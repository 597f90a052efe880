"""The Data Processor pipeline: one realtime tick end to end.

Counterpart of kmamiz_tpu/server/processor.py — the Rust service's
collect_data (KMamiz kmamiz_data_processor/src/data_processor.rs:75-126):

  fetch traces -> dedup vs processed-trace map -> namespaces -> replicas
  and envoy logs per pod -> realtime + combined data -> endpoint
  dependencies (+merge with existing) -> datatypes -> response

With a cluster source (`k8s_source`, ingestion.kubernetes.KubernetesClient)
each tick lists the pods of the window's namespaces and reads each pod's
istio-proxy log (stage `fetch_cluster_state`): the logs carry the request
and response bodies behind the datatypes, and the replica counts feed the
records and the hourly fold. A fault of that source fails the tick.

The numeric window statistics (counts, latency mean/CV, latest
timestamps) run on the processor's device through ops.window.window_stats
— on the card, the hand-written CUDA segment-stats kernel, twice per tick;
string-bound work (JSON body merging, schema inference) stays on the
host, grouped per (endpoint, status). Every window also merges into the
device edge store (graph.store).

Every tick also feeds the model plane's hourly history
(`_observe_history`): per-endpoint SERVER-span sums accumulate into the
current hour's bucket, and the first tick of a later hour folds the
completed bucket into models.history.HistoryState and publishes
`forecast_snapshot`, the input of GET /api/v1/model/forecast. The
snapshot holds host numpy copies of the edge columns: one device-to-host
copy per fold, none per tick.

Raw ingest (`ingest_raw_window`, POST /ingest on the DP server) takes a
Zipkin response's raw bytes, or a KMZC columnar frame, through the native
SoA loader (core.spans.raw_spans_to_batch) into the same device graph,
uncapped. `ingest_raw_stream` does the same over a sequence of chunks
(the pages of a Zipkin backfill, `ingest_from_zipkin`, or a large
/ingest body split on trace-group boundaries), parsing chunk k+1 on a
worker thread while chunk k stages its merge on the device. The tick and
raw ingest share one processed-trace dedup map, which the native parse
reads through a persistent skip set.

The online history state persists through `snapshot_history` /
`restore_history` (server/cacheables.CModelHistoryState): chunked part
documents keyed by endpoint name, field for field the JAX processor's, so
a store written by either package restores into the other. The state is
host numpy in both packages; a snapshot copies it under _history_lock and
encodes after releasing it, so it never pairs two ticks' arrays and never
holds a tick back for the encoding.

The resilience layer: with the quarantine on (the default,
resilience/quarantine.py) a raw payload that fails to parse is diverted
to disk and answered with a zero-span summary; with the WAL on
(KMAMIZ_WAL=1, resilience/wal.py) every parsed payload, and every tick's
kept trace groups, is appended before its merge, and `replay_wal`
rebuilds the graph after a crash.

Telemetry, as in the JAX processor: each tick (and each raw ingest under
the DP server's `dp-ingest` root) records a span trace of its phases
(telemetry/tracing.py: parse, wal-append, walk_sparse, pack, merge,
scorers, assemble, host-transfer, quarantine, and the port-only
fetch_cluster_state and dependencies_json), the step timer's phases
(core/profiling.py: fetch_traces, fetch_cluster_state, dependencies,
combine_window, graph_merge, combine_assemble, raw_ingest_parse,
raw_ingest_graph, ingest_parse, ingest_merge), the scorecard and
freshness observations, and torch.profiler captures of its device stages
when KMAMIZ_PROFILE_DIR is set. Span boundaries add no device
synchronisation. `last_stage_ms` keeps the port's own stage walls.

Tenancy, as in the JAX processor: a processor serves one tenant
(`tenant`, "default" unless given), whose graph is admitted into the
tenant arena under that name, whose WAL and quarantine are the tenant's
namespaces and whose ticks count in its scorecard.
`sibling_for_tenant` brings another tenant up from this one's sources.
The tenancy router runs several tenants' prepare_tick, one stacked merge
(`prepare_batched_merge` gives a tick's window as id columns,
`adopt_batched_merge` takes its lane) and each finish_tick.

The fold hooks: the STLGT continual trainer, then the control plane
(control.on_fold, inside its `control-decide` span), each contained and
counted in `fold_errors`. Not ported yet: the JAX processor's fold hook
of the cost model.
"""
from __future__ import annotations

import gc
import itertools
import json
import logging
import queue
import threading
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from kmamiz_tpu_torch import native, synth
from kmamiz_tpu_torch.core import profiling, schema
from kmamiz_tpu_torch.core.interning import StringInterner
from kmamiz_tpu_torch.core.profiling import step_timer
from kmamiz_tpu_torch.core.spans import (
    KIND_SERVER,
    RawIngestSession,
    _pad_size,
    raw_spans_to_batch,
    spans_to_batch,
)
from kmamiz_tpu_torch.core.timeutils import to_precise
from kmamiz_tpu_torch.device import DeviceLike, resolve_device
from kmamiz_tpu_torch.domain.combined import CombinedRealtimeDataList
from kmamiz_tpu_torch.domain.endpoint_dependencies import EndpointDependencies
from kmamiz_tpu_torch.domain.realtime import RealtimeDataList
from kmamiz_tpu_torch.domain.traces import Traces
from kmamiz_tpu_torch.graph.store import EndpointGraph
from kmamiz_tpu_torch.models import graphsage
from kmamiz_tpu_torch.models.history import SLOT_SECONDS, HistoryState
from kmamiz_tpu_torch.ops import window as window_ops
from kmamiz_tpu_torch.resilience import metrics as res_metrics
from kmamiz_tpu_torch.resilience import quarantine as res_quarantine
from kmamiz_tpu_torch.resilience.wal import IngestWAL
from kmamiz_tpu_torch.telemetry import device as tel_device
from kmamiz_tpu_torch.telemetry import freshness as tel_freshness
from kmamiz_tpu_torch.telemetry import slo as tel_slo
from kmamiz_tpu_torch.telemetry.profiling import events as prof_events
from kmamiz_tpu_torch.telemetry.tracing import TRACER, phase_span

logger = logging.getLogger("kmamiz_tpu_torch.processor")

PROCESSED_TRACE_TTL_MS = 300_000  # Rust DP keeps the dedup map for 5 min
ZIPKIN_LIMIT = 2_500
#: chunks a large body splits into (POST /ingest) and pages a Zipkin
#: backfill fetches (KMAMIZ_INGEST_STREAM_CHUNKS's default)
DEFAULT_STREAM_CHUNKS = 4
#: parsed chunks the streaming ingest's ring holds (KMAMIZ_INGEST_DEPTH's
#: default); each pins its batch's host arrays
DEFAULT_STREAM_DEPTH = 2
#: the scratch windows that warm_up ticks over: a tick's trace count, on a
#: small mesh (services x urls), 7-span chains
WARM_UP_TRACES = 2_500
WARM_UP_MESH = dict(n_services=50, urls_per_service=4)
#: the gen-0 collection threshold the serving process runs with (the JAX
#: processor's KMAMIZ_GC_GEN0 default; the knob is not ported)
GC_GEN0 = 50_000


def _tune_gc() -> None:
    """Raise the gen-0 collection threshold for the serving process, as
    the JAX processor does. A 2,500-trace tick allocates ~10^5
    short-lived dicts (span copies, dependency records, response JSON);
    CPython's default gen-0 threshold of 700 triggers a young-generation
    scan every few hundred of them, and with the application's caches of
    10,000 endpoints alive the older generations' scans it sets off take
    a share of every tick. Collection stays on: only its cadence changes."""
    _, gen1, gen2 = gc.get_threshold()
    gc.set_threshold(GC_GEN0, gen1, gen2)


def _pack_stats(count, mean, cv, ts_rel):
    """Pack the per-segment stats into ONE device buffer so the host pays a
    single device-to-host copy. int32 timestamps ride along losslessly as
    their float32 bit pattern."""
    return torch.stack([count, mean, cv, ts_rel.view(torch.float32)])


class _PreparedTick:
    """A tick's host-stage results between prepare_tick and finish_tick,
    with the wall ms of each stage."""

    __slots__ = (
        "request",
        "req_time",
        "wall_t0",
        "trace_groups",
        "realtime",
        "stats_job",
        "dependencies",
        "window_edges",
        "batch",
        "stages",
        "objects",
        "dependency_records",
        "arrival_ns",
        "merged",
    )

    def __init__(self, request: dict) -> None:
        self.request = request
        self.req_time = 0
        self.wall_t0 = prof_events.now_ms()
        # the freshness watermark: stamped when the tick starts, observed
        # when its response is assembled
        self.arrival_ns = prof_events.now_ns()
        self.trace_groups = []
        self.realtime = None
        self.stats_job = None
        self.dependencies = None
        self.window_edges = None
        self.batch = None
        self.stages: Dict[str, float] = {}
        # the response's dependencies as the object (collect's objects)
        self.objects = False
        # the response's dependency records, when they were encoded early
        self.dependency_records = None
        # whether the graph merge is done (the router's stacked lane)
        self.merged = False


class _ClusterFetch:
    """A tick's cluster fetch, the source's
    get_replicas_and_joinable_logs(namespaces, trace_ids=...), on a thread
    of its own. result() waits and returns (replicas, structured logs) or
    raises the fetch's error; `ms` is the fetch's own wall, between
    `start_ns` and `end_ns` (prof_events.now_ns)."""

    def __init__(self, source, namespaces, trace_ids) -> None:
        self.ms = 0.0
        self.start_ns = self.end_ns = 0
        self._out = None
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._run, args=(source, namespaces, trace_ids), name="cluster-fetch", daemon=True
        )
        self._thread.start()

    def _run(self, source, namespaces, trace_ids) -> None:
        self.start_ns = prof_events.now_ns()
        try:
            self._out = source.get_replicas_and_joinable_logs(namespaces, trace_ids=trace_ids)
        except BaseException as err:  # noqa: BLE001 - re-raised by result()
            self._err = err
        finally:
            self.end_ns = prof_events.now_ns()
            self.ms = (self.end_ns - self.start_ns) / 1e6

    def result(self):
        self._thread.join()
        if self._err is not None:
            raise self._err
        return self._out


class _stage:
    """Records the wall ms of a with-block into a tick's stage dict."""

    def __init__(self, stages: Dict[str, float], name: str) -> None:
        self.stages, self.name = stages, name

    def __enter__(self):
        self.t0 = prof_events.now_ms()

    def __exit__(self, *exc):
        self.stages[self.name] = prof_events.now_ms() - self.t0
        return False


class DataProcessor:
    """One instance per DP service; holds the processed-trace dedup map and
    the persistent device graph. `device=None` runs on the card (and
    raises without one); pass device="cpu" to run on the CPU. `graph`
    starts the processor from a carried graph on the same device; `now_ms`
    is the clock of the dedup map's time-to-live.

    `k8s_source` is the cluster source: an object with
    get_replicas_and_joinable_logs(namespaces, trace_ids=) -> (replicas,
    structured envoy logs), as ingestion.kubernetes.KubernetesClient has
    (the JAX processor's source answers get_replicas_and_envoy_logs; the
    port's hands the tick the logs of the window's requests, which its
    worker processes structured). With use_device_stats
    off, the window statistics run on the host (the JAX processor's
    flag: the stream's bit-exact contract runs so). `wal` is the ingest
    WAL: "from_env" (KMAMIZ_WAL, in the tenant's namespace), an IngestWAL,
    or None. `max_payload_bytes` is the quarantine's trace-bomb cap of one
    raw ingest payload (0: none). `tenant` names the tenant it serves."""

    def __init__(
        self,
        trace_source: Callable[[int, int, int], List[List[dict]]],
        k8s_source: Optional[object] = None,
        device: DeviceLike = None,
        graph: Optional[EndpointGraph] = None,
        now_ms: Callable[[], float] = prof_events.wall_ms,
        use_device_stats: bool = True,
        wal: object = "from_env",
        max_payload_bytes: int = res_quarantine.MAX_PAYLOAD_BYTES,
        tenant: str = "default",
    ) -> None:
        if k8s_source is not None and not callable(
            getattr(k8s_source, "get_replicas_and_joinable_logs", None)
        ):
            raise TypeError(
                "k8s_source has no get_replicas_and_joinable_logs(namespaces)"
            )
        _tune_gc()
        self.tenant = tenant
        self.device = resolve_device(device)
        # a card processor feeds the device memory gauges
        tel_device.track_device(self.device)
        self._trace_source = trace_source
        self._k8s = k8s_source
        self._use_device_stats = use_device_stats
        self.max_payload_bytes = max_payload_bytes
        #: the newest replica count of each uniqueServiceName, folded into
        #: the hourly features
        self._last_replicas: Dict[str, float] = {}
        # crash-safe ingest WAL (resilience/wal.py), None unless
        # KMAMIZ_WAL=1: every parsed ingest payload appends before its
        # graph merge; _wal_replaying stops re-appends during replay_wal
        self._wal = IngestWAL.from_env(tenant=tenant) if wal == "from_env" else wal
        self._wal_replaying = False
        self._now_ms = now_ms  # the dedup map's clock
        self._processed: Dict[str, float] = {}
        # the processed map's keys as native skip entries
        # (native.encode_skip_entry layout), in the map's order. Only the
        # raw path reads them, so they encode when it asks
        # (_skip_entries_locked): _skip_encoded counts the keys already in
        # them, and a prune empties them and bumps _skip_gen, so the tick
        # never encodes an id
        self._skip_entries = bytearray()
        self._skip_encoded = 0
        self._skip_gen = 0
        # persistent native mirror of the skip entries (native.SkipSet),
        # passed to every raw parse; created lazily, synced by the appended
        # delta, cleared and refilled after a prune
        self._native_skipset: Optional[native.SkipSet] = None
        self._skipset_synced = 0  # bytes of _skip_entries already pushed
        self._skipset_gen = -1  # generation the native set reflects
        # persistent raw-ingest session (core.spans.RawIngestSession): the
        # shape/status tables survive across payloads, so warm payloads
        # carry no naming strings; created lazily
        self._raw_session: Optional[RawIngestSession] = None
        # collect() and ingest_raw_window() run on several server threads;
        # dedup-map transitions serialize here (the graph store carries its
        # own lock)
        self._dedup_lock = threading.Lock()
        #: one tick at a time (collect)
        self.tick_lock = threading.Lock()
        if graph is not None and graph.device != self.device:
            raise ValueError(
                f"graph lies on {graph.device}, the processor runs on {self.device}"
            )
        # a carried graph (graph.convert.graph_from_export) or a new one
        self.graph = graph if graph is not None else EndpointGraph(device=self.device, tenant=tenant)
        #: wall ms of the last finished tick's stages
        self.last_stage_ms: Dict[str, float] = {}
        #: whether a tick with a cluster fetch JSON-encodes its dependency
        #: records while the fetch runs (the DP server sets it: it answers
        #: in JSON; take_encoded_dependencies hands the text over)
        self.encode_dependencies_early = False
        # (the records, their JSON text) of the last tick that encoded early
        self._encoded_dependencies: Tuple[Optional[list], str] = (None, "")
        #: wall ms of the last raw ingest's parse and merge
        self.last_ingest_ms: Dict[str, float] = {}
        # online history-feature state, created on the first observed
        # tick; ticks accumulate into the current hour's bucket and fold on
        # rollover. collect() runs on several server threads, so every
        # transition serializes on _history_lock.
        self.history: Optional[HistoryState] = None
        self.history_features = None  # last fold's [N, 8] columns
        self.history_model_features = None  # full [N, 18] model input
        self.history_predicted_hour = None
        # the fold's snapshot for /model/forecast: features, the matching
        # edges and names, published as ONE dict (replaced wholesale, read
        # through one attribute) so readers never mix folds
        self.forecast_snapshot = None
        self._hour_bucket = None  # [abs_hour, count, e4, e5, lat, lat^2,
        #                            cls_count, cls_lat, cls_lat^2]
        self._history_lock = threading.Lock()
        #: failures the fold hooks contained (the fold itself went on)
        self.fold_errors: Dict[str, int] = {"stlgtFoldErrors": 0, "controlFoldErrors": 0}
        #: parsed stream chunks that never merged (the consumer bailed out)
        self.ingest_dropped = 0

    @property
    def wal(self) -> Optional[IngestWAL]:
        """This processor's ingest WAL (None when durability is off)."""
        return self._wal

    def sibling_for_tenant(self, tenant: str) -> "DataProcessor":
        """A new processor for another tenant that shares this one's
        sources, device, clock and settings and nothing stateful: its own
        graph (admitted under `tenant`), WAL namespace, dedup map and
        history. The tenancy router's runtime factory uses it."""
        sibling = DataProcessor(
            self._trace_source,
            k8s_source=self._k8s,
            device=self.device,
            now_ms=self._now_ms,
            use_device_stats=self._use_device_stats,
            max_payload_bytes=self.max_payload_bytes,
            tenant=tenant,
        )
        sibling.encode_dependencies_early = self.encode_dependencies_early
        return sibling

    # -- trace dedup (data_processor.rs:30-73) -------------------------------

    def _filter_traces(self, traces: List[List[dict]], request_time: float):
        with self._dedup_lock:
            kept = []
            for group in traces:
                if not group:
                    continue
                trace_id = group[0].get("traceId")
                if trace_id in self._processed:
                    continue
                self._processed[trace_id] = request_time
                kept.append(group)
            self._prune_processed_locked(request_time)
            return kept

    def _prune_processed_locked(self, now_ms: float) -> None:
        """TTL-prune the processed map. A prune that removes entries empties
        the skip entries and bumps the generation (the native skip set
        clears and resyncs); they re-encode when the raw path next asks."""
        cutoff = now_ms - PROCESSED_TRACE_TTL_MS
        if any(v < cutoff for v in self._processed.values()):
            self._processed = {k: v for k, v in self._processed.items() if v >= cutoff}
            self._skip_entries = bytearray()
            self._skip_encoded = 0
            self._skip_gen += 1

    def _skip_entries_locked(self) -> bytearray:
        """The skip entries, brought up to the processed map: the keys
        registered since the last call encode now. New keys append at the
        map's end and a prune resets the count, so the entries stay the
        map's keys in order."""
        if self._skip_encoded < len(self._processed):
            for tid in itertools.islice(self._processed, self._skip_encoded, None):
                self._skip_entries += native.encode_skip_entry(tid)
            self._skip_encoded = len(self._processed)
        return self._skip_entries

    def _skipset_locked(self) -> native.SkipSet:
        """The persistent native skip set, synced to _skip_entries (caller
        holds _dedup_lock): after a prune (a generation bump) it clears and
        takes the rebuilt entries, otherwise only the appended delta."""
        if self._native_skipset is None:
            self._native_skipset = native.SkipSet()
        ss = self._native_skipset
        if self._skipset_gen != self._skip_gen:
            ss.clear()
            self._skipset_synced = 0
            self._skipset_gen = self._skip_gen
        entries = self._skip_entries_locked()
        if self._skipset_synced < len(entries):
            ss.extend(bytes(entries[self._skipset_synced :]))
            self._skipset_synced = len(entries)
        return ss

    def _raw_session_locked(self) -> RawIngestSession:
        """The persistent raw-ingest session (caller holds _dedup_lock for
        the lazy create; the session has its own consumer lock)."""
        if self._raw_session is None:
            self._raw_session = RawIngestSession(self.graph.interner)
        return self._raw_session

    # -- raw ingest: the uncapped window path --------------------------------

    def _wal_append(self, raw: bytes) -> None:
        """Durably log one parsed ingest payload before its graph merge.
        No-op with the WAL off or during replay_wal. An append failure
        counts (`walAppendErrors`) and the ingest goes on: availability
        over durability, as the store fails open."""
        if self._wal is None or self._wal_replaying:
            return
        try:
            self._wal.append(raw)
        except OSError:
            res_metrics.incr("walAppendErrors")

    def _divert_poison(self, raw: bytes, source: str) -> str:
        """Classify a payload the native parser rejected and move it to the
        quarantine; returns the reason code. The port's library is always
        there (a failed build raises at the parse), so a payload the
        classifier finds sound is a parser rejection: parse-error."""
        reason = res_quarantine.classify_payload(raw, self.max_payload_bytes) or res_quarantine.REASON_PARSE_ERROR
        res_quarantine.quarantine_for(self.tenant).put(raw, reason, source=source)
        return reason

    def _quarantined_summary(self, reason: str, wall_t0: float) -> dict:
        """ingest_raw_window's answer for a diverted payload: no new span,
        the graph untouched."""
        return {
            "spans": 0,
            "traces": 0,
            "endpoints": len(self.graph.interner.endpoints),
            "edges": int(self.graph.n_edges),
            "quarantined": 1,
            "reason": reason,
            "ms": round(prof_events.now_ms() - wall_t0, 1),
        }

    def replay_wal(self) -> dict:
        """Rebuild ingest state from the WAL (the boot path after a crash):
        each durable payload re-ingests through ingest_raw_window, in
        order, on the fresh dedup map, so the graph is the one the
        payloads built before the crash. A payload that fails to re-parse
        is quarantined, never aborting the boot."""
        totals = {"replayed": 0, "spans": 0, "quarantined": 0}
        if self._wal is None:
            return totals
        self._wal_replaying = True
        try:
            for payload in self._wal.replay():
                out = self.ingest_raw_window(payload)
                totals["replayed"] += 1
                totals["spans"] += out.get("spans", 0)
                totals["quarantined"] += out.get("quarantined", 0)
        finally:
            self._wal_replaying = False
        res_metrics.incr("walReplays")
        return totals

    def ingest_raw_window(self, raw: bytes) -> dict:
        """Raw Zipkin response bytes (or a KMZC columnar frame) -> the
        device graph, uncapped.

        The tick (collect) keeps the reference's 2,500-trace cap; this is
        the scale path without it: the native SoA loader scans the bytes
        into span columns (no json.loads, no per-span dicts), applies the
        tick's processed-trace dedup through the persistent skip set, and
        merges the window into the graph on the processor's device.
        Returns {spans, traces, endpoints, edges, ms}.

        A malformed payload, or one over the max_payload_bytes cap,
        diverts to the quarantine with its reason code and answers a
        zero-span summary carrying `quarantined` and `reason`, the
        interner and the dedup map untouched. With KMAMIZ_QUARANTINE=0 it
        raises ValueError instead. A parsed payload appends to the WAL
        (when on) before its merge. A fault on this side (a library
        answer that does not decode, a desynced session) raises
        RuntimeError, where the JAX processor reports it as a malformed
        payload."""
        t_start = self._now_ms()  # domain time for the dedup registration
        wall_t0 = prof_events.now_ms()
        tel_slo.INGEST_PAYLOADS.inc()
        quarantine_on = res_quarantine.enabled()
        if quarantine_on and 0 < self.max_payload_bytes < len(raw):
            # the size gate comes before the parse: a trace bomb never
            # reaches the scanner, the interner or the device
            with phase_span("quarantine"):
                res_quarantine.quarantine_for(self.tenant).put(
                    raw, res_quarantine.REASON_TRACE_BOMB, source="ingest_raw_window"
                )
            return self._quarantined_summary(res_quarantine.REASON_TRACE_BOMB, wall_t0)
        with self._dedup_lock:
            skipset = self._skipset_locked()
            session = self._raw_session_locked()
        with step_timer.phase("raw_ingest_parse"), phase_span("parse"):
            out = raw_spans_to_batch(
                raw, interner=self.graph.interner, skipset=skipset, session=session
            )
        if out is None:
            if not quarantine_on:
                raise ValueError("malformed span payload")
            with phase_span("quarantine"):
                reason = self._divert_poison(raw, "ingest_raw_window")
            return self._quarantined_summary(reason, wall_t0)
        batch, kept = out
        t_parsed = prof_events.now_ms()
        with phase_span("wal-append"):
            self._wal_append(raw)
        # the dedup snapshot is the skip set as the parse saw it: a trace a
        # concurrent collect() registers mid-parse may merge twice, which
        # the set-union edge store absorbs
        self._register_processed(kept, t_start)
        if batch.n_spans:
            with step_timer.phase("raw_ingest_graph"), profiling.trace("raw_ingest_graph"), phase_span(
                "merge"
            ):
                self.graph.merge_window(batch)
        edges = int(self.graph.n_edges)  # waits for the merge
        t_end = prof_events.now_ms()
        self.last_ingest_ms = {"parse": t_parsed - wall_t0, "merge": t_end - t_parsed}
        return {
            "spans": batch.n_spans,
            "traces": len(kept),
            "endpoints": batch.num_endpoints,
            "edges": edges,
            "ms": round(t_end - wall_t0, 1),
        }

    def _register_processed(self, kept, when_ms: float) -> None:
        """Register kept trace ids in the processed map, then TTL-prune.
        When the parse supplied the raw skip-entry bytes of the kept
        records (KeptTraceIds.blob) and every id is new — the steady case —
        the bytes append as ONE slice instead of one encoding per id."""
        blob = getattr(kept, "blob", None)
        with self._dedup_lock:
            if blob is not None and kept and all(t not in self._processed for t in kept):
                # prescan-deduped ids, all new: after the tick's backlog
                # encodes, map entries and skip entries stay 1:1 (the blob
                # is byte-identical to encode_skip_entry, absent markers
                # included)
                self._skip_entries_locked()
                self._skip_entries += blob
                self._processed.update(zip(kept, [when_ms] * len(kept)))
                self._skip_encoded = len(self._processed)
            else:
                for tid in kept:
                    self._processed[tid] = when_ms
            self._prune_processed_locked(when_ms)

    # -- streaming raw ingest: a bounded ring, parse ahead of the merge -------

    def ingest_raw_stream(self, chunks, depth: int = DEFAULT_STREAM_DEPTH) -> dict:
        """Pipelined uncapped ingest over an iterable of raw Zipkin
        responses (pages of a paginated fetch, or native.split_groups over
        one large body), in three stages around a ring of `depth` parsed
        chunks:

        1. fetch/parse (a worker thread): pulls the next chunk (so a
           paginated source's HTTP fetch overlaps everything after it),
           parses it through the persistent skip set and session (host
           arrays only: this thread launches no device work), registers
           its kept trace ids, and enqueues the batch;
        2. upload/dispatch (this thread): pops batches in order and stages
           each into the graph (merge_window(stage=True): the upload, the
           walk and its self-compaction);
        3. the device merge: staged windows collapse into pending
           pre-unions while later chunks parse, and the read at the end
           adopts ONE union over everything.

        Dedup matches chunk-by-chunk ingest_raw_window: chunk k's kept ids
        register before chunk k+1's parse reads the processed set. The
        span-id map is scoped per chunk, as the reference's is per
        paginated response; groups never split across chunks, so the
        graph equals the one-shot path's.

        Failure: per-chunk quarantine. A malformed chunk (or one over the
        size cap) diverts to the quarantine with its reason code and the
        stream goes on; the graph of the surviving chunks is the one
        ingesting only those gives. With KMAMIZ_QUARANTINE=0, every chunk
        parsed before a malformed one merges and registers, then
        ValueError is raised. An error of the source iterator, or a
        RuntimeError of the parse, propagates that way. Each parsed chunk
        appends to the WAL (when on) on the parse thread, in chunk order.
        A parsed chunk dropped when the consumer bails out counts in
        `ingest_dropped` (and as `ingestDropped` in resilience/metrics).

        Returns the totals (spans, traces, chunks, quarantined),
        endpoints, edges, the overlap accounting (parse_ms, merge_ms,
        saved_ms = parse + merge - wall), the per-chunk breakdown
        (`chunk_detail`: spans, parse_ms, merge_ms, transfer_ms), the final
        read's `drain_ms`, `ms`, `pipeline_depth` and the ring's peak
        occupancy (`ring_peak`)."""
        depth = max(1, int(depth))
        wall_t0 = prof_events.now_ms()
        parse_ms = merge_ms = 0.0
        totals = {"spans": 0, "traces": 0, "chunks": 0}
        quarantined = [0]  # written by the parse thread, read after join
        chunk_detail = []
        ring: "queue.Queue" = queue.Queue(maxsize=depth)
        ring_peak = 0
        stop = threading.Event()  # the consumer bailed out: unblock the worker

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    ring.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            if item[0] == "chunk":
                # parsed and registered, but never merged
                with self._dedup_lock:
                    self.ingest_dropped += 1
                res_metrics.incr("ingestDropped")
            return False

        def produce() -> None:
            """Fetch, parse, log and register, strictly in chunk order (a
            chunk's parse_ms leaves its fetch out)."""
            quarantine_on = res_quarantine.enabled()
            size_cap = self.max_payload_bytes
            try:
                it = iter(chunks)
                while not stop.is_set():
                    try:
                        raw = next(it)
                    except StopIteration:
                        break
                    tel_slo.INGEST_PAYLOADS.inc()
                    if quarantine_on and 0 < size_cap < len(raw):
                        res_quarantine.quarantine_for(self.tenant).put(
                            raw, res_quarantine.REASON_TRACE_BOMB, source="ingest_raw_stream"
                        )
                        quarantined[0] += 1
                        continue
                    with self._dedup_lock:
                        skipset = self._skipset_locked()
                        session = self._raw_session_locked()
                    t0 = prof_events.now_ms()
                    out = raw_spans_to_batch(
                        raw, interner=self.graph.interner, skipset=skipset, session=session
                    )
                    dt = prof_events.now_ms() - t0
                    step_timer.record("ingest_parse", dt)
                    if out is None:
                        if quarantine_on:
                            # divert the poison chunk and go on
                            self._divert_poison(raw, "ingest_raw_stream")
                            quarantined[0] += 1
                            continue
                        put(("error", ValueError("malformed span payload"), dt))
                        return
                    batch, kept = out
                    # the WAL's order is the chunks' order: this thread
                    # appends each before it registers or hands it on
                    self._wal_append(raw)
                    # registration precedes the next parse, whatever the depth
                    self._register_processed(kept, self._now_ms())
                    if not put(("chunk", (batch, kept), dt)):
                        return
            except BaseException as err:  # noqa: BLE001 - re-raised by the consumer
                put(("error", err, 0.0))
                return
            put(("end", None, 0.0))

        worker = threading.Thread(target=produce, name="ingest-raw-parse", daemon=True)
        worker.start()
        pending_err: Optional[BaseException] = None
        try:
            while True:
                ring_peak = max(ring_peak, ring.qsize())
                tag, payload, dt = ring.get()
                if tag == "end":
                    break
                parse_ms += dt
                if tag == "error":
                    pending_err = payload
                    break
                batch, kept = payload
                t0 = prof_events.now_ms()
                transfer_ms = 0.0
                if batch.n_spans:
                    with step_timer.phase("raw_ingest_graph"), profiling.trace(
                        "raw_ingest_graph"
                    ), phase_span("merge"):
                        # the walk, its self-compaction and the upload;
                        # one union over every chunk at the drain below
                        transfer_ms = self.graph.merge_window(batch, stage=True)
                chunk_ms = prof_events.now_ms() - t0
                step_timer.record("ingest_merge", chunk_ms)
                merge_ms += chunk_ms
                chunk_detail.append(
                    {
                        "spans": batch.n_spans,
                        "parse_ms": round(dt, 1),
                        "merge_ms": round(chunk_ms, 1),
                        "transfer_ms": round(transfer_ms, 1),
                    }
                )
                totals["spans"] += batch.n_spans
                totals["traces"] += len(kept)
                totals["chunks"] += 1
        finally:
            stop.set()
            worker.join(timeout=30.0)
        if pending_err is not None:
            raise pending_err
        # the staged merges resolve here: n_edges waits for the device, the
        # stream's one fence (so the span boundary costs no sync)
        t0 = prof_events.now_ms()
        with phase_span("host-transfer"):
            n_edges = int(self.graph.n_edges)
        drain_ms = prof_events.now_ms() - t0
        wall_ms = prof_events.now_ms() - wall_t0
        return {
            **totals,
            "quarantined": quarantined[0],
            "endpoints": len(self.graph.interner.endpoints),
            "edges": n_edges,
            "chunk_detail": chunk_detail,
            "drain_ms": round(drain_ms, 1),
            "ms": round(wall_ms, 1),
            "parse_ms": round(parse_ms, 1),
            "merge_ms": round(merge_ms, 1),
            "saved_ms": round(max(0.0, parse_ms + merge_ms - wall_ms), 1),
            "pipeline_depth": depth,
            "ring_peak": ring_peak,
        }

    def ingest_from_zipkin(
        self,
        zipkin,
        look_back_ms: float,
        end_ts: Optional[float] = None,
        pages: int = DEFAULT_STREAM_CHUNKS,
    ) -> dict:
        """The backfill route: a paginated raw Zipkin fetch
        (ingestion.zipkin.ZipkinClient.iter_trace_pages_raw) through
        ingest_raw_stream, each page's fetch and parse on the pipeline's
        worker while the previous page merges. Uncapped, where the tick
        keeps the reference's 2,500 traces."""
        return self.ingest_raw_stream(
            zipkin.iter_trace_pages_raw(look_back_ms, end_ts, pages=pages)
        )

    # -- the tick ------------------------------------------------------------

    def take_encoded_dependencies(self, records) -> Optional[str]:
        """The JSON text (json.dumps's) of a response's dependency records
        when the tick that made them encoded them early, handed over once:
        `records` must be that response's list itself; else None."""
        encoded, text = self._encoded_dependencies
        if records is None or records is not encoded:
            return None
        self._encoded_dependencies = (None, "")
        return text

    def warm_up(self) -> None:
        """Load the tick's device code before the first tick is served.
        CUDA loads a kernel's module at its first launch (the segment-stats
        kernel's, and torch's sorts and scatters of the merge), and the
        caching allocator and pinned staging take their first blocks then:
        the first served tick would pay for all of it. Two ticks of a
        scratch processor on this device, over synthetic windows of
        WARM_UP_TRACES traces (the second merges through the interned-edge
        path), run it instead. This processor's graph (its arena slot given
        back after), dedup map, history and WAL are not touched (the scratch ticks count in the telemetry
        like any tick of the process). Nothing loads lazily on the CPU,
        where it returns at once."""
        if self.device.type != "cuda":
            return
        windows = iter(
            json.loads(
                synth.make_raw_window(
                    WARM_UP_TRACES, 7, t_start=k * WARM_UP_TRACES, trace_prefix=f"warm-up{k}-", **WARM_UP_MESH
                )
            )
            for k in range(2)
        )
        scratch = DataProcessor(
            trace_source=lambda look_back, t, limit: next(windows), device=self.device, wal=None
        )
        for k in range(2):
            scratch.collect({"uniqueId": f"warm-up{k}", "lookBack": 30_000})
        # the scratch graph took this tenant's arena slot: hand it back
        from kmamiz_tpu_torch.tenancy.arena import default_arena

        default_arena().admit(self.tenant, self.graph)

    def collect(self, request: dict, objects: bool = False) -> dict:
        """TExternalDataProcessorRequest -> TExternalDataProcessorResponse.
        Ticks run one at a time under tick_lock, whoever calls: the DP
        server's POST / and the application's scheduled realtime job.

        With objects, the in-process operator's form: existingDep may be
        its cache's EndpointDependencies and the response's dependencies
        is one, where the reference's worker thread clones both as JSON
        (EndpointDependencies.handed_over holds the two forms equal)."""
        stages: Dict[str, float] = {}
        # the trace's root is the tick's own work, not its wait for the
        # lock; a no-op when the caller already opened the trace
        with self.tick_lock, TRACER.tick():
            with _stage(stages, "prepare"):
                p = self.prepare_tick(request)
            p.objects = objects
            with _stage(stages, "merge"):
                self.merge_prepared(p)
            with _stage(stages, "finish"):
                out = self.finish_tick(p)
            self.last_stage_ms = {**p.stages, **stages}
        return out

    def prepare_tick(self, request: dict) -> _PreparedTick:
        """The tick's host stages: fetch/dedup, the cluster fetch (on its
        own thread) beside the WAL append and the dependency walk, the
        device-stats dispatch, and the span-batch build — everything up to
        (but NOT including) the graph merge. `fetch_cluster_state` in the
        stage walls is the fetch's own wall, which overlaps
        `wal_append` and `dependencies`; its span (`fetch_cluster_state`,
        timed on its thread) overlaps them too."""
        p = _PreparedTick(request)
        tel_slo.TICKS.inc()
        t_start = self._now_ms()  # dedup stamps, default request time
        p.req_time = request.get("time", int(t_start))
        existing_dep = request.get("existingDep")

        with _stage(p.stages, "fetch_parse"):
            with step_timer.phase("fetch_traces"), phase_span("parse"):
                trace_groups = self._trace_source(
                    request.get("lookBack", 30_000),
                    p.req_time,
                    ZIPKIN_LIMIT,
                )
                trace_groups = self._filter_traces(trace_groups, t_start)
            with phase_span("parse"):
                # still parse work: span dicts -> Traces
                traces = Traces(trace_groups)

        # the cluster fetch runs on a thread of its own (its fan-out on the
        # cluster client's worker processes) while this thread logs the
        # window and walks its dependencies, neither of which touches the
        # graph; its failure fails the tick before the graph changes. It
        # hands back the logs of the window's traces only: the realtime
        # join reads no other
        cluster = None
        if self._k8s is not None:
            namespaces = {ns for ns in traces.extract_containing_namespaces() if ns}
            trace_ids = {span["traceId"] for group in trace_groups for span in group}
            cluster = _ClusterFetch(self._k8s, namespaces, trace_ids)

        if trace_groups and self._wal is not None:
            with _stage(p.stages, "wal_append"), phase_span("wal-append"):
                # the tick's kept groups as raw Zipkin JSON, before any
                # graph mutation; replay re-ingests them through
                # ingest_raw_window, which merges the same edges
                self._wal_append(json.dumps(trace_groups).encode("utf-8"))

        # the port's walk is the gather form: the JAX walk_sparse phase
        with _stage(p.stages, "dependencies"), step_timer.phase("dependencies"), phase_span("walk_sparse"):
            dependencies = traces.to_endpoint_dependencies()
            # the raw pre-filter window edges; combine_with returns a new
            # instance without them, so capture before combining
            p.window_edges = getattr(dependencies, "window_edges", None)
            if isinstance(existing_dep, EndpointDependencies):
                if existing_dep.dependencies:
                    dependencies = dependencies.combine_with(
                        existing_dep.handed_over()
                    )
            elif existing_dep:
                dependencies = dependencies.combine_with(
                    EndpointDependencies(existing_dep)
                )

        if cluster is not None and self.encode_dependencies_early:
            with _stage(p.stages, "dependencies_json"), phase_span("dependencies_json"):
                # the response's largest part, encoded in the fetch's
                # shadow, one record a call so the fetch's thread gets the
                # interpreter between records
                p.dependency_records = dependencies.to_json()
                text = "[" + ", ".join(json.dumps(r) for r in p.dependency_records) + "]"
                self._encoded_dependencies = (p.dependency_records, text)

        replicas: List[dict] = []
        structured_logs: List[dict] = []
        if cluster is not None:
            replicas, structured_logs = cluster.result()
            p.stages["fetch_cluster_state"] = cluster.ms
            step_timer.record("fetch_cluster_state", cluster.ms)
            TRACER.record_span("fetch_cluster_state", cluster.start_ns, cluster.end_ns)
            for part, ms in getattr(self._k8s, "last_fetch_ms", {}).items():
                p.stages[f"cluster_{part}"] = ms
            self._last_replicas.update(
                {
                    r["uniqueServiceName"]: float(r.get("replicas", 1))
                    for r in replicas
                    if r.get("uniqueServiceName")
                }
            )

        # dispatch the device stats before the host builds the span batch:
        # the kernel runs and its packed result streams back meanwhile
        with _stage(p.stages, "combine_window"), step_timer.phase("combine_window"), profiling.trace(
            "combine"
        ), phase_span("pack"):
            realtime = traces.combine_logs_to_realtime_data(structured_logs, replicas)
            records = realtime.to_json()
            if self._use_device_stats and trace_groups and records:
                p.stats_job = DeviceStatsJob(records, self.device)

        p.trace_groups = trace_groups
        p.realtime = realtime
        p.dependencies = dependencies
        if trace_groups:
            with _stage(p.stages, "span_batch"), step_timer.phase("graph_merge"), phase_span("merge"):
                p.batch = spans_to_batch(trace_groups, interner=self.graph.interner)
        return p

    def merge_prepared(self, p: _PreparedTick) -> None:
        """The tick's graph merge (the host walk's edge set when every
        endpoint is interned, else the device walk over the span batch),
        then the history-feature accumulation."""
        if not p.trace_groups or p.merged:
            return
        with step_timer.phase("graph_merge"), profiling.trace("graph_merge"), phase_span("merge"):
            if p.window_edges is None or not self.graph.merge_window_edges(p.window_edges, p.batch):
                self.graph.merge_window(p.batch)
        # the history feed of the model plane's scorers (the JAX phase name)
        with _stage(p.stages, "history"), phase_span("scorers"):
            self._observe_history(p.batch, p.req_time)

    def prepare_batched_merge(self, p: _PreparedTick):
        """The tick's window as interned id columns for the router's
        stacked merge, or None when it cannot join a stack (no spans, no
        host edge set, already merged, or an endpoint the interner lacks);
        merge_prepared then merges it serially."""
        if not p.trace_groups or p.merged or p.window_edges is None:
            return None
        return self.graph.intern_window_edges(p.window_edges)

    def adopt_batched_merge(self, p: _PreparedTick, src_row, dst_row, dist_row, count, cols, expected_version) -> None:
        """Take this tick's lane of a stacked same-bucket union as its
        merge (tenancy/router.py), then the history feed. Raises
        StoreVersionDrift when the graph moved past the stack's snapshot
        (the router then merges serially: a set union, the same edges)."""
        _src_l, _dst_l, dist_l = cols
        with step_timer.phase("graph_merge"), phase_span("merge"):
            self.graph.adopt_batched_merged(
                src_row, dst_row, dist_row, count, p.batch, max(dist_l), min(dist_l),
                expected_version=expected_version,
            )
        p.merged = True
        with _stage(p.stages, "history"), phase_span("scorers"):
            self._observe_history(p.batch, p.req_time)

    def finish_tick(self, p: _PreparedTick) -> dict:
        """The tick's response assembly: device-stats drain + host body
        merge + datatypes, the scorecard and freshness observations, the
        response dict (its dependencies as the object with p.objects, see
        collect)."""
        with _stage(p.stages, "combine_assemble"), step_timer.phase("combine_assemble"), profiling.trace(
            "combine_assemble"
        ), phase_span("assemble"):
            combined = self._combine(p.realtime, p.stats_job)
            datatypes = [d.to_json() for d in combined_list_datatypes(combined)]
        elapsed = prof_events.now_ms() - p.wall_t0
        tel_slo.SCORECARD.observe_tick(elapsed)
        tel_slo.TENANTS.observe_tick(self.tenant, elapsed)
        # the window stamped at the tick's start is now forecast-visible
        fresh_ns = prof_events.now_ns() - p.arrival_ns
        tel_freshness.observe(fresh_ns / 1e6)
        prof_events.emit("freshness", fresh_ns)
        with phase_span("assemble"):
            # the response's shape is assembly work too (the HTTP encode is
            # the server's encode-serve span)
            if p.objects:
                dependencies = p.dependencies
            elif p.dependency_records is not None:
                dependencies = p.dependency_records
            else:
                dependencies = p.dependencies.to_json()
            return {
                "uniqueId": p.request.get("uniqueId", ""),
                "combined": combined.to_json(),
                "dependencies": dependencies,
                "datatype": datatypes,
                "log": (
                    f"processed {sum(len(g) for g in p.trace_groups)} spans / "
                    f"{len(p.trace_groups)} traces in {elapsed:.1f}ms "
                    f"(device={self.device})"
                ),
            }

    # -- online history features (models/history.HistoryState) ---------------

    #: empty-hour catch-up bound: past this, the delta/rolling context is
    #: stale regardless, so the stream resumes at the current hour
    HISTORY_MAX_CATCHUP_HOURS = 48

    def _observe_history(self, batch, req_time_ms: float) -> None:
        """Accumulate this tick's per-endpoint SERVER-span stats into the
        current hour's bucket; when the hour rolls over, fold the completed
        bucket (and a zero-activity bucket for each quiet hour between) and
        publish the forecast snapshot.

        A request whose clock runs behind the current bucket accumulates
        into it instead of folding a partial hour early, and one whose
        clock runs ahead of the server's clamps to the server's, so a
        skewed client cannot advance the bucket past wall time."""
        n_ep = len(self.graph.interner.endpoints)
        abs_hour = int(min(req_time_ms, self._now_ms()) // 3_600_000)
        sel = batch.valid & (batch.kind == KIND_SERVER)
        eids = batch.endpoint_id[sel]
        # host-side hour-bucket accumulators; float64 keeps long-run sums exact
        err4 = (batch.status_class[sel] == 4).astype(np.float64)
        err5 = (batch.status_class[sel] == 5).astype(np.float64)
        lat = np.asarray(batch.latency_ms, dtype=np.float64)[sel]
        scls = np.clip(np.asarray(batch.status_class, dtype=np.int64)[sel], 0, 5)

        with self._history_lock:
            if self.history is None:
                self.history = HistoryState(n_ep)
            if self._hour_bucket is not None and abs_hour > self._hour_bucket[0]:
                completed_hour = self._hour_bucket[0]
                self._fold_hour_locked(*self._hour_bucket)
                # zero-activity folds for fully quiet hours in between, so
                # the state sees every hour once, in order
                gap_first = completed_hour + 1
                gap_last = abs_hour - 1
                if gap_last - gap_first + 1 > self.HISTORY_MAX_CATCHUP_HOURS:
                    gap_first = gap_last - self.HISTORY_MAX_CATCHUP_HOURS + 1
                m = self.history.num_endpoints
                for h in range(gap_first, gap_last + 1):
                    self._fold_hour_locked(
                        h,
                        *(np.zeros(m) for _ in range(5)),
                        *(np.zeros((m, 6)) for _ in range(3)),
                    )
                self._hour_bucket = None
            if self._hour_bucket is None:
                self._hour_bucket = [
                    abs_hour,
                    *(np.zeros(n_ep) for _ in range(5)),  # count, err4, err5, lat, lat^2
                    *(np.zeros((n_ep, 6)) for _ in range(3)),  # per status class
                ]
            bucket = self._hour_bucket
            if len(bucket[1]) < n_ep:  # new endpoints interned this tick
                grow = n_ep - len(bucket[1])
                for i in range(1, 6):
                    bucket[i] = np.concatenate([bucket[i], np.zeros(grow)])
                for i in range(6, 9):
                    bucket[i] = np.concatenate([bucket[i], np.zeros((grow, 6))])
            np.add.at(bucket[1], eids, 1.0)
            np.add.at(bucket[2], eids, err4)
            np.add.at(bucket[3], eids, err5)
            np.add.at(bucket[4], eids, lat)
            np.add.at(bucket[5], eids, lat * lat)
            np.add.at(bucket[6], (eids, scls), 1.0)
            np.add.at(bucket[7], (eids, scls), lat)
            np.add.at(bucket[8], (eids, scls), lat * lat)

    def _fold_hour_locked(
        self,
        hour,
        count,
        err4_sum,
        err5_sum,
        lat_sum,
        lat_sq_sum,
        cls_count,
        cls_lat,
        cls_lat_sq,
    ) -> None:
        """Fold one completed hour into the state (5xx share, log1p mean
        latency, active = saw traffic), assemble the full model-feature
        matrix for the predicted hour, and publish the forecast snapshot:
        features plus the graph's edges and names as of this fold. Caller
        holds _history_lock.

        Latency CV is the count-weighted mean of per-(endpoint, status
        class) CVs from the sum-of-squares identity."""
        safe = np.maximum(count, 1.0)
        lat_mean = lat_sum / safe
        # the edge columns cross to the host once per fold, in one copy
        src, dst, _dist, mask = self.graph.edge_arrays()
        cols = torch.stack([src, dst, mask.to(torch.int32)]).cpu().numpy()
        src, dst, mask = cols[0], cols[1], cols[2].astype(bool)
        self.history.set_degrees(src, dst, mask, len(count))
        hist_cols = self.history.step(
            hour % 24,
            err5_sum / safe,
            np.log1p(lat_mean),
            count > 0,
        )
        self.history_features = hist_cols
        self.history_predicted_hour = (hour % 24 + 1) % 24
        cls_safe = np.maximum(cls_count, 1.0)
        cls_mean = cls_lat / cls_safe
        cls_var = np.maximum(cls_lat_sq / cls_safe - cls_mean * cls_mean, 0.0)
        cls_cv = np.sqrt(cls_var) / np.maximum(cls_mean, 1e-9)
        cv = (cls_count * cls_cv).sum(axis=1) / safe
        n = len(count)
        replicas = np.ones(n, dtype=np.float32)
        if self._last_replicas:
            interner = self.graph.interner
            for eid in range(n):
                svc_name = interner.services.lookup(interner.service_of(eid))
                replicas[eid] = self._last_replicas.get(svc_name, 1.0)
        base = graphsage.assemble_features(
            count / SLOT_SECONDS,
            err4_sum / safe,
            err5_sum / safe,
            np.log1p(lat_mean),
            cv,
            replicas,
            np.log1p(count),
            count > 0,
            hour_of_day=float(self.history_predicted_hour),
        )
        self.history_model_features = np.concatenate([base, hist_cols], axis=1)
        interner = self.graph.interner
        self.forecast_snapshot = {
            "features": self.history_model_features,
            "src": src,
            "dst": dst,
            "mask": mask,
            "names": [interner.endpoints.lookup(i) for i in range(n)],
            "predicted_hour": self.history_predicted_hour,
            # the forecast memo's key: the served forecast is a pure
            # function of the graph at fold time and the hour folded
            "cache_key": (
                int(self.graph.version),
                int(self.graph.label_epoch),
                int(hour),
            ),
        }
        # STLGT continual-training hook (KMAMIZ_STLGT=1): each fold becomes
        # an online example and may trigger a stale-slot refresh on this
        # processor's device. A trainer failure must not take the fold
        # down: it is counted, logged, and the fold goes on.
        try:
            from kmamiz_tpu_torch.models import stlgt as _stlgt

            _stlgt.on_fold(self.forecast_snapshot, device=self.device)
        except Exception:  # noqa: BLE001 - containment, counted
            self.fold_errors["stlgtFoldErrors"] += 1
            res_metrics.incr("stlgtFoldErrors")
            logger.exception("STLGT fold hook failed")
        # the control plane's recompute (KMAMIZ_CONTROL=1): admission,
        # warm-up and scheduling decisions are computed only here, at the
        # fold; the serving edge reads the stored verdict. Contained as
        # the STLGT hook is.
        try:
            from kmamiz_tpu_torch import control as _control

            _control.on_fold(self.tenant, self.forecast_snapshot)
        except Exception:  # noqa: BLE001 - containment, counted
            self.fold_errors["controlFoldErrors"] += 1
            res_metrics.incr("controlFoldErrors")
            logger.exception("control fold hook failed")

    # -- history persistence (server/cacheables.CModelHistoryState) ---------

    #: endpoints per snapshot part: bounds any single store document to a
    #: few MB (Mongo caps BSON documents at 16 MB; one monolithic doc at
    #: 10k+ endpoints would brush against it)
    HISTORY_SNAPSHOT_CHUNK = 2048

    def snapshot_history(self) -> "Optional[list]":
        """Serializable snapshot of the whole online model state:
        HistoryState accumulators, the in-progress hour bucket, and the
        published forecast snapshot — everything keyed by endpoint NAME
        (ids shift across restarts). Returns a LIST of part documents
        (endpoint ranges of HISTORY_SNAPSHOT_CHUNK) so no single store
        document outgrows a backend's size cap; None before the first
        observed tick. Rides the dispatch cron + shutdown syncAll like
        every other live cache (CModelHistoryState).

        Lock discipline: only cheap array memcpys happen under
        _history_lock; the base64 encoding of what can be tens of MB runs
        after release, so a flush never stalls the realtime tick."""
        from kmamiz_tpu_torch.models.history import HistoryState, encode_array

        with self._history_lock:
            if self.history is None:
                return None
            saved_at = self._now_ms()
            state_arrays = {
                f: np.array(getattr(self.history, f))
                for f in HistoryState._ARRAY_FIELDS
            }
            window = [np.array(w) for w in self.history._window]
            started = self.history._started
            n_state = self.history.num_endpoints
            bucket = (
                None
                if self._hour_bucket is None
                else [self._hour_bucket[0]]
                + [np.array(a) for a in self._hour_bucket[1:]]
            )
            hist_feats = (
                None
                if self.history_features is None
                else np.array(self.history_features)
            )
            model_feats = (
                None
                if self.history_model_features is None
                else np.array(self.history_model_features)
            )
            predicted_hour = self.history_predicted_hour
            # the forecast snapshot dict is replaced wholesale on fold and
            # its arrays never mutate: safe to reference outside the lock
            snap = self.forecast_snapshot
        interner = self.graph.interner
        n_names = max(n_state, len(bucket[1]) if bucket else 0)
        names = [interner.endpoints.lookup(i) for i in range(n_names)]
        chunk = self.HISTORY_SNAPSHOT_CHUNK
        parts = max(1, -(-max(n_names, 1) // chunk))
        docs = []
        for p in range(parts):
            lo, hi = p * chunk, min((p + 1) * chunk, n_names)
            doc = {
                "savedAt": saved_at,
                "part": p,
                "parts": parts,
                "names": names[lo:hi],
                "state": {
                    "n": max(0, min(n_state, hi) - lo),
                    "started": started,
                    "window": [
                        encode_array(w[..., lo:hi]) for w in window
                    ],
                    **{
                        f.lstrip("_"): encode_array(
                            state_arrays[f][..., lo:hi]
                        )
                        for f in HistoryState._ARRAY_FIELDS
                    },
                },
                "hourBucket": None,
                "forecast": None,
                "historyFeatures": None,
                "modelFeatures": None,
                "predictedHour": predicted_hour,
            }
            if bucket is not None:
                doc["hourBucket"] = {
                    "hour": int(bucket[0]),
                    "arrays": [encode_array(a[lo:hi]) for a in bucket[1:]],
                }
            if hist_feats is not None:
                doc["historyFeatures"] = encode_array(hist_feats[lo:hi])
            if model_feats is not None:
                doc["modelFeatures"] = encode_array(model_feats[lo:hi])
            if p == 0 and snap is not None:
                # edge arrays are not per-endpoint; they live on part 0
                doc["forecast"] = {
                    "features": encode_array(np.asarray(snap["features"])),
                    "src": encode_array(np.asarray(snap["src"])),
                    "dst": encode_array(np.asarray(snap["dst"])),
                    "mask": encode_array(np.asarray(snap["mask"])),
                    "names": list(snap["names"]),
                    "predictedHour": snap["predicted_hour"],
                }
            docs.append(doc)
        return docs

    @staticmethod
    def _assemble_snapshot_parts(docs) -> "Optional[dict]":
        """Pick the newest COMPLETE part set from stored snapshot
        documents and merge it back into one logical snapshot."""
        from kmamiz_tpu_torch.models.history import decode_array

        groups: Dict[float, list] = {}
        for d in docs or []:
            groups.setdefault(d.get("savedAt", 0), []).append(d)
        for saved_at in sorted(groups, reverse=True):
            parts = sorted(groups[saved_at], key=lambda d: d.get("part", 0))
            want = parts[0].get("parts", len(parts))
            if len(parts) != want or [
                d.get("part", 0) for d in parts
            ] != list(range(want)):
                continue  # torn write: fall back to the next-newest set
            if want == 1:
                return parts[0]

            def cat(getter, axis):
                # returns the DECODED concatenation: downstream decode_array
                # passes ndarrays through, so the boot restore never
                # re-encodes the multi-MB snapshot just to re-decode it
                arrs = [decode_array(getter(d)) for d in parts]
                return np.concatenate(arrs, axis=axis)

            first = parts[0]
            merged = {
                "savedAt": saved_at,
                "names": [nm for d in parts for nm in d["names"]],
                "state": {
                    "n": sum(d["state"]["n"] for d in parts),
                    "started": first["state"]["started"],
                    "window": [
                        cat(lambda d, i=i: d["state"]["window"][i], -1)
                        for i in range(len(first["state"]["window"]))
                    ],
                    **{
                        k: cat(lambda d, k=k: d["state"][k], -1)
                        for k in first["state"]
                        if k not in ("n", "started", "window")
                    },
                },
                "hourBucket": None,
                "forecast": first.get("forecast"),
                "historyFeatures": None,
                "modelFeatures": None,
                "predictedHour": first.get("predictedHour"),
            }
            if first.get("hourBucket") is not None:
                merged["hourBucket"] = {
                    "hour": first["hourBucket"]["hour"],
                    "arrays": [
                        cat(lambda d, i=i: d["hourBucket"]["arrays"][i], 0)
                        for i in range(len(first["hourBucket"]["arrays"]))
                    ],
                }
            for key in ("historyFeatures", "modelFeatures"):
                if first.get(key) is not None:
                    merged[key] = cat(lambda d, k=key: d[k], 0)
            return merged
        return None

    @staticmethod
    def _scatter_rows(a: np.ndarray, ids: np.ndarray, n_new: int):
        """Re-key a per-endpoint row array: saved row i lands at row
        ids[i] of a fresh n_new-row layout (trailing dims preserved)."""
        out = np.zeros((n_new,) + a.shape[1:], dtype=a.dtype)
        k = min(len(a), len(ids))
        out[ids[:k]] = a[:k]
        return out

    def restore_history(self, docs) -> None:
        """Rebuild the online model state from stored snapshot_history
        documents (boot path; live state always wins over a late
        restore). Saved endpoint names re-intern in THIS process — ids
        shift across restarts — and every per-endpoint column scatters
        to its new id. The forecast snapshot restores verbatim (it is
        self-contained: its edge ids index its own names list), so
        /model/forecast serves immediately after a restart, bit-equal to
        pre-restart. A downtime gap folds later as the existing
        zero-activity catch-up when the first live tick arrives."""
        from kmamiz_tpu_torch.models.history import HistoryState, decode_array

        if isinstance(docs, dict):
            docs = [docs]
        doc = self._assemble_snapshot_parts(docs)
        if doc is None:
            return
        with self._history_lock:
            if self.history is not None:
                return  # live state outranks a stored snapshot
            names = doc.get("names") or []
            interner = self.graph.interner
            ids = np.asarray(
                [interner.intern_endpoint(nm) for nm in names],
                dtype=np.int64,
            )
            n_new = len(interner.endpoints)
            state = HistoryState.from_doc(doc["state"])
            state.remap(ids, n_new)
            self.history = state
            bucket = doc.get("hourBucket")
            if bucket is not None:
                self._hour_bucket = [int(bucket["hour"])] + [
                    self._scatter_rows(decode_array(a), ids, n_new)
                    for a in bucket["arrays"]
                ]
            if doc.get("historyFeatures") is not None:
                self.history_features = self._scatter_rows(
                    decode_array(doc["historyFeatures"]), ids, n_new
                )
            if doc.get("modelFeatures") is not None:
                self.history_model_features = self._scatter_rows(
                    decode_array(doc["modelFeatures"]), ids, n_new
                )
            self.history_predicted_hour = doc.get("predictedHour")
            fc = doc.get("forecast")
            if fc is not None:
                self.forecast_snapshot = {
                    "features": decode_array(fc["features"]),
                    "src": decode_array(fc["src"]),
                    "dst": decode_array(fc["dst"]),
                    "mask": decode_array(fc["mask"]),
                    "names": list(fc["names"]),
                    "predicted_hour": fc["predictedHour"],
                    # the forecast memo's key: no fold's (its hour is >= 0)
                    "cache_key": (int(self.graph.version), int(self.graph.label_epoch), -1),
                }

    # -- hybrid combine: device numeric stats + host body merge --------------

    def _combine(
        self, realtime: RealtimeDataList, stats_job: Optional["DeviceStatsJob"]
    ) -> CombinedRealtimeDataList:
        if stats_job is None:
            return realtime.to_combined_realtime_data()

        # numeric stats come from the device, whose interner also keys
        # segments by the raw status value
        group_items = record_groups(realtime.to_json())

        # the body merge runs BEFORE blocking on the device result, so the
        # copy back hides behind it
        merged_bodies = schema.merge_and_infer_bodies(
            schema.body_pairs_for_groups([rows for _key, rows in group_items])
        )

        # the one device-to-host fence the tick already pays: the span
        # boundary rides it
        with phase_span("host-transfer"):
            stats = stats_job.result()
        out: List[dict] = []
        for i, ((uen, status), rows) in enumerate(group_items):
            # both sides key segments by the RAW status value (spans without
            # http.status_code carry None), so two statuses that stringify
            # identically (None vs "None") stay distinct on host and device
            seg_stats = stats[(uen, status)]
            sample = rows[0]

            replica = rows[0].get("replica")
            for curr in rows[1:]:
                if replica and curr.get("replica"):
                    replica += curr["replica"]

            request_body, request_schema = merged_bodies[2 * i]
            response_body, response_schema = merged_bodies[2 * i + 1]
            out.append(
                {
                    "uniqueServiceName": sample["uniqueServiceName"],
                    "uniqueEndpointName": uen,
                    "service": sample["service"],
                    "namespace": sample["namespace"],
                    "version": sample["version"],
                    "method": sample["method"],
                    "status": status,
                    "combined": seg_stats["count"],
                    "requestBody": request_body,
                    "requestSchema": request_schema,
                    "responseBody": response_body,
                    "responseSchema": response_schema,
                    "avgReplica": (replica / len(rows)) if replica else None,
                    "latestTimestamp": seg_stats["latest_timestamp"],
                    "latency": {
                        "mean": to_precise(seg_stats["mean"]),
                        "cv": to_precise(seg_stats["cv"]),
                    },
                    "requestContentType": sample.get("requestContentType"),
                    "responseContentType": sample.get("responseContentType"),
                }
            )
        return CombinedRealtimeDataList(out)


def record_groups(records: List[dict]) -> List[Tuple[tuple, List[dict]]]:
    """Realtime records grouped by (uniqueEndpointName, raw status), in
    first-seen order: the unit of the tick's body merge and of its
    combined records."""
    groups: Dict[tuple, List[dict]] = {}
    for r in records:
        groups.setdefault((r["uniqueEndpointName"], r["status"]), []).append(r)
    return list(groups.items())


class StatsColumns(NamedTuple):
    """A tick's realtime records as the padded host columns window_stats
    takes, with the interners that decode its segments."""

    endpoint_id: np.ndarray  # int32[cap]
    status_id: np.ndarray  # int32[cap]
    status_class: np.ndarray  # int8[cap]
    latency_ms: np.ndarray  # float32[cap]
    timestamp_rel: np.ndarray  # int32[cap] (µs offset from ts_base)
    valid: np.ndarray  # bool[cap]
    ts_base: int
    endpoints: StringInterner
    statuses: StringInterner
    num_endpoints: int  # pow2 bucket of len(endpoints)
    num_statuses: int  # pow2 bucket of len(statuses)


def stats_columns(records: List[dict]) -> StatsColumns:
    """Intern and pad realtime records for window_stats."""
    endpoints = StringInterner()
    statuses = StringInterner()
    n = len(records)
    cap = 8
    while cap < n:
        cap *= 2

    eid = np.zeros(cap, dtype=np.int32)
    sid = np.zeros(cap, dtype=np.int32)
    scl = np.zeros(cap, dtype=np.int8)
    lat = np.zeros(cap, dtype=np.float32)
    ts_abs = np.zeros(n, dtype=np.int64)
    valid = np.zeros(cap, dtype=bool)
    # intern the RAW status value (None, int, or str are all hashable);
    # the status class still derives from its string form. Interning raw
    # keeps device segments aligned with the host's raw-status groupby.
    for i, r in enumerate(records):
        eid[i] = endpoints.intern(r["uniqueEndpointName"])
        sid[i] = statuses.intern(r["status"])
        s = str(r["status"])
        scl[i] = int(s[0]) if s[:1].isdigit() else 0
        lat[i] = r["latency"]
        ts_abs[i] = r["timestamp"]
        valid[i] = True
    ts_base = int(ts_abs.min()) if n else 0
    ts_rel = np.zeros(cap, dtype=np.int32)
    ts_rel[:n] = (ts_abs - ts_base).astype(np.int32)
    # pow2 segment buckets, as in the JAX package (where they bound the
    # set of compiled programs): per-segment sums are unchanged, padded
    # segments receive no rows, and the decode uses the bucketed stride
    return StatsColumns(
        eid,
        sid,
        scl,
        lat,
        ts_rel,
        valid,
        ts_base,
        endpoints,
        statuses,
        _pad_size(max(len(endpoints), 1)),
        _pad_size(max(len(statuses), 1)),
    )


class DeviceStatsJob:
    """Asynchronous device segment-stats over realtime records: the
    constructor uploads the columns, runs window_stats and starts the
    packed result's copy into pinned host memory; result() waits only for
    whatever has not already overlapped with host work."""

    def __init__(self, records: List[dict], device: torch.device) -> None:
        cols = stats_columns(records)
        self._cols = cols

        def put(a):
            return torch.from_numpy(a).to(device)

        stats = window_ops.window_stats(
            put(cols.endpoint_id),
            put(cols.status_id),
            put(cols.status_class),
            put(cols.latency_ms),
            put(cols.timestamp_rel),
            put(cols.valid),
            num_endpoints=cols.num_endpoints,
            num_statuses=cols.num_statuses,
        )
        packed = _pack_stats(
            stats.count,
            stats.latency_mean,
            stats.latency_cv,
            stats.latest_timestamp_rel,
        )
        # ONE copy back, into pinned memory so it runs asynchronously
        on_card = device.type == "cuda"
        self._host = torch.empty(
            packed.shape, dtype=torch.float32, pin_memory=on_card
        )
        self._host.copy_(packed, non_blocking=on_card)
        self._ready = None
        if on_card:
            self._ready = torch.cuda.Event()
            self._ready.record()

    def result(self) -> Dict[tuple, dict]:
        if self._ready is not None:
            self._ready.synchronize()
        cols = self._cols
        packed = self._host.numpy()
        count, mean, cv = packed[0], packed[1], packed[2]
        ts = packed[3].view(np.int32).astype(np.int64) + cols.ts_base

        out: Dict[tuple, dict] = {}
        for e in range(len(cols.endpoints)):
            for s in range(len(cols.statuses)):
                seg = e * cols.num_statuses + s
                if count[seg] > 0:
                    out[(cols.endpoints.lookup(e), cols.statuses.lookup(s))] = {
                        "count": int(count[seg]),
                        "mean": float(mean[seg]),
                        "cv": float(cv[seg]),
                        "latest_timestamp": int(ts[seg]),
                    }
        return out


def combined_list_datatypes(combined) -> list:
    """Datatype extraction from combined data (the per-window slice of
    CombinedRealtimeDataList.extractEndpointDataType)."""
    return combined.extract_endpoint_data_type()

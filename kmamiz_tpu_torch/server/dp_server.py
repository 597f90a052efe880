"""HTTP server speaking the external Data Processor protocol.

Counterpart of kmamiz_tpu/server/dp_server.py, the sibling of the
reference's Rust service (KMamiz kmamiz_data_processor/src/main.rs:28-79):
GET / answers health (with the process's segment-stats kernel
launches and the boot prewarm's state; 503 {"status": "WARMING"} while
the prewarm runs, see core/prewarm.py), POST / takes a TExternalDataProcessorRequest
({uniqueId, lookBack, time, existingDep}) and returns a
TExternalDataProcessorResponse ({uniqueId, combined, dependencies,
datatype, log}). POST /ingest takes a raw Zipkin response body (trace
groups, or a KMZC columnar frame) into the processor's graph, uncapped,
and answers the ingest summary; a large JSON body streams through
ingest_raw_stream in chunks of whole trace groups. GET /model/stlgt
answers the STLGT continual trainer's health (ring, stale slots,
refreshes, params version). Gzip request bodies (Content-Encoding: gzip)
are accepted; responses are gzip-compressed when the client sends
Accept-Encoding: gzip.

Telemetry, at the JAX server's paths: GET /metrics (the registry as
Prometheus text 0.0.4), GET /timings (the step timer's phases, the
resilience summary, the per-tenant scorecard, freshness and the stream
engine's counters), GET /debug/traces (the tick-span ring as Zipkin v2
trace groups, which POST /ingest takes back: the self-trace), GET
/debug/graftprof (the live profile of the profiler's event ring) and
POST /debug/profile ({"durationMs": N, "dir": optional}: a torch.profiler
capture of whatever the process runs meanwhile, 409 while one runs).
Each tick is a trace rooted at `dp-tick` (an /ingest at `dp-ingest`), the
answer's encode its `encode-serve` span, and with KMAMIZ_TRANSFER_GUARD
set it runs under the sync guard (analysis/guards.py).

A tick runs under the tick watchdog (resilience/watchdog.py,
KMAMIZ_TICK_DEADLINE_MS) and, with KMAMIZ_STREAM=1, as a micro-tick of
the stream engine (server/stream.py). A tick that overruns its deadline
or faults is answered with the last good tick's payload, marked `stale`
with `staleAgeMs` and `staleReason` (and the X-KMamiz-Stale-Age-Ms
header); only before the first good tick does it answer 503 (deadline)
or 500 (fault). A malformed /ingest payload is quarantined and answered
200 with the zero-span summary (400 with KMAMIZ_QUARANTINE=0).

Run standalone, configured from the environment like the Rust service
(kmamiz_data_processor/src/env.rs):

    python -m kmamiz_tpu_torch.server.dp_server

Tenants, as in the JAX server: a request names its tenant by a
``/t/<tenant>/`` path prefix or the tenant header (tenancy/router.py's
TENANT_HEADER, ``x-kmamiz-tenant``); neither is the default tenant, whose
processor is the server's. Each tenant gets a runtime on its first
request (its processor from `sibling_for_tenant`, with its own WAL
namespace replayed first, its last-good payload, watchdog and encode
cache); a bad tenant name answers 400 and a tenant past the arena's limit
429. With a gather window (`batch_window_ms` > 0) concurrent ticks of
several tenants run as one batch with one stacked merge
(TickRouter.submit). With KMAMIZ_CONTROL=1 the control plane's stored
verdict is read before the tick: shed answers 429 with Retry-After,
defer the tenant's last good payload marked `deferred` (and the
X-KMamiz-Control header); a tick with "priority": "high" always runs.
/timings carries `tenancy` and `control`, /metrics the tenant labels.

The fleet's routes, per tenant (the /t/<tenant>/ prefix or the header),
as the JAX server has them: GET /fleet/signature (the tenant's graph
signature), /fleet/export (its edges by endpoint name, for the
coordinator's fold) and /fleet/wal (its WAL as one handoff blob, 409 with
the WAL off); POST /fleet/drain (the stage fence, then the pre-drain
signature and durable record count), /fleet/wal-import (the blob replayed
into a new processor that waits, staged, for the commit), /fleet/wal-commit
(the staged runtime installed into the router), /fleet/wal-abort (the
staged runtime dropped) and /fleet/drop (the migrated-away tenant's
runtime forgotten). /timings carries `fleet`.

Left out of the JAX server: the /timings sections of parts the port does
not have (programs and cost: nothing is compiled per shape). /timings
carries `lockWitness`, the runtime lock witness's snapshot, which main()
arms before the processor exists under KMAMIZ_LOCK_WITNESS=1.
"""
from __future__ import annotations

import gzip
import json
import logging
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

from kmamiz_tpu_torch import control as ctl_plane
from kmamiz_tpu_torch import fleet as fleet_mod
from kmamiz_tpu_torch import native
from kmamiz_tpu_torch.analysis import guards
from kmamiz_tpu_torch.core import prewarm, wire
from kmamiz_tpu_torch.core.profiling import step_timer
from kmamiz_tpu_torch.device import DeviceLike
from kmamiz_tpu_torch.graph.store import graph_signature
from kmamiz_tpu_torch.ops.segment_stats import segment_stats
from kmamiz_tpu_torch.resilience import metrics as res_metrics
from kmamiz_tpu_torch.resilience.watchdog import (
    REASON_FAULT,
    TickDeadlineExceeded,
    TickWatchdog,
)
from kmamiz_tpu_torch.server import stream as stream_mod
from kmamiz_tpu_torch.server.processor import DEFAULT_STREAM_CHUNKS, DataProcessor
from kmamiz_tpu_torch.telemetry import REGISTRY as TEL_REGISTRY
from kmamiz_tpu_torch.telemetry import TRACER
from kmamiz_tpu_torch.telemetry import device as tel_device
from kmamiz_tpu_torch.telemetry import freshness as tel_freshness
from kmamiz_tpu_torch.telemetry import slo as tel_slo
from kmamiz_tpu_torch.telemetry.profiling import events as prof_events
from kmamiz_tpu_torch.telemetry.profiling import report as prof_report
from kmamiz_tpu_torch.tenancy.arena import DEFAULT_TENANT, TenantLimitError, TenantNameError
from kmamiz_tpu_torch.tenancy.router import (
    BATCH_WINDOW_MS,
    TenantResolutionError,
    TenantRuntime,
    TickRouter,
    resolve_tenant,
)

logger = logging.getLogger("kmamiz_tpu_torch.dp_server")

#: decompressed /ingest bodies from this size on stream
#: (KMAMIZ_INGEST_STREAM_BYTES's default): 32 MiB
DEFAULT_STREAM_BYTES = 32 << 20
#: the gzip level of responses: a tick's answer carries the window's whole
#: dependency records (~20 MB of JSON at 10,000 endpoints), which level 9
#: (gzip.compress's default, the JAX server's) takes ~0.7 s to compress on
#: a host core and level 1 ~0.1 s, for ~1.7x the bytes; the client reads
#: the same JSON either way
GZIP_LEVEL = 1
#: the content type of Prometheus text exposition 0.0.4
PROMETHEUS_TEXT = "text/plain; version=0.0.4; charset=utf-8"
#: the listen backlog: several tenants' ticks connect at once (the gather
#: window coalesces them), and past socketserver's default of 5 a
#: connection's SYN is dropped and retried a second later, out of the window
LISTEN_BACKLOG = 64


class _HTTPServer(ThreadingHTTPServer):
    request_queue_size = LISTEN_BACKLOG


class _LastGoodTick:
    """The newest successful tick response and when it was made. When a
    tick overruns its deadline or faults, the server answers with it,
    marked stale, instead of a 5xx that would send the host app's poller
    to its in-process fallback. Serving it is host work on a dict: no
    device call."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._payload: Optional[dict] = None
        self._at_ms: Optional[float] = None

    def update(self, payload: dict, version: int, label_epoch: int) -> None:
        now_ms = prof_events.wall_ms()
        with self._lock:
            self._payload = payload
            self._at_ms = now_ms
        res_metrics.note_last_good(version, label_epoch, now_ms)

    def serve_stale(self, unique_id: str, reason: str) -> Optional[dict]:
        """A copy of the last good payload addressed to this request, with
        the staleness spelled out; None before the first good tick."""
        with self._lock:
            if self._payload is None:
                return None
            payload = dict(self._payload)
            at_ms = self._at_ms
        payload["uniqueId"] = unique_id
        payload["stale"] = True
        payload["staleAgeMs"] = round(max(0.0, prof_events.wall_ms() - at_ms), 1)
        payload["staleReason"] = reason
        res_metrics.note_stale_serve()
        return payload

    def serve_deferred(self, unique_id: str, control: dict) -> Optional[dict]:
        """The control plane deferred this tick: the last good payload
        answers, marked `deferred` with the verdict. A chosen degradation,
        not a stale serve: no stale counter moves. None before the first
        good tick (the caller then admits the tick)."""
        with self._lock:
            if self._payload is None:
                return None
            payload = dict(self._payload)
            at_ms = self._at_ms
        payload["uniqueId"] = unique_id
        payload["deferred"] = True
        payload["deferredAgeMs"] = round(max(0.0, prof_events.wall_ms() - at_ms), 1)
        payload["control"] = control
        return payload


def encode_payload(payload: dict, encoded: Optional[dict] = None) -> bytes:
    """json.dumps(payload), encoded; the values of the keys in `encoded`
    are given as their JSON text already, which goes in as it is (the
    same bytes json.dumps would write)."""
    if not encoded:
        return json.dumps(payload).encode()
    return (
        "{"
        + ", ".join(
            f"{json.dumps(key)}: {encoded[key] if key in encoded else json.dumps(value)}"
            for key, value in payload.items()
        )
        + "}"
    ).encode()


class _EncodedPayloadCache:
    """Encoded response bytes by (uniqueId, graph version, label epoch):
    a retried request against an unchanged graph is answered with the
    bytes already encoded, not a second json.dumps + gzip."""

    def __init__(self, max_entries: int = 4) -> None:
        self._lock = threading.Lock()
        self._max = max_entries
        self._entries: "dict[tuple, bytes]" = {}

    def get_or_encode(
        self, key: tuple, payload: dict, use_gzip: bool, encoded: Optional[dict] = None
    ) -> bytes:
        full_key = key + (use_gzip,)
        with self._lock:
            body = self._entries.get(full_key)
        if body is not None:
            return body
        body = encode_payload(payload, encoded)
        if use_gzip:
            body = gzip.compress(body, compresslevel=GZIP_LEVEL)
        with self._lock:
            while len(self._entries) >= self._max:
                self._entries.pop(next(iter(self._entries)))
            self._entries[full_key] = body
        return body


def _make_runtime(tenant: str, proc: DataProcessor) -> TenantRuntime:
    """One tenant's serving state: its processor and its own last-good
    payload, watchdog and encode cache (per-instance state is the
    isolation: one tenant's overrun trips only its watchdog, its stale
    serve reads only its last-good payload)."""
    last_good = _LastGoodTick()
    # the deadline follows KMAMIZ_TICK_DEADLINE_MS (0 = off); a straggler
    # that finishes after its trip still refreshes last_good
    watchdog = TickWatchdog(
        on_late_result=lambda result: last_good.update(result, proc.graph.version, proc.graph.label_epoch)
        if isinstance(result, dict)
        else None
    )
    return TenantRuntime(tenant, proc, last_good=last_good, watchdog=watchdog, encoded_cache=_EncodedPayloadCache())


def make_handler(
    processor: DataProcessor,
    stream_bytes: int = DEFAULT_STREAM_BYTES,
    stream_chunks: int = DEFAULT_STREAM_CHUNKS,
    router: Optional[TickRouter] = None,
    batch_window_ms: float = BATCH_WINDOW_MS,
):
    if router is None:

        def _factory(tenant: str) -> TenantRuntime:
            if tenant == DEFAULT_TENANT:
                return _make_runtime(tenant, processor)
            proc = processor.sibling_for_tenant(tenant)
            # the tenant's own WAL namespace replays before its first
            # tick, so a restarted server answers from its recovered graph
            recovered = proc.replay_wal()
            if recovered["replayed"]:
                logger.info("tenant %s wal replay: %s", tenant, recovered)
            return _make_runtime(tenant, proc)

        router = TickRouter(_factory, batch_window_ms=batch_window_ms)

    # the fleet migration's two-phase import: /fleet/wal-import replays the
    # shipped blob into a runtime that waits here; only the coordinator's
    # /fleet/wal-commit, after its check, installs it into the router (an
    # aborted handoff drops it by /fleet/wal-abort, the tenant's live
    # runtime never touched)
    pending_lock = threading.Lock()
    pending_imports: dict = {}

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt: str, *args) -> None:  # quiet default logs
            logger.debug("%s " + fmt, self.address_string(), *args)

        def _route(self) -> Optional[Tuple[str, str]]:
            """(tenant, the path without its prefix), or None after
            answering 400 for a bad tenant name."""
            try:
                return resolve_tenant(self.headers, self.path)
            except (TenantResolutionError, TenantNameError) as e:
                self._send_json(400, {"error": str(e)})
                return None

        def _runtime(self, tenant: str) -> Optional[TenantRuntime]:
            """The tenant's runtime (made at its first request), or None
            after answering 429 (the tenant limit) or 400 (a bad name)."""
            try:
                return router.runtime(tenant)
            except TenantLimitError as e:
                self._send_json(429, {"error": str(e)})
            except TenantNameError as e:
                self._send_json(400, {"error": str(e)})
            return None

        def _send_bytes(self, status: int, body: bytes, content_type: str) -> None:
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(
            self,
            status: int,
            payload: dict,
            cache_key: Optional[tuple] = None,
            extra_headers: Optional[dict] = None,
            encoded_parts: Optional[dict] = None,
            cache: Optional[_EncodedPayloadCache] = None,
        ) -> None:
            encoded = "gzip" in self.headers.get("Accept-Encoding", "")
            if cache_key is not None and cache is not None:
                body = cache.get_or_encode(cache_key, payload, encoded, encoded_parts)
            else:
                body = json.dumps(payload).encode()
                if encoded:
                    body = gzip.compress(body, compresslevel=GZIP_LEVEL)
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            if encoded:
                self.send_header("Content-Encoding", "gzip")
            for name, value in (extra_headers or {}).items():
                self.send_header(name, str(value))
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self) -> None:  # health check (main.rs:28-31)
            route = self._route()
            if route is None:
                return
            tenant, path = route
            path = path.split("?", 1)[0].rstrip("/")
            if path == "/metrics":
                # the registry's cells: the same ones /timings reads
                self._send_bytes(200, TEL_REGISTRY.render().encode("utf-8"), PROMETHEUS_TEXT)
                return
            if path == "/timings":
                from kmamiz_tpu_torch.analysis.concurrency import witness

                self._send_json(
                    200,
                    {
                        "phases": step_timer.summary(),
                        "resilience": res_metrics.resilience_summary(),
                        "tenancy": router.summary(),
                        "tenants": tel_slo.TENANTS.snapshot(),
                        "control": ctl_plane.snapshot(),
                        "freshness": tel_freshness.snapshot(),
                        "stream": stream_mod.stats(),
                        "fleet": fleet_mod.snapshot(),
                        "lockWitness": witness.snapshot(),
                    },
                )
                return
            if path.startswith("/fleet/"):
                self._fleet_get(tenant, path)
                return
            if path == "/debug/traces":
                # POSTing this body back to /ingest builds the pipeline's
                # own dependency graph (self-trace)
                self._send_json(200, TRACER.export_zipkin())
                return
            if path == "/debug/graftprof":
                self._send_json(200, prof_report.build_profile())
                return
            if path == "/model/stlgt":
                from kmamiz_tpu_torch.models.stlgt import trainer as stlgt_trainer

                self._send_json(200, stlgt_trainer.trainer_status())
                return
            if path != "":
                self._send_json(404, {"error": f"no route {self.path}"})
                return
            # the boot prewarm (core/prewarm.py): 503 while it runs or
            # after it failed, unless KMAMIZ_PREWARM_READY_GATE=0
            warm = prewarm.warm_state()
            if prewarm.serving_blocked():
                status = "WARMING" if warm["status"] == "warming" else "ERROR"
                self._send_json(503, {"status": status, "prewarm": warm})
                return
            rt = self._runtime(tenant)
            if rt is None:
                return
            self._send_json(
                200,
                {
                    "status": "UP",
                    "service": "kmamiz-tpu-torch-data-processor",
                    "prewarm": warm,
                    "tenant": tenant,
                    "device": str(rt.processor.device),
                    # the tick's CUDA kernel launches in this process
                    "launches": {"segment_stats": segment_stats.launches},
                    # the tenant's last tick's stage walls
                    "lastTickStagesMs": dict(rt.processor.last_stage_ms),
                },
            )

        def do_POST(self) -> None:
            try:
                length = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(length)
                if self.headers.get("Content-Encoding") == "gzip":
                    raw = gzip.decompress(raw)
            except (ValueError, OSError, EOFError) as e:
                # EOFError: gzip.decompress raises it on a truncated stream
                self._send_json(400, {"error": f"bad request: {e}"})
                return
            route = self._route()
            if route is None:
                return
            tenant, path = route
            path = path.split("?", 1)[0].rstrip("/")
            if path == "/debug/profile":
                self._profile(raw)
                return
            if path.startswith("/fleet/"):
                self._fleet_post(tenant, path, raw)
                return
            if path not in ("", "/ingest"):
                self._send_json(404, {"error": f"no route {self.path}"})
                return
            if path == "":
                try:
                    request = json.loads(raw) if raw else {}
                except ValueError as e:
                    self._send_json(400, {"error": f"bad request: {e}"})
                    return
            rt = self._runtime(tenant)
            if rt is None:
                return
            if path == "/ingest":
                self._ingest(rt, raw)
                return
            self._tick(rt, request)

        def _admitted(self, rt: TenantRuntime, request: dict) -> bool:
            """The control plane's stored verdict, read before the tick:
            shed answers 429, defer the last good payload marked
            `deferred` (none yet: the tick runs); False when answered."""
            verdict = ctl_plane.admission_verdict(rt.tenant, request)
            if verdict is None:
                return True
            unique_id = request.get("uniqueId", "")
            if verdict["action"] == "shed":
                self._send_json(
                    429,
                    {
                        "uniqueId": unique_id,
                        "error": f"tick shed: forecasted p99 {verdict['forecastP99Ms']}ms exceeds SLO "
                        f"{verdict['sloMs']}ms (KMAMIZ_CONTROL)",
                        "control": verdict,
                    },
                    extra_headers={"Retry-After": "1", "X-KMamiz-Control": "shed"},
                )
                return False
            deferred = rt.last_good.serve_deferred(unique_id, verdict)
            if deferred is None:
                return True
            self._send_json(200, deferred, extra_headers={"X-KMamiz-Control": "defer"})
            return False

        def _tick(self, rt: TenantRuntime, request: dict) -> None:
            """POST /: the admission read, then one tick under the
            tenant's watchdog: in a gathered batch when the router's
            window is on, else serial or, with KMAMIZ_STREAM=1, a
            micro-tick of the stream engine."""
            if not self._admitted(rt, request):
                return
            tenant, processor, watchdog = rt.tenant, rt.processor, rt.watchdog
            unique_id = request.get("uniqueId", "")
            streaming = stream_mod.stream_enabled()
            if router.batch_window_ms > 0:
                # the deadline spans the whole gathered batch
                watchdog.end_stream_epoch()
                collect = lambda: router.submit(tenant, request)  # noqa: E731
            elif streaming:
                engine = stream_mod.engine_for(processor, watchdog)
                # the epoch accounting comes before the watchdog reads its
                # deadline: a boundary reads the env again
                engine.note_micro_tick()
                collect = lambda: engine.collect(request)  # noqa: E731
            else:
                # leaving stream mode must not strand an epoch's deadline
                watchdog.end_stream_epoch()
                collect = lambda: processor.collect(request)  # noqa: E731

            def tick():
                # under the sync guard when KMAMIZ_TRANSFER_GUARD asks
                with guards.maybe_guarded_tick(processor.device) as report:
                    result = collect()
                if report is not None:
                    logger.info("collect tick made %d synchronising calls", report.syncs)
                return result

            try:
                response = watchdog.run(
                    tick, overrun_reason=stream_mod.REASON_STREAM_OVERRUN if streaming else None
                )
            except TickDeadlineExceeded as e:
                logger.warning("collect tick degraded (tenant %s): %s", tenant, e)
                stale = rt.last_good.serve_stale(unique_id, e.reason)
                if stale is None:
                    self._send_json(503, {"error": str(e), "reason": e.reason})
                else:
                    tel_slo.TENANTS.note_stale(tenant)
                    self._send_stale(stale)
                return
            except Exception as e:  # noqa: BLE001 - degrade, else 500
                logger.exception("collect failed (tenant %s)", tenant)
                stale = rt.last_good.serve_stale(unique_id, REASON_FAULT)
                if stale is None:
                    self._send_json(500, {"error": str(e)})
                else:
                    res_metrics.watchdog_tripped(REASON_FAULT)
                    tel_slo.TENANTS.note_stale(tenant)
                    self._send_stale(stale)
                return
            graph = processor.graph
            version, label_epoch = graph.version, graph.label_epoch
            rt.last_good.update(response, version, label_epoch)
            # the dependency records the tick encoded in its fetch's shadow
            text = processor.take_encoded_dependencies(response.get("dependencies"))
            t_enc = prof_events.now_ms()
            self._send_json(
                200,
                response,
                cache_key=(unique_id, version, label_epoch),
                encoded_parts=None if text is None else {"dependencies": text},
                cache=rt.encoded_cache,
            )
            # the encode runs after the tick's trace closed (the tick itself
            # may have run on the watchdog's worker): a post-hoc span
            TRACER.annotate_last("encode-serve", prof_events.now_ms() - t_enc)

        def _send_stale(self, stale: dict) -> None:
            """The degraded answer: 200 and the last good payload, its
            staleness in the payload and in a header."""
            self._send_json(200, stale, extra_headers={"X-KMamiz-Stale-Age-Ms": stale["staleAgeMs"]})

        def _ingest(self, rt: TenantRuntime, raw: bytes) -> None:
            """POST /ingest: the body IS the Zipkin response (or a KMZC
            frame), into the tenant's graph. A decompressed JSON body of
            at least `stream_bytes` splits into `stream_chunks` chunks of
            whole trace groups and
            streams through processor.ingest_raw_stream (the parse of chunk
            k+1 overlaps the merge of chunk k; span-id maps are scoped per
            chunk); any other body, or one that splits into a single chunk,
            is one window through processor.ingest_raw_window. A malformed
            payload is quarantined and answered 200 with the zero-span
            summary (400 with KMAMIZ_QUARANTINE=0); any other failure
            answers 500."""
            processor = rt.processor
            try:
                summary = None
                with TRACER.tick(root_name="dp-ingest"):
                    # a KMZC frame is indivisible: the splitter reads JSON only
                    if len(raw) >= stream_bytes and not wire.is_columnar(raw):
                        chunks = native.split_groups(raw, stream_chunks)
                        if chunks is not None and len(chunks) > 1:
                            summary = processor.ingest_raw_stream(chunks)
                    if summary is None:
                        summary = processor.ingest_raw_window(raw)
            except ValueError as e:
                self._send_json(400, {"error": str(e)})
                return
            except Exception as e:  # noqa: BLE001 - answer 500, keep serving
                logger.exception("raw ingest failed")
                self._send_json(500, {"error": str(e)})
                return
            self._send_json(200, summary)

        def _fleet_get(self, tenant: str, path: str) -> None:
            """GET /fleet/signature, /fleet/export and /fleet/wal of the
            tenant's runtime."""
            if path not in ("/fleet/signature", "/fleet/export", "/fleet/wal"):
                self._send_json(404, {"error": f"no route {self.path}"})
                return
            rt = self._runtime(tenant)
            if rt is None:
                return
            if path == "/fleet/signature":
                # the migration's bit-exactness oracle
                self._send_json(200, {"tenant": tenant, "signature": graph_signature(rt.processor.graph)})
            elif path == "/fleet/export":
                # edges by endpoint name, for the coordinator's fold
                self._send_json(200, rt.processor.graph.export_named_edges())
            else:
                wal = rt.processor.wal
                if wal is None:
                    self._send_json(409, {"error": "WAL disabled (KMAMIZ_WAL=0): no handoff"})
                    return
                self._send_bytes(200, wal.export_handoff(), "application/octet-stream")

        def _fleet_post(self, tenant: str, path: str, raw: bytes) -> None:
            """The migration's steps on this worker: POST /fleet/drain (the
            source), /fleet/wal-import, /fleet/wal-commit, /fleet/wal-abort
            (the target) and /fleet/drop (the source after the flip)."""
            if path == "/fleet/drain":
                rt = self._runtime(tenant)
                if rt is None:
                    return
                rt.processor.graph.stage_fence()
                wal = rt.processor.wal
                self._send_json(
                    200,
                    {
                        "tenant": tenant,
                        "signature": graph_signature(rt.processor.graph),
                        "walRecords": wal.record_count() if wal is not None else 0,
                    },
                )
            elif path == "/fleet/wal-import":
                # a new processor and WAL namespace replay the shipped blob
                # in order; the runtime stages until /fleet/wal-commit
                proc = processor.sibling_for_tenant(tenant)
                if proc.wal is None:
                    self._send_json(409, {"error": "WAL disabled (KMAMIZ_WAL=0): no import"})
                    return
                try:
                    proc.wal.truncate()
                    records = proc.wal.import_handoff(raw)
                    replayed = proc.replay_wal()
                except ValueError as e:
                    self._send_json(400, {"error": str(e)})
                    return
                with pending_lock:
                    stale = pending_imports.pop(tenant, None)
                    pending_imports[tenant] = _make_runtime(tenant, proc)
                if stale is not None and stale.processor.wal is not None and stale.processor.wal is not proc.wal:
                    stale.processor.wal.close()
                self._send_json(
                    200,
                    {
                        "tenant": tenant,
                        "records": records,
                        "replayed": replayed["replayed"],
                        "spans": replayed["spans"],
                        "signature": graph_signature(proc.graph),
                    },
                )
            elif path == "/fleet/wal-commit":
                with pending_lock:
                    rt = pending_imports.pop(tenant, None)
                if rt is None:
                    self._send_json(409, {"error": f"no pending import for tenant {tenant!r}"})
                    return
                router.install_runtime(tenant, rt)
                self._send_json(200, {"tenant": tenant, "installed": True})
            elif path == "/fleet/wal-abort":
                with pending_lock:
                    rt = pending_imports.pop(tenant, None)
                if rt is not None and rt.processor.wal is not None:
                    rt.processor.wal.close()
                self._send_json(200, {"tenant": tenant, "dropped": rt is not None})
            elif path == "/fleet/drop":
                # exactly one worker keeps the migrated tenant's live state
                self._send_json(200, {"tenant": tenant, "dropped": router.drop_runtime(tenant)})
            else:
                self._send_json(404, {"error": f"no route {self.path}"})

        def _profile(self, raw: bytes) -> None:
            """POST /debug/profile: a torch.profiler capture of
            {"durationMs": N} (clamped), into {"dir": ...} or
            KMAMIZ_PROFILE_DIR; blocks for the window and answers the
            capture's file, 409 while another capture runs."""
            try:
                req = json.loads(raw) if raw else {}
            except ValueError as e:
                self._send_json(400, {"error": f"bad request: {e}"})
                return
            out = tel_device.capture_profile(req.get("durationMs", 100), req.get("dir"))
            self._send_json(200 if out.get("ok") else 409, out)

    Handler.router = router  # the server and its tests reach the router here
    return Handler


class DataProcessorServer:
    """The DP protocol on `host:port` (port 0 picks a free one), served
    from a background thread between start() and stop(), or on the
    caller's thread by serve_forever(). `stream_bytes` and
    `stream_chunks` set when and how POST /ingest streams a body;
    `batch_window_ms` is the tenants' gather window (0: every tick on its
    own); `router` replaces the default per-tenant sibling factory."""

    def __init__(
        self,
        processor: DataProcessor,
        host: str = "0.0.0.0",
        port: int = 8600,
        stream_bytes: int = DEFAULT_STREAM_BYTES,
        stream_chunks: int = DEFAULT_STREAM_CHUNKS,
        batch_window_ms: float = BATCH_WINDOW_MS,
        router: Optional[TickRouter] = None,
    ) -> None:
        self.processor = processor
        # the server answers in JSON: a tick may encode its dependency
        # records while its cluster fetch runs
        processor.encode_dependencies_early = True
        handler = make_handler(processor, stream_bytes, stream_chunks, router=router, batch_window_ms=batch_window_ms)
        #: the tenants' runtimes and the gathered dispatch
        self.router: TickRouter = handler.router
        self._server = _HTTPServer((host, port), handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="dp-server", daemon=True
        )
        self._thread.start()

    def serve_forever(self) -> None:
        self._server.serve_forever()

    def stop(self) -> None:
        """Stop serving (if start() served) and close the socket."""
        if self._thread is not None:
            self._server.shutdown()
            self._thread.join(timeout=10)
        self._server.server_close()


def build_server(device: DeviceLike = None, warm: bool = True) -> Tuple[DataProcessorServer, dict]:
    """The standalone DP as main() assembles it, from the environment of
    the Rust service (kmamiz_data_processor/src/env.rs): ZIPKIN_URL,
    KUBEAPI_HOST (unset: no cluster source), IS_RUNNING_IN_K8S ("true":
    the mounted service account's token and CA), BIND_IP and DP_PORT,
    with the processor on `device` (None: the card, raising without
    one). The cluster client's fan-out processes start first, off the
    request path, and with `warm` so do the native library's build and
    the tick's device code (warm_up); main() passes warm=False and leaves
    both to the boot prewarm (core/prewarm.py), which runs after the
    server exists. With KMAMIZ_WAL=1 the WAL replays before the server
    exists, so the first tick answers from the recovered graph. Returns
    (server, the replay's totals)."""
    from kmamiz_tpu_torch.ingestion.kubernetes import KubernetesClient
    from kmamiz_tpu_torch.ingestion.zipkin import ZipkinClient

    zipkin = ZipkinClient(os.environ.get("ZIPKIN_URL", ""))
    k8s = None
    kube_host = os.environ.get("KUBEAPI_HOST", "")
    if kube_host:
        if os.environ.get("IS_RUNNING_IN_K8S", "").lower() == "true":
            k8s = KubernetesClient.from_service_account(kube_host)
        else:
            k8s = KubernetesClient(kube_host)
    processor = DataProcessor(trace_source=zipkin.get_trace_list, k8s_source=k8s, device=device)
    if warm:
        native.available()
    if k8s is not None:
        k8s.warm_up()
    if warm:
        processor.warm_up()
    recovered = processor.replay_wal()
    if recovered["replayed"]:
        logger.info("wal replay: %s", recovered)
    server = DataProcessorServer(
        processor,
        host=os.environ.get("BIND_IP", "0.0.0.0"),
        port=int(os.environ.get("DP_PORT", "8600")),
    )
    return server, recovered


def arm_lock_witness() -> bool:
    """Arm the runtime lock witness when KMAMIZ_LOCK_WITNESS asks for it,
    as main() does BEFORE the processor exists, so every lock the serving
    stack creates is wrapped (the scenario runner does the same for
    soaks). Returns whether it is armed; /timings reads it."""
    from kmamiz_tpu_torch.analysis.concurrency import witness as lock_witness

    if lock_witness.enabled():
        lock_witness.install()
    return lock_witness.installed()


def main() -> None:
    """The standalone external DP on the card: point a KMamiz install's
    EXTERNAL_DATA_PROCESSOR here. LOG_LEVEL (verbose|info|warn|error)
    sets the log level. KMAMIZ_COMPILE_CACHE_DIR (core/compile_cache.py)
    is where the libraries are looked up and built; the boot prewarm
    (core/prewarm.py, KMAMIZ_PREWARM) builds or loads them and warms the
    device code after the WAL replay, by default on a thread of its own
    while GET / answers 503 WARMING."""
    from kmamiz_tpu_torch.core import compile_cache
    from kmamiz_tpu_torch.core import logger as klog

    logging.basicConfig(level=logging.INFO)
    klog.configure(os.environ.get("LOG_LEVEL", "info"))
    compile_cache.enable_from_env()
    arm_lock_witness()
    server, _ = build_server(warm=False)
    prewarm.boot_prewarm_from_env(server.processor)
    logger.info("external DP listening on %d", server.port)
    server.serve_forever()


if __name__ == "__main__":
    main()

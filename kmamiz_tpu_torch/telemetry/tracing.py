"""Per-tick span tracing: the collect tick as a trace of its own phases.

Counterpart of kmamiz_tpu/telemetry/tracing.py. Each DP collect tick (and
each raw-ingest window) opens a trace; the pipeline phases — parse /
quarantine / WAL append / merge / pack / host transfer / walk / scorers /
encode-serve — record spans into a preallocated builder. Span timing is
host `perf_counter_ns` only: a span boundary adds no device
synchronisation; spans around device work close where the tick already
waits for the card (the stats drain, the merge's count).

Finished traces land in a ring (`KMAMIZ_TRACE_RING` traces, default
256) and export as Zipkin v2 JSON trace groups at `GET /debug/traces` —
in the Istio-sidecar span shape the ingest path parses
(`synth.make_raw_window`), so the processor can re-ingest its own
export and build a dependency graph of its own pipeline (self-trace).

Phase names are the JAX package's. The port's walk is always the
gather form (the JAX package's flat-gather "sparse" walk), so its walk
span is `walk_sparse`. Two port-only stages get spans of their own:
`fetch_cluster_state`, the cluster fetch on its own thread
(`record_span`, timed on that thread; it overlaps the tick thread's
phases, so the profiler's attribution does not sum it), and
`dependencies_json`, the dependency records' JSON encode in the fetch's
shadow. The JAX package's `control-decide` has no producer in the port.

Overhead: when disabled (`KMAMIZ_TELEMETRY=0`) `tick()`/`phase_span()` yield
immediately with no allocation. When enabled, a span is one list append
of a 4-tuple; Zipkin formatting happens only at export time, never on
the tick.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import List, Optional, Tuple

from kmamiz_tpu_torch.config import telemetry_enabled, trace_ring
from kmamiz_tpu_torch.telemetry.profiling import events as prof_events
from kmamiz_tpu_torch.telemetry.registry import REGISTRY

# span taxonomy: canonical phase names
PHASES = (
    "parse",
    "quarantine",
    "wal-append",
    "merge",
    "assemble",
    "pack",
    "host-transfer",
    "walk",
    "walk_sparse",
    "scorers",
    "encode-serve",
    # STLGT continual-training refresh (models/stlgt/trainer.py)
    "stlgt-refresh",
    # port-only stages: the cluster fetch (its own thread) and the early
    # JSON encode of the dependency records beside it
    "fetch_cluster_state",
    "dependencies_json",
)

_SELFTRACE_NAMESPACE = "graftscope"
_ROOT_SERVICE = "dp-tick"


class _TraceBuilder:
    """One in-flight trace: spans as (name, start_ns, dur_ns, parent_idx).

    Built once per tick; appends are the only hot-path operation.
    """

    __slots__ = ("trace_id", "wall_us", "t0_ns", "spans", "_stack", "status")

    def __init__(self, trace_id: str, root_name: str) -> None:
        self.trace_id = trace_id
        self.wall_us = time.time_ns() // 1000
        self.t0_ns = time.perf_counter_ns()
        # span 0 is the root; dur filled at close
        self.spans: List[Tuple[str, int, int, int]] = [(root_name, 0, -1, -1)]
        self._stack = [0]
        self.status = "200"

    def open_span(self, name: str) -> int:
        idx = len(self.spans)
        self.spans.append((name, time.perf_counter_ns() - self.t0_ns, -1, self._stack[-1]))
        self._stack.append(idx)
        return idx

    def close_span(self, idx: int) -> None:
        name, start, _, parent = self.spans[idx]
        self.spans[idx] = (name, start, time.perf_counter_ns() - self.t0_ns - start, parent)
        if self._stack and self._stack[-1] == idx:
            self._stack.pop()

    def close(self) -> None:
        name, start, _, parent = self.spans[0]
        self.spans[0] = (name, start, time.perf_counter_ns() - self.t0_ns, parent)


class TickTracer:
    """Ring of finished tick traces + the per-thread open builder."""

    def __init__(self) -> None:
        self._ring: deque = deque(maxlen=trace_ring())
        self._lock = threading.Lock()
        self._seq = 0
        self._tls = threading.local()

    # -- hot path --------------------------------------------------------
    def current(self) -> Optional[_TraceBuilder]:
        return getattr(self._tls, "builder", None)

    @contextmanager
    def tick(self, root_name: str = _ROOT_SERVICE):
        """Open a trace for one tick. No-op (yields None) when telemetry
        is off or a trace is already open on this thread (re-entrancy:
        ingest-inside-collect keeps one trace)."""
        if not telemetry_enabled() or self.current() is not None:
            yield None
            return
        with self._lock:
            self._seq += 1
            trace_id = f"graftscope-{self._seq}"
        builder = _TraceBuilder(trace_id, root_name)
        self._tls.builder = builder
        prof_events.note_tick_start()
        try:
            yield builder
        finally:
            self._tls.builder = None
            builder.close()
            with self._lock:
                self._ring.append(builder)
            prof_events.note_tick_end(root_name, builder.spans[0][2])

    def record_span(self, name: str, start_ns: int, end_ns: int) -> None:
        """Add a span that another thread timed (`now_ns` readings) to
        this thread's open trace, parented on its root; no-op outside a
        tick."""
        builder = self.current()
        if builder is None:
            return
        dur_ns = max(0, end_ns - start_ns)
        builder.spans.append((name, start_ns - builder.t0_ns, dur_ns, 0))
        prof_events.emit(name, dur_ns)
        h = SPAN_HANDLES.get(name)
        if h is not None:
            h.observe(dur_ns / 1e6)

    def annotate_last(self, name: str, dur_ms: float) -> None:
        """Append a post-tick span (encode-serve, which happens after the
        tick's trace closed, possibly on another thread when the watchdog
        ran the tick on a worker) to the most recent trace in the ring,
        parented on its root."""
        if not telemetry_enabled():
            return
        with self._lock:
            if not self._ring:
                return
            tb = self._ring[-1]
            _rn, rstart, rdur, _rp = tb.spans[0]
            start = rstart + (rdur if rdur >= 0 else 0)
            tb.spans.append((name, start, max(0, int(dur_ms * 1e6)), 0))
        prof_events.emit(name, max(0, int(dur_ms * 1e6)))
        h = SPAN_HANDLES.get(name)
        if h is not None:
            h.observe(dur_ms)

    # -- export (cold path) ----------------------------------------------
    def traces(self) -> List[_TraceBuilder]:
        with self._lock:
            return list(self._ring)

    def export_zipkin(self) -> List[List[dict]]:
        """Ring contents as Zipkin v2 JSON trace groups, in the
        Istio-sidecar span shape the raw-ingest path parses — feeding
        this back into `ingest_raw_window` yields the pipeline's own
        dependency graph."""
        groups = []
        for tb in self.traces():
            group = []
            for i, (name, start_ns, dur_ns, parent) in enumerate(tb.spans):
                svc = name.replace("_", "-").replace(".", "-")
                ns = _SELFTRACE_NAMESPACE
                url = f"http://{svc}.{ns}.svc.cluster.local/tick/{svc}"
                group.append(
                    {
                        "traceId": tb.trace_id,
                        "id": f"{tb.trace_id}-{i}",
                        "parentId": f"{tb.trace_id}-{parent}" if parent >= 0 else None,
                        "kind": "SERVER",
                        "name": f"{svc}.{ns}.svc.cluster.local:80/*",
                        "timestamp": tb.wall_us + start_ns // 1000,
                        "duration": max(1, dur_ns // 1000),
                        "localEndpoint": {"serviceName": svc},
                        "tags": {
                            "component": "proxy",
                            "http.method": "POST",
                            "http.protocol": "HTTP/1.1",
                            "http.status_code": tb.status,
                            "http.url": url,
                            "istio.canonical_revision": "latest",
                            "istio.canonical_service": svc,
                            "istio.mesh_id": "cluster.local",
                            "istio.namespace": ns,
                            "response_flags": "-",
                            "upstream_cluster": "inbound|9080||",
                        },
                    }
                )
            if group:
                groups.append(group)
        return groups

    def reset_for_tests(self) -> None:
        with self._lock:
            self._ring = deque(maxlen=trace_ring())
            self._seq = 0
        self._tls = threading.local()


# the process-wide tracer (mirrors REGISTRY's singleton pattern)
TRACER = TickTracer()

# span-latency histogram: one preallocated handle per canonical phase —
# the tick looks handles up by identity, never by formatted label
_SPAN_MS = REGISTRY.histogram_family(
    "kmamiz_tick_span_ms",
    "Per-phase span latency within one collect tick (ms)",
    ("phase",),
)
SPAN_HANDLES = {p: _SPAN_MS.handle(p) for p in PHASES}


@contextmanager
def phase_span(name: str):
    """Span + histogram observation for one canonical phase. The handle
    dict is module-scope; unknown names trace but skip the histogram."""
    builder = TRACER.current()
    if builder is None:
        yield
        return
    h = SPAN_HANDLES.get(name)
    idx = builder.open_span(name)
    try:
        yield
    finally:
        builder.close_span(idx)
        _n, _s, dur_ns, _p = builder.spans[idx]
        prof_events.emit(name, dur_ns)
        if h is not None:
            h.observe(dur_ns / 1e6)

"""Native-plane attribution: the C++ parse/merge counters as telemetry.

Counterpart of kmamiz_tpu/telemetry/profiling/native_counters.py over the
port's own native library (`native.prof_counters()`, built from
csrc/kmamiz_spans.cpp): per-shard parse ns, merge lock-wait ns — the
barrier skew behind the merge wall — merge queue depth, span-id claim
contention, intern-table probe stats. This module is their Python face:

- `counters()` — the raw snapshot; the zero snapshot (available=False)
  while this process has not loaded the library, since it has then
  parsed nothing (reading it would build it);
- a scrape-time mirror into the `kmamiz_prof_native*` registry families
  (a `register_callback` collector: the hot path never touches it);
- `poll(tick_id)` — the per-tick delta hook (events.on_tick_end): when
  parses happened since the last tick, the merge-time and lock-wait
  deltas land in the host event ring as `native-merge` /
  `native-merge-lockwait` events.
"""
from __future__ import annotations

import threading
from typing import Dict

from kmamiz_tpu_torch import native
from kmamiz_tpu_torch.telemetry.profiling import events
from kmamiz_tpu_torch.telemetry.registry import REGISTRY

_SCALARS = (
    "parses",
    "spans",
    "merge_ns",
    "merge_lock_wait_ns",
    "merge_queue_depth_peak",
    "claim_contended",
    "intern_probes",
    "intern_hits",
)

_NATIVE = REGISTRY.gauge_family(
    "kmamiz_prof_native",
    "graftprof native parse/merge counters (cumulative)",
    ("counter",),
)
_SCALAR_HANDLES = {k: _NATIVE.handle(k) for k in _SCALARS}
_AVAILABLE = REGISTRY.gauge(
    "kmamiz_prof_native_available",
    "1 when libkmamiz_native exports the graftprof counters",
)
_SHARD = REGISTRY.gauge_family(
    "kmamiz_prof_native_shard",
    "graftprof per-shard stats of the last native parse",
    ("shard", "field"),
)

_lock = threading.Lock()
_last: Dict[str, int] = {}


def counters() -> dict:
    """Cumulative native counter snapshot; the zero snapshot while the
    library is not loaded in this process."""
    return native.prof_counters() if native.loaded() else native.prof_zero()


def _collect() -> None:
    """Scrape-time mirror into the registry (render() callback)."""
    snap = counters()
    _AVAILABLE.set(1.0 if snap["available"] else 0.0)
    for key, handle in _SCALAR_HANDLES.items():
        handle.set(float(snap[key]))
    for i, sh in enumerate(snap["shards"]):
        for field in ("parse_ns", "wait_ns", "spans"):
            _SHARD.handle(str(i), field).set(float(sh[field]))


REGISTRY.register_callback(_collect)


def poll(tick_id: int = 0) -> None:
    """Per-tick delta poll: emit native merge/lock-wait deltas into the
    host event ring. One ctypes snapshot per tick, nothing per span."""
    snap = counters()
    if not snap["available"]:
        return
    with _lock:
        prev = dict(_last)
        for key in ("parses", "merge_ns", "merge_lock_wait_ns"):
            _last[key] = int(snap[key])
    d_parses = int(snap["parses"]) - prev.get("parses", 0)
    if d_parses <= 0:
        return
    d_merge = int(snap["merge_ns"]) - prev.get("merge_ns", 0)
    d_wait = int(snap["merge_lock_wait_ns"]) - prev.get("merge_lock_wait_ns", 0)
    if d_merge >= 0:
        events.emit("native-merge", d_merge)
    if d_wait >= 0:
        events.emit("native-merge-lockwait", d_wait)


events.on_tick_end(poll)


def reset_for_tests() -> None:
    with _lock:
        _last.clear()
    if native.loaded():
        native.prof_reset()

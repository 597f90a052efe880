"""Device-plane attribution: kernel time joined back to the port's kernels.

Counterpart of kmamiz_tpu/telemetry/profiling/device_attr.py. Three
sources, all cold-path:

- **Compile-cause log** — the JAX package's programs report each XLA
  compile into this ring. PyTorch compiles nothing per shape on the
  port's paths, so nothing produces an entry: the ring stays empty (the
  flight artifact's `compileLog`) and `kmamiz_prof_compile_events_total`
  stays 0.
- **Device memory watermark timeline** — a per-tick sample of the card's
  memory gauges (`telemetry/device.device_memory_stats`, nothing on the
  CPU), ring-buffered as ``(tick_id, bytes_in_use, peak_bytes)``; the
  flight recorder freezes it next to the host events.
- **torch.profiler trace join** — `parse_profile_dir` walks a capture
  directory (the `POST /debug/profile` output, `*.trace.json[.gz]`
  Chrome traces), sums the device events' durations (`ph: "X"` of the
  `kernel`, `gpu_memcpy` and `gpu_memset` categories) and credits each
  launch of a hand-written kernel (`cat: "kernel"`, its symbol in the
  name) to its wrapper in ops/ — `segment_stats`, `fused_sddmm_spmm`,
  `fused_sddmm_spmm_grad_edges`, `fused_sddmm_spmm_grad_rows` — where the
  JAX package joins `jit_<program>` kernels to its program registry,
  which the port does not carry. Everything else lands under
  `__unattributed__`. The credits are mirrored as
  `kmamiz_prof_program_device_ms` gauges.
"""
from __future__ import annotations

import gzip
import json
import os
import threading
from collections import deque
from typing import Dict, List

from kmamiz_tpu_torch.telemetry import device as tel_device
from kmamiz_tpu_torch.telemetry.profiling import events
from kmamiz_tpu_torch.telemetry.registry import REGISTRY

_COMPILE_LOG_MAX = 256
_HBM_MAX = 1024

#: the hand-written kernels' symbols (csrc/*.cu) and the wrapper each
#: launch is credited to, the longest symbol first so that
#: `fused_sddmm_spmm_kernel_grad_rows` never credits the forward
KERNEL_PROGRAMS = (
    ("fused_sddmm_spmm_kernel_grad_edges", "fused_sddmm_spmm_grad_edges"),
    ("fused_sddmm_spmm_kernel_grad_rows", "fused_sddmm_spmm_grad_rows"),
    ("fused_sddmm_spmm_kernel_gate", "fused_sddmm_spmm"),
    ("fused_sddmm_spmm_kernel_keys", "fused_sddmm_spmm"),
    ("fused_sddmm_spmm_kernel", "fused_sddmm_spmm"),
    ("segment_stats_kernel", "segment_stats"),
)
#: Chrome-trace categories of device work in a torch.profiler capture
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
UNATTRIBUTED = "__unattributed__"

_lock = threading.Lock()
_compile_log: deque = deque(maxlen=_COMPILE_LOG_MAX)
_hbm: deque = deque(maxlen=_HBM_MAX)

REGISTRY.counter(
    "kmamiz_prof_compile_events_total",
    "Compile-cause log entries recorded (none in the port)",
)
_PROG_DEVICE_MS = REGISTRY.gauge_family(
    "kmamiz_prof_program_device_ms",
    "Per-kernel device time from the last joined torch.profiler capture",
    ("program",),
)


def compile_log() -> List[dict]:
    with _lock:
        return list(_compile_log)


def _sample_hbm(tick_id: int) -> None:
    """Per-tick device memory sample (events.on_tick_end hook)."""
    stats = tel_device.device_memory_stats()
    if not stats:
        return
    with _lock:
        _hbm.append((int(tick_id), stats["bytes_in_use"], stats["peak_bytes_in_use"]))


events.on_tick_end(_sample_hbm)


def hbm_timeline() -> List[List[int]]:
    """(tick_id, bytes_in_use, peak_bytes) rows, oldest first."""
    with _lock:
        return [list(row) for row in _hbm]


# -- torch.profiler trace join -----------------------------------------------


def _iter_trace_files(root: str) -> List[str]:
    """All .trace.json(.gz) files under a capture directory."""
    found: List[str] = []
    for dirpath, _dirs, files in os.walk(root):
        for fname in files:
            if fname.endswith(".trace.json") or fname.endswith(".trace.json.gz"):
                found.append(os.path.join(dirpath, fname))
    return sorted(found)


def _load_trace_events(path: str) -> List[dict]:
    try:
        if path.endswith(".gz"):
            with gzip.open(path, "rt", encoding="utf-8", errors="replace") as f:
                doc = json.load(f)
        else:
            with open(path, encoding="utf-8", errors="replace") as f:
                doc = json.load(f)
    except (OSError, ValueError):
        return []
    if isinstance(doc, dict):
        evs = doc.get("traceEvents", [])
        return evs if isinstance(evs, list) else []
    return doc if isinstance(doc, list) else []


def kernel_program(name: str, category: str = "kernel") -> str:
    """The kernel wrapper a device event is credited to: a `kernel` event
    whose name holds one of the hand-written kernels' symbols (mangled or
    demangled), else `__unattributed__`."""
    if category == "kernel":
        for symbol, program in KERNEL_PROGRAMS:
            if symbol in name:
                return program
    return UNATTRIBUTED


def parse_profile_dir(root: str) -> dict:
    """Aggregate a torch.profiler capture directory into per-kernel device
    ms. Tolerant of partial or foreign captures: unparseable files skip,
    other device work reports as `__unattributed__`, host events count
    nowhere."""
    files = _iter_trace_files(root)
    programs_us: Dict[str, float] = {}
    n_events = 0
    for path in files:
        for ev in _load_trace_events(path):
            if not isinstance(ev, dict) or ev.get("ph") != "X":
                continue
            name, dur, cat = ev.get("name"), ev.get("dur"), ev.get("cat")
            if not name or not isinstance(dur, (int, float)):
                continue
            if cat not in DEVICE_CATEGORIES:
                continue
            target = kernel_program(name, cat)
            programs_us[target] = programs_us.get(target, 0.0) + float(dur)
            n_events += 1
    programs_ms = {name: round(us / 1000.0, 3) for name, us in sorted(programs_us.items())}
    for name, ms in programs_ms.items():
        if name != UNATTRIBUTED:
            _PROG_DEVICE_MS.handle(name).set(ms)
    return {
        "files": len(files),
        "events": n_events,
        "total_device_ms": round(sum(programs_us.values()) / 1000.0, 3),
        "unattributed_ms": programs_ms.get(UNATTRIBUTED, 0.0),
        "programs": {k: v for k, v in programs_ms.items() if k != UNATTRIBUTED},
    }


def reset_for_tests() -> None:
    with _lock:
        _compile_log.clear()
        _hbm.clear()

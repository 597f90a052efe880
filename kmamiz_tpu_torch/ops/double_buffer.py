"""Double-buffered host-to-device uploads.

Counterpart of kmamiz_tpu/ops/double_buffer.py. A window merge uploads a
group of host arrays (the packed walk inputs, or host edge columns) and
enqueues device work on them at once. `UploadPipeline` keeps up to
`depth` such groups in flight instead of waiting for each copy: window
N's copy streams while the host packs window N+1 and the device works on
window N-1. The host blocks only when more than `depth` groups are in
flight, and then only on the OLDEST group.

On a CUDA device `put` stages each array in pinned host memory and
copies it with `non_blocking` on a side stream of its own; an event
recorded there after the copies is what the consumer's stream waits on
(a device-side wait: the host goes on) before any kernel reads the
tensors, and what the host waits on when it retires the group. The
device tensors are allocated on the side stream and marked as used by
the consumer's stream (`record_stream`), so the caching allocator cannot
hand their memory out again while the consumer still reads it; the
in-flight group holds the pinned sources until its event completes.
`depth=0` waits for every copy before `put` returns (the synchronous
upload). On the CPU `put` is a plain copy with the same accounting.

`AsyncCount` is the matching device-to-host half for one scalar: a
`non_blocking` copy into pinned host memory and an event whose `query()`
answers whether the value has landed, so a caller can read a count only
once it is there and defer the read otherwise.

Neither class is thread-safe: the graph store owns one pipeline and
touches it only under its lock.
"""
from __future__ import annotations

import time
from collections import deque
from typing import List, Sequence, Tuple

import numpy as np
import torch

#: two windows in flight hide one whole copy behind one whole pack and
#: dispatch without pinning more than two windows of staging memory
DEFAULT_DEPTH = 2


def _now_ms() -> float:
    return time.perf_counter() * 1e3


class UploadPipeline:
    """Depth-bounded window of in-flight host-to-device upload groups."""

    def __init__(self, device: torch.device, depth: int = DEFAULT_DEPTH) -> None:
        self.device = torch.device(device)
        self.depth = max(0, int(depth))
        # (event, pinned sources) per group; event is None on the CPU
        self._in_flight: deque = deque()
        self._stream = None  # the side stream, made at the first card upload
        self.uploads = 0
        self.blocked_ms = 0.0
        self.peak_in_flight = 0
        # stage hand-off fences (EndpointGraph.stage_fence): each one is a
        # merge-to-score boundary that drained this pipeline
        self.fences = 0

    def note_fence(self) -> None:
        """Count one explicit stage hand-off fence; the drain itself is
        the caller's."""
        self.fences += 1

    def _copy_group(self, host_arrays: Sequence[np.ndarray]):
        """Issue one group's copies; returns (device tensors, event, pinned
        sources)."""
        sources = [torch.from_numpy(np.ascontiguousarray(a)) for a in host_arrays]
        if self.device.type != "cuda":
            return [t.to(self.device) for t in sources], None, None
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        consumer = torch.cuda.current_stream(self.device)
        pinned = [t.pin_memory() for t in sources]
        # the copies overlap what the consumer has queued: their targets are
        # new side-stream blocks, which no queued kernel reads
        with torch.cuda.stream(self._stream):
            out = [t.to(self.device, non_blocking=True) for t in pinned]
            event = torch.cuda.Event()
            event.record(self._stream)
        for t in out:
            t.record_stream(consumer)
        consumer.wait_event(event)
        return out, event, pinned

    def put(self, host_arrays: Sequence[np.ndarray]) -> Tuple[List[torch.Tensor], float]:
        """Upload one group; returns (device tensors, blocked_ms).
        blocked_ms is the host wait this call paid: the whole copy at depth
        0, otherwise only the retire of the groups past `depth`."""
        t0 = _now_ms()
        out, event, pinned = self._copy_group(host_arrays)
        self.uploads += 1
        if self.depth <= 0:
            if event is not None:
                event.synchronize()
            return out, _now_ms() - t0
        self._in_flight.append((event, pinned))
        while len(self._in_flight) > self.depth:
            self._retire(self._in_flight.popleft())
        self.peak_in_flight = max(self.peak_in_flight, len(self._in_flight))
        blocked = _now_ms() - t0
        self.blocked_ms += blocked
        return out, blocked

    @staticmethod
    def _retire(group) -> None:
        event, _pinned = group
        if event is not None:
            event.synchronize()

    def drain(self) -> float:
        """Retire every in-flight group; returns the ms spent waiting. The
        store calls it at its read fence, where in steady state the copies
        have long landed."""
        if not self._in_flight:
            return 0.0
        t0 = _now_ms()
        while self._in_flight:
            self._retire(self._in_flight.popleft())
        waited = _now_ms() - t0
        self.blocked_ms += waited
        return waited

    def stats(self) -> dict:
        """The JAX pipeline's counters: depth 0 is the synchronous mode,
        whose waits `put` returns but does not account."""
        pipelined = self.depth > 0
        return {
            "depth": self.depth,
            "mode": "pipelined" if pipelined else "sync",
            "uploads": self.uploads,
            "in_flight": len(self._in_flight),
            "peak_in_flight": self.peak_in_flight,
            "blocked_ms": round(self.blocked_ms, 1),
            "fences": self.fences,
            "blocked_ms_per_upload": (
                round(self.blocked_ms / self.uploads, 3) if pipelined and self.uploads else 0.0
            ),
        }


class AsyncCount:
    """A device scalar read back without blocking the host: on a CUDA
    device a `non_blocking` copy into a pinned host scalar and an event
    recorded after it; on the CPU the value itself. `int()` waits for the
    copy (an event wait) and returns the value."""

    __slots__ = ("_host", "_event")

    def __init__(self, value: torch.Tensor) -> None:
        if value.device.type == "cuda":
            self._host = torch.empty(value.shape, dtype=value.dtype, pin_memory=True)
            self._host.copy_(value, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = value
            self._event = None

    def ready(self) -> bool:
        """Whether the value has landed on the host (always on the CPU)."""
        return self._event is None or self._event.query()

    def __int__(self) -> int:
        if self._event is not None:
            self._event.synchronize()
        return int(self._host)

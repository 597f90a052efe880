"""Segment-sum and segment-max of one span window (the window_stats core).

Counterpart of kmamiz_tpu/ops/pallas_kernels.py:segment_stats_matmul,
whose TPU kernel (_segment_stats_kernel) reduces through a dense one-hot
matmul on the MXU. On the card the same function is the hand-written CUDA
scatter in csrc/segment_stats.cu; its header states the design (one output
buffer zeroed by the C entry, segment-major sums with a 16-byte vector
atomic per four stat rows), the bound (memory traffic: ~31 MB and ~9.4 us
at the production window of 2^20 spans x 80,000 segments x 5 stat rows on
an H100's 3.35 TB/s) and the known weakness (atomic contention on hot
segments, run-dependent float summation order).

The kernel's wrapper returns the sums as the [m, S] view of segment-major
[S, ld] storage (ld = m rounded up to a multiple of 4 when m >= 4); the
plain version returns them contiguous. Callers take either strides.

`segment_stats` routes by the device of its inputs: CUDA tensors launch the
kernel (or raise), CPU tensors take `segment_stats_plain`. There is no
switch and no fallback between the two.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from kmamiz_tpu_torch.ops import cuda_build

KERNEL = "segment_stats"
#: the TPU kernel this one replaces
REPLACES = "kmamiz_tpu/ops/pallas_kernels.py:74"


def row_stride(m: int) -> int:
    """Floats per segment in the sums' storage: m rounded up to a multiple
    of 4 when m >= 4 (16-byte rows for the kernel's vector atomic), else m."""
    return m if m < 4 else (m + 3) // 4 * 4


def _outputs(
    m: int, num_segments: int, with_ts: bool, device
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """One uninitialised allocation holding every output: (its base
    tensor, sums as the [m, S] view of segment-major [S, ld] float32
    storage, ts_max [S] int32 after the S * ld floats or None). Without
    timestamps the sums are the allocation itself (one op on the host)."""
    ld = row_stride(m)
    if not with_ts:
        sums = torch.empty_strided((m, num_segments), (1, ld), dtype=torch.float32, device=device)
        return sums, sums, None
    head = num_segments * ld
    buf = torch.empty(head + num_segments, dtype=torch.float32, device=device)
    return buf, buf.as_strided((m, num_segments), (1, ld)), buf[head:].view(torch.int32)


def segment_stats_plain(
    values: torch.Tensor,
    seg: torch.Tensor,
    ts: Optional[torch.Tensor],
    num_segments: int,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The plain PyTorch version: index_add_ for the sums and an amax
    scatter onto zeros for the timestamps (none when ts is None). Segment
    ids outside [0, num_segments) are dropped, as the kernel drops them."""
    m = values.shape[0]
    keep = (seg >= 0) & (seg < num_segments)
    idx = torch.where(keep, seg, num_segments).long()
    sums = torch.zeros((m, num_segments + 1), dtype=torch.float32, device=values.device)
    sums.index_add_(1, idx, values.to(torch.float32))
    if ts is None:
        return sums[:, :num_segments], None
    ts_max = torch.zeros(num_segments + 1, dtype=torch.int32, device=values.device)
    ts_max.scatter_reduce_(0, idx, ts.to(torch.int32), "amax", include_self=True)
    return sums[:, :num_segments], ts_max[:num_segments]


def _check(values, seg, ts, num_segments) -> None:
    if values.dim() != 2 or seg.dim() != 1 or (ts is not None and ts.dim() != 1):
        raise ValueError("segment_stats wants values[m, N], seg[N] and ts[N] or None")
    n = values.shape[1]
    if seg.shape[0] != n or (ts is not None and ts.shape[0] != n):
        raise ValueError(
            f"segment_stats: values has {n} spans, seg {seg.shape[0]}, "
            f"ts {None if ts is None else ts.shape[0]}"
        )
    if (
        values.dtype != torch.float32
        or seg.dtype != torch.int32
        or (ts is not None and ts.dtype != torch.int32)
    ):
        raise TypeError(
            "segment_stats wants float32 values and int32 seg/ts, got "
            f"{values.dtype}, {seg.dtype}, {None if ts is None else ts.dtype}"
        )
    device = seg.device
    if values.device != device or (ts is not None and ts.device != device):
        raise ValueError("segment_stats inputs lie on different devices")
    if not 0 <= num_segments < 2**31:
        raise ValueError(f"num_segments out of int32 range: {num_segments}")


_fn = None


def _kernel():
    """The C entry, with its argtypes set once when the library loads."""
    global _fn
    if _fn is None:
        fn = cuda_build.load(KERNEL).kmamiz_segment_stats
        fn.argtypes = [
            ctypes.c_void_p,  # values
            ctypes.c_int,  # m
            ctypes.c_int64,  # n
            ctypes.c_void_p,  # seg
            ctypes.c_void_p,  # ts (None: no timestamps)
            ctypes.c_int32,  # num_segments
            ctypes.c_int,  # ld
            ctypes.c_void_p,  # out
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def segment_stats(
    values: torch.Tensor,
    seg: torch.Tensor,
    ts: Optional[torch.Tensor],
    num_segments: int,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Segment-sum every row of values[m, N] (float32) and segment-max
    ts[N] (int32, identity 0) by seg[N] int32 ids in [0, num_segments);
    other ids are dropped. Returns (sums[m, S] float32, the strided view
    described in the module docstring, ts_max[S] int32), or None in place
    of ts_max when ts is None.

    CUDA inputs launch the kernel on the current stream without a sync:
    one allocation and one ctypes call, whose C entry zeroes the outputs
    and launches. CPU inputs run segment_stats_plain."""
    _check(values, seg, ts, num_segments)
    if not values.is_cuda:
        if values.device.type == "cpu":
            return segment_stats_plain(values, seg, ts, num_segments)
        raise ValueError(f"segment_stats: unsupported device {values.device}")
    device = values.device
    m, n = values.shape
    buf, sums, ts_max = _outputs(m, num_segments, ts is not None, device)
    args = (
        values.contiguous().data_ptr(),
        m,
        n,
        seg.contiguous().data_ptr(),
        None if ts is None else ts.contiguous().data_ptr(),
        num_segments,
        row_stride(m),
        buf.data_ptr(),
    )
    err = cuda_build.launch(_kernel(), args, device)
    if err != 0:
        raise RuntimeError(f"segment_stats kernel launch failed: cudaError {err}")
    segment_stats.launches += 1
    return sums, ts_max


#: launches of the CUDA kernel in this process (CPU calls do not count)
segment_stats.launches = 0

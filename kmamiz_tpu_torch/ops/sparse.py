"""Fused SDDMM/SpMM over the edge list: the model plane's neighbor sums.

Counterpart of the fused kernels of kmamiz_tpu/ops/sparse.py
(`fused_neighbor_sums`, `fused_gated_bias`), whose TPU kernel
(_fused_kernel) gathers and scatters through one-hot matmuls with the node
table resident in VMEM. On the card the same function is the hand-written
CUDA kernel in csrc/fused_sddmm_spmm.cu (one warp per edge, atomic
scatter, no node cap); its header states the design and the bound.

Id rule, taken from the JAX package's XLA formulation (what it runs at
this size and by default): a gather clamps its id into [0, N); a scatter
to an id outside [0, N) is dropped; masked-off edges gate 0 and scatter
nothing. (The JAX fused kernel instead clips an out-of-range id of a live
edge to N-1; real snapshots carry no such ids.)

`fused_sddmm_spmm` routes by the device of its inputs: CUDA tensors launch
the kernel (or raise), CPU tensors take `fused_plain`. There is no switch
and no fallback between the two. The sparse counting primitives of the
JAX module belong to the scorers and are not ported here.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from kmamiz_tpu_torch.ops import cuda_build

KERNEL = "fused_sddmm_spmm"
#: the TPU kernel this one replaces
REPLACES = "kmamiz_tpu/ops/sparse.py:162"


def fused_plain(
    v: torch.Tensor,
    src_ep: torch.Tensor,
    dst_ep: torch.Tensor,
    edge_mask: torch.Tensor,
    q: Optional[torch.Tensor] = None,
    k: Optional[torch.Tensor] = None,
    b_edge: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: gather, mask, gate, index_add_ in both
    directions. Gated when q, k and b_edge are given. Returns
    (bias[N, H], deg[N], gate[E]), the un-normalised sums."""
    n, h = v.shape
    src = src_ep.long()
    dst = dst_ep.long()
    src_c = src.clamp(0, n - 1)
    dst_c = dst.clamp(0, n - 1)
    em = edge_mask.to(torch.float32)
    if q is None:
        gate = em
    else:
        affinity = (q[src_c] * k[dst_c]).sum(dim=1) / math.sqrt(h)
        gate = torch.sigmoid(affinity + b_edge.reshape(())) * em
    # scatter ids: masked-off and out-of-range edges park at the spill row n
    src_s = torch.where(edge_mask & (src >= 0) & (src < n), src, n)
    dst_s = torch.where(edge_mask & (dst >= 0) & (dst < n), dst, n)
    g = gate[:, None]
    bias = torch.zeros((n + 1, h), dtype=torch.float32, device=v.device)
    bias.index_add_(0, dst_s, v[src_c] * g)
    bias.index_add_(0, src_s, v[dst_c] * g)
    deg = torch.zeros(n + 1, dtype=torch.float32, device=v.device)
    deg.index_add_(0, dst_s, gate)
    deg.index_add_(0, src_s, gate)
    return bias[:n], deg[:n], gate


def _check(v, src_ep, dst_ep, edge_mask, q, k, b_edge) -> None:
    if v.dim() != 2 or src_ep.dim() != 1 or dst_ep.dim() != 1 or edge_mask.dim() != 1:
        raise ValueError("fused_sddmm_spmm wants v[N, H], src[E], dst[E], mask[E]")
    e = src_ep.shape[0]
    if dst_ep.shape[0] != e or edge_mask.shape[0] != e:
        raise ValueError(
            f"fused_sddmm_spmm: src has {e} edges, dst {dst_ep.shape[0]}, "
            f"mask {edge_mask.shape[0]}"
        )
    if v.shape[0] < 1 or v.shape[1] < 1:
        raise ValueError(f"fused_sddmm_spmm: empty node table {tuple(v.shape)}")
    if (
        v.dtype != torch.float32
        or src_ep.dtype != torch.int32
        or dst_ep.dtype != torch.int32
        or edge_mask.dtype != torch.bool
    ):
        raise TypeError(
            "fused_sddmm_spmm wants float32 v, int32 src/dst and a bool mask, got "
            f"{v.dtype}, {src_ep.dtype}, {dst_ep.dtype}, {edge_mask.dtype}"
        )
    gated = [t is not None for t in (q, k, b_edge)]
    if any(gated) and not all(gated):
        raise ValueError("the gated mode wants q, k and b_edge together")
    tensors = [v, src_ep, dst_ep, edge_mask]
    if all(gated):
        if q.shape != v.shape or k.shape != v.shape or b_edge.numel() != 1:
            raise ValueError(
                f"gated mode wants q, k shaped like v {tuple(v.shape)} and one "
                f"b_edge, got {tuple(q.shape)}, {tuple(k.shape)}, {b_edge.numel()}"
            )
        if not (q.dtype == k.dtype == b_edge.dtype == torch.float32):
            raise TypeError("gated mode wants float32 q, k and b_edge")
        tensors += [q, k, b_edge]
    if len({t.device for t in tensors}) != 1:
        raise ValueError("fused_sddmm_spmm inputs lie on different devices")


def _library() -> ctypes.CDLL:
    lib = cuda_build.load(KERNEL)
    fn = lib.kmamiz_fused_sddmm_spmm
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p,  # src
            ctypes.c_void_p,  # dst
            ctypes.c_void_p,  # mask
            ctypes.c_void_p,  # v
            ctypes.c_void_p,  # q
            ctypes.c_void_p,  # k
            ctypes.c_void_p,  # b
            ctypes.c_int,  # gated
            ctypes.c_int64,  # e
            ctypes.c_int32,  # n
            ctypes.c_int32,  # h
            ctypes.c_float,  # sqrt_h
            ctypes.c_void_p,  # bias
            ctypes.c_void_p,  # deg
            ctypes.c_void_p,  # gate
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
    return lib


def fused_sddmm_spmm(
    v: torch.Tensor,
    src_ep: torch.Tensor,
    dst_ep: torch.Tensor,
    edge_mask: torch.Tensor,
    q: Optional[torch.Tensor] = None,
    k: Optional[torch.Tensor] = None,
    b_edge: Optional[torch.Tensor] = None,
    want_gate: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(bias[N, H], deg[N], gate[E]) of the edge list src/dst (int32) under
    edge_mask (bool) over the node table v[N, H] (float32); gated when q,
    k ([N, H] float32) and b_edge (one float32) are given. With
    want_gate=False the kernel skips the gate and None comes back in its
    place.

    CUDA inputs launch the kernel on the current stream without a sync;
    CPU inputs run fused_plain."""
    _check(v, src_ep, dst_ep, edge_mask, q, k, b_edge)
    gated = q is not None
    if v.device.type == "cpu":
        bias, deg, gate = fused_plain(v, src_ep, dst_ep, edge_mask, q, k, b_edge)
        return bias, deg, gate if want_gate else None
    if v.device.type != "cuda":
        raise ValueError(f"fused_sddmm_spmm: unsupported device {v.device}")
    n, h = v.shape
    e = src_ep.shape[0]
    if n >= 2**31:
        raise ValueError(f"fused_sddmm_spmm: N={n} out of int32 range")
    v = v.contiguous()
    src_ep = src_ep.contiguous()
    dst_ep = dst_ep.contiguous()
    edge_mask = edge_mask.contiguous()
    if gated:
        q, k, b_edge = q.contiguous(), k.contiguous(), b_edge.contiguous()
    bias = torch.zeros((n, h), dtype=torch.float32, device=v.device)
    deg = torch.zeros(n, dtype=torch.float32, device=v.device)
    gate = torch.empty(e, dtype=torch.float32, device=v.device) if want_gate else None
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().kmamiz_fused_sddmm_spmm(
            src_ep.data_ptr(),
            dst_ep.data_ptr(),
            edge_mask.data_ptr(),
            v.data_ptr(),
            q.data_ptr() if gated else None,
            k.data_ptr() if gated else None,
            b_edge.data_ptr() if gated else None,
            int(gated),
            e,
            n,
            h,
            math.sqrt(h),
            bias.data_ptr(),
            deg.data_ptr(),
            gate.data_ptr() if want_gate else None,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_sddmm_spmm kernel launch failed: cudaError {err}")
    fused_sddmm_spmm.launches += 1
    return bias, deg, gate


#: launches of the CUDA kernel in this process (CPU calls do not count)
fused_sddmm_spmm.launches = 0


def fused_gated_bias(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    b_edge: torch.Tensor,
    src_ep: torch.Tensor,
    dst_ep: torch.Tensor,
    edge_mask: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """STLGT neighbor bias: the gate ``sigmoid(q[src]·k[dst] / sqrt(H) +
    b_edge) * mask`` and the bidirectional gated SpMM in one kernel.
    Returns (bias_sum[N, H], gate_deg[N], gate[E]), un-normalised; the
    model divides by max(gate_deg, 1)."""
    return fused_sddmm_spmm(v, src_ep, dst_ep, edge_mask, q, k, b_edge)


def fused_neighbor_sums(
    h: torch.Tensor,
    src_ep: torch.Tensor,
    dst_ep: torch.Tensor,
    edge_mask: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GraphSAGE neighbor aggregation: the bidirectional masked SpMM and
    the degree in one kernel. Returns (agg[N, F], deg[N]); neighbor_mean
    divides agg by max(deg, 1)."""
    agg, deg, _ = fused_sddmm_spmm(h, src_ep, dst_ep, edge_mask, want_gate=False)
    return agg, deg

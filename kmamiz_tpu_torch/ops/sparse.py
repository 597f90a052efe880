"""Fused SDDMM/SpMM over the edge list: the model plane's neighbor sums.

Counterpart of the fused kernels of kmamiz_tpu/ops/sparse.py
(`fused_neighbor_sums`, `fused_gated_bias`), whose TPU kernel
(_fused_kernel) gathers and scatters through one-hot matmuls with the node
table resident in VMEM. On the card the same function is the hand-written
CUDA kernel in csrc/fused_sddmm_spmm.cu: a CSR-by-node reduction over the
index that `edge_index` builds (one warp per node row, no atomics, no
zero-fill, the same bits on every run; a gate pre-pass when the gate is
wanted); its header states the design and the bound.

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
from typing import NamedTuple, Optional, Tuple

import torch

from kmamiz_tpu_torch.ops import cuda_build

KERNEL = "fused_sddmm_spmm"
#: the TPU kernel this one replaces
REPLACES = "kmamiz_tpu/ops/sparse.py:162"


class EdgeIndex(NamedTuple):
    """The edge list by node row (CSR), both directions: row n holds an
    entry for every live edge with dst == n (edge id j = e) and every live
    edge with src == n (j = E + e), in order of j."""

    row_ptr: torch.Tensor  # int32[N+1]: row n is entries row_ptr[n]:row_ptr[n+1]
    nbr: torch.Tensor  # int32[2E]: the other end (the kernel clamps its gather)
    eid: torch.Tensor  # int64[2E]: j, the edge id with its direction


def edge_keys_plain(
    src_ep: torch.Tensor, dst_ep: torch.Tensor, edge_mask: torch.Tensor, n: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """edge_index's sort keys and opposite ends for the 2E entries (dst
    sides, then src sides), in plain PyTorch: key = that end's row, or n
    when the edge is masked off or the row lies outside [0, n)."""
    rows = torch.cat([dst_ep, src_ep])
    keys = torch.where(edge_mask.repeat(2) & (rows >= 0) & (rows < n), rows, n)
    return keys, torch.cat([src_ep, dst_ep])


def edge_index(
    src_ep: torch.Tensor, dst_ep: torch.Tensor, edge_mask: torch.Tensor, n: int
) -> EdgeIndex:
    """The CSR index of the edge list over n node rows, as the kernel reads
    it. A side whose id lies outside [0, n), and both sides of a masked-off
    edge, park at key n past the last row, so only the first row_ptr[n] of
    the 2E entries are live. The keys come from a small kernel of
    csrc/fused_sddmm_spmm.cu on the card (edge_keys_plain on the CPU), then
    one stable sort and one searchsorted: no host sync."""
    e = src_ep.shape[0]
    if src_ep.shape != (e,) or dst_ep.shape != (e,) or edge_mask.shape != (e,):
        raise ValueError("edge_index wants src[E], dst[E] and mask[E]")
    if src_ep.dtype != torch.int32 or dst_ep.dtype != torch.int32 or edge_mask.dtype != torch.bool:
        raise TypeError("edge_index wants int32 src/dst and a bool mask")
    device = src_ep.device
    if dst_ep.device != device or edge_mask.device != device:
        raise ValueError("edge_index inputs lie on different devices")
    if not 0 < n < 2**31 or 2 * e >= 2**31:
        raise ValueError(f"edge_index: N={n} or 2E={2 * e} out of int32 range")
    if device.type == "cuda":
        # int16 keys when n fits: the radix sort then runs two 8-bit passes
        # instead of four
        key_dtype = torch.int16 if n < 2**15 else torch.int32
        keys = torch.empty(2 * e, dtype=key_dtype, device=device)
        other = torch.empty(2 * e, dtype=torch.int32, device=device)
        args = (
            src_ep.contiguous().data_ptr(),
            dst_ep.contiguous().data_ptr(),
            edge_mask.contiguous().data_ptr(),
            e,
            n,
            keys.element_size(),
            keys.data_ptr(),
            other.data_ptr(),
        )
        err = cuda_build.launch(_kernel("kmamiz_edge_index_keys"), args, device)
        if err != 0:
            raise RuntimeError(f"edge_index keys kernel launch failed: cudaError {err}")
    else:
        keys, other = edge_keys_plain(src_ep, dst_ep, edge_mask, n)
    sorted_keys, order = torch.sort(keys, stable=True)
    row_ptr = torch.searchsorted(
        sorted_keys, torch.arange(n + 1, dtype=keys.dtype, device=device), out_int32=True
    )
    return EdgeIndex(row_ptr, other[order], order)


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
    device = v.device
    if src_ep.device != device or dst_ep.device != device or edge_mask.device != device:
        raise ValueError("fused_sddmm_spmm inputs lie on different devices")
    if q is None and k is None and b_edge is None:
        return
    if q is None or k is None or b_edge is None:
        raise ValueError("the gated mode wants q, k and b_edge together")
    if q.shape != v.shape or k.shape != v.shape or b_edge.numel() != 1:
        raise ValueError(
            f"gated mode wants q, k shaped like v {tuple(v.shape)} and one "
            f"b_edge, got {tuple(q.shape)}, {tuple(k.shape)}, {b_edge.numel()}"
        )
    if not (q.dtype == k.dtype == b_edge.dtype == torch.float32):
        raise TypeError("gated mode wants float32 q, k and b_edge")
    if q.device != device or k.device != device or b_edge.device != device:
        raise ValueError("fused_sddmm_spmm inputs lie on different devices")


def _check_index(index: EdgeIndex, n: int, e: int, device) -> None:
    row_ptr, nbr, eid = index
    if row_ptr.shape != (n + 1,) or nbr.shape != (2 * e,) or eid.shape != (2 * e,):
        raise ValueError(
            f"edge index shaped {tuple(row_ptr.shape)}, {tuple(nbr.shape)}, "
            f"{tuple(eid.shape)} for N={n}, E={e}"
        )
    if row_ptr.dtype != torch.int32 or nbr.dtype != torch.int32 or eid.dtype != torch.int64:
        raise TypeError("the edge index is int32 row_ptr and nbr, int64 eid")
    if row_ptr.device != device or nbr.device != device or eid.device != device:
        raise ValueError("the edge index lies on another device")


#: argtypes of the C entries of csrc/fused_sddmm_spmm.cu
_ARGTYPES = {
    "kmamiz_fused_sddmm_spmm": [
        ctypes.c_void_p,  # src
        ctypes.c_void_p,  # dst
        ctypes.c_void_p,  # mask
        ctypes.c_void_p,  # row_ptr
        ctypes.c_void_p,  # nbr
        ctypes.c_void_p,  # eid (int64)
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
    ],
    "kmamiz_edge_index_keys": [
        ctypes.c_void_p,  # src
        ctypes.c_void_p,  # dst
        ctypes.c_void_p,  # mask
        ctypes.c_int64,  # e
        ctypes.c_int32,  # n
        ctypes.c_int,  # key_bytes (2: int16 keys, 4: int32)
        ctypes.c_void_p,  # keys
        ctypes.c_void_p,  # other
        ctypes.c_void_p,  # stream
    ],
}
_entries: dict = {}


def _kernel(name: str = "kmamiz_fused_sddmm_spmm"):
    """A C entry of the library, with its argtypes set once at load."""
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(cuda_build.load(KERNEL), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


def fused_sddmm_spmm(
    v: torch.Tensor,
    src_ep: torch.Tensor,
    dst_ep: torch.Tensor,
    edge_mask: torch.Tensor,
    q: Optional[torch.Tensor] = None,
    k: Optional[torch.Tensor] = None,
    b_edge: Optional[torch.Tensor] = None,
    want_gate: bool = True,
    index: Optional[EdgeIndex] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(bias[N, H], deg[N], gate[E]) of the edge list src/dst (int32) under
    edge_mask (bool) over the node table v[N, H] (float32); gated when q,
    k ([N, H] float32) and b_edge (one float32) are given. With
    want_gate=False None comes back in place of the gate. `index` is
    edge_index(src_ep, dst_ep, edge_mask, N), built here when not given;
    callers that aggregate one edge list several times build it once.

    CUDA inputs launch the kernel on the current stream without a sync;
    CPU inputs run fused_plain and ignore the index."""
    _check(v, src_ep, dst_ep, edge_mask, q, k, b_edge)
    gated = q is not None
    if not v.is_cuda:
        if v.device.type == "cpu":
            bias, deg, gate = fused_plain(v, src_ep, dst_ep, edge_mask, q, k, b_edge)
            return bias, deg, gate if want_gate else None
        raise ValueError(f"fused_sddmm_spmm: unsupported device {v.device}")
    n, h = v.shape
    e = src_ep.shape[0]
    if n >= 2**31 or 2 * e >= 2**31:
        raise ValueError(f"fused_sddmm_spmm: N={n} or 2E={2 * e} out of int32 range")
    if index is None:
        index = edge_index(src_ep, dst_ep, edge_mask, n)
    _check_index(index, n, e, v.device)
    row_ptr, nbr, eid = (t.contiguous() for t in index)
    v = v.contiguous()
    src_ep = src_ep.contiguous()
    dst_ep = dst_ep.contiguous()
    edge_mask = edge_mask.contiguous()
    if gated:
        q, k, b_edge = q.contiguous(), k.contiguous(), b_edge.contiguous()
    # the kernel writes every element once: nothing is zero-filled (the
    # gate is scratch for the row pass when gated and not wanted)
    bias = torch.empty((n, h), dtype=torch.float32, device=v.device)
    deg = torch.empty(n, dtype=torch.float32, device=v.device)
    gate = torch.empty(e, dtype=torch.float32, device=v.device) if want_gate or gated else None
    args = (
        src_ep.data_ptr(),
        dst_ep.data_ptr(),
        edge_mask.data_ptr(),
        row_ptr.data_ptr(),
        nbr.data_ptr(),
        eid.data_ptr(),
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
        None if gate is None else gate.data_ptr(),
    )
    err = cuda_build.launch(_kernel(), args, v.device)
    if err != 0:
        raise RuntimeError(f"fused_sddmm_spmm kernel launch failed: cudaError {err}")
    fused_sddmm_spmm.launches += 1
    return bias, deg, gate if want_gate else None


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
    index: Optional[EdgeIndex] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GraphSAGE neighbor aggregation: the bidirectional masked SpMM and
    the degree in one kernel. Returns (agg[N, F], deg[N]); neighbor_mean
    divides agg by max(deg, 1)."""
    agg, deg, _ = fused_sddmm_spmm(
        h, src_ep, dst_ep, edge_mask, want_gate=False, index=index
    )
    return agg, deg

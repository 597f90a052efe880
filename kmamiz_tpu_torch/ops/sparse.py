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
and no fallback between the two. When an input wants a grad, both
routes run inside one torch.autograd.Function, whose backward is the
kernel's backward on the card (`fused_backward`: one C call that launches
the SDDMM of the gate's grad and a row pass over the edge list's gather
index, in csrc/fused_sddmm_spmm.cu) and its plain versions on the CPU
(`fused_backward_plain` composes them). The JAX package has no backward
kernel: JAX differentiates its XLA formulation, whose VJP these equal.

The module also holds the JAX module's sparse counting primitives
(`dense_rank_pairs`, `run_start_index`, `exclusive_cumsum`), the
building blocks of ops/scorers.py's packed-key pipeline: plain PyTorch
ops on any device, int32 throughout, with no host sync.
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
    edge with src == n (j = E + e), in order of j. `gather` is the index
    the backward reads (rows by the clamped gather id of every live side;
    equal to this one when every live id lies in [0, N)), or None when the
    index was built for forwards only. The gather index also holds `pos`
    and `split`, what the backward's kernels read in place of eid."""

    row_ptr: torch.Tensor  # int32[N+1]: row n is entries row_ptr[n]:row_ptr[n+1]
    nbr: torch.Tensor  # int32[2E]: the other end (the kernel clamps its gather)
    eid: torch.Tensor  # int64[2E]: j, the edge id with its direction
    gather: Optional["EdgeIndex"] = None
    # gather index only: int32[2E], the entry that holds slot j (the inverse
    # of the sort), -1 where the slot is parked past row_ptr[N]
    pos: Optional[torch.Tensor] = None
    # gather index only: int32[N], the first src-side entry (j >= E) of each
    # row; the row's dst-side entries, j < E, come before it
    split: Optional[torch.Tensor] = None


def edge_keys_plain(
    src_ep: torch.Tensor,
    dst_ep: torch.Tensor,
    edge_mask: torch.Tensor,
    n: int,
    gather: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """edge_index's sort keys and opposite ends for the 2E entries (dst
    sides, then src sides), in plain PyTorch: key = that end's row, or n
    when the edge is masked off or the row lies outside [0, n). With
    gather=True the gather index's keys: the row clamped into [0, n) for
    every live side, n for masked-off edges."""
    rows = torch.cat([dst_ep, src_ep])
    live = edge_mask.repeat(2)
    if gather:
        keys = torch.where(live, rows.clamp(0, n - 1), n)
    else:
        keys = torch.where(live & (rows >= 0) & (rows < n), rows, n)
    return keys, torch.cat([src_ep, dst_ep])


def edge_index(
    src_ep: torch.Tensor,
    dst_ep: torch.Tensor,
    edge_mask: torch.Tensor,
    n: int,
    for_backward: bool = False,
) -> EdgeIndex:
    """The CSR index of the edge list over n node rows, as the kernel reads
    it. A side whose id lies outside [0, n), and both sides of a masked-off
    edge, park at key n past the last row, so only the first row_ptr[n] of
    the 2E entries are live. The keys come from a small kernel of
    csrc/fused_sddmm_spmm.cu on the card (edge_keys_plain on the CPU), then
    one stable sort and one searchsorted: no host sync. for_backward=True
    also builds the gather index the backward reads (`EdgeIndex.gather`):
    one more keys launch, sort and searchsorted, then its `pos` (one
    scatter) and `split` (one more searchsorted). Owners of an edge list
    that stays fixed build the index once and pass it to every call."""
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
    edge_index.builds += 1
    index = _csr(src_ep, dst_ep, edge_mask, n, gather=False)
    if for_backward:
        index = index._replace(gather=_csr(src_ep, dst_ep, edge_mask, n, gather=True))
    return index


#: edge_index calls in this process (each builds one index, or two with
#: for_backward)
edge_index.builds = 0


def edge_keys(
    src_ep: torch.Tensor,
    dst_ep: torch.Tensor,
    edge_mask: torch.Tensor,
    n: int,
    gather: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """edge_index's sort keys and opposite ends (see edge_keys_plain, its
    plain version, which CPU tensors take). Card tensors: one launch of
    csrc/fused_sddmm_spmm.cu's keys kernel, int16 keys when n < 2^15 (the
    radix sort then runs two 8-bit passes instead of four), else int32."""
    device = src_ep.device
    if device.type != "cuda":
        return edge_keys_plain(src_ep, dst_ep, edge_mask, n, gather)
    e = src_ep.shape[0]
    key_dtype = torch.int16 if n < 2**15 else torch.int32
    keys = torch.empty(2 * e, dtype=key_dtype, device=device)
    other = torch.empty(2 * e, dtype=torch.int32, device=device)
    args = (
        src_ep.contiguous().data_ptr(),
        dst_ep.contiguous().data_ptr(),
        edge_mask.contiguous().data_ptr(),
        e,
        n,
        int(gather),
        keys.element_size(),
        keys.data_ptr(),
        other.data_ptr(),
    )
    _launch("kmamiz_edge_index_keys", args, device)
    return keys, other


def _csr(src_ep, dst_ep, edge_mask, n: int, gather: bool) -> EdgeIndex:
    e = src_ep.shape[0]
    device = src_ep.device
    keys, other = edge_keys(src_ep, dst_ep, edge_mask, n, gather)
    sorted_keys, order = torch.sort(keys, stable=True)
    row_ptr = torch.searchsorted(
        sorted_keys, torch.arange(n + 1, dtype=keys.dtype, device=device), out_int32=True
    )
    index = EdgeIndex(row_ptr, other[order], order)
    if not gather:
        return index
    # pos: entry p holds slot order[p]; parked entries give -1
    entries = torch.arange(2 * e, dtype=torch.int32, device=device)
    pos = torch.empty_like(entries).scatter_(
        0, order, torch.where(entries < row_ptr[-1], entries, -1)
    )
    # split: with side = (j >= E), 2 * key + side is sorted too (the sort is
    # stable in j), so row r's src side starts at the first 2r + 1
    keys2 = sorted_keys.to(torch.int32) * 2 + (order >= e)
    split = torch.searchsorted(
        keys2, torch.arange(1, 2 * n, 2, dtype=torch.int32, device=device), out_int32=True
    )
    return index._replace(pos=pos, split=split)


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
    (bias[N, H], deg[N], gate[E]), the un-normalised sums, in v's dtype."""
    n, h = v.shape
    src = src_ep.long()
    dst = dst_ep.long()
    src_c = src.clamp(0, n - 1)
    dst_c = dst.clamp(0, n - 1)
    em = edge_mask.to(v.dtype)
    if q is None:
        gate = em
    else:
        affinity = (q[src_c] * k[dst_c]).sum(dim=1) / math.sqrt(h)
        gate = torch.sigmoid(affinity + b_edge.reshape(())) * em
    # scatter ids: masked-off and out-of-range edges park at the spill row n
    src_s = torch.where(edge_mask & (src >= 0) & (src < n), src, n)
    dst_s = torch.where(edge_mask & (dst >= 0) & (dst < n), dst, n)
    g = gate[:, None]
    bias = torch.zeros((n + 1, h), dtype=v.dtype, device=v.device)
    bias.index_add_(0, dst_s, v[src_c] * g)
    bias.index_add_(0, src_s, v[dst_c] * g)
    deg = torch.zeros(n + 1, dtype=v.dtype, device=v.device)
    deg.index_add_(0, dst_s, gate)
    deg.index_add_(0, src_s, gate)
    return bias[:n], deg[:n], gate


def grad_edges_plain(
    v: torch.Tensor,
    src_ep: torch.Tensor,
    dst_ep: torch.Tensor,
    edge_mask: torch.Tensor,
    gate: torch.Tensor,
    d_bias: torch.Tensor,
    d_deg: Optional[torch.Tensor] = None,
    d_gate: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """da[E], the grad of the gated forward's gate logit, in plain
    PyTorch (the plain version of fused_sddmm_spmm_grad_edges): for edge
    e = (s, d) with gather rows sc, dc (the ids clamped into [0, N))

        dg_e = d_gate[e] + [d in [0, N)] (d_bias[d]·v[sc] + d_deg[d])
                         + [s in [0, N)] (d_bias[s]·v[dc] + d_deg[s])
        da_e = dg_e g_e (1 - g_e)

    (a scatter the forward dropped passes no grad back; masked-off edges
    have g_e = 0). d_deg and d_gate may be None (no grad)."""
    n = v.shape[0]
    src, dst = src_ep.long(), dst_ep.long()
    src_c, dst_c = src.clamp(0, n - 1), dst.clamp(0, n - 1)
    to_dst = (edge_mask & (dst >= 0) & (dst < n)).to(v.dtype)
    to_src = (edge_mask & (src >= 0) & (src < n)).to(v.dtype)
    dg = to_dst * (d_bias[dst_c] * v[src_c]).sum(dim=1) + to_src * (d_bias[src_c] * v[dst_c]).sum(dim=1)
    if d_deg is not None:
        dg = dg + to_dst * d_deg[dst_c] + to_src * d_deg[src_c]
    if d_gate is not None:
        dg = dg + d_gate
    return dg * (gate * (1.0 - gate))


def grad_rows_plain(
    n: int,
    src_ep: torch.Tensor,
    dst_ep: torch.Tensor,
    edge_mask: torch.Tensor,
    gate: torch.Tensor,
    d_bias: Optional[torch.Tensor],
    da: Optional[torch.Tensor] = None,
    q: Optional[torch.Tensor] = None,
    k: Optional[torch.Tensor] = None,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(dv, dq, dk) [N, H] in plain PyTorch (the plain version of
    fused_sddmm_spmm_grad_rows), by gather row:

        dv[sc] += g_e d_bias[d]  if d lies in [0, N)
        dv[dc] += g_e d_bias[s]  if s lies in [0, N)
        dq[sc] += da_e k[dc] / sqrt(H),  dk[dc] += da_e q[sc] / sqrt(H)

    dv is None when d_bias is; dq and dk are None unless q, k and da are
    given. gate None is the ungated gate, the mask."""
    src, dst = src_ep.long(), dst_ep.long()
    src_c, dst_c = src.clamp(0, n - 1), dst.clamp(0, n - 1)
    dv = dq = dk = None
    if d_bias is not None:
        if gate is None:
            gate = edge_mask.to(d_bias.dtype)
        to_dst = (edge_mask & (dst >= 0) & (dst < n)).to(d_bias.dtype)
        to_src = (edge_mask & (src >= 0) & (src < n)).to(d_bias.dtype)
        dv = torch.zeros_like(d_bias)
        dv.index_add_(0, src_c, (gate * to_dst)[:, None] * d_bias[dst_c])
        dv.index_add_(0, dst_c, (gate * to_src)[:, None] * d_bias[src_c])
    if q is not None and da is not None:
        scale = math.sqrt(q.shape[1])
        dq = torch.zeros_like(q)
        dq.index_add_(0, src_c, da[:, None] * k[dst_c] / scale)
        dk = torch.zeros_like(k)
        dk.index_add_(0, dst_c, da[:, None] * q[src_c] / scale)
    return dv, dq, dk


def entry_values_plain(gather: EdgeIndex, gate: torch.Tensor, da: torch.Tensor) -> torch.Tensor:
    """gda[2E, 2]: each entry of the gather index with its edge's (gate,
    da), in entry order, in plain PyTorch (what the backward's SDDMM
    writes through `gather.pos`; parked entries, past row_ptr[N], hold 0
    here and are not written by the kernel)."""
    e = gate.shape[0]
    values = torch.stack([gate, da], dim=1).repeat(2, 1)  # slot j: edge j mod E
    # parked slots land on a spill row past the 2E entries
    to = torch.where(gather.pos >= 0, gather.pos, 2 * e).long()
    out = torch.zeros((2 * e + 1, 2), dtype=gate.dtype, device=gate.device)
    out.index_put_((to,), values)
    return out[: 2 * e]


def grad_rows_index_plain(
    n: int,
    gather: EdgeIndex,
    d_bias: Optional[torch.Tensor],
    gda: Optional[torch.Tensor] = None,
    q: Optional[torch.Tensor] = None,
    k: Optional[torch.Tensor] = None,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(dv, dq, dk) [N, H] in plain PyTorch from what the backward's row
    pass reads: the gather index (row_ptr, nbr, split) and the entries'
    (g, da) in entry order (gda, as entry_values_plain gives it). Per
    entry of row r with other end o (clamped to oc):

        dv[r] += g d_bias[o]   if o lies in [0, N)
        dq[r] += da k[oc]      on the src side (the entry at or past split[r])
        dk[r] += da q[oc]      on the dst side

    and dq, dk times 1/sqrt(H) after the sums, as the kernel scales them.
    dv is None when d_bias is; dq and dk unless q, k and gda are given.
    gda None is the ungated gate, 1 for every live entry."""
    entries = gather.nbr.shape[0]
    device = gather.nbr.device
    p = torch.arange(entries, device=device)
    # each entry's row; parked entries (past row_ptr[N]) land on row n
    row = torch.searchsorted(gather.row_ptr[1:], p, right=True)
    other = gather.nbr.long()
    oc = other.clamp(0, n - 1)
    dv = dq = dk = None

    def row_sums(rows, terms):
        out = torch.zeros((n + 1, terms.shape[1]), dtype=terms.dtype, device=device)
        return out.index_add_(0, rows, terms)[:n]

    if d_bias is not None:
        g = torch.ones(entries, dtype=d_bias.dtype, device=device) if gda is None else gda[:, 0]
        g = g * ((other >= 0) & (other < n)).to(d_bias.dtype)
        dv = row_sums(row, g[:, None] * d_bias[oc])
    if q is not None and gda is not None:
        last = torch.full((1,), entries, dtype=torch.int32, device=device)
        bounds = torch.cat([gather.split, last])
        src_side = p >= bounds[row]
        da = gda[:, 1, None]
        inv = 1.0 / math.sqrt(q.shape[1])
        dq = row_sums(torch.where(src_side, row, n), da * k[oc]) * inv
        dk = row_sums(torch.where(src_side, n, row), da * q[oc]) * inv
    return dv, dq, dk


def fused_backward_plain(
    v: torch.Tensor,
    src_ep: torch.Tensor,
    dst_ep: torch.Tensor,
    edge_mask: torch.Tensor,
    gate: torch.Tensor,
    d_bias: Optional[torch.Tensor],
    d_deg: Optional[torch.Tensor] = None,
    d_gate: Optional[torch.Tensor] = None,
    q: Optional[torch.Tensor] = None,
    k: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The plain PyTorch VJP of fused_plain: (dv, dq, dk, db) for the
    upstream grads d_bias[N, H], d_deg[N] and d_gate[E] (each may be None:
    no grad) at the forward's gate[E] (ungated: the mask, or None); dq,
    dk and db are None ungated (q None). grad_edges_plain's da, then
    grad_rows_plain, and db = sum of da."""
    if d_bias is None:
        d_bias = torch.zeros_like(v)
    if q is None:
        dv, _, _ = grad_rows_plain(v.shape[0], src_ep, dst_ep, edge_mask, gate, d_bias)
        return dv, None, None, None
    da = grad_edges_plain(v, src_ep, dst_ep, edge_mask, gate, d_bias, d_deg, d_gate)
    dv, dq, dk = grad_rows_plain(v.shape[0], src_ep, dst_ep, edge_mask, gate, d_bias, da, q, k)
    return dv, dq, dk, da.sum()


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
    # float64 only on the CPU: the plain version is dtype-generic (gradcheck)
    # graftlint: disable=dtype-drift -- a dtype check, not f64 work: the card path admits float32 only
    floats = (torch.float32, torch.float64) if v.device.type == "cpu" else (torch.float32,)
    if (
        v.dtype not in floats
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
    if not (q.dtype == k.dtype == b_edge.dtype == v.dtype):
        raise TypeError("gated mode wants q, k and b_edge of v's float type")
    if q.device != device or k.device != device or b_edge.device != device:
        raise ValueError("fused_sddmm_spmm inputs lie on different devices")


def _check_index(index: EdgeIndex, n: int, e: int, device) -> None:
    for part in (index, index.gather):
        if part is None:
            continue
        row_ptr, nbr, eid = part.row_ptr, part.nbr, part.eid
        if row_ptr.shape != (n + 1,) or nbr.shape != (2 * e,) or eid.shape != (2 * e,):
            raise ValueError(
                f"edge index shaped {tuple(row_ptr.shape)}, {tuple(nbr.shape)}, "
                f"{tuple(eid.shape)} for N={n}, E={e}"
            )
        if row_ptr.dtype != torch.int32 or nbr.dtype != torch.int32 or eid.dtype != torch.int64:
            raise TypeError("the edge index is int32 row_ptr and nbr, int64 eid")
        if row_ptr.device != device or nbr.device != device or eid.device != device:
            raise ValueError("the edge index lies on another device")
    gather = index.gather
    if gather is None:
        return
    pos, split = gather.pos, gather.split
    if pos is None or split is None:
        raise ValueError(
            "the gather index has no pos/split: build it with edge_index(..., for_backward=True)"
        )
    if pos.shape != (2 * e,) or split.shape != (n,):
        raise ValueError(
            f"gather index pos {tuple(pos.shape)}, split {tuple(split.shape)} for N={n}, E={e}"
        )
    if pos.dtype != torch.int32 or split.dtype != torch.int32:
        raise TypeError("the gather index's pos and split are int32")
    if pos.device != device or split.device != device:
        raise ValueError("the edge index lies on another device")


def _contiguous(index: Optional[EdgeIndex]) -> Optional[EdgeIndex]:
    """The index with every tensor (the gather part's included) contiguous."""
    if index is None:
        return None
    return EdgeIndex(
        *(
            _contiguous(t) if isinstance(t, EdgeIndex) else (None if t is None else t.contiguous())
            for t in index
        )
    )


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
        ctypes.c_int,  # gather (1: the backward's gather index)
        ctypes.c_int,  # key_bytes (2: int16 keys, 4: int32)
        ctypes.c_void_p,  # keys
        ctypes.c_void_p,  # other
        ctypes.c_void_p,  # stream
    ],
    "kmamiz_fused_sddmm_spmm_backward": [
        ctypes.c_void_p,  # src
        ctypes.c_void_p,  # dst
        ctypes.c_void_p,  # mask
        ctypes.c_void_p,  # row_ptr (gather index)
        ctypes.c_void_p,  # nbr
        ctypes.c_void_p,  # split
        ctypes.c_void_p,  # pos
        ctypes.c_void_p,  # v
        ctypes.c_void_p,  # q
        ctypes.c_void_p,  # k
        ctypes.c_void_p,  # gate
        ctypes.c_void_p,  # d_bias
        ctypes.c_void_p,  # d_deg (nullable)
        ctypes.c_void_p,  # d_gate (nullable)
        ctypes.c_int,  # gated
        ctypes.c_int,  # stages (_EDGES | _ROWS)
        ctypes.c_int64,  # e
        ctypes.c_int32,  # n
        ctypes.c_int32,  # h
        ctypes.c_float,  # sqrt_h
        ctypes.c_void_p,  # dv (nullable)
        ctypes.c_void_p,  # dq (nullable)
        ctypes.c_void_p,  # dk (nullable)
        ctypes.c_void_p,  # db (nullable)
        ctypes.c_void_p,  # da (nullable)
        ctypes.c_void_p,  # gda: 2E float2 scratch
        ctypes.c_void_p,  # partials: db's block partials
        ctypes.c_int32,  # partials_cap
        ctypes.c_void_p,  # stream
    ],
    "kmamiz_fused_sddmm_spmm_backward_info": [
        ctypes.c_int,  # which: 0 the SDDMM, 1 the row pass
        ctypes.c_int,  # vw
        ctypes.c_int,  # gated
        ctypes.c_void_p,  # out: int32[5]
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


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(name: str, args, device) -> None:
    err = cuda_build.launch(_kernel(name), args, device)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _forward_kernel(v, src_ep, dst_ep, edge_mask, q, k, b_edge, want_gate, index):
    """The forward launch on card tensors (contiguous, checked)."""
    n, h = v.shape
    e = src_ep.shape[0]
    gated = q is not None
    # the kernel writes every element once: nothing is zero-filled (the
    # gate is scratch for the row pass when gated and not wanted)
    bias = torch.empty((n, h), dtype=torch.float32, device=v.device)
    deg = torch.empty(n, dtype=torch.float32, device=v.device)
    gate = torch.empty(e, dtype=torch.float32, device=v.device) if want_gate or gated else None
    args = (
        src_ep.data_ptr(),
        dst_ep.data_ptr(),
        edge_mask.data_ptr(),
        index.row_ptr.data_ptr(),
        index.nbr.data_ptr(),
        index.eid.data_ptr(),
        v.data_ptr(),
        _ptr(q),
        _ptr(k),
        _ptr(b_edge),
        int(gated),
        e,
        n,
        h,
        math.sqrt(h),
        bias.data_ptr(),
        deg.data_ptr(),
        _ptr(gate),
    )
    _launch("kmamiz_fused_sddmm_spmm", args, v.device)
    fused_sddmm_spmm.launches += 1
    return bias, deg, gate


#: stages of the backward's C entry
_EDGES = 1  # the SDDMM of da (gated only)
_ROWS = 2  # the row pass, and db
#: room for the SDDMM's per-block partials of db (the kernel caps its grid
#: to it; the card's SM count times the resident blocks is far below)
_PARTIALS = 2048


def _gather_part(index: Optional[EdgeIndex]) -> EdgeIndex:
    if index is None or index.gather is None:
        raise ValueError(
            "the fused kernel's backward reads the gather index: build the "
            "edge index with edge_index(..., for_backward=True)"
        )
    return index.gather


def _backward_call(
    stages, gated, device, v, src_ep, dst_ep, edge_mask, gate, d_bias, d_deg, d_gate, q, k,
    gather, n, h, dv=None, dq=None, dk=None, db=None, da=None, gda=None, partials=None,
) -> None:
    """One call of kmamiz_fused_sddmm_spmm_backward: the inputs are
    contiguous card tensors or None, the outputs and scratch (dv ...
    partials) raw device pointers or None (not wanted)."""
    args = (
        _ptr(src_ep),
        _ptr(dst_ep),
        _ptr(edge_mask),
        gather.row_ptr.data_ptr(),
        gather.nbr.data_ptr(),
        gather.split.data_ptr(),
        gather.pos.data_ptr(),
        _ptr(v),
        _ptr(q),
        _ptr(k),
        _ptr(gate),
        _ptr(d_bias),
        _ptr(d_deg),
        _ptr(d_gate),
        int(gated),
        stages,
        gather.nbr.shape[0] // 2,
        n,
        h,
        math.sqrt(h),
        dv,
        dq,
        dk,
        db,
        da,
        gda,
        partials,
        _PARTIALS,
    )
    _launch("kmamiz_fused_sddmm_spmm_backward", args, device)


def fused_sddmm_spmm_grad_edges(
    v, src_ep, dst_ep, edge_mask, gate, d_bias, d_deg=None, d_gate=None,
    index: Optional[EdgeIndex] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward's SDDMM alone: (da[E], gda[2E, 2]), da as
    grad_edges_plain gives it and each gather-index entry's (gate, da) in
    entry order, as entry_values_plain gives it (the plain versions, which
    CPU tensors take). Card tensors: one launch (csrc/fused_sddmm_spmm.cu,
    kernel 3), which leaves gda's parked entries, past the gather index's
    row_ptr[N], unwritten. fused_backward runs it and the row pass in one
    call; this entry times and checks it alone."""
    gather = _gather_part(index)
    if not v.is_cuda:
        da = grad_edges_plain(v, src_ep, dst_ep, edge_mask, gate, d_bias, d_deg, d_gate)
        return da, entry_values_plain(gather, gate, da)
    n, h = v.shape
    e = src_ep.shape[0]
    # one allocation: gda [2E, 2], da [E], the partials of db
    buf = torch.empty(5 * e + _PARTIALS, dtype=torch.float32, device=v.device)
    base = buf.data_ptr()
    _backward_call(
        _EDGES, True, v.device, v, src_ep, dst_ep, edge_mask, gate, d_bias, d_deg, d_gate,
        None, None, gather, n, h, da=base + 16 * e, gda=base, partials=base + 20 * e,
    )
    fused_sddmm_spmm_grad_edges.launches += 1
    return buf[4 * e : 5 * e], buf[: 4 * e].view(2 * e, 2)


#: launches of the backward's SDDMM kernel in this process
fused_sddmm_spmm_grad_edges.launches = 0


def fused_sddmm_spmm_grad_rows(
    n: int,
    d_bias,
    gda=None,
    q=None,
    k=None,
    index: Optional[EdgeIndex] = None,
):
    """The backward's row pass alone: (dv, dq, dk) [N, H] over
    index.gather, dv when d_bias is given, dq and dk (gated) when q, k and
    the entries' (gate, da), gda, are (see grad_rows_index_plain, its plain
    version, which CPU tensors take). Card tensors: one launch
    (csrc/fused_sddmm_spmm.cu, kernel 4). fused_backward runs it after the
    SDDMM in one call; this entry times and checks it alone."""
    gather = _gather_part(index)
    ref = d_bias if d_bias is not None else q
    if not ref.is_cuda:
        return grad_rows_index_plain(n, gather, d_bias, gda, q, k)
    h = ref.shape[1]
    gated = q is not None
    want_qk = gated and gda is not None
    # dv alone: an [N, H] tensor, no view of it to build on the host
    out = torch.empty((3, n, h) if want_qk else (n, h), dtype=torch.float32, device=ref.device)
    base, step = out.data_ptr(), 4 * n * h
    _backward_call(
        _ROWS, gated, ref.device, None, None, None, None, None, d_bias, None, None,
        q if want_qk else None, k if want_qk else None, gather, n, h,
        dv=base if d_bias is not None else None,
        dq=base + step if want_qk else None,
        dk=base + 2 * step if want_qk else None,
        gda=None if gda is None else gda.data_ptr(),
    )
    fused_sddmm_spmm_grad_rows.launches += 1
    if not want_qk:
        return out if d_bias is not None else None, None, None
    return out[0] if d_bias is not None else None, out[1], out[2]


#: launches of the backward's row-pass kernel in this process
fused_sddmm_spmm_grad_rows.launches = 0


def backward_info(which: str, vw: int, gated: bool) -> dict:
    """What the current card makes of a backward kernel ("edges": the
    SDDMM, "rows": the row pass) at vector width vw (1, 2 or 4 floats):
    registers a thread, static shared memory a block, local (spill) bytes a
    thread, and resident warps an SM. Builds the kernel when it is not."""
    out = (ctypes.c_int * 5)()
    err = _kernel("kmamiz_fused_sddmm_spmm_backward_info")(
        0 if which == "edges" else 1, vw, int(gated), ctypes.addressof(out)
    )
    if err != 0:
        raise RuntimeError(f"kmamiz_fused_sddmm_spmm_backward_info failed: cudaError {err}")
    regs, smem, local, blocks, threads = out
    return {
        "registers": regs,
        "shared_bytes": smem,
        "local_bytes": local,
        "resident_warps_per_sm": blocks * threads // 32,
    }


def fused_backward(
    v, src_ep, dst_ep, edge_mask, gate, d_bias, d_deg=None, d_gate=None,
    q=None, k=None, index: Optional[EdgeIndex] = None,
    needs: Tuple[bool, bool, bool, bool] = (True, True, True, True),
):
    """(dv, dq, dk, db) of the fused forward for the upstream grads, as
    fused_backward_plain computes them; `needs` says which of (v, q, k,
    b_edge) want a grad (the others come back None, uncomputed). On the
    card: one C call over index.gather, which edge_index(...,
    for_backward=True) builds, launching (gated) the SDDMM of da, which
    writes each entry's (gate, da) in entry order, then the row pass for
    dv, dq and dk, which also sums db from the SDDMM's block partials.
    That is two launches gated and one ungated (none when nothing wants a
    grad), into one allocation: dv, dq, dk as views of one [3, N, H]
    tensor (one [N, H] tensor ungated), the entries' (gate, da), db's
    partials and db. No host sync. Gated, the SDDMM runs even when only v wants a grad
    (no caller of the port asks for that): only it writes the entries'
    gate in entry order, which the row pass reads. CPU tensors take the
    plain versions."""
    n, h = v.shape
    gated = q is not None
    need_v, need_q, need_k, need_b = needs
    if not gated:
        need_q = need_k = need_b = False
    if not (need_v or need_q or need_k or need_b):
        return None, None, None, None
    if d_bias is None:
        d_bias = torch.zeros_like(v)
    if not v.is_cuda:
        dv, dq, dk, db = fused_backward_plain(
            v, src_ep, dst_ep, edge_mask, gate, d_bias, d_deg, d_gate, q, k
        )
        return (
            dv if need_v else None, dq if need_q else None, dk if need_k else None,
            db if need_b else None,
        )
    gather = _gather_part(index)
    d_bias, d_deg, d_gate = (None if t is None else t.contiguous() for t in (d_bias, d_deg, d_gate))
    e = src_ep.shape[0]
    # gated, the SDDMM always runs: it also hands the row pass each
    # entry's gate, in entry order
    edges = gated
    slots = 3 if gated else 1
    grads = slots * n * h
    # past the grads, from a multiple of 4 floats (8-byte float2 access):
    # the entries' (gate, da) [2E, 2], the partials, db
    gda = (grads + 3) // 4 * 4
    partials = gda + 4 * e
    db = partials + _PARTIALS
    # ungated: dv alone, an [N, H] tensor (no view of it to build on the host)
    buf = torch.empty(db + 1 if edges else (n, h), dtype=torch.float32, device=v.device)
    base = buf.data_ptr()
    _backward_call(
        (_EDGES if edges else 0) | _ROWS, gated, v.device, v, src_ep, dst_ep, edge_mask, gate,
        d_bias, d_deg, d_gate, q, k, gather, n, h,
        dv=base if need_v else None,
        dq=base + 4 * n * h if need_q else None,
        dk=base + 8 * n * h if need_k else None,
        db=base + 4 * db if need_b else None,
        gda=base + 4 * gda if edges else None,
        partials=base + 4 * partials if edges else None,
    )
    fused_backward.launches += 1
    if edges:
        fused_sddmm_spmm_grad_edges.launches += 1
    fused_sddmm_spmm_grad_rows.launches += 1
    if not gated:
        return buf, None, None, None
    out = buf[:grads].view(slots, n, h)
    return (
        out[0] if need_v else None,
        out[1] if need_q else None,
        out[2] if need_k else None,
        buf[db : db + 1] if need_b else None,
    )


#: C calls of the whole backward in this process (each launches the SDDMM,
#: gated, and the row pass, and counts them on their wrappers' counters)
fused_backward.launches = 0


class _Fused(torch.autograd.Function):
    """fused_sddmm_spmm with its VJP: the kernels on the card, the plain
    versions on the CPU. The forward saves the gate (and, on the card, the
    edge index the backward reads); the backward builds no index."""

    @staticmethod
    def forward(ctx, v, q, k, b_edge, src_ep, dst_ep, edge_mask, index, want_gate):
        gated = q is not None
        if v.is_cuda:
            bias, deg, gate = _forward_kernel(
                v, src_ep, dst_ep, edge_mask, q, k, b_edge, want_gate, index
            )
        else:
            bias, deg, gate = fused_plain(v, src_ep, dst_ep, edge_mask, q, k, b_edge)
        ctx.set_materialize_grads(False)
        ctx.index = index
        ctx.b_shape = None if b_edge is None else b_edge.shape
        # ungated, the gate is the mask and deg counts it: no input moves them
        if not gated:
            # one call: a second would replace the first's set
            ctx.mark_non_differentiable(*(t for t in (deg, gate) if t is not None))
        ctx.save_for_backward(v, q, k, src_ep, dst_ep, edge_mask, gate)
        if not want_gate:
            return bias, deg, None
        return bias, deg, gate

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_bias, d_deg, d_gate):
        v, q, k, src_ep, dst_ep, edge_mask, gate = ctx.saved_tensors
        needs = tuple(ctx.needs_input_grad[:4])
        dv, dq, dk, db = fused_backward(
            v, src_ep, dst_ep, edge_mask, gate, d_bias, d_deg, d_gate,
            q, k, ctx.index, needs,
        )
        if db is not None:
            db = db.reshape(ctx.b_shape)
        return dv, dq, dk, db, None, None, None, None, None


def wants_grad(*tensors) -> bool:
    """True when autograd records and one of the tensors wants a grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors
    )


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

    Differentiable in v, q, k and b_edge (the autograd Function above;
    when no input wants a grad the launch runs without it). CUDA inputs
    launch the kernel on the current stream without a sync; a
    backward on the card needs the index's gather part, which the index
    built here has whenever an input wants a grad (a given index without
    it raises). CPU inputs run fused_plain and fused_backward_plain and
    ignore the index."""
    _check(v, src_ep, dst_ep, edge_mask, q, k, b_edge)
    if v.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_sddmm_spmm: unsupported device {v.device}")
    grad = wants_grad(v, q, k, b_edge)
    if v.is_cuda:
        n, h = v.shape
        e = src_ep.shape[0]
        if n >= 2**31 or 2 * e >= 2**31:
            raise ValueError(f"fused_sddmm_spmm: N={n} or 2E={2 * e} out of int32 range")
        if index is None:
            index = edge_index(src_ep, dst_ep, edge_mask, n, for_backward=grad)
        _check_index(index, n, e, v.device)
        if grad and index.gather is None:
            raise ValueError(
                "fused_sddmm_spmm: an input wants a grad and the given edge index "
                "has no gather part; build it with edge_index(..., for_backward=True)"
            )
        index = _contiguous(index)
        v, src_ep, dst_ep, edge_mask = (t.contiguous() for t in (v, src_ep, dst_ep, edge_mask))
        if q is not None:
            q, k, b_edge = q.contiguous(), k.contiguous(), b_edge.contiguous()
    if not grad:
        # nothing to differentiate (serving, no_grad): the launch alone,
        # without an autograd node and its host cost
        if v.is_cuda:
            bias, deg, gate = _forward_kernel(v, src_ep, dst_ep, edge_mask, q, k, b_edge, want_gate, index)
        else:
            bias, deg, gate = fused_plain(v, src_ep, dst_ep, edge_mask, q, k, b_edge)
        return bias, deg, gate if want_gate else None
    return _Fused.apply(v, q, k, b_edge, src_ep, dst_ep, edge_mask, index, want_gate)


#: launches of the forward kernel in this process (CPU calls do not count)
fused_sddmm_spmm.launches = 0


def fused_gated_bias(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    b_edge: torch.Tensor,
    src_ep: torch.Tensor,
    dst_ep: torch.Tensor,
    edge_mask: torch.Tensor,
    index: Optional[EdgeIndex] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """STLGT neighbor bias: the gate ``sigmoid(q[src]·k[dst] / sqrt(H) +
    b_edge) * mask`` and the bidirectional gated SpMM in one kernel.
    Returns (bias_sum[N, H], gate_deg[N], gate[E]), un-normalised; the
    model divides by max(gate_deg, 1). `index` as in fused_sddmm_spmm."""
    return fused_sddmm_spmm(v, src_ep, dst_ep, edge_mask, q, k, b_edge, index=index)


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


# ---------------------------------------------------------------------------
# sparse counting primitives (scorer building blocks, plain PyTorch)
# ---------------------------------------------------------------------------


def dense_rank_pairs(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense rank of (a, b) pairs: returns (gid[N] int32, a_of_gid[N]
    int32) where gid is the 0-based rank of row (a[i], b[i]) in the sorted
    distinct-pair order and a_of_gid[g] recovers a for group g (slots past
    the group count are 0). The rank order is (a, b)-lexicographic, so
    within any fixed a the gid is monotone in b and contiguous per a. One
    sort of the pairs packed into an int64 key, one scatter back."""
    n = a.shape[0]
    a32, b32 = a.to(torch.int32), b.to(torch.int32)
    key = (a32.to(torch.int64) << 32) | (b32.to(torch.int64) + 2**31)
    order = torch.sort(key).indices
    s_a, s_b = a32[order], b32[order]
    first = torch.cat(
        [
            torch.ones(1, dtype=torch.bool, device=a.device),
            (s_a[1:] != s_a[:-1]) | (s_b[1:] != s_b[:-1]),
        ]
    )
    rank_sorted = torch.cumsum(first.to(torch.int32), 0, dtype=torch.int32) - 1
    gid = torch.zeros(n, dtype=torch.int32, device=a.device).scatter_(0, order, rank_sorted)
    # idempotent per-group scatter: every row of group g writes the same a
    # (include_self keeps the zero fill in the max, as `.at[].max` does)
    a_of_gid = torch.zeros(n, dtype=torch.int32, device=a.device).scatter_reduce_(
        0, rank_sorted.to(torch.int64), s_a, "amax"
    )
    return gid, a_of_gid


def run_start_index(first: torch.Tensor) -> torch.Tensor:
    """For each row of a sorted table, the index of its run's first row
    (`first` marks run boundaries): a cummax over (first ? i : -1). Rows
    before any boundary clamp to 0."""
    iota = torch.arange(first.shape[0], dtype=torch.int32, device=first.device)
    marked = torch.where(first, iota, -1)
    return torch.cummax(marked, 0).values.clamp(min=0)


def exclusive_cumsum(flags: torch.Tensor) -> torch.Tensor:
    """int32 exclusive prefix sum with a trailing total, length N+1:
    out[i] = number of set flags strictly before i. Boundary differences
    out[hi] - out[lo] over it are exact distinct counts."""
    return torch.cat(
        [
            torch.zeros(1, dtype=torch.int32, device=flags.device),
            torch.cumsum(flags.to(torch.int32), 0, dtype=torch.int32),
        ]
    )

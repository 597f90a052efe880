"""Lexicographic sort/unique over int32 key columns.

Counterpart of kmamiz_tpu/ops/sortutil.py with bit-identical outputs: the
sorted unique rows form a prefix and every other row is parked at
SENTINEL (INT32_MAX) in every column. The JAX package sorts all columns
in one variadic lax.sort; torch has no multi-key sort, so lex_unique packs
the two most significant columns into one int64 key (exact for any int32
values) and sorts the remaining columns by stable passes in reverse key
order before it.

Every function works along the last dimension: a [T, n] stack of columns
sorts and compacts each of its T rows on its own, in one batched program
(the tenant axis of tenancy/batch.py), with each row bit-equal to the
same call on that row alone.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

SENTINEL = torch.iinfo(torch.int32).max


def park_invalid(
    cols: Sequence[torch.Tensor], valid: torch.Tensor
) -> List[torch.Tensor]:
    """Replace invalid rows with the sentinel in every column."""
    return [torch.where(valid, c.to(torch.int32), SENTINEL) for c in cols]


def _pair_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """int64 key ordered like (hi, lo) for any int32 hi and lo: hi fills
    the upper 32 bits, lo shifted to unsigned the lower 32."""
    return (hi.to(torch.int64) << 32) | (lo.to(torch.int64) + 2**31)


def _lex_order(cols: Sequence[torch.Tensor]) -> torch.Tensor:
    """Permutation along the last dimension sorting cols lexicographically
    (cols[0] primary)."""
    n = cols[0].shape[-1]
    order = torch.arange(n, device=cols[0].device).expand(cols[0].shape)
    tail = list(cols[2:]) if len(cols) > 1 else []
    # least significant keys first; each later stable pass keeps their order
    for c in reversed(tail):
        order = order.gather(-1, torch.sort(c.gather(-1, order), dim=-1, stable=True).indices)
    key = _pair_key(cols[0], cols[1]) if len(cols) > 1 else cols[0]
    return order.gather(-1, torch.sort(key.gather(-1, order), dim=-1, stable=True).indices)


def lex_unique(
    cols: Sequence[torch.Tensor], valid: torch.Tensor
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Sort rows lexicographically (cols[0] most significant) and mark the
    first occurrence of each distinct valid row.

    Returns (sorted_cols, unique_mask); parked rows sort to the end and are
    never marked unique.
    """
    parked = park_invalid(cols, valid)
    order = _lex_order(parked)
    sorted_cols = [c.gather(-1, order) for c in parked]
    lead = sorted_cols[0].shape[:-1]
    neq = torch.zeros(
        (*lead, sorted_cols[0].shape[-1] - 1), dtype=torch.bool, device=valid.device
    )
    for c in sorted_cols:
        neq = neq | (c[..., 1:] != c[..., :-1])
    first = torch.cat([torch.ones((*lead, 1), dtype=torch.bool, device=valid.device), neq], dim=-1)
    is_valid = sorted_cols[0] != SENTINEL
    return sorted_cols, first & is_valid


def scatter_compact(
    cols: Sequence[torch.Tensor], keep: torch.Tensor
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Pack kept rows into a prefix (input order preserved), parking the
    tail at SENTINEL. cumsum + scatter, so no host sync on the kept count;
    order-preserving, so sorted input stays sorted."""
    n = cols[0].shape[-1]
    lead = cols[0].shape[:-1]
    pos = torch.cumsum(keep, -1) - 1
    dest = torch.where(keep, pos, n)  # dropped rows land in a trash slot
    out = []
    for c in cols:
        buf = torch.full((*lead, n + 1), SENTINEL, dtype=torch.int32, device=c.device)
        buf.scatter_(-1, dest, torch.where(keep, c.to(torch.int32), SENTINEL))
        out.append(buf[..., :n])
    return out, out[0] != SENTINEL


def compact_unique(
    cols: Sequence[torch.Tensor], valid: torch.Tensor
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """lex_unique, then push duplicate/parked rows to the tail so distinct
    valid rows form a sorted prefix. Returns (cols, valid_mask)."""
    sorted_cols, uniq = lex_unique(cols, valid)
    return scatter_compact(sorted_cols, uniq)


# single-int32-key packing for (src, dst, dist) edge rows: 14+14+3 bits.
# Usable when the CALLER guarantees src/dst < 2^14 - 1 and 1 <= dist <= 8
# (the -1 keeps the max packed key below SENTINEL); outputs equal
# compact_unique's.
EDGE_KEY_EP_BITS = 14
EDGE_KEY_DIST_BITS = 3
EDGE_KEY_MAX_EP = (1 << EDGE_KEY_EP_BITS) - 1  # ids must be < this
EDGE_KEY_MAX_DIST = 1 << EDGE_KEY_DIST_BITS  # dist must be <= this


def compact_unique_edges_packed(
    src: torch.Tensor,
    dst: torch.Tensor,
    dist: torch.Tensor,
    valid: torch.Tensor,
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """compact_unique over (src, dst, dist) via one packed int32 key.

    Ordering matches the 3-column lexsort (the packing is monotone in
    (src, dst, dist)), so outputs are interchangeable with compact_unique.
    """
    shift = EDGE_KEY_EP_BITS + EDGE_KEY_DIST_BITS
    key = (
        (src.to(torch.int32) << shift)
        | (dst.to(torch.int32) << EDGE_KEY_DIST_BITS)
        | (dist.to(torch.int32) - 1)
    )
    key = torch.where(valid, key, SENTINEL)
    skey = torch.sort(key).values
    neq = torch.cat(
        [torch.ones(1, dtype=torch.bool, device=key.device), skey[1:] != skey[:-1]]
    )
    keep = neq & (skey != SENTINEL)
    (ckey,), valid_out = scatter_compact([skey], keep)
    dist_mask = EDGE_KEY_MAX_DIST - 1
    src_o = torch.where(valid_out, ckey >> shift, SENTINEL)
    dst_o = torch.where(
        valid_out, (ckey >> EDGE_KEY_DIST_BITS) & EDGE_KEY_MAX_EP, SENTINEL
    )
    dist_o = torch.where(valid_out, (ckey & dist_mask) + 1, SENTINEL)
    return [src_o, dst_o, dist_o], valid_out

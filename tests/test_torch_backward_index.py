"""The fused kernel's backward as the card runs it, on the CPU: the gather
index's entry-ordered fields (`pos`, `split`), the checks and the rebuild
that carry them, and the plain versions of what the two backward kernels
read and write (`entry_values_plain`, `grad_rows_index_plain`) against
the plain VJP, which tests/test_torch_sparse.py holds to jax.vjp of the
JAX package's XLA formulation.

Exactness: with dyadic inputs (multiples of 1/8, small) and H = 4 (the
1/sqrt(H) scale is 1/2) every product and every partial sum is exact in
float32, so sums in the index's row order and in index_add_'s order give
the same bits. Elsewhere the bias tolerance of test_torch_sparse.py:
rtol 1e-4 / atol 1e-5.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from kmamiz_tpu_torch.ops import sparse

SENTINEL = np.iinfo(np.int32).max


def _edges(case):
    """(src, dst, mask, n) for the index cases."""
    rng = np.random.default_rng(41)
    if case == "empty":
        z = np.zeros(0, np.int32)
        return z, z.copy(), np.zeros(0, bool), 8
    if case == "n1":
        src = np.array([0, 0, 5, -1, SENTINEL], np.int32)
        dst = np.array([0, 3, 0, 0, SENTINEL], np.int32)
        return src, dst, np.array([True, True, True, True, False]), 1
    n, e = 64, 600
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    mask = rng.random(e) < 0.8
    src[-e // 8 :] = SENTINEL
    dst[-e // 8 :] = SENTINEL
    mask[-e // 8 :] = False
    if case == "all-masked":
        mask[:] = False
    elif case == "out-of-range":
        mask[:12] = True
        src[:4] = n + np.arange(4)  # past the last row
        dst[4:8] = -1 - np.arange(4)  # below the first
        src[8:10], dst[10:12] = SENTINEL, SENTINEL
    elif case == "hub":
        src[:300] = 7
        mask[:300] = True
    return src, dst, mask, n


CASES = ["random", "empty", "n1", "all-masked", "out-of-range", "hub"]


def _index(case):
    src, dst, mask, n = _edges(case)
    t = torch.from_numpy
    return sparse.edge_index(t(src), t(dst), t(mask), n, for_backward=True), src, dst, mask, n


@pytest.mark.parametrize("case", CASES)
def test_pos_inverts_the_gather_sort(case):
    """pos[j] is the entry that holds slot j, -1 where the slot is parked:
    each live entry maps to its slot and back."""
    index, _src, _dst, mask, n = _index(case)
    gather = index.gather
    e = len(mask)
    pos, eid = gather.pos.numpy(), gather.eid.numpy()
    live = int(gather.row_ptr[-1])
    assert gather.pos.dtype == torch.int32 and pos.shape == (2 * e,)
    # every live side is an entry of the gather index; masked edges park
    assert live == 2 * int(mask.sum())
    np.testing.assert_array_equal(pos[eid[:live]], np.arange(live))
    slot_live = np.concatenate([mask, mask])
    np.testing.assert_array_equal(eid[pos[slot_live]], np.flatnonzero(slot_live))
    assert (pos[~slot_live] == -1).all()
    assert (pos[slot_live] < live).all()
    # the forward index carries neither field
    assert index.pos is None and index.split is None


@pytest.mark.parametrize("case", CASES)
def test_split_parts_each_row_by_side(case):
    """split[r]: the row's dst-side entries (j < E) lie before it, its
    src-side entries (j >= E) at or after it."""
    index, _src, _dst, mask, n = _index(case)
    gather = index.gather
    e = len(mask)
    row_ptr, split, eid = gather.row_ptr.numpy(), gather.split.numpy(), gather.eid.numpy()
    assert gather.split.dtype == torch.int32 and split.shape == (n,)
    for r in range(n):
        assert row_ptr[r] <= split[r] <= row_ptr[r + 1]
        assert (eid[row_ptr[r] : split[r]] < e).all()
        assert (eid[split[r] : row_ptr[r + 1]] >= e).all()
    if case == "hub":
        # 300 live edges leave row 7 from its src side
        assert row_ptr[8] - split[7] >= 300 * 0.8


def test_split_and_pos_of_a_hand_built_case():
    # edges (src -> dst): 0: 1->2, 1: 2->1, 2: masked, 3: 2->2, 4: 9->1 (src out of range)
    src = torch.tensor([1, 2, 0, 2, 9], dtype=torch.int32)
    dst = torch.tensor([2, 1, 0, 2, 1], dtype=torch.int32)
    mask = torch.tensor([True, True, False, True, True])
    gather = sparse.edge_index(src, dst, mask, 3, for_backward=True).gather
    # rows by clamped id: row 1: dst side of 1, 4; src side of 0
    #                     row 2: dst side of 0, 3; src side of 1, 3, 4 (9 clamps to 2)
    assert gather.row_ptr.tolist() == [0, 0, 3, 8]
    assert gather.eid.tolist()[:8] == [1, 4, 5, 0, 3, 6, 8, 9]
    assert gather.split.tolist() == [0, 2, 5]
    assert gather.pos.tolist() == [3, 0, -1, 4, 1, 2, 5, -1, 6, 7]


def test_contiguous_rebuild_keeps_the_gather_fields():
    """fused_sddmm_spmm rebuilds a given index contiguous: pos and split
    survive it, and non-contiguous parts come back contiguous."""
    index, *_ = _index("random")
    strided = index._replace(
        gather=index.gather._replace(
            pos=torch.stack([index.gather.pos, index.gather.pos], 1)[:, 0],
            split=torch.stack([index.gather.split, index.gather.split], 1)[:, 1],
        )
    )
    assert not strided.gather.pos.is_contiguous()
    rebuilt = sparse._contiguous(strided)
    for name in ("row_ptr", "nbr", "eid", "pos", "split"):
        want = getattr(index.gather, name)
        got = getattr(rebuilt.gather, name)
        assert got.is_contiguous() and torch.equal(got, want), name
    for name in ("row_ptr", "nbr", "eid"):
        assert torch.equal(getattr(rebuilt, name), getattr(index, name))
    assert rebuilt.pos is None and rebuilt.split is None
    assert sparse._contiguous(None) is None


@pytest.mark.parametrize(
    "broken,error",
    [
        ("no-pos", ValueError),
        ("no-split", ValueError),
        ("pos-shape", ValueError),
        ("split-shape", ValueError),
        ("pos-dtype", TypeError),
        ("split-dtype", TypeError),
    ],
)
def test_check_index_validates_the_gather_fields(broken, error):
    index, src, _dst, _mask, n = _index("random")
    e = len(src)
    sparse._check_index(index, n, e, torch.device("cpu"))  # the good one passes
    g = index.gather
    bad = {
        "no-pos": g._replace(pos=None),
        "no-split": g._replace(split=None),
        "pos-shape": g._replace(pos=g.pos[:-1]),
        "split-shape": g._replace(split=torch.cat([g.split, g.split[:1]])),
        "pos-dtype": g._replace(pos=g.pos.long()),
        "split-dtype": g._replace(split=g.split.long()),
    }[broken]
    with pytest.raises(error):
        sparse._check_index(index._replace(gather=bad), n, e, torch.device("cpu"))
    # a forward-only index needs neither
    sparse._check_index(index._replace(gather=None), n, e, torch.device("cpu"))


def _dyadic(rng, *shape):
    return torch.from_numpy((rng.integers(-8, 9, size=shape) / 8).astype(np.float32))


def _backward_inputs(case, h, seed):
    index, src, dst, mask, n = _index(case)
    rng = np.random.default_rng(seed)
    e = len(src)
    v, q, k, d_bias = (_dyadic(rng, n, h) for _ in range(4))
    gate = _dyadic(rng, e).abs() * torch.from_numpy(mask)  # masked edges gate 0
    da = _dyadic(rng, e) * torch.from_numpy(mask)
    t = torch.from_numpy
    return index, (t(src), t(dst), t(mask)), n, v, q, k, d_bias, gate, da


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_entry_ordered_row_pass_gives_grad_rows_plain_exactly(case, gated):
    """The row pass's plain version, reading the gather index and the
    entries' (gate, da) in entry order, gives grad_rows_plain's (dv, dq,
    dk) bit for bit on dyadic data."""
    index, ids, n, _v, q, k, d_bias, gate, da = _backward_inputs(case, 4, seed=len(case))
    gather = index.gather
    if gated:
        gda = sparse.entry_values_plain(gather, gate, da)
        got = sparse.grad_rows_index_plain(n, gather, d_bias, gda, q, k)
        want = sparse.grad_rows_plain(n, *ids, gate, d_bias, da, q, k)
    else:
        got = sparse.grad_rows_index_plain(n, gather, d_bias)
        want = sparse.grad_rows_plain(n, *ids, None, d_bias)
        assert got[1] is None and got[2] is None
    for name, a, w in zip(("dv", "dq", "dk"), got, want):
        if w is None:
            continue
        assert torch.equal(a, w), name


@pytest.mark.parametrize("case", CASES)
def test_entry_values_follow_pos(case):
    """entry_values_plain puts edge j mod E's (gate, da) at entry pos[j]
    for every live slot, and 0 on parked entries."""
    index, _ids, _n, _v, _q, _k, _d_bias, gate, da = _backward_inputs(case, 4, seed=3)
    gather = index.gather
    gda = sparse.entry_values_plain(gather, gate, da)
    e = gate.shape[0]
    assert gda.shape == (2 * e, 2)
    live = int(gather.row_ptr[-1])
    edge = gather.eid[:live] % max(e, 1)
    assert torch.equal(gda[:live, 0], gate[edge]) and torch.equal(gda[:live, 1], da[edge])
    assert not gda[live:].any()


@pytest.mark.parametrize("h", [4, 5, 18, 132])
def test_cpu_wrappers_take_the_plain_versions(h):
    """On CPU tensors the backward's wrappers run the plain versions and
    launch nothing: the SDDMM alone, the row pass alone over its output,
    and the whole backward for each subset of wanted grads."""
    index, ids, n, v, q, k, d_bias, gate, _da = _backward_inputs("out-of-range", h, seed=h)
    rng = np.random.default_rng(h + 1)
    d_deg, d_gate = _dyadic(rng, n), _dyadic(rng, gate.shape[0])
    counters = (
        sparse.fused_backward,
        sparse.fused_sddmm_spmm_grad_edges,
        sparse.fused_sddmm_spmm_grad_rows,
    )
    before = [c.launches for c in counters]
    da, gda = sparse.fused_sddmm_spmm_grad_edges(v, *ids, gate, d_bias, d_deg, d_gate, index=index)
    torch.testing.assert_close(da, sparse.grad_edges_plain(v, *ids, gate, d_bias, d_deg, d_gate))
    assert torch.equal(gda, sparse.entry_values_plain(index.gather, gate, da))
    rows = sparse.fused_sddmm_spmm_grad_rows(n, d_bias, gda, q, k, index=index)
    want_rows = sparse.grad_rows_plain(n, *ids, gate, d_bias, da, q, k)
    for a, w in zip(rows, want_rows):
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-5)
    want = sparse.fused_backward_plain(v, *ids, gate, d_bias, d_deg, d_gate, q, k)
    subsets = [(True, True, True, True), (True, False, False, False), (False, False, False, True)]
    for needs in subsets:
        got = sparse.fused_backward(v, *ids, gate, d_bias, d_deg, d_gate, q, k, index, needs)
        for need, a, w in zip(needs, got, want):
            assert (a is None) == (not need)
            if need:
                torch.testing.assert_close(a, w)
    assert sparse.fused_backward(v, *ids, gate, d_bias, needs=(False,) * 4) == (None,) * 4
    assert [c.launches for c in counters] == before


def test_backward_wrappers_need_the_gather_index():
    index, ids, n, v, q, k, d_bias, gate, _da = _backward_inputs("random", 4, seed=9)
    forward_only = sparse.edge_index(*ids, n)
    with pytest.raises(ValueError, match="gather"):
        sparse.fused_sddmm_spmm_grad_edges(v, *ids, gate, d_bias, index=forward_only)
    with pytest.raises(ValueError, match="gather"):
        sparse.fused_sddmm_spmm_grad_rows(n, d_bias, index=None)

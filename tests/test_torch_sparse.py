"""The fused SDDMM/SpMM (kmamiz_tpu_torch.ops.sparse) on the CPU against
the JAX package: its fused Pallas kernels in interpret mode, and the XLA
gather/segment-sum formulas of graphsage.neighbor_mean and
stlgt/model.encode that it runs by default.

Tolerances are tests/test_ops_sparse.py's: gate and degree rtol/atol
1e-5, bias rtol 1e-4 / atol 1e-5 (float sums in other orders).

Id rule: for a live edge whose id is >= N the XLA formulas clamp the
gather to N-1 and drop the scatter, while the fused Pallas kernel clips the
id to N-1 and scatters there. The port follows the XLA formulas.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmamiz_tpu.ops import sparse as jax_sparse
from kmamiz_tpu_torch.ops import sparse

SENTINEL = np.iinfo(np.int32).max


def _graph(seed, n, e, h, out_of_range=0):
    """Node tables and an edge list: ~20% masked-off edges, the last
    eighth padding (mask off, sentinel ids), and `out_of_range` live edges
    whose src or dst is >= n."""
    rng = np.random.default_rng(seed)
    tables = [rng.normal(size=(n, h)).astype(np.float32) for _ in range(3)]
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    mask = rng.random(e) < 0.8
    pad = e // 8
    src[-pad:] = SENTINEL
    dst[-pad:] = SENTINEL
    mask[-pad:] = False
    for i in range(out_of_range):
        mask[i] = True
        if i % 2:
            src[i] = n + i
        else:
            dst[i] = n
    return tables, src, dst, mask


def _xla(v, src, dst, mask, q=None, k=None, b=None):
    """The JAX package's XLA formulation (stlgt/model.encode's else-branch
    and graphsage.neighbor_mean's sums), verbatim."""
    v, src, dst, mask = map(jnp.asarray, (v, src, dst, mask))
    n = v.shape[0]
    em = mask.astype(jnp.float32)
    src_c = jnp.minimum(src, n - 1)
    dst_c = jnp.minimum(dst, n - 1)
    if q is None:
        gate = em
    else:
        q, k = jnp.asarray(q), jnp.asarray(k)
        affinity = (q[src_c] * k[dst_c]).sum(axis=1) / jnp.sqrt(jnp.float32(v.shape[1]))
        gate = jax.nn.sigmoid(affinity + jnp.float32(b)) * em
    src_s = jnp.where(mask, src, n)
    dst_s = jnp.where(mask, dst, n)
    bias = jax.ops.segment_sum(v[src_c] * gate[:, None], dst_s, num_segments=n + 1)[:-1]
    bias = bias + jax.ops.segment_sum(v[dst_c] * gate[:, None], src_s, num_segments=n + 1)[:-1]
    deg = jax.ops.segment_sum(gate, dst_s, num_segments=n + 1)[:-1]
    deg = deg + jax.ops.segment_sum(gate, src_s, num_segments=n + 1)[:-1]
    return np.asarray(bias), np.asarray(deg), np.asarray(gate)


def _port(v, src, dst, mask, q=None, k=None, b=None):
    t = torch.from_numpy
    if q is None:
        agg, deg = sparse.fused_neighbor_sums(t(v), t(src), t(dst), t(mask))
        return agg.numpy(), deg.numpy(), None
    bias, deg, gate = sparse.fused_gated_bias(
        t(q), t(k), t(v), torch.tensor([b], dtype=torch.float32), t(src), t(dst), t(mask)
    )
    return bias.numpy(), deg.numpy(), gate.numpy()


def _assert_close(got, want, gated):
    bias, deg, gate = got
    w_bias, w_deg, w_gate = want
    if gated:
        np.testing.assert_allclose(gate, w_gate, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bias, w_bias, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(deg, w_deg, rtol=1e-5, atol=1e-5)


SHAPES = [(40, 300, 18), (256, 2048, 32), (128, 1024, 64)]


@pytest.mark.parametrize("n,e,h", SHAPES)
def test_ungated_matches_pallas_interpret(n, e, h):
    (v, _, _), src, dst, mask = _graph(n + h, n, e, h)
    agg, deg = jax_sparse.fused_neighbor_sums(
        jnp.asarray(v), jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask),
        tile=256, interpret=True,
    )
    _assert_close(_port(v, src, dst, mask), (np.asarray(agg), np.asarray(deg), None), False)


@pytest.mark.parametrize("n,e,h", SHAPES)
def test_gated_matches_pallas_interpret(n, e, h):
    (v, q, k), src, dst, mask = _graph(n * h, n, e, h)
    bias, deg, gate = jax_sparse.fused_gated_bias(
        *map(jnp.asarray, (q, k, v)), jnp.float32(0.3),
        *map(jnp.asarray, (src, dst, mask)), tile=256, interpret=True,
    )
    got = _port(v, src, dst, mask, q, k, 0.3)
    _assert_close(got, tuple(map(np.asarray, (bias, deg, gate))), True)
    assert np.all(got[2][~mask] == 0.0)


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("n,e,h", SHAPES)
def test_matches_xla_formulas_with_out_of_range_ids(gated, n, e, h):
    (v, q, k), src, dst, mask = _graph(7 * n + h, n, e, h, out_of_range=6)
    args = (q, k, -0.2) if gated else ()
    _assert_close(_port(v, src, dst, mask, *args), _xla(v, src, dst, mask, *args), gated)


def test_out_of_range_rule_follows_xla_not_the_pallas_clip():
    """A live edge 0 -> n: the XLA formulas gather row n-1 into row 0 and
    drop the scatter into row n; the Pallas kernel also adds row 0 into
    row n-1. The port does what the XLA formulas do."""
    n, h = 8, 18
    rng = np.random.default_rng(5)
    v = rng.normal(size=(n, h)).astype(np.float32)
    src = np.array([0, 1], dtype=np.int32)
    dst = np.array([n, 2], dtype=np.int32)
    mask = np.array([True, True])
    got_agg, got_deg, _ = _port(v, src, dst, mask)
    want_agg, want_deg, _ = _xla(v, src, dst, mask)
    np.testing.assert_allclose(got_agg, want_agg, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got_deg, want_deg)
    np.testing.assert_array_equal(got_deg, [1, 1, 1, 0, 0, 0, 0, 0])
    np.testing.assert_array_equal(got_agg[0], v[n - 1])
    np.testing.assert_array_equal(got_agg[n - 1], 0.0)
    pallas_agg, pallas_deg = jax_sparse.fused_neighbor_sums(
        *map(jnp.asarray, (v, src, dst, mask)), tile=8, interpret=True
    )
    assert float(np.asarray(pallas_deg)[n - 1]) == 1.0  # the clip the port avoids
    np.testing.assert_allclose(np.asarray(pallas_agg)[n - 1], v[0], rtol=1e-6)


def test_plain_version_and_cpu_route_launch_nothing():
    (v, q, k), src, dst, mask = _graph(3, 32, 200, 32)
    t = torch.from_numpy
    before = sparse.fused_sddmm_spmm.launches
    routed = sparse.fused_sddmm_spmm(
        t(v), t(src), t(dst), t(mask), t(q), t(k), torch.tensor([0.1])
    )
    plain = sparse.fused_plain(t(v), t(src), t(dst), t(mask), t(q), t(k), torch.tensor([0.1]))
    for a, b in zip(routed, plain):
        assert torch.equal(a, b)
    assert sparse.fused_sddmm_spmm.launches == before
    _, _, gate = sparse.fused_sddmm_spmm(t(v), t(src), t(dst), t(mask), want_gate=False)
    assert gate is None


def test_wrapper_rejects_what_the_kernel_does_not_take():
    v = torch.zeros((4, 3))
    ids = torch.zeros(5, dtype=torch.int32)
    mask = torch.ones(5, dtype=torch.bool)
    with pytest.raises(TypeError):
        sparse.fused_sddmm_spmm(v, ids.long(), ids, mask)
    with pytest.raises(TypeError):
        sparse.fused_sddmm_spmm(v, ids, ids, mask.int())
    with pytest.raises(ValueError):
        sparse.fused_sddmm_spmm(v, ids, ids[:4], mask)
    with pytest.raises(ValueError, match="together"):
        sparse.fused_sddmm_spmm(v, ids, ids, mask, q=v)
    with pytest.raises(ValueError):
        sparse.fused_sddmm_spmm(v, ids, ids, mask, q=v, k=v[:2], b_edge=torch.zeros(1))
    with pytest.raises(ValueError, match="empty"):
        sparse.fused_sddmm_spmm(torch.zeros((0, 3)), ids, ids, mask)
    with pytest.raises(ValueError, match="device"):
        sparse.fused_sddmm_spmm(v, ids, ids, mask.to("meta"))


def _index_reference(src, dst, mask, n):
    """edge_index by hand: row r lists (other end, j) for j in order,
    j < E the dst side of edge j and j >= E the src side of edge j - E; a
    masked edge or an end outside [0, n) lists nothing."""
    e = len(src)
    rows = [[] for _ in range(n)]
    for j in range(2 * e):
        edge = j % e
        row, other = (dst[edge], src[edge]) if j < e else (src[edge], dst[edge])
        if mask[edge] and 0 <= row < n:
            rows[row].append((int(other), j))
    row_ptr = np.cumsum([0] + [len(r) for r in rows])
    nbr = np.array([x for r in rows for x, _ in r], dtype=np.int64)
    eid = np.array([j for r in rows for _, j in r], dtype=np.int64)
    return row_ptr, nbr, eid


def _index_case(case):
    """(src, dst, mask, n) of one edge_index case."""
    rng = np.random.default_rng(11)
    if case == "n1":
        src = np.array([0, 0, 1, -1, 0], dtype=np.int32)
        dst = np.array([0, 3, 0, 0, 0], dtype=np.int32)
        return src, dst, np.array([True, True, True, True, False]), 1
    if case == "no-edges":
        empty = np.zeros(0, dtype=np.int32)
        return empty, empty, np.zeros(0, dtype=bool), 5
    n, e = 64, 400
    src = rng.integers(0, n // 2, e).astype(np.int32)  # rows n/2.. stay empty
    dst = rng.integers(0, n // 2, e).astype(np.int32)
    mask = rng.random(e) < 0.7
    src[-50:] = SENTINEL  # padding
    dst[-50:] = SENTINEL
    mask[-50:] = False
    src[:4] = [-3, n, 5, 7]  # live edges with one end out of range
    dst[:4] = [9, 9, n + 8, -1]
    mask[:4] = True
    src[10:16] = 3  # one (src, dst) pair in six slots, e.g. at six distances
    dst[10:16] = 4
    mask[10:16] = True
    src[16], dst[16], mask[16] = 6, 6, True  # a self loop
    return src, dst, mask, n


@pytest.mark.parametrize("case", ["random", "n1", "no-edges"])
def test_edge_index_matches_a_hand_built_csr(case):
    src, dst, mask, n = _index_case(case)
    index = sparse.edge_index(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(mask), n)
    row_ptr, nbr, eid = _index_reference(src, dst, mask, n)
    assert index.row_ptr.dtype == index.nbr.dtype == torch.int32
    assert index.eid.dtype == torch.int64
    assert index.nbr.shape == index.eid.shape == (2 * len(src),)
    np.testing.assert_array_equal(index.row_ptr.numpy(), row_ptr)
    live = int(row_ptr[-1])
    np.testing.assert_array_equal(index.nbr.numpy()[:live], nbr)
    np.testing.assert_array_equal(index.eid.numpy()[:live], eid)
    # the parked entries are the rest of the 2E: eid is a permutation
    np.testing.assert_array_equal(np.sort(index.eid.numpy()), np.arange(2 * len(src)))
    if case == "random":
        assert (np.diff(row_ptr)[32:] == 0).all()  # empty rows
        e = len(src)  # every slot of the duplicated pair 3 -> 4, both sides
        assert set(range(10, 16)) <= set(eid[row_ptr[4] : row_ptr[5]])
        assert set(range(e + 10, e + 16)) <= set(eid[row_ptr[3] : row_ptr[4]])


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("n,e,h", SHAPES)
def test_plain_sums_rebuild_from_the_index(gated, n, e, h):
    """fused_plain's bias and deg are the per-row sums over the index's
    entries: g(j) * v[nbr clamped into [0, n)] and g(j), g the gate of edge
    j mod E."""
    (v, q, k), src, dst, mask = _graph(3 * n + h, n, e, h, out_of_range=5)
    t = torch.from_numpy
    extra = (t(q), t(k), torch.tensor([0.4])) if gated else ()
    bias, deg, gate = sparse.fused_plain(t(v), t(src), t(dst), t(mask), *extra)
    index = sparse.edge_index(t(src), t(dst), t(mask), n)
    row_ptr, nbr, eid = (a.numpy().astype(np.int64) for a in (index.row_ptr, index.nbr, index.eid))
    nbr = nbr.clip(0, n - 1)
    g = gate.numpy()[eid % e]
    want_bias = np.zeros((n, h), dtype=np.float64)
    want_deg = np.zeros(n, dtype=np.float64)
    for r in range(n):
        p = slice(row_ptr[r], row_ptr[r + 1])
        want_bias[r] = (g[p, None] * v[nbr[p]]).sum(axis=0)
        want_deg[r] = g[p].sum()
    np.testing.assert_allclose(bias.numpy(), want_bias, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(deg.numpy(), want_deg, rtol=1e-5, atol=1e-5)


def test_index_of_a_bucket_padded_snapshot():
    """edge_index over the forward's bucket-padded inputs (models/serving's
    padded_inputs): the padding rows past the real endpoints and the
    padding edge slots list nothing, and each row's length is the node's
    ungated degree (graphsage.neighbor_degree), exactly."""
    from kmamiz_tpu_torch.models import graphsage, serving

    rng = np.random.default_rng(12)
    n, e = 150, 1200
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    mask = rng.random(e) < 0.9
    feats, src_p, dst_p, mask_p, _n, _e = serving.padded_inputs(
        np.ones((n, 18), dtype=np.float32), src, dst, mask, torch.device("cpu")
    )
    n_pad = feats.shape[0]
    assert (n_pad, src_p.shape[0]) == (256, 2048)
    index = sparse.edge_index(src_p, dst_p, mask_p, n_pad)
    lengths = (index.row_ptr[1:] - index.row_ptr[:-1]).numpy()
    assert int(index.row_ptr[-1]) == 2 * int(mask.sum())
    assert (lengths[n:] == 0).all()
    assert (index.eid[: int(index.row_ptr[-1])] % src_p.shape[0] < e).all()
    deg = graphsage.neighbor_degree(n_pad, src_p, dst_p, mask_p)
    np.testing.assert_array_equal(lengths.astype(np.float32), deg.numpy())


# -- the backward --------------------------------------------------------------
#
# fused_backward_plain against autograd of fused_plain (float64: the same
# VJP, rtol 1e-10) and against jax.vjp of the JAX package's XLA formulas
# (float32: rtol 1e-4 / atol 1e-5, the bias tolerance above), gated and
# ungated, with masked edges, padding and live edges whose ids lie out of
# range.


def _upstream(seed, n, e, h):
    rng = np.random.default_rng(seed)
    return (
        rng.normal(size=(n, h)).astype(np.float32),
        rng.normal(size=n).astype(np.float32),
        rng.normal(size=e).astype(np.float32),
    )


def _xla_vjp(v, src, dst, mask, q, k, b, d_bias, d_deg, d_gate):
    """jax.vjp of the XLA formulas (_xla's arithmetic) at (v[, q, k, b])."""
    src, dst, mask = map(jnp.asarray, (src, dst, mask))
    n, h = v.shape

    def f(v, q=None, k=None, b=None):
        em = mask.astype(jnp.float32)
        src_c, dst_c = jnp.minimum(src, n - 1), jnp.minimum(dst, n - 1)
        if q is None:
            gate = em
        else:
            aff = (q[src_c] * k[dst_c]).sum(axis=1) / jnp.sqrt(jnp.float32(h))
            gate = jax.nn.sigmoid(aff + b) * em
        src_s, dst_s = jnp.where(mask, src, n), jnp.where(mask, dst, n)
        bias = jax.ops.segment_sum(v[src_c] * gate[:, None], dst_s, num_segments=n + 1)[:-1]
        bias = bias + jax.ops.segment_sum(v[dst_c] * gate[:, None], src_s, num_segments=n + 1)[:-1]
        deg = jax.ops.segment_sum(gate, dst_s, num_segments=n + 1)[:-1]
        deg = deg + jax.ops.segment_sum(gate, src_s, num_segments=n + 1)[:-1]
        return bias, deg, gate

    args = (jnp.asarray(v),) if q is None else tuple(map(jnp.asarray, (v, q, k, np.float32(b))))
    _, vjp = jax.vjp(f, *args)
    cot = (jnp.asarray(d_bias), jnp.asarray(d_deg), jnp.asarray(d_gate))
    return [np.asarray(g) for g in vjp(cot)]


# the forward's shapes, then an odd H (the kernels' scalar-load path) and
# H > 128 (more columns than a warp's lanes hold in one vector each)
BACKWARD_SHAPES = SHAPES + [(40, 300, 5), (24, 200, 7), (32, 256, 132)]


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("n,e,h", BACKWARD_SHAPES)
def test_backward_plain_matches_jax_vjp(gated, n, e, h):
    (v, q, k), src, dst, mask = _graph(5 * n + h, n, e, h, out_of_range=6)
    d_bias, d_deg, d_gate = _upstream(n + e, n, e, h)
    b = 0.3
    t = torch.from_numpy
    if gated:
        _, _, gate = sparse.fused_plain(t(v), t(src), t(dst), t(mask), t(q), t(k), torch.tensor([b]))
        got = sparse.fused_backward_plain(
            t(v), t(src), t(dst), t(mask), gate, t(d_bias), t(d_deg), t(d_gate), t(q), t(k)
        )
        want = _xla_vjp(v, src, dst, mask, q, k, b, d_bias, d_deg, d_gate)
        for name, a, w in zip(("dv", "dq", "dk", "db"), got, want):
            np.testing.assert_allclose(a.numpy(), w, rtol=1e-4, atol=1e-5, err_msg=name)
    else:
        gate = t(mask).to(torch.float32)
        dv, dq, dk, db = sparse.fused_backward_plain(t(v), t(src), t(dst), t(mask), gate, t(d_bias))
        assert dq is None and dk is None and db is None
        [want] = _xla_vjp(v, src, dst, mask, None, None, None, d_bias, d_deg, d_gate)
        np.testing.assert_allclose(dv.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("gated", [False, True])
def test_backward_plain_is_autograd_of_fused_plain(gated):
    n, e, h = 24, 160, 6
    (v, q, k), src, dst, mask = _graph(77, n, e, h, out_of_range=8)
    d_bias, d_deg, d_gate = (torch.from_numpy(a).double() for a in _upstream(5, n, e, h))
    ids = [torch.from_numpy(a) for a in (src, dst, mask)]
    leaves = [torch.from_numpy(v).double().requires_grad_()]
    if gated:
        leaves += [torch.from_numpy(a).double().requires_grad_() for a in (q, k)]
        leaves.append(torch.tensor([0.2], dtype=torch.float64, requires_grad=True))
    bias, deg, gate = sparse.fused_plain(leaves[0], *ids, *leaves[1:])
    want = torch.autograd.grad(
        (bias, deg, gate) if gated else (bias,),
        leaves,
        (d_bias, d_deg, d_gate) if gated else (d_bias,),
    )
    got = sparse.fused_backward_plain(
        leaves[0].detach(), *ids, gate.detach(), d_bias, d_deg if gated else None,
        d_gate if gated else None, *(x.detach() for x in leaves[1:3]),
    )
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.reshape(w.shape).numpy(), w.numpy(), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("gated", [False, True])
def test_gradcheck_of_the_cpu_route(gated):
    """The autograd Function's CPU route (fused_plain forward,
    fused_backward_plain backward) in float64 at N = 12, with masked edges
    and live out-of-range ids."""
    n, e, h = 12, 40, 4
    (v, q, k), src, dst, mask = _graph(3, n, e, h, out_of_range=4)
    ids = [torch.from_numpy(a) for a in (src, dst, mask)]
    v = torch.from_numpy(v).double().requires_grad_()
    if not gated:
        assert torch.autograd.gradcheck(
            lambda v: sparse.fused_neighbor_sums(v, *ids)[0], (v,)
        )
        return
    q, k = (torch.from_numpy(a).double().requires_grad_() for a in (q, k))
    b = torch.tensor([0.1], dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda v, q, k, b: sparse.fused_gated_bias(q, k, v, b, *ids), (v, q, k, b)
    )


def test_backward_respects_what_wants_a_grad():
    n, e, h = 16, 64, 4
    (v, q, k), src, dst, mask = _graph(8, n, e, h)
    t = torch.from_numpy
    ids = [t(src), t(dst), t(mask)]
    q_leaf = t(q).requires_grad_()
    bias, deg, gate = sparse.fused_gated_bias(q_leaf, t(k), t(v), torch.tensor([0.0]), *ids)
    (dq,) = torch.autograd.grad(bias.sum() + gate.sum(), (q_leaf,))
    assert dq.shape == (n, h) and bool(dq.abs().sum() > 0)
    # ungated: deg and the gate are constants of the edge list
    v_leaf = t(v).requires_grad_()
    agg, deg = sparse.fused_neighbor_sums(v_leaf, *ids)
    assert agg.requires_grad and not deg.requires_grad


def _gather_rows_reference(index, n, e, g, da, d_bias, q, k, h):
    """The backward's row pass (csrc kernel 4) by hand over the gather
    index: dv[r] sums g * d_bias[nbr] over entries whose other end lies in
    [0, n); dq[r] sums da * k[clamp(nbr)] over the row's src-side entries
    (j >= E), dk[r] da * q[clamp(nbr)] over its dst-side entries."""
    row_ptr, nbr, eid = (a.numpy().astype(np.int64) for a in (index.row_ptr, index.nbr, index.eid))
    dv, dq, dk = (np.zeros((n, h)) for _ in range(3))
    for r in range(n):
        for p in range(row_ptr[r], row_ptr[r + 1]):
            j, other = eid[p], nbr[p]
            edge = j % e
            if 0 <= other < n:
                dv[r] += g[edge] * d_bias[other]
            row = np.clip(other, 0, n - 1)
            if j >= e:
                dq[r] += da[edge] * k[row] / np.sqrt(h)
            else:
                dk[r] += da[edge] * q[row] / np.sqrt(h)
    return dv, dq, dk


def test_gather_index_rebuilds_the_plain_grads():
    """The card's backward reads the gather index (edge_index(...,
    for_backward=True)): each live side by its clamped id. Its row sums,
    done by hand as the kernel does them, give fused_backward_plain's
    grads, with live out-of-range ids (the case where the gather index
    and the forward index differ)."""
    n, e, h = 40, 300, 6
    (v, q, k), src, dst, mask = _graph(21, n, e, h, out_of_range=9)
    d_bias, d_deg, d_gate = _upstream(9, n, e, h)
    t = torch.from_numpy
    ids = (t(src), t(dst), t(mask))
    index = sparse.edge_index(*ids, n, for_backward=True)
    gather = index.gather
    assert not torch.equal(gather.row_ptr, index.row_ptr)  # out-of-range ids move entries
    # every live side is listed once, by its clamped row
    assert int(gather.row_ptr[-1]) == 2 * int(mask.sum())
    _, _, gate = sparse.fused_plain(t(v), *ids, t(q), t(k), torch.tensor([0.3]))
    dv, dq, dk, _db = sparse.fused_backward_plain(
        t(v), *ids, gate, t(d_bias), t(d_deg), t(d_gate), t(q), t(k)
    )
    # da as the card's edge kernel writes it, from the plain formulas
    src_c, dst_c = np.clip(src, 0, n - 1), np.clip(dst, 0, n - 1)
    to_dst = mask & (dst >= 0) & (dst < n)
    to_src = mask & (src >= 0) & (src < n)
    dg = (
        to_dst * ((d_bias[dst_c] * v[src_c]).sum(1) + d_deg[dst_c])
        + to_src * ((d_bias[src_c] * v[dst_c]).sum(1) + d_deg[src_c])
        + d_gate
    )
    g = gate.numpy()
    da = dg * g * (1 - g)
    want = _gather_rows_reference(gather, n, e, g, da, d_bias, q, k, h)
    for name, a, w in zip(("dv", "dq", "dk"), (dv, dq, dk), want):
        np.testing.assert_allclose(a.numpy(), w, rtol=1e-4, atol=1e-5, err_msg=name)


def test_gather_index_equals_the_forward_index_when_ids_are_in_range():
    (_, _, _), src, dst, mask = _graph(4, 64, 500, 4)
    t = torch.from_numpy
    index = sparse.edge_index(t(src), t(dst), t(mask), 64, for_backward=True)
    for a, b in zip(index[:3], index.gather[:3]):
        assert torch.equal(a, b)
    assert sparse.edge_index(t(src), t(dst), t(mask), 64).gather is None

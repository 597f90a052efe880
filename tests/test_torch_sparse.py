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
    row_ptr, nbr, eid = (a.numpy().astype(np.int64) for a in index)
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

"""The port's scorer ops against kmamiz_tpu.ops.scorers on the same seeded
inputs: both service-score pipelines (the sparse one at dist_bits 3 through
its partition path and its payload fallback, at dist_bits 4 through the
per-distance fallback, and the legacy lexsort one), the dispatcher's
choice, usage cohesion, risk, the incremental recompute's subset and
splice, and the counting primitives of ops/sparse.py.

Tolerances: integer lanes (instability_on/_by, ais, ads, acs, is_gateway,
total_endpoints, pair tables, kept counts) and instability are equal;
relying_factor, risk and norm_risk agree within rel 1e-5; usage_cohesion
within rel 1e-6.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmamiz_tpu.ops import scorers as jax_scorers
from kmamiz_tpu.ops import sparse as jax_sparse
from kmamiz_tpu_torch.ops import scorers
from kmamiz_tpu_torch.ops import sparse
from kmamiz_tpu_torch.ops.sortutil import SENTINEL

FLOAT_RTOL = {"relying_factor": 1e-5, "usage_cohesion": 1e-6, "risk": 1e-5, "norm_risk": 1e-5}


def make_edges(
    seed,
    n_ep=64,
    n_svc=16,
    cap=512,
    n_live=300,
    dist_lo=1,
    dist_hi=8,
    n_ml=20,
    record_p=0.8,
    masked_p=0.0,
    out_of_range=0,
):
    """Seeded flat edge columns at capacity `cap` (live rows first, the
    rest SENTINEL), per-endpoint tables, and a mask. `masked_p` drops live
    rows from the mask; `out_of_range` live rows get ids past the
    endpoint table (or negative)."""
    rng = np.random.default_rng(seed)
    src = np.full(cap, SENTINEL, np.int32)
    dst = np.full(cap, SENTINEL, np.int32)
    dist = np.full(cap, SENTINEL, np.int32)
    src[:n_live] = rng.integers(0, n_ep, n_live)
    dst[:n_live] = rng.integers(0, n_ep, n_live)
    dist[:n_live] = rng.integers(dist_lo, dist_hi, n_live)
    if out_of_range:
        rows = rng.choice(n_live, out_of_range, replace=False)
        src[rows[::2]] = rng.integers(n_ep, 4 * n_ep, len(rows[::2]))
        dst[rows[1::2]] = -rng.integers(1, 5, len(rows[1::2]))
    mask = src != SENTINEL
    mask &= rng.random(cap) >= masked_p
    ep_service = rng.integers(0, n_svc, n_ep).astype(np.int32)
    ep_ml = rng.integers(0, n_ml, n_ep).astype(np.int32)
    ep_record = rng.random(n_ep) < record_p
    return src, dst, dist, mask, ep_service, ep_ml, ep_record


def to_jax(arrays):
    return [jnp.asarray(a) for a in arrays]


def to_torch(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def assert_lanes(got, want, fields=None):
    for name, g, w in zip(want._fields, got, want):
        if fields is not None and name not in fields:
            continue
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype, name
        if name in FLOAT_RTOL:
            np.testing.assert_allclose(g, w, rtol=FLOAT_RTOL[name], atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


# (label, make_edges kwargs, num_services, dist_bits): the sparse pipeline
# at dist_bits 3 (partition path) and 4 (per-distance fallback), the
# legacy one; sentinel padding in every case
SCORE_CASES = [
    ("sparse d3", dict(seed=0), 16, 3),
    ("sparse d3 dense", dict(seed=1, cap=1024, n_live=1024), 16, 3),
    ("sparse d4", dict(seed=2, dist_hi=16), 16, 4),
    ("legacy", dict(seed=3), 16, None),
    ("legacy d4 data", dict(seed=4, dist_hi=16), 16, None),
    ("masked rows", dict(seed=5, masked_p=0.3), 16, 3),
    ("masked rows legacy", dict(seed=5, masked_p=0.3), 16, None),
    ("out-of-range ids", dict(seed=6, out_of_range=40), 16, 3),
    ("out-of-range ids legacy", dict(seed=6, out_of_range=40), 16, None),
    ("recordless endpoints", dict(seed=7, record_p=0.3), 16, 3),
    ("recordless endpoints legacy", dict(seed=7, record_p=0.3), 16, None),
    ("distance-0 rows", dict(seed=8, dist_lo=0, dist_hi=3), 16, 3),
    ("distance-0 rows legacy", dict(seed=8, dist_lo=0, dist_hi=3), 16, None),
    ("deep distances", dict(seed=9, dist_hi=70), 16, None),
    ("many tied keys", dict(seed=10, n_ep=6, n_svc=3, n_ml=2, n_live=500, dist_hi=4), 4, 3),
    ("many tied keys d4", dict(seed=11, n_ep=6, n_svc=3, n_ml=2, n_live=500, dist_hi=12), 4, 4),
    ("many tied keys legacy", dict(seed=10, n_ep=6, n_svc=3, n_ml=2, n_live=500, dist_hi=4), 4, None),
    ("services past the table", dict(seed=12, n_svc=40), 32, 3),
    ("empty", dict(seed=13, n_live=0), 8, 3),
]


@pytest.mark.parametrize("label,kw,num_services,dist_bits", SCORE_CASES, ids=[c[0] for c in SCORE_CASES])
def test_service_scores_match_jax(label, kw, num_services, dist_bits):
    arrays = make_edges(**kw)
    want = jax_scorers.service_scores(*to_jax(arrays), num_services=num_services, dist_bits=dist_bits)
    got = scorers.service_scores(*to_torch(arrays), num_services=num_services, dist_bits=dist_bits)
    assert_lanes(got, want)
    if dist_bits is not None:
        # the sparse pipeline's relying factor is integer counts scaled by
        # constant reciprocals, as XLA compiles them: the same bits
        np.testing.assert_array_equal(got.relying_factor.numpy(), np.asarray(want.relying_factor))


@pytest.mark.parametrize("label,kw,num_services,dist_bits", SCORE_CASES, ids=[c[0] for c in SCORE_CASES])
def test_usage_cohesion_matches_jax(label, kw, num_services, dist_bits):
    src, dst, dist, mask, ep_service, _ml, ep_record = make_edges(**kw)
    arrays = (src, dst, dist, mask, ep_service, ep_record)
    want = jax_scorers.usage_cohesion(*to_jax(arrays), num_services=num_services)
    got = scorers.usage_cohesion(*to_torch(arrays), num_services=num_services)
    assert_lanes(got, want)


def test_payload_fallback_at_dist_bits_3_matches_jax():
    """Where the partition key does not fit (2*S*n_ep >= SENTINEL) the
    sparse pipeline sorts dist as a payload and weighs by 420/d; the
    gates admit S = 32767 over 65,536 endpoints."""
    S, n_ep = 32767, 1 << 16
    assert scorers._sparse_scorer_ok(S, n_ep, 512, 3)
    assert not 2 * S * n_ep < SENTINEL
    src, dst, dist, mask, _s, ep_ml, ep_record = make_edges(20, n_ep=n_ep, n_svc=S)
    rng = np.random.default_rng(20)
    # few services own most endpoints, so owners repeat
    ep_service = rng.integers(0, 40, n_ep).astype(np.int32)
    ep_service[:5] = S - 1 - np.arange(5)
    arrays = (src, dst, dist, mask, ep_service, ep_ml, ep_record)
    want = jax_scorers.service_scores(*to_jax(arrays), num_services=S, dist_bits=3)
    got = scorers.service_scores(*to_torch(arrays), num_services=S, dist_bits=3)
    assert_lanes(got, want)


@pytest.mark.parametrize("seed", range(4))
def test_payload_order_does_not_change_the_result(seed):
    """Many equal keys whose dist payload lands in arbitrary order: any
    permutation of the edge rows gives the same bits, and the JAX lanes."""
    kw = dict(seed=30 + seed, n_ep=8, n_svc=3, n_ml=2, n_live=400, dist_hi=12)
    src, dst, dist, mask, ep_service, ep_ml, ep_record = make_edges(**kw)
    want = jax_scorers.service_scores(
        *to_jax((src, dst, dist, mask, ep_service, ep_ml, ep_record)), num_services=4, dist_bits=4
    )
    base = None
    for perm_seed in range(3):
        perm = np.random.default_rng(perm_seed).permutation(src.shape[0])
        arrays = (src[perm], dst[perm], dist[perm], mask[perm], ep_service, ep_ml, ep_record)
        got = scorers.service_scores(*to_torch(arrays), num_services=4, dist_bits=4)
        assert_lanes(got, want)
        if base is None:
            base = got
        for name, g, b in zip(got._fields, got, base):
            assert torch.equal(g, b), name


# (num_services, n_ep, cap, dist_bits) around every packing gate
GATE_CASES = [
    (16, 64, 512, None),
    (16, 64, 512, 0),
    (16, 64, 512, 3),
    (16, 64, 512, 4),
    (16, 64, 512, 6),
    (16, 64, 512, 7),
    (32767, 1 << 16, 512, 3),
    (32768, 64, 512, 3),
    (1 << 12, 1 << 20, 512, 3),
    (1024, 16384, 1 << 28, 3),
    (1024, 16384, (1 << 28) - 1, 3),
    (1024, 16384, 1 << 26, 5),
]


@pytest.mark.parametrize("num_services,n_ep,cap,dist_bits", GATE_CASES)
def test_dispatcher_takes_the_reference_pipeline(num_services, n_ep, cap, dist_bits, monkeypatch):
    if dist_bits is not None:
        assert scorers._sparse_scorer_ok(num_services, n_ep, cap, dist_bits) == (
            jax_scorers._sparse_scorer_ok(num_services, n_ep, cap, dist_bits)
        )
    if cap > 4096 or n_ep > 1 << 16 or num_services > 1 << 15:
        return  # the gate alone: too large to run here
    assert jax_sparse.use_sparse()  # the JAX package's default backend
    picked = {}

    def spy(pkg, name):
        def record(*a, **k):
            picked[pkg] = name
        return record

    for pkg, mod in (("jax", jax_scorers), ("port", scorers)):
        monkeypatch.setattr(mod, "service_scores_sparse", spy(pkg, "sparse"))
        monkeypatch.setattr(mod, "service_scores_xla", spy(pkg, "legacy"))
    src, dst, dist, mask, _s, ep_ml, ep_record = make_edges(0, n_ep=n_ep, cap=cap, n_live=min(cap, 200))
    ep_service = np.random.default_rng(1).integers(0, num_services, n_ep).astype(np.int32)
    arrays = (src, dst, dist, mask, ep_service, ep_ml, ep_record)
    jax_scorers.service_scores(*to_jax(arrays), num_services=num_services, dist_bits=dist_bits)
    scorers.service_scores(*to_torch(arrays), num_services=num_services, dist_bits=dist_bits)
    assert picked["port"] == picked["jax"]


RISK_CASES = [
    ("random", 0, 32, 0.7),
    ("all active", 1, 16, 1.0),
    ("one active", 2, 16, 0.0),
    ("none active", 3, 8, -1.0),
    ("degenerate equal risks", 4, 8, 1.0),
]


@pytest.mark.parametrize("label,seed,n,active_p", RISK_CASES, ids=[c[0] for c in RISK_CASES])
def test_risk_scores_match_jax(label, seed, n, active_p):
    rng = np.random.default_rng(seed)
    rf = rng.gamma(2.0, 1.0, n).astype(np.float32)
    acs = rng.integers(0, 9, n).astype(np.float32)
    replicas = rng.integers(1, 4, n).astype(np.float32)
    req = rng.gamma(2.0, 100.0, n).astype(np.float32)
    err = (req * rng.random(n) * 0.1).astype(np.float32)
    cvw = (req * rng.random(n)).astype(np.float32)
    active = rng.random(n) < active_p
    if label == "one active":
        active[3] = True
    if label == "degenerate equal risks":
        rf[:] = 1.0
        acs[:] = 2.0
        replicas[:] = 1.0
        req[:] = 10.0
        err[:] = 0.0
        cvw[:] = 5.0
    arrays = (rf, acs, replicas, req, err, cvw, active)
    want = jax_scorers.risk_scores(*to_jax(arrays))
    got = scorers.risk_scores(*to_torch(arrays))
    for name, g, w in zip(want._fields, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("seed,dist_bits", [(40, 3), (41, 4), (42, None), (43, 3)])
def test_incremental_subset_and_splice_match_jax(seed, dist_bits):
    """dirty_edge_subset's compaction and kept count equal the JAX ones;
    scoring the subset and splicing the dirty lanes into the full scores
    gives the full scores back bit for bit, as in the JAX package."""
    dist_hi = 8 if dist_bits == 3 else 16
    src, dst, dist, mask, ep_service, ep_ml, ep_record = make_edges(
        seed, n_ep=128, n_svc=32, cap=2048, n_live=1500, dist_hi=dist_hi
    )
    dirty = np.random.default_rng(seed).random(32) < 0.15
    j_sub = jax_scorers.dirty_edge_subset(*to_jax((src, dst, dist, mask, ep_service, dirty)))
    t_sub = scorers.dirty_edge_subset(*to_torch((src, dst, dist, mask, ep_service, dirty)))
    for g, w in zip(t_sub, j_sub):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    kept = int(t_sub[3])
    sub_cap = 1 << max(kept - 1, 1).bit_length()
    s, d, ds = (c[:sub_cap] for c in t_sub[:3])
    tables = to_torch((ep_service, ep_ml, ep_record))
    full = scorers.service_scores(*to_torch((src, dst, dist, mask)), *tables, num_services=32, dist_bits=dist_bits)
    inc = scorers.service_scores(s, d, ds, s != SENTINEL, *tables, num_services=32, dist_bits=dist_bits)
    stale = scorers.ServiceScores(*[torch.zeros_like(x) for x in full])
    dirty_t = torch.from_numpy(dirty)
    spliced = scorers.merge_service_lanes(dirty_t, inc, full)
    for name, a, b in zip(full._fields, spliced, full):
        assert torch.equal(a, b), name
    # the dirty lanes come from the subset, the others from the base
    merged = scorers.merge_service_lanes(dirty_t, inc, stale)
    want = jax_scorers.merge_service_lanes(
        jnp.asarray(dirty),
        jax_scorers.ServiceScores(*[jnp.asarray(x.numpy()) for x in inc]),
        jax_scorers.ServiceScores(*[jnp.asarray(x.numpy()) for x in stale]),
    )
    for name, a, w in zip(full._fields, merged, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w), err_msg=name)
        np.testing.assert_array_equal(a.numpy()[dirty], full._asdict()[name].numpy()[dirty], err_msg=name)


@pytest.mark.parametrize("seed,n,hi_a,hi_b", [(0, 1, 3, 3), (1, 50, 4, 4), (2, 1000, 30, 500), (3, 257, 2, 2)])
def test_counting_primitives_match_jax(seed, n, hi_a, hi_b):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, hi_a, n).astype(np.int32)
    b = rng.integers(-hi_b, hi_b, n).astype(np.int32)
    gid, a_of_gid = sparse.dense_rank_pairs(torch.from_numpy(a), torch.from_numpy(b))
    j_gid, j_a = jax_sparse.dense_rank_pairs(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(gid.numpy(), np.asarray(j_gid))
    np.testing.assert_array_equal(a_of_gid.numpy(), np.asarray(j_a))
    first = rng.random(n) < 0.3
    np.testing.assert_array_equal(
        sparse.run_start_index(torch.from_numpy(first)).numpy(),
        np.asarray(jax_sparse.run_start_index(jnp.asarray(first))),
    )
    out = sparse.exclusive_cumsum(torch.from_numpy(first))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(jax_sparse.exclusive_cumsum(jnp.asarray(first))))


def test_sparse_and_legacy_pipelines_agree():
    """The two pipelines of the port on the same inputs: integer lanes
    equal, relying factor within rel 1e-5 (as the JAX package pins)."""
    arrays = to_torch(make_edges(50, cap=2048, n_live=2000, dist_hi=8))
    sparse_run = scorers.service_scores(*arrays, num_services=16, dist_bits=3)
    legacy = scorers.service_scores(*arrays, num_services=16)
    for name, s, l in zip(legacy._fields, sparse_run, legacy):
        if name == "relying_factor":
            np.testing.assert_allclose(s.numpy(), l.numpy(), rtol=1e-5)
        else:
            assert torch.equal(s, l), name

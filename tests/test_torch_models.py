"""The model forwards of the port on the CPU against the JAX package, with
the same weights on both sides: JAX's init_params, as numpy arrays, handed
to the port through checkpoint.params_from_numpy.

The JAX side runs both of its formulations: the default backend (XLA
gather/segment-sum) and KMAMIZ_SPARSE=pallas_interpret (its fused Pallas
kernel in interpret mode). Tolerance rtol/atol 1e-5: float sums in other
orders.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmamiz_tpu.models import common as jax_common
from kmamiz_tpu.models import graphsage as jax_sage
from kmamiz_tpu.models.stlgt import model as jax_stlgt
from kmamiz_tpu.ops import sparse as jax_sparse
from kmamiz_tpu_torch.models import checkpoint, common, graphsage
from kmamiz_tpu_torch.models.stlgt import model as stlgt

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(params=["sparse", "pallas_interpret"])
def jax_backend(request, monkeypatch):
    monkeypatch.setenv("KMAMIZ_SPARSE", request.param)
    jax_sparse.reset_for_tests()
    yield request.param
    jax_sparse.reset_for_tests()


def _snapshot(seed, n=200, n_pad=256, e=1500, e_pad=2048, f=18):
    """Features with zero-padded rows past n, and an edge list padded past
    e with masked-off sentinel edges plus ~10% masked-off live ones."""
    rng = np.random.default_rng(seed)
    feats = np.zeros((n_pad, f), dtype=np.float32)
    feats[:n] = rng.normal(size=(n, f)).astype(np.float32)
    src = np.full(e_pad, np.iinfo(np.int32).max, dtype=np.int32)
    dst = src.copy()
    mask = np.zeros(e_pad, dtype=bool)
    src[:e] = rng.integers(0, n, e)
    dst[:e] = rng.integers(0, n, e)
    mask[:e] = rng.random(e) < 0.9
    return feats, src, dst, mask


def _numpy(params):
    return {k: None if v is None else np.asarray(v) for k, v in params._asdict().items()}


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("num_nodes", [0, 256])
def test_graphsage_forward_matches_jax(jax_backend, num_nodes):
    feats, src, dst, mask = _snapshot(1)
    jp = jax_sage.init_params(
        jax.random.PRNGKey(3), hidden=64, num_features=18, num_nodes=num_nodes
    )
    # non-zero skips and biases, so every term of the readout is exercised
    rng = np.random.default_rng(2)
    arrays = {
        k: None if v is None else v + 0.1 * rng.normal(size=v.shape).astype(np.float32)
        for k, v in _numpy(jp).items()
    }
    jp = type(jp)(**{k: None if v is None else jnp.asarray(v) for k, v in arrays.items()})
    want_lat, want_logit = jax_sage.forward(jp, *map(jnp.asarray, (feats, src, dst, mask)))
    params = checkpoint.params_from_numpy(graphsage, arrays, device="cpu")
    lat, logit = graphsage.forward(params, *_torch(feats, src, dst, mask))
    np.testing.assert_allclose(lat.numpy(), np.asarray(want_lat), **TOL)
    np.testing.assert_allclose(logit.numpy(), np.asarray(want_logit), **TOL)


def test_graphsage_forward_with_the_model10k_weights(jax_backend):
    from pathlib import Path

    from test_torch_checkpoint import restore_orbax

    fixtures = Path(__file__).resolve().parent / "fixtures"
    arrays, _meta = restore_orbax(fixtures / "model10k", 60)
    jp = jax_sage.SageParams(**{k: None if v is None else jnp.asarray(v) for k, v in arrays.items()})
    params, _ = checkpoint.restore_params(str(fixtures / "model10k_torch"), graphsage, device="cpu")
    feats, src, dst, mask = _snapshot(4)
    want = jax_sage.forward(jp, *map(jnp.asarray, (feats, src, dst, mask)))
    got = graphsage.forward(params, *_torch(feats, src, dst, mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("hidden", [32, 64])
def test_stlgt_forward_quantiles_matches_jax(jax_backend, hidden):
    feats, src, dst, mask = _snapshot(5)
    jp = jax_stlgt.init_params(jax.random.PRNGKey(7), hidden=hidden, num_features=18)
    arrays = _numpy(jp)
    arrays["b_edge"] = np.array([0.25], dtype=np.float32)
    arrays["w_quant_skip"] = np.full_like(arrays["w_quant_skip"], 0.01)
    jp = jax_stlgt.StlgtParams(**{k: jnp.asarray(v) for k, v in arrays.items()})
    want_q, want_logit, want_gate = jax_stlgt.forward_quantiles(
        jp, *map(jnp.asarray, (feats, src, dst, mask))
    )
    params = checkpoint.params_from_numpy(stlgt, arrays, device="cpu")
    q, logit, gate = stlgt.forward_quantiles(params, *_torch(feats, src, dst, mask))
    np.testing.assert_allclose(q.numpy(), np.asarray(want_q), **TOL)
    np.testing.assert_allclose(logit.numpy(), np.asarray(want_logit), **TOL)
    np.testing.assert_allclose(gate.numpy(), np.asarray(want_gate), **TOL)
    assert np.all(np.diff(q.numpy(), axis=1) >= 0)
    assert np.all(gate.numpy()[~mask] == 0)
    p50, logit2 = stlgt.forward(params, *_torch(feats, src, dst, mask))
    assert torch.equal(p50, q[:, 0]) and torch.equal(logit2, logit)


def test_neighbor_mean_and_degree_match_jax():
    feats, src, dst, mask = _snapshot(6, f=12)
    args = map(jnp.asarray, (feats, src, dst, mask))
    want = np.asarray(jax_sage.neighbor_mean(*args))
    got = graphsage.neighbor_mean(*_torch(feats, src, dst, mask))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    want_deg = np.asarray(jax_sage.neighbor_degree(256, *map(jnp.asarray, (src, dst, mask))))
    got_deg = graphsage.neighbor_degree(256, *_torch(src, dst, mask))
    np.testing.assert_array_equal(got_deg.numpy(), want_deg)


def test_concat_embedding_pads_like_jax():
    rng = np.random.default_rng(8)
    feats = rng.normal(size=(16, 5)).astype(np.float32)
    emb = rng.normal(size=(10, 8)).astype(np.float32)
    want = np.asarray(jax_common.concat_embedding(jnp.asarray(feats), jnp.asarray(emb)))
    got = common.concat_embedding(torch.from_numpy(feats), torch.from_numpy(emb))
    np.testing.assert_array_equal(got.numpy(), want)
    assert common.concat_embedding(torch.from_numpy(feats), None).shape == (16, 5)


def test_features_from_stats_matches_jax():
    rng = np.random.default_rng(9)
    ne, ns = 12, 4
    count = rng.integers(0, 5, ne * ns).astype(np.float32)
    e4 = np.minimum(count, rng.integers(0, 3, ne * ns)).astype(np.float32)
    e5 = np.minimum(count - e4, rng.integers(0, 2, ne * ns)).astype(np.float32)
    lm = rng.gamma(2.0, 40.0, ne * ns).astype(np.float32)
    cv = rng.random(ne * ns).astype(np.float32)
    replicas = rng.integers(1, 4, 16).astype(np.float32)
    stats = (count, e4, e5, lm, cv, replicas)
    want = jax_sage.features_from_stats(
        *map(jnp.asarray, stats), ne, ns, 30.0, hour_of_day=5.0
    )
    got = graphsage.features_from_stats(*_torch(*stats), ne, ns, 30.0, hour_of_day=5.0)
    assert isinstance(got, np.ndarray) and got.shape == (ne, graphsage.NUM_FEATURES)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-7)


def test_init_params_shapes_match_jax():
    g = torch.Generator().manual_seed(0)
    for port, ref, kw in (
        (graphsage.init_params(g, hidden=16, num_features=18, num_nodes=5, device="cpu"),
         jax_sage.init_params(jax.random.PRNGKey(0), hidden=16, num_features=18, num_nodes=5), {}),
        (stlgt.init_params(g, hidden=32, num_features=18, device="cpu"),
         jax_stlgt.init_params(jax.random.PRNGKey(0), hidden=32, num_features=18), {}),
    ):
        assert port._fields == ref._fields
        for name in port._fields:
            assert tuple(getattr(port, name).shape) == tuple(getattr(ref, name).shape), name
    a = stlgt.init_params(torch.Generator().manual_seed(1), device="cpu")
    b = stlgt.init_params(torch.Generator().manual_seed(1), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert stlgt.QUANTILES == jax_stlgt.QUANTILES
    assert graphsage.NUM_FEATURES == jax_sage.NUM_FEATURES
    assert graphsage.EMB_DIM == jax_sage.EMB_DIM

"""The port's GAT head on the CPU against kmamiz_tpu.models.gat: the
segment softmax, the forward, one step's grads, AdamW steps, `train`
with model=gat, the checkpoint, and the forecast route serving a GAT
checkpoint.

Both sides start from the same weights (JAX's init_params as numpy arrays
through checkpoint.params_from_numpy). Tolerances: forward rtol/atol 1e-5
(tests/test_torch_models.py's TOL); one step's grads rtol 1e-4 / atol
1e-6; losses and final params at tests/test_torch_training.py's LOSS_TOL
and PARAM_TOL; the forecast payload within one unit of the route's
rounding (probability 1e-4, latency 0.01 ms), as tests/test_torch_forecast.py.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import prefixed_trace_source
from kmamiz_tpu.models import checkpoint as jax_ckpt
from kmamiz_tpu.models import gat as jax_gat
from kmamiz_tpu.models import trainer as jax_trainer
from kmamiz_tpu.server.processor import DataProcessor as JaxProcessor
from kmamiz_tpu_torch.models import checkpoint, common, gat, graphsage, serving, trainer
from kmamiz_tpu_torch.server.processor import DataProcessor
from test_torch_training import GRAD_TOL, LOSS_TOL, PARAM_TOL, _batch, _datasets, _numpy, _perturbed

TOL = dict(rtol=1e-5, atol=1e-5)
H = 3_600_000


def _graph(rng, n=24, e=60):
    feats = rng.normal(size=(n, graphsage.NUM_FEATURES)).astype(np.float32)
    src = rng.integers(0, n, e, dtype=np.int32)
    dst = rng.integers(0, n, e, dtype=np.int32)
    mask = rng.random(e) < 0.8
    return feats, src, dst, mask


def _params(seed, hidden=16, num_features=10, num_nodes=0, perturb=True):
    """(JAX params, port params) holding the same numbers."""
    jp = jax_gat.init_params(
        jax.random.PRNGKey(seed), hidden=hidden, num_features=num_features, num_nodes=num_nodes
    )
    arrays = _perturbed(jp, seed + 100) if perturb else _numpy(jp)
    jp = jax_gat.GatParams(**{k: None if v is None else jnp.asarray(v) for k, v in arrays.items()})
    return jp, checkpoint.params_from_numpy(gat, arrays, device="cpu")


class TestSegmentSoftmax:
    def test_weights_sum_to_one_per_destination(self):
        rng = np.random.default_rng(0)
        scores = rng.normal(size=32).astype(np.float32) * 10
        seg = rng.integers(0, 5, 32, dtype=np.int32)
        mask = rng.random(32) < 0.7
        alpha = gat._segment_softmax(
            torch.from_numpy(scores), torch.from_numpy(seg), 5, torch.from_numpy(mask)
        ).numpy()
        want = np.asarray(
            jax_gat._segment_softmax(jnp.asarray(scores), jnp.asarray(seg), 5, jnp.asarray(mask))
        )
        np.testing.assert_allclose(alpha, want, **TOL)
        alpha = np.where(mask, alpha, 0.0)
        sums = np.zeros(5)
        np.add.at(sums, seg, alpha)
        for s in range(5):
            seg_has = bool(np.any((seg == s) & mask))
            assert sums[s] == pytest.approx(1.0 if seg_has else 0.0, abs=1e-5)

    def test_extreme_scores_stay_finite(self):
        scores = torch.tensor([1e4, -1e4, 1e4, 0.0])
        seg = torch.tensor([0, 0, 1, 1], dtype=torch.int32)
        alpha = gat._segment_softmax(scores, seg, 2, torch.ones(4, dtype=torch.bool)).numpy()
        assert np.all(np.isfinite(alpha))
        assert alpha[0] == pytest.approx(1.0, abs=1e-5)

    def test_empty_segments_take_no_shift(self):
        """A segment with no live edge keeps shift 0 (jnp.where(shift >
        neg / 2, shift, 0)), so its masked rows stay finite and weightless."""
        scores = torch.tensor([3.0, -2.0, 5.0])
        seg = torch.tensor([0, 2, 2], dtype=torch.int32)
        mask = torch.tensor([True, False, False])
        alpha = gat._segment_softmax(scores, seg, 3, mask).numpy()
        np.testing.assert_array_equal(alpha, [1.0, 0.0, 0.0])

    def test_tie_grads_match_jax(self):
        """Tied maxima and exponents at the clip's edges: the segment max
        splits its gradient among ties and the clip gives 0.5 at its kink,
        in both packages."""
        scores = np.array([2.0, 2.0, 1.0, -70.0, 0.5, 0.5], dtype=np.float32)
        seg = np.array([0, 0, 0, 0, 1, 1], dtype=np.int32)
        mask = np.array([True, True, True, True, True, False])
        w = np.arange(1, 7, dtype=np.float32)

        def jax_f(s):
            return jnp.sum(jax_gat._segment_softmax(s, jnp.asarray(seg), 2, jnp.asarray(mask)) * w)

        want = np.asarray(jax.grad(jax_f)(jnp.asarray(scores)))
        s = torch.from_numpy(scores).requires_grad_(True)
        out = gat._segment_softmax(s, torch.from_numpy(seg), 2, torch.from_numpy(mask))
        (out * torch.from_numpy(w)).sum().backward()
        np.testing.assert_allclose(s.grad.numpy(), want, **GRAD_TOL)


class TestForward:
    @pytest.mark.parametrize("num_nodes", [0, 64], ids=["identity_free", "embedding"])
    def test_forward_matches_jax(self, num_nodes):
        feats, src, dst, mask, *_ = _batch(3)
        jp, params = _params(4, num_nodes=num_nodes)
        want = jax_gat.forward(jp, *map(jnp.asarray, (feats, src, dst, mask)))
        got = gat.forward(params, *map(torch.from_numpy, (feats, src, dst, mask)))
        for g, w in zip(got, want):
            assert g.shape == (feats.shape[0],)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)

    def test_index_is_accepted_and_unread(self):
        feats, src, dst, mask = map(torch.from_numpy, _graph(np.random.default_rng(1)))
        _, params = _params(0)
        a = gat.forward(params, feats, src, dst, mask)
        b = gat.forward(params, feats, src, dst, mask, index=object())
        for x, y in zip(a, b):
            assert torch.equal(x, y)

    def test_isolated_nodes_unharmed(self):
        _, params = _params(0, hidden=8, perturb=False)
        feats = torch.ones((6, graphsage.NUM_FEATURES))
        src = torch.tensor([0], dtype=torch.int32)
        dst = torch.tensor([1], dtype=torch.int32)
        lat, logit = gat.forward(params, feats, src, dst, torch.zeros(1, dtype=torch.bool))
        assert torch.isfinite(lat).all() and torch.isfinite(logit).all()

    def test_init_params_shapes_match_jax(self):
        jp = jax_gat.init_params(jax.random.PRNGKey(0), hidden=16, num_nodes=12)
        params = gat.init_params(torch.Generator().manual_seed(0), hidden=16, num_nodes=12, device="cpu")
        for name, a, b in zip(params._fields, params, jp):
            assert tuple(a.shape) == tuple(np.asarray(b).shape), name
            assert a.dtype == torch.float32
        no_emb = gat.init_params(torch.Generator().manual_seed(0), hidden=8, device="cpu")
        assert no_emb.embedding is None


class TestTraining:
    @pytest.mark.parametrize("perturb", [True, False], ids=["perturbed", "init"])
    def test_one_step_grads_match_jax(self, perturb):
        batch = _batch(1)
        jp, params = _params(3, perturb=perturb)
        (want_loss, want_aux), want_grads = jax.value_and_grad(jax_gat.loss_fn, has_aux=True)(
            jp, *map(jnp.asarray, batch)
        )
        loss, aux, grads = common.value_and_grad(gat.loss_fn, params, *map(torch.from_numpy, batch))
        np.testing.assert_allclose(float(loss), float(want_loss), **GRAD_TOL)
        for a, b in zip(aux, want_aux):
            np.testing.assert_allclose(float(a), float(b), **GRAD_TOL)
        for name, g, w in zip(params._fields, grads, want_grads):
            if w is None:
                assert g is None, name
                continue
            np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **GRAD_TOL)

    def test_three_adamw_steps_match_jax(self):
        batch = _batch(2)
        jp, params = _params(5, hidden=8)
        j_opt = jax_gat.make_optimizer(1e-2)
        j_state = j_opt.init(jp)
        j_step = jax_gat.make_train_step(j_opt, pos_weight=2.0)
        p_opt = gat.make_optimizer(1e-2)
        p_state = p_opt.init(params)
        p_step = gat.make_train_step(p_opt, pos_weight=2.0)
        for _ in range(3):
            jp, j_state, j_loss, _ = j_step(jp, j_state, *map(jnp.asarray, batch))
            params, p_state, p_loss, _ = p_step(params, p_state, *map(torch.from_numpy, batch))
            np.testing.assert_allclose(float(p_loss), float(j_loss), **LOSS_TOL)
        for name, a, b in zip(params._fields, params, jp):
            if b is None:
                assert a is None
                continue
            np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **PARAM_TOL)

    def test_train_matches_jax(self, monkeypatch):
        """Both trainers start from JAX's init with every leaf perturbed
        (_perturbed). From the bare init, the attention vectors' grads are
        float noise (~1e-7: within a destination's segment the a_dst term
        is a constant the softmax cancels, short of the LeakyReLU's kink),
        which the two packages round differently; AdamW divides a grad by
        its own scale, so that noise becomes a step of size lr with either
        sign, and the trajectories part by ~1e-3 within an epoch. One
        step's grads agree from both inits (test_one_step_grads_match_jax)."""

        def jax_init(rng, hidden=64, num_features=10, num_nodes=0):
            jp = init_params(rng, hidden=hidden, num_features=num_features, num_nodes=num_nodes)
            arrays = _perturbed(jp, 7)
            return jax_gat.GatParams(**{k: None if v is None else jnp.asarray(v) for k, v in arrays.items()})

        def port_init(generator, hidden=64, num_features=10, num_nodes=0, device=None):
            jp = jax_init(
                jax.random.PRNGKey(int(generator.initial_seed())),
                hidden=hidden,
                num_features=num_features,
                num_nodes=num_nodes,
            )
            return checkpoint.params_from_numpy(gat, _numpy(jp), device=device)

        init_params = jax_gat.init_params
        monkeypatch.setattr(jax_gat, "init_params", jax_init)
        monkeypatch.setattr(gat, "init_params", port_init)
        jds, pds = _datasets()
        kw = dict(epochs=3, hidden=8, seed=1)
        want = jax_trainer.train(jds, model=jax_gat, **kw)
        got = trainer.train(pds, device="cpu", model=gat, **kw)
        np.testing.assert_allclose(got.losses, want.losses, **LOSS_TOL)
        np.testing.assert_allclose(got.latency_losses, want.latency_losses, **LOSS_TOL)
        np.testing.assert_allclose(got.anomaly_losses, want.anomaly_losses, **LOSS_TOL)
        assert isinstance(got.params, gat.GatParams)
        for name, a, b in zip(got.params._fields, got.params, want.params):
            if b is None:
                assert a is None
                continue
            np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **PARAM_TOL)

    def test_training_converges(self):
        rng = np.random.default_rng(2)
        params = gat.init_params(torch.Generator().manual_seed(1), hidden=16, device="cpu")
        optimizer = gat.make_optimizer(1e-2)
        opt_state = optimizer.init(params)
        step = gat.make_train_step(optimizer)
        feats, src, dst, mask = map(torch.from_numpy, _graph(rng))
        tl = torch.from_numpy(rng.normal(size=24).astype(np.float32))
        ta = torch.from_numpy((rng.random(24) < 0.2).astype(np.float32))
        nm = torch.ones(24, dtype=torch.bool)
        losses = []
        for _ in range(60):
            params, opt_state, loss, _ = step(params, opt_state, feats, src, dst, mask, tl, ta, nm)
            losses.append(float(loss))
        assert losses[-1] < losses[0] * 0.7 and np.isfinite(losses[-1])

    @pytest.mark.parametrize("edge_mask", [[True, True, False], [False, False, False]], ids=["padding_only_segment", "all_masked"])
    def test_grads_finite_with_fully_masked_segments(self, edge_mask):
        """A destination whose only edges are masked (capacity padding
        clamps to node n-1) must not give NaN grads through the softmax's
        untaken exp branch; the grads also match JAX's."""
        jp, params = _params(0, hidden=8, perturb=False)
        feats = np.ones((4, graphsage.NUM_FEATURES), dtype=np.float32)
        src = np.array([0, 3, 3], dtype=np.int32)
        dst = np.array([1, 2, 0], dtype=np.int32)
        batch = (
            feats, src, dst, np.array(edge_mask),
            np.zeros(4, dtype=np.float32), np.zeros(4, dtype=np.float32), np.ones(4, dtype=bool),
        )
        _, want = jax.value_and_grad(jax_gat.loss_fn, has_aux=True)(jp, *map(jnp.asarray, batch))
        _, _, grads = common.value_and_grad(gat.loss_fn, params, *map(torch.from_numpy, batch))
        for name, g, w in zip(params._fields, grads, want):
            if g is None:
                continue
            assert torch.isfinite(g).all(), name
            np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **GRAD_TOL)


def test_checkpoint_round_trip(tmp_path):
    _, params = _params(7, hidden=8)
    checkpoint.save_params(str(tmp_path), params, 3, {"model": "gat", "hidden": 8, "num_features": 10})
    restored, meta = checkpoint.restore_params(str(tmp_path), gat, device="cpu")
    assert isinstance(restored, gat.GatParams) and meta["model"] == "gat"
    for a, b in zip(restored, params):
        assert (a is None and b is None) or torch.equal(a, b)


def _jax_router(proc, model_dir):
    from kmamiz_tpu.api.app import build_router
    from kmamiz_tpu.config import Settings
    from kmamiz_tpu.server.initializer import AppContext, Initializer
    from kmamiz_tpu.server.storage import MemoryStore

    settings = Settings()
    settings.external_data_processor = ""
    settings.model_dir = model_dir
    ctx = AppContext.build(app_settings=settings, store=MemoryStore(), processor=proc)
    Initializer(ctx).register_data_caches()
    return build_router(ctx)


def _gat_checkpoints(tmp_path, hidden=16, num_features=18):
    """The same GAT weights as a JAX orbax checkpoint and a port one."""
    jp = jax_gat.init_params(jax.random.PRNGKey(9), hidden=hidden, num_features=num_features)
    arrays = _perturbed(jp, 19)
    jp = jax_gat.GatParams(**{k: None if v is None else jnp.asarray(v) for k, v in arrays.items()})
    meta = {"model": "gat", "hidden": hidden, "num_features": num_features, "num_nodes": 0, "lr": 1e-3}
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    opt = jax_gat.make_optimizer(1e-3)
    jax_ckpt.save_checkpoint(str(jax_dir), jp, opt.init(jp), 5, meta)
    params = checkpoint.params_from_numpy(gat, arrays, device="cpu")
    checkpoint.save_params(str(port_dir), params, 5, meta)
    return str(jax_dir), str(port_dir)


def test_forecast_route_serves_gat_like_jax(pdas_traces, tmp_path):
    from test_torch_forecast import _drive, _port_router

    jax_dir, port_dir = _gat_checkpoints(tmp_path)
    jax_dp = JaxProcessor(trace_source=prefixed_trace_source(pdas_traces, "d"), use_device_stats=False)
    port_dp = DataProcessor(trace_source=prefixed_trace_source(pdas_traces, "d"), device="cpu")
    _drive(jax_dp, [910, 911])
    _drive(port_dp, [910, 911])
    want = _jax_router(jax_dp, jax_dir).dispatch("GET", "/api/v1/model/forecast")
    got = _port_router(port_dp, model_dir=port_dir).dispatch("GET", "/api/v1/model/forecast")
    assert got.status == want.status == 200, (got.payload, want.payload)
    g, w = got.payload, want.payload
    assert g["model"] == w["model"] == "gat"
    assert g["predictedHour"] == w["predictedHour"]
    g_idx = {e["uniqueEndpointName"]: e for e in g["endpoints"]}
    w_idx = {e["uniqueEndpointName"]: e for e in w["endpoints"]}
    assert set(g_idx) == set(w_idx) and len(g_idx) == len(g["endpoints"])
    for name, we in w_idx.items():
        ge = g_idx[name]
        assert abs(ge["anomalyProbability"] - we["anomalyProbability"]) <= 1e-4 + 1e-9, name
        assert abs(ge["predictedLatencyMs"] - we["predictedLatencyMs"]) <= 0.01 + 1e-9, name
    # the raw forward at the forward's tolerance
    params, _ = checkpoint.restore_params(port_dir, gat, device="cpu")
    ps = port_dp.forecast_snapshot
    lat, prob = serving.forecast_forward(params, ps["features"], ps["src"], ps["dst"], ps["mask"], gat)
    assert np.all(np.isfinite(lat)) and np.all((prob >= 0) & (prob <= 1))

"""Model-plane training of the port on the CPU against the JAX package: the
loss and its grads, the AdamW step, `train` (legacy loop, fused epochs,
slot microbatches, resume), evaluation, the dataset builder and the
history augmentation.

Both sides start from the same weights: JAX's init_params, as numpy
arrays, handed to the port (the two frameworks draw different numbers
from one seed). Tolerances: one step's grads rtol 1e-4 / atol 1e-6
(float32 sums in other orders); AdamW after 3 steps rtol 1e-5 / atol 1e-7
(the port mirrors optax's order of operations); train losses rtol 1e-4 /
atol 1e-5 and final params rtol 1e-3 / atol 1e-5, as the JAX package's
own fused-against-legacy test holds them; dataset building and history
augmentation bit-exact.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kmamiz_tpu.models import common as jax_common
from kmamiz_tpu.models import graphsage as jax_sage
from kmamiz_tpu.models import history as jax_history
from kmamiz_tpu.models import trainer as jax_trainer
from kmamiz_tpu.models.stlgt import model as jax_stlgt
from kmamiz_tpu_torch.models import checkpoint, common, graphsage, history, stacked, trainer
from kmamiz_tpu_torch.models.stlgt import model as stlgt

GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=1e-3, atol=1e-5)


def _numpy(params):
    return {k: None if v is None else np.asarray(v) for k, v in params._asdict().items()}


def _leaves(params):
    return [np.asarray(v) for v in params if v is not None]


def _batch(seed, n=48, n_pad=64, e=160, e_pad=256, f=10):
    """One slot: features with zero-padded rows, an edge list with masked
    sentinel padding and ~10% masked live edges, targets and a node mask."""
    rng = np.random.default_rng(seed)
    feats = np.zeros((n_pad, f), dtype=np.float32)
    feats[:n] = rng.normal(size=(n, f)).astype(np.float32)
    src = np.full(e_pad, np.iinfo(np.int32).max, dtype=np.int32)
    dst = src.copy()
    mask = np.zeros(e_pad, dtype=bool)
    src[:e] = rng.integers(0, n, e)
    dst[:e] = rng.integers(0, n, e)
    mask[:e] = rng.random(e) < 0.9
    t_lat = rng.normal(size=n_pad).astype(np.float32)
    t_ano = (rng.random(n_pad) < 0.3).astype(np.float32)
    n_mask = np.zeros(n_pad, dtype=bool)
    n_mask[:n] = rng.random(n) < 0.9
    return feats, src, dst, mask, t_lat, t_ano, n_mask


def _perturbed(params, seed):
    """Params with non-zero skips and biases, so every term is exercised."""
    rng = np.random.default_rng(seed)
    return {
        k: None if v is None else v + 0.1 * rng.normal(size=v.shape).astype(np.float32)
        for k, v in _numpy(params).items()
    }


@pytest.mark.parametrize("family", ["graphsage", "graphsage_embedding", "stlgt"])
def test_one_step_grads_match_jax(family):
    batch = _batch(1)
    if family == "stlgt":
        jp = jax_stlgt.init_params(jax.random.PRNGKey(3), hidden=16, num_features=10)
        jax_loss = jax_stlgt.make_pinball_loss_fn(2.5)
        port_model, port_loss = stlgt, stlgt.make_pinball_loss_fn(2.5)
    else:
        nodes = 64 if family == "graphsage_embedding" else 0
        jp = jax_sage.init_params(jax.random.PRNGKey(3), hidden=16, num_features=10, num_nodes=nodes)
        jax_loss = jax_common.make_loss_fn(jax_sage.forward, 2.5)
        port_model, port_loss = graphsage, common.make_loss_fn(graphsage.forward, 2.5)
    arrays = _perturbed(jp, 2)
    jp = type(jp)(**{k: None if v is None else jnp.asarray(v) for k, v in arrays.items()})
    (want_loss, want_aux), want_grads = jax.value_and_grad(jax_loss, has_aux=True)(
        jp, *map(jnp.asarray, batch)
    )
    params = checkpoint.params_from_numpy(port_model, arrays, device="cpu")
    loss, aux, grads = common.value_and_grad(port_loss, params, *map(torch.from_numpy, batch))
    np.testing.assert_allclose(float(loss), float(want_loss), **GRAD_TOL)
    for a, b in zip(aux, want_aux):
        np.testing.assert_allclose(float(a), float(b), **GRAD_TOL)
    for name, g, w in zip(params._fields, grads, want_grads):
        if w is None:
            assert g is None, name
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **GRAD_TOL)


def test_adamw_matches_optax_over_three_steps():
    jp = jax_sage.init_params(jax.random.PRNGKey(5), hidden=8, num_features=10, num_nodes=12)
    arrays = _numpy(jp)
    rng = np.random.default_rng(4)
    grads = [
        {k: None if v is None else rng.normal(size=v.shape).astype(np.float32) for k, v in arrays.items()}
        for _ in range(3)
    ]
    opt = optax.adamw(0.05, weight_decay=1e-4)
    state = opt.init(jp)
    port_opt = graphsage.make_optimizer(0.05)
    params = checkpoint.params_from_numpy(graphsage, arrays, device="cpu")
    port_state = port_opt.init(params)
    for g in grads:
        jg = type(jp)(**{k: None if v is None else jnp.asarray(v) for k, v in g.items()})
        updates, state = opt.update(jg, state, jp)
        jp = optax.apply_updates(jp, updates)
        tg = type(params)(**{k: None if v is None else torch.from_numpy(v) for k, v in g.items()})
        params, port_state = port_opt.apply(params, tg, port_state)
    assert int(port_state.count) == 3
    for name, a, b in zip(params._fields, params, jp):
        if b is None:
            assert a is None
            continue
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-7, err_msg=name)
    mu = state[0].mu
    for name, a, b in zip(params._fields, port_state.mu, mu):
        if b is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-7, err_msg=name)


def _datasets(n_nodes=16, n_edges=24, n_slots=5, seed=0, anomaly=0.2, f=10):
    """The same synthetic slots as a JAX and a port GraphDataset."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, n_edges, dtype=np.int32)
    dst = rng.integers(0, n_nodes, n_edges, dtype=np.int32)
    feats = [rng.normal(size=(n_nodes, f)).astype(np.float32) for _ in range(n_slots)]
    t_lat = [rng.normal(size=n_nodes).astype(np.float32) for _ in range(n_slots)]
    t_ano = [(rng.random(n_nodes) < anomaly).astype(np.float32) for _ in range(n_slots)]
    n_mask = [rng.random(n_nodes) < 0.9 for _ in range(n_slots)]
    names = [f"ep{i}" for i in range(n_nodes)]
    keys = [f"0-{i}-0" for i in range(n_slots)]
    jds = jax_trainer.GraphDataset(
        endpoint_names=names,
        src=jnp.asarray(src),
        dst=jnp.asarray(dst),
        edge_mask=jnp.ones(n_edges, dtype=bool),
        features=[jnp.asarray(a) for a in feats],
        target_latency=[jnp.asarray(a) for a in t_lat],
        target_anomaly=[jnp.asarray(a) for a in t_ano],
        node_mask=[jnp.asarray(a) for a in n_mask],
        slot_keys=list(keys),
    )
    pds = trainer.GraphDataset(
        endpoint_names=names,
        src=src,
        dst=dst,
        edge_mask=np.ones(n_edges, dtype=bool),
        features=feats,
        target_latency=t_lat,
        target_anomaly=t_ano,
        node_mask=n_mask,
        slot_keys=list(keys),
    )
    return jds, pds


@pytest.fixture
def jax_init(monkeypatch):
    """The port's GraphSAGE init_params draws JAX's weights for the seed,
    so both trainers start from the same point."""

    def init(generator, hidden=64, num_features=10, num_nodes=0, device=None):
        seed = int(generator.initial_seed())
        jp = jax_sage.init_params(
            jax.random.PRNGKey(seed), hidden=hidden, num_features=num_features, num_nodes=num_nodes
        )
        return checkpoint.params_from_numpy(graphsage, _numpy(jp), device=device)

    monkeypatch.setattr(graphsage, "init_params", init)


@pytest.mark.parametrize(
    "fused,embeddings,batch",
    [(False, False, 1), (True, False, 1), (True, True, 1), (True, False, 2)],
    ids=["legacy", "fused", "fused_embedding", "slot_batches"],
)
def test_train_matches_jax(jax_init, fused, embeddings, batch):
    jds, pds = _datasets()
    kw = dict(epochs=4, hidden=8, seed=1, fused=fused, use_node_embeddings=embeddings, batch_slots=batch)
    want = jax_trainer.train(jds, **kw)
    got = trainer.train(pds, device="cpu", **kw)
    np.testing.assert_allclose(got.losses, want.losses, **LOSS_TOL)
    np.testing.assert_allclose(got.latency_losses, want.latency_losses, **LOSS_TOL)
    np.testing.assert_allclose(got.anomaly_losses, want.anomaly_losses, **LOSS_TOL)
    for name, a, b in zip(got.params._fields, got.params, want.params):
        if b is None:
            assert a is None
            continue
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **PARAM_TOL)


def test_fused_matches_the_legacy_loop():
    _, pds = _datasets(seed=3)
    legacy = trainer.train(pds, epochs=5, hidden=8, fused=False, device="cpu")
    fused = trainer.train(pds, epochs=5, hidden=8, fused=True, device="cpu")
    np.testing.assert_allclose(fused.losses, legacy.losses, **LOSS_TOL)
    for a, b in zip(_leaves(fused.params), _leaves(legacy.params)):
        np.testing.assert_allclose(a, b, **PARAM_TOL)


def test_env_var_selects_the_legacy_loop(monkeypatch):
    _, pds = _datasets(n_slots=2)
    monkeypatch.setenv("KMAMIZ_SAGE_FUSED", "0")
    r = trainer.train(pds, epochs=1, hidden=8, device="cpu")
    assert not hasattr(pds, "_stacked_cache")  # the legacy loop stacks nothing
    assert np.isfinite(r.losses[-1])


def test_resume_mid_run_is_bit_exact(tmp_path):
    _, pds = _datasets()
    full = trainer.train(pds, epochs=6, hidden=8, checkpoint_dir=str(tmp_path / "a"), checkpoint_every=2, device="cpu")
    d2 = str(tmp_path / "b")
    head = trainer.train(pds, epochs=4, hidden=8, checkpoint_dir=d2, checkpoint_every=2, device="cpu")
    assert checkpoint.latest_complete_step(d2) == 4
    tail = trainer.train(pds, epochs=6, hidden=8, checkpoint_dir=d2, checkpoint_every=2, device="cpu")
    assert head.losses + tail.losses == full.losses
    for a, b in zip(_leaves(tail.params), _leaves(full.params)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize(
    "change,needle",
    [({"hidden": 16}, "hidden=8"), ({"lr": 0.5}, "lr=0.01"), ({"seed": 9}, "seed=0")],
)
def test_resume_rejects_other_hyperparameters(tmp_path, change, needle):
    _, pds = _datasets(n_slots=2)
    trainer.train(pds, epochs=1, hidden=8, checkpoint_dir=str(tmp_path), device="cpu")
    kw = {"epochs": 2, "hidden": 8, **change}
    with pytest.raises(ValueError, match=needle):
        trainer.train(pds, checkpoint_dir=str(tmp_path), device="cpu", **kw)


def test_resume_rejects_another_layout(tmp_path):
    _, pds = _datasets(n_slots=2)
    trainer.train(pds, epochs=1, hidden=8, checkpoint_dir=str(tmp_path), device="cpu")
    _, more = _datasets(n_slots=3)
    with pytest.raises(ValueError, match="stacked layout"):
        trainer.train(more, epochs=2, hidden=8, checkpoint_dir=str(tmp_path), device="cpu")


def test_checkpoint_keeps_the_optimizer_state(tmp_path):
    _, pds = _datasets(n_slots=2)
    r = trainer.train(pds, epochs=2, hidden=8, checkpoint_dir=str(tmp_path), checkpoint_every=0, device="cpu")
    template = graphsage.init_params(torch.Generator().manual_seed(0), hidden=8, num_features=10, device="cpu")
    opt_template = graphsage.make_optimizer(0.01).init(template)
    params, opt_state, meta = checkpoint.restore_checkpoint(str(tmp_path), template, opt_template)
    assert meta["step"] == 2 and meta["model"] == "graphsage" and meta["stacked"]["num_slots"] == 2
    assert int(opt_state.count) == 2 * 2  # 2 epochs of 2 slots
    for a, b in zip(_leaves(params), _leaves(r.params)):
        np.testing.assert_array_equal(a, b)
    # a params-only reader (the forecast route) skips the optimizer arrays
    served, _meta = checkpoint.restore_params(str(tmp_path), graphsage, device="cpu")
    for a, b in zip(_leaves(served), _leaves(r.params)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="template"):
        wide = graphsage.init_params(torch.Generator(), hidden=16, num_features=10, device="cpu")
        checkpoint.restore_checkpoint(str(tmp_path), wide, graphsage.make_optimizer(0.01).init(wide))


def test_mesh_waits_for_the_multi_gpu_slice():
    _, pds = _datasets(n_slots=2)
    with pytest.raises(NotImplementedError):
        trainer.train(pds, epochs=1, hidden=8, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError):
        stacked.dp_epoch_runner(graphsage, 0.01, 1.0, mesh=object())


def test_stacked_layout_and_predictions_match_jax():
    from kmamiz_tpu.models import stacked as jax_stacked

    jds, pds = _datasets(n_nodes=20, n_edges=40, n_slots=3)
    assert stacked.dataset_layout(pds) == jax_stacked.dataset_layout(jds)
    st = stacked.stack_dataset(pds, "cpu")
    assert st.layout() == jax_stacked.stack_dataset(jds).layout()
    assert stacked.stack_dataset(pds, "cpu") is st  # memoized
    assert st.features.shape == (3, 32, 10) and not bool(st.node_mask[:, 20:].any())
    jp = jax_sage.init_params(jax.random.PRNGKey(1), hidden=8, num_features=10)
    params = checkpoint.params_from_numpy(graphsage, _numpy(jp), device="cpu")
    lat, logit = stacked.predict_all(params, pds, graphsage)
    want_lat, want_logit = jax_stacked.predict_all(jp, jds, jax_sage)
    np.testing.assert_allclose(lat, want_lat, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(logit, want_logit, rtol=1e-5, atol=1e-6)
    groups = stacked.batch_slots_arrays(st, 2)
    want_groups = jax_stacked.batch_slots_arrays(jax_stacked.stack_dataset(jds), 2)
    for a, b in zip(groups, want_groups):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_evaluation_matches_jax():
    jds, pds = _datasets(n_nodes=24, n_edges=50, n_slots=6, anomaly=0.3)
    jp = jax_sage.init_params(jax.random.PRNGKey(2), hidden=8, num_features=10)
    jp = type(jp)(**{k: None if v is None else jnp.asarray(v) for k, v in _perturbed(jp, 5).items()})
    params = checkpoint.params_from_numpy(graphsage, _numpy(jp), device="cpu")
    want_t = jax_trainer.calibrate_threshold(jp, jds)
    assert trainer.calibrate_threshold(params, pds) == want_t
    got = trainer.evaluate(params, pds, threshold=want_t)
    want = jax_trainer.evaluate(jp, jds, threshold=want_t)
    for field in ("anomaly_accuracy", "anomaly_precision", "anomaly_recall", "anomaly_f1", "anomaly_base_rate"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.per_slot_flagged == want.per_slot_flagged
    np.testing.assert_allclose(got.latency_mse, want.latency_mse, rtol=1e-5)
    np.testing.assert_allclose(got.latency_mae_ms, want.latency_mae_ms, rtol=1e-5)
    for fn, kw in ((trainer.evaluate_baseline, {}), (trainer.evaluate_naive, {"rate": 0.3, "seed": 4})):
        a = fn(pds, **kw)
        b = getattr(jax_trainer, fn.__name__)(jds, **kw)
        assert a.per_slot_flagged == b.per_slot_flagged and a.anomaly_f1 == b.anomaly_f1
        np.testing.assert_allclose(a.latency_mse, b.latency_mse, rtol=1e-6)
    head, tail = trainer.temporal_split(pds, 0.5)
    j_head, j_tail = jax_trainer.temporal_split(jds, 0.5)
    assert head.slot_keys == j_head.slot_keys and tail.slot_keys == j_tail.slot_keys


@pytest.fixture(scope="module")
def simulation():
    from test_trainer import FAULT_YAML

    from kmamiz_tpu.simulator.simulator import Simulator

    return Simulator().generate_simulation_data(FAULT_YAML, 0.0, rng=np.random.default_rng(7))


def _assert_same_dataset(got, want):
    assert got.endpoint_names == want.endpoint_names
    assert got.slot_keys == want.slot_keys
    for name in ("src", "dst", "edge_mask"):
        a, b = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("features", "target_latency", "target_anomaly", "node_mask"):
        assert len(getattr(got, name)) == len(getattr(want, name))
        for a, b in zip(getattr(got, name), getattr(want, name)):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_dataset_from_simulation_is_bit_exact(simulation):
    args = (simulation.endpoint_dependencies, simulation.realtime_data_per_slot, simulation.replica_counts)
    got = trainer.dataset_from_simulation(*args)
    want = jax_trainer.dataset_from_simulation(*args)
    assert len(got.features) == 47
    _assert_same_dataset(got, want)


def test_history_augmentation_is_bit_exact(simulation):
    args = (simulation.endpoint_dependencies, simulation.realtime_data_per_slot, simulation.replica_counts)
    got = history.augment_with_history(trainer.dataset_from_simulation(*args))
    want = jax_history.augment_with_history(jax_trainer.dataset_from_simulation(*args))
    assert got.features[0].shape[1] == 10 + history.NUM_HISTORY_FEATURES
    _assert_same_dataset(got, want)
    held = history.split_endpoints(got.num_nodes, 0.34, seed=2)
    np.testing.assert_array_equal(held, jax_history.split_endpoints(got.num_nodes, 0.34, seed=2))
    _assert_same_dataset(history.mask_endpoints(got, ~held), jax_history.mask_endpoints(want, ~held))


def test_simulation_checkpoint_serves_through_the_port_route(simulation, tmp_path, pdas_traces):
    """A head the port trains on augmented simulator slots is served by
    the port's forecast route (the checkpoint carries optimizer arrays,
    which the route skips)."""
    from conftest import prefixed_trace_source

    from kmamiz_tpu_torch.api.app import build_router
    from kmamiz_tpu_torch.config import Settings
    from kmamiz_tpu_torch.server.initializer import AppContext
    from kmamiz_tpu_torch.server.processor import DataProcessor

    args = (simulation.endpoint_dependencies, simulation.realtime_data_per_slot, simulation.replica_counts)
    ds = history.augment_with_history(trainer.dataset_from_simulation(*args))
    r = trainer.train(ds, epochs=2, hidden=8, checkpoint_dir=str(tmp_path), checkpoint_every=0, device="cpu")
    assert r.losses[-1] < r.losses[0]
    dp = DataProcessor(trace_source=prefixed_trace_source(pdas_traces, "tr"), device="cpu")
    for i, hour in enumerate((920, 921)):
        dp.collect({"uniqueId": f"tr{i}", "lookBack": 30_000, "time": hour * 3_600_000})
    settings = Settings()
    settings.model_dir = str(tmp_path)
    res = build_router(AppContext(settings=settings, processor=dp)).dispatch("GET", "/api/v1/model/forecast")
    assert res.status == 200, res.payload
    assert res.payload["model"] == "graphsage"
    assert len(res.payload["endpoints"]) == len(dp.forecast_snapshot["names"])

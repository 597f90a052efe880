"""The port's model-evaluation tools (kmamiz_tpu_torch/tools/eval_models.py,
eval_models_large.py and eval_stlgt.py) against the repo's JAX tools
(tools/eval_models*.py, tools/eval_stlgt.py) on the CPU.

The host-numpy pieces are the JAX tools' own: EVAL_YAML and the mesh
generator byte-equal, ROC-AUC, PR-AUC and onset recall equal (ties,
single-class labels and no onsets included). The device pieces run the
port with device="cpu" from JAX's initial weights for the seed (handed to
the port, tests/test_torch_simulator.py's `same_init`; GAT's perturbed):
collect_scores' probabilities within rtol 1e-5 / atol 1e-6 and its boolean
arrays equal; both protocols of eval_models_large end to end at 6 services
x 3 endpoints, 2 days, hidden 8, with their rows' threshold and
classification metrics equal, ROC-AUC, PR-AUC and onset recall within abs
1e-6, latency MAE within the losses' tolerance (rtol 1e-4 / atol 1e-5).
GAT's rows are compared in full over its initial weights (0 epochs) and in
their thresholded metrics at 1 epoch only: it parts within its first epoch
through ELU's grad at large negative pre-activations (exp(x) in the port,
expm1(x) + 1 in JAX), as tests/test_torch_simulator.py's GAT test sets
out. eval_stlgt's prequential replay runs both heads from JAX's
weights; each tool's entry point raises on a CUDA device without a card.
"""
from __future__ import annotations

import importlib
import json
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from kmamiz_tpu.models import graphsage as jax_sage
from kmamiz_tpu.models.stlgt import model as jax_stlgt
from kmamiz_tpu_torch.models import checkpoint, gat, graphsage, trainer
from kmamiz_tpu_torch.models.stlgt import model as stlgt
from kmamiz_tpu_torch.tools import eval_models, eval_stlgt
from kmamiz_tpu_torch.tools import eval_models_large as eml
from test_torch_simulator import LOSS_TOL, _numpy, _perturbed, same_init  # noqa: F401 (fixture)

REPO = Path(__file__).resolve().parent.parent
PROB_TOL = dict(rtol=1e-5, atol=1e-6)
SMALL = ["--services", "6", "--eps-per-service", "3", "--days", "2", "--hidden", "8"]
#: EvalResult fields that thresholded counts decide: equal, not close
EXACT_METRICS = (
    "threshold", "anomaly_accuracy", "anomaly_precision", "anomaly_recall",
    "anomaly_base_rate", "anomaly_f1", "per_slot_flagged", "in_sample",
)


@pytest.fixture(scope="module")
def jax_tools():
    """The JAX tools, imported as modules of the checkout's tools/ (each
    puts the checkout at the head of sys.path, and eval_models_large
    imports its sibling eval_models by bare name, so tools/ goes on the
    path for the import); sys.path is put back afterwards."""
    saved = list(sys.path)
    try:
        sys.path.insert(0, str(REPO / "tools"))
        return types.SimpleNamespace(
            **{name: importlib.import_module(f"tools.{name}") for name in ("eval_models", "eval_models_large", "eval_stlgt")}
        )
    finally:
        sys.path[:] = saved


# -- the host pieces -----------------------------------------------------------


def test_eval_yaml_is_the_jax_tools(jax_tools):
    assert eval_models.EVAL_YAML == jax_tools.eval_models.EVAL_YAML


@pytest.mark.parametrize("services,eps,days,seed", [(6, 3, 2, 0), (20, 10, 1, 3), (37, 4, 3, 11), (100, 10, 4, 0)])
def test_make_mesh_config_is_the_jax_tools(jax_tools, services, eps, days, seed):
    got = eml.make_mesh_config(services, eps, days, np.random.default_rng(seed))
    want = jax_tools.eval_models_large.make_mesh_config(services, eps, days, np.random.default_rng(seed))
    assert got == want


def _metric_inputs(case: str):
    rng = np.random.default_rng(5)
    n = 400
    scores = rng.random(n).astype(np.float32)
    labels = rng.random(n) < 0.2
    onsets = labels & (rng.random(n) < 0.5)
    if case == "ties":
        scores = np.round(scores * 4).astype(np.float32) / 4
    elif case == "all_positive":
        labels = np.ones(n, dtype=bool)
        onsets = rng.random(n) < 0.3
    elif case == "all_negative":
        labels = np.zeros(n, dtype=bool)
        onsets = np.zeros(n, dtype=bool)
    elif case == "no_onsets":
        onsets = np.zeros(n, dtype=bool)
    return scores, labels, onsets


@pytest.mark.parametrize("case", ["seeded", "ties", "all_positive", "all_negative", "no_onsets"])
def test_threshold_free_metrics_are_the_jax_tools(jax_tools, case):
    """roc_auc, pr_auc and onset_recall give the JAX tool's numbers (nan
    where it gives nan: one class only, no onset)."""
    scores, labels, onsets = _metric_inputs(case)
    ref = jax_tools.eval_models_large
    got = [eml.roc_auc(scores, labels), eml.pr_auc(scores, labels)]
    want = [ref.roc_auc(scores, labels), ref.pr_auc(scores, labels)]
    for threshold in (0.25, 0.5, 0.9):
        got.append(eml.onset_recall(scores, labels, onsets, threshold))
        want.append(ref.onset_recall(scores, labels, onsets, threshold))
    np.testing.assert_equal(got, want)
    nans = {
        "all_positive": [True, False] + [False] * 3,
        "all_negative": [True, True] + [True] * 3,
        "no_onsets": [False, False] + [True] * 3,
    }.get(case, [False] * 5)
    assert [bool(np.isnan(v)) for v in got] == nans


# -- collect_scores and the persistence rows ---------------------------------------


@pytest.fixture(scope="module")
def small_eval_set():
    """The held-out slots of the 6 x 3 mesh (2 days, seed 0), host numpy:
    both tools read the same dataset."""
    result = eml.simulate(eml.make_mesh_config(6, 3, 2, np.random.default_rng(0)), 0)
    dataset = trainer.dataset_from_simulation(
        result.endpoint_dependencies, result.realtime_data_per_slot, result.replica_counts
    )
    return trainer.temporal_split(dataset, eml.TRAIN_FRACTION)[1]


@pytest.mark.parametrize("name", ["graphsage", "gat"])
def test_collect_scores_matches_jax(jax_tools, small_eval_set, name):
    from kmamiz_tpu.models import gat as jax_gat

    jax_model, model = {"graphsage": (jax_sage, graphsage), "gat": (jax_gat, gat)}[name]
    jp = jax_model.init_params(jax.random.PRNGKey(3), hidden=8)
    arrays = _perturbed(jp, 7)  # off the bare init: every unit live
    jp = type(jp)(**{k: None if v is None else jax.numpy.asarray(v) for k, v in arrays.items()})
    params = checkpoint.params_from_numpy(model, arrays, device="cpu")
    got = eml.collect_scores(params, small_eval_set, model)
    want = jax_tools.eval_models_large.collect_scores(jp, small_eval_set, jax_model)
    np.testing.assert_allclose(got[0], want[0], **PROB_TOL)
    assert 0.0 < got[0].min() < got[0].max() < 1.0
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == b.dtype == bool
        np.testing.assert_array_equal(a, b)


def test_persistence_rows_are_the_jax_tools(jax_tools, small_eval_set):
    got = eml._persistence_rows(small_eval_set)
    want = jax_tools.eval_models_large._persistence_rows(small_eval_set)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[1].any() and got[2].any()


# -- the protocols end to end ------------------------------------------------------


def _rows_of(module, monkeypatch, call):
    """The rows `call()` hands to `module`'s _print_rows."""
    seen = []
    monkeypatch.setattr(module, "_print_rows", seen.append)
    call()
    assert len(seen) == 1
    return seen[0]


def _jax_main_rows(jax_tools, monkeypatch, argv):
    ref = jax_tools.eval_models_large
    monkeypatch.setattr(sys, "argv", ["eval_models_large.py", *argv])
    return _rows_of(ref, monkeypatch, ref.main)


def _port_main_rows(monkeypatch, argv):
    return _rows_of(eml, monkeypatch, lambda: eml.main([*argv, "--device", "cpu"]))


def _assert_rows_match(got, want, level=lambda name: "all"):
    """Row names equal; then per row, as `level(name)` says: "all" holds the
    thresholded metrics equal, the threshold-free ones within abs 1e-6 (nan
    where the JAX tool has nan) and the latency MAE within the losses'
    tolerance; "thresholded" the thresholded metrics and onset recall
    alone; "finite" a finite latency MAE."""
    assert [r[0] for r in got] == [r[0] for r in want]
    for g, w in zip(got, want):
        name, gm, wm = g[0], g[1], w[1]
        assert np.isfinite(gm.latency_mae_ms), name
        if level(name) == "finite":
            continue
        for key in EXACT_METRICS:
            assert getattr(gm, key) == getattr(wm, key), (name, key)
        if level(name) == "thresholded":
            np.testing.assert_equal(g[4], w[4], err_msg=name)
            continue
        np.testing.assert_allclose(g[2:5], w[2:5], rtol=0, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(gm.latency_mae_ms, wm.latency_mae_ms, err_msg=name, **LOSS_TOL)


def test_transductive_protocol_matches_jax(same_init, jax_tools, monkeypatch):
    """3 epochs: the GraphSAGE rows (and its hybrid), the persistence
    skyline and the random baseline in full; GAT's rows finite."""
    argv = [*SMALL, "--epochs", "3", "--seed", "0"]
    want = _jax_main_rows(jax_tools, monkeypatch, argv)
    got = _port_main_rows(monkeypatch, argv)
    _assert_rows_match(got, want, lambda name: "finite" if name.startswith("GAT") else "all")
    assert got[0][1].anomaly_base_rate > 0


@pytest.mark.parametrize("epochs", [0, 1])
def test_transductive_gat_rows_match_jax(same_init, jax_tools, monkeypatch, epochs):
    """GAT's rows. At 0 epochs (the protocol over the shared initial
    weights) every row in full. At 1 epoch the thresholded metrics and
    onset recall equal, and GraphSAGE's rows in full: GAT already parts
    within its first epoch on this mesh (params by up to 0.1 in a_dst_1r,
    logits by 0.03: ELU's grad at large negative pre-activations, see the
    module docstring), which moves its ROC-AUC by 9e-4 (a ranked pair or
    two) and its latency MAE by 2%."""
    argv = [*SMALL, "--epochs", str(epochs), "--seed", "0"]
    want = _jax_main_rows(jax_tools, monkeypatch, argv)
    got = _port_main_rows(monkeypatch, argv)
    _assert_rows_match(got, want, lambda name: "thresholded" if epochs and name.startswith("GAT") else "all")


@pytest.mark.parametrize("seed", [0, 1])
def test_inductive_protocol_matches_jax(same_init, jax_tools, monkeypatch, seed):
    """Every row of the held-out-endpoint protocol; seed 0's held-out
    endpoints see no anomaly in the held-out slots (the AUCs are nan on
    both sides), seed 1's see 8."""
    argv = [*SMALL, "--epochs", "3", "--seed", str(seed), "--inductive"]
    want = _jax_main_rows(jax_tools, monkeypatch, argv)
    got = _port_main_rows(monkeypatch, argv)
    _assert_rows_match(got, want, lambda name: True)
    assert (got[0][1].anomaly_base_rate > 0) == bool(seed)


def test_inductive_checkpoint_restores_the_trained_params(tmp_path):
    """The with-history head's checkpoint holds its trained params and a
    fresh AdamW state of their shapes, so the forecast handler's restore
    (models/checkpoint.py) takes it."""
    args = eml.build_parser().parse_args(
        [*SMALL, "--epochs", "2", "--inductive", "--checkpoint-dir", str(tmp_path), "--device", "cpu"]
    )
    result = eml.simulate(eml.make_mesh_config(6, 3, 2, np.random.default_rng(0)), 0)
    heads = []
    eml.inductive_eval(args, result, on_head=lambda *head: heads.append(head))
    assert [h[0] for h in heads] == ["GraphSAGE (with history features)", "GraphSAGE (ablation: base features)"]
    trained = heads[0][2].params
    params, meta = checkpoint.restore_params(str(tmp_path), graphsage, device="cpu")
    assert meta["step"] == 2 and meta["model"] == "graphsage" and meta["num_nodes"] == 0
    assert meta["num_features"] == trained.w_self_1.shape[0] == 18
    for field, a, b in zip(params._fields, params, trained):
        assert (a is None) == (b is None), field
        if a is not None:
            assert torch.equal(a, b), field
    restored = checkpoint.restore_checkpoint(str(tmp_path), params, graphsage.make_optimizer(0.01).init(params))
    assert restored is not None and int(restored[1].count) == 0


@pytest.mark.parametrize("epochs", [0, 1])
def test_eval_models_prints_the_jax_table(same_init, jax_tools, monkeypatch, capsys, epochs):
    """eval_models' held-out line and table, line for line, but GAT's
    latency MAE cell: within the losses' tolerance over the initial
    weights, not held at 1 epoch (GAT parts within its first epoch, see
    test_transductive_gat_rows_match_jax)."""
    argv = ["--epochs", str(epochs), "--hidden", "8"]
    monkeypatch.setattr(sys, "argv", ["eval_models.py", *argv])
    jax_tools.eval_models.main()
    want = capsys.readouterr().out.splitlines()
    assert eval_models.main([*argv, "--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 10 and got[-1].startswith("| naive: flag everything |")
    for a, b in zip(got, want):
        if a.startswith("| GAT |"):
            (a, mae), (b, want_mae) = a.rsplit("|", 2)[:2], b.rsplit("|", 2)[:2]
            if not epochs:  # untrained: a 4e17 ms MAE, printed to 20 digits
                np.testing.assert_allclose(float(mae), float(want_mae), **LOSS_TOL)
        assert a == b


# -- eval_stlgt ----------------------------------------------------------------------


def _from_jax(model, jax_model):
    """An init_params of the port's `model` that draws `jax_model`'s
    weights for the generator's seed."""

    def init(generator, hidden=32, num_features=10, num_nodes=0, device=None):
        jp = jax_model.init_params(
            jax.random.PRNGKey(int(generator.initial_seed())), hidden=hidden, num_features=num_features
        )
        return checkpoint.params_from_numpy(model, _numpy(jp), device=device)

    return init


STLGT_KW = dict(ticks=12, hidden=8, epochs=2, depth=4, warmup=2)


@pytest.fixture(scope="module")
def stlgt_runs(jax_tools):
    """(port result, JAX result, the port's refresh reports) of the replay
    at 12 ticks, both heads from JAX's weights."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(stlgt, "init_params", _from_jax(stlgt, jax_stlgt))
        mp.setattr(graphsage, "init_params", _from_jax(graphsage, jax_sage))
        want = jax_tools.eval_stlgt.evaluate(**STLGT_KW)
        refreshes = []
        got = eval_stlgt.evaluate(device="cpu", refreshes=refreshes, **STLGT_KW)
    return got, want, refreshes


def test_eval_stlgt_replays_the_jax_stream(stlgt_runs):
    got, want, refreshes = stlgt_runs
    assert set(got) == set(want)
    for key in ("scenario", "endpoints", "edges", "ticks", "scored_ticks", "fault_ticks"):
        assert got[key] == want[key], key
    assert got["scored_ticks"] > 0 and got["fault_ticks"] > 0
    status, ref_status = got["trainer"], want["trainer"]
    assert status == ref_status | {"lastLoss": status["lastLoss"]}
    np.testing.assert_allclose(status["lastLoss"], ref_status["lastLoss"], rtol=1e-3)
    # one refresh a fold after the first, each over its stale slots
    assert len(refreshes) == status["refreshes"] == STLGT_KW["ticks"] - 1
    assert all(r["ok"] and 1 <= r["stale_slots"] <= STLGT_KW["depth"] for r in refreshes)


def test_eval_stlgt_scores_match_jax(stlgt_runs):
    """Coverages and attribution rates equal to the JAX tool's: the two
    heads' forecasts agree within float rounding, and no (endpoint, tick)
    outcome lies that close to a forecast, so every outcome counts alike
    (the looser bound, one outcome's share, is not needed here)."""
    got, want, _ = stlgt_runs
    for key in (
        "stlgt_p50_coverage", "stlgt_p95_coverage", "stlgt_p99_coverage", "sage_p99_coverage",
        "attribution_hit_rate", "attribution_base_rate", "stlgt_beats_baseline",
    ):
        assert got[key] == want[key], key


def test_eval_stlgt_main_prints_the_jax_line_and_exits_with_the_gate(stlgt_runs, capsys):
    code = eval_stlgt.main(["--ticks", "12", "--epochs", "2", "--hidden", "8", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    doc = json.loads(lines[-2])
    assert set(doc) == set(stlgt_runs[1]) - {"trainer"}
    assert code == (0 if doc["stlgt_beats_baseline"] else 1)
    assert lines[-1].startswith("PASS: " if code == 0 else "FAIL: ")
    assert lines[:2] == ["| metric | value |", "|---|---|"]
    assert lines[2] == f"| scenario | {doc['scenario']} |"


# -- the device ----------------------------------------------------------------------


@pytest.mark.parametrize("argv", [[], ["--device", "cuda"]])
@pytest.mark.parametrize("tool", [eval_models, eml, eval_stlgt], ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_entry_point_raises_without_a_card(monkeypatch, tool, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        tool.main(argv)

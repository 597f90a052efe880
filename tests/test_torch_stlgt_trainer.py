"""The STLGT continual trainer of the port on the CPU against the JAX
package: ring bookkeeping, refreshes, the select-merge, failure
containment, and the served surface (the quantile/horizon forecast and
GET /model/stlgt).

Both trainers start from the same weights (JAX's init_params for the
seed, handed to the port). Ring contents, labels, node masks and stale
flags are bit-exact; params after each refresh agree within rtol 1e-3 /
atol 1e-5 (float32 sums in other orders over two epochs of AdamW); a
refresh with no stale slot leaves the params bit-identical; the served
payloads agree within one unit of the route's rounding plus rtol 1e-4.
"""
from __future__ import annotations

import json
import urllib.request

import jax
import numpy as np
import pytest
import torch

from conftest import prefixed_trace_source
from kmamiz_tpu.models.stlgt import model as jax_stlgt
from kmamiz_tpu.models.stlgt.trainer import ContinualTrainer as JaxTrainer
from kmamiz_tpu_torch.models import checkpoint
from kmamiz_tpu_torch.models import stlgt as stlgt_pkg
from kmamiz_tpu_torch.models.stlgt import model as stlgt
from kmamiz_tpu_torch.models.stlgt.trainer import ContinualTrainer

PARAM_TOL = dict(rtol=1e-3, atol=1e-5)
H = 3_600_000


@pytest.fixture(autouse=True)
def _fresh_port_trainer():
    stlgt_pkg.reset_for_tests()
    yield
    stlgt_pkg.reset_for_tests()


@pytest.fixture
def jax_init(monkeypatch):
    """The port's STLGT init_params draws JAX's weights for the seed."""

    def init(generator, hidden=32, num_features=10, num_nodes=0, device=None):
        jp = jax_stlgt.init_params(
            jax.random.PRNGKey(int(generator.initial_seed())), hidden=hidden, num_features=num_features
        )
        arrays = {k: np.asarray(v) for k, v in jp._asdict().items()}
        return checkpoint.params_from_numpy(stlgt, arrays, device=device)

    monkeypatch.setattr(stlgt, "init_params", init)


def _graph(n, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, 2 * n).astype(np.int32)
    dst = rng.integers(0, n, 2 * n).astype(np.int32)
    mask = rng.random(2 * n) < 0.85
    return src, dst, mask


def _snap(feats, edges, hour, version=1):
    src, dst, mask = edges
    return {
        "features": feats,
        "src": src,
        "dst": dst,
        "mask": mask,
        "names": [f"svc\tns\tv1\tGET\t/api/e{i}" for i in range(feats.shape[0])],
        "predicted_hour": (hour + 1) % 24,
        "cache_key": (version, 0, hour),
    }


def _folds():
    """A fold sequence: two dirty folds, a quiet one (the same rows), one
    where endpoints appear (and the edge list grows), a version bump on
    the same rows, and one where a single row changes."""
    rng = np.random.default_rng(0)

    def feats(n):
        f = (rng.random((n, 10)) * 0.5).astype(np.float32)
        f[:, 7] = (rng.random(n) < 0.9).astype(np.float32)  # active column
        f[:, 2] = (rng.random(n) * 0.3).astype(np.float32)  # 5xx share: some labels 1
        f[:, 9] = 1.0  # a real row always carries the hour's cos column
        return f

    f0, f1 = feats(6), feats(6)
    f3 = feats(9)
    f5 = f3.copy()
    f5[2, 3] += 0.25
    g6, g9 = _graph(6, 1), _graph(9, 2)
    return [
        _snap(f0, g6, 0),
        _snap(f1, g6, 1),
        _snap(f1.copy(), g6, 2),
        _snap(f3, g9, 3),
        _snap(f3.copy(), g9, 4, version=2),
        _snap(f5, g9, 5, version=2),
    ]


def _assert_same_ring(port, ref):
    assert len(port._ring) == len(ref._ring)
    for a, b in zip(port._ring, ref._ring):
        assert set(a) == set(b)
        for key in a:
            x, y = np.asarray(a[key]), np.asarray(b[key])
            assert x.dtype == y.dtype, key
            np.testing.assert_array_equal(x, y, err_msg=key)
    assert [bool(s) for s in port._stale] == [bool(s) for s in ref._stale]
    pending_a, pending_b = port._pending, ref._pending
    for key in ("features", "src", "dst", "mask"):
        np.testing.assert_array_equal(pending_a[key], pending_b[key])
    assert pending_a["version"] == pending_b["version"]


def test_ring_bookkeeping_is_bit_exact():
    """refresh_every large: after the first refresh the ring only grows and
    goes stale, fold by fold, as the reference's."""
    port = ContinualTrainer(depth=4, refresh_every=100, epochs=1, hidden=8, device="cpu")
    ref = JaxTrainer(depth=4, refresh_every=100, epochs=1, hidden=8)
    stale_counts = []
    for snap in _folds():
        port.observe_fold(snap)
        ref.observe_fold(snap)
        _assert_same_ring(port, ref)
        ps, rs = port.status(), ref.status()
        assert ps == rs | {"lastLoss": ps["lastLoss"]}
        stale_counts.append(ps["staleSlots"])
    # first example refreshed; the quiet fold marks only its new slot; the
    # grown fold dirties every slot; the version bump marks everything;
    # the depth-4 ring dropped its oldest example
    assert stale_counts == [0, 0, 1, 3, 4, 4]
    assert port.status()["examples"] == 4


def _leaves_close(port_params, ref_params, **tol):
    for name, a, b in zip(port_params._fields, port_params, ref_params):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **tol)


def test_refreshes_match_jax(jax_init):
    port = ContinualTrainer(depth=4, refresh_every=1, epochs=2, hidden=8, lr=0.05, device="cpu")
    ref = JaxTrainer(depth=4, refresh_every=1, epochs=2, hidden=8, lr=0.05)
    refreshes = 0
    for snap in _folds():
        got = port.observe_fold(snap)
        want = ref.observe_fold(snap)
        assert (got is None) == (want is None)
        _assert_same_ring(port, ref)
        if got is None:
            continue
        refreshes += 1
        assert got["ok"] and want["ok"], (got, want)
        assert {k: got[k] for k in ("slots", "stale_slots", "bucket", "version")} == {
            k: want[k] for k in ("slots", "stale_slots", "bucket", "version")
        }
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4, atol=1e-6)
        _leaves_close(port._params, ref._params, **PARAM_TOL)
    assert refreshes == 5
    assert port.serving()["version"] == ref.serving()["version"] == 5


def test_zero_stale_refresh_is_a_bit_exact_noop():
    """AdamW with zero grads is not a no-op (decay and the moments still
    move), so a refresh without stale slots must skip every update, the
    step count included."""
    t = ContinualTrainer(depth=4, epochs=2, hidden=8, device="cpu")
    folds = _folds()
    t.observe_fold(folds[0])
    t.observe_fold(folds[1])
    before = [p.clone() for p in t._params]
    count = t._opt_state.count.clone()
    t._stale = [False] * len(t._ring)
    report = t.refresh()
    assert report["ok"] and report["stale_slots"] == 0 and report["loss"] == 0.0
    for a, b in zip(before, t._params):
        assert torch.equal(a, b)
    assert torch.equal(count, t._opt_state.count)
    # the counter-check: the same refresh with its slot stale trains
    t._stale = [True] * len(t._ring)
    assert t.refresh()["ok"]
    assert any(not torch.equal(a, b) for a, b in zip(before, t._params))
    assert int(t._opt_state.count) == int(count) + 2  # 2 epochs x 1 slot


def test_failure_keeps_last_good_serving(monkeypatch):
    t = ContinualTrainer(depth=4, epochs=1, hidden=8, device="cpu")
    folds = _folds()
    t.observe_fold(folds[0])
    assert t.observe_fold(folds[1])["ok"]
    live = t.serving()

    def boom():
        raise RuntimeError("device fell over")

    monkeypatch.setattr(t, "_run_epoch_block_locked", boom)
    report = t.observe_fold(folds[2])
    assert report is not None and not report["ok"]
    assert "device fell over" in report["error"]
    status = t.status()
    assert status["refreshFailures"] == 1
    assert status["paramsVersion"] == 1
    assert status["stalenessTicks"] == 1
    assert t.serving()["params"] is live["params"]


def test_ring_grows_its_buckets_and_repads():
    """An example uploaded at a smaller bucket is re-padded when the ring's
    buckets grow (N 6 -> 9 rows: bucket 8 -> 16)."""
    t = ContinualTrainer(depth=8, refresh_every=1, epochs=1, hidden=8, device="cpu")
    for snap in _folds()[:5]:
        t.observe_fold(snap)
    assert {slot["buckets"] for slot in t._slots} == {(16, 32)}
    assert t.status()["refreshFailures"] == 0


def test_hook_counts_contained_failures(monkeypatch, pdas_traces):
    """The processor's fold hook swallows a trainer failure (the fold goes
    on) and counts it."""
    from kmamiz_tpu_torch.models.stlgt import trainer as port_trainer
    from kmamiz_tpu_torch.server.processor import DataProcessor

    monkeypatch.setenv("KMAMIZ_STLGT", "1")

    def boom(snap, device=None):
        raise RuntimeError("hook fell over")

    monkeypatch.setattr(port_trainer, "on_fold", boom)
    monkeypatch.setattr(stlgt_pkg, "on_fold", boom)
    dp = DataProcessor(trace_source=prefixed_trace_source(pdas_traces, "hk"), device="cpu")
    for i, hour in enumerate((960, 961)):
        dp.collect({"uniqueId": f"hk{i}", "lookBack": 30_000, "time": hour * H})
    assert dp.forecast_snapshot is not None
    assert dp.fold_errors["stlgtFoldErrors"] == 1


@pytest.fixture
def stlgt_env(monkeypatch):
    monkeypatch.setenv("KMAMIZ_STLGT", "1")
    monkeypatch.setenv("KMAMIZ_STLGT_HIDDEN", "8")
    monkeypatch.setenv("KMAMIZ_STLGT_EPOCHS", "1")
    monkeypatch.setenv("KMAMIZ_STLGT_HISTORY", "2")
    from kmamiz_tpu.models import stlgt as jax_stlgt_pkg

    jax_stlgt_pkg.reset_for_tests()
    stlgt_pkg.reset_for_tests()
    yield


def _routers(pdas_traces):
    """A JAX and a port processor fed the same ticks over three hours, and
    their routers with no checkpoint (STLGT-live serves alone)."""
    from test_stlgt import _stlgt_ctx

    from kmamiz_tpu_torch.api.app import build_router
    from kmamiz_tpu_torch.config import Settings
    from kmamiz_tpu_torch.server.initializer import AppContext
    from kmamiz_tpu_torch.server.processor import DataProcessor

    jax_dp, jax_router = _stlgt_ctx(pdas_traces, "sr")
    port_dp = DataProcessor(trace_source=prefixed_trace_source(pdas_traces, "sr"), device="cpu")
    settings = Settings()
    settings.model_dir = ""
    port_router = build_router(AppContext(settings=settings, processor=port_dp))
    for dp in (jax_dp, port_dp):
        for i in range(3):
            dp.collect({"uniqueId": f"q{i}", "lookBack": 30_000, "time": (930 + i) * H})
    return jax_dp, jax_router, port_dp, port_router


def _close(got, want, unit):
    return abs(got - want) <= unit + 1e-4 * abs(want) + 1e-9


@pytest.mark.parametrize("query", ["", "?quantile=p99&horizon=3", "?horizon=9"])
def test_stlgt_forecast_route_matches_jax(pdas_traces, stlgt_env, jax_init, query):
    _, jax_router, port_dp, port_router = _routers(pdas_traces)
    want = jax_router.dispatch("GET", f"/api/v1/model/forecast{query}")
    got = port_router.dispatch("GET", f"/api/v1/model/forecast{query}")
    assert got.status == want.status == 200, (got.payload, want.payload)
    g, w = got.payload, want.payload
    assert set(g) == set(w) and g["model"] == w["model"] == "stlgt-live"
    assert g["predictedHour"] == w["predictedHour"]
    gs, ws = g["stlgt"], w["stlgt"]
    assert set(gs) == set(ws)
    for key in ("paramsVersion", "quantile", "horizon", "quantileLevels"):
        assert gs[key] == ws[key], key
    w_rows = {r["uniqueEndpointName"]: r for r in ws["endpoints"]}
    assert len(gs["endpoints"]) == len(w_rows)
    for r in gs["endpoints"]:
        wr = w_rows[r["uniqueEndpointName"]]
        assert _close(r["anomalyProbability"], wr["anomalyProbability"], 1e-4)
        assert set(r["latencyQuantilesMs"]) == set(wr["latencyQuantilesMs"])
        for level, ms in r["latencyQuantilesMs"].items():
            assert _close(ms, wr["latencyQuantilesMs"][level], 0.01), (level, ms)
    key = lambda a: (a["source"], a["target"])  # noqa: E731
    g_att = sorted(gs["attributions"], key=key)
    w_att = sorted(ws["attributions"], key=key)
    assert [key(a) for a in g_att] == [key(a) for a in w_att]
    for a, b in zip(g_att, w_att):
        assert _close(a["score"], b["score"], 1e-4)
    w_legacy = {r["uniqueEndpointName"]: r for r in w["endpoints"]}
    for r in g["endpoints"]:
        assert _close(r["predictedLatencyMs"], w_legacy[r["uniqueEndpointName"]]["predictedLatencyMs"], 0.01)
    # memoized per snapshot and params version: a second GET is the same
    # payload, from the memo
    again = port_router.dispatch("GET", f"/api/v1/model/forecast{query}")
    assert again.raw_body == got.raw_body


def test_stlgt_status_route_matches_jax(pdas_traces, stlgt_env, jax_init):
    from kmamiz_tpu.models.stlgt import trainer as jax_trainer

    from kmamiz_tpu_torch.server.dp_server import DataProcessorServer

    _, _, port_dp, _ = _routers(pdas_traces)
    server = DataProcessorServer(port_dp, host="127.0.0.1", port=0)
    server.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/model/stlgt", timeout=30) as r:
            got = json.loads(r.read())
    finally:
        server.stop()
    want = jax_trainer.trainer_status()
    assert set(got) == set(want)
    assert got["refreshes"] >= 1 and got["refreshFailures"] == 0 and got["enabled"] is True
    np.testing.assert_allclose(got.pop("lastLoss"), want.pop("lastLoss"), rtol=1e-3)
    assert got == want


def test_replica_replays_the_next_fold():
    """A replica on another device (here the CPU again) takes the next fold
    to the same ring and the same params, bit for bit on one device."""
    t = ContinualTrainer(depth=4, refresh_every=1, epochs=2, hidden=8, device="cpu")
    folds = _folds()
    for snap in folds[:3]:
        t.observe_fold(snap)
    twin = t.replica("cpu")
    assert t.observe_fold(folds[3])["ok"] and twin.observe_fold(folds[3])["ok"]
    assert twin.status() == t.status()
    for a, b in zip(t._params, twin._params):
        assert torch.equal(a, b)

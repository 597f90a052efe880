"""The forecast path of the port on the CPU against the JAX package: the
processor's hourly history feed and forecast snapshot, the GraphSAGE
forecast route with the model10k weights, and the STLGT quantile forward.

Both processors take the pdas traces (fresh trace ids per tick) at
request times in given hours. Snapshot features agree within atol 1e-6
(float64 host sums, float32 columns); names, predicted hour and the edge
set are equal. The route is compared per endpoint name, because the order
of near-ties may differ: the forward's raw outputs within rtol 1e-5, the
payload within one unit of the route's rounding (probability 1e-4,
latency 0.01 ms).
"""
from __future__ import annotations

import gzip
import json
import os
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import prefixed_trace_source
from kmamiz_tpu.server.processor import DataProcessor as JaxProcessor
from kmamiz_tpu_torch.api.app import build_router
from kmamiz_tpu_torch.api.router import ApiServer
from kmamiz_tpu_torch.config import Settings
from kmamiz_tpu_torch.models import checkpoint, graphsage, serving
from kmamiz_tpu_torch.models import stlgt as stlgt_pkg
from kmamiz_tpu_torch.models.stlgt import model as stlgt
from kmamiz_tpu_torch.models.stlgt import serving as stlgt_serving
from kmamiz_tpu_torch.server.initializer import AppContext
from kmamiz_tpu_torch.server.processor import DataProcessor

H = 3_600_000
FIXTURES = Path(__file__).resolve().parent / "fixtures"
MODEL_DIR = str(FIXTURES / "model10k_torch")


def _drive(proc, hours):
    for i, hour in enumerate(hours):
        proc.collect({"uniqueId": f"t{i}", "lookBack": 30_000, "time": hour * H + 1000 * i})


def _pair(pdas_traces, hours):
    jax_dp = JaxProcessor(
        trace_source=prefixed_trace_source(pdas_traces, "d"), use_device_stats=False
    )
    port_dp = DataProcessor(
        trace_source=prefixed_trace_source(pdas_traces, "d"), device="cpu"
    )
    _drive(jax_dp, hours)
    _drive(port_dp, hours)
    return jax_dp, port_dp


def _edge_multiset(snap):
    names = snap["names"]
    src, dst, mask = (np.asarray(snap[k]) for k in ("src", "dst", "mask"))
    live = np.nonzero(mask.astype(bool))[0]
    return Counter((names[src[i]], names[dst[i]]) for i in live)


def _assert_same_snapshot(got, want):
    assert got["names"] == want["names"]
    assert got["predicted_hour"] == want["predicted_hour"]
    assert got["features"].dtype == np.float32
    assert got["features"].shape == want["features"].shape
    np.testing.assert_allclose(got["features"], np.asarray(want["features"]), rtol=0, atol=1e-6)
    assert _edge_multiset(got) == _edge_multiset(want)
    for k in ("src", "dst", "mask"):
        assert isinstance(got[k], np.ndarray), k  # host copies, never device tensors


@pytest.mark.parametrize(
    "hours",
    [
        [910, 911],
        [910, 911, 912],
        [910, 914],  # quiet hours fold as zero-activity buckets
        [910, 909, 911],  # a clock behind the bucket accumulates into it
        [900, 960],  # past the catch-up bound of 48 quiet hours
    ],
)
def test_snapshot_matches_jax(pdas_traces, hours):
    jax_dp, port_dp = _pair(pdas_traces, hours)
    assert port_dp.forecast_snapshot is not None
    _assert_same_snapshot(port_dp.forecast_snapshot, jax_dp.forecast_snapshot)
    np.testing.assert_array_equal(port_dp.history_features, jax_dp.history_features)
    assert port_dp.history.to_doc() == jax_dp.history.to_doc()
    # the last fold is of the hour before the last tick's
    assert port_dp.forecast_snapshot["predicted_hour"] == ((hours[-1] - 1) % 24 + 1) % 24
    assert port_dp.forecast_snapshot["features"].shape[1] == 18
    key = port_dp.forecast_snapshot["cache_key"]
    assert key[0] == port_dp.graph.version and key[1] == 0


def test_no_snapshot_before_an_hour_completes(pdas_traces):
    port_dp = DataProcessor(trace_source=prefixed_trace_source(pdas_traces, "d"), device="cpu")
    _drive(port_dp, [910, 910])
    assert port_dp.forecast_snapshot is None
    assert port_dp.last_stage_ms["history"] >= 0.0


def _port_router(proc, model_dir=MODEL_DIR):
    settings = Settings()
    settings.model_dir = model_dir
    return build_router(AppContext(settings=settings, processor=proc))


def _jax_router(proc):
    from kmamiz_tpu.api.app import build_router as jax_build_router
    from kmamiz_tpu.config import Settings as JaxSettings
    from kmamiz_tpu.server.initializer import AppContext as JaxContext
    from kmamiz_tpu.server.initializer import Initializer
    from kmamiz_tpu.server.storage import MemoryStore

    settings = JaxSettings()
    settings.external_data_processor = ""
    settings.model_dir = str(FIXTURES / "model10k")
    ctx = JaxContext.build(app_settings=settings, store=MemoryStore(), processor=proc)
    Initializer(ctx).register_data_caches()
    return jax_build_router(ctx)


def test_forecast_route_matches_jax(pdas_traces):
    jax_dp, port_dp = _pair(pdas_traces, [910, 911])
    want = _jax_router(jax_dp).dispatch("GET", "/api/v1/model/forecast")
    got = _port_router(port_dp).dispatch("GET", "/api/v1/model/forecast")
    assert got.status == want.status == 200
    g, w = got.payload, want.payload
    assert g["predictedHour"] == w["predictedHour"] == (910 % 24 + 1) % 24
    assert g["model"] == w["model"] == "graphsage"
    g_idx = {e["uniqueEndpointName"]: e for e in g["endpoints"]}
    w_idx = {e["uniqueEndpointName"]: e for e in w["endpoints"]}
    assert len(g_idx) == len(g["endpoints"]) and set(g_idx) == set(w_idx)
    for name, we in w_idx.items():
        ge = g_idx[name]
        assert abs(ge["anomalyProbability"] - we["anomalyProbability"]) <= 1e-4 + 1e-9, name
        assert abs(ge["predictedLatencyMs"] - we["predictedLatencyMs"]) <= 0.01 + 1e-9, name
    assert json.loads(got.raw_body) == g and gzip.decompress(got.raw_gzip) == got.raw_body


def test_forecast_forward_matches_jax(pdas_traces):
    from kmamiz_tpu.models import graphsage as jax_sage
    from kmamiz_tpu.models import serving as jax_serving
    from test_torch_checkpoint import restore_orbax
    import jax.numpy as jnp

    jax_dp, port_dp = _pair(pdas_traces, [910, 911])
    arrays, _ = restore_orbax(FIXTURES / "model10k", 60)
    jp = jax_sage.SageParams(**{k: None if v is None else jnp.asarray(v) for k, v in arrays.items()})
    js = jax_dp.forecast_snapshot
    want_lat, want_prob = jax_serving.forecast_forward(
        jp, js["features"], js["src"], js["dst"], js["mask"], jax_sage
    )
    params, _ = checkpoint.restore_params(MODEL_DIR, graphsage, device="cpu")
    ps = port_dp.forecast_snapshot
    lat, prob = serving.forecast_forward(params, ps["features"], ps["src"], ps["dst"], ps["mask"], graphsage)
    assert lat.shape == prob.shape == (len(ps["names"]),)
    np.testing.assert_allclose(lat, want_lat, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(prob, want_prob, rtol=1e-5, atol=1e-5)
    from kmamiz_tpu_torch.core.spans import _pad_size

    assert serving.serve_stats()["last_bucket"] == [_pad_size(len(lat)), _pad_size(len(ps["src"]))]


def test_quantile_forward_matches_jax(pdas_traces):
    import jax
    import jax.numpy as jnp
    from kmamiz_tpu.models.stlgt import model as jax_stlgt
    from kmamiz_tpu.models.stlgt import serving as jax_stlgt_serving

    jax_dp, port_dp = _pair(pdas_traces, [910, 911])
    jp = jax_stlgt.init_params(jax.random.PRNGKey(11), hidden=32, num_features=18)
    arrays = {k: np.asarray(v) for k, v in jp._asdict().items()}
    js, ps = jax_dp.forecast_snapshot, port_dp.forecast_snapshot
    want = jax_stlgt_serving.quantile_forward(
        jp, js["features"], js["src"], js["dst"], js["mask"], jax_stlgt
    )
    params = checkpoint.params_from_numpy(stlgt, arrays, device="cpu")
    got = stlgt_serving.quantile_forward(
        params, ps["features"], ps["src"], ps["dst"], ps["mask"], stlgt
    )
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-5)

    def gates_by_name(snap, gate):
        # the two stores pad their edge columns to different capacities,
        # so live edges are matched by endpoint names
        names, mask = snap["names"], np.asarray(snap["mask"], dtype=bool)
        src, dst = np.asarray(snap["src"]), np.asarray(snap["dst"])
        return {(names[src[i]], names[dst[i]]): float(gate[i]) for i in np.nonzero(mask)[0]}

    g_gates, w_gates = gates_by_name(ps, got[2]), gates_by_name(js, np.asarray(want[2]))
    assert g_gates.keys() == w_gates.keys()
    for key, w in w_gates.items():
        assert g_gates[key] == pytest.approx(w, rel=1e-5, abs=1e-5), key
    q_ms, prob, gate = got
    assert q_ms.shape == (len(ps["names"]), 3) and gate.shape == ps["src"].shape
    assert np.all(np.diff(q_ms, axis=1) >= 0)
    assert np.all((gate >= 0) & (gate <= 1)) and np.all(gate[~ps["mask"]] == 0)


def test_forecast_is_memoized_per_fold(pdas_traces):
    port_dp = DataProcessor(trace_source=prefixed_trace_source(pdas_traces, "d"), device="cpu")
    router = _port_router(port_dp)
    status = router.dispatch("GET", "/api/v1/model/status").payload
    assert status["modelLoaded"] is True and status["featureHourReady"] is False
    assert status["checkpoint"]["numFeatures"] == 18
    assert router.dispatch("GET", "/api/v1/model/forecast").status == 503  # no fold yet
    _drive(port_dp, [910, 911])
    calls = serving.serve_stats()["calls"]
    fc = router.dispatch("GET", "/api/v1/model/forecast").payload
    assert serving.serve_stats()["calls"] == calls + 1
    assert router.dispatch("GET", "/api/v1/model/forecast").payload is fc
    assert serving.serve_stats()["calls"] == calls + 1
    port_dp.collect({"uniqueId": "c", "lookBack": 30_000, "time": 912 * H})
    fc3 = router.dispatch("GET", "/api/v1/model/forecast").payload
    assert fc3 is not fc and fc3["predictedHour"] == (911 % 24 + 1) % 24
    status = router.dispatch("GET", "/api/v1/model/status").payload
    assert status["featureHourReady"] and status["numEndpoints"] == len(fc3["endpoints"])


@pytest.mark.parametrize(
    "query,status,needle",
    [
        ("?quantile=p77", 400, "unknown quantile"),
        ("?horizon=25", 400, "KMAMIZ_STLGT_HORIZON_MAX=24"),
        ("?quantile=p95", 503, "STLGT"),
        ("?horizon=2", 503, "STLGT"),
    ],
)
def test_quantile_and_horizon_rules_match_jax(pdas_traces, query, status, needle):
    jax_dp, port_dp = _pair(pdas_traces, [910, 911])
    got = _port_router(port_dp).dispatch("GET", "/api/v1/model/forecast" + query)
    want = _jax_router(jax_dp).dispatch("GET", "/api/v1/model/forecast" + query)
    assert got.status == want.status == status
    assert needle in got.payload["error"]
    assert got.payload == want.payload


def test_horizon_max_reads_the_environment(monkeypatch):
    assert stlgt_pkg.horizon_max() == 24
    monkeypatch.setenv("KMAMIZ_STLGT_HORIZON_MAX", "3")
    assert stlgt_pkg.horizon_max() == 3
    monkeypatch.setenv("KMAMIZ_STLGT_HORIZON_MAX", "x")
    assert stlgt_pkg.horizon_max() == 24
    assert stlgt_pkg.serving_params() is None


def _checkpoint_dir(tmp_path, **meta):
    params = graphsage.init_params(
        torch.Generator().manual_seed(0), hidden=8, num_features=18, device="cpu"
    )
    checkpoint.save_params(str(tmp_path), params, 1, {"hidden": 8, "num_features": 18, **meta})
    return str(tmp_path)


@pytest.mark.parametrize(
    "meta,needle",
    # a sidecar naming GAT over GraphSAGE arrays: GAT checkpoints serve
    # (tests/test_torch_gat.py), a mismatched one is refused
    [({"model": "gat"}, "GatParams has no fields"), ({"model": "graphsage", "num_nodes": 5}, "node-identity")],
)
def test_terminal_load_errors(tmp_path, meta, needle):
    proc = DataProcessor(trace_source=lambda lb, t, lim: [], device="cpu")
    router = _port_router(proc, _checkpoint_dir(tmp_path, **meta))
    resp = router.dispatch("GET", "/api/v1/model/forecast")
    assert resp.status == 503 and needle in resp.payload["error"]
    status = router.dispatch("GET", "/api/v1/model/status").payload
    assert status["modelLoaded"] is False and needle in status["error"]


def test_missing_model_dir_and_transient_errors(tmp_path, monkeypatch):
    proc = DataProcessor(trace_source=lambda lb, t, lim: [], device="cpu")
    resp = _port_router(proc, "").dispatch("GET", "/api/v1/model/forecast")
    assert resp.status == 503 and resp.payload["error"] == "KMAMIZ_MODEL_DIR not configured"
    empty = tmp_path / "ckpt"
    router = _port_router(proc, str(empty))
    resp = router.dispatch("GET", "/api/v1/model/status").payload
    assert resp["modelLoaded"] is False and "no complete checkpoint" in resp["error"]
    # a checkpoint written later loads once the retry delay has passed
    _checkpoint_dir(empty, model="graphsage")
    from kmamiz_tpu_torch.api.handlers import model as model_handler

    monkeypatch.setattr(model_handler.ModelHandler, "RETRY_SECONDS", 0.0)
    router = _port_router(proc, str(tmp_path / "other"))
    assert router.dispatch("GET", "/api/v1/model/status").payload["modelLoaded"] is False
    _checkpoint_dir(tmp_path / "other", model="graphsage")
    assert router.dispatch("GET", "/api/v1/model/status").payload["modelLoaded"] is True


def test_feature_width_mismatch_is_409(tmp_path, pdas_traces):
    params = graphsage.init_params(torch.Generator().manual_seed(0), hidden=8, num_features=10, device="cpu")
    checkpoint.save_params(str(tmp_path), params, 1, {"model": "graphsage", "hidden": 8, "num_features": 10})
    port_dp = DataProcessor(trace_source=prefixed_trace_source(pdas_traces, "d"), device="cpu")
    _drive(port_dp, [910, 911])
    resp = _port_router(port_dp, str(tmp_path)).dispatch("GET", "/api/v1/model/forecast")
    assert resp.status == 409 and "feature width 18" in resp.payload["error"]


def test_api_server_serves_the_forecast_over_http(pdas_traces):
    import urllib.request

    port_dp = DataProcessor(trace_source=prefixed_trace_source(pdas_traces, "d"), device="cpu")
    _drive(port_dp, [910, 911])
    server = ApiServer(_port_router(port_dp), host="127.0.0.1", port=0)
    server.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/api/v1/model/forecast",
            headers={"Accept-Encoding": "gzip"},
        )
        with urllib.request.urlopen(req, timeout=60) as resp:
            body = resp.read()
            if resp.headers.get("Content-Encoding") == "gzip":
                body = gzip.decompress(body)
            assert resp.status == 200
        fc = json.loads(body)
        assert fc["predictedHour"] == (910 % 24 + 1) % 24
        assert len(fc["endpoints"]) == len(port_dp.forecast_snapshot["names"])
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"http://127.0.0.1:{server.port}/api/v1/nope", timeout=60)
        assert err.value.code == 404
    finally:
        server.stop()

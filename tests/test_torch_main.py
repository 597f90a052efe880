"""The wiring of the port's two `main()`s, on the CPU.

`python -m kmamiz_tpu_torch.server.dp_server` runs dp_server.main(),
which assembles the DP from the environment through
`dp_server.build_server`; `python -m kmamiz_tpu_torch.api.app` runs
app.main(), which assembles the application through
`app.build_production_context`. Both builders take the port's explicit
`device`: here they run with device="cpu" on scratch ports against a
mock Zipkin and a mock kube API (tests/test_torch_kubernetes.py's mock
cluster), and each main() without a card raises before it serves.
The environment's switches are taken at both of their settings
(IS_RUNNING_IN_K8S, KUBERNETES_SERVICE_HOST/_PORT, KMAMIZ_WAL, LOG_LEVEL).
"""
from __future__ import annotations

import json
import logging
import os
import shutil
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import pytest
import torch

from kmamiz_tpu_torch.config import Settings
from kmamiz_tpu_torch.graph.store import graph_signature
from kmamiz_tpu_torch.ingestion import kubernetes
from kmamiz_tpu_torch.resilience import metrics
from test_torch_kubernetes import MockCluster, _base, _MockApi, _Server, _windows

REPO = Path(__file__).resolve().parent.parent
NEVER_CRON = "0 0 1 1 *"


@pytest.fixture()
def mesh():
    """A mock Zipkin and kube API on one server: Zipkin answers the queued
    window to a tick's short look-back and nothing to a backfill's 30 days
    (so a first-time setup leaves the window to the tick)."""
    _MockApi.routes = {}
    _MockApi.seen = []
    server = _Server(("127.0.0.1", 0), _MockApi)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    cluster = MockCluster(seed=3)
    feed = {"groups": []}

    def traces(q):
        look_back = int(q.get("lookback", ["0"])[0])
        return 200, (feed["groups"] if look_back < 86_400_000 else []), False

    cluster.mount(_MockApi, extra={("GET", "/zipkin/api/v2/traces"): traces})
    metrics.reset_for_tests()
    yield {"base": _base(server), "cluster": cluster, "feed": feed}
    server.shutdown()
    server.server_close()
    metrics.reset_for_tests()


def _queue(mesh, groups):
    mesh["cluster"].add_window(groups)
    mesh["feed"]["groups"] = groups


@pytest.fixture()
def service_account(tmp_path, monkeypatch):
    """A mounted service account in a directory of the test's."""
    certifi = pytest.importorskip("certifi")
    sa = tmp_path / "serviceaccount"
    sa.mkdir()
    shutil.copy(certifi.where(), sa / "ca.crt")
    (sa / "token").write_text("sa-token\n")
    (sa / "namespace").write_text("kmamiz-system\n")
    monkeypatch.setattr(kubernetes, "SERVICE_ACCOUNT_DIR", str(sa))
    return sa


def _post(port: int, body: dict) -> dict:
    req = urllib.request.Request(f"http://127.0.0.1:{port}/", data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=60) as resp:
        assert resp.status == 200
        return json.loads(resp.read())


def test_encode_payload_splices_the_given_text_as_json_dumps_would():
    """encode_payload with a value's JSON text given writes the bytes of
    json.dumps(payload)."""
    from kmamiz_tpu_torch.server.dp_server import encode_payload

    records = [{"endpoint": {"url": "http://a/ü", "t": 1.5e12}, "distance": 1}, {"x": [None, True, 0.1]}]
    payload = {"uniqueId": "u", "combined": [{"k": "v"}], "dependencies": records, "datatype": [], "log": "é"}
    text = "[" + ", ".join(json.dumps(r) for r in records) + "]"
    assert encode_payload(payload, {"dependencies": text}) == json.dumps(payload).encode()
    assert encode_payload(payload) == json.dumps(payload).encode()
    empty = {**payload, "dependencies": []}
    assert encode_payload(empty, {"dependencies": "[]"}) == json.dumps(empty).encode()


def test_dp_tick_with_a_cluster_answers_with_its_early_encoded_dependencies(mesh, monkeypatch):
    """A DP server's tick with a cluster source encodes its dependency
    records while the fetch runs; the answer's bytes are json.dumps's of
    the payload, and a second tick's records are its own."""
    from kmamiz_tpu_torch.domain.traces import Traces
    from kmamiz_tpu_torch.server import dp_server

    monkeypatch.setenv("ZIPKIN_URL", mesh["base"])
    monkeypatch.setenv("KUBEAPI_HOST", mesh["base"])
    monkeypatch.setenv("IS_RUNNING_IN_K8S", "false")
    monkeypatch.setenv("BIND_IP", "127.0.0.1")
    monkeypatch.setenv("DP_PORT", "0")
    monkeypatch.setenv("KMAMIZ_WAL", "0")
    server, _ = dp_server.build_server(device="cpu")
    proc = server.processor
    server.start()
    try:
        for k, groups in enumerate(_windows(2)):
            _queue(mesh, groups)
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.port}/", data=json.dumps({"uniqueId": f"e{k}", "lookBack": 30_000}).encode()
            )
            with urllib.request.urlopen(req, timeout=60) as resp:
                body = resp.read()
            answer = json.loads(body)
            assert "dependencies_json" in proc.last_stage_ms
            assert answer["dependencies"] and body == json.dumps(answer).encode()
            want = Traces(groups).to_endpoint_dependencies().to_json()
            assert answer["dependencies"] == json.loads(json.dumps(want))
    finally:
        server.stop()


def test_warm_up_on_the_cpu_touches_nothing():
    """A CPU processor's warm_up returns at once: nothing loads lazily on
    the CPU (the card's case is tests/test_torch_cuda.py's)."""
    from kmamiz_tpu_torch.ops import segment_stats as ss
    from kmamiz_tpu_torch.server.processor import DataProcessor

    dp = DataProcessor(trace_source=lambda lb, t, lim: [], device="cpu", wal=None)
    before = ss.segment_stats.launches
    start = time.monotonic()
    dp.warm_up()
    assert time.monotonic() - start < 0.5
    assert ss.segment_stats.launches == before and dp.graph.n_edges == 0 and not dp._processed


# -- the DP server -----------------------------------------------------------------


@pytest.mark.parametrize("wal", ["0", "1"])
def test_dp_builder_serves_ticks_with_the_cluster_and_replays_its_wal(wal, mesh, monkeypatch, tmp_path):
    from kmamiz_tpu_torch.server import dp_server

    monkeypatch.setenv("ZIPKIN_URL", mesh["base"])
    monkeypatch.setenv("KUBEAPI_HOST", mesh["base"])
    monkeypatch.setenv("IS_RUNNING_IN_K8S", "false")
    monkeypatch.setenv("BIND_IP", "127.0.0.1")
    monkeypatch.setenv("DP_PORT", "0")
    monkeypatch.setenv("KMAMIZ_WAL", wal)
    monkeypatch.setenv("KMAMIZ_WAL_DIR", str(tmp_path / "wal"))
    windows = _windows(2)
    server, recovered = dp_server.build_server(device="cpu")
    assert recovered == {"replayed": 0, "spans": 0, "quarantined": 0}
    proc = server.processor
    assert proc.device.type == "cpu" and proc._k8s is not None and proc._k8s._token is None
    server.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/", timeout=30) as r:
            assert json.loads(r.read())["status"] == "UP"
        for k, groups in enumerate(windows):
            _queue(mesh, groups)
            resp = _post(server.port, {"uniqueId": f"m{k}", "lookBack": 30_000})
            assert resp["uniqueId"] == f"m{k}" and resp["combined"]
            assert any(d["schemas"][0]["responseSchema"] for d in resp["datatype"] if d["schemas"])
            assert "fetch_cluster_state" in proc.last_stage_ms
            with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/", timeout=30) as r:
                assert json.loads(r.read())["lastTickStagesMs"] == proc.last_stage_ms
        want = graph_signature(proc.graph)
    finally:
        server.stop()
    # a second boot over the same directory: with the WAL on, it replays
    # the ticks' windows to the same graph before it serves
    again, recovered = dp_server.build_server(device="cpu")
    try:
        if wal == "1":
            assert recovered["replayed"] == 2
            assert recovered["spans"] == sum(len(g) for w in windows for g in w)
            assert graph_signature(again.processor.graph) == want
        else:
            assert recovered["replayed"] == 0 and again.processor.graph.n_edges == 0
    finally:
        again.stop()


@pytest.mark.parametrize("in_cluster", ["true", "false"])
def test_dp_builder_takes_the_service_account_in_a_cluster(in_cluster, service_account, monkeypatch):
    from kmamiz_tpu_torch.server import dp_server

    monkeypatch.setenv("ZIPKIN_URL", "http://127.0.0.1:9")
    monkeypatch.setenv("KUBEAPI_HOST", "http://127.0.0.1:9")
    monkeypatch.setenv("IS_RUNNING_IN_K8S", in_cluster)
    monkeypatch.setenv("DP_PORT", "0")
    monkeypatch.setenv("BIND_IP", "127.0.0.1")
    monkeypatch.delenv("KMAMIZ_WAL", raising=False)
    server, _ = dp_server.build_server(device="cpu")
    try:
        k8s = server.processor._k8s
        if in_cluster == "true":
            assert (k8s._token, k8s.current_namespace) == ("sa-token", "kmamiz-system")
        else:
            assert k8s._token is None and k8s.current_namespace == ""
    finally:
        server.stop()
    monkeypatch.delenv("KUBEAPI_HOST")
    server, _ = dp_server.build_server(device="cpu")
    assert server.processor._k8s is None  # no KUBEAPI_HOST: no cluster source
    server.stop()


def test_dp_builder_requires_a_zipkin_url(monkeypatch):
    from kmamiz_tpu_torch.server import dp_server

    monkeypatch.delenv("ZIPKIN_URL", raising=False)
    with pytest.raises(ValueError, match="ZIPKIN_URL"):
        dp_server.build_server(device="cpu")


# -- the application ------------------------------------------------------------------


def _settings(mesh, tmp_path, **kw) -> Settings:
    s = Settings()
    s.storage_uri = "file://" + str(tmp_path / "store")
    s.zipkin_url = s.kube_api_host = mesh["base"]
    s.is_running_in_kubernetes = False
    s.external_data_processor = ""
    s.static_dir = s.wasm_path = ""
    s.aggregate_interval = s.dispatch_interval = NEVER_CRON
    s.realtime_interval = "* * * * * *"  # every second
    for k, v in kw.items():
        setattr(s, k, v)
    return s


def test_application_ticks_with_envoy_logs_and_flushes(mesh, tmp_path):
    from kmamiz_tpu_torch.api.app import Application, build_production_context
    from kmamiz_tpu_torch.server.storage import FileStore

    _queue(mesh, _windows(1)[0])
    app = Application(ctx=build_production_context(_settings(mesh, tmp_path), device="cpu"))
    proc = app.ctx.processor
    assert proc.device.type == "cpu" and proc._k8s is app.ctx.k8s_client
    app.start_up()
    app.listen(host="127.0.0.1", port=0)
    try:
        deadline = time.monotonic() + 60
        while "fetch_cluster_state" not in proc.last_stage_ms and time.monotonic() < deadline:
            time.sleep(0.05)
        assert "fetch_cluster_state" in proc.last_stage_ms
        app.ctx.scheduler.register("realtime", NEVER_CRON, lambda: None)  # park it
        with urllib.request.urlopen(f"http://127.0.0.1:{app.server.port}/api/v1/health", timeout=30) as r:
            health = json.loads(r.read())
        assert health["status"] == "UP"
        assert {"breakers", "quarantine", "watchdog", "jobs", "counters"} <= set(health["resilience"])
        assert health["resilience"]["jobs"].get("realtime", {}).get("consecutiveFailures", 0) == 0
        datatypes = [d.to_json() for d in app.ctx.cache.get("EndpointDataType").get_data()]
        assert any(s.get("responseSchema") for d in datatypes for s in d["schemas"])
    finally:
        app.tear_down()
    stored = FileStore(str(tmp_path / "store"))
    assert stored.find_all("EndpointDataType")
    assert stored.find_all("EndpointDependencies")


@pytest.mark.parametrize("in_cluster", [True, False])
def test_start_up_asks_the_replaced_instance_to_sync_in_a_cluster(in_cluster, mesh, tmp_path, service_account, monkeypatch):
    from kmamiz_tpu_torch.api.app import Application, build_production_context

    calls = []
    monkeypatch.setattr(
        kubernetes.KubernetesClient,
        "force_kmamiz_sync",
        lambda self, port, version, simulator_mode=False: calls.append((port, version, simulator_mode)),
    )
    s = _settings(mesh, tmp_path, is_running_in_kubernetes=in_cluster, realtime_interval=NEVER_CRON, service_port="3456")
    ctx = build_production_context(s, device="cpu")
    assert (ctx.k8s_client._token == "sa-token") == in_cluster
    app = Application(ctx=ctx)
    app.start_up()
    app.tear_down()
    assert calls == ([("3456", "1", False)] if in_cluster else [])


@pytest.mark.parametrize("read_only", [True, False])
def test_production_context_modes(read_only, mesh, tmp_path):
    from kmamiz_tpu_torch.api.app import build_production_context

    ctx = build_production_context(_settings(mesh, tmp_path, read_only_mode=read_only), device="cpu")
    # read-only keeps the clients for the sync handshake
    assert ctx.zipkin_client is not None and ctx.k8s_client is not None and ctx.processor is not None
    s = _settings(mesh, tmp_path, simulator_mode=True)
    ctx = build_production_context(s, device="cpu")
    assert ctx.processor is None and ctx.zipkin_client is None and ctx.k8s_client is None


# -- settings and main() -----------------------------------------------------------------


@pytest.mark.parametrize("in_cluster", [True, False])
def test_kube_api_host_from_the_cluster_env(in_cluster, monkeypatch):
    monkeypatch.setenv("IS_RUNNING_IN_K8S", "true" if in_cluster else "false")
    monkeypatch.setenv("KUBEAPI_HOST", "http://127.0.0.1:8080")
    monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "10.0.0.1")
    monkeypatch.setenv("KUBERNETES_SERVICE_PORT", "443")
    want = "https://10.0.0.1:443" if in_cluster else "http://127.0.0.1:8080"
    assert Settings().kube_api_host == want
    from kmamiz_tpu.config import Settings as JaxSettings

    assert JaxSettings().kube_api_host == want


@pytest.mark.parametrize("level, want", [("verbose", 5), ("warn", logging.WARNING), ("error", logging.ERROR), ("info", logging.INFO)])
def test_log_level_applies(level, want):
    from kmamiz_tpu_torch.core import logger as klog

    pkg = logging.getLogger("kmamiz_tpu_torch")
    before = pkg.level
    try:
        klog.configure(level)
        assert pkg.level == want
    finally:
        pkg.setLevel(before)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_dp_main_raises_without_a_card(no_card, monkeypatch):
    from kmamiz_tpu_torch.server import dp_server

    monkeypatch.setenv("ZIPKIN_URL", "http://127.0.0.1:9")
    monkeypatch.delenv("KUBEAPI_HOST", raising=False)
    monkeypatch.setenv("DP_PORT", "0")
    with pytest.raises(RuntimeError, match="CUDA"):
        dp_server.main()


def test_app_main_raises_without_a_card(no_card, monkeypatch, tmp_path):
    from kmamiz_tpu_torch.api import app

    monkeypatch.setenv("STORAGE_URI", "file://" + str(tmp_path / "store"))
    monkeypatch.setenv("ZIPKIN_URL", "http://127.0.0.1:9")
    monkeypatch.setenv("KUBEAPI_HOST", "http://127.0.0.1:9")
    monkeypatch.setenv("PORT", "0")
    with pytest.raises(RuntimeError, match="CUDA"):
        app.main()


@pytest.mark.parametrize("module", ["kmamiz_tpu_torch.server.dp_server", "kmamiz_tpu_torch.api.app"])
def test_python_dash_m_without_a_card_exits_nonzero(module, tmp_path):
    """`python -m` of either server in a process without a card exits
    with an error before it serves."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the server would serve")
    env = dict(os.environ)
    env.update(
        ZIPKIN_URL="http://127.0.0.1:9",
        KUBEAPI_HOST="http://127.0.0.1:9",
        DP_PORT="0",
        PORT="0",
        STORAGE_URI="file://" + str(tmp_path / "store"),
    )
    proc = subprocess.run(
        [sys.executable, "-m", module], cwd=REPO, env=env, capture_output=True, text=True, timeout=240
    )
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr

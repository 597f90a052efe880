"""The port's Kubernetes client and the DP tick with a cluster source,
against the JAX package, on the CPU.

The client cases are tests/test_ingestion.py's TestKubernetesClient and
TestProductionContext, run on the port's client, against a mock API
server whose listen backlog is 64 (the JAX file's mock keeps the
default of 5, which a 16-worker fan-out can overrun). The tick cases
feed both packages' processors, each through its own KubernetesClient,
from one mock cluster: pod listings of 1-3 pods per service (seeded) and
istio-proxy logs that the port's envoy_filter writes for the SERVER
spans of every window so far, with JSON bodies. The realtime records,
the dependencies, the datatypes (body schemas included) and the replica
counts must be equal; latency mean within rel 1e-5 / abs 1e-6 and cv
within rel 1e-3 / abs 1e-5 (tests/test_processor_equivalence.py's
tolerances); the graph signatures equal. The hour's fold features must
equal JAX's within atol 1e-6 (tests/test_torch_forecast.py's), the
replica column exactly.
"""
from __future__ import annotations

import gzip
import json
import random
import threading
import time
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

import numpy as np
import pytest

from kmamiz_tpu.ingestion import KubernetesClient as JaxKubernetesClient
from kmamiz_tpu.resilience.chaos import graph_signature as jax_signature
from kmamiz_tpu.server.processor import DataProcessor as JaxProcessor
from kmamiz_tpu_torch import synth
from kmamiz_tpu_torch.core import envoy_filter
from kmamiz_tpu_torch.graph.store import graph_signature
from kmamiz_tpu_torch.ingestion import KubernetesClient
from kmamiz_tpu_torch.ingestion.kubernetes import KubernetesServiceError, joinable
from kmamiz_tpu_torch.server.processor import DataProcessor
from test_torch_processor import _assert_same_tick

H = 3_600_000

#: request/response bodies of the mock cluster's logs (None: no body)
BODY_POOL = (
    '{"id":1,"name":"a","tags":["x","y"],"price":9.5}',
    '{"id":2,"name":"b","tags":[],"owner":{"id":7,"roles":["r"]}}',
    '[{"k":1},{"k":"s","z":[{"q":false}]}]',
    '{"ok":true}',
    None,
)


class _MockApi(BaseHTTPRequestHandler):
    routes: dict = {}
    seen: list = []

    def log_message(self, *args):
        pass

    def _serve(self):
        split = urlsplit(self.path)
        type(self).seen.append((self.command, self.path))
        handler = self.routes.get((self.command, split.path))
        if handler is None:
            self.send_response(404)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        status, payload, use_gzip = handler(parse_qs(split.query))
        body = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
        if use_gzip:
            body = gzip.compress(body)
        self.send_response(status)
        if use_gzip:
            self.send_header("Content-Encoding", "gzip")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    do_GET = _serve
    do_POST = _serve


class _Server(ThreadingHTTPServer):
    request_queue_size = 64  # a 16-worker fan-out never meets the backlog
    daemon_threads = True


@pytest.fixture()
def mock_api():
    _MockApi.routes = {}
    _MockApi.seen = []
    server = _Server(("127.0.0.1", 0), _MockApi)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield server, _MockApi
    server.shutdown()
    server.server_close()


def _base(server) -> str:
    return f"http://127.0.0.1:{server.server_address[1]}"


POD_LIST = {
    "items": [
        {
            "metadata": {
                "name": f"user-service-{i}",
                "namespace": "pdas",
                "labels": {
                    "service.istio.io/canonical-name": "user-service",
                    "service.istio.io/canonical-revision": "latest",
                },
            }
        }
        for i in range(3)
    ]
    + [
        {
            "metadata": {
                "name": "db-service-0",
                "namespace": "pdas",
                "labels": {
                    "service.istio.io/canonical-name": "db-service",
                    "service.istio.io/canonical-revision": "v2",
                },
            }
        }
    ]
}


def _istio_log(lines) -> bytes:
    """Envoy lines as the istio-proxy container prints them."""
    return "\n".join(
        ln.split("\t")[0] + "\twasm log kmamiz-filter: " + ln.split("\t", 1)[1] for ln in lines
    ).encode()


# -- the client: tests/test_ingestion.py's cases -------------------------------------


class TestKubernetesClient:
    def test_replicas_from_canonical_labels(self, mock_api):
        server, api = mock_api
        api.routes[("GET", "/api/v1/namespaces/pdas/pods")] = lambda q: (200, POD_LIST, False)
        replicas = KubernetesClient(_base(server)).get_replicas_from_pod_list("pdas")
        assert replicas == JaxKubernetesClient(_base(server)).get_replicas_from_pod_list("pdas")
        by_name = {r["uniqueServiceName"]: r for r in replicas}
        assert by_name["user-service\tpdas\tlatest"]["replicas"] == 3
        assert by_name["db-service\tpdas\tv2"]["replicas"] == 1
        assert by_name["db-service\tpdas\tv2"]["version"] == "v2"

    def test_pod_names_and_namespaces(self, mock_api):
        server, api = mock_api
        api.routes[("GET", "/api/v1/namespaces/pdas/pods")] = lambda q: (200, POD_LIST, False)
        api.routes[("GET", "/api/v1/namespaces")] = lambda q: (
            200,
            {"items": [{"metadata": {"name": "pdas"}}, {"metadata": {"name": "book"}}]},
            False,
        )
        client = KubernetesClient(_base(server))
        assert len(client.get_pod_names("pdas")) == 4
        assert client.get_namespaces() == ["pdas", "book"]
        assert len(client.get_replicas({"pdas"})) == 2

    def test_envoy_log_fetch_and_parse(self, mock_api, pdas_envoy_log_lines):
        server, api = mock_api
        raw = _istio_log(pdas_envoy_log_lines)
        api.routes[("GET", "/api/v1/namespaces/pdas/pods/user-service-0/log")] = lambda q: (200, raw, False)
        rows = KubernetesClient(_base(server)).get_envoy_logs("pdas", "user-service-0").to_json()
        assert rows == JaxKubernetesClient(_base(server)).get_envoy_logs("pdas", "user-service-0").to_json()
        assert rows and all(r["podName"] == "user-service-0" for r in rows)
        assert {r["type"] for r in rows} <= {"Request", "Response"}
        # the tail the tick asks for
        assert any("container=istio-proxy&tailLines=10000" in p for _, p in api.seen)

    def test_missing_data_is_fatal(self, mock_api):
        server, _ = mock_api
        with pytest.raises(KubernetesServiceError):
            KubernetesClient(_base(server)).get_pod_list("missing")

    def test_transient_failures_are_retried(self, mock_api):
        server, api = mock_api
        attempts = []

        def flaky(q):
            attempts.append(1)
            if len(attempts) < 3:
                return 500, {"err": "etcd hiccup"}, False
            return 200, POD_LIST, False

        api.routes[("GET", "/api/v1/namespaces/pdas/pods")] = flaky
        client = KubernetesClient(_base(server), retries=2, backoff_s=0.01)
        assert len(client.get_pod_names("pdas")) == 4
        assert len(attempts) == 3

    def test_client_errors_are_not_retried(self, mock_api):
        server, api = mock_api
        client = KubernetesClient(_base(server), retries=3, backoff_s=0.01)
        with pytest.raises(KubernetesServiceError):
            client.get_pod_list("gone")  # 404
        assert len([p for _, p in api.seen if p.startswith("/api/v1/namespaces/gone")]) == 1

    def test_retries_exhausted_raises(self, mock_api):
        server, api = mock_api
        api.routes[("GET", "/api/v1/namespaces/pdas/pods")] = lambda q: (503, {}, False)
        client = KubernetesClient(_base(server), retries=1, backoff_s=0.01)
        with pytest.raises(KubernetesServiceError):
            client.get_pod_list("pdas")
        assert len([p for _, p in api.seen if p.startswith("/api/v1/namespaces/pdas")]) == 2

    def test_cluster_fanout_is_concurrent(self, mock_api):
        """8 pods each taking 0.15 s to serve logs: the fan-out costs about
        one pod's fetch, not the sum, and lists the pods once."""
        server, api = mock_api
        pods = {
            "items": [
                {
                    "metadata": {
                        "name": f"svc-{i}",
                        "namespace": "pdas",
                        "labels": {
                            "service.istio.io/canonical-name": "svc",
                            "service.istio.io/canonical-revision": "latest",
                        },
                    }
                }
                for i in range(8)
            ]
        }
        api.routes[("GET", "/api/v1/namespaces/pdas/pods")] = lambda q: (200, pods, False)

        def slow_log(q):
            time.sleep(0.15)
            return 200, b"", False

        for i in range(8):
            api.routes[("GET", f"/api/v1/namespaces/pdas/pods/svc-{i}/log")] = slow_log
        client = KubernetesClient(_base(server))
        try:
            client.warm_up()  # the worker processes start at a server's boot
            start = time.monotonic()
            replicas, logs = client.get_replicas_and_joinable_logs(["pdas"])
            elapsed = time.monotonic() - start
        finally:
            client.close()
        assert logs == []
        assert len([p for _, p in api.seen if p.endswith("/log?container=istio-proxy&tailLines=10000")]) == 8
        assert replicas == [
            {
                "uniqueServiceName": "svc\tpdas\tlatest",
                "service": "svc",
                "namespace": "pdas",
                "version": "latest",
                "replicas": 8,
            }
        ]
        assert elapsed < 0.9, f"fan-out not concurrent: {elapsed:.2f}s"
        assert len([p for _, p in api.seen if p == "/api/v1/namespaces/pdas/pods"]) == 1

    def test_fanout_parses_per_pod_logs(self, mock_api, pdas_envoy_log_lines):
        server, api = mock_api
        api.routes[("GET", "/api/v1/namespaces/pdas/pods")] = lambda q: (200, POD_LIST, False)
        raw = _istio_log(pdas_envoy_log_lines)
        for pod in ["user-service-0", "user-service-1", "user-service-2", "db-service-0"]:
            api.routes[("GET", f"/api/v1/namespaces/pdas/pods/{pod}/log")] = lambda q: (200, raw, False)
        from kmamiz_tpu.core.envoy import EnvoyLogs as JaxEnvoyLogs

        client = KubernetesClient(_base(server))
        try:
            replicas, logs = client.get_replicas_and_joinable_logs(["pdas"])
        finally:
            client.close()
        want_replicas, want_logs = JaxKubernetesClient(_base(server)).get_replicas_and_envoy_logs(["pdas"])
        assert replicas == want_replicas
        assert logs and logs == joinable(JaxEnvoyLogs.combine_structured([log.to_structured() for log in want_logs]))
        assert {p.split("/")[6] for _, p in api.seen if "/log?" in p} == {
            "user-service-0",
            "user-service-1",
            "user-service-2",
            "db-service-0",
        }

    def test_auth_header_sent(self, mock_api):
        server, api = mock_api
        captured = {}

        def handler(q):
            return 200, {"items": []}, False

        api.routes[("GET", "/api/v1/namespaces")] = handler
        orig = _MockApi._serve

        def spy(self):
            captured["auth"] = self.headers.get("Authorization")
            orig(self)

        _MockApi._serve = _MockApi.do_GET = spy
        try:
            KubernetesClient(_base(server), token="sekret").get_namespaces()
        finally:
            _MockApi._serve = _MockApi.do_GET = orig
        assert captured["auth"] == "Bearer sekret"

    def test_production_service_base_url(self, mock_api):
        server, api = mock_api
        api.routes[("GET", "/api/v1/namespaces/kmamiz-system/services")] = lambda q: (
            200,
            {
                "items": [
                    {"metadata": {"name": "other"}, "spec": {"ports": [{"port": 9}]}},
                    {"metadata": {"name": "kmamiz"}, "spec": {"ports": [{"port": 8080}]}},
                ]
            },
            False,
        )
        assert KubernetesClient(_base(server)).get_production_service_base_url() == "http://kmamiz:8080"

    def test_force_sync_best_effort(self, monkeypatch):
        """The handshake posts to the kmamiz service of the client's
        namespace and swallows a failure (the transport is stubbed: the
        service's name resolves only inside a cluster)."""
        from kmamiz_tpu_torch.ingestion import kubernetes

        calls = []

        def refuse(request, timeout=None):
            calls.append((request.get_method(), request.full_url))
            raise OSError("connection refused")

        monkeypatch.setattr(kubernetes.urllib.request, "urlopen", refuse)
        client = KubernetesClient("http://127.0.0.1:9", current_namespace="kmamiz-system")
        client.force_kmamiz_sync("3000", "1")
        client.force_kmamiz_sync("3000", "1", simulator_mode=True)
        assert calls == [
            ("POST", "http://kmamiz.kmamiz-system.svc:3000/api/v1/data/sync"),
            ("POST", "http://kmamiz-simulator.kmamiz-system.svc:3000/api/v1/data/sync"),
        ]

    def test_from_service_account(self, tmp_path):
        """The mounted service account's token, namespace and CA bundle, in
        a directory of the test's (certifi's bundle stands in for the
        cluster's CA)."""
        import shutil

        certifi = pytest.importorskip("certifi")
        shutil.copy(certifi.where(), tmp_path / "ca.crt")
        (tmp_path / "token").write_text("tok\n")
        (tmp_path / "namespace").write_text("kmamiz-system\n")
        client = KubernetesClient.from_service_account("http://127.0.0.1:9", str(tmp_path))
        assert client.current_namespace == "kmamiz-system"
        assert client._token == "tok"
        (tmp_path / "token").write_text("")
        with pytest.raises(ValueError, match="token is empty"):
            KubernetesClient.from_service_account("http://127.0.0.1:9", str(tmp_path))

    def test_requires_a_host(self):
        with pytest.raises(ValueError, match="KUBEAPI_HOST"):
            KubernetesClient("")


class _KeepAliveApi(BaseHTTPRequestHandler):
    """An HTTP/1.1 API that keeps its connections alive, or with `drop`
    closes each one after its answer without saying so; counts the
    connections it accepted."""

    protocol_version = "HTTP/1.1"
    connections = 0
    drop = False

    def setup(self):
        type(self).connections += 1
        super().setup()

    def log_message(self, *args):
        pass

    def do_GET(self):
        body = json.dumps({"items": [{"metadata": {"name": "pdas"}}]}).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)
        self.close_connection = type(self).drop


@pytest.mark.parametrize("drop", [False, True], ids=["kept", "dropped"])
def test_a_thread_keeps_its_api_connection_alive(drop):
    """The client's calls on one thread share one connection to an API
    server that keeps it alive; a kept-alive connection that the server
    closed is opened anew at once, not through the retry's backoff."""
    _KeepAliveApi.connections, _KeepAliveApi.drop = 0, drop
    server = _Server(("127.0.0.1", 0), _KeepAliveApi)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        client = KubernetesClient(_base(server), retries=0, backoff_s=5.0)
        start = time.monotonic()
        for _ in range(3):
            assert client.get_namespaces() == ["pdas"]
        assert time.monotonic() - start < 2.0
        assert _KeepAliveApi.connections == (3 if drop else 1)
    finally:
        server.shutdown()
        server.server_close()


class TestProductionContext:
    def test_build_production_context_wires_clients(self):
        from kmamiz_tpu_torch.api.app import build_production_context
        from kmamiz_tpu_torch.config import Settings

        ctx = build_production_context(Settings(), device="cpu")
        assert ctx.zipkin_client is not None
        assert ctx.k8s_client is not None
        assert ctx.processor is not None and ctx.processor.device.type == "cpu"
        assert ctx.processor._k8s is ctx.k8s_client
        assert ctx.operator._processor is ctx.processor

    def test_serve_only_context_has_no_clients(self):
        from kmamiz_tpu_torch.api.app import build_production_context
        from kmamiz_tpu_torch.config import Settings

        s = Settings()
        s.serve_only = True
        ctx = build_production_context(s, device="cpu")
        assert ctx.zipkin_client is None
        assert ctx.k8s_client is None
        assert ctx.processor is None


# -- the tick and the fold with a cluster source ---------------------------------------


class MockCluster:
    """A kube API over trace windows: each service of the windows runs 1-3
    pods (seeded), and each pod's istio-proxy log holds the envoy lines of
    the SERVER spans it served in the windows added so far, cut to the
    request's tailLines. A span's Request line carries its parent span id
    and its Response line its own id (the wasm filter's shape), with a
    JSON body from BODY_POOL on each side, drawn from the span id."""

    def __init__(self, seed: int = 0) -> None:
        self.rng = random.Random(seed)
        self.pods: dict = {}  # (service, namespace) -> pod names
        self.logs: dict = {}  # (namespace, pod) -> lines
        self.fail = False

    def add_window(self, groups) -> None:
        for group in groups:
            for span in group:
                if span.get("kind") != "SERVER":
                    continue
                tags = span["tags"]
                svc, ns = tags["istio.canonical_service"], tags["istio.namespace"]
                pods = self.pods.get((svc, ns))
                if pods is None:
                    pods = self.pods[(svc, ns)] = [f"{svc}-{i}" for i in range(self.rng.randint(1, 3))]
                key = zlib.crc32(span["id"].encode())
                pod = pods[key % len(pods)]
                host_path = tags["http.url"].split("://", 1)[1]
                host, path = host_path.split("/", 1)
                parent = span.get("parentId") or f"{span['id']}-in"
                req_body, res_body = BODY_POOL[key % len(BODY_POOL)], BODY_POOL[(key >> 8) % len(BODY_POOL)]
                common = dict(
                    timestamp_ms=span["timestamp"] / 1000,
                    method=tags["http.method"],
                    host=host,
                    path="/" + path,
                    status=tags["http.status_code"],
                    request_id=f"req-{span['traceId']}",
                    trace_id=span["traceId"],
                    request_content_type="application/json" if req_body else "",
                    request_body=req_body or "",
                    response_content_type="application/json" if res_body else "",
                    response_body=res_body or "",
                )
                request_line = envoy_filter.emit_stream_logs(span_id=parent, parent_span_id="NO_ID", **common)[0]
                response_line = envoy_filter.emit_stream_logs(span_id=span["id"], parent_span_id=parent, **common)[1]
                self.logs.setdefault((ns, pod), []).extend([request_line, response_line])

    def pod_list(self, ns: str) -> dict:
        return {
            "items": [
                {
                    "metadata": {
                        "name": pod,
                        "namespace": ns,
                        "labels": {
                            "service.istio.io/canonical-name": svc,
                            "service.istio.io/canonical-revision": "latest",
                        },
                    }
                }
                for (svc, pns), pods in sorted(self.pods.items())
                if pns == ns
                for pod in pods
            ]
        }

    def mount(self, api, extra=None) -> None:
        """Route the mock API's kube paths to this cluster (and `extra`'s
        routes, such as a Zipkin trace query, as given)."""
        cluster = self
        extra = dict(extra or {})

        class Routes(dict):
            def get(self, key, default=None):
                if key in extra:
                    return extra[key]
                method, path = key
                parts = path.strip("/").split("/")
                if cluster.fail:
                    return lambda q: (500, {"err": "apiserver down"}, False)
                if parts[:3] == ["api", "v1", "namespaces"] and len(parts) == 3:
                    nss = sorted({ns for _, ns in cluster.pods})
                    return lambda q: (200, {"items": [{"metadata": {"name": n}} for n in nss]}, False)
                if len(parts) == 5 and parts[4] == "pods":
                    return lambda q: (200, cluster.pod_list(parts[3]), False)
                if len(parts) == 7 and parts[6] == "log":
                    lines = cluster.logs.get((parts[3], parts[5]), [])

                    def log(q):
                        tail = int(q.get("tailLines", ["10000"])[0])
                        return 200, _istio_log(lines[-tail:]), False

                    return log
                return default

        api.routes = Routes()


def hex_ids(groups):
    """The windows' trace and span ids in hex, as Zipkin writes them (the
    envoy line's header takes word characters only: synth's "t-j" ids
    could never be logged)."""
    for group in groups:
        for span in group:
            for key in ("traceId", "id", "parentId"):
                if span.get(key):
                    span[key] = span[key].encode().hex()
    return groups


def _windows(n: int, traces: int = 30):
    return [
        hex_ids(
            json.loads(
                synth.make_raw_window(
                    traces, 7, t_start=k * traces, trace_prefix=f"k8s{k}-", n_services=12, n_namespaces=3,
                    urls_per_service=3,
                )
            )
        )
        for k in range(n)
    ]


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setenv("KMAMIZ_SEGMENT_BACKEND", "pallas_interpret")


def _pair(server, feed):
    """A JAX and a port processor, each with its own KubernetesClient on
    the mock cluster, both reading the queued window."""
    source = lambda lb, t, lim: feed["groups"]  # noqa: E731
    jax_dp = JaxProcessor(trace_source=source, k8s_source=JaxKubernetesClient(_base(server)))
    port_dp = DataProcessor(trace_source=source, k8s_source=KubernetesClient(_base(server)), device="cpu")
    return jax_dp, port_dp


def test_tick_with_a_cluster_source_matches_jax(mock_api):
    server, api = mock_api
    cluster = MockCluster(seed=1)
    cluster.mount(api)
    feed = {"groups": []}
    jax_dp, port_dp = _pair(server, feed)
    bodied = 0
    for k, groups in enumerate(_windows(3)):
        cluster.add_window(groups)
        feed["groups"] = groups
        request = {"uniqueId": f"k{k}", "lookBack": 30_000, "time": 0}
        want, got = jax_dp.collect(request), port_dp.collect(request)
        _assert_same_tick(got, want)
        assert "fetch_cluster_state" in port_dp.last_stage_ms
        bodied += sum(1 for c in got["combined"] if c["responseSchema"] or c["requestSchema"])
        for c in got["combined"]:
            service, ns, _ = c["uniqueServiceName"].split("\t")
            assert c["avgReplica"] == len(cluster.pods[(service, ns)])
    assert bodied > 0  # the logs' bodies reached the datatypes
    assert port_dp._last_replicas == jax_dp._last_replicas
    assert graph_signature(port_dp.graph) == jax_signature(jax_dp.graph)


def test_hour_fold_takes_the_cluster_replicas(mock_api):
    server, api = mock_api
    cluster = MockCluster(seed=2)
    cluster.mount(api)
    feed = {"groups": []}
    jax_dp, port_dp = _pair(server, feed)
    for k, (groups, hour) in enumerate(zip(_windows(3), (910, 910, 911))):
        cluster.add_window(groups)
        feed["groups"] = groups
        request = {"uniqueId": f"f{k}", "lookBack": 30_000, "time": hour * H + 1000 * k}
        jax_dp.collect(request)
        port_dp.collect(request)
    got, want = port_dp.forecast_snapshot, jax_dp.forecast_snapshot
    assert got is not None and got["names"] == want["names"]
    np.testing.assert_allclose(got["features"], np.asarray(want["features"]), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(port_dp.history_features, jax_dp.history_features)
    # the replicas column (graphsage.assemble_features' sixth) is the
    # cluster's pod count of each endpoint's service
    replicas = got["features"][:, 5]
    np.testing.assert_array_equal(replicas, np.asarray(want["features"])[:, 5])
    for eid, name in enumerate(got["names"]):
        service, ns, _ = name.split("\t")[:3]
        assert replicas[eid] == len(cluster.pods[(service, ns)])
    assert set(replicas.tolist()) != {1.0}


def test_a_cluster_fault_fails_the_tick(mock_api):
    """A KubernetesServiceError fails the tick in both packages, and the
    window's traces stay registered, as in the JAX processor."""
    server, api = mock_api
    cluster = MockCluster()
    cluster.mount(api)
    feed = {"groups": _windows(1)[0]}
    cluster.add_window(feed["groups"])
    cluster.fail = True
    for dp, client in (
        (DataProcessor(lambda lb, t, lim: feed["groups"], k8s_source=KubernetesClient(_base(server), backoff_s=0.01), device="cpu"), None),
        (JaxProcessor(lambda lb, t, lim: feed["groups"], k8s_source=JaxKubernetesClient(_base(server), backoff_s=0.01)), None),
    ):
        with pytest.raises(Exception, match="Kubernetes API server"):
            dp.collect({"uniqueId": "x"})


def test_the_pooled_fetch_joins_as_the_structured_logs(mock_api):
    """get_replicas_and_joinable_logs (the worker processes' fetch, each
    trace reduced to the join's fields, no parent-id fill) gives, tick
    after tick as the pods' logs grow, the realtime records that JAX's
    combine_to_structured_envoy_logs over its get_replicas_and_envoy_logs
    gives."""
    from kmamiz_tpu.core.envoy import EnvoyLogs as JaxEnvoyLogs
    from kmamiz_tpu.domain.traces import Traces as JaxTraces
    from kmamiz_tpu_torch.domain.traces import Traces

    server, api = mock_api
    cluster = MockCluster(seed=4)
    cluster.mount(api)
    client = KubernetesClient(_base(server))
    try:
        for groups in _windows(3):
            cluster.add_window(groups)
            namespaces = {s["tags"]["istio.namespace"] for g in groups for s in g}
            jax_replicas, jax_logs = JaxKubernetesClient(_base(server)).get_replicas_and_envoy_logs(namespaces)
            want = JaxTraces(groups).combine_logs_to_realtime_data(
                JaxEnvoyLogs.combine_to_structured_envoy_logs(jax_logs), jax_replicas
            ).to_json()
            replicas, joined = client.get_replicas_and_joinable_logs(namespaces)
            assert replicas == jax_replicas
            got = Traces(groups).combine_logs_to_realtime_data(joined, replicas).to_json()
            assert got == want
            assert sum(1 for r in got if r["responseBody"]) > 0
    finally:
        client.close()


def _jax_realtime(server, groups, namespaces):
    """JAX's realtime records of a window over the whole of the cluster's
    logs: its get_replicas_and_envoy_logs, combine_to_structured_envoy_logs."""
    from kmamiz_tpu.core.envoy import EnvoyLogs as JaxEnvoyLogs
    from kmamiz_tpu.domain.traces import Traces as JaxTraces

    jax_replicas, jax_logs = JaxKubernetesClient(_base(server)).get_replicas_and_envoy_logs(namespaces)
    return JaxTraces(groups).combine_logs_to_realtime_data(
        JaxEnvoyLogs.combine_to_structured_envoy_logs(jax_logs), jax_replicas
    ).to_json()


def test_the_window_fetch_joins_as_the_structured_logs(mock_api):
    """get_replicas_and_joinable_logs given the window's trace ids (as the
    tick calls it) hands back the requests of the window only, however
    many windows the pods' logs hold, and the window's realtime records
    equal those that JAX's join gives over every log line."""
    from kmamiz_tpu_torch.domain.traces import Traces

    server, api = mock_api
    cluster = MockCluster(seed=5)
    cluster.mount(api)
    client = KubernetesClient(_base(server))
    try:
        for groups in _windows(3):
            cluster.add_window(groups)
            namespaces = {s["tags"]["istio.namespace"] for g in groups for s in g}
            trace_ids = {s["traceId"] for g in groups for s in g}
            replicas, joined = client.get_replicas_and_joinable_logs(namespaces, trace_ids=trace_ids)
            assert {entry["requestId"] for entry in joined} == {f"req-{t}" for t in trace_ids}
            got = Traces(groups).combine_logs_to_realtime_data(joined, replicas).to_json()
            assert got == _jax_realtime(server, groups, namespaces)
            assert sum(1 for r in got if r["responseBody"]) > 0
    finally:
        client.close()


def test_the_window_fetch_keeps_every_pod_of_a_window_request(mock_api):
    """A request of the window keeps the traces that other pods logged
    under it, also where those carry no traceId of the window: here a pod
    that logged the request earlier without a trace header, whose NO_ID
    trace then comes first in the combined request and takes the join's
    key. A pod whose log holds a NO_ID span id anywhere structures the
    kept request in fallback mode. The realtime records equal JAX's over
    every log line; a request with no trace in the window is left out."""
    from kmamiz_tpu_torch.domain.traces import Traces

    server, api = mock_api
    cluster = MockCluster(seed=6)
    cluster.mount(api)
    (groups,) = _windows(1, traces=6)
    cluster.add_window(groups)
    spans = [s for g in groups for s in g if s.get("kind") == "SERVER"]
    first, other = spans[0], spans[-1]
    ns = first["tags"]["istio.namespace"]
    cluster.pods[("ghost", ns)] = ["ghost-0"]
    early = min(s["timestamp"] for s in spans) / 1000 - 1_000
    common = dict(method="GET", host="ghost", path="/", status="200", response_content_type="application/json")
    request, response = envoy_filter.emit_stream_logs(
        early, request_id=f"req-{first['traceId']}", span_id=first["id"], response_body='{"ghost":1}', **common
    )
    stray = envoy_filter.emit_stream_logs(early, request_id="req-elsewhere", trace_id="e1", **common)
    cluster.logs[(ns, "ghost-0")] = [request, response, *stray]
    namespaces = {s["tags"]["istio.namespace"] for g in groups for s in g}
    client = KubernetesClient(_base(server))
    try:
        replicas, joined = client.get_replicas_and_joinable_logs(
            namespaces, trace_ids={s["traceId"] for g in groups for s in g}
        )
    finally:
        client.close()
    by_request = {entry["requestId"]: entry["traces"] for entry in joined}
    assert "req-elsewhere" not in by_request
    assert by_request[f"req-{first['traceId']}"][0]["traceId"] == "NO_ID"
    assert by_request[f"req-{first['traceId']}"][0]["isFallback"] is True
    assert f"req-{other['traceId']}" in by_request
    got = Traces(groups).combine_logs_to_realtime_data(joined, replicas).to_json()
    assert got == _jax_realtime(server, groups, namespaces)


def test_a_pod_log_fault_in_a_worker_fails_the_fetch(mock_api):
    """A pod's log answering 500 past the retries raises the worker's
    KubernetesServiceError in the caller, as the JAX client's fetch does;
    the workers stay up and the next fetch answers."""
    server, api = mock_api
    api.routes[("GET", "/api/v1/namespaces/pdas/pods")] = lambda q: (200, POD_LIST, False)
    for pod in ["user-service-0", "user-service-1", "user-service-2", "db-service-0"]:
        api.routes[("GET", f"/api/v1/namespaces/pdas/pods/{pod}/log")] = lambda q: (200, b"", False)
    api.routes[("GET", "/api/v1/namespaces/pdas/pods/db-service-0/log")] = lambda q: (500, {}, False)
    client = KubernetesClient(_base(server), retries=1, backoff_s=0.01)
    try:
        for _ in range(2):
            with pytest.raises(KubernetesServiceError, match="Kubernetes API server"):
                client.get_replicas_and_joinable_logs(["pdas"])
        from kmamiz_tpu.ingestion.kubernetes import KubernetesServiceError as JaxKubernetesServiceError

        with pytest.raises(JaxKubernetesServiceError, match="Kubernetes API server"):
            JaxKubernetesClient(_base(server), retries=1, backoff_s=0.01).get_replicas_and_envoy_logs(["pdas"])
        api.routes[("GET", "/api/v1/namespaces/pdas/pods/db-service-0/log")] = lambda q: (200, b"", False)
        assert client.get_replicas_and_joinable_logs(["pdas"])[1] == []
    finally:
        client.close()


def test_a_lost_worker_fails_the_fetch_and_the_next_starts_anew(mock_api):
    """A fan-out worker process that dies fails that fetch with a
    RuntimeError (the tick fails, and is served stale); the next fetch
    starts the workers again."""
    from kmamiz_tpu_torch.ingestion import kubernetes

    server, api = mock_api
    api.routes[("GET", "/api/v1/namespaces/pdas/pods")] = lambda q: (200, POD_LIST, False)
    raw = b"2022-01-01T00:00:00.000000Z\tdebug\tenvoy wasm\twasm log kmamiz-filter pdas: [Request r1/T1/S1/NO_ID] [GET h/p]"
    for pod in ["user-service-0", "user-service-1", "user-service-2", "db-service-0"]:
        api.routes[("GET", f"/api/v1/namespaces/pdas/pods/{pod}/log")] = lambda q: (200, raw, False)
    client = KubernetesClient(_base(server))
    try:
        client.warm_up()
        assert len(client._workers) == kubernetes.FANOUT_PROCESSES
        client._workers[0].proc.kill()
        client._workers[0].proc.wait()
        with pytest.raises(RuntimeError, match="fan-out worker"):
            client.get_replicas_and_joinable_logs(["pdas"])
        assert client._workers == []
        replicas, logs = client.get_replicas_and_joinable_logs(["pdas"])
        assert len(replicas) == 2 and [entry["requestId"] for entry in logs] == ["r1"]
    finally:
        client.close()


def test_the_fan_out_workers_import_no_torch():
    """The module a fan-out worker process imports pulls in neither torch
    nor the caller's main module."""
    import subprocess
    import sys

    probe = "import sys, kmamiz_tpu_torch.ingestion.kubernetes; print('torch' in sys.modules)"
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "False"

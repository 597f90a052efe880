"""Simulator mode of the port's Application against the JAX package's,
both on the CPU.

Both applications boot in simulator mode (no processor, no clients) over
their own MemoryStore, and take the same YAML at
POST /api/v1/simulation/startSimulation. The handler draws from an
unseeded generator and stamps the simulation with the wall clock: both
are pinned here (np.random.default_rng() seeded 0, the handlers' clock at
one instant), so the two simulations are the same. Then the caches the
upload fills are equal, every GET route both apps register answers alike
(tests/test_torch_app.py's tolerances), the handler's refusals carry the
same messages, and over a real socket the export -> clear -> import round
trip gives the graph back. The clone route reads a production port
application over HTTP into both simulators alike, and the comparator's
POST pushes a simulator's snapshot to that production application.
"""
from __future__ import annotations

import json
import types
import urllib.request

import numpy as np
import pytest

import kmamiz_tpu.simulator.handler as jax_handler
import kmamiz_tpu_torch.simulator.handler as port_handler
from test_e2e_application import SIM_YAML
from test_simulator import BASIC_YAML, LOAD_YAML
from test_torch_app import Feed, _boot, _concrete, _get_routes, _run_jobs, assert_close, jax_app, port_app
from test_torch_cuda import FAULT_YAML
from test_torch_simulator import _mesh_yaml

SIM_NOW_MS = 1_700_000_000_000
MESHES = {"load": LOAD_YAML, "shop": SIM_YAML, "fault": FAULT_YAML, "mesh20": _mesh_yaml()}
NAMESPACES = ("book", "shop", "mesh", "nope")
#: the caches a simulation fills, and how each is read for comparison
FILLED = {
    "EndpointDependencies": lambda data: data and data.to_json(),
    "LabeledEndpointDependencies": lambda data: data and data.to_json(),
    "EndpointDataType": lambda data: [d.to_json() for d in data or []],
    "ReplicaCounts": lambda data: data,
    "SimulatedHistoricalData": lambda data: [h.to_json() for h in data],
    "CombinedRealtimeData": lambda data: data,
}


@pytest.fixture
def pinned(monkeypatch):
    """The handlers' generator seeded and their clock fixed."""
    monkeypatch.setenv("KMAMIZ_PREWARM", "0")
    rng = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng", lambda seed=None: rng(0 if seed is None else seed))
    clock = types.SimpleNamespace(time=lambda: SIM_NOW_MS / 1000)
    monkeypatch.setattr(jax_handler, "time", clock)
    monkeypatch.setattr(port_handler, "time", clock)


def _sim_apps(**kw):
    kw = {"simulator_mode": True, "enable_testing_endpoints": True, **kw}
    return (
        _boot(jax_app(None, now=SIM_NOW_MS, **kw), SIM_NOW_MS),
        _boot(port_app(None, now=SIM_NOW_MS, **kw), SIM_NOW_MS),
    )


@pytest.fixture
def sim_apps(pinned):
    apps = _sim_apps()
    yield apps
    for app in apps:
        app.tear_down()


def _upload(app, body: bytes):
    return app.router.dispatch("POST", "/api/v1/simulation/startSimulation", body)


def _filled(app) -> dict:
    return {name: read(app.ctx.cache.get(name).get_data()) for name, read in FILLED.items()}


def test_simulator_mode_registers_the_simulators_caches(sim_apps):
    jax, port = sim_apps
    assert set(port.ctx.cache.get_all()) == set(jax.ctx.cache.get_all())
    assert {"TaggedSimulationYAML", "SimulatedHistoricalData"} <= set(port.ctx.cache.get_all())
    assert port.ctx.processor is None and port.ctx.zipkin_client is None and port.ctx.k8s_client is None
    assert _get_routes(port.router) == _get_routes(jax.router)
    assert {r for r in port.router.route_list if "simulation" in r or "clone" in r} == {
        r for r in jax.router.route_list if "simulation" in r or "clone" in r
    }


@pytest.mark.parametrize("mesh", list(MESHES))
def test_an_upload_fills_the_caches_as_jax(sim_apps, mesh):
    jax, port = sim_apps
    want, got = _upload(jax, MESHES[mesh].encode()), _upload(port, MESHES[mesh].encode())
    assert got.status == want.status == 201 and got.payload == want.payload
    filled = _filled(port)
    assert_close(filled, _filled(jax))
    assert filled["EndpointDependencies"] and filled["SimulatedHistoricalData"]
    assert filled["CombinedRealtimeData"] is None  # reset by each slot's aggregation
    assert_close(port.ctx.store.get_aggregated_data(), jax.ctx.store.get_aggregated_data())
    # the static config generated back from the caches, byte for byte
    want = jax.router.dispatch("GET", "/api/v1/simulation/generateStaticSimConfig")
    got = port.router.dispatch("GET", "/api/v1/simulation/generateStaticSimConfig")
    assert got.status == want.status == 200 and got.payload == want.payload


def _urls(app, pattern):
    if ":namespace?" in pattern:
        base = pattern.replace("/:namespace?", "")
        return [base] + [f"{base}/{ns}" for ns in NAMESPACES]
    return _concrete(app, pattern)


@pytest.mark.parametrize("mesh", ["load", "shop"])
def test_every_shared_get_route_matches_jax_after_an_upload(sim_apps, mesh):
    jax, port = sim_apps
    for app in (jax, port):
        assert _upload(app, MESHES[mesh].encode()).status == 201
        app.router.dispatch("POST", "/api/v1/comparator/diffData", json.dumps({"tag": "t1"}).encode())
    skip = ("/health", "/health/timings", "/telemetry/metrics", "/telemetry/traces")
    checked = 0
    for pattern in sorted(_get_routes(port.router)):
        if pattern.endswith(skip):
            continue
        for url in _urls(port, pattern):
            want, got = jax.router.dispatch("GET", url), port.router.dispatch("GET", url)
            assert got.status == want.status, url
            if pattern.endswith("/export"):
                g, w = (dict(jax.import_export.read_tgz(r.raw_body)) for r in (got, want))
                assert_close(g, w, path=url)
            elif pattern.endswith("/yaml/:uniqueServiceName"):
                assert got.raw_body == want.raw_body, url
            elif pattern.endswith("/tags"):
                assert [t["tag"] for t in got.payload] == [t["tag"] for t in want.payload]
            else:
                assert_close(got.payload, want.payload, path=url)
            checked += 1
    assert checked > 40


BODIES = {
    "missing": b"",
    "blank": b"   ",
    "invalid": b"bogus: true",
    "cycle": (BASIC_YAML + "  - endpointId: rt-get\n    dependOn:\n      - endpointId: pp-get\n").encode(),
    "multipart": (
        b"------testboundary\r\n"
        b'Content-Disposition: form-data; name="file"; filename="sim.yaml"\r\n'
        b"Content-Type: application/x-yaml\r\n\r\n" + BASIC_YAML.encode() + b"\r\n------testboundary--\r\n"
    ),
}


@pytest.mark.parametrize("name", list(BODIES))
def test_the_handler_answers_each_body_as_jax(sim_apps, name):
    jax, port = sim_apps
    want, got = _upload(jax, BODIES[name]), _upload(port, BODIES[name])
    assert (got.status, got.payload) == (want.status, want.payload)
    assert_close(_filled(port), _filled(jax))


def _http(port: int, path: str, body: bytes = None, method: str = None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method=method)
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_over_a_socket_the_upload_and_the_round_trip_match_jax(pinned):
    apps = _sim_apps()
    try:
        for app in apps:
            app.listen(host="127.0.0.1", port=0)
        (jax, port) = (app.server.port for app in apps)
        for p in (jax, port):
            status, body = _http(p, "/api/v1/simulation/startSimulation", SIM_YAML.encode())
            assert status == 201 and json.loads(body) == {"message": "ok"}
        for path in (
            "/api/v1/graph/dependency/endpoint",
            "/api/v1/graph/dependency/service",
            "/api/v1/graph/chord/direct",
            "/api/v1/graph/instability",
            "/api/v1/graph/coupling",
            "/api/v1/graph/cohesion",
            "/api/v1/graph/statistics",
            "/api/v1/data/serviceDisplayInfo",
            "/api/v1/swagger/gateway%09shop%09v1",
            "/api/v1/alert/violation",
        ):
            (ws, wb), (gs, gb) = _http(jax, path), _http(port, path)
            assert gs == ws == 200, path
            assert_close(json.loads(gb), json.loads(wb), path=path)
        status, exported = _http(port, "/api/v1/data/export")
        assert status == 200
        assert_close(dict(apps[1].import_export.read_tgz(exported)), dict(apps[0].import_export.read_tgz(_http(jax, "/api/v1/data/export")[1])))
        before = json.loads(_http(port, "/api/v1/graph/dependency/endpoint")[1])
        assert _http(port, "/api/v1/data/clear", method="DELETE")[0] in (200, 204)
        cleared = json.loads(_http(port, "/api/v1/graph/dependency/endpoint")[1])
        assert len(cleared["nodes"]) == 1  # the external-requests node alone
        assert _http(port, "/api/v1/data/import", exported)[0] in (200, 201)
        after = json.loads(_http(port, "/api/v1/graph/dependency/endpoint")[1])
        assert {n["id"] for n in after["nodes"]} == {n["id"] for n in before["nodes"]}
        # an import in simulator mode keeps the historical data in its cache
        assert apps[1].ctx.cache.get("SimulatedHistoricalData").get_data()
    finally:
        for app in apps:
            app.tear_down()
    # tear_down in simulator mode leaves nothing in the store
    assert apps[1].ctx.store.find_all("EndpointDependencies") == []


@pytest.fixture
def production(pinned):
    """A production port application fed two fixture windows, listening."""
    app = _boot(port_app(Feed(3, 6), now=SIM_NOW_MS), SIM_NOW_MS)
    _run_jobs(app, SIM_NOW_MS)
    app.listen(host="127.0.0.1", port=0)
    yield app
    app.tear_down()


def test_the_clone_route_copies_production_into_both_simulators_alike(production):
    apps = _sim_apps()
    try:
        for app in apps:
            app.ctx.extra["production_service_url"] = f"http://127.0.0.1:{production.server.port}"
        want, got = (app.router.dispatch("POST", "/api/v1/data/cloneDataFromProductionService") for app in apps)
        assert got.status == want.status == 201 and got.payload == want.payload
        jax, port = apps
        deps = port.ctx.cache.get("EndpointDependencies").get_data().to_json()
        assert deps and deps == jax.ctx.cache.get("EndpointDependencies").get_data().to_json()
        assert deps == production.ctx.cache.get("EndpointDependencies").get_data().to_json()
        assert_close(
            [d.to_json() for d in port.ctx.cache.get("EndpointDataType").get_data()],
            [d.to_json() for d in jax.ctx.cache.get("EndpointDataType").get_data()],
        )
        # the clone skips the historical and aggregated collections
        assert port.ctx.store.find_all("HistoricalData") == jax.ctx.store.find_all("HistoricalData") == []
        # an unreachable production answers 500 with the same message
        for app in apps:
            app.ctx.extra["production_service_url"] = "http://127.0.0.1:1"
        want, got = (app.router.dispatch("POST", "/api/v1/data/cloneDataFromProductionService") for app in apps)
        assert (got.status, got.payload) == (want.status, want.payload) and got.status == 500
    finally:
        for app in apps:
            app.tear_down()


def test_the_comparator_pushes_a_simulators_snapshot_to_production(production):
    apps = _sim_apps()
    try:
        for app, tag in zip(apps, ("jax", "port")):
            assert _upload(app, SIM_YAML.encode()).status == 201
            app.ctx.extra["production_service_url"] = f"http://127.0.0.1:{production.server.port}"
            res = app.router.dispatch("POST", "/api/v1/comparator/diffData", json.dumps({"tag": tag}).encode())
            assert res.status == 200
        tagged = {d["tag"]: d for d in production.ctx.cache.get("TaggedDiffDatas").get_data()}
        assert {"[from Simulator] jax", "[from Simulator] port"} <= set(tagged)
        got, want = tagged["[from Simulator] port"], tagged["[from Simulator] jax"]
        assert_close(got["graphData"], want["graphData"])
        assert_close(got["endpointDataTypesMap"], want["endpointDataTypesMap"])
        # a simulator has no /diffData/simulator route; without production it answers 500
        for app in apps:
            assert app.router.dispatch("POST", "/api/v1/comparator/diffData/simulator", b"{}").status == 404
            app.ctx.extra["production_service_url"] = ""
            assert app.router.dispatch("POST", "/api/v1/comparator/diffData", b'{"tag": "x"}').status == 500
    finally:
        for app in apps:
            app.tear_down()

"""The port's graph routes against the JAX package's: both contexts take
the same PDAS traces through operator.retrieve_realtime_data(), and the
seven ported routes of /api/v1/graph give equal payloads. The device
scorer payloads equal the `?scorer=host` oracle's, the payload cache hits
until a merge moves the graph version, a device scorer that raises gives
a 500 (not the host payload), and the chart routes, which read the
historical store, answer as the JAX package's.
"""
from __future__ import annotations

import pytest

from conftest import load_fixture, prefixed_trace_source
from kmamiz_tpu_torch.api.app import build_router
from kmamiz_tpu_torch.server.initializer import AppContext, Initializer
from kmamiz_tpu_torch.server.processor import DataProcessor

FIXTURE_NOW_MS = 1646208500000
ROUTES = [
    "dependency/endpoint",
    "dependency/service",
    "chord/direct",
    "chord/indirect",
    "cohesion",
    "instability",
    "coupling",
]
SCORER_ROUTES = ["cohesion", "instability", "coupling"]


def jax_context(traces):
    """tests/test_api.py's context, without the aggregation."""
    from kmamiz_tpu.config import Settings
    from kmamiz_tpu.server.initializer import AppContext as JaxContext
    from kmamiz_tpu.server.initializer import Initializer as JaxInitializer
    from kmamiz_tpu.server.processor import DataProcessor as JaxProcessor
    from kmamiz_tpu.server.storage import MemoryStore

    s = Settings()
    s.external_data_processor = ""
    processor = JaxProcessor(trace_source=lambda look_back, time, limit: traces, k8s_source=None)
    ctx = JaxContext.build(app_settings=s, store=MemoryStore(), processor=processor)
    ctx.service_utils._now_ms = lambda: FIXTURE_NOW_MS
    JaxInitializer(ctx).register_data_caches()
    return ctx


def port_context(traces=None, trace_source=None):
    processor = DataProcessor(
        trace_source=trace_source or (lambda look_back, time, limit: traces), device="cpu"
    )
    ctx = AppContext(processor=processor)
    Initializer(ctx).register_data_caches()
    return ctx


@pytest.fixture(scope="module")
def routers():
    from kmamiz_tpu.api.app import build_router as jax_build_router

    pdas = [load_fixture("pdas_traces")]
    jctx, pctx = jax_context(pdas), port_context(pdas)
    for ctx in (jctx, pctx):
        ctx.operator.retrieve_realtime_data()
        # a second tick of the same traces merges the cached records per
        # endpoint; before it the host oracle counts the first window's
        # un-merged record rows (the reference's quirk, which the device
        # scorers of both packages do not reproduce)
        ctx.processor._processed.clear()
        ctx.operator.retrieve_realtime_data()
    return jax_build_router(jctx), build_router(pctx), pctx, jctx


def get(router, path):
    return router.dispatch("GET", "/api/v1/graph/" + path)


def canon(payload):
    """Cohesion rows with their consumer lists in name order (the device
    lists them by service id, the host in insertion order)."""
    return [
        {**row, "consumers": sorted(row["consumers"], key=lambda c: c["uniqueServiceName"])}
        if "consumers" in row
        else row
        for row in payload
    ]


@pytest.mark.parametrize("route", ROUTES + [r + "/pdas" for r in ROUTES] + [r + "/nope" for r in SCORER_ROUTES])
def test_route_matches_jax(routers, route):
    jax_router, port_router, _ctx, _jctx = routers
    want, got = get(jax_router, route), get(port_router, route)
    assert got.status == want.status == 200
    assert got.payload == want.payload


@pytest.mark.parametrize("route", SCORER_ROUTES)
def test_device_payload_equals_host_oracle(routers, route):
    _jax, port_router, ctx, _jctx = routers
    dev, host = get(port_router, route), get(port_router, route + "?scorer=host")
    assert dev.status == host.status == 200
    assert dev.payload
    assert canon(dev.payload) == canon(host.payload)
    assert ctx.processor.graph.n_edges > 0


def test_namespace_filter(routers):
    _jax, port_router, _ctx, _jctx = routers
    dev = get(port_router, "instability/pdas")
    assert dev.payload and all("\tpdas\t" in r["uniqueServiceName"] for r in dev.payload)
    assert dev.payload == get(port_router, "instability/pdas?scorer=host").payload
    assert get(port_router, "instability/nope").payload == []


@pytest.mark.parametrize("route", ["line", "statistics", "requests/a%09b%09c", "line/pdas"])
def test_historical_routes_wait_for_the_store(routers, route):
    """The chart routes read the store's historical data, empty before an
    aggregation; they answer as the JAX package's (tests/test_torch_app.py
    holds them after aggregations)."""
    jax_router, port_router, _ctx, _jctx = routers
    want, got = get(jax_router, route), get(port_router, route)
    assert got.status == want.status == 200
    assert got.payload == want.payload


def test_payload_cache_hits_until_a_merge():
    ctx = port_context(trace_source=prefixed_trace_source(load_fixture("pdas_traces"), "c"))
    router = build_router(ctx)
    ctx.operator.retrieve_realtime_data()
    graph = ctx.processor.graph
    calls = {"n": 0}
    scores = graph.service_scores

    def spy(*a, **k):
        calls["n"] += 1
        return scores(*a, **k)

    graph.service_scores = spy
    first = get(router, "instability").payload
    assert get(router, "instability").payload is first
    assert calls["n"] == 1
    version = graph.version
    ctx.operator.retrieve_realtime_data()  # a new window: the version moves
    assert graph.version > version
    again = get(router, "instability").payload
    assert calls["n"] == 2 and again == get(router, "instability?scorer=host").payload


@pytest.mark.parametrize("route,method", [
    ("instability", "service_scores"),
    ("coupling", "service_scores"),
    ("cohesion", "usage_cohesion"),
])
def test_device_error_is_a_500_not_the_host_payload(route, method):
    ctx = port_context([load_fixture("pdas_traces")])
    router = build_router(ctx)
    ctx.operator.retrieve_realtime_data()

    def broken(*a, **k):
        raise RuntimeError("device scorer failed")

    setattr(ctx.processor.graph, method, broken)
    assert get(router, route).status == 500
    host = get(router, route + "?scorer=host")
    assert host.status == 200 and host.payload


def test_empty_graph_answers_from_the_host_path():
    ctx = port_context([])
    router = build_router(ctx)
    for route in SCORER_ROUTES:
        res = get(router, route)
        assert res.status == 200 and res.payload == []


def test_warm_start_serves_the_same_scores():
    """A context restarted from the dependency cache (Initializer.warm_start
    -> graph.load_dependencies) serves the scorer routes like the one
    that merged the windows."""
    live = port_context([load_fixture("pdas_traces")])
    live.operator.retrieve_realtime_data()
    live.processor._processed.clear()
    live.operator.retrieve_realtime_data()
    restarted = port_context([])
    for name in ("EndpointDependencies", "EndpointDataType"):
        restarted.cache.get(name).set_data(live.cache.get(name).get_data())
    restarted.service_utils.update_label()
    assert Initializer(restarted).warm_start() > 0
    live_router, restarted_router = build_router(live), build_router(restarted)
    for route in SCORER_ROUTES:
        got = get(restarted_router, route).payload
        assert got
        assert canon(got) == canon(get(live_router, route).payload)
        assert canon(got) == canon(get(restarted_router, route + "?scorer=host").payload)


def test_mesh_windows_match_jax_on_both_paths():
    """Windows that serve an endpoint many times: the graph keeps every
    edge while the reference's per-window records keep the last record of
    an endpoint, so the device and host payloads differ, in the JAX
    package as in the port; each path equals its JAX twin."""
    import json

    from kmamiz_tpu.api.app import build_router as jax_build_router
    from kmamiz_tpu_torch import synth

    feed = []
    jctx = jax_context(feed)
    pctx = port_context(feed)
    for k in range(2):
        feed[:] = json.loads(
            synth.make_raw_window(120, 7, t_start=k * 120, trace_prefix=f"m{k}-", n_services=40, urls_per_service=3)
        )
        jctx.operator.retrieve_realtime_data()
        pctx.operator.retrieve_realtime_data()
    jax_router, port_router = jax_build_router(jctx), build_router(pctx)
    differs = 0
    for route in SCORER_ROUTES:
        for query in ("", "?scorer=host"):
            want, got = get(jax_router, route + query), get(port_router, route + query)
            assert got.status == want.status == 200
            assert got.payload == want.payload, route + query
        differs += canon(get(port_router, route).payload) != canon(get(port_router, route + "?scorer=host").payload)
    assert differs > 0


@pytest.mark.parametrize("module", ["analytics/endpoint_utils.py", "server/cache.py"])
def test_host_copies_are_verbatim(module):
    """The jax-free host modules the graph routes read are copies: the
    code after the module docstring equals the JAX package's, up to the
    package name."""
    import ast
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent

    def code(path, package):
        text = path.read_text()
        body = ast.parse(text).body
        start = body[1].lineno if isinstance(body[0], ast.Expr) else body[0].lineno
        return "\n".join(text.splitlines()[start - 1:]).replace(package, "PKG")

    assert code(root / "kmamiz_tpu_torch" / module, "kmamiz_tpu_torch") == code(root / "kmamiz_tpu" / module, "kmamiz_tpu")


def test_label_mapping_matches_jax(routers):
    """The label mapping the realtime path built (the label refresh over
    the window's datatypes and dependencies) equals the JAX context's,
    and so do the labels it gives every endpoint."""
    _jax, _port, ctx, jctx = routers
    got, want = ctx.cache.get("LabelMapping"), jctx.cache.get("LabelMapping")
    assert got.to_json() == want.to_json()
    names = ctx.processor.graph.interner.endpoints.strings
    assert names
    assert [got.get_label(n) for n in names] == [want.get_label(n) for n in names]
    for name in ("EndpointDependencies", "LabeledEndpointDependencies", "CombinedRealtimeData"):
        assert ctx.cache.get(name).get_data().to_json() == jctx.cache.get(name).get_data().to_json(), name

    def datatypes(c):
        # a schema's time is the tick's wall clock, which differs between
        # the two contexts
        return [
            {**d.to_json(), "schemas": [{**sc, "time": None} for sc in d.to_json()["schemas"]]}
            for d in c.cache.get("EndpointDataType").get_data()
        ]

    assert datatypes(ctx) == datatypes(jctx)

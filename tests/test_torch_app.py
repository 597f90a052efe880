"""The port's Application against the JAX package's, both on the CPU.

Both applications boot in production mode over their own MemoryStore,
with the schedules registered but set far in the future, and run the same
jobs by hand: realtime ticks of the PDAS and Bookinfo traces (fresh trace
ids per tick, one seeded order) and two aggregations at fixed times. Then
every GET route registered by both answers with equal payloads: integers
and strings equal, latency means at rel 1e-5 / abs 1e-6 and latency CVs,
risks and the numbers derived from them at rel 1e-3 / abs 1e-5, the
processor-equivalence tolerances (tests/test_torch_processor.py).
Wall-clock stamps (`time` of a datatype schema or a tag, `timestamp` of
a tagged interface) are each app's own and are only checked to lie within
ten minutes of the JAX app's, and document ids (`_id`, drawn
at random by each store) are only checked to be present.

Also: export -> clear -> import gives the same export; a store written by
either package's application (a FileStore directory, flushed by
tear_down) boots the other with equal caches and an equal history
snapshot; read-only and serve-only boots answer as the JAX package's; and
the scheduled realtime job runs the processor's tick under its tick lock.
"""
from __future__ import annotations

import json
import math
import random
import threading
import time

import pytest

from conftest import load_fixture
from test_torch_history_persist import normalized
from kmamiz_tpu_torch.api.app import Application
from kmamiz_tpu_torch.config import Settings
from kmamiz_tpu_torch.server.initializer import AppContext
from kmamiz_tpu_torch.server.processor import DataProcessor
from kmamiz_tpu_torch.server.storage import FileStore, MemoryStore

NEVER = "0 0 1 1 *"  # the schedules' cron in these tests: New Year's midnight
MEAN_TOL = dict(rel=1e-5, abs=1e-6)
CV_TOL = dict(rel=1e-3, abs=1e-5)
#: payload keys whose numbers derive from latency CVs (risk, its norm,
#: charts), besides every key naming a risk or a CV
CV_KEYS = {"latencyCV", "cv", "risk", "norm", "impact", "probability", "metrics", "risks"}
MEAN_KEYS = {"latencyMean", "mean"}  # and every key naming a mean


def _fresh_ids(groups, tag):
    out = []
    for g in groups:
        ng = []
        for s in g:
            c = dict(s)
            c["traceId"] = f"{tag}-{s.get('traceId')}"
            c["id"] = f"{tag}-{s.get('id')}"
            if c.get("parentId"):
                c["parentId"] = f"{tag}-{c['parentId']}"
            ng.append(c)
        out.append(ng)
    return out


class Feed:
    """The seeded sequence of realtime windows, the same for both apps:
    window i is one of the two fixtures (cycling after n), with trace ids
    fresh to the call."""

    def __init__(self, seed: int, n: int) -> None:
        rng = random.Random(seed)
        pdas, bookinfo = [load_fixture("pdas_traces")], load_fixture("bookinfo_traces")
        self.windows = [rng.choice([pdas, bookinfo]) for _ in range(n)]
        self.next = 0

    def __call__(self, look_back, end_ts, limit):
        i = self.next
        self.next += 1
        return _fresh_ids(self.windows[i % len(self.windows)], f"w{i}")


def _settings(cls, storage_uri="memory://", **kw):
    s = cls()
    s.storage_uri = storage_uri
    s.external_data_processor = ""
    s.static_dir = ""
    s.wasm_path = ""
    s.model_dir = ""
    s.realtime_interval = s.aggregate_interval = s.dispatch_interval = NEVER
    for k, v in kw.items():
        setattr(s, k, v)
    return s


def jax_app(feed, store=None, now=None, **kw):
    from kmamiz_tpu.api.app import Application as JaxApplication
    from kmamiz_tpu.config import Settings as JaxSettings
    from kmamiz_tpu.server.initializer import AppContext as JaxContext
    from kmamiz_tpu.server.processor import DataProcessor as JaxProcessor
    from kmamiz_tpu.server.storage import MemoryStore as JaxMemoryStore

    s = _settings(JaxSettings, **kw)
    proc = JaxProcessor(trace_source=feed, use_device_stats=False) if feed else None
    ctx = JaxContext.build(app_settings=s, store=store or JaxMemoryStore(), processor=proc)
    return _pin_clocks(JaxApplication(ctx=ctx), now)


def port_app(feed, store=None, now=None, **kw):
    s = _settings(Settings, **kw)
    proc = DataProcessor(trace_source=feed, device="cpu") if feed else None
    ctx = AppContext.build(app_settings=s, store=store or MemoryStore(), processor=proc)
    return _pin_clocks(Application(ctx=ctx), now)


def _pin_clocks(app, now):
    if now is not None:
        app.ctx.service_utils._now_ms = lambda: now
    return app


def _boot(app, now):
    app.start_up()
    if now is not None and "LookBackRealtimeData" in app.ctx.cache.get_all():
        app.ctx.cache.get("LookBackRealtimeData")._now_ms = lambda: now
    return app


def _run_jobs(app, now):
    op = app.ctx.operator
    for _ in range(3):
        op.retrieve_realtime_data()
    op.create_historical_and_aggregated_data(create_time_ms=now - 120_000)
    for _ in range(2):
        op.retrieve_realtime_data()
    op.create_historical_and_aggregated_data(create_time_ms=now - 60_000)
    op.retrieve_realtime_data()


@pytest.fixture(scope="module")
def apps():
    mp = pytest.MonkeyPatch()
    mp.setenv("KMAMIZ_PREWARM", "0")
    now = int(time.time() * 1000)
    jax = _boot(jax_app(Feed(3, 6), now=now), now)
    port = _boot(port_app(Feed(3, 6), now=now), now)
    for app in (jax, port):
        _run_jobs(app, now)
    yield jax, port, now
    for app in (jax, port):
        app.tear_down()
    mp.undo()


def _tolerance(key):
    k = key.lower()
    if key in CV_KEYS or "risk" in k or "cv" in k:
        return CV_TOL
    if key in MEAN_KEYS or "mean" in k:
        return MEAN_TOL
    return dict(rel=1e-12, abs=0)


def assert_close(got, want, key="", path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            assert_close(got[k], want[k], k, f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, key, f"{path}[{i}]")
    elif key == "_id":
        assert isinstance(got, str) and got, path  # each store draws its own ids
    elif key in ("time", "timestamp") and not path.startswith("/api/v1/graph/requests"):
        # wall-clock stamps (a datatype schema's tick, a tag's creation),
        # each app's own
        assert isinstance(got, (int, float)) and abs(got - want) < 600_000, path
    elif isinstance(want, float):
        if math.isnan(want):
            assert math.isnan(got), path
        else:
            assert got == pytest.approx(want, **_tolerance(key)), path
    else:
        assert got == want, path


def _get_routes(router):
    return {r.split("] ", 1)[1] for r in router.route_list if r.startswith("[GET]")}


def _concrete(app, path):
    """Concrete URLs for a route pattern, from the app's own data."""
    dts = [d.to_json() for d in app.ctx.cache.get("EndpointDataType").get_data()]
    label = app.ctx.cache.get("LabelMapping").get_label
    names = sorted(d["uniqueEndpointName"] for d in dts)
    services = sorted({d["uniqueServiceName"] for d in dts})
    label_names = [
        "\t".join(n.split("\t")[:4] + [label(n)]) for n in names[:2]
    ]
    quote = lambda s: s.replace("\t", "%09").replace("/", "%2F")  # noqa: E731
    if ":namespace?" in path:
        base = path.replace("/:namespace?", "")
        return [base, base + "/pdas", base + "/book", base + "/nope"]
    if ":uniqueLabelName" in path:
        return [path.replace(":uniqueLabelName", quote(n)) for n in label_names] + [
            path.replace(":uniqueLabelName", "a%09b")
        ]
    if ":uniqueName" in path:
        return [path.replace(":uniqueName", quote(s)) for s in services[:2]] + [
            path.replace(":uniqueName", quote(label_names[0])) + "?ignoreServiceVersion=true"
        ]
    if ":uniqueServiceName" in path:
        return [path.replace(":uniqueServiceName", quote(s)) for s in services[:2]]
    if path.endswith("/interface"):
        return [path + "?uniqueLabelName=" + quote(label_names[0]), path]
    if path.endswith("/diffData"):
        return [path, path + "?tag=t1"]
    return [path]


def test_every_shared_get_route_matches_jax(apps):
    jax, port, _now = apps
    shared = _get_routes(jax.router) & _get_routes(port.router)
    assert shared == _get_routes(port.router)  # every port GET route is the JAX app's
    # a tagged diff snapshot and a swagger tag, so those routes have data
    for app in (jax, port):
        app.router.dispatch("POST", "/api/v1/comparator/diffData", json.dumps({"tag": "t1"}).encode())
    checked = 0
    for pattern in sorted(shared):
        for url in _concrete(port, pattern):
            want, got = jax.router.dispatch("GET", url), port.router.dispatch("GET", url)
            assert got.status == want.status, url
            if pattern.endswith("/health"):
                assert got.payload["status"] == want.payload["status"] == "UP"
                continue
            if pattern.endswith("/health/timings"):
                # the port keeps no program registry: no `programs` section
                assert set(got.payload) == set(want.payload) - {"programs"}, url
                assert got.payload["phases"] and set(got.payload["resilience"]) <= set(want.payload["resilience"])
                continue
            if pattern.endswith("/telemetry/metrics"):
                assert got.content_type == want.content_type == "text/plain; version=0.0.4; charset=utf-8"
                assert b"kmamiz_ticks_total" in got.raw_body and b"kmamiz_ticks_total" in want.raw_body
                continue
            if pattern.endswith("/telemetry/traces"):
                # each package's own ring (the JAX conftest empties its ring
                # between tests): Zipkin groups with one root each
                assert isinstance(got.payload, list) and isinstance(want.payload, list)
                assert all(sum(s["parentId"] is None for s in g) == 1 for g in got.payload)
                continue
            if pattern.endswith("/export"):
                g, w = (dict(jax.import_export.read_tgz(r.raw_body)) for r in (got, want))
                assert_close(g, w, path=url)
                continue
            if pattern.endswith("/yaml/:uniqueServiceName"):
                assert got.raw_body == want.raw_body, url
                continue
            if isinstance(want.payload, list) and pattern.endswith("/tags"):
                # tag times are each app's wall clock
                assert [t["tag"] for t in got.payload] == [t["tag"] for t in want.payload]
                continue
            if pattern.endswith("/diffData"):
                assert_close(got.payload["graphData"], want.payload["graphData"], path=url)
                assert_close(got.payload["endpointDataTypesMap"], want.payload["endpointDataTypesMap"], path=url)
                continue
            assert_close(got.payload, want.payload, path=url)
            checked += 1
    assert checked > 40


def test_jobs_filled_the_store_like_jax(apps):
    jax, port, now = apps
    for app in (jax, port):
        app.ctx.dispatch.sync_all()

    def ordered(docs):
        return sorted(docs, key=lambda d: json.dumps(
            {k: v for k, v in d.items() if k not in ("_id", "schemas")}, sort_keys=True
        ))

    for c in ("HistoricalData", "EndpointDependencies", "EndpointDataType", "CombinedRealtimeData"):
        g, w = port.ctx.store.find_all(c), jax.ctx.store.find_all(c)
        assert len(g) == len(w) > 0, c
        if c != "CombinedRealtimeData":  # reset by each aggregation: the last tick's rows
            assert_close(ordered(g), ordered(w), path=c)
    assert_close(port.ctx.store.get_aggregated_data(), jax.ctx.store.get_aggregated_data())


def test_history_snapshot_is_persisted(apps):
    _jax, port, _now = apps
    port.ctx.dispatch.sync_all()
    docs = port.ctx.store.find_all("ModelHistoryState")
    assert docs and docs[0]["parts"] == len(docs)
    assert json.dumps(sorted(docs, key=lambda d: d["part"])[0]["names"]) == json.dumps(
        port.ctx.processor.snapshot_history()[0]["names"]
    )


def test_export_clear_import_round_trip(apps):
    _jax, port, _now = apps
    ie = port.import_export
    blob = ie.export_tgz()
    before = dict(ie.read_tgz(blob))
    ie.clear_data()
    assert port.ctx.store.find_all("HistoricalData") == []
    empty = port.router.dispatch("GET", "/api/v1/graph/dependency/endpoint").payload
    assert [n["id"] for n in empty["nodes"]] == ["null"] and empty["links"] == []
    assert port.router.dispatch("POST", "/api/v1/data/import", blob).status == 404  # testing endpoints off
    assert ie.import_data(ie.read_tgz(blob))
    after = dict(ie.read_tgz(ie.export_tgz()))
    assert_close(after, before)
    assert "ModelHistoryState" in port.ctx.cache.get_all()  # re-registered after the swap


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_store_written_by_either_package_boots_the_other(tmp_path, monkeypatch, writer):
    from kmamiz_tpu.server.storage import FileStore as JaxFileStore

    monkeypatch.setenv("KMAMIZ_PREWARM", "0")
    now = int(time.time() * 1000)
    make = {"jax": (jax_app, JaxFileStore), "port": (port_app, FileStore)}
    build, store_cls = make[writer]
    first = _boot(build(Feed(5, 4), store=store_cls(str(tmp_path)), now=now), now)
    _run_jobs(first, now)
    first.tear_down()  # stops the schedules, flushes every cache
    want_hist = first.ctx.processor.snapshot_history()

    jax = _boot(jax_app(Feed(9, 1), store=JaxFileStore(str(tmp_path)), now=now), now)
    port = _boot(port_app(Feed(9, 1), store=FileStore(str(tmp_path)), now=now), now)
    try:
        for name in ("EndpointDependencies", "CombinedRealtimeData", "EndpointDataType", "UserDefinedLabel"):
            assert_close(port.ctx.cache.get(name).to_json(), jax.ctx.cache.get(name).to_json(), path=name)
        for app in (jax, port):
            got = app.ctx.processor.snapshot_history()
            assert [{**d, "savedAt": 0} for d in normalized(got)] == [
                {**d, "savedAt": 0} for d in normalized(want_hist)
            ]
        # the graph warm-started from the dependency records in both
        assert port.ctx.processor.graph.n_edges > 0
        assert port.ctx.processor.graph.n_edges == jax.ctx.processor.graph.n_edges
        for url in ("/api/v1/graph/instability", "/api/v1/graph/coupling", "/api/v1/data/history"):
            assert_close(
                port.router.dispatch("GET", url).payload, jax.router.dispatch("GET", url).payload, path=url
            )
    finally:
        jax.tear_down()
        port.tear_down()


@pytest.mark.parametrize("mode", ["read_only_mode", "serve_only"])
def test_read_only_and_serve_only_boots(tmp_path, monkeypatch, mode):
    from kmamiz_tpu.server.storage import FileStore as JaxFileStore

    monkeypatch.setenv("KMAMIZ_PREWARM", "0")
    now = int(time.time() * 1000)
    writer = _boot(port_app(Feed(4, 3), store=FileStore(str(tmp_path)), now=now), now)
    _run_jobs(writer, now)
    writer.tear_down()
    files = {p.name: p.read_bytes() for p in tmp_path.iterdir()}

    jax = _boot(jax_app(Feed(4, 1), store=JaxFileStore(str(tmp_path)), now=now, **{mode: True}), now)
    port = _boot(port_app(Feed(4, 1), store=FileStore(str(tmp_path)), now=now, **{mode: True}), now)
    try:
        assert port.ctx.scheduler.jobs == [] == jax.ctx.scheduler.jobs
        for url in (
            "/api/v1/data/aggregate",
            "/api/v1/data/history",
            "/api/v1/graph/dependency/endpoint",
            "/api/v1/graph/line",
            "/api/v1/graph/statistics",
            "/api/v1/data/label",
            "/api/v1/alert/violation",
        ):
            want, got = jax.router.dispatch("GET", url), port.router.dispatch("GET", url)
            assert got.status == want.status, url
            assert_close(got.payload, want.payload, path=url)
        if mode == "read_only_mode":
            assert port.router.dispatch("GET", "/api/v1/data/history").payload
    finally:
        jax.tear_down()
        port.tear_down()
    # neither mode writes the store at tear_down
    assert {p.name: p.read_bytes() for p in tmp_path.iterdir()} == files


def test_simulator_mode_boots():
    """Simulator mode starts with no processor, registers the simulation
    handler's two routes and reports the mode."""
    app = port_app(None, simulator_mode=True)
    app.start_up()
    try:
        routes = "\n".join(app.router.route_list)
        assert "/api/v1/simulation/startSimulation" in routes
        assert "/api/v1/simulation/generateStaticSimConfig" in routes
        res = app.router.dispatch("GET", "/api/v1/configuration/config")
        assert res.status == 200 and res.payload == {"SimulatorMode": True}
        assert app.ctx.processor is None
    finally:
        app.tear_down()


def test_scheduled_realtime_job_ticks_under_the_tick_lock(monkeypatch):
    """A one-second cron fires the realtime job on the scheduler's thread;
    each tick runs under the processor's tick lock, so ticks started from
    another thread (as the DP server's POST / starts them) never overlap a
    scheduled one; tear_down stops the schedules before its flush."""
    app = port_app(Feed(1, 3), realtime_interval="* * * * * *")
    proc = app.ctx.processor
    state = {"active": 0, "peak": 0, "ticks": 0, "unlocked": 0}
    real_prepare, real_finish = proc.prepare_tick, proc.finish_tick

    def prepare(request):
        state["unlocked"] += not proc.tick_lock.locked()
        state["active"] += 1
        state["peak"] = max(state["peak"], state["active"])
        time.sleep(0.05)
        return real_prepare(request)

    def finish(p):
        out = real_finish(p)
        state["active"] -= 1
        state["ticks"] += 1
        return out

    monkeypatch.setattr(proc, "prepare_tick", prepare)
    monkeypatch.setattr(proc, "finish_tick", finish)
    app.start_up()

    def outside():
        for i in range(6):
            proc.collect({"uniqueId": f"post{i}", "lookBack": 30_000})

    t = threading.Thread(target=outside)
    t.start()
    try:
        deadline = time.monotonic() + 10
        while state["ticks"] < 9 and time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        t.join(30)
        app.tear_down()
    assert not t.is_alive()
    assert state["ticks"] >= 8 and state["peak"] == 1 and state["unlocked"] == 0
    n = state["ticks"]
    time.sleep(1.2)
    assert state["ticks"] == n  # no tick after tear_down
    assert app.ctx.store.find_all("EndpointDependencies")  # flushed


def test_label_refresh_reuses_unchanged_services_with_the_same_result(apps):
    """ServiceUtils._label_mapping (a service's mapping reused while its
    datatypes are unchanged) gives create_endpoint_label_mapping's result,
    order included, before and after a service's schemas change."""
    from kmamiz_tpu_torch.analytics.endpoint_utils import create_endpoint_label_mapping
    from kmamiz_tpu_torch.domain.endpoint_data_type import EndpointDataType

    _jax, port, _now = apps
    utils = port.ctx.service_utils
    dts = list(port.ctx.cache.get("EndpointDataType").get_data())
    assert len({d.to_json()["uniqueServiceName"] for d in dts}) > 1
    for _ in range(2):
        got = utils._label_mapping(dts)
        want = create_endpoint_label_mapping(dts)
        assert list(got.items()) == list(want.items())
    # one service's schema changes: its mapping is recomputed
    j = dts[0].to_json()
    changed = {**j, "schemas": [{**s, "responseSchema": "interface Root {\n  x: number;\n}"} for s in j["schemas"]]}
    dts[0] = EndpointDataType(changed)
    got = utils._label_mapping(dts)
    assert list(got.items()) == list(create_endpoint_label_mapping(dts).items())


def test_label_refresh_reuses_a_mapping_across_a_ticks_restamp(apps, monkeypatch):
    """A realtime tick re-stamps the schemas it merges (new times, the
    statuses reordered by time, a missing interface where the empty one
    was): what the mapping reads is unchanged, so every service's mapping
    is reused, and it equals create_endpoint_label_mapping's."""
    from kmamiz_tpu_torch.analytics.endpoint_utils import create_endpoint_label_mapping
    from kmamiz_tpu_torch.domain.endpoint_data_type import EndpointDataType
    from kmamiz_tpu_torch.server import service_utils

    root = "interface Root {\n}"
    swap = {None: root, root: None}
    _jax, port, _now = apps
    utils = port.ctx.service_utils
    dts = []
    for i, d in enumerate(port.ctx.cache.get("EndpointDataType").get_data()):
        j = d.to_json()
        extra = [{**j["schemas"][0], "status": "500", "time": 1}] if i % 2 else []
        dts.append(EndpointDataType({**j, "schemas": j["schemas"] + extra}))
    utils._label_mapping(dts)
    restamped = []
    for d in dts:
        j = d.to_json()
        schemas = [
            {
                **sc,
                "time": (sc.get("time") or 0) + 5_000,
                "requestSchema": swap.get(sc.get("requestSchema"), sc.get("requestSchema")),
                "responseSchema": swap.get(sc.get("responseSchema"), sc.get("responseSchema")),
            }
            for sc in reversed(j["schemas"])
        ]
        restamped.append(EndpointDataType({**j, "schemas": schemas}))
    assert any(len(d.to_json()["schemas"]) > 1 for d in dts)
    calls = []
    monkeypatch.setattr(
        service_utils, "create_endpoint_label_mapping", lambda x: calls.append(x) or create_endpoint_label_mapping(x)
    )
    got = utils._label_mapping(restamped)
    assert calls == []
    assert list(got.items()) == list(create_endpoint_label_mapping(restamped).items())


def test_a_tick_during_a_slow_relabel_keeps_its_newer_data():
    """A realtime tick's set_data that lands while a GET labels the
    dependency view neither waits for the labeling nor is overwritten by
    its result: the reader gets the labeled view of the data it read,
    the cache keeps the tick's data, and the next read labels that."""
    import copy

    from kmamiz_tpu_torch.domain.endpoint_dependencies import EndpointDependencies
    from kmamiz_tpu_torch.server.cache import Cacheable
    from kmamiz_tpu_torch.server.cacheables import CLabeledEndpointDependencies

    records = load_fixture("pdas_endpoint_dependencies")
    half = len(records) // 2
    old, new = copy.deepcopy(records[:half]), copy.deepcopy(records[half:])
    assert old and new

    def names(deps):
        return [d["endpoint"]["uniqueEndpointName"] for d in deps.to_json()]

    tick_done = threading.Event()

    def slow_label(name):
        if not tick_done.is_set():
            # the tick runs on its own thread, as the scheduler's does
            tick = threading.Thread(target=cache.set_data, args=(EndpointDependencies(copy.deepcopy(new)),))
            tick.start()
            tick.join(timeout=10)
            assert not tick.is_alive(), "set_data waited for the labeling"
            tick_done.set()
        return "label:" + name

    cache = CLabeledEndpointDependencies(old, get_label=slow_label, label_version=lambda: 0)
    seen = cache.get_data()
    assert tick_done.is_set()
    assert names(seen) == [d["endpoint"]["uniqueEndpointName"] for d in old]
    assert all(d["endpoint"]["labelName"] == "label:" + d["endpoint"]["uniqueEndpointName"] for d in seen.to_json())
    # the tick's data won: stored as set, not the reader's older view
    assert names(Cacheable.get_data(cache)) == [d["endpoint"]["uniqueEndpointName"] for d in new]
    assert "labelName" not in Cacheable.get_data(cache).to_json()[0]["endpoint"]
    after = cache.to_json()
    assert [d["endpoint"]["uniqueEndpointName"] for d in after] == names(Cacheable.get_data(cache))
    assert all(d["endpoint"]["labelName"] == "label:" + d["endpoint"]["uniqueEndpointName"] for d in after)
    # labeled once for this version and mapping: the next read reuses it
    version = cache.version
    cache.get_data()
    assert cache.version == version


def test_external_data_processor_and_its_fallback():
    """With EXTERNAL_DATA_PROCESSOR set, the realtime tick posts the DP
    request there (here the port's own DP server) through the breaker and
    the retrier, and merges the answer as the in-process path would; an
    unreachable one falls back to the in-process processor and counts it."""
    import socket

    from kmamiz_tpu_torch.resilience import breaker
    from kmamiz_tpu_torch.resilience import metrics as res_metrics
    from kmamiz_tpu_torch.server.dp_server import DataProcessorServer

    breaker.reset_for_tests()
    res_metrics.reset_for_tests()
    external = DataProcessorServer(DataProcessor(trace_source=Feed(2, 2), device="cpu"), host="127.0.0.1", port=0)
    external.start()
    try:
        # no in-process processor: the answer can only come over HTTP
        via_http = port_app(None, external_data_processor=f"http://127.0.0.1:{external.port}/")
        via_http.initializer.register_data_caches()
        in_process = port_app(Feed(2, 2))
        in_process.initializer.register_data_caches()
        for app in (via_http, in_process):
            app.ctx.operator.retrieve_realtime_data()
        assert res_metrics.get("dpFallback") == 0
        for name in ("EndpointDependencies", "EndpointDataType"):
            got = via_http.ctx.cache.get(name).to_json()
            want = in_process.ctx.cache.get(name).to_json()
            assert got, name
            assert_close(got, want, path=name)
    finally:
        external.stop()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = s.getsockname()[1]
    fallback = port_app(Feed(2, 2), external_data_processor=f"http://127.0.0.1:{dead}/")
    fallback.initializer.register_data_caches()
    fallback.ctx.operator.retrieve_realtime_data()
    assert res_metrics.get("dpFallback") == 1
    assert fallback.ctx.cache.get("EndpointDependencies").get_data()
    breaker.reset_for_tests()
    res_metrics.reset_for_tests()

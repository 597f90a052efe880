"""The port's telemetry (kmamiz_tpu_torch/telemetry/, core/profiling.py,
analysis/guards.py) against the JAX package's, on the CPU.

- the registry's Prometheus text is byte-equal for the same
  registrations and observations, and the process registry's exposition
  conforms to 0.0.4 after a tick;
- after the same fixture ticks (Bookinfo, PDAS, a seeded synth window) on
  both packages' processors, the span trees are equal in names and parent
  links, the step timer knows the same phases, and the shared families
  (ticks, ingest payloads, quarantined, resilience counters, stale serves,
  watchdog trips) hold the same values after the same DP-server scenario;
- each package's /debug/traces export, re-ingested by its own raw path,
  gives the same endpoint and edge sets (the self-trace);
- the step timer's summary is equal for the same observations;
- trace()'s cap and busy guard behave as tests/test_profiling.py pins for
  the JAX package, with torch.profiler stubbed;
- the sync guard's level parsing is the JAX package's, and on a CPU
  device the guard is a no-op that reports 0;
- the scorecard's math, the device gauges on a CPU processor, and the HTTP
  surfaces: the DP's /metrics, /timings, /debug/traces and
  /debug/profile, the REST API's /api/v1/telemetry/* and
  /health/timings.

The JAX side runs its segment stats on the Pallas kernel in interpret
mode (KMAMIZ_SEGMENT_BACKEND=pallas_interpret), as the other port tests.
"""
from __future__ import annotations

import contextlib
import json
import re
import threading
import urllib.error
import urllib.request

import pytest
import torch

from kmamiz_tpu import telemetry as jax_telemetry
from kmamiz_tpu.analysis import guards as jax_guards
from kmamiz_tpu.core.profiling import StepTimer as JaxStepTimer
from kmamiz_tpu.core.profiling import step_timer as jax_step_timer
from kmamiz_tpu.resilience.chaos import graph_signature as jax_signature
from kmamiz_tpu.server.processor import DataProcessor as JaxProcessor
from kmamiz_tpu.telemetry.registry import MetricsRegistry as JaxRegistry
from kmamiz_tpu_torch import synth, telemetry
from kmamiz_tpu_torch.analysis import guards
from kmamiz_tpu_torch.core import profiling
from kmamiz_tpu_torch.core.profiling import StepTimer, step_timer
from kmamiz_tpu_torch.graph.store import graph_signature
from kmamiz_tpu_torch.resilience import breaker, metrics, quarantine
from kmamiz_tpu_torch.server.dp_server import DataProcessorServer
from kmamiz_tpu_torch.server.processor import DataProcessor
from kmamiz_tpu_torch.telemetry import REGISTRY, SCORECARD, TRACER, slo
from kmamiz_tpu_torch.telemetry.registry import MetricsRegistry
from kmamiz_tpu_torch.telemetry.tracing import PHASES, phase_span

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_SAMPLE_RE = re.compile(r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(?P<labels>[^}]*)\})? (?P<value>\S+)$")


def parse_exposition(text: str):
    """(types, samples): types[name] = counter|gauge|histogram, samples =
    [(name, labels-dict, value)]. Raises on any malformed line."""
    types, samples = {}, []
    for line in text.strip().splitlines():
        if line.startswith("# HELP"):
            continue
        if line.startswith("# TYPE"):
            _, _, name, kind = line.split(maxsplit=3)
            assert _NAME_RE.match(name), name
            assert kind in ("counter", "gauge", "histogram"), line
            types[name] = kind
            continue
        m = _SAMPLE_RE.match(line)
        assert m, f"malformed sample line: {line!r}"
        labels = {}
        if m.group("labels"):
            for k, v in re.findall(r'(\w+)="((?:[^"\\]|\\.)*)"', m.group("labels")):
                labels[k] = v
        samples.append((m.group("name"), labels, float(m.group("value"))))
    return types, samples


def assert_conformant(text: str) -> None:
    """Every histogram: cumulative buckets, monotonic, +Inf == _count."""
    types, samples = parse_exposition(text)
    for name, kind in types.items():
        if kind != "histogram":
            continue
        series = {}
        for sname, labels, value in samples:
            if sname == f"{name}_bucket":
                key = tuple(sorted((k, v) for k, v in labels.items() if k != "le"))
                series.setdefault(key, []).append((labels["le"], value))
        counts = {
            tuple(sorted(labels.items())): value for sname, labels, value in samples if sname == f"{name}_count"
        }
        for key, buckets in series.items():
            assert buckets[-1][0] == "+Inf", name
            values = [v for _le, v in buckets]
            assert values == sorted(values), name
            assert values[-1] == counts[key], name


def family_values(text: str, names) -> dict:
    _types, samples = parse_exposition(text)
    return {(n, tuple(sorted(lab.items()))): v for n, lab, v in samples if n in names}


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    monkeypatch.setenv("KMAMIZ_SEGMENT_BACKEND", "pallas_interpret")
    monkeypatch.setenv("KMAMIZ_PROF_FLIGHT_DIR", str(tmp_path / "flight"))
    monkeypatch.setenv("KMAMIZ_QUARANTINE_DIR", str(tmp_path / "quarantine"))
    for mod in (telemetry, breaker, metrics, quarantine):
        mod.reset_for_tests()
    step_timer.reset()
    jax_step_timer.reset()
    yield
    for mod in (telemetry, breaker, metrics, quarantine):
        mod.reset_for_tests()


def fixture_windows():
    from conftest import load_fixture

    return {
        "bookinfo": load_fixture("bookinfo_traces"),
        "pdas": [load_fixture("pdas_traces")],
        "synth": json.loads(synth.make_raw_window(60, 7, n_services=50, urls_per_service=4)),
    }


def span_tree(spans):
    """The trace as a canonical tree: (name, sorted children)."""

    def canon(i):
        return (spans[i][0], tuple(sorted(canon(k) for k in range(len(spans)) if spans[k][3] == i)))

    return canon(0)


# -- the registry -------------------------------------------------------------


def _fill(reg, *, escape: bool):
    c = reg.counter("t_total", "a counter")
    g = reg.gauge("t_gauge", "a gauge")
    h = reg.histogram("t_ms", "a histogram", buckets=(1, 5, 10))
    fam = reg.counter_family("t_labeled_total", "per phase", ("phase",))
    hfam = reg.histogram_family("t_phase_ms", "per phase hist", ("phase", "kind"))
    c.inc()
    c.inc(2.5)
    g.set(-3)
    for v in (0.5, 1, 4.2, 7, 12, 1e9):
        h.observe(v)
    fam.handle("parse").inc(3)
    fam.handle('we"ird\\name\n' if escape else "merge").inc()
    hfam.handle("walk", "a").observe(0.25)
    hfam.handle("walk", "b").observe(3000)
    return reg


@pytest.mark.parametrize("escape", [False, True], ids=["plain", "escaped-labels"])
def test_render_is_byte_equal_to_jax(escape):
    assert _fill(MetricsRegistry(), escape=escape).render() == _fill(JaxRegistry(), escape=escape).render()


def test_reset_keeps_handles_and_render_equal():
    port, jax = _fill(MetricsRegistry(), escape=False), _fill(JaxRegistry(), escape=False)
    port.reset_for_tests()
    jax.reset_for_tests()
    assert port.render() == jax.render()
    with pytest.raises(ValueError):
        port.gauge("t_total")


def test_process_registry_conforms_after_a_tick():
    groups = fixture_windows()["pdas"]
    DataProcessor(trace_source=lambda lb, t, lim: groups, device="cpu").collect({"uniqueId": "a", "time": 0})
    text = REGISTRY.render()
    assert_conformant(text)
    assert 'kmamiz_tick_span_ms_bucket{phase="parse",le="+Inf"}' in text
    assert REGISTRY.get_value("kmamiz_ticks_total") == 1


# -- the tick's spans, against the JAX processor --------------------------------


@pytest.mark.parametrize("name", ["bookinfo", "pdas", "synth"])
def test_span_tree_and_step_phases_match_jax(name, monkeypatch):
    monkeypatch.setenv("KMAMIZ_TELEMETRY", "1")
    groups = fixture_windows()[name]
    request = {"uniqueId": name, "lookBack": 30_000, "time": 0}
    JaxProcessor(trace_source=lambda lb, t, lim: groups).collect(dict(request))
    DataProcessor(trace_source=lambda lb, t, lim: groups, device="cpu").collect(dict(request))
    got, want = TRACER.traces()[-1].spans, jax_telemetry.TRACER.traces()[-1].spans
    assert span_tree(got) == span_tree(want)
    assert {s[0] for s in got} <= set(PHASES) | {"dp-tick"}
    for i, (_name, _start, dur, parent) in enumerate(got):
        assert dur >= 0 and parent < i
    assert set(step_timer.summary()) == set(jax_step_timer.summary())


def test_disabled_telemetry_records_no_trace(monkeypatch):
    monkeypatch.setenv("KMAMIZ_TELEMETRY", "0")
    groups = fixture_windows()["pdas"]
    DataProcessor(trace_source=lambda lb, t, lim: groups, device="cpu").collect({"uniqueId": "a", "time": 0})
    assert TRACER.traces() == []
    assert REGISTRY.get_value("kmamiz_ticks_total") == 1  # the registry stays live


def test_nested_spans_and_a_span_from_another_thread():
    with TRACER.tick():
        with phase_span("parse"):
            pass
        with phase_span("merge"):
            with phase_span("pack"):
                pass
        t0 = telemetry.profiling.events.now_ns()
        TRACER.record_span("fetch_cluster_state", t0, t0 + 5_000_000)
    spans = TRACER.traces()[-1].spans
    assert [s[0] for s in spans] == ["dp-tick", "parse", "merge", "pack", "fetch_cluster_state"]
    assert [s[3] for s in spans] == [-1, 0, 0, 2, 0]
    assert spans[4][2] == 5_000_000
    assert REGISTRY.get_value("kmamiz_tick_span_ms", ("fetch_cluster_state",)) == 1


def test_reentrant_tick_keeps_one_trace():
    with TRACER.tick(root_name="outer"):
        with TRACER.tick(root_name="inner") as inner:
            assert inner is None
            with phase_span("merge"):
                pass
    assert [s[0] for s in TRACER.traces()[-1].spans] == ["outer", "merge"]


def _dp_scenario(server_cls, processor, source, raw_ok: bytes, raw_bad: bytes) -> None:
    """A good tick, a faulted tick (stale serve + a watchdog trip), a clean
    and a malformed /ingest, over HTTP."""
    server = server_cls(processor, host="127.0.0.1", port=0)
    server.start()
    try:
        for mode, uid in (("ok", "good"), ("fail", "faulted")):
            source.mode = mode
            status, _ = post(server.port, "/", json.dumps({"uniqueId": uid, "lookBack": 30_000, "time": 0}).encode())
            assert status == 200
        for raw in (raw_ok, raw_bad):
            status, _ = post(server.port, "/ingest", raw)
            assert status == 200
    finally:
        server.stop()


class _Source:
    def __init__(self, groups) -> None:
        self.mode, self.groups = "ok", groups

    def __call__(self, lb, t, lim):
        if self.mode == "fail":
            raise ConnectionError("upstream down")
        return self.groups


SHARED_FAMILIES = (
    "kmamiz_ticks_total",
    "kmamiz_ingest_payloads_total",
    "kmamiz_quarantined_total",
    "kmamiz_resilience_total",
    "kmamiz_stale_serves_total",
    "kmamiz_watchdog_trips_total",
)


def test_shared_families_hold_the_jax_values_after_the_same_scenario(monkeypatch):
    from kmamiz_tpu.server.dp_server import DataProcessorServer as JaxServer

    monkeypatch.delenv("KMAMIZ_TICK_DEADLINE_MS", raising=False)
    groups = fixture_windows()["bookinfo"]
    raw_ok = synth.make_raw_window(20, 4, t_start=0, trace_prefix="ingest-")
    raw_bad = b'[[{"traceId": "x", "id": '
    port_source, jax_source = _Source(groups), _Source(groups)
    port = DataProcessor(trace_source=port_source, device="cpu", wal=None)
    _dp_scenario(DataProcessorServer, port, port_source, raw_ok, raw_bad)
    _dp_scenario(JaxServer, JaxProcessor(trace_source=jax_source, use_device_stats=False), jax_source, raw_ok, raw_bad)
    # the nonzero cells: a reset zeroes the cells that earlier tests of the
    # process registered, and keeps them
    got = {k: v for k, v in family_values(REGISTRY.render(), SHARED_FAMILIES).items() if v}
    want = {k: v for k, v in family_values(jax_telemetry.REGISTRY.render(), SHARED_FAMILIES).items() if v}
    assert got == want
    assert got[("kmamiz_stale_serves_total", ())] == 1
    assert got[("kmamiz_quarantined_total", ())] == 1
    assert got[("kmamiz_ingest_payloads_total", ())] == 2


# -- the self-trace round trip ----------------------------------------------------


@pytest.mark.parametrize("name", ["pdas", "synth"])
def test_each_export_reingests_to_the_same_graph(name):
    groups = fixture_windows()[name]
    request = {"uniqueId": "self", "lookBack": 30_000, "time": 0}
    DataProcessor(trace_source=lambda lb, t, lim: groups, device="cpu").collect(dict(request))
    JaxProcessor(trace_source=lambda lb, t, lim: groups).collect(dict(request))
    exports = (TRACER.export_zipkin(), jax_telemetry.TRACER.export_zipkin())
    assert len(exports[0]) == len(exports[1]) == 1
    port_sink = DataProcessor(trace_source=lambda lb, t, lim: [], device="cpu")
    jax_sink = JaxProcessor(trace_source=lambda lb, t, lim: [], use_device_stats=False)
    out = port_sink.ingest_raw_window(json.dumps(exports[0]).encode())
    want = jax_sink.ingest_raw_window(json.dumps(exports[1]).encode())
    assert out["spans"] == want["spans"] > 0 and out["edges"] == want["edges"] > 0
    assert sorted(port_sink.graph.interner.endpoints.strings) == sorted(jax_sink.graph.interner.endpoints.strings)
    assert graph_signature(port_sink.graph) == jax_signature(jax_sink.graph)


# -- the step timer and trace() ------------------------------------------------------


def test_step_timer_summary_equals_jax():
    port, jax = StepTimer(), JaxStepTimer()
    for name, ms in (("a", 1.5), ("b", 10.0), ("a", 4.0), ("c", 0.0)):
        port.record(name, ms)
        jax.record(name, ms)
    assert port.summary() == jax.summary()
    with port.phase("d"):
        pass
    assert port.summary()["d"]["count"] == 1
    port.reset()
    assert port.summary() == {}


@pytest.fixture()
def capture_log(monkeypatch, tmp_path):
    """Route trace() captures into a list instead of torch.profiler, and
    reset the module's cap state around each test."""
    captures = []

    class FakeProfile:
        def __init__(self, activities=None):
            captures.append(activities)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def export_chrome_trace(self, path):
            open(path, "w").write("{}")

    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    monkeypatch.setenv("KMAMIZ_PROFILE_DIR", str(tmp_path))
    monkeypatch.setattr(profiling, "_traces_left", -1)
    return captures


def test_trace_is_a_noop_without_a_profile_dir(monkeypatch):
    monkeypatch.delenv("KMAMIZ_PROFILE_DIR", raising=False)
    monkeypatch.setattr(profiling, "_traces_left", -1)
    with profiling.trace("t"):
        pass
    assert profiling._traces_left == -1  # env never read


@pytest.mark.parametrize("cap, captures, left", [("2", 2, 0), ("unlimited", 5, 3), ("0", 0, 0)])
def test_trace_cap(capture_log, monkeypatch, tmp_path, cap, captures, left):
    monkeypatch.setenv("KMAMIZ_PROFILE_COUNT", cap)
    for _ in range(5):
        with profiling.trace("t"):
            pass
    assert len(capture_log) == captures
    assert profiling._traces_left == left
    assert bool(list((tmp_path / "t").glob("*.pt.trace.json"))) == (captures > 0)


def test_broken_profiler_never_breaks_the_tick(monkeypatch, tmp_path):
    def broken(activities=None):
        raise OSError("unwritable profile dir")

    monkeypatch.setattr(torch.profiler, "profile", broken)
    monkeypatch.setenv("KMAMIZ_PROFILE_DIR", str(tmp_path))
    monkeypatch.setenv("KMAMIZ_PROFILE_COUNT", "8")
    monkeypatch.setattr(profiling, "_traces_left", -1)
    ran = []
    with profiling.trace("t"):
        ran.append(True)
    assert ran == [True]
    assert profiling._traces_left == 0  # disabled, not drained per tick


def test_trace_body_exception_propagates(capture_log):
    with pytest.raises(RuntimeError, match="tick failed"):
        with profiling.trace("t"):
            raise RuntimeError("tick failed")
    assert len(capture_log) == 1


def test_trace_cap_survives_concurrent_callers(capture_log, monkeypatch):
    monkeypatch.setenv("KMAMIZ_PROFILE_COUNT", "1")
    barrier = threading.Barrier(4)

    def worker():
        barrier.wait()
        for _ in range(10):
            with profiling.trace("t"):
                pass

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(capture_log) == 1
    assert profiling._traces_left == 0


def test_trace_skips_while_a_capture_holds_the_guard(capture_log):
    assert profiling.trace_guard.acquire(blocking=False)
    try:
        with profiling.trace("t"):
            pass
    finally:
        profiling.trace_guard.release()
    assert capture_log == [] and profiling._traces_left == -1


# -- the sync guard ------------------------------------------------------------------


@pytest.mark.parametrize(
    "raw",
    ["", "0", "off", "false", "OFF", "1", "on", "true", "ON", "log", "disallow", "log_explicit", "allow", "sometimes"],
)
@pytest.mark.parametrize("default", [None, "log"])
def test_guard_level_parsing_equals_jax(monkeypatch, raw, default):
    monkeypatch.setenv("KMAMIZ_TRANSFER_GUARD", raw)
    assert guards.transfer_guard_level(default) == jax_guards.transfer_guard_level(default)


def test_guard_on_a_cpu_tick_is_a_noop(monkeypatch):
    groups = fixture_windows()["pdas"]
    proc = DataProcessor(trace_source=lambda lb, t, lim: groups, device="cpu")
    with guards.hot_path_guard("disallow", device=proc.device, expected_syncs=0, require_no_recompile=True) as report:
        proc.collect({"uniqueId": "g", "time": 0})
    assert report.syncs == 0 and report.new_compiles == {} and not report.recompiled
    monkeypatch.setenv("KMAMIZ_TRANSFER_GUARD", "1")
    with guards.maybe_guarded_tick(proc.device) as report:
        pass
    assert report is not None and report.level == "disallow" and report.syncs == 0
    monkeypatch.delenv("KMAMIZ_TRANSFER_GUARD")
    with guards.maybe_guarded_tick(proc.device) as report:
        assert report is None


# -- the scorecard and the device gauges ------------------------------------------------


def test_scorecard_percentiles_and_rates():
    for ms in range(1, 101):
        SCORECARD.observe_tick(float(ms))
    slo.TICKS.inc(10)
    slo.STALE_SERVES.inc(1)
    slo.INGEST_PAYLOADS.inc(20)
    slo.INGEST_DROPPED.inc(2)
    slo.QUARANTINED.inc(1)
    snap = SCORECARD.snapshot()
    assert snap["tick_p50_ms"] == pytest.approx(50.0, abs=1.5)
    assert snap["tick_p99_ms"] == pytest.approx(99.0, abs=1.5)
    assert snap["stale_serve_rate"] == pytest.approx(0.1)
    assert snap["ingest_drop_rate"] == pytest.approx(0.1)
    assert snap["quarantine_rate"] == pytest.approx(0.05)
    # the JAX scorecard's keys without its recompile count
    assert set(snap) == set(slo.SLO_KEYS_HIGHER_IS_WORSE) == set(jax_telemetry.SCORECARD.snapshot()) - {
        "recompile_count"
    }


def test_scorecard_window_rolls(monkeypatch):
    monkeypatch.setenv("KMAMIZ_SLO_WINDOW", "8")
    card = slo.Scorecard()
    for ms in (1000.0,) * 8 + (1.0,) * 8:
        card.observe_tick(ms)
    assert card.snapshot()["tick_p99_ms"] == 1.0


def test_a_cpu_processor_registers_no_device_gauges():
    groups = fixture_windows()["pdas"]
    proc = DataProcessor(trace_source=lambda lb, t, lim: groups, device="cpu")
    proc.collect({"uniqueId": "a", "time": 0})
    text = REGISTRY.render()  # the arenas of the live stores: `proc`'s graph
    assert "kmamiz_device_bytes_in_use" not in text
    values = family_values(text, ("kmamiz_arena_bytes", "kmamiz_program_calls_total"))
    assert values[("kmamiz_arena_bytes", (("arena", "graph.edges"),))] > 0
    # the plain versions run on CPU tensors: no kernel launched
    assert values[("kmamiz_program_calls_total", (("program", "segment_stats"),))] == 0
    assert "kmamiz_program_compiles_total" not in text


# -- the HTTP surfaces --------------------------------------------------------------------


def post(port: int, path: str, body: bytes):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture
def dp():
    groups = fixture_windows()["pdas"]
    server = DataProcessorServer(
        DataProcessor(trace_source=lambda lb, t, lim: groups, device="cpu", wal=None), host="127.0.0.1", port=0
    )
    server.start()
    yield server
    server.stop()


def test_dp_metrics_timings_and_traces(dp):
    status, _ = post(dp.port, "/", json.dumps({"uniqueId": "a", "lookBack": 30_000, "time": 0}).encode())
    assert status == 200
    with urllib.request.urlopen(f"http://127.0.0.1:{dp.port}/metrics", timeout=30) as resp:
        assert resp.headers["Content-Type"] == "text/plain; version=0.0.4; charset=utf-8"
        text = resp.read().decode()
    assert_conformant(text)
    assert 'le="+Inf"' in text and "kmamiz_ticks_total 1" in text
    with urllib.request.urlopen(f"http://127.0.0.1:{dp.port}/timings", timeout=30) as resp:
        timings = json.loads(resp.read())
    # the JAX server's sections, less those of parts the port does not
    # have (nothing is compiled per shape)
    jax_sections = {
        "phases", "programs", "resilience", "tenancy", "tenants", "control",
        "cost", "freshness", "stream", "fleet", "lockWitness",
    }
    assert set(timings) == jax_sections - {"programs", "cost"}
    # the witness is off unless KMAMIZ_LOCK_WITNESS arms it
    assert timings["lockWitness"]["installed"] is False
    assert timings["tenants"]["default"]["ticks"] == 1 and timings["freshness"]["samples"] == 1
    with urllib.request.urlopen(f"http://127.0.0.1:{dp.port}/debug/traces", timeout=30) as resp:
        export = json.loads(resp.read())
    root = [s for s in export[-1] if s["parentId"] is None]
    assert len(root) == 1 and root[0]["localEndpoint"]["serviceName"] == "dp-tick"
    # the answer's encode, after the trace closed
    assert "encode-serve" in {s["localEndpoint"]["serviceName"] for s in export[-1]}
    # the self-trace: the export POSTed back to /ingest parses
    status, summary = post(dp.port, "/ingest", json.dumps(export).encode())
    assert status == 200 and summary["traces"] == len(export) and summary["spans"] > 0
    assert TRACER.traces()[-1].spans[0][0] == "dp-ingest"


def test_dp_profile_capture_and_busy(dp, tmp_path):
    status, out = post(dp.port, "/debug/profile", json.dumps({"durationMs": 20, "dir": str(tmp_path)}).encode())
    assert status == 200 and out["ok"] and out["trace"].endswith(".pt.trace.json")
    assert profiling.trace_guard.acquire(blocking=False)
    try:
        status, out = post(dp.port, "/debug/profile", json.dumps({"durationMs": 20}).encode())
    finally:
        profiling.trace_guard.release()
    assert status == 409 and out["busy"] is True and out["ok"] is False


def test_rest_telemetry_routes_and_health_timings(tmp_path):
    from kmamiz_tpu_torch.api.app import build_router
    from kmamiz_tpu_torch.config import Settings
    from kmamiz_tpu_torch.server.initializer import AppContext

    groups = fixture_windows()["pdas"]
    proc = DataProcessor(trace_source=lambda lb, t, lim: groups, device="cpu", wal=None)
    proc.collect({"uniqueId": "a", "time": 0})
    settings = Settings(storage_uri="memory://", static_dir="", wasm_path="")
    router = build_router(AppContext.build(app_settings=settings, processor=proc))
    resp = router.dispatch("GET", "/api/v1/telemetry/metrics")
    assert resp.status == 200 and resp.content_type == "text/plain; version=0.0.4; charset=utf-8"
    assert_conformant(resp.raw_body.decode())
    resp = router.dispatch("GET", "/api/v1/telemetry/traces")
    assert resp.status == 200 and resp.payload[-1][0]["traceId"]
    resp = router.dispatch("POST", "/api/v1/telemetry/profile", json.dumps({"durationMs": 5, "dir": str(tmp_path)}).encode())
    assert resp.status == 200 and resp.payload["ok"]
    with contextlib.ExitStack() as stack:
        assert profiling.trace_guard.acquire(blocking=False)
        stack.callback(profiling.trace_guard.release)
        resp = router.dispatch("POST", "/api/v1/telemetry/profile", b"{}")
        assert resp.status == 409 and resp.payload["busy"]
    resp = router.dispatch("GET", "/api/v1/health/timings")
    assert resp.status == 200
    assert {"serverTime", "phases", "scorerCache", "modelServe", "resilience"} == set(resp.payload)
    assert resp.payload["phases"]["fetch_traces"]["count"] == 1

"""The port's profiler (kmamiz_tpu_torch/telemetry/profiling/) against the
JAX package's graftprof, on the CPU.

- the host event ring: emit/snapshot, the last-ticks window, the
  KMAMIZ_PROF gate, the capacity floor and wrap-around;
- a seeded event stream condenses to the JAX package's `build_profile`,
  and two streams give the same `diff` verdict;
- the flight artifact has the JAX artifact's keys, its debounce runs on a
  fake clock (the JAX test of it runs on the real one and is
  intermittent), retention prunes to the newest, `record` never raises,
  and a watchdog trip and a breaker opening freeze evidence;
- the native counters read the same as `kmamiz_tpu.native`'s after the
  same parse;
- `parse_profile_dir` gives the JAX package's totals on one synthetic
  Chrome trace, and its kernel-name join credits `segment_stats` and the
  fused kernel's launches;
- the report's attribution math, the HTTP surface (/debug/graftprof,
  /debug/profile) and warm ticks' attribution.
"""
from __future__ import annotations

import json
import os
import random
import urllib.error
import urllib.request

import pytest

from kmamiz_tpu import native as jax_native
from kmamiz_tpu.server.processor import DataProcessor as JaxProcessor
from kmamiz_tpu.telemetry.profiling import device_attr as jax_device_attr
from kmamiz_tpu.telemetry.profiling import native_counters as jax_native_counters
from kmamiz_tpu.telemetry.profiling import recorder as jax_recorder
from kmamiz_tpu.telemetry.profiling import report as jax_report
from kmamiz_tpu_torch import native, synth, telemetry
from kmamiz_tpu_torch.core import profiling as core_profiling
from kmamiz_tpu_torch.resilience import breaker, metrics
from kmamiz_tpu_torch.server.dp_server import DataProcessorServer
from kmamiz_tpu_torch.server.processor import DataProcessor
from kmamiz_tpu_torch.telemetry import TRACER
from kmamiz_tpu_torch.telemetry import device as tel_device
from kmamiz_tpu_torch.telemetry.profiling import device_attr, events, native_counters, recorder, report

MS = 1_000_000  # ns per ms: event durations are nanoseconds


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    monkeypatch.setenv("KMAMIZ_PROF_FLIGHT_DIR", str(tmp_path / "flight"))
    monkeypatch.setenv("KMAMIZ_SEGMENT_BACKEND", "pallas_interpret")
    for mod in (telemetry, breaker, metrics):
        mod.reset_for_tests()
    yield
    for mod in (telemetry, breaker, metrics):
        mod.reset_for_tests()


def _tick(ev_mod, phases, root="dp-tick", root_ms=10.0):
    """Drive one synthetic tick through a package's live ring."""
    ev_mod.note_tick_start()
    for name, ms in phases:
        ev_mod.emit(name, int(ms * MS))
    ev_mod.note_tick_end(root, int(root_ms * MS))


def _rows(ticks, phases, root_ms=10.0):
    """Synthetic event rows (name, tick, end_ns, dur_ns) for build_profile."""
    rows = []
    for t in range(1, ticks + 1):
        for i, (name, ms) in enumerate(phases):
            rows.append((name, t, t * 1000 + i, int(ms * MS)))
        rows.append(("dp-tick", t, t * 1000 + 999, int(root_ms * MS)))
    return rows


def _seeded_rows(seed: int, ticks: int = 8, scale: float = 1.0):
    rng = random.Random(seed)
    rows = []
    for t in range(1, ticks + 1):
        phases = [(name, rng.randrange(1, 9) * scale) for name in ("parse", "merge", "walk_sparse", "assemble")]
        for i, (name, ms) in enumerate(phases):
            rows.append((name, t, t * 1000 + i, int(ms * MS)))
        rows.append(("native-merge", t, t * 1000 + 10, int(rng.randrange(1, 5) * MS)))
        rows.append(("dp-tick", t, t * 1000 + 999, int((sum(ms for _n, ms in phases) + rng.randrange(0, 3)) * MS)))
    return rows


# -- the event ring -----------------------------------------------------------


def test_emit_snapshot_roundtrip():
    _tick(events, [("parse", 2.0), ("merge", 3.0)])
    snap = events.snapshot()
    assert [e[0] for e in snap] == ["parse", "merge", "dp-tick"]
    assert all(e[1] == 1 for e in snap)
    assert events.phase_durations_ms()["merge"] == [3.0]


def test_last_ticks_window_scopes_to_newest():
    for k in range(5):
        _tick(events, [("parse", float(k + 1))])
    assert {e[1] for e in events.snapshot(last_ticks=2)} == {4, 5}


def test_env_gate_drops_events_and_record(monkeypatch):
    monkeypatch.setenv("KMAMIZ_PROF", "0")
    _tick(events, [("parse", 2.0)])
    assert events.snapshot() == []
    assert recorder.record("watchdog", "off") is None


def test_ring_capacity_floor_and_wrap(monkeypatch):
    monkeypatch.setenv("KMAMIZ_PROF_RING", "3")  # floored at 64
    events.reset_for_tests()
    for k in range(100):
        events.emit("parse", k)
    snap = events.snapshot()
    assert len(snap) == 64 and max(e[3] for e in snap) == 99


def test_phase_p95_absent_is_zero():
    assert events.phase_p95_ms("never") == 0.0
    assert events.phase_percentile_ms("never", 0.99) == 0.0


# -- profiles and diffs against the JAX report ---------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 1234])
def test_seeded_stream_condenses_to_the_jax_profile(seed):
    rows = _seeded_rows(seed)
    native_snap = {
        "available": True, "parses": 3, "spans": 10, "merge_ns": 5 * MS, "merge_lock_wait_ns": MS,
        "merge_queue_depth_peak": 2, "claim_contended": 0, "intern_probes": 10, "intern_hits": 4,
        "shards": [{"parse_ns": MS, "wait_ns": 0, "spans": 5}],
    }
    got = report.build_profile(event_rows=rows, native=native_snap, compile_log=[], hbm_timeline=[])
    want = jax_report.build_profile(event_rows=rows, native=native_snap, compile_log=[], hbm_timeline=[])
    assert got == want
    assert report.render(got) == jax_report.render(want)


@pytest.mark.parametrize("scale, regress", [(1.0, False), (3.0, True)])
def test_diff_verdict_equals_jax(scale, regress):
    base = report.build_profile(event_rows=_seeded_rows(7), native={}, compile_log=[], hbm_timeline=[])
    cand = report.build_profile(event_rows=_seeded_rows(7, scale=scale), native={}, compile_log=[], hbm_timeline=[])
    got, want = report.diff(base, cand), jax_report.diff(base, cand)
    assert got == want
    assert bool(got) == regress


def test_attribution_math_and_cap():
    prof = report.build_profile(
        event_rows=_rows(3, [("parse", 4.0), ("merge", 5.0)]), native={}, compile_log=[], hbm_timeline=[]
    )
    assert prof["ticks"] == 3 and prof["wall_ms"] == pytest.approx(30.0)
    assert prof["attribution_ratio"] == pytest.approx(0.9)
    over = report.build_profile(
        event_rows=_rows(2, [("parse", 8.0), ("merge", 8.0)]), native={}, compile_log=[], hbm_timeline=[]
    )
    assert over["attribution_ratio"] == 1.0


@pytest.mark.parametrize("overlap", ["native-merge", "compile", "freshness", "fetch_cluster_state"])
def test_overlapping_events_are_not_attributed(overlap):
    rows = _rows(1, [("merge", 9.0)]) + [(overlap, 1, 5000, int(20.0 * MS))]
    prof = report.build_profile(event_rows=rows, native={}, compile_log=[], hbm_timeline=[])
    assert prof["attribution_ratio"] == pytest.approx(0.9)
    assert overlap in prof["phases"]


def test_from_any_rejects_unknown_kinds():
    with pytest.raises(ValueError, match="unrecognized artifact kind"):
        report.from_any({"kind": "not-a-profile"})
    with pytest.raises(ValueError):
        report.from_any([1, 2, 3])


# -- the flight recorder --------------------------------------------------------------


def test_artifact_keys_equal_the_jax_artifacts(tmp_path):
    _tick(events, [("parse", 2.0), ("merge", 5.0)])
    path = recorder.record("watchdog", "tick-overrun", force=True)
    assert path is not None and os.path.exists(path)
    doc = json.loads(open(path).read())
    want = jax_recorder.build_artifact("watchdog", "tick-overrun")
    assert set(doc) == set(want)
    assert doc["kind"] == "kmamiz-flight" and doc["version"] == 1 and doc["compileLog"] == []
    prof = report.from_any(doc)
    assert prof["ticks"] == 1 and set(prof["phases"]) == {"parse", "merge", "dp-tick"}
    assert jax_report.from_any(doc)["phases"] == prof["phases"]


class FakeClock:
    def __init__(self) -> None:
        self.now = 0.0

    def __call__(self) -> float:
        return self.now


def test_debounce_suppresses_storms_force_bypasses(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(recorder, "clock", clock)
    monkeypatch.setenv("KMAMIZ_PROF_FLIGHT_DEBOUNCE_S", "600")
    assert recorder.record("breaker-open", "zipkin") is not None
    clock.now = 599.0
    assert recorder.record("breaker-open", "zipkin") is None
    assert recorder.record("breaker-open", "zipkin", force=True) is not None
    clock.now = 599.0 + 600.0
    assert recorder.record("breaker-open", "zipkin") is not None
    assert recorder.record("watchdog", "deadline") is None


def test_retention_prunes_to_newest(monkeypatch, tmp_path):
    monkeypatch.setenv("KMAMIZ_PROF_FLIGHT_MAX", "2")
    paths = [recorder.record("watchdog", f"n{i}", force=True) for i in range(4)]
    assert all(paths)
    kept = sorted(p.name for p in (tmp_path / "flight").glob("flight-*.json"))
    assert kept == sorted(os.path.basename(p) for p in paths[-2:])


def test_record_never_raises(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("boom")

    monkeypatch.setattr(recorder, "build_artifact", boom)
    assert recorder.record("watchdog", "broken", force=True) is None


def test_watchdog_trip_and_breaker_open_freeze_evidence(tmp_path):
    _tick(events, [("merge", 3.0)])
    metrics.watchdog_tripped("deadline")
    assert len(list((tmp_path / "flight").glob("flight-*-watchdog.json"))) == 1
    recorder.reset_for_tests()  # clear the debounce; prove the second trigger
    breaker.CircuitBreaker("dp-test", threshold=1, cooldown_s=30).record_failure()
    assert list((tmp_path / "flight").glob("flight-*-breaker-open.json"))
    assert metrics.watchdog_state()["trips"] == 1


# -- native counters --------------------------------------------------------------------


def test_native_counters_read_the_jax_librarys_after_the_same_parse():
    raw = synth.make_raw_window(40, 4, t_start=0)
    native.available()
    native.prof_reset()
    jax_native.prof_reset()
    DataProcessor(trace_source=lambda lb, t, lim: [], device="cpu").ingest_raw_window(raw)
    JaxProcessor(trace_source=lambda lb, t, lim: [], use_device_stats=False).ingest_raw_window(raw)
    got, want = native_counters.counters(), jax_native_counters.counters()
    assert got["available"] is want["available"] is True
    assert set(got) == set(want)
    for key in ("parses", "spans", "shards_used", "intern_probes", "intern_hits", "claim_contended"):
        assert got[key] == want[key], key
    # the shards take work as their threads get to it: only their total
    # is the parse's
    assert sum(s["spans"] for s in got["shards"]) == sum(s["spans"] for s in want["shards"])
    events.note_tick_start()
    native_counters.poll(events._cur_tick)
    assert "native-merge" in {e[0] for e in events.snapshot()}


def test_native_counters_before_any_load_are_zero(monkeypatch):
    monkeypatch.setattr(native, "loaded", lambda: False)
    snap = native_counters.counters()
    assert snap["available"] is False and snap["parses"] == 0 and snap["shards"] == []
    native_counters.poll(1)
    assert events.snapshot() == []


# -- the capture join ----------------------------------------------------------------------

#: one synthetic Chrome trace: device events of the port's kernels (a
#: mangled and a demangled name), a copy, another library kernel
TRACE_EVENTS = [
    {"ph": "X", "cat": "kernel", "name": "segment_stats_kernel", "dur": 12.5},
    {"ph": "X", "cat": "kernel", "name": "_Z20segment_stats_kernelPKfilPKiS3_iiPf", "dur": 7.5},
    {"ph": "X", "cat": "kernel", "name": "void fused_sddmm_spmm_kernel<true, 4>(int const*)", "dur": 30.0},
    {"ph": "X", "cat": "kernel", "name": "fused_sddmm_spmm_kernel_grad_rows", "dur": 5.0},
    {"ph": "X", "cat": "kernel", "name": "fused_sddmm_spmm_kernel_grad_edges", "dur": 4.0},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pinned)", "dur": 3.0},
    {"ph": "X", "cat": "kernel", "name": "void at::native::vectorized_elementwise_kernel<4>", "dur": 2.0},
    {"ph": "i", "cat": "kernel", "name": "segment_stats_kernel", "dur": 100.0},
]


@pytest.mark.parametrize("gz", [False, True], ids=["json", "gzip"])
def test_parse_profile_dir_totals_equal_jax_and_credit_the_kernels(tmp_path, gz):
    import gzip

    path = tmp_path / "plugins" / ("capture.pt.trace.json" + (".gz" if gz else ""))
    path.parent.mkdir()
    text = json.dumps({"traceEvents": TRACE_EVENTS})
    path.write_bytes(gzip.compress(text.encode()) if gz else text.encode())
    got = device_attr.parse_profile_dir(str(tmp_path))
    want = jax_device_attr.parse_profile_dir(str(tmp_path))
    for key in ("files", "events", "total_device_ms"):
        assert got[key] == want[key], key
    assert got["programs"] == {
        "segment_stats": 0.02,
        "fused_sddmm_spmm": 0.03,
        "fused_sddmm_spmm_grad_rows": 0.005,
        "fused_sddmm_spmm_grad_edges": 0.004,
    }
    assert got["unattributed_ms"] == 0.005


def test_host_events_count_nowhere(tmp_path):
    (tmp_path / "c.trace.json").write_text(
        json.dumps([{"ph": "X", "cat": "cpu_op", "name": "segment_stats_kernel", "dur": 9.0}])
    )
    out = device_attr.parse_profile_dir(str(tmp_path))
    assert out["events"] == 0 and out["programs"] == {}


def test_a_real_cpu_capture_parses(tmp_path):
    out = tel_device.capture_profile(5, str(tmp_path))
    assert out["ok"] and os.path.exists(out["trace"])
    parsed = device_attr.parse_profile_dir(str(tmp_path))
    assert parsed["files"] == 1 and parsed["programs"] == {}


def test_capture_window_clamped_by_env(monkeypatch, tmp_path):
    monkeypatch.setenv("KMAMIZ_PROFILE_MAX_S", "0.002")
    from kmamiz_tpu_torch.config import profile_max_s

    assert profile_max_s() == 0.002
    monkeypatch.setenv("KMAMIZ_PROFILE_MAX_S", "-5")
    assert profile_max_s() == 0.001
    monkeypatch.setenv("KMAMIZ_PROFILE_MAX_S", "garbage")
    assert profile_max_s() == 10.0
    monkeypatch.setenv("KMAMIZ_PROFILE_MAX_S", "0.01")
    out = tel_device.capture_profile(60_000, str(tmp_path))
    assert out["ok"] is True and out["duration_ms"] == 10


# -- the HTTP surface and live ticks -----------------------------------------------------------


@pytest.fixture()
def server():
    srv = DataProcessorServer(DataProcessor(trace_source=lambda lb, t, lim: [], device="cpu"), host="127.0.0.1", port=0)
    srv.start()
    yield f"http://127.0.0.1:{srv.port}"
    srv.stop()


def test_debug_graftprof_serves_the_live_profile(server):
    _tick(events, [("parse", 2.0)])
    doc = json.loads(urllib.request.urlopen(f"{server}/debug/graftprof", timeout=30).read())
    assert doc["kind"] == report.PROFILE_KIND
    assert "parse" in doc["phases"] and "native" in doc and "device" in doc


def test_debug_profile_busy_is_409(server):
    assert core_profiling.trace_guard.acquire(blocking=False)
    try:
        req = urllib.request.Request(
            f"{server}/debug/profile",
            data=json.dumps({"durationMs": 50}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=30)
        assert err.value.code == 409
        body = json.loads(err.value.read())
        assert body["busy"] is True and body["ok"] is False
    finally:
        core_profiling.trace_guard.release()


def test_warm_ticks_attribute_the_majority_of_their_wall():
    windows = [json.loads(synth.make_raw_window(40, 4, t_start=t)) for t in (0, 5_000)]
    DataProcessor(trace_source=lambda lb, t, lim: windows[0], device="cpu").collect(
        {"uniqueId": "warm", "lookBack": 30_000, "time": 1_000}
    )
    events.reset_for_tests()
    DataProcessor(trace_source=lambda lb, t, lim: windows[1], device="cpu").collect(
        {"uniqueId": "t", "lookBack": 30_000, "time": 6_000}
    )
    prof = report.build_profile()
    assert prof["ticks"] == 1
    assert prof["attribution_ratio"] >= 0.5, prof
    assert {"parse", "merge", "walk_sparse", "pack", "assemble"} <= set(prof["phases"])
    assert TRACER.traces()[-1].spans[0][0] == "dp-tick"

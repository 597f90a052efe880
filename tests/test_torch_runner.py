"""The port's closed-loop scenario runner against kmamiz_tpu's on the CPU.

Real soaks through both packages' runners, each against a real in-process
DP server, on the same seeded specs: the cards' signatures, the reference
signatures and every gate both cards carry must agree (the JAX cards'
compile gates have no port counterpart: nothing is compiled per shape).
The archetypes: steady-chain twice, kill9-wal-replay (its child on the
CPU), capacity-growth-chain (a capacity bucket crossed), multi-tenant-mix
(the ingest cap reaching the processors), fleet-migration and wal-replay;
the counterfactual's prevented count; the crashed card and the matrix's
containment; the flight recorder's per-cell namespaces; and the WAL-replay
source's bundles (synthesized bundles byte-equal to the JAX package's,
mixed v1/v2 segments, torn tails, the capture CLI's copy).
"""
from __future__ import annotations

import json
import os
import struct
import subprocess
import sys
import zlib

import pytest

from kmamiz_tpu.scenarios import runner as jax_runner
from kmamiz_tpu.scenarios.factory import build_scenario as jax_build
from kmamiz_tpu.soak import walreplay as jax_walreplay
from kmamiz_tpu_torch import control, fleet, scenarios, telemetry, tenancy
from kmamiz_tpu_torch.resilience import breaker, metrics, quarantine
from kmamiz_tpu_torch.resilience.wal import KIND_COLUMNAR, KIND_JSON, IngestWAL
from kmamiz_tpu_torch.scenarios import ARCHETYPES, build_scenario, runner
from kmamiz_tpu_torch.server.processor import DataProcessor
from kmamiz_tpu_torch.soak import capture, walreplay
from kmamiz_tpu_torch.telemetry.profiling import recorder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = [name for name, _ in ARCHETYPES]
#: the JAX cards' gates that count XLA compiles
COMPILE_GATES = {"zero_steady_recompiles"}


@pytest.fixture(autouse=True)
def _port_state(monkeypatch, tmp_path):
    monkeypatch.setenv("KMAMIZ_PROF_FLIGHT_DIR", str(tmp_path / "flight"))
    monkeypatch.delenv("KMAMIZ_SOAK_BUNDLE", raising=False)
    mods = (telemetry, tenancy, breaker, metrics, quarantine, control, fleet, scenarios, recorder)
    for mod in mods:
        mod.reset_for_tests()
    yield
    for mod in mods:
        mod.reset_for_tests()


def _spec(archetype, n_ticks):
    return build_scenario(archetype, 0, NAMES.index(archetype), n_ticks)


def _both(archetype, n_ticks, tmp_path):
    """(the port's card on the CPU, the JAX package's card) of one spec."""
    port = runner.run_scenario(_spec(archetype, n_ticks), tmpdir=str(tmp_path / "port"), device="cpu")
    jax = jax_runner.run_scenario(jax_build(archetype, 0, NAMES.index(archetype), n_ticks), tmpdir=str(tmp_path / "jax"))
    return port, jax


def _assert_cards_agree(port, jax):
    assert port["pass"], (port["gates"], port["errors"])
    assert jax["pass"], jax["gates"]
    assert set(port["gates"]) == set(jax["gates"]) - COMPILE_GATES
    assert {g: port["gates"][g] for g in port["gates"]} == {g: jax["gates"][g] for g in port["gates"]}
    for key in ("spec_signature", "signatures", "lost_spans", "quarantined", "expected_poisons"):
        assert port[key] == jax[key], key
    if "ref_signatures" in jax:
        assert port["ref_signatures"] == jax["ref_signatures"]
    for key in ("steady_recompiles", "mid_tick_compiles", "mid_tick_detail", "cost"):
        assert key not in port


def test_steady_chain_soak_twice_equals_jax(tmp_path):
    """One real 4-tick soak, twice: every gate holds, and the graph
    signatures equal the JAX runner's and each other's."""
    first, jax = _both("steady-chain", 4, tmp_path)
    _assert_cards_agree(first, jax)
    assert first["posts"] == jax["posts"] and first["stale_serves"] == jax["stale_serves"] == 0
    second = runner.run_scenario(_spec("steady-chain", 4), tmpdir=str(tmp_path / "again"), device="cpu")
    assert second["pass"] and second["signatures"] == first["signatures"]
    names = [c["name"] for c in scenarios.recorded_runs()]
    assert names.count(first["name"]) == 2


def test_kill9_wal_replay_child_on_the_cpu(tmp_path):
    port, jax = _both("kill9-wal-replay", 6, tmp_path)
    _assert_cards_agree(port, jax)
    assert port["wal"]["child_sigkilled"] and port["wal"]["returncode"] == -9
    assert port["wal"]["replayed"] == port["wal"]["windows"] == runner.KILL9_WINDOWS
    # the child ran the port's runner, never the JAX package's
    assert "kmamiz_tpu." not in port["wal"]["stderr_tail"]


def test_capacity_growth_crosses_a_bucket(tmp_path):
    port, jax = _both("capacity-growth-chain", 10, tmp_path)
    _assert_cards_agree(port, jax)
    assert port["gates"]["bucket_crossed"]
    (tenant,) = port["capacity"]
    before, after = port["capacity"][tenant]
    assert after > before
    assert port["capacity"] == jax["capacity"]


def test_multi_tenant_mix_cap_reaches_the_processors(tmp_path):
    """The poison storylines' ingest cap is the processors' argument (the
    JAX runner sets KMAMIZ_INGEST_MAX_BYTES, which the port never reads):
    every bomb is quarantined, as in the JAX run."""
    port, jax = _both("multi-tenant-mix", 10, tmp_path)
    _assert_cards_agree(port, jax)
    assert port["quarantined"] == port["expected_poisons"] > 0


def test_runner_arguments_reach_processor_and_stream(monkeypatch):
    monkeypatch.delenv("KMAMIZ_INGEST_MAX_BYTES", raising=False)
    monkeypatch.delenv("KMAMIZ_STREAM_EPOCH_TICKS", raising=False)
    for archetype, cap in (("multi-tenant-mix", runner.POISON_SIZE_CAP), ("steady-chain", quarantine.MAX_PAYLOAD_BYTES)):
        spec = _spec(archetype, 4)
        sources = {p.tenant: runner._ScenarioSource(p.tenant) for p in spec.tenants}
        procs = runner._scenario_processors(spec, sources, "cpu")
        assert {p.max_payload_bytes for p in procs.values()} == {cap}
        assert all(getattr(p, "_stream_engine", None) is None for p in procs.values())
    spec = _spec("streaming-freshness", 4)
    procs = runner._scenario_processors(spec, {p.tenant: runner._ScenarioSource(p.tenant) for p in spec.tenants}, "cpu")
    assert [p._stream_engine.epoch_ticks for p in procs.values()] == [runner.STREAM_EPOCH_TICKS]
    assert all(p.max_payload_bytes == quarantine.MAX_PAYLOAD_BYTES for p in procs.values())


def test_fleet_migration_archetype_equals_jax(tmp_path):
    port, jax = _both("fleet-migration", 10, tmp_path)
    _assert_cards_agree(port, jax)
    assert port["migration"]["ok"] and port["migration"]["queuedReleased"] >= 1
    for key in ("source", "target", "signature", "records", "queuedReleased"):
        assert port["migration"][key] == jax["migration"][key], key
    pf, jf = port["fleet"], jax["fleet"]
    assert pf["foldedEdges"] == jf["foldedEdges"] > 0
    assert pf["coordinator"]["overrides"] == jf["coordinator"]["overrides"]
    assert pf["workers"] == jf["workers"]
    assert {k: v for k, v in pf.items() if k not in ("coordinator", "workers")} == {
        k: v for k, v in jf.items() if k not in ("coordinator", "workers")
    }


def test_wal_replay_archetype_and_bundle_equal_jax(tmp_path):
    spec = _spec("wal-replay", 6)
    jax_spec = jax_build("wal-replay", 0, NAMES.index("wal-replay"), 6)
    meta = walreplay.synthesize_bundle(spec, str(tmp_path / "port-b"))
    jax_meta = jax_walreplay.synthesize_bundle(jax_spec, str(tmp_path / "jax-b"))
    assert {k: v for k, v in meta.items() if k != "created_unix"} == {
        k: v for k, v in jax_meta.items() if k != "created_unix"
    }
    segs = lambda d: [(p.name, p.read_bytes()) for p in sorted((tmp_path / d / "wal").glob("*.wal"))]  # noqa: E731
    assert segs("port-b") == segs("jax-b")  # byte-equal WAL
    records = walreplay.load_bundle_records(str(tmp_path / "port-b"))
    assert {k for k, _p in records} == {KIND_JSON, KIND_COLUMNAR}
    assert records == jax_walreplay.load_bundle_records(str(tmp_path / "port-b"))

    port, jax = _both("wal-replay", 3, tmp_path)
    _assert_cards_agree(port, jax)
    assert port["wal"] == jax["wal"]
    assert port["wal"]["records"] == 3 and port["wal"]["torn_dropped"] == 0
    # a captured bundle (KMAMIZ_SOAK_BUNDLE) replays through both runners alike
    os.environ["KMAMIZ_SOAK_BUNDLE"] = str(tmp_path / "jax-b")
    try:
        port, jax = _both("wal-replay", 6, tmp_path / "bundle")
    finally:
        del os.environ["KMAMIZ_SOAK_BUNDLE"]
    _assert_cards_agree(port, jax)
    assert port["wal"]["records"] == jax_meta["records"] and port["wal"]["source"] == jax_meta["source"]


def test_counterfactual_prevents_as_many_as_jax():
    port = runner.run_counterfactual(seed=0, n_ticks=8, device="cpu")
    jax = jax_runner.run_counterfactual(seed=0, n_ticks=8)
    assert port["pass"], (port["gates"], port["off"]["errors"], port["on"]["errors"])
    assert port["slo_violations_prevented"] == jax["slo_violations_prevented"] >= 1
    assert port["cascade_ticks"] == jax["cascade_ticks"]
    assert set(port["gates"]) == set(jax["gates"]) - COMPILE_GATES
    assert all(port["gates"][g] == jax["gates"][g] for g in port["gates"])
    for arm in ("off", "on"):
        for key in ("violations", "deferred", "shed", "stale", "signature", "ref_signature", "lost_spans"):
            assert port[arm][key] == jax[arm][key], (arm, key)
    assert control.PREVENTED_VIOLATIONS.value == float(port["slo_violations_prevented"])


# ---------------------------------------------------------------------------
# crash containment and the flight recorder's namespaces


def test_crashed_card_has_full_shape(tmp_path):
    card = runner.crashed_card(None, ValueError("boom"), archetype="outage-cycle")
    want = jax_runner.crashed_card(None, ValueError("boom"), archetype="outage-cycle")
    assert card["pass"] is False and card["gates"] == {"crashed": False}
    assert card["errors"] == want["errors"] == ["ValueError: boom"]
    assert "boom" in card["crash"] and card["archetype"] == "outage-cycle"
    assert set(card) == set(want) - {"steady_recompiles", "mid_tick_compiles", "mid_tick_detail"}
    # the evidence box lands in the cell's namespace
    assert os.path.basename(card["flight_artifact"]).startswith("flight-outage-cycle-0-")


def test_run_matrix_contains_a_crashing_scenario(monkeypatch):
    def explode(spec, tmpdir=None, verbose=False, device=None):
        raise RuntimeError(f"compose died for {spec.name}")

    monkeypatch.setattr(runner, "run_scenario", explode)
    cards = runner.run_matrix([_spec("steady-chain", 4)], device="cpu")
    assert len(cards) == 1
    assert cards[0]["pass"] is False and cards[0]["gates"]["crashed"] is False
    assert "compose died" in cards[0]["errors"][0]
    assert scenarios.recorded_runs()[-1] is cards[0]


def test_flight_namespaces_have_isolated_retention(tmp_path, monkeypatch):
    monkeypatch.setenv("KMAMIZ_PROF_FLIGHT_DIR", str(tmp_path / "f"))
    monkeypatch.setenv("KMAMIZ_PROF_FLIGHT_MAX", "1")
    assert recorder.record("scenario-a", "g", force=True, namespace="arch-1")
    assert recorder.record("scenario-b", "g", force=True, namespace="arch-2")
    assert recorder.record("watchdog", "g", force=True)
    names = sorted(os.listdir(tmp_path / "f"))
    # one box per namespace plus the un-namespaced group: nothing evicted
    assert len(names) == 3
    assert any(n.startswith("flight-arch-1-") for n in names)
    assert any(n.startswith("flight-arch-2-") for n in names)
    recorder.record("scenario-a2", "g", force=True, namespace="arch-1")
    kept = [n for n in os.listdir(tmp_path / "f") if n.startswith("flight-arch-1-")]
    assert len(kept) == 1 and "scenario-a2" in kept[0]
    assert len(os.listdir(tmp_path / "f")) == 3
    artifact = json.loads((tmp_path / "f" / kept[0]).read_text())
    assert artifact["namespace"] == "arch-1" and artifact["kind"] == "kmamiz-flight"


def test_flight_debounce_is_per_namespace(tmp_path, monkeypatch):
    monkeypatch.setenv("KMAMIZ_PROF_FLIGHT_DIR", str(tmp_path / "f"))
    monkeypatch.setenv("KMAMIZ_PROF", "1")
    monkeypatch.setattr(recorder, "clock", lambda: 100.0)  # no time passes
    assert recorder.record("breach", "x", namespace="cell-a")
    # the same namespace inside the debounce window: skipped
    assert recorder.record("breach", "x", namespace="cell-a") is None
    # another cell's namespace has its own clock
    assert recorder.record("breach", "x", namespace="cell-b")
    assert recorder.record("breach", "x")
    assert recorder.record("breach", "x") is None


def test_numeric_namespace_cannot_shadow_unnamespaced_names():
    from kmamiz_tpu.telemetry.profiling import recorder as jax_recorder

    for ns in ("1234567890123", "cascade-fanout-3", "a/b c", "--", None):
        assert recorder._safe_namespace(ns) == jax_recorder._safe_namespace(ns)
    assert recorder._safe_namespace("1234567890123") == "ns-1234567890123"


# ---------------------------------------------------------------------------
# the WAL-replay source


def _window(tick, i=0):
    import random

    from kmamiz_tpu_torch.scenarios.topology import sample_topology, trace_group

    topo = sample_topology("chain", random.Random(7), "walrep")
    return json.dumps([trace_group(topo, "walrep", tick, i)]).encode()


def _ingest_all(payloads):
    dp = DataProcessor(trace_source=lambda *_a: [], device="cpu", use_device_stats=False, wal=None)
    spans = sum(int(dp.ingest_raw_window(p).get("spans", 0)) for p in payloads)
    from kmamiz_tpu_torch.graph.store import graph_signature

    return graph_signature(dp.graph), spans


def test_mixed_v1_v2_segments_and_torn_tail_replay(tmp_path):
    wal_dir = tmp_path / "bundle" / "wal"
    wal_dir.mkdir(parents=True)
    v1_payloads = [_window(0), _window(1)]
    (wal_dir / "000000.wal").write_bytes(b"".join(struct.pack("<II", len(p), zlib.crc32(p)) + p for p in v1_payloads))
    wal = IngestWAL(str(wal_dir), fsync=False)
    wal.append(_window(2))
    wal.append(_window(3))
    wal.close()
    seg = sorted(wal_dir.glob("*.wal"))[-1]
    seg.write_bytes(seg.read_bytes()[:-5])  # tear the last frame
    records = walreplay.load_bundle_records(str(tmp_path / "bundle"))
    assert records == jax_walreplay.load_bundle_records(str(tmp_path / "bundle"))
    assert [p for _k, p in records] == [*v1_payloads, _window(2)]  # the intact prefix
    assert _ingest_all([p for _k, p in records]) == _ingest_all([_window(t) for t in range(3)])


def test_capture_cli_copies_a_wal_dir(tmp_path):
    src = tmp_path / "src"
    wal = IngestWAL(str(src), fsync=False)
    for tick in range(4):
        wal.append(_window(tick))
    wal.close()
    out = subprocess.run(
        [sys.executable, "-m", "kmamiz_tpu_torch.soak.capture", "--wal-dir", str(src), "--out", str(tmp_path / "b")],
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    doc = json.loads(out.stdout.strip().splitlines()[-1])
    assert doc["records"] == 4 and doc["segments"] == 1 and doc["kind"] == walreplay.BUNDLE_KIND
    copied = walreplay.load_bundle_records(str(tmp_path / "b"))
    assert copied == list(IngestWAL(str(src)).replay_records())
    # the same bundle through the JAX capture's function
    from kmamiz_tpu.soak import capture as jax_capture

    want = jax_capture.capture_from_wal_dir(str(src), str(tmp_path / "jb"))
    got = capture.capture_from_wal_dir(str(src), str(tmp_path / "pb"))
    drop = ("created_unix", "source")
    assert {k: v for k, v in got.items() if k not in drop} == {k: v for k, v in want.items() if k not in drop}

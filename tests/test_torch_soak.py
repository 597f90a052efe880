"""The port's soak sweep (kmamiz_tpu_torch/soak/, cost/scenario.py) against
kmamiz_tpu's on the CPU.

Parity on the same inputs: the scenario plane's costs and observed
ratios over the seed-0..3 matrices, the 200-cell plan, a manifest
planned by one package and read by the other, triage and dedupe on
seeded cards, baselines and flights, and the soak report over the same
records. Then the JAX package's own sweep tests, ported against a
stubbed runner (cells, manifest, triage, worker, the engine in process),
crash containment, a real in-process mini-sweep through the port's
runner, and one subprocess sweep through the engine's workers. The
200-cell acceptance sweep and kill-mid-sweep resume are slow, as their
JAX twins are.
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from kmamiz_tpu.cost import scenario as jax_cost
from kmamiz_tpu.scenarios import factory as jax_factory
from kmamiz_tpu.soak import cells as jax_cells
from kmamiz_tpu.soak import engine as jax_engine
from kmamiz_tpu.soak import triage as jax_triage
from kmamiz_tpu.soak.manifest import SoakManifest as JaxManifest
from kmamiz_tpu_torch import scenarios, soak, telemetry
from kmamiz_tpu_torch.cost import scenario as cost
from kmamiz_tpu_torch.scenarios import ARCHETYPES, build_scenario, factory, runner
from kmamiz_tpu_torch.soak import cells as cells_mod
from kmamiz_tpu_torch.soak import engine, triage, worker
from kmamiz_tpu_torch.soak.manifest import SoakManifest, read_json
from kmamiz_tpu_torch.telemetry.profiling import recorder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = [name for name, _t in ARCHETYPES]


@pytest.fixture(autouse=True)
def _soak_state(monkeypatch, tmp_path):
    # the JAX package reads its sweep knobs from the environment
    for var in ("KMAMIZ_SOAK_TICKS", "KMAMIZ_SOAK_ARCHETYPES", "KMAMIZ_SOAK_WORKERS", "KMAMIZ_SOAK_PASS_FLOOR"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("KMAMIZ_PROF_FLIGHT_DIR", str(tmp_path / "flight"))
    mods = (telemetry, scenarios, soak, recorder)
    for mod in mods:
        mod.reset_for_tests()
    yield
    for mod in mods:
        mod.reset_for_tests()


def _arch_index(name):
    return cells_mod.archetype_index(name)


# ---------------------------------------------------------------------------
# parity with the JAX package on the same inputs
# ---------------------------------------------------------------------------


def _records(rng, n=40):
    """Finished cell records of seeded walls and priors, with the odd
    malformed one fit_observed must skip."""
    archs = ["steady-chain", "cascade-fanout", "outage-cycle"]
    out = []
    for i in range(n):
        rec = {
            "archetype": archs[int(rng.integers(len(archs)))],
            "wall_s": float(np.round(rng.uniform(0.05, 9.0), 3)),
            "predicted_s": float(np.round(rng.uniform(0.5, 6.0), 4)),
        }
        if i % 13 == 5:
            rec["wall_s"] = "n/a"
        if i % 17 == 3:
            rec["predicted_s"] = 0
        out.append(rec)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_scenario_costs_equal_jax_over_the_matrix(seed):
    port_specs = scenarios.scenario_matrix(seed, len(ARCHETYPES), 6)
    jax_specs = jax_factory.scenario_matrix(seed, len(ARCHETYPES), 6)
    records = _records(np.random.default_rng(seed))
    observed = cost.fit_observed(records)
    assert observed == jax_cost.fit_observed(records)
    assert observed  # the seeded records give every archetype a ratio
    for p, j in zip(port_specs, jax_specs, strict=True):
        assert scenarios.spec_signature(p) == jax_factory.spec_signature(j)
        assert cost.predicted_scenario_cost_s(p) == jax_cost.predicted_scenario_cost_s(j)
        assert cost.predicted_scenario_cost_s(p, observed) == jax_cost.predicted_scenario_cost_s(j, observed)


def test_weights_equal_jax():
    for name in ("PER_TICK_S", "PER_TRACE_S", "PER_TENANT_S", "BASE_S", "EVENT_COST_S"):
        assert getattr(cost, name) == getattr(jax_cost, name), name


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(n_cells=200, seed0=0),
        dict(n_cells=37, seed0=5, ticks=4),
        dict(n_cells=24, seed0=1, archetypes=NAMES, ticks=3, observed={"wal-replay": 3.5, "steady-chain": 0.25}),
    ],
    ids=["plan200", "seed5", "every-archetype-observed"],
)
def test_enumerate_cells_equals_jax(kwargs):
    assert cells_mod.enumerate_cells(**kwargs) == jax_cells.enumerate_cells(**kwargs)


def test_default_vocabulary_and_ticks_equal_jax():
    assert cells_mod.sweep_archetypes() == jax_cells.sweep_archetypes()
    assert cells_mod.sweep_ticks() == jax_cells.sweep_ticks() == cells_mod.DEFAULT_SWEEP_TICKS
    assert soak.SUBPROCESS_HEAVY == jax_cells.SUBPROCESS_HEAVY
    assert soak.COLD_PROCESS == jax_cells.COLD_PROCESS
    assert engine.DEFAULT_PASS_FLOOR == jax_engine.DEFAULT_PASS_FLOOR == jax_engine.pass_floor()
    assert engine.DEFAULT_WORKERS == min(4, max(1, os.cpu_count() or 1))


def _fill_results(man, rng):
    """Seeded result records for every planned cell, as a worker writes
    them: a few failures with triage, the poison cell failing."""
    doc = man.load()
    for cell in doc["cells"]:
        ok = bool(rng.random() > 0.25) and not cell.get("poison")
        gates = [] if ok else (["soak_poison"] if cell.get("poison") else ["bit_exact"])
        tri = None
        if not ok:
            gate = gates[0]
            phase = triage.GATE_PHASE[gate]
            tri = {"signature": f"{cell['archetype']}|{gate}|{phase}|default", "blamed_gate": gate,
                   "blamed_phase": phase, "blamed_tenant": "default"}
        man.record_result(cell["id"], {
            "id": cell["id"], "archetype": cell["archetype"], "seed": cell["seed"],
            "index": cell["index"], "ticks": cell["ticks"], "predicted_s": cell["predicted_s"],
            "poison": bool(cell.get("poison")), "pass": ok, "gates_failed": gates,
            "triage": tri, "flight_artifact": None if ok else f"flights/{cell['id']}.json",
            "wall_s": float(np.round(rng.uniform(0.2, 3.0), 2)), "run_id": "run-x",
        })


def test_a_manifest_planned_by_one_package_is_read_by_the_other(tmp_path):
    rng = np.random.default_rng(11)
    # JAX plans, the port reads and resumes
    jax_man = JaxManifest(str(tmp_path / "jax"))
    jax_doc = jax_engine.plan_sweep(jax_man, 16, archetypes=["steady-chain", "outage-cycle", "wal-replay"], ticks=4, poison=1)
    port_man = SoakManifest(jax_man.root)
    assert port_man.load() == jax_doc
    # the port's plan of the same sweep keeps the manifest verbatim
    assert engine.plan_sweep(port_man, 16, archetypes=["steady-chain", "outage-cycle", "wal-replay"], ticks=4, poison=1) == jax_doc
    _fill_results(jax_man, rng)
    assert port_man.load_results() == jax_man.load_results()
    assert engine.build_report(port_man) == jax_engine.build_report(jax_man)
    assert [c["id"] for c in port_man.pending_cells(rerun_failed=False)] == []
    # the port plans, JAX reads: the same plan byte for byte but the stamp
    port_root = SoakManifest(str(tmp_path / "port"))
    port_doc = engine.plan_sweep(port_root, 16, archetypes=["steady-chain", "outage-cycle", "wal-replay"], ticks=4, poison=1)
    back = JaxManifest(port_root.root)
    assert back.load() == port_doc
    assert {k: v for k, v in port_doc.items() if k != "created_unix"} == {
        k: v for k, v in jax_doc.items() if k != "created_unix"
    }
    _fill_results(port_root, np.random.default_rng(11))
    assert jax_engine.build_report(back) == engine.build_report(port_root)
    # JAX's rerun bookkeeping drops the port's failed records
    failed = [c["id"] for c in port_doc["cells"] if not port_root.load_results()[c["id"]]["pass"]]
    assert failed
    assert [c["id"] for c in back.pending_cells(rerun_failed=True)] == failed
    assert [c["id"] for c in port_root.pending_cells(rerun_failed=False)] == failed


def _flight_doc(rng, trigger, detail="", scale=1.0, ticks=6):
    """A flight box of seeded phase events over `ticks` ticks."""
    events = []
    for tick in range(1, ticks + 1):
        total = 0
        for name in ("parse", "walk_sparse", "merge", "scorers", "assemble"):
            dur = int(rng.uniform(0.2, 3.0) * scale * 1e6)
            total += dur
            events.append([name, tick, tick * 10**9, dur])
        events.append(["dp-tick", tick, tick * 10**9 + 1, int(total * 1.05)])
    return {"kind": "kmamiz-flight", "version": 1, "trigger": trigger, "detail": detail, "wall_s": 1.0,
            "flight_ticks": 64, "events": events, "traces": [], "scorecard": {}, "tenants": {},
            "native": {}, "compileLog": [], "hbmTimeline": []}


def _seeded_cards(rng):
    gates_pool = sorted(set(triage.GATE_PHASE) | {"mystery_gate"})
    cards = []
    for i in range(24):
        tenants = ["default"] if i % 3 == 0 else ["alpha", "beta"]
        failed = list(rng.choice(gates_pool, size=int(rng.integers(0, 3)), replace=False))
        gates = {g: g not in failed for g in ("no_errors", "bit_exact", *failed)}
        live = {t: f"sig-{t}" for t in tenants}
        ref = dict(live)
        if i % 4 == 1:
            ref[tenants[-1]] = "other"
        errors = [f"tick {i}: tenant {tenants[0]} flapped"] if i % 5 == 2 else []
        cards.append({"name": f"cell-{i}", "archetype": NAMES[i % len(NAMES)], "tenants": tenants,
                      "gates": gates, "signatures": live if i % 6 else {}, "ref_signatures": ref,
                      "errors": errors, "pass": not failed and ref == live})
    return cards


def test_triage_and_dedupe_equal_jax_on_seeded_cards():
    rng = np.random.default_rng(5)
    cards = _seeded_cards(rng)
    base = _flight_doc(rng, "soak-baseline-x", "last passing cell")
    slow = _flight_doc(rng, "scenario-cell", "bit_exact", scale=6.0)
    same = _flight_doc(np.random.default_rng(9), "scenario-cell", "bit_exact")
    records = []
    for i, card in enumerate(cards):
        for baseline, flight in ((None, None), (base, slow), (base, same), (base, None)):
            got = triage.triage_card(card, baseline, flight)
            assert got == jax_triage.triage_card(card, baseline, flight)
        assert triage.failed_gates(card) == jax_triage.failed_gates(card)
        assert triage.blamed_tenant(card) == jax_triage.blamed_tenant(card)
        records.append({"id": card["name"], "triage": triage.triage_card(card, base, slow)})
    assert any(r["triage"]["regressed_phases"] for r in records)
    records.append({"name": "untriaged-cell"})
    assert triage.dedupe(records) == jax_triage.dedupe(records)
    # the port's map is the JAX one without the compile gate
    assert triage.GATE_PHASE == {g: p for g, p in jax_triage.GATE_PHASE.items() if g != "zero_steady_recompiles"}


# ---------------------------------------------------------------------------
# the JAX package's sweep tests, over the port
# ---------------------------------------------------------------------------


class TestCells:
    def test_enumeration_is_deterministic_and_lpt_ordered(self):
        a = cells_mod.enumerate_cells(12, seed0=3, ticks=4)
        b = cells_mod.enumerate_cells(12, seed0=3, ticks=4)
        assert a == b
        costs = [c["predicted_s"] for c in a]
        assert costs == sorted(costs, reverse=True)
        assert len({c["id"] for c in a}) == 12

    def test_cycles_archetypes_across_ascending_seeds(self):
        archs = ["steady-chain", "cascade-fanout"]
        cells = cells_mod.enumerate_cells(5, seed0=0, archetypes=archs, ticks=4)
        by_id = {c["id"]: c for c in cells}
        assert set(by_id) == {
            "steady-chain-s0", "cascade-fanout-s0",
            "steady-chain-s1", "cascade-fanout-s1",
            "steady-chain-s2",
        }
        for c in cells:
            assert c["index"] == _arch_index(c["archetype"])

    def test_default_vocabulary_excludes_heavy_and_cold_process(self):
        archs = cells_mod.sweep_archetypes()
        for excluded in soak.SUBPROCESS_HEAVY + soak.COLD_PROCESS:
            assert excluded not in archs
        assert "wal-replay" in archs
        assert set(archs) < set(NAMES)
        assert "capacity-growth-chain" in soak.COLD_PROCESS

    def test_archetype_and_ticks_arguments_validate(self):
        # KMAMIZ_SOAK_ARCHETYPES / _TICKS in the JAX package
        assert cells_mod.sweep_archetypes(["steady-chain", "wal-replay"]) == ["steady-chain", "wal-replay"]
        with pytest.raises(ValueError, match="no-such-archetype"):
            cells_mod.sweep_archetypes(["no-such-archetype"])
        with pytest.raises(ValueError, match="no-such-archetype"):
            cells_mod.enumerate_cells(2, archetypes=["no-such-archetype"])
        assert cells_mod.sweep_ticks(3) == 3
        with pytest.raises(ValueError, match="at least 1"):
            cells_mod.enumerate_cells(2, ticks=0)
        # an opted-in heavy archetype is planned like any other
        heavy = cells_mod.enumerate_cells(2, archetypes=["kill9-wal-replay", "fleet-migration"], ticks=2)
        assert {c["archetype"] for c in heavy} == {"kill9-wal-replay", "fleet-migration"}

    def test_observed_ratios_reorder_the_plan(self):
        base = cells_mod.enumerate_cells(4, archetypes=["steady-chain", "outage-cycle"], ticks=4)
        cheap = next(c for c in base if c["archetype"] == "steady-chain")
        boosted = cells_mod.enumerate_cells(
            4, archetypes=["steady-chain", "outage-cycle"], ticks=4, observed={"steady-chain": 100.0}
        )
        assert boosted[0]["archetype"] == "steady-chain"
        assert boosted[0]["predicted_s"] > cheap["predicted_s"]


def _tiny_plan(man, n=3, poison=0):
    return engine.plan_sweep(man, n, archetypes=["steady-chain"], ticks=4, poison=poison)


class TestManifest:
    def test_claim_is_exclusive(self, tmp_path):
        man = SoakManifest(str(tmp_path))
        _tiny_plan(man)
        assert man.claim("steady-chain-s0") is True
        assert man.claim("steady-chain-s0") is False

    def test_stale_claims_cleared_only_without_result(self, tmp_path):
        man = SoakManifest(str(tmp_path))
        _tiny_plan(man)
        man.claim("steady-chain-s0")
        man.claim("steady-chain-s1")
        man.record_result("steady-chain-s0", {"id": "steady-chain-s0", "pass": True})
        assert man.clear_stale_claims() == ["steady-chain-s1"]
        assert man.claim("steady-chain-s0") is False
        assert man.claim("steady-chain-s1") is True

    def test_pending_is_incremental_and_reruns_failures(self, tmp_path):
        man = SoakManifest(str(tmp_path))
        _tiny_plan(man, n=3)
        man.record_result("steady-chain-s0", {"id": "steady-chain-s0", "ticks": 4, "pass": True})
        man.claim("steady-chain-s1")
        man.record_result("steady-chain-s1", {"id": "steady-chain-s1", "ticks": 4, "pass": False})
        assert [c["id"] for c in man.pending_cells(rerun_failed=False)] == ["steady-chain-s2"]
        ids = [c["id"] for c in man.pending_cells(rerun_failed=True)]
        assert sorted(ids) == ["steady-chain-s1", "steady-chain-s2"]
        assert man.load_results().keys() == {"steady-chain-s0"}
        assert man.claim("steady-chain-s1") is True

    def test_replan_with_other_ticks_invalidates_results(self, tmp_path):
        man = SoakManifest(str(tmp_path))
        engine.plan_sweep(man, 2, archetypes=["steady-chain"], ticks=6)
        man.record_result("steady-chain-s0", {"id": "steady-chain-s0", "ticks": 6, "pass": True})
        man.claim("steady-chain-s0")
        engine.plan_sweep(man, 2, archetypes=["steady-chain"], ticks=4)
        ids = [c["id"] for c in man.pending_cells(rerun_failed=False)]
        assert sorted(ids) == ["steady-chain-s0", "steady-chain-s1"]
        assert man.load_results() == {}
        assert man.claim("steady-chain-s0") is True

    def test_plan_reuse_and_deterministic_poison(self, tmp_path):
        man = SoakManifest(str(tmp_path))
        first = _tiny_plan(man, n=3, poison=1)
        assert _tiny_plan(man, n=3, poison=1) == first
        assert first["poison"] == ["steady-chain-s0"]
        assert [c["id"] for c in first["cells"] if c.get("poison")] == ["steady-chain-s0"]
        assert _tiny_plan(man, n=3, poison=2)["poison"] == ["steady-chain-s0", "steady-chain-s1"]


def _failed_card(**over):
    card = {
        "name": "cascade-fanout-s7i1",
        "archetype": "cascade-fanout",
        "tenants": ["alpha", "beta"],
        "gates": {"bit_exact": False, "no_errors": True},
        "signatures": {"alpha": "x", "beta": "live"},
        "ref_signatures": {"alpha": "x", "beta": "ref"},
        "errors": [],
        "pass": False,
    }
    card.update(over)
    return card


class TestTriage:
    def test_blame_signature_from_deterministic_parts(self):
        tri = triage.triage_card(_failed_card())
        assert tri["blamed_gate"] == "bit_exact"
        assert tri["blamed_phase"] == "merge"
        assert tri["blamed_tenant"] == "beta"
        assert tri["signature"] == "cascade-fanout|bit_exact|merge|beta"
        assert tri["baseline"] is False

    def test_tenant_falls_back_to_error_line_then_matrix(self):
        card = _failed_card(signatures={}, ref_signatures={}, errors=["tick 3: tenant beta source flapped"])
        assert triage.blamed_tenant(card) == "beta"
        assert triage.blamed_tenant(_failed_card(signatures={}, ref_signatures={}, errors=[])) == "matrix"
        card = _failed_card(signatures={}, ref_signatures={}, tenants=["solo"], errors=[])
        assert triage.blamed_tenant(card) == "solo"

    def test_dedupe_same_signature_is_one_bug(self):
        tri = triage.triage_card(_failed_card())
        recs = [
            {"id": "cascade-fanout-s7", "triage": tri},
            {"id": "cascade-fanout-s9", "triage": tri},
            {"id": "outage-cycle-s1", "triage": {"signature": "other|g|p|t"}},
        ]
        bugs = triage.dedupe(recs)
        assert bugs[0]["count"] == 2
        assert bugs[0]["cells"] == ["cascade-fanout-s7", "cascade-fanout-s9"]
        assert len(bugs) == 2

    def test_no_gate_maps_to_the_compile_phase(self):
        # no port card carries zero_steady_recompiles: an unknown gate
        tri = triage.triage_card(_failed_card(gates={"zero_steady_recompiles": False}))
        assert tri["blamed_phase"] == "unknown"
        assert "compile" not in triage.GATE_PHASE.values()


class TestCrashContainment:
    def test_crashed_card_has_full_shape(self):
        card = runner.crashed_card(None, ValueError("boom"), archetype="outage-cycle")
        assert card["pass"] is False
        assert card["gates"] == {"crashed": False}
        assert card["errors"] == ["ValueError: boom"]
        assert "boom" in card["crash"]
        assert card["archetype"] == "outage-cycle"
        # the table and headline readers index these without .get (the
        # port's cards have no compile counts)
        for key in ("p99_tick_ms", "stale_serves", "lost_spans", "quarantined", "expected_poisons", "recovery_ms", "wall_s"):
            assert key in card
        tri = triage.triage_card(card)
        assert tri["blamed_gate"] == "crashed"
        assert tri["blamed_phase"] == "compose"

    def test_run_matrix_contains_a_crashing_scenario(self, monkeypatch):
        def explode(spec, tmpdir=None, verbose=False, device=None):
            raise RuntimeError(f"compose died for {spec.name}")

        monkeypatch.setattr(runner, "run_scenario", explode)
        cards = runner.run_matrix([build_scenario("steady-chain", 0, 0, 4)], device="cpu")
        assert len(cards) == 1
        assert cards[0]["pass"] is False
        assert cards[0]["gates"]["crashed"] is False
        assert "compose died" in cards[0]["errors"][0]
        from kmamiz_tpu_torch.tools.scenario_soak import _table, headline

        assert headline(cards)["scenario_matrix_pass"] is False
        assert "steady-chain" in _table(cards)


class _FakeSpec:
    def __init__(self, archetype, seed, index, ticks):
        self.archetype = archetype
        self.seed = seed
        self.index = index
        self.n_ticks = ticks
        self.name = f"{archetype}-s{seed}i{index}"
        self.tenants = []


def _fast_card(spec, ok=True):
    return {
        "name": spec.name,
        "archetype": spec.archetype,
        "spec_signature": f"sig-{spec.name}",
        "tenants": ["default"],
        "gates": {"bit_exact": ok, "no_errors": True},
        "signatures": {"default": "live"},
        "ref_signatures": {"default": "live" if ok else "ref"},
        "errors": [],
        "p99_tick_ms": 1.0,
        "lost_spans": 0,
        "pass": ok,
    }


class _Failing(set):
    """The cell seeds whose runs fail, and the device of every run."""

    def __init__(self):
        super().__init__()
        self.devices = []


@pytest.fixture
def stub_runner(monkeypatch):
    """Compose and run as instant fakes; failures keyed by a set of cell
    seeds the test controls."""
    failing = _Failing()

    def run(spec, tmpdir=None, verbose=False, device=None):
        failing.devices.append(device)
        return _fast_card(spec, ok=spec.seed not in failing)

    monkeypatch.setattr(factory, "build_scenario", lambda a, s, i, t: _FakeSpec(a, s, i, t))
    monkeypatch.setattr(runner, "run_scenario", run)
    return failing


class TestWorker:
    def test_run_cell_pass_refreshes_baseline(self, tmp_path, stub_runner):
        man = SoakManifest(str(tmp_path / "soak"))
        plan = _tiny_plan(man, n=1)
        rec = worker.run_cell(man, plan["cells"][0], device="cpu", run_id="run-1")
        assert rec["pass"] is True and rec["triage"] is None
        assert rec["run_id"] == "run-1"
        assert stub_runner.devices == ["cpu"]
        assert man.load_results()["steady-chain-s0"]["pass"] is True
        baseline = read_json(man.baseline_path("steady-chain"))
        assert baseline and baseline["kind"] == "kmamiz-flight"

    def test_run_cell_failure_gets_triage(self, tmp_path, stub_runner):
        stub_runner.add(0)
        man = SoakManifest(str(tmp_path / "soak"))
        rec = worker.run_cell(man, _tiny_plan(man, n=1)["cells"][0], device="cpu")
        assert rec["pass"] is False
        assert rec["gates_failed"] == ["bit_exact"]
        assert rec["triage"]["signature"] == "steady-chain|bit_exact|merge|default"

    def test_poison_cell_forced_to_fail_with_evidence(self, tmp_path, stub_runner):
        man = SoakManifest(str(tmp_path / "soak"))
        rec = worker.run_cell(man, _tiny_plan(man, n=1, poison=1)["cells"][0], device="cpu")
        assert rec["poison"] is True and rec["pass"] is False
        assert rec["gates_failed"] == ["soak_poison"]
        assert rec["triage"]["blamed_phase"] == "poison"
        assert rec["flight_artifact"] and os.path.exists(rec["flight_artifact"])

    def test_crashing_cell_is_contained(self, tmp_path, monkeypatch):
        def explode(a, s, i, t):
            raise RuntimeError("compose exploded")

        monkeypatch.setattr(factory, "build_scenario", explode)
        man = SoakManifest(str(tmp_path / "soak"))
        rec = worker.run_cell(man, _tiny_plan(man, n=1)["cells"][0], device="cpu")
        assert rec["pass"] is False
        assert rec["gates_failed"] == ["crashed"]
        assert "compose exploded" in rec["errors"][0]
        assert rec["triage"]["blamed_phase"] == "compose"

    def test_a_device_fault_fails_the_cell_and_never_passes(self, tmp_path, monkeypatch):
        """A raising run (the card's fault, say) is a failed, triaged cell
        that keeps the sweep below its floor: the catch is the sweep's
        contract, not a fallback."""
        def fault(spec, tmpdir=None, verbose=False, device=None):
            raise RuntimeError("CUDA error: an illegal memory access was encountered")

        monkeypatch.setattr(factory, "build_scenario", lambda a, s, i, t: _FakeSpec(a, s, i, t))
        monkeypatch.setattr(runner, "run_scenario", fault)
        man = SoakManifest(str(tmp_path / "soak"))
        _tiny_plan(man, n=2)
        assert worker.work_loop(man.root, device="cpu", run_id="r") == 0
        report = engine.build_report(man)
        assert report["complete"] and report["pass_rate"] == 0.0
        assert report["soak_pass"] is False and report["triaged_fraction"] == 1.0
        assert report["bugs"][0]["blamed_gate"] == "crashed"

    def test_worker_main_refuses_without_a_card(self, tmp_path, monkeypatch):
        import torch

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        man = SoakManifest(str(tmp_path / "soak"))
        _tiny_plan(man, n=1)
        with pytest.raises(RuntimeError, match="CUDA"):
            worker.main(["--dir", man.root])
        # nothing was claimed or recorded
        assert man.load_results() == {} and not os.listdir(man.claims_dir)
        with pytest.raises(RuntimeError, match="CUDA"):
            engine.run_sweep(n_cells=1, archetypes=["steady-chain"], ticks=2, soak_dir=str(tmp_path / "s2"))


@pytest.fixture
def inline_workers(monkeypatch):
    """Run the real worker loop inline instead of subprocesses."""

    class _Done:
        def wait(self):
            return 0

    def spawn(man, n, run_id, verbose, device):
        worker.work_loop(man.root, device=device, run_id=run_id)
        return [_Done()]

    monkeypatch.setattr(engine, "_spawn_workers", spawn)


class TestEngineInProcess:
    def test_sweep_report_poison_and_resume(self, tmp_path, stub_runner, inline_workers):
        root = str(tmp_path / "soak")
        kw = dict(n_cells=6, archetypes=["steady-chain", "outage-cycle"], ticks=4, poison=1, soak_dir=root, workers=1, device="cpu")
        report = engine.run_sweep(**kw)
        assert report["complete"] and report["cells_executed"] == 6
        assert report["pass_rate"] == 1.0
        assert report["triaged_fraction"] == 1.0
        assert report["soak_pass"] is True
        assert report["poison_cells"] == ["outage-cycle-s0"]
        assert report["bugs"][0]["blamed_gate"] == "soak_poison"
        again = engine.run_sweep(**kw, rerun_failed=False)
        assert again["cells_executed"] == 0
        for key in ("cells", "bugs", "pass_rate", "triaged_fraction", "soak_pass", "poison_cells"):
            assert again[key] == report[key], key
        rerun = engine.run_sweep(**kw)
        assert rerun["cells_executed"] == 1
        assert rerun["cells"] == report["cells"]
        # the JAX package reports the port's sweep directory alike
        jax_report = jax_engine.build_report(JaxManifest(root))
        assert jax_report == engine.build_report(SoakManifest(root))

    def test_real_failure_blocks_soak_pass_but_is_triaged(self, tmp_path, stub_runner, inline_workers):
        stub_runner.add(1)
        report = engine.run_sweep(
            n_cells=4, archetypes=["steady-chain", "outage-cycle"], ticks=4, poison=0,
            soak_dir=str(tmp_path / "soak"), workers=1, device="cpu",
        )
        assert report["complete"] is True
        assert report["real_failures"] == 2
        assert report["pass_rate"] == 0.5
        assert report["soak_pass"] is False
        assert report["triaged_fraction"] == 1.0
        assert {b["signature"] for b in report["bugs"]} == {
            "steady-chain|bit_exact|merge|default",
            "outage-cycle|bit_exact|merge|default",
        }
        # a floor the sweep meets passes it (KMAMIZ_SOAK_PASS_FLOOR in JAX)
        assert engine.build_report(SoakManifest(str(tmp_path / "soak")), pass_floor=0.5)["soak_pass"] is True

    def test_recorded_sweeps_registry(self, tmp_path, stub_runner, inline_workers):
        assert soak.recorded_sweeps() == []
        engine.run_sweep(n_cells=1, archetypes=["steady-chain"], ticks=4, soak_dir=str(tmp_path / "soak"), workers=1, device="cpu")
        assert len(soak.recorded_sweeps()) == 1


def test_a_real_mini_sweep_through_the_port_runner(tmp_path, inline_workers):
    """8 cells of the default vocabulary, 2 ticks each, through the
    port's runner on the CPU: every card passes, the poison cell is
    attributed, and each cell's spec is the JAX factory's."""
    root = str(tmp_path / "soak")
    report = engine.run_sweep(n_cells=8, ticks=2, poison=1, soak_dir=root, workers=1, device="cpu")
    assert report["complete"] and report["cells_total"] == 8 and report["cells_executed"] == 8
    assert report["pass_rate"] == 1.0, report["failures"]
    assert report["soak_pass"] is True and report["triaged_fraction"] == 1.0
    assert [b["blamed_gate"] for b in report["bugs"]] == ["soak_poison"]
    results = SoakManifest(root).load_results()
    assert {r["archetype"] for r in results.values()} == set(cells_mod.sweep_archetypes())
    for rec in results.values():
        spec = jax_factory.build_scenario(rec["archetype"], rec["seed"], rec["index"], rec["ticks"])
        assert rec["spec_signature"] == jax_factory.spec_signature(spec)
        assert rec["lost_spans"] == 0
    # every archetype left its baseline but the poison cell's, whose one
    # cell never passed
    poisoned = results[report["poison_cells"][0]]["archetype"]
    assert sorted(os.listdir(SoakManifest(root).baselines_dir)) == sorted(
        f"{a}.json" for a in cells_mod.sweep_archetypes() if a != poisoned
    )


def test_a_subprocess_sweep_spawns_its_workers_on_the_device(tmp_path):
    root = str(tmp_path / "soak")
    report = engine.run_sweep(
        n_cells=4, archetypes=["steady-chain", "outage-cycle"], ticks=2, workers=2,
        soak_dir=root, device="cpu",
    )
    assert report["complete"] and report["cells_executed"] == 4, report
    assert report["soak_pass"] is True
    recs = SoakManifest(root).load_results().values()
    assert {r["run_id"] for r in recs} == {report["run_id"]}
    # cells ran in the worker processes, not in this one
    assert os.getpid() not in {r["worker_pid"] for r in recs}


# ---------------------------------------------------------------------------
# slow tier: the acceptance sweep, for real, on the CPU
# ---------------------------------------------------------------------------


def _cli_sweep(root, cells, extra=(), timeout=3000):
    proc = subprocess.run(
        [sys.executable, "-m", "kmamiz_tpu_torch.tools.graftsoak", "--cells", str(cells), "--ticks", "4",
         "--workers", "2", "--poison", "1", "--soak-dir", root, "--device", "cpu", *extra],
        cwd=REPO, capture_output=True, text=True, timeout=timeout,
    )
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    return proc.returncode, json.loads(lines[-1])


@pytest.mark.slow
class TestAcceptanceSweep:
    def test_200_cells_at_four_nines_with_poison_attributed(self, tmp_path):
        code, report = _cli_sweep(str(tmp_path / "soak"), 200)
        assert report["complete"] is True
        assert report["cells_total"] == 200
        assert report["pass_rate"] >= 0.9999, report["failures"]
        assert report["triaged_fraction"] >= 1.0
        assert len(report["poison_cells"]) == 1
        poison_bug = [b for b in report["bugs"] if b["blamed_gate"] == "soak_poison"]
        assert poison_bug and poison_bug[0]["cells"] == report["poison_cells"]
        assert (code == 0) == report["soak_pass"]

    def test_kill_mid_sweep_resumes_to_identical_report(self, tmp_path):
        root = str(tmp_path / "soak")
        proc = subprocess.Popen(
            [sys.executable, "-m", "kmamiz_tpu_torch.tools.graftsoak", "--cells", "12", "--ticks", "4",
             "--workers", "2", "--poison", "0", "--soak-dir", root, "--device", "cpu"],
            cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL, start_new_session=True,
        )
        man = SoakManifest(root)
        deadline = time.time() + 240
        while time.time() < deadline and len(man.load_results()) < 3:
            time.sleep(1)
        os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
        proc.wait()
        done_before = set(man.load_results())
        assert done_before, "sweep never started"
        code, report = _cli_sweep(root, 12, extra=("--poison", "0"))
        assert code == 0 and report["complete"] is True
        assert report["cells_total"] == 12
        assert report["cells_executed"] == 12 - len(done_before)
        results = man.load_results()
        for cell_id in done_before:
            assert results[cell_id]["run_id"] != report["run_id"]
        code2, again = _cli_sweep(root, 12, extra=("--poison", "0"))
        assert code2 == 0 and again["cells_executed"] == 0
        for key in ("cells", "bugs", "pass_rate", "triaged_fraction", "poison_cells", "soak_pass", "cells_total"):
            assert again[key] == report[key], key

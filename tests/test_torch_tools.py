"""The port's command-line tools (kmamiz_tpu_torch/tools/) against the
repo's JAX tools (tools/graftsoak.py, tools/scenario_soak.py,
tools/graftprof.py) on the CPU.

Each pair is run in process on the same inputs and must print the same
last JSON line and give the same exit code: graftsoak's ``--list`` plan
and ``--report-only`` report over one sweep directory, scenario_soak's
``--list`` and ``headline()`` over the same cards, graftprof's report,
``--diff`` and flight-box blame over the same artifacts. Then each port
tool runs for real on the CPU: a graftsoak sweep through its worker
processes, a scenario_soak matrix and counterfactual, and a graftprof
``--capture`` whose attribution holds the 0.90 bar, whose phases are the
JAX capture's (but XLA's compile), whose collect answers equal the JAX
capture's within the tick's tolerances and whose raw-ingest leg ran and
counted what the JAX capture's counted.
"""
from __future__ import annotations

import importlib
import json
import sys
import types

import numpy as np
import pytest

from kmamiz_tpu_torch import scenarios, soak, telemetry
from kmamiz_tpu_torch.soak import engine
from kmamiz_tpu_torch.soak.manifest import SoakManifest
from kmamiz_tpu_torch.telemetry.profiling import recorder
from kmamiz_tpu_torch.tools import graftprof, graftsoak, scenario_soak
from test_torch_processor import _assert_same_tick
from test_torch_soak import _fill_results, _flight_doc, _seeded_cards


@pytest.fixture(scope="module")
def jax_tools():
    """The JAX tools. Each puts an absolute checkout path at the head of
    sys.path when it is imported, so the packages they import come in
    first from this checkout, and sys.path is put back afterwards."""
    importlib.import_module("kmamiz_tpu.scenarios")
    importlib.import_module("kmamiz_tpu.soak")
    saved = list(sys.path)
    try:
        return types.SimpleNamespace(
            **{name: importlib.import_module(f"tools.{name}") for name in ("graftprof", "graftsoak", "scenario_soak")}
        )
    finally:
        sys.path[:] = saved


@pytest.fixture(autouse=True)
def _tool_state(monkeypatch, tmp_path):
    for var in ("KMAMIZ_SOAK_TICKS", "KMAMIZ_SOAK_ARCHETYPES", "KMAMIZ_SOAK_WORKERS", "KMAMIZ_SOAK_PASS_FLOOR"):
        monkeypatch.delenv(var, raising=False)
    # the JAX capture sets both for good: restored at teardown
    monkeypatch.setenv("KMAMIZ_PROF", "1")
    monkeypatch.setenv("KMAMIZ_PARSE_THREADS", "2")
    monkeypatch.setenv("KMAMIZ_PROF_FLIGHT_DIR", str(tmp_path / "flight"))
    mods = (telemetry, scenarios, soak, recorder)
    for mod in mods:
        mod.reset_for_tests()
    yield
    for mod in mods:
        mod.reset_for_tests()


def _run(main, argv, capsys):
    """(exit code, last stdout line as JSON, every stdout line) of one CLI."""
    code = main(argv)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    return code, json.loads(lines[-1]), lines


# ---------------------------------------------------------------------------
# graftsoak
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "extra",
    [
        ["--cells", "12", "--ticks", "4", "--poison", "1"],
        ["--cells", "30", "--seed", "2", "--archetypes", "steady-chain,wal-replay,fleet-migration"],
    ],
    ids=["default-vocabulary", "archetypes"],
)
def test_graftsoak_list_equals_jax(tmp_path, capsys, extra, jax_tools):
    port = _run(graftsoak.main, ["--list", "--soak-dir", str(tmp_path / "port"), *extra], capsys)
    jax = _run(jax_tools.graftsoak.main, ["--list", "--soak-dir", str(tmp_path / "jax"), *extra], capsys)
    assert port[0] == jax[0] == 0
    assert [json.loads(ln) for ln in port[2]] == [json.loads(ln) for ln in jax[2]]


@pytest.mark.parametrize("failing", [False, True], ids=["passing", "real-failures"])
def test_graftsoak_report_only_equals_jax(tmp_path, capsys, failing, jax_tools):
    man = SoakManifest(str(tmp_path / "soak"))
    engine.plan_sweep(man, 10, archetypes=["steady-chain", "outage-cycle"], ticks=4, poison=1)
    if failing:
        _fill_results(man, np.random.default_rng(3))
    else:
        for cell in man.load()["cells"]:
            poison = bool(cell.get("poison"))
            tri = {"signature": f"{cell['archetype']}|soak_poison|poison|default"} if poison else None
            man.record_result(cell["id"], {**cell, "pass": not poison, "poison": poison, "triage": tri,
                                           "gates_failed": ["soak_poison"] if poison else []})
    port = _run(graftsoak.main, ["--report-only", "--soak-dir", man.root], capsys)
    jax = _run(jax_tools.graftsoak.main, ["--report-only", "--soak-dir", man.root], capsys)
    assert port[1] == jax[1]
    assert port[0] == jax[0] == (1 if failing else 0)
    assert port[1]["soak_pass"] is not failing


def test_graftsoak_sweeps_on_the_cpu(tmp_path, capfd):
    # capfd: the workers write to the engine's stderr by descriptor
    code, out, _ = _run(
        graftsoak.main,
        ["--cells", "3", "--ticks", "2", "--workers", "1", "--poison", "1",
         "--archetypes", "steady-chain,outage-cycle", "--soak-dir", str(tmp_path / "soak"), "--device", "cpu"],
        capfd,
    )
    assert code == 0 and out["soak_pass"] is True
    assert out["cells_executed"] == 3 and out["soak_pass_rate"] == 1.0
    assert out["soak_triaged_fraction"] == 1.0 and out["soak_cells_per_min"] > 0
    assert [b["blamed_gate"] for b in out["bugs"]] == ["soak_poison"]


# ---------------------------------------------------------------------------
# scenario_soak
# ---------------------------------------------------------------------------


def test_headline_equals_jax_on_the_same_cards(jax_tools):
    rng = np.random.default_rng(4)
    cards = _seeded_cards(rng)
    for card in cards:
        card.update(p99_tick_ms=float(np.round(rng.uniform(1, 500), 3)),
                    recovery_ms=float(np.round(rng.uniform(0, 900), 1)), lost_spans=int(rng.integers(0, 2)))
    for subset in (cards, cards[:1], [c for c in cards if c["pass"]], []):
        assert scenario_soak.headline(subset) == jax_tools.scenario_soak.headline(subset)


@pytest.mark.parametrize(
    "argv",
    [["--list", "--matrix", "5", "--ticks", "4"], ["--list", "--seed", "3", "--scenario", "fleet-migration"]],
    ids=["matrix", "scenario"],
)
def test_scenario_soak_list_equals_jax(capsys, argv, jax_tools):
    port = _run(scenario_soak.main, argv, capsys)
    jax = _run(jax_tools.scenario_soak.main, argv, capsys)
    assert port[0] == jax[0] == 0
    assert [json.loads(ln) for ln in port[2]] == [json.loads(ln) for ln in jax[2]]


def test_scenario_soak_runs_on_the_cpu(capsys):
    code, out, _ = _run(scenario_soak.main, ["--matrix", "2", "--ticks", "3", "--device", "cpu"], capsys)
    assert code == 0 and out["scenario_matrix_pass"] is True
    assert out["scenario_lost_spans"] == 0 and len(out["scenarios"]) == 2
    assert out == {"scenarios": out["scenarios"], **scenario_soak.headline(out["scenarios"])}
    code, out, _ = _run(scenario_soak.main, ["--counterfactual", "--ticks", "8", "--device", "cpu"], capsys)
    assert code == 0 and out["counterfactual_pass"] is True
    assert out["control_counterfactual_prevented"] >= 1


# ---------------------------------------------------------------------------
# graftprof
# ---------------------------------------------------------------------------


def _artifacts(tmp_path):
    rng = np.random.default_rng(8)
    docs = {
        "base": _flight_doc(rng, "soak-baseline-x", "last passing cell"),
        "same": None,
        "scenario": _flight_doc(rng, "scenario-cascade-fanout-s7i1", "no_errors,bit_exact"),
        "slow": _flight_doc(rng, "scenario-outage-cycle-s2i5", "soak_poison", scale=5.0),
        "crashed": _flight_doc(rng, "scenario-wal-replay-s0i8", "crashed: RuntimeError: boom"),
        "watchdog": _flight_doc(rng, "watchdog", "deadline", scale=5.0),
    }
    docs["same"] = docs["base"]
    paths = {}
    for name, doc in docs.items():
        paths[name] = tmp_path / f"{name}.json"
        paths[name].write_text(json.dumps(doc))
    return {k: str(v) for k, v in paths.items()}


@pytest.mark.parametrize(
    "pair,extra",
    [
        (("base", "same"), []),
        (("base", "scenario"), []),
        (("base", "slow"), []),
        (("base", "slow"), ["--threshold", "20"]),
        (("base", "crashed"), []),
        (("base", "watchdog"), []),
    ],
    ids=["identical", "scenario-blame", "regressed-blame", "threshold", "crashed", "not-a-scenario"],
)
def test_graftprof_diff_and_blame_equal_jax(tmp_path, capsys, pair, extra, jax_tools):
    paths = _artifacts(tmp_path)
    argv = ["--diff", paths[pair[0]], paths[pair[1]], *extra]
    port = _run(graftprof.main, argv, capsys)
    jax = _run(jax_tools.graftprof.main, argv, capsys)
    assert port[:2] == jax[:2]
    if pair[1] in ("scenario", "slow", "crashed"):
        assert port[1]["blame"]["blamed_phase"] == {"scenario": "merge", "slow": "poison", "crashed": "compose"}[pair[1]]
    else:
        assert "blame" not in port[1]


def test_graftprof_report_equals_jax(tmp_path, capsys, jax_tools):
    paths = _artifacts(tmp_path)
    for name in ("base", "slow"):
        outs = []
        for main in (graftprof.main, jax_tools.graftprof.main):
            assert main(["report", paths[name], "--json"]) == 0
            outs.append(json.loads(capsys.readouterr().out))
        assert outs[0] == outs[1]
    assert graftprof.main([paths["base"]]) == 0
    assert "dp-tick" in capsys.readouterr().out


def test_graftprof_capture_on_the_cpu_against_jax(tmp_path, capsys, monkeypatch, jax_tools):
    """A 2-tick capture: the 0.90 attribution bar, the JAX capture's
    phases (but XLA's compile) and its collect answers."""
    from kmamiz_tpu.server.processor import DataProcessor as JaxProcessor

    port_answers, port_ingest = [], []
    profile = graftprof.capture(
        str(tmp_path / "port.json"), ticks=2, device="cpu", answers=port_answers, ingest=port_ingest
    )
    assert profile["attribution_ratio"] >= 0.90
    assert profile["ticks"] == 3  # two collect ticks and the raw-ingest leg
    # the raw-ingest leg ran, was not skipped nor quarantined, and its
    # native parse and merge are in the profile
    assert len(port_ingest) == 1 and port_ingest[0]["spans"] > 0 and "quarantined" not in port_ingest[0]
    assert {"dp-ingest", "native-merge"} <= set(profile["phases"])
    assert json.loads((tmp_path / "port.json").read_text()) == profile
    # the CLI prints the JAX tool's keys
    code, out, _ = _run(graftprof.main, ["--capture", str(tmp_path / "cli.json"), "--ticks", "2", "--device", "cpu"], capsys)
    assert code == 0 and set(out) == {"profile", "ticks", "wall_ms", "attribution_ratio"}
    assert out["attribution_ratio"] >= 0.90 and out["ticks"] == 3

    jax_answers = []
    real_collect = JaxProcessor.collect

    def collect(self, request, *args, **kwargs):
        answer = real_collect(self, request, *args, **kwargs)
        jax_answers.append(answer)
        return answer

    jax_ingest = []
    real_ingest = JaxProcessor.ingest_raw_window

    def ingest_raw_window(self, raw, *args, **kwargs):
        summary = real_ingest(self, raw, *args, **kwargs)
        jax_ingest.append(summary)
        return summary

    monkeypatch.setattr(JaxProcessor, "collect", collect)
    monkeypatch.setattr(JaxProcessor, "ingest_raw_window", ingest_raw_window)
    monkeypatch.setenv("KMAMIZ_SEGMENT_BACKEND", "pallas_interpret")
    jax_profile = jax_tools.graftprof._capture(str(tmp_path / "jax.json"), 2, 2, 0)
    assert jax_profile["ticks"] == profile["ticks"]
    assert set(profile["phases"]) == set(jax_profile["phases"]) - {"compile"}
    assert len(port_answers) == len(jax_answers) == 2
    for got, want in zip(port_answers, jax_answers):
        _assert_same_tick(got, want)
        assert got["combined"]
    assert len(jax_ingest) == 1
    assert {k: v for k, v in port_ingest[0].items() if k != "ms"} == {k: v for k, v in jax_ingest[0].items() if k != "ms"}

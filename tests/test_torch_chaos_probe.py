"""The port's chaos probe (kmamiz_tpu_torch/tools/chaos_probe.py) against
the repo's JAX tool (tools/chaos_probe.py) on the CPU.

Pillar 1 (the poisoned chunk stream and its quarantine) and pillar 2 (the
breaker's state machine) run in both packages on the same seeds and must
give the same results: chunk counts, quarantined payloads by reason, the
graph signature, the breaker's transitions and snapshot. Pillars 3 and 4
run on the CPU through the port's CLI: the degraded serve holds, with the
window statistics run for each of its three ticks, and the WAL replay
after the SIGKILLed child gives the graph signature of a JAX processor
that ingested every window in process. The CLI prints the JAX tool's keys
(less `stale_new_compiles`: the port has no program registry) and exits
0; without a card it raises before any pillar runs.
"""
from __future__ import annotations

import ast
import contextlib
import importlib
import io
import json
import sys
from pathlib import Path

import pytest
import torch

from kmamiz_tpu_torch.ops import window as window_ops
from kmamiz_tpu_torch.resilience import quarantine as port_quarantine
from kmamiz_tpu_torch.tools import chaos_probe

JAX_TOOL = Path(__file__).resolve().parent.parent / "tools" / "chaos_probe.py"
LEFT_OUT = {"stale_new_compiles"}


@pytest.fixture(scope="module")
def jax_probe():
    """The JAX tool, which puts an absolute checkout path at the head of
    sys.path when it is imported; sys.path is put back afterwards."""
    saved = list(sys.path)
    try:
        tool = importlib.import_module("tools.chaos_probe")
    finally:
        sys.path[:] = saved
    assert Path(tool.__file__).resolve() == JAX_TOOL
    return tool


@pytest.fixture(autouse=True)
def _probe_env(monkeypatch, tmp_path):
    # the JAX pillar 1 sets both for good: restored at teardown
    monkeypatch.setenv("KMAMIZ_QUARANTINE_DIR", str(tmp_path / "q-outer"))
    monkeypatch.setenv("KMAMIZ_INGEST_MAX_BYTES", str(256 * 1024 * 1024))
    monkeypatch.setenv("KMAMIZ_PROF_FLIGHT_DIR", str(tmp_path / "flight"))
    monkeypatch.setenv("KMAMIZ_TICK_DEADLINE_MS", "0")
    for var in ("KMAMIZ_WAL", "KMAMIZ_WAL_DIR", "KMAMIZ_QUARANTINE", "KMAMIZ_STLGT"):
        monkeypatch.delenv(var, raising=False)
    port_quarantine.reset_for_tests()
    yield
    port_quarantine.reset_for_tests()


def _jax_return_keys(function: str) -> set:
    """The keys of the dict the JAX tool's `function` returns, read from
    its source (running pillars 3 and 4 would boot a JAX server and a
    JAX child)."""
    tree = ast.parse(JAX_TOOL.read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == function)
    ret = [n for n in ast.walk(fn) if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict)][-1]
    return {k.value for k in ret.value.keys}


def _run_cli(argv) -> tuple:
    """(exit code, the last stdout line as JSON) of the port's CLI, with
    every window-statistics call counted."""
    calls = {"n": 0}
    real = window_ops.segment_stats

    def counted(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(window_ops, "segment_stats", counted)
        code = chaos_probe.main(argv)
    lines = [ln for ln in out.getvalue().splitlines() if ln.strip()]
    return code, json.loads(lines[-1]), calls["n"]


@pytest.fixture(scope="module")
def port_cli(tmp_path_factory):
    """The port's CLI once on the CPU at seed 0 (its four pillars)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KMAMIZ_PROF_FLIGHT_DIR", str(tmp_path_factory.mktemp("flight")))
        mp.setenv("KMAMIZ_TICK_DEADLINE_MS", "0")
        for var in ("KMAMIZ_WAL", "KMAMIZ_WAL_DIR", "KMAMIZ_QUARANTINE", "KMAMIZ_STLGT"):
            mp.delenv(var, raising=False)
        return _run_cli(["--seed", "0", "--device", "cpu"])


@pytest.fixture
def jax_main_keys(jax_probe, monkeypatch, capsys):
    """The JAX main's JSON keys for an argv, its pillars stubbed (the
    keys it adds around them are what is compared)."""

    def run(argv) -> dict:
        monkeypatch.setattr(jax_probe, "pillar_quarantine", lambda seed, tmpdir: {"ok": True, "quarantined": 0})
        monkeypatch.setattr(jax_probe, "pillar_breaker", lambda: {"ok": True})
        monkeypatch.setattr(jax_probe, "pillar_degraded_serve", lambda: {"ok": True, "degraded_serve_ms": 0.0})
        monkeypatch.setattr(
            jax_probe, "pillar_wal_recovery", lambda seed, tmpdir: {"ok": True, "chaos_recovery_ms": 0.0}
        )
        monkeypatch.setattr(sys, "argv", ["chaos_probe.py", *argv])
        assert jax_probe.main() == 0
        line = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()][-1]
        return json.loads(line)

    return run


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pillar_quarantine_matches_jax(jax_probe, tmp_path, seed):
    from kmamiz_tpu.resilience import quarantine as jax_quarantine

    # an earlier diversion in this process: the pillar counts from zero
    # all the same, and the binding comes back afterwards
    earlier = port_quarantine.default_quarantine()
    earlier.put(b"[", port_quarantine.REASON_TRUNCATED_JSON, source="earlier")
    jax_quarantine.reset_for_tests()
    want = jax_probe.pillar_quarantine(seed, str(tmp_path / "jax"))
    jax_quarantine.reset_for_tests()
    got = chaos_probe.pillar_quarantine(seed, str(tmp_path / "port"), "cpu")
    assert port_quarantine.default_quarantine() is earlier
    assert want["ok"] and got["ok"], (want, got)
    for key in ("chunks", "delivered", "clean", "quarantined", "byReason", "signature", "bitExact"):
        assert got[key] == want[key], key
    assert set(got) == set(want)
    assert sorted(p.name.split("-", 2)[2] for p in (tmp_path / "port" / "quarantine").glob("*.bin")) == sorted(
        p.name.split("-", 2)[2] for p in (tmp_path / "jax" / "quarantine").glob("*.bin")
    )


def test_pillar_breaker_matches_jax(jax_probe):
    assert chaos_probe.pillar_breaker() == jax_probe.pillar_breaker()


def test_degraded_serve_holds_on_the_cpu_with_stats_each_tick(port_cli):
    code, result, stats_calls = port_cli
    pillar = result["degraded_serve"]
    assert pillar["ok"] and pillar["warm_tick"] and pillar["stale_served"] and pillar["recovered_after_straggler"]
    assert set(pillar) == _jax_return_keys("pillar_degraded_serve") - LEFT_OUT
    assert 0 < pillar["degraded_serve_ms"] < 2_000
    # pillars 1 and 4 run no window statistics; pillar 3's three ticks two
    # segment-stats calls each (on the card, two kernel launches each)
    assert stats_calls == 2 * 3


def test_wal_recovery_on_the_cpu_gives_the_jax_graph(jax_probe, port_cli):
    from kmamiz_tpu.resilience.chaos import graph_signature
    from kmamiz_tpu.server.processor import DataProcessor

    pillar = port_cli[1]["wal_recovery"]
    assert pillar["ok"] and pillar["child_sigkilled"] and pillar["bitExact"]
    assert pillar["wal_records_replayed"] == pillar["windows"] == 20
    assert set(pillar) == _jax_return_keys("pillar_wal_recovery")
    reference = DataProcessor(trace_source=lambda *a: [], use_device_stats=False)
    for raw in jax_probe._clean_chunks(prefix="w"):
        reference.ingest_raw_window(raw)
    assert pillar["signature"] == graph_signature(reference.graph)


def test_main_on_the_cpu_prints_the_jax_keys(port_cli, jax_main_keys):
    code, result, _ = port_cli
    assert code == 0 and result["ok"] is True
    assert set(result) == set(jax_main_keys([]))
    assert result["seed"] == 0
    assert result["chaos_recovery_ms"] == result["wal_recovery"]["chaos_recovery_ms"]
    assert result["degraded_serve_ms"] == result["degraded_serve"]["degraded_serve_ms"]
    for pillar in chaos_probe.PILLARS:
        assert set(result[pillar]) == _jax_return_keys(f"pillar_{pillar}") - LEFT_OUT


def test_main_matrix_of_two_seeds_passes_both(jax_main_keys):
    code, result, _ = _run_cli(["--matrix", "2", "--device", "cpu"])
    want = jax_main_keys(["--matrix", "2"])
    assert code == 0 and result["ok"] is True
    assert set(result) == set(want)
    # the seeded pillars' aggregates are main's own; the seedless pillars
    # run once, as without --matrix
    for key in ("quarantine", "wal_recovery"):
        assert set(result[key]) == set(want[key]), key
    for key in ("breaker", "degraded_serve"):
        assert set(result[key]) == _jax_return_keys(f"pillar_{key}") - LEFT_OUT, key
        assert result[key]["ok"], key
    assert result["quarantine"]["seeds_passed"] == result["wal_recovery"]["seeds_passed"] == 2
    assert result["matrix_seeds"] == want["matrix_seeds"] == [0, 1]
    assert [r["seed"] for r in result["matrix"]] == [0, 1]
    for r in result["matrix"]:
        assert r["quarantine"]["ok"] and r["wal_recovery"]["ok"]
        assert set(r["quarantine"]) == _jax_return_keys("pillar_quarantine")


def test_main_raises_without_a_card_before_any_pillar(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def never(*a, **kw):
        raise AssertionError("a pillar ran without a card")

    for name in ("pillar_quarantine", "pillar_breaker", "pillar_degraded_serve", "pillar_wal_recovery"):
        monkeypatch.setattr(chaos_probe, name, never)
    for argv in ([], ["--device", "cuda"], ["--matrix", "2"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            chaos_probe.main(argv)


def test_reset_forgets_the_tenants_quarantines_as_jax(tmp_path):
    from kmamiz_tpu.resilience import quarantine as jax_quarantine

    for package in (jax_quarantine, port_quarantine):
        package.quarantine_for("acme").put(b"[", package.REASON_TRUNCATED_JSON, source="t")
        assert package.tenant_quarantine_stats()["acme"]["count"] == 1
        package.reset_for_tests()
        assert package.tenant_quarantine_stats() == {}
        assert package.quarantine_stats()["count"] == 0


def test_scoped_default_leaves_the_tenants_bindings_alone(tmp_path):
    acme = port_quarantine.quarantine_for("acme")
    acme.put(b"[", port_quarantine.REASON_TRUNCATED_JSON, source="t")
    earlier = port_quarantine.default_quarantine()
    with port_quarantine.scoped_default(str(tmp_path / "scoped")) as fresh:
        assert port_quarantine.default_quarantine() is fresh
        assert port_quarantine.quarantine_for("acme") is acme
    assert port_quarantine.default_quarantine() is earlier
    assert port_quarantine.quarantine_for("acme") is acme
    assert port_quarantine.tenant_quarantine_stats()["acme"]["count"] == 1

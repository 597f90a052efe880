"""The port's fleet bench (kmamiz_tpu_torch/tools/fleet_bench.py) against
the repo's JAX tool (tools/fleet_bench.py) on the CPU.

The frames each tenant sends and the tenant placed on each worker are the
JAX tool's, byte for byte. The CLI boots four CPU workers (``python -m
kmamiz_tpu_torch.fleet.worker --device cpu``), prints the JAX tool's keys
and passes its migration with no span lost; `scorecard` does the same
over workers the caller runs (in process here); without a card the CLI
raises before it spawns anything.
"""
from __future__ import annotations

import ast
import importlib
import json
import sys
from pathlib import Path

import pytest
import torch

from kmamiz_tpu_torch.fleet.coordinator import LocalTransport
from kmamiz_tpu_torch.fleet.ring import HashRing
from kmamiz_tpu_torch.fleet.worker import FleetWorker
from kmamiz_tpu_torch.tools import fleet_bench

JAX_TOOL = Path(__file__).resolve().parent.parent / "tools" / "fleet_bench.py"


@pytest.fixture(scope="module")
def jax_bench():
    """The JAX tool, which puts the checkout at the head of sys.path when
    it is imported; sys.path is put back afterwards."""
    saved = list(sys.path)
    try:
        return importlib.import_module("tools.fleet_bench")
    finally:
        sys.path[:] = saved


def _jax_result_keys() -> set:
    """The keys of the scorecard the JAX tool's main starts from."""
    tree = ast.parse(JAX_TOOL.read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    assign = next(
        n
        for n in ast.walk(main)
        if isinstance(n, ast.Assign) and getattr(n.targets[0], "id", None) == "result" and isinstance(n.value, ast.Dict)
    )
    return {k.value for k in assign.value.keys}


@pytest.mark.parametrize("tenant", ["fb0", "fb3", "t-1"])
def test_frames_equal_the_jax_tools(jax_bench, tenant):
    assert fleet_bench._frames(tenant, 4) == jax_bench._frames(tenant, 4)


@pytest.mark.parametrize("seed", [0, 26])
def test_tenant_for_each_worker_equals_the_jax_tools(jax_bench, seed):
    from kmamiz_tpu.fleet.ring import HashRing as JaxRing

    workers = ["w0", "w1", "w2", "w3"]
    got = fleet_bench._tenant_for_each_worker(HashRing(workers, vnodes=64, seed=seed))
    want = jax_bench._tenant_for_each_worker(JaxRing(workers, vnodes=64, seed=seed))
    assert got == want
    assert sorted(w for w, _ in got) == workers


def test_main_on_four_cpu_workers_passes_its_migration(capsys):
    assert fleet_bench.main(["--frames", "2", "--device", "cpu"]) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()][-1]
    result = json.loads(line)
    assert "fleet_bench_error" not in result, result
    assert set(result) == _jax_result_keys()
    assert result["fleet_migration_pass"] is True
    assert result["fleet_migration_lost_spans"] == 0
    assert result["fleet_spans_per_sec_1"] > 0 and result["fleet_spans_per_sec_4"] > 0
    assert result["fleet_scale_efficiency"] > 0


def test_scorecard_over_in_process_workers(tmp_path):
    ring = HashRing(["w0", "w1", "w2", "w3"])
    workers = {w: FleetWorker(w, wal_root=str(tmp_path), device="cpu") for w in ring.workers}
    result = fleet_bench.scorecard(LocalTransport(workers), ring, 2)
    assert "fleet_bench_error" not in result, result
    assert set(result) == _jax_result_keys()
    assert result["fleet_migration_pass"] is True and result["fleet_migration_lost_spans"] == 0
    # the migrated tenant landed on its target
    src, tenant = fleet_bench._tenant_for_each_worker(ring)[0]
    assert tenant not in workers[src].tenants()


def test_scorecard_turns_an_error_into_its_key(tmp_path):
    ring = HashRing(["w0", "w1", "w2", "w3"])
    result = fleet_bench.scorecard(LocalTransport({}), ring, 2)
    assert result["fleet_bench_error"].startswith("TransportError")
    assert result["fleet_migration_pass"] is None


def test_main_raises_without_a_card_before_it_spawns(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def never(*a, **kw):
        raise AssertionError("a worker was spawned without a card")

    monkeypatch.setattr(fleet_bench.subprocess, "Popen", never)
    for argv in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            fleet_bench.main(argv)

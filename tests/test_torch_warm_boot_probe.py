"""The port's restart-warmth probe (kmamiz_tpu_torch/tools/warm_boot_probe.py)
on the CPU: its one JSON line carries the JAX tool's keys (read from the
JAX tool's source: running it compiles XLA programs), its new-compile
counts are real counts of libraries loaded inside the timed ticks, and
without a card the default device raises.
"""
from __future__ import annotations

import ast
import json
from pathlib import Path

import pytest
import torch

from kmamiz_tpu_torch.core import compile_cache
from kmamiz_tpu_torch.tools import warm_boot_probe

JAX_TOOL = Path(__file__).resolve().parent.parent / "tools" / "warm_boot_probe.py"


def _jax_line_keys() -> set:
    """The keys of the dict the JAX tool's main() prints with json.dumps."""
    tree = ast.parse(JAX_TOOL.read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    for node in ast.walk(main):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "dumps"
            and node.args
            and isinstance(node.args[0], ast.Dict)
        ):
            return {k.value for k in node.args[0].keys}
    raise AssertionError("no json.dumps({...}) in the JAX tool's main")


@pytest.fixture
def small_ticks(monkeypatch):
    monkeypatch.setattr(warm_boot_probe, "TICK_TRACES", 150)


def test_the_line_has_the_jax_tools_keys_and_no_load_inside_a_tick(capsys, small_ticks):
    assert warm_boot_probe.main(["--device", "cpu"]) == 0
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    want = _jax_line_keys()
    assert want == {
        "prewarm_s",
        "prewarm_programs",
        "prewarm_report",
        "first_tick_ms",
        "second_tick_ms",
        "first_tick_new_compiles",
        "second_tick_new_compiles",
        "programs",
    }
    assert set(line) == want | {"device"}
    assert line["device"] == "cpu"
    assert line["first_tick_new_compiles"] == line["second_tick_new_compiles"] == 0
    assert line["first_tick_ms"] > 0 and line["second_tick_ms"] > 0 and line["prewarm_s"] >= 0
    assert "kmamiz_native" in line["programs"]
    assert line["programs"]["kmamiz_native"]["kind"] == "host"
    assert line["prewarm_report"]["device"] == "cpu"
    assert "library" in out.err  # the per-library table on stderr


def test_a_library_first_loaded_inside_a_tick_is_counted(monkeypatch, small_ticks):
    from kmamiz_tpu_torch.server.processor import DataProcessor

    collect = DataProcessor.collect
    ticks = []

    def late_load(self, request, *args, **kwargs):
        ticks.append(request["uniqueId"])
        if request["uniqueId"] == "warm-1":
            compile_cache.record_load("late", "cuda", "/x/liblate.so", True, 5.0, 1.0)
        return collect(self, request, *args, **kwargs)

    monkeypatch.setattr(DataProcessor, "collect", late_load)
    line = warm_boot_probe.probe("cpu")
    assert ticks == ["warm-1", "warm-2"]
    assert line["first_tick_new_compiles"] == 1 and line["second_tick_new_compiles"] == 0
    assert line["programs"]["late"] == {"kind": "cuda", "built": True, "buildMs": 5.0, "loadMs": 1.0, "prewarmed": False}


def test_the_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        warm_boot_probe.main([])

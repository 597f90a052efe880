"""The port's parse profiler (kmamiz_tpu_torch/tools/profile_parse.py)
against the repo's JAX tool (tools/profile_parse.py) on the CPU.

At a small window both print the same lines: the window's spans and
megabytes, then per thread count the walls' line and the reps' line, the
native worker count equal; only the times (walls, the generator's and
the native phases') differ between two runs, and are masked. A parse the
library rejects raises in the port.
"""
from __future__ import annotations

import importlib
import importlib.util
import re
import sys
from pathlib import Path

import pytest

from kmamiz_tpu_torch import native
from kmamiz_tpu_torch.tools import profile_parse

ARGV = ["1500", "2", "1,2"]
NUMBER = r"\d+(?:\.\d+)?"


CHECKOUT = Path(__file__).resolve().parent.parent


def _under_checkout(module) -> bool:
    return Path(module.__file__).resolve().is_relative_to(CHECKOUT)


@pytest.fixture(scope="module")
def jax_profile():
    """The JAX tool, which puts an absolute checkout path at the head of
    sys.path and imports bench.py and kmamiz_tpu.native when it is
    imported. Both are loaded from this checkout first, so the tool finds
    them cached wherever the checkout lies; sys.path is put back
    afterwards."""
    if "bench" not in sys.modules:
        spec = importlib.util.spec_from_file_location("bench", CHECKOUT / "bench.py")
        bench = importlib.util.module_from_spec(spec)
        sys.modules["bench"] = bench
        spec.loader.exec_module(bench)
    importlib.import_module("kmamiz_tpu.native")
    saved = list(sys.path)
    try:
        tool = importlib.import_module("tools.profile_parse")
    finally:
        sys.path[:] = saved
    for name in ("bench", "kmamiz_tpu", "kmamiz_tpu.native", "tools.profile_parse"):
        assert _under_checkout(sys.modules[name]), name
    return tool


def _masked(line: str) -> str:
    """The line with its times masked: the generator's wall, the walls and
    phase times, and each rep's wall (their count kept)."""
    line = re.sub(rf"\(gen {NUMBER}s\)", "(gen #s)", line)
    line = re.sub(rf"\b(min|med|max|prescan|parse|merge)\s+{NUMBER}", r"\1 #", line)
    if line.lstrip().startswith("reps:"):
        line = re.sub(NUMBER, "#", line)
    return line


def test_prints_the_jax_tools_lines(jax_profile, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["profile_parse.py", *ARGV])
    jax_profile.main()
    want = capsys.readouterr().out.splitlines()
    profile_parse.main(ARGV)
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 1 + 2 * len(ARGV[2].split(","))
    assert [_masked(g) for g in got] == [_masked(w) for w in want]
    # the unmasked parts carry the window's size and the worker counts
    assert got[0].startswith(f"window: {1500 * 7} spans, ")
    assert "(native threads 2)" in got[3]


def test_reads_its_argv_from_the_command_line(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["profile_parse", "200", "1", "1"])
    profile_parse.main()
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("window: 1400 spans, ") and lines[1].startswith("t1: ")
    assert re.fullmatch(rf"\s+reps: \[{NUMBER}\]", lines[2])


def test_a_rejected_window_raises(monkeypatch):
    monkeypatch.setattr(native, "parse_spans", lambda raw, threads=None: None)
    with pytest.raises(ValueError, match="malformed"):
        profile_parse.main(["100", "1", "1"])

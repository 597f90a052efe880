"""The port's graftlint (kmamiz_tpu_torch/analysis/) against its fixture
corpus, and against the JAX engine on the JAX corpus.

The corpus (tests/fixtures/lint_torch/) is the JAX corpus
(tests/fixtures/lint/) with its package prefix renamed and its jax idioms
written in torch, each file at the same line numbers. Every violation
line carries an `# EXPECT: <rule>` marker; the core assertion is EXACT
set equality between markers and findings. The rules carried over with
the same logic must find what the JAX engine finds on the JAX corpus,
line for line; the three torch-meaning rules have markers and clean twins
of their own.
"""
from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from kmamiz_tpu.analysis import framework as jax_framework
from kmamiz_tpu_torch.analysis import framework

FIXTURES = Path(__file__).parent / "fixtures"
FIXTURE_ROOT = FIXTURES / "lint_torch"
JAX_FIXTURE_ROOT = FIXTURES / "lint"
_EXPECT_RE = re.compile(r"#\s*EXPECT:\s*([\w,\s-]+)")

ALL_RULES = {
    "unregistered-jit",
    "host-sync-in-hot-path",
    "dtype-drift",
    "unguarded-shared-state",
    "hot-path-metric-label",
    "hot-path-clock",
    "prof-counter-wire",
    # graftrace concurrency rules (analysis/concurrency/, tools/graftrace.py)
    "lock-order-cycle",
    "blocking-call-under-lock",
    "inconsistent-guard",
}
# the JAX rules for XLA retraces and buffer donation: no port counterpart
LEFT_OUT = {"shape-hazard", "donation-miss"}
# the rules whose logic is the JAX package's (host rules, concurrency)
CARRIED_OVER = (
    "unguarded-shared-state",
    "hot-path-metric-label",
    "hot-path-clock",
    "prof-counter-wire",
    "lock-order-cycle",
    "blocking-call-under-lock",
    "inconsistent-guard",
)


def _to_port(path: str) -> str:
    return re.sub(r"^kmamiz_tpu/", "kmamiz_tpu_torch/", path)


def _expected_from_markers():
    expected = set()
    for path in sorted(FIXTURE_ROOT.rglob("*.py")):
        rel = path.relative_to(FIXTURE_ROOT).as_posix()
        for lineno, line in enumerate(path.read_text().splitlines(), 1):
            m = _EXPECT_RE.search(line)
            if not m:
                continue
            for rule in m.group(1).split(","):
                expected.add((rel, lineno, rule.strip()))
    return expected


def lint_corpus(**kw):
    """The torch corpus linted without the live DECLARED_EDGES, whose
    processor.py path collides with the corpus's (the JAX tests lint
    their corpus without the live jit tables for the same reason)."""
    from kmamiz_tpu_torch.analysis.concurrency import locks

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(locks, "DECLARED_EDGES", ())
        return framework.lint_paths(str(FIXTURE_ROOT), **kw)


@pytest.fixture(scope="module")
def corpus_result():
    return lint_corpus()


@pytest.fixture(scope="module")
def jax_corpus_result():
    # empty jit tables: the JAX corpus must not inherit the live guard tables
    return jax_framework.lint_paths(str(JAX_FIXTURE_ROOT), tables=({}, {}))


class TestFixtureCorpus:
    def test_findings_match_markers_exactly(self, corpus_result):
        got = {(f.path, f.line, f.rule) for f in corpus_result.findings}
        expected = _expected_from_markers()
        assert got == expected, (
            f"missing: {sorted(expected - got)}\n"
            f"unexpected: {sorted(got - expected)}"
        )

    def test_every_rule_catches_its_seeded_violation(self, corpus_result):
        assert {f.rule for f in corpus_result.findings} == ALL_RULES

    def test_suppressions_divert_not_delete(self, corpus_result):
        sup = {(f.path, f.rule) for f in corpus_result.suppressed}
        assert sup == {
            ("kmamiz_tpu_torch/server/processor.py", "host-sync-in-hot-path"),
            ("kmamiz_tpu_torch/server/processor.py", "hot-path-metric-label"),
            ("kmamiz_tpu_torch/server/processor.py", "hot-path-clock"),
            ("kmamiz_tpu_torch/server/state.py", "unguarded-shared-state"),
        }

    def test_strict_flags_reasonless_suppressions(self, corpus_result):
        # state.py's suppression has no `-- reason`; processor.py's does
        missing = corpus_result.missing_reasons()
        assert [p for p, _ in missing] == ["kmamiz_tpu_torch/server/state.py"]

    def test_cold_twin_has_zero_findings(self, corpus_result):
        assert not [
            f for f in corpus_result.findings if f.path.endswith("offline.py")
        ]

    def test_corpus_has_every_jax_corpus_file(self):
        # every JAX corpus file has its torch twin (the lines of each are
        # held by TestParityWithReference), the native struct unchanged
        jax_files = {
            _to_port(p.relative_to(JAX_FIXTURE_ROOT).as_posix())
            for p in JAX_FIXTURE_ROOT.rglob("*.py")
        }
        assert jax_files <= {
            p.relative_to(FIXTURE_ROOT).as_posix() for p in FIXTURE_ROOT.rglob("*.py")
        }
        assert (FIXTURE_ROOT / "kmamiz_tpu_torch" / "csrc" / "kmamiz_spans.cpp").read_text() == (
            JAX_FIXTURE_ROOT / "native" / "kmamiz_spans.cpp"
        ).read_text()


class TestParityWithReference:
    """The rules carried over find, on the torch corpus, what the JAX
    engine finds on the JAX corpus: (rule, path with the prefix mapped,
    line)."""

    @pytest.mark.parametrize("rule", CARRIED_OVER)
    def test_findings_equal_the_jax_engines(self, rule, corpus_result, jax_corpus_result):
        got = {(f.rule, f.path, f.line) for f in corpus_result.findings if f.rule == rule}
        want = {
            (f.rule, _to_port(f.path), f.line)
            for f in jax_corpus_result.findings
            if f.rule == rule
        }
        assert want, rule
        assert got == want

    @pytest.mark.parametrize("rule", CARRIED_OVER)
    def test_messages_equal_the_jax_engines(self, rule, corpus_result, jax_corpus_result):
        # the same text, up to the package names a message quotes
        got = sorted(f.message for f in corpus_result.findings if f.rule == rule)
        want = sorted(
            f.message.replace("kmamiz_tpu/", "kmamiz_tpu_torch/")
            for f in jax_corpus_result.findings
            if f.rule == rule
        )
        assert got == want

    def test_suppressed_findings_equal_the_jax_engines(self, corpus_result, jax_corpus_result):
        got = {(f.rule, f.path, f.line) for f in corpus_result.suppressed if f.rule in CARRIED_OVER}
        want = {
            (f.rule, _to_port(f.path), f.line)
            for f in jax_corpus_result.suppressed
            if f.rule in CARRIED_OVER
        }
        assert got == want

    def test_hot_set_equals_the_jax_engines(self):
        from kmamiz_tpu.analysis import callgraph as jax_callgraph
        from kmamiz_tpu_torch.analysis import callgraph

        ctx = framework.build_context(str(FIXTURE_ROOT))
        jax_ctx = jax_framework.build_context(str(JAX_FIXTURE_ROOT), tables=({}, {}))
        mapped = {_to_port(q) for q in jax_ctx.hot}
        # the torch corpus's processor adds four hot functions after the
        # JAX corpus's last line (the torch-meaning cases)
        assert ctx.hot - mapped == {
            f"kmamiz_tpu_torch/server/processor.py:{fn}"
            for fn in ("tick_host_copies", "tick_host_copies_clean", "tick_dtype_more", "tick_dtype_clean")
        }
        assert mapped <= ctx.hot
        # the seeds are the JAX package's, each at its path in the port
        assert callgraph.DEFAULT_SEED_MODULES == tuple(
            _to_port(s) for s in jax_callgraph.DEFAULT_SEED_MODULES
        )


class TestTorchMeaningRules:
    @pytest.mark.parametrize(
        "line, what",
        [
            (21, ".cpu()"),
            (22, "bool() of a tensor"),
            (28, ".item()"),
            (33, "float() of a tensor"),
            (38, "torch.cuda.synchronize()"),
            (102, ".tolist() of a tensor"),
            (103, ".numpy() of a tensor"),
            (104, "np.asarray of a tensor"),
            (106, "Event.synchronize()"),
        ],
    )
    def test_each_torch_sync_is_flagged(self, corpus_result, line, what):
        hits = [
            f
            for f in corpus_result.findings
            if f.rule == "host-sync-in-hot-path"
            and f.path == "kmamiz_tpu_torch/server/processor.py"
            and f.line == line
        ]
        assert len(hits) == 1, what

    @pytest.mark.parametrize(
        "path, first, last",
        [
            # host data, a numpy array's .tolist(), metadata reads
            ("kmamiz_tpu_torch/server/processor.py", 110, 114),
            # explicit dtypes, an integer arange, .float()
            ("kmamiz_tpu_torch/server/processor.py", 124, 127),
            ("kmamiz_tpu_torch/server/processor.py", 54, 57),
            # eager functions under plain decorators
            ("kmamiz_tpu_torch/ops/kernels.py", 16, 19),
            ("kmamiz_tpu_torch/ops/kernels.py", 41, 48),
            # the JAX corpus's shape hazards: no rule in the port
            ("kmamiz_tpu_torch/ops/shapes.py", 1, 37),
        ],
    )
    def test_clean_twins_are_silent(self, corpus_result, path, first, last):
        assert not [
            f for f in corpus_result.findings if f.path == path and first <= f.line <= last
        ]

    @pytest.mark.parametrize("line", [12, 22, 29, 34, 38])
    def test_each_compile_form_is_flagged(self, corpus_result, line):
        # @torch.compile, torch.compile(f), jit.script, @partial(torch.compile),
        # torch.jit.trace
        assert [
            f.rule
            for f in corpus_result.findings
            if f.path == "kmamiz_tpu_torch/ops/kernels.py" and f.line == line
        ] == ["unregistered-jit"]

    @pytest.mark.parametrize("line", [48, 49, 50, 118, 119, 120])
    def test_each_dtype_drift_is_flagged(self, corpus_result, line):
        assert [
            f.rule
            for f in corpus_result.findings
            if f.path == "kmamiz_tpu_torch/server/processor.py" and f.line == line
        ] == ["dtype-drift"]

    def test_compile_is_flagged_off_the_hot_path_too(self, tmp_path):
        pkg = tmp_path / "kmamiz_tpu_torch" / "cold"
        pkg.mkdir(parents=True)
        (pkg / "m.py").write_text("import torch\nf = torch.compile(abs)\n")
        result = framework.lint_paths(str(tmp_path), rules=["unregistered-jit"])
        assert [(f.path, f.line) for f in result.findings] == [("kmamiz_tpu_torch/cold/m.py", 2)]


class TestFrameworkMechanics:
    def test_rule_subset_and_unknown_rule(self):
        result = framework.lint_paths(str(FIXTURE_ROOT), rules=["unguarded-shared-state"])
        assert {f.rule for f in result.findings} == {"unguarded-shared-state"}
        with pytest.raises(ValueError, match="unknown rule"):
            framework.lint_paths(str(FIXTURE_ROOT), rules=["no-such-rule"])

    @pytest.mark.parametrize("rule", sorted(LEFT_OUT))
    def test_left_out_rules_are_unknown(self, rule):
        with pytest.raises(ValueError, match="unknown rule"):
            framework.lint_paths(str(FIXTURE_ROOT), rules=[rule])

    def test_prof_counter_wire_flags_both_directions(self):
        # the fixture struct has `new_counter_ns` the decoder never
        # learned AND the decoder lists `ghost_ns` the struct dropped;
        # both findings anchor on the _PROF_SCALARS assignment line
        result = framework.lint_paths(str(FIXTURE_ROOT), rules=["prof-counter-wire"])
        msgs = sorted(f.message for f in result.findings)
        assert len(msgs) == 2
        assert any("new_counter_ns" in m and "not listed" in m for m in msgs)
        assert any("ghost_ns" in m and "stale" in m for m in msgs)

    def test_prof_counter_wire_clean_without_native_tree(self, tmp_path):
        # fixture repos without csrc/kmamiz_spans.cpp are out of scope
        pkg = tmp_path / "kmamiz_tpu_torch" / "native"
        pkg.mkdir(parents=True)
        (pkg / "__init__.py").write_text('_PROF_SCALARS = ("parses",)\n')
        result = framework.lint_paths(str(tmp_path))
        assert not result.findings

    def test_prof_counter_wire_reads_the_ports_own_pair(self, tmp_path):
        # the JAX package's native/ tree is not the port's wire
        (tmp_path / "native").mkdir()
        (tmp_path / "native" / "kmamiz_spans.cpp").write_text(
            "struct ProfCounters {\n  uint64_t parses = 0;\n  uint64_t other = 0;\n};\n"
        )
        pkg = tmp_path / "kmamiz_tpu_torch" / "native"
        pkg.mkdir(parents=True)
        (pkg / "__init__.py").write_text('_PROF_SCALARS = ("parses",)\n')
        assert not framework.lint_paths(str(tmp_path)).findings

    def test_suppression_comment_above_line(self, tmp_path):
        pkg = tmp_path / "kmamiz_tpu_torch" / "server"
        pkg.mkdir(parents=True)
        (pkg / "m.py").write_text(
            "_CACHE = {}\n"
            "def f(k, v):\n"
            "    # graftlint: disable=unguarded-shared-state -- test above-line form\n"
            "    _CACHE[k] = v\n"
        )
        result = framework.lint_paths(str(tmp_path))
        assert not result.findings and len(result.suppressed) == 1

    def test_default_walk_is_the_port_alone(self, tmp_path):
        for pkg in ("kmamiz_tpu", "kmamiz_tpu_torch"):
            (tmp_path / pkg / "server").mkdir(parents=True)
            (tmp_path / pkg / "server" / "m.py").write_text("_C = {}\ndef f(k):\n    _C[k] = 1\n")
        ctx = framework.build_context(str(tmp_path))
        assert list(ctx.modules) == ["kmamiz_tpu_torch/server/m.py"]

    def test_render_json_roundtrips(self, corpus_result):
        doc = json.loads(framework.render_json(corpus_result))
        assert doc["counts"]["findings"] == len(corpus_result.findings)
        assert {f["rule"] for f in doc["findings"]} == ALL_RULES

    def test_render_text_counts(self, corpus_result):
        text = framework.render_text(corpus_result)
        assert f"{len(corpus_result.findings)} finding(s)" in text
        assert "4 suppressed" in text

    def test_all_rules_registered(self):
        assert set(framework.all_rules()) == ALL_RULES
        assert set(jax_framework.all_rules()) == ALL_RULES | LEFT_OUT


class TestHotGatingKnobs:
    def test_hot_all_flags_cold_module(self):
        result = framework.lint_paths(
            str(FIXTURE_ROOT),
            rules=["host-sync-in-hot-path"],
            hot_all=True,
        )
        assert [f for f in result.findings if f.path.endswith("offline.py")]

    def test_explicit_seed_narrows_hot_set(self):
        result = framework.lint_paths(
            str(FIXTURE_ROOT),
            rules=["host-sync-in-hot-path"],
            seeds=["kmamiz_tpu_torch/cold/offline.py"],
        )
        paths = {f.path for f in result.findings}
        assert paths == {"kmamiz_tpu_torch/cold/offline.py"}


class TestCLI:
    def test_list_rules(self, capsys):
        from kmamiz_tpu_torch.tools.graftlint import main

        assert main(["--list-rules"]) == 0
        out = capsys.readouterr().out
        for rule in ALL_RULES:
            assert rule in out
        for rule in LEFT_OUT:
            assert rule not in out

    def test_json_on_repo_parses(self, capsys):
        from kmamiz_tpu_torch.tools.graftlint import main

        assert main(["--json", "kmamiz_tpu_torch/analysis"]) == 0
        doc = json.loads(capsys.readouterr().out)
        assert doc["findings"] == []

    def test_unknown_rule_exits_2(self, capsys):
        from kmamiz_tpu_torch.tools.graftlint import main

        assert main(["--rules", "shape-hazard"]) == 2
        assert "unknown rule" in capsys.readouterr().err

    def test_strict_exits_1_on_a_finding(self, tmp_path, monkeypatch, capsys):
        from kmamiz_tpu_torch.tools import graftlint

        monkeypatch.setattr(graftlint.framework, "repo_root", lambda: str(FIXTURE_ROOT))
        assert graftlint.main(["--strict"]) == 1
        assert graftlint.main([]) == 0
        monkeypatch.setenv("KMAMIZ_LINT_STRICT", "1")
        assert graftlint.main([]) == 1
        assert "suppression without a reason" in capsys.readouterr().err

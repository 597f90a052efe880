"""The port's tree must be graftlint-clean under its own rules.

Two layers, as for the JAX package: the CLI contract
(``python -m kmamiz_tpu_torch.tools.graftlint --strict`` exits 0) and the
in-process invariants (zero unsuppressed findings, every suppression
carries a ``-- reason``). The port lints ``kmamiz_tpu_torch/`` alone: the
JAX package is never linted from it.
"""
import subprocess
import sys
from pathlib import Path

from kmamiz_tpu_torch.analysis import framework

REPO_ROOT = Path(__file__).parent.parent


class TestRepoClean:
    def test_repo_has_no_unsuppressed_findings(self):
        result = framework.lint_repo()
        assert not result.findings, "\n" + framework.render_text(result)

    def test_every_suppression_has_a_reason(self):
        result = framework.lint_repo()
        missing = result.missing_reasons()
        assert not missing, (
            "suppressions without `-- <why>`: "
            + ", ".join(f"{p}:{s.line}" for p, s in missing)
        )

    def test_lints_the_port_and_nothing_else(self):
        ctx = framework.build_context(framework.repo_root())
        assert ctx.modules and all(rel.startswith("kmamiz_tpu_torch/") for rel in ctx.modules)
        assert "kmamiz_tpu_torch/server/processor.py" in ctx.modules
        result = framework.run_rules(ctx)
        assert all(f.path.startswith("kmamiz_tpu_torch/") for f in result.suppressed)

    def test_cli_strict_exits_zero(self):
        proc = subprocess.run(
            [sys.executable, "-m", "kmamiz_tpu_torch.tools.graftlint", "--strict"],
            cwd=REPO_ROOT,
            capture_output=True,
            text=True,
            timeout=300,
        )
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "0 finding(s)" in proc.stdout

"""graftlint engine: modules, suppressions, rule registry, reporters.

Counterpart of kmamiz_tpu/analysis/framework.py. Linting is pure ``ast``
work: the CLI and the repo-clean test never import torch (nor initialise
a card) just to read source files. The port has no program registry, so
the context carries no jit-site tables: its ``unregistered-jit`` rule
forbids compiled entry points outright (rules.py).
"""
from __future__ import annotations

import ast
import json
import os
import re
import tokenize
from dataclasses import dataclass, field
from io import StringIO
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Set

# `# graftlint: disable=rule-a,rule-b -- reason` (reason optional unless
# strict mode; `--` separator optional)
_SUPPRESS_RE = re.compile(
    r"#\s*graftlint:\s*disable=(?P<rules>[\w,-]+)(?:\s*(?:--)?\s*(?P<reason>\S.*))?"
)


@dataclass(frozen=True)
class Suppression:
    line: int
    rules: frozenset
    reason: str = ""


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str  # repo-relative, forward slashes
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


class ModuleInfo:
    """One parsed source file: AST, source lines, suppression comments."""

    def __init__(self, rel_path: str, source: str):
        self.rel_path = rel_path.replace(os.sep, "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=rel_path)
        self.suppressions: Dict[int, Suppression] = {}
        for tok in tokenize.generate_tokens(StringIO(source).readline):
            if tok.type != tokenize.COMMENT:
                continue
            m = _SUPPRESS_RE.search(tok.string)
            if not m:
                continue
            rules = frozenset(
                r.strip() for r in m.group("rules").split(",") if r.strip()
            )
            self.suppressions[tok.start[0]] = Suppression(
                line=tok.start[0], rules=rules, reason=(m.group("reason") or "").strip()
            )

    def suppression_for(self, rule: str, line: int) -> Optional[Suppression]:
        """A finding at `line` is suppressed by a disable comment for its
        rule on the same physical line, or on the line directly above
        (comment-above style, for lines formatters keep full)."""
        for ln in (line, line - 1):
            sup = self.suppressions.get(ln)
            if sup and rule in sup.rules:
                return sup
        return None


@dataclass
class LintContext:
    """Everything rules may consult beyond their own module's AST."""

    root: str
    modules: Dict[str, ModuleInfo] = field(default_factory=dict)
    # qualnames ("pkg/mod.py:Class.fn") reachable from the tick/serve
    # entry points; None => hot-path-gated rules treat every fn as hot
    # (fixture mode), computed lazily otherwise
    hot: Optional[Set[str]] = None

    def is_hot(self, qualname: str) -> bool:
        return self.hot is None or qualname in self.hot


@dataclass(frozen=True)
class Rule:
    name: str
    doc: str
    check: Callable[[ModuleInfo, LintContext], List[Finding]]


_RULES: Dict[str, Rule] = {}


def rule(name: str, doc: str):
    """Register a rule checker: fn(module, context) -> [Finding]."""

    def deco(fn):
        _RULES[name] = Rule(name=name, doc=doc, check=fn)
        return fn

    return deco


def all_rules() -> Dict[str, Rule]:
    from kmamiz_tpu_torch.analysis import rules as _  # noqa: F401  (registers)
    from kmamiz_tpu_torch.analysis.concurrency import rules as _c  # noqa: F401

    return dict(_RULES)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

_SKIP_DIRS = {"__pycache__", ".git", "tests", "docs"}


def _iter_py_files(root: str, paths: Optional[Sequence[str]]) -> List[str]:
    if paths:
        out = []
        for p in paths:
            ap = p if os.path.isabs(p) else os.path.join(root, p)
            if os.path.isdir(ap):
                out.extend(_iter_py_files(root, _walk(ap, root)))
            else:
                out.append(os.path.relpath(ap, root))
        return sorted(set(out))
    return _walk(os.path.join(root, "kmamiz_tpu_torch"), root)


def _walk(top: str, root: str) -> List[str]:
    found = []
    for dirpath, dirnames, filenames in os.walk(top):
        dirnames[:] = [d for d in dirnames if d not in _SKIP_DIRS]
        for f in filenames:
            if f.endswith(".py"):
                found.append(os.path.relpath(os.path.join(dirpath, f), root))
    return sorted(found)


def build_context(
    root: str,
    paths: Optional[Sequence[str]] = None,
    *,
    seeds: Optional[Sequence[str]] = None,
    hot_all: bool = False,
) -> LintContext:
    ctx = LintContext(root=root)
    for rel in _iter_py_files(root, paths):
        try:
            with open(os.path.join(root, rel), encoding="utf-8") as fh:
                ctx.modules[rel.replace(os.sep, "/")] = ModuleInfo(rel, fh.read())
        except (SyntaxError, UnicodeDecodeError, OSError):
            continue  # non-parseable files are out of scope, not findings

    from kmamiz_tpu_torch.analysis import callgraph

    if hot_all:
        ctx.hot = None
    else:
        ctx.hot = callgraph.hot_functions(ctx, seeds=seeds)
    return ctx


@dataclass
class LintResult:
    findings: List[Finding]  # unsuppressed
    suppressed: List[Finding]
    suppressions_used: List[tuple]  # (rel_path, Suppression)

    def missing_reasons(self) -> List[tuple]:
        return [(p, s) for p, s in self.suppressions_used if not s.reason]


def run_rules(
    ctx: LintContext, rule_names: Optional[Iterable[str]] = None
) -> LintResult:
    registry = all_rules()
    names = list(rule_names) if rule_names else sorted(registry)
    unknown = [n for n in names if n not in registry]
    if unknown:
        raise ValueError(f"unknown rule(s): {', '.join(unknown)}")
    live: List[Finding] = []
    suppressed: List[Finding] = []
    used: List[tuple] = []
    for rel in sorted(ctx.modules):
        mod = ctx.modules[rel]
        for name in names:
            for f in registry[name].check(mod, ctx):
                sup = mod.suppression_for(f.rule, f.line)
                if sup is not None:
                    suppressed.append(f)
                    used.append((mod.rel_path, sup))
                else:
                    live.append(f)
    live.sort(key=lambda f: (f.path, f.line, f.rule))
    suppressed.sort(key=lambda f: (f.path, f.line, f.rule))
    return LintResult(findings=live, suppressed=suppressed, suppressions_used=used)


def lint_paths(
    root: str,
    paths: Optional[Sequence[str]] = None,
    rules: Optional[Iterable[str]] = None,
    *,
    seeds: Optional[Sequence[str]] = None,
    hot_all: bool = False,
) -> LintResult:
    ctx = build_context(root, paths, seeds=seeds, hot_all=hot_all)
    return run_rules(ctx, rules)


def repo_root() -> str:
    return os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )


def lint_repo(rules: Optional[Iterable[str]] = None) -> LintResult:
    """Lint the kmamiz_tpu_torch package in-repo (what --strict CI runs)."""
    return lint_paths(repo_root(), None, rules)


# ---------------------------------------------------------------------------
# reporters
# ---------------------------------------------------------------------------


def render_text(result: LintResult, *, verbose: bool = False) -> str:
    out = [f.render() for f in result.findings]
    if verbose and result.suppressed:
        out.append("")
        out.extend(f"suppressed: {f.render()}" for f in result.suppressed)
    out.append(
        f"graftlint: {len(result.findings)} finding(s), "
        f"{len(result.suppressed)} suppressed"
    )
    return "\n".join(out)


def render_json(result: LintResult) -> str:
    return json.dumps(
        {
            "findings": [vars(f) for f in result.findings],
            "suppressed": [vars(f) for f in result.suppressed],
            "counts": {
                "findings": len(result.findings),
                "suppressed": len(result.suppressed),
            },
        },
        indent=2,
        sort_keys=True,
    )

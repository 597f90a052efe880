"""graftrace CLI: whole-repo concurrency analysis for kmamiz_tpu_torch.

Counterpart of the repo's tools/graftrace.py, over the port: the same
options, output and exit codes, over ``kmamiz_tpu_torch/``.

    python -m kmamiz_tpu_torch.tools.graftrace            # run the 3
                                              # concurrency rules, exit 0
    python -m kmamiz_tpu_torch.tools.graftrace --strict   # exit 1 on any
                                              # unsuppressed finding or
                                              # reason-less suppression
    python -m kmamiz_tpu_torch.tools.graftrace --locks    # lock inventory
    python -m kmamiz_tpu_torch.tools.graftrace --dot      # acquisition-order
                                              # graph as Graphviz DOT
    python -m kmamiz_tpu_torch.tools.graftrace --json     # machine-readable
    python -m kmamiz_tpu_torch.tools.graftrace kmamiz_tpu_torch/fleet
    python -m kmamiz_tpu_torch.tools.graftrace --list-rules

The rules (lock-order-cycle, blocking-call-under-lock,
inconsistent-guard) also run inside plain graftlint; this front-end adds
the lock-model views and scopes --strict to concurrency only. Suppress a
finding with `# graftlint: disable=<rule> -- <reason>` on (or directly
above) the flagged line. The runtime lock witness (KMAMIZ_LOCK_WITNESS=1,
analysis/concurrency/witness.py) cross-checks this model against
witnessed acquisition orders.
"""
import argparse
import os
import sys

from kmamiz_tpu_torch.analysis import framework
from kmamiz_tpu_torch.analysis.concurrency import locks

CONCURRENCY_RULES = (
    "lock-order-cycle",
    "blocking-call-under-lock",
    "inconsistent-guard",
)


def _render_locks(model: locks.LockModel) -> str:
    lines = []
    for lid in sorted(model.locks):
        site = model.locks[lid]
        extra = ""
        if site.alias_of:
            extra = f"  (guards {model.canon(lid)})"
        elif lid in model.trylock_only:
            extra = "  (try-lock only)"
        lines.append(
            f"{site.kind:<9} {lid:<60} {site.rel_path}:{site.line}{extra}"
        )
    lines.append(
        f"{len(model.locks)} lock site(s), "
        f"{len(model.edges)} order edge(s), "
        f"{len(model.wide_edge_pairs)} wide pair(s)"
    )
    return "\n".join(lines)


def _render_dot(model: locks.LockModel) -> str:
    """Acquisition-order graph: solid = confident blocking edge (cycle
    detection input), dashed = try-lock edge (excluded from cycles)."""
    out = ["digraph graftrace {", "  rankdir=LR;", '  node [shape=box];']
    names = {}
    for i, lid in enumerate(sorted(model.locks)):
        if model.locks[lid].alias_of:
            continue  # conditions render as their underlying lock
        names[lid] = f"n{i}"
        out.append(f'  n{i} [label="{lid}"];')
    seen = set()
    for e in model.edges:
        src, dst = model.canon(e.src), model.canon(e.dst)
        key = (src, dst, e.blocking)
        if src not in names or dst not in names or key in seen:
            continue
        seen.add(key)
        style = "" if e.blocking and dst not in model.trylock_only else (
            ' [style=dashed]'
        )
        out.append(f"  {names[src]} -> {names[dst]}{style};")
    out.append("}")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="graftrace", description=__doc__.splitlines()[0]
    )
    ap.add_argument("paths", nargs="*", help="files/dirs (default: kmamiz_tpu_torch/)")
    ap.add_argument(
        "--strict",
        action="store_true",
        default=os.environ.get("KMAMIZ_LINT_STRICT", "") not in ("", "0"),
        help="exit 1 on unsuppressed findings or reason-less suppressions",
    )
    ap.add_argument("--json", action="store_true", help="JSON report")
    ap.add_argument(
        "--locks", action="store_true", help="print the lock inventory"
    )
    ap.add_argument(
        "--dot", action="store_true", help="acquisition-order graph as DOT"
    )
    ap.add_argument(
        "--rules",
        help=f"comma-separated rule subset (default: {','.join(CONCURRENCY_RULES)})",
    )
    ap.add_argument(
        "--verbose", action="store_true", help="also list suppressed findings"
    )
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        all_rules = framework.all_rules()
        for name in CONCURRENCY_RULES:
            print(f"{name}: {all_rules[name].doc}")
        return 0

    if args.locks or args.dot:
        model = locks.repo_model()
        if args.locks:
            print(_render_locks(model))
        if args.dot:
            print(_render_dot(model))
        return 0

    if args.rules:
        rules = [r.strip() for r in args.rules.split(",")]
        unknown = [r for r in rules if r not in CONCURRENCY_RULES]
        if unknown:
            print(
                f"graftrace: not a concurrency rule: {', '.join(unknown)} "
                f"(choose from {', '.join(CONCURRENCY_RULES)})",
                file=sys.stderr,
            )
            return 2
    else:
        rules = list(CONCURRENCY_RULES)
    try:
        result = framework.lint_paths(
            framework.repo_root(), args.paths or None, rules
        )
    except ValueError as exc:
        print(f"graftrace: {exc}", file=sys.stderr)
        return 2

    if args.json:
        print(framework.render_json(result))
    else:
        print(framework.render_text(result, verbose=args.verbose))

    if not args.strict:
        return 0
    bad = len(result.findings)
    missing = result.missing_reasons()
    if missing:
        for path, sup in missing:
            print(
                f"graftrace: strict: {path}:{sup.line}: suppression "
                "without a reason (add `-- <why>`)",
                file=sys.stderr,
            )
    return 1 if (bad or missing) else 0


if __name__ == "__main__":
    sys.exit(main())

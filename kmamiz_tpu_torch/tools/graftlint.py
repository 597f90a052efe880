"""graftlint CLI: lint the kmamiz_tpu_torch package for hot-path invariant drift.

Counterpart of the repo's tools/graftlint.py, over the port: the same
options, output and exit codes. It lints ``kmamiz_tpu_torch/`` (never the
JAX package) with the port's rules (``--list-rules``).

    python -m kmamiz_tpu_torch.tools.graftlint                 # report, exit 0
    python -m kmamiz_tpu_torch.tools.graftlint --strict        # exit 1 on any
                                              # unsuppressed finding or
                                              # reason-less suppression
    python -m kmamiz_tpu_torch.tools.graftlint --json          # machine-readable
    python -m kmamiz_tpu_torch.tools.graftlint kmamiz_tpu_torch/ops  # a subtree
    python -m kmamiz_tpu_torch.tools.graftlint --list-rules

KMAMIZ_LINT_STRICT=1 makes --strict the default. Suppress a finding in
source with `# graftlint: disable=<rule> -- <reason>` on (or directly
above) the flagged line.
"""
import argparse
import os
import sys

from kmamiz_tpu_torch.analysis import framework


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="graftlint", description=__doc__.splitlines()[0]
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
        "--rules", help="comma-separated rule subset (default: all)"
    )
    ap.add_argument(
        "--verbose", action="store_true", help="also list suppressed findings"
    )
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for name, r in sorted(framework.all_rules().items()):
            print(f"{name}: {r.doc}")
        return 0

    rules = [r.strip() for r in args.rules.split(",")] if args.rules else None
    try:
        result = framework.lint_paths(
            framework.repo_root(), args.paths or None, rules
        )
    except ValueError as exc:
        print(f"graftlint: {exc}", file=sys.stderr)
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
                f"graftlint: strict: {path}:{sup.line}: suppression "
                "without a reason (add `-- <why>`)",
                file=sys.stderr,
            )
    return 1 if (bad or missing) else 0


if __name__ == "__main__":
    sys.exit(main())

"""graftsoak CLI: the thousand-scenario production-replay sweep.

Counterpart of the repo's tools/graftsoak.py, over the port: the same
options, report, last JSON line and exit code, and ``--device`` (default:
the card) for the workers.

Fans (archetype, seed) cells across worker subprocesses, longest
graftcost-predicted cell first, with a resumable on-disk manifest under
--soak-dir / KMAMIZ_SOAK_DIR: kill it anytime, rerun the same command,
and only the unfinished (plus any failed) cells execute. Every failure
keeps its namespaced flight-*.json box and is auto-triaged against the
archetype's last passing flight.

stdout carries ONE JSON line with the sweep report plus the bench keys:

    soak_pass              complete + pass rate >= floor + all triaged
    soak_pass_rate         passing fraction of non-poison cells
    soak_triaged_fraction  failures carrying a triage blame (want 1.0)
    soak_cells_per_min     this run's execution throughput

The human-readable report goes to stderr. Exit 0 iff soak_pass.

    python -m kmamiz_tpu_torch.tools.graftsoak --cells 200          # the 200-cell gate
    python -m kmamiz_tpu_torch.tools.graftsoak --cells 1000 --workers 8
    python -m kmamiz_tpu_torch.tools.graftsoak --cells 24 --poison 1  # triage canary
    python -m kmamiz_tpu_torch.tools.graftsoak --report-only        # re-render report
    python -m kmamiz_tpu_torch.tools.graftsoak --cells 12 --list    # plan, don't run
    python -m kmamiz_tpu_torch.tools.graftsoak --cells 6 --device cpu
"""
from __future__ import annotations

import argparse
import json
import sys

from kmamiz_tpu_torch.soak import (
    SoakManifest,
    build_report,
    plan_sweep,
    run_sweep,
)


def _render(report: dict) -> str:
    lines = [
        f"soak: {report['cells_finished']}/{report['cells_total']} cells "
        f"({report['cells_executed']} executed this run, "
        f"{report['cells_per_min']}/min)  "
        f"pass_rate={report['pass_rate']} (floor {report['pass_floor']})  "
        f"triaged={report['triaged_fraction']}  "
        f"{'PASS' if report['soak_pass'] else 'FAIL'}"
    ]
    for bug in report["bugs"]:
        lines.append(
            f"  bug x{bug['count']}: {bug['signature']}  "
            f"cells={','.join(bug['cells'][:4])}"
        )
    for f in report["failures"][:8]:
        flight = f.get("flight_artifact") or "-"
        lines.append(f"  fail {f['id']}: gates={f['gates_failed']}  {flight}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", type=int, default=100, help="sweep size")
    ap.add_argument("--seed", type=int, default=0, help="first matrix seed")
    ap.add_argument(
        "--workers", type=int, default=None, help="worker subprocesses"
    )
    ap.add_argument("--ticks", type=int, default=None, help="ticks per cell")
    ap.add_argument(
        "--archetypes",
        default=None,
        help="comma-separated archetype subset (default: sweepable set)",
    )
    ap.add_argument(
        "--poison",
        type=int,
        default=0,
        help="seed N canary cells forced to fail (proves triage fires)",
    )
    ap.add_argument(
        "--soak-dir", default=None, help="sweep directory (KMAMIZ_SOAK_DIR)"
    )
    ap.add_argument(
        "--no-rerun-failed",
        action="store_true",
        help="resume without re-executing already-failed cells",
    )
    ap.add_argument(
        "--report-only",
        action="store_true",
        help="aggregate + print the report from existing records",
    )
    ap.add_argument(
        "--list",
        action="store_true",
        help="write/print the cost-ordered plan without running",
    )
    ap.add_argument(
        "--device", default=None, help="the workers' torch device (default: the card)"
    )
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    archetypes = (
        [a.strip() for a in args.archetypes.split(",") if a.strip()]
        if args.archetypes
        else None
    )

    if args.list:
        man = SoakManifest(args.soak_dir)
        doc = plan_sweep(
            man,
            args.cells,
            seed=args.seed,
            archetypes=archetypes,
            ticks=args.ticks,
            poison=args.poison,
        )
        for cell in doc["cells"]:
            print(json.dumps(cell))
        return 0

    if args.report_only:
        report = build_report(SoakManifest(args.soak_dir))
        report.setdefault("cells_executed", 0)
        report.setdefault("cells_per_min", 0.0)
        report.setdefault("wall_s", 0.0)
    else:
        report = run_sweep(
            n_cells=args.cells,
            seed=args.seed,
            workers=args.workers,
            ticks=args.ticks,
            archetypes=archetypes,
            poison=args.poison,
            soak_dir=args.soak_dir,
            rerun_failed=not args.no_rerun_failed,
            verbose=args.verbose,
            device=args.device,
        )

    print(_render(report), file=sys.stderr)
    print(
        json.dumps(
            {
                **report,
                "soak_pass_rate": report["pass_rate"],
                "soak_triaged_fraction": report["triaged_fraction"],
                "soak_cells_per_min": report["cells_per_min"],
            }
        )
    )
    return 0 if report["soak_pass"] else 1


if __name__ == "__main__":
    sys.exit(main())

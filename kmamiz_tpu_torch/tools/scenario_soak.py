"""Scenario soak: run the seeded scenario matrix against a real server.

Counterpart of the repo's tools/scenario_soak.py, over the port: the same
options, headline keys, last JSON line and exit code, and ``--device``
(default: the card). Instantiates the archetype matrix from
kmamiz_tpu_torch/scenarios/ (one integer seed composes every topology,
traffic curve, and failure storyline) and drives each scenario
closed-loop against an in-process DataProcessorServer / TickRouter on the
device, scoring it on its SLO scorecard — p50/p95/p99 tick latency,
stale-serve rate, lost-span count, quarantine exactness,
recovery-time-to-fresh, and a bit-exact reference-graph replay. The
port's cards carry no compile counts (nothing is compiled per shape), so
the table shows none.

stdout carries ONE JSON line with the per-scenario scorecards plus the
bench.py headline keys hoisted to the top level:

    scenario_matrix_pass        every scenario passed all its gates
    scenario_worst_p99_tick_ms  max p99 fresh-tick latency across cards
    scenario_worst_recovery_ms  max recovery-to-fresh across cards
    scenario_lost_spans         total lost spans across cards (must be 0)

The human-readable scorecard table goes to stderr. Exit 0 iff the
matrix passes (always 0 with --list).

    python -m kmamiz_tpu_torch.tools.scenario_soak --seed 0              # full matrix
    python -m kmamiz_tpu_torch.tools.scenario_soak --matrix 3 --ticks 6  # bench subset
    python -m kmamiz_tpu_torch.tools.scenario_soak --scenario kill9-wal-replay
    python -m kmamiz_tpu_torch.tools.scenario_soak --list                # compose only
    python -m kmamiz_tpu_torch.tools.scenario_soak --counterfactual      # graftpilot gate

With --counterfactual the seeded cascade scenario runs twice — control
plane OFF then ON — and the JSON line carries the graftpilot gate keys
instead (``control_counterfactual_prevented``, ``counterfactual_pass``).
"""
from __future__ import annotations

import argparse
import json
import sys

from kmamiz_tpu_torch.scenarios import (
    ARCHETYPES,
    run_counterfactual,
    run_matrix,
    scenario_matrix,
    spec_signature,
)


def headline(cards) -> dict:
    """The always-gated bench keys, hoisted from the scorecards."""
    return {
        "scenario_matrix_pass": bool(cards) and all(c["pass"] for c in cards),
        "scenario_worst_p99_tick_ms": max(
            (c["p99_tick_ms"] for c in cards), default=0.0
        ),
        "scenario_worst_recovery_ms": max(
            (c["recovery_ms"] for c in cards), default=0.0
        ),
        "scenario_lost_spans": sum(c["lost_spans"] for c in cards),
    }


def _table(cards) -> str:
    width = max((len(c["name"]) for c in cards), default=4)
    lines = []
    for c in cards:
        state = "PASS" if c["pass"] else "FAIL"
        fails = [k for k, v in c["gates"].items() if not v]
        lines.append(
            f"{c['name']:<{width}}  {state}  "
            f"p99={c['p99_tick_ms']}ms stale={c['stale_serves']} "
            f"lost={c['lost_spans']} "
            f"q={c['quarantined']}/{c['expected_poisons']} "
            f"recovery={c['recovery_ms']}ms "
            f"wall={c['wall_s']}s{'  ' + str(fails) if fails else ''}"
        )
        if c.get("flight_artifact"):
            # the frozen graftprof evidence for this failure
            # (python -m kmamiz_tpu_torch.tools.graftprof <path> renders it)
            lines.append(f"{'':<{width}}  flight: {c['flight_artifact']}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=None, help="matrix seed")
    ap.add_argument(
        "--matrix", type=int, default=None, help="number of scenarios"
    )
    ap.add_argument("--ticks", type=int, default=None, help="ticks per soak")
    ap.add_argument(
        "--scenario",
        default=None,
        metavar="ARCHETYPE",
        help="run only matrix entries of this archetype "
        f"({', '.join(name for name, _ in ARCHETYPES)})",
    )
    ap.add_argument(
        "--list",
        action="store_true",
        help="compose the matrix and print specs without running",
    )
    ap.add_argument(
        "--check",
        action="store_true",
        help="exit nonzero unless every scenario passes its scorecard "
        "(the default; kept explicit for gate invocations)",
    )
    ap.add_argument(
        "--counterfactual",
        action="store_true",
        help="run the graftpilot counterfactual gate (cascade scenario "
        "with the control plane OFF vs ON) instead of the matrix",
    )
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    if args.counterfactual:
        card = run_counterfactual(
            seed=args.seed if args.seed is not None else 0,
            n_ticks=args.ticks if args.ticks is not None else 10,
            verbose=True,
            device=args.device,
        )
        fails = [k for k, v in card["gates"].items() if not v]
        print(
            f"{card['name']}  {'PASS' if card['pass'] else 'FAIL'}  "
            f"prevented={card['slo_violations_prevented']} "
            f"off_violations={card['off']['violations']} "
            f"on_deferred={card['on']['deferred']} "
            f"lost={card['off']['lost_spans']}+{card['on']['lost_spans']} "
            f"wall={card['wall_s']}s"
            f"{'  ' + str(fails) if fails else ''}",
            file=sys.stderr,
        )
        print(
            json.dumps(
                {
                    "counterfactual": card,
                    "control_counterfactual_prevented": card[
                        "slo_violations_prevented"
                    ],
                    "counterfactual_pass": card["pass"],
                }
            )
        )
        return 0 if card["pass"] else 1

    specs = scenario_matrix(args.seed, args.matrix, args.ticks)
    if args.scenario is not None:
        known = {name for name, _ in ARCHETYPES}
        if args.scenario not in known:
            ap.error(f"unknown archetype {args.scenario!r}")
        specs = tuple(s for s in specs if s.archetype == args.scenario)
        if not specs:
            # the archetype exists but the matrix slice missed it: run
            # one instance at its canonical matrix index
            index = next(
                i
                for i, (name, _) in enumerate(ARCHETYPES)
                if name == args.scenario
            )
            specs = (scenario_matrix(args.seed, index + 1, args.ticks)[index],)

    if args.list:
        for spec in specs:
            doc = {
                "name": spec.name,
                "archetype": spec.archetype,
                "n_ticks": spec.n_ticks,
                "tenants": [p.tenant for p in spec.tenants],
                "events": [
                    {"tenant": t, "event": ev.key()}
                    for t, ev in spec.events()
                ],
                "spec_signature": spec_signature(spec),
            }
            print(json.dumps(doc))
        return 0

    cards = run_matrix(specs, device=args.device)
    results = {"scenarios": cards, **headline(cards)}

    print(_table(cards), file=sys.stderr)
    print(json.dumps(results))
    return 0 if results["scenario_matrix_pass"] else 1


if __name__ == "__main__":
    sys.exit(main())

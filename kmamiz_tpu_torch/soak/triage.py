"""Auto-triage: attribute every failed sweep cell to a blamed
phase / tenant / gate, then dedupe failures into bugs.

Counterpart of kmamiz_tpu/soak/triage.py. ``GATE_PHASE`` has no
``zero_steady_recompiles`` entry: no card of the port carries that gate
(it counts XLA compiles, and nothing is compiled per shape here). Like
the JAX table, it has no entry for the lock-witness gates
(``lock_witness_acyclic``, ``lock_witness_covered``) either: a failed one
blames the phase ``unknown``.

On any gate failure the scenario runner freezes a ``flight-*.json``
evidence box; the sweep keeps the LAST PASSING flight profile per
archetype as a baseline. Triage bisects the two with the graftprof
per-phase p95 diff (``telemetry/profiling/report.diff`` — the same
thresholds ``python -m kmamiz_tpu_torch.tools.graftprof --diff`` gates
on) and combines three
deterministic attributions into one record:

* **blamed gate** — the first failed gate, sorted (stable across runs)
* **blamed phase** — the gate's owning pipeline phase (static map),
  with any diff-regressed phases attached as supporting evidence
* **blamed tenant** — the tenant whose live signature diverged from
  the reference (bit-exactness failures), else the tenant named by the
  first error line, else the cell's only tenant

The *triage signature* ``archetype|gate|phase|tenant`` is built purely
from those deterministic parts — two cells failing the same way carry
the same signature, so the soak report can say "1 bug, N occurrences"
instead of listing N raw failures (same spirit as crash-bucket dedupe
in a crash reporter).
"""
from __future__ import annotations

from typing import Dict, List, Optional

#: gate -> owning pipeline phase (the place an operator starts reading)
GATE_PHASE: Dict[str, str] = {
    "no_errors": "drive",
    "bit_exact": "merge",
    "zero_lost_spans": "ingest",
    "bucket_crossed": "capacity",
    "stale_bounded": "serve",
    "quarantine_exact": "quarantine",
    "recovered_to_fresh": "recovery",
    "wal_replayed": "wal-replay",
    "replayed_all": "wal-replay",
    "freshness_slo": "freshness",
    "crashed": "compose",
    "soak_poison": "poison",
}


def failed_gates(card: dict) -> List[str]:
    return sorted(g for g, ok in card.get("gates", {}).items() if not ok)


def blamed_tenant(card: dict) -> str:
    """Deterministic tenant attribution from the scorecard alone."""
    live = card.get("signatures") or {}
    ref = card.get("ref_signatures") or {}
    diverged = sorted(t for t in live if t in ref and live[t] != ref[t])
    if diverged:
        return diverged[0]
    tenants = card.get("tenants") or []
    for err in card.get("errors") or []:
        for tenant in sorted(tenants):
            if tenant in str(err):
                return tenant
    if len(tenants) == 1:
        return tenants[0]
    return "matrix"


def _regressed_phases(
    baseline: Optional[dict], flight: Optional[dict]
) -> List[dict]:
    """graftprof bisection: per-phase p95 regressions of the failing
    cell's flight against the archetype's last passing flight. Best
    effort — missing or unparseable artifacts yield no evidence, never
    an exception (triage runs on the failure path)."""
    if not baseline or not flight:
        return []
    try:
        from kmamiz_tpu_torch.telemetry.profiling import report

        return report.diff(report.from_any(baseline), report.from_any(flight))
    except Exception:  # noqa: BLE001 - evidence is optional, blame is not
        return []


def triage_card(
    card: dict,
    baseline: Optional[dict] = None,
    flight: Optional[dict] = None,
) -> dict:
    """The triage record for one failed cell. Always attributes —
    a missing baseline or flight degrades the evidence, not the blame."""
    gates = failed_gates(card)
    gate = gates[0] if gates else "unknown"
    phase = GATE_PHASE.get(gate, "unknown")
    tenant = blamed_tenant(card)
    regressions = _regressed_phases(baseline, flight)
    record = {
        "blamed_gate": gate,
        "blamed_phase": phase,
        "blamed_tenant": tenant,
        "failed_gates": gates,
        "signature": f"{card.get('archetype', '?')}|{gate}|{phase}|{tenant}",
        "baseline": bool(baseline),
        "regressed_phases": [
            {
                "phase": r["phase"],
                "baseline_p95_ms": r["baseline_p95_ms"],
                "candidate_p95_ms": r["candidate_p95_ms"],
            }
            for r in regressions[:4]
        ],
    }
    return record


def dedupe(failures: List[dict]) -> List[dict]:
    """Group failed cell records by triage signature: same blame = one
    bug, N occurrences. Input records carry ``triage`` + ``id``."""
    bugs: Dict[str, dict] = {}
    for rec in failures:
        tri = rec.get("triage") or {}
        sig = tri.get("signature", "untriaged")
        bug = bugs.setdefault(
            sig,
            {
                "signature": sig,
                "blamed_gate": tri.get("blamed_gate", "unknown"),
                "blamed_phase": tri.get("blamed_phase", "unknown"),
                "blamed_tenant": tri.get("blamed_tenant", "unknown"),
                "count": 0,
                "cells": [],
            },
        )
        bug["count"] += 1
        bug["cells"].append(rec.get("id", rec.get("name", "?")))
    out = sorted(bugs.values(), key=lambda b: (-b["count"], b["signature"]))
    for bug in out:
        bug["cells"] = sorted(bug["cells"])[:8]
    return out

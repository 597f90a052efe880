"""Sweep engine: plan, fan out worker subprocesses, aggregate, triage.

Counterpart of kmamiz_tpu/soak/engine.py. The JAX package's
KMAMIZ_SOAK_WORKERS and KMAMIZ_SOAK_PASS_FLOOR are `DEFAULT_WORKERS`
(``min(4, cores)``, which `run_sweep`'s ``workers=`` overrides) and
`DEFAULT_PASS_FLOOR` here; KMAMIZ_SOAK_DIR still names the default
sweep directory. The workers run on ``device``
(default: the card), each in a process of its own (its own CUDA context
on the card); the engine's own process only plans and aggregates.

``run_sweep`` is the whole lifecycle of one soak sweep:

1. **Plan** — enumerate ``(archetype, seed)`` cells, price each with
   the graftcost scenario plane (corrected by any observed walls
   already in the sweep dir), order longest-first, and write the
   manifest atomically. A matching manifest already on disk is REUSED
   verbatim, so resuming a killed sweep keeps the original plan.
2. **Resume bookkeeping** — stale claims (in-flight cells of a killed
   run) are released; failed results are dropped for re-execution when
   ``rerun_failed`` (the default: reruns are incremental, only
   new/failed cells execute).
3. **Fan out** — N worker subprocesses (``kmamiz_tpu_torch.soak.worker``)
   claim cells from the shared manifest until none remain. A worker
   that dies mid-cell only orphans its claim; the engine clears it and
   respawns (bounded rounds), so the sweep converges even through
   worker loss.
4. **Aggregate** — per-cell records roll up into the soak report:
   pass rate over non-poison cells, triaged fraction over ALL
   failures, and the deduped bug list (same triage signature = one
   bug, N occurrences).
"""
from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
from typing import List, Optional, Sequence

from kmamiz_tpu_torch.device import DeviceLike, resolve_device
from kmamiz_tpu_torch.soak import cells as cells_mod
from kmamiz_tpu_torch.soak import triage as triage_mod
from kmamiz_tpu_torch.soak.manifest import SoakManifest

_SWEEPS_LOCK = threading.Lock()
_SWEEPS: List[dict] = []

DEFAULT_CELLS = 100
#: worker subprocesses of a sweep that names no count
DEFAULT_WORKERS = min(4, max(1, os.cpu_count() or 1))
#: acceptance floor: four nines of non-poison cells pass
DEFAULT_PASS_FLOOR = 0.9999
_SPAWN_ROUNDS = 3


def _poison_ids(cells: List[dict], n_poison: int) -> List[str]:
    """Deterministic poison pick: the lexically-first ``n_poison`` cell
    ids — stable across plans, resumes, and cost reorderings."""
    return sorted(c["id"] for c in cells)[: max(0, n_poison)]


def plan_sweep(
    man: SoakManifest,
    n_cells: int,
    seed: int = 0,
    archetypes: Optional[Sequence[str]] = None,
    ticks: Optional[int] = None,
    poison: int = 0,
) -> dict:
    """Write (or reuse) the sweep manifest. An existing manifest with
    the same cell set, ticks, and poison pick is kept verbatim — the
    resume contract."""
    observed = cells_mod.observed_ratios(man.load_results())
    cells = cells_mod.enumerate_cells(
        n_cells, seed0=seed, archetypes=archetypes, ticks=ticks,
        observed=observed,
    )
    poison_ids = set(_poison_ids(cells, poison))
    for cell in cells:
        if cell["id"] in poison_ids:
            cell["poison"] = True
    existing = man.load()
    if existing is not None:
        same_cells = {
            (c["id"], c["ticks"], bool(c.get("poison")))
            for c in existing.get("cells", [])
        } == {(c["id"], c["ticks"], bool(c.get("poison"))) for c in cells}
        if same_cells:
            return existing
    doc = {
        "seed": seed,
        "n_cells": n_cells,
        "poison": sorted(poison_ids),
        "cells": cells,
        "created_unix": int(time.time()),
    }
    man.write(doc)
    return man.load()


def _spawn_workers(man: SoakManifest, n: int, run_id: str, verbose: bool, device: str):
    repo_root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    env = {**os.environ, "KMAMIZ_PROF_FLIGHT_DIR": man.flights_dir}
    cmd = [
        sys.executable, "-m", "kmamiz_tpu_torch.soak.worker",
        "--dir", man.root, "--device", device, "--run-id", run_id,
    ]
    if verbose:
        cmd.append("--verbose")
    return [
        subprocess.Popen(cmd, env=env, cwd=repo_root, stdout=sys.stderr)
        for _ in range(n)
    ]


def build_report(man: SoakManifest, pass_floor: Optional[float] = None) -> dict:
    """Roll the per-cell records up into the soak report, gated on
    ``pass_floor`` (None: `DEFAULT_PASS_FLOOR`). Every field that feeds
    the gate (pass rate, triage, bugs, per-cell verdicts) is
    deterministic for a deterministic cell set — resuming a killed
    sweep reproduces it bit-identically."""
    doc = man.load() or {"cells": []}
    results = man.load_results()
    cells = doc.get("cells", [])
    finished = [results[c["id"]] for c in cells if c["id"] in results]
    nonpoison = [r for r in finished if not r.get("poison")]
    passed = [r for r in nonpoison if r.get("pass")]
    failures = [r for r in finished if not r.get("pass")]
    real_failures = [r for r in failures if not r.get("poison")]
    triaged = [
        r for r in failures if (r.get("triage") or {}).get("signature")
    ]
    pass_rate = (
        round(len(passed) / len(nonpoison), 6) if nonpoison else 0.0
    )
    triaged_fraction = (
        round(len(triaged) / len(failures), 6) if failures else 1.0
    )
    complete = len(finished) == len(cells) and bool(cells)
    floor = DEFAULT_PASS_FLOOR if pass_floor is None else pass_floor
    return {
        "cells_total": len(cells),
        "cells_finished": len(finished),
        "cells_passed": len(passed),
        "cells_failed": len(failures),
        "real_failures": len(real_failures),
        "poison_cells": sorted(doc.get("poison", [])),
        "pass_rate": pass_rate,
        "pass_floor": floor,
        "triaged_fraction": triaged_fraction,
        "bugs": triage_mod.dedupe(failures),
        "failures": [
            {
                "id": r["id"],
                "gates_failed": r.get("gates_failed", []),
                "triage": r.get("triage"),
                "flight_artifact": r.get("flight_artifact"),
            }
            for r in sorted(failures, key=lambda r: r["id"])[:32]
        ],
        "complete": complete,
        "soak_pass": complete
        and pass_rate >= floor
        and triaged_fraction >= 1.0,
        "cells": [
            {
                "id": r["id"],
                "pass": bool(r.get("pass")),
                "gates_failed": r.get("gates_failed", []),
                "triage_signature": (r.get("triage") or {}).get("signature"),
            }
            for r in sorted(finished, key=lambda r: r["id"])
        ],
    }


def run_sweep(
    n_cells: int = DEFAULT_CELLS,
    seed: int = 0,
    workers: Optional[int] = None,
    ticks: Optional[int] = None,
    archetypes: Optional[Sequence[str]] = None,
    poison: int = 0,
    soak_dir: Optional[str] = None,
    rerun_failed: bool = True,
    verbose: bool = False,
    device: DeviceLike = None,
) -> dict:
    """The full sweep lifecycle, its workers on ``device`` (None: the
    card, raising without one); returns the soak report plus this run's
    execution stats (cells executed, wall, cells/min)."""
    dev = str(resolve_device(device))
    man = SoakManifest(soak_dir)
    plan_sweep(
        man, n_cells, seed=seed, archetypes=archetypes, ticks=ticks,
        poison=poison,
    )
    man.clear_stale_claims()
    if rerun_failed:
        man.pending_cells(rerun_failed=True)  # drops failed records+claims
    run_id = f"run-{os.getpid()}-{int(time.time() * 1000)}"
    t0 = time.time()
    n_workers = DEFAULT_WORKERS if workers is None else max(1, workers)
    rounds = 0
    while man.pending_cells(rerun_failed=False) and rounds < _SPAWN_ROUNDS:
        rounds += 1
        procs = _spawn_workers(man, n_workers, run_id, verbose, dev)
        for p in procs:
            p.wait()
        # a worker that died mid-cell left a claim with no result;
        # clear it so the next round picks the cell up
        if man.clear_stale_claims() and verbose:
            print("[soak] cleared stale claims, respawning", file=sys.stderr)
    wall_s = time.time() - t0
    report = build_report(man)
    executed = [
        r
        for r in man.load_results().values()
        if r.get("run_id") == run_id
    ]
    report["soak_dir"] = man.root
    report["run_id"] = run_id
    report["cells_executed"] = len(executed)
    report["wall_s"] = round(wall_s, 1)
    report["cells_per_min"] = (
        round(len(executed) / wall_s * 60.0, 2) if wall_s > 0 else 0.0
    )
    with _SWEEPS_LOCK:
        _SWEEPS.append(report)
    return report


def recorded_sweeps() -> List[dict]:
    with _SWEEPS_LOCK:
        return list(_SWEEPS)


def reset_for_tests() -> None:
    with _SWEEPS_LOCK:
        _SWEEPS.clear()

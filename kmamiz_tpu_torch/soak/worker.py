"""Sweep worker subprocess: claim cells, run scenarios, record results.

Counterpart of kmamiz_tpu/soak/worker.py.
``python -m kmamiz_tpu_torch.soak.worker --dir <sweep> --device <d>
--run-id <id>`` loops over the manifest's pending cells IN MANIFEST
ORDER (the engine wrote them longest-predicted-first), claims the first
unowned one atomically, runs it on ``--device`` (default: the card)
inside its own temp sandbox, and writes the cell's result record
atomically, stamped with ``--run-id`` (the JAX worker reads that from
KMAMIZ_SOAK_RUN_ID). Per cell:

* a compose or run exception becomes a ``crashed``-gate card: the cell
  fails, carries a triage blame and never passes. One bad cell never
  takes the worker, let alone the sweep; a sweep with such a cell falls
  below its pass floor;
* a PASSING cell refreshes ``baselines/<archetype>.json`` — the "last
  passing flight" the auto-triage bisects failures against;
* a FAILING cell keeps its namespaced ``flight-*.json`` evidence box
  and gets a triage record (blamed gate/phase/tenant + signature)
  bisected against the archetype baseline;
* a cell marked ``poison`` in the manifest is forced to fail after
  running — the sweep's own canary that failure evidence, triage, and
  dedupe actually fire.

The worker exits 0 when a full scan finds nothing left to claim.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import Optional

from kmamiz_tpu_torch.device import DeviceLike
from kmamiz_tpu_torch.soak import triage as triage_mod
from kmamiz_tpu_torch.soak.manifest import SoakManifest, read_json, write_json_atomic
from kmamiz_tpu_torch.telemetry.profiling import events as prof_events


def _flight_namespace(cell: dict) -> str:
    return f"{cell['archetype']}-{cell['seed']}"


def run_cell(
    man: SoakManifest,
    cell: dict,
    verbose: bool = False,
    device: DeviceLike = None,
    run_id: Optional[str] = None,
) -> dict:
    """Run one claimed cell end to end on ``device`` (None: the card) and
    write its result record, stamped with ``run_id``."""
    from kmamiz_tpu_torch.scenarios import factory, runner
    from kmamiz_tpu_torch.telemetry.profiling import recorder

    t0 = prof_events.now_ms()
    spec = None
    try:
        spec = factory.build_scenario(
            cell["archetype"], cell["seed"], cell["index"], cell["ticks"]
        )
        with tempfile.TemporaryDirectory(prefix="kmamiz-cell-") as tmp:
            card = runner.run_scenario(spec, tmpdir=tmp, device=device)
    except Exception as exc:  # noqa: BLE001 - the sweep's contract: a failed, triaged cell
        card = runner.crashed_card(
            spec, exc, archetype=cell["archetype"],
            wall_s=(prof_events.now_ms() - t0) / 1000,
        )

    if cell.get("poison") and card.get("pass"):
        # seeded canary: force the failure path so the sweep proves its
        # own evidence + triage machinery end to end
        card = dict(card)
        card["gates"] = {**card.get("gates", {}), "soak_poison": False}
        card["pass"] = False
        if not card.get("flight_artifact"):
            card["flight_artifact"] = recorder.record(
                f"scenario-{card.get('name', cell['id'])}",
                "soak_poison",
                force=True,
                namespace=_flight_namespace(cell),
            )

    tri = None
    if card.get("pass"):
        # refresh the archetype's last-passing-flight baseline (atomic
        # replace; concurrent workers race benignly — last writer wins)
        write_json_atomic(
            man.baseline_path(cell["archetype"]),
            recorder.build_artifact(
                f"soak-baseline-{cell['id']}", "last passing cell"
            ),
        )
    else:
        baseline = read_json(man.baseline_path(cell["archetype"]))
        flight = (
            read_json(card["flight_artifact"])
            if card.get("flight_artifact")
            else None
        )
        tri = triage_mod.triage_card(card, baseline, flight)

    record = {
        "id": cell["id"],
        "archetype": cell["archetype"],
        "seed": cell["seed"],
        "index": cell["index"],
        "ticks": cell["ticks"],
        "predicted_s": cell.get("predicted_s"),
        "poison": bool(cell.get("poison")),
        "spec_signature": card.get("spec_signature"),
        "pass": bool(card.get("pass")),
        "gates_failed": triage_mod.failed_gates(card),
        "p99_tick_ms": card.get("p99_tick_ms", 0.0),
        "lost_spans": card.get("lost_spans", 0),
        "errors": (card.get("errors") or [])[:2],
        "flight_artifact": card.get("flight_artifact"),
        "triage": tri,
        "wall_s": round((prof_events.now_ms() - t0) / 1000, 2),
        "worker_pid": os.getpid(),
        "run_id": run_id,
        "finished_unix": int(prof_events.wall_ms() / 1000),
    }
    man.record_result(cell["id"], record)
    if verbose:
        state = "PASS" if record["pass"] else "FAIL"
        blame = f"  blame={tri['signature']}" if tri else ""
        print(
            f"[soak-worker {os.getpid()}] {cell['id']} {state} "
            f"wall={record['wall_s']}s{blame}",
            file=sys.stderr,
        )
    return record


def work_loop(
    root: str,
    verbose: bool = False,
    device: DeviceLike = None,
    run_id: Optional[str] = None,
) -> int:
    """Claim and run pending cells of the sweep under ``root`` until none
    is left; 2 when ``root`` holds no manifest."""
    man = SoakManifest(root)
    if man.load() is None:
        print(f"no manifest under {root}", file=sys.stderr)
        return 2
    # per-cell evidence lands inside the sweep dir; namespaced names
    # keep cells from evicting each other's boxes
    os.environ["KMAMIZ_PROF_FLIGHT_DIR"] = man.flights_dir
    ran = 0
    while True:
        claimed = None
        for cell in man.pending_cells(rerun_failed=False):
            if man.claim(cell["id"]):
                claimed = cell
                break
        if claimed is None:
            break
        run_cell(man, claimed, verbose=verbose, device=device, run_id=run_id)
        ran += 1
    if verbose:
        print(f"[soak-worker {os.getpid()}] done: {ran} cells", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", required=True, help="sweep directory")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--run-id", default=None, help="the sweep run that spawned this worker")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    from kmamiz_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    return work_loop(args.dir, verbose=args.verbose, device=device, run_id=args.run_id)


if __name__ == "__main__":
    sys.exit(main())

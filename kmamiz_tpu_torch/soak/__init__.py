"""graftsoak: thousand-scenario production-replay soak at four nines.

Counterpart of kmamiz_tpu/soak/. Three pillars over the scenario factory
and runner:

* **Sweep engine** (:mod:`.engine`, :mod:`.manifest`, :mod:`.cells`,
  :mod:`.worker`, driven by ``python -m kmamiz_tpu_torch.tools.graftsoak``)
  — worker subprocesses on the card fanning ``(archetype, seed)`` cells,
  ordered by the graftcost scenario plane's predicted cost (longest
  first), with a resumable on-disk manifest of atomic per-cell result
  records under the sweep directory (``KMAMIZ_SOAK_DIR``). The manifest's
  format is the JAX package's.
* **WAL-replay scenario source** (:mod:`.walreplay`, recorded by
  ``python -m kmamiz_tpu_torch.soak.capture``) — a recorded WAL v2
  window replayed through a live server as archetype 11
  (``wal-replay``), held bit-exact to a reference built from the same
  records.
* **Auto-triage** (:mod:`.triage`) — every failing cell's flight box
  bisected against the archetype's last passing flight, blamed
  phase/tenant/gate emitted into the cell record, failures deduped by
  triage signature in the soak report.
"""
from kmamiz_tpu_torch.soak.cells import (
    COLD_PROCESS,
    SUBPROCESS_HEAVY,
    enumerate_cells,
    sweep_archetypes,
    sweep_ticks,
)
from kmamiz_tpu_torch.soak.engine import (
    build_report,
    plan_sweep,
    recorded_sweeps,
    run_sweep,
)
from kmamiz_tpu_torch.soak.manifest import SoakManifest, default_soak_dir
from kmamiz_tpu_torch.soak.triage import dedupe, triage_card
from kmamiz_tpu_torch.soak.walreplay import (
    load_bundle_records,
    read_bundle_meta,
    run_wal_replay_scenario,
    synthesize_bundle,
)

__all__ = [
    "COLD_PROCESS",
    "SUBPROCESS_HEAVY",
    "SoakManifest",
    "build_report",
    "dedupe",
    "default_soak_dir",
    "enumerate_cells",
    "load_bundle_records",
    "plan_sweep",
    "read_bundle_meta",
    "recorded_sweeps",
    "reset_for_tests",
    "run_sweep",
    "run_wal_replay_scenario",
    "sweep_archetypes",
    "sweep_ticks",
    "synthesize_bundle",
    "triage_card",
]


def reset_for_tests() -> None:
    """Clear soak-global state (the completed-sweep registry)."""
    from kmamiz_tpu_torch.soak import engine

    engine.reset_for_tests()

"""Sweep cell enumeration: (archetype, seed) grid, cost-ordered.

Counterpart of kmamiz_tpu/soak/cells.py: the same cells, ids, seeds,
indices and predicted costs, in the same order. The JAX package's
KMAMIZ_SOAK_TICKS and KMAMIZ_SOAK_ARCHETYPES are `DEFAULT_SWEEP_TICKS`
and the default vocabulary here, and the validated ``ticks=`` and
``archetypes=`` arguments of `enumerate_cells`.

A *cell* is one scenario the sweep will run: an archetype name plus a
matrix seed. Cell identity is ``<archetype>-s<seed>`` and each cell
composes its spec at the archetype's CANONICAL matrix index — the same
``build_scenario(archetype, seed, index, ticks)`` call no matter how
large the sweep is, so a cell re-run in isolation reproduces the sweep
cell bit-exactly (``spec_signature`` is the oracle).

Two archetype groups are opt-in for sweeps (name them in
``archetypes=``):

* ``SUBPROCESS_HEAVY`` — archetypes that fork whole interpreter trees
  per cell (kill-9 crash children, the 4-worker fleet ring): at
  thousands of cells they would multiply process spawns without adding
  coverage the nightly matrix gate doesn't already have.
* ``COLD_PROCESS`` — ``capacity-growth-chain``, whose verdict the JAX
  package can hold only in a cold interpreter (its prewarm predictor
  fits on the compiles its own warmup makes). The port compiles nothing
  per shape, but keeps the vocabulary, so that one plan is one plan in
  both packages. The nightly matrix (one cold process) still gates it.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from kmamiz_tpu_torch.cost.scenario import fit_observed, predicted_scenario_cost_s
from kmamiz_tpu_torch.scenarios.factory import ARCHETYPES, build_scenario

#: subprocess-per-cell archetypes, excluded from sweeps by default
SUBPROCESS_HEAVY = ("kill9-wal-replay", "fleet-migration")

#: archetypes the JAX package can gate only in a cold interpreter (see
#: module docstring), excluded from sweeps by default
COLD_PROCESS = ("capacity-growth-chain",)

#: ticks per cell unless a sweep names another count
DEFAULT_SWEEP_TICKS = 6


def sweep_ticks(ticks: Optional[int] = None) -> int:
    """Ticks per cell: ``ticks``, else `DEFAULT_SWEEP_TICKS`. Raises
    ValueError for a count below 1."""
    if ticks is None:
        return DEFAULT_SWEEP_TICKS
    if int(ticks) < 1:
        raise ValueError(f"ticks per cell must be at least 1, not {ticks!r}")
    return int(ticks)


def sweep_archetypes(archetypes: Optional[Sequence[str]] = None) -> List[str]:
    """The archetype vocabulary a sweep cycles through: ``archetypes``
    (validated against the factory's), else every archetype outside
    SUBPROCESS_HEAVY and COLD_PROCESS."""
    known = [name for name, _t in ARCHETYPES]
    if archetypes:
        picked = list(archetypes)
        bad = [a for a in picked if a not in known]
        if bad:
            raise ValueError(f"unknown archetype(s): {bad}")
        return picked
    excluded = set(SUBPROCESS_HEAVY) | set(COLD_PROCESS)
    return [a for a in known if a not in excluded]


def archetype_index(archetype: str) -> int:
    """The archetype's canonical matrix index (its ARCHETYPES slot)."""
    for i, (name, _t) in enumerate(ARCHETYPES):
        if name == archetype:
            return i
    raise ValueError(f"unknown archetype: {archetype!r}")


def cell_id(archetype: str, seed: int) -> str:
    return f"{archetype}-s{seed}"


def enumerate_cells(
    n_cells: int,
    seed0: int = 0,
    archetypes: Optional[Sequence[str]] = None,
    ticks: Optional[int] = None,
    observed: Optional[Dict[str, float]] = None,
) -> List[dict]:
    """The sweep plan: ``n_cells`` cells cycling the archetype
    vocabulary across ascending seeds, each priced by the graftcost
    scenario plane and sorted longest-first (LPT — the expensive tail
    starts immediately instead of straggling last)."""
    archs = sweep_archetypes(archetypes)
    ticks = sweep_ticks(ticks)
    cells = []
    for i in range(n_cells):
        archetype = archs[i % len(archs)]
        seed = seed0 + i // len(archs)
        spec = build_scenario(archetype, seed, archetype_index(archetype), ticks)
        cells.append(
            {
                "id": cell_id(archetype, seed),
                "archetype": archetype,
                "seed": seed,
                "index": archetype_index(archetype),
                "ticks": ticks,
                "predicted_s": predicted_scenario_cost_s(spec, observed),
            }
        )
    cells.sort(key=lambda c: (-c["predicted_s"], c["id"]))
    return cells


def observed_ratios(results: Dict[str, dict]) -> Dict[str, float]:
    """Per-archetype cost corrections from a prior (partial) sweep's
    finished records — resumed and repeated sweeps order by what cells
    actually cost last time."""
    return fit_observed(results.values())

"""Seeded scenario factory (counterpart of kmamiz_tpu/scenarios/).

Compose: :func:`scenario_matrix` samples topologies, traffic curves and
failure storylines from one integer seed; everything random happens at
compose time, and :func:`spec_signature` is the determinism oracle (equal
to the JAX package's for one seed). :func:`labeled_windows` exports a
scenario's windows as labeled model data. The closed-loop runner
(`run_scenario`, `run_matrix`, `run_counterfactual`) waits for the port's
fleet and soak harnesses.
"""
from kmamiz_tpu_torch.scenarios.factory import (
    ARCHETYPES,
    ScenarioSpec,
    TenantPlan,
    build_scenario,
    scenario_matrix,
    spec_signature,
)
from kmamiz_tpu_torch.scenarios.labeled import labeled_windows
from kmamiz_tpu_torch.scenarios.storyline import STORYLINE_KINDS, Event, enabled_storylines
from kmamiz_tpu_torch.scenarios.topology import TOPOLOGY_KINDS, Topology
from kmamiz_tpu_torch.scenarios.traffic import TRAFFIC_KINDS

__all__ = [
    "ARCHETYPES",
    "Event",
    "ScenarioSpec",
    "STORYLINE_KINDS",
    "TOPOLOGY_KINDS",
    "TRAFFIC_KINDS",
    "TenantPlan",
    "Topology",
    "build_scenario",
    "enabled_storylines",
    "labeled_windows",
    "scenario_matrix",
    "spec_signature",
]

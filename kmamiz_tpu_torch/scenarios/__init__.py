"""Seeded scenario factory and closed-loop soak runner (counterpart of
kmamiz_tpu/scenarios/).

Compose: :func:`scenario_matrix` samples topologies, traffic curves and
failure storylines from one integer seed; everything random happens at
compose time, and :func:`spec_signature` is the determinism oracle (equal
to the JAX package's for one seed). :func:`labeled_windows` exports a
scenario's windows as labeled model data. Run: :func:`run_scenario` drives
a spec against a real in-process ``DataProcessorServer`` on the card (or
the device it is given) and scores it against its gates;
:func:`run_matrix` runs many, :func:`run_counterfactual` the control
plane's OFF/ON gate.
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
from kmamiz_tpu_torch.scenarios.runner import (
    crashed_card,
    recorded_runs,
    run_counterfactual,
    run_matrix,
    run_scenario,
)
from kmamiz_tpu_torch.scenarios.storyline import STORYLINE_KINDS, Event, enabled_storylines
from kmamiz_tpu_torch.scenarios.topology import TOPOLOGY_KINDS, Topology
from kmamiz_tpu_torch.scenarios.traffic import TRAFFIC_KINDS


def reset_for_tests() -> None:
    """Clear the completed-run registry."""
    from kmamiz_tpu_torch.scenarios import runner

    runner.reset_for_tests()


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
    "crashed_card",
    "enabled_storylines",
    "labeled_windows",
    "recorded_runs",
    "reset_for_tests",
    "run_counterfactual",
    "run_matrix",
    "run_scenario",
    "scenario_matrix",
    "spec_signature",
]

"""graftcost's scenario plane: the soak sweep's predicted cell costs.

Counterpart of the part of kmamiz_tpu/cost/ that the port carries. The
JAX package's compile-cost plane (``cost/{features,model,prewarm,
growth_probe}.py`` and the package's own ``__init__``: a ridge model of
XLA compile and warm-run walls over ``core/programs``' registry, spent on
predictive prewarm and boot prewarm ranking) is not ported, by decision:
the port has no program registry and compiles nothing per shape
(ROADMAP.md, "Not ported, by decision"). What is left is host code with
no compile in it: :mod:`.scenario`, the wall-cost estimate of one soak
cell that orders a sweep longest-first.
"""
from kmamiz_tpu_torch.cost.scenario import fit_observed, predicted_scenario_cost_s

__all__ = ["fit_observed", "predicted_scenario_cost_s"]

"""MicroViSim-equivalent synthetic-mesh simulator.

Counterpart of kmamiz_tpu/simulator/: host numpy code, copied so that
the same YAML and the same seeded np.random.Generator give the same
draws and so bit-identical output.

Equivalent of the reference's `src/MicroViSim-simulator/`: a YAML-driven
generator that synthesizes a whole service mesh — endpoint dependencies,
datatypes, replica counts, and per-time-slot traffic with faults and
overload — exercising the full framework pipeline without any Kubernetes,
Istio, Zipkin, or Envoy. It doubles as the "multi-node test without a real
cluster" substitute (SURVEY.md §4) and as the 10k-endpoint benchmark mesh
generator.

The hot path — per-request traffic propagation, a recursive DFS in the
reference (LoadSimulationPropagator.ts:89-244) — is re-designed here as
vectorized frontier propagation over the dependency DAG: the request
dimension is an array axis, Bernoulli error draws / dependency-group
selections / critical-path latencies are batched vector ops, and the DAG is
swept once forward (masks + selections) and once backward (status +
latency) in topological order.
"""
from kmamiz_tpu_torch.simulator.simulator import Simulator  # noqa: F401
from kmamiz_tpu_torch.simulator.config import SimulationConfigManager  # noqa: F401

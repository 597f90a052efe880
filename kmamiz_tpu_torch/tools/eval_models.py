"""Reproducible evaluation of the GraphSAGE and GAT heads, over the port.

Counterpart of the repo's tools/eval_models.py: synthesizes a mesh with
time-windowed faults through the port's MicroViSim-equivalent simulator,
trains each head on the first 75% of hourly slots on ``--device`` (the
card when not given; without one the tool raises), and reports held-out
anomaly precision/recall/F1 and latency MAE against the persistence
baseline (next slot = current slot) and two naive ones. Prints the same
markdown table as the JAX tool.

Usage: python -m kmamiz_tpu_torch.tools.eval_models [--epochs N] [--seed S]
       [--hidden H] [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import List, Optional, Tuple

import numpy as np

from kmamiz_tpu_torch.device import DeviceLike, resolve_device

EVAL_YAML = """
servicesInfo:
  - namespace: mesh
    services:
      - serviceName: gateway
        versions:
          - version: v1
            replica: 2
            endpoints:
              - endpointId: gw-get
                endpointInfo: { path: /api/entry, method: get }
      - serviceName: catalog
        versions:
          - version: v1
            replica: 2
            endpoints:
              - endpointId: catalog-list
                endpointInfo: { path: /api/catalog, method: get }
              - endpointId: catalog-item
                endpointInfo: { path: /api/catalog/item, method: get }
      - serviceName: pricing
        versions:
          - version: v1
            replica: 1
            endpoints:
              - endpointId: price-get
                endpointInfo: { path: /api/price, method: get }
      - serviceName: inventory
        versions:
          - version: v1
            replica: 1
            endpoints:
              - endpointId: inv-get
                endpointInfo: { path: /api/inventory, method: get }
      - serviceName: db
        versions:
          - version: v1
            replica: 1
            endpoints:
              - endpointId: db-query
                endpointInfo: { path: /query, method: post }
endpointDependencies:
  - endpointId: gw-get
    isExternal: true
    dependOn:
      - endpointId: catalog-list
      - endpointId: catalog-item
  - endpointId: catalog-list
    dependOn:
      - endpointId: price-get
      - endpointId: db-query
  - endpointId: catalog-item
    dependOn:
      - endpointId: price-get
      - endpointId: inv-get
  - endpointId: inv-get
    dependOn:
      - endpointId: db-query
loadSimulation:
  config:
    simulationDurationInDays: 4
    overloadErrorRateIncreaseFactor: 3
  serviceMetrics: []
  endpointMetrics:
    - endpointId: gw-get
      delay: { latencyMs: 25, jitterMs: 6 }
      errorRatePercent: 1
      expectedExternalDailyRequestCount: 9600
    - endpointId: catalog-list
      delay: { latencyMs: 15, jitterMs: 4 }
      errorRatePercent: 1
    - endpointId: catalog-item
      delay: { latencyMs: 12, jitterMs: 4 }
      errorRatePercent: 1
    - endpointId: price-get
      delay: { latencyMs: 8, jitterMs: 2 }
      errorRatePercent: 1
    - endpointId: inv-get
      delay: { latencyMs: 9, jitterMs: 2 }
      errorRatePercent: 1
    - endpointId: db-query
      delay: { latencyMs: 5, jitterMs: 1 }
      errorRatePercent: 1
  faultInjection:
    - type: increase-error-rate
      targets:
        services: []
        endpoints:
          - endpointId: db-query
      timePeriods:
        # a RECURRING nightly window (same hours every day): train days
        # teach the periodicity, the held-out day grades forecasting the
        # window start the persistence baseline cannot see coming
        - startTime: { day: 1, hour: 5 }
          durationHours: 4
          probabilityPercent: 100
        - startTime: { day: 2, hour: 5 }
          durationHours: 4
          probabilityPercent: 100
        - startTime: { day: 3, hour: 5 }
          durationHours: 4
          probabilityPercent: 100
        - startTime: { day: 4, hour: 5 }
          durationHours: 4
          probabilityPercent: 100
      increaseErrorRatePercent: 70
    - type: increase-error-rate
      targets:
        services: []
        endpoints:
          - endpointId: price-get
      timePeriods:
        - startTime: { day: 2, hour: 14 }
          durationHours: 3
          probabilityPercent: 100
        - startTime: { day: 4, hour: 1 }
          durationHours: 3
          probabilityPercent: 100
      increaseErrorRatePercent: 60
    - type: increase-latency
      targets:
        services: []
        endpoints:
          - endpointId: inv-get
      timePeriods:
        - startTime: { day: 3, hour: 9 }
          durationHours: 4
          probabilityPercent: 100
      increaseLatencyMs: 220
"""


def evaluate(
    epochs: int = 60, seed: int = 0, hidden: int = 32, device: DeviceLike = None
) -> Tuple[List[tuple], object, object]:
    """Simulate EVAL_YAML for `seed`, train both heads on `device` (the
    card when None) and score them with the baselines on the same
    held-out slots -> ([(name, EvalResult)], eval set, whole dataset)."""
    from kmamiz_tpu_torch.models import gat, graphsage, trainer
    from kmamiz_tpu_torch.simulator import Simulator

    dev = resolve_device(device)
    result = Simulator().generate_simulation_data(EVAL_YAML, 0.0, rng=np.random.default_rng(seed))
    if result.validation_error_message or result.converting_error_message:
        raise ValueError(result.validation_error_message or result.converting_error_message)

    rows = []
    shared_dataset = None
    for name, model in (("GraphSAGE", graphsage), ("GAT", gat)):
        _res, metrics, dataset = trainer.train_on_simulation(
            result.endpoint_dependencies,
            result.realtime_data_per_slot,
            result.replica_counts,
            epochs=epochs,
            hidden=hidden,
            seed=seed,
            model=model,
            device=dev,
        )
        shared_dataset = dataset
        rows.append((name, metrics))

    # baselines score the SAME held-out slots (shared split definition)
    _train_set, eval_set = trainer.temporal_split(shared_dataset, 0.75)
    base_rate = rows[0][1].anomaly_base_rate
    rows.append(("persistence skyline", trainer.evaluate_baseline(eval_set)))
    rows.append(
        ("naive: random @ base rate", trainer.evaluate_naive(eval_set, rate=base_rate, seed=seed))
    )
    rows.append(("naive: flag everything", trainer.evaluate_naive(eval_set, rate=1.0)))
    return rows, eval_set, shared_dataset


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--epochs", type=int, default=60)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--hidden", type=int, default=32)
    parser.add_argument("--device", default=None, help="torch device (default: the card)")
    args = parser.parse_args(argv)

    rows, eval_set, dataset = evaluate(args.epochs, args.seed, args.hidden, args.device)
    print(
        f"\nheld-out slots: {len(eval_set.features)} "
        f"(of {len(dataset.features)}), "
        f"anomaly base rate {rows[0][1].anomaly_base_rate:.3f}, "
        f"epochs {args.epochs}, seed {args.seed}\n"
    )
    print("| model | precision | recall | F1 | latency MAE (ms) |")
    print("|---|---|---|---|---|")
    for name, m in rows:
        print(
            f"| {name} | {m.anomaly_precision:.3f} | {m.anomaly_recall:.3f} "
            f"| {m.anomaly_f1:.3f} | {m.latency_mae_ms:.2f} |"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

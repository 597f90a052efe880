"""Seeded traffic-curve sampler: traces-per-tick schedules.

A copy of kmamiz_tpu/scenarios/traffic.py over the port's simulator (the
same draws, the same curves).

Four curve families map onto production load shapes:

- ``steady``  — flat baseline;
- ``diurnal`` — the MicroViSim daily profile: a daily request total
  split over 24 hourly slots with ±20% random weights by
  ``simulator/load_handler.distribute_daily_request_count`` (the same
  splitter the load simulator uses), compressed onto the tick axis;
- ``burst``   — flat baseline with sampled multi-tick spikes;
- ``ramp``    — linear climb from a low to a high rate.

A curve is a plain ``tuple[int, ...]`` of trace counts, one per tick,
fully determined at compose time — the runner never draws randomness.
Counts are clamped to ``MAX_TRACES_PER_TICK`` so a sampled spike cannot
blow the closed-loop soak's wall-clock budget.
"""
from __future__ import annotations

import random
from typing import Tuple

import numpy as np

from kmamiz_tpu_torch.simulator.load_handler import (
    TIME_SLOTS_PER_DAY,
    distribute_daily_request_count,
)

TRAFFIC_KINDS = ("steady", "diurnal", "burst", "ramp")

MAX_TRACES_PER_TICK = 12


def sample_traffic(
    kind: str, n_ticks: int, rng: random.Random
) -> Tuple[int, ...]:
    """Draw one traces-per-tick schedule of the requested family."""
    if kind not in TRAFFIC_KINDS:
        raise ValueError(f"unknown traffic kind: {kind!r}")
    if kind == "steady":
        base = rng.randint(3, 5)
        curve = [base] * n_ticks
    elif kind == "diurnal":
        # the simulator's own daily splitter, seeded from this curve's
        # stream; tick t reads hourly slot t * 24 // n_ticks
        np_rng = np.random.default_rng(rng.getrandbits(63))
        total = rng.randint(60, 120)
        slots = distribute_daily_request_count(
            total, TIME_SLOTS_PER_DAY, np_rng
        )
        scale = max(1.0, float(slots.max()) / (MAX_TRACES_PER_TICK - 2))
        curve = [
            1 + int(round(float(slots[t * TIME_SLOTS_PER_DAY // n_ticks]) / scale))
            for t in range(n_ticks)
        ]
    elif kind == "burst":
        base = rng.randint(2, 4)
        curve = [base] * n_ticks
        for _ in range(max(1, n_ticks // 5)):
            at = rng.randrange(n_ticks)
            factor = rng.randint(3, 5)
            for j in range(2):
                if at + j < n_ticks:
                    curve[at + j] = base * factor
    else:  # ramp
        low = rng.randint(1, 2)
        high = rng.randint(7, 10)
        span = max(1, n_ticks - 1)
        curve = [
            low + round((high - low) * t / span) for t in range(n_ticks)
        ]
    return tuple(min(MAX_TRACES_PER_TICK, max(1, c)) for c in curve)

"""Slot keys of the simulator's hourly slots.

Copy of kmamiz_tpu/simulator/slot_metrics.py:parse_slot_key, the one
function the trainer's dataset builder reads.
"""
from __future__ import annotations

from typing import Tuple


def parse_slot_key(key: str) -> Tuple[int, int, int]:
    day, hour, minute = (int(x) for x in key.split("-"))
    return day, hour, minute

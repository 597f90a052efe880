"""STLGT subsystem: the linear graph transformer tail-latency head.

- model.py    — kernelized softmax-free transformer block, monotone
                p50/p95/p99 quantile head, per-edge attribution gates.
- serving.py  — bucket-padded quantile forward.

The continual trainer (kmamiz_tpu/models/stlgt/trainer.py) is not ported
yet, so there are no live serving params: `serving_params()` returns None
and the forecast route serves the checkpointed head alone.
"""
from __future__ import annotations

import os
from typing import Optional

from kmamiz_tpu_torch.models.stlgt import model, serving  # noqa: F401


def serving_params() -> Optional[dict]:
    """Last-good params of the process's continual trainer: None until the
    trainer is ported."""
    return None


def horizon_max() -> int:
    """KMAMIZ_STLGT_HORIZON_MAX (default 24): upper clamp on the
    ``/model/forecast?horizon=`` sqrt-widening; beyond it the route
    answers 400."""
    try:
        value = int(os.environ.get("KMAMIZ_STLGT_HORIZON_MAX", "24"))
    except ValueError:
        value = 24
    return max(1, value)

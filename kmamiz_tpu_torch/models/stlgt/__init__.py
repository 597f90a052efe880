"""STLGT subsystem: the linear graph transformer tail-latency head.

- model.py    — kernelized softmax-free transformer block, monotone
                p50/p95/p99 quantile head (pinball loss), per-edge
                attribution gates.
- trainer.py  — the continual trainer driven from the tick's folds: fold
                snapshots become next-hour examples, dirty endpoints mark
                ring slots stale, a refresh trains only stale slots.
- serving.py  — bucket-padded quantile forward.

`serving_params()` gives the process trainer's last-good params (None
before its first refresh) to the forecast route.
"""
from kmamiz_tpu_torch.models.stlgt import model, serving, trainer  # noqa: F401
from kmamiz_tpu_torch.models.stlgt.trainer import (  # noqa: F401
    configured_quantiles,
    enabled,
    get_trainer,
    horizon_max,
    on_fold,
    reset_for_tests,
    serving_params,
    trainer_status,
)

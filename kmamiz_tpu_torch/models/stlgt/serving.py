"""Bucket-padded STLGT inference: quantiles and edge attribution.

Counterpart of kmamiz_tpu/models/stlgt/serving.py, with the discipline of
models/serving.py: pow2 buckets with masked padding, the readout (expm1
back to milliseconds, sigmoid on the logit) on the params' device, host
arrays sliced to the real rows and edges.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from kmamiz_tpu_torch.models.serving import PaddedSnapshot, pad_snapshot


def quantile_forward(
    params, features, src, dst, mask, model
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Bucket-padded STLGT forward -> (latency quantiles ms [N, 3],
    anomaly probability [N], edge attribution score [E]) as host float
    arrays for the real rows and edges."""
    padded = pad_snapshot(features, src, dst, mask, params[0].device)
    return quantile_forward_padded(params, padded, model)


def quantile_forward_padded(
    params, padded: PaddedSnapshot, model
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """quantile_forward over a snapshot already padded on the params'
    device (models/serving.pad_snapshot), with its edge index."""
    with torch.no_grad():
        q_log, logit, gate = model.forward_quantiles(
            params, padded.features, padded.src, padded.dst, padded.mask, index=padded.index
        )
        # graftlint: disable=host-sync-in-hot-path -- the route returns host arrays; one fetch per forward
        q_ms = torch.expm1(q_log).cpu().numpy()
        prob = torch.sigmoid(logit).cpu().numpy()  # graftlint: disable=host-sync-in-hot-path -- same fetch
        gate = gate.cpu().numpy()  # graftlint: disable=host-sync-in-hot-path -- same fetch
    return q_ms[: padded.n], prob[: padded.n], gate[: padded.e]

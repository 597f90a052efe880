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

from kmamiz_tpu_torch.models.serving import padded_inputs


def quantile_forward(
    params, features, src, dst, mask, model
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Bucket-padded STLGT forward -> (latency quantiles ms [N, 3],
    anomaly probability [N], edge attribution score [E]) as host float
    arrays for the real rows and edges."""
    device = params[0].device
    feats, src_p, dst_p, mask_p, n, e = padded_inputs(features, src, dst, mask, device)
    with torch.no_grad():
        q_log, logit, gate = model.forward_quantiles(params, feats, src_p, dst_p, mask_p)
        q_ms = torch.expm1(q_log).cpu().numpy()
        prob = torch.sigmoid(logit).cpu().numpy()
        gate = gate.cpu().numpy()
    return q_ms[:n], prob[:n], gate[:e]

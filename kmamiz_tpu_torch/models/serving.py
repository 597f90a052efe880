"""Bucket-padded inference for the forecast route.

Counterpart of kmamiz_tpu/models/serving.py. Node and edge counts round up
to power-of-two buckets with masked padding, as in the JAX package, so the
kernels see the same few shapes over a deployment's life and padded rows
stay inert; the forward runs on the device the params lie on, sigmoid and
expm1 included, and returns host arrays sliced to the real endpoint count.
PyTorch compiles nothing per shape, so there is no program registry.
"""
from __future__ import annotations

import threading
import time
from typing import Tuple

import numpy as np
import torch

from kmamiz_tpu_torch.core.spans import _pad_size

_lock = threading.Lock()
_stats = {
    "calls": 0,
    "last_ms": 0.0,
    "last_bucket": None,  # (bucket_nodes, bucket_edges) most recently served
}


def padded_inputs(features, src, dst, mask, device: torch.device):
    """The forward's inputs on `device`: features zero-padded to the pow2
    bucket of N rows, edge columns to the pow2 bucket of E with the padding
    masked off. Returns (features, src, dst, mask, n, e)."""
    features = np.asarray(features, dtype=np.float32)
    n, f = features.shape
    e = int(np.asarray(src).shape[0])
    nb, eb = _pad_size(n), _pad_size(e)

    feats = np.zeros((nb, f), dtype=np.float32)
    feats[:n] = features
    src_p = np.zeros(eb, dtype=np.int32)
    dst_p = np.zeros(eb, dtype=np.int32)
    mask_p = np.zeros(eb, dtype=bool)
    src_p[:e] = np.asarray(src, dtype=np.int32)
    dst_p[:e] = np.asarray(dst, dtype=np.int32)
    mask_p[:e] = np.asarray(mask, dtype=bool)
    put = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return put(feats), put(src_p), put(dst_p), put(mask_p), n, e


def forecast_forward(
    params, features, src, dst, mask, model
) -> Tuple[np.ndarray, np.ndarray]:
    """One bucket-padded forward of `model` (a model module) on the
    params' device -> (predicted latency ms [N], anomaly probability [N])
    as host float arrays for the real N rows."""
    device = params[0].device
    t0 = time.perf_counter()
    feats, src_p, dst_p, mask_p, n, _e = padded_inputs(features, src, dst, mask, device)
    with torch.no_grad():
        lat, logit = model.forward(params, feats, src_p, dst_p, mask_p)
        # one copy back of both outputs
        out = torch.stack([torch.expm1(lat), torch.sigmoid(logit)]).cpu().numpy()
    elapsed_ms = (time.perf_counter() - t0) * 1e3
    with _lock:
        _stats["calls"] += 1
        _stats["last_ms"] = elapsed_ms
        _stats["last_bucket"] = [int(feats.shape[0]), int(src_p.shape[0])]
    return out[0, :n], out[1, :n]


def serve_stats() -> dict:
    """Serving-forward counters: calls, the last forward's wall ms and its
    (node, edge) bucket."""
    with _lock:
        return dict(_stats)

"""Bucket-padded inference for the forecast route.

Counterpart of kmamiz_tpu/models/serving.py. Node and edge counts round up
to power-of-two buckets with masked padding, as in the JAX package, so the
kernels see the same few shapes over a deployment's life and padded rows
stay inert; the forward runs on the device the params lie on, sigmoid and
expm1 included, and returns host arrays sliced to the real endpoint count.
PyTorch compiles nothing per shape, so there is no program registry.
`pad_snapshot` uploads a snapshot once, with its edge index on the card,
for every forward that reads it (the forecast route shares one between
the GraphSAGE and STLGT heads).

Each forward counts in `kmamiz_model_serves_total` and times under the
step timer's `model_forward` phase (GET /health/timings), as in the JAX
package; `serve_stats()` is the route's own summary.
"""
from __future__ import annotations

import threading
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from kmamiz_tpu_torch.core.profiling import step_timer
from kmamiz_tpu_torch.core.spans import _pad_size
from kmamiz_tpu_torch.ops import sparse
from kmamiz_tpu_torch.telemetry.profiling import events as prof_events
from kmamiz_tpu_torch.telemetry.registry import REGISTRY

# preallocated serving counter: the forward increments the handle
_SERVES = REGISTRY.counter("kmamiz_model_serves_total", "Forecast forward calls served")

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


class PaddedSnapshot(NamedTuple):
    """A snapshot's forward inputs on one device, bucket-padded."""

    features: torch.Tensor  # [Nb, F]
    src: torch.Tensor  # [Eb] int32
    dst: torch.Tensor  # [Eb] int32
    mask: torch.Tensor  # [Eb] bool
    n: int  # real rows
    e: int  # real edges
    index: Optional[sparse.EdgeIndex]  # the card's edge index over Nb rows


def pad_snapshot(features, src, dst, mask, device: torch.device) -> PaddedSnapshot:
    """padded_inputs plus, on the card, the edge list's index, built once
    for every forward of the snapshot."""
    feats, src_p, dst_p, mask_p, n, e = padded_inputs(features, src, dst, mask, device)
    index = (
        sparse.edge_index(src_p, dst_p, mask_p, feats.shape[0]) if feats.is_cuda else None
    )
    return PaddedSnapshot(feats, src_p, dst_p, mask_p, n, e, index)


def forecast_forward(
    params, features, src, dst, mask, model
) -> Tuple[np.ndarray, np.ndarray]:
    """One bucket-padded forward of `model` (a model module) on the
    params' device -> (predicted latency ms [N], anomaly probability [N])
    as host float arrays for the real N rows."""
    padded = pad_snapshot(features, src, dst, mask, params[0].device)
    return forecast_forward_padded(params, padded, model)


def forecast_forward_padded(params, padded: PaddedSnapshot, model) -> Tuple[np.ndarray, np.ndarray]:
    """forecast_forward over a snapshot already padded on the params'
    device (pad_snapshot), with its edge index."""
    t0 = prof_events.now_ms()
    with step_timer.phase("model_forward"), torch.no_grad():
        lat, logit = model.forward(
            params, padded.features, padded.src, padded.dst, padded.mask, index=padded.index
        )
        # one copy back of both outputs
        # graftlint: disable=host-sync-in-hot-path -- the route returns host arrays; one fetch per forward
        out = torch.stack([torch.expm1(lat), torch.sigmoid(logit)]).cpu().numpy()
    elapsed_ms = prof_events.now_ms() - t0
    _SERVES.inc()
    with _lock:
        _stats["calls"] += 1
        _stats["last_ms"] = elapsed_ms
        _stats["last_bucket"] = [int(padded.features.shape[0]), int(padded.src.shape[0])]
    return out[0, : padded.n], out[1, : padded.n]


def serve_stats() -> dict:
    """Serving-forward counters: calls, the last forward's wall ms and its
    (node, edge) bucket."""
    with _lock:
        return dict(_stats)

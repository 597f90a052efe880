"""STLGT head: linear graph transformer for tail-latency quantiles.

Counterpart of kmamiz_tpu/models/stlgt/model.py for serving. One
linear-attention block over the pow2-bucketed endpoint slots (phi = elu+1
kernelized attention, O(N·H²)), plus a neighbor bias from the edge list:
a sigmoid-gated message per dependency edge, summed over both directions,
whose gate doubles as the per-edge attribution score. The gate and the
gated sums are one launch of the fused SDDMM/SpMM kernel (ops/sparse.py,
gated mode) on the card.

Heads: a monotone quantile stack (p50 raw, p95 = p50 + softplus, p99 =
p95 + softplus) over log1p latency, and the anomaly logit. `forward`
returns (p50, anomaly_logit) like every model module; `forward_quantiles`
is the full surface. Training uses the masked pinball loss plus the
family's weighted BCE (`make_pinball_loss_fn`) and the family's AdamW.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from kmamiz_tpu_torch.device import DeviceLike, resolve_device
from kmamiz_tpu_torch.models import common as _common
from kmamiz_tpu_torch.models.graphsage import (  # noqa: F401 - one feature layout for every head
    NUM_FEATURES,
    assemble_features,
    glorot,
)
from kmamiz_tpu_torch.ops import sparse

#: forecast quantile levels, in emitted column order (p50, p95, p99)
QUANTILES: Tuple[float, ...] = (0.50, 0.95, 0.99)
NUM_QUANTILES = len(QUANTILES)


class StlgtParams(NamedTuple):
    w_in: torch.Tensor  # [F, H] input projection
    b_in: torch.Tensor  # [H]
    w_q: torch.Tensor  # [H, H] attention query
    w_k: torch.Tensor  # [H, H] attention key
    w_v: torch.Tensor  # [H, H] attention value
    w_o: torch.Tensor  # [H, H] attention output
    b_edge: torch.Tensor  # [1] edge-gate bias
    w_f1: torch.Tensor  # [H, H] FFN
    b_f1: torch.Tensor  # [H]
    w_f2: torch.Tensor  # [H, H]
    b_f2: torch.Tensor  # [H]
    w_quant: torch.Tensor  # [H, NUM_QUANTILES] quantile head
    b_quant: torch.Tensor  # [NUM_QUANTILES]
    w_quant_skip: torch.Tensor  # [F, NUM_QUANTILES] wide-and-deep skip
    w_anomaly: torch.Tensor  # [H, 1]
    b_anomaly: torch.Tensor  # [1]
    w_anomaly_skip: torch.Tensor  # [F, 1]


def init_params(
    generator: torch.Generator,
    hidden: int = 32,
    num_features: int = NUM_FEATURES,
    num_nodes: int = 0,
    device: DeviceLike = None,
) -> StlgtParams:
    """Random weights from `generator` (a CPU torch.Generator), placed on
    `device` (the card when None). num_nodes is accepted for model-module
    interface parity and ignored: STLGT is identity-free."""
    del num_nodes
    dev = resolve_device(device)
    h = hidden

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32)

    params = StlgtParams(
        w_in=glorot(generator, (num_features, h)),
        b_in=zeros(h),
        w_q=glorot(generator, (h, h)),
        w_k=glorot(generator, (h, h)),
        w_v=glorot(generator, (h, h)),
        w_o=glorot(generator, (h, h)),
        b_edge=zeros(1),
        w_f1=glorot(generator, (h, h)),
        b_f1=zeros(h),
        w_f2=glorot(generator, (h, h)),
        b_f2=zeros(h),
        w_quant=glorot(generator, (h, NUM_QUANTILES)),
        b_quant=zeros(NUM_QUANTILES),
        # persistence skip: the quantile readout sees the raw features
        w_quant_skip=zeros(num_features, NUM_QUANTILES),
        w_anomaly=glorot(generator, (h, 1)),
        b_anomaly=zeros(1),
        w_anomaly_skip=zeros(num_features, 1),
    )
    return StlgtParams(*(t.to(dev) for t in params))


def _phi(x: torch.Tensor) -> torch.Tensor:
    """elu+1: the positive feature map of kernelized linear attention."""
    return torch.nn.functional.elu(x) + 1.0


def encode(
    params: StlgtParams,
    features: torch.Tensor,  # [N, F] (bucket-padded rows all-zero)
    src_ep: torch.Tensor,  # [E]
    dst_ep: torch.Tensor,  # [E]
    edge_mask: torch.Tensor,  # [E]
    index: Optional[sparse.EdgeIndex] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One linear-transformer block -> (node states [N, H], edge gates
    [E]). Padded lanes (all-zero feature rows) are masked out of the
    attention sums; padded edges out of the bias by edge_mask. `index` is
    the edge list's sparse.edge_index over the N rows (the kernel's wrapper
    builds one when not given)."""
    # a padded slot has an all-zero feature row; real slots always carry
    # at least the hour-of-day cos column
    lane = (features.abs().sum(dim=1) > 0).to(torch.float32)[:, None]

    x = torch.relu(features @ params.w_in + params.b_in)
    q = _phi(x @ params.w_q) * lane
    k = _phi(x @ params.w_k) * lane
    v = (x @ params.w_v) * lane

    # global linear attention: O(N·H²), softmax-free
    kv = k.T @ v  # [H, H]
    z = k.sum(dim=0)  # [H]
    attn = (q @ kv) / (q @ z + 1e-6)[:, None]

    # neighbor bias: the gate and the gated sums over both directions in
    # one fused SDDMM/SpMM; the deg normalisation stays out here
    bias, deg, gate = sparse.fused_gated_bias(
        q, k, v, params.b_edge, src_ep, dst_ep, edge_mask, index=index
    )
    bias = bias / torch.clamp(deg, min=1.0)[:, None]

    h1 = x + torch.relu((attn + bias) @ params.w_o)
    h2 = h1 + torch.relu(
        torch.relu(h1 @ params.w_f1 + params.b_f1) @ params.w_f2 + params.b_f2
    )
    return h2 * lane, gate


def forward_quantiles(
    params: StlgtParams,
    features: torch.Tensor,
    src_ep: torch.Tensor,
    dst_ep: torch.Tensor,
    edge_mask: torch.Tensor,
    index: Optional[sparse.EdgeIndex] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full STLGT surface -> (latency quantiles [N, NUM_QUANTILES] in
    log1p-ms, anomaly logits [N], per-edge attribution gates [E]).
    Quantile columns are monotone by construction."""
    h, gate = encode(params, features, src_ep, dst_ep, edge_mask, index=index)
    softplus = torch.nn.functional.softplus
    raw = h @ params.w_quant + features @ params.w_quant_skip + params.b_quant
    q50 = raw[:, 0]
    q95 = q50 + softplus(raw[:, 1])
    q99 = q95 + softplus(raw[:, 2])
    quantiles = torch.stack([q50, q95, q99], dim=1)
    anomaly_logit = (
        h @ params.w_anomaly + features @ params.w_anomaly_skip + params.b_anomaly
    )[:, 0]
    return quantiles, anomaly_logit, gate


def forward(
    params: StlgtParams,
    features: torch.Tensor,
    src_ep: torch.Tensor,
    dst_ep: torch.Tensor,
    edge_mask: torch.Tensor,
    index: Optional[sparse.EdgeIndex] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Model-module surface: (p50 latency, anomaly logit)."""
    quantiles, anomaly_logit, _gate = forward_quantiles(
        params, features, src_ep, dst_ep, edge_mask, index=index
    )
    return quantiles[:, 0], anomaly_logit


def make_pinball_loss_fn(
    pos_weight: float = 1.0, quantiles: Tuple[float, ...] = QUANTILES
):
    """Masked pinball (quantile) loss over the three levels + the family's
    weighted BCE anomaly term, with common.make_loss_fn's signature."""

    def loss_fn(
        params,
        features,
        src_ep,
        dst_ep,
        edge_mask,
        target_latency,
        target_anomaly,
        node_mask,
        index=None,
    ):
        pred_q, anomaly_logit, _gate = forward_quantiles(
            params, features, src_ep, dst_ep, edge_mask, index=index
        )
        taus = torch.tensor(quantiles, dtype=torch.float32, device=pred_q.device)
        w = node_mask.to(torch.float32)
        denom = torch.clamp(w.sum(), min=1.0)
        diff = target_latency[:, None] - pred_q  # [N, Q]
        pinball = torch.maximum(taus * diff, (taus - 1.0) * diff)
        quant_loss = torch.sum(w[:, None] * pinball) / denom
        anomaly_loss = _common.weighted_bce(
            anomaly_logit, target_anomaly, w, denom, pos_weight
        )
        return quant_loss + anomaly_loss, (quant_loss, anomaly_loss)

    return loss_fn


make_optimizer = _common.make_optimizer

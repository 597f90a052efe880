"""GraphSAGE latency/anomaly head over the endpoint-dependency graph.

Counterpart of kmamiz_tpu/models/graphsage.py for serving: a 2-layer
neighbor-mean GraphSAGE over the edge store's columns, with per-endpoint
features from the window statistics predicting next-hour latency
(regression, log1p ms) and anomaly probability (binary logit).

Aggregation uses both edge directions (callers and callees are both
signal for an endpoint's health) as segment means. Each neighbor mean is
one launch of the fused SDDMM/SpMM kernel (ops/sparse.py) on the card, so
a forward launches it twice, over one edge index: the caller's (an owner
of a fixed edge list builds it once), else one built per forward. The
loss, optimizer and train step are the family's (models/common.py).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from kmamiz_tpu_torch.device import DeviceLike, resolve_device
from kmamiz_tpu_torch.models import common as _common
from kmamiz_tpu_torch.models.common import concat_embedding
from kmamiz_tpu_torch.ops import sparse

NUM_FEATURES = 10  # incl. sin/cos hour-of-day
EMB_DIM = 8  # learned node-identity embedding width


def assemble_features(
    request_rate,
    err4_share,
    err5_share,
    log_latency,
    latency_cv,
    replicas,
    log_volume,
    active,
    hour_of_day: float,
) -> np.ndarray:
    """THE feature-column layout, shared by the trainer's per-slot features
    and the tick's hour fold — one definition so the two can never skew.
    Host numpy [N, NUM_FEATURES]; consumers move it to their device at the
    bucket-padding step."""
    angle = 2.0 * np.pi * float(hour_of_day) / 24.0
    rate = np.asarray(request_rate, dtype=np.float32)
    return np.stack(
        [
            rate,
            np.asarray(err4_share, dtype=np.float32),
            np.asarray(err5_share, dtype=np.float32),
            np.asarray(log_latency, dtype=np.float32),
            np.asarray(latency_cv, dtype=np.float32),
            np.asarray(replicas, dtype=np.float32),
            np.asarray(log_volume, dtype=np.float32),
            np.asarray(active, dtype=np.float32),
            np.full_like(rate, np.float32(np.sin(angle))),
            np.full_like(rate, np.float32(np.cos(angle))),
        ],
        axis=1,
    )


class SageParams(NamedTuple):
    w_self_1: torch.Tensor  # [F, H]
    w_neigh_1: torch.Tensor  # [F, H]
    b_1: torch.Tensor  # [H]
    w_self_2: torch.Tensor  # [H, H]
    w_neigh_2: torch.Tensor  # [H, H]
    b_2: torch.Tensor  # [H]
    w_latency: torch.Tensor  # [H, 1]
    b_latency: torch.Tensor  # [1]
    w_anomaly: torch.Tensor  # [H, 1]
    b_anomaly: torch.Tensor  # [1]
    w_latency_skip: torch.Tensor  # [F, 1]
    w_anomaly_skip: torch.Tensor  # [F, 1]
    embedding: Optional[torch.Tensor]  # [num_nodes, EMB_DIM], or None


def glorot(generator: torch.Generator, shape) -> torch.Tensor:
    """Normal weights scaled by sqrt(2 / (fan_in + fan_out)), drawn on the
    CPU so that one seed gives the same weights on every device."""
    scale = math.sqrt(2.0 / (shape[0] + shape[1]))
    return torch.randn(shape, generator=generator, dtype=torch.float32) * scale


def init_params(
    generator: torch.Generator,
    hidden: int = 64,
    num_features: int = NUM_FEATURES,
    num_nodes: int = 0,
    device: DeviceLike = None,
) -> SageParams:
    """Random weights from `generator` (a CPU torch.Generator), placed on
    `device` (the card when None). num_nodes > 0 adds a learned per-node
    embedding, concatenated to the input features of layer 1."""
    in_dim = num_features + (EMB_DIM if num_nodes else 0)
    dev = resolve_device(device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32)

    params = SageParams(
        w_self_1=glorot(generator, (in_dim, hidden)),
        w_neigh_1=glorot(generator, (in_dim, hidden)),
        b_1=zeros(hidden),
        w_self_2=glorot(generator, (hidden, hidden)),
        w_neigh_2=glorot(generator, (hidden, hidden)),
        b_2=zeros(hidden),
        w_latency=glorot(generator, (hidden, 1)),
        b_latency=zeros(1),
        w_anomaly=glorot(generator, (hidden, 1)),
        b_anomaly=zeros(1),
        # wide-and-deep input skips: persistence is the dominant mode of
        # both targets, so the readout sees the raw features directly
        w_latency_skip=zeros(num_features, 1),
        w_anomaly_skip=zeros(num_features, 1),
        embedding=(
            torch.randn((num_nodes, EMB_DIM), generator=generator, dtype=torch.float32) * 0.1
            if num_nodes
            else None
        ),
    )
    return SageParams(*(None if t is None else t.to(dev) for t in params))


def neighbor_degree(
    num_nodes: int,
    src_ep: torch.Tensor,  # [E]
    dst_ep: torch.Tensor,  # [E]
    edge_mask: torch.Tensor,  # [E]
    dtype=torch.float32,
) -> torch.Tensor:
    """Per-node masked degree over both edge directions [N], in plain
    torch. forward does not call it: the fused kernel returns the same
    degree beside its sums."""
    n = num_nodes
    src = torch.where(edge_mask & (src_ep >= 0) & (src_ep < n), src_ep, n).long()
    dst = torch.where(edge_mask & (dst_ep >= 0) & (dst_ep < n), dst_ep, n).long()
    em = edge_mask.to(dtype)
    deg = torch.zeros(n + 1, dtype=dtype, device=em.device)
    deg.index_add_(0, src, em)
    deg.index_add_(0, dst, em)
    return deg[:n]


def neighbor_mean(
    h: torch.Tensor,  # [N, F]
    src_ep: torch.Tensor,  # [E]
    dst_ep: torch.Tensor,  # [E]
    edge_mask: torch.Tensor,  # [E]
    index: Optional[sparse.EdgeIndex] = None,
) -> torch.Tensor:
    """Mean of neighbor states over both edge directions: one fused
    SDDMM/SpMM (ops/sparse.py) gives the sums and the masked degree (exact:
    sums of 1.0); the division stays out here. `index` is the edge list's
    sparse.edge_index over N rows (built by the kernel's wrapper when not
    given)."""
    agg, deg = sparse.fused_neighbor_sums(
        h.to(torch.float32), src_ep, dst_ep, edge_mask, index=index
    )
    return (agg / torch.clamp(deg, min=1.0)[:, None]).to(h.dtype)


def forward(
    params: SageParams,
    features: torch.Tensor,  # [N, F]
    src_ep: torch.Tensor,
    dst_ep: torch.Tensor,
    edge_mask: torch.Tensor,
    index: Optional[sparse.EdgeIndex] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two SAGE layers -> (latency prediction [N], anomaly logits [N]).
    On the card both layers aggregate over one edge index
    (sparse.edge_index over the N feature rows): `index` when given, else
    one built here (with its gather part when a param wants a grad); the
    plain CPU version reads no index."""
    x = concat_embedding(features, params.embedding)
    if index is None and x.is_cuda:
        index = sparse.edge_index(
            src_ep, dst_ep, edge_mask, x.shape[0], for_backward=sparse.wants_grad(*params)
        )
    agg1 = neighbor_mean(x, src_ep, dst_ep, edge_mask, index=index)
    h1 = torch.relu(x @ params.w_self_1 + agg1 @ params.w_neigh_1 + params.b_1)
    agg2 = neighbor_mean(h1, src_ep, dst_ep, edge_mask, index=index)
    h2 = torch.relu(h1 @ params.w_self_2 + agg2 @ params.w_neigh_2 + params.b_2)
    latency = (
        h2 @ params.w_latency + features @ params.w_latency_skip + params.b_latency
    )[:, 0]
    anomaly_logit = (
        h2 @ params.w_anomaly + features @ params.w_anomaly_skip + params.b_anomaly
    )[:, 0]
    return latency, anomaly_logit


# loss / optimizer / train step are the family-shared scaffolding
loss_fn = _common.make_loss_fn(forward)  # unweighted default
make_optimizer = _common.make_optimizer


def make_train_step(optimizer, pos_weight: float = 1.0):
    """(params, opt_state, batch..., index=None) -> (params, opt_state,
    loss, aux)."""
    if pos_weight == 1.0:
        return _common.make_train_step(optimizer, loss_fn)
    return _common.make_train_step(optimizer, _common.make_loss_fn(forward, pos_weight))


def features_from_stats(
    count: torch.Tensor,  # [E*S] per-(endpoint, status) counts
    error_4xx: torch.Tensor,
    error_5xx: torch.Tensor,
    latency_mean: torch.Tensor,
    latency_cv: torch.Tensor,
    replicas: torch.Tensor,  # [N]
    num_endpoints: int,
    num_statuses: int,
    window_seconds: float = 30.0,
    *,
    hour_of_day: float,
) -> np.ndarray:
    """Fold per-(endpoint, status) window stats into the host feature
    block [N, NUM_FEATURES]."""
    shape = (num_endpoints, num_statuses)
    c = count.reshape(shape)
    e4 = error_4xx.reshape(shape)
    e5 = error_5xx.reshape(shape)
    lm = latency_mean.reshape(shape)
    cv = latency_cv.reshape(shape)

    total = c.sum(dim=1)
    safe = torch.clamp(total, min=1.0)
    # count-weighted means across status groups
    mean_latency = (lm * c).sum(dim=1) / safe
    mean_cv = (cv * c).sum(dim=1) / safe

    def host(t):
        return t.detach().cpu().numpy()

    return assemble_features(
        host(total / window_seconds),
        host(e4.sum(dim=1) / safe),
        host(e5.sum(dim=1) / safe),
        host(torch.log1p(mean_latency)),
        host(mean_cv),
        host(replicas[:num_endpoints]),
        host(torch.log1p(total)),
        host(total > 0),
        hour_of_day=hour_of_day,
    )

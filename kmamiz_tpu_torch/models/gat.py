"""Graph-attention (GAT) latency/anomaly head, the second model family
over the endpoint-dependency graph.

Counterpart of kmamiz_tpu/models/gat.py. Same task and feature/target
contract as models/graphsage.py (next-window latency regression and
anomaly logits over the capacity-padded edge store), but neighbors
aggregate through edge attention instead of a mean: per directed edge a
score a^T[Wh_src || Wh_dst] passes LeakyReLU and normalizes with a
numerically stable segment softmax over each destination's incoming edges
(a scatter amax for the shift, index_add_ for the partition). Both edge
directions contribute, each with its own attention vectors.

The reference is XLA, not Pallas, so the module is PyTorch ops: it runs
no hand-written kernel, and `forward` takes the edge `index` the family's
callers pass (models/stacked.py, models/serving.py) and does not read it.
Gradients through the two kinks match JAX's: a segment max split evenly
among ties (scatter_reduce amax does the same) and the exponent's clip
written as minimum/maximum, whose tie gradient is 0.5 as jnp.clip's is.
Rows are gathered with index_select, whose backward is an index_add_ (on
the card, atomic adds); a plain `h[idx]`'s backward is an accumulating
index_put_, which sorts the indices on the card at every step.

API mirrors graphsage (init_params / forward / loss_fn / make_optimizer /
make_train_step) so the trainer, checkpointing and serving reuse it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from kmamiz_tpu_torch.device import DeviceLike, resolve_device
from kmamiz_tpu_torch.models import common as _common
from kmamiz_tpu_torch.models.common import concat_embedding
from kmamiz_tpu_torch.models.graphsage import EMB_DIM, NUM_FEATURES, glorot

LEAK = 0.2


class GatParams(NamedTuple):
    w_1: torch.Tensor  # [F, H]
    a_src_1: torch.Tensor  # [H] attention vector, source half (fwd direction)
    a_dst_1: torch.Tensor  # [H]
    a_src_1r: torch.Tensor  # [H] reverse direction
    a_dst_1r: torch.Tensor  # [H]
    b_1: torch.Tensor  # [H]
    w_2: torch.Tensor  # [H, H]
    a_src_2: torch.Tensor  # [H]
    a_dst_2: torch.Tensor  # [H]
    a_src_2r: torch.Tensor  # [H]
    a_dst_2r: torch.Tensor  # [H]
    b_2: torch.Tensor  # [H]
    w_latency: torch.Tensor  # [H, 1]
    b_latency: torch.Tensor  # [1]
    w_anomaly: torch.Tensor  # [H, 1]
    b_anomaly: torch.Tensor  # [1]
    w_latency_skip: torch.Tensor  # [F, 1]
    w_anomaly_skip: torch.Tensor  # [F, 1]
    embedding: Optional[torch.Tensor]  # [num_nodes, EMB_DIM] learned node identity, or None


def init_params(
    generator: torch.Generator,
    hidden: int = 64,
    num_features: int = NUM_FEATURES,
    num_nodes: int = 0,
    device: DeviceLike = None,
) -> GatParams:
    """Random weights from `generator` (a CPU torch.Generator), placed on
    `device` (the card when None). num_nodes > 0 adds a learned per-node
    embedding, concatenated to the input features of layer 1."""
    in_dim = num_features + (EMB_DIM if num_nodes else 0)
    dev = resolve_device(device)

    def att(h):
        return torch.randn((h,), generator=generator, dtype=torch.float32) * 0.1

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32)

    params = GatParams(
        w_1=glorot(generator, (in_dim, hidden)),
        a_src_1=att(hidden),
        a_dst_1=att(hidden),
        a_src_1r=att(hidden),
        a_dst_1r=att(hidden),
        b_1=zeros(hidden),
        w_2=glorot(generator, (hidden, hidden)),
        a_src_2=att(hidden),
        a_dst_2=att(hidden),
        a_src_2r=att(hidden),
        a_dst_2r=att(hidden),
        b_2=zeros(hidden),
        w_latency=glorot(generator, (hidden, 1)),
        b_latency=zeros(1),
        w_anomaly=glorot(generator, (hidden, 1)),
        b_anomaly=zeros(1),
        # wide-and-deep input skips (see graphsage.init_params)
        w_latency_skip=zeros(num_features, 1),
        w_anomaly_skip=zeros(num_features, 1),
        embedding=(
            torch.randn((num_nodes, EMB_DIM), generator=generator, dtype=torch.float32) * 0.1 if num_nodes else None
        ),
    )
    return GatParams(*(None if t is None else t.to(dev) for t in params))


def _segment_softmax(
    scores: torch.Tensor, seg: torch.Tensor, num_segments: int, mask: torch.Tensor
) -> torch.Tensor:
    """Numerically stable softmax of edge scores within each segment;
    masked edges contribute zero weight.

    The exponent is clipped to [-60, 0] before exp: for real rows the
    shift already makes it non-positive, and for masked rows it keeps the
    untaken branch from overflowing to inf, whose 0 * inf cotangent would
    turn the whole gradient NaN whenever a segment holds only masked edges
    (capacity padding clamped to node n-1 when that node has no real
    edge). Masked edges still count in their segment's index (they lie at
    n-1) but carry the float32 minimum into the max and 0 into the sum, so
    they move no real edge's weight."""
    neg = torch.finfo(scores.dtype).min
    seg = seg.long()
    shift = torch.full((num_segments,), neg, dtype=scores.dtype, device=scores.device)
    shift = shift.scatter_reduce(0, seg, torch.where(mask, scores, neg), "amax", include_self=True)
    shift = torch.where(shift > neg / 2, shift, torch.zeros_like(shift))  # empty segments
    delta = torch.minimum(
        torch.clamp_min(scores - shift.index_select(0, seg), -60.0), torch.zeros_like(scores)
    )
    expd = torch.where(mask, torch.exp(delta), torch.zeros_like(delta))
    denom = torch.zeros(num_segments, dtype=scores.dtype, device=scores.device)
    denom = denom.index_add(0, seg, expd)
    return expd / torch.clamp_min(denom.index_select(0, seg), 1e-30)


def _attend(h, src, dst, edge_mask, a_src, a_dst) -> torch.Tensor:
    """One attention direction: aggregate h[src] into dst with softmax
    weights over each dst's incoming edges. Returns [N, H]."""
    n = h.shape[0]
    last = torch.full_like(src, n - 1)
    src_c = torch.minimum(torch.where(edge_mask, src, last), last).long()
    dst_c = torch.minimum(torch.where(edge_mask, dst, last), last).long()
    gathered = h.index_select(0, src_c)
    scores = torch.nn.functional.leaky_relu(
        gathered @ a_src + h.index_select(0, dst_c) @ a_dst, negative_slope=LEAK
    )
    alpha = _segment_softmax(scores, dst_c, n, edge_mask)
    msgs = gathered * (alpha * edge_mask.to(alpha.dtype))[:, None]
    return torch.zeros_like(h).index_add(0, dst_c, msgs)


def _layer(h, src, dst, edge_mask, w, a_s, a_d, a_sr, a_dr, b) -> torch.Tensor:
    hw = h @ w
    fwd = _attend(hw, src, dst, edge_mask, a_s, a_d)
    rev = _attend(hw, dst, src, edge_mask, a_sr, a_dr)
    return torch.nn.functional.elu(hw + fwd + rev + b)


def forward(
    params: GatParams,
    features: torch.Tensor,  # [N, NUM_FEATURES]
    src_ep: torch.Tensor,
    dst_ep: torch.Tensor,
    edge_mask: torch.Tensor,
    index=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two attention layers -> (latency prediction [N], anomaly logits
    [N]). `index` (the family's edge index) is accepted and not read."""
    del index
    x = concat_embedding(features, params.embedding)
    h1 = _layer(
        x, src_ep, dst_ep, edge_mask,
        params.w_1, params.a_src_1, params.a_dst_1,
        params.a_src_1r, params.a_dst_1r, params.b_1,
    )
    h2 = _layer(
        h1, src_ep, dst_ep, edge_mask,
        params.w_2, params.a_src_2, params.a_dst_2,
        params.a_src_2r, params.a_dst_2r, params.b_2,
    )
    latency = (h2 @ params.w_latency + features @ params.w_latency_skip + params.b_latency)[:, 0]
    anomaly_logit = (
        h2 @ params.w_anomaly + features @ params.w_anomaly_skip + params.b_anomaly
    )[:, 0]
    return latency, anomaly_logit


loss_fn = _common.make_loss_fn(forward)  # unweighted default
make_optimizer = _common.make_optimizer


def make_train_step(optimizer, pos_weight: float = 1.0):
    """(params, opt_state, batch..., index=None) -> (params, opt_state,
    loss, aux)."""
    if pos_weight == 1.0:
        return _common.make_train_step(optimizer, loss_fn)
    return _common.make_train_step(optimizer, _common.make_loss_fn(forward, pos_weight))

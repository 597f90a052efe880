"""Shared pieces of the graph model families: the node-identity embedding,
the loss, the optimizer and the train step.

Counterpart of kmamiz_tpu/models/common.py. Every head predicts
(latency [N], anomaly logits [N]) from (features, src, dst, edge_mask);
the loss, the optimizer and the train step are shared so the families
cannot drift. Params are NamedTuples of tensors (a field may be None, as
GraphSAGE's embedding), updated by plain functions.

The optimizer is a functional AdamW that mirrors optax.adamw(lr,
weight_decay=1e-4) operation by operation (b1 0.9, b2 0.999, eps 1e-8,
eps_root 0, decay on every leaf, bias correction by the step count), so a
step of the port and a step of the JAX package differ only by the float
rounding of their kernels. torch.optim.AdamW folds the bias corrections
into the step size and drifts from optax by rounding within a few steps.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F


def concat_embedding(
    features: torch.Tensor, embedding: Optional[torch.Tensor]
) -> torch.Tensor:
    """Concatenate the learned node-identity embedding to the feature
    block, zero-padding it when the features carry bucket-padded node rows:
    padded nodes have no edges and are never read, so a zero identity is
    exact."""
    if embedding is None:
        return features
    pad = features.shape[0] - embedding.shape[0]
    if pad:
        embedding = torch.nn.functional.pad(embedding, (0, 0, 0, pad))
    return torch.cat([features, embedding], dim=1)


def sigmoid_binary_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax.sigmoid_binary_cross_entropy, in its log-sigmoid form."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def weighted_bce(logits, labels, w, denom, pos_weight: float) -> torch.Tensor:
    """The family's anomaly term: node-masked sigmoid BCE with the positive
    class weighted by pos_weight, over the masked node count."""
    class_w = 1.0 + (pos_weight - 1.0) * labels
    return torch.sum(w * class_w * sigmoid_binary_cross_entropy(logits, labels)) / denom


def make_loss_fn(forward, pos_weight: float = 1.0):
    """Masked MSE (latency) + masked sigmoid BCE (anomaly) over a head's
    forward function. pos_weight scales the positive-class BCE term:
    anomalies are rare, and unweighted BCE drives the head to the base
    rate. The loss takes the forward's edge `index` (see ops/sparse.py)."""

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
        pred_latency, anomaly_logit = forward(
            params, features, src_ep, dst_ep, edge_mask, index=index
        )
        w = node_mask.to(torch.float32)
        denom = torch.clamp(w.sum(), min=1.0)
        latency_loss = torch.sum(w * (pred_latency - target_latency) ** 2) / denom
        anomaly_loss = weighted_bce(anomaly_logit, target_anomaly, w, denom, pos_weight)
        return latency_loss + anomaly_loss, (latency_loss, anomaly_loss)

    return loss_fn


class AdamState(NamedTuple):
    """AdamW's state: the step count and the two moments, one tensor per
    params field (None where the field is None)."""

    count: torch.Tensor  # int32 scalar
    mu: tuple
    nu: tuple


class AdamW(NamedTuple):
    """optax.adamw as plain functions over params NamedTuples."""

    lr: float
    weight_decay: float = 1e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params) -> AdamState:
        zeros = tuple(None if p is None else torch.zeros_like(p) for p in params)
        count = torch.zeros((), dtype=torch.int32, device=_device_of(params))
        return AdamState(count, zeros, tuple(None if z is None else z.clone() for z in zeros))

    @torch.no_grad()
    def apply(self, params, grads, state: AdamState):
        """One update -> (params, state), new tensors (the inputs are left
        as they were). The order of operations is optax's: moments, bias
        correction, mu_hat / (sqrt(nu_hat) + eps), + weight_decay * p,
        * -lr, p + update; each step is one multi-tensor (_foreach) op over
        every leaf, so an update is ~14 launches on the card, not ~14 per
        leaf."""
        b1, b2 = self.b1, self.b2
        live = [i for i, p in enumerate(params) if p is not None]
        p = [params[i] for i in live]
        g = [grads[i] for i in live]
        count = state.count + 1
        c = count.to(torch.float32)
        bc1 = 1 - torch.pow(torch.full((), b1, device=c.device), c)
        bc2 = 1 - torch.pow(torch.full((), b2, device=c.device), c)
        mu_old = [state.mu[i] for i in live]
        nu_old = [state.nu[i] for i in live]
        mu = torch._foreach_add(torch._foreach_mul(g, 1 - b1), torch._foreach_mul(mu_old, b1))
        g2 = torch._foreach_mul(g, g)
        nu = torch._foreach_add(torch._foreach_mul(g2, 1 - b2), torch._foreach_mul(nu_old, b2))
        den = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, bc2)), self.eps)
        u = torch._foreach_div(torch._foreach_div(mu, bc1), den)
        u = torch._foreach_add(u, torch._foreach_mul(p, self.weight_decay))
        new_p = torch._foreach_add(p, torch._foreach_mul(u, -self.lr))

        def scatter(values):
            out = [None] * len(params)
            for i, t in zip(live, values):
                out[i] = t
            return out

        return type(params)(*scatter(new_p)), AdamState(count, tuple(scatter(mu)), tuple(scatter(nu)))


def _device_of(params) -> torch.device:
    return next(p for p in params if p is not None).device


def make_optimizer(lr: float = 1e-3) -> AdamW:
    return AdamW(lr, weight_decay=1e-4)


def value_and_grad(loss_fn: Callable, params, *batch, **kw):
    """(loss, aux, grads) of loss_fn(params, *batch, **kw): grads is a
    params NamedTuple (None where the field is None; zeros for a field the
    loss does not reach, as JAX gives). loss and aux come back detached."""
    leaves = [None if p is None else p.detach().requires_grad_(True) for p in params]
    with torch.enable_grad():
        loss, aux = loss_fn(type(params)(*leaves), *batch, **kw)
        live = [p for p in leaves if p is not None]
        got = iter(torch.autograd.grad(loss, live, allow_unused=True))
    grads = []
    for p in leaves:
        if p is None:
            grads.append(None)
            continue
        g = next(got)
        grads.append(torch.zeros_like(p) if g is None else g)
    return loss.detach(), tuple(a.detach() for a in aux), type(params)(*grads)


def make_train_step(optimizer: AdamW, loss_fn: Callable):
    """(params, opt_state, batch..., index=None) -> (params, opt_state,
    loss, aux): one grad and one optimizer update. Nothing is synced to the
    host: loss and aux stay device scalars."""

    def train_step(
        params,
        opt_state,
        features,
        src_ep,
        dst_ep,
        edge_mask,
        target_latency,
        target_anomaly,
        node_mask,
        index=None,
    ):
        loss, aux, grads = value_and_grad(
            loss_fn,
            params,
            features,
            src_ep,
            dst_ep,
            edge_mask,
            target_latency,
            target_anomaly,
            node_mask,
            index=index,
        )
        params, opt_state = optimizer.apply(params, grads, opt_state)
        return params, opt_state, loss, aux

    return train_step

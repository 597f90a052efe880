"""Device-resident stacked dataset and fused GraphSAGE epochs.

Counterpart of kmamiz_tpu/models/stacked.py. `stack_dataset` pads a
GraphDataset's slots to power-of-two capacity buckets (node and edge
counts, masked padding) and uploads all of them once as [S, N, ...]
tensors, with one edge index of the fixed edge list per stack (on the
card, with the gather part the backward reads). `epoch_runner` runs whole
epoch blocks: the JAX package's lax.scan over slots inside a scan over
epochs becomes a loop over the device-resident slots with one optimizer
update per slot (the legacy loop's schedule), the block's losses kept on
the device and fetched by the caller once per block: no host sync per
slot. `dp_epoch_runner` averages the weighted grads of a slot microbatch
before one update; with a mesh the batch axis shards over its devices
(parallel/mesh.make_sharded_slot_grad).
`predict_all` runs a head over every stacked slot.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from kmamiz_tpu_torch.core.spans import _pad_size
from kmamiz_tpu_torch.device import DeviceLike, resolve_device
from kmamiz_tpu_torch.models import common
from kmamiz_tpu_torch.ops import sparse


@dataclass
class StackedDataset:
    """All slots of a GraphDataset as bucket-padded device tensors."""

    features: torch.Tensor  # [S, Nb, F] float32
    target_latency: torch.Tensor  # [S, Nb] float32
    target_anomaly: torch.Tensor  # [S, Nb] float32
    node_mask: torch.Tensor  # [S, Nb] bool (False on padded nodes)
    src: torch.Tensor  # [Eb] int32
    dst: torch.Tensor  # [Eb] int32
    edge_mask: torch.Tensor  # [Eb] bool (False on padded edges)
    num_slots: int  # real S
    num_nodes: int  # real N (<= bucket_nodes)
    num_edges: int  # real E (<= bucket_edges)
    bucket_nodes: int
    bucket_edges: int
    index: Optional[sparse.EdgeIndex] = None  # the card's edge index, with its gather part

    def layout(self) -> dict:
        """The shape contract a checkpoint records (and resume validates)."""
        return {
            "bucket_nodes": int(self.bucket_nodes),
            "bucket_edges": int(self.bucket_edges),
            "num_slots": int(self.num_slots),
            "num_nodes": int(self.num_nodes),
        }


def dataset_layout(dataset) -> dict:
    """A GraphDataset's stacked layout without building the stack."""
    n = dataset.num_nodes
    e = int(np.asarray(dataset.src).shape[0])
    return {
        "bucket_nodes": _pad_size(n),
        "bucket_edges": _pad_size(e),
        "num_slots": len(dataset.features),
        "num_nodes": n,
    }


def stack_dataset(dataset, device: DeviceLike = None) -> StackedDataset:
    """GraphDataset (per-slot list layout) -> one stack on `device` (the
    card when None), uploaded once. Memoized on the dataset instance per
    device: repeated train/evaluate/calibrate calls reuse the upload and
    the edge index. Node and edge counts pad to power-of-two buckets with
    False masks, so padded rows contribute nothing."""
    dev = resolve_device(device)
    cached = getattr(dataset, "_stacked_cache", None)
    if (
        cached is not None
        and cached.features.device == dev
        and cached.layout() == dataset_layout(dataset)
    ):
        return cached

    s = len(dataset.features)
    n = dataset.num_nodes
    f = int(np.asarray(dataset.features[0]).shape[1]) if s else 0
    e = int(np.asarray(dataset.src).shape[0])
    nb, eb = _pad_size(n), _pad_size(e)

    feats = np.zeros((s, nb, f), dtype=np.float32)
    t_lat = np.zeros((s, nb), dtype=np.float32)
    t_ano = np.zeros((s, nb), dtype=np.float32)
    n_mask = np.zeros((s, nb), dtype=bool)
    for i in range(s):
        feats[i, :n] = np.asarray(dataset.features[i], dtype=np.float32)
        t_lat[i, :n] = np.asarray(dataset.target_latency[i], dtype=np.float32)
        t_ano[i, :n] = np.asarray(dataset.target_anomaly[i], dtype=np.float32)
        n_mask[i, :n] = np.asarray(dataset.node_mask[i], dtype=bool)

    src = np.zeros(eb, dtype=np.int32)
    dst = np.zeros(eb, dtype=np.int32)
    e_mask = np.zeros(eb, dtype=bool)
    src[:e] = np.asarray(dataset.src, dtype=np.int32)
    dst[:e] = np.asarray(dataset.dst, dtype=np.int32)
    e_mask[:e] = np.asarray(dataset.edge_mask, dtype=bool)

    def put(a):
        return torch.from_numpy(a).to(dev)

    src_t, dst_t, mask_t = put(src), put(dst), put(e_mask)
    stacked = StackedDataset(
        features=put(feats),
        target_latency=put(t_lat),
        target_anomaly=put(t_ano),
        node_mask=put(n_mask),
        src=src_t,
        dst=dst_t,
        edge_mask=mask_t,
        num_slots=s,
        num_nodes=n,
        num_edges=e,
        bucket_nodes=nb,
        bucket_edges=eb,
        # the edge list is fixed for the stack: one index serves every
        # forward and backward of its slots (the CPU's plain version reads none)
        index=(
            sparse.edge_index(src_t, dst_t, mask_t, nb, for_backward=True)
            if dev.type == "cuda"
            else None
        ),
    )
    try:
        dataset._stacked_cache = stacked
    except (AttributeError, TypeError):  # frozen/slotted containers
        pass
    return stacked


# ---------------------------------------------------------------------------
# fused epochs (sequential per-slot schedule, B = 1)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=32)
def epoch_runner(model, lr: float, pos_weight: float):
    """(params, opt_state, stacked tensors, n_epochs, index=None) ->
    (params, opt_state, losses [n_epochs, 3] on the device): one optimizer
    update per slot per epoch, the legacy loop's schedule; an epoch's
    losses are the mean over its slots of (loss, latency, anomaly).
    Memoized per (model, lr, pos_weight)."""
    optimizer = model.make_optimizer(lr)
    loss_fn = common.make_loss_fn(model.forward, pos_weight)

    def run(
        params,
        opt_state,
        features,
        target_latency,
        target_anomaly,
        node_mask,
        src,
        dst,
        edge_mask,
        n_epochs: int,
        index: Optional[sparse.EdgeIndex] = None,
    ):
        epochs = []
        for _ in range(n_epochs):
            per_slot = []
            for f, tl, ta, nm in zip(features, target_latency, target_anomaly, node_mask):
                loss, (lat_l, ano_l), grads = common.value_and_grad(
                    loss_fn, params, f, src, dst, edge_mask, tl, ta, nm, index=index
                )
                params, opt_state = optimizer.apply(params, grads, opt_state)
                per_slot.append(torch.stack([loss, lat_l, ano_l]))
            epochs.append(torch.stack(per_slot).mean(dim=0))
        return params, opt_state, torch.stack(epochs)

    return run


# ---------------------------------------------------------------------------
# data-parallel epochs (slot microbatches, optionally mesh-sharded)
# ---------------------------------------------------------------------------


def batch_slots_arrays(stacked: StackedDataset, batch: int) -> Tuple[torch.Tensor, ...]:
    """Regroup the stacked slot tensors into [n_batches, batch, ...] with a
    per-slot weight tensor ([n_batches, batch], 0.0 on padding slots) so
    the last partial batch contributes only its real slots."""
    s = stacked.num_slots
    nb = -(-s // batch)  # ceil
    pad = nb * batch - s

    def group(a):
        if pad:
            a = torch.cat([a, torch.zeros((pad,) + tuple(a.shape[1:]), dtype=a.dtype, device=a.device)])
        return a.reshape((nb, batch) + tuple(a.shape[1:]))

    dev = stacked.features.device
    weights = torch.cat(
        [torch.ones(s, dtype=torch.float32, device=dev), torch.zeros(pad, dtype=torch.float32, device=dev)]
    ).reshape(nb, batch)
    return (
        group(stacked.features),
        group(stacked.target_latency),
        group(stacked.target_anomaly),
        group(stacked.node_mask),
        weights,
    )


def _local_batch_grads(loss_fn):
    """One device's batch grads: each slot's grads weighted by its slot
    weight, summed in slot order, over the batch's weight total."""

    def batch_grads(params, feats, tl, ta, nm, src, dst, em, w, index=None):
        grads = None
        totals = torch.zeros(3, dtype=torch.float32, device=w.device)
        for f, lt, at, m, wi in zip(feats, tl, ta, nm, w):
            loss, (lat_l, ano_l), g = common.value_and_grad(
                loss_fn, params, f, src, dst, em, lt, at, m, index=index
            )
            g = [None if x is None else x * wi for x in g]
            grads = g if grads is None else [None if a is None else a + b for a, b in zip(grads, g)]
            totals = totals + torch.stack([loss, lat_l, ano_l]) * wi
        wsum = torch.clamp(w.sum(), min=1.0)
        return type(params)(*(None if x is None else x / wsum for x in grads)), totals / wsum

    return batch_grads


@functools.lru_cache(maxsize=32)
def dp_epoch_runner(model, lr: float, pos_weight: float, mesh=None, axis: str = "slots"):
    """Epochs over slot microbatches: the grads of a batch's slots are
    weighted by slot weight and averaged before ONE optimizer update
    (minibatch SGD over slots).

    With `mesh`, the batch axis shards over the devices of its `axis` and
    the grads merge onto the params' device
    (parallel/mesh.make_sharded_slot_grad); params stay replicated, so the
    update is the unsharded microbatch's up to the float order of the sums
    (tests/test_torch_parallel.py holds it to the per-slot loop)."""
    optimizer = model.make_optimizer(lr)
    loss_fn = common.make_loss_fn(model.forward, pos_weight)
    if mesh is not None:
        from kmamiz_tpu_torch.parallel.mesh import make_sharded_slot_grad

        batch_grads = make_sharded_slot_grad(mesh, loss_fn, axis=axis)
    else:
        batch_grads = _local_batch_grads(loss_fn)

    def run(
        params,
        opt_state,
        b_features,  # [n_batches, B, Nb, F]
        b_target_latency,
        b_target_anomaly,
        b_node_mask,
        b_weights,  # [n_batches, B]
        src,
        dst,
        edge_mask,
        n_epochs: int,
        index: Optional[sparse.EdgeIndex] = None,
    ):
        epochs = []
        for _ in range(n_epochs):
            per_batch = []
            for f, tl, ta, nm, w in zip(
                b_features, b_target_latency, b_target_anomaly, b_node_mask, b_weights
            ):
                g, losses = batch_grads(params, f, tl, ta, nm, src, dst, edge_mask, w, index)
                params, opt_state = optimizer.apply(params, g, opt_state)
                per_batch.append(losses * w.sum())
            # slot-weighted epoch mean: partial final batches count only
            # their real slots
            epochs.append(torch.stack(per_batch).sum(dim=0) / torch.clamp(b_weights.sum(), min=1.0))
        return params, opt_state, torch.stack(epochs)

    return run


# ---------------------------------------------------------------------------
# batched evaluation forward
# ---------------------------------------------------------------------------


def predict_all(params, dataset, model) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """The head's forward over every slot of the dataset, stacked on the
    params' device -> (pred_latency [S, N], anomaly_logits [S, N]) as host
    arrays sliced back to the real node count, fetched in one copy. None
    for an empty dataset."""
    if not len(dataset.features):
        return None
    device = next(p for p in params if p is not None).device
    st = stack_dataset(dataset, device)
    with torch.no_grad():
        outs = [
            torch.stack(model.forward(params, f, st.src, st.dst, st.edge_mask, index=st.index))
            for f in st.features
        ]
        out = torch.stack(outs).cpu().numpy()  # [S, 2, Nb]
    n = st.num_nodes
    return out[:, 0, :n], out[:, 1, :n]

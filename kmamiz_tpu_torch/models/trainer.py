"""GraphSAGE training pipeline over hourly slots.

Counterpart of kmamiz_tpu/models/trainer.py. Each hourly slot becomes one
training example: per-endpoint features from that slot's combined
realtime data, targets from the NEXT slot (log-latency regression and
anomaly classification); the 2-layer GraphSAGE head (or, with
model=gat, the GAT head) trains full-graph with the family's AdamW. Anomaly ground truth is derived from the data
(next-slot 5xx share above a threshold), so no manual labels are needed.

The dataset lives on the host (numpy); `train` stacks it on its device
once (models/stacked.py) and runs epoch blocks there, or, with
fused=False (KMAMIZ_SAGE_FUSED=0), the legacy per-slot loop.
`train_on_simulation` builds the dataset from the simulator's output and
trains, calibrates and evaluates on one device.
"""
from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import torch

from kmamiz_tpu_torch.device import DeviceLike, resolve_device
from kmamiz_tpu_torch.models import graphsage
from kmamiz_tpu_torch.models import stacked as stacked_mod
from kmamiz_tpu_torch.models.history import ANOMALY_ERROR_SHARE, SLOT_SECONDS
from kmamiz_tpu_torch.ops import sparse
from kmamiz_tpu_torch.simulator.naming import extract_unique_service_name
from kmamiz_tpu_torch.simulator.slot_metrics import parse_slot_key

logger = logging.getLogger("kmamiz_tpu_torch.models.trainer")

@dataclass
class GraphDataset:
    """Per-slot full-graph examples over a fixed endpoint set (host numpy)."""

    endpoint_names: List[str]
    src: np.ndarray  # [E] int32 distance-1 edges
    dst: np.ndarray  # [E] int32
    edge_mask: np.ndarray  # [E] bool
    features: List[np.ndarray]  # per slot [N, F] float32
    target_latency: List[np.ndarray]  # per slot [N] (log1p ms, next slot)
    target_anomaly: List[np.ndarray]  # per slot [N] {0,1} (next slot)
    node_mask: List[np.ndarray]  # per slot [N] endpoints active next slot
    slot_keys: List[str] = field(default_factory=list)

    @property
    def num_nodes(self) -> int:
        return len(self.endpoint_names)


def _slot_order(keys) -> List[str]:
    return sorted(keys, key=parse_slot_key)


def _per_slot_stats(rows: List[dict], index: Dict[str, int], n: int) -> Tuple[np.ndarray, ...]:
    """rows of TCombinedRealtimeData -> per-endpoint (count, err4xx,
    err5xx, latency_mean, latency_cv, active)."""
    count = np.zeros(n, dtype=np.float64)
    err4 = np.zeros(n, dtype=np.float64)
    err5 = np.zeros(n, dtype=np.float64)
    lat_weighted = np.zeros(n, dtype=np.float64)
    cv_weighted = np.zeros(n, dtype=np.float64)
    for row in rows:
        i = index.get(row["uniqueEndpointName"])
        if i is None:
            continue
        c = float(row["combined"])
        count[i] += c
        status = str(row["status"])
        if status.startswith("4"):
            err4[i] += c
        elif status.startswith("5"):
            err5[i] += c
        lat_weighted[i] += c * float(row["latency"].get("mean") or 0.0)
        cv_weighted[i] += c * float(row["latency"].get("cv") or 0.0)
    safe = np.maximum(count, 1.0)
    return count, err4, err5, lat_weighted / safe, cv_weighted / safe, count > 0


def dataset_from_simulation(
    endpoint_dependencies: List[dict],
    realtime_data_per_slot: Dict[str, List[dict]],
    replica_counts: List[dict],
) -> GraphDataset:
    """SimulationResult pieces -> consecutive-slot (features, next-slot
    targets) examples over the distance-1 dependency graph."""
    names = sorted({dep["endpoint"]["uniqueEndpointName"] for dep in endpoint_dependencies})
    index = {name: i for i, name in enumerate(names)}
    n = len(names)

    src_list, dst_list = [], []
    for dep in endpoint_dependencies:
        a = index[dep["endpoint"]["uniqueEndpointName"]]
        for d in dep.get("dependingOn", []):
            if d.get("distance") == 1:
                b = index.get(d["endpoint"]["uniqueEndpointName"])
                if b is not None:
                    src_list.append(a)
                    dst_list.append(b)
    if not src_list:  # keep shapes non-empty
        src_list, dst_list = [0], [0]
        edge_mask = np.zeros(1, dtype=bool)
    else:
        edge_mask = np.ones(len(src_list), dtype=bool)

    replicas = np.ones(n, dtype=np.float32)
    service_replicas = {r["uniqueServiceName"]: float(r["replicas"]) for r in replica_counts}
    for name, i in index.items():
        replicas[i] = service_replicas.get(extract_unique_service_name(name), 1.0)

    order = _slot_order(realtime_data_per_slot)
    per_slot = [_per_slot_stats(realtime_data_per_slot[key], index, n) for key in order]

    dataset = GraphDataset(
        endpoint_names=names,
        src=np.asarray(src_list, dtype=np.int32),
        dst=np.asarray(dst_list, dtype=np.int32),
        edge_mask=edge_mask,
        features=[],
        target_latency=[],
        target_anomaly=[],
        node_mask=[],
        slot_keys=[],
    )

    for t in range(len(order) - 1):
        count, err4, err5, lat, cv, active = per_slot[t]
        n_count, _n_err4, n_err5, n_lat, _n_cv, n_active = per_slot[t + 1]
        # hour-of-day of the PREDICTED slot: recurring operational faults
        # are periodic, and the persistence baseline is blind to them
        _, next_hour, _ = parse_slot_key(order[t + 1])
        features = graphsage.assemble_features(
            count / SLOT_SECONDS,
            err4 / np.maximum(count, 1.0),
            err5 / np.maximum(count, 1.0),
            np.log1p(lat),  # same space as the regression target
            cv,
            replicas,
            np.log1p(count),
            active,
            hour_of_day=float(next_hour),
        )
        err_share_next = n_err5 / np.maximum(n_count, 1.0)
        dataset.features.append(features)
        dataset.target_latency.append(np.log1p(n_lat).astype(np.float32))
        dataset.target_anomaly.append((err_share_next > ANOMALY_ERROR_SHARE).astype(np.float32))
        dataset.node_mask.append(np.asarray(n_active))
        dataset.slot_keys.append(order[t])
    return dataset


@dataclass
class TrainResult:
    params: graphsage.SageParams
    losses: List[float]
    latency_losses: List[float]
    anomaly_losses: List[float]


def _epoch_blocks(start: int, total: int, every: int) -> List[Tuple[int, int]]:
    """Epoch ranges between checkpoint boundaries: [start, total) cut at
    multiples of `every` (every <= 0: one block). A resumed run replays the
    block sequence a fresh run would from that epoch: bit-exact resume."""
    blocks = []
    e = start
    while e < total:
        nxt = min((e // every + 1) * every, total) if every > 0 else total
        blocks.append((e, nxt))
        e = nxt
    return blocks


def train(
    dataset: GraphDataset,
    epochs: int = 30,
    hidden: int = 32,
    lr: float = 1e-2,
    seed: int = 0,
    checkpoint_dir: str = "",
    checkpoint_every: int = 10,
    model=graphsage,
    use_node_embeddings: bool = False,
    fused: bool = None,
    batch_slots: int = 1,
    mesh=None,
    device: DeviceLike = None,
) -> TrainResult:
    """Full-graph training on `device` (the card when None), one step per
    slot per epoch.

    fused (default on; KMAMIZ_SAGE_FUSED=0 or fused=False for the legacy
    host loop) stacks the dataset on the device once and runs epoch blocks
    with the block's losses fetched once per block; the per-slot update
    schedule is the legacy loop's. batch_slots > 1 switches to slot
    minibatches (one averaged update per batch); with `mesh`
    (parallel/mesh.py) the minibatch also shards over the mesh's devices,
    at least one slot each (batch = max(batch_slots, the mesh axis)).

    With checkpoint_dir set, training resumes from the latest complete
    step and snapshots every checkpoint_every epochs (0 = only at the
    end) plus at the end. Resuming validates the saved hyperparameters
    and the saved stacked layout against the requested ones."""
    from kmamiz_tpu_torch.models import checkpoint as ckpt

    dev = resolve_device(device)
    if fused is None:
        fused = os.environ.get("KMAMIZ_SAGE_FUSED", "1") not in ("0", "off", "false")

    # node-identity embeddings are opt-in (they overfit small meshes)
    num_nodes = dataset.num_nodes if (use_node_embeddings and dataset is not None) else 0
    # feature width comes from the data: history-augmented datasets carry
    # extra identity-free columns beyond the base layout
    num_features = (
        int(np.asarray(dataset.features[0]).shape[1])
        if dataset is not None and dataset.features
        else model.NUM_FEATURES
    )
    params = model.init_params(
        torch.Generator().manual_seed(seed),
        hidden=hidden,
        num_features=num_features,
        num_nodes=num_nodes,
        device=dev,
    )
    optimizer = model.make_optimizer(lr)
    opt_state = optimizer.init(params)
    model_name = model.__name__.rsplit(".", 1)[-1]

    start_epoch = 0
    if checkpoint_dir:
        # resolve the resume step once; an incomplete save (archive
        # without sidecar) falls back to the previous complete step
        resume_step = ckpt.latest_complete_step(checkpoint_dir)
        if resume_step is None and ckpt.latest_step(checkpoint_dir) is not None:
            logger.warning(
                "checkpoint dir %s has only incomplete saves; starting fresh", checkpoint_dir
            )
        if resume_step is not None:
            meta = ckpt.load_metadata(checkpoint_dir, resume_step) or {}
            if meta.get("num_features") is None:
                raise ValueError(
                    f"checkpoint {checkpoint_dir} step {resume_step} was "
                    "saved before the 10-feature layout (no num_features in "
                    "metadata) and cannot restore into the current model; "
                    "delete the directory or retrain"
                )
            for name, want in (
                ("hidden", hidden),
                ("lr", lr),
                ("seed", seed),
                ("model", model_name),
                ("num_features", num_features),
                ("num_nodes", num_nodes),
            ):
                saved = meta.get(name)
                if saved is None:
                    raise ValueError(
                        f"checkpoint {checkpoint_dir} step {resume_step} "
                        f"metadata lacks '{name}'; was it saved outside "
                        "trainer.train()?"
                    )
                if saved != want:
                    raise ValueError(
                        f"checkpoint {checkpoint_dir} was trained with "
                        f"{name}={saved}, requested {name}={want}"
                    )
            # the stacked layout is part of the training schedule
            saved_layout = meta.get("stacked")
            if saved_layout is not None and dataset is not None:
                current_layout = stacked_mod.dataset_layout(dataset)
                if dict(saved_layout) != current_layout:
                    raise ValueError(
                        f"checkpoint {checkpoint_dir} step {resume_step} was "
                        f"saved with stacked layout {dict(saved_layout)} but "
                        f"the dataset stacks to {current_layout}; resume "
                        "needs the same node/edge buckets and slot count "
                        "(retrain, or rebuild the matching dataset)"
                    )
            restored = ckpt.restore_checkpoint(checkpoint_dir, params, opt_state, step=resume_step)
            if restored is not None:
                params, opt_state, meta = restored
                start_epoch = int(meta.get("step", 0))

    # balance the rare positive class: the inverse base rate of the
    # training slots, clipped (1.0 when no positives exist)
    pos = sum(
        float((np.asarray(a) * np.asarray(m)).sum())
        for a, m in zip(dataset.target_anomaly, dataset.node_mask)
    )
    tot = sum(float(np.asarray(m).sum()) for m in dataset.node_mask)
    base_rate = pos / tot if tot else 0.0
    pos_weight = float(np.clip(1.0 / base_rate, 1.0, 20.0)) if base_rate else 1.0

    def metadata(last_loss):
        return {
            "loss": last_loss,
            "hidden": hidden,
            "lr": lr,
            "seed": seed,
            "model": model_name,
            "num_features": num_features,
            "num_nodes": num_nodes,
            "stacked": stacked_mod.dataset_layout(dataset),
        }

    losses, lat_losses, ano_losses = [], [], []
    if fused and dataset.features:
        st = stacked_mod.stack_dataset(dataset, dev)
        edges = (st.src, st.dst, st.edge_mask)
        if batch_slots > 1 or mesh is not None:
            axis = mesh.axis_names[0] if mesh is not None else "slots"
            batch = max(batch_slots, mesh.shape[axis] if mesh is not None else 1)
            runner = stacked_mod.dp_epoch_runner(model, lr, pos_weight, mesh=mesh, axis=axis)
            batched = stacked_mod.batch_slots_arrays(st, batch)

            def run_block(p, s, n_ep):
                return runner(p, s, *batched, *edges, n_ep, index=st.index)

        else:
            runner = stacked_mod.epoch_runner(model, lr, pos_weight)
            slots = (st.features, st.target_latency, st.target_anomaly, st.node_mask)

            def run_block(p, s, n_ep):
                return runner(p, s, *slots, *edges, n_ep, index=st.index)

        save_every = checkpoint_every if checkpoint_dir else 0
        for e0, e1 in _epoch_blocks(start_epoch, epochs, save_every):
            params, opt_state, block = run_block(params, opt_state, e1 - e0)
            block = block.cpu().numpy().astype(np.float64)  # [e1-e0, 3], one fetch per block
            losses.extend(block[:, 0].tolist())
            lat_losses.extend(block[:, 1].tolist())
            ano_losses.extend(block[:, 2].tolist())
            if checkpoint_dir:
                ckpt.save_checkpoint(
                    checkpoint_dir, params, opt_state, step=e1, metadata=metadata(losses[-1])
                )
        return TrainResult(params, losses, lat_losses, ano_losses)

    step = model.make_train_step(optimizer, pos_weight=pos_weight)

    def put(a):
        return torch.from_numpy(np.asarray(a)).to(dev)

    # the edge list is fixed for the dataset: uploaded and indexed once
    src, dst, em = put(dataset.src), put(dataset.dst), put(dataset.edge_mask)
    n_rows = dataset.num_nodes
    index = sparse.edge_index(src, dst, em, n_rows, for_backward=True) if dev.type == "cuda" else None
    for epoch in range(start_epoch, epochs):
        epoch_loss = epoch_lat = epoch_ano = 0.0
        for i in range(len(dataset.features)):
            params, opt_state, loss, (lat_l, ano_l) = step(
                params,
                opt_state,
                put(dataset.features[i]),
                src,
                dst,
                em,
                put(dataset.target_latency[i]),
                put(dataset.target_anomaly[i]),
                put(dataset.node_mask[i]),
                index=index,
            )
            epoch_loss += float(loss)
            epoch_lat += float(lat_l)
            epoch_ano += float(ano_l)
        slots = max(len(dataset.features), 1)
        losses.append(epoch_loss / slots)
        lat_losses.append(epoch_lat / slots)
        ano_losses.append(epoch_ano / slots)
        if checkpoint_dir and (
            (checkpoint_every > 0 and (epoch + 1) % checkpoint_every == 0) or epoch + 1 == epochs
        ):
            ckpt.save_checkpoint(
                checkpoint_dir, params, opt_state, step=epoch + 1, metadata=metadata(losses[-1])
            )
    return TrainResult(params, losses, lat_losses, ano_losses)


@dataclass
class EvalResult:
    latency_mse: float
    anomaly_accuracy: float
    anomaly_precision: float
    anomaly_recall: float
    anomaly_base_rate: float
    per_slot_flagged: Dict[str, List[str]]  # slotKey -> flagged endpoints
    in_sample: bool = False  # True when evaluated on the training slots
    anomaly_f1: float = 0.0
    latency_mae_ms: float = 0.0  # mean |expm1(pred) - expm1(target)| in ms
    threshold: float = 0.5  # decision threshold (train-set calibrated)


def _score_predictions(dataset, predict) -> EvalResult:
    """Shared metric accumulation: `predict(i) -> (latency_log1p [N],
    anomaly_pos bool [N])` per slot."""
    tp = fp = fn = tn = 0
    sq_err_sum = 0.0
    abs_ms_sum = 0.0
    weight_sum = 0.0
    positives = 0
    total = 0
    flagged: Dict[str, List[str]] = {}
    for i in range(len(dataset.features)):
        pred_latency, pred_pos_raw = predict(i)
        mask = np.asarray(dataset.node_mask[i])
        pred_pos = np.asarray(pred_pos_raw) & mask
        truth = np.asarray(dataset.target_anomaly[i]).astype(bool) & mask

        tp += int((pred_pos & truth).sum())
        fp += int((pred_pos & ~truth).sum())
        fn += int((~pred_pos & truth).sum())
        tn += int((~pred_pos & ~truth & mask).sum())
        positives += int(truth.sum())
        total += int(mask.sum())

        pred_log = np.asarray(pred_latency)
        target_log = np.asarray(dataset.target_latency[i])
        err = pred_log - target_log
        sq_err_sum += float((mask * err**2).sum())
        abs_ms_sum += float((mask * np.abs(np.expm1(pred_log) - np.expm1(target_log))).sum())
        weight_sum += float(mask.sum())

        names = [dataset.endpoint_names[j] for j in np.flatnonzero(pred_pos)]
        if names:
            flagged[dataset.slot_keys[i]] = names

    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    return EvalResult(
        latency_mse=sq_err_sum / max(weight_sum, 1.0),
        anomaly_accuracy=(tp + tn) / max(total, 1),
        anomaly_precision=precision,
        anomaly_recall=recall,
        anomaly_base_rate=positives / max(total, 1),
        per_slot_flagged=flagged,
        anomaly_f1=(
            2 * precision * recall / (precision + recall) if precision + recall else 0.0
        ),
        latency_mae_ms=abs_ms_sum / max(weight_sum, 1.0),
    )


def _sigmoid(logits: np.ndarray) -> np.ndarray:
    return torch.sigmoid(torch.from_numpy(np.asarray(logits, dtype=np.float32))).numpy()


def evaluate(params, dataset: GraphDataset, threshold: float = 0.5, model=graphsage) -> EvalResult:
    """Every slot's forward over the stacked dataset on the params'
    device, fetched once (models/stacked.predict_all), then scored."""
    preds = stacked_mod.predict_all(params, dataset, model)
    if preds is not None:
        latencies, logits = preds
        probs = _sigmoid(logits)

    def predict(i):
        return latencies[i], probs[i] > threshold

    result = _score_predictions(dataset, predict)
    result.threshold = threshold
    return result


def evaluate_baseline(dataset: GraphDataset) -> EvalResult:
    """Persistence baseline the heads must beat: next-slot anomaly =
    current-slot 5xx share above the labelling threshold (feature col 2);
    next-slot latency = current-slot latency mean (feature col 3)."""

    def predict(i):
        feats = np.asarray(dataset.features[i])
        return feats[:, 3], feats[:, 2] > ANOMALY_ERROR_SHARE

    return _score_predictions(dataset, predict)


def evaluate_naive(dataset: GraphDataset, rate: float = 0.0, seed: int = 0) -> EvalResult:
    """Truly naive baselines: flag nothing (rate=0), everything (rate=1),
    or random at `rate`; latency = the dataset's global mean target."""
    rng = np.random.default_rng(seed)
    all_targets = (
        np.concatenate(
            [
                np.asarray(t)[np.asarray(m).astype(bool)]
                for t, m in zip(dataset.target_latency, dataset.node_mask)
            ]
        )
        if dataset.features
        else np.zeros(1)
    )
    mean_latency = float(all_targets.mean()) if all_targets.size else 0.0

    def predict(i):
        n = np.asarray(dataset.features[i]).shape[0]
        if rate <= 0:
            flags = np.zeros(n, dtype=bool)
        elif rate >= 1:
            flags = np.ones(n, dtype=bool)
        else:
            flags = rng.random(n) < rate
        return np.full(n, mean_latency, dtype=np.float32), flags

    return _score_predictions(dataset, predict)


def temporal_split(
    dataset: GraphDataset, train_fraction: float = 0.75
) -> Tuple[GraphDataset, GraphDataset]:
    """First-slots train set / remaining-slots eval set."""
    cut = max(1, int(len(dataset.features) * train_fraction))

    def subset(lo, hi):
        return GraphDataset(
            endpoint_names=dataset.endpoint_names,
            src=dataset.src,
            dst=dataset.dst,
            edge_mask=dataset.edge_mask,
            features=dataset.features[lo:hi],
            target_latency=dataset.target_latency[lo:hi],
            target_anomaly=dataset.target_anomaly[lo:hi],
            node_mask=dataset.node_mask[lo:hi],
            slot_keys=dataset.slot_keys[lo:hi],
        )

    return subset(0, cut), subset(cut, None)


def train_on_simulation(
    endpoint_dependencies: List[dict],
    realtime_data_per_slot: Dict[str, List[dict]],
    replica_counts: List[dict],
    train_fraction: float = 0.75,
    epochs: int = 30,
    hidden: int = 32,
    seed: int = 0,
    model=graphsage,
    use_node_embeddings: bool = False,
    device: DeviceLike = None,
) -> Tuple[TrainResult, EvalResult, GraphDataset]:
    """Temporal split: train on the first slots, evaluate on the rest
    (fault windows land wherever the config put them). Training,
    calibration and evaluation run on `device` (the card when None)."""
    dataset = dataset_from_simulation(endpoint_dependencies, realtime_data_per_slot, replica_counts)
    train_set, eval_set = temporal_split(dataset, train_fraction)
    result = train(
        train_set,
        epochs=epochs,
        hidden=hidden,
        seed=seed,
        model=model,
        use_node_embeddings=use_node_embeddings,
        device=device,
    )
    threshold = calibrate_threshold(result.params, train_set, model=model)
    if eval_set.features:
        metrics = evaluate(result.params, eval_set, threshold=threshold, model=model)
    else:  # nothing held out: report train-set metrics, explicitly marked
        metrics = evaluate(result.params, train_set, threshold=threshold, model=model)
        metrics.in_sample = True
    metrics.threshold = threshold
    return result, metrics, dataset


def calibrate_threshold(params, dataset: GraphDataset, model=graphsage, grid=None) -> float:
    """The decision threshold maximising F1 on the TRAINING slots; 0.5
    when no threshold achieves positive F1. Forwards run once; only the
    thresholding sweeps."""
    if grid is None:
        grid = [i / 20 for i in range(1, 20)]
    preds = stacked_mod.predict_all(params, dataset, model)
    if preds is None:
        return 0.5
    probs = _sigmoid(preds[1])  # [S, N]
    best_t, best_f1 = 0.5, 0.0
    for t in grid:
        tp = fp = fn = 0
        for i, prob in enumerate(probs):
            mask = np.asarray(dataset.node_mask[i]).astype(bool)
            pred = (prob > t) & mask
            truth = np.asarray(dataset.target_anomaly[i]).astype(bool) & mask
            tp += int((pred & truth).sum())
            fp += int((pred & ~truth).sum())
            fn += int((~pred & truth).sum())
        precision = tp / max(tp + fp, 1)
        recall = tp / max(tp + fn, 1)
        f1 = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
        if f1 > best_f1:
            best_t, best_f1 = t, f1
    return best_t

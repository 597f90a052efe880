"""Model-head evaluation at BASELINE.json scale, over the port.

Counterpart of the repo's tools/eval_models_large.py: generates a layered
MicroViSim mesh (default 100 services / 1k endpoints, BASELINE config 3)
with a rich programmatic fault schedule (recurring nightly windows,
overlapping multi-endpoint incidents, probabilistic windows, and gateway
traffic bursts that push services into overload), then trains and
evaluates the GraphSAGE and GAT heads on ``--device`` (the card when not
given; without one the tool raises) against the persistence skyline and
naive baselines. The flags, tables and lines are the JAX tool's.

Beyond thresholded P/R/F1 this reports threshold-free ROC-AUC and PR-AUC
and ONSET recall: the fraction of fault-window FIRST slots (next slot
anomalous, current slot clean) the model flags. Persistence scores 0
there by construction; onset detection is precisely what a forecaster
adds over "alert when it's already broken".

Usage:
  python -m kmamiz_tpu_torch.tools.eval_models_large            # 1k ep
  python -m kmamiz_tpu_torch.tools.eval_models_large --services 10
  python -m kmamiz_tpu_torch.tools.eval_models_large --tenk     # wall-clock
  python -m kmamiz_tpu_torch.tools.eval_models_large --inductive --checkpoint-dir DIR
  (each with --device cpu to run on the CPU)

The transductive and inductive protocols are functions of the parsed
flags and a simulation (`transductive_eval`, `inductive_eval`), so that a
caller that already holds a simulation scores it without simulating again;
their `on_head` hook sees each trained head.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, List, Optional

import numpy as np
import torch
import yaml

from kmamiz_tpu_torch.device import resolve_device

TRAIN_FRACTION = 0.75  # the one split definition, passed everywhere

#: on_head(label, model, TrainResult, EvalResult, scored dataset), called
#: after each head is trained and scored
HeadHook = Callable[[str, object, object, object, object], None]


def make_mesh_config(
    n_services: int,
    eps_per_service: int,
    days: int,
    rng: np.random.Generator,
    fault_fraction: float = 0.08,
) -> str:
    """Layered mesh: gateway tier (external traffic) -> mid tiers -> leaf
    tier; each endpoint depends on 1-3 endpoints one tier deeper."""
    n_gw = max(1, n_services // 20)
    n_leaf = max(1, int(n_services * 0.3))
    n_mid = max(1, n_services - n_gw - n_leaf)
    tiers = (
        [0] * n_gw + [1] * (n_mid // 2) + [2] * (n_mid - n_mid // 2) + [3] * n_leaf
    )

    services = []
    ep_ids: list[list[str]] = [[] for _ in range(4)]
    for s in range(n_services):
        tier = tiers[s]
        endpoints = []
        for e in range(eps_per_service):
            eid = f"s{s}-e{e}"
            ep_ids[tier].append(eid)
            endpoints.append(
                {
                    "endpointId": eid,
                    "endpointInfo": {
                        "path": f"/api/s{s}/op{e}",
                        "method": "post" if e % 3 == 0 else "get",
                    },
                }
            )
        services.append(
            {
                "serviceName": f"svc{s}",
                "versions": [
                    {
                        "version": "v1",
                        "replica": int(rng.integers(1, 4)),
                        "endpoints": endpoints,
                    }
                ],
            }
        )

    dependencies = []
    for tier in range(4):
        deeper = ep_ids[tier + 1] if tier < 3 else []
        for eid in ep_ids[tier]:
            entry: dict = {"endpointId": eid}
            if tier == 0:
                entry["isExternal"] = True
            if deeper:
                k = int(rng.integers(1, min(3, len(deeper)) + 1))
                picks = rng.choice(len(deeper), size=k, replace=False)
                entry["dependOn"] = [
                    {"endpointId": deeper[int(p)]} for p in picks
                ]
            if "dependOn" in entry or entry.get("isExternal"):
                dependencies.append(entry)

    tier_latency = [25, 15, 10, 5]
    endpoint_metrics = []
    for tier in range(4):
        for eid in ep_ids[tier]:
            m = {
                "endpointId": eid,
                "delay": {
                    "latencyMs": tier_latency[tier] + int(rng.integers(0, 6)),
                    "jitterMs": 2 + int(rng.integers(0, 4)),
                },
                "errorRatePercent": 1,
            }
            if tier == 0:
                m["expectedExternalDailyRequestCount"] = 4800
            endpoint_metrics.append(m)

    # -- fault schedule -------------------------------------------------------
    all_eps = [e for t in ep_ids for e in t]
    n_faulty = max(3, int(len(all_eps) * fault_fraction))
    faulty = [all_eps[int(i)] for i in rng.choice(len(all_eps), n_faulty, False)]
    third = max(1, n_faulty // 3)
    faults = []

    def window(day, hour, dur, prob=100):
        return {
            "startTime": {"day": day, "hour": hour},
            "durationHours": dur,
            "probabilityPercent": prob,
        }

    # (a) recurring nightly error windows — periodic, learnable, invisible
    # to persistence at onset
    for eid in faulty[:third]:
        hour = int(rng.integers(1, 20))
        faults.append(
            {
                "type": "increase-error-rate",
                "targets": {"services": [], "endpoints": [{"endpointId": eid}]},
                "timePeriods": [window(d, hour, 3) for d in range(1, days + 1)],
                "increaseErrorRatePercent": int(rng.integers(50, 85)),
            }
        )
    # (b) overlapping multi-endpoint incidents: one window, several
    # endpoints at once (correlated failures along the graph)
    incident_eps = faulty[third : 2 * third]
    for i in range(0, len(incident_eps), 3):
        group = incident_eps[i : i + 3]
        day = int(rng.integers(1, days + 1))
        hour = int(rng.integers(0, 20))
        faults.append(
            {
                "type": "increase-error-rate",
                "targets": {
                    "services": [],
                    "endpoints": [{"endpointId": e} for e in group],
                },
                "timePeriods": [window(day, hour, int(rng.integers(2, 5)))],
                "increaseErrorRatePercent": int(rng.integers(50, 80)),
            }
        )
    # (c) probabilistic recurring latency faults (drifting severity)
    for eid in faulty[2 * third :]:
        hour = int(rng.integers(0, 20))
        faults.append(
            {
                "type": "increase-latency",
                "targets": {"services": [], "endpoints": [{"endpointId": eid}]},
                "timePeriods": [
                    window(d, hour, 2, prob=70) for d in range(1, days + 1)
                ],
                "increaseLatencyMs": int(rng.integers(150, 400)),
            }
        )
    # (d) gateway traffic bursts -> overload errors downstream
    for eid in ep_ids[0][: max(1, len(ep_ids[0]) // 4)]:
        day = int(rng.integers(1, days + 1))
        faults.append(
            {
                "type": "inject-traffic",
                "targets": {"services": [], "endpoints": [{"endpointId": eid}]},
                "timePeriods": [window(day, int(rng.integers(8, 16)), 2)],
                "increaseRequestCount": 4000,
            }
        )

    config = {
        "servicesInfo": [{"namespace": "mesh", "services": services}],
        "endpointDependencies": dependencies,
        "loadSimulation": {
            "config": {
                "simulationDurationInDays": days,
                "overloadErrorRateIncreaseFactor": 3,
            },
            "serviceMetrics": [],
            "endpointMetrics": endpoint_metrics,
            "faultInjection": faults,
        },
    }
    return yaml.safe_dump(config, sort_keys=False)


# -- threshold-free + onset metrics -----------------------------------------


def collect_scores(params, dataset, model):
    """(probabilities, truths, onsets, currents) over every slot's masked
    endpoints: the head's forward per slot on the params' device
    (models/stacked.predict_all, one fetch), the sigmoid on the host."""
    from kmamiz_tpu_torch.models.stacked import predict_all
    from kmamiz_tpu_torch.models.trainer import ANOMALY_ERROR_SHARE

    _lat, logits = predict_all(params, dataset, model)
    all_probs = torch.sigmoid(torch.from_numpy(logits)).numpy()
    probs, truths, onsets, currents = [], [], [], []
    for i in range(len(dataset.features)):
        mask = np.asarray(dataset.node_mask[i]).astype(bool)
        prob = all_probs[i]
        truth = np.asarray(dataset.target_anomaly[i]).astype(bool)
        # onset: the predicted slot is anomalous while the CURRENT slot is
        # still clean (feature col 2 = current 5xx share)
        current_bad = np.asarray(dataset.features[i])[:, 2] > ANOMALY_ERROR_SHARE
        probs.append(prob[mask])
        truths.append(truth[mask])
        onsets.append((truth & ~current_bad)[mask])
        currents.append(current_bad[mask])
    return (
        np.concatenate(probs),
        np.concatenate(truths),
        np.concatenate(onsets),
        np.concatenate(currents),
    )


def roc_auc(scores: np.ndarray, labels: np.ndarray) -> float:
    pos = scores[labels]
    neg = scores[~labels]
    if not len(pos) or not len(neg):
        return float("nan")
    # midranks for ties
    allv = np.concatenate([pos, neg])
    sorted_v = np.sort(allv)
    uniq, first = np.unique(sorted_v, return_index=True)
    counts = np.diff(np.append(first, len(sorted_v)))
    mid = {v: f + (c + 1) / 2 for v, f, c in zip(uniq, first, counts)}
    r_pos = np.array([mid[v] for v in pos])
    u = r_pos.sum() - len(pos) * (len(pos) + 1) / 2
    return float(u / (len(pos) * len(neg)))


def pr_auc(scores: np.ndarray, labels: np.ndarray) -> float:
    if not labels.any():
        return float("nan")
    order = np.argsort(-scores, kind="mergesort")
    sorted_labels = labels[order]
    tp = np.cumsum(sorted_labels)
    precision = tp / np.arange(1, len(sorted_labels) + 1)
    recall = tp / labels.sum()
    # average precision (step-wise integral)
    return float(np.sum(precision[sorted_labels.astype(bool)]) / labels.sum())


def onset_recall(scores, truths, onsets, threshold) -> float:
    n_onset = int(onsets.sum())
    if not n_onset:
        return float("nan")
    return float(((scores > threshold) & onsets).sum() / n_onset)


def _persistence_rows(eval_set):
    """(scores, truths, onsets) for the threshold-free persistence
    skyline over an eval set (node_mask-respecting)."""
    from kmamiz_tpu_torch.models.trainer import ANOMALY_ERROR_SHARE

    p_scores, p_truths, p_onsets = [], [], []
    for i in range(len(eval_set.features)):
        mask = np.asarray(eval_set.node_mask[i]).astype(bool)
        feats = np.asarray(eval_set.features[i])
        truth = np.asarray(eval_set.target_anomaly[i]).astype(bool)
        current_bad = feats[:, 2] > ANOMALY_ERROR_SHARE
        p_scores.append(feats[:, 2][mask])
        p_truths.append(truth[mask])
        p_onsets.append((truth & ~current_bad)[mask])
    return (
        np.concatenate(p_scores),
        np.concatenate(p_truths),
        np.concatenate(p_onsets),
    )


def _hybrid_row(name, metrics, scores, truths, onsets, currents, threshold,
                train_s):
    """persistence ("already broken") UNION the head's forecast ("about
    to break"): the operational pager policy; it can only add the
    model's true onsets (plus its false alarms) on top of the skyline."""
    from kmamiz_tpu_torch.models import trainer

    hybrid = (scores > threshold) | currents
    tp = int((hybrid & truths).sum())
    fp = int((hybrid & ~truths).sum())
    fn = int((~hybrid & truths).sum())
    hp = tp / max(tp + fp, 1)
    hr = tp / max(tp + fn, 1)
    hybrid_metrics = trainer.EvalResult(
        latency_mse=metrics.latency_mse,
        anomaly_accuracy=0.0,
        anomaly_precision=hp,
        anomaly_recall=hr,
        anomaly_base_rate=metrics.anomaly_base_rate,
        per_slot_flagged={},
        anomaly_f1=2 * hp * hr / (hp + hr) if hp + hr else 0.0,
        latency_mae_ms=metrics.latency_mae_ms,
    )
    return (
        f"{name} + persistence (hybrid)",
        hybrid_metrics,
        float("nan"),
        float("nan"),
        onset_recall(scores, truths, onsets, threshold),
        train_s,
    )


def _print_rows(rows) -> None:
    print(
        "| model | precision | recall | F1 | ROC-AUC | PR-AUC | "
        "onset recall | latency MAE (ms) | train wall (s) |"
    )
    print("|---|---|---|---|---|---|---|---|---|")
    for name, m, auc, ap, onset, wall in rows:
        print(
            f"| {name} | {m.anomaly_precision:.3f} | {m.anomaly_recall:.3f} "
            f"| {m.anomaly_f1:.3f} | {auc:.3f} | {ap:.3f} | {onset:.3f} "
            f"| {m.latency_mae_ms:.2f} | {wall:.0f} |"
        )


def inductive_eval(args, result, on_head: Optional[HeadHook] = None) -> list:
    """Held-out-ENDPOINT evaluation: 20% of endpoints never contribute a
    training loss or calibration label; anomaly metrics are computed on
    exactly those endpoints over the held-out slots. No node-identity
    embeddings: the identity signal is replaced by causal history
    features (models/history.py), which transfer to endpoints the model
    never saw. Trains on ``args.device``; prints the table and returns
    its rows."""
    from kmamiz_tpu_torch.models import graphsage, history, trainer
    from kmamiz_tpu_torch.models.trainer import ANOMALY_ERROR_SHARE

    device = resolve_device(args.device)
    dataset = trainer.dataset_from_simulation(
        result.endpoint_dependencies,
        result.realtime_data_per_slot,
        result.replica_counts,
    )
    held = history.split_endpoints(dataset.num_nodes, 0.2, seed=args.seed)
    print(
        f"\n== INDUCTIVE protocol: {int(held.sum())}/{dataset.num_nodes} "
        "endpoints held out of training losses AND threshold calibration; "
        "metrics below are on those endpoints only, held-out slots only =="
    )

    rows = []
    eval_held = None  # the history iteration's holdout, reused below
    held_slot_count = 0
    for label, use_history in (("with history features", True),
                               ("ablation: base features", False)):
        ds = history.augment_with_history(dataset) if use_history else dataset
        train_set, eval_set = trainer.temporal_split(ds, TRAIN_FRACTION)
        train_seen = history.mask_endpoints(train_set, ~held)
        it_eval_held = history.mask_endpoints(eval_set, held)

        t1 = time.perf_counter()
        res = trainer.train(
            train_seen,
            epochs=args.epochs,
            hidden=args.hidden,
            seed=args.seed,
            model=graphsage,
            use_node_embeddings=False,
            device=device,
        )
        train_s = time.perf_counter() - t1
        if use_history and getattr(args, "checkpoint_dir", None):
            # save AFTER training (never pass checkpoint_dir into
            # trainer.train here: its resume path validates only hypers,
            # so a stale checkpoint from a different mesh would silently
            # skip training and report bogus "fresh" metrics)
            from kmamiz_tpu_torch.models import checkpoint as ckpt

            ckpt.save_checkpoint(
                args.checkpoint_dir,
                res.params,
                # a restore reads the optimizer state against
                # optimizer.init(template); the state itself is not reused,
                # so a fresh init keeps the archive's layout without
                # threading it out of TrainResult
                graphsage.make_optimizer(0.01).init(res.params),
                step=args.epochs,
                metadata={
                    "loss": float(res.losses[-1]) if res.losses else None,
                    "hidden": args.hidden,
                    "lr": 0.01,
                    "seed": args.seed,
                    "model": "graphsage",
                    "num_features": int(
                        np.asarray(train_seen.features[0]).shape[1]
                    ),
                    "num_nodes": 0,
                },
            )
        threshold = trainer.calibrate_threshold(
            res.params, train_seen, model=graphsage
        )
        metrics = trainer.evaluate(
            res.params, it_eval_held, threshold=threshold, model=graphsage
        )
        scores, truths, onsets, currents = collect_scores(
            res.params, it_eval_held, graphsage
        )
        name = f"GraphSAGE ({label})"
        rows.append(
            (
                name,
                metrics,
                roc_auc(scores, truths),
                pr_auc(scores, truths),
                onset_recall(scores, truths, onsets, threshold),
                train_s,
            )
        )
        if use_history:
            eval_held = it_eval_held
            held_slot_count = len(eval_set.features)
            rows.append(
                _hybrid_row(
                    "GraphSAGE", metrics, scores, truths, onsets,
                    currents, threshold, train_s,
                )
            )
        if on_head is not None:
            on_head(name, graphsage, res, metrics, it_eval_held)

    # the skyline on the SAME held-out endpoints/slots (the skyline only
    # reads base feature columns, which augmentation leaves in place)
    p_scores, p_truths, p_onsets = _persistence_rows(eval_held)
    persist = trainer.evaluate_baseline(eval_held)
    rows.append(
        (
            "persistence skyline (held-out endpoints)",
            persist,
            roc_auc(p_scores, p_truths),
            pr_auc(p_scores, p_truths),
            onset_recall(p_scores, p_truths, p_onsets, ANOMALY_ERROR_SHARE),
            0.0,
        )
    )
    base_rate = rows[0][1].anomaly_base_rate
    rows.append(
        (
            "naive: random @ base rate",
            trainer.evaluate_naive(eval_held, rate=base_rate, seed=args.seed),
            0.5,
            float(p_truths.mean()),
            float(base_rate),
            0.0,
        )
    )
    print(
        f"\nheld-out slots: {held_slot_count}, held-out endpoints: "
        f"{int(held.sum())}, anomaly base rate {base_rate:.3f}, onset "
        f"samples {int(p_onsets.sum())}, epochs {args.epochs}, "
        f"seed {args.seed}\n"
    )
    _print_rows(rows)
    import resource

    peak_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    print(f"peak host memory: {peak_gb:.1f} GB (ru_maxrss)")
    if getattr(args, "checkpoint_dir", None):
        print(f"checkpoint (with-history model): {args.checkpoint_dir}")
    return rows


def transductive_eval(args, result, on_head: Optional[HeadHook] = None) -> list:
    """Held-out-SLOT evaluation of both heads (GraphSAGE, GAT; with
    ``args.embeddings`` their node-identity embeddings) beside the
    persistence skyline and the random baseline on the same slots. Trains
    on ``args.device``; prints the table and returns its rows."""
    from kmamiz_tpu_torch.models import gat, graphsage, trainer
    from kmamiz_tpu_torch.models.trainer import ANOMALY_ERROR_SHARE

    device = resolve_device(args.device)
    rows = []
    shared_dataset = None
    suffix = " (+node embeddings)" if args.embeddings else ""
    for name, model in (
        (f"GraphSAGE{suffix}", graphsage),
        (f"GAT{suffix}", gat),
    ):
        t1 = time.perf_counter()
        res, metrics, dataset = trainer.train_on_simulation(
            result.endpoint_dependencies,
            result.realtime_data_per_slot,
            result.replica_counts,
            train_fraction=TRAIN_FRACTION,
            epochs=args.epochs,
            hidden=args.hidden,
            seed=args.seed,
            model=model,
            use_node_embeddings=args.embeddings,
            device=device,
        )
        train_s = time.perf_counter() - t1
        shared_dataset = dataset
        _train, eval_set = trainer.temporal_split(dataset, TRAIN_FRACTION)
        scores, truths, onsets, currents = collect_scores(
            res.params, eval_set, model
        )
        rows.append(
            (
                name,
                metrics,
                roc_auc(scores, truths),
                pr_auc(scores, truths),
                onset_recall(scores, truths, onsets, metrics.threshold),
                train_s,
            )
        )
        rows.append(
            _hybrid_row(
                name, metrics, scores, truths, onsets, currents,
                metrics.threshold, train_s,
            )
        )
        if on_head is not None:
            on_head(name, model, res, metrics, eval_set)

    _train, eval_set = trainer.temporal_split(shared_dataset, TRAIN_FRACTION)
    base_rate = rows[0][1].anomaly_base_rate
    # persistence scores: current 5xx share as the ranking score, the
    # fair threshold-free form of the skyline
    p_scores, p_truths, p_onsets = _persistence_rows(eval_set)

    persist = trainer.evaluate_baseline(eval_set)
    rows.append(
        (
            "persistence skyline",
            persist,
            roc_auc(p_scores, p_truths),
            pr_auc(p_scores, p_truths),
            onset_recall(p_scores, p_truths, p_onsets, ANOMALY_ERROR_SHARE),
            0.0,
        )
    )
    rows.append(
        (
            "naive: random @ base rate",
            trainer.evaluate_naive(eval_set, rate=base_rate, seed=args.seed),
            0.5,
            float(p_truths.mean()),
            float(base_rate),
            0.0,
        )
    )

    n_onsets = int(p_onsets.sum())
    print(
        f"\nheld-out slots: {len(eval_set.features)} "
        f"(of {len(shared_dataset.features)}), anomaly base rate "
        f"{base_rate:.3f}, onset samples {n_onsets}, epochs {args.epochs}, "
        f"seed {args.seed}\n"
    )
    _print_rows(rows)
    return rows


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--services", type=int, default=100)
    parser.add_argument("--eps-per-service", type=int, default=10)
    parser.add_argument("--days", type=int, default=4)
    parser.add_argument("--epochs", type=int, default=40)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--hidden", type=int, default=32)
    parser.add_argument(
        "--embeddings",
        action="store_true",
        help="learned per-node identity embeddings (MODELS.md future work)",
    )
    parser.add_argument(
        "--inductive",
        action="store_true",
        help="hold out 20%% of ENDPOINTS from training + calibration and "
        "score only them (history features, no identity embeddings)",
    )
    parser.add_argument(
        "--tenk",
        action="store_true",
        help="also time (not score) the 1k-svc/10k-endpoint config",
    )
    parser.add_argument(
        "--checkpoint-dir",
        default=None,
        help="save the (with-history) inductive model's checkpoint here",
    )
    parser.add_argument("--device", default=None, help="torch device (default: the card)")
    return parser


def simulate(yaml_cfg: str, seed: int):
    """The simulator's output for a mesh YAML, seeded as the tool seeds it."""
    from kmamiz_tpu_torch.simulator import Simulator

    result = Simulator().generate_simulation_data(
        yaml_cfg, 0.0, rng=np.random.default_rng(seed)
    )
    if result.validation_error_message or result.converting_error_message:
        raise ValueError(result.validation_error_message or result.converting_error_message)
    return result


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)

    from kmamiz_tpu_torch.models import graphsage, trainer

    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    yaml_cfg = make_mesh_config(
        args.services, args.eps_per_service, args.days, rng
    )
    result = simulate(yaml_cfg, args.seed)
    sim_s = time.perf_counter() - t0
    n_eps = args.services * args.eps_per_service
    print(
        f"mesh: {args.services} services / {n_eps} endpoints / "
        f"{args.days} days -> simulated in {sim_s:.1f}s"
    )

    if args.inductive:
        inductive_eval(args, result)
        return 0

    transductive_eval(args, result)

    if args.tenk:
        t2 = time.perf_counter()
        r10k = simulate(make_mesh_config(1000, 10, 1, rng), args.seed)
        gen_s = time.perf_counter() - t2
        t3 = time.perf_counter()
        trainer.train_on_simulation(
            r10k.endpoint_dependencies,
            r10k.realtime_data_per_slot,
            r10k.replica_counts,
            epochs=1,
            hidden=args.hidden,
            seed=args.seed,
            model=graphsage,
            use_node_embeddings=args.embeddings,
            device=device,
        )
        step_s = time.perf_counter() - t3
        where = torch.cuda.get_device_name(device) if device.type == "cuda" else "the CPU"
        print(
            f"\n10k-endpoint wall-clock (BASELINE config 4 shape, 1 day): "
            f"simulate {gen_s:.1f}s, 1-epoch GraphSAGE train+eval {step_s:.1f}s "
            f"(on {where})"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

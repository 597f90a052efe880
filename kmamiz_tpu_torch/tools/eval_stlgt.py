"""STLGT evaluation: prequential replay over scenario-factory labeled
windows, over the port.

Counterpart of the repo's tools/eval_stlgt.py (docs/STLGT.md#evaluation),
with ``--device`` (the card when not given; without one the tool raises).
Replays one seeded scenario's labeled windows (scenarios/labeled.py:
ground truth comes from the composed storyline, not from heuristics over
spans) as an ONLINE forecast task: at each tick both heads train on the
windows seen so far, then forecast the NEXT window's per-endpoint
latency. Scored, TpuGraphs-style, on the tail:

- **quantile coverage**: fraction of (endpoint, tick) outcomes at or
  under the forecast p50/p95/p99; a well-calibrated p99 covers ~99%,
  and critically keeps covering through the injected cascade ticks;
- **attribution hit-rate**: during injected-fault ticks, the fraction
  of the model's top-K blamed edges that actually touch a storyline
  fault service (vs the random-edge base rate).

The GraphSAGE baseline trains online on the same example stream with
the same update budget (point forecast + MSE: its prediction is a
conditional mean, which is exactly why its tail coverage saturates low).
Exit code 0 iff STLGT beats the baseline on p99 coverage: the
acceptance gate. The table and the JSON line are the JAX tool's.

Usage: python -m kmamiz_tpu_torch.tools.eval_stlgt [--seed 0] [--ticks 48]
       [--device cpu]
"""
from __future__ import annotations

import argparse
import json
from typing import List, Optional

import numpy as np

from kmamiz_tpu_torch.device import DeviceLike, resolve_device

#: edges blamed per fault tick (top attribution gates)
TOP_K = 5


def _pad_edges(src, dst, mask):
    from kmamiz_tpu_torch.core.spans import _pad_size

    e = len(src)
    eb = _pad_size(e)
    src_p = np.zeros(eb, dtype=np.int32)
    dst_p = np.zeros(eb, dtype=np.int32)
    mask_p = np.zeros(eb, dtype=bool)
    src_p[:e], dst_p[:e], mask_p[:e] = src, dst, mask
    return src_p, dst_p, mask_p


def evaluate(
    seed: int = 0,
    index: int = 0,
    archetype: str = "cascade-fanout",
    ticks: int = 48,
    epochs: int = 4,
    hidden: int = 16,
    lr: float = 0.02,
    depth: int = 8,
    warmup: int = 4,
    device: DeviceLike = None,
    refreshes: Optional[list] = None,
) -> dict:
    """Prequential replay on `device` (the card when None) -> metrics dict
    (see module docstring). Pure function of its arguments: the scenario
    content is compose-time seeded and both heads train deterministically.
    `refreshes`, when given, receives each STLGT refresh's report (the
    trainer's observe_fold answer: its stale slots give the refresh's
    optimizer steps)."""
    import torch

    from kmamiz_tpu_torch.core.spans import _pad_size
    from kmamiz_tpu_torch.models import common, graphsage
    from kmamiz_tpu_torch.models import serving as sage_serving
    from kmamiz_tpu_torch.models.stlgt import serving as stlgt_serving
    from kmamiz_tpu_torch.models.stlgt.trainer import ContinualTrainer
    from kmamiz_tpu_torch.ops import sparse
    from kmamiz_tpu_torch.scenarios import build_scenario, labeled_windows

    dev = resolve_device(device)
    spec = build_scenario(archetype, seed, index, ticks)
    data = labeled_windows(spec)
    windows = data["windows"]
    names = data["names"]
    n = len(names)
    nb = _pad_size(n)
    src_p, dst_p, mask_p = _pad_edges(data["src"], data["dst"], data["mask"])
    n_edges = len(data["src"])
    svc_of = data["service_of"]
    services = data["services"]

    # STLGT: the continual trainer, driven exactly like the processor
    # fold hook drives it
    trainer = ContinualTrainer(
        depth=depth, refresh_every=1, epochs=epochs, hidden=hidden, lr=lr, device=dev
    )

    # GraphSAGE baseline: same features, same online example stream,
    # same number of optimizer updates per window
    sage_params = graphsage.init_params(
        torch.Generator().manual_seed(seed), hidden=hidden, num_features=10, device=dev
    )
    sage_opt = graphsage.make_optimizer(lr)
    sage_opt_state = sage_opt.init(sage_params)
    sage_step = common.make_train_step(
        sage_opt, common.make_loss_fn(graphsage.forward, 1.0)
    )

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # the padded edge list is fixed for the replay: uploaded, and on the
    # card indexed, once for every baseline step
    src_t, dst_t, mask_t = put(src_p), put(dst_p), put(mask_p)
    sage_index = (
        sparse.edge_index(src_t, dst_t, mask_t, nb, for_backward=True)
        if dev.type == "cuda"
        else None
    )

    def padf(feats):
        out = np.zeros((nb, feats.shape[1]), dtype=np.float32)
        out[:n] = feats
        return out

    cov = {"stlgt_p50": [], "stlgt_p95": [], "stlgt_p99": [], "sage": []}
    attribution_hits = []
    attribution_base = []
    fault_ticks = 0
    for t, w in enumerate(windows):
        snap = {
            "features": w["features"],
            "src": data["src"],
            "dst": data["dst"],
            "mask": data["mask"],
            "names": names,
            "predicted_hour": (t + 1) % 24,
            "cache_key": (1, 0, t),
        }
        report = trainer.observe_fold(snap)
        if report is not None and refreshes is not None:
            refreshes.append(report)
        if t > 0:
            prev, cur = windows[t - 1], w
            t_lat = cur["features"][:, 3]
            t_anom = (cur["features"][:, 2] > 0.10).astype(np.float32)
            nm = prev["active"] & cur["active"]
            batch = (
                put(padf(prev["features"])),
                src_t,
                dst_t,
                mask_t,
                put(np.pad(t_lat, (0, nb - n))),
                put(np.pad(t_anom, (0, nb - n))),
                put(np.pad(nm, (0, nb - n))),
            )
            for _ in range(epochs):
                sage_params, sage_opt_state, _loss, _aux = sage_step(
                    sage_params, sage_opt_state, *batch, index=sage_index
                )

        live = trainer.serving()
        if t + 1 >= len(windows) or t < warmup or live is None:
            continue
        nxt = windows[t + 1]
        act = w["active"] & nxt["active"]
        if not act.any():
            continue
        actual_ms = nxt["latency_ms"][act]

        q_ms, _prob, gate = stlgt_serving.quantile_forward(
            live["params"],
            w["features"],
            data["src"],
            data["dst"],
            data["mask"],
            live["model"],
        )
        cov["stlgt_p50"].append(np.mean(actual_ms <= q_ms[act, 0]))
        cov["stlgt_p95"].append(np.mean(actual_ms <= q_ms[act, 1]))
        cov["stlgt_p99"].append(np.mean(actual_ms <= q_ms[act, 2]))

        sage_ms, _sp = sage_serving.forecast_forward(
            sage_params,
            w["features"],
            data["src"],
            data["dst"],
            data["mask"],
            graphsage,
        )
        cov["sage"].append(np.mean(actual_ms <= sage_ms[act]))

        # attribution: on injected-fault ticks, do the top-K edge gates
        # point at edges touching a storyline fault service?
        truth = set(w["truth_services"])
        if truth:
            fault_ticks += 1
            truth_idx = {services.index(s) for s in truth}

            def touches(e):
                return (
                    int(svc_of[data["src"][e]]) in truth_idx
                    or int(svc_of[data["dst"][e]]) in truth_idx
                )

            top = np.argsort(-gate)[: min(TOP_K, n_edges)]
            attribution_hits.append(
                float(np.mean([1.0 if touches(int(e)) else 0.0 for e in top]))
            )
            attribution_base.append(
                float(np.mean([1.0 if touches(e) else 0.0 for e in range(n_edges)]))
            )

    result = {
        "scenario": spec.name,
        "endpoints": n,
        "edges": n_edges,
        "ticks": ticks,
        "scored_ticks": len(cov["sage"]),
        "fault_ticks": fault_ticks,
        "stlgt_p50_coverage": round(float(np.mean(cov["stlgt_p50"])), 4),
        "stlgt_p95_coverage": round(float(np.mean(cov["stlgt_p95"])), 4),
        "stlgt_p99_coverage": round(float(np.mean(cov["stlgt_p99"])), 4),
        "sage_p99_coverage": round(float(np.mean(cov["sage"])), 4),
        "attribution_hit_rate": round(
            float(np.mean(attribution_hits)) if attribution_hits else 0.0, 4
        ),
        "attribution_base_rate": round(
            float(np.mean(attribution_base)) if attribution_base else 0.0, 4
        ),
        "trainer": trainer.status(),
    }
    result["stlgt_beats_baseline"] = bool(
        result["stlgt_p99_coverage"] > result["sage_p99_coverage"]
    )
    return result


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--index", type=int, default=0)
    ap.add_argument("--archetype", default="cascade-fanout")
    ap.add_argument("--ticks", type=int, default=48)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--hidden", type=int, default=16)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    result = evaluate(
        seed=args.seed,
        index=args.index,
        archetype=args.archetype,
        ticks=args.ticks,
        epochs=args.epochs,
        hidden=args.hidden,
        lr=args.lr,
        device=args.device,
    )
    print("| metric | value |")
    print("|---|---|")
    for key in (
        "scenario",
        "scored_ticks",
        "fault_ticks",
        "stlgt_p50_coverage",
        "stlgt_p95_coverage",
        "stlgt_p99_coverage",
        "sage_p99_coverage",
        "attribution_hit_rate",
        "attribution_base_rate",
    ):
        print(f"| {key} | {result[key]} |")
    print(json.dumps({k: v for k, v in result.items() if k != "trainer"}))
    if result["stlgt_beats_baseline"]:
        print("PASS: STLGT p99 coverage beats the GraphSAGE baseline")
        return 0
    print("FAIL: STLGT p99 coverage does not beat the GraphSAGE baseline")
    return 1


if __name__ == "__main__":
    raise SystemExit(main())

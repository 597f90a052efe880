"""Forecast routes: serve the trained graph head against live features.

Counterpart of kmamiz_tpu/api/handlers/model.py. The handler runs a
checkpointed head against the features the realtime tick folds each hour
(DataProcessor._observe_history -> forecast_snapshot) over the live
dependency graph, on the processor's device:

- `GET /model/status` — checkpoint metadata and feature freshness.
- `GET /model/forecast` — per-endpoint anomaly probability and predicted
  latency for the upcoming hour, memoized per published snapshot and
  STLGT params version. With the STLGT continual trainer live
  (KMAMIZ_STLGT=1, models/stlgt/trainer.py) the route grows `?quantile=`
  (p50|p95|p99|all) and `?horizon=` (hours, sqrt widening of the tail)
  and a `stlgt` payload section: per-endpoint latency quantiles and the
  top per-edge attribution gates; with no checkpoint configured the live
  STLGT params serve the legacy shape too (model "stlgt-live"). Each
  published snapshot is padded and indexed once for both heads.

Configuration: KMAMIZ_MODEL_DIR points at a checkpoint directory of the
port (models/checkpoint.py). Only identity-free heads serve (num_nodes=0):
node-identity embeddings cannot be aligned with a live, growing endpoint
set. The sidecar's "model" picks the head: GAT or GraphSAGE.
"""
from __future__ import annotations

import gzip
import json
import logging
import threading
import time
from typing import Optional

import numpy as np

from kmamiz_tpu_torch.api.router import IRequestHandler, Request, Response
from kmamiz_tpu_torch.device import resolve_device
from kmamiz_tpu_torch.server.initializer import AppContext

logger = logging.getLogger("kmamiz_tpu_torch.api.model")


class ModelHandler(IRequestHandler):
    def __init__(self, ctx: AppContext) -> None:
        super().__init__("model")
        self._ctx = ctx
        self._lock = threading.Lock()
        self._loaded = None  # (params, meta, model_module) | None
        self._load_error: Optional[str] = None
        # a missing checkpoint, a mid-rewrite sidecar or a vanished archive
        # are TRANSIENT (the trainer may not have written its step yet):
        # they re-attempt on later requests, rate-limited. Terminal errors
        # (no model dir, embedding or GAT checkpoints, unexpected
        # exceptions) stay until restart.
        self._error_transient = False
        self._next_retry = 0.0
        # (snapshot, payload, encoded, gzipped, memo key): forecasts change
        # once per hour fold; polls in between serve the memoized payload
        self._forecast_cache = None
        # ((cache_key, device), PaddedSnapshot): the published snapshot on
        # the device, with its edge index, shared by the heads' forwards
        self._padded = None

        self.add_route("get", "/status", self._status)
        self.add_route("get", "/forecast", self._forecast)

    RETRY_SECONDS = 5.0

    def _mark_transient(self, msg: str) -> None:
        """Record a transient load failure (rate-limited retry). Caller
        holds self._lock; returns None as the failure exit."""
        self._load_error = msg
        self._error_transient = True
        self._next_retry = time.monotonic() + self.RETRY_SECONDS
        return None

    # -- checkpoint loading (lazy, once) -------------------------------------

    def _device(self):
        dp = self._ctx.processor
        return dp.device if dp is not None else resolve_device(None)

    def _load(self):
        with self._lock:
            if self._loaded is not None:
                return self._loaded
            if self._load_error is not None and (
                not self._error_transient or time.monotonic() < self._next_retry
            ):
                return None
            directory = self._ctx.settings.model_dir
            if not directory:
                self._load_error = "KMAMIZ_MODEL_DIR not configured"
                return None
            # every path below is terminal unless it marks itself transient
            self._error_transient = False
            try:
                from kmamiz_tpu_torch.models import checkpoint as ckpt
                from kmamiz_tpu_torch.models import gat, graphsage

                step = ckpt.latest_complete_step(directory)
                if step is None:
                    return self._mark_transient(f"no complete checkpoint in {directory}")
                meta = ckpt.load_metadata(directory, step) or {}
                if not meta:
                    # the sidecar vanished between listing and read: the
                    # trainer is rewriting this step
                    return self._mark_transient(
                        f"checkpoint step {step} metadata unreadable (trainer mid-write?)"
                    )
                if int(meta.get("num_nodes", 0)):
                    self._load_error = (
                        "checkpoint uses node-identity embeddings; only "
                        "identity-free heads serve against a live endpoint "
                        "set (retrain without --embeddings)"
                    )
                    return None
                model = gat if meta.get("model") == "gat" else graphsage
                restored = ckpt.restore_params(
                    directory, model, step=step, device=self._device()
                )
                if restored is None:
                    # the archive disappeared between listing and restore
                    return self._mark_transient(f"restore failed for {directory}")
                params, meta = restored
                self._loaded = (params, dict(meta), model)
                self._load_error = None
                logger.info("forecast model loaded from %s step %s", directory, step)
            except OSError as err:
                # filesystem races with a concurrently-writing trainer
                logger.warning("forecast model load raced a writer: %s", err)
                return self._mark_transient(f"model load raced a writer: {err}")
            except Exception as err:  # noqa: BLE001 - surfaced via /status
                self._load_error = f"model load failed: {err}"
                logger.exception("forecast model load failed")
            return self._loaded

    # -- routes --------------------------------------------------------------

    def _status(self, req: Request) -> Response:
        loaded = self._load()
        dp = self._ctx.processor
        snap = dp.forecast_snapshot if dp is not None else None
        payload = {
            "modelLoaded": loaded is not None,
            "modelDir": self._ctx.settings.model_dir,
            "error": self._load_error,
            "featureHourReady": snap is not None,
            "predictedHour": snap["predicted_hour"] if snap else None,
            "numEndpoints": int(snap["features"].shape[0]) if snap else 0,
        }
        if loaded is not None:
            _params, meta, _model = loaded
            payload["checkpoint"] = {
                "model": meta.get("model"),
                "step": meta.get("step"),
                "hidden": meta.get("hidden"),
                "numFeatures": meta.get("num_features"),
                "loss": meta.get("loss"),
            }
        return Response(payload=payload)

    #: quantile selector values the route accepts (column order of
    #: models/stlgt/model.QUANTILES)
    _QUANTILE_COLS = {"p50": 0, "p95": 1, "p99": 2}
    #: attribution edges returned per forecast (highest STLGT edge gate)
    _TOP_EDGES = 20

    def _padded_snapshot(self, snap: dict, device):
        """The snapshot padded on `device` with its edge index: built once
        per published snapshot and device, for every forward of it."""
        from kmamiz_tpu_torch.models import serving

        key = (snap["cache_key"], str(device))
        cached = self._padded
        if cached is not None and cached[0] == key:
            return cached[1]
        padded = serving.pad_snapshot(
            snap["features"], snap["src"], snap["dst"], snap["mask"], device
        )
        self._padded = (key, padded)
        return padded

    def _stlgt_section(self, live, snap, qsel, horizon):
        """(stlgt payload section, quantiles ms [N, 3], probability [N])
        of the live STLGT params on the snapshot."""
        from kmamiz_tpu_torch.models.stlgt import serving as stlgt_serving

        names = snap["names"]
        q_ms, s_prob, gate = stlgt_serving.quantile_forward_padded(
            live["params"],
            self._padded_snapshot(snap, live["params"][0].device),
            live["model"],
        )
        if horizon > 1:
            # multi-hour horizon: the tail spread widens by the
            # independent-increments heuristic (sqrt scaling of the
            # above-median excess); p50 is carried flat
            scale = float(np.sqrt(horizon))
            q_ms = q_ms.copy()
            q_ms[:, 1:] = q_ms[:, :1] + (q_ms[:, 1:] - q_ms[:, :1]) * scale
        cols = self._QUANTILE_COLS if qsel == "all" else {qsel: self._QUANTILE_COLS[qsel]}
        stlgt_endpoints = [
            {
                "uniqueEndpointName": names[i],
                "anomalyProbability": round(float(s_prob[i]), 4),
                "latencyQuantilesMs": {
                    level: round(float(max(q_ms[i, c], 0.0)), 2) for level, c in cols.items()
                },
            }
            for i in np.argsort(-s_prob)
        ]
        edge_mask = np.asarray(snap["mask"], dtype=bool)
        src_ids = np.asarray(snap["src"])
        dst_ids = np.asarray(snap["dst"])
        n = len(names)
        attributions = []
        for e in np.argsort(-gate):
            if len(attributions) >= self._TOP_EDGES:
                break
            e = int(e)
            if not edge_mask[e]:
                continue
            s, d = int(src_ids[e]), int(dst_ids[e])
            if s >= n or d >= n:
                continue
            attributions.append(
                {"source": names[s], "target": names[d], "score": round(float(gate[e]), 4)}
            )
        section = {
            "paramsVersion": live["version"],
            "quantile": qsel,
            "horizon": horizon,
            "quantileLevels": list(live["quantiles"]),
            "endpoints": stlgt_endpoints,
            "attributions": attributions,
        }
        return section, q_ms, s_prob

    def _forecast(self, req: Request) -> Response:
        from kmamiz_tpu_torch.models import stlgt as stlgt_pkg

        # live STLGT params (the continual trainer's last-good) serve the
        # quantile surface, and the whole route when no checkpoint is
        # configured; a checkpointed head alone serves the legacy shape
        live = stlgt_pkg.serving_params()
        loaded = self._load()
        if loaded is None and live is None:
            return Response(status=503, payload={"error": self._load_error})
        qsel = (req.query.get("quantile") or "all").lower()
        if qsel != "all" and qsel not in self._QUANTILE_COLS:
            return Response(
                status=400,
                payload={"error": f"unknown quantile {qsel!r} (p50|p95|p99|all)"},
            )
        horizon = max(1, int(req.query_int("horizon") or 1))
        # sqrt-horizon widening has no natural ceiling: beyond the
        # configured max the request is a caller error, not a forecast
        hmax = stlgt_pkg.horizon_max()
        if horizon > hmax:
            return Response(
                status=400,
                payload={
                    "error": f"horizon {horizon} exceeds "
                    f"KMAMIZ_STLGT_HORIZON_MAX={hmax}: sqrt-horizon "
                    "widening is not meaningful that far out"
                },
            )
        if (qsel != "all" or horizon != 1) and live is None:
            return Response(
                status=503,
                payload={
                    "error": "quantile/horizon forecasts need the STLGT "
                    "continual trainer (KMAMIZ_STLGT=1) to have completed "
                    "a refresh"
                },
            )
        dp = self._ctx.processor
        # ONE attribute read: the fold publishes features, edges, names and
        # hour together, so a reader never mixes two folds
        snap = dp.forecast_snapshot if dp is not None else None
        if snap is None:
            return Response(
                status=503,
                payload={
                    "error": "no completed feature hour yet (the first "
                    "forecast is available after one full hour of ticks)"
                },
            )
        # memoized per published snapshot (the fold's graph version, label
        # epoch and hour), STLGT params version and selection: dashboards
        # poll every few seconds, the forecast changes once per fold
        memo_key = (
            snap["cache_key"],
            live["version"] if live is not None else 0,
            qsel,
            horizon,
        )
        cached = self._forecast_cache
        if cached is not None and cached[4] == memo_key:
            return Response(payload=cached[1], raw_body=cached[2], raw_gzip=cached[3])
        feats = snap["features"]
        names = snap["names"]
        if loaded is not None:
            params, meta, model = loaded
            if feats.shape[1] != int(meta["num_features"]):
                return Response(
                    status=409,
                    payload={
                        "error": (
                            f"feature width {feats.shape[1]} != checkpoint's "
                            f"{meta['num_features']} (train with the matching "
                            "feature layout)"
                        )
                    },
                )

        stlgt_section = None
        if live is not None:
            stlgt_section, q_ms, s_prob = self._stlgt_section(live, snap, qsel, horizon)
        if loaded is not None:
            from kmamiz_tpu_torch.models import serving

            lat_ms, prob = serving.forecast_forward_padded(
                params, self._padded_snapshot(snap, params[0].device), model
            )
            model_name = meta.get("model")
        else:
            # no checkpoint configured: the live STLGT head serves the
            # legacy shape too (p50 column and its anomaly probability)
            lat_ms, prob = q_ms[:, 0], s_prob
            model_name = "stlgt-live"
        order = np.argsort(-prob)
        endpoints = [
            {
                "uniqueEndpointName": names[i],
                "anomalyProbability": round(float(prob[i]), 4),
                "predictedLatencyMs": round(float(max(lat_ms[i], 0.0)), 2),
            }
            for i in order
        ]
        payload = {
            "predictedHour": snap["predicted_hour"],
            "model": model_name,
            "endpoints": endpoints,
        }
        if stlgt_section is not None:
            payload["stlgt"] = stlgt_section
        encoded = json.dumps(payload).encode()
        zipped = gzip.compress(encoded)
        self._forecast_cache = (snap, payload, encoded, zipped, memo_key)
        return Response(payload=payload, raw_body=encoded, raw_gzip=zipped)

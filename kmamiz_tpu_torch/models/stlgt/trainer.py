"""STLGT continual trainer: online refresh driven from the tick's folds.

Counterpart of kmamiz_tpu/models/stlgt/trainer.py. Every hour fold
(server/processor._fold_hour_locked) publishes a forecast snapshot. This
module turns consecutive snapshots into supervised examples (window t's
features predict window t+1's observed latency and anomaly), keeps them
in a bounded ring, and refreshes ONE shared set of STLGT params over the
ring's stale slots.

Staleness drives the work, not the clock:

- the newest example's slot is always stale (never trained on);
- DIRTY endpoints mark their slots stale: an endpoint whose feature row
  changed since the previous fold (or that just appeared) marks every
  ring slot it is active in;
- a graph-version bump (topology change) marks everything stale.

The JAX package runs a refresh as one scan-fused program in which each
slot's optimizer update is SELECT-MERGED by its 0/1 stale weight
(`p = where(w, p_updated, p_old)`, the step count included: AdamW with
zero grads is not a no-op). The port loops over the ring's slots and
skips a non-stale slot's update outright, which is the same select, and
spends nothing on it. Each example is uploaded once, when it joins the
ring, with its edge index (on the card); its tensors are padded to the
ring's pow2 buckets, the reference's layout, and re-padded only when the
ring's buckets grow. A refresh's losses are fetched once.

Failure containment mirrors the tick watchdog: a refresh that raises
keeps the last-good params serving, staleness keeps climbing, and the
next fold tries again. A refresh is the tick phase `stlgt-refresh`; each
completed one counts in `kmamiz_model_train_ticks_total{model="stlgt"}`,
and `kmamiz_model_forecast_staleness_ticks{model="stlgt"}` holds the folds
since the last (the same numbers as `status()`).
"""
from __future__ import annotations

import functools
import os
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from kmamiz_tpu_torch.core.spans import _pad_size
from kmamiz_tpu_torch.device import DeviceLike, resolve_device
from kmamiz_tpu_torch.models import common
from kmamiz_tpu_torch.models.history import ANOMALY_ERROR_SHARE
from kmamiz_tpu_torch.ops import sparse
from kmamiz_tpu_torch.telemetry.registry import REGISTRY
from kmamiz_tpu_torch.telemetry.tracing import phase_span

# feature-column offsets in the assembled base layout
# (graphsage.assemble_features): err5 share and log1p latency are the
# label sources, active the example mask
_COL_ERR5 = 2
_COL_LOG_LATENCY = 3
_COL_ACTIVE = 7

# -- per-model SLO rows --------------------------------------------------------
#: continual-training refreshes completed, per model head
MODEL_TRAIN_TICKS = REGISTRY.counter_family(
    "kmamiz_model_train_ticks_total",
    "Continual-training refreshes completed, per model",
    ("model",),
)
#: folds observed since the serving params last refreshed, per model: 0 is
#: fresh; a climbing value means serving falls back to last-good
MODEL_FORECAST_STALENESS = REGISTRY.gauge_family(
    "kmamiz_model_forecast_staleness_ticks",
    "Folds since the model's serving params last refreshed",
    ("model",),
)
# preallocated per-model handles: the fold path never formats a label
_STLGT_TICKS = MODEL_TRAIN_TICKS.handle("stlgt")
_STLGT_STALENESS = MODEL_FORECAST_STALENESS.handle("stlgt")


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, str(default)))
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, str(default)))
    except ValueError:
        return default


def enabled() -> bool:
    """KMAMIZ_STLGT gate, default OFF."""
    return os.environ.get("KMAMIZ_STLGT", "0") not in ("0", "false", "")


def horizon_max() -> int:
    """KMAMIZ_STLGT_HORIZON_MAX (default 24): upper clamp on the
    ``/model/forecast?horizon=`` sqrt-widening; beyond it the route
    answers 400."""
    return max(1, _env_int("KMAMIZ_STLGT_HORIZON_MAX", 24))


def configured_quantiles() -> Tuple[float, ...]:
    """KMAMIZ_STLGT_QUANTILES as a sorted tuple, default (.5, .95, .99)."""
    raw = os.environ.get("KMAMIZ_STLGT_QUANTILES", "")
    if not raw:
        from kmamiz_tpu_torch.models.stlgt import model as _model

        return _model.QUANTILES
    try:
        vals = tuple(sorted(float(v) for v in raw.split(",") if v.strip()))
        return vals if len(vals) == 3 else (0.50, 0.95, 0.99)
    except ValueError:
        return (0.50, 0.95, 0.99)


# ---------------------------------------------------------------------------
# refresh block
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=16)
def stlgt_epoch_runner(model, lr: float, pos_weight: float, quantiles):
    """(params, opt_state, slots, stale, n_epochs) -> (params, opt_state,
    losses [n_epochs, 3] on the device). `slots` are the ring's device
    examples (dicts of features, target_latency, target_anomaly,
    node_mask, src, dst, mask, index), `stale` their flags: each epoch
    runs one optimizer update per stale slot, in ring order, and skips
    the rest entirely (the reference's select-merge). An epoch's losses
    are the mean over its stale slots (0 with none)."""
    optimizer = model.make_optimizer(lr)
    loss_fn = model.make_pinball_loss_fn(pos_weight, tuple(quantiles))

    def run(params, opt_state, slots, stale, n_epochs: int):
        device = next(p for p in params if p is not None).device
        n_stale = max(sum(1 for s in stale if s), 1)
        epochs = []
        for _ in range(n_epochs):
            total = torch.zeros(3, dtype=torch.float32, device=device)
            for ex, is_stale in zip(slots, stale):
                if not is_stale:
                    continue
                loss, (q_l, a_l), grads = common.value_and_grad(
                    loss_fn,
                    params,
                    ex["features"],
                    ex["src"],
                    ex["dst"],
                    ex["mask"],
                    ex["target_latency"],
                    ex["target_anomaly"],
                    ex["node_mask"],
                    index=ex["index"],
                )
                params, opt_state = optimizer.apply(params, grads, opt_state)
                total = total + torch.stack([loss, q_l, a_l])
            epochs.append(total / n_stale)
        return params, opt_state, torch.stack(epochs)

    return run


# ---------------------------------------------------------------------------
# continual trainer
# ---------------------------------------------------------------------------


class ContinualTrainer:
    """Bounded example ring + stale tracking + refresh scheduling for one
    STLGT head, training on `device` (the card when None). All mutable
    state lives behind `_lock`; the processor calls `observe_fold` from
    its fold path, tests drive instances directly."""

    def __init__(
        self,
        depth: int = 8,
        refresh_every: int = 1,
        epochs: int = 2,
        hidden: int = 32,
        lr: float = 0.05,
        pos_weight: float = 1.0,
        quantiles: Optional[Tuple[float, ...]] = None,
        seed: int = 0,
        device: DeviceLike = None,
    ) -> None:
        from kmamiz_tpu_torch.models.stlgt import model as _model

        self.model = _model
        self.device = resolve_device(device)
        self.depth = max(1, int(depth))
        self.refresh_every = max(1, int(refresh_every))
        self.epochs = max(1, int(epochs))
        self.hidden = int(hidden)
        self.lr = float(lr)
        self.pos_weight = float(pos_weight)
        self.quantiles = tuple(quantiles or _model.QUANTILES)
        self.seed = int(seed)

        self._lock = threading.Lock()
        self._ring: list = []  # example dicts (host arrays), oldest first
        self._slots: list = []  # parallel device copies of the examples
        self._stale: list = []  # parallel 0/1 flags
        self._pending: Optional[dict] = None  # last fold awaiting its label
        self._params = None  # training + serving
        self._opt_state = None
        self._params_version = 0  # bumps per successful refresh
        self._folds_seen = 0
        self._folds_since_refresh = 0
        self._refreshes = 0
        self._refresh_failures = 0
        self._last_loss: Optional[float] = None
        self._last_error: Optional[str] = None

    # -- snapshot intake ----------------------------------------------------

    @staticmethod
    def _window_from_snapshot(snap: dict) -> dict:
        feats = np.asarray(snap["features"], dtype=np.float32)
        return {
            "features": feats,
            "src": np.asarray(snap["src"], dtype=np.int32),
            "dst": np.asarray(snap["dst"], dtype=np.int32),
            "mask": np.asarray(snap["mask"], dtype=bool),
            "version": int(snap.get("cache_key", (0, 0, 0))[0]),
        }

    def observe_fold(self, snap: dict) -> Optional[dict]:
        """One hour fold observed: label the pending window with this
        fold's outcomes, append the example, propagate staleness, and
        refresh if the cadence says so. Returns the refresh report when
        one ran, else None."""
        with self._lock:
            win = self._window_from_snapshot(snap)
            self._folds_seen += 1
            prev = self._pending
            self._pending = win
            if prev is not None:
                self._append_example_locked(prev, win)
                self._folds_since_refresh += 1
            _STLGT_STALENESS.set(float(self._folds_since_refresh))
            if not any(self._stale):
                return None
            if self._params is not None and self._folds_since_refresh < self.refresh_every:
                return None
            return self._refresh_locked()

    def _append_example_locked(self, prev: dict, cur: dict) -> None:
        n_cur = cur["features"].shape[0]
        n_prev = prev["features"].shape[0]
        f = cur["features"].shape[1]
        # the endpoint id space only grows between folds (the interner
        # appends); pad the older window up to the newer count
        k = min(n_prev, n_cur)
        feats = np.zeros((n_cur, f), dtype=np.float32)
        feats[:k] = prev["features"][:k]
        t_lat = cur["features"][:, _COL_LOG_LATENCY].astype(np.float32)
        t_anom = (cur["features"][:, _COL_ERR5] > ANOMALY_ERROR_SHARE).astype(np.float32)
        active_prev = np.zeros(n_cur, dtype=bool)
        active_prev[:k] = prev["features"][:k, _COL_ACTIVE] > 0
        node_mask = active_prev & (cur["features"][:, _COL_ACTIVE] > 0)
        example = {
            "features": feats,
            "src": prev["src"],
            "dst": prev["dst"],
            "mask": prev["mask"],
            "target_latency": t_lat,
            "target_anomaly": t_anom,
            "node_mask": node_mask,
        }
        # dirty endpoints: rows that changed since the previous fold (or
        # appeared); their slots go stale across the whole ring
        dirty = np.ones(n_cur, dtype=bool)
        dirty[:k] = np.abs(cur["features"][:k] - prev["features"][:k]).sum(axis=1) > 0
        version_bump = cur["version"] != prev["version"]
        for i, ex in enumerate(self._ring):
            if version_bump:
                self._stale[i] = True
                continue
            m = ex["node_mask"]
            kk = min(m.shape[0], n_cur)
            if bool((m[:kk] & dirty[:kk]).any()):
                self._stale[i] = True
        self._ring.append(example)
        self._slots.append(self._upload(example, _pad_size(n_cur), _pad_size(int(prev["src"].shape[0]))))
        self._stale.append(True)  # a never-trained window is always stale
        while len(self._ring) > self.depth:
            self._ring.pop(0)
            self._slots.pop(0)
            self._stale.pop(0)

    def _upload(self, ex: dict, nb: int, eb: int) -> dict:
        """The example on the trainer's device, padded to (nb, eb) rows
        and edges (zero features, False masks), with its edge index on
        the card (the CPU's plain version reads none)."""
        n = ex["features"].shape[0]
        e = int(ex["src"].shape[0])

        def pad(a, size, dtype):
            out = np.zeros((size,) + a.shape[1:], dtype=dtype)
            out[: a.shape[0]] = a
            return torch.from_numpy(out).to(self.device)

        slot = {
            "features": pad(ex["features"], nb, np.float32),
            "target_latency": pad(ex["target_latency"], nb, np.float32),
            "target_anomaly": pad(ex["target_anomaly"], nb, np.float32),
            "node_mask": pad(ex["node_mask"], nb, bool),
            "src": pad(ex["src"], eb, np.int32),
            "dst": pad(ex["dst"], eb, np.int32),
            "mask": pad(ex["mask"], eb, bool),
            "buckets": (nb, eb),
            "rows": (n, e),
        }
        slot["index"] = (
            sparse.edge_index(slot["src"], slot["dst"], slot["mask"], nb, for_backward=True)
            if self.device.type == "cuda"
            else None
        )
        return slot

    # -- refresh ------------------------------------------------------------

    def _refresh_locked(self) -> dict:
        try:
            with phase_span("stlgt-refresh"):
                report = self._run_epoch_block_locked()
        except Exception as exc:  # noqa: BLE001 - watchdog-style containment
            # last-good params keep serving; staleness keeps climbing
            self._refresh_failures += 1
            self._last_error = f"{type(exc).__name__}: {exc}"
            _STLGT_STALENESS.set(float(self._folds_since_refresh))
            return {"ok": False, "error": self._last_error}
        self._refreshes += 1
        self._folds_since_refresh = 0
        self._params_version += 1
        self._last_error = None
        self._stale = [False] * len(self._ring)
        _STLGT_TICKS.inc()
        _STLGT_STALENESS.set(0.0)
        report["ok"] = True
        report["version"] = self._params_version
        return report

    def _run_epoch_block_locked(self) -> dict:
        s_real = len(self._ring)
        s_cap = _pad_size(max(s_real, 1))
        nb = _pad_size(max(ex["features"].shape[0] for ex in self._ring))
        eb = _pad_size(max(int(ex["src"].shape[0]) for ex in self._ring))
        f = self._ring[0]["features"].shape[1]
        # the ring's buckets grew past an example's: re-pad it (and its index)
        for i, ex in enumerate(self._ring):
            if self._slots[i]["buckets"] != (nb, eb):
                self._slots[i] = self._upload(ex, nb, eb)

        if self._params is None:
            self._params = self.model.init_params(
                torch.Generator().manual_seed(self.seed),
                hidden=self.hidden,
                num_features=f,
                device=self.device,
            )
            self._opt_state = self.model.make_optimizer(self.lr).init(self._params)

        runner = stlgt_epoch_runner(self.model, self.lr, self.pos_weight, self.quantiles)
        stale = [bool(s) for s in self._stale]
        params, opt_state, losses = runner(
            self._params, self._opt_state, self._slots, stale, self.epochs
        )
        losses = losses.cpu().numpy()  # one fetch per refresh
        self._params, self._opt_state = params, opt_state
        self._last_loss = float(losses[-1, 0])
        return {
            "slots": s_real,
            "stale_slots": int(sum(stale)),
            "bucket": [int(s_cap), int(nb), int(eb)],
            "loss": self._last_loss,
        }

    def replica(self, device: DeviceLike) -> "ContinualTrainer":
        """A trainer on `device` with this one's settings, ring, stale
        flags, pending window, params and optimizer state: what the next
        fold does to it, this trainer's next fold does on `device` (a
        refresh replayed on the CPU against the card's)."""
        with self._lock:
            other = ContinualTrainer(
                depth=self.depth,
                refresh_every=self.refresh_every,
                epochs=self.epochs,
                hidden=self.hidden,
                lr=self.lr,
                pos_weight=self.pos_weight,
                quantiles=self.quantiles,
                seed=self.seed,
                device=device,
            )
            other._ring = [dict(ex) for ex in self._ring]
            other._slots = [other._upload(ex, *slot["buckets"]) for ex, slot in zip(self._ring, self._slots)]
            other._stale = list(self._stale)
            other._pending = None if self._pending is None else dict(self._pending)
            if self._params is not None:
                move = lambda t: None if t is None else t.detach().to(other.device, copy=True)  # noqa: E731
                other._params = type(self._params)(*(move(t) for t in self._params))
                st = self._opt_state
                other._opt_state = type(st)(
                    move(st.count), tuple(move(t) for t in st.mu), tuple(move(t) for t in st.nu)
                )
            for name in (
                "_params_version",
                "_folds_seen",
                "_folds_since_refresh",
                "_refreshes",
                "_refresh_failures",
                "_last_loss",
                "_last_error",
            ):
                setattr(other, name, getattr(self, name))
            return other

    def refresh(self) -> dict:
        """Force a refresh now (tests)."""
        with self._lock:
            if not self._ring:
                return {"ok": False, "error": "no examples"}
            return self._refresh_locked()

    # -- serving surface ----------------------------------------------------

    def serving(self) -> Optional[dict]:
        """Last-good params for the forecast route, or None before the
        first successful refresh. The version keys the handler's memo
        alongside the snapshot's cache_key."""
        with self._lock:
            if self._params is None or self._params_version == 0:
                return None
            return {
                "params": self._params,
                "version": self._params_version,
                "quantiles": self.quantiles,
                "model": self.model,
            }

    def status(self) -> Dict[str, object]:
        with self._lock:
            return {
                "enabled": enabled(),
                "depth": self.depth,
                "refreshEvery": self.refresh_every,
                "epochs": self.epochs,
                "quantiles": list(self.quantiles),
                "foldsSeen": self._folds_seen,
                "examples": len(self._ring),
                "staleSlots": int(sum(1 for s in self._stale if s)),
                "refreshes": self._refreshes,
                "refreshFailures": self._refresh_failures,
                "paramsVersion": self._params_version,
                "stalenessTicks": self._folds_since_refresh,
                "lastLoss": self._last_loss,
                "lastError": self._last_error,
            }


# ---------------------------------------------------------------------------
# process-wide trainer (env-configured; the processor hook's entry)
# ---------------------------------------------------------------------------

_TRAINER: Optional[ContinualTrainer] = None
_TRAINER_LOCK = threading.Lock()


def get_trainer(device: DeviceLike = None) -> ContinualTrainer:
    """The process trainer, built on first use from the KMAMIZ_STLGT_*
    settings on `device` (the card when None; later calls get the same
    trainer whatever they pass)."""
    global _TRAINER
    with _TRAINER_LOCK:
        if _TRAINER is None:
            _TRAINER = ContinualTrainer(
                depth=_env_int("KMAMIZ_STLGT_HISTORY", 8),
                refresh_every=_env_int("KMAMIZ_STLGT_REFRESH", 1),
                epochs=_env_int("KMAMIZ_STLGT_EPOCHS", 2),
                hidden=_env_int("KMAMIZ_STLGT_HIDDEN", 32),
                lr=_env_float("KMAMIZ_STLGT_LR", 0.05),
                quantiles=configured_quantiles(),
                device=device,
            )
        return _TRAINER


def on_fold(snap: dict, device: DeviceLike = None) -> None:
    """Processor fold hook: no-op unless KMAMIZ_STLGT=1, so the default
    pipeline pays one env read per fold. `device` is the processor's."""
    if not enabled():
        return
    get_trainer(device).observe_fold(snap)


def trainer_status() -> Dict[str, object]:
    """GET /model/stlgt payload: config + ring + refresh health."""
    with _TRAINER_LOCK:
        t = _TRAINER
    if t is None:
        return {"enabled": enabled(), "foldsSeen": 0, "paramsVersion": 0}
    return t.status()


def serving_params() -> Optional[dict]:
    """Last-good serving params of the process trainer (None when it never
    refreshed)."""
    with _TRAINER_LOCK:
        t = _TRAINER
    return t.serving() if t is not None else None


def reset_for_tests() -> None:
    global _TRAINER
    with _TRAINER_LOCK:
        _TRAINER = None

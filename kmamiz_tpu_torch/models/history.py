"""Identity-free history features: the online state behind the forecast.

Counterpart of kmamiz_tpu/models/history.py: `HistoryState` (fed one
completed hourly bucket at a time by the processor's fold), the array
codec of its persisted documents, and the trainer's side:
`augment_with_history` (a dataset's slots replayed through the same
state, so training and serving share one feature formula),
`mask_endpoints` and `split_endpoints`. Host numpy throughout, copied
from the JAX package.

Columns (NUM_HISTORY_FEATURES, appended after the base features):
same-hour mean past anomaly label and 5xx share plus a log count of
observations, slot-over-slot deltas of 5xx share and log latency, a
3-slot rolling 5xx share, and log in/out degree from the dependency graph.
Everything is causal: the columns for slot t use only data observable by
the end of slot t.
"""
from __future__ import annotations

import base64
import dataclasses
from typing import List

import numpy as np

from kmamiz_tpu_torch.simulator.slot_metrics import parse_slot_key

#: next-slot 5xx share that counts as anomalous (kmamiz_tpu/models/trainer.py)
ANOMALY_ERROR_SHARE = 0.10
#: seconds per history slot: slots are hourly (kmamiz_tpu/models/trainer.py)
SLOT_SECONDS = 3600.0

NUM_HISTORY_FEATURES = 8

#: base-feature columns the history builder reads
_COL_ERR5 = 2
_COL_LOG_LATENCY = 3
_COL_ACTIVE = 7


def encode_array(a: np.ndarray) -> dict:
    """JSON-safe array encoding (dtype + shape + base64 raw bytes) for the
    persisted history snapshot: an exact round trip."""
    a = np.ascontiguousarray(a)
    return {
        "dtype": str(a.dtype),
        "shape": list(a.shape),
        "data": base64.b64encode(a.tobytes()).decode("ascii"),
    }


def decode_array(d) -> np.ndarray:
    if isinstance(d, np.ndarray):
        # already decoded: passes straight through
        return d
    return (
        np.frombuffer(base64.b64decode(d["data"]), dtype=d["dtype"])
        .reshape(d["shape"])
        .copy()
    )


def augment_with_history(dataset):
    """New GraphDataset (models/trainer.py) whose per-slot features carry
    NUM_HISTORY_FEATURES extra columns (same graph, targets and masks):
    the dataset's slots replayed through the online state
    (`HistoryState.step`), the formula serving uses."""
    state = HistoryState(dataset.num_nodes)
    state.set_degrees(dataset.src, dataset.dst, dataset.edge_mask, dataset.num_nodes)
    out_features: List[np.ndarray] = []
    for t in range(len(dataset.features)):
        base = np.asarray(dataset.features[t])
        hour = parse_slot_key(dataset.slot_keys[t])[1]
        cols = state.step(
            hour,
            base[:, _COL_ERR5],
            base[:, _COL_LOG_LATENCY],
            base[:, _COL_ACTIVE],
        )
        out_features.append(np.concatenate([base, cols], axis=1).astype(np.float32))
    return dataclasses.replace(
        dataset,
        features=out_features,
        target_latency=list(dataset.target_latency),
        target_anomaly=list(dataset.target_anomaly),
        node_mask=list(dataset.node_mask),
        slot_keys=list(dataset.slot_keys),
    )


def mask_endpoints(dataset, keep: np.ndarray):
    """View whose per-slot node_mask is restricted to `keep` (bool [N]).
    The graph and features are untouched (masked-out endpoints still pass
    messages as neighbors), but losses, threshold calibration and every
    metric only see kept endpoints."""
    keep = np.asarray(keep).astype(bool)
    return dataclasses.replace(
        dataset,
        features=list(dataset.features),
        target_latency=list(dataset.target_latency),
        target_anomaly=list(dataset.target_anomaly),
        node_mask=[np.asarray(m) & keep for m in dataset.node_mask],
        slot_keys=list(dataset.slot_keys),
    )


def split_endpoints(n: int, held_fraction: float = 0.2, seed: int = 0) -> np.ndarray:
    """bool [n]: True = HELD-OUT endpoint (labels unseen in training)."""
    rng = np.random.default_rng(seed)
    held = np.zeros(n, dtype=bool)
    k = max(1, int(round(n * held_fraction)))
    held[rng.choice(n, size=k, replace=False)] = True
    return held


class HistoryState:
    """Serving-side rolling state for the history features, fed one
    completed hourly bucket at a time. `step(hour, err5_share,
    latency_log, active)` returns the NUM_HISTORY_FEATURES columns for
    predicting hour+1 and folds the bucket into the accumulators.

    Endpoint capacity grows on demand (new endpoints join with empty
    profiles). Degree columns come from the live dependency graph via
    `set_degrees`.
    """

    def __init__(self, num_endpoints: int = 0) -> None:
        self._n = 0
        self._label_sum = np.zeros((24, 0))
        self._label_obs = np.zeros((24, 0))
        self._err_sum = np.zeros((24, 0))
        self._err_obs = np.zeros((24, 0))
        self._prev_err5 = np.zeros(0, dtype=np.float32)
        self._prev_lat = np.zeros(0, dtype=np.float32)
        self._window: List[np.ndarray] = []
        self._deg_in = np.zeros(0, dtype=np.float32)
        self._deg_out = np.zeros(0, dtype=np.float32)
        # no label fold on the very first bucket: its anomaly state is the
        # label of an example that predates the stream
        self._started = False
        if num_endpoints:
            self._grow(num_endpoints)

    @property
    def num_endpoints(self) -> int:
        return self._n

    def _grow(self, n: int) -> None:
        if n <= self._n:
            return
        extra = n - self._n

        def widen(a, fill=0.0):
            pad_shape = a.shape[:-1] + (extra,)
            return np.concatenate([a, np.full(pad_shape, fill, dtype=a.dtype)], axis=-1)

        self._label_sum = widen(self._label_sum)
        self._label_obs = widen(self._label_obs)
        self._err_sum = widen(self._err_sum)
        self._err_obs = widen(self._err_obs)
        self._prev_err5 = widen(self._prev_err5)
        self._prev_lat = widen(self._prev_lat)
        self._deg_in = widen(self._deg_in)
        self._deg_out = widen(self._deg_out)
        self._window = [widen(w) for w in self._window]
        self._n = n

    def set_degrees(self, src, dst, edge_mask, num_endpoints: int) -> None:
        """Refresh the structural-position columns from the dependency
        graph's host edge columns."""
        self._grow(num_endpoints)
        src = np.asarray(src)
        dst = np.asarray(dst)
        emask = np.asarray(edge_mask).astype(bool)
        deg_out = np.zeros(self._n, dtype=np.float32)
        deg_in = np.zeros(self._n, dtype=np.float32)
        s, d = src[emask], dst[emask]
        keep = (s >= 0) & (s < self._n) & (d >= 0) & (d < self._n)
        np.add.at(deg_out, s[keep], 1.0)
        np.add.at(deg_in, d[keep], 1.0)
        self._deg_in = np.log1p(deg_in)
        self._deg_out = np.log1p(deg_out)

    def step(
        self,
        hour: int,
        err5_share,
        latency_log,
        active,
        anomaly_threshold: float = ANOMALY_ERROR_SHARE,
    ) -> np.ndarray:
        """One completed hourly bucket -> feature columns [N, 8] for
        predicting hour+1, THEN fold the bucket (emit before fold, so a
        profile never includes its own slot). The bucket's anomaly label
        keys under `hour`, the hour the anomaly occurred in."""
        err5 = np.asarray(err5_share, dtype=np.float32)
        lat = np.asarray(latency_log, dtype=np.float32)
        self._grow(len(err5))
        n = self._n

        def fit(a, fill=0.0):
            out = np.full(n, fill, dtype=np.float32)
            out[: len(a)] = a
            return out

        err5 = fit(err5)
        lat = fit(lat)
        # host hour-bucket weights; float64 keeps long-run sums exact
        act = fit(np.asarray(active, dtype=np.float32)).astype(np.float64)

        hour = int(hour) % 24
        h_pred = (hour + 1) % 24

        # label fold first: this bucket's anomaly state is the label of the
        # example emitted one hour ago (keyed by occurrence hour)
        if self._started:
            label = (err5 > anomaly_threshold).astype(np.float64)
            self._label_sum[hour] += label * act
            self._label_obs[hour] += act
        self._started = True

        self._window.append(err5)
        if len(self._window) > 3:
            self._window.pop(0)

        hist_n = self._label_obs[h_pred]
        cols = np.stack(
            [
                (self._label_sum[h_pred] / np.maximum(hist_n, 1.0)).astype(np.float32),
                (self._err_sum[h_pred] / np.maximum(self._err_obs[h_pred], 1.0)).astype(
                    np.float32
                ),
                np.log1p(hist_n).astype(np.float32),
                err5 - self._prev_err5,
                lat - self._prev_lat,
                np.mean(self._window, axis=0).astype(np.float32),
                self._deg_in,
                self._deg_out,
            ],
            axis=1,
        )

        # observation fold after the emit, keyed by the observed hour
        self._err_sum[hour] += err5.astype(np.float64) * act
        self._err_obs[hour] += act
        self._prev_err5, self._prev_lat = err5, lat
        return cols

    # -- persistence: raw array bytes; re-keying across restarts happens by
    # endpoint name outside this class (remap), since intern ids shift

    _ARRAY_FIELDS = (
        "_label_sum",
        "_label_obs",
        "_err_sum",
        "_err_obs",
        "_prev_err5",
        "_prev_lat",
        "_deg_in",
        "_deg_out",
    )

    def to_doc(self) -> dict:
        """Exact serializable snapshot of the accumulators."""
        doc = {
            "n": self._n,
            "started": self._started,
            "window": [encode_array(w) for w in self._window],
        }
        for f in self._ARRAY_FIELDS:
            doc[f.lstrip("_")] = encode_array(getattr(self, f))
        return doc

    @classmethod
    def from_doc(cls, doc: dict) -> "HistoryState":
        state = cls(0)
        state._n = int(doc["n"])
        state._started = bool(doc["started"])
        state._window = [decode_array(w).astype(np.float32) for w in doc["window"]]
        for f in cls._ARRAY_FIELDS:
            setattr(state, f, decode_array(doc[f.lstrip("_")]))
        return state

    def remap(self, new_ids: np.ndarray, n_new: int) -> None:
        """Re-key every per-endpoint column: saved index i becomes
        new_ids[i] in a fresh n_new-wide layout (endpoints absent from the
        snapshot start empty).

        Ids are validated before any field is touched: a negative id would
        wrap around into another endpoint's column, a duplicate would drop
        a profile, and an out-of-range id would raise mid-loop with the
        state half-remapped."""
        ids = np.asarray(new_ids, dtype=np.int64)
        if ids.size and (ids.min() < 0 or ids.max() >= n_new):
            raise ValueError(
                f"remap ids must lie in [0, {n_new}); "
                f"got range [{ids.min()}, {ids.max()}]"
            )
        if len(np.unique(ids)) != len(ids):
            raise ValueError("remap ids must be unique (duplicate target id)")

        def scatter(a):
            out = np.zeros(a.shape[:-1] + (n_new,), dtype=a.dtype)
            k = min(a.shape[-1], len(ids))
            out[..., ids[:k]] = a[..., :k]
            return out

        for f in self._ARRAY_FIELDS:
            setattr(self, f, scatter(getattr(self, f)))
        self._window = [scatter(w) for w in self._window]
        self._n = n_new

"""The port's HistoryState against the JAX package's: the same buckets
replayed through both give exactly equal columns, and the document round
trip and the restart remap agree."""
from __future__ import annotations

import numpy as np
import pytest

from kmamiz_tpu.models import history as jax_history
from kmamiz_tpu.models import trainer as jax_trainer
from kmamiz_tpu_torch.models import history


def _buckets(seed, hours=30):
    """Hourly buckets with an endpoint set that grows mid-stream, quiet
    endpoints, and 5xx shares on both sides of the anomaly threshold."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(hours):
        n = 12 if t < 10 else 20
        out.append(
            (
                (7 + t) % 24,
                (rng.random(n) * 0.3).astype(np.float32),
                rng.normal(4.0, 1.0, n).astype(np.float32),
                rng.random(n) < 0.8,
            )
        )
    return out


def _edges(seed, n=20, e=60):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n + 2, e).astype(np.int32)  # some ids past n
    dst = rng.integers(0, n, e).astype(np.int32)
    return src, dst, rng.random(e) < 0.9


def _replay(module, buckets, edges):
    state = module.HistoryState(4)
    cols = []
    for t, (hour, err5, lat, active) in enumerate(buckets):
        if t in (0, 15):
            state.set_degrees(*edges, len(err5))
        cols.append(state.step(hour, err5, lat, active))
    return state, cols


def test_constants_match():
    assert history.NUM_HISTORY_FEATURES == jax_history.NUM_HISTORY_FEATURES
    assert history.ANOMALY_ERROR_SHARE == jax_trainer.ANOMALY_ERROR_SHARE
    assert history.SLOT_SECONDS == jax_trainer.SLOT_SECONDS


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_replay_gives_equal_columns(seed):
    buckets, edges = _buckets(seed), _edges(seed)
    _, want = _replay(jax_history, buckets, edges)
    _, got = _replay(history, buckets, edges)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


def test_doc_round_trip_matches_jax():
    buckets, edges = _buckets(3), _edges(3)
    jax_state, _ = _replay(jax_history, buckets, edges)
    state, _ = _replay(history, buckets, edges)
    doc, jax_doc = state.to_doc(), jax_state.to_doc()
    assert doc == jax_doc
    # each package reads the other's document
    for restored in (history.HistoryState.from_doc(jax_doc), jax_history.HistoryState.from_doc(doc)):
        assert restored.to_doc() == doc
    nxt = (5, np.full(20, 0.2, np.float32), np.ones(20, np.float32), np.ones(20, bool))
    np.testing.assert_array_equal(
        history.HistoryState.from_doc(doc).step(*nxt),
        jax_history.HistoryState.from_doc(jax_doc).step(*nxt),
    )


def test_remap_matches_jax():
    buckets, edges = _buckets(4), _edges(4)
    jax_state, _ = _replay(jax_history, buckets, edges)
    state, _ = _replay(history, buckets, edges)
    ids = np.random.default_rng(4).permutation(30)[:20]
    state.remap(ids, 30)
    jax_state.remap(ids, 30)
    assert state.num_endpoints == 30
    assert state.to_doc() == jax_state.to_doc()


@pytest.mark.parametrize(
    "ids,n_new,match",
    [([0, -1], 4, "lie in"), ([0, 4], 4, "lie in"), ([1, 1], 4, "unique")],
)
def test_remap_rejects_bad_ids_before_touching_state(ids, n_new, match):
    state, _ = _replay(history, _buckets(5, hours=3), _edges(5, n=12))
    before = state.to_doc()
    with pytest.raises(ValueError, match=match):
        state.remap(np.array(ids), n_new)
    assert state.to_doc() == before


def test_array_codec_round_trip():
    for a in (np.arange(6, dtype=np.float64).reshape(2, 3), np.array([1.5], np.float32)):
        doc = history.encode_array(a)
        assert doc == jax_history.encode_array(a)
        back = history.decode_array(doc)
        assert back.dtype == a.dtype and np.array_equal(back, a)
    a = np.ones(3)
    assert history.decode_array(a) is a

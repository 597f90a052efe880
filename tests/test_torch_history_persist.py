"""History persistence of the port against the JAX package's: the same
ticks give snapshot_history documents equal to the JAX processor's, each
package restores the other's documents into an equal state, snapshot ->
restore -> snapshot gives identical bytes, and a tick racing a snapshot
leaves a consistent part set. A restore pads the state to the saved
names (`normalized`), so a snapshot of a restored processor has the
original's values, and its bytes once every endpoint has been folded.

Both processors take the pdas traces (fresh trace ids per tick) on one
fixed clock. The documents compare field for field with two exceptions
that the history state does not own: the forecast's edge columns, which
the two edge stores pad to different capacities (compared as the
multiset of live named edges), and its features, which agree within atol
1e-6 (tests/test_torch_forecast.py: float64 host sums, float32 columns).
"""
from __future__ import annotations

import json
import sys
import threading
from collections import Counter

import numpy as np
import pytest

from conftest import prefixed_trace_source
from kmamiz_tpu.models.history import decode_array as jax_decode
from kmamiz_tpu.server.processor import DataProcessor as JaxProcessor
from kmamiz_tpu_torch.models.history import decode_array
from kmamiz_tpu_torch.server.processor import DataProcessor

H = 3_600_000
NOW = 920 * H  # the processors' clock: later than every tick's hour


def _drive(proc, hours, prefix="d"):
    for i, hour in enumerate(hours):
        proc.collect({"uniqueId": f"{prefix}{i}", "lookBack": 30_000, "time": hour * H + 1000 * i})


def _pair(pdas_traces, hours):
    jax_dp = JaxProcessor(
        trace_source=prefixed_trace_source(pdas_traces, "d"),
        use_device_stats=False,
        now_ms=lambda: NOW,
    )
    port_dp = DataProcessor(
        trace_source=prefixed_trace_source(pdas_traces, "d"), device="cpu", now_ms=lambda: NOW
    )
    _drive(jax_dp, hours)
    _drive(port_dp, hours)
    return jax_dp, port_dp


def _fresh_port():
    return DataProcessor(trace_source=lambda lb, t, lim: [], device="cpu", now_ms=lambda: NOW)


def _fresh_jax():
    return JaxProcessor(trace_source=lambda lb, t, lim: [], use_device_stats=False, now_ms=lambda: NOW)


def normalized(docs):
    """Documents with each part's state columns zero-padded to the part's
    names. A snapshot writes the state as wide as it is (the endpoints it
    has folded) and the names as wide as the open bucket; a restore remaps
    the state onto every saved name, so a restored processor snapshots
    the same values, padded. Padding is the only difference restore makes."""
    out = []
    for d in docs:
        k = len(d["names"])
        state = dict(d["state"])

        def pad(a):
            a = decode_array(a)
            width = [(0, 0)] * (a.ndim - 1) + [(0, k - a.shape[-1])]
            return np.pad(a, width).tobytes()

        for key, value in d["state"].items():
            if key == "window":
                state[key] = [pad(w) for w in value]
            elif isinstance(value, dict):
                state[key] = pad(value)
        state.pop("n")
        out.append({**d, "state": state})
    return out


def _named_edges(fc):
    names = fc["names"]
    src, dst = decode_array(fc["src"]), decode_array(fc["dst"])
    mask = decode_array(fc["mask"]).astype(bool)
    return Counter((names[src[i]], names[dst[i]]) for i in np.nonzero(mask)[0])


def _assert_same_docs(got, want, exact_forecast=True):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = dict(g), dict(w)
        gf, wf = g.pop("forecast"), w.pop("forecast")
        assert g == w
        assert (gf is None) == (wf is None)
        if gf is None:
            continue
        if exact_forecast:
            assert gf == wf
            continue
        assert gf["names"] == wf["names"] and gf["predictedHour"] == wf["predictedHour"]
        assert _named_edges(gf) == _named_edges(wf)
        np.testing.assert_allclose(
            decode_array(gf["features"]), jax_decode(wf["features"]), rtol=0, atol=1e-6
        )


HOURS = [[910, 911], [910, 911, 912, 912], [910, 914], [900, 960, 961]]


@pytest.mark.parametrize("hours", HOURS, ids=lambda h: "-".join(map(str, h)))
def test_snapshot_documents_match_jax(pdas_traces, hours):
    jax_dp, port_dp = _pair(pdas_traces, hours)
    want, got = jax_dp.snapshot_history(), port_dp.snapshot_history()
    assert got is not None and got[0]["savedAt"] == NOW
    _assert_same_docs(got, want, exact_forecast=False)
    json.dumps(got)  # store-ready: plain JSON


def test_no_snapshot_before_a_tick():
    assert _fresh_port().snapshot_history() is None


@pytest.mark.parametrize("chunk", [2048, 3], ids=["one_part", "many_parts"])
def test_cross_package_restore(pdas_traces, monkeypatch, chunk):
    jax_dp, port_dp = _pair(pdas_traces, [910, 911, 912])
    monkeypatch.setattr(DataProcessor, "HISTORY_SNAPSHOT_CHUNK", chunk)
    monkeypatch.setattr(JaxProcessor, "HISTORY_SNAPSHOT_CHUNK", chunk)
    jax_docs, port_docs = jax_dp.snapshot_history(), port_dp.snapshot_history()
    assert len(port_docs) == len(jax_docs)
    assert (len(port_docs) > 1) == (chunk == 3)
    # the port restores the JAX documents and snapshots them back verbatim
    port_b = _fresh_port()
    port_b.restore_history(json.loads(json.dumps(jax_docs)))
    _assert_same_docs(port_b.snapshot_history(), jax_docs)
    # the JAX package restores the port's documents
    jax_b = _fresh_jax()
    jax_b.restore_history(json.loads(json.dumps(port_docs)))
    _assert_same_docs(jax_b.snapshot_history(), port_docs)
    # the restored forecast serves: its edges index its own names
    assert port_b.forecast_snapshot["names"] == jax_dp.forecast_snapshot["names"]
    assert port_b.forecast_snapshot["cache_key"][2] == -1


@pytest.mark.parametrize("hours", [[910, 911, 912], [910, 911, 912, 912]], ids=["folded", "grown"])
def test_snapshot_restore_snapshot_is_identical(pdas_traces, hours):
    """Identical bytes when the state is as wide as the names (every
    endpoint folded); otherwise identical values, and the restored
    snapshot is a fixed point: restoring it again gives its bytes."""
    _, port_dp = _pair(pdas_traces, hours)
    first = port_dp.snapshot_history()
    again = _fresh_port()
    again.restore_history(first)
    second = again.snapshot_history()
    assert normalized(second) == normalized(first)
    if all(d["state"]["n"] == len(d["names"]) for d in first):
        assert json.dumps(second, sort_keys=True) == json.dumps(first, sort_keys=True)
    third = _fresh_port()
    third.restore_history(second)
    assert json.dumps(third.snapshot_history(), sort_keys=True) == json.dumps(second, sort_keys=True)


def test_restore_picks_newest_complete_part_set(pdas_traces, monkeypatch):
    monkeypatch.setattr(DataProcessor, "HISTORY_SNAPSHOT_CHUNK", 3)
    _, port_dp = _pair(pdas_traces, [910, 911])
    old = port_dp.snapshot_history()
    _drive(port_dp, [912], prefix="x")
    new = [{**d, "savedAt": NOW + 1} for d in port_dp.snapshot_history()]
    torn = new[:-1]  # the newest set lost a part
    a = _fresh_port()
    a.restore_history(old + torn)
    assert normalized(a.snapshot_history()) == normalized(old)
    b = _fresh_port()
    b.restore_history(old + new)
    assert [d["predictedHour"] for d in b.snapshot_history()] == [d["predictedHour"] for d in new]


def test_live_state_outranks_a_restore(pdas_traces):
    _, port_dp = _pair(pdas_traces, [910, 911])
    before = json.dumps(port_dp.snapshot_history())
    _, other = _pair(pdas_traces, [910, 914])
    port_dp.restore_history(other.snapshot_history())
    assert json.dumps(port_dp.snapshot_history()) == before


def _consistent(docs):
    """A part set from one instant: one savedAt and part numbering,
    per-part arrays as wide as the part's names, the bucket's per-status
    counts summing to its counts, and the published fold matching the
    open bucket (ticks here advance one hour at a time)."""
    assert len({d["savedAt"] for d in docs}) == 1
    assert [d["part"] for d in docs] == list(range(docs[0]["parts"]))
    counts = classes = 0.0
    for d in docs:
        k = len(d["names"])
        b = d["hourBucket"]
        if b is not None:
            count, cls_count = decode_array(b["arrays"][0]), decode_array(b["arrays"][5])
            assert len(count) == k and cls_count.shape == (k, 6)
            counts += count.sum()
            classes += cls_count.sum()
        for key in ("historyFeatures", "modelFeatures"):
            if d[key] is not None:
                assert len(decode_array(d[key])) == k
    assert counts == classes
    first = docs[0]
    if first["forecast"] is not None and first["hourBucket"] is not None:
        assert first["predictedHour"] == first["hourBucket"]["hour"] % 24
        assert first["forecast"]["predictedHour"] == first["predictedHour"]


def test_tick_racing_snapshots_keeps_part_sets_consistent(pdas_traces, monkeypatch):
    monkeypatch.setattr(DataProcessor, "HISTORY_SNAPSHOT_CHUNK", 4)
    proc = DataProcessor(
        trace_source=prefixed_trace_source(pdas_traces, "r"), device="cpu", now_ms=lambda: NOW
    )
    _drive(proc, [900])
    snaps, errors = [], []
    stop = threading.Event()

    def snapshotter():
        try:
            while not stop.is_set():
                docs = proc.snapshot_history()
                if docs is not None:
                    snaps.append(docs)
        except Exception as err:  # noqa: BLE001 - surfaced by the assert below
            errors.append(err)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=snapshotter) for _ in range(3)]
    try:
        for t in threads:
            t.start()
        for i in range(12):  # every other tick opens a new hour
            hour = 901 + i // 2
            proc.collect({"uniqueId": f"r{i}", "lookBack": 30_000, "time": hour * H + i})
    finally:
        stop.set()
        for t in threads:
            t.join(30)
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(snaps) > 10
    for docs in snaps:
        _consistent(docs)
    # every raced snapshot restores and snapshots back identically
    for docs in snaps[:: max(1, len(snaps) // 5)]:
        fresh = _fresh_port()
        fresh.restore_history(docs)
        assert normalized(fresh.snapshot_history()) == normalized(docs)

"""The slice as a whole: the port's DataProcessor tick on the CPU against
the JAX package's, with the JAX segment stats on its Pallas kernel in
interpret mode (KMAMIZ_SEGMENT_BACKEND=pallas_interpret).

dependencies, datatype and every combined field must be equal, except
latency.mean (rel 1e-5, abs 1e-6) and latency.cv (rel 1e-3, abs 1e-5):
the tolerances tests/test_processor_equivalence.py pins between float32
device moments and the float64 host path. The graphs must carry the same
signature afterwards; the `log` field is free text and is not compared.
"""
from __future__ import annotations

import gzip
import json
import random
import urllib.request

import pytest

from kmamiz_tpu.resilience.chaos import graph_signature
from kmamiz_tpu.server.processor import DataProcessor as JaxProcessor
from kmamiz_tpu_torch import synth
from kmamiz_tpu_torch.server.dp_server import DataProcessorServer
from kmamiz_tpu_torch.server.processor import DataProcessor
from test_processor_equivalence import _random_window


def _assert_same_tick(got: dict, want: dict) -> None:
    assert got["uniqueId"] == want["uniqueId"]
    assert got["dependencies"] == want["dependencies"]
    assert got["datatype"] == want["datatype"]
    g_idx = {(c["uniqueEndpointName"], c["status"]): c for c in got["combined"]}
    w_idx = {(c["uniqueEndpointName"], c["status"]): c for c in want["combined"]}
    assert len(g_idx) == len(got["combined"])
    assert set(g_idx) == set(w_idx)
    for key, w in w_idx.items():
        g = dict(g_idx[key])
        w = dict(w)
        g_lat, w_lat = g.pop("latency"), w.pop("latency")
        assert g == w, key
        assert g_lat["mean"] == pytest.approx(w_lat["mean"], rel=1e-5, abs=1e-6), key
        assert g_lat["cv"] == pytest.approx(w_lat["cv"], rel=1e-3, abs=1e-5), key


def _windows():
    from conftest import load_fixture

    out = {
        "bookinfo": load_fixture("bookinfo_traces"),
        "pdas": [load_fixture("pdas_traces")],
    }
    for seed in range(4):
        rng = random.Random(seed)
        out[f"random{seed}"] = _random_window(rng, n_traces=rng.randint(5, 40))
    out["synth"] = json.loads(
        synth.make_raw_window(60, 7, n_services=1000, urls_per_service=10)
    )
    return out


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setenv("KMAMIZ_SEGMENT_BACKEND", "pallas_interpret")


@pytest.mark.parametrize(
    "name", ["bookinfo", "pdas", "random0", "random1", "random2", "random3", "synth"]
)
def test_tick_matches_jax(name):
    groups = _windows()[name]
    request = {"uniqueId": name, "lookBack": 30_000, "time": 0}
    jax_dp = JaxProcessor(trace_source=lambda lb, t, lim: groups)
    port_dp = DataProcessor(trace_source=lambda lb, t, lim: groups, device="cpu")
    want = jax_dp.collect(request)
    got = port_dp.collect(request)
    assert got["combined"], name
    _assert_same_tick(got, want)
    assert graph_signature(port_dp.graph) == graph_signature(jax_dp.graph)
    assert port_dp.graph.n_edges == jax_dp.graph.n_edges
    # a second tick of the same traces is deduplicated in both packages
    _assert_same_tick(port_dp.collect(request), jax_dp.collect(request))


def test_two_ticks_with_existing_dependencies():
    """Tick 2 brings fresh traces and tick 1's dependencies as existingDep
    (the host app's merge-with-existing path)."""
    windows = _windows()
    feeds = [windows["random0"], windows["bookinfo"]]

    def source(seen):
        def fetch(lb, t, lim):
            seen["n"] += 1
            return feeds[seen["n"] - 1]

        return fetch

    jax_dp = JaxProcessor(trace_source=source({"n": 0}))
    port_dp = DataProcessor(trace_source=source({"n": 0}), device="cpu")
    first = {"uniqueId": "a", "time": 0}
    want1, got1 = jax_dp.collect(first), port_dp.collect(first)
    _assert_same_tick(got1, want1)
    second = {"uniqueId": "b", "time": 0, "existingDep": want1["dependencies"]}
    _assert_same_tick(port_dp.collect(second), jax_dp.collect(second))
    assert graph_signature(port_dp.graph) == graph_signature(jax_dp.graph)


def test_server_answers_like_collect():
    groups = _windows()["pdas"]
    request = {"uniqueId": "srv", "lookBack": 30_000, "time": 0}
    direct = DataProcessor(
        trace_source=lambda lb, t, lim: groups, device="cpu"
    ).collect(request)

    served = DataProcessor(trace_source=lambda lb, t, lim: groups, device="cpu")
    server = DataProcessorServer(served, host="127.0.0.1", port=0)
    server.start()
    try:
        base = f"http://127.0.0.1:{server.port}/"
        with urllib.request.urlopen(base, timeout=30) as resp:
            assert resp.status == 200
            assert json.loads(resp.read())["status"] == "UP"
        req = urllib.request.Request(
            base,
            data=gzip.compress(json.dumps(request).encode()),
            headers={
                "Content-Type": "application/json",
                "Content-Encoding": "gzip",
                "Accept-Encoding": "gzip",
            },
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert resp.status == 200
            assert resp.headers["Content-Encoding"] == "gzip"
            answer = json.loads(gzip.decompress(resp.read()))
        bad = urllib.request.Request(base, data=b"{not json", method="POST")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(bad, timeout=30)
        assert err.value.code == 400
    finally:
        server.stop()
    assert set(answer) == {"uniqueId", "combined", "dependencies", "datatype", "log"}
    answer.pop("log"), direct.pop("log")
    assert answer == direct


def test_body_merge_matches_jax():
    """Both packages merge and type bodies through their own build of
    the native JSON library (the port's copy of native/kmamiz_json.cpp),
    handing deeply nested groups back to the Python fold. Both must give
    the same (merged body, interface) pairs."""
    from kmamiz_tpu.core import schema as jax_schema
    from kmamiz_tpu_torch.core import schema as port_schema
    from test_processor_equivalence import BODIES

    pool = BODIES + [
        '{"a":[1,2,{"b":null}],"c":{"d":"x","e":[]}}',
        '[{"k":1},{"k":"s","z":[{"q":false}]}]',
        '{"n":1.5e3,"t":true,"u":"\\u00e9"}',
        '{"id":2,"tags":["c"],"extra":{"deep":{"deeper":[1]}}}',
        "[]",
        "{}",
        "null",
    ]
    rng = random.Random(5)
    pairs = [
        (
            [rng.choice(pool) for _ in range(rng.randint(1, 6))],
            rng.choice(["application/json", None, "text/plain"]),
        )
        for _ in range(300)
    ]
    assert port_schema.merge_and_infer_bodies(pairs) == jax_schema.merge_and_infer_bodies(
        pairs
    )


def test_dedup_time_to_live():
    """A trace seen within PROCESSED_TRACE_TTL_MS is skipped; the map
    forgets it after, in both packages (same injected clock)."""
    from kmamiz_tpu_torch.server.processor import PROCESSED_TRACE_TTL_MS

    groups = _windows()["random1"]
    clock = {"ms": 1_000_000.0}
    jax_dp = JaxProcessor(trace_source=lambda lb, t, lim: groups, now_ms=lambda: clock["ms"])
    port_dp = DataProcessor(
        trace_source=lambda lb, t, lim: groups, device="cpu", now_ms=lambda: clock["ms"]
    )
    sizes = []
    for step_ms in (0, PROCESSED_TRACE_TTL_MS + 1, 1):
        clock["ms"] += step_ms
        request = {"uniqueId": f"ttl{step_ms}", "time": 0}
        want, got = jax_dp.collect(request), port_dp.collect(request)
        _assert_same_tick(got, want)
        sizes.append(sum(c["combined"] for c in got["combined"]))
    # seen, still remembered (then pruned), seen again
    assert sizes[0] > 0 and sizes[1] == 0 and sizes[2] == sizes[0]

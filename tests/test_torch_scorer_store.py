"""The port's EndpointGraph scorer surface against the JAX EndpointGraph
and the port's host EndpointDependencies scorers: the same Bookinfo and
PDAS windows give the same lanes, `load_dependencies` from the same
records gives the same graph and lanes in both packages, deprecated
endpoints age out, and the scorer caches (output memo, device-resident
tables, dirty-service incremental recompute) stay bit-exact against the
uncached pipeline (the cases of tests/test_scorer_cache.py).

The JAX graphs grow by repacking, as the port's do, so both pad their
edge columns to the same capacity and the cohesion pair tables line up.
Tolerances as in tests/test_torch_scorers.py.
"""
from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from conftest import load_fixture, prefixed_trace_source
from kmamiz_tpu.core.spans import spans_to_batch as jax_spans_to_batch
from kmamiz_tpu.graph.store import EndpointGraph as JaxGraph
from kmamiz_tpu_torch import config
from kmamiz_tpu_torch.core.spans import spans_to_batch
from kmamiz_tpu_torch.domain.endpoint_dependencies import EndpointDependencies
from kmamiz_tpu_torch.domain.traces import Traces
from kmamiz_tpu_torch.graph import store as port_store
from kmamiz_tpu_torch.graph.store import EndpointGraph
from test_scorer_cache import EPS_PER_SVC, N_SVC, NOW_MS, mk_trace
from test_torch_scorers import FLOAT_RTOL

CORPORA = ["pdas", "bookinfo"]


def corpus(name):
    return [load_fixture("pdas_traces")] if name == "pdas" else load_fixture("bookinfo_traces")


def port_graph(groups):
    g = EndpointGraph(device="cpu")
    g.merge_window(spans_to_batch(groups, interner=g.interner))
    return g


def jax_graph(groups):
    batch = jax_spans_to_batch(groups)
    g = JaxGraph(interner=batch.interner, grow="repack")
    g.merge_window(batch)
    return g


def assert_same(got, want):
    assert type(got).__name__ == type(want).__name__
    for name, g, w in zip(want._fields, got, want):
        g, w = g.cpu().numpy(), np.asarray(w)
        if name in FLOAT_RTOL:
            np.testing.assert_allclose(g, w, rtol=FLOAT_RTOL[name], atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def assert_bits(a, b):
    assert type(a) is type(b)
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), name


def named_edges(g):
    s, d, dist, m = (np.asarray(x.cpu() if torch.is_tensor(x) else x) for x in g.edge_arrays())
    look = g.interner.endpoints.lookup
    return {(look(int(a)), look(int(b)), int(c)) for a, b, c in zip(s[m], d[m], dist[m])}


def host_deps(groups):
    """Per-record combineWith folds: the union the graph store keeps."""
    deps = EndpointDependencies([])
    for record in Traces(groups).to_endpoint_dependencies().to_json():
        deps = deps.combine_with(EndpointDependencies([record]))
    return deps


# ---------------------------------------------------------------------------
# parity with the JAX store and with the host scorers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", CORPORA)
def test_store_scores_match_jax(name):
    groups = corpus(name)
    pg, jg = port_graph(groups), jax_graph(groups)
    assert pg.capacity == jg.capacity
    assert pg._scorer_dist_bits() == jg._scorer_dist_bits()
    assert_same(pg.service_scores(), jg.service_scores())
    assert_same(pg.usage_cohesion(), jg.usage_cohesion())
    labeled = lambda uen: uen.split("\t")[4].split("?")[0]  # noqa: E731
    assert_same(pg.service_scores(label_of=labeled), jg.service_scores(label_of=labeled))
    np.testing.assert_array_equal(pg.active_services(), jg.active_services())


@pytest.mark.parametrize("name", CORPORA)
def test_store_scores_match_host(name):
    groups = corpus(name)
    g = port_graph(groups)
    deps = host_deps(groups)
    scores, cohesion, active = g.service_scores(), g.usage_cohesion(), g.active_services()
    services = g.interner.services
    rows = deps.to_service_instability()
    assert rows
    for h in rows:
        sid = services.get(h["uniqueServiceName"])
        assert active[sid]
        assert scores.instability_on[sid] == h["dependingOn"]
        assert scores.instability_by[sid] == h["dependingBy"]
        assert float(scores.instability[sid]) == pytest.approx(h["instability"])
    for h in deps.to_service_coupling():
        sid = services.get(h["uniqueServiceName"])
        assert (scores.ais[sid], scores.ads[sid], scores.acs[sid]) == (h["ais"], h["ads"], h["acs"])
    for h in deps.to_service_endpoint_cohesion():
        sid = services.get(h["uniqueServiceName"])
        assert cohesion.total_endpoints[sid] == h["totalEndpoints"]
        assert float(cohesion.usage_cohesion[sid]) == pytest.approx(h["endpointUsageCohesion"], rel=1e-6)


@pytest.mark.parametrize("name", CORPORA)
def test_load_dependencies_matches_jax(name):
    """The scorers' carried state: the same dependency records loaded in
    both packages give the same edges and lanes, and the same lanes as
    the graph built from spans."""
    groups = corpus(name)
    records = host_deps(groups).to_json()
    pg = EndpointGraph(device="cpu")
    pg.load_dependencies(records)
    jg = JaxGraph(grow="repack")
    jg.load_dependencies(records)
    assert named_edges(pg) == named_edges(jg) == named_edges(port_graph(groups))
    assert pg.label_epoch == 1 and pg._scorer_dist_bits() == jg._scorer_dist_bits()
    assert_same(pg.service_scores(), jg.service_scores())
    assert_same(pg.usage_cohesion(), jg.usage_cohesion())
    np.testing.assert_array_equal(pg.active_services(), jg.active_services())
    # the same lanes as the graph built from spans (ids agree by name)
    sg = port_graph(groups)
    s_spans, s_load = sg.service_scores(), pg.service_scores()
    for usn in host_deps(groups).to_service_instability():
        a = sg.interner.services.get(usn["uniqueServiceName"])
        b = pg.interner.services.get(usn["uniqueServiceName"])
        for lane in ("instability_on", "instability_by", "ais", "ads"):
            assert getattr(s_spans, lane)[a] == getattr(s_load, lane)[b], lane
        # the two graphs' distance bounds may pick different pipelines
        rf_spans, rf_load = float(s_spans.relying_factor[a]), float(s_load.relying_factor[b])
        assert rf_load == pytest.approx(rf_spans, rel=1e-5)


def _info(svc, url="u"):
    return {
        "uniqueServiceName": f"{svc}\tns\tv",
        "uniqueEndpointName": f"{svc}\tns\tv\tGET\t{url}",
        "service": svc, "namespace": "ns", "version": "v", "url": url,
        "host": "h", "path": "p", "port": "80", "method": "GET",
        "clusterName": "c", "timestamp": 1,
    }


LOAD_CASES = {
    # a distance-0 row must not hide the distance-1 link of the same pair
    "distance-0 row": [
        {"endpoint": _info("a"), "lastUsageTimestamp": 1, "dependingBy": [],
         "dependingOn": [{"endpoint": _info("b"), "distance": d, "type": "t"} for d in (0, 1)]},
        {"endpoint": _info("b"), "lastUsageTimestamp": 1, "dependingOn": [],
         "dependingBy": [{"endpoint": _info("a"), "distance": 1, "type": "t"}]},
    ],
    # b owns no record: it scores nothing as an owner
    "recordless endpoint": [
        {"endpoint": _info("a"), "lastUsageTimestamp": 1, "dependingBy": [],
         "dependingOn": [{"endpoint": _info("b"), "distance": 1, "type": "t"}]},
    ],
    # distances past 16 take the legacy pipeline
    "deep distances": [
        {"endpoint": _info("a"), "lastUsageTimestamp": 1, "dependingBy": [],
         "dependingOn": [{"endpoint": _info(f"s{d}"), "distance": d, "type": "t"} for d in (1, 9, 40)]},
    ],
}


@pytest.mark.parametrize("case", sorted(LOAD_CASES))
def test_loaded_edge_cases_match_jax(case):
    records = LOAD_CASES[case]
    pg = EndpointGraph(device="cpu")
    pg.load_dependencies(records)
    jg = JaxGraph(grow="repack")
    jg.load_dependencies(records)
    assert pg._scorer_dist_bits() == jg._scorer_dist_bits()
    assert_same(pg.service_scores(), jg.service_scores())
    assert_same(pg.usage_cohesion(), jg.usage_cohesion())
    scores, coh = pg.service_scores(), pg.usage_cohesion()
    sid_a, sid_b = pg.interner.services.get("a\tns\tv"), pg.interner.services.get("b\tns\tv")
    if case == "distance-0 row":
        assert scores.ads[sid_a] == 1 and scores.ais[sid_b] == 1
    if case == "recordless endpoint":
        assert scores.instability_on[sid_a] == 1 and scores.ads[sid_a] == 1
        assert scores.instability_by[sid_b] == 0 and scores.ais[sid_b] == 0
        assert coh.consumer_count[sid_b] == 0
        assert not torch.any(coh.pair_owner[coh.pair_valid] == sid_b)
    if case == "deep distances":
        assert pg._scorer_dist_bits() is None


def test_dist_bounds_track_every_merge_path():
    """The dist_bits promise follows the distances of every merge path,
    as the JAX store's does: the tick's host edges, the walk (its depth),
    bulk edges, folded exports and loaded records."""
    pdas = [load_fixture("pdas_traces")]
    pg, jg = EndpointGraph(device="cpu"), JaxGraph(grow="repack")
    assert pg._scorer_dist_bits() == jg._scorer_dist_bits() == 3
    pg.merge_window_edges([], spans_to_batch([], interner=pg.interner))
    pg.merge_window(spans_to_batch(pdas, interner=pg.interner))
    jg.merge_window(jax_spans_to_batch(pdas, interner=jg.interner))
    assert (pg._min_dist, pg._max_dist) == (jg._min_dist, jg._max_dist)
    ids = [pg.interner.intern_endpoint(f"x\tns\tv\tGET\t/{i}") for i in range(3)]
    pg.merge_edges(np.array(ids[:2]), np.array(ids[1:]), np.array([1, 12]))
    assert pg._scorer_dist_bits() == 4
    other = EndpointGraph(device="cpu")
    other.fold_named_edges({"names": ["p\tn\tv\tGET\t/a", "q\tn\tv\tGET\t/b"], "src": [0], "dst": [1], "dist": [20]})
    assert other._scorer_dist_bits() is None
    loaded = EndpointGraph(device="cpu")
    loaded.load_dependencies(LOAD_CASES["distance-0 row"])
    assert (loaded._min_dist, loaded._max_dist) == (0, 1)
    neg = EndpointGraph(device="cpu")
    neg.load_dependencies([{**LOAD_CASES["recordless endpoint"][0],
                            "dependingOn": [{"endpoint": _info("b"), "distance": -1, "type": "t"}]}])
    assert neg._scorer_dist_bits() is None
    # the tick's host-edge path
    tick = EndpointGraph(device="cpu")
    batch = spans_to_batch(pdas, interner=tick.interner)
    edges = [(a, b, 5) for a, b in zip(tick.interner.endpoints.strings[:2], tick.interner.endpoints.strings[1:3])]
    assert tick.merge_window_edges(edges, batch)
    assert (tick._min_dist, tick._max_dist) == (1, 5)


def test_deprecated_endpoints_age_out(monkeypatch):
    pdas = [load_fixture("pdas_traces")]
    batch = spans_to_batch(pdas)
    g = EndpointGraph(device="cpu", interner=batch.interner)
    g.merge_window(batch)
    monkeypatch.setattr(config.settings, "deprecated_endpoint_threshold", "1d")
    # the fixture's spans are from 2022: everything is stale against now
    assert not g.active_services().any()
    assert float(g.service_scores().instability_on.sum()) == 0
    assert float(g.usage_cohesion().usage_cohesion.sum()) == 0
    now = float(batch.timestamp_us[: batch.n_spans].max()) / 1000 + 1
    assert g.active_services(now_ms=now).any()
    assert float(g.service_scores(now_ms=now).instability_on.sum()) > 0
    assert_bits(g.service_scores(now_ms=now), g.service_scores_uncached(now_ms=now))
    monkeypatch.setattr(config.settings, "deprecated_endpoint_threshold", "")
    assert g.active_services().any()


# ---------------------------------------------------------------------------
# the scorer caches (tests/test_scorer_cache.py's cases)
# ---------------------------------------------------------------------------


def small_graph():
    groups = [mk_trace(f"t{i}", f"svc{i % 3}", i % 2, f"svc{(i + 1) % 3}", i % 2) for i in range(6)]
    return port_graph(groups)


def ring_graph():
    """svc0 -> svc1 -> ... -> svc59 -> svc0, five endpoints each: enough
    edges that the capacity clears the incremental subset's minimum."""
    groups = [
        mk_trace(f"init-{i}-{j}", f"svc{i}", j, f"svc{(i + 1) % N_SVC}", j)
        for i in range(N_SVC)
        for j in range(EPS_PER_SVC)
    ]
    return port_graph(groups)


def test_memo_hit_with_zero_uploads():
    graph = small_graph()
    first = graph.service_scores(now_ms=NOW_MS)
    before = graph.scorer_cache_stats()
    second = graph.service_scores(now_ms=NOW_MS)
    after = graph.scorer_cache_stats()
    assert second is first
    assert after["uploads"] == before["uploads"]
    assert after["hits"] == before["hits"] + 1 and after["misses"] == before["misses"]
    assert_bits(first, graph.service_scores_uncached(now_ms=NOW_MS))


def test_cohesion_memo_and_parity():
    graph = small_graph()
    first = graph.usage_cohesion(now_ms=NOW_MS)
    assert graph.usage_cohesion(now_ms=NOW_MS) is first
    assert_bits(first, graph.usage_cohesion_uncached(now_ms=NOW_MS))
    graph.service_scores(now_ms=NOW_MS)
    assert graph.usage_cohesion(now_ms=NOW_MS) is first


def test_memo_invalidates_on_merge():
    graph = small_graph()
    first = graph.service_scores(now_ms=NOW_MS)
    graph.merge_window(spans_to_batch([mk_trace("new-0", "svc0", 7, "svc1", 7)], interner=graph.interner))
    second = graph.service_scores(now_ms=NOW_MS)
    assert second is not first
    assert_bits(second, graph.service_scores_uncached(now_ms=NOW_MS))


def test_cache_invalidates_on_invalidate_labels():
    graph = small_graph()
    first = graph.service_scores(now_ms=NOW_MS)
    coh_first = graph.usage_cohesion(now_ms=NOW_MS)
    epoch = graph.label_epoch
    graph.invalidate_labels()
    assert graph.label_epoch == epoch + 1
    second = graph.service_scores(now_ms=NOW_MS)
    assert second is not first
    assert graph.usage_cohesion(now_ms=NOW_MS) is not coh_first
    assert_bits(second, graph.service_scores_uncached(now_ms=NOW_MS))
    assert graph.service_scores(now_ms=NOW_MS) is second


def test_label_of_keyed_separately():
    graph = small_graph()
    plain = graph.service_scores(now_ms=NOW_MS)
    labeled = graph.service_scores(label_of=lambda uen: uen, now_ms=NOW_MS)
    assert labeled is not plain
    assert graph.service_scores(now_ms=NOW_MS) is plain


def test_cache_invalidates_on_fresh_horizon_expiry(monkeypatch):
    monkeypatch.setattr(config.settings, "deprecated_endpoint_threshold", "1d")
    graph = small_graph()
    in_window = graph.service_scores(now_ms=NOW_MS)
    late_ms = NOW_MS + 3 * 86_400_000
    expired = graph.service_scores(now_ms=late_ms)
    assert expired is not in_window
    assert float(expired.instability_on.sum()) == 0
    assert_bits(expired, graph.service_scores_uncached(now_ms=late_ms))
    assert graph.service_scores(now_ms=late_ms) is expired
    assert graph.service_scores(now_ms=NOW_MS) is in_window


@pytest.mark.parametrize("seed", [7, 11])
def test_incremental_parity_over_randomized_merges(seed):
    """After every merge the cached scorers equal the uncached pipeline
    bit for bit, and the incremental path fired at least once."""
    rng = random.Random(seed)
    graph = ring_graph()
    assert_bits(graph.service_scores(now_ms=NOW_MS), graph.service_scores_uncached(now_ms=NOW_MS))
    for step in range(6):
        touched = rng.sample(range(N_SVC), rng.randint(1, 2))
        groups = []
        for s in touched:
            for j in range(rng.randint(1, 3)):
                ep = rng.randint(0, EPS_PER_SVC + 1)
                groups.append(mk_trace(f"m{step}-{s}-{j}", f"svc{s}", ep, f"svc{(s + 1) % N_SVC}", ep))
        graph.merge_window(spans_to_batch(groups, interner=graph.interner))
        assert_bits(graph.service_scores(now_ms=NOW_MS), graph.service_scores_uncached(now_ms=NOW_MS))
        assert_bits(graph.usage_cohesion(now_ms=NOW_MS), graph.usage_cohesion_uncached(now_ms=NOW_MS))
    stats = graph.scorer_cache_stats()
    assert stats["incremental"] >= 1 and stats["full"] >= 1, stats


def test_incremental_matches_jax_over_the_same_merges():
    """The incremental lanes equal the JAX store's after the same merges."""
    base = [
        mk_trace(f"init-{i}-{j}", f"svc{i}", j, f"svc{(i + 1) % N_SVC}", j)
        for i in range(N_SVC)
        for j in range(EPS_PER_SVC)
    ]
    pg = port_graph(base)
    jg = jax_graph(base)
    pg.service_scores(now_ms=NOW_MS)
    jg.service_scores(now_ms=NOW_MS)
    window = [mk_trace("m-0", "svc3", 1, "svc4", 6), mk_trace("m-1", "svc9", 2, "svc10", 2)]
    pg.merge_window(spans_to_batch(window, interner=pg.interner))
    jg.merge_window(jax_spans_to_batch(window, interner=jg.interner))
    assert_same(pg.service_scores(now_ms=NOW_MS), jg.service_scores(now_ms=NOW_MS))
    assert pg.scorer_cache_stats()["incremental"] == 1


def test_incremental_disabled_above_dirty_fraction(monkeypatch):
    monkeypatch.setattr(port_store, "DIRTY_FRACTION", 0.0)
    graph = ring_graph()
    graph.service_scores(now_ms=NOW_MS)
    graph.merge_window(spans_to_batch([mk_trace("x-0", "svc0", 0, "svc1", 0)], interner=graph.interner))
    inc_before = graph.scorer_cache_stats()["incremental"]
    scores = graph.service_scores(now_ms=NOW_MS)
    assert graph.scorer_cache_stats()["incremental"] == inc_before
    assert_bits(scores, graph.service_scores_uncached(now_ms=NOW_MS))


def test_journal_overflow_takes_the_full_recompute(monkeypatch):
    monkeypatch.setattr(port_store, "DIRTY_JOURNAL_MAX", 1)
    graph = ring_graph()
    graph.service_scores(now_ms=NOW_MS)
    for k in range(2):
        graph.merge_window(spans_to_batch([mk_trace(f"x-{k}", "svc0", 0, "svc1", 0)], interner=graph.interner))
    stats = graph.scorer_cache_stats()
    assert stats["journal_len"] == 1
    scores = graph.service_scores(now_ms=NOW_MS)
    after = graph.scorer_cache_stats()
    assert after["incremental"] == stats["incremental"] and after["full"] == stats["full"] + 1
    assert_bits(scores, graph.service_scores_uncached(now_ms=NOW_MS))


def test_incremental_empty_window_reuses_base():
    graph = ring_graph()
    base = graph.service_scores(now_ms=NOW_MS)
    graph.merge_window(spans_to_batch([], interner=graph.interner))
    before = graph.scorer_cache_stats()
    again = graph.service_scores(now_ms=NOW_MS)
    after = graph.scorer_cache_stats()
    assert again is base
    assert after["uploads"] == before["uploads"]
    assert after["incremental"] == before["incremental"] + 1


def test_bulk_merge_drops_incremental_bases():
    graph = ring_graph()
    graph.service_scores(now_ms=NOW_MS)
    ids = list(range(4))
    graph.merge_edges(ids[:2], ids[2:], [1, 1])
    stats = graph.scorer_cache_stats()
    assert stats["memo_entries"] == 0 and stats["journal_len"] == 0
    graph.service_scores(now_ms=NOW_MS)
    assert graph.scorer_cache_stats()["full"] == stats["full"] + 1


def test_forecast_memo_keys_on_the_label_epoch():
    """The forecast memo hits while the label epoch is unchanged (scorer
    reads do not move it), and the next fold carries a moved epoch."""
    from test_torch_forecast import H, _drive, _port_router

    from kmamiz_tpu_torch.models import serving
    from kmamiz_tpu_torch.server.processor import DataProcessor

    dp = DataProcessor(trace_source=prefixed_trace_source(load_fixture("pdas_traces"), "e"), device="cpu")
    router = _port_router(dp)
    _drive(dp, [910, 911])
    fc = router.dispatch("GET", "/api/v1/model/forecast").payload
    calls = serving.serve_stats()["calls"]
    epoch = dp.graph.label_epoch
    dp.graph.service_scores()
    dp.graph.usage_cohesion()
    assert dp.graph.label_epoch == epoch
    assert router.dispatch("GET", "/api/v1/model/forecast").payload is fc
    assert serving.serve_stats()["calls"] == calls
    dp.graph.invalidate_labels()
    dp.collect({"uniqueId": "f", "lookBack": 30_000, "time": 912 * H})
    assert dp.forecast_snapshot["cache_key"][1] == epoch + 1
    assert router.dispatch("GET", "/api/v1/model/forecast").payload is not fc

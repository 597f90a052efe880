"""The port's staged store merges and upload pipeline against the JAX
package's, on the CPU.

The staged cases of tests/test_graph_scorers.py, each run on the port's
EndpointGraph and on the JAX store grown with grow="repack" (the port's
only growth mode), with the port's stage constants set to the JAX test's
environment values: the graphs must carry the same edges as the fused
merge and as each other, the staging accounting must agree, and the
drain must leave nothing staged. Each case runs twice: as the CPU runs
it (every staged count has landed) and with the store's readiness probe
answering "not ready" for every count, which drives the branches that
defer a truncation check to the drain; the graph must not change.

The pipeline cases hold the port's UploadPipeline to the JAX one's
accounting at depths 0, 1 and 2, fences included.
"""
from __future__ import annotations

import numpy as np
import pytest

from kmamiz_tpu.core.spans import spans_to_batch as jax_spans_to_batch
from kmamiz_tpu.graph.store import EndpointGraph as JaxGraph
from kmamiz_tpu.ops.double_buffer import UploadPipeline as JaxPipeline
from kmamiz_tpu.resilience.chaos import graph_signature as jax_signature
from kmamiz_tpu_torch.core.spans import spans_to_batch
from kmamiz_tpu_torch.graph import store as port_store
from kmamiz_tpu_torch.ops.double_buffer import AsyncCount, UploadPipeline

import torch


@pytest.fixture(params=[False, True], ids=["landed", "deferred"])
def deferred(request, monkeypatch):
    """Whether every staged count reads as not landed yet."""
    if request.param:
        monkeypatch.setattr(port_store, "count_ready", lambda count: False)
    return request.param


def _stage_constants(monkeypatch, cap=None, max_rows=None):
    """The JAX test's environment values, on both stores."""
    if cap is not None:
        monkeypatch.setenv("KMAMIZ_STAGE_CAP", str(cap))
        monkeypatch.setattr(port_store, "STAGE_CAP", cap)
    if max_rows is not None:
        monkeypatch.setenv("KMAMIZ_STAGE_MAX_ROWS", str(max_rows))
        monkeypatch.setattr(port_store, "STAGE_MAX_ROWS", max_rows)


def _pair(capacity=1024):
    return (
        port_store.EndpointGraph(capacity=capacity, device="cpu"),
        JaxGraph(capacity=capacity, grow="repack"),
    )


def _edge_set(graph):
    s, d, dist, m = (
        a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a) for a in graph.edge_arrays()
    )
    return {(int(a), int(b), int(c)) for a, b, c in zip(s[m], d[m], dist[m])}


def _assert_same_graph(port, ref):
    assert port.n_edges == ref.n_edges
    assert port.capacity == ref.capacity
    assert port_store.graph_signature(port) == jax_signature(ref)


def _groups(traces):
    return traces if isinstance(traces[0], list) else [traces]


def test_staged_merge_equals_fused(bookinfo_traces, deferred):
    """Staged merges (a walk per window, one union at the drain) give the
    fused merges' edge set, in both packages."""
    fused = port_store.EndpointGraph(device="cpu")
    for group in bookinfo_traces:
        fused.merge_window(spans_to_batch([group], interner=fused.interner))

    staged, ref = _pair()
    v0 = staged.version
    for group in bookinfo_traces:
        staged.merge_window(spans_to_batch([group], interner=staged.interner), stage=True)
        ref.merge_window(jax_spans_to_batch([group], interner=ref.interner), stage=True)
        # (the held-input rows of deferred checks are not compared: which
        # JAX counts have landed depends on its asynchronous dispatch)
        assert staged._staged_rows == ref._staged_rows
    assert staged.version == ref.version > v0  # staging bumps the version
    # nothing adopted before the first read: windows sit staged or in the
    # pending pre-union
    assert staged._staged or staged._preunion is not None
    assert staged.n_edges == fused.n_edges  # the read drains
    assert not staged._staged and staged._preunion is None
    assert staged._preunion_rows == 0 and not staged._preunion_checks
    assert _edge_set(staged) == _edge_set(fused)
    _assert_same_graph(staged, ref)


def test_stage_backstop_counts_pinned_inputs(pdas_traces, monkeypatch, deferred):
    """The backstop counts the held walk inputs, not only the compacted
    prefixes: with STAGE_CAP 8 and STAGE_MAX_ROWS 32 the one-trace PDAS
    window (8 prefix rows + 64 packed slots) drains inline."""
    _stage_constants(monkeypatch, cap=8, max_rows=32)
    g, ref = _pair()
    g.merge_window(spans_to_batch([pdas_traces], interner=g.interner), stage=True)
    ref.merge_window(jax_spans_to_batch([pdas_traces], interner=ref.interner), stage=True)
    assert not g._staged and not ref._staged  # the backstop drained inline
    assert g._n_edges == ref._n_edges > 0
    _assert_same_graph(g, ref)


def test_staged_and_fused_interleave(pdas_traces, bookinfo_traces, deferred):
    """A fused merge (a tick) landing between staged stream chunks loses
    neither side's edges."""
    groups = _groups(pdas_traces) + bookinfo_traces
    whole = port_store.EndpointGraph(device="cpu")
    for group in groups:
        whole.merge_window(spans_to_batch([group], interner=whole.interner))

    mixed, ref = _pair()
    for i, group in enumerate(groups):
        mixed.merge_window(spans_to_batch([group], interner=mixed.interner), stage=(i % 2 == 0))
        ref.merge_window(jax_spans_to_batch([group], interner=ref.interner), stage=(i % 2 == 0))
    assert mixed.n_edges == whole.n_edges
    assert _edge_set(mixed) == _edge_set(whole)
    _assert_same_graph(mixed, ref)


def _dist_zero_records():
    info = {
        "uniqueServiceName": "a\tns\tv", "uniqueEndpointName": "a\tns\tv\tGET\tu",
        "service": "a", "namespace": "ns", "version": "v", "url": "u",
        "host": "h", "path": "p", "port": "80", "method": "GET",
        "clusterName": "c", "timestamp": 1,
    }
    dep_info = {**info, "uniqueEndpointName": "b\tns\tv\tGET\tu",
                "uniqueServiceName": "b\tns\tv", "service": "b"}
    return [
        {
            "endpoint": info,
            "lastUsageTimestamp": 1,
            "dependingOn": [{"endpoint": dep_info, "distance": 0, "type": "t"}],
            "dependingBy": [],
        }
    ]


def test_out_of_range_loaded_distance_stays_exact(pdas_traces, deferred):
    """A loaded record of distance 0 keeps the drain off the packed
    single-key sort (dist - 1 would wrap the key): the generic union keeps
    the edge exact."""
    g, ref = _pair()
    for graph in (g, ref):
        graph.load_dependencies(_dist_zero_records())
    groups = _groups(pdas_traces)
    g.merge_window(spans_to_batch(groups, interner=g.interner), stage=True)
    ref.merge_window(jax_spans_to_batch(groups, interner=ref.interner), stage=True)
    edges = _edge_set(g)
    eid_a = g.interner.endpoints.get("a\tns\tv\tGET\tu")
    eid_b = g.interner.endpoints.get("b\tns\tv\tGET\tu")
    assert (eid_a, eid_b, 0) in edges  # exact, not garbage
    assert all(c < 1_000_000 and a >= 0 for a, _b, c in edges)
    _assert_same_graph(g, ref)


def test_merge_edges_bulk_union(pdas_traces, deferred):
    """Bulk edge unions share the window merges' capacity policy and
    coexist with a staged window merge."""
    import jax.numpy as jnp

    g, ref = _pair(capacity=8)
    bulk = [([1, 2, 3, 1], [4, 5, 6, 4], [1, 2, 1, 1]), ([1, 9], [4, 9], [1, 3])]
    v0 = g.version
    for (src, dst, dist), n in zip(bulk, (3, 4)):
        g.merge_edges(np.asarray(src), np.asarray(dst), np.asarray(dist, np.int32))
        ref.merge_edges(*(jnp.asarray(c, jnp.int32) for c in (src, dst, dist)))
        assert g.n_edges == ref.n_edges == n  # the duplicate (1, 4, 1) collapsed
    assert g.version > v0
    groups = _groups(pdas_traces)
    g.merge_window(spans_to_batch(groups, interner=g.interner), stage=True)
    ref.merge_window(jax_spans_to_batch(groups, interner=ref.interner), stage=True)
    only_window = port_store.EndpointGraph(device="cpu")
    only_window.merge_window(spans_to_batch(groups, interner=only_window.interner))
    assert g.n_edges == 4 + only_window.n_edges
    assert g.capacity >= g.n_edges and g.capacity & (g.capacity - 1) == 0
    _assert_same_graph(g, ref)


def test_preunion_truncation_rewalks(bookinfo_traces, monkeypatch, deferred):
    """With STAGE_CAP far below a window's distinct edges every prefix
    truncates: whichever branch resolves a check (landed at the pre-union,
    or deferred to the drain), the re-walk reproduces the fused edge set
    and the held-input accounting returns to zero."""
    _stage_constants(monkeypatch, cap=4)
    fused = port_store.EndpointGraph(device="cpu")
    for group in bookinfo_traces:
        fused.merge_window(spans_to_batch([group], interner=fused.interner))

    staged, ref = _pair()
    for group in bookinfo_traces:
        staged.merge_window(spans_to_batch([group], interner=staged.interner), stage=True)
        ref.merge_window(jax_spans_to_batch([group], interner=ref.interner), stage=True)
    assert staged._preunion is not None  # the stream pre-unioned
    if deferred:
        assert staged._preunion_checks  # the checks waited for the drain
    assert staged.n_edges == fused.n_edges
    assert staged._preunion is None and not staged._preunion_checks
    assert staged._preunion_rows == 0
    assert _edge_set(staged) == _edge_set(fused)
    _assert_same_graph(staged, ref)


def test_stage_fence_and_upload_stats_match_jax(bookinfo_traces):
    """A staged stream, a fence, a fused merge and a read leave the same
    upload counters and fence answer in both stores."""
    g, ref = _pair()
    for group in bookinfo_traces[:3]:
        g.merge_window(spans_to_batch([group], interner=g.interner), stage=True)
        ref.merge_window(jax_spans_to_batch([group], interner=ref.interner), stage=True)
    assert g.stage_fence() == ref.stage_fence() == {"version": 3, "in_flight": 0}
    for group in bookinfo_traces[3:]:
        g.merge_window(spans_to_batch([group], interner=g.interner))
        ref.merge_window(jax_spans_to_batch([group], interner=ref.interner))
    _assert_same_graph(g, ref)
    got, want = g.upload_stats(), ref.upload_stats()
    for stats in (got, want):
        del stats["blocked_ms"], stats["blocked_ms_per_upload"]
    assert got == want
    assert got["fences"] == 1 and got["uploads"] == len(bookinfo_traces)


def _arrays(k):
    rng = np.random.default_rng(k)
    return (
        rng.integers(-1, 64, (8, 64), dtype=np.int32),
        rng.random((8, 64)) < 0.5,
    )


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_upload_pipeline_accounting_matches_jax(depth):
    """Uploads, in-flight groups, their peak and the fence count follow
    the JAX pipeline's step for step; the tensors are the host arrays."""
    port, ref = UploadPipeline("cpu", depth), JaxPipeline(depth)
    for k in range(4):
        host = _arrays(k)
        out, waited = port.put(host)
        ref.put(host)
        assert waited >= 0.0
        for got, want in zip(out, host):
            assert got.device.type == "cpu" and np.array_equal(got.numpy(), want)
        assert port.stats()["in_flight"] == ref.stats()["in_flight"] == min(k + 1, depth)
    port.note_fence()
    ref.note_fence()
    assert port.drain() >= 0.0
    ref.drain()
    got, want = port.stats(), ref.stats()
    for stats in (got, want):
        del stats["blocked_ms"], stats["blocked_ms_per_upload"]
    assert got == want
    assert got["uploads"] == 4 and got["in_flight"] == 0 and got["fences"] == 1
    assert got["peak_in_flight"] == min(depth, 4)
    assert got["mode"] == ("sync" if depth == 0 else "pipelined")


def test_async_count_on_the_cpu():
    count = AsyncCount(torch.tensor(7, dtype=torch.int64))
    assert count.ready() and int(count) == 7
    assert port_store.count_ready(count)

"""The port's device mesh (kmamiz_tpu_torch/parallel/mesh.py) on eight
virtual CPU shards, against the JAX package's mesh on conftest's eight
virtual CPU devices and against the port's own single-device path.

A counterpart of each case of tests/test_parallel.py, on the same inputs.
Tolerances:

- Sharded window stats: counts, 4xx/5xx and timestamps equal; latency
  mean within rel 1e-5; CV within rel 1e-3 / abs 1e-5 (the tick's
  tolerances): the merges add the shards' float32 partials in another
  order than one device's scatter.
- Ring collectives: the port's rings add in the reference's step order,
  so they equal JAX's rings bit for bit; against a psum (which adds in
  shard order) rel 1e-5 / abs 1e-6, as the reference test holds its ring
  against XLA's psum. Max merges are exact.
- Layouts (shard_window, shard_window_packed) and the sharded walks' edge
  sets: equal.
- Sharded service scores: integer lanes and instability equal, relying
  factor and risk within rel 1e-5 (PERF.md §2's scorer tolerances).
- Slot grads: rtol 1e-5 / atol 1e-6 against the single-device per-slot
  loop (the port's, and the JAX loop the reference's failing test builds;
  JAX's own make_sharded_slot_grad is not the oracle: ROADMAP.md §C).
- Training on the mesh: losses rtol 1e-4 / atol 1e-5, params rtol 1e-3 /
  atol 1e-5, as tests/test_parallel.py holds the JAX trainer.

The deployed path runs with `process_devices` patched to eight virtual
CPU shards (the `shards8` fixture), the counterpart of conftest's
--xla_force_host_platform_device_count=8.
"""
from __future__ import annotations

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmamiz_tpu.parallel import mesh as jax_mesh
from kmamiz_tpu_torch.core.spans import KIND_SERVER
from kmamiz_tpu_torch.ops import window
from kmamiz_tpu_torch.parallel import mesh as pmesh

CPU8 = [torch.device("cpu")] * 8
EXACT_SCORES = ("instability_on", "instability_by", "instability", "ais", "ads", "acs", "is_gateway")


@pytest.fixture(scope="module")
def mesh8():
    return pmesh.make_mesh(8, devices=CPU8)


@pytest.fixture(scope="module")
def jmesh8():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return jax_mesh.make_mesh(8)


@pytest.fixture
def shards8(monkeypatch):
    """The process sees eight virtual CPU shards (the deployed path's
    mesh); KMAMIZ_MESH is left to each test."""
    real = pmesh.process_devices

    def devices(device):
        return list(CPU8) if torch.device(device).type == "cpu" else real(device)

    monkeypatch.setattr(pmesh, "process_devices", devices)
    monkeypatch.delenv("KMAMIZ_MESH_DEVICES", raising=False)
    monkeypatch.delenv("KMAMIZ_TENANT_SHARD", raising=False)


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _stat_args(w):
    vs = w.valid & (w.kind == KIND_SERVER)
    return (w.rt_endpoint_id, w.status_id, w.status_class, w.latency_ms, w.timestamp_rel, vs)


def _sizes(w):
    return len(w.batches[0].interner.endpoints), max(len(w.batches[0].statuses), 1)


def _assert_stats(got, want):
    """The tick's tolerances over two WindowStats (either package's)."""
    for name in ("count", "error_4xx", "error_5xx", "latest_timestamp_rel"):
        np.testing.assert_array_equal(_np(getattr(got, name)), _np(getattr(want, name)), err_msg=name)
    np.testing.assert_allclose(_np(got.latency_mean), _np(want.latency_mean), rtol=1e-5, err_msg="mean")
    np.testing.assert_allclose(_np(got.latency_cv), _np(want.latency_cv), rtol=1e-3, atol=1e-5, err_msg="cv")


def _port_stats(mesh, w, **kw):
    ne, ns = _sizes(w)
    return pmesh.sharded_window_stats(mesh, *(torch.from_numpy(a) for a in _stat_args(w)), num_endpoints=ne, num_statuses=ns, **kw)


def _jax_stats(mesh, w, **kw):
    ne, ns = _sizes(w)
    return jax_mesh.sharded_window_stats(mesh, *(jnp.asarray(a) for a in _stat_args(w)), num_endpoints=ne, num_statuses=ns, **kw)


def _single_stats(w):
    ne, ns = _sizes(w)
    return window.window_stats(*(torch.from_numpy(a) for a in _stat_args(w)), num_endpoints=ne, num_statuses=ns)


def test_sharded_stats_match_single_device(bookinfo_traces, mesh8, jmesh8):
    w = pmesh.shard_window(bookinfo_traces, 8)
    stats = _port_stats(mesh8, w)
    _assert_stats(stats, _single_stats(w))
    _assert_stats(stats, _jax_stats(jmesh8, jax_mesh.shard_window(bookinfo_traces, 8)))
    assert float(stats.count.sum()) == sum(1 for g in bookinfo_traces for s in g if s["kind"] == "SERVER")


SHARDED_FIELDS = (
    "valid", "kind", "parent_idx", "endpoint_id", "rt_endpoint_id",
    "status_id", "status_class", "latency_ms", "timestamp_rel",
)


def test_shard_window_layouts_match_jax(bookinfo_traces):
    for groups in (bookinfo_traces, _random_groups("layout")):
        got, want = pmesh.shard_window(groups, 8), jax_mesh.shard_window(groups, 8)
        for name in SHARDED_FIELDS:
            np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
        assert (got.per_shard, got.ts_base_us) == (want.per_shard, want.ts_base_us)
        got_p, want_p = pmesh.shard_window_packed(got), jax_mesh.shard_window_packed(want)
        assert got_p[-1] == want_p[-1]
        for a, b in zip(got_p[:-1], want_p[:-1]):
            np.testing.assert_array_equal(a, b)


def _edge_set(anc, desc, dist, mask):
    anc, desc, dist, mask = (_np(x) for x in (anc, desc, dist, mask))
    return {(int(a), int(d), int(dd)) for a, d, dd in zip(anc[mask], desc[mask], dist[mask])}


def _unsharded(cols):
    return tuple(pmesh.unshard(c, "cpu") for c in cols)


def _host_edges(groups):
    from kmamiz_tpu_torch.domain.traces import Traces

    out = set()
    for d in Traces(groups).to_endpoint_dependencies().to_json():
        name = d["endpoint"]["uniqueEndpointName"]
        for b in d["dependingOn"]:
            # the owner is the ancestor; dependingOn targets are descendants
            out.add((b["endpoint"]["uniqueEndpointName"], name, b["distance"]))
    return out


def test_sharded_edges_match_host(bookinfo_traces, mesh8, jmesh8):
    w = pmesh.shard_window(bookinfo_traces, 8)
    edges = _edge_set(*_unsharded(pmesh.sharded_dependency_edges(mesh8, w.parent_idx, w.kind, w.valid, w.endpoint_id)))
    lookup = w.batches[0].interner.endpoints.lookup
    assert {(lookup(d), lookup(a), dd) for a, d, dd in edges} == _host_edges(bookinfo_traces)
    jw = jax_mesh.shard_window(bookinfo_traces, 8)
    want = jax_mesh.sharded_dependency_edges(jmesh8, *(jnp.asarray(a) for a in (jw.parent_idx, jw.kind, jw.valid, jw.endpoint_id)))
    assert edges == _edge_set(*want)


def _jax_shard_map(fn, mesh, x, in_spec, out_spec):
    return np.asarray(
        jax_mesh.shard_map(fn, mesh=mesh, in_specs=(in_spec,), out_specs=out_spec, check_vma=False)(jnp.asarray(x))
    )


class TestRingCollectives:
    """The port's rings match its psum/pmax, and JAX's rings bit for bit."""

    def test_ring_all_reduce_matches_psum(self, jmesh8):
        from jax.sharding import PartitionSpec as P

        x = np.random.default_rng(0).normal(size=(8, 64)).astype(np.float32)
        xs = pmesh.shard(x.reshape(-1), CPU8)
        ring, ref = pmesh.ring_all_reduce(xs), pmesh.psum(xs)
        for a, b in zip(ring, ref):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)
        want = _jax_shard_map(lambda v: jax_mesh.ring_all_reduce(v, "spans", 8), jmesh8, x.reshape(-1), P("spans"), P())
        for a in ring:
            np.testing.assert_array_equal(a.numpy(), want)

    def test_ring_max(self, jmesh8):
        from jax.sharding import PartitionSpec as P

        x = np.random.default_rng(1).integers(0, 1000, size=(8, 48)).astype(np.int32)
        xs = pmesh.shard(x.reshape(-1), CPU8)
        ring, ref = pmesh.ring_all_reduce(xs, op="max"), pmesh.pmax(xs)
        want = _jax_shard_map(lambda v: jax_mesh.ring_all_reduce(v, "spans", 8, op="max"), jmesh8, x.reshape(-1), P("spans"), P())
        for a, b in zip(ring, ref):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
            np.testing.assert_array_equal(a.numpy(), want)

    def test_ring_reduce_scatter_ownership(self, jmesh8):
        """Shard i owns the fully reduced chunk i after the reduce-scatter."""
        from jax.sharding import PartitionSpec as P

        x = np.random.default_rng(2).normal(size=(8, 8 * 16)).astype(np.float32)
        out = torch.cat(pmesh.ring_reduce_scatter(pmesh.shard(x.reshape(-1), CPU8))).numpy()
        np.testing.assert_allclose(out, x.sum(axis=0), rtol=1e-5)
        want = _jax_shard_map(lambda v: jax_mesh.ring_reduce_scatter(v, "spans", 8), jmesh8, x.reshape(-1), P("spans"), P("spans"))
        np.testing.assert_array_equal(out, want)
        with pytest.raises(ValueError, match="divisible by 8"):
            pmesh.ring_reduce_scatter(pmesh.shard(np.zeros(8 * 12, np.float32), CPU8))

    def test_sharded_window_stats_ring_matches_psum(self, bookinfo_traces, mesh8, jmesh8):
        w = pmesh.shard_window(bookinfo_traces, 8)
        a, b = _port_stats(mesh8, w, merge="psum"), _port_stats(mesh8, w, merge="ring")
        for fa, fb in zip(a, b):
            np.testing.assert_allclose(fa.numpy(), fb.numpy(), rtol=1e-5, atol=1e-6)
        _assert_stats(b, _jax_stats(jmesh8, jax_mesh.shard_window(bookinfo_traces, 8), merge="ring"))


def _grid():
    return pmesh.Mesh(np.array(CPU8, dtype=object).reshape(2, 4), ("host", "spans"))


class TestHierarchicalMerge:
    """The within-host ring / across-host reduce equals a flat psum on a
    2 x 4 ('host', 'spans') grid."""

    def test_hierarchical_all_reduce_matches_psum(self):
        from jax.sharding import Mesh as JaxMesh
        from jax.sharding import PartitionSpec as P

        x = np.random.default_rng(3).normal(size=(8, 64)).astype(np.float32)
        xs = pmesh.shard(x.reshape(-1), _grid().device_list())
        hier, ref = pmesh.hierarchical_all_reduce(xs, 4), pmesh.psum(xs)
        for a, b in zip(hier, ref):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)
        jgrid = JaxMesh(np.asarray(jax.devices()[:8]).reshape(2, 4), ("host", "spans"))
        want = _jax_shard_map(
            lambda v: jax_mesh.hierarchical_all_reduce(v, "spans", 4, "host"), jgrid, x.reshape(-1), P(("host", "spans")), P()
        )
        # the cross-host step adds two chunks, in either order the same bits
        for a in hier:
            np.testing.assert_array_equal(a.numpy(), want)

    def test_sharded_window_stats_hierarchical(self, bookinfo_traces, mesh8):
        w = pmesh.shard_window(bookinfo_traces, 8)
        flat = _port_stats(mesh8, w, merge="psum")
        hier = _port_stats(_grid(), w, merge="hierarchical", axis="spans")
        for fa, fb in zip(flat, hier):
            np.testing.assert_allclose(fa.numpy(), fb.numpy(), rtol=1e-5, atol=1e-6)
        _assert_stats(hier, _single_stats(w))
        with pytest.raises(ValueError, match="unknown merge"):
            _port_stats(mesh8, w, merge="tree")


def _random_groups(seed: str):
    # str seeding is deterministic (unlike salted hash()), as in the
    # reference's fuzz
    rng = random.Random(seed)
    ts_base = 1_700_000_000_000_000
    groups = []
    for t in range(rng.randint(12, 30)):
        size = rng.randint(1, 9)
        group = []
        for j in range(size):
            svc = f"svc{rng.randint(0, 3)}"
            group.append(
                {
                    "traceId": f"t{t}",
                    "id": f"{t}-{j}",
                    "parentId": f"{t}-{j-1}" if j else None,
                    "kind": rng.choice(["SERVER", "CLIENT"]),
                    "name": f"{svc}.ns.svc.cluster.local:80/*",
                    "timestamp": ts_base + rng.randint(0, 20_000_000),
                    # a high-magnitude, low-spread regime where the naive
                    # E[x^2]-E[x]^2 variance collapses in float32
                    "duration": (
                        800_000_000 + rng.randint(0, 200_000) if rng.random() < 0.3 else rng.randint(100, 900_000)
                    ),
                    "tags": {
                        "http.method": "GET",
                        "http.status_code": rng.choice(["200", "404", "500"]),
                        "http.url": f"http://{svc}.ns.svc.cluster.local/a",
                        "istio.canonical_revision": "v1",
                        "istio.canonical_service": svc,
                        "istio.mesh_id": "c",
                        "istio.namespace": "ns",
                    },
                }
            )
        groups.append(group)
    # svc9 only ever reports 200: its (endpoint, 404/500) segments are empty
    groups.append(
        [
            {
                "traceId": "t-only200",
                "id": "only200-0",
                "parentId": None,
                "kind": "SERVER",
                "name": "svc9.ns.svc.cluster.local:80/*",
                "timestamp": ts_base + 1000,
                "duration": 5000,
                "tags": {
                    "http.method": "GET",
                    "http.status_code": "200",
                    "http.url": "http://svc9.ns.svc.cluster.local/a",
                    "istio.canonical_revision": "v1",
                    "istio.canonical_service": "svc9",
                    "istio.mesh_id": "c",
                    "istio.namespace": "ns",
                },
            }
        ]
    )
    return groups


class TestShardedEquivalenceFuzz:
    """Randomized windows: the sharded stats under each merge reproduce
    window_stats on the same spans, and JAX's sharded stats."""

    @pytest.mark.parametrize("merge", ["psum", "ring"])
    def test_random_windows(self, merge, mesh8, jmesh8):
        groups = _random_groups(merge)
        w = pmesh.shard_window(groups, 8)
        sharded, flat = _port_stats(mesh8, w, merge=merge), _single_stats(w)
        # the empty-segment guard must be exercised
        assert bool((flat.count == 0).any())
        np.testing.assert_array_equal(sharded.count.numpy(), flat.count.numpy())
        np.testing.assert_array_equal(sharded.error_5xx.numpy(), flat.error_5xx.numpy())
        np.testing.assert_array_equal(sharded.latest_timestamp_rel.numpy(), flat.latest_timestamp_rel.numpy())
        np.testing.assert_allclose(sharded.latency_mean.numpy(), flat.latency_mean.numpy(), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(sharded.latency_cv.numpy(), flat.latency_cv.numpy(), rtol=1e-3, atol=1e-5)
        _assert_stats(sharded, _jax_stats(jmesh8, jax_mesh.shard_window(groups, 8), merge=merge))


def _packed_edges(mesh, packed):
    pslot, kind, valid, ep, depth = packed
    return _edge_set(*_unsharded(pmesh.sharded_dependency_edges_packed(mesh, pslot, kind, valid, ep, max_depth=depth)))


def test_sharded_packed_walk_matches_flat(bookinfo_traces, mesh8):
    """The sharded packed walk equals the sharded flat walk and the host
    oracle."""
    w = pmesh.shard_window(bookinfo_traces, 8)
    packed = pmesh.shard_window_packed(w)
    assert packed is not None
    got = _packed_edges(mesh8, packed)
    flat = _edge_set(*_unsharded(pmesh.sharded_dependency_edges(mesh8, w.parent_idx, w.kind, w.valid, w.endpoint_id)))
    assert got == flat
    lookup = w.batches[0].interner.endpoints.lookup
    assert {(lookup(d), lookup(a), dd) for a, d, dd in got} == _host_edges(bookinfo_traces)


def test_sharded_packed_walk_random_windows(mesh8, jmesh8):
    """Random forests through the packed sharded walk against the flat
    sharded walk (edge multisets) and JAX's packed sharded walk."""
    rng = np.random.default_rng(5)
    for _ in range(3):
        groups = []
        for t in range(rng.integers(8, 40)):
            n = int(rng.integers(1, 10))
            group = []
            for j in range(n):
                group.append(
                    {
                        "traceId": f"t{t}",
                        "id": f"{t}-{j}",
                        "parentId": f"{t}-{rng.integers(0, j)}" if j else None,
                        "kind": rng.choice(["SERVER", "CLIENT"]),
                        "name": f"svc{rng.integers(0, 6)}.ns.svc.cluster.local:80/*",
                        "timestamp": 1_700_000_000_000_000 + int(rng.integers(0, 10**6)),
                        "duration": int(rng.integers(100, 10_000)),
                        "tags": {
                            "http.method": "GET",
                            "http.status_code": "200",
                            "http.url": f"http://svc{rng.integers(0, 6)}.ns/api",
                            "istio.canonical_service": f"svc{rng.integers(0, 6)}",
                            "istio.namespace": "ns",
                            "istio.canonical_revision": "v1",
                            "istio.mesh_id": "m",
                        },
                    }
                )
            groups.append(group)
        w = pmesh.shard_window(groups, 8)
        packed = pmesh.shard_window_packed(w)
        assert packed is not None
        pslot, kind, valid, ep, depth = packed
        cols = _unsharded(pmesh.sharded_dependency_edges_packed(mesh8, pslot, kind, valid, ep, max_depth=depth))
        anc, desc, dist, mask = (_np(x) for x in cols)
        got = sorted((int(a), int(d), int(dd)) for a, d, dd in zip(anc[mask], desc[mask], dist[mask]))
        f_anc, f_desc, f_dist, f_mask = (
            _np(x) for x in _unsharded(pmesh.sharded_dependency_edges(mesh8, w.parent_idx, w.kind, w.valid, w.endpoint_id))
        )
        flat = sorted((int(a), int(d), int(dd)) for a, d, dd in zip(f_anc[f_mask], f_desc[f_mask], f_dist[f_mask]))
        assert got == flat
        want = jax_mesh.sharded_dependency_edges_packed(
            jmesh8, *(jnp.asarray(a) for a in (pslot, kind, valid, ep)), max_depth=depth
        )
        w_anc, w_desc, w_dist, w_mask = (np.asarray(x) for x in want)
        assert got == sorted((int(a), int(d), int(dd)) for a, d, dd in zip(w_anc[w_mask], w_desc[w_mask], w_dist[w_mask]))


def _graph_edges(graph):
    s, d, ds, m = (_np(x) for x in graph.edge_arrays())
    return {(int(a), int(b), int(c)) for a, b, c in zip(s[m], d[m], ds[m])}


class _Spy:
    """Counts the calls of a module function it wraps."""

    def __init__(self, monkeypatch, module, name):
        self.calls = 0
        real = getattr(module, name)

        def wrapped(*a, **kw):
            self.calls += 1
            return real(*a, **kw)

        monkeypatch.setattr(module, name, wrapped)


class TestDeployedMeshPath:
    """The deployed path over the mesh: DataProcessor.ingest_raw_stream and
    the store's staged merges, the device stats, a collect tick, the
    store's scorers and a stacked tenant merge, sharded over eight virtual
    CPU shards, against the same port run with KMAMIZ_MESH=0 and against
    kmamiz_tpu (its mesh for the stats, the tick and the scorer; its
    staged ingest on one device, which tests/test_parallel.py holds to
    its mesh run)."""

    @pytest.fixture(scope="class")
    def raw_chunks(self):
        from kmamiz_tpu_torch.synth import make_raw_chunks

        return make_raw_chunks(2000, 7, 3, n_services=50, urls_per_service=8)

    def _ingest(self, chunks, monkeypatch, mesh_on):
        from kmamiz_tpu_torch.server.processor import DataProcessor

        monkeypatch.setenv("KMAMIZ_MESH", "1" if mesh_on else "0")
        dp = DataProcessor(lambda *a: [], device="cpu", use_device_stats=False, wal=None)
        return dp, dp.ingest_raw_stream(list(chunks))

    def _jax_ingest(self, chunks, monkeypatch):
        """The JAX package's staged ingest of the same chunks, on one
        device: tests/test_parallel.py holds its mesh run to this one, and
        a JAX mesh ingest beside the rest of the suite is the heaviest
        XLA work a worker would take on."""
        from kmamiz_tpu.server.processor import DataProcessor as JaxProcessor

        monkeypatch.setenv("KMAMIZ_MESH", "0")
        dp = JaxProcessor(trace_source=lambda *a: [], use_device_stats=False)
        return dp, dp.ingest_raw_stream(list(chunks))

    def test_ingest_raw_stream_mesh_parity(self, raw_chunks, shards8, monkeypatch):
        from kmamiz_tpu_torch.graph import store as port_store

        dp1, r1 = self._ingest(raw_chunks, monkeypatch, mesh_on=False)
        spy = _Spy(monkeypatch, pmesh, "sharded_window_edges_compact")
        dp8, r8 = self._ingest(raw_chunks, monkeypatch, mesh_on=True)
        assert spy.calls == len(raw_chunks)  # every chunk staged on the mesh
        for k in ("spans", "traces", "endpoints", "edges"):
            assert r1[k] == r8[k], (k, r1[k], r8[k])
        assert r8["spans"] == 14_000
        assert _graph_edges(dp1.graph) == _graph_edges(dp8.graph)
        assert port_store.graph_signature(dp8.graph) == port_store.graph_signature(dp1.graph)
        jdp, jr = self._jax_ingest(raw_chunks, monkeypatch)
        assert {k: jr[k] for k in ("spans", "traces", "endpoints", "edges")} == {
            k: r8[k] for k in ("spans", "traces", "endpoints", "edges")
        }
        assert _graph_edges(jdp.graph) == _graph_edges(dp8.graph)

    def test_truncated_prefix_rewalks_sharded(self, raw_chunks, shards8, monkeypatch):
        """A stage cap far below a window's distinct edges forces the
        drain's re-walk through the sharded packed walk; the result is
        still the exact edge union."""
        from kmamiz_tpu_torch.graph import store as port_store

        dp1, _ = self._ingest(raw_chunks, monkeypatch, mesh_on=False)
        monkeypatch.setattr(port_store, "STAGE_CAP", 4)
        spy = _Spy(monkeypatch, pmesh, "sharded_dependency_edges_packed")
        dp8, _ = self._ingest(raw_chunks, monkeypatch, mesh_on=True)
        assert spy.calls == len(raw_chunks)  # every window re-walked on the mesh
        assert _graph_edges(dp1.graph) == _graph_edges(dp8.graph)
        monkeypatch.setenv("KMAMIZ_STAGE_CAP", "4")
        jdp, _ = self._jax_ingest(raw_chunks, monkeypatch)
        assert _graph_edges(jdp.graph) == _graph_edges(dp8.graph)

    def test_device_stats_job_mesh_parity(self, bookinfo_traces, shards8, monkeypatch):
        """collect()'s device stats take the sharded path on the mesh and
        match the single-device kernel and the JAX job on the mesh."""
        from kmamiz_tpu.server.processor import DeviceStatsJob as JaxJob
        from kmamiz_tpu_torch.domain.traces import Traces
        from kmamiz_tpu_torch.server.processor import DeviceStatsJob

        records = Traces(bookinfo_traces).combine_logs_to_realtime_data([], []).to_json()
        monkeypatch.setenv("KMAMIZ_MESH", "0")
        single = DeviceStatsJob(records, torch.device("cpu")).result()
        monkeypatch.setenv("KMAMIZ_MESH", "1")
        spy = _Spy(monkeypatch, pmesh, "sharded_window_stats")
        sharded = DeviceStatsJob(records, torch.device("cpu")).result()
        assert spy.calls == 1
        want = JaxJob(records).result()
        for other in (single, want):
            assert set(other) == set(sharded)
            for key, ref in other.items():
                got = sharded[key]
                assert got["count"] == ref["count"] and got["latest_timestamp"] == ref["latest_timestamp"]
                np.testing.assert_allclose(got["mean"], ref["mean"], rtol=1e-5)
                np.testing.assert_allclose(got["cv"], ref["cv"], rtol=1e-3, atol=1e-5)

    def test_collect_tick_mesh_parity(self, pdas_traces, shards8, monkeypatch):
        """A whole collect tick gives the same combined rows and
        dependencies under the mesh as on one device and as JAX's."""
        from kmamiz_tpu.server.processor import DataProcessor as JaxProcessor
        from kmamiz_tpu_torch.server.processor import DataProcessor

        request = {"uniqueId": "t", "lookBack": 30_000, "time": 1_000_000}

        def run(mesh_on):
            monkeypatch.setenv("KMAMIZ_MESH", "1" if mesh_on else "0")
            dp = DataProcessor(lambda *a: [list(pdas_traces)], device="cpu", use_device_stats=True, wal=None)
            return dp.collect(dict(request))

        r1 = run(False)
        spy = _Spy(monkeypatch, pmesh, "sharded_window_stats")
        r8 = run(True)
        assert spy.calls == 1
        monkeypatch.setenv("KMAMIZ_MESH", "1")
        rj = JaxProcessor(trace_source=lambda *a: [list(pdas_traces)], use_device_stats=True).collect(dict(request))

        def key(r):
            return (r["uniqueEndpointName"], str(r["status"]))

        c8 = {key(r): r for r in r8["combined"]}
        for other in (r1, rj):
            c = {key(r): r for r in other["combined"]}
            assert set(c) == set(c8)
            for k in c:
                assert c[k]["combined"] == c8[k]["combined"]
                np.testing.assert_allclose(c8[k]["latency"]["mean"], c[k]["latency"]["mean"], rtol=1e-5)
                np.testing.assert_allclose(c8[k]["latency"]["cv"], c[k]["latency"]["cv"], rtol=1e-3, atol=1e-5)
        assert r8["dependencies"] == r1["dependencies"]
        assert len(r8["dependencies"]) == len(rj["dependencies"])

    def test_sharded_stacked_tenant_merge_is_bit_equal_to_serial(self, pdas_traces, shards8, monkeypatch):
        """With the mesh on, the arena stacks eight same-bucket tenants as
        eight per-device groups; the router's gathered batch merges each
        group on its device, and every tenant's graph equals a serial
        merge of the same windows, column for column."""
        from kmamiz_tpu_torch import tenancy
        from kmamiz_tpu_torch.server.processor import DataProcessor
        from kmamiz_tpu_torch.tenancy import batch as batch_ops

        tenancy.reset_for_tests()
        monkeypatch.setenv("KMAMIZ_MESH", "1")
        names = [f"m{i}" for i in range(8)]
        procs = {t: DataProcessor(lambda *a: [pdas_traces], device="cpu", wal=None, tenant=t) for t in names}
        twins = {t: DataProcessor(lambda *a: [pdas_traces], device="cpu", wal=None, tenant=f"twin-{t}") for t in names}
        router = tenancy.TickRouter(lambda t: tenancy.TenantRuntime(tenant=t, processor=procs[t]))
        spy = _Spy(monkeypatch, batch_ops, "sharded_merge_edges")
        request = {"uniqueId": "r", "lookBack": 30_000, "time": 1_000_000}
        answers = router.batched_collect([(t, dict(request)) for t in names])
        assert spy.calls == 1
        stack, _views = tenancy.default_arena().stacked_edges(names)
        assert isinstance(stack[0], tuple) and len(stack[0]) == 8
        for t, answer in zip(names, answers):
            want = twins[t].collect(dict(request))
            assert answer["dependencies"] == want["dependencies"]
            for a, b in zip(procs[t].graph.edge_arrays(), twins[t].graph.edge_arrays()):
                assert torch.equal(a, b)
        # KMAMIZ_TENANT_SHARD=0 keeps the one [T, cap] stack
        monkeypatch.setenv("KMAMIZ_TENANT_SHARD", "0")
        procs["m0"].graph.merge_edges([0], [1], [1])
        stack, _views = tenancy.default_arena().stacked_edges(names)
        assert isinstance(stack[0], torch.Tensor) and stack[0].shape[0] == 8
        tenancy.reset_for_tests()


def test_sharded_stats_pallas_backend_matches(bookinfo_traces, mesh8, jmesh8):
    """The port's shards run the segment-stats wrapper (its plain version
    on the CPU): equal to JAX's sharded stats through the Pallas kernel in
    interpret mode, the JAX package's own CPU run of its kernel."""
    w = pmesh.shard_window(bookinfo_traces, 8)
    _assert_stats(_port_stats(mesh8, w), _jax_stats(jmesh8, jax_mesh.shard_window(bookinfo_traces, 8), backend="pallas_interpret"))


def _scorer_inputs():
    rng = np.random.default_rng(3)
    cap, edges, n_ep, n_svc = 1 << 12, 3000, 512, 64
    sen = np.iinfo(np.int32).max
    src = np.full(cap, sen, np.int32)
    src[:edges] = rng.integers(0, n_ep, edges)
    dst = np.full(cap, sen, np.int32)
    dst[:edges] = rng.integers(0, n_ep, edges)
    dist = np.ones(cap, np.int32)
    dist[:edges] = rng.integers(1, 6, edges)
    mask = np.zeros(cap, bool)
    mask[:edges] = True
    eps = rng.integers(0, n_svc, n_ep).astype(np.int32)
    epm = rng.integers(0, 300, n_ep).astype(np.int32)
    epr = rng.random(n_ep) < 0.8
    return (src, dst, dist, mask, eps, epm, epr), n_svc


def _assert_scores(got, want):
    for name in got._fields:
        g, w = _np(getattr(got, name)), _np(getattr(want, name))
        if name in EXACT_SCORES:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=name)


def test_sharded_service_scores_parity(mesh8, jmesh8):
    """The sharded scorer equals the single-device scorer and JAX's
    sharded scorer."""
    from kmamiz_tpu_torch.ops import scorers

    args, n_svc = _scorer_inputs()
    targs = tuple(torch.from_numpy(a) for a in args)
    shard = pmesh.sharded_service_scores(mesh8, *targs, num_services=n_svc)
    _assert_scores(shard, scorers.service_scores(*targs, num_services=n_svc))
    _assert_scores(shard, scorers.service_scores(*targs, num_services=n_svc, dist_bits=3))
    _assert_scores(shard, jax_mesh.sharded_service_scores(jmesh8, *(jnp.asarray(a) for a in args), num_services=n_svc))


def test_store_serves_sharded_scorer_on_mesh(pdas_traces, shards8, monkeypatch):
    """EndpointGraph.service_scores takes the sharded path with the mesh
    on, equal to the single-device path on the same graph and to the JAX
    store's sharded scorer; the memo keys the two apart."""
    from kmamiz_tpu.core.spans import spans_to_batch as jax_spans_to_batch
    from kmamiz_tpu.graph.store import EndpointGraph as JaxGraph
    from kmamiz_tpu_torch.core.spans import spans_to_batch
    from kmamiz_tpu_torch.graph.store import EndpointGraph

    g = EndpointGraph(capacity=64, device="cpu")  # 64 rows shard over 8
    g.merge_window(spans_to_batch([pdas_traces], interner=g.interner))
    monkeypatch.setenv("KMAMIZ_MESH", "0")
    single = g.service_scores()
    spy = _Spy(monkeypatch, pmesh, "sharded_service_scores")
    monkeypatch.setenv("KMAMIZ_MESH", "1")
    shard = g.service_scores()
    assert spy.calls == 1  # a sharded miss: the single-device entry was not served
    assert g.service_scores() is shard and spy.calls == 1  # a memo hit
    assert {k[6] for k in g._scorer_memo} == {None, 8}
    _assert_scores(shard, single)
    _assert_scores(g.service_scores_uncached(), single)
    assert spy.calls == 2
    jg = JaxGraph(capacity=64)
    jg.merge_window(jax_spans_to_batch([pdas_traces], interner=jg.interner))
    _assert_scores(shard, jg.service_scores())


def test_active_mesh_switches(shards8, monkeypatch):
    """KMAMIZ_MESH, KMAMIZ_MESH_DEVICES and the device count decide the
    mesh per call; one device is no mesh."""
    monkeypatch.setenv("KMAMIZ_MESH", "1")
    assert pmesh.active_mesh("cpu").shape == {"spans": 8}
    monkeypatch.setenv("KMAMIZ_MESH_DEVICES", "4")
    assert pmesh.active_mesh("cpu").shape == {"spans": 4}
    monkeypatch.setenv("KMAMIZ_MESH_DEVICES", "1")
    assert pmesh.active_mesh("cpu") is None
    monkeypatch.delenv("KMAMIZ_MESH_DEVICES")
    monkeypatch.setenv("KMAMIZ_MESH", "0")
    assert pmesh.active_mesh("cpu") is None
    monkeypatch.setattr(pmesh, "process_devices", lambda device: [torch.device("cpu")])
    monkeypatch.setenv("KMAMIZ_MESH", "1")
    assert pmesh.active_mesh("cpu") is None


class TestSlotDataParallel:
    """GraphSAGE slot-batch data parallelism (models/stacked.py +
    make_sharded_slot_grad): the grads merged over the mesh equal the same
    microbatch's per-slot loop on one device."""

    def _datasets(self, n_slots=8):
        from kmamiz_tpu.models import trainer as jax_trainer
        from kmamiz_tpu_torch.models import graphsage, trainer

        rng = np.random.default_rng(4)
        n_nodes, n_edges = 12, 20
        src = rng.integers(0, n_nodes, n_edges, dtype=np.int32)
        dst = rng.integers(0, n_nodes, n_edges, dtype=np.int32)
        feats = [rng.normal(size=(n_nodes, graphsage.NUM_FEATURES)).astype(np.float32) for _ in range(n_slots)]
        t_lat = [rng.normal(size=n_nodes).astype(np.float32) for _ in range(n_slots)]
        t_ano = [(rng.random(n_nodes) < 0.2).astype(np.float32) for _ in range(n_slots)]
        n_mask = [rng.random(n_nodes) < 0.9 for _ in range(n_slots)]
        names = [f"ep{i}" for i in range(n_nodes)]
        keys = [f"s{i}" for i in range(n_slots)]
        jds = jax_trainer.GraphDataset(
            endpoint_names=names,
            src=jnp.asarray(src),
            dst=jnp.asarray(dst),
            edge_mask=jnp.ones(n_edges, dtype=bool),
            features=[jnp.asarray(a) for a in feats],
            target_latency=[jnp.asarray(a) for a in t_lat],
            target_anomaly=[jnp.asarray(a) for a in t_ano],
            node_mask=[jnp.asarray(a) for a in n_mask],
            slot_keys=list(keys),
        )
        pds = trainer.GraphDataset(
            endpoint_names=names,
            src=src,
            dst=dst,
            edge_mask=np.ones(n_edges, dtype=bool),
            features=feats,
            target_latency=t_lat,
            target_anomaly=t_ano,
            node_mask=n_mask,
            slot_keys=list(keys),
        )
        return jds, pds

    @staticmethod
    def _params(hidden=8):
        from kmamiz_tpu.models import graphsage as jax_sage
        from kmamiz_tpu_torch.models import checkpoint, graphsage

        jp = jax_sage.init_params(jax.random.PRNGKey(0), hidden=hidden)
        numpy = {k: None if v is None else np.asarray(v) for k, v in jp._asdict().items()}
        return jp, checkpoint.params_from_numpy(graphsage, numpy, device="cpu")

    def test_sharded_slot_grads_match_single_device(self):
        from kmamiz_tpu.models import common as jax_common
        from kmamiz_tpu.models import graphsage as jax_sage
        from kmamiz_tpu.models import stacked as jax_stacked
        from kmamiz_tpu_torch.models import common, graphsage, stacked

        jds, pds = self._datasets()
        st = stacked.stack_dataset(pds, "cpu")
        jp, params = self._params()
        loss_fn = common.make_loss_fn(graphsage.forward, 3.0)
        bg = pmesh.make_sharded_slot_grad(pmesh.make_mesh(8, axis="slots", devices=CPU8), loss_fn, axis="slots")
        feats, tl, ta, nm, w = stacked.batch_slots_arrays(st, 8)
        g_mesh, losses = bg(params, feats[0], tl[0], ta[0], nm[0], st.src, st.dst, st.edge_mask, w[0], st.index)

        # the single-device per-slot loop: the port's, and the JAX one the
        # reference's test builds
        gs, ls = [], []
        for i in range(8):
            loss, _aux, g = common.value_and_grad(
                loss_fn, params, feats[0][i], st.src, st.dst, st.edge_mask, tl[0][i], ta[0][i], nm[0][i]
            )
            gs.append(g)
            ls.append(float(loss))
        jax_grad = jax.value_and_grad(jax_common.make_loss_fn(jax_sage.forward, 3.0), has_aux=True)
        jst = jax_stacked.stack_dataset(jds)
        jf, jtl, jta, jnm, _jw = jax_stacked.batch_slots_arrays(jst, 8)
        jgs, jls = [], []
        for i in range(8):
            (loss, _), g = jax_grad(jp, jf[0][i], jst.src, jst.dst, jst.edge_mask, jtl[0][i], jta[0][i], jnm[0][i])
            jgs.append(g)
            jls.append(float(loss))
        for k, name in enumerate(g_mesh._fields):
            if g_mesh[k] is None:
                assert gs[0][k] is None
                continue
            ref = sum(g[k] for g in gs) / 8.0
            np.testing.assert_allclose(g_mesh[k].numpy(), ref.numpy(), rtol=1e-5, atol=1e-6, err_msg=name)
            jref = sum(np.asarray(getattr(g, name)) for g in jgs) / 8.0
            np.testing.assert_allclose(g_mesh[k].numpy(), jref, rtol=1e-5, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(float(losses[0]), sum(ls) / 8.0, rtol=1e-5)
        np.testing.assert_allclose(float(losses[0]), sum(jls) / 8.0, rtol=1e-5)

    def test_mesh_training_matches_one_device(self, monkeypatch):
        from kmamiz_tpu.models import graphsage as jax_sage
        from kmamiz_tpu.models import trainer as jax_trainer
        from kmamiz_tpu_torch.models import checkpoint, graphsage, trainer

        def init(generator, hidden=64, num_features=10, num_nodes=0, device=None):
            jp = jax_sage.init_params(
                jax.random.PRNGKey(int(generator.initial_seed())),
                hidden=hidden, num_features=num_features, num_nodes=num_nodes,
            )
            numpy = {k: None if v is None else np.asarray(v) for k, v in jp._asdict().items()}
            return checkpoint.params_from_numpy(graphsage, numpy, device=device)

        # both trainers start from JAX's weights for the seed
        monkeypatch.setattr(graphsage, "init_params", init)
        jds, pds = self._datasets()
        mesh = pmesh.make_mesh(8, axis="slots", devices=CPU8)
        r1 = trainer.train(pds, epochs=3, hidden=8, fused=True, batch_slots=8, device="cpu")
        rn = trainer.train(pds, epochs=3, hidden=8, fused=True, batch_slots=1, mesh=mesh, device="cpu")
        rj = jax_trainer.train(jds, epochs=3, hidden=8, fused=True, batch_slots=8, mesh=jax_mesh.make_mesh(8, axis="slots"))
        for other in (r1, rj):
            np.testing.assert_allclose(rn.losses, other.losses, rtol=1e-4, atol=1e-5)
            for name, a, b in zip(rn.params._fields, rn.params, other.params):
                if a is None:
                    assert b is None
                    continue
                np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-3, atol=1e-5, err_msg=name)

    def test_indivisible_batch_rejected(self):
        from kmamiz_tpu_torch.models import common, graphsage, stacked

        _jds, pds = self._datasets(n_slots=6)
        st = stacked.stack_dataset(pds, "cpu")
        bg = pmesh.make_sharded_slot_grad(
            pmesh.make_mesh(8, axis="slots", devices=CPU8), common.make_loss_fn(graphsage.forward, 1.0), axis="slots"
        )
        feats, tl, ta, nm, w = stacked.batch_slots_arrays(st, 6)
        _jp, params = self._params()
        with pytest.raises(ValueError, match="does not shard"):
            bg(params, feats[0], tl[0], ta[0], nm[0], st.src, st.dst, st.edge_mask, w[0])

"""The port's fleet against kmamiz_tpu/fleet/ on the CPU.

The 23 cases of tests/test_fleet.py, each run through both packages on the
same inputs and held to the JAX package: ring placements and minimal
disruption; WAL handoff blobs byte-equal and imported across packages,
with the torn-tail, crc, kind and magic cases; live migration bit-exact
with zero loss, the drain queue, the aborts (source dead mid-handoff, a
failed flush re-queued, a staged import dropped), the commit dropping the
source's copy, an invalid target, the in-flight barrier; the fold
(a malformed export refused, the aggregate equal to the tenants' edge sum
and to the JAX fold's graph); the fleet archetype's spec; the metrics
scrape rendered byte-equal. Then: the /fleet/* routes over HTTP between a
JAX worker process and a port worker process (migrations both ways), and
placement's weights and plans with KMAMIZ_COST unset on the JAX side.
"""
from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import threading
import urllib.request

import pytest

from kmamiz_tpu import control as jax_control
from kmamiz_tpu import fleet as jax_fleet
from kmamiz_tpu.fleet import coordinator as jax_coordinator
from kmamiz_tpu.fleet import migration as jax_migration
from kmamiz_tpu.fleet import placement as jax_placement
from kmamiz_tpu.fleet import ring as jax_ring
from kmamiz_tpu.fleet import worker as jax_worker
from kmamiz_tpu.graph.store import EndpointGraph as JaxGraph
from kmamiz_tpu.resilience import wal as jax_wal
from kmamiz_tpu.resilience.chaos import graph_signature as jax_signature
from kmamiz_tpu.scenarios import factory as jax_factory
from kmamiz_tpu.telemetry import fleetscrape as jax_fleetscrape
from kmamiz_tpu_torch import control, fleet, telemetry, tenancy
from kmamiz_tpu_torch.fleet import coordinator, migration, placement, ring, worker
from kmamiz_tpu_torch.graph.store import EndpointGraph, graph_signature
from kmamiz_tpu_torch.resilience import breaker, metrics, quarantine
from kmamiz_tpu_torch.resilience import wal
from kmamiz_tpu_torch.scenarios.factory import build_scenario, spec_signature
from kmamiz_tpu_torch.scenarios.topology import sample_topology, trace_group
from kmamiz_tpu_torch.server.processor import DataProcessor
from kmamiz_tpu_torch.telemetry import fleetscrape

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _port_state(monkeypatch, tmp_path):
    monkeypatch.setenv("KMAMIZ_PROF_FLIGHT_DIR", str(tmp_path / "flight"))
    monkeypatch.delenv("KMAMIZ_COST", raising=False)
    mods = (telemetry, tenancy, breaker, metrics, quarantine, control, fleet)
    for mod in mods:
        mod.reset_for_tests()
    yield
    for mod in mods:
        mod.reset_for_tests()


class Side:
    """One package's fleet: a two-worker ring behind a LocalTransport."""

    def __init__(self, name: str, root):
        self.name = name
        port = name == "port"
        self.fleet = fleet if port else jax_fleet
        self.Ring = ring.HashRing if port else jax_ring.HashRing
        self.Worker = worker.FleetWorker if port else jax_worker.FleetWorker
        self.Coordinator = coordinator.FleetCoordinator if port else jax_coordinator.FleetCoordinator
        self.Local = coordinator.LocalTransport if port else jax_coordinator.LocalTransport
        self.migration = migration if port else jax_migration
        self.MigrationError = self.migration.MigrationError
        self.Graph = (lambda: EndpointGraph(device="cpu", tenant="aggregate")) if port else JaxGraph
        self.signature = graph_signature if port else jax_signature
        kw = {"device": "cpu"} if port else {}
        self.ring = self.Ring(["w0", "w1"])
        self.workers = {w: self.Worker(w, wal_root=str(root / name / "wal"), **kw) for w in self.ring.workers}
        self.coordinator = self.Coordinator(self.ring, self.Local(self.workers))

    def other(self, w: str) -> str:
        return next(x for x in self.ring.workers if x != w)


@pytest.fixture
def sides(tmp_path):
    return Side("port", tmp_path), Side("jax", tmp_path)


def _window(tenant, tick, prefix="tf"):
    topo = sample_topology("chain", random.Random(3), f"{prefix}-{tenant}")
    return json.dumps([trace_group(topo, f"{prefix}-{tenant}", tick, i) for i in range(2)]).encode()


def _snapshots_equal():
    assert fleet.snapshot() == jax_fleet.snapshot()


# ---------------------------------------------------------------------------
# the consistent-hash ring


def test_ring_deterministic_for_seed():
    tenants = [f"tenant-{i}" for i in range(100)]
    a = ring.HashRing(["w0", "w1", "w2", "w3"], vnodes=32, seed=7)
    b = ring.HashRing(["w3", "w1", "w0", "w2"], vnodes=32, seed=7)  # order-free
    assert a.assignment(tenants) == b.assignment(tenants)
    for seed, vnodes in ((7, 32), (0, 64), (3, 1)):
        got = ring.HashRing(["w0", "w1", "w2", "w3"], vnodes=vnodes, seed=seed)
        want = jax_ring.HashRing(["w0", "w1", "w2", "w3"], vnodes=vnodes, seed=seed)
        assert got.assignment(tenants) == want.assignment(tenants)
        assert got.spread(tenants) == want.spread(tenants)
        assert got.describe() == want.describe()


def test_ring_seed_changes_placement():
    tenants = [f"tenant-{i}" for i in range(100)]
    a = ring.HashRing(["w0", "w1", "w2", "w3"], seed=0).assignment(tenants)
    b = ring.HashRing(["w0", "w1", "w2", "w3"], seed=1).assignment(tenants)
    assert a != b
    assert b == jax_ring.HashRing(["w0", "w1", "w2", "w3"], seed=1).assignment(tenants)


def test_ring_minimal_disruption_on_grow():
    tenants = [f"tenant-{i}" for i in range(200)]
    before = ring.HashRing(["w0", "w1", "w2", "w3"])
    after = before.with_workers(["w0", "w1", "w2", "w3", "w4"])
    placed, moved = before.assignment(tenants), after.assignment(tenants)
    moves = {t for t in tenants if placed[t] != moved[t]}
    # every displaced tenant lands on the new worker, and only its arcs move
    assert all(moved[t] == "w4" for t in moves)
    assert 0 < len(moves) < len(tenants) // 2
    jax_after = jax_ring.HashRing(["w0", "w1", "w2", "w3"]).with_workers(["w0", "w1", "w2", "w3", "w4"])
    assert moved == jax_after.assignment(tenants)


def test_ring_rejects_duplicates_and_empties():
    for bad in (dict(workers=["w0", "w0"]), dict(workers=[]), dict(workers=["w0"], vnodes=0)):
        with pytest.raises(ring.RingError):
            ring.HashRing(**bad)
        with pytest.raises(jax_ring.RingError):
            jax_ring.HashRing(**bad)


def test_ring_worker_and_tenant_charset_parity():
    with pytest.raises(ring.RingError):
        ring.HashRing(["w0", "../escape"])
    r = ring.HashRing(["w0", "w1"])
    with pytest.raises(ring.RingError):
        r.owner("bad/../name")
    # the charset is the arena's: an arena-valid name places, as in JAX
    assert r.owner("ok-tenant_1.x") == jax_ring.HashRing(["w0", "w1"]).owner("ok-tenant_1.x")


# ---------------------------------------------------------------------------
# the WAL handoff blob


def _handoff_wals(tmp_path):
    """The same three records in a port WAL and a JAX WAL."""
    port_wal, jax_w = wal.IngestWAL(str(tmp_path / "src-port")), jax_wal.IngestWAL(str(tmp_path / "src-jax"))
    for i in range(3):
        payload = json.dumps([{"rec": i}]).encode()
        port_wal.append(payload)
        jax_w.append(payload)
    return port_wal, jax_w


def test_handoff_roundtrip_preserves_records(tmp_path):
    port_wal, jax_w = _handoff_wals(tmp_path)
    blob = port_wal.export_handoff()
    assert blob == jax_w.export_handoff()  # byte-equal
    assert port_wal.record_count() == jax_w.record_count() == 3
    # each package imports the other's blob
    dst = wal.IngestWAL(str(tmp_path / "dst-port"))
    jax_dst = jax_wal.IngestWAL(str(tmp_path / "dst-jax"))
    assert dst.import_handoff(jax_w.export_handoff()) == 3
    assert jax_dst.import_handoff(blob) == 3
    want = [p for _k, p in jax_w.replay_records()]
    assert [p for _k, p in dst.replay_records()] == want == [p for _k, p in jax_dst.replay_records()]
    # the imported segments are byte-equal too
    seg = lambda d: [p.read_bytes() for p in sorted(d.glob("*.wal"))]  # noqa: E731
    assert seg(tmp_path / "dst-port") == seg(tmp_path / "dst-jax")


def test_handoff_torn_tail_imports_intact_prefix(tmp_path):
    port_wal, _ = _handoff_wals(tmp_path)
    blob = port_wal.export_handoff()
    dst = wal.IngestWAL(str(tmp_path / "dst"))
    assert dst.import_handoff(blob[:-3]) == 2  # the last record torn mid-payload
    assert dst.record_count() == 2
    assert jax_wal.IngestWAL(str(tmp_path / "dst-jax")).import_handoff(blob[:-3]) == 2


def test_handoff_crc_mismatch_stops_clean(tmp_path):
    port_wal, _ = _handoff_wals(tmp_path)
    blob = bytearray(port_wal.export_handoff())
    blob[-1] ^= 0xFF  # corrupt the last record's payload
    assert wal.IngestWAL(str(tmp_path / "dst")).import_handoff(bytes(blob)) == 2
    assert jax_wal.IngestWAL(str(tmp_path / "dst-jax")).import_handoff(bytes(blob)) == 2


def test_handoff_kind_contradiction_stops_clean(tmp_path):
    payload = json.dumps([{"rec": 0}]).encode()  # JSON, not KMZC
    blob = wal._HANDOFF_MAGIC + wal._HEADER_V2.pack(len(payload), wal.zlib.crc32(payload), wal.KIND_COLUMNAR) + payload
    assert wal._HANDOFF_MAGIC == jax_wal._HANDOFF_MAGIC
    dst = wal.IngestWAL(str(tmp_path / "dst"))
    assert dst.import_handoff(blob) == 0
    assert dst.record_count() == 0
    assert jax_wal.IngestWAL(str(tmp_path / "dst-jax")).import_handoff(blob) == 0


def test_handoff_missing_magic_raises(tmp_path):
    with pytest.raises(ValueError):
        wal.IngestWAL(str(tmp_path / "dst")).import_handoff(b"not a handoff blob")
    with pytest.raises(ValueError):
        jax_wal.IngestWAL(str(tmp_path / "dst-jax")).import_handoff(b"not a handoff blob")


# ---------------------------------------------------------------------------
# workers, coordinator, migration (in process, LocalTransport)


def test_migration_bit_exact_zero_loss(sides):
    outs = []
    for side in sides:
        tenant, coord = "alpha", side.coordinator
        for tick in range(3):
            assert coord.route_ingest(tenant, _window(tenant, tick))
        source = coord.owner(tenant)
        target = side.other(source)
        pre_sig = side.workers[source].signature(tenant)
        out = side.migration.migrate_tenant(coord, tenant, target)
        assert out["ok"] and out["records"] == 3
        assert out["signature"] == pre_sig  # the replayed graph is bit-exact
        assert coord.owner(tenant) == target
        assert side.workers[target].signature(tenant) == pre_sig
        # traffic after the flip flows to the target
        coord.route_ingest(tenant, _window(tenant, 9))
        assert side.workers[target].summary()["frames"] >= 1
        outs.append((out["source"], out["target"], out["signature"], side.workers[target].signature(tenant)))
    assert outs[0] == outs[1]
    _snapshots_equal()


class _Proxy:
    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        return getattr(self._inner, name)


def test_migration_drain_queue_releases_to_target(sides):
    results = []
    for side in sides:
        tenant, coord = "alpha", side.coordinator
        coord.route_ingest(tenant, _window(tenant, 0))
        source = coord.owner(tenant)
        target = side.other(source)

        class MidHandoff(_Proxy):
            def wal_export(self, worker_id, t):
                # a frame races the handoff: it must park, not route
                assert coord.route_ingest(t, _window(t, 5)) is None
                return self._inner.wal_export(worker_id, t)

        real = coord.transport
        coord.swap_transport(MidHandoff(real))
        try:
            out = side.migration.migrate_tenant(coord, tenant, target)
        finally:
            coord.swap_transport(real)
        assert out["queuedReleased"] == 1
        # the queued frame landed on the target (the source was never retouched)
        assert side.workers[target].summary()["frames"] == 1
        assert side.fleet.snapshot()["framesQueuedDuringDrain"] == 1
        results.append((out["signature"], side.workers[target].signature(tenant)))
    assert results[0] == results[1]
    _snapshots_equal()


def test_migration_aborts_when_source_dies_mid_handoff(sides):
    for side in sides:
        tenant, coord = "alpha", side.coordinator
        coord.route_ingest(tenant, _window(tenant, 0))
        source = coord.owner(tenant)
        pre_sig = side.workers[source].signature(tenant)

        class Kill9(_Proxy):
            def wal_export(self, worker_id, t):
                raise ConnectionError("source killed mid-handoff")

        real = coord.transport
        coord.swap_transport(Kill9(real))
        try:
            with pytest.raises(side.MigrationError):
                side.migration.migrate_tenant(coord, tenant, side.other(source))
        finally:
            coord.swap_transport(real)
        # no split brain: ownership unchanged, the source serves its last good graph
        assert coord.owner(tenant) == source
        assert side.workers[source].signature(tenant) == pre_sig
        assert coord.route_ingest(tenant, _window(tenant, 7)) is not None
        assert side.fleet.snapshot()["migrationsAborted"] == 1
    _snapshots_equal()


def test_migration_abort_flush_failure_requeues_frames(sides):
    """The source unreachable for the handoff and for the abort path's
    queue release: the queued frame is re-queued, never dropped, the abort
    still counts, and the frame lands once the source is back."""
    for side in sides:
        tenant, coord = "alpha", side.coordinator
        coord.route_ingest(tenant, _window(tenant, 0))
        source = coord.owner(tenant)
        pre_frames = side.workers[source].summary()["frames"]

        class Dead(_Proxy):
            def wal_export(self, worker_id, t):
                assert coord.route_ingest(t, _window(t, 5)) is None
                raise ConnectionError("source killed mid-handoff")

            def ingest(self, worker_id, t, raw):
                raise ConnectionError("source still unreachable")

        real = coord.transport
        coord.swap_transport(Dead(real))
        try:
            with pytest.raises(side.MigrationError):
                side.migration.migrate_tenant(coord, tenant, side.other(source))
        finally:
            coord.swap_transport(real)
        snap = side.fleet.snapshot()
        assert snap["migrationsAborted"] == 1 and snap["framesRequeued"] == 1
        assert coord.snapshot()["queuedFrames"] == {tenant: 1}
        assert coord.owner(tenant) == source
        # the next routed frame delivers the backlog first, in order
        assert coord.route_ingest(tenant, _window(tenant, 6)) is not None
        assert side.workers[source].summary()["frames"] == pre_frames + 2
        assert coord.snapshot()["queuedFrames"] == {}
    _snapshots_equal()
    port, jax = sides
    assert port.workers[port.coordinator.owner("alpha")].signature("alpha") == jax.workers[
        jax.coordinator.owner("alpha")
    ].signature("alpha")


def test_migration_abort_discards_staged_import(sides):
    """Two-phase install: a replay that diverges is dropped on abort; the
    target keeps no live or staged state for the tenant."""
    for side in sides:
        tenant, coord = "alpha", side.coordinator
        for tick in range(2):
            coord.route_ingest(tenant, _window(tenant, tick))
        source = coord.owner(tenant)
        target = side.other(source)

        class Diverge(_Proxy):
            def wal_import(self, worker_id, t, data):
                return {**self._inner.wal_import(worker_id, t, data), "signature": "deadbeef" * 8}

        real = coord.transport
        coord.swap_transport(Diverge(real))
        try:
            with pytest.raises(side.MigrationError, match="diverged"):
                side.migration.migrate_tenant(coord, tenant, target)
        finally:
            coord.swap_transport(real)
        assert coord.owner(tenant) == source
        assert tenant not in side.workers[target].tenants()
        assert tenant not in side.workers[target]._pending_imports
    _snapshots_equal()


def test_migration_commit_drops_source_copy(sides):
    for side in sides:
        tenant, coord = "alpha", side.coordinator
        for tick in range(2):
            coord.route_ingest(tenant, _window(tenant, tick))
        source = coord.owner(tenant)
        target = side.other(source)
        assert side.migration.migrate_tenant(coord, tenant, target)["ok"]
        # one worker holds the tenant's live state after the flip
        assert tenant in side.workers[target].tenants()
        assert tenant not in side.workers[source].tenants()
    _snapshots_equal()


def test_migration_invalid_target_never_pauses_traffic(sides):
    for side in sides:
        tenant, coord = "alpha", side.coordinator
        coord.route_ingest(tenant, _window(tenant, 0))
        source = coord.owner(tenant)
        with pytest.raises(side.MigrationError):
            side.migration.migrate_tenant(coord, tenant, "w9")  # off the ring
        with pytest.raises(side.MigrationError):
            side.migration.migrate_tenant(coord, tenant, source)  # already there
        snap = coord.snapshot()
        assert snap["draining"] == [] and snap["queuedFrames"] == {}
        assert side.fleet.snapshot()["migrationsStarted"] == 0
        assert side.fleet.snapshot()["migrationsAborted"] == 0
        assert coord.route_ingest(tenant, _window(tenant, 1)) is not None
    _snapshots_equal()


def test_begin_drain_waits_for_inflight_send(sides):
    """The drain barrier: a frame already on the wire lands before the
    source's drain snapshot, so begin_drain blocks on it; the drain takes
    no tick lock, so it cannot wait on a tenant's tick in a cycle."""
    for side in sides:
        tenant, coord = "alpha", side.coordinator
        entered, release, drained = threading.Event(), threading.Event(), threading.Event()
        real = coord.transport

        class Slow(_Proxy):
            def ingest(self, worker_id, t, raw):
                entered.set()
                assert release.wait(10)
                return real.ingest(worker_id, t, raw)

        coord.swap_transport(Slow(real))
        sender = threading.Thread(target=coord.route_ingest, args=(tenant, _window(tenant, 0)))
        sender.start()
        assert entered.wait(10)

        def drain():
            coord.begin_drain(tenant)
            drained.set()

        drainer = threading.Thread(target=drain)
        drainer.start()
        assert not drained.wait(0.3)  # the barrier holds while the send flies
        release.set()
        assert drained.wait(10)  # ...and lets go once it lands
        sender.join(10)
        drainer.join(10)
        coord.swap_transport(real)
        coord.abort_migration(tenant)
        assert side.workers[coord.owner(tenant)].summary()["frames"] == 1
    _snapshots_equal()


def test_fold_named_edges_rejects_malformed_export():
    for g in (EndpointGraph(device="cpu", tenant="fold"), JaxGraph()):
        assert g.fold_named_edges({"names": [], "src": [], "dst": [], "dist": []}) == 0
        with pytest.raises(ValueError):  # edges but no name table
            g.fold_named_edges({"names": [], "src": [0], "dst": [0], "dist": [1]})
        with pytest.raises(ValueError):  # a negative index must not wrap
            g.fold_named_edges({"names": ["a", "b"], "src": [-1], "dst": [0], "dist": [1]})
        with pytest.raises(ValueError):  # an index past the table
            g.fold_named_edges({"names": ["a"], "src": [0], "dst": [1], "dist": [1]})


def test_coordinator_fold_matches_tenant_edge_sum(sides):
    tenants = ["alpha", "beta"]
    aggregates = []
    for side in sides:
        coord = side.coordinator
        for tenant in tenants:
            for tick in range(2):
                coord.route_ingest(tenant, _window(tenant, tick))
        aggregate = side.Graph()
        folded = coord.fold(tenants, aggregate)
        per_tenant = sum(int(side.workers[coord.owner(t)].processor(t).graph.n_edges) for t in tenants)
        # disjoint tenant namespaces: the two-level merge neither loses nor
        # invents edges
        assert folded == per_tenant == int(aggregate.n_edges)
        aggregates.append(aggregate)
    port_agg, jax_agg = aggregates
    assert graph_signature(port_agg) == jax_signature(jax_agg)
    assert port_agg.export_named_edges() == jax_agg.export_named_edges()
    _snapshots_equal()


def test_worker_without_wal_root_refuses_migration():
    for w in (worker.FleetWorker("w9", device="cpu"), jax_worker.FleetWorker("w9")):
        w.ingest("alpha", _window("alpha", 0))
        with pytest.raises(RuntimeError):
            w.wal_export("alpha")


def test_fleet_migration_archetype_composes():
    spec = build_scenario("fleet-migration", 0, 9, 10)
    assert spec_signature(spec) == jax_factory.spec_signature(jax_factory.build_scenario("fleet-migration", 0, 9, 10))
    assert [p.tenant for p in spec.tenants] == ["alpha", "beta", "gamma"]
    assert spec.has_event("tenant-migration")
    (tick,) = [ev.at_tick for _t, ev in spec.events() if ev.kind == "tenant-migration"]
    assert 0 < tick < spec.n_ticks


# ---------------------------------------------------------------------------
# the metrics scrape


def test_fleetscrape_aggregates_and_labels_per_worker():
    pages = {
        "w0": '# HELP noise\nkmamiz_ingest_payloads_total 3\nkmamiz_tick_ms{q="p99"} 10\n',
        "w1": "kmamiz_ingest_payloads_total 5\nmalformed{{{ 1\nkmamiz_tick_ms_sum 2.5\n",
        "w2": "",  # a dead worker: an empty page must not break the merge
    }
    merged = fleetscrape.aggregate(pages)
    assert merged == jax_fleetscrape.aggregate(pages)
    assert merged["kmamiz_ingest_payloads_total"][""] == 8.0
    assert merged["kmamiz_ingest_payloads_total"]['worker="w0"'] == 3.0
    assert merged["kmamiz_tick_ms"]['q="p99",worker="w0"'] == 10.0
    assert fleetscrape.spans_per_worker(pages) == jax_fleetscrape.spans_per_worker(pages) == {
        "w0": 3.0,
        "w1": 5.0,
        "w2": 0.0,
    }
    page = fleetscrape.render(pages)
    assert page == jax_fleetscrape.render(pages)  # byte-equal
    assert "kmamiz_ingest_payloads_total 8" in page
    assert 'kmamiz_ingest_payloads_total{worker="w1"} 5' in page
    # the port's own registry pages render like the JAX package's
    real = {"w0": telemetry.REGISTRY.render(), "w1": telemetry.REGISTRY.render()}
    assert fleetscrape.render(real) == jax_fleetscrape.render(real)


# ---------------------------------------------------------------------------
# the /fleet/* routes over HTTP: a JAX worker process and a port one


def _spawn(cmd, env, cwd):
    proc = subprocess.Popen(cmd, env=env, cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    line = proc.stdout.readline().split()
    assert line[:1] == ["FLEET_WORKER_READY"], line
    return proc, f"http://127.0.0.1:{line[2]}"


def test_fleet_routes_over_http_between_packages(tmp_path):
    """A port coordinator over HTTPTransport: w0 a JAX worker process, w1
    the port's `python -m kmamiz_tpu_torch.fleet.worker --device cpu`. A
    tenant migrates JAX -> port and back over the /fleet/* routes, bit-
    exact with a frame mid-handoff; the scrape merges both /metrics."""
    base_env = {k: v for k, v in os.environ.items() if not k.startswith("KMAMIZ_")}
    base_env.update(KMAMIZ_WAL="1", KMAMIZ_QUARANTINE_DIR=str(tmp_path / "q"), JAX_PLATFORMS="cpu")
    procs = []
    try:
        jax_proc, jax_url = _spawn(
            [sys.executable, "-m", "kmamiz_tpu.fleet.worker", "--worker-id", "w0"],
            {**base_env, "KMAMIZ_WAL_DIR": str(tmp_path / "w0")},
            REPO,
        )
        procs.append(jax_proc)
        port_proc, port_url = _spawn(
            [sys.executable, "-m", "kmamiz_tpu_torch.fleet.worker", "--worker-id", "w1", "--device", "cpu"],
            {**base_env, "KMAMIZ_WAL_DIR": str(tmp_path / "w1")},
            REPO,
        )
        procs.append(port_proc)
        endpoints = {"w0": jax_url, "w1": port_url}
        transport = coordinator.HTTPTransport(endpoints)
        coord = coordinator.FleetCoordinator(ring.HashRing(["w0", "w1"]), transport)
        tenant = next(t for t in (f"tenant-{i}" for i in range(50)) if coord.owner(t) == "w0")
        frames = [_window(tenant, tick) for tick in range(3)]
        for raw in frames:
            assert coord.route_ingest(tenant, raw)["spans"] > 0
        ref_proc = DataProcessor(lambda *_a: [], device="cpu", use_device_stats=False, wal=None, tenant="ref")
        for raw in frames:
            ref_proc.ingest_raw_window(raw)
        assert transport.signature("w0", tenant) == graph_signature(ref_proc.graph)
        for target, tick in (("w1", 5), ("w0", 6)):
            mid = _window(tenant, tick)

            class MidHandoff(_Proxy):
                def wal_export(self, worker_id, t):
                    assert coord.route_ingest(t, mid) is None
                    return self._inner.wal_export(worker_id, t)

            coord.swap_transport(MidHandoff(transport))
            try:
                out = migration.migrate_tenant(coord, tenant, target)
            finally:
                coord.swap_transport(transport)
            assert out["ok"] and out["queuedReleased"] == 1 and out["target"] == target
            ref_proc.ingest_raw_window(mid)
            assert transport.signature(target, tenant) == graph_signature(ref_proc.graph)
            # the source dropped its copy: its runtime is gone
            source = out["source"]
            assert transport.drop_tenant(source, tenant)["dropped"] is False
        # the fold over HTTP, both packages' exports
        aggregate = EndpointGraph(device="cpu", tenant="aggregate")
        assert coord.fold([tenant], aggregate) == int(ref_proc.graph.n_edges)
        assert graph_signature(aggregate) == graph_signature(ref_proc.graph)
        # /timings carries the fleet section in both packages' servers
        for url in endpoints.values():
            with urllib.request.urlopen(f"{url}/timings", timeout=30) as resp:
                assert "fleet" in json.loads(resp.read())
        pages = fleetscrape.scrape_workers(endpoints)
        assert pages["w0"] and pages["w1"]
        page = fleetscrape.render(pages)
        assert page == jax_fleetscrape.render(pages)
        totals = fleetscrape.aggregate(pages)["kmamiz_ingest_payloads_total"]
        assert totals[""] == totals['worker="w0"'] + totals['worker="w1"'] > 0
    finally:
        for p in procs:
            p.kill()
            p.wait(10)


# ---------------------------------------------------------------------------
# placement


def test_placement_weights_and_plans_equal_jax():
    tenants = [f"t{i}" for i in range(12)]
    r, jr = ring.HashRing(["w0", "w1", "w2"], seed=2), jax_ring.HashRing(["w0", "w1", "w2"], seed=2)
    # no forecast yet: every tenant at the default weight
    assert placement.tenant_weights(tenants) == jax_placement.tenant_weights(tenants)
    for i, t in enumerate(tenants[:7]):
        for pkg in (control, jax_control):
            pkg.ingest_forecast(pkg.ForecastView(tenant=t, p99_ms=10.0 + i, cost_ms=5.0 * (i + 1) ** 2))
    weights = placement.tenant_weights(tenants)
    assert weights == jax_placement.tenant_weights(tenants)
    assert placement.worker_loads(r, tenants) == jax_placement.worker_loads(jr, tenants)
    overrides = {"t0": "w2"}
    for t in tenants:
        assert placement.pick_target(r, t, tenants, overrides=overrides) == jax_placement.pick_target(
            jr, t, tenants, overrides=overrides
        )
    for ratio, moves in ((1.0, 3), (1.5, 2), (2.0, 1), (100.0, 1)):
        plan = placement.rebalance_plan(r, tenants, imbalance_ratio=ratio, max_moves=moves)
        assert plan == jax_placement.rebalance_plan(jr, tenants, imbalance_ratio=ratio, max_moves=moves)
    assert placement.rebalance_plan(r, tenants, imbalance_ratio=1.0, max_moves=3)


def test_concurrent_routing_through_migrations_loses_nothing(tmp_path):
    """A time-bounded stress of the coordinator's shared routing state:
    more routing threads than cores (one per tenant, each in its own frame
    order) with a short switch interval, while tenants migrate back and
    forth. No frame is lost or doubled, and every tenant's graph, by
    endpoint names, equals a serial ingest of its frames."""
    side = Side("port", tmp_path)
    coord = side.coordinator
    tenants = [f"s{i}" for i in range(max(12, (os.cpu_count() or 1) + 4))]
    n_frames = 6
    errors = []

    def send(tenant):
        try:
            for tick in range(n_frames):
                coord.route_ingest(tenant, _window(tenant, tick, prefix="st"))
        except Exception as e:  # noqa: BLE001 - reported by the main thread
            errors.append(repr(e))

    old_interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=send, args=(t,), daemon=True) for t in tenants]
        for th in threads:
            th.start()
        for tenant in tenants[:4] * 2:
            assert migration.migrate_tenant(coord, tenant, side.other(coord.owner(tenant)))["ok"]
        for th in threads:
            th.join(timeout=60)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(old_interval)
    assert not errors, errors
    assert fleet.snapshot()["migrationsCompleted"] == 8
    assert coord.snapshot()["queuedFrames"] == {} and coord.snapshot()["inflight"] == {}
    routed = fleet.snapshot()["framesRouted"]
    assert routed == len(tenants) * n_frames

    def named(graph):
        e = graph.export_named_edges()
        return sorted(zip((e["names"][i] for i in e["src"]), (e["names"][i] for i in e["dst"]), e["dist"]))

    for tenant in tenants:
        ref = DataProcessor(lambda *_a: [], device="cpu", use_device_stats=False, wal=None, tenant="ref")
        for tick in range(n_frames):
            ref.ingest_raw_window(_window(tenant, tick, prefix="st"))
        proc = side.workers[coord.owner(tenant)].processor(tenant)
        assert named(proc.graph) == named(ref.graph), tenant
        assert set(proc._processed) == set(ref._processed), tenant

"""The port's tenancy layer against kmamiz_tpu/tenancy/ on the CPU.

The cases of tests/test_tenancy.py, each run through both packages where
the JAX package has the same function: the arena's (tenant, version)
index, buckets and admission bound; tenant resolution; the batched tick
(graph signatures equal to the JAX serial and batched paths, responses
within the tick tolerances of tests/test_processor_equivalence.py); the
stacked merge program on seeded uneven windows, bit-equal to the JAX
program; the batched scorers; mixed buckets; the gather window; the
drift re-merge and the absence of any other fallback; per-tenant
quarantine, WAL, breakers and scheduler jobs; the tenant scorecards; and
the DP server's tenant routing with its 400 and 429.
"""
from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from kmamiz_tpu.resilience.chaos import graph_signature as jax_signature
from kmamiz_tpu.server.processor import DataProcessor as JaxProcessor
from kmamiz_tpu.tenancy import TenantRuntime as JaxRuntime
from kmamiz_tpu.tenancy import TickRouter as JaxRouter
from kmamiz_tpu.tenancy import batch as jax_batch
from kmamiz_tpu.tenancy import resolve_tenant as jax_resolve
from kmamiz_tpu_torch import control, telemetry, tenancy
from kmamiz_tpu_torch.graph.store import EndpointGraph, StoreVersionDrift, graph_signature
from kmamiz_tpu_torch.resilience import breaker, metrics, quarantine
from kmamiz_tpu_torch.server.dp_server import DataProcessorServer
from kmamiz_tpu_torch.server.processor import DataProcessor
from kmamiz_tpu_torch.server.scheduler import Scheduler
from kmamiz_tpu_torch.telemetry import slo
from kmamiz_tpu_torch.tenancy import (
    DEFAULT_TENANT,
    TenantLimitError,
    TenantNameError,
    TenantResolutionError,
    TenantRuntime,
    TickRouter,
    default_arena,
    reset_tenant,
    resolve_tenant,
    tenant_job_name,
)
from kmamiz_tpu_torch.tenancy import arena as arena_mod
from kmamiz_tpu_torch.tenancy import batch as port_batch
from test_torch_processor import _assert_same_tick

CHAOS_FIXTURES = Path(__file__).parent / "fixtures" / "chaos"
TICK = {"uniqueId": "tick-1", "lookBack": 30000, "time": 1646208339000}


@pytest.fixture(autouse=True)
def _port_state(monkeypatch, tmp_path):
    """The port's process-wide registries start and end clean; the JAX
    side runs its Pallas segment kernel in interpret mode."""
    monkeypatch.setenv("KMAMIZ_SEGMENT_BACKEND", "pallas_interpret")
    monkeypatch.setenv("KMAMIZ_PROF_FLIGHT_DIR", str(tmp_path / "flight"))
    mods = (telemetry, tenancy, breaker, metrics, quarantine, control)
    for mod in mods:
        mod.reset_for_tests()
    yield
    for mod in mods:
        mod.reset_for_tests()


def port_processor(pdas_traces, tenant):
    return DataProcessor(
        trace_source=lambda look_back, time, limit: [pdas_traces], device="cpu", tenant=tenant
    )


def jax_processor(pdas_traces, tenant):
    return JaxProcessor(trace_source=lambda look_back, time, limit: [pdas_traces], tenant=tenant)


def port_router(pdas_traces, **kw):
    return TickRouter(
        lambda tenant: TenantRuntime(tenant=tenant, processor=port_processor(pdas_traces, tenant)), **kw
    )


def jax_router(pdas_traces):
    return JaxRouter(lambda tenant: JaxRuntime(tenant=tenant, processor=jax_processor(pdas_traces, tenant)))


# -- the arena: versioned index, buckets, admission ----------------------------


class TestArena:
    def test_graph_self_registers_and_indexes(self):
        g = EndpointGraph(tenant="acme", device="cpu")
        arena = default_arena()
        assert arena.get("acme") is g
        view = arena[("acme", g.version)]
        assert view.tenant == "acme"
        # the port grows by repacking: the snapshot is the capacity itself
        assert view.capacity == g.capacity == g.capacity_bucket()
        with pytest.raises(KeyError):
            arena[("acme", g.version + 1)]

    def test_same_bucket_tenants_share_a_bucket(self):
        g1 = EndpointGraph(tenant="a1", device="cpu")
        g2 = EndpointGraph(tenant="a2", device="cpu")
        assert g1.capacity == g2.capacity
        assert set(default_arena().buckets()[g1.capacity]) >= {"a1", "a2"}

    def test_max_tenants_bounds_admission(self, monkeypatch):
        monkeypatch.setattr(arena_mod, "MAX_TENANTS", 2)
        keep = [EndpointGraph(tenant="t1", device="cpu"), EndpointGraph(tenant="t2", device="cpu")]
        with pytest.raises(TenantLimitError):
            EndpointGraph(tenant="t3", device="cpu")
        # re-admitting a tenant replaces its slot
        keep.append(EndpointGraph(tenant="t1", device="cpu"))
        assert default_arena().get("t1") is keep[-1]

    @pytest.mark.parametrize("name", ["", "../etc", "a/b", ".hidden", "x" * 65, "a\nb"])
    def test_unsafe_names_rejected(self, name):
        from kmamiz_tpu.tenancy.arena import valid_tenant as jax_valid

        assert not jax_valid(name) and not tenancy.valid_tenant(name)
        with pytest.raises(TenantNameError):
            default_arena().admit(name, EndpointGraph(device="cpu"))

    def test_summary_accounts_bytes_per_bucket(self):
        g = EndpointGraph(tenant="acct", device="cpu")
        s = default_arena().summary()
        assert s["tenants"] >= 1 and s["maxTenants"] == 64
        bucket = s["buckets"][str(g.capacity)]
        assert "acct" in bucket["tenants"] and bucket["bytes"] > 0

    def test_stacked_edges_memoized_on_versions(self, pdas_traces):
        router = port_router(pdas_traces)
        router.batched_collect([("s1", dict(TICK)), ("s2", dict(TICK))])
        arena = default_arena()
        (src, dst, dist, mask), views = arena.stacked_edges(["s1", "s2"])
        assert src.shape == (2, views[0].capacity) and mask.dtype == torch.bool
        again, _ = arena.stacked_edges(["s1", "s2"])
        assert again[0] is src  # no restack between merges
        assert arena.stacked_bytes() == 2 * views[0].capacity * 13
        assert torch.equal(src[1], router.runtime("s2").processor.graph.edge_arrays()[0])


# -- request routing -------------------------------------------------------------


class TestResolveTenant:
    @pytest.mark.parametrize(
        "headers, path",
        [({}, "/graph"), ({"x-kmamiz-tenant": "acme"}, "/graph"), ({"x-kmamiz-tenant": "acme"}, "/t/zed/graph")],
    )
    def test_matches_jax(self, headers, path):
        assert resolve_tenant(headers, path) == jax_resolve(headers, path)

    def test_default_header_and_prefix(self):
        assert resolve_tenant({}, "/graph") == (DEFAULT_TENANT, "/graph")
        assert resolve_tenant({"x-kmamiz-tenant": "acme"}, "/graph") == ("acme", "/graph")
        assert resolve_tenant({"x-kmamiz-tenant": "acme"}, "/t/zed/graph") == ("zed", "/graph")

    def test_header_name_argument(self, monkeypatch):
        """The JAX package's KMAMIZ_TENANT_HEADER is an argument here."""
        monkeypatch.setenv("KMAMIZ_TENANT_HEADER", "x-org")
        assert resolve_tenant({"x-org": "acme"}, "/", header="x-org") == jax_resolve({"x-org": "acme"}, "/")

    @pytest.mark.parametrize("bad", ["../up", "a/b", ".dot", "x" * 65])
    def test_unsafe_names_rejected(self, bad):
        with pytest.raises(TenantResolutionError):
            resolve_tenant({"x-kmamiz-tenant": bad}, "/")
        if "/" not in bad:
            with pytest.raises(TenantResolutionError):
                resolve_tenant({}, f"/t/{bad}/graph")


# -- the stacked dispatch ----------------------------------------------------------


def _window_stacks(seed: int, t: int = 4, cap: int = 256):
    """Seeded [T, cap] store stacks (each lane a sorted unique prefix,
    SENTINEL-parked after it, as a store holds it) and SENTINEL-padded
    [T, wcap] windows of uneven lengths, duplicates included."""
    from kmamiz_tpu.ops.sortutil import SENTINEL

    rng = np.random.default_rng(seed)
    a = np.full((3, t, cap), SENTINEL, dtype=np.int32)
    lens = rng.integers(0, 120, size=t)
    for lane in range(t):
        rows = np.unique(
            np.stack([rng.integers(0, 40, 200), rng.integers(0, 40, 200), rng.integers(1, 5, 200)], 1), axis=0
        )[: lens[lane]]
        a[:, lane, : len(rows)] = rows.T
    w_lens = rng.integers(1, 90, size=t)
    wcap = 1 << int(np.ceil(np.log2(max(64, w_lens.max()))))
    w = np.full((3, t, wcap), SENTINEL, dtype=np.int32)
    for lane in range(t):
        n = w_lens[lane]
        w[:, lane, :n] = np.stack([rng.integers(0, 40, n), rng.integers(0, 40, n), rng.integers(1, 5, n)])
    return a, a[0] != SENTINEL, w, w[0] != SENTINEL


class TestBatchedTicks:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_batched_merge_edges_matches_jax(self, seed):
        import jax.numpy as jnp

        a, a_mask, w, w_mask = _window_stacks(seed)
        got = port_batch.batched_merge_edges(
            *(torch.from_numpy(x) for x in (a[0], a[1], a[2], a_mask, w[0], w[1], w[2], w_mask))
        )
        want = jax_batch.batched_merge_edges(*(jnp.asarray(x) for x in (a[0], a[1], a[2], a_mask, w[0], w[1], w[2], w_mask)))
        for g, j in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(j))

    @pytest.mark.parametrize("seed", [3, 4])
    def test_batched_merge_lanes_equal_serial_merges(self, seed):
        """Each lane is the serial store union of that lane's columns."""
        from kmamiz_tpu_torch.graph.store import _merge_edges

        a, a_mask, w, w_mask = _window_stacks(seed, t=5)
        s, d, ds, valid, counts = port_batch.batched_merge_edges(
            *(torch.from_numpy(x) for x in (a[0], a[1], a[2], a_mask, w[0], w[1], w[2], w_mask))
        )
        for lane in range(5):
            n = int(w_mask[lane].sum())
            cols = [torch.from_numpy(a[k, lane]) for k in range(3)] + [torch.from_numpy(a_mask[lane])]
            win = [torch.from_numpy(w[k, lane, :n].copy()) for k in range(3)]
            ss, sd, sds, sv = _merge_edges(*cols, *win, torch.ones(n, dtype=torch.bool))
            k = int(counts[lane])
            assert k == int(sv.sum())
            for got, want in ((s, ss), (d, sd), (ds, sds)):
                assert torch.equal(got[lane, :k], want[:k])

    def test_batched_collect_bitexact_with_jax(self, pdas_traces):
        router = port_router(pdas_traces)
        out = router.batched_collect([("alpha", dict(TICK)), ("beta", dict(TICK))])
        assert router.stats() == {
            "batches": 1, "stackedMerges": 1, "stackedLanes": 2, "driftRemerges": 0, "serialMerges": 0,
        }
        j_router = jax_router(pdas_traces)
        j_out = j_router.batched_collect([("alpha", dict(TICK)), ("beta", dict(TICK))])
        ref = jax_processor(pdas_traces, "ref")
        ref_resp = ref.collect(dict(TICK))
        for tenant in ("alpha", "beta"):
            sig = graph_signature(router.runtime(tenant).processor.graph)
            assert sig == jax_signature(ref.graph)
            assert sig == jax_signature(j_router.runtime(tenant).processor.graph)
        for resp, j_resp in zip(out, j_out):
            _assert_same_tick(resp, j_resp)
            _assert_same_tick(resp, ref_resp)

    def test_batched_collect_equals_port_serial(self, pdas_traces):
        router = port_router(pdas_traces)
        out = router.batched_collect([("a", dict(TICK)), ("b", dict(TICK, uniqueId="t2"))])
        serial = port_processor(pdas_traces, "serial")
        want = serial.collect(dict(TICK))
        g = router.runtime("a").processor.graph
        for got_col, want_col in zip(g.edge_arrays(), serial.graph.edge_arrays()):
            assert torch.equal(got_col, want_col)
        assert g.n_edges == serial.graph.n_edges and g.version == serial.graph.version
        assert {k: v for k, v in out[0].items() if k != "log"} == {k: v for k, v in want.items() if k != "log"}

    def test_batched_service_scores_match_serial_and_jax(self, pdas_traces):
        router = port_router(pdas_traces)
        router.batched_collect([("alpha", dict(TICK)), ("beta", dict(TICK))])
        stacked, svc_caps = router.batched_service_scores(["alpha", "beta"])
        j_router = jax_router(pdas_traces)
        j_router.batched_collect([("alpha", dict(TICK)), ("beta", dict(TICK))])
        j_stacked, j_caps = j_router.batched_service_scores(["alpha", "beta"])
        assert svc_caps == j_caps
        ref = router.runtime("alpha").processor.graph.service_scores_uncached()
        for lane in range(2):
            n = svc_caps[lane]
            for name, field, ref_field, j_field in zip(stacked._fields, stacked, ref, j_stacked):
                got = field[lane][:n].numpy()
                np.testing.assert_allclose(got, ref_field[:n].numpy(), rtol=1e-5, err_msg=name)
                np.testing.assert_allclose(got, np.asarray(j_field)[lane][:n], rtol=1e-5, err_msg=name)
                if field.dtype in (torch.bool, torch.int32):
                    np.testing.assert_array_equal(got, ref_field[:n].numpy())

    def test_mixed_buckets_merge_serially(self, pdas_traces):
        router = port_router(pdas_traces)
        big = router.runtime("bigcap").processor
        big.graph = EndpointGraph(tenant="bigcap", capacity=4096, device="cpu")
        out = router.batched_collect([("alpha", dict(TICK)), ("bigcap", dict(TICK))])
        assert [r["uniqueId"] for r in out] == ["tick-1", "tick-1"]
        assert len(out[1]["combined"]) == len(out[0]["combined"]) == 3
        assert router.stats()["serialMerges"] == 2 and router.stats()["stackedMerges"] == 0
        ref = jax_processor(pdas_traces, "ref2")
        ref.collect(dict(TICK))
        for tenant in ("alpha", "bigcap"):
            assert graph_signature(router.runtime(tenant).processor.graph) == jax_signature(ref.graph)

    def test_submit_window_coalesces(self, pdas_traces):
        # a window wide enough that a loaded host still lands both in it
        router = port_router(pdas_traces, batch_window_ms=500)
        results = {}
        gate = threading.Barrier(2)

        def run(tenant):
            gate.wait()
            results[tenant] = router.submit(tenant, dict(TICK))

        threads = [threading.Thread(target=run, args=(t,)) for t in ("ta", "tb")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert set(results) == {"ta", "tb"}
        for resp in results.values():
            assert resp["uniqueId"] == TICK["uniqueId"] and len(resp["combined"]) == 3
        stats = router.stats()
        assert stats["batches"] == 1 and stats["stackedLanes"] == 2 and stats["serialMerges"] == 0

    def test_drift_remerges_serially_and_stays_exact(self, pdas_traces, monkeypatch):
        """A merge that lands between the stack's snapshot and the adopt
        makes that lane stale: it re-merges serially, the same edge set."""
        router = port_router(pdas_traces)
        arena = default_arena()
        real = arena.stacked_edges

        def moving(tenants):
            out = real(tenants)
            g = router.runtime("beta").processor.graph
            g.merge_edges([0], [1], [1])  # bumps beta's version
            return out

        router.runtime("alpha"), router.runtime("beta")
        monkeypatch.setattr(arena, "stacked_edges", moving)
        router.batched_collect([("alpha", dict(TICK)), ("beta", dict(TICK))])
        assert router.stats()["driftRemerges"] == 1 and router.stats()["serialMerges"] == 1
        ref = jax_processor(pdas_traces, "ref3")
        ref.collect(dict(TICK))
        assert graph_signature(router.runtime("alpha").processor.graph) == jax_signature(ref.graph)
        beta = router.runtime("beta").processor.graph
        assert beta.n_edges == ref.graph.n_edges + 1  # the extra (0, 1, 1) edge

    def test_other_stacked_errors_raise(self, pdas_traces, monkeypatch):
        """No fallback: an error in the stacked program fails the batch."""
        router = port_router(pdas_traces)

        def broken(*args):
            raise RuntimeError("stacked program failed")

        monkeypatch.setattr(port_batch, "batched_merge_edges", broken)
        with pytest.raises(RuntimeError, match="stacked program failed"):
            router.batched_collect([("alpha", dict(TICK)), ("beta", dict(TICK))])

    def test_adopt_refuses_a_moved_store(self, pdas_traces):
        g = EndpointGraph(tenant="drifting", device="cpu")
        col = torch.zeros(g.capacity, dtype=torch.int32)
        with pytest.raises(StoreVersionDrift):
            g.adopt_batched_merged(col, col, col, 0, None, 1, 1, expected_version=g.version + 1)


# -- isolation: quarantine, WAL, breakers, jobs -------------------------------------


def mk_span(tid, sid, parent=None, svc="svc", url=None):
    return {
        "traceId": tid,
        "id": sid,
        "parentId": parent,
        "kind": "SERVER",
        "name": f"{svc}.ns.svc.cluster.local:80/*",
        "timestamp": 1_700_000_000_000_000,
        "duration": 1000,
        "tags": {
            "http.method": "GET",
            "http.status_code": "200",
            "http.url": url or f"http://{svc}.ns/api",
            "istio.canonical_revision": "v1",
            "istio.canonical_service": svc,
            "istio.mesh_id": "cluster.local",
            "istio.namespace": "ns",
        },
    }


def clean_chunks(n_traces=8, prefix="t"):
    groups = []
    for t in range(n_traces):
        tid = f"{prefix}{t}"
        groups.append(
            [
                mk_span(tid, f"{tid}p"),
                mk_span(tid, f"{tid}c", parent=f"{tid}p", svc=f"down{t % 3}", url=f"http://down{t % 3}.ns/api/{t % 2}"),
            ]
        )
    return [json.dumps([g]).encode() for g in groups]


def raw_dp(tenant):
    return DataProcessor(trace_source=lambda *a: [], device="cpu", use_device_stats=False, tenant=tenant)


def jax_raw_reference(chunks):
    """The same chunks through the JAX processor's raw path."""
    ref = JaxProcessor(trace_source=lambda *a: [], use_device_stats=False, tenant="jref")
    for raw in chunks:
        ref.ingest_raw_window(raw)
    return jax_signature(ref.graph)


class TestTenantIsolation:
    def test_poisoning_a_leaves_b_bitexact_and_unquarantined(self, monkeypatch, tmp_path):
        monkeypatch.setenv("KMAMIZ_QUARANTINE_DIR", str(tmp_path / "quarantine"))
        dp_a, dp_b = raw_dp("aaa"), raw_dp("bbb")
        chunks = clean_chunks(prefix="iso")
        poison = (CHAOS_FIXTURES / "truncated-json.bin").read_bytes()
        for raw in chunks:
            dp_b.ingest_raw_window(raw)
        assert dp_a.ingest_raw_window(poison)["quarantined"] == 1
        reference = raw_dp("ccc")
        for raw in chunks:
            reference.ingest_raw_window(raw)
        assert graph_signature(dp_b.graph) == graph_signature(reference.graph) == jax_raw_reference(chunks)
        q_root = tmp_path / "quarantine"
        assert list((q_root / "tenants" / "aaa").glob("*.bin"))
        assert not list((q_root / "tenants" / "bbb").glob("*.bin"))
        assert not list(q_root.glob("*.bin"))  # the default tenant's directory
        per_tenant = quarantine.tenant_quarantine_stats()
        assert per_tenant["aaa"]["count"] == 1
        assert "bbb" not in per_tenant or per_tenant["bbb"]["count"] == 0
        assert metrics.resilience_summary()["tenantQuarantine"]["aaa"]["count"] == 1
        assert slo.TENANTS.snapshot().get("bbb", {}).get("stale_serves", 0) == 0

    def test_per_tenant_wal_replays_independently(self, monkeypatch, tmp_path):
        monkeypatch.setenv("KMAMIZ_WAL", "1")
        monkeypatch.setenv("KMAMIZ_WAL_DIR", str(tmp_path / "wal"))
        chunks_a, chunks_b = clean_chunks(prefix="wa"), clean_chunks(prefix="wb")
        crash_a, crash_b = raw_dp("wta"), raw_dp("wtb")
        for raw in chunks_a:
            crash_a.ingest_raw_window(raw)
        for raw in chunks_b:
            crash_b.ingest_raw_window(raw)
        sig_a, sig_b = graph_signature(crash_a.graph), graph_signature(crash_b.graph)
        crash_a.wal.close()
        crash_b.wal.close()
        del crash_a, crash_b
        assert (tmp_path / "wal" / "tenants" / "wta").is_dir()
        assert (tmp_path / "wal" / "tenants" / "wtb").is_dir()
        rec_a, rec_b = raw_dp("wta"), raw_dp("wtb")
        assert rec_a.replay_wal()["replayed"] == len(chunks_a)
        assert rec_b.replay_wal()["replayed"] == len(chunks_b)
        assert graph_signature(rec_a.graph) == sig_a == jax_raw_reference(chunks_a)
        assert graph_signature(rec_b.graph) == sig_b

    def test_bad_tenant_never_becomes_a_path(self, monkeypatch, tmp_path):
        monkeypatch.setenv("KMAMIZ_WAL", "1")
        monkeypatch.setenv("KMAMIZ_WAL_DIR", str(tmp_path / "wal"))
        from kmamiz_tpu_torch.resilience.wal import IngestWAL

        for bad in ("../up", "a/b"):
            with pytest.raises(TenantNameError):
                IngestWAL.from_env(tenant=bad)
            with pytest.raises(TenantNameError):
                quarantine.quarantine_for(bad)
            with pytest.raises(TenantNameError):
                tenant_job_name(bad, "sync")

    def test_breakers_key_per_tenant(self):
        from kmamiz_tpu.resilience.breaker import get_breaker as jax_get

        b_default = breaker.get_breaker("zipkin")
        b_a = breaker.get_breaker("zipkin", tenant="bka")
        b_b = breaker.get_breaker("zipkin", tenant="bkb")
        assert b_a is not b_b and b_a is not b_default
        assert breaker.get_breaker("zipkin", tenant="bka") is b_a
        assert b_a.name == jax_get("zipkin", tenant="bka").name == "bka:zipkin"
        for _ in range(b_a.threshold):
            with pytest.raises(RuntimeError):
                b_a.call(lambda: (_ for _ in ()).throw(RuntimeError("x")))
        states = breaker.breaker_states()
        assert states["bka:zipkin"]["state"] == "open" and states["zipkin"]["state"] == "closed"
        assert "bkb:zipkin" not in breaker.breaker_states(tenant="bka")
        assert set(breaker.breakers_for("bka")) == {"bka:zipkin"}
        assert set(breaker.breakers_for()) == {"zipkin"}
        reset_tenant("bka")
        assert "bka:zipkin" not in breaker.breaker_states()
        assert "bkb:zipkin" in breaker.breaker_states()

    def test_scheduler_jobs_namespace_and_stop_per_tenant(self):
        from kmamiz_tpu.tenancy import tenant_job_name as jax_job_name

        sched = Scheduler()
        sched.register("sync", 3600.0, lambda: None)
        sched.register("sync", 3600.0, lambda: None, tenant="scha")
        sched.register("sync", 3600.0, lambda: None, tenant="schb")
        assert sorted(sched.jobs) == ["scha/sync", "schb/sync", "sync"]
        for tenant in ("scha", DEFAULT_TENANT):
            assert tenant_job_name(tenant, "sync") == jax_job_name(tenant, "sync")
        metrics.job_failed("scha/sync", RuntimeError("boom"))
        metrics.job_failed("schb/sync", RuntimeError("boom"))
        sched.stop_tenant("scha")
        assert sorted(sched.jobs) == ["schb/sync", "sync"]
        states = metrics.job_states()
        assert "scha/sync" not in states and states["schb/sync"]["consecutiveFailures"] == 1
        sched.stop()


# -- telemetry: bounded tenant label cardinality --------------------------------------


class TestTenantTelemetry:
    def test_scorecards_fold_past_series_cap(self, monkeypatch):
        monkeypatch.setattr(slo, "MAX_TENANT_SERIES", 2)
        for i in range(5):
            slo.TENANTS.observe_tick(f"card{i}", 10.0 + i)
        rows = slo.TENANTS.snapshot()
        assert sorted(k for k in rows if k != slo.OTHER_TENANT_LABEL) == ["card0", "card1"]
        assert rows[slo.OTHER_TENANT_LABEL]["ticks"] == 3

    def test_stale_counter_rides_tenant_label(self):
        slo.TENANTS.observe_tick("stale-t", 5.0)
        slo.TENANTS.note_stale("stale-t")
        rows = slo.TENANTS.snapshot()
        assert rows["stale-t"]["stale_serves"] == 1 and rows["stale-t"]["stale_serve_rate"] == 1.0


# -- the HTTP layer ---------------------------------------------------------------------


class TestHTTPTenancy:
    @pytest.fixture
    def server(self, pdas_traces):
        srv = DataProcessorServer(port_processor(pdas_traces, DEFAULT_TENANT), host="127.0.0.1", port=0)
        srv.start()
        yield f"http://127.0.0.1:{srv.port}"
        srv.stop()

    def _tick(self, base, unique_id, headers=None, path=""):
        req = urllib.request.Request(
            base + path,
            data=json.dumps({"uniqueId": unique_id, "lookBack": 30000, "time": 1646208339000}).encode(),
            headers={"Content-Type": "application/json", **(headers or {})},
        )
        return json.loads(urllib.request.urlopen(req, timeout=60).read())

    def test_header_and_path_routing_isolate_graphs(self, server):
        r_default = self._tick(server, "d1")
        r_hdr = self._tick(server, "h1", headers={"x-kmamiz-tenant": "web"})
        r_path = self._tick(server, "p1", path="/t/mobile/")
        assert len(r_default["combined"]) == len(r_hdr["combined"]) == len(r_path["combined"]) == 3
        timings = json.loads(urllib.request.urlopen(f"{server}/timings", timeout=30).read())
        assert sorted(timings["tenancy"]["tenants"]) == ["default", "mobile", "web"]
        assert set(timings["tenants"]) >= {"default", "mobile", "web"}
        assert timings["control"]["enabled"] is False
        text = urllib.request.urlopen(f"{server}/metrics", timeout=30).read().decode()
        assert 'kmamiz_tenant_ticks_total{tenant="mobile"} 1' in text
        assert 'kmamiz_tenant_arena_bytes{tenant="web"}' in text
        health = json.loads(urllib.request.urlopen(f"{server}/t/web/", timeout=30).read())
        assert health["tenant"] == "web" and health["status"] == "UP"

    def test_ingest_routes_by_tenant(self, server, monkeypatch, tmp_path):
        monkeypatch.setenv("KMAMIZ_QUARANTINE_DIR", str(tmp_path / "q"))
        req = urllib.request.Request(f"{server}/t/poisoned/ingest", data=b"{not json")
        summary = json.loads(urllib.request.urlopen(req, timeout=60).read())
        assert summary["quarantined"] == 1
        assert list((tmp_path / "q" / "tenants" / "poisoned").glob("*.bin"))

    def test_bad_tenant_name_is_400(self, server):
        with pytest.raises(urllib.error.HTTPError) as err:
            self._tick(server, "x", headers={"x-kmamiz-tenant": "../up"})
        assert err.value.code == 400

    def test_tenant_limit_is_429(self, server, monkeypatch):
        monkeypatch.setattr(arena_mod, "MAX_TENANTS", len(default_arena().tenants()))
        with pytest.raises(urllib.error.HTTPError) as err:
            self._tick(server, "x", headers={"x-kmamiz-tenant": "overflow"})
        assert err.value.code == 429

    def test_gathered_ticks_through_the_server(self, pdas_traces):
        srv = DataProcessorServer(
            port_processor(pdas_traces, DEFAULT_TENANT), host="127.0.0.1", port=0, batch_window_ms=1000
        )
        srv.start()
        try:
            base = f"http://127.0.0.1:{srv.port}"
            out = {}
            gate = threading.Barrier(3)

            def post(tenant):
                gate.wait()
                out[tenant] = self._tick(base, f"g-{tenant}", path=f"/t/{tenant}/")

            threads = [threading.Thread(target=post, args=(t,)) for t in ("ga", "gb", "gc")]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert {t: len(r["combined"]) for t, r in out.items()} == {"ga": 3, "gb": 3, "gc": 3}
            stats = srv.router.stats()
            assert stats["stackedLanes"] == 3 and stats["batches"] == 1 and stats["serialMerges"] == 0
        finally:
            srv.stop()

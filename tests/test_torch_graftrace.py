"""The port's graftrace (kmamiz_tpu_torch/analysis/concurrency/): the
fixture corpus's marker equality for the three rules, the lock model on
the corpus against the JAX model on the JAX corpus, the repo-clean strict
gate (CLI + in-process), the port's lock model, the runtime lock witness,
the witnessed fleet-migration soak and the DP's /timings section.

Every test here resets the port's witness before and after it: the
shared conftest resets only the JAX package's.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from kmamiz_tpu.analysis import framework as jax_framework
from kmamiz_tpu.analysis.concurrency import locks as jax_locks
from kmamiz_tpu_torch.analysis import framework
from kmamiz_tpu_torch.analysis.concurrency import locks, witness

REPO_ROOT = Path(__file__).parent.parent
FIXTURE_ROOT = Path(__file__).parent / "fixtures" / "lint_torch"
JAX_FIXTURE_ROOT = Path(__file__).parent / "fixtures" / "lint"
_EXPECT_RE = re.compile(r"#\s*EXPECT:\s*([\w,\s-]+)")

CONCURRENCY_RULES = (
    "lock-order-cycle",
    "blocking-call-under-lock",
    "inconsistent-guard",
)
# the port's Counter/Gauge lock lines (telemetry/registry.py)
COUNTER_LOCK = "kmamiz_tpu_torch/telemetry/registry.py:58"
GAUGE_LOCK = "kmamiz_tpu_torch/telemetry/registry.py:80"


@pytest.fixture(autouse=True)
def _reset_port_witness():
    witness.reset_for_tests()
    yield
    witness.reset_for_tests()


def _to_port(s: str) -> str:
    return s.replace("kmamiz_tpu/", "kmamiz_tpu_torch/")


def _expected_markers():
    expected = set()
    for path in sorted(FIXTURE_ROOT.rglob("*.py")):
        rel = path.relative_to(FIXTURE_ROOT).as_posix()
        for lineno, line in enumerate(path.read_text().splitlines(), 1):
            m = _EXPECT_RE.search(line)
            if not m:
                continue
            for rule in m.group(1).split(","):
                rule = rule.strip()
                if rule in CONCURRENCY_RULES:
                    expected.add((rel, lineno, rule))
    return expected


def _corpus_model(root, fw, lk):
    ctx = fw.LintContext(root=str(root))
    for rel in fw._iter_py_files(str(root), None):
        ctx.modules[rel] = fw.ModuleInfo(rel, (Path(root) / rel).read_text())
    return lk.build_model(ctx)


def lint_corpus(declared=(), **kw):
    """The torch corpus linted with `declared` as DECLARED_EDGES (none by
    default: the live table's processor.py path collides with the
    corpus's, as the JAX tests lint their corpus without the live jit
    tables)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(locks, "DECLARED_EDGES", declared)
        return framework.lint_paths(str(FIXTURE_ROOT), **kw)


@pytest.fixture(scope="module")
def corpus_result():
    return lint_corpus(rules=list(CONCURRENCY_RULES))


class TestFixtureCorpus:
    def test_findings_match_markers_exactly(self, corpus_result):
        got = {(f.path, f.line, f.rule) for f in corpus_result.findings}
        expected = _expected_markers()
        assert got == expected, (
            f"missing: {sorted(expected - got)}\n"
            f"unexpected: {sorted(got - expected)}"
        )

    def test_each_rule_catches_its_seeded_violation(self, corpus_result):
        assert {f.rule for f in corpus_result.findings} == set(CONCURRENCY_RULES)

    def test_clean_twins_are_silent(self, corpus_result):
        assert not [f for f in corpus_result.findings if f.path.endswith("_clean.py")]

    def test_cycle_finding_carries_the_full_path(self, corpus_result):
        (f,) = [f for f in corpus_result.findings if f.rule == "lock-order-cycle"]
        # both directions of the 2-cycle, with file:line provenance
        assert f.message.count("->") == 2
        assert "_ingest_lock" in f.message and "_publish_lock" in f.message
        assert re.search(r"deadlock\.py:\d+", f.message)

    def test_guard_finding_names_majority_lock_and_votes(self, corpus_result):
        (f,) = [f for f in corpus_result.findings if f.rule == "inconsistent-guard"]
        assert "Router._lock" in f.message
        assert "2/3" in f.message
        assert "Router._aux" in f.message


class TestModelParityWithReference:
    """The lock model on the torch corpus equals the JAX model on the JAX
    corpus, lock ids and sites mapped."""

    @pytest.fixture(scope="class")
    def models(self):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(locks, "DECLARED_EDGES", ())
            port = _corpus_model(FIXTURE_ROOT, framework, locks)
        return port, _corpus_model(JAX_FIXTURE_ROOT, jax_framework, jax_locks)

    def test_inventory_equals_the_jax_models(self, models):
        port, jax = models
        assert {lid: (s.rel_path, s.line, s.kind, s.alias_of) for lid, s in port.locks.items()} == {
            _to_port(lid): (_to_port(s.rel_path), s.line, s.kind, s.alias_of and _to_port(s.alias_of))
            for lid, s in jax.locks.items()
        }

    def test_order_edges_equal_the_jax_models(self, models):
        port, jax = models

        def key(m, f=lambda s: s):
            return sorted((f(e.src), f(e.dst), f(e.rel_path), e.line, f(e.fn), e.blocking) for e in m.edges)

        assert port.edges and key(port) == key(jax, _to_port)
        assert port.wide_edge_pairs == {(_to_port(a), _to_port(b)) for a, b in jax.wide_edge_pairs}
        assert port.trylock_only == {_to_port(t) for t in jax.trylock_only}
        assert [[_to_port(e.src) for e in c] for c in jax_locks.find_cycles(jax)] == [
            [e.src for e in c] for c in locks.find_cycles(port)
        ]


class TestRepoClean:
    """The port's tree must be graftrace-clean (strict)."""

    def test_repo_has_no_unsuppressed_findings(self):
        result = framework.lint_repo(list(CONCURRENCY_RULES))
        assert not result.findings, "\n" + framework.render_text(result)

    def test_every_suppression_has_a_reason(self):
        result = framework.lint_repo(list(CONCURRENCY_RULES))
        missing = result.missing_reasons()
        assert not missing, (
            "suppressions without `-- <why>`: "
            + ", ".join(f"{p}:{s.line}" for p, s in missing)
        )

    def test_cli_strict_exits_zero(self):
        proc = subprocess.run(
            [sys.executable, "-m", "kmamiz_tpu_torch.tools.graftrace", "--strict"],
            cwd=REPO_ROOT,
            capture_output=True,
            text=True,
            timeout=300,
        )
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "0 finding(s)" in proc.stdout


class TestLockModel:
    @pytest.fixture(scope="class")
    def model(self):
        return locks.repo_model()

    @pytest.mark.parametrize(
        "lid",
        [
            "kmamiz_tpu_torch/graph/store.py:EndpointGraph._lock",
            "kmamiz_tpu_torch/fleet/coordinator.py:FleetCoordinator._lock",
            "kmamiz_tpu_torch/telemetry/registry.py:Counter._lock",
            "kmamiz_tpu_torch/fleet/__init__.py:_counters_lock",
            "kmamiz_tpu_torch/core/spans.py:RawIngestSession.lock",
            "kmamiz_tpu_torch/models/stlgt/trainer.py:ContinualTrainer._lock",
        ],
    )
    def test_inventories_known_locks(self, model, lid):
        assert lid in model.locks, lid

    def test_models_only_the_port(self, model):
        assert all(lid.startswith("kmamiz_tpu_torch/") for lid in model.locks)

    def test_condition_aliases_to_underlying_lock(self, model):
        barrier = "kmamiz_tpu_torch/fleet/coordinator.py:FleetCoordinator._barrier"
        assert model.locks[barrier].alias_of == (
            "kmamiz_tpu_torch/fleet/coordinator.py:FleetCoordinator._lock"
        )

    def test_repo_order_graph_is_acyclic(self, model):
        assert locks.find_cycles(model) == []

    def test_declared_edges_are_the_ports_and_none_stale(self, model):
        # the JAX table's one entry orders the store's lock before
        # core/programs.py's Program._lock, which the port does not have;
        # the port's one entry is the tick's trace source (a callable
        # attribute) reaching the zipkin breaker
        assert [d for d in jax_locks.DECLARED_EDGES if "core/programs.py" in d[1]]
        assert [(s, d) for s, d, _ in locks.DECLARED_EDGES] == [
            (
                "kmamiz_tpu_torch/server/processor.py:DataProcessor.tick_lock",
                "kmamiz_tpu_torch/resilience/breaker.py:CircuitBreaker._lock",
            )
        ]
        assert model.stale_declared == []
        assert not [lid for lid in model.locks if "core/programs.py" in lid]
        for src, dst, _ in locks.DECLARED_EDGES:
            assert (src, dst) in model.wide_edge_pairs

    def test_stale_declared_edge_is_a_finding(self):
        # a declaration naming a lock the extractor does not know surfaces
        # as a lock-order-cycle finding, not rot: the live table over the
        # corpus, whose processor.py has no tick lock, and a made-up one
        for declared, path in (
            (locks.DECLARED_EDGES, "kmamiz_tpu_torch/server/processor.py"),
            (
                (("kmamiz_tpu_torch/sync/guard.py:Router._lock", "kmamiz_tpu_torch/core/programs.py:Program._lock", "gone"),),
                "kmamiz_tpu_torch/sync/guard.py",
            ),
        ):
            result = lint_corpus(declared, rules=["lock-order-cycle"])
            assert [(f.path, f.line) for f in result.findings if "stale declaration" in f.message] == [(path, 1)]

    def test_package_init_call_edges_resolve(self, model):
        # `fleet_mod.incr(...)` under the coordinator lock reaches the
        # counters lock in fleet/__init__.py
        pair = (
            "kmamiz_tpu_torch/fleet/coordinator.py:FleetCoordinator._lock",
            "kmamiz_tpu_torch/fleet/__init__.py:_counters_lock",
        )
        assert pair in model.wide_edge_pairs

    def test_annotated_parameter_lock_resolves(self, model):
        # `with session.lock:` where the signature says
        # `session: RawIngestSession` must name the session lock
        pair = (
            "kmamiz_tpu_torch/core/spans.py:RawIngestSession.lock",
            "kmamiz_tpu_torch/core/interning.py:EndpointInterner._intern_lock",
        )
        assert pair in model.wide_edge_pairs


class TestBlockingDeviceSync:
    @pytest.mark.parametrize(
        "call",
        ["torch.cuda.synchronize()", "done.synchronize()", "t.item()", "t.cpu()", "t.tolist()"],
    )
    def test_device_sync_under_a_lock_reports(self, tmp_path, call):
        pkg = tmp_path / "kmamiz_tpu_torch" / "sync"
        pkg.mkdir(parents=True)
        (pkg / "m.py").write_text(
            "import threading\nimport torch\n_lock = threading.Lock()\n"
            f"def f(t, done):\n    with _lock:\n        return {call}\n"
        )
        result = framework.lint_paths(str(tmp_path), rules=["blocking-call-under-lock"])
        assert [(f.line, f.message.split(" while")[0]) for f in result.findings] == [(6, "device sync")]

    def test_device_sync_under_the_store_lock_alone_is_the_contract(self, tmp_path):
        pkg = tmp_path / "kmamiz_tpu_torch" / "graph"
        pkg.mkdir(parents=True)
        (pkg / "store.py").write_text(
            "import threading\nclass EndpointGraph:\n    def __init__(self):\n"
            "        self._lock = threading.RLock()\n"
            "    def count(self, t):\n        with self._lock:\n            return t.item()\n"
        )
        result = framework.lint_paths(str(tmp_path), rules=["blocking-call-under-lock"])
        assert not result.findings


class TestWitness:
    def test_disabled_by_default(self, monkeypatch):
        monkeypatch.delenv(witness.ENV_WITNESS, raising=False)
        assert not witness.enabled()
        monkeypatch.setenv(witness.ENV_WITNESS, "1")
        assert witness.enabled()
        monkeypatch.setenv(witness.ENV_WITNESS, "false")
        assert not witness.enabled()

    def test_armed_wraps_repo_created_locks_only(self):
        from kmamiz_tpu_torch.telemetry.registry import Counter

        with witness.armed():
            repo_lock = Counter()._lock  # created inside registry.py
            local_lock = threading.Lock()  # created here, in tests/
            assert type(repo_lock).__name__ == "_WitnessLock"
            assert type(local_lock).__name__ != "_WitnessLock"
        assert not witness.installed()

    def test_uninstall_restores_the_real_factories(self):
        import _thread

        real_lock, real_rlock = threading.Lock, threading.RLock
        assert witness._REAL_LOCK is real_lock and witness._REAL_RLOCK is real_rlock
        witness.install()
        assert threading.Lock is not real_lock and threading.RLock is not real_rlock
        witness.uninstall()
        assert threading.Lock is real_lock and threading.RLock is real_rlock
        assert threading.Lock is _thread.allocate_lock
        assert threading.RLock.__module__ == "threading"

    def test_jax_and_port_witnesses_nest_and_unwind(self):
        # either package's witness restores exactly what it found
        from kmamiz_tpu.analysis.concurrency import witness as jax_witness

        real_lock = threading.Lock
        try:
            with witness.armed():
                assert threading.Lock is not real_lock
            assert threading.Lock is real_lock and jax_witness._REAL_LOCK is real_lock
        finally:
            jax_witness.reset_for_tests()

    def test_records_order_edges_and_finds_cycles(self):
        from kmamiz_tpu_torch.telemetry.registry import Counter, Gauge

        with witness.armed():
            c, g = Counter(), Gauge()
            c._lock.acquire()
            g._lock.acquire()  # edge Counter._lock -> Gauge._lock
            g._lock.release()
            c._lock.release()
            g._lock.acquire()
            c._lock.acquire()  # reverse edge: closes the cycle
            c._lock.release()
            g._lock.release()
        report = witness.check(static=(set(), set()))
        assert report.edge_count == 2
        assert not report.acyclic and len(report.cycles) == 1
        assert any("registry.py" in s for s in report.cycles[0])
        # both sites are unknown to the (empty) static model handed in
        assert report.unknown_sites and report.uncovered

    def test_witnessed_edge_missing_from_static_model_is_a_finding(self):
        from kmamiz_tpu_torch.telemetry.registry import Counter, Gauge

        with witness.armed():
            c, g = Counter(), Gauge()
            with c._lock:
                with g._lock:
                    pass
        report = witness.check()  # the port's real static model
        # the sites are known (the extractor inventories registry.py), but
        # nothing in the port nests Counter under Gauge: a blind spot the
        # witness must flag, not absorb
        assert report.unknown_sites == []
        assert (COUNTER_LOCK, GAUGE_LOCK) in [tuple(p) for p in report.uncovered]
        assert not report.ok

    def test_clean_witness_state_is_ok(self):
        report = witness.check()
        assert report.edge_count == 0 and report.ok

    def test_snapshot_shape_and_hold_accounting(self):
        from kmamiz_tpu_torch.telemetry.registry import Counter

        with witness.armed():
            Counter().inc()
        snap = witness.snapshot()
        assert snap["enabled"] is False  # env not set in tests
        assert COUNTER_LOCK in snap["locks"]
        assert snap["locks"][COUNTER_LOCK]["acquires"] >= 1
        assert snap["locks"][COUNTER_LOCK]["maxHoldMs"] >= 0.0

    def test_check_snapshot_equals_check(self):
        from kmamiz_tpu_torch.telemetry.registry import Counter, Gauge

        with witness.armed():
            c, g = Counter(), Gauge()
            with c._lock:
                with g._lock:
                    pass
        # through JSON, as another process's /timings hands it over
        snap = json.loads(json.dumps(witness.snapshot()))
        got, want = witness.check_snapshot(snap), witness.check()
        assert (got.edge_count, got.acquire_count, got.cycles, got.uncovered, got.unknown_sites) == (
            want.edge_count, want.acquire_count, want.cycles, want.uncovered, want.unknown_sites
        )
        assert got.acquire_count == 2 and got.edge_count == 1

    def test_rlock_reentry_records_one_acquire_depth(self):
        from kmamiz_tpu_torch.graph.store import EndpointGraph

        with witness.armed():
            lk = EndpointGraph.__new__(EndpointGraph)  # no full init
            lk._lock = threading.RLock()
        # the RLock was created in THIS file (tests/), so it stays raw
        assert type(lk._lock).__name__ != "_WitnessLock"

    def test_witnessed_rlock_reentry_counts_once(self):
        from kmamiz_tpu_torch.graph.store import EndpointGraph

        with witness.armed():
            graph = EndpointGraph(device="cpu")
            assert type(graph._lock).__name__ == "_WitnessLock"
            with graph._lock:
                with graph._lock:
                    pass
        site = witness._site_str(graph._lock._site)
        assert witness.snapshot()["locks"][site]["acquires"] == 1


class TestStoreScorerLocking:
    """The scorer memo read happens under the store's lock (the JAX
    package's regression pin for graftrace's findings in graph/store.py):
    a memo hit stays bit-exact and still counts as a hit."""

    def test_scorer_memo_hit_is_locked_and_bit_exact(self, pdas_traces):
        from kmamiz_tpu_torch.core.spans import spans_to_batch
        from kmamiz_tpu_torch.graph.store import EndpointGraph

        batch = spans_to_batch([pdas_traces])
        graph = EndpointGraph(interner=batch.interner, device="cpu")
        graph.merge_window(batch)
        first = graph.service_scores()
        hits_before = graph.scorer_cache_stats()["hits"]
        second = graph.service_scores()
        assert graph.scorer_cache_stats()["hits"] == hits_before + 1
        assert np.array_equal(np.asarray(first.instability), np.asarray(second.instability))
        assert np.array_equal(np.asarray(first.ais), np.asarray(second.ais))


class TestWitnessedSoak:
    def test_fleet_migration_soak_under_witness(self, monkeypatch):
        """The lock-witnessed fleet-migration soak (seed 0) passes every
        gate with zero witnessed cycles and zero witnessed edges missing
        from the port's static model."""
        from kmamiz_tpu_torch.scenarios.factory import build_scenario
        from kmamiz_tpu_torch.scenarios.runner import run_scenario

        monkeypatch.setenv(witness.ENV_WITNESS, "1")
        card = run_scenario(build_scenario("fleet-migration", 0, 9, 10), device="cpu")
        assert card["pass"], card["gates"]
        assert card["gates"]["lock_witness_acyclic"] is True
        assert card["gates"]["lock_witness_covered"] is True
        lw = card["lock_witness"]
        assert lw["edges"] > 0 and lw["acquires"] > 0
        assert lw["cycles"] == [] and lw["uncovered"] == []
        assert lw["unknownSites"] == []
        # the runner disarms the witness when the scenario ends
        assert not witness.installed()

    def test_fleet_card_has_no_witness_gates_unarmed(self, monkeypatch):
        from kmamiz_tpu_torch.scenarios.factory import build_scenario
        from kmamiz_tpu_torch.scenarios.runner import run_scenario

        monkeypatch.delenv(witness.ENV_WITNESS, raising=False)
        card = run_scenario(build_scenario("fleet-migration", 0, 9, 10), device="cpu")
        assert card["pass"] and card["lock_witness"] is None
        assert "lock_witness_acyclic" not in card["gates"]


class TestDataProcessorWitness:
    def test_timings_lock_witness_under_the_env(self, monkeypatch, pdas_traces):
        """The DP armed as main() arms it (KMAMIZ_LOCK_WITNESS=1, before
        the processor exists): /timings' lockWitness reads installed with
        acquires, and its edges hold to the port's static model."""
        from kmamiz_tpu_torch.server import dp_server
        from kmamiz_tpu_torch.server.processor import DataProcessor

        monkeypatch.setenv(witness.ENV_WITNESS, "1")
        assert dp_server.arm_lock_witness() is True
        server = dp_server.DataProcessorServer(
            DataProcessor(trace_source=lambda lb, t, lim: [pdas_traces], device="cpu", wal=None),
            host="127.0.0.1",
            port=0,
        )
        server.start()
        try:
            body = json.dumps({"uniqueId": "w", "lookBack": 30_000, "time": 0}).encode()
            req = urllib.request.Request(f"http://127.0.0.1:{server.port}/", data=body)
            with urllib.request.urlopen(req, timeout=60) as resp:
                assert resp.status == 200
            with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/timings", timeout=30) as resp:
                lw = json.loads(resp.read())["lockWitness"]
        finally:
            server.stop()
        assert lw["enabled"] is True and lw["installed"] is True
        assert sum(v["acquires"] for v in lw["locks"].values()) > 0
        assert all(site.startswith("kmamiz_tpu_torch/") for site in lw["locks"])
        report = witness.check_snapshot(lw)
        assert report.ok, (report.cycles, report.uncovered, report.unknown_sites)

    def test_tick_through_the_zipkin_client_is_covered(self, monkeypatch, pdas_traces):
        """The DP as main() wires it: its trace source is the Zipkin
        client, whose GETs go through the zipkin breaker under the tick
        lock, an edge only the declared table names."""
        import http.server

        from kmamiz_tpu_torch.ingestion.zipkin import ZipkinClient
        from kmamiz_tpu_torch.resilience import breaker
        from kmamiz_tpu_torch.server import dp_server
        from kmamiz_tpu_torch.server.processor import DataProcessor

        body = json.dumps([pdas_traces]).encode()

        class Zipkin(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - the stdlib's name
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        stub = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Zipkin)
        threading.Thread(target=stub.serve_forever, daemon=True).start()
        breaker.reset_for_tests()  # the zipkin breaker is made armed
        monkeypatch.setenv(witness.ENV_WITNESS, "1")
        assert dp_server.arm_lock_witness() is True
        zipkin = ZipkinClient(f"http://127.0.0.1:{stub.server_address[1]}")
        proc = DataProcessor(trace_source=zipkin.get_trace_list, device="cpu", wal=None)
        try:
            resp = proc.collect({"uniqueId": "z", "lookBack": 30_000, "time": 0})
        finally:
            stub.shutdown()
            breaker.reset_for_tests()
        assert resp["dependencies"]
        report = witness.check()
        assert report.ok, (report.cycles, report.uncovered, report.unknown_sites)
        edges = {(e["src"].rsplit(":", 1)[0], e["dst"].rsplit(":", 1)[0]) for e in witness.snapshot()["edges"]}
        assert ("kmamiz_tpu_torch/server/processor.py", "kmamiz_tpu_torch/resilience/breaker.py") in edges

    def test_unarmed_without_the_env(self, monkeypatch):
        from kmamiz_tpu_torch.server import dp_server

        monkeypatch.delenv(witness.ENV_WITNESS, raising=False)
        assert dp_server.arm_lock_witness() is False
        assert threading.Lock is witness._REAL_LOCK


class TestCLI:
    def test_list_rules(self, capsys):
        from kmamiz_tpu_torch.tools.graftrace import main

        assert main(["--list-rules"]) == 0
        out = capsys.readouterr().out
        for rule in CONCURRENCY_RULES:
            assert rule in out

    def test_locks_table_lists_inventory(self, capsys):
        from kmamiz_tpu_torch.tools.graftrace import main

        assert main(["--locks"]) == 0
        out = capsys.readouterr().out
        assert "kmamiz_tpu_torch/graph/store.py:EndpointGraph._lock" in out
        assert "lock site(s)" in out
        assert "kmamiz_tpu/" not in out

    def test_dot_graph_is_wellformed(self, capsys):
        from kmamiz_tpu_torch.tools.graftrace import main

        assert main(["--dot"]) == 0
        out = capsys.readouterr().out
        assert out.startswith("digraph graftrace {")
        assert out.rstrip().endswith("}")
        assert "->" in out

    def test_rejects_non_concurrency_rule(self, capsys):
        from kmamiz_tpu_torch.tools.graftrace import main

        assert main(["--rules", "dtype-drift"]) == 2

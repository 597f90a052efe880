"""Closed-loop scenario runner: a real server, a storyline, a scorecard.

Counterpart of kmamiz_tpu/scenarios/runner.py. One :func:`run_scenario`
call boots a real in-process ``DataProcessorServer`` (a ``TickRouter``
mounting every tenant of the spec with its own trace source, which the
driver controls) on the given device, and replays the storyline tick by
tick over HTTP: ticks through ``POST /`` (or ``/t/<tenant>/``), poison
storms through ``POST /ingest``, upstream flaps through per-tenant
circuit breakers around the sources, tick stalls through the watchdog
deadline, and kill -9 through a crashed child process whose ingest WAL
the scenario's processor replays. Reader threads keep health and
``/timings`` pressure on the same server meanwhile.

The scorecard's oracle for lost spans and determinism is a reference
graph: every span group the runner hands the live system is recorded, in
ingest order, and at the end a new processor ingests exactly that
sequence. ``graph_signature`` equality means the soak lost and
duplicated nothing, whatever stale serves, breaker trips and WAL replays
happened. Span content is arithmetic over (tick, trace)
(:mod:`.topology`), so re-posting a tick during recovery probes cannot
change the merged content.

The gates (``scorecard["gates"]``): bit-exact graphs and zero lost spans;
stale serves present and bounded for degrading storylines, none
otherwise; every poisoned delivery quarantined; recovery to fresh after
each degrading fault; the child's SIGKILL and a full WAL replay for
kill-9 storylines; a crossed capacity bucket for growth storylines. The
fleet-migration archetype runs the fleet harness (fleet/soak.py) and the
wal-replay archetype a recorded WAL (soak/walreplay.py).

What differs from the JAX runner:

- No compile counting. The JAX cards' ``steady_recompiles``,
  ``mid_tick_compiles`` and the ``zero_steady_recompiles`` gate count
  XLA compiles, and nothing is compiled per shape here. The warmup and
  window-shape rehearsal stay: their windows are part of each tenant's
  ingest log, so the graphs are the JAX runner's.
- No compile-cost plane: growth storylines run no prewarm drains and the
  card has no ``cost`` section.
- Knobs the port takes as arguments are passed as arguments: the poison
  storylines' ingest cap (KMAMIZ_INGEST_MAX_BYTES in the JAX runner) is
  each processor's ``max_payload_bytes``, the streaming archetype's epoch
  (KMAMIZ_STREAM_EPOCH_TICKS) the stream engine's ``epoch_ticks``, and
  the counterfactual's SLO, hysteresis, warm-up gate and probe
  (KMAMIZ_CONTROL_SLO_MS etc.) the controller's settings
  (``control.configure``). What the port reads from the environment
  (KMAMIZ_TICK_DEADLINE_MS, KMAMIZ_QUARANTINE_DIR, KMAMIZ_WAL,
  KMAMIZ_WAL_DIR, KMAMIZ_STREAM, KMAMIZ_CONTROL, KMAMIZ_CONTROL_MODE) is
  set for the scenario's span and restored after it.
- The soak workers' harness is this module's own (`run_soak_workers`).
- Under KMAMIZ_LOCK_WITNESS=1 a scenario runs with the lock witness
  armed, as in the JAX runner; the fleet-migration card then carries the
  ``lock_witness_acyclic`` and ``lock_witness_covered`` gates.

The kill-9 child is ``python -m kmamiz_tpu_torch.scenarios.runner
--child-kill --device <the parent's device>``.
"""
from __future__ import annotations

import contextlib
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

from kmamiz_tpu_torch.device import DeviceLike
from kmamiz_tpu_torch.scenarios.factory import SEED_STRIDE, ScenarioSpec, build_scenario
from kmamiz_tpu_torch.scenarios.storyline import growth_groups, growth_twin_groups, poison_payloads_for
from kmamiz_tpu_torch.scenarios.topology import tick_groups, trace_group
from kmamiz_tpu_torch.telemetry.profiling import events as prof_events

#: completed scorecards, newest last
_RUNS_LOCK = threading.Lock()
_RUNS: List[dict] = []

#: wall-clock ceiling per scenario: a wedged scenario fails loudly
#: instead of hanging the matrix
SCENARIO_MAX_WALL_S = 600.0

#: recovery probe loop: attempts x sleep bounds recovery-to-fresh
RECOVERY_ATTEMPTS = 120
RECOVERY_SLEEP_S = 0.05

STALL_DEADLINE_MS = 250
STALL_SLEEP_S = 1.0

#: the freshness SLO of the streaming archetype: span arrival -> visible
#: p99 ceiling
FRESHNESS_SLO_MS = 250.0

#: the poison storylines' ingest cap: under chaos.mutate_payload's bomb
#: (~4.1 KB), so every poison-storm bomb trips it
POISON_SIZE_CAP = 4000

#: the streaming archetype's stream epoch: the tick-stall storyline
#: changes the deadline mid-stream and expects it live on the next
#: micro-tick
STREAM_EPOCH_TICKS = 1

KILL9_WINDOWS = 5


def reset_for_tests() -> None:
    with _RUNS_LOCK:
        _RUNS.clear()


def recorded_runs() -> List[dict]:
    with _RUNS_LOCK:
        return list(_RUNS)


@contextlib.contextmanager
def scoped_env(pairs: Dict[str, Optional[str]]):
    """Set environment switches for one scenario, restoring the prior
    values after it (None removes the key): scenarios must not leak
    switches into each other."""
    saved = {k: os.environ.get(k) for k in pairs}
    try:
        for k, v in pairs.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_soak_workers(worker_fns: Sequence[Callable[[], None]], seconds: float) -> Tuple[List[str], float]:
    """Run each function in a loop on a thread of its own until the
    deadline or the first exception (which stops them all); returns (the
    errors, the wall in s). A thread that will not stop raises."""
    errors: List[str] = []
    stop = threading.Event()
    deadline = prof_events.now_ms() + seconds * 1e3

    def guard(fn):
        def run():
            try:
                while prof_events.now_ms() < deadline and not stop.is_set():
                    fn()
            except Exception as e:  # noqa: BLE001 - reported, and the loop stops
                errors.append(f"{fn.__name__}: {e!r}")
                stop.set()

        return run

    threads = [threading.Thread(target=guard(fn), daemon=True) for fn in worker_fns]
    t0 = prof_events.now_ms()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        if t.is_alive():
            raise RuntimeError("soak worker failed to stop")
    return errors, (prof_events.now_ms() - t0) / 1e3


class _ScenarioSource:
    """A tenant's trace source, driven by the runner, behind that tenant's
    circuit breaker. The driver pushes a tick's groups before posting the
    tick; a flap makes the upstream raise (tripping the breaker), a stall
    makes it hang past the watchdog deadline. Pending groups survive failed
    calls, so recovery probes drain them exactly once."""

    def __init__(self, tenant: str) -> None:
        self.tenant = tenant
        self._lock = threading.Lock()
        self._pending: List[List[dict]] = []
        self.fail = False
        self.stall_s = 0.0

    def push(self, groups: List[List[dict]]) -> None:
        with self._lock:
            self._pending.extend(groups)

    def __call__(self, _look_back, _end_ts, _limit):
        from kmamiz_tpu_torch.resilience.breaker import get_breaker

        def upstream():
            if self.fail:
                raise ConnectionError("scenario: upstream flap")
            if self.stall_s:
                time.sleep(self.stall_s)
            with self._lock:
                groups, self._pending = self._pending, []
            return groups

        breaker = get_breaker("scenario-upstream", tenant=self.tenant, threshold=3, cooldown_s=0.25)
        return breaker.call(upstream)


def _tenant_prefix(tenant: str) -> str:
    return "" if tenant == "default" else f"/t/{tenant}"


def _post_tick(port: int, tenant: str, unique_id: str, timeout_s: float = 120.0) -> Tuple[int, dict, float]:
    body = json.dumps(
        {
            "uniqueId": unique_id,
            "lookBack": 30_000,
            # the real clock: the processed-trace TTL prunes against ingest
            # time, so a virtual epoch here would strand dedup entries
            "time": int(prof_events.wall_ms()),
        }
    ).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{_tenant_prefix(tenant)}/",
        data=body,
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    t0 = prof_events.now_ms()
    with urllib.request.urlopen(req, timeout=timeout_s) as resp:
        payload = json.loads(resp.read())
        return resp.status, payload, prof_events.now_ms() - t0


def _post_ingest(port: int, tenant: str, raw: bytes) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{_tenant_prefix(tenant)}/ingest",
        data=raw,
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


# -- storyline -> per-tick view ----------------------------------------------


def _deploy_version_fn(plan, tick: int):
    """istio.canonical_revision per service at ``tick`` under any active
    rolling-deploy event: one service of the event's order flips to v2
    per elapsed tick."""
    flipped = set()
    for ev in plan.events:
        if ev.kind == "rolling-deploy" and tick >= ev.at_tick:
            (order,) = ev.params
            flipped.update(order[: tick - ev.at_tick + 1])

    def version_of(svc: str) -> str:
        return "v2" if svc in flipped else "v1"

    return version_of


def _tick_view(plan, tick: int) -> dict:
    """What the storyline does to this tenant at this tick."""
    view = {
        "flap": False,
        "stall": False,
        "drop": set(),
        "error": set(),
        "latency_us": 0,
        "poisons": [],
        "growth": [],
    }
    for ev in plan.events:
        if not ev.active(tick):
            continue
        if ev.kind == "upstream-flap":
            view["flap"] = True
        elif ev.kind == "tick-stall":
            view["stall"] = True
        elif ev.kind == "partial-outage":
            view["drop"].update(ev.params[0])
        elif ev.kind == "cascade":
            view["error"].update(ev.params[0])
            view["latency_us"] = 5_000 * ev.params[1]
        elif ev.kind == "poison-storm":
            view["poisons"].append(ev)
        elif ev.kind == "capacity-growth":
            view["growth"].append(ev)
    return view


def kill9_windows(spec: ScenarioSpec) -> List[bytes]:
    """The raw windows a kill-9 storyline's crash child ingests (and the
    parent replays): spec content, made identically on both sides of the
    process boundary."""
    plan = spec.tenants[0]
    return [
        json.dumps([trace_group(plan.topology, f"{spec.name}-wal", 90 + w, i) for i in range(2)]).encode()
        for w in range(KILL9_WINDOWS)
    ]


def run_child_kill(archetype: str, seed: int, index: int, n_ticks: int, device: DeviceLike = None) -> None:
    """The crash child (the parent sets KMAMIZ_WAL=1 and the WAL's
    directory): merge every kill-9 window but the last, WAL-append the
    last and SIGKILL before its merge, the crash point ingest_raw_window's
    append-before-merge order exists for. Never returns."""
    from kmamiz_tpu_torch.server.processor import DataProcessor

    spec = build_scenario(archetype, seed, index, n_ticks)
    windows = kill9_windows(spec)
    dp = DataProcessor(trace_source=lambda *a: [], use_device_stats=False, device=device)
    for raw in windows[:-1]:
        dp.ingest_raw_window(raw)
    dp._wal_append(windows[-1])
    os.kill(os.getpid(), signal.SIGKILL)


def _run_kill9_child(spec: ScenarioSpec, wal_dir: str, device) -> dict:
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    base_seed = (spec.seed - spec.index) // SEED_STRIDE
    child_env = {**os.environ, "KMAMIZ_WAL": "1", "KMAMIZ_WAL_DIR": wal_dir}
    child = subprocess.run(
        [
            sys.executable,
            "-m",
            "kmamiz_tpu_torch.scenarios.runner",
            "--child-kill",
            "--archetype",
            spec.archetype,
            "--seed",
            str(base_seed),
            "--index",
            str(spec.index),
            "--ticks",
            str(spec.n_ticks),
            "--device",
            str(device),
        ],
        env=child_env,
        cwd=repo_root,
        capture_output=True,
        timeout=SCENARIO_MAX_WALL_S,
    )
    return {
        "child_sigkilled": child.returncode == -signal.SIGKILL,
        "returncode": child.returncode,
        "stderr_tail": child.stderr.decode(errors="replace")[-400:],
    }


# -- the closed loop ---------------------------------------------------------


def run_scenario(spec: ScenarioSpec, tmpdir: Optional[str] = None, verbose: bool = False, device: DeviceLike = None) -> dict:
    """Run one scenario against a real server on `device` (None: the card,
    raising without one); return its scorecard."""
    from kmamiz_tpu_torch import native
    from kmamiz_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if not native.available():
        raise RuntimeError("scenario runner requires the native library")
    with contextlib.ExitStack() as stack:
        if tmpdir is None:
            tmpdir = stack.enter_context(tempfile.TemporaryDirectory(prefix="kmamiz-scn-"))
        env: Dict[str, Optional[str]] = {
            "KMAMIZ_TICK_DEADLINE_MS": "0",
            "KMAMIZ_QUARANTINE_DIR": os.path.join(tmpdir, "quarantine"),
            "KMAMIZ_WAL": "1" if spec.has_event("kill9-replay") else "0",
            "KMAMIZ_WAL_DIR": os.path.join(tmpdir, "wal"),
            # the streaming archetype runs every tick as a micro-tick of the
            # stream engine (the freshness SLO and its stale-serve degraded
            # mode); every other one the serial tick
            "KMAMIZ_STREAM": "1" if spec.archetype == "streaming-freshness" else "0",
        }
        stack.enter_context(scoped_env(env))
        # lock-witness (KMAMIZ_LOCK_WITNESS=1): every lock the scenario
        # constructs from here on records real acquisition orders; the
        # fleet soak cross-checks them against the static graftrace model
        from kmamiz_tpu_torch.analysis.concurrency import witness

        if witness.enabled():
            stack.enter_context(witness.armed())
        _reset_shared_state()
        if spec.archetype == "fleet-migration":
            # archetype 10: a 4-worker ring behind one coordinator, with a
            # live WAL-handoff migration fired mid-soak
            from kmamiz_tpu_torch.fleet.soak import run_fleet_scenario

            card = run_fleet_scenario(spec, tmpdir, verbose, device=dev)
        elif spec.archetype == "wal-replay":
            # archetype 11: a recorded WAL window replayed through a live
            # server, held to a reference built from the same records
            from kmamiz_tpu_torch.soak.walreplay import run_wal_replay_scenario

            card = run_wal_replay_scenario(spec, tmpdir, verbose, device=dev)
        else:
            card = _run_scenario_inner(spec, tmpdir, verbose, dev)
    with _RUNS_LOCK:
        _RUNS.append(card)
    return card


def _reset_shared_state() -> None:
    """Per-scenario isolation: new breaker budgets, a new quarantine
    binding (the default one caches its directory at first use), a new
    tenant arena, controller, stream counters, freshness window and fleet
    counters."""
    from kmamiz_tpu_torch import control, fleet, tenancy
    from kmamiz_tpu_torch.resilience import breaker, quarantine
    from kmamiz_tpu_torch.server import stream as stream_mod
    from kmamiz_tpu_torch.telemetry import freshness

    breaker.reset_for_tests()
    quarantine.reset_for_tests()
    tenancy.reset_for_tests()
    control.reset_for_tests()
    stream_mod.reset_for_tests()
    freshness.reset_for_tests()
    fleet.reset_for_tests()


def _scenario_processors(spec: ScenarioSpec, sources: Dict[str, "_ScenarioSource"], device) -> dict:
    """Each tenant's live processor: the poison storylines' ingest cap as
    its `max_payload_bytes`, and for the streaming archetype a stream
    engine of STREAM_EPOCH_TICKS attached before the server serves."""
    from kmamiz_tpu_torch.resilience.quarantine import MAX_PAYLOAD_BYTES
    from kmamiz_tpu_torch.server import stream as stream_mod
    from kmamiz_tpu_torch.server.processor import DataProcessor

    cap = POISON_SIZE_CAP if spec.has_event("poison-storm") else MAX_PAYLOAD_BYTES
    procs = {
        p.tenant: DataProcessor(
            trace_source=sources[p.tenant],
            device=device,
            use_device_stats=False,
            tenant=p.tenant,
            max_payload_bytes=cap,
        )
        for p in spec.tenants
    }
    if spec.archetype == "streaming-freshness":
        for proc in procs.values():
            stream_mod.engine_for(proc, epoch_ticks=STREAM_EPOCH_TICKS)
    return procs


def _failed_gates_artifact(spec: ScenarioSpec, gates: dict) -> Optional[str]:
    """A failed gate is a reproducible SLO breach under a seeded
    storyline: freeze the flight box (force bypasses KMAMIZ_PROF=0 and the
    debounce) in the cell's namespace, ``<archetype>-<seed>``."""
    from kmamiz_tpu_torch.telemetry.profiling import recorder

    failed = sorted(g for g, ok in gates.items() if not ok)
    base_seed = (spec.seed - spec.index) // SEED_STRIDE
    return recorder.record(
        f"scenario-{spec.name}", ",".join(failed), force=True, namespace=f"{spec.archetype}-{base_seed}"
    )


def _run_scenario_inner(spec: ScenarioSpec, tmpdir: str, verbose: bool, device) -> dict:
    from kmamiz_tpu_torch.graph.store import graph_signature
    from kmamiz_tpu_torch.scenarios.factory import spec_signature
    from kmamiz_tpu_torch.server.dp_server import DataProcessorServer, _make_runtime
    from kmamiz_tpu_torch.telemetry import freshness as tel_freshness
    from kmamiz_tpu_torch.telemetry.slo import percentile
    from kmamiz_tpu_torch.tenancy.router import TickRouter

    t_start = prof_events.now_ms()
    state: dict = {
        "latencies": [],
        "stale": 0,
        "posts": 0,
        "quarantined": 0,
        "expected_poisons": 0,
        "poison_misses": 0,
        "recoveries": {},
        "recovered_all": True,
        "wal": None,
        "pre_caps": {},
        # per-tenant ordered ingest log: ("collect", groups) | ("raw", bytes)
        "expected": {p.tenant: [] for p in spec.tenants},
        "errors": [],
    }

    wal_info = None
    if spec.has_event("kill9-replay"):
        # crash a child mid-ingest before the server exists; the
        # scenario's own processor then replays the orphaned WAL
        wal_info = _run_kill9_child(spec, os.environ["KMAMIZ_WAL_DIR"], device)

    sources = {p.tenant: _ScenarioSource(p.tenant) for p in spec.tenants}
    procs = _scenario_processors(spec, sources, device)

    if wal_info is not None:
        plan0 = spec.tenants[0]
        replay = procs[plan0.tenant].replay_wal()
        windows = kill9_windows(spec)
        wal_info["replayed"] = replay["replayed"]
        wal_info["windows"] = len(windows)
        wal_info["ok"] = wal_info["child_sigkilled"] and replay["replayed"] == len(windows)
        for raw in windows:
            state["expected"][plan0.tenant].append(("raw", raw))
    state["wal"] = wal_info

    # the server's default processor is the first tenant's, as in the JAX
    # runner; the readers' GET / reaches it through the default tenant's
    # runtime
    default_proc = procs[spec.tenants[0].tenant]
    router = TickRouter(lambda tenant: _make_runtime(tenant, procs.get(tenant, default_proc)))
    server = DataProcessorServer(default_proc, host="127.0.0.1", port=0, router=router)
    server.start()
    try:
        steps = _drive(spec, state, server.port, sources, procs)

        def driver():
            next(steps)

        def reader():
            # concurrent read pressure on the same server: health and the
            # /timings surface
            for path in ("/", "/timings"):
                req = urllib.request.Request(f"http://127.0.0.1:{server.port}{path}")
                with urllib.request.urlopen(req, timeout=60) as resp:
                    resp.read()
            time.sleep(0.02)

        errors, _wall = run_soak_workers((driver, reader), seconds=SCENARIO_MAX_WALL_S)
        # the driver signals completion by exhausting its generator
        real_errors = [e for e in errors if "StopIteration" not in e]
        if real_errors:
            state["errors"].extend(real_errors)
        live_sigs = {p.tenant: graph_signature(procs[p.tenant].graph) for p in spec.tenants}
        end_caps = {p.tenant: int(procs[p.tenant].graph.capacity) for p in spec.tenants}
        lost_spans, missing = _lost_spans(spec, state, procs)
    finally:
        server.stop()

    ref_sigs = _reference_signatures(spec, state, device)
    fresh = tel_freshness.snapshot()
    streaming = spec.archetype == "streaming-freshness"
    lat = sorted(state["latencies"])
    recovery_ms = max(state["recoveries"].values(), default=0.0)
    degrading = spec.has_event("upstream-flap") or spec.has_event("tick-stall")
    stale_rate = state["stale"] / max(1, state["posts"])

    has_growth = spec.has_event("capacity-growth")
    growth_tenants = [p.tenant for p in spec.tenants if any(ev.kind == "capacity-growth" for ev in p.events)]
    gates = {
        "no_errors": not state["errors"],
        "bit_exact": all(live_sigs[t] == ref_sigs[t] for t in live_sigs),
        "zero_lost_spans": lost_spans == 0,
        # growth storylines cross a capacity bucket mid-soak by design
        "bucket_crossed": all(end_caps[t] > state["pre_caps"].get(t, 1 << 62) for t in growth_tenants)
        if has_growth
        else True,
        "stale_bounded": (state["stale"] >= 1 and stale_rate <= 0.6) if degrading else state["stale"] == 0,
        "quarantine_exact": (
            state["quarantined"] == state["expected_poisons"]
            and state["poison_misses"] == 0
            and (state["expected_poisons"] > 0 or not spec.has_event("poison-storm"))
        ),
        "recovered_to_fresh": state["recovered_all"],
        "wal_replayed": state["wal"]["ok"] if state["wal"] else True,
        # the streaming soak must hold the 250 ms arrival-to-visible p99
        # or visibly take the degraded mode (a stale serve) under its
        # stall: a silent freshness collapse behind fresh 200s fails
        "freshness_slo": (fresh["samples"] > 0 and (fresh["freshness_ms_p99"] < FRESHNESS_SLO_MS or state["stale"] >= 1))
        if streaming
        else True,
    }
    card = {
        "name": spec.name,
        "archetype": spec.archetype,
        "spec_signature": spec_signature(spec),
        "n_ticks": spec.n_ticks,
        "tenants": [p.tenant for p in spec.tenants],
        "posts": state["posts"],
        "stale_serves": state["stale"],
        "stale_rate": round(stale_rate, 4),
        "p50_tick_ms": round(percentile(lat, 0.50), 2),
        "p95_tick_ms": round(percentile(lat, 0.95), 2),
        "p99_tick_ms": round(percentile(lat, 0.99), 2),
        "lost_spans": lost_spans,
        "missing_traces": missing[:8],
        "quarantined": state["quarantined"],
        "expected_poisons": state["expected_poisons"],
        "recovery_ms": round(recovery_ms, 1),
        "recoveries": {k: round(v, 1) for k, v in state["recoveries"].items()},
        "capacity": {t: [state["pre_caps"].get(t), end_caps.get(t)] for t in growth_tenants},
        "signatures": live_sigs,
        "ref_signatures": ref_sigs,
        "freshness": fresh,
        "wal": state["wal"],
        "errors": state["errors"][:4],
        "gates": gates,
        "pass": all(gates.values()),
        "wall_s": round((prof_events.now_ms() - t_start) / 1000, 1),
    }
    if not card["pass"]:
        card["flight_artifact"] = _failed_gates_artifact(spec, gates)
    if verbose:
        print(f"{spec.name}: pass={card['pass']} gates={gates}", file=sys.stderr)
    return card


def _drive(
    spec: ScenarioSpec,
    state: dict,
    port: int,
    sources: Dict[str, _ScenarioSource],
    procs: Dict[str, object],
) -> Iterator[None]:
    """The storyline as a step generator (one tick-unit of work per
    ``next()``), run as a soak worker beside the readers. Exhaustion
    (StopIteration) is the completion signal."""
    # the JAX runner's warmup: every path under every version map the
    # storyline will serve, per tenant; then its window-shape rehearsal,
    # one window of each distinct tick shape (the JAX package compiles
    # its merge programs there). Nothing compiles here, but the windows
    # are part of the tenant's ingest log, and the capacity the growth
    # gate starts from is the one after them
    for plan in spec.tenants:
        topo = plan.topology
        warm: List[List[dict]] = []
        stages = {0: _deploy_version_fn(plan, -1)}
        for ev in plan.events:
            if ev.kind == "rolling-deploy":
                for t in range(ev.at_tick, ev.at_tick + ev.duration):
                    stages[len(stages)] = _deploy_version_fn(plan, t)
        for s_i, version_of in stages.items():
            for p_i in range(len(topo.paths)):
                warm.append(trace_group(topo, f"{spec.name}-warm{s_i}", 0, p_i, version_of=version_of))
        sources[plan.tenant].push(warm)
        state["expected"][plan.tenant].append(("collect", warm))
        status, body, _ms = _post_tick(port, plan.tenant, f"{spec.name}-warm-{plan.tenant}")
        if status != 200 or body.get("stale"):
            state["errors"].append(f"warmup failed for {plan.tenant}")
        yield

        rehearsed = set()
        for t in range(spec.n_ticks):
            view = _tick_view(plan, t)
            if view["flap"]:
                continue
            groups = tick_groups(
                topo,
                f"{spec.name}-wr{t}",
                t,
                plan.traffic[t],
                drop_services=frozenset(view["drop"]),
                error_services=frozenset(view["error"]),
                version_of=_deploy_version_fn(plan, t),
                latency_boost_us=view["latency_us"],
            )
            for ev in view["growth"]:
                # shape twins: the ramp tick's group lengths on one repeated
                # edge, leaving the capacity ramp itself to the soak
                groups = groups + growth_twin_groups(ev, topo, f"{spec.name}-wr{t}", t)
            shape_key = tuple(sorted(len(g) for g in groups))
            if not groups or shape_key in rehearsed:
                continue
            rehearsed.add(shape_key)
            sources[plan.tenant].push(groups)
            state["expected"][plan.tenant].append(("collect", groups))
            status, body, _ms = _post_tick(port, plan.tenant, f"{spec.name}-wr{t}-{plan.tenant}")
            if status != 200 or body.get("stale"):
                state["errors"].append(f"rehearsal {t} failed for {plan.tenant}")
            yield

    state["pre_caps"] = {p.tenant: int(procs[p.tenant].graph.capacity) for p in spec.tenants}
    degraded_prev = {p.tenant: False for p in spec.tenants}

    for tick in range(spec.n_ticks):
        for plan in spec.tenants:
            src = sources[plan.tenant]
            view = _tick_view(plan, tick)
            uid = f"{spec.name}-t{tick}-{plan.tenant}"

            # poison storms ride the raw-ingest path; every delivery must
            # divert to the tenant's quarantine, touching nothing
            for ev in view["poisons"]:
                clean = json.dumps([trace_group(plan.topology, f"{spec.name}-poison", tick, 0)]).encode()
                for _kind, payload in poison_payloads_for(ev, plan.topology, tick, clean):
                    state["expected_poisons"] += 1
                    summary = _post_ingest(port, plan.tenant, payload)
                    got = summary.get("quarantined", 0)
                    state["quarantined"] += got
                    if got != 1 or summary.get("spans", 0) != 0:
                        state["poison_misses"] += 1

            if view["flap"]:
                # the upstream fails hard: the tenant's breaker trips and
                # the server degrades to its last good graph
                src.fail = True
                status, body, _ms = _post_tick(port, plan.tenant, uid)
                src.fail = False
                state["posts"] += 1
                if status == 200 and body.get("stale"):
                    state["stale"] += 1
                else:
                    state["errors"].append(f"flap tick {tick} ({plan.tenant}): expected stale, got {status}")
                degraded_prev[plan.tenant] = True
                yield
                continue

            groups = tick_groups(
                plan.topology,
                spec.name,
                tick,
                plan.traffic[tick],
                drop_services=frozenset(view["drop"]),
                error_services=frozenset(view["error"]),
                version_of=_deploy_version_fn(plan, tick),
                latency_boost_us=view["latency_us"],
            )
            for ev in view["growth"]:
                # the measured capacity ramp: per_tick new /grow/<k>
                # endpoints ride the ordinary collect path
                groups = groups + growth_groups(ev, plan.topology, spec.name, tick)

            if view["stall"]:
                # the source hangs past the watchdog deadline: a stale serve
                # now, the straggler merges the groups late
                src.push(groups)
                state["expected"][plan.tenant].append(("collect", groups))
                src.stall_s = STALL_SLEEP_S
                with scoped_env({"KMAMIZ_TICK_DEADLINE_MS": str(STALL_DEADLINE_MS)}):
                    status, body, _ms = _post_tick(port, plan.tenant, uid)
                src.stall_s = 0.0
                state["posts"] += 1
                if status == 200 and body.get("stale"):
                    state["stale"] += 1
                else:
                    state["errors"].append(f"stall tick {tick} ({plan.tenant}): expected stale, got {status}")
                # the straggler's late merge lands before the next tick
                # posts (the ingest order stays deterministic)
                time.sleep(STALL_SLEEP_S + 0.5)
                degraded_prev[plan.tenant] = True
                yield
                continue

            if degraded_prev[plan.tenant]:
                # the first tick after a degraded window: recovery to fresh
                # (the breaker's cooldown and half-open probe)
                src.push(groups)
                state["expected"][plan.tenant].append(("collect", groups))
                t0 = prof_events.now_ms()
                fresh = False
                for _attempt in range(RECOVERY_ATTEMPTS):
                    status, body, ms = _post_tick(port, plan.tenant, uid)
                    state["posts"] += 1
                    if status == 200 and not body.get("stale"):
                        fresh = True
                        break
                    state["stale"] += 1
                    time.sleep(RECOVERY_SLEEP_S)
                state["recoveries"][f"{plan.tenant}@t{tick}"] = prof_events.now_ms() - t0
                if not fresh:
                    state["recovered_all"] = False
                    state["errors"].append(f"no recovery to fresh by tick {tick} ({plan.tenant})")
                degraded_prev[plan.tenant] = False
                yield
                continue

            src.push(groups)
            state["expected"][plan.tenant].append(("collect", groups))
            status, body, ms = _post_tick(port, plan.tenant, uid)
            state["posts"] += 1
            if status != 200:
                state["errors"].append(f"tick {tick} ({plan.tenant}): {status}")
            elif body.get("stale"):
                state["stale"] += 1
                state["errors"].append(f"unexpected stale at tick {tick} ({plan.tenant})")
            else:
                state["latencies"].append(ms)
            yield


def _lost_spans(spec: ScenarioSpec, state: dict, procs) -> Tuple[int, List[str]]:
    """Every trace id the runner handed the live system must be in the
    tenant's dedup registry; a missing trace's spans are lost spans."""
    lost = 0
    missing: List[str] = []
    for plan in spec.tenants:
        expected_groups: List[List[dict]] = []
        for kind, payload in state["expected"][plan.tenant]:
            if kind == "raw":
                expected_groups.extend(json.loads(payload))
            else:
                expected_groups.extend(payload)
        dp = procs[plan.tenant]
        with dp._dedup_lock:
            processed = set(dp._processed)
        for group in expected_groups:
            tid = group[0]["traceId"]
            if tid not in processed:
                lost += len(group)
                missing.append(f"{plan.tenant}:{tid}")
    return lost, missing


def _reference_signatures(spec: ScenarioSpec, state: dict, device) -> Dict[str, str]:
    """Rebuild each tenant's graph from the recorded ingest log on a new
    processor (no WAL, the default ingest cap) on the same device, with
    the live paths (collect windows through collect, raw windows through
    raw ingest) in the live order: the bit-exactness oracle."""
    from kmamiz_tpu_torch.graph.store import graph_signature
    from kmamiz_tpu_torch.server.processor import DataProcessor

    sigs: Dict[str, str] = {}
    for plan in spec.tenants:
        pending: List[List[List[dict]]] = []

        def source(_lb, _t, _lim, _pending=pending):
            return _pending.pop(0) if _pending else []

        ref = DataProcessor(trace_source=source, device=device, use_device_stats=False, wal=None)
        for i, (kind, payload) in enumerate(state["expected"][plan.tenant]):
            if kind == "raw":
                ref.ingest_raw_window(payload)
            else:
                pending.append(payload)
                ref.collect({"uniqueId": f"ref-{plan.tenant}-{i}", "lookBack": 30_000, "time": int(prof_events.wall_ms())})
        sigs[plan.tenant] = graph_signature(ref.graph)
    return sigs


# -- the control plane's counterfactual --------------------------------------

#: the counterfactual runs' span-content SLO: between the baseline window
#: p99 (~1.3 ms: 1_000 + hop*37 us spans) and the smallest cascade boost
#: (multiplier 2 -> +10 ms), so OFF always violates on cascade ticks and
#: never elsewhere
CF_SLO_MS = 5.0

#: the "all clear" forecast published outside the cascade window
CF_CLEAR_P99_MS = 1.2

#: the controller's settings in the ON arm (the JAX runner's env values):
#: hysteresis 1, since the oracle forecast is noise-free and admission must
#: track the cascade window's edges exactly
CF_CONTROL = dict(slo_ms=CF_SLO_MS, hysteresis=1, warmup_gate=0.5, probe_s=0.05)


def _window_p99_ms(groups: List[List[dict]]) -> float:
    """Span-content p99 of one tick window, in ms (span ``duration`` is
    us): the violation oracle both counterfactual arms share."""
    from kmamiz_tpu_torch.telemetry.slo import percentile

    return percentile(sorted(span["duration"] / 1000.0 for group in groups for span in group), 0.99)


def _breach_ticks(plan) -> List[int]:
    """Ticks whose storyline view carries a cascade latency boost: the
    ticks an oracle forecast flags and (with hysteresis 1) exactly those
    the ON arm defers."""
    return [t for t in range(len(plan.traffic)) if _tick_view(plan, t)["latency_us"] > 0]


def _counterfactual_run(
    spec: ScenarioSpec,
    control_on: bool,
    forecast_p99_ms: float,
    attributions: Tuple,
    tmpdir: str,
    device,
) -> dict:
    """One arm of the counterfactual: the cascade storyline against a
    real server, driven serially, with the control plane ON or OFF. The ON
    arm publishes the oracle forecast through the fold hook's entry,
    ``ingest_forecast``, one evaluation before each tick; everything else
    (spec, windows, seeds) is identical."""
    from kmamiz_tpu_torch import control
    from kmamiz_tpu_torch.graph.store import graph_signature
    from kmamiz_tpu_torch.resilience import breaker as breaker_mod
    from kmamiz_tpu_torch.server.dp_server import DataProcessorServer, _make_runtime
    from kmamiz_tpu_torch.server.processor import DataProcessor
    from kmamiz_tpu_torch.tenancy.router import TickRouter

    plan = spec.tenants[0]
    topo = plan.topology
    tenant = plan.tenant
    env: Dict[str, Optional[str]] = {
        "KMAMIZ_TICK_DEADLINE_MS": "0",
        "KMAMIZ_QUARANTINE_DIR": os.path.join(tmpdir, "quarantine"),
        "KMAMIZ_WAL": "0",
        "KMAMIZ_CONTROL": "1" if control_on else "0",
        "KMAMIZ_CONTROL_MODE": "defer",
    }
    breach = set(_breach_ticks(plan))
    run = {
        "control": control_on,
        "posts": 0,
        "violations": 0,
        "deferred": 0,
        "shed": 0,
        "stale": 0,
        "errors": [],
    }
    state: dict = {"expected": {tenant: []}}
    with contextlib.ExitStack() as stack:
        stack.enter_context(scoped_env(env))
        _reset_shared_state()
        control.configure(**CF_CONTROL)
        source = _ScenarioSource(tenant)
        procs = {tenant: DataProcessor(trace_source=source, device=device, use_device_stats=False, tenant=tenant)}
        router = TickRouter(lambda t: _make_runtime(t, procs[t]))
        server = DataProcessorServer(procs[tenant], host="127.0.0.1", port=0, router=router)
        server.start()
        try:
            # the warmup and window-shape rehearsal of the scenario loop
            version_of = _deploy_version_fn(plan, -1)
            warm = [trace_group(topo, f"{spec.name}-cfwarm", 0, p_i) for p_i in range(len(topo.paths))]
            source.push(warm)
            state["expected"][tenant].append(("collect", warm))
            status, body, _ms = _post_tick(server.port, tenant, f"{spec.name}-cfwarm")
            if status != 200 or body.get("stale"):
                run["errors"].append("counterfactual warmup failed")

            def tick_window(t: int, name: str) -> List[List[dict]]:
                view = _tick_view(plan, t)
                return tick_groups(
                    topo,
                    name,
                    t,
                    plan.traffic[t],
                    drop_services=frozenset(view["drop"]),
                    error_services=frozenset(view["error"]),
                    version_of=version_of,
                    latency_boost_us=view["latency_us"],
                )

            rehearsed = set()
            for t in range(spec.n_ticks):
                groups = tick_window(t, f"{spec.name}-cfwr{t}")
                shape_key = tuple(sorted(len(g) for g in groups))
                if not groups or shape_key in rehearsed:
                    continue
                rehearsed.add(shape_key)
                source.push(groups)
                state["expected"][tenant].append(("collect", groups))
                status, body, _ms = _post_tick(server.port, tenant, f"{spec.name}-cfwr{t}")
                if status != 200 or body.get("stale"):
                    run["errors"].append(f"counterfactual rehearsal {t} failed")

            if control_on and breach:
                # the ON arm's deferred windows all drain in ONE collect at
                # the first clear tick; the JAX runner rehearses that
                # combined window too, and it is part of the ingest log
                drain_tick = max(breach) + 1
                combined: List[List[dict]] = []
                for t in [*sorted(breach), drain_tick]:
                    if t < spec.n_ticks:
                        combined.extend(tick_window(t, f"{spec.name}-cfdrain{t}"))
                if combined:
                    source.push(combined)
                    state["expected"][tenant].append(("collect", combined))
                    status, body, _ms = _post_tick(server.port, tenant, f"{spec.name}-cfdrain")
                    if status != 200 or body.get("stale"):
                        run["errors"].append("counterfactual drain rehearsal failed")

            for t in range(spec.n_ticks):
                if control_on:
                    # the oracle forecast, through the fold hook's entry
                    p99 = forecast_p99_ms if t in breach else CF_CLEAR_P99_MS
                    control.ingest_forecast(
                        control.ForecastView(
                            tenant=tenant,
                            p99_ms=p99,
                            cost_ms=p99 * plan.traffic[t],
                            attributions=tuple(attributions) if t in breach else (),
                        )
                    )
                groups = tick_window(t, spec.name)
                source.push(groups)
                state["expected"][tenant].append(("collect", groups))
                status, body, _ms = _post_tick(server.port, tenant, f"{spec.name}-cf{t}")
                run["posts"] += 1
                if status == 429:
                    run["shed"] += 1
                elif status != 200:
                    run["errors"].append(f"cf tick {t}: {status}")
                elif body.get("deferred"):
                    run["deferred"] += 1
                elif body.get("stale"):
                    run["stale"] += 1
                    run["errors"].append(f"cf tick {t}: unexpected stale")
                elif _window_p99_ms(groups) > CF_SLO_MS:
                    # a fresh serve whose own window breaches the SLO: the
                    # violation the controller exists to defer
                    run["violations"] += 1

            run["signature"] = graph_signature(procs[tenant].graph)
            lost, missing = _lost_spans(spec, state, procs)
            run["lost_spans"] = lost
            run["missing_traces"] = missing[:8]
            brk = breaker_mod.breakers_for(tenant).get("scenario-upstream")
            brk_snap = brk.snapshot() if brk is not None else {}
            run["breaker_warm_ups"] = int(brk_snap.get("warmUps", 0))
            run["breaker_warmed_at_end"] = bool(brk_snap.get("warmed", False))
            run["control_snapshot"] = control.snapshot()
        finally:
            server.stop()
        run["ref_signature"] = _reference_signatures(spec, state, device)[tenant]
    return run


def run_counterfactual(
    seed: int = 0, index: int = 1, n_ticks: int = 10, verbose: bool = False, device: DeviceLike = None
) -> dict:
    """The control plane's validation gate: one seeded cascade storyline
    run twice, control OFF then ON, with an oracle forecast from the
    composed cascade event. Identical spec and windows; the only
    difference is whether anyone acts on the forecast. The card gates
    ``slo_violations_prevented >= 1`` with zero lost spans and bit-exact
    reference signatures in both arms."""
    from kmamiz_tpu_torch import control, native
    from kmamiz_tpu_torch.device import resolve_device
    from kmamiz_tpu_torch.scenarios.factory import spec_signature
    from kmamiz_tpu_torch.scenarios.storyline import cascade_forecast

    dev = resolve_device(device)
    if not native.available():
        raise RuntimeError("counterfactual runner requires the native library")
    t_start = time.time()
    spec = build_scenario("cascade-fanout", seed, index, n_ticks)
    plan = spec.tenants[0]
    cascade = next((ev for ev in plan.events if ev.kind == "cascade"), None)
    if cascade is None:
        raise RuntimeError("cascade storyline disabled (storyline.STORYLINES)")
    forecast_p99_ms, attributions = cascade_forecast(cascade, plan.topology)

    arms = {}
    for label, control_on in (("off", False), ("on", True)):
        with tempfile.TemporaryDirectory(prefix="kmamiz-cf-") as tmp:
            arms[label] = _counterfactual_run(spec, control_on, forecast_p99_ms, attributions, tmp, dev)
    off, on = arms["off"], arms["on"]

    prevented = off["violations"] - on["violations"]
    control.PREVENTED_VIOLATIONS.set(float(max(0, prevented)))
    gates = {
        "off_violations_present": off["violations"] >= 1,
        "violations_prevented": prevented >= 1,
        "zero_lost_spans": off["lost_spans"] == 0 and on["lost_spans"] == 0,
        "bit_exact": off["signature"] == off["ref_signature"] and on["signature"] == on["ref_signature"],
        "breaker_warmed_and_reverted": on["breaker_warm_ups"] >= 1 and not on["breaker_warmed_at_end"],
        "no_errors": not off["errors"] and not on["errors"],
    }
    card = {
        "name": f"counterfactual-{spec.name}",
        "archetype": spec.archetype,
        "spec_signature": spec_signature(spec),
        "n_ticks": spec.n_ticks,
        "slo_ms": CF_SLO_MS,
        "forecast_p99_ms": round(forecast_p99_ms, 3),
        "cascade_ticks": _breach_ticks(plan),
        "off": off,
        "on": on,
        "slo_violations_prevented": prevented,
        "gates": gates,
        "pass": all(gates.values()),
        "wall_s": round(time.time() - t_start, 1),
    }
    if verbose:
        print(f"{card['name']}: pass={card['pass']} prevented={prevented} gates={gates}", file=sys.stderr)
    return card


def crashed_card(
    spec: Optional[ScenarioSpec],
    exc: BaseException,
    archetype: Optional[str] = None,
    wall_s: float = 0.0,
) -> dict:
    """A failed scorecard for a scenario that threw instead of scoring:
    gate ``crashed`` False, the exception's text kept, every headline key
    of a card present. ``spec`` may be None when composing crashed (pass
    ``archetype`` so the failure can be bucketed)."""
    import traceback

    from kmamiz_tpu_torch.scenarios.factory import spec_signature
    from kmamiz_tpu_torch.telemetry.profiling import recorder

    name = spec.name if spec is not None else f"{archetype or 'unknown'}-?"
    arch = spec.archetype if spec is not None else (archetype or "unknown")
    base_seed = (spec.seed - spec.index) // SEED_STRIDE if spec is not None else 0
    card = {
        "name": name,
        "archetype": arch,
        "spec_signature": spec_signature(spec) if spec is not None else None,
        "n_ticks": spec.n_ticks if spec is not None else 0,
        "tenants": [p.tenant for p in spec.tenants] if spec is not None else [],
        "posts": 0,
        "stale_serves": 0,
        "stale_rate": 0.0,
        "p50_tick_ms": 0.0,
        "p95_tick_ms": 0.0,
        "p99_tick_ms": 0.0,
        "lost_spans": 0,
        "missing_traces": [],
        "quarantined": 0,
        "expected_poisons": 0,
        "recovery_ms": 0.0,
        "recoveries": {},
        "capacity": {},
        "signatures": {},
        "ref_signatures": {},
        "freshness": {},
        "wal": None,
        "errors": [f"{type(exc).__name__}: {exc}"],
        "crash": traceback.format_exception_only(type(exc), exc)[-1].strip(),
        "traceback": traceback.format_exc()[-2000:],
        "gates": {"crashed": False},
        "pass": False,
        "wall_s": round(wall_s, 1),
    }
    card["flight_artifact"] = recorder.record(
        f"scenario-{name}", f"crashed: {card['crash']}", force=True, namespace=f"{arch}-{base_seed}"
    )
    return card


def run_matrix(specs, verbose: bool = False, device: DeviceLike = None) -> List[dict]:
    """Run every scenario, each in its own temporary directory. A scenario
    that throws becomes a ``crashed``-gate failed card: one bad cell never
    stops the rest of the matrix."""
    results = []
    for spec in specs:
        t0 = time.time()
        with tempfile.TemporaryDirectory(prefix="kmamiz-scn-") as tmp:
            try:
                card = run_scenario(spec, tmpdir=tmp, verbose=verbose, device=device)
            except Exception as exc:  # noqa: BLE001 - contained into the scorecard
                card = crashed_card(spec, exc, wall_s=time.time() - t0)
                with _RUNS_LOCK:
                    _RUNS.append(card)
                if verbose:
                    print(f"{spec.name}: CRASHED {card['crash']}", file=sys.stderr)
        results.append(card)
    return results


def main(argv: Optional[List[str]] = None) -> int:
    """The kill-9 crash child's entry point::

    python -m kmamiz_tpu_torch.scenarios.runner --child-kill \\
        --archetype kill9-wal-replay --seed 0 --index 3 --ticks 10 [--device cpu]
    """
    import argparse

    parser = argparse.ArgumentParser(description="scenario runner internals")
    parser.add_argument("--child-kill", action="store_true")
    parser.add_argument("--archetype", default="kill9-wal-replay")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--index", type=int, default=0)
    parser.add_argument("--ticks", type=int, default=10)
    parser.add_argument("--device", default=None, help="torch device (default: the card)")
    args = parser.parse_args(argv)
    if args.child_kill:
        run_child_kill(args.archetype, args.seed, args.index, args.ticks, device=args.device)
        return 1  # unreachable
    parser.error("nothing to do (this entry point only serves --child-kill)")
    return 2


if __name__ == "__main__":
    sys.exit(main())

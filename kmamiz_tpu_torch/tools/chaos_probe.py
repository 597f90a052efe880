"""Chaos probe: prove the four resilience-pillar invariants under a seed,
over the port.

Counterpart of the repo's tools/chaos_probe.py (docs/RESILIENCE.md), with
``--device`` (the card when not given; without one the tool raises before
any pillar). Everything the fault layer promises
(kmamiz_tpu_torch/resilience/) is asserted against the REAL pipeline —
native parse, the graph merge on the device, the DP HTTP server — with
faults drawn from a seeded FaultPlan so a failure reproduces exactly:

  1. quarantine bit-exactness — a chunk stream poisoned per the plan
     (truncated JSON, invalid UTF-8, schema drift, trace bombs, drops)
     ingests to a graph bit-identical (graph_signature) to ingesting
     only the untouched chunks; every poisoned delivery lands in the
     quarantine with a reason code;
  2. breaker state machine — `threshold` consecutive failures OPEN the
     breaker (short-circuits without touching the upstream), cooldown
     admits a HALF-OPEN probe, a failed probe re-opens, a good one
     closes;
  3. degraded serve — with KMAMIZ_TICK_DEADLINE_MS set and the trace
     source hung, POST / on the DP server answers 200 with the
     last-good graph, `stale: true`, the X-KMamiz-Stale-Age-Ms header,
     and no 5xx; the abandoned straggler lands and the next tick serves
     fresh;
  4. crash-safe recovery — a child process ingests with KMAMIZ_WAL=1
     and SIGKILLs itself between the WAL append and the graph merge of
     its final window; a fresh processor's replay_wal() restores a
     graph bit-identical to ingesting every window.

Where the port differs from the JAX tool:

- the trace-bomb cap is each processor's `max_payload_bytes`
  (SIZE_CAP_BYTES), not a process-wide KMAMIZ_INGEST_MAX_BYTES;
- each pillar sets KMAMIZ_QUARANTINE_DIR, KMAMIZ_TICK_DEADLINE_MS,
  KMAMIZ_WAL and KMAMIZ_WAL_DIR for its own span only, and pillar 1
  binds a fresh default quarantine under its directory for the span
  (so its count starts at zero in a process that quarantined before);
- pillar 3 reports no `stale_new_compiles`: the port has no program
  registry to count compiles in;
- pillar 3's three ticks each carry fresh trace ids (the JAX tool
  repeats one window, which the dedup empties after the warm tick), so
  every tick that completes, the straggler included, merges its window
  and runs the window statistics (on the card, two segment-stats
  launches a tick).

stdout carries ONE JSON line: {"seed": ..., "ok": ..., per-pillar
results, "chaos_recovery_ms": ..., "degraded_serve_ms": ...}. The
human-readable pillar table goes to stderr. Exit 0 iff every pillar
holds. `--child-kill` is the internal crash-child mode (never returns).

Usage: python -m kmamiz_tpu_torch.tools.chaos_probe [--seed N]
       [--matrix N] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
import urllib.request
from typing import List, Optional

from kmamiz_tpu_torch.device import DeviceLike, resolve_device
from kmamiz_tpu_torch.scenarios.runner import scoped_env

# clean chunks must fit under this while the plan's "bomb" payloads
# (~4.1 KB, chaos.mutate_payload) overflow it
SIZE_CAP_BYTES = 4000
#: the deadline the overrunning tick is served under, and how long its
#: trace source hangs (well past it)
STALE_DEADLINE_MS = 250
HANG_S = 2.0
#: the crash child's wall limit
CHILD_TIMEOUT_S = 600

PILLARS = ("quarantine", "breaker", "degraded_serve", "wal_recovery")


def _mk_span(tid: str, sid: str, parent=None, svc="svc", url=None) -> dict:
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


def _clean_groups(n_traces: int, prefix: str):
    """n_traces two-span traces fanning out to 5 downstream services —
    enough edge diversity that a silently lost or duplicated trace
    moves the graph signature."""
    groups = []
    for t in range(n_traces):
        tid = f"{prefix}{t}"
        parent = _mk_span(tid, f"{tid}p")
        child = _mk_span(
            tid,
            f"{tid}c",
            parent=f"{tid}p",
            svc=f"down{t % 5}",
            url=f"http://down{t % 5}.ns/api/{t % 3}",
        )
        groups.append([parent, child])
    return groups


def _clean_chunks(n_traces=40, per_chunk=2, prefix="t"):
    groups = _clean_groups(n_traces, prefix)
    chunks = [
        json.dumps(groups[i : i + per_chunk]).encode()
        for i in range(0, len(groups), per_chunk)
    ]
    oversized = [len(c) for c in chunks if len(c) >= SIZE_CAP_BYTES]
    if oversized:
        raise RuntimeError(
            f"clean chunks must stay under the probe size cap: {oversized}"
        )
    return chunks


def _fresh_processor(device):
    """An ingest processor as the JAX tool's: no trace source, device
    statistics off (raw ingest runs none), the probe's size cap, the WAL
    as the environment says."""
    from kmamiz_tpu_torch.server.processor import DataProcessor

    return DataProcessor(
        trace_source=lambda *a: [],
        use_device_stats=False,
        device=device,
        max_payload_bytes=SIZE_CAP_BYTES,
    )


# -- pillar 1: poison-input quarantine ---------------------------------------


def pillar_quarantine(seed: int, tmpdir: str, device: DeviceLike = None) -> dict:
    from kmamiz_tpu_torch.resilience import quarantine as res_quarantine
    from kmamiz_tpu_torch.resilience.chaos import (
        FaultPlan,
        chaos_chunks,
        graph_signature,
    )

    qdir = os.path.join(tmpdir, "quarantine")
    with scoped_env({"KMAMIZ_QUARANTINE_DIR": qdir}), res_quarantine.scoped_default(qdir):
        chunks = _clean_chunks()
        delivered, clean_indices = chaos_chunks(chunks, FaultPlan(seed))

        chaos_dp = _fresh_processor(device)
        quarantined = 0
        for raw in delivered:
            quarantined += chaos_dp.ingest_raw_window(raw).get("quarantined", 0)
        chaos_sig = graph_signature(chaos_dp.graph)

        clean_dp = _fresh_processor(device)
        for i in clean_indices:
            clean_dp.ingest_raw_window(chunks[i])
        clean_sig = graph_signature(clean_dp.graph)

        stats = res_quarantine.quarantine_stats()
    poisoned = len(delivered) - len(clean_indices)
    return {
        "ok": (
            chaos_sig == clean_sig
            and poisoned > 0
            and quarantined == poisoned
            and stats["count"] == poisoned
        ),
        "chunks": len(chunks),
        "delivered": len(delivered),
        "clean": len(clean_indices),
        "quarantined": quarantined,
        "byReason": stats["byReason"],
        "signature": chaos_sig,
        "bitExact": chaos_sig == clean_sig,
    }


# -- pillar 2: circuit breaker state machine ---------------------------------


def pillar_breaker() -> dict:
    from kmamiz_tpu_torch.resilience.breaker import (
        HALF_OPEN,
        OPEN,
        BreakerOpenError,
        CircuitBreaker,
    )

    clock = {"t": 0.0}
    breaker = CircuitBreaker(
        "chaos-probe", threshold=3, cooldown_s=5.0, now=lambda: clock["t"]
    )

    def failing():
        raise ConnectionError("chaos: injected upstream failure")

    for _ in range(breaker.threshold):
        try:
            breaker.call(failing)
        except ConnectionError:
            pass
    opened = breaker.state == OPEN

    # open: short-circuits without touching the upstream
    upstream_calls = {"n": 0}

    def probe():
        upstream_calls["n"] += 1
        return "ok"

    short_circuited = False
    try:
        breaker.call(probe)
    except BreakerOpenError:
        short_circuited = upstream_calls["n"] == 0

    clock["t"] += breaker.cooldown_s
    half_opened = breaker.state == HALF_OPEN

    # a failed half-open probe re-opens and restarts the cooldown
    try:
        breaker.call(failing)
    except ConnectionError:
        pass
    reopened = breaker.state == OPEN

    clock["t"] += breaker.cooldown_s
    breaker.call(probe)
    closed = breaker.state == "closed" and upstream_calls["n"] == 1

    return {
        "ok": all([opened, short_circuited, half_opened, reopened, closed]),
        "opened_after_threshold": opened,
        "short_circuited": short_circuited,
        "half_opened_after_cooldown": half_opened,
        "reopened_on_probe_failure": reopened,
        "closed_on_probe_success": closed,
        "snapshot": breaker.snapshot(),
    }


# -- pillar 3: tick watchdog + stale-graph degradation -----------------------


def _post(port: int, unique_id: str, timeout_s: float = 30.0):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/",
        data=json.dumps(
            {"uniqueId": unique_id, "lookBack": 30_000, "time": 1_000_000}
        ).encode(),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout_s) as resp:
        body = json.loads(resp.read())
        elapsed_ms = (time.perf_counter() - t0) * 1000
        return resp.status, resp.headers, body, elapsed_ms


def pillar_degraded_serve(device: DeviceLike = None) -> dict:
    from kmamiz_tpu_torch.server.dp_server import DataProcessorServer
    from kmamiz_tpu_torch.server.processor import DataProcessor

    window = {"groups": _clean_groups(10, prefix="dg")}
    hang = {"s": 0.0}

    def source(_lb, _t, _lim):
        if hang["s"]:
            time.sleep(hang["s"])
        return window["groups"]

    with scoped_env({"KMAMIZ_TICK_DEADLINE_MS": "0"}):
        processor = DataProcessor(trace_source=source, device=device)
        server = DataProcessorServer(processor, host="127.0.0.1", port=0)
        server.start()
        try:
            # warm tick with the watchdog off: the pillar is about what
            # happens AFTER a good tick exists
            status, _, body, _ = _post(server.port, "chaos-warm")
            warm_ok = status == 200 and not body.get("stale")

            # overrunning tick: the source hangs well past the deadline
            os.environ["KMAMIZ_TICK_DEADLINE_MS"] = str(STALE_DEADLINE_MS)
            window["groups"] = _clean_groups(10, prefix="dgs")
            hang["s"] = HANG_S
            status, headers, body, degraded_ms = _post(server.port, "chaos-stale")
            stale_ok = (
                status == 200
                and body.get("stale") is True
                and body.get("uniqueId") == "chaos-stale"
                and body.get("staleReason") == "deadline"
                and headers.get("X-KMamiz-Stale-Age-Ms") is not None
            )

            # let the abandoned straggler drain, then prove recovery: with
            # the deadline lifted the next tick serves fresh again
            time.sleep(hang["s"] + 0.5)
            hang["s"] = 0.0
            os.environ["KMAMIZ_TICK_DEADLINE_MS"] = "0"
            window["groups"] = _clean_groups(10, prefix="dgr")
            status, _, body, _ = _post(server.port, "chaos-recovered")
            recovered_ok = status == 200 and not body.get("stale")
        finally:
            server.stop()

    return {
        "ok": warm_ok and stale_ok and recovered_ok,
        "warm_tick": warm_ok,
        "stale_served": stale_ok,
        "recovered_after_straggler": recovered_ok,
        "degraded_serve_ms": round(degraded_ms, 1),
    }


# -- pillar 4: kill -9 mid-ingest -> WAL replay ------------------------------


def run_child_kill(device: DeviceLike = None) -> None:
    """Crash child (the parent sets KMAMIZ_WAL=1 + the WAL dir): ingest
    all windows but the last, WAL the last one, then die before its merge
    — the exact crash point ingest_raw_window's append-before-merge
    ordering exists for. Never returns."""
    chunks = _clean_chunks(prefix="w")
    dp = _fresh_processor(device)
    for raw in chunks[:-1]:
        dp.ingest_raw_window(raw)
    dp._wal_append(chunks[-1])
    os.kill(os.getpid(), signal.SIGKILL)


def start_crash_child(seed: int, tmpdir: str, device: DeviceLike = None) -> subprocess.Popen:
    """Start pillar 4's crash child (`--child-kill` on `device`, its WAL
    under `tmpdir`, its output in `tmpdir`/child.log); the pillar waits
    for it. Started ahead of the other pillars, its boot runs beside
    them."""
    dev = resolve_device(device)
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    child_env = {
        **os.environ,
        "KMAMIZ_WAL": "1",
        "KMAMIZ_WAL_DIR": os.path.join(tmpdir, "wal"),
    }
    with open(os.path.join(tmpdir, "child.log"), "wb") as log:
        return subprocess.Popen(
            [
                sys.executable,
                "-m",
                "kmamiz_tpu_torch.tools.chaos_probe",
                "--child-kill",
                "--seed",
                str(seed),
                "--device",
                str(dev),
            ],
            env=child_env,
            cwd=repo_root,
            stdout=log,
            stderr=subprocess.STDOUT,
        )


def pillar_wal_recovery(seed: int, tmpdir: str, device: DeviceLike, child: subprocess.Popen) -> dict:
    """Pillar 4 over `child`, start_crash_child(seed, tmpdir, device)'s."""
    from kmamiz_tpu_torch.resilience.chaos import graph_signature

    dev = resolve_device(device)
    wal_dir = os.path.join(tmpdir, "wal")
    try:
        child.wait(timeout=CHILD_TIMEOUT_S)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    killed = child.returncode == -signal.SIGKILL

    chunks = _clean_chunks(prefix="w")

    # reference: every window ingested in-process, WAL off so the
    # recovery dir only holds what the child wrote before dying
    with scoped_env({"KMAMIZ_WAL": "0"}):
        reference = _fresh_processor(dev)
        for raw in chunks:
            reference.ingest_raw_window(raw)
        reference_sig = graph_signature(reference.graph)

    with scoped_env({"KMAMIZ_WAL": "1", "KMAMIZ_WAL_DIR": wal_dir}):
        t0 = time.perf_counter()
        recovered = _fresh_processor(dev)
        replay = recovered.replay_wal()
        recovery_ms = (time.perf_counter() - t0) * 1000
    recovered_sig = graph_signature(recovered.graph)

    return {
        "ok": (
            killed
            and replay["replayed"] == len(chunks)
            and recovered_sig == reference_sig
        ),
        "child_sigkilled": killed,
        "wal_records_replayed": replay["replayed"],
        "windows": len(chunks),
        "bitExact": recovered_sig == reference_sig,
        "signature": recovered_sig,
        "chaos_recovery_ms": round(recovery_ms, 1),
    }


# -- the probe ---------------------------------------------------------------


def probe(seed: int = 0, matrix: Optional[int] = None, device: DeviceLike = None) -> dict:
    """Every pillar on `device` (the card when None, raising without one
    before any pillar runs); the tool's result dict. With `matrix`, the
    seeded pillars (quarantine, WAL recovery) run across that many
    consecutive seeds from `seed` and the seedless ones once."""
    dev = resolve_device(device)
    results: dict = {"seed": seed}
    with tempfile.TemporaryDirectory(prefix="kmamiz-chaos-") as tmpdir:
        if matrix is None:
            # the crash child boots beside pillars 1-3
            child = start_crash_child(seed, tmpdir, dev)
            try:
                results["quarantine"] = pillar_quarantine(seed, tmpdir, dev)
                results["breaker"] = pillar_breaker()
                results["degraded_serve"] = pillar_degraded_serve(dev)
            finally:
                results["wal_recovery"] = pillar_wal_recovery(seed, tmpdir, dev, child)
        else:
            # per-seed tmp subdirs keep quarantine/WAL artifacts apart;
            # each pillar_quarantine binds its own fresh quarantine
            seeds: List[int] = list(range(seed, seed + max(1, matrix)))
            per_seed = []
            for s in seeds:
                seed_dir = os.path.join(tmpdir, f"seed{s}")
                os.makedirs(seed_dir, exist_ok=True)
                child = start_crash_child(s, seed_dir, dev)
                try:
                    quarantined = pillar_quarantine(s, seed_dir, dev)
                finally:
                    recovered = pillar_wal_recovery(s, seed_dir, dev, child)
                per_seed.append({"seed": s, "quarantine": quarantined, "wal_recovery": recovered})
            results["matrix"] = per_seed
            results["matrix_seeds"] = seeds
            # aggregate view: worst case across seeds for the seeded
            # pillars, the seedless pillars once
            results["quarantine"] = {
                "ok": all(r["quarantine"]["ok"] for r in per_seed),
                "seeds_passed": sum(1 for r in per_seed if r["quarantine"]["ok"]),
                "quarantined": sum(r["quarantine"]["quarantined"] for r in per_seed),
            }
            results["breaker"] = pillar_breaker()
            results["degraded_serve"] = pillar_degraded_serve(dev)
            results["wal_recovery"] = {
                "ok": all(r["wal_recovery"]["ok"] for r in per_seed),
                "seeds_passed": sum(1 for r in per_seed if r["wal_recovery"]["ok"]),
                "chaos_recovery_ms": max(r["wal_recovery"]["chaos_recovery_ms"] for r in per_seed),
            }

    results["ok"] = all(results[p]["ok"] for p in PILLARS)
    # the two headline walls, hoisted to the top level
    results["chaos_recovery_ms"] = results["wal_recovery"]["chaos_recovery_ms"]
    results["degraded_serve_ms"] = results["degraded_serve"]["degraded_serve_ms"]
    return results


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--matrix",
        type=int,
        default=None,
        metavar="N",
        help="run the seed-dependent pillars (quarantine, WAL recovery) "
        "across N consecutive seeds starting at --seed; the seedless "
        "breaker and degraded-serve pillars run once",
    )
    parser.add_argument("--device", default=None, help="torch device (default: the card)")
    parser.add_argument(
        "--child-kill",
        action="store_true",
        help="internal: crash-child mode for the WAL pillar (never returns)",
    )
    args = parser.parse_args(argv)

    if args.child_kill:
        run_child_kill(resolve_device(args.device))
        return 1  # unreachable

    results = probe(args.seed, args.matrix, args.device)

    width = max(len(p) for p in PILLARS)
    for p in PILLARS:
        state = "PASS" if results[p]["ok"] else "FAIL"
        detail = {
            k: v
            for k, v in results[p].items()
            if k not in ("ok", "signature", "snapshot", "byReason")
        }
        print(f"{p:<{width}}  {state}  {detail}", file=sys.stderr)

    print(json.dumps(results))
    return 0 if results["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

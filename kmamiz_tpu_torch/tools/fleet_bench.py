"""Fleet scale-out bench: 1-worker vs 4-worker ingest + live migration,
over the port.

Counterpart of the repo's tools/fleet_bench.py, with ``--device`` (the
card when not given; without one the tool raises before it spawns
anything). Boots real subprocess workers (``python -m
kmamiz_tpu_torch.fleet.worker --device D``, each a full
DataProcessorServer with its own WAL directory), measures single-worker
ingest throughput, then aggregate throughput with four workers driven
concurrently through ``HTTPTransport``, and finally runs one live tenant
migration (drain -> WAL handoff -> replay -> ring flip) with a frame
injected mid-handoff. Prints ONE json line:

    {"fleet_spans_per_sec_1": ..., "fleet_spans_per_sec_4": ...,
     "fleet_scale_efficiency": ..., "fleet_migration_lost_spans": ...,
     "fleet_migration_pass": ..., "fleet_host_cores": ...}

``fleet_scale_efficiency`` is per-worker: rate4 / (4 * rate1). Four
workers on one card share it (and the host's cores): the efficiency is
a record of that sharing, not a scaling claim. Once the device is
resolved, any error becomes ``fleet_bench_error`` in the line and the
exit code stays 0, as the JAX tool's scorecard does.

`scorecard(transport, ring, n_frames)` is the tool's line over workers
that are already up (the caller's transport and ring); `main` boots four
and calls it.

Usage: python -m kmamiz_tpu_torch.tools.fleet_bench [--frames N]
       [--spawn-s S] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import sys
import tempfile
import threading
import time
from typing import List, Optional

from kmamiz_tpu_torch.device import resolve_device
from kmamiz_tpu_torch.fleet import migration as migration_mod
from kmamiz_tpu_torch.fleet.coordinator import FleetCoordinator, HTTPTransport
from kmamiz_tpu_torch.fleet.ring import HashRing
from kmamiz_tpu_torch.scenarios.topology import sample_topology, trace_group

#: spans per frame come out of the sampled fanout topology; frames per
#: measured stretch
DEFAULT_FRAMES = 24
WORKERS = ("w0", "w1", "w2", "w3")


class _Worker:
    """One spawned worker subprocess + its discovered port."""

    def __init__(self, worker_id: str, wal_root: str, device: str) -> None:
        self.worker_id = worker_id
        self.port: Optional[int] = None
        env = dict(os.environ)
        env["KMAMIZ_WAL"] = "1"
        env["KMAMIZ_WAL_DIR"] = os.path.join(wal_root, "workers", worker_id)
        # workers are ingest-only here; keep their pollers/schedulers quiet
        env.setdefault("KMAMIZ_PROF", "0")
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        self.proc = subprocess.Popen(
            [
                sys.executable,
                "-m",
                "kmamiz_tpu_torch.fleet.worker",
                "--worker-id",
                worker_id,
                "--port",
                "0",
                "--device",
                device,
            ],
            stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL,
            text=True,
            env=env,
            cwd=repo_root,
        )

    def await_ready(self, spawn_s: float) -> int:
        deadline = time.monotonic() + spawn_s
        while time.monotonic() < deadline:
            line = self.proc.stdout.readline()
            if not line:
                break
            if line.startswith("FLEET_WORKER_READY"):
                self.port = int(line.split()[2])
                return self.port
        raise RuntimeError(f"worker {self.worker_id} never became ready")

    @property
    def endpoint(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def stop(self) -> None:
        self.proc.kill()
        self.proc.wait(timeout=30)


def _frames(tenant: str, n: int):
    """n raw ingest windows for one tenant (distinct trace ids)."""
    topo = sample_topology("fanout", random.Random(7), f"fb-{tenant}")
    out = []
    for i in range(n):
        groups = [trace_group(topo, f"fb-{tenant}", i, p) for p in range(3)]
        out.append(json.dumps(groups).encode())
    return out


def _drive(transport, worker_id: str, tenant: str, frames):
    """Ingest every frame; returns spans accepted."""
    spans = 0
    for raw in frames:
        summary = transport.ingest(worker_id, tenant, raw)
        spans += int(summary.get("spans", 0))
    return spans


def _measure_rate(transport, placements, n_frames):
    """placements: [(worker_id, tenant)]; one sending thread per tenant.
    Returns aggregate spans/sec over the slowest sender's wall."""
    frames = {t: _frames(t, n_frames) for _w, t in placements}
    # warm each tenant's shapes once so the measured stretch is steady
    for worker_id, tenant in placements:
        _drive(transport, worker_id, tenant, frames[tenant][:1])
    results = {}

    def run(worker_id: str, tenant: str) -> None:
        results[tenant] = _drive(transport, worker_id, tenant, frames[tenant][1:])

    threads = [threading.Thread(target=run, args=(w, t)) for w, t in placements]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall = time.perf_counter() - t0
    return sum(results.values()) / max(wall, 1e-9)


class _MidHandoffTransport:
    """Fires a callback between drain and WAL export (same injection the
    scenario soak uses) so the measured migration includes a frame that
    races the handoff."""

    def __init__(self, inner, on_export) -> None:
        self._inner = inner
        self._on_export = on_export

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def wal_export(self, worker_id: str, tenant: str) -> bytes:
        self._on_export()
        return self._inner.wal_export(worker_id, tenant)


def _tenant_for_each_worker(ring: HashRing):
    """A deterministic tenant name owned by every worker (search a
    numbered namespace until each worker has one)."""
    owned = {}
    i = 0
    while len(owned) < len(ring.workers) and i < 10_000:
        tenant = f"fb{i}"
        owned.setdefault(ring.owner(tenant), tenant)
        i += 1
    return [(w, owned[w]) for w in ring.workers]


def _measure(transport, ring: HashRing, n_frames: int, result: dict) -> None:
    """The bench over workers that are up: `transport` reaches every
    worker of `ring` (their WALs on). Fills `result` with the rates, the
    efficiency and the migration's outcome as each is measured; an error
    propagates, leaving the keys measured so far."""
    placements = _tenant_for_each_worker(ring)

    # single-worker baseline: one tenant, its ring owner
    rate1 = _measure_rate(transport, placements[:1], n_frames)
    result["fleet_spans_per_sec_1"] = round(rate1, 0)

    # 4-worker aggregate: one tenant per worker, driven concurrently
    # (parallelism comes from the worker PROCESSES; the GIL only holds
    # these senders' urllib waits)
    rate4 = _measure_rate(transport, placements, n_frames)
    result["fleet_spans_per_sec_4"] = round(rate4, 0)
    result["fleet_scale_efficiency"] = round(rate4 / max(4.0 * rate1, 1e-9), 3)

    # live migration with a mid-handoff frame: the tenant that just
    # soaked on the first worker moves to another
    coordinator = FleetCoordinator(ring, transport)
    src_worker, tenant = placements[0]
    target = next(w for w in ring.workers if w != src_worker)
    # pre-migration durable count on the source: the handoff must land
    # exactly this many records on the target (frames lost anywhere in
    # drain -> export -> import show up here; each lost frame is >= 1
    # lost span)
    expected_records = transport.drain(src_worker, tenant)["walRecords"]
    mid = _frames(tenant, 1)
    state = {"queued": 0}

    def inject() -> None:
        if coordinator.route_ingest(tenant, mid[0]) is None:
            state["queued"] += 1

    coordinator.swap_transport(_MidHandoffTransport(transport, inject))
    try:
        mig = migration_mod.migrate_tenant(coordinator, tenant, target)
    finally:
        coordinator.swap_transport(transport)
    lost_records = max(0, expected_records - mig["records"])
    lost_queued = max(0, state["queued"] - mig["queuedReleased"])
    result["fleet_migration_lost_spans"] = lost_records + lost_queued
    result["fleet_migration_pass"] = bool(
        mig["ok"] and result["fleet_migration_lost_spans"] == 0 and state["queued"] == 1
    )


def _blank_result() -> dict:
    return {
        "fleet_spans_per_sec_1": None,
        "fleet_spans_per_sec_4": None,
        "fleet_scale_efficiency": None,
        "fleet_migration_lost_spans": None,
        "fleet_migration_pass": None,
        "fleet_host_cores": os.cpu_count(),
    }


def _error_text(err: Exception) -> str:
    return f"{type(err).__name__}: {err}"[:300]


def scorecard(transport, ring: HashRing, n_frames: int = DEFAULT_FRAMES) -> dict:
    """The tool's JSON line over workers that are up (`transport` reaches
    every worker of `ring`, their WALs on): the rates, the efficiency,
    the migration's outcome and the host's cores; an error becomes ``fleet_bench_error`` beside
    the keys measured before it."""
    result = _blank_result()
    try:
        _measure(transport, ring, n_frames, result)
    except Exception as err:  # noqa: BLE001 - scorecard, not crash
        result["fleet_bench_error"] = _error_text(err)
    return result


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=DEFAULT_FRAMES)
    ap.add_argument(
        "--spawn-s",
        type=float,
        default=180.0,
        help="per-worker readiness deadline (torch import + server bind)",
    )
    ap.add_argument("--device", default=None, help="the workers' torch device (default: the card)")
    args = ap.parse_args(argv)
    device = str(resolve_device(args.device))

    workers: List[_Worker] = []
    with tempfile.TemporaryDirectory(prefix="fleet-bench-") as wal_root:
        try:
            ring = HashRing(list(WORKERS))
            # the four boot at once; each is then awaited in turn
            for w in ring.workers:
                workers.append(_Worker(w, wal_root, device))
            for w in workers:
                w.await_ready(args.spawn_s)
            transport = HTTPTransport({w.worker_id: w.endpoint for w in workers})
        except Exception as err:  # noqa: BLE001 - scorecard, not crash
            result = _blank_result()
            result["fleet_bench_error"] = _error_text(err)
        else:
            result = scorecard(transport, ring, args.frames)
        finally:
            for w in workers:
                try:
                    w.stop()
                except Exception:  # noqa: BLE001 - teardown best-effort
                    pass
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

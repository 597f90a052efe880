"""WAL-replay scenario source: recorded windows as a scenario
(archetype 11, ``wal-replay``).

Counterpart of kmamiz_tpu/soak/walreplay.py. The fsynced WAL v2 holds
every raw ingest window as it arrived; this module replays a recorded
window back through a real ``DataProcessorServer`` (each durable record
over ``POST /ingest``) and holds the result to the gates of every other
archetype. The reference signature comes from the same records
(``IngestWAL.replay_records`` into a new processor), so the oracle is the
recording itself.

Bundles:

* ``KMAMIZ_SOAK_BUNDLE`` names a captured bundle directory
  (``python -m kmamiz_tpu_torch.soak.capture`` writes one from a WAL
  directory or a live server's ``/fleet/wal``): the production replay.
* Otherwise the cell makes a bundle from its own composed spec
  (`synthesize_bundle`: topology x traffic through a real WAL append,
  every third window a KMZC frame), byte-equal to the JAX package's WAL
  for the same spec.

A torn tail drops cleanly: the reference and the live replay both read
``replay_records``, which stops at a torn trailing frame, and the cell
scores the intact prefix. The JAX card's ``zero_steady_recompiles`` gate
counts XLA compiles and is not on this card (nothing is compiled per
shape).
"""
from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

from kmamiz_tpu_torch.resilience.wal import IngestWAL
from kmamiz_tpu_torch.telemetry.profiling import events as prof_events

BUNDLE_KIND = "kmamiz-soak-bundle"
BUNDLE_VERSION = 1


def bundle_env() -> Optional[str]:
    return os.environ.get("KMAMIZ_SOAK_BUNDLE") or None


def bundle_wal_dir(bundle_dir: str) -> str:
    return os.path.join(bundle_dir, "wal")


def write_bundle_meta(bundle_dir: str, **fields) -> dict:
    meta = {"kind": BUNDLE_KIND, "version": BUNDLE_VERSION, **fields}
    os.makedirs(bundle_dir, exist_ok=True)
    tmp = os.path.join(bundle_dir, "bundle.json.tmp")
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(meta, f, indent=1, sort_keys=True)
    os.replace(tmp, os.path.join(bundle_dir, "bundle.json"))
    return meta


def read_bundle_meta(bundle_dir: str) -> dict:
    with open(os.path.join(bundle_dir, "bundle.json"), encoding="utf-8") as f:
        meta = json.load(f)
    if meta.get("kind") != BUNDLE_KIND:
        raise ValueError(f"not a soak bundle: {bundle_dir}")
    return meta


def load_bundle_records(bundle_dir: str) -> List[Tuple[int, bytes]]:
    """Every durable record of the bundle's WAL, oldest first, a torn tail
    dropped. Read-only: a replay never appends."""
    wal = IngestWAL(bundle_wal_dir(bundle_dir))
    try:
        return list(wal.replay_records())
    finally:
        wal.close()


def synthesize_bundle(spec, bundle_dir: str) -> dict:
    """A deterministic stand-in recording from the spec's own topology x
    traffic: one window per tick through a real WAL append (v2 frames,
    fsync off: the content is what is under test), every third window a
    KMZC frame so that columnar records always replay."""
    from kmamiz_tpu_torch.core import wire
    from kmamiz_tpu_torch.scenarios.topology import trace_group

    plan = spec.tenants[0]
    wal = IngestWAL(bundle_wal_dir(bundle_dir), fsync=False)
    windows = 0
    try:
        for tick in range(spec.n_ticks):
            groups = [trace_group(plan.topology, f"{spec.name}-rep", tick, i) for i in range(max(1, plan.traffic[tick]))]
            wal.append(wire.encode_groups(groups) if tick % 3 == 2 else json.dumps(groups).encode())
            windows += 1
    finally:
        wal.close()
    return write_bundle_meta(
        bundle_dir,
        records=windows,
        tenant=plan.tenant,
        source=f"synthesized:{spec.name}",
        created_unix=int(prof_events.wall_ms() / 1000),
    )


def run_wal_replay_scenario(spec, tmpdir: str, verbose: bool = False, device=None) -> dict:
    """Drive one wal-replay cell end to end on `device`; returns its card
    (the gate names of the other archetypes)."""
    import urllib.error

    from kmamiz_tpu_torch.graph.store import graph_signature
    from kmamiz_tpu_torch.scenarios.factory import spec_signature
    from kmamiz_tpu_torch.scenarios.runner import _failed_gates_artifact, _post_ingest
    from kmamiz_tpu_torch.server.dp_server import DataProcessorServer, _make_runtime
    from kmamiz_tpu_torch.server.processor import DataProcessor
    from kmamiz_tpu_torch.telemetry.slo import percentile
    from kmamiz_tpu_torch.tenancy.router import TickRouter

    t_start = prof_events.now_ms()
    tenant = spec.tenants[0].tenant
    errors: List[str] = []

    bundle_dir = bundle_env()
    if bundle_dir is None:
        bundle_dir = os.path.join(tmpdir, "bundle")
        meta = synthesize_bundle(spec, bundle_dir)
    else:
        meta = read_bundle_meta(bundle_dir)
    records = load_bundle_records(bundle_dir)
    torn_dropped = max(0, int(meta.get("records", len(records))) - len(records))

    # the reference: the recording itself is the oracle; a new processor
    # ingests every durable record directly
    ref_dp = DataProcessor(trace_source=lambda *_a: [], device=device, use_device_stats=False, wal=None)
    ref_spans = 0
    for _kind, payload in records:
        ref_spans += int(ref_dp.ingest_raw_window(payload).get("spans", 0))
    ref_sig = graph_signature(ref_dp.graph)

    # the live pass: each record POSTed to a real server, the path
    # production ingest takes
    live_dp = DataProcessor(trace_source=lambda *_a: [], device=device, use_device_stats=False, tenant=tenant)
    router = TickRouter(lambda t: _make_runtime(t, live_dp))
    server = DataProcessorServer(live_dp, host="127.0.0.1", port=0, router=router)
    server.start()
    latencies: List[float] = []
    live_spans = 0
    quarantined = 0
    posts = 0
    try:
        for _kind, payload in records:
            t0 = prof_events.now_ms()
            try:
                resp = _post_ingest(server.port, tenant, payload)
            except (OSError, urllib.error.URLError) as exc:
                errors.append(f"ingest: {type(exc).__name__}: {exc}")
                continue
            latencies.append(prof_events.now_ms() - t0)
            posts += 1
            live_spans += int(resp.get("spans", 0))
            quarantined += int(resp.get("quarantined", 0))
        live_sig = graph_signature(live_dp.graph)
    finally:
        server.stop()

    lat = sorted(latencies)
    gates = {
        "no_errors": not errors,
        "bit_exact": live_sig == ref_sig,
        "replayed_all": posts == len(records),
        "zero_lost_spans": live_spans == ref_spans,
        "quarantine_exact": quarantined == 0,
    }
    card = {
        "name": spec.name,
        "archetype": spec.archetype,
        "spec_signature": spec_signature(spec),
        "n_ticks": spec.n_ticks,
        "tenants": [tenant],
        "posts": posts,
        "stale_serves": 0,
        "stale_rate": 0.0,
        "p50_tick_ms": round(percentile(lat, 0.50), 2),
        "p95_tick_ms": round(percentile(lat, 0.95), 2),
        "p99_tick_ms": round(percentile(lat, 0.99), 2),
        "lost_spans": max(0, ref_spans - live_spans),
        "missing_traces": [],
        "quarantined": quarantined,
        "expected_poisons": 0,
        "recovery_ms": 0.0,
        "recoveries": {},
        "capacity": {},
        "signatures": {tenant: live_sig},
        "ref_signatures": {tenant: ref_sig},
        "freshness": {},
        "wal": {
            "ok": gates["replayed_all"] and gates["bit_exact"],
            "records": len(records),
            "spans": live_spans,
            "torn_dropped": torn_dropped,
            "source": meta.get("source", bundle_dir),
        },
        "errors": errors[:4],
        "gates": gates,
        "pass": all(gates.values()),
        "wall_s": round((prof_events.now_ms() - t_start) / 1000, 1),
    }
    if not card["pass"]:
        card["flight_artifact"] = _failed_gates_artifact(spec, gates)
    if verbose:
        import sys

        print(f"{spec.name}: pass={card['pass']} gates={gates}", file=sys.stderr)
    return card

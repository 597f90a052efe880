"""Live tenant migration: drain -> ship WAL -> replay -> flip the ring.

Counterpart of kmamiz_tpu/fleet/migration.py. The handoff:

1. **drain**: the coordinator marks the tenant draining (new frames
   queue; nothing is dropped) and the source quiesces at the graph's
   ``stage_fence()``, answering its pre-drain ``graph_signature`` and
   durable record count;
2. **ship**: the source's WAL namespace becomes one handoff blob
   (``IngestWAL.export_handoff``);
3. **replay**: the target imports the blob into a new WAL namespace and
   replays it through a new processor. Replay order sets the interner's
   ids, so the rebuilt graph must hash to the source's pre-drain
   signature bit for bit; a mismatch is corruption, and the migration
   aborts. The rebuilt processor only stages (``wal_import`` is phase one
   of a two-phase install);
4. **flip**: after the check the coordinator commits the staged processor
   on the target (``commit_import``), flips the ring entry and releases
   the drain queue to the target; the source drops its copy, so one
   worker serves the tenant.

Any failure (the source unreachable mid-handoff, a torn blob whose replay
diverges, a signature mismatch, a drain over its budget) takes the abort
path: the staged import is dropped (``abort_import``), the ring entry
never flips, the queue goes back to the source, and the tenant serves on
from the source's intact state. A queue release that meets an unreachable
worker re-queues the unsent frames (coordinator._flush). No state exists
in which two workers both claim the tenant.
"""
from __future__ import annotations

from typing import Optional

from kmamiz_tpu_torch import fleet as fleet_mod
from kmamiz_tpu_torch.telemetry.profiling import events as prof_events


class MigrationError(RuntimeError):
    """The handoff failed; the coordinator has already aborted back to
    the source when this is raised from migrate_tenant."""


def migrate_tenant(
    coordinator,
    tenant: str,
    target: str,
    drain_timeout_ms: Optional[float] = None,
) -> dict:
    """Move one tenant to ``target`` through the WAL-handoff protocol.
    Returns a result dict (``ok``, ``source``, ``target``,
    ``signature``, ``records``, ``queuedReleased``, ``drainMs``); raises
    MigrationError after aborting when any stage fails. The drain budget
    is ``drain_timeout_ms`` (None: fleet.DRAIN_TIMEOUT_MS)."""
    if drain_timeout_ms is None:
        drain_timeout_ms = fleet_mod.DRAIN_TIMEOUT_MS
    transport = coordinator.transport
    # validate BEFORE begin_drain: a trivially bad request (unknown
    # target, tenant already there) must fail without ever pausing the
    # tenant's traffic or taking the abort/flush path
    if target not in coordinator.ring.workers:
        raise MigrationError(f"target {target!r} is not on the ring")
    if coordinator.owner(tenant) == target:
        raise MigrationError(f"tenant {tenant!r} already lives on {target!r}")
    source = coordinator.begin_drain(tenant)
    fleet_mod.incr("migrationsStarted")
    t0_ms = prof_events.now_ms()
    staged = False
    try:
        if source == target:  # owner flipped between the check and drain
            raise MigrationError(
                f"tenant {tenant!r} already lives on {target!r}"
            )
        pre = transport.drain(source, tenant)
        blob = transport.wal_export(source, tenant)
        _check_drain_budget(t0_ms, drain_timeout_ms, tenant)
        imported = transport.wal_import(target, tenant, blob)
        staged = True
        if imported["signature"] != pre["signature"]:
            raise MigrationError(
                f"tenant {tenant!r} replay diverged: target "
                f"{imported['signature'][:12]} != source pre-drain "
                f"{pre['signature'][:12]}"
            )
        if imported["records"] != pre["walRecords"]:
            raise MigrationError(
                f"tenant {tenant!r} handoff lost records: shipped "
                f"{imported['records']} of {pre['walRecords']}"
            )
        # verification passed: install the staged processor on the
        # target FIRST, so the flip below releases the queue into the
        # migrated graph, never a lazily-created empty one
        transport.commit_import(target, tenant)
    except Exception as err:
        if staged:
            try:  # best-effort: the target may be unreachable too
                transport.abort_import(target, tenant)
            except Exception:  # noqa: BLE001 - abort must not mask err
                pass
        coordinator.abort_migration(tenant)
        fleet_mod.incr("migrationsAborted")
        if isinstance(err, MigrationError):
            raise
        raise MigrationError(
            f"tenant {tenant!r} migration {source!r} -> {target!r} "
            f"failed: {err}"
        ) from err
    released = coordinator.commit_migration(tenant, target)
    fleet_mod.incr("migrationsCompleted")
    try:
        # the source forgets the tenant: exactly one worker serves it
        # post-flip even if the coordinator later rebuilds its overrides
        transport.drop_tenant(source, tenant)
    except Exception:  # noqa: BLE001 - committed; cleanup is best-effort
        pass
    return {
        "ok": True,
        "tenant": tenant,
        "source": source,
        "target": target,
        "signature": imported["signature"],
        "records": imported["records"],
        "queuedReleased": len(released),
        "drainMs": round(prof_events.now_ms() - t0_ms, 1),
    }


def _check_drain_budget(t0_ms: float, budget_ms: float, tenant: str) -> None:
    elapsed_ms = prof_events.now_ms() - t0_ms
    if budget_ms and elapsed_ms > budget_ms:
        raise MigrationError(
            f"tenant {tenant!r} drain exceeded "
            f"{budget_ms:.0f}ms (took {elapsed_ms:.0f}ms)"
        )

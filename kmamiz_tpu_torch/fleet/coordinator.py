"""The fleet coordinator: one logical DP endpoint over N workers.

Counterpart of kmamiz_tpu/fleet/coordinator.py. It routes every ingest
frame (Zipkin JSON or KMZC) to the tenant's ring owner, folds the
workers' graphs into one aggregate store (two levels: each worker's
window merges are level one, the coordinator's set union by endpoint
names, `fold_named_edges`, is level two), and carries the migration's
routing state: per-tenant overrides that flip at commit, and drain
queues that hold frames during a handoff, so a burst mid-migration loses
nothing.

Transports keep the decisions apart from the deployment's shape:
``LocalTransport`` calls :class:`~kmamiz_tpu_torch.fleet.worker.FleetWorker`
methods directly (in-process fleets), ``HTTPTransport`` speaks the DP
server's ``/fleet/*`` routes (worker processes).

Locks: the coordinator's one lock guards its routing state and is never
held across a worker call. The drain barrier (`begin_drain`) waits on it
for the tenant's in-flight sends; a worker's ingest takes only that
worker's processor and store locks, never a tick lock, so a drain, a
staged import and a tenant's tick do not wait on each other in a cycle.
"""
from __future__ import annotations

import json
import logging
import threading
import urllib.error
import urllib.request
from typing import Dict, Iterable, List, Optional

from kmamiz_tpu_torch import fleet as fleet_mod
from kmamiz_tpu_torch.fleet.ring import HashRing, RingError
from kmamiz_tpu_torch.telemetry.profiling.events import now_ms

logger = logging.getLogger(__name__)


class TransportError(RuntimeError):
    """A worker could not be reached or answered a non-2xx."""


class LocalTransport:
    """Direct method dispatch onto in-process FleetWorker instances."""

    def __init__(self, workers: Dict[str, "FleetWorker"]) -> None:
        self._workers = dict(workers)

    def _worker(self, worker_id: str):
        try:
            return self._workers[worker_id]
        except KeyError:
            raise TransportError(f"unknown worker {worker_id!r}") from None

    def ingest(self, worker_id: str, tenant: str, raw: bytes) -> dict:
        return self._worker(worker_id).ingest(tenant, raw)

    def signature(self, worker_id: str, tenant: str) -> str:
        return self._worker(worker_id).signature(tenant)

    def export_edges(self, worker_id: str, tenant: str) -> dict:
        return self._worker(worker_id).export_edges(tenant)

    def drain(self, worker_id: str, tenant: str) -> dict:
        return self._worker(worker_id).drain(tenant)

    def wal_export(self, worker_id: str, tenant: str) -> bytes:
        return self._worker(worker_id).wal_export(tenant)

    def wal_import(self, worker_id: str, tenant: str, data: bytes) -> dict:
        return self._worker(worker_id).wal_import(tenant, data)

    def commit_import(self, worker_id: str, tenant: str) -> dict:
        return self._worker(worker_id).commit_import(tenant)

    def abort_import(self, worker_id: str, tenant: str) -> dict:
        return self._worker(worker_id).abort_import(tenant)

    def drop_tenant(self, worker_id: str, tenant: str) -> dict:
        return self._worker(worker_id).drop_tenant(tenant)

    def timings(self, worker_id: str) -> dict:
        worker = self._worker(worker_id)
        return {"worker": worker.summary()}


class HTTPTransport:
    """The same verbs over the DP server's /fleet/* routes. The tenant
    rides the path prefix (/t/<tenant>/...), as the router resolves it."""

    def __init__(
        self, endpoints: Dict[str, str], timeout_s: float = 30.0
    ) -> None:
        # worker id -> base URL, e.g. {"w0": "http://127.0.0.1:8601"}
        self._endpoints = dict(endpoints)
        self._timeout_s = timeout_s

    def _url(self, worker_id: str, tenant: Optional[str], path: str) -> str:
        try:
            base = self._endpoints[worker_id].rstrip("/")
        except KeyError:
            raise TransportError(f"unknown worker {worker_id!r}") from None
        prefix = f"/t/{tenant}" if tenant else ""
        return f"{base}{prefix}{path}"

    def _request(
        self, url: str, data: Optional[bytes] = None, raw: bool = False
    ):
        req = urllib.request.Request(url, data=data)
        if data is not None:
            req.add_header("Content-Type", "application/octet-stream")
        try:
            with urllib.request.urlopen(req, timeout=self._timeout_s) as resp:
                body = resp.read()
        except (urllib.error.URLError, OSError, TimeoutError) as err:
            raise TransportError(f"{url}: {err}") from err
        return body if raw else json.loads(body)

    def ingest(self, worker_id: str, tenant: str, raw: bytes) -> dict:
        return self._request(self._url(worker_id, tenant, "/ingest"), raw)

    def signature(self, worker_id: str, tenant: str) -> str:
        out = self._request(self._url(worker_id, tenant, "/fleet/signature"))
        return out["signature"]

    def export_edges(self, worker_id: str, tenant: str) -> dict:
        return self._request(self._url(worker_id, tenant, "/fleet/export"))

    def drain(self, worker_id: str, tenant: str) -> dict:
        return self._request(self._url(worker_id, tenant, "/fleet/drain"), b"")

    def wal_export(self, worker_id: str, tenant: str) -> bytes:
        return self._request(
            self._url(worker_id, tenant, "/fleet/wal"), raw=True
        )

    def wal_import(self, worker_id: str, tenant: str, data: bytes) -> dict:
        return self._request(
            self._url(worker_id, tenant, "/fleet/wal-import"), data
        )

    def commit_import(self, worker_id: str, tenant: str) -> dict:
        return self._request(
            self._url(worker_id, tenant, "/fleet/wal-commit"), b""
        )

    def abort_import(self, worker_id: str, tenant: str) -> dict:
        return self._request(
            self._url(worker_id, tenant, "/fleet/wal-abort"), b""
        )

    def drop_tenant(self, worker_id: str, tenant: str) -> dict:
        return self._request(self._url(worker_id, tenant, "/fleet/drop"), b"")

    def timings(self, worker_id: str) -> dict:
        return self._request(self._url(worker_id, None, "/timings"))


class FleetCoordinator:
    """Ring-driven routing + migration bookkeeping over a transport."""

    def __init__(self, ring: HashRing, transport) -> None:
        self._ring = ring
        self._transport = transport
        # routing state shared by request threads and the migration
        # thread: every read and write holds _lock
        self._lock = threading.RLock()
        # begin_drain waits on this until the tenant's in-flight ingest
        # sends (dispatched pre-drain, still on the wire) have landed, so
        # a frame can never slip onto the source AFTER drain() captured
        # the signature/record count it must reproduce on the target
        self._barrier = threading.Condition(self._lock)
        self._overrides: Dict[str, str] = {}
        self._draining: set = set()
        self._queues: Dict[str, List[bytes]] = {}
        self._inflight: Dict[str, int] = {}

    @property
    def transport(self):
        return self._transport

    def swap_transport(self, transport):
        """Replace the transport, returning the old one: the soak's
        mid-handoff injection and a test's dead worker splice proxies in
        here."""
        with self._lock:
            old, self._transport = self._transport, transport
            return old

    @property
    def ring(self) -> HashRing:
        with self._lock:
            return self._ring

    def owner(self, tenant: str) -> str:
        """Migration override first, ring second — the override IS the
        flipped ring entry until a ring rebuild absorbs it."""
        with self._lock:
            override = self._overrides.get(tenant)
            if override is not None:
                return override
            return self._ring.owner(tenant)

    # -- ingest routing ------------------------------------------------------

    def route_ingest(self, tenant: str, raw: bytes) -> Optional[dict]:
        """Send one frame to the tenant's owner; while the tenant is
        draining for migration the frame parks in its queue instead
        (released to whichever side the migration resolves to), so a
        handoff never drops an in-flight window. A backlog left behind
        by an earlier failed queue release delivers first, preserving
        arrival order. Returns the worker's ingest summary, or None for
        a frame that is (still) queued."""
        with self._lock:
            if tenant in self._draining:
                self._queues.setdefault(tenant, []).append(raw)
                fleet_mod.incr("framesQueuedDuringDrain")
                return None
            worker_id = self.owner(tenant)
            backlog = self._queues.pop(tenant, None)
            if backlog:
                backlog.append(raw)
            else:
                backlog = None
                self._inflight[tenant] = self._inflight.get(tenant, 0) + 1
        if backlog is not None:
            summaries = self._flush(tenant, worker_id, backlog)
            # the new frame is last in the backlog: its summary came
            # back only if the whole backlog flushed
            if len(summaries) == len(backlog):
                return summaries[-1]
            return None
        try:
            summary = self._transport.ingest(worker_id, tenant, raw)
        finally:
            self._ingest_done(tenant)
        fleet_mod.incr("framesRouted")
        return summary

    def _ingest_done(self, tenant: str) -> None:
        with self._lock:
            n = self._inflight.get(tenant, 0) - 1
            if n > 0:
                self._inflight[tenant] = n
            else:
                self._inflight.pop(tenant, None)
            self._barrier.notify_all()

    # -- hierarchical fold ---------------------------------------------------

    def fold(self, tenants: Iterable[str], graph) -> int:
        """Level-two merge: pull each tenant's name-based edge export
        from its owner and set-union everything into ``graph`` (an
        EndpointGraph, usually the coordinator's aggregate store, on any
        device: names cross, never interner ids). Returns the live edges
        folded."""
        folded = 0
        for tenant in tenants:
            export = self._transport.export_edges(self.owner(tenant), tenant)
            folded += graph.fold_named_edges(export)
        fleet_mod.incr("folds")
        fleet_mod.incr("foldedEdges", folded)
        return folded

    # -- migration hooks (fleet/migration.py drives these) -------------------

    def begin_drain(
        self, tenant: str, barrier_timeout_s: Optional[float] = None
    ) -> str:
        """Mark a tenant draining (frames queue from here on) and wait
        for the tenant's in-flight ingest sends to land before
        returning, so the source's drain() snapshot cannot race a frame
        already on the wire. Returns the current owner (the migration
        source). A barrier timeout rolls the drain flag back — frames
        queued while waiting stay parked and route_ingest's backlog
        path delivers them — and raises RingError."""
        if barrier_timeout_s is None:
            timeout_ms = fleet_mod.DRAIN_TIMEOUT_MS
            barrier_timeout_s = timeout_ms / 1000.0 if timeout_ms else 30.0
        with self._lock:
            if tenant in self._draining:
                raise RingError(f"tenant {tenant!r} is already draining")
            self._draining.add(tenant)
            self._queues.setdefault(tenant, [])
            deadline = now_ms() + barrier_timeout_s * 1000.0
            while self._inflight.get(tenant, 0):
                remaining = (deadline - now_ms()) / 1000.0
                if remaining <= 0:
                    self._draining.discard(tenant)
                    raise RingError(
                        f"tenant {tenant!r} drain barrier timed out with "
                        f"{self._inflight[tenant]} ingest send(s) in flight"
                    )
                self._barrier.wait(remaining)
            return self.owner(tenant)

    def commit_migration(self, tenant: str, target: str) -> List[dict]:
        """Flip the ring entry (override) to the target and release the
        drain queue there, in arrival order. The flip and the queue
        capture are atomic; the flush itself happens outside the lock so
        slow worker I/O never blocks routing of other tenants."""
        with self._lock:
            if target not in self._ring.workers:
                raise RingError(f"target {target!r} is not on the ring")
            self._overrides[tenant] = target
            self._draining.discard(tenant)
            queued = self._queues.pop(tenant, [])
        return self._flush(tenant, target, queued)

    def abort_migration(self, tenant: str) -> List[dict]:
        """Migration failed: clear the drain flag WITHOUT touching the
        ring and release the queue back to the unchanged owner — the
        source keeps serving from its intact state (no split-brain)."""
        with self._lock:
            self._draining.discard(tenant)
            queued = self._queues.pop(tenant, [])
            owner = self.owner(tenant)
        return self._flush(tenant, owner, queued)

    def _flush(
        self, tenant: str, worker_id: str, queued: List[bytes]
    ) -> List[dict]:
        """Replay parked frames to ``worker_id`` in arrival order.
        Never raises and never loses a frame: a send that fails (worker
        unreachable mid-release — the kill -9 abort path) or a fresh
        drain starting mid-flush puts the unsent remainder back at the
        FRONT of the tenant's queue, where the next drain resolution or
        route_ingest's backlog path delivers it. Returns the summaries
        of the frames that did land."""
        summaries: List[dict] = []
        for pos, raw in enumerate(queued):
            with self._lock:
                if tenant in self._draining:
                    self._requeue_locked(tenant, queued[pos:])
                    return summaries
                self._inflight[tenant] = self._inflight.get(tenant, 0) + 1
            try:
                summaries.append(
                    self._transport.ingest(worker_id, tenant, raw)
                )
            except Exception as err:  # noqa: BLE001 - frames must survive
                with self._lock:
                    self._requeue_locked(tenant, queued[pos:])
                logger.warning(
                    "fleet flush to %s failed for tenant %s (%s frame(s) "
                    "re-queued): %s",
                    worker_id,
                    tenant,
                    len(queued) - pos,
                    err,
                )
                return summaries
            finally:
                self._ingest_done(tenant)
            fleet_mod.incr("framesRouted")
        return summaries

    def _requeue_locked(self, tenant: str, frames: List[bytes]) -> None:
        self._queues.setdefault(tenant, [])[:0] = frames
        fleet_mod.incr("framesRequeued", len(frames))

    def snapshot(self) -> dict:
        """The routing state, for /timings."""
        with self._lock:
            return {
                "ring": self._ring.describe(),
                "overrides": dict(self._overrides),
                "draining": sorted(self._draining),
                "queuedFrames": {
                    t: len(q) for t, q in self._queues.items() if q
                },
                "inflight": dict(self._inflight),
            }

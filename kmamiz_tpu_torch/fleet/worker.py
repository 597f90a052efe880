"""One fleet front end: per-tenant processors under a worker identity.

Counterpart of kmamiz_tpu/fleet/worker.py. A ``FleetWorker`` is the unit
the ring assigns tenants to. Each owned tenant gets its own
``DataProcessor`` (the raw ingest path: the native parse, KMZC frames,
the quarantine, the graph merge on the worker's device), whose WAL logs
under the worker's namespace, ``<wal-root>/workers/<worker-id>/tenants/
<tenant>``: a migration ships one directory's records, and two workers
never share a WAL file. Its processors run with device statistics off,
as the JAX worker's do: ingest merges the graph on the card and runs no
window statistics.

Two modes:

- in process (tests, the fleet soak): N ``FleetWorker``s in one process
  behind a ``LocalTransport``, with the routing, fold and migration
  decisions of the multi-process deployment;
- a subprocess (`main`): a ``DataProcessorServer`` per worker on the
  card, whose ``/fleet/*`` routes the coordinator speaks over HTTP
  (``HTTPTransport``)::

      python -m kmamiz_tpu_torch.fleet.worker --worker-id w0 [--device cpu]
"""
from __future__ import annotations

import os
import threading
from typing import Callable, Dict, List, Optional

from kmamiz_tpu_torch.device import DeviceLike
from kmamiz_tpu_torch.fleet.ring import RingError
from kmamiz_tpu_torch.graph.store import graph_signature
from kmamiz_tpu_torch.resilience.wal import IngestWAL
from kmamiz_tpu_torch.tenancy.arena import valid_tenant


def _stub_source(_look_back: int, _end_ts: int, _limit: int) -> List[list]:
    """Fleet workers are ingest-driven; the poll source stays empty."""
    return []


class FleetWorker:
    """Per-tenant processors + WAL namespaces under one worker id, on
    `device` (None: the card, raising without one)."""

    def __init__(
        self,
        worker_id: str,
        wal_root: Optional[str] = None,
        trace_source: Optional[Callable] = None,
        device: DeviceLike = None,
    ) -> None:
        if not isinstance(worker_id, str) or not valid_tenant(worker_id):
            raise RingError(f"invalid worker id: {worker_id!r}")
        self.worker_id = worker_id
        self.device = device
        self._wal_root = wal_root
        self._trace_source = trace_source or _stub_source
        # tenant processors are made on a tenant's first frame; that and
        # the migration's swap serialize here
        self._lock = threading.RLock()
        self._procs: Dict[str, "DataProcessor"] = {}
        # replayed but unverified migration imports wait here until the
        # coordinator's signature check commits (or aborts) them: an
        # aborted handoff never leaves a divergent graph serving
        self._pending_imports: Dict[str, "DataProcessor"] = {}
        self._frames = 0
        self._spans = 0

    # -- tenant processors ---------------------------------------------------

    def _tenant_wal(self, tenant: str) -> Optional[IngestWAL]:
        if self._wal_root is None:
            return None
        return IngestWAL(os.path.join(self._wal_root, "workers", self.worker_id, "tenants", tenant))

    def _fresh_processor(self, tenant: str) -> "DataProcessor":
        from kmamiz_tpu_torch.server.processor import DataProcessor

        return DataProcessor(
            self._trace_source,
            device=self.device,
            use_device_stats=False,
            tenant=tenant,
            wal=self._tenant_wal(tenant),
        )

    def processor(self, tenant: str) -> "DataProcessor":
        """The tenant's processor, made on first use (the coordinator
        enforces placement; the worker serves)."""
        with self._lock:
            proc = self._procs.get(tenant)
            if proc is None:
                proc = self._fresh_processor(tenant)
                self._procs[tenant] = proc
            return proc

    def tenants(self) -> List[str]:
        with self._lock:
            return sorted(self._procs)

    def drop_tenant(self, tenant: str) -> dict:
        """Forget a migrated-away tenant (its WAL directory stays on disk
        as the abort path's safety net until the next import)."""
        with self._lock:
            proc = self._procs.pop(tenant, None)
        if proc is not None and proc.wal is not None:
            proc.wal.close()
        return {"tenant": tenant, "worker": self.worker_id, "dropped": proc is not None}

    # -- ingest / fold -------------------------------------------------------

    def ingest(self, tenant: str, raw: bytes) -> dict:
        summary = self.processor(tenant).ingest_raw_window(raw)
        with self._lock:
            self._frames += 1
            self._spans += int(summary.get("spans", 0))
        return summary

    def signature(self, tenant: str) -> str:
        return graph_signature(self.processor(tenant).graph)

    def export_edges(self, tenant: str) -> dict:
        return self.processor(tenant).graph.export_named_edges()

    # -- migration (fleet/migration.py drives these) -------------------------

    def drain(self, tenant: str) -> dict:
        """Quiesce a tenant for handoff: retire its in-flight merges at the
        graph's stage_fence, then report the pre-drain signature and the
        durable record count the target must reproduce."""
        proc = self.processor(tenant)
        proc.graph.stage_fence()
        wal = proc.wal
        return {
            "tenant": tenant,
            "worker": self.worker_id,
            "signature": graph_signature(proc.graph),
            "walRecords": wal.record_count() if wal is not None else 0,
        }

    def wal_export(self, tenant: str) -> bytes:
        wal = self.processor(tenant).wal
        if wal is None:
            raise RuntimeError(
                f"tenant {tenant!r} has no WAL on worker {self.worker_id!r} (migration needs durability; set a wal_root)"
            )
        return wal.export_handoff()

    def wal_import(self, tenant: str, data: bytes) -> dict:
        """Receive a migrating tenant: a new processor (empty dedup map and
        graph, its WAL namespace truncated) imports the shipped records and
        replays them in order. Ids follow replay order, so the rebuilt
        graph's signature is the source's pre-drain one, bit for bit. The
        processor only stages here (phase one): it serves after the
        coordinator's check calls commit_import, and abort_import drops it
        without touching the tenant's live entry."""
        proc = self._fresh_processor(tenant)
        if proc.wal is None:
            raise RuntimeError(f"worker {self.worker_id!r} has no wal_root; cannot import")
        proc.wal.truncate()
        imported = proc.wal.import_handoff(data)
        replayed = proc.replay_wal()
        with self._lock:
            stale = self._pending_imports.pop(tenant, None)
            self._pending_imports[tenant] = proc
        if stale is not None and stale.wal is not None and stale.wal is not proc.wal:
            stale.wal.close()
        return {
            "tenant": tenant,
            "worker": self.worker_id,
            "records": imported,
            "replayed": replayed["replayed"],
            "spans": replayed["spans"],
            "signature": graph_signature(proc.graph),
        }

    def commit_import(self, tenant: str) -> dict:
        """Phase two: the replay checked out; the staged processor becomes
        the tenant's live entry, so the first frame after the flip lands
        in the migrated graph."""
        with self._lock:
            proc = self._pending_imports.pop(tenant, None)
            if proc is None:
                raise RingError(f"no pending import for tenant {tenant!r} on worker {self.worker_id!r}")
            old = self._procs.get(tenant)
            self._procs[tenant] = proc
        if old is not None and old.wal is not None and old.wal is not proc.wal:
            old.wal.close()
        return {"tenant": tenant, "worker": self.worker_id, "installed": True}

    def abort_import(self, tenant: str) -> dict:
        """The migration aborted: drop the staged processor. The tenant's
        live entry (if any) was never touched."""
        with self._lock:
            proc = self._pending_imports.pop(tenant, None)
        if proc is not None and proc.wal is not None:
            proc.wal.close()
        return {"tenant": tenant, "worker": self.worker_id, "dropped": proc is not None}

    def summary(self) -> dict:
        with self._lock:
            return {"worker": self.worker_id, "tenants": sorted(self._procs), "frames": self._frames, "spans": self._spans}


def main(argv: Optional[List[str]] = None) -> None:
    """The subprocess worker: a DataProcessorServer whose /fleet/* routes
    serve this worker's tenants, on the card unless --device says
    otherwise (and raising without one). The parent points KMAMIZ_WAL_DIR
    at the worker's own directory (with KMAMIZ_WAL=1) before the spawn, so
    each tenant's WAL lands under it as the in-process layout has it; the
    WAL replays before the server answers. The bound port is printed as
    ``FLEET_WORKER_READY <worker-id> <port>``."""
    import argparse
    import logging

    from kmamiz_tpu_torch.server.dp_server import DataProcessorServer
    from kmamiz_tpu_torch.server.processor import DataProcessor

    ap = argparse.ArgumentParser(description="kmamiz fleet worker")
    ap.add_argument("--worker-id", required=True)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)
    if not valid_tenant(args.worker_id):
        ap.error(f"invalid worker id: {args.worker_id!r}")

    logging.basicConfig(level=os.environ.get("LOG_LEVEL", "WARNING").upper())
    processor = DataProcessor(_stub_source, use_device_stats=False, device=args.device)
    recovered = processor.replay_wal()
    if recovered["replayed"]:
        logging.getLogger("kmamiz_tpu_torch.fleet.worker").info("worker %s wal replay: %s", args.worker_id, recovered)
    server = DataProcessorServer(processor, host=args.host, port=args.port)
    print(f"FLEET_WORKER_READY {args.worker_id} {server.port}", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()

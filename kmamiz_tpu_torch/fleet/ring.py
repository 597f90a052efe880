"""Seeded consistent-hash ring: tenant -> worker placement.

Counterpart of kmamiz_tpu/fleet/ring.py, with its hashes, so both
packages place a tenant on the same worker for the same seed, vnodes and
workers. Every fleet process must agree on a tenant's owner without
talking to the others, so placement is a pure function of (seed, worker
ids, vnode count, tenant name), hashed with sha256 over explicit strings:
Python's `hash` is salted per process.

Each worker projects ``vnodes`` points onto a 64-bit ring; a tenant maps
to the first worker point clockwise of its own hash. Adding or removing a
worker moves only the tenants of its arcs, and load spreads near-uniformly
with no central table.

Worker ids and tenants share the tenant arena's name rules
(`tenancy/arena.valid_tenant`): both become path components (a worker's
WAL namespace is ``<wal-root>/workers/<worker-id>``).
"""
from __future__ import annotations

import bisect
import hashlib
from typing import Dict, Iterable, List, Sequence, Tuple

from kmamiz_tpu_torch.tenancy.arena import valid_tenant


class RingError(ValueError):
    """Invalid ring construction (bad/duplicate worker id, bad tenant)."""


def _point(seed: int, key: str) -> int:
    """Deterministic 64-bit ring coordinate for a key under a seed."""
    digest = hashlib.sha256(f"{seed}|{key}".encode("utf-8")).digest()
    return int.from_bytes(digest[:8], "big")


class HashRing:
    """Immutable seeded ring over a fixed worker set."""

    __slots__ = ("_workers", "_vnodes", "_seed", "_points", "_keys")

    def __init__(self, workers: Sequence[str], vnodes: int = 64, seed: int = 0) -> None:
        if not workers:
            raise RingError("ring needs at least one worker")
        if vnodes < 1:
            raise RingError(f"vnodes must be >= 1, got {vnodes}")
        seen = set()
        for worker in workers:
            if not isinstance(worker, str) or not valid_tenant(worker):
                raise RingError(f"invalid worker id: {worker!r}")
            if worker in seen:
                raise RingError(f"duplicate worker id: {worker!r}")
            seen.add(worker)
        self._workers: Tuple[str, ...] = tuple(workers)
        self._vnodes = int(vnodes)
        self._seed = int(seed)
        # the worker id is part of the hashed string, and equal points
        # (astronomically rare) still sort by the (point, worker) pair
        points: List[Tuple[int, str]] = sorted(
            (_point(self._seed, f"{worker}#{i}"), worker) for worker in self._workers for i in range(self._vnodes)
        )
        self._points = points
        self._keys = [p for p, _w in points]

    @property
    def workers(self) -> Tuple[str, ...]:
        return self._workers

    @property
    def vnodes(self) -> int:
        return self._vnodes

    @property
    def seed(self) -> int:
        return self._seed

    def owner(self, tenant: str) -> str:
        """The worker owning a tenant: the first vnode clockwise of the
        tenant's hash (wrapping past the top of the ring)."""
        if not isinstance(tenant, str) or not valid_tenant(tenant):
            raise RingError(f"invalid tenant name: {tenant!r}")
        i = bisect.bisect_right(self._keys, _point(self._seed, f"tenant|{tenant}"))
        return self._points[i % len(self._points)][1]

    def assignment(self, tenants: Iterable[str]) -> Dict[str, str]:
        """tenant -> worker for a tenant set."""
        return {tenant: self.owner(tenant) for tenant in tenants}

    def with_workers(self, workers: Sequence[str]) -> "HashRing":
        """A resized ring with this one's seed and vnode count: only the
        tenants of the changed arcs move."""
        return HashRing(workers, vnodes=self._vnodes, seed=self._seed)

    def spread(self, tenants: Iterable[str]) -> Dict[str, int]:
        """worker -> the number of tenants it owns."""
        counts = {worker: 0 for worker in self._workers}
        for tenant in tenants:
            counts[self.owner(tenant)] += 1
        return counts

    def describe(self) -> dict:
        """The ring's settings, for /timings."""
        return {"workers": list(self._workers), "vnodes": self._vnodes, "seed": self._seed, "points": len(self._points)}

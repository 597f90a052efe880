"""Tenant arena: many endpoint graphs, one card.

Counterpart of kmamiz_tpu/tenancy/arena.py. One serving process hosts
many monitored clusters (tenants), each with its own
:class:`~kmamiz_tpu_torch.graph.store.EndpointGraph`. The arena is the
process-wide index over those graphs: ``arena[(tenant, version)]``
resolves to an edge-column snapshot, and graphs group into capacity
buckets, the power-of-two edge capacity of their padded columns.
Same-bucket tenants stack into one ``[T, cap]`` view (`stacked_edges`,
`torch.stack` on the stores' device) that the tenancy router's batched
merge reads.

Admission is bounded by MAX_TENANTS distinct tenant names (the JAX
package's KMAMIZ_MAX_TENANTS default, 64); graphs are held by weakref, so
a short-lived store never pins device memory through the arena.

Left out: the JAX arena's mesh sharding of the stacked view
(KMAMIZ_TENANT_SHARD), which waits for the port's multi-GPU layer.
"""
from __future__ import annotations

import re
import threading
import weakref
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

DEFAULT_TENANT = "default"

#: distinct tenants the arena admits (KMAMIZ_MAX_TENANTS's default)
MAX_TENANTS = 64

#: tenant names become directory components (quarantine and WAL
#: namespaces) and metric label values: no separators, no dotfiles, a
#: bounded length
_TENANT_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")


def valid_tenant(name: str) -> bool:
    return isinstance(name, str) and bool(_TENANT_RE.match(name)) and ".." not in name


class TenantLimitError(RuntimeError):
    """Admitting one more distinct tenant would exceed MAX_TENANTS."""


class TenantNameError(ValueError):
    """A tenant name outside the safe charset."""


def max_tenants() -> int:
    return max(1, int(MAX_TENANTS))


class ArenaView(NamedTuple):
    """The snapshot a ``(tenant, version)`` index resolves to."""

    tenant: str
    version: int
    capacity: int
    src: torch.Tensor
    dst: torch.Tensor
    dist: torch.Tensor
    mask: torch.Tensor


class TenantArena:
    """Process-wide ``tenant -> EndpointGraph`` registry with capacity
    buckets and stacked same-bucket views."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._graphs: "Dict[str, weakref.ref]" = {}
        # the last stacked view: (tenant, version) tuple -> tensors
        self._stacked_key: Optional[tuple] = None
        self._stacked_val: Optional[tuple] = None

    # -- admission -----------------------------------------------------------

    def admit(self, tenant: str, graph) -> None:
        """Register a tenant's graph. Re-admitting a tenant replaces its
        graph (the latest wins); a new name past max_tenants() raises
        TenantLimitError."""
        if not valid_tenant(tenant):
            raise TenantNameError(f"invalid tenant name: {tenant!r}")
        with self._lock:
            self._prune_locked()
            if tenant not in self._graphs and len(self._graphs) >= max_tenants():
                raise TenantLimitError(f"tenant limit reached ({max_tenants()}); cannot admit {tenant!r}")
            self._graphs[tenant] = weakref.ref(graph)
            self._stacked_key = None
            self._stacked_val = None

    def _prune_locked(self) -> None:
        for t in [t for t, r in self._graphs.items() if r() is None]:
            del self._graphs[t]

    # -- lookup --------------------------------------------------------------

    def get(self, tenant: str):
        with self._lock:
            ref = self._graphs.get(tenant)
        return ref() if ref is not None else None

    def tenants(self) -> List[str]:
        with self._lock:
            self._prune_locked()
            return sorted(self._graphs)

    def buckets(self) -> Dict[int, List[str]]:
        """Capacity bucket -> the tenants whose graphs occupy it."""
        out: Dict[int, List[str]] = {}
        for tenant in self.tenants():
            graph = self.get(tenant)
            if graph is not None:
                out.setdefault(graph.capacity, []).append(tenant)
        return out

    def snapshot(self, tenant: str) -> ArenaView:
        graph = self.get(tenant)
        if graph is None:
            raise KeyError(f"unknown tenant: {tenant!r}")
        # one lock hold: the version and the columns belong together
        with graph._lock:
            src, dst, dist, mask = graph.edge_arrays()
            version = graph.version
        return ArenaView(tenant, version, int(src.shape[0]), src, dst, dist, mask)

    def __getitem__(self, key: Tuple[str, int]) -> ArenaView:
        """``arena[(tenant, version)]``: the snapshot while the graph still
        sits at that version, else KeyError (the caller re-reads the
        current version)."""
        tenant, version = key
        view = self.snapshot(tenant)
        if view.version != int(version):
            raise KeyError(f"stale index ({tenant!r}, {version}); current version is {view.version}")
        return view

    # -- stacked same-bucket views -------------------------------------------

    def stacked_edges(self, tenants: Sequence[str]):
        """``[T, cap]`` stacked (src, dst, dist, mask) over same-bucket
        tenants, and the per-tenant views it was built from. Memoized on
        the ``(tenant, version)`` tuple: reads between merges reuse the
        stack; a merge moves a version, so each round restacks
        (T x cap x 13 bytes on the stores' device)."""
        views = [self.snapshot(t) for t in tenants]
        caps = {v.capacity for v in views}
        if len(caps) != 1:
            raise ValueError(f"tenants span capacity buckets: {sorted(caps)}")
        key = tuple((v.tenant, v.version) for v in views)
        with self._lock:
            if key == self._stacked_key and self._stacked_val is not None:
                return self._stacked_val, views
        stacked = tuple(torch.stack([getattr(v, f) for v in views]) for f in ("src", "dst", "dist", "mask"))
        with self._lock:
            self._stacked_key = key
            self._stacked_val = stacked
        return stacked, views

    def stacked_bytes(self) -> int:
        """Device bytes of the memoized stacked view (0 without one)."""
        with self._lock:
            val = self._stacked_val
        return sum(t.nbytes for t in val) if val is not None else 0

    # -- introspection -------------------------------------------------------

    def summary(self) -> dict:
        """Per-bucket tenants and device bytes, for /timings."""
        buckets = {}
        total_bytes = 0
        for cap, members in self.buckets().items():
            byts = 0
            for t in members:
                graph = self.get(t)
                if graph is not None:
                    byts += sum(graph.arena_bytes().values())
            total_bytes += byts
            buckets[str(cap)] = {"tenants": members, "bytes": byts}
        return {
            "tenants": len(self.tenants()),
            "maxTenants": max_tenants(),
            "buckets": buckets,
            "bytes": total_bytes,
        }

    def arena_bytes_by_tenant(self) -> Dict[str, int]:
        return {t: sum(g.arena_bytes().values()) for t in self.tenants() if (g := self.get(t)) is not None}

    def reset_for_tests(self) -> None:
        with self._lock:
            self._graphs.clear()
            self._stacked_key = None
            self._stacked_val = None


# -- the process-wide arena and its per-tenant device-byte gauges -------------

_DEFAULT_LOCK = threading.Lock()
_DEFAULT: dict = {"instance": None}
_TELEMETRY_REGISTERED = False


def default_arena() -> TenantArena:
    """The process-wide arena every EndpointGraph admits itself into."""
    global _TELEMETRY_REGISTERED
    with _DEFAULT_LOCK:
        if _DEFAULT["instance"] is None:
            _DEFAULT["instance"] = TenantArena()
        if not _TELEMETRY_REGISTERED:
            _TELEMETRY_REGISTERED = True
            _register_arena_telemetry()
        return _DEFAULT["instance"]


def _register_arena_telemetry() -> None:
    """kmamiz_tenant_arena_bytes{tenant=...}, read at scrape time (the
    merge path touches no label); the label folds past the scorecard's
    series cap (telemetry/slo.tenant_label)."""
    from kmamiz_tpu_torch.telemetry import REGISTRY
    from kmamiz_tpu_torch.telemetry.slo import tenant_label

    family = REGISTRY.gauge_family(
        "kmamiz_tenant_arena_bytes", "Tracked device-arena bytes per tenant graph", ("tenant",)
    )

    def scrape() -> None:
        with _DEFAULT_LOCK:
            arena = _DEFAULT["instance"]
        if arena is None:
            return
        totals: Dict[str, int] = {}
        for tenant, nbytes in arena.arena_bytes_by_tenant().items():
            label = tenant_label(tenant)
            totals[label] = totals.get(label, 0) + nbytes
        for label, nbytes in totals.items():
            family.handle(label).set(float(nbytes))

    REGISTRY.register_callback(scrape)


def reset_for_tests() -> None:
    with _DEFAULT_LOCK:
        instance = _DEFAULT["instance"]
    if instance is not None:
        instance.reset_for_tests()

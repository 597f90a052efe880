"""Multi-tenant serving: many endpoint graphs, one card.

Counterpart of kmamiz_tpu/tenancy/:

- :mod:`.arena` — the capacity-bucketed ``(tenant, version)`` index every
  EndpointGraph admits itself into; same-bucket tenants stack into
  ``[T, cap]`` views.
- :mod:`.batch` — the stacked merge and scorers over the tenant axis.
- :mod:`.router` — tenant resolution, per-tenant runtimes and the batched
  tick dispatcher the DP server mounts.
- :mod:`.isolation` — per-tenant keys of the resilience layers
  (quarantine directories, WAL namespaces, breakers, job names).

The JAX package's `growth` module (a tenant's capacity growth, which its
cost model predicts) comes with the port of the cost model.
"""
from __future__ import annotations

from kmamiz_tpu_torch.tenancy.arena import (
    DEFAULT_TENANT,
    ArenaView,
    TenantArena,
    TenantLimitError,
    TenantNameError,
    default_arena,
    max_tenants,
    valid_tenant,
)
from kmamiz_tpu_torch.tenancy.batch import batched_merge_edges, batched_service_scores
from kmamiz_tpu_torch.tenancy.isolation import (
    reset_tenant,
    tenant_breaker,
    tenant_job_name,
    tenant_quarantine,
    tenant_wal,
)
from kmamiz_tpu_torch.tenancy.router import (
    TenantResolutionError,
    TenantRuntime,
    TickRouter,
    resolve_tenant,
    tenant_header,
)

__all__ = [
    "DEFAULT_TENANT",
    "ArenaView",
    "TenantArena",
    "TenantLimitError",
    "TenantNameError",
    "TenantResolutionError",
    "TenantRuntime",
    "TickRouter",
    "batched_merge_edges",
    "batched_service_scores",
    "default_arena",
    "max_tenants",
    "reset_for_tests",
    "reset_tenant",
    "resolve_tenant",
    "tenant_breaker",
    "tenant_header",
    "tenant_job_name",
    "tenant_quarantine",
    "tenant_wal",
    "valid_tenant",
]


def reset_for_tests() -> None:
    """Clear the process-wide arena."""
    from kmamiz_tpu_torch.tenancy import arena

    arena.reset_for_tests()

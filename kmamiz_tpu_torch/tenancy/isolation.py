"""Per-tenant isolation of the resilience edge layers.

Counterpart of kmamiz_tpu/tenancy/isolation.py: one tenant's poison
traffic, overrunning ticks or flapping upstream must not degrade another
tenant. This module keys the resilience primitives by tenant:

- quarantine: a tenant's payloads divert to ``<dir>/tenants/<tenant>``
  (the default tenant keeps the plain directory), with a budget of their
  own;
- WAL: a tenant's log lives under ``<wal-dir>/tenants/<tenant>`` and
  replays on its own;
- breakers: ``<tenant>:<upstream>`` registry keys, a failure budget each;
- scheduler jobs: ``<tenant>/<job>`` names, whose streaks reset together;
- watchdog, last-good payload, encoded-payload cache: one instance per
  TenantRuntime (tenancy/router.py).

Tenant names are checked against the arena's safe charset before they
become a path component.
"""
from __future__ import annotations

from kmamiz_tpu_torch.tenancy.arena import DEFAULT_TENANT, TenantNameError, valid_tenant


def _check(tenant: str) -> str:
    if tenant != DEFAULT_TENANT and not valid_tenant(tenant):
        raise TenantNameError(f"invalid tenant name: {tenant!r}")
    return tenant


def tenant_breaker(name: str, tenant: str = DEFAULT_TENANT, **kwargs):
    """The tenant's circuit breaker for an upstream (the default tenant
    shares the process-wide names)."""
    from kmamiz_tpu_torch.resilience.breaker import get_breaker

    return get_breaker(name, tenant=_check(tenant), **kwargs)


def tenant_quarantine(tenant: str = DEFAULT_TENANT):
    from kmamiz_tpu_torch.resilience.quarantine import quarantine_for

    return quarantine_for(_check(tenant))


def tenant_wal(tenant: str = DEFAULT_TENANT):
    """The tenant's env-configured ingest WAL (None when KMAMIZ_WAL is
    off)."""
    from kmamiz_tpu_torch.resilience.wal import IngestWAL

    return IngestWAL.from_env(tenant=_check(tenant))


def tenant_job_name(tenant: str, name: str) -> str:
    """A scheduler job's name in the tenant's namespace
    (server/scheduler.py applies it for register(..., tenant=...))."""
    _check(tenant)
    return name if tenant == DEFAULT_TENANT else f"{tenant}/{name}"


def reset_tenant(tenant: str) -> None:
    """Drop one tenant's resilience state (breakers, quarantine binding,
    job streaks) without touching any other tenant's."""
    from kmamiz_tpu_torch.resilience import breaker, metrics, quarantine

    _check(tenant)
    breaker.reset_tenant(tenant)
    quarantine.drop_tenant(tenant)
    metrics.reset_job_streaks(prefix=f"{tenant}/")

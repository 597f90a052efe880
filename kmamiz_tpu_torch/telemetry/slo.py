"""SLO scorecard: the handful of numbers that say whether serving is OK.

Counterpart of kmamiz_tpu/telemetry/slo.py: rolling tick-latency
percentiles (p50/p95/p99 over the last KMAMIZ_SLO_WINDOW ticks) plus
rates derived from registry counters: stale-serve rate, ingest-drop rate
and quarantine rate.

The JAX scorecard also reports the process's XLA recompile count from its
program registry. PyTorch compiles nothing per shape on the port's paths
and the port keeps no program registry, so the scorecard has no
`recompile_count`.

`TENANTS` keeps the per-tenant rows of the JAX package; the port serves
one tenant ("default") until its tenancy layer comes, so it holds one
row. The JAX package's KMAMIZ_MAX_TENANT_SERIES knob is the module
constant MAX_TENANT_SERIES at its default.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List

from kmamiz_tpu_torch.config import slo_window
from kmamiz_tpu_torch.telemetry.registry import REGISTRY

# scorecard counters: single source of truth shared with the resilience
# summary (resilience/metrics.py increments these same handles)
TICKS = REGISTRY.counter("kmamiz_ticks_total", "Collect ticks attempted")
STALE_SERVES = REGISTRY.counter(
    "kmamiz_stale_serves_total", "Ticks answered from the last-good graph"
)
INGEST_PAYLOADS = REGISTRY.counter(
    "kmamiz_ingest_payloads_total", "Raw ingest payloads accepted for parse"
)
INGEST_DROPPED = REGISTRY.counter(
    "kmamiz_ingest_dropped_total", "Ingest chunks dropped under backpressure"
)
QUARANTINED = REGISTRY.counter(
    "kmamiz_quarantined_total", "Payloads diverted to the quarantine"
)

#: the tenant of the port's one processor (the JAX DEFAULT_TENANT)
DEFAULT_TENANT = "default"
#: distinct tenant labels before the tail folds into "__other__"
MAX_TENANT_SERIES = 32


def percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over a pre-sorted sample."""
    if not sorted_vals:
        return 0.0
    k = max(0, min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[k]


class Scorecard:
    """Rolling tick-latency window + counter-derived rates."""

    def __init__(self) -> None:
        self._ticks_ms: deque = deque(maxlen=slo_window())
        self._lock = threading.Lock()

    def observe_tick(self, ms: float) -> None:
        with self._lock:
            self._ticks_ms.append(float(ms))

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            vals = sorted(self._ticks_ms)
        ticks = TICKS.value
        payloads = INGEST_PAYLOADS.value
        return {
            "tick_p50_ms": round(percentile(vals, 0.50), 3),
            "tick_p95_ms": round(percentile(vals, 0.95), 3),
            "tick_p99_ms": round(percentile(vals, 0.99), 3),
            "stale_serve_rate": round(STALE_SERVES.value / max(1.0, ticks), 6),
            "ingest_drop_rate": round(INGEST_DROPPED.value / max(1.0, payloads), 6),
            "quarantine_rate": round(QUARANTINED.value / max(1.0, payloads), 6),
        }

    def reset_for_tests(self) -> None:
        with self._lock:
            self._ticks_ms = deque(maxlen=slo_window())


SCORECARD = Scorecard()

# the scorecard's keys, and the direction in which each regresses
SLO_KEYS_HIGHER_IS_WORSE = (
    "tick_p50_ms",
    "tick_p95_ms",
    "tick_p99_ms",
    "stale_serve_rate",
    "ingest_drop_rate",
    "quarantine_rate",
)


# -- per-tenant SLO ----------------------------------------------------------

#: per-tenant tick/stale counter families; the tenant label value is
#: ALWAYS routed through tenant_label() so cardinality stays bounded
TENANT_TICKS = REGISTRY.counter_family(
    "kmamiz_tenant_ticks_total", "Collect ticks attempted, per tenant", ("tenant",)
)
TENANT_STALE_SERVES = REGISTRY.counter_family(
    "kmamiz_tenant_stale_serves_total",
    "Ticks answered from the tenant's last-good graph",
    ("tenant",),
)

_TENANT_SERIES_LOCK = threading.Lock()
# first-seen order of distinct tenant slugs; index < MAX_TENANT_SERIES
# keeps its own label, the tail folds into "__other__"
_TENANT_SLUGS: Dict[str, int] = {}

OTHER_TENANT_LABEL = "__other__"


def tenant_label(tenant: str) -> str:
    """The metric label value for a tenant: itself for the first
    MAX_TENANT_SERIES distinct tenants this process has seen, "__other__"
    for the tail."""
    with _TENANT_SERIES_LOCK:
        idx = _TENANT_SLUGS.get(tenant)
        if idx is None:
            idx = len(_TENANT_SLUGS)
            _TENANT_SLUGS[tenant] = idx
    return tenant if idx < MAX_TENANT_SERIES else OTHER_TENANT_LABEL


class TenantScorecards:
    """Per-tenant rolling scorecards + counter handles, acquired once per
    tenant label (cold path, under the lock) and cached: the per-tick
    observe is a dict hit plus a deque append."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._cards: Dict[str, Scorecard] = {}
        self._ticks: Dict[str, object] = {}
        self._stales: Dict[str, object] = {}

    def _slot(self, tenant: str):
        label = tenant_label(tenant)
        with self._lock:
            card = self._cards.get(label)
            if card is None:
                card = Scorecard()
                self._cards[label] = card
                self._ticks[label] = TENANT_TICKS.handle(label)
                self._stales[label] = TENANT_STALE_SERVES.handle(label)
            return label, card

    def observe_tick(self, tenant: str, ms: float) -> None:
        label, card = self._slot(tenant)
        card.observe_tick(ms)
        self._ticks[label].inc()

    def note_stale(self, tenant: str) -> None:
        label, _card = self._slot(tenant)
        self._stales[label].inc()

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """Per-tenant-label scorecard rows: tick percentiles + tick /
        stale-serve counts + stale rate."""
        with self._lock:
            cards = dict(self._cards)
        rows: Dict[str, Dict[str, float]] = {}
        for label, card in sorted(cards.items()):
            with card._lock:
                vals = sorted(card._ticks_ms)
            ticks = self._ticks[label].value
            stales = self._stales[label].value
            rows[label] = {
                "tick_p50_ms": round(percentile(vals, 0.50), 3),
                "tick_p95_ms": round(percentile(vals, 0.95), 3),
                "tick_p99_ms": round(percentile(vals, 0.99), 3),
                "ticks": ticks,
                "stale_serves": stales,
                "stale_serve_rate": round(stales / max(1.0, ticks), 6),
            }
        return rows

    def reset_for_tests(self) -> None:
        with self._lock:
            self._cards.clear()
            self._ticks.clear()
            self._stales.clear()
        with _TENANT_SERIES_LOCK:
            _TENANT_SLUGS.clear()


TENANTS = TenantScorecards()

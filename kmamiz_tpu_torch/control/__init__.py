"""graftpilot: the forecast-driven control plane.

Counterpart of kmamiz_tpu/control/. It closes the loop from the STLGT
forecast to a serving action with three levers, each a thin facade over a
pure decision core:

- predictive admission (control/admission.py): shed (429) or defer (serve
  the last good payload, marked ``deferred``) a tenant's low-priority
  ticks while its forecast p99 is over its SLO, with hysteresis;
- breaker warm-up (control/warmup.py): pre-trip the tenant's breakers
  while the forecast's edge attribution blames an upstream, and revert
  when it drops;
- tick scheduling (control/policy.py): order the TickRouter's gather
  window cheap-first by predicted cost.

Every decision is a pure function of (forecast, settings), computed at
the processor's hour fold (`on_fold`, under the ``control-decide`` span),
where the STLGT quantile forward runs on the processor's device: on the
card, one launch of the fused SDDMM/SpMM kernel (ops/sparse.py). The
serving edge only reads a stored verdict (`admission_verdict`: one switch
check and one dict lookup).

Switches, read from the environment as the JAX package reads them:
KMAMIZ_CONTROL=1 turns the plane on (off by default) and
KMAMIZ_CONTROL_MODE is defer (default) or shed. The tuning values are the
controller's settings, at the JAX defaults (module constants below) unless
`configure` gives others: the SLO, per-tenant SLOs, hysteresis, warm-up
gate, probe cooldown and horizon.
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field, replace
from typing import Dict, FrozenSet, Mapping, Optional, Tuple

from kmamiz_tpu_torch.control import admission, policy, warmup  # noqa: F401  (policy: the router's)
from kmamiz_tpu_torch.telemetry.profiling import events as prof_events
from kmamiz_tpu_torch.telemetry.registry import REGISTRY

#: forecast-p99 SLO, ms (KMAMIZ_CONTROL_SLO_MS's default)
SLO_MS = 250.0
#: consecutive breaching (or clear) evaluations to enter (or leave)
#: shedding (KMAMIZ_CONTROL_HYSTERESIS's default)
HYSTERESIS = 2
#: attribution score that arms breaker warm-up (KMAMIZ_CONTROL_WARMUP_GATE)
WARMUP_GATE = 0.5
#: shortened probe window of a warmed breaker, s (KMAMIZ_CONTROL_PROBE_S)
PROBE_S = 1.0
#: hours ahead admission judges (KMAMIZ_CONTROL_HORIZON), clamped to the
#: forecast route's KMAMIZ_STLGT_HORIZON_MAX
HORIZON = 1

# -- metrics: every handle made at import (the admission read runs on the
# serving edge) ---------------------------------------------------------------
_ADMISSION_FAMILY = REGISTRY.counter_family(
    "kmamiz_control_admission_total", "Tick admission outcomes decided at the serving edge", ("action",)
)
_ADMISSION_HANDLES = {
    action: _ADMISSION_FAMILY.handle(action) for action in (admission.ALLOW, admission.DEFER, admission.SHED)
}
WARMUPS = REGISTRY.counter(
    "kmamiz_control_warmups_total", "Breakers proactively warmed (pre-tripped half-open) by attribution"
)
WARMUP_REVERTS = REGISTRY.counter(
    "kmamiz_control_warmup_reverts_total", "Warmed breakers reverted after attribution mass dropped"
)
SHEDDING_TENANTS = REGISTRY.gauge(
    "kmamiz_control_shedding_tenants", "Tenants currently in the shed/defer admission posture"
)
PREVENTED_VIOLATIONS = REGISTRY.gauge(
    "kmamiz_control_prevented_violations", "SLO violations prevented in the last counterfactual run (ON vs OFF)"
)
DECIDE_MS = REGISTRY.histogram(
    "kmamiz_control_decide_ms", "Controller decision latency per forecast ingest (fold boundary)"
)


def enabled() -> bool:
    """The master switch: KMAMIZ_CONTROL=1 (off by default)."""
    return os.environ.get("KMAMIZ_CONTROL", "0") not in ("0", "false", "")


def mode() -> str:
    """KMAMIZ_CONTROL_MODE: defer (serve the last good payload, marked) or
    shed (429)."""
    got = os.environ.get("KMAMIZ_CONTROL_MODE", admission.DEFER).lower()
    return got if got in admission.MODES else admission.DEFER


@dataclass(frozen=True)
class Settings:
    """The controller's tuning values; `tenant_slo_ms` overrides the SLO
    for the tenants it names."""

    slo_ms: float = SLO_MS
    hysteresis: int = HYSTERESIS
    warmup_gate: float = WARMUP_GATE
    probe_s: float = PROBE_S
    horizon: int = HORIZON
    tenant_slo_ms: Mapping[str, float] = field(default_factory=dict)


@dataclass(frozen=True)
class ForecastView:
    """The controller's sole input: one tenant's forecast, reduced to what
    the three levers need. Built from an STLGT forward at the fold
    (`on_fold`) or given directly (`ingest_forecast`)."""

    tenant: str
    p99_ms: float  # worst endpoint forecast p99 at the control horizon
    cost_ms: float  # total predicted latency mass (scheduling policy)
    attributions: Tuple[warmup.Attribution, ...] = field(default=())
    version: int = 0  # STLGT params version (observability only)


class Controller:
    """The process's decision store. `ingest` runs the pure cores and
    swaps the per-tenant states under a lock; readers take the lock for
    one dict lookup. Breaker warm-up's side effects run inside `ingest`,
    at fold cadence."""

    def __init__(self, settings: Optional[Settings] = None) -> None:
        self.settings = settings or Settings()
        self._lock = threading.Lock()
        self._admission: Dict[str, admission.AdmissionState] = {}
        self._costs: Dict[str, float] = {}
        self._warmed: Dict[str, FrozenSet[str]] = {}
        self._ingests = 0

    def slo_ms(self, tenant: Optional[str] = None) -> float:
        return float(self.settings.tenant_slo_ms.get(tenant, self.settings.slo_ms))

    def ingest(self, view: ForecastView) -> dict:
        t0 = prof_events.now_ms()
        cfg = self.settings
        adm_cfg = admission.AdmissionConfig(
            slo_ms=self.slo_ms(view.tenant), hysteresis=max(1, int(cfg.hysteresis)), mode=mode()
        )
        warm_cfg = warmup.WarmupConfig(gate_threshold=cfg.warmup_gate, probe_cooldown_s=cfg.probe_s)
        warm_decision = warmup.evaluate(view.attributions, warm_cfg)
        with self._lock:
            prev = self._admission.get(view.tenant)
            prev_warm = self._warmed.get(view.tenant, frozenset())
        state = admission.step(prev, view.p99_ms, adm_cfg)
        warmed = warmup.apply(view.tenant, warm_decision, warm_cfg, prev_warm)
        with self._lock:
            self._admission[view.tenant] = state
            self._costs[view.tenant] = float(view.cost_ms)
            self._warmed[view.tenant] = warmed
            self._ingests += 1
            shedding = sum(1 for s in self._admission.values() if s.active)
        newly_warmed = warmed - prev_warm
        reverted = prev_warm - warmed
        if newly_warmed:
            WARMUPS.inc(len(newly_warmed))
        if reverted:
            WARMUP_REVERTS.inc(len(reverted))
        SHEDDING_TENANTS.set(float(shedding))
        DECIDE_MS.observe(prof_events.now_ms() - t0)
        return {
            "tenant": view.tenant,
            "action": state.action,
            "active": state.active,
            "forecastP99Ms": round(state.forecast_p99_ms, 3),
            "sloMs": state.slo_ms,
            "warmed": sorted(warmed),
            "attributionMass": round(warm_decision.mass, 4),
        }

    def admission_state(self, tenant: str) -> Optional[admission.AdmissionState]:
        with self._lock:
            return self._admission.get(tenant)

    def predicted_costs(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._costs)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "ingests": self._ingests,
                "tenants": {
                    t: {
                        **s.as_dict(),
                        "predictedCostMs": round(self._costs.get(t, 0.0), 3),
                        "warmedBreakers": sorted(self._warmed.get(t, frozenset())),
                    }
                    for t, s in sorted(self._admission.items())
                },
            }


_CONTROLLER: Optional[Controller] = None
_CONTROLLER_LOCK = threading.Lock()


def get_controller() -> Controller:
    global _CONTROLLER
    with _CONTROLLER_LOCK:
        if _CONTROLLER is None:
            _CONTROLLER = Controller()
        return _CONTROLLER


def configure(**values) -> Settings:
    """Set the process controller's tuning values (the fields of
    Settings: slo_ms, tenant_slo_ms, hysteresis, warmup_gate, probe_s,
    horizon); the rest keep theirs. Decisions already stored stay."""
    ctl = get_controller()
    ctl.settings = replace(ctl.settings, **values)
    return ctl.settings


def slo_ms(tenant: Optional[str] = None) -> float:
    """The forecast-p99 SLO of `tenant` (its override, else the base)."""
    return get_controller().slo_ms(tenant)


def hysteresis_ticks() -> int:
    return max(1, int(get_controller().settings.hysteresis))


def control_horizon() -> int:
    """The horizon admission judges, clamped to the forecast route's
    KMAMIZ_STLGT_HORIZON_MAX."""
    from kmamiz_tpu_torch.models import stlgt

    return max(1, min(int(get_controller().settings.horizon), stlgt.horizon_max()))


def reset_for_tests() -> None:
    """Drop the controller: admission states, costs, warmed breakers and
    settings start clean."""
    global _CONTROLLER
    with _CONTROLLER_LOCK:
        _CONTROLLER = None


def ingest_forecast(view: ForecastView) -> dict:
    """The decision entry: one control evaluation for one tenant (the
    fold hook and direct callers alike)."""
    return get_controller().ingest(view)


def predicted_costs() -> Dict[str, float]:
    """The latest per-tenant predicted costs; empty before any ingest."""
    ctl = _CONTROLLER
    return ctl.predicted_costs() if ctl is not None else {}


def snapshot() -> dict:
    """The controller's posture, for /timings."""
    ctl = _CONTROLLER
    base = {"enabled": enabled(), "mode": mode()}
    if ctl is None:
        return {**base, "ingests": 0, "tenants": {}}
    return {**base, **ctl.snapshot()}


def admission_verdict(tenant: str, request: object) -> Optional[dict]:
    """The serving edge's read: None admits; otherwise a verdict with
    action defer or shed. A tick with ``"priority": "high"`` always
    passes."""
    if not enabled():
        return None
    ctl = _CONTROLLER
    if ctl is None:  # nothing decided yet: admit
        return None
    state = ctl.admission_state(tenant)
    if state is None or not state.active:
        _ADMISSION_HANDLES[admission.ALLOW].inc()
        return None
    if isinstance(request, dict) and str(request.get("priority", "")).lower() == "high":
        _ADMISSION_HANDLES[admission.ALLOW].inc()
        return None
    _ADMISSION_HANDLES[state.action].inc()
    return {
        "action": state.action,
        "forecastP99Ms": round(state.forecast_p99_ms, 3),
        "sloMs": state.slo_ms,
    }


# -- the fold hook: forecast snapshot -> view -> decisions ---------------------


def view_from_forecast(
    tenant: str, q_ms, gate, snap: dict, version: int = 0, horizon: Optional[int] = None
) -> ForecastView:
    """Reduce an STLGT quantile forward to a ForecastView: the worst
    endpoint p99 (widened by sqrt(horizon), the forecast route's rule),
    the tenant's total predicted latency mass, and the top attribution
    edges above zero. numpy on host arrays."""
    import numpy as np

    q_ms = np.asarray(q_ms, dtype=np.float32)
    h = control_horizon() if horizon is None else max(1, int(horizon))
    p99 = q_ms[:, 2]
    if h > 1:
        p99 = q_ms[:, 0] + (p99 - q_ms[:, 0]) * float(np.sqrt(h))
    p99 = np.clip(p99, 0.0, None)
    names = snap["names"]
    n = len(names)
    edge_mask = np.asarray(snap["mask"], dtype=bool)
    src_ids = np.asarray(snap["src"])
    dst_ids = np.asarray(snap["dst"])
    gate = np.asarray(gate, dtype=np.float32)
    attributions = []
    for e in np.argsort(-gate):
        if len(attributions) >= 20:
            break
        e = int(e)
        if not edge_mask[e] or gate[e] <= 0.0:
            continue
        s, d = int(src_ids[e]), int(dst_ids[e])
        if s >= n or d >= n:
            continue
        attributions.append((str(names[s]), str(names[d]), float(gate[e])))
    return ForecastView(
        tenant=tenant,
        p99_ms=float(p99.max()) if p99.size else 0.0,
        cost_ms=policy.predicted_cost_ms(p99[:n].tolist()),
        attributions=tuple(attributions),
        version=int(version),
    )


def on_fold(tenant: str, snap: Optional[dict]) -> Optional[dict]:
    """The fold's recompute: run the live STLGT forward over the freshly
    published forecast snapshot (on the trainer's device) and ingest the
    view. A no-op unless the plane is on and the trainer has params."""
    if not enabled() or snap is None:
        return None
    from kmamiz_tpu_torch.models import stlgt
    from kmamiz_tpu_torch.models.stlgt import serving as stlgt_serving
    from kmamiz_tpu_torch.telemetry.tracing import phase_span

    live = stlgt.serving_params()
    if live is None:
        return None
    with phase_span("control-decide"):
        q_ms, _prob, gate = stlgt_serving.quantile_forward(
            live["params"], snap["features"], snap["src"], snap["dst"], snap["mask"], live["model"]
        )
        view = view_from_forecast(tenant or "default", q_ms, gate, snap, version=live["version"])
        return ingest_forecast(view)

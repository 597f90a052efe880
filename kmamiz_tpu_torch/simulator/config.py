"""Simulation-config parsing, validation, and preprocessing.

Equivalent of the reference's SimulationConfigManager + the three zod
schemas + three validators + three preprocessors
(KMamiz src/MicroViSim-simulator/classes/SimulationConfigManager.ts,
entities/TSimConfig*.ts, SimConfigValidator/*, SimConfigPreprocessor/*).

The YAML is parsed with pyyaml and checked by a hand-rolled schema walker
(the image has no zod equivalent); semantic validation (duplicates,
undefined ids, cycles, probability sums) and preprocessing (unique-name
assignment, body normalization, fault-target expansion) mirror the
reference checks and their error-message format:

    [Location] <path>  [Error] <message>
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Set, Tuple

import yaml

from kmamiz_tpu_torch.simulator import bodies, naming

REQUEST_TYPES = {
    "get", "post", "put", "patch", "delete", "head", "options", "connect", "trace",
}
FALLBACK_STRATEGIES = (
    "failIfAnyDependentFail",
    "failIfAllDependentFail",
    "ignoreDependentFail",
)
MAX_SIMULATION_DAYS = 7

ValidationError = Dict[str, str]  # {"errorLocation": ..., "message": ...}


def _err(location: str, message: str) -> ValidationError:
    return {"errorLocation": location, "message": message}


def _format_errors(header: str, errors: List[ValidationError]) -> str:
    lines = [header]
    for e in errors:
        if e["errorLocation"]:
            lines.append(f"[Location] {e['errorLocation']}  [Error] {e['message']}")
        else:
            lines.append(e["message"])
    return "\n---\n".join(lines)


def _is_number(value) -> bool:
    """Numeric YAML scalar check; bool is an int subclass and must not pass."""
    return isinstance(value, (int, float)) and not isinstance(value, bool)


def _is_int(value) -> bool:
    """Integer YAML scalar check, excluding bool."""
    return isinstance(value, int) and not isinstance(value, bool)



# ---------------------------------------------------------------------------
# schema validation (zod-equivalent structural checks with defaults)
# ---------------------------------------------------------------------------

class _SchemaErrors(Exception):
    def __init__(self, errors: List[ValidationError]) -> None:
        super().__init__("schema validation failed")
        self.errors = errors


class _Walker:
    def __init__(self) -> None:
        self.errors: List[ValidationError] = []

    def fail(self, loc: str, message: str) -> None:
        self.errors.append(_err(loc, message))

    def strict_keys(self, obj: dict, allowed: Set[str], loc: str) -> None:
        for key in obj:
            if key not in allowed:
                self.fail(f"{loc}.{key}", f'Unrecognized key "{key}".')

    def require(self, obj: dict, key: str, kind, loc: str):
        if key not in obj:
            self.fail(f"{loc}.{key}", "Required.")
            return None
        value = obj[key]
        if kind is not None and not isinstance(value, kind):
            self.fail(f"{loc}.{key}", f"Invalid type for {key}.")
            return None
        return value

    def forbid_system_fields(self, obj: dict, loc: str) -> None:
        for field in ("uniqueServiceName", "uniqueEndpointName"):
            if obj.get(field) is not None:
                self.fail(
                    f"{loc}.{field}",
                    f"{field} is a system-generated field. It should not be provided.",
                )


def _norm_endpoint_id(value, walker: _Walker, loc: str) -> Optional[str]:
    if isinstance(value, (int, float)):
        value = str(value)
    if not isinstance(value, str) or not value.strip():
        walker.fail(loc, "endpointId cannot be empty.")
        return None
    return value.strip()


def _norm_version(value) -> str:
    if isinstance(value, (int, float)):
        return str(value)
    if value is None or (isinstance(value, str) and not value.strip()):
        return "latest"
    return str(value).strip()


def _norm_status(value, walker: _Walker, loc: str) -> Optional[str]:
    try:
        num = int(str(value))
    except (TypeError, ValueError):
        num = -1
    if not (100 <= num <= 599):
        walker.fail(loc, "Invalid status. It must be between 100 and 599.")
        return None
    return str(num)


def _walk_services_info(raw, walker: _Walker) -> List[dict]:
    if not isinstance(raw, list):
        walker.fail("servicesInfo", "Expected array.")
        return []
    namespaces = []
    for i, ns in enumerate(raw):
        loc = f"servicesInfo[{i}]"
        if not isinstance(ns, dict):
            walker.fail(loc, "Expected object.")
            continue
        walker.strict_keys(ns, {"namespace", "services"}, loc)
        namespace = walker.require(ns, "namespace", str, loc)
        services_raw = walker.require(ns, "services", list, loc) or []
        services = []
        for j, svc in enumerate(services_raw):
            sloc = f"{loc}.services[{j}]"
            if not isinstance(svc, dict):
                walker.fail(sloc, "Expected object.")
                continue
            walker.strict_keys(svc, {"serviceName", "versions"}, sloc)
            name = walker.require(svc, "serviceName", str, sloc)
            if name is not None and not name:
                walker.fail(f"{sloc}.serviceName", "service name cannot be empty.")
            versions = []
            for k, ver in enumerate(walker.require(svc, "versions", list, sloc) or []):
                vloc = f"{sloc}.versions[{k}]"
                if not isinstance(ver, dict):
                    walker.fail(vloc, "Expected object.")
                    continue
                walker.strict_keys(
                    ver,
                    {"uniqueServiceName", "version", "replica", "endpoints"},
                    vloc,
                )
                walker.forbid_system_fields(ver, vloc)
                replica = ver.get("replica", 1)
                if not _is_int(replica):
                    walker.fail(f"{vloc}.replica", "replica must be an integer.")
                    replica = 1
                elif replica < 0:
                    walker.fail(
                        f"{vloc}.replica",
                        "replica (the number of service instances) must be at "
                        "least 0 to simulate injection.",
                    )
                endpoints = []
                for m, ep in enumerate(
                    walker.require(ver, "endpoints", list, vloc) or []
                ):
                    eloc = f"{vloc}.endpoints[{m}]"
                    if not isinstance(ep, dict):
                        walker.fail(eloc, "Expected object.")
                        continue
                    walker.strict_keys(
                        ep,
                        {"uniqueEndpointName", "endpointId", "endpointInfo", "datatype"},
                        eloc,
                    )
                    walker.forbid_system_fields(ep, eloc)
                    endpoint_id = _norm_endpoint_id(
                        ep.get("endpointId"), walker, f"{eloc}.endpointId"
                    )
                    info_raw = walker.require(ep, "endpointInfo", dict, eloc) or {}
                    walker.strict_keys(info_raw, {"path", "method"}, f"{eloc}.endpointInfo")
                    path = info_raw.get("path")
                    if not isinstance(path, str) or not path:
                        walker.fail(f"{eloc}.endpointInfo.path", "path cannot not be empty.")
                        path = "/"
                    method = info_raw.get("method")
                    if not isinstance(method, str) or method.lower() not in REQUEST_TYPES:
                        walker.fail(f"{eloc}.endpointInfo.method", "Invalid method.")
                        method = "get"
                    datatype = None
                    if ep.get("datatype") is not None:
                        dt = ep["datatype"]
                        dloc = f"{eloc}.datatype"
                        if not isinstance(dt, dict):
                            walker.fail(dloc, "Expected object.")
                            dt = {}
                        walker.strict_keys(
                            dt,
                            {"requestContentType", "requestBody", "responses"},
                            dloc,
                        )
                        responses = []
                        for r, resp in enumerate(
                            walker.require(dt, "responses", list, dloc) or []
                        ):
                            rloc = f"{dloc}.responses[{r}]"
                            if not isinstance(resp, dict):
                                walker.fail(rloc, "Expected object.")
                                continue
                            walker.strict_keys(
                                resp,
                                {"status", "responseContentType", "responseBody"},
                                rloc,
                            )
                            status = _norm_status(
                                resp.get("status"), walker, f"{rloc}.status"
                            )
                            responses.append(
                                {
                                    "status": status,
                                    "responseContentType": resp.get(
                                        "responseContentType", ""
                                    ),
                                    "responseBody": str(
                                        resp.get("responseBody", "")
                                    ),
                                }
                            )
                        datatype = {
                            "requestContentType": walker.require(
                                dt, "requestContentType", str, dloc
                            )
                            or "",
                            "requestBody": str(dt.get("requestBody", "")),
                            "responses": responses,
                        }
                    endpoints.append(
                        {
                            "endpointId": endpoint_id,
                            "endpointInfo": {"path": path, "method": method},
                            "datatype": datatype,
                            "uniqueEndpointName": None,
                        }
                    )
                versions.append(
                    {
                        "version": _norm_version(ver.get("version")),
                        "replica": max(0, replica),
                        "endpoints": endpoints,
                        "uniqueServiceName": None,
                    }
                )
            services.append({"serviceName": name or "", "versions": versions})
        namespaces.append({"namespace": namespace or "", "services": services})
    return namespaces


def _walk_depend_on_entry(dep, walker: _Walker, loc: str) -> Optional[dict]:
    """Normalize one dependOn entry into {"oneOf": [...]} or a plain target."""
    if not isinstance(dep, dict):
        walker.fail(loc, "Expected object.")
        return None
    if "oneOf" in dep:
        walker.strict_keys(dep, {"oneOf"}, loc)
        members = []
        for i, one in enumerate(dep.get("oneOf") or []):
            oloc = f"{loc}.oneOf[{i}]"
            if not isinstance(one, dict):
                walker.fail(oloc, "Expected object.")
                continue
            walker.strict_keys(
                one, {"uniqueEndpointName", "endpointId", "callProbability"}, oloc
            )
            walker.forbid_system_fields(one, oloc)
            prob = one.get("callProbability")
            if not _is_number(prob):
                walker.fail(
                    oloc, "Invalid callProbability. It must be between 0 and 100."
                )
                prob = 0.0
            elif not (0 <= prob <= 100):
                walker.fail(
                    oloc, "Invalid callProbability. It must be between 0 and 100."
                )
                prob = 0.0
            members.append(
                {
                    "endpointId": _norm_endpoint_id(
                        one.get("endpointId"), walker, f"{oloc}.endpointId"
                    ),
                    "callProbability": float(prob),
                    "uniqueEndpointName": None,
                }
            )
        return {"oneOf": members}
    walker.strict_keys(
        dep, {"uniqueEndpointName", "endpointId", "callProbability"}, loc
    )
    walker.forbid_system_fields(dep, loc)
    prob = dep.get("callProbability")
    if prob is not None:
        if (
            not _is_number(prob)
            or not (0 <= prob <= 100)
        ):
            walker.fail(loc, "Invalid callProbability. It must be between 0 and 100.")
            prob = None
    return {
        "endpointId": _norm_endpoint_id(
            dep.get("endpointId"), walker, f"{loc}.endpointId"
        ),
        "callProbability": float(prob) if prob is not None else None,
        "uniqueEndpointName": None,
    }


def _walk_endpoint_dependencies(raw, walker: _Walker) -> List[dict]:
    if not isinstance(raw, list):
        walker.fail("endpointDependencies", "Expected array.")
        return []
    out = []
    for i, dep in enumerate(raw):
        loc = f"endpointDependencies[{i}]"
        if not isinstance(dep, dict):
            walker.fail(loc, "Expected object.")
            continue
        walker.strict_keys(
            dep,
            {"uniqueEndpointName", "isExternal", "endpointId", "dependOn"},
            loc,
        )
        walker.forbid_system_fields(dep, loc)
        depend_on = []
        for j, entry in enumerate(walker.require(dep, "dependOn", list, loc) or []):
            norm = _walk_depend_on_entry(entry, walker, f"{loc}.dependOn[{j}]")
            if norm is not None:
                depend_on.append(norm)
        out.append(
            {
                "endpointId": _norm_endpoint_id(
                    dep.get("endpointId"), walker, f"{loc}.endpointId"
                ),
                "isExternal": bool(dep.get("isExternal", False)),
                "dependOn": depend_on,
                "uniqueEndpointName": None,
            }
        )
    return out


def _walk_fault_targets(
    raw, walker: _Walker, loc: str, allow_endpoints: bool
) -> dict:
    targets = {"services": [], "endpoints": []}
    if not isinstance(raw, dict):
        walker.fail(loc, "Expected object.")
        return targets
    allowed = {"services"} | ({"endpoints"} if allow_endpoints else set())
    walker.strict_keys(raw, allowed, loc)
    for i, svc in enumerate(raw.get("services") or []):
        sloc = f"{loc}.services[{i}]"
        if not isinstance(svc, dict):
            walker.fail(sloc, "Expected object.")
            continue
        walker.strict_keys(
            svc, {"uniqueServiceName", "serviceName", "namespace", "version"}, sloc
        )
        walker.forbid_system_fields(svc, sloc)
        name = walker.require(svc, "serviceName", str, sloc)
        if name is not None and not name:
            walker.fail(f"{sloc}.serviceName", "serviceName cannot be empty.")
        namespace = walker.require(svc, "namespace", str, sloc)
        if namespace is not None and not namespace:
            walker.fail(f"{sloc}.namespace", "namespace cannot be empty.")
        targets["services"].append(
            {
                "serviceName": name or "",
                "namespace": namespace or "",
                "version": _norm_version(svc["version"]) if "version" in svc else None,
                "uniqueServiceName": None,
            }
        )
    for i, ep in enumerate(raw.get("endpoints") or [] if allow_endpoints else []):
        eloc = f"{loc}.endpoints[{i}]"
        if not isinstance(ep, dict):
            walker.fail(eloc, "Expected object.")
            continue
        walker.strict_keys(ep, {"uniqueEndpointName", "endpointId"}, eloc)
        walker.forbid_system_fields(ep, eloc)
        targets["endpoints"].append(
            {
                "endpointId": _norm_endpoint_id(
                    ep.get("endpointId"), walker, f"{eloc}.endpointId"
                ),
                "uniqueEndpointName": None,
            }
        )
    return targets


def _walk_time_periods(raw, walker: _Walker, loc: str) -> List[dict]:
    if not isinstance(raw, list) or not raw:
        walker.fail(loc, "At least one time period is required.")
        return []
    periods = []
    for i, tp in enumerate(raw):
        ploc = f"{loc}[{i}]"
        if not isinstance(tp, dict):
            walker.fail(ploc, "Expected object.")
            continue
        walker.strict_keys(
            tp, {"startTime", "durationHours", "probabilityPercent"}, ploc
        )
        start = tp.get("startTime")
        day, hour = 1, 0
        if not isinstance(start, dict):
            walker.fail(f"{ploc}.startTime", "Expected object.")
        else:
            day = start.get("day")
            hour = start.get("hour")
            if not _is_int(day) or not (1 <= day <= 7):
                walker.fail(f"{ploc}.startTime.day", "day must be an integer in 1..7.")
                day = 1
            if not _is_int(hour) or not (0 <= hour <= 23):
                walker.fail(f"{ploc}.startTime.hour", "hour must be an integer in 0..23.")
                hour = 0
        duration = tp.get("durationHours")
        if not _is_int(duration) or duration < 1:
            walker.fail(f"{ploc}.durationHours", "durationHours must be an integer >= 1.")
            duration = 1
        prob = tp.get("probabilityPercent", 100)
        if not _is_number(prob) or not (0 <= prob <= 100):
            walker.fail(
                f"{ploc}.probabilityPercent",
                "probabilityPercent must be between 0 and 100.",
            )
            prob = 100
        periods.append(
            {
                "startTime": {"day": day, "hour": hour},
                "durationHours": duration,
                "probabilityPercent": float(prob),
            }
        )
    return periods


_FAULT_TYPES = {
    "increase-latency",
    "increase-error-rate",
    "inject-traffic",
    "reduce-instance",
}


def _walk_faults(raw, walker: _Walker) -> List[dict]:
    faults = []
    for i, fault in enumerate(raw or []):
        loc = f"loadSimulation.faultInjection[{i}]"
        if not isinstance(fault, dict):
            walker.fail(loc, "Expected object.")
            continue
        ftype = fault.get("type")
        if ftype not in _FAULT_TYPES:
            walker.fail(f"{loc}.type", f'Invalid fault type "{ftype}".')
            continue
        allow_endpoints = ftype != "reduce-instance"
        base_keys = {"type", "targets", "timePeriods"}
        extra_keys = {
            "increase-latency": {"increaseLatencyMs"},
            "increase-error-rate": {"increaseErrorRatePercent"},
            "inject-traffic": {"increaseRequestCount", "requestMultiplier"},
            "reduce-instance": {"reduceCount"},
        }[ftype]
        walker.strict_keys(fault, base_keys | extra_keys, loc)
        out = {
            "type": ftype,
            "targets": _walk_fault_targets(
                fault.get("targets"), walker, f"{loc}.targets", allow_endpoints
            ),
            "timePeriods": _walk_time_periods(
                fault.get("timePeriods"), walker, f"{loc}.timePeriods"
            ),
        }
        if ftype == "increase-latency":
            v = fault.get("increaseLatencyMs")
            if not _is_number(v) or v < 0:
                walker.fail(f"{loc}.increaseLatencyMs", "increaseLatencyMs must be zero or greater.")
                v = 0
            out["increaseLatencyMs"] = float(v)
        elif ftype == "increase-error-rate":
            v = fault.get("increaseErrorRatePercent")
            if not _is_number(v) or not (0 <= v <= 100):
                walker.fail(
                    f"{loc}.increaseErrorRatePercent",
                    "Invalid increaseErrorRatePercent. It must be between 0 and 100.",
                )
                v = 0
            out["increaseErrorRatePercent"] = float(v)
        elif ftype == "inject-traffic":
            count = fault.get("increaseRequestCount")
            mult = fault.get("requestMultiplier")
            if (count is None) == (mult is None):
                walker.fail(
                    loc,
                    "Exactly one of the fields increaseRequestCount or "
                    "requestMultiplier must be set.",
                )
            if count is not None and (not _is_int(count) or count < 1):
                walker.fail(
                    f"{loc}.increaseRequestCount",
                    "increaseRequestCount must be at least 1.",
                )
                count = None
            if mult is not None and (
                not _is_number(mult) or mult <= 0
            ):
                walker.fail(
                    f"{loc}.requestMultiplier", "requestMultiplier must be greater than 0."
                )
                mult = None
            out["increaseRequestCount"] = count
            out["requestMultiplier"] = float(mult) if mult is not None else None
        elif ftype == "reduce-instance":
            v = fault.get("reduceCount")
            if not _is_int(v) or v < 1:
                walker.fail(f"{loc}.reduceCount", "reduceCount must be an integer >= 1.")
                v = 1
            out["reduceCount"] = v
        faults.append(out)
    return faults


def _walk_load_simulation(raw, walker: _Walker) -> Optional[dict]:
    if raw is None:
        return None
    loc = "loadSimulation"
    if not isinstance(raw, dict):
        walker.fail(loc, "Expected object.")
        return None
    walker.strict_keys(
        raw, {"config", "serviceMetrics", "endpointMetrics", "faultInjection"}, loc
    )

    config_raw = raw.get("config") or {}
    cloc = f"{loc}.config"
    if not isinstance(config_raw, dict):
        walker.fail(cloc, "Expected object.")
        config_raw = {}
    walker.strict_keys(
        config_raw,
        {"simulationDurationInDays", "overloadErrorRateIncreaseFactor"},
        cloc,
    )
    days = config_raw.get("simulationDurationInDays", 1)
    if not _is_int(days):
        walker.fail(f"{cloc}.simulationDurationInDays", "simulationDurationInDays must be an integer.")
        days = 1
    elif days < 1:
        walker.fail(f"{cloc}.simulationDurationInDays", "simulationDurationInDays must be at least 1.")
        days = 1
    elif days > MAX_SIMULATION_DAYS:
        walker.fail(
            f"{cloc}.simulationDurationInDays",
            f"simulationDurationInDays cannot exceed {MAX_SIMULATION_DAYS}.",
        )
        days = MAX_SIMULATION_DAYS
    factor = config_raw.get("overloadErrorRateIncreaseFactor", 3)
    if not _is_number(factor) or not (0 <= factor <= 10):
        walker.fail(
            f"{cloc}.overloadErrorRateIncreaseFactor",
            "Invalid overloadErrorRateIncreaseFactor. It must be between 0 and 10.",
        )
        factor = 3

    service_metrics = []
    for i, ns in enumerate(raw.get("serviceMetrics") or []):
        nloc = f"{loc}.serviceMetrics[{i}]"
        if not isinstance(ns, dict):
            walker.fail(nloc, "Expected object.")
            continue
        walker.strict_keys(ns, {"namespace", "services"}, nloc)
        services = []
        for j, svc in enumerate(ns.get("services") or []):
            sloc = f"{nloc}.services[{j}]"
            if not isinstance(svc, dict):
                walker.fail(sloc, "Expected object.")
                continue
            walker.strict_keys(svc, {"serviceName", "versions"}, sloc)
            name = walker.require(svc, "serviceName", str, sloc)
            if name is not None and not name:
                walker.fail(f"{sloc}.serviceName", "serviceName cannot be empty.")
            versions = []
            for k, ver in enumerate(svc.get("versions") or []):
                vloc = f"{sloc}.versions[{k}]"
                if not isinstance(ver, dict):
                    walker.fail(vloc, "Expected object.")
                    continue
                walker.strict_keys(
                    ver, {"uniqueServiceName", "version", "capacityPerReplica"}, vloc
                )
                walker.forbid_system_fields(ver, vloc)
                cap = ver.get("capacityPerReplica", 1)
                if not _is_number(cap) or cap < 0.01:
                    walker.fail(
                        f"{vloc}.capacityPerReplica",
                        "capacityPerReplica must be at least 0.01.",
                    )
                    cap = 1
                versions.append(
                    {
                        "version": _norm_version(ver.get("version")),
                        "capacityPerReplica": float(cap),
                        "uniqueServiceName": None,
                    }
                )
            services.append({"serviceName": name or "", "versions": versions})
        service_metrics.append({"namespace": ns.get("namespace", ""), "services": services})

    endpoint_metrics = []
    for i, metric in enumerate(raw.get("endpointMetrics") or []):
        mloc = f"{loc}.endpointMetrics[{i}]"
        if not isinstance(metric, dict):
            walker.fail(mloc, "Expected object.")
            continue
        walker.strict_keys(
            metric,
            {
                "uniqueEndpointName",
                "endpointId",
                "delay",
                "errorRatePercent",
                "expectedExternalDailyRequestCount",
                "fallbackStrategy",
            },
            mloc,
        )
        walker.forbid_system_fields(metric, mloc)
        delay_raw = metric.get("delay") or {}
        if not isinstance(delay_raw, dict):
            walker.fail(f"{mloc}.delay", "Expected object.")
            delay_raw = {}
        walker.strict_keys(delay_raw, {"latencyMs", "jitterMs"}, f"{mloc}.delay")
        latency_ms = delay_raw.get("latencyMs", 0)
        if not _is_number(latency_ms) or latency_ms < 0:
            walker.fail(f"{mloc}.delay.latencyMs", "latencyMs must be zero or greater.")
            latency_ms = 0
        jitter_ms = delay_raw.get("jitterMs", 0)
        if not _is_number(jitter_ms) or jitter_ms < 0:
            walker.fail(f"{mloc}.delay.jitterMs", "jitterMs must be zero or greater.")
            jitter_ms = 0
        error_rate = metric.get("errorRatePercent", 0)
        if not _is_number(error_rate) or not (0 <= error_rate <= 100):
            walker.fail(
                f"{mloc}.errorRatePercent",
                "Invalid errorRate. It must be between 0 and 100.",
            )
            error_rate = 0
        daily = metric.get("expectedExternalDailyRequestCount", 0)
        if not _is_int(daily):
            walker.fail(
                f"{mloc}.expectedExternalDailyRequestCount",
                "expectedExternalDailyRequestCount must be an integer.",
            )
            daily = 0
        elif daily < 0:
            walker.fail(
                f"{mloc}.expectedExternalDailyRequestCount",
                "expectedExternalDailyRequestCount cannot be negative.",
            )
            daily = 0
        fallback = metric.get("fallbackStrategy", FALLBACK_STRATEGIES[0])
        if fallback not in FALLBACK_STRATEGIES:
            walker.fail(f"{mloc}.fallbackStrategy", f'Invalid fallbackStrategy "{fallback}".')
            fallback = FALLBACK_STRATEGIES[0]
        endpoint_metrics.append(
            {
                "endpointId": _norm_endpoint_id(
                    metric.get("endpointId"), walker, f"{mloc}.endpointId"
                ),
                "delay": {"latencyMs": float(latency_ms), "jitterMs": float(jitter_ms)},
                "errorRatePercent": float(error_rate),
                "expectedExternalDailyRequestCount": daily,
                "fallbackStrategy": fallback,
                "uniqueEndpointName": None,
            }
        )

    return {
        "config": {
            "simulationDurationInDays": days,
            "overloadErrorRateIncreaseFactor": float(factor),
        },
        "serviceMetrics": service_metrics,
        "endpointMetrics": endpoint_metrics,
        "faultInjection": _walk_faults(raw.get("faultInjection"), walker),
    }


def validate_schema(raw: Any) -> Tuple[List[ValidationError], Optional[dict]]:
    """Structural validation + normalization of the parsed YAML document."""
    walker = _Walker()
    if not isinstance(raw, dict):
        return [_err("", "Top-level YAML document must be a mapping.")], None
    walker.strict_keys(
        raw, {"servicesInfo", "endpointDependencies", "loadSimulation"}, "config"
    )
    config = {
        "servicesInfo": _walk_services_info(raw.get("servicesInfo"), walker),
        "endpointDependencies": _walk_endpoint_dependencies(
            raw.get("endpointDependencies"), walker
        ),
        "loadSimulation": _walk_load_simulation(raw.get("loadSimulation"), walker),
    }
    if "servicesInfo" not in raw:
        walker.fail("servicesInfo", "Required.")
    if "endpointDependencies" not in raw:
        walker.fail("endpointDependencies", "Required.")
    if walker.errors:
        return walker.errors, None
    return [], config


# ---------------------------------------------------------------------------
# semantic validators (SimConfigValidator/*)
# ---------------------------------------------------------------------------

def validate_services_info(services_info: List[dict]) -> List[ValidationError]:
    """Duplicate service / endpointId / endpoint-path checks
    (SimConfigServicesInfoValidator.ts)."""
    errors: List[ValidationError] = []
    seen_services: Set[str] = set()
    for ns in services_info:
        for svc in ns["services"]:
            for ver in svc["versions"]:
                usn = naming.generate_unique_service_name(
                    svc["serviceName"], ns["namespace"], ver["version"]
                )
                if usn in seen_services:
                    errors.append(
                        _err(
                            f"servicesInfo > namespace: {ns['namespace']} > "
                            f"serviceName: {svc['serviceName']} > version: {ver['version']}",
                            "Duplicate service found.",
                        )
                    )
                else:
                    seen_services.add(usn)
    if errors:
        return errors

    seen_ids: Set[str] = set()
    seen_endpoint_names: Set[str] = set()
    for ns in services_info:
        for svc in ns["services"]:
            for ver in svc["versions"]:
                for ep in ver["endpoints"]:
                    loc = (
                        f"servicesInfo > namespace: {ns['namespace']} > "
                        f"serviceName: {svc['serviceName']} > version: {ver['version']} > "
                        f"endpointId: {ep['endpointId']}"
                    )
                    if ep["endpointId"] in seen_ids:
                        errors.append(_err(loc, "Duplicate endpointId found."))
                    else:
                        seen_ids.add(ep["endpointId"])
                    uen = naming.generate_unique_endpoint_name(
                        svc["serviceName"],
                        ns["namespace"],
                        ver["version"],
                        ep["endpointInfo"]["method"].upper(),
                        ep["endpointInfo"]["path"],
                    )
                    if uen in seen_endpoint_names:
                        errors.append(
                            _err(
                                loc,
                                f'The endpoint with method "{ep["endpointInfo"]["method"].upper()}" '
                                f'and path "{ep["endpointInfo"]["path"]}" has already been defined.',
                            )
                        )
                    else:
                        seen_endpoint_names.add(uen)
    return errors


def _depend_on_id_map(dependencies: List[dict]) -> Dict[str, Set[str]]:
    """endpointId -> set of target endpointIds (flattening oneOf groups)."""
    out: Dict[str, Set[str]] = {}
    for dep in dependencies:
        targets = out.setdefault(dep["endpointId"], set())
        for entry in dep["dependOn"]:
            if "oneOf" in entry:
                targets.update(one["endpointId"] for one in entry["oneOf"])
            else:
                targets.add(entry["endpointId"])
    return out


def validate_endpoint_dependencies(
    dependencies: List[dict], defined_ids: Set[str]
) -> List[ValidationError]:
    """Undefined ids, duplicates, cycles, oneOf probability sums
    (SimConfigEndpointDependenciesValidator.ts)."""
    errors: List[ValidationError] = []
    for i, dep in enumerate(dependencies):
        loc = f"endpointDependencies[{i}]"
        if dep["endpointId"] not in defined_ids:
            errors.append(
                _err(loc, f'Source endpointId "{dep["endpointId"]}" is not defined in servicesInfo.')
            )
        for j, entry in enumerate(dep["dependOn"]):
            dloc = f"{loc}.dependOn[{j}]"
            members = entry["oneOf"] if "oneOf" in entry else [entry]
            for k, one in enumerate(members):
                mloc = f"{dloc}.oneOf[{k}]" if "oneOf" in entry else dloc
                if one["endpointId"] not in defined_ids:
                    errors.append(
                        _err(
                            mloc,
                            f'Target endpointId "{one["endpointId"]}" is not defined in servicesInfo.',
                        )
                    )
    if errors:
        return errors

    seen_sources: Set[str] = set()
    for i, dep in enumerate(dependencies):
        loc = f"endpointDependencies[{i}]"
        if dep["endpointId"] in seen_sources:
            errors.append(
                _err(loc, f'Duplicate source endpointId "{dep["endpointId"]}" found.')
            )
            continue
        seen_sources.add(dep["endpointId"])
        seen_targets: Set[str] = set()
        for entry in dep["dependOn"]:
            members = entry["oneOf"] if "oneOf" in entry else [entry]
            for one in members:
                if one["endpointId"] in seen_targets:
                    errors.append(
                        _err(
                            f"{loc}.dependOn",
                            f'Duplicate endpointId "{one["endpointId"]}" found in the '
                            f'dependOn list for "{dep["endpointId"]}".',
                        )
                    )
                else:
                    seen_targets.add(one["endpointId"])
    if errors:
        return errors

    errors.extend(_check_cycles(dependencies))
    if errors:
        return errors

    for i, dep in enumerate(dependencies):
        for j, entry in enumerate(dep["dependOn"]):
            if "oneOf" in entry:
                total = sum(one["callProbability"] for one in entry["oneOf"])
                if total > 100:
                    errors.append(
                        _err(
                            f"endpointDependencies[{i}].dependOn[{j}]",
                            f'Total callProbability of oneOf group exceeds 100 for source '
                            f'endpoint "{dep["endpointId"]}". The current total is {total:g}.',
                        )
                    )
    return errors


def _check_cycles(dependencies: List[dict]) -> List[ValidationError]:
    """Cycle detection (incl. self-loops) on the id-level dependOn graph
    (SimConfigEndpointDependenciesValidator.ts checkCyclicEndpointDependencies),
    implemented iteratively so deep chains can't blow the Python stack."""
    graph = _depend_on_id_map(dependencies)
    errors: List[ValidationError] = []
    reported: Set[str] = set()
    WHITE, GRAY, BLACK = 0, 1, 2
    color: Dict[str, int] = {}
    parent: Dict[str, Optional[str]] = {}

    for root in graph:
        if color.get(root, WHITE) != WHITE:
            continue
        stack: List[Tuple[str, any]] = [(root, iter(sorted(graph.get(root, ()))))]
        color[root] = GRAY
        parent[root] = None
        while stack:
            node, neighbors = stack[-1]
            advanced = False
            for nxt in neighbors:
                if color.get(nxt, WHITE) == WHITE:
                    color[nxt] = GRAY
                    parent[nxt] = node
                    stack.append((nxt, iter(sorted(graph.get(nxt, ())))))
                    advanced = True
                    break
                if color.get(nxt) == GRAY:
                    cycle = [nxt]
                    cur = node
                    while cur is not None and cur != nxt:
                        cycle.append(cur)
                        cur = parent.get(cur)
                    cycle.append(nxt)
                    cycle.reverse()
                    normalized = "->".join(sorted(set(cycle)))
                    if normalized not in reported:
                        reported.add(normalized)
                        errors.append(
                            _err(
                                "endpointDependencies",
                                "Cyclic dependency detected: " + " -> ".join(cycle),
                            )
                        )
            if not advanced:
                color[node] = BLACK
                stack.pop()
    return errors


def validate_load_simulation(
    load: dict,
    defined_ids: Set[str],
    defined_service_names: Set[str],
) -> List[ValidationError]:
    """serviceMetrics / endpointMetrics / fault-target reference checks
    (SimConfigLoadSimulationValidator.ts)."""
    errors: List[ValidationError] = []
    seen_services: Set[str] = set()
    for ns in load["serviceMetrics"]:
        for svc in ns["services"]:
            for ver in svc["versions"]:
                usn = naming.generate_unique_service_name(
                    svc["serviceName"], ns["namespace"], ver["version"]
                )
                loc = "loadSimulation.serviceMetrics"
                if usn not in defined_service_names:
                    errors.append(
                        _err(
                            loc,
                            f'service "{svc["serviceName"]}" in namespace '
                            f'"{ns["namespace"]}" with version "{ver["version"]}" is '
                            "not defined in servicesInfo.",
                        )
                    )
                elif usn in seen_services:
                    errors.append(
                        _err(
                            loc,
                            f'Duplicate service "{svc["serviceName"]}" in namespace '
                            f'"{ns["namespace"]}" with version "{ver["version"]}" found '
                            "in serviceMetrics.",
                        )
                    )
                else:
                    seen_services.add(usn)

    seen_metrics: Set[str] = set()
    for metric in load["endpointMetrics"]:
        loc = "loadSimulation.endpointMetrics"
        if metric["endpointId"] not in defined_ids:
            errors.append(
                _err(loc, f'EndpointId "{metric["endpointId"]}" is not defined in servicesInfo.')
            )
        elif metric["endpointId"] in seen_metrics:
            errors.append(
                _err(loc, f'Duplicate endpointId "{metric["endpointId"]}" found in endpointMetrics.')
            )
        else:
            seen_metrics.add(metric["endpointId"])

    for i, fault in enumerate(load["faultInjection"]):
        loc = f"loadSimulation.faultInjection[{i}]"
        for svc in fault["targets"]["services"]:
            if svc["version"] is not None:
                usn = naming.generate_unique_service_name(
                    svc["serviceName"], svc["namespace"], svc["version"]
                )
                if usn not in defined_service_names:
                    errors.append(
                        _err(
                            loc,
                            f'Service "{svc["serviceName"]}" in namespace '
                            f'"{svc["namespace"]}" with version "{svc["version"]}" is '
                            "not defined in servicesInfo.",
                        )
                    )
            else:
                prefix = naming.generate_unique_service_name_without_version(
                    svc["serviceName"], svc["namespace"]
                ) + "\t"
                if not any(name.startswith(prefix) for name in defined_service_names):
                    errors.append(
                        _err(
                            loc,
                            f'Service "{svc["serviceName"]}" in namespace '
                            f'"{svc["namespace"]}" is not defined in servicesInfo.',
                        )
                    )
        for ep in fault["targets"]["endpoints"]:
            if ep["endpointId"] not in defined_ids:
                errors.append(
                    _err(loc, f'EndpointId "{ep["endpointId"]}" is not defined in servicesInfo.')
                )
    return errors


# ---------------------------------------------------------------------------
# preprocessors (SimConfigPreprocessor/*)
# ---------------------------------------------------------------------------

def preprocess_services_info(services_info: List[dict]) -> List[ValidationError]:
    """Assign unique names and normalize JSON bodies in place
    (SimConfigServicesInfoPreprocessor.ts)."""
    errors: List[ValidationError] = []
    for ni, ns in enumerate(services_info):
        for si, svc in enumerate(ns["services"]):
            for vi, ver in enumerate(svc["versions"]):
                ver["uniqueServiceName"] = naming.generate_unique_service_name(
                    svc["serviceName"], ns["namespace"], ver["version"]
                )
                for ei, ep in enumerate(ver["endpoints"]):
                    ep["uniqueEndpointName"] = naming.generate_unique_endpoint_name(
                        svc["serviceName"],
                        ns["namespace"],
                        ver["version"],
                        ep["endpointInfo"]["method"].upper(),
                        ep["endpointInfo"]["path"],
                    )
                    dt = ep.get("datatype")
                    if not dt:
                        continue
                    loc = (
                        f"servicesInfo[{ni}].services[{si}].versions[{vi}]"
                        f".endpoints[{ei}]"
                    )
                    if dt["requestContentType"] == "application/json":
                        ok, processed, warning = bodies.preprocess_json_body(
                            dt["requestBody"]
                        )
                        if not ok:
                            errors.append(
                                _err(
                                    loc,
                                    f'Unacceptable format in requestBody of endpoint '
                                    f'"{ep["endpointId"]}": {warning}',
                                )
                            )
                        else:
                            dt["requestBody"] = processed
                    for resp in dt["responses"]:
                        if resp["responseContentType"] == "application/json":
                            ok, processed, warning = bodies.preprocess_json_body(
                                resp["responseBody"]
                            )
                            if not ok:
                                errors.append(
                                    _err(
                                        loc,
                                        f'Unacceptable format in responseBody (status: '
                                        f'{resp["status"]}) of endpoint '
                                        f'"{ep["endpointId"]}": {warning}',
                                    )
                                )
                            else:
                                resp["responseBody"] = processed
    return errors


def preprocess_endpoint_dependencies(
    dependencies: List[dict], id_to_name: Dict[str, str]
) -> List[ValidationError]:
    """Fill uniqueEndpointName on every dependency entry in place
    (SimConfigEndpointDependenciesPreprocessor.ts)."""
    errors: List[ValidationError] = []

    def assign(obj: dict, loc: str) -> None:
        obj["uniqueEndpointName"] = id_to_name.get(obj["endpointId"])
        if not obj["uniqueEndpointName"]:
            errors.append(
                _err(
                    loc,
                    f'Failed to assign uniqueEndpointName: endpointId '
                    f'"{obj["endpointId"]}" does not exist in the mapping. '
                    "(This is unexpected system error!!)",
                )
            )

    for i, dep in enumerate(dependencies):
        loc = f"endpointDependencies[{i}]"
        assign(dep, loc)
        for j, entry in enumerate(dep["dependOn"]):
            if "oneOf" in entry:
                for k, one in enumerate(entry["oneOf"]):
                    assign(one, f"{loc}.dependOn[{j}].oneOf[{k}]")
            else:
                assign(entry, f"{loc}.dependOn[{j}]")
    return errors


def preprocess_load_simulation(
    load: dict,
    id_to_name: Dict[str, str],
    service_to_endpoint_ids: Dict[str, Set[str]],
) -> List[ValidationError]:
    """Fill unique names; expand version-less fault service targets to all
    matching versions; convert fault service targets to endpoint targets
    (SimConfigLoadSimulationPreprocessor.ts)."""
    errors: List[ValidationError] = []
    for i, metric in enumerate(load["endpointMetrics"]):
        metric["uniqueEndpointName"] = id_to_name.get(metric["endpointId"])
        if not metric["uniqueEndpointName"]:
            errors.append(
                _err(
                    f"loadSimulation.endpointMetrics[{i}]",
                    f'Failed to assign uniqueEndpointName: endpointId '
                    f'"{metric["endpointId"]}" does not exist in the mapping. '
                    "(This is unexpected system error!!)",
                )
            )
    for ns in load["serviceMetrics"]:
        for svc in ns["services"]:
            for ver in svc["versions"]:
                ver["uniqueServiceName"] = naming.generate_unique_service_name(
                    svc["serviceName"], ns["namespace"], ver["version"]
                )

    for fault in load["faultInjection"]:
        # expand version-less service targets to every defined version
        expanded: List[str] = []
        seen: Set[str] = set()
        for svc in fault["targets"]["services"]:
            if svc["version"] is not None:
                usn = naming.generate_unique_service_name(
                    svc["serviceName"], svc["namespace"], svc["version"]
                )
                if usn not in seen:
                    seen.add(usn)
                    expanded.append(usn)
            else:
                prefix = naming.generate_unique_service_name_without_version(
                    svc["serviceName"], svc["namespace"]
                ) + "\t"
                for name in sorted(service_to_endpoint_ids):
                    if name.startswith(prefix) and name not in seen:
                        seen.add(name)
                        expanded.append(name)
        fault["targets"]["services"] = []
        for usn in expanded:
            service, namespace, version = naming.split_unique_service_name(usn)
            fault["targets"]["services"].append(
                {
                    "serviceName": service,
                    "namespace": namespace,
                    "version": version,
                    "uniqueServiceName": usn,
                }
            )

        # endpoint-level faults targeting services apply to every endpoint of
        # the service (SimConfigLoadSimulationPreprocessor.ts:117-140)
        if fault["type"] != "reduce-instance":
            endpoint_ids = {ep["endpointId"] for ep in fault["targets"]["endpoints"]}
            for svc in fault["targets"]["services"]:
                for endpoint_id in service_to_endpoint_ids.get(
                    svc["uniqueServiceName"], ()
                ):
                    endpoint_ids.add(endpoint_id)
            fault["targets"]["endpoints"] = [
                {"endpointId": eid, "uniqueEndpointName": id_to_name.get(eid)}
                for eid in sorted(endpoint_ids)
            ]
    return errors


# ---------------------------------------------------------------------------
# manager
# ---------------------------------------------------------------------------

class SimulationConfigManager:
    """YAML-string -> validated+preprocessed config, or an error message
    (SimulationConfigManager.ts:52-107)."""

    def handle_sim_config(self, yaml_string: str) -> Tuple[str, Optional[dict]]:
        if not yaml_string.strip():
            return "", None
        try:
            raw = yaml.safe_load(yaml_string)
        except yaml.YAMLError as err:
            return (
                "Failed to handle simulation configuration file"
                f"(Unexpected error occurred):\n---\n{err}",
                None,
            )

        errors, config = validate_schema(raw)
        if errors:
            return (
                _format_errors(
                    "Failed to parse simulation configuration file:", errors
                ),
                None,
            )

        errors = self._validate_and_preprocess(config)
        if errors:
            return (
                _format_errors(
                    "Failed to validate and preprocess simulation configuration file:",
                    errors,
                ),
                None,
            )
        return "", config

    def _validate_and_preprocess(self, config: dict) -> List[ValidationError]:
        errors = validate_services_info(config["servicesInfo"])
        if errors:
            return errors
        errors = preprocess_services_info(config["servicesInfo"])
        if errors:
            return errors

        id_to_name = endpoint_id_to_unique_name_map(config["servicesInfo"])
        service_to_endpoint_ids = service_name_to_endpoint_ids_map(
            config["servicesInfo"]
        )

        errors = validate_endpoint_dependencies(
            config["endpointDependencies"], set(id_to_name)
        )
        if errors:
            return errors
        errors = preprocess_endpoint_dependencies(
            config["endpointDependencies"], id_to_name
        )
        if errors:
            return errors

        if config["loadSimulation"] is not None:
            errors = validate_load_simulation(
                config["loadSimulation"],
                set(id_to_name),
                set(service_to_endpoint_ids),
            )
            if errors:
                return errors
            errors = preprocess_load_simulation(
                config["loadSimulation"], id_to_name, service_to_endpoint_ids
            )
            if errors:
                return errors
        return []


def endpoint_id_to_unique_name_map(services_info: List[dict]) -> Dict[str, str]:
    """endpointId -> uniqueEndpointName (first definition wins,
    SimulationConfigManager.ts:159-175)."""
    out: Dict[str, str] = {}
    for ns in services_info:
        for svc in ns["services"]:
            for ver in svc["versions"]:
                for ep in ver["endpoints"]:
                    out.setdefault(ep["endpointId"], ep["uniqueEndpointName"])
    return out


def service_name_to_endpoint_ids_map(
    services_info: List[dict],
) -> Dict[str, Set[str]]:
    """uniqueServiceName -> set of endpointIds (SimulationConfigManager.ts:177-192)."""
    out: Dict[str, Set[str]] = {}
    for ns in services_info:
        for svc in ns["services"]:
            for ver in svc["versions"]:
                out[ver["uniqueServiceName"]] = {
                    ep["endpointId"] for ep in ver["endpoints"]
                }
    return out

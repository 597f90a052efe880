"""Envoy WASM-filter log parsing and request/response pairing.

A copy of kmamiz_tpu/core/envoy.py (KMamiz src/services/
KubernetesService.ts:201-242 for the line parse, src/classes/EnvoyLog.ts
for the structuring: span-id pairing, the stack fallback when
spanId=NO_ID, the cross-pod combine and the parent-id fill). The served
path parses with the port's native library
(csrc/kmamiz_native.cpp through kmamiz_tpu_torch.native), which has no
Python fallback: `_parse_envoy_lines_py` and
`_strip_istio_proxy_prefix_py` are the plain twins that the tests hold
the native parse against.
"""
from __future__ import annotations

import re
from datetime import datetime, timezone
from typing import Dict, List

from kmamiz_tpu_torch import native

_HEADER_RE = re.compile(
    r"\[(Request|Response) ([\w-]+)/(\w+)/(\w+)/(\w+)\]"
)
_STATUS_RE = re.compile(r"\[Status\] ([0-9]+)")
_METHOD_PATH_RE = re.compile(r"(GET|POST|PUT|DELETE|PATCH|HEAD|OPTIONS) ([^\]]+)")
_CONTENT_TYPE_RE = re.compile(r"\[ContentType ([^\]]*)\]")
_BODY_RE = re.compile(r"\[Body\] (.*)")

_ISTIO_PROXY_PREFIX_RE = re.compile(
    r"\t.*envoy (lua|wasm).*\t(script|wasm) log[^:]*: "
)


def parse_timestamp_ms(time_str: str) -> float:
    """RFC3339 timestamp -> epoch milliseconds."""
    try:
        dt = datetime.fromisoformat(time_str.replace("Z", "+00:00"))
        if dt.tzinfo is None:
            dt = dt.replace(tzinfo=timezone.utc)
        return dt.timestamp() * 1000
    except ValueError:
        return float("nan")


def strip_istio_proxy_prefix(lines: List[str]) -> List[str]:
    """Reduce raw istio-proxy container log lines to 'time\\tpayload' form
    (KubernetesService.getEnvoyLogs filtering), natively."""
    return native.strip_istio_proxy_prefix(lines)


def _strip_istio_proxy_prefix_py(lines: List[str]) -> List[str]:
    """Plain twin of strip_istio_proxy_prefix."""
    out = []
    for line in lines:
        if "script log: " not in line and "wasm log " not in line:
            continue
        out.append(_ISTIO_PROXY_PREFIX_RE.sub("\t", line))
    return out


def parse_envoy_logs(
    logs: List[str], namespace: str, pod_name: str
) -> "EnvoyLogs":
    """Parse 'time\\t[Request|Response ...]' lines into TEnvoyLog dicts
    (KubernetesService.ParseEnvoyLogs), natively."""
    records = native.parse_envoy_lines(logs)
    return decorate_envoy_records(
        records, backfill_trace_ids(records), namespace, pod_name
    )


def backfill_trace_ids(records: List[dict]) -> Dict[str, str]:
    """One pod's parsed records -> each requestId's first non-NO_ID
    traceId, which every record of that request takes (a requestId
    missing here takes NO_ID)."""
    id_map: Dict[str, str] = {}
    for r in records:
        if r["requestId"] not in id_map and r["traceId"] != "NO_ID":
            id_map[r["requestId"]] = r["traceId"]
    return id_map


def decorate_envoy_records(
    records: List[dict], id_map: Dict[str, str], namespace: str, pod_name: str
) -> "EnvoyLogs":
    """Parsed records -> TEnvoyLog dicts: the timestamp parsed, the pod's
    identity, the traceId from `id_map` (backfill_trace_ids of the pod's
    records)."""
    envoy_logs: List[dict] = []
    for r in records:
        entry = dict(r)
        entry["timestamp"] = parse_timestamp_ms(entry.pop("time"))
        entry["namespace"] = namespace
        entry["podName"] = pod_name
        entry["traceId"] = id_map.get(entry["requestId"], "NO_ID")
        envoy_logs.append(entry)
    return EnvoyLogs(envoy_logs)


def _parse_envoy_lines_py(logs: List[str]) -> List[dict]:
    """Plain twin of native.parse_envoy_lines: raw undecorated field
    records, one per parseable line."""
    records: List[dict] = []
    for l in logs:
        parts = l.split("\t", 1)
        if len(parts) != 2:
            continue
        time_str, log = parts
        header = _HEADER_RE.search(log)
        if not header:
            continue
        log_type, request_id, trace_id, span_id, parent_span_id = header.groups()
        status = (_STATUS_RE.search(log) or [None, None])[1]
        mp = _METHOD_PATH_RE.search(log)
        method, path = (mp.group(1), mp.group(2)) if mp else (None, None)
        ct = _CONTENT_TYPE_RE.search(log)
        body = _BODY_RE.search(log)
        records.append(
            {
                "time": time_str,
                "type": log_type,
                "requestId": request_id,
                "traceId": trace_id,
                "spanId": span_id,
                "parentSpanId": parent_span_id,
                "method": method,
                "path": path,
                "status": status,
                "contentType": ct.group(1) if ct else None,
                "body": body.group(1) if body else None,
            }
        )
    return records


class EnvoyLogs:
    def __init__(self, envoy_logs: List[dict]) -> None:
        self._logs = envoy_logs

    def to_json(self) -> List[dict]:
        return self._logs

    # -- structuring (EnvoyLog.ts:17-99) -------------------------------------

    def to_structured(self) -> List[dict]:
        if not self._logs:
            return []
        log_map: Dict[str, Dict[str, dict]] = {}
        span_ids = set()
        for e in self._logs:
            key = f"{e['requestId']}/{e['traceId']}"
            log_map.setdefault(key, {})[e["spanId"]] = e
            span_ids.add(e["spanId"])
        if "NO_ID" in span_ids:
            return self.to_structured_fallback()

        structured = []
        for key, span_map in log_map.items():
            request_id, trace_id = key.split("/")
            traces = []
            for span_id, log in span_map.items():
                parent = span_map.get(log["parentSpanId"])
                if log["type"] == "Response" and parent and parent["type"] == "Request":
                    traces.append(
                        {
                            "traceId": trace_id,
                            "spanId": span_id,
                            "parentSpanId": log["parentSpanId"],
                            "request": parent,
                            "response": log,
                            "isFallback": False,
                        }
                    )
            structured.append({"requestId": request_id, "traces": traces})
        return structured

    def to_structured_fallback(self) -> List[dict]:
        if not self._logs:
            return []
        logs_map: Dict[str, List[dict]] = {}
        for log in self._logs:
            if not log.get("requestId"):
                continue
            logs_map.setdefault(f"{log['requestId']}/{log['traceId']}", []).append(log)

        structured = []
        for key, logs in logs_map.items():
            request_id, trace_id = key.split("/")
            trace_stack: List[dict] = []
            trace_map: Dict[str, dict] = {}
            for log in logs:
                if log["type"] == "Request":
                    trace_stack.append(log)
                if log["type"] == "Response":
                    if not trace_stack:
                        continue
                    req = trace_stack.pop()
                    trace_map[req["spanId"]] = {
                        "traceId": trace_id,
                        "request": req,
                        "response": log,
                        "spanId": req["spanId"],
                        "parentSpanId": req["parentSpanId"],
                        "isFallback": True,
                    }
            structured.append(
                {"requestId": request_id, "traces": list(trace_map.values())}
            )
        return structured

    # -- cross-pod combine (EnvoyLog.ts:101-149) -----------------------------

    @staticmethod
    def combine_to_structured_envoy_logs(logs: List["EnvoyLogs"]) -> List[dict]:
        combined = EnvoyLogs.combine_structured([l.to_structured() for l in logs])
        return EnvoyLogs.fill_missing_ids(combined)

    @staticmethod
    def combine_structured(logs: List[List[dict]]) -> List[dict]:
        log_map: Dict[str, List[dict]] = {}
        for service_log in logs:
            for log in service_log:
                log_map.setdefault(log["requestId"], []).extend(log["traces"])
        # Deliberate deviation: the reference passes a one-argument comparator
        # (EnvoyLog.ts:124) so its "sort" never actually orders traces; a true
        # ascending request-timestamp sort is what the code intends.
        return [
            {
                "requestId": request_id,
                "traces": sorted(
                    traces, key=lambda t: t["request"]["timestamp"]
                ),
            }
            for request_id, traces in log_map.items()
        ]

    @staticmethod
    def fill_missing_ids(logs: List[dict]) -> List[dict]:
        id_map: Dict[str, str] = {}
        for l in logs:
            for t in l["traces"]:
                if t.get("parentSpanId") and t["parentSpanId"] != "NO_ID":
                    id_map[f"{l['requestId']}/{t['spanId']}"] = t["parentSpanId"]
        for l in logs:
            for t in l["traces"]:
                t["parentSpanId"] = id_map.get(
                    f"{l['requestId']}/{t['spanId']}", t.get("parentSpanId")
                )
        return logs

"""Envoy telemetry-filter equivalent: KMamiz log-line emission.

A copy of kmamiz_tpu/core/envoy_filter.py (the reference's Go proxy-wasm
plugin, KMamiz envoy/wasm/main.go): a `[Request id/trace/span/parent]
[METHOD host/path] [ContentType ...] [Body ...]` line per request and
the `[Response ...] [Status] ...` twin on stream close, JSON bodies
desensitized to type-preserving zero values (main.go:210-240; booleans
and null kept, as the WASM scrubber keeps them).

The tests and chip_smoke.py make istio-proxy container logs with it,
which the ingestion parser (kmamiz_tpu_torch.core.envoy) reads back.
"""
from __future__ import annotations

import json
from datetime import datetime, timezone
from typing import Any, List, Optional

NO_ID = "NO_ID"


def desensitize_value(value: Any) -> Any:
    """WASM parseObject semantics: strings -> "", numbers -> 0, booleans and
    null preserved; containers keep their shape (main.go:210-240)."""
    if isinstance(value, list):
        return [desensitize_value(v) for v in value]
    if isinstance(value, dict):
        return {k: desensitize_value(v) for k, v in value.items()}
    if isinstance(value, bool) or value is None:
        return value
    if isinstance(value, str):
        return ""
    if isinstance(value, (int, float)):
        return 0
    return value


def _reject_constant(_name: str):
    # the wasm filter's strict grammar has no NaN/Infinity; json.loads
    # would accept them
    raise ValueError("non-JSON constant")


def _scan_string_end(s: str, i: int) -> int:
    """i points AFTER the opening quote of a known-valid JSON string;
    returns the index after the closing quote."""
    while True:
        c = s[i]
        if c == "\\":
            i += 2
            continue
        if c == '"':
            return i + 1
        i += 1


def _desens_tokens(s: str) -> str:
    """Rebuild a KNOWN-VALID JSON text with values scrubbed, keeping the
    RAW source tokens for keys and literals — exactly what the wasm
    filter's streaming transform (and the reference's gjson walk,
    main.go:210-240) emit. json.dumps-style re-encoding of keys would
    diverge on non-ASCII or non-canonically-escaped keys (e.g. the
    source token "uni\\u00E9" must survive byte-for-byte). Separators
    normalize to ", " / ": ", matching the filter's output."""
    out: list = []
    i, n = 0, len(s)
    # per-open-container marker: True/False = object (key expected /
    # not), None = array (never expects keys)
    expect_key: list = []
    while i < n:
        c = s[i]
        if c in " \t\n\r":
            i += 1
            continue
        if c == "{":
            out.append("{")
            expect_key.append(True)
            i += 1
        elif c == "[":
            out.append("[")
            expect_key.append(None)
            i += 1
        elif c in "}]":
            out.append(c)
            expect_key.pop()
            i += 1
        elif c == ",":
            out.append(", ")
            if expect_key and expect_key[-1] is not None:
                expect_key[-1] = True
            i += 1
        elif c == ":":
            out.append(": ")
            expect_key[-1] = False
            i += 1
        elif c == '"':
            end = _scan_string_end(s, i + 1)
            if expect_key and expect_key[-1]:
                out.append(s[i:end])  # raw key token, byte-for-byte
            else:
                out.append('""')
            i = end
        elif s.startswith("true", i):
            out.append("true")
            i += 4
        elif s.startswith("false", i):
            out.append("false")
            i += 5
        elif s.startswith("null", i):
            out.append("null")
            i += 4
        else:  # number token
            out.append("0")
            while i < n and s[i] not in ",}] \t\n\r":
                i += 1
    return "".join(out)


def desensitize_body(body: str) -> Optional[str]:
    """JSON body -> desensitized JSON string; None when it doesn't parse
    (the filter drops unparseable bodies, main.go:213-218). Validation
    rides json.loads' strict grammar (with NaN/Infinity rejected, like
    the filter); the output is rebuilt from the RAW source tokens so
    keys, duplicate keys, and literal spellings match the wasm
    filter's streaming transform exactly."""
    try:
        json.loads(body, parse_constant=_reject_constant)
    except (json.JSONDecodeError, TypeError, ValueError, RecursionError):
        return None
    return _desens_tokens(body)


def _id_block(kind: str, request_id: str, trace_id: str, span_id: str, parent_span_id: str) -> str:
    return f"[{kind} {request_id}/{trace_id}/{span_id}/{parent_span_id}]"


def format_request_log(
    method: str,
    host: str,
    path: str,
    request_id: str = NO_ID,
    trace_id: str = NO_ID,
    span_id: str = NO_ID,
    parent_span_id: str = NO_ID,
    content_type: str = "",
    body: str = "",
) -> str:
    """main.go:177-189 plus the body block appended on buffer end."""
    line = (
        _id_block("Request", request_id, trace_id, span_id, parent_span_id)
        + f" [{method} {host}{path}]"
    )
    if content_type:
        line += f" [ContentType {content_type}]"
    if body and content_type == "application/json":
        scrubbed = desensitize_body(body)
        if scrubbed is not None:
            line += f" [Body] {scrubbed}"
    return line


def format_response_log(
    status: str,
    request_id: str = NO_ID,
    trace_id: str = NO_ID,
    span_id: str = NO_ID,
    parent_span_id: str = NO_ID,
    content_type: str = "",
    body: str = "",
) -> str:
    """main.go:190-201 plus the body block."""
    line = (
        _id_block("Response", request_id, trace_id, span_id, parent_span_id)
        + f" [Status] {status}"
    )
    if content_type:
        line += f" [ContentType {content_type}]"
    if body and content_type == "application/json":
        scrubbed = desensitize_body(body)
        if scrubbed is not None:
            line += f" [Body] {scrubbed}"
    return line


def emit_stream_logs(
    timestamp_ms: float,
    method: str,
    host: str,
    path: str,
    status: str,
    request_id: str = NO_ID,
    trace_id: str = NO_ID,
    span_id: str = NO_ID,
    parent_span_id: str = NO_ID,
    request_content_type: str = "",
    request_body: str = "",
    response_content_type: str = "",
    response_body: str = "",
) -> List[str]:
    """One HTTP stream -> the Request/Response line pair in the
    'time\\tpayload' shape the ingestion parser consumes
    (OnHttpStreamDone, main.go:52-63)."""
    stamp = (
        datetime.fromtimestamp(timestamp_ms / 1000, tz=timezone.utc)
        .isoformat(timespec="microseconds")
        .replace("+00:00", "Z")
    )
    request_line = format_request_log(
        method,
        host,
        path,
        request_id,
        trace_id,
        span_id,
        parent_span_id,
        request_content_type,
        request_body,
    )
    response_line = format_response_log(
        status,
        request_id,
        trace_id,
        span_id,
        parent_span_id,
        response_content_type,
        response_body,
    )
    return [f"{stamp}\t{request_line}", f"{stamp}\t{response_line}"]

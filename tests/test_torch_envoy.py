"""The port's envoy-log parse and log-line emitter against the JAX package,
on the CPU.

kmamiz_tpu_torch.core.envoy parses with the port's own native library
(no Python fallback); it must give what the JAX package's native parse
and its Python parse give, record for record, on the PDAS envoy fixture,
on istio-proxy prefixed lines and on the edge cases of
tests/test_native.py. The structuring (span-id pairing, the NO_ID stack
fallback, the cross-pod combine and the parent-id fill) and the join
into realtime records must equal JAX's, and the port's envoy_filter must
emit JAX's lines byte for byte. Every comparison is exact (no tolerance):
strings, ids and the float timestamps are the same computation.
"""
from __future__ import annotations

import json

import pytest

from kmamiz_tpu import native as jax_native
from kmamiz_tpu.core import envoy as jax_envoy
from kmamiz_tpu.core import envoy_filter as jax_filter
from kmamiz_tpu.domain.traces import Traces as JaxTraces
from kmamiz_tpu_torch import native
from kmamiz_tpu_torch.core import envoy, envoy_filter
from kmamiz_tpu_torch.domain.traces import Traces

ISTIO_RAW_LINES = [
    "2022-03-02T08:05:38.224642Z\tdebug\tenvoy wasm\twasm log kmamiz-filter my-ns: "
    "[Request abc-1/trace1/span1/parent1] [GET svc.ns.svc.cluster.local/a]",
    "2022-03-02T08:05:38.230000Z\tdebug\tenvoy lua\tscript log: "
    "[Response abc-1/trace1/span1/parent1] [Status] 200 [ContentType application/json] "
    '[Body] {"x": 0}',
    "2022-03-02T08:05:38.300000Z\tinfo\tsome other line entirely",
    "no tabs here wasm log marker: but malformed",
]

EDGE_LINES = [
    "time\t[Request bad id/with spaces/x/y]",
    "time\t[Request a-b/t/s/p] [GET /path] extra ]",
    "time\t[Response a_b/t1/s1/p1] [Status] 404",
    "time\tno header at all",
    "time\t[Request x/y] too few parts",
    "time\t[Request a/b/c/d] [PATCH h/p] [ContentType text/plain] [Body] raw",
    "\t[Request a/b/c/d] [Status] 7",
    "time\t[Request NO_ID/NO_ID/NO_ID/NO_ID] [HEAD h]",
    "t1\t[Request r1/trace9/s/p] [GET h/p]",
    "t2\t[Response r1/NO_ID/s/p] [Status] 200",
    "t3\t[Request r2/NO_ID/s/p] [GET h/q]",
]


def _normalize(rows):
    """NaN != NaN: stringify unparseable timestamps."""
    out = []
    for r in rows:
        r = dict(r)
        if r.get("timestamp") != r.get("timestamp"):
            r["timestamp"] = "NaN"
        out.append(r)
    return out


def _jax_python_parse(lines, namespace, pod):
    """The JAX package's parse with its native library switched off."""
    real = jax_native.parse_envoy_lines
    jax_native.parse_envoy_lines = lambda _lines: None
    try:
        return jax_envoy.parse_envoy_logs(lines, namespace, pod).to_json()
    finally:
        jax_native.parse_envoy_lines = real


def _wrapped(lines):
    """Fixture lines as an istio-proxy container log prints them."""
    return [ln.split("\t")[0] + "\twasm log kmamiz-filter: " + ln.split("\t", 1)[1] for ln in lines]


@pytest.fixture(scope="module")
def pdas_lines():
    from conftest import load_fixture

    return load_fixture("pdas_envoy_log_lines")


class TestNativeParse:
    @pytest.mark.parametrize("case", ["fixture", "edges", "emitted"])
    def test_native_records_equal_both_jax_parses(self, case, pdas_lines):
        lines = {
            "fixture": pdas_lines,
            "edges": EDGE_LINES,
            "emitted": envoy_filter.emit_stream_logs(
                1646208338224.0, "POST", "a.b.svc.cluster.local", "/x?q=1", "500",
                "req-9", "t9", "s9", "p9", "application/json", json.dumps({"k": "v"}),
                "application/json", json.dumps({"err": True}),
            ),
        }[case]
        got = native.parse_envoy_lines(lines)
        assert got == jax_native.parse_envoy_lines(lines)
        assert got == jax_envoy._parse_envoy_lines_py(lines)
        assert got == envoy._parse_envoy_lines_py(lines)

    @pytest.mark.parametrize("case", ["fixture", "edges"])
    def test_decorated_logs_equal_jax(self, case, pdas_lines):
        lines = pdas_lines if case == "fixture" else EDGE_LINES
        got = _normalize(envoy.parse_envoy_logs(lines, "pdas", "pod-1").to_json())
        assert got == _normalize(jax_envoy.parse_envoy_logs(lines, "pdas", "pod-1").to_json())
        assert got == _normalize(_jax_python_parse(lines, "pdas", "pod-1"))

    def test_parsed_fields(self, pdas_lines):
        logs = envoy.parse_envoy_logs(pdas_lines, "pdas", "user-service").to_json()
        assert len(logs) == len(pdas_lines)
        req, res = logs[0], logs[1]
        assert (req["type"], req["method"], req["requestId"]) == (
            "Request",
            "GET",
            "8c78cf18-cba3-9da3-a3d7-3c63ad4108f1",
        )
        assert (res["type"], res["status"], res["contentType"]) == ("Response", "200", "application/json")

    def test_trace_id_backfill_first_non_no_id_wins(self):
        rows = envoy.parse_envoy_logs(EDGE_LINES[-3:], "ns", "pod").to_json()
        assert [r["traceId"] for r in rows] == ["trace9", "trace9", "NO_ID"]

    def test_timestamp_parse(self):
        assert envoy.parse_timestamp_ms("2022-03-02T08:05:38.224642Z") == jax_envoy.parse_timestamp_ms(
            "2022-03-02T08:05:38.224642Z"
        )


class TestStrip:
    @pytest.mark.parametrize("case", ["istio", "fixture"])
    def test_native_strip_equals_jax(self, case, pdas_lines):
        lines = ISTIO_RAW_LINES if case == "istio" else _wrapped(pdas_lines)
        got = envoy.strip_istio_proxy_prefix(lines)
        assert got == jax_native.strip_istio_proxy_prefix(lines)
        assert got == envoy._strip_istio_proxy_prefix_py(lines)
        real = jax_native.strip_istio_proxy_prefix
        jax_native.strip_istio_proxy_prefix = lambda _lines: None
        try:
            assert got == jax_envoy.strip_istio_proxy_prefix(lines)
        finally:
            jax_native.strip_istio_proxy_prefix = real


class TestStructuring:
    @pytest.mark.parametrize("case", ["fixture", "fallback", "two-pods"])
    def test_structured_and_combined_equal_jax(self, case, pdas_lines):
        if case == "fallback":
            lines = [
                "2022-01-01T00:00:00.000Z\t[Request req-1/trace1/NO_ID/NO_ID] [GET svc/api/a]",
                "2022-01-01T00:00:00.001Z\t[Response req-1/trace1/NO_ID/NO_ID] [Status] 200 "
                '[ContentType application/json] [Body] {"ok":true}',
            ]
        else:
            lines = pdas_lines
        pods = ["pod-0", "pod-1"] if case == "two-pods" else ["pod-0"]
        port_logs = [envoy.parse_envoy_logs(lines, "pdas", p) for p in pods]
        jax_logs = [jax_envoy.parse_envoy_logs(lines, "pdas", p) for p in pods]
        assert [l.to_structured() for l in port_logs] == [l.to_structured() for l in jax_logs]
        got = envoy.EnvoyLogs.combine_to_structured_envoy_logs(port_logs)
        assert got == jax_envoy.EnvoyLogs.combine_to_structured_envoy_logs(jax_logs)
        if case == "fallback":
            (t,) = got[0]["traces"]
            assert t["isFallback"] is True and t["response"]["status"] == "200"

    def test_synthetic_join_into_realtime_records(self):
        """The wasm filter's shape: the Request logged under the parent
        span id, the Response under the SERVER span id; the join puts both
        bodies on the SERVER span's record, in both packages."""
        lines = envoy_filter.emit_stream_logs(
            1646208338224.642, "GET", "svc.ns.svc.cluster.local", "/api/a", "200",
            "req-1", "t1", "aaa", "bbb", "application/json", '{"q":1}',
            "application/json", '{"ok":true,"n":3}',
        )
        # the Request line carries the parent's span id
        lines[0] = lines[0].replace("/aaa/bbb]", "/bbb/ccc]")
        span = {
            "traceId": "t1",
            "parentId": "bbb",
            "id": "aaa",
            "kind": "SERVER",
            "name": "svc.ns.svc.cluster.local:80/*",
            "timestamp": 1646208338224823,
            "duration": 1903,
            "tags": {
                "http.method": "GET",
                "http.status_code": "200",
                "http.url": "http://svc.ns.svc.cluster.local/api/a",
                "istio.canonical_revision": "latest",
                "istio.canonical_service": "svc",
                "istio.namespace": "ns",
            },
        }
        replicas = [{"uniqueServiceName": "svc\tns\tlatest", "replicas": 3}]
        got = Traces([[dict(span)]]).combine_logs_to_realtime_data(
            envoy.EnvoyLogs.combine_to_structured_envoy_logs([envoy.parse_envoy_logs(lines, "ns", "p")]),
            replicas,
        )
        want = JaxTraces([[dict(span)]]).combine_logs_to_realtime_data(
            jax_envoy.EnvoyLogs.combine_to_structured_envoy_logs([jax_envoy.parse_envoy_logs(lines, "ns", "p")]),
            replicas,
        )
        assert got.to_json() == want.to_json()
        (row,) = got.to_json()
        assert row["responseBody"] == '{"ok": true, "n": 0}'
        assert row["requestBody"] == '{"q": 0}'
        assert row["replica"] == 3
        assert got.to_combined_realtime_data().to_json() == want.to_combined_realtime_data().to_json()


EMIT_CASES = [
    dict(
        timestamp_ms=1646208338224.642, method="GET", host="user-service.pdas.svc.cluster.local",
        path="/user/1", status="200", request_id="req-1", trace_id="trace1", span_id="span1",
        parent_span_id="parent1", response_content_type="application/json",
        response_body=json.dumps({"secret": "value", "n": 7}),
    ),
    dict(
        timestamp_ms=1.5, method="POST", host="h", path="/login", status="401",
        request_content_type="application/json",
        request_body='{"password": "hunter2", "uni\\u00E9": [1, 2.5, true, null, {"a": "b"}]}',
        response_content_type="text/plain", response_body="nope",
    ),
    dict(
        timestamp_ms=1700000000000.0, method="PUT", host="a", path="/b", status="500",
        request_content_type="application/json", request_body="not json",
        response_content_type="application/json", response_body="[1, NaN]",
    ),
]


class TestEmitter:
    @pytest.mark.parametrize("case", range(len(EMIT_CASES)))
    def test_emitted_lines_equal_jax(self, case):
        kw = EMIT_CASES[case]
        got = envoy_filter.emit_stream_logs(**kw)
        assert got == jax_filter.emit_stream_logs(**kw)
        assert len(got) == 2

    def test_desensitize_equals_jax(self):
        value = {"name": "alice", "age": 33, "admin": True, "note": None, "tags": ["a", 1, False]}
        assert envoy_filter.desensitize_value(value) == jax_filter.desensitize_value(value) == {
            "name": "", "age": 0, "admin": True, "note": None, "tags": ["", 0, False],
        }
        for body in ('{"a": 1}', "not json", '{"k":"v","k":"w"}', "[1, Infinity]"):
            assert envoy_filter.desensitize_body(body) == jax_filter.desensitize_body(body)

    def test_round_trip_through_the_port_parser(self):
        lines = envoy_filter.emit_stream_logs(**EMIT_CASES[0])
        req, res = envoy.parse_envoy_logs(lines, "pdas", "user-service-0").to_json()
        assert (req["type"], req["method"], req["traceId"]) == ("Request", "GET", "trace1")
        assert req["path"] == "user-service.pdas.svc.cluster.local/user/1"
        assert json.loads(res["body"]) == {"secret": "", "n": 0}
        line = envoy_filter.format_request_log(
            "POST", "svc", "/login", content_type="application/json", body=json.dumps({"password": "hunter2"})
        )
        assert "hunter2" not in line and '"password"' in line
        assert "[Body]" not in envoy_filter.format_request_log(
            "POST", "h", "/p", content_type="text/plain", body="raw text"
        )

"""Raw ingest in the port against the JAX package, on the CPU.

The port's raw_spans_to_batch (its own native build) must give the batch
of the reference's raw_spans_to_batch and of the port's own dict path
spans_to_batch(json.loads(raw)): every array, the interner tables, the
endpoint infos and the kept trace ids, bit for bit. Its DataProcessor's
ingest_raw_window, the dedup map it shares with the tick, and POST
/ingest must answer as the JAX processor does with the quarantine off
(KMAMIZ_QUARANTINE=0), with equal graph signatures.
"""
from __future__ import annotations

import gzip
import json
import struct
import urllib.error
import urllib.request

import numpy as np
import pytest

from conftest import load_fixture
from kmamiz_tpu.core import spans as ref_spans
from kmamiz_tpu.core.interning import EndpointInterner as RefInterner
from kmamiz_tpu.core.interning import StringInterner as RefStrings
from kmamiz_tpu.resilience.chaos import graph_signature as ref_signature
from kmamiz_tpu.server.processor import DataProcessor as JaxProcessor
from kmamiz_tpu_torch import native, synth
from kmamiz_tpu_torch.core import wire
from kmamiz_tpu_torch.core.interning import EndpointInterner, StringInterner
from kmamiz_tpu_torch.core.spans import (
    KeptTraceIds,
    RawIngestSession,
    raw_spans_to_batch,
    spans_to_batch,
)
from kmamiz_tpu_torch.graph.store import graph_signature
from kmamiz_tpu_torch.server.dp_server import DataProcessorServer
from kmamiz_tpu_torch.server.processor import PROCESSED_TRACE_TTL_MS, DataProcessor

ARRAY_FIELDS = [
    "valid",
    "kind",
    "parent_idx",
    "endpoint_id",
    "service_id",
    "rt_endpoint_id",
    "rt_service_id",
    "status_id",
    "status_class",
    "latency_ms",
    "timestamp_us",
    "timestamp_rel",
    "trace_of",
]


def assert_batches_equal(got, want):
    """The fields of tests/test_native_spans.py's assert_batches_equal."""
    assert got.n_spans == want.n_spans
    assert got.ts_base_us == want.ts_base_us
    for f in ARRAY_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        assert np.array_equal(a, b), f"{f}: {a} != {b}"
    assert got.interner.endpoints.strings == want.interner.endpoints.strings
    assert got.interner.services.strings == want.interner.services.strings
    assert got.interner.endpoint_service_ids == want.interner.endpoint_service_ids
    assert got.statuses.strings == want.statuses.strings
    assert got.endpoint_infos == want.endpoint_infos


def three_ways(raw, **kw):
    """The port's raw batch against the reference's raw batch and the
    port's dict path over json.loads(raw) filtered as the tick filters
    (kw: skip_trace_ids); returns the port's (batch, kept)."""
    got = raw_spans_to_batch(raw, **kw)
    want = ref_spans.raw_spans_to_batch(raw, **kw)
    assert (got is None) == (want is None)
    if got is None:
        return None
    assert_batches_equal(got[0], want[0])
    assert list(got[1]) == list(want[1])
    seen = set(kw.get("skip_trace_ids", ()))
    groups = []
    for g in json.loads(raw) if not wire.is_columnar(raw) else wire.decode_groups(raw):
        if g and g[0].get("traceId") not in seen:
            seen.add(g[0].get("traceId"))
            groups.append(g)
    assert_batches_equal(got[0], spans_to_batch(groups))
    assert list(got[1]) == [g[0].get("traceId") for g in groups]
    return got


def mk_span(tid, sid, parent=None, **over):
    s = {
        "traceId": tid,
        "id": sid,
        "parentId": parent,
        "kind": "SERVER",
        "name": "svc.ns.svc.cluster.local:80/*",
        "timestamp": 1_700_000_000_000_000,
        "duration": 1000,
        "tags": {
            "http.method": "GET",
            "http.status_code": "200",
            "http.url": "http://svc.ns.svc.cluster.local/api",
            "istio.canonical_revision": "v1",
            "istio.canonical_service": "svc",
            "istio.mesh_id": "cluster.local",
            "istio.namespace": "ns",
        },
    }
    s.update(over)
    return s


def _fixture_groups(name):
    data = load_fixture(name)
    return data if isinstance(data[0], list) else [data]


def _synth(n=80, prefix="w", t_start=0):
    return synth.make_raw_window(
        n, 7, t_start=t_start, trace_prefix=prefix, n_services=30, urls_per_service=4
    )


# -- batches -------------------------------------------------------------------


@pytest.mark.parametrize(
    "name", ["pdas_traces", "pdas2_traces", "bookinfo_traces", "synth", "legacy_synth"]
)
def test_window_batches(name):
    if name == "synth":
        raw = _synth()
    elif name == "legacy_synth":
        raw = synth.make_raw_window(60, 5)
    else:
        raw = json.dumps(_fixture_groups(name)).encode()
    three_ways(raw)


@pytest.mark.parametrize("frame", [False, True])
def test_sequential_windows_share_the_interner(frame):
    """Windows merged over one persistent interner grow the tables alike
    (the graph's interner on the ingest path), from JSON or KMZC bytes."""
    windows = [
        json.dumps(_fixture_groups("pdas_traces")).encode(),
        json.dumps(_fixture_groups("pdas2_traces")).encode(),
        _synth(40, "a"),
        _synth(40, "b", t_start=20),
    ]
    if frame:
        windows = [wire.encode_groups(json.loads(w)) for w in windows]
    ours = (EndpointInterner(), StringInterner())
    dicts = (EndpointInterner(), StringInterner())
    refs = (RefInterner(), RefStrings())
    for raw in windows:
        got, kept = raw_spans_to_batch(raw, interner=ours[0], statuses=ours[1])
        want, ref_kept = ref_spans.raw_spans_to_batch(
            raw, interner=refs[0], statuses=refs[1]
        )
        groups = wire.decode_groups(raw) if frame else json.loads(raw)
        host = spans_to_batch(groups, interner=dicts[0], statuses=dicts[1])
        assert_batches_equal(got, want)
        assert_batches_equal(got, host)
        assert list(kept) == list(ref_kept)


def _dedup_case(name):
    if name == "skip_set":
        return [[mk_span("t1", "a")], [mk_span("t2", "b")]], ["t1"]
    if name == "skip_none":
        s1 = {k: v for k, v in mk_span("x", "a").items() if k != "traceId"}
        return [[s1], [dict(s1, id="b")], [mk_span("t3", "c")]], [None]
    if name == "duplicate_trace_id":
        return [[mk_span("t1", "a")], [mk_span("t1", "b")]], []
    if name == "missing_id_sentinel":
        s1 = {k: v for k, v in mk_span("x", "a").items() if k != "traceId"}
        return [[s1], [dict(s1, id="b")]], []
    if name == "empty_groups":
        return [[], [mk_span("t1", "a")], []], []
    if name == "duplicate_span_ids":
        a1 = mk_span("t1", "dup")
        a2 = mk_span(
            "t2",
            "dup",
            timestamp=1_700_000_000_500_000,
            tags={
                **a1["tags"],
                "http.status_code": "503",
                "http.url": "http://svc2.ns.svc.cluster.local/other",
                "istio.canonical_service": "svc2",
            },
        )
        only_dead = mk_span("u1", "d", tags={**a1["tags"], "http.status_code": "418"})
        return [[a1, mk_span("t1", "other")], [a2], [only_dead], [mk_span("u2", "d")]], []
    if name == "parents_across_groups":
        return [
            [mk_span("t1", "a"), mk_span("t1", "b", parent="a")],
            [mk_span("t2", "c", parent="zz"), mk_span("t2", "d", parent="a")],
        ], []
    raise KeyError(name)


@pytest.mark.parametrize(
    "name",
    [
        "skip_set",
        "skip_none",
        "duplicate_trace_id",
        "missing_id_sentinel",
        "empty_groups",
        "duplicate_span_ids",
        "parents_across_groups",
    ],
)
def test_dedup(name):
    groups, skip = _dedup_case(name)
    batch, kept = three_ways(json.dumps(groups).encode(), skip_trace_ids=skip)
    if name == "duplicate_span_ids":
        # JS-Map semantics: first position, last record; a status seen only
        # in an overwritten record is not interned
        assert batch.n_spans == 3
        assert batch.statuses.lookup(int(batch.status_id[0])) == "503"
        assert "418" not in batch.statuses.strings
    if name == "missing_id_sentinel":
        assert kept == [None] and batch.n_spans == 1


def _edge_case(name) -> bytes:
    if name == "escapes":
        span = {
            "traceId": "esc\\u0074-1",
            "id": "a\\nb",
            "kind": "SERVER",
            "name": "svc.ns.svc.cluster.local:80/\\u002A",
            "timestamp": 1_700_000_000_000_000,
            "duration": 5,
            "tags": {
                "http.url": "http://x/\\uD83D\\uDE00/path",
                "http.method": "GET",
                "http.status_code": "200",
            },
        }
        return ("[[" + json.dumps(span).replace("\\\\u", "\\u") + "]]").encode()
    if name == "whitespace_and_numbers":
        return b"""[ [ { "traceId" : "t1" , "id" : "a" ,
            "kind" : "SERVER" , "name" : "n" ,
            "timestamp" : 1.7e15 , "duration" : 1500.5 ,
            "tags" : { "http.status_code" : "200" } } ] ]"""
    if name == "non_string_tags_and_extra_fields":
        span = {
            "traceId": "t1",
            "id": "a",
            "kind": "SERVER",
            "name": "n",
            "timestamp": 1,
            "duration": 2,
            "annotations": [{"timestamp": 5, "value": 'x,[]{}"quote"'}],
            "localEndpoint": {"serviceName": "svc", "port": 80},
            "tags": {"http.status_code": "200", "request_size": "51", "n": 7},
            "shared": True,
        }
        return json.dumps([[span]]).encode()
    if name == "null_and_missing_parent":
        return json.dumps(
            [[{"traceId": "t", "id": "a", "parentId": None, "timestamp": 1},
              {"traceId": "t", "id": "b", "timestamp": 1}]]
        ).encode()
    if name == "structural_chars_in_skipped_values":
        span = {
            "traceId": "t1",
            "id": "a",
            "kind": "SERVER",
            "name": "n",
            "timestamp": 5,
            "duration": -1.5e-3,
            "localEndpoint": {"ipv4": "10.0.0.1", "note": '}],[{"id":"fake"}'},
            "annotations": [{"value": 'quote \\" and ]} inside'}],
            "tags": {
                "http.status_code": "200",
                "weird": "[Request a/b/c/d] {not json}",
                "depth": {"a": [{"b": [[]]}]},
            },
        }
        return json.dumps([[span, {"traceId": "t1", "id": "b", "timestamp": 6}]]).encode()
    if name == "unicode_separators_and_big_numbers":
        span = {
            "traceId": "t sep",
            "id": "x",
            "name": "svc line",
            "timestamp": 9_007_199_254_740_991,
            "duration": 1e18,
            "tags": {"http.url": "http://h/p?q=é", "http.status_code": "200"},
        }
        return json.dumps([[span]], ensure_ascii=False).encode()
    if name == "pretty_printed":
        return json.dumps(
            [[mk_span(f"w{t}", f"s{t}")] for t in range(9)], indent=3
        ).encode()
    if name == "empty_response":
        return b"[]"
    raise KeyError(name)


@pytest.mark.parametrize(
    "name",
    [
        "escapes",
        "whitespace_and_numbers",
        "non_string_tags_and_extra_fields",
        "null_and_missing_parent",
        "structural_chars_in_skipped_values",
        "unicode_separators_and_big_numbers",
        "pretty_printed",
        "empty_response",
    ],
)
def test_json_edge_cases(name):
    assert three_ways(_edge_case(name)) is not None


@pytest.mark.parametrize("raw", [b"[[{", b"not json", b'[[{"id": }]]'])
def test_malformed_payload_is_none(raw):
    assert raw_spans_to_batch(raw) is None
    assert ref_spans.raw_spans_to_batch(raw) is None


@pytest.mark.parametrize(
    "name", ["bookinfo_traces", "synth", "cross_group_duplicate_ids"]
)
def test_forced_multithreaded_parse(monkeypatch, name):
    monkeypatch.setenv("KMAMIZ_PARSE_THREADS", "4")
    if name == "synth":
        raw = _synth(200)
    elif name == "cross_group_duplicate_ids":
        groups = []
        for t in range(40):
            sid = "shared" if t % 7 == 0 else f"s{t}"
            child = mk_span(f"t{t}", f"c{t}", parent=sid, duration=1000 + t)
            groups.append([mk_span(f"t{t}", sid, duration=500 + t), child])
        raw = json.dumps(groups).encode()
    else:
        raw = json.dumps(_fixture_groups(name)).encode()
    assert native.parse_threads() == 4
    three_ways(raw)


@pytest.mark.parametrize("malformed_second", [False, True])
def test_session_path_matches_plain_path(malformed_second):
    """The session path gives the plain path's batches over a sequence of
    windows on one interner; a rejected payload between them resets the
    session and changes nothing."""
    windows = [_synth(30, "a"), _synth(30, "b", t_start=10), _synth(30, "c", t_start=40)]
    plain = EndpointInterner()
    sess_interner = EndpointInterner()
    sess = RawIngestSession(sess_interner)
    ref_interner = RefInterner()
    ref_sess = ref_spans.RawIngestSession(ref_interner)
    for k, raw in enumerate(windows):
        if malformed_second and k == 1:
            before = list(sess_interner.endpoints.strings)
            native_before = sess.native
            assert raw_spans_to_batch(b"[[{oops", interner=sess_interner, session=sess) is None
            assert sess.native is not native_before
            assert sess_interner.endpoints.strings == before
        p_batch, p_kept = raw_spans_to_batch(raw, interner=plain)
        s_batch, s_kept = raw_spans_to_batch(raw, interner=sess_interner, session=sess)
        r_batch, r_kept = ref_spans.raw_spans_to_batch(
            raw, interner=ref_interner, session=ref_sess
        )
        assert isinstance(s_kept, KeptTraceIds)
        assert list(p_kept) == list(s_kept) == list(r_kept)
        assert bytes(s_kept.blob) == bytes(r_kept.blob) == b"".join(
            native.encode_skip_entry(t) for t in s_kept
        )
        assert_batches_equal(s_batch, r_batch)
        for f in ARRAY_FIELDS:
            if f != "status_id":  # the session owns its status table
                assert np.array_equal(getattr(p_batch, f), getattr(s_batch, f)), f
        assert [p_batch.statuses.lookup(int(i)) for i in p_batch.status_id[: p_batch.n_spans]] == [
            s_batch.statuses.lookup(int(i)) for i in s_batch.status_id[: s_batch.n_spans]
        ]
        assert plain.endpoints.strings == sess_interner.endpoints.strings
        assert plain.endpoint_infos == sess_interner.endpoint_infos


@pytest.mark.parametrize("session", [False, True])
def test_malformed_utf8_leaves_the_interner_untouched(session):
    raw = synth.make_raw_window(50, 7)
    bad = raw.replace(b"svc1.ns1", b"svc\xb2.ns1", 1)
    interner = EndpointInterner()
    kw = {"session": RawIngestSession(interner)} if session else {}
    assert raw_spans_to_batch(bad, interner=interner, **kw) is None
    assert len(interner.endpoints) == 0
    ref_interner = RefInterner()
    assert ref_spans.raw_spans_to_batch(bad, interner=ref_interner) is None
    # and the next good payload parses as if nothing had happened
    got, _ = raw_spans_to_batch(raw, interner=interner, **kw)
    assert_batches_equal(got, spans_to_batch(json.loads(raw)))


# -- the processor -----------------------------------------------------------------


@pytest.fixture
def no_quarantine(monkeypatch):
    monkeypatch.setenv("KMAMIZ_QUARANTINE", "0")


def _pair(clock=None, groups=()):
    now = (lambda: clock["ms"]) if clock is not None else None
    kw = {"now_ms": now} if now else {}
    ref = JaxProcessor(trace_source=lambda lb, t, lim: list(groups), **kw)
    port = DataProcessor(trace_source=lambda lb, t, lim: list(groups), device="cpu", **kw)
    return ref, port


def _without_ms(summary):
    return {k: v for k, v in summary.items() if k != "ms"}


def port_skip_blob_locked(dp) -> bytes:
    """The port processor's processed set as one native skip blob (count
    header + skip entries), the layout of the JAX processor's
    _skip_blob_locked(); the caller holds dp._dedup_lock."""
    return struct.pack("<I", len(dp._processed)) + bytes(dp._skip_entries_locked())


@pytest.mark.parametrize("frame", [False, True])
def test_ingest_raw_window_matches_jax(no_quarantine, frame):
    windows = [
        json.dumps(_fixture_groups("pdas_traces")).encode(),
        _synth(60, "a"),
        json.dumps(_fixture_groups("bookinfo_traces")).encode(),
        _synth(60, "a"),  # a repeat: deduplicated
        _synth(60, "a", t_start=30),  # half new
    ]
    if frame:
        windows = [wire.encode_groups(json.loads(w)) for w in windows]
    ref, port = _pair()
    for raw in windows:
        got, want = port.ingest_raw_window(raw), ref.ingest_raw_window(raw)
        assert set(got) == set(want) == {"spans", "traces", "endpoints", "edges", "ms"}
        assert _without_ms(got) == _without_ms(want)
        assert graph_signature(port.graph) == ref_signature(ref.graph)
        assert set(port.last_ingest_ms) == {"parse", "merge"}
    assert got["traces"] == 30 and got["spans"] == 30 * 7
    assert port._processed.keys() == ref._processed.keys()
    with port._dedup_lock, ref._dedup_lock:
        assert port_skip_blob_locked(port) == ref._skip_blob_locked()
    for bad in (b"nope", b"[[{", synth.make_raw_window(5, 3).replace(b"svc1", b"s\xff", 1)):
        before = graph_signature(port.graph)
        with pytest.raises(ValueError):
            port.ingest_raw_window(bad)
        with pytest.raises(ValueError):
            ref.ingest_raw_window(bad)
        assert graph_signature(port.graph) == before


def test_raw_ingest_then_collect_share_the_dedup_map(no_quarantine):
    group = load_fixture("pdas_traces")
    fresh = json.loads(_synth(20, "tick"))
    ref, port = _pair(groups=[group] + fresh)
    for dp in (ref, port):
        dp.ingest_raw_window(json.dumps([group]).encode())
    request = {"uniqueId": "x", "time": 1646208339000}
    got, want = port.collect(request), ref.collect(request)
    # the tick sees the raw-ingested trace as processed and only the fresh
    # traces count
    assert sum(c["combined"] for c in got["combined"]) == 20 * 4
    assert got["dependencies"] == want["dependencies"]
    assert graph_signature(port.graph) == ref_signature(ref.graph)
    # and a raw ingest of the tick's traces after it finds them processed
    raw = json.dumps(fresh).encode()
    assert _without_ms(port.ingest_raw_window(raw)) == _without_ms(ref.ingest_raw_window(raw))
    assert port.ingest_raw_window(raw)["traces"] == 0


def test_register_processed_blob_fast_path():
    """The one-slice blob path and the per-id path leave the same dedup
    state, in both packages."""
    ids = ["tA", "tB", None]
    blob = b"".join(native.encode_skip_entry(t) for t in ids)
    states = [
        DataProcessor(lambda *a: [], device="cpu"),
        DataProcessor(lambda *a: [], device="cpu"),
        JaxProcessor(trace_source=lambda *a: [], use_device_stats=False),
    ]
    states[0]._register_processed(KeptTraceIds(ids, blob), 1000.0)
    states[1]._register_processed(list(ids), 1000.0)
    states[2]._register_processed(ref_spans.KeptTraceIds(ids, blob), 1000.0)
    blobs = []
    for dp in states[:2]:
        with dp._dedup_lock:
            blobs.append(port_skip_blob_locked(dp))
    with states[2]._dedup_lock:
        blobs.append(states[2]._skip_blob_locked())
    assert states[0]._processed == states[1]._processed == states[2]._processed
    assert blobs[0] == blobs[1] == blobs[2]


def test_skip_set_resyncs_after_a_prune(no_quarantine):
    """A TTL prune rebuilds the skip entries and bumps the generation: the
    native skip set clears and resyncs, so pruned ids parse again — at the
    same step as in the JAX processor."""
    clock = {"ms": 1_000_000.0}
    ref, port = _pair(clock)
    raw = json.dumps([[mk_span("tOld", "a")]]).encode()
    seen = []
    for step_ms in (0, 0, PROCESSED_TRACE_TTL_MS + 1_000, 0):
        clock["ms"] += step_ms
        got, want = port.ingest_raw_window(raw), ref.ingest_raw_window(raw)
        assert _without_ms(got) == _without_ms(want)
        seen.append(got["traces"])
    # first seen; deduplicated; deduplicated (the parse predates this
    # pass's prune); seen again after the resync
    assert seen == [1, 0, 0, 1]
    assert port._skip_gen == 1


def test_tick_dedup_keeps_the_reference_lists():
    """The tick's _filter_traces (now with skip entries and the reference's
    prune) keeps the same groups and leaves the same skip blob as the JAX
    processor's, across the time-to-live."""
    groups = json.loads(_synth(30, "k"))
    clock = {"ms": 5_000_000.0}
    ref, port = _pair(clock)
    for step_ms, window in (
        (0, groups[:20]),
        (1, groups[10:]),
        (PROCESSED_TRACE_TTL_MS + 1, groups),
        (1, groups[5:25] + [[]] + groups[:3]),
    ):
        clock["ms"] += step_ms
        got = port._filter_traces(window, clock["ms"])
        want = ref._filter_traces(window, clock["ms"])
        assert got == want
        with port._dedup_lock, ref._dedup_lock:
            assert port_skip_blob_locked(port) == ref._skip_blob_locked()


def test_tick_encodes_no_skip_entries(monkeypatch):
    """The tick registers trace ids without encoding them, across a TTL
    prune too; the raw path's first read encodes the map's keys once, in
    the map's order, to the JAX processor's blob."""
    encoded = []
    encode = native.encode_skip_entry
    monkeypatch.setattr(
        native, "encode_skip_entry", lambda tid: encoded.append(tid) or encode(tid)
    )
    groups = json.loads(_synth(30, "e"))
    clock = {"ms": 5_000_000.0}
    ref, port = _pair(clock)
    for step_ms, window in ((0, groups[:20]), (PROCESSED_TRACE_TTL_MS + 1, groups[10:])):
        clock["ms"] += step_ms
        assert port._filter_traces(window, clock["ms"]) == ref._filter_traces(
            window, clock["ms"]
        )
    assert encoded == [] and port._skip_gen == 1
    with port._dedup_lock, ref._dedup_lock:
        assert port_skip_blob_locked(port) == ref._skip_blob_locked()
        assert port_skip_blob_locked(port) == ref._skip_blob_locked()
    assert encoded == list(port._processed)


def _post(port_no, path, body, gzipped=False):
    headers = {"Content-Encoding": "gzip"} if gzipped else {}
    data = gzip.compress(body) if gzipped else body
    req = urllib.request.Request(
        f"http://127.0.0.1:{port_no}{path}", data=data, headers=headers, method="POST"
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.mark.parametrize("gzipped", [False, True])
def test_http_ingest_route(no_quarantine, gzipped):
    raw = _synth(40, "http")
    twin = DataProcessor(lambda *a: [], device="cpu")
    direct = twin.ingest_raw_window(raw)
    dp = DataProcessor(lambda *a: [], device="cpu")
    server = DataProcessorServer(dp, host="127.0.0.1", port=0)
    server.start()
    try:
        status, summary = _post(server.port, "/ingest", raw, gzipped)
        assert status == 200
        assert _without_ms(summary) == _without_ms(direct)
        assert graph_signature(dp.graph) == graph_signature(twin.graph)
        frame = wire.encode_groups(json.loads(_synth(10, "frame", t_start=100)))
        status, summary = _post(server.port, "/ingest", frame, gzipped)
        assert status == 200 and summary["traces"] == 10
        before = graph_signature(dp.graph)
        status, answer = _post(server.port, "/ingest", b"nope", gzipped)
        assert status == 400 and "error" in answer
        assert graph_signature(dp.graph) == before
        assert _post(server.port, "/ingest/x", raw)[0] == 404
    finally:
        server.stop()


@pytest.mark.parametrize("fault", ["undecodable", "desynced"])
def test_binding_faults_are_no_malformed_payload(no_quarantine, monkeypatch, fault):
    """A fault on the binding's side raises RuntimeError, where a malformed
    payload gives None: ingest_raw_window passes it on with the dedup map
    and the graph untouched, and POST /ingest answers 500, not 400."""
    dp = DataProcessor(lambda *a: [], device="cpu")
    dp.ingest_raw_window(_synth(10, "ok"))
    raw = _synth(10, "next", t_start=50)
    if fault == "undecodable":

        def truncated(*args):
            raise struct.error("truncated status record")

        monkeypatch.setattr(native, "_read_status_records", truncated)
        with pytest.raises(RuntimeError, match="undecodable"):
            native.parse_spans(raw)

    def inject():
        if fault == "desynced":  # a shape the library never emitted
            dp._raw_session.entries.append(None)

    before = (dict(dp._processed), graph_signature(dp.graph))
    inject()
    with pytest.raises(RuntimeError, match=fault):
        dp.ingest_raw_window(raw)
    assert (dict(dp._processed), graph_signature(dp.graph)) == before
    server = DataProcessorServer(dp, host="127.0.0.1", port=0)
    server.start()
    try:
        inject()
        status, answer = _post(server.port, "/ingest", raw)
        assert status == 500 and fault in answer["error"]
    finally:
        server.stop()
    assert (dict(dp._processed), graph_signature(dp.graph)) == before

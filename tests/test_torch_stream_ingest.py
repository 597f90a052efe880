"""Streaming raw ingest in the port against the JAX package, on the CPU.

The port's DataProcessor.ingest_raw_stream, native.split_groups, the
/ingest stream branch and the Zipkin page feeder (ingestion/zipkin.py,
ingest_from_zipkin) against kmamiz_tpu's on the same seeded chunks: the
cases of tests/test_ingest_pipeline.py (ring depths, chunk-ordered dedup,
a malformed later chunk, a failing source), the stream cases of
tests/test_native_spans.py and the Zipkin page cases of
tests/test_ingestion.py. Both packages parse with their own native
library; the JAX side runs with its quarantine off
(KMAMIZ_QUARANTINE=0), the port's only behaviour: a malformed chunk
raises ValueError after the chunks before it merged.
"""
from __future__ import annotations

import gzip
import json
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

import pytest

from kmamiz_tpu import native as jax_native
from kmamiz_tpu.ingestion import ZipkinClient as JaxZipkin
from kmamiz_tpu.resilience.chaos import graph_signature as jax_signature
from kmamiz_tpu.server.processor import DataProcessor as JaxProcessor
from kmamiz_tpu_torch import native, synth
from kmamiz_tpu_torch.core import wire
from kmamiz_tpu_torch.graph.store import graph_signature
from kmamiz_tpu_torch.ingestion import ZipkinClient
from kmamiz_tpu_torch.resilience import breaker as port_breaker
from kmamiz_tpu_torch.resilience import retry as port_retry
from kmamiz_tpu_torch.server.dp_server import DataProcessorServer
from kmamiz_tpu_torch.server.processor import DEFAULT_STREAM_DEPTH, DataProcessor
from test_torch_raw_ingest import port_skip_blob_locked

TOTAL_KEYS = ("spans", "traces", "chunks", "quarantined", "endpoints", "edges")


@pytest.fixture(autouse=True)
def no_quarantine(monkeypatch):
    monkeypatch.setenv("KMAMIZ_QUARANTINE", "0")
    # the Zipkin client's breaker is process-wide in both packages (the
    # JAX conftest resets its own): a test's failed fetches must not open
    # it for the next test
    port_breaker.reset_for_tests()
    yield
    port_breaker.reset_for_tests()


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


def svc_groups(n_traces=36):
    """Two-span traces (a SERVER parent, a CLIENT child in one of five
    services): distinct services give distinct edges."""
    groups = []
    for t in range(n_traces):
        parent = mk_span(f"t{t}", f"p{t}")
        child = mk_span(
            f"t{t}",
            f"c{t}",
            parent=f"p{t}",
            kind="CLIENT",
            name=f"down{t % 5}.ns.svc.cluster.local:80/*",
        )
        child["tags"]["istio.canonical_service"] = f"down{t % 5}"
        child["tags"]["http.url"] = f"http://down{t % 5}.ns/api/{t % 3}"
        groups.append([parent, child])
    return groups


def as_chunks(groups, n_chunks):
    per = -(-len(groups) // n_chunks)
    return [json.dumps(groups[i : i + per]).encode() for i in range(0, len(groups), per)]


def _pair():
    """A port and a JAX processor on one fixed clock, so that their
    processed maps (trace id -> registration time) compare equal."""
    clock = lambda: 1_700_000_000_000.0  # noqa: E731
    return (
        DataProcessor(lambda *a: [], device="cpu", now_ms=clock),
        JaxProcessor(trace_source=lambda *a: [], use_device_stats=False, now_ms=clock),
    )


def assert_same_state(port, ref):
    assert graph_signature(port.graph) == jax_signature(ref.graph)
    assert port.graph.n_edges == ref.graph.n_edges
    assert port._processed == ref._processed
    with port._dedup_lock, ref._dedup_lock:
        assert port_skip_blob_locked(port) == ref._skip_blob_locked()


def assert_same_summary(got, want):
    assert set(got) == set(want)
    for key in TOTAL_KEYS + ("pipeline_depth",):
        assert got[key] == want[key], key
    assert [d["spans"] for d in got["chunk_detail"]] == [d["spans"] for d in want["chunk_detail"]]


# -- ingest_raw_stream -------------------------------------------------------------


@pytest.mark.parametrize("n_chunks", [1, 4, 6])
@pytest.mark.parametrize("depth", [1, 2, 4])
def test_stream_matches_jax_and_one_shot(depth, n_chunks):
    """Equal summaries, graphs, processed maps and skip entries to the JAX
    stream at every depth and chunk count, the one-shot window's graph,
    and a repeat that ingests nothing."""
    groups = svc_groups()
    chunks = as_chunks(groups, n_chunks)
    whole = DataProcessor(lambda *a: [], device="cpu")
    one = whole.ingest_raw_window(json.dumps(groups).encode())

    port, ref = _pair()
    got = port.ingest_raw_stream(chunks, depth=depth)
    want = ref.ingest_raw_stream(chunks, depth=depth)
    assert_same_summary(got, want)
    assert got["spans"] == one["spans"] == 72
    assert got["traces"] == one["traces"] == 36
    assert got["edges"] == one["edges"] and got["endpoints"] == one["endpoints"]
    assert got["chunks"] == len(chunks) and got["pipeline_depth"] == depth
    assert 0 <= got["ring_peak"] <= depth
    assert graph_signature(port.graph) == graph_signature(whole.graph)
    assert_same_state(port, ref)
    # the dedup maps converged: a second pass is a no-op in both
    again, ref_again = port.ingest_raw_stream(chunks, depth=depth), ref.ingest_raw_stream(
        chunks, depth=depth
    )
    assert again["spans"] == again["traces"] == 0
    assert_same_summary(again, ref_again)
    assert port.ingest_dropped == 0


def test_default_depth_is_the_jax_default():
    port, ref = _pair()
    chunks = as_chunks(svc_groups(12), 3)
    assert port.ingest_raw_stream(chunks)["pipeline_depth"] == DEFAULT_STREAM_DEPTH
    assert ref.ingest_raw_stream(chunks)["pipeline_depth"] == DEFAULT_STREAM_DEPTH


def test_dedup_registration_is_chunk_ordered():
    """Chunk k's kept ids register before chunk k+1's parse, at every
    depth: the repeated trace in chunk 3 drops while chunks 1-3 can sit in
    the ring together."""
    c1 = json.dumps([[mk_span("tX", "a")], [mk_span("tY", "b")]]).encode()
    c2 = json.dumps([[mk_span("tZ", "c")]]).encode()
    c3 = json.dumps([[mk_span("tX", "d")], [mk_span("tW", "e")]]).encode()
    port, ref = _pair()
    got = port.ingest_raw_stream([c1, c2, c3], depth=4)
    assert got["traces"] == got["spans"] == 4
    assert_same_summary(got, ref.ingest_raw_stream([c1, c2, c3], depth=4))
    assert_same_state(port, ref)


@pytest.mark.parametrize("depth", [1, 3])
def test_malformed_later_chunk_at_least_once(depth):
    """The error rides the ring in order: every chunk parsed before it
    merges and registers, then ValueError is raised, as in the JAX
    processor with its quarantine off."""
    good1 = json.dumps([[mk_span("tA", "a")]]).encode()
    good2 = json.dumps([[mk_span("tB", "b", name="other.ns.svc.cluster.local:80/*")]]).encode()
    bad = b'[[{"traceId": "tC", "id": '  # truncated
    port, ref = _pair()
    for dp in (port, ref):
        with pytest.raises(ValueError):
            dp.ingest_raw_stream([good1, good2, bad], depth=depth)
    assert set(port._processed) == {"tA", "tB"}
    assert len(port.graph.interner.endpoints) == len(ref.graph.interner.endpoints) > 0
    assert_same_state(port, ref)


def test_source_iterator_error_propagates():
    """An error of the chunk source (a paginated fetch) reaches the caller
    after the chunks before it landed."""

    def chunks():
        yield json.dumps([[mk_span("tA", "a")]]).encode()
        raise RuntimeError("zipkin went away")

    port, ref = _pair()
    for dp in (port, ref):
        with pytest.raises(RuntimeError, match="zipkin went away"):
            dp.ingest_raw_stream(chunks(), depth=2)
    assert "tA" in port._processed
    assert_same_state(port, ref)


def test_chunk_dropped_at_bail_out_is_counted(monkeypatch):
    """A merge that fails ends the stream: the chunk the worker parsed and
    could not hand over counts in ingest_dropped, and the error reaches
    the caller."""
    port = DataProcessor(lambda *a: [], device="cpu")
    third_asked = threading.Event()

    def chunks():
        for k in range(3):
            if k == 2:
                third_asked.set()
            yield json.dumps([[mk_span(f"t{k}", "a")]]).encode()

    def failing_merge(batch, stage=False):
        # chunk 1 waits in the ring, chunk 2 is being parsed or handed over
        assert third_asked.wait(timeout=30)
        raise RuntimeError("device lost")

    monkeypatch.setattr(port.graph, "merge_window", failing_merge)
    with pytest.raises(RuntimeError, match="device lost"):
        port.ingest_raw_stream(chunks(), depth=1)
    assert port.ingest_dropped == 1
    assert set(port._processed) == {"t0", "t1", "t2"}


def test_stream_chunk_detail_accounting():
    """Per chunk: spans summing to the total, parse/merge/transfer >= 0 with
    the transfer inside the merge; drain_ms present."""
    raw = json.dumps([[mk_span(f"t{t}", f"s{t}")] for t in range(40)]).encode()
    chunks = native.split_groups(raw, 4)
    assert chunks is not None and len(chunks) > 1
    out = DataProcessor(lambda *a: [], device="cpu").ingest_raw_stream(chunks)
    detail = out["chunk_detail"]
    assert len(detail) == out["chunks"]
    assert sum(d["spans"] for d in detail) == out["spans"] == 40
    for d in detail:
        assert d["parse_ms"] >= 0
        assert d["merge_ms"] >= d["transfer_ms"] >= 0
    assert out["drain_ms"] >= 0 and out["saved_ms"] >= 0 and out["quarantined"] == 0


def test_stream_span_id_scope_is_per_chunk():
    """The same span id in every trace group: the one-shot parse collapses
    them window-wide, the stream once per chunk (the reference's scope
    under paginated fetches); the graphs agree, in both packages."""
    raw = json.dumps([[mk_span(f"t{t}", "sameid")] for t in range(24)]).encode()
    one = DataProcessor(lambda *a: [], device="cpu")
    whole = one.ingest_raw_window(raw)
    chunks = native.split_groups(raw, 4)
    port, ref = _pair()
    got = port.ingest_raw_stream(chunks)
    assert whole["spans"] == 1
    assert got["spans"] == len(chunks) == 4
    assert got["traces"] == whole["traces"] == 24
    assert got["edges"] == whole["edges"] and got["endpoints"] == whole["endpoints"]
    assert_same_summary(got, ref.ingest_raw_stream(chunks))
    assert_same_state(port, ref)


def test_synthetic_window_streams_like_jax():
    """A seeded BASELINE-shaped window (7-span chains), split by the
    native splitter, into one persistent processor per package: twice
    (the second all deduplicated), then a half-new window."""
    kw = dict(n_services=40, urls_per_service=5)
    port, ref = _pair()
    for raw in (
        synth.make_raw_window(240, 7, **kw),
        synth.make_raw_window(240, 7, **kw),
        synth.make_raw_window(240, 7, t_start=120, **kw),
    ):
        chunks = native.split_groups(raw, 4)
        assert chunks == jax_native.split_groups(raw, 4)
        assert_same_summary(port.ingest_raw_stream(chunks), ref.ingest_raw_stream(chunks))
        assert_same_state(port, ref)
    assert port.graph.n_edges > 100


# -- split_groups ------------------------------------------------------------------


@pytest.mark.parametrize("n_chunks", [1, 4, 6, 40])
def test_split_groups_is_the_jax_binding(n_chunks):
    groups = [[mk_span(f"t{t}", f"s{t}")] for t in range(17)]
    raw = json.dumps(groups).encode()
    chunks = native.split_groups(raw, n_chunks)
    assert chunks == jax_native.split_groups(raw, n_chunks)
    assert 1 <= len(chunks) <= n_chunks
    # each chunk is a standalone response; together they hold every group
    assert [g for c in chunks for g in json.loads(c)] == groups


def test_split_groups_adversarial_strings():
    """Brackets, escaped quotes and backslash runs inside strings split as
    the JAX binding splits them."""
    names = ["a]b[c", 'quote\\"inside', "run\\\\\\x][", "[[[]]]", "comma,]like"]
    groups = []
    for t, name in enumerate(names * 5):
        s = mk_span(f"evil{t}", f"id{t}")
        s["name"] = name
        s["tags"]["http.url"] = f"http://h/[{name}]?q=\\]"
        groups.append([s])
    raw = json.dumps(groups).encode()
    chunks = native.split_groups(raw, 5)
    assert chunks == jax_native.split_groups(raw, 5)
    assert sum(len(json.loads(c)) for c in chunks) == len(groups)


@pytest.mark.parametrize("raw", [b'[[{"truncated', b"[[", b"not json"])
def test_split_groups_malformed_is_none(raw):
    assert native.split_groups(raw, 4) is None
    assert jax_native.split_groups(raw, 4) is None


def test_split_groups_undecodable_answer_raises(monkeypatch):
    """An answer that does not decode is the binding's fault: RuntimeError,
    not a malformed input."""
    raw = json.dumps([[mk_span("t", "s")]]).encode()
    real = native.struct.unpack_from

    def broken(fmt, buf, pos=0):
        if fmt == "<2Q":
            return (len(raw) + 5, len(raw) + 9)  # past the input
        return real(fmt, buf, pos)

    monkeypatch.setattr(native.struct, "unpack_from", broken)
    with pytest.raises(RuntimeError, match="undecodable"):
        native.split_groups(raw, 2)


# -- POST /ingest ------------------------------------------------------------------


def _post(port_no, body, gzipped=True):
    headers = {"Content-Encoding": "gzip"} if gzipped else {}
    req = urllib.request.Request(
        f"http://127.0.0.1:{port_no}/ingest",
        data=gzip.compress(body) if gzipped else body,
        headers=headers,
        method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _without_times(summary):
    return {
        k: v
        for k, v in summary.items()
        if k not in ("ms", "drain_ms", "parse_ms", "merge_ms", "saved_ms", "chunk_detail", "ring_peak")
    }


def test_http_ingest_streams_over_the_threshold():
    """A decompressed body at or over the server's stream_bytes splits into
    stream_chunks chunks through ingest_raw_stream, with the summary and
    graph of a direct stream of the same chunks; under it, or as a KMZC
    frame, a body is one window."""
    kw = dict(n_services=30, urls_per_service=4)
    big = synth.make_raw_window(200, 7, trace_prefix="big", **kw)
    small = synth.make_raw_window(20, 7, trace_prefix="small", **kw)
    frame = wire.encode_groups(json.loads(synth.make_raw_window(400, 7, trace_prefix="frame", **kw)))
    threshold = len(small) + 1
    assert len(big) >= threshold and len(frame) >= threshold
    twin = DataProcessor(lambda *a: [], device="cpu")
    direct = twin.ingest_raw_stream(native.split_groups(big, 4))
    dp = DataProcessor(lambda *a: [], device="cpu")
    server = DataProcessorServer(dp, host="127.0.0.1", port=0, stream_bytes=threshold)
    server.start()
    try:
        status, summary = _post(server.port, big)
        assert status == 200
        assert summary["chunks"] == 4 and summary["pipeline_depth"] == DEFAULT_STREAM_DEPTH
        assert _without_times(summary) == _without_times(direct)
        assert graph_signature(dp.graph) == graph_signature(twin.graph)

        status, summary = _post(server.port, small)
        assert status == 200 and "pipeline_depth" not in summary
        assert summary["traces"] == 20

        # a KMZC frame over the threshold is indivisible: one window
        status, summary = _post(server.port, frame)
        assert status == 200 and "pipeline_depth" not in summary and summary["traces"] == 400

        # a malformed body over the threshold: no split, and the window
        # path answers 400
        status, answer = _post(server.port, b"[[" + b" " * threshold)
        assert status == 400 and "error" in answer
    finally:
        server.stop()


def test_http_ingest_stream_chunks_argument():
    """stream_chunks sets the split; a split into one chunk takes the
    window path."""
    raw = synth.make_raw_window(60, 7, trace_prefix="c", n_services=30, urls_per_service=4)
    for n_chunks, streamed in ((3, True), (1, False)):
        dp = DataProcessor(lambda *a: [], device="cpu")
        server = DataProcessorServer(
            dp, host="127.0.0.1", port=0, stream_bytes=1, stream_chunks=n_chunks
        )
        server.start()
        try:
            status, summary = _post(server.port, raw, gzipped=False)
        finally:
            server.stop()
        assert status == 200 and summary["traces"] == 60
        assert ("pipeline_depth" in summary) == streamed
        if streamed:
            assert summary["chunks"] == n_chunks


# -- the Zipkin page feeder ----------------------------------------------------------


class _MockApi(BaseHTTPRequestHandler):
    routes = {}
    seen = []

    def log_message(self, *args):
        pass

    def _serve(self):
        split = urlsplit(self.path)
        type(self).seen.append((self.command, self.path))
        handler = self.routes.get((self.command, split.path))
        if handler is None:
            self.send_response(404)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        status, payload, use_gzip = handler(parse_qs(split.query))
        body = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
        if use_gzip:
            body = gzip.compress(body)
        self.send_response(status)
        if use_gzip:
            self.send_header("Content-Encoding", "gzip")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    do_GET = _serve


@pytest.fixture()
def mock_api():
    _MockApi.routes = {}
    _MockApi.seen = []
    server = ThreadingHTTPServer(("127.0.0.1", 0), _MockApi)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield server, _MockApi
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _base(server) -> str:
    return f"http://127.0.0.1:{server.server_address[1]}"


def _page_span(tid, sid, svc="svc"):
    s = mk_span(tid, sid, name=f"{svc}.ns.svc.cluster.local:80/*")
    s["tags"]["http.url"] = f"http://{svc}.ns.svc.cluster.local/api"
    s["tags"]["istio.canonical_service"] = svc
    return s


@pytest.mark.parametrize("pages,look_back,end_ts", [(4, 8000, 100_000), (3, 1000, 5_000), (1, 700, 10)])
def test_pages_split_the_lookback_window(mock_api, pages, look_back, end_ts):
    """Contiguous sub-windows, oldest first, ending at end_ts: the same
    queries as the JAX client's."""
    server, api = mock_api
    queries = []

    def traces(params):
        queries.append((int(params["endTs"][0]), int(params["lookback"][0])))
        page = len(queries) - 1
        return 200, [[_page_span(f"t{page}", f"s{page}")]], False

    api.routes[("GET", "/zipkin/api/v2/traces")] = traces
    got = list(ZipkinClient(_base(server)).iter_trace_pages_raw(look_back, end_ts=end_ts, pages=pages))
    port_queries, queries[:] = list(queries), []
    want = list(JaxZipkin(_base(server)).iter_trace_pages_raw(look_back, end_ts=end_ts, pages=pages))
    assert got == want and len(got) == pages
    assert port_queries == queries
    assert port_queries[-1] == (end_ts, int(look_back / pages))
    assert json.loads(got[0])[0][0]["traceId"] == "t0"


def test_empty_and_failed_pages_are_skipped(mock_api, monkeypatch):
    # one attempt per fetch in both packages: the JAX package's env knob,
    # the port's module constant
    monkeypatch.setenv("KMAMIZ_RETRY_ATTEMPTS", "1")
    monkeypatch.setattr(port_retry, "ATTEMPTS", 1)
    server, api = mock_api
    calls = {"n": 0}

    def traces(params):
        calls["n"] += 1
        if calls["n"] % 4 == 2:
            return 500, {"error": "boom"}, False
        if calls["n"] % 4 == 3:
            return 200, b"", False
        return 200, [[_page_span(f"t{calls['n']}", "s")]], False

    api.routes[("GET", "/zipkin/api/v2/traces")] = traces
    pages = list(ZipkinClient(_base(server)).iter_trace_pages_raw(4000, 0, pages=4))
    assert calls["n"] == 4
    assert len(pages) == 2  # page 2 failed, page 3 empty
    assert len(list(JaxZipkin(_base(server)).iter_trace_pages_raw(4000, 0, pages=4))) == 2


def test_fetch_is_lazy(mock_api):
    server, api = mock_api
    calls = {"n": 0}

    def traces(params):
        calls["n"] += 1
        return 200, [[_page_span(f"t{calls['n']}", "s")]], False

    api.routes[("GET", "/zipkin/api/v2/traces")] = traces
    it = ZipkinClient(_base(server)).iter_trace_pages_raw(4000, 0, pages=4)
    assert calls["n"] == 0
    next(it)
    assert calls["n"] == 1


def test_trace_list_and_services_like_jax(mock_api):
    """The rest of the client: the trace-list query (gzip), the raw list,
    the services, and the error postures ([] / None)."""
    server, api = mock_api
    groups = [[_page_span("t1", "a")], [_page_span("t2", "b")]]
    api.routes[("GET", "/zipkin/api/v2/traces")] = lambda q: (200, groups, True)
    api.routes[("GET", "/zipkin/api/v2/services")] = lambda q: (200, ["a", "b"], False)
    port, ref = ZipkinClient(_base(server)), JaxZipkin(_base(server))
    assert port.get_trace_list(30_000, 1_000_000, limit=2500) == groups
    assert port.get_trace_list_raw(30_000, 1_000_000) == ref.get_trace_list_raw(30_000, 1_000_000)
    assert port.get_services() == ref.get_services() == ["a", "b"]
    paths = [p for _, p in api.seen if "/traces" in p]
    query = parse_qs(urlsplit(paths[0]).query)
    assert query["serviceName"] == ["istio-ingressgateway.istio-system"]
    assert query["lookback"] == ["30000"] and query["endTs"] == ["1000000"]
    assert query["limit"] == ["2500"]
    api.routes.clear()
    assert port.get_trace_list(1000, 1000) == [] and port.get_trace_list_raw(1000, 1000) is None
    assert port.get_services() == []
    with pytest.raises(ValueError):
        ZipkinClient("")


def test_ingest_from_zipkin_streams_all_pages(mock_api):
    """Paginated fetch, chunked parse, staged merge: a trace returned by
    two adjacent pages merges once, as in the JAX processor."""
    server, api = mock_api
    pages = [
        [[_page_span("t0", "a", svc="alpha")]],
        [[_page_span("t0", "a", svc="alpha")], [_page_span("t1", "b", svc="beta")]],
        [[_page_span("t2", "c", svc="gamma")]],
    ]
    calls = {"n": 0}

    def traces(params):
        body = pages[calls["n"] % len(pages)]
        calls["n"] += 1
        return 200, body, False

    api.routes[("GET", "/zipkin/api/v2/traces")] = traces
    port, ref = _pair()
    got = port.ingest_from_zipkin(ZipkinClient(_base(server)), 3000, end_ts=9000, pages=3)
    assert calls["n"] == 3
    assert got["traces"] == got["spans"] == got["endpoints"] == 3
    assert len(got["chunk_detail"]) == 3
    want = ref.ingest_from_zipkin(JaxZipkin(_base(server)), 3000, end_ts=9000, pages=3)
    assert_same_summary(got, want)
    assert_same_state(port, ref)

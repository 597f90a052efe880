"""SoA span batches: Zipkin JSON -> fixed-shape host arrays.

The reference walks per-span object graphs
(KMamiz src/classes/Traces.ts:112-211, Rust twin
kmamiz_data_processor/src/data/trace.rs:110-212); here a window of spans
becomes id-indexed arrays. Parent span-ids are resolved to row indices on
the host (strings never reach the device); the CLIENT-skip ancestor walk and
all groupby statistics then run as tensor ops (kmamiz_tpu_torch.ops.window).

Batches are padded to power-of-two sizes, the layout the JAX package uses,
so both packages see identical windows. Two paths build them: the dict
path (spans_to_batch, over json.loads'd trace groups) and the raw-bytes
path (raw_spans_to_batch), whose spans come from the native SoA scanner
of csrc/kmamiz_spans.cpp (kmamiz_tpu_torch.native) and whose naming
resolves through the same _make_naming_entry, so both give the same
batch.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from kmamiz_tpu_torch import native
from kmamiz_tpu_torch.core.interning import EndpointInterner, StringInterner
from kmamiz_tpu_torch.core.schema import js_str as _js
from kmamiz_tpu_torch.domain.traces import to_endpoint_info

KIND_OTHER = 0
KIND_SERVER = 1
KIND_CLIENT = 2


def _pad_size(n: int, base: int = 2, minimum: int = 8) -> int:
    size = minimum
    while size < n:
        size *= base
    return size


@dataclass
class SpanBatch:
    """One window of spans in structure-of-arrays form.

    All arrays share length `capacity` (padded); rows [n_spans:] are padding
    with valid=False. Ids index the accompanying interner tables.
    """

    n_spans: int
    valid: np.ndarray  # bool[capacity]
    kind: np.ndarray  # int8[capacity] (KIND_*)
    parent_idx: np.ndarray  # int32[capacity], -1 = no parent in window
    # graph id space: ToEndpointInfo naming (.svc. parse w/ istio fallback)
    endpoint_id: np.ndarray  # int32[capacity]
    service_id: np.ndarray  # int32[capacity]
    # realtime id space: istio-tag naming used by the stats/combined path
    # (the reference names endpoints differently in toRealTimeData /
    # combineLogsToRealtimeData vs toEndpointDependencies)
    rt_endpoint_id: np.ndarray  # int32[capacity]
    rt_service_id: np.ndarray  # int32[capacity]
    status_id: np.ndarray  # int32[capacity]
    status_class: np.ndarray  # int8[capacity] (first digit of http status)
    latency_ms: np.ndarray  # float64[capacity] (duration / 1000)
    timestamp_us: np.ndarray  # int64[capacity] (host-side absolute)
    timestamp_rel: np.ndarray  # int32[capacity] (µs offset from ts_base_us;
    # absolute µs don't fit int32; the device stats run in int32)
    ts_base_us: int
    # trace membership (index of the first trace group a span id appeared
    # in); feeds pack_trace_rows for the packed ancestor-walk layout
    trace_of: np.ndarray  # int32[capacity]

    interner: EndpointInterner
    statuses: StringInterner
    # per-endpoint metadata for reconstructing protocol output
    endpoint_infos: List[dict]

    @property
    def capacity(self) -> int:
        return len(self.valid)

    @property
    def num_endpoints(self) -> int:
        return len(self.interner.endpoints)

    @property
    def num_services(self) -> int:
        return len(self.interner.services)

    @property
    def num_statuses(self) -> int:
        return len(self.statuses)


class _NamingEntry(NamedTuple):
    """One distinct naming shape's resolved ids and info templates."""

    eid: int
    sid: int
    rt_eid: int
    rt_sid: int
    uen: str
    info_base: dict
    rt_uen: str
    rt_base: dict


def _make_naming_entry(
    span_like: dict, tags: dict, interner: EndpointInterner
) -> _NamingEntry:
    """Resolve one distinct naming shape: graph-space naming via
    to_endpoint_info (Traces.ts:213-241) and realtime-space naming via the
    istio tags, interning both. Shared by the dict path (spans_to_batch)
    and the raw-bytes path (raw_spans_to_batch)."""
    info = to_endpoint_info(span_like)
    uen = info["uniqueEndpointName"]
    info_base = {k_: v for k_, v in info.items() if k_ != "timestamp"}
    eid = interner.intern_endpoint(uen, info)
    rt_usn = (
        f"{_js(tags.get('istio.canonical_service'))}"
        f"\t{_js(tags.get('istio.namespace'))}"
        f"\t{_js(tags.get('istio.canonical_revision'))}"
    )
    rt_uen = (
        f"{rt_usn}\t{_js(tags.get('http.method'))}"
        f"\t{_js(tags.get('http.url'))}"
    )
    # metadata for the rt-space endpoint carries the rt naming
    # (istio tags), not the graph-space info
    rt_base = {
        **info_base,
        "service": tags.get("istio.canonical_service"),
        "namespace": tags.get("istio.namespace"),
        "version": tags.get("istio.canonical_revision"),
        "uniqueServiceName": rt_usn,
        "uniqueEndpointName": rt_uen,
    }
    rt_eid = interner.intern_endpoint(
        rt_uen, {**rt_base, "timestamp": info["timestamp"]}
    )
    return _NamingEntry(
        eid=eid,
        sid=interner.service_of(eid),
        rt_eid=rt_eid,
        rt_sid=interner.service_of(rt_eid),
        uen=uen,
        info_base=info_base,
        rt_uen=rt_uen,
        rt_base=rt_base,
    )


def _apply_best_ts(
    best_ts: "Dict[int, Tuple[float, _NamingEntry]]", interner: EndpointInterner
) -> None:
    """Apply the freshest timestamp per endpoint (intern_endpoint keeps the
    max vs any info already stored by earlier windows)."""
    for key_eid, (ts_ms, hit) in best_ts.items():
        if key_eid == hit.eid:
            interner.intern_endpoint(hit.uen, {**hit.info_base, "timestamp": ts_ms})
        else:
            interner.intern_endpoint(
                hit.rt_uen, {**hit.rt_base, "timestamp": ts_ms}
            )


def _compute_timestamp_rel(
    timestamp_us: np.ndarray, n: int, capacity: int, ts_base_us: Optional[int]
) -> Tuple[np.ndarray, int]:
    if ts_base_us is not None:
        ts_base = ts_base_us
    else:
        ts_base = int(timestamp_us[:n].min()) if n else 0
    timestamp_rel = np.zeros(capacity, dtype=np.int32)
    if n:
        span_rel = timestamp_us[:n] - ts_base
        if span_rel.max() > np.iinfo(np.int32).max:
            # one batch must fit int32 µs offsets (~35 min); realtime windows
            # are 30 s — long replays/backfills must split into batches
            raise ValueError(
                "span window exceeds int32 µs range; split the batch "
                f"(span of {span_rel.max() / 1e6:.0f}s)"
            )
        timestamp_rel[:n] = span_rel.astype(np.int32)
    return timestamp_rel, ts_base


def spans_to_batch(
    trace_groups: Sequence[Sequence[dict]],
    interner: Optional[EndpointInterner] = None,
    statuses: Optional[StringInterner] = None,
    pad: bool = True,
    ts_base_us: Optional[int] = None,
) -> SpanBatch:
    """Flatten Zipkin trace groups into a SpanBatch.

    Mirrors the reference's span-map construction: spans are keyed by id with
    last-wins/first-position semantics (JS Map), and parent ids resolve only
    within the window.
    """
    interner = interner or EndpointInterner()
    statuses = statuses or StringInterner()

    span_map: Dict[str, dict] = {}
    trace_of_id: Dict[str, int] = {}
    for g, group in enumerate(trace_groups):
        for span in group:
            span_map[span["id"]] = span
            # first-position wins, like the span map itself
            trace_of_id.setdefault(span["id"], g)
    spans = list(span_map.values())
    index_of = {span_id: i for i, span_id in enumerate(span_map.keys())}

    n = len(spans)
    capacity = _pad_size(n) if pad else max(n, 1)

    # per-window memo: spans repeat a small set of naming shapes, so the
    # string formatting / URL explode / interning runs once per distinct
    # (name, url, method, istio tags) combination instead of per span
    # (~3x host ingest). Statuses cache separately (an endpoint emitting
    # five statuses still resolves its naming once). Freshest-timestamp
    # info semantics are preserved by tracking the max-ts span per
    # endpoint and applying it after the loop. The per-span columns
    # accumulate in Python lists and land in the arrays as one bulk
    # assignment each — per-element numpy scalar stores were the single
    # largest host cost of the pack.
    naming_cache: Dict[tuple, "_NamingEntry"] = {}
    status_cache: Dict[Optional[str], Tuple[int, int]] = {}
    best_ts: Dict[int, Tuple[float, "_NamingEntry"]] = {}

    kind_l = []
    parent_l = []
    eid_l = []
    sid_l = []
    rt_eid_l = []
    rt_sid_l = []
    stid_l = []
    stcl_l = []
    lat_l = []
    ts_l = []
    trace_l = []

    for span in spans:
        trace_l.append(trace_of_id[span["id"]])
        k = span.get("kind")
        kind_l.append(
            KIND_SERVER if k == "SERVER" else KIND_CLIENT if k == "CLIENT" else KIND_OTHER
        )
        parent = span.get("parentId")
        if parent is not None:
            parent_l.append(index_of.get(parent, -1))
        else:
            parent_l.append(-1)

        tags = span.get("tags", {})
        key = (
            span.get("name", ""),
            tags.get("http.url", ""),
            tags.get("http.method"),
            tags.get("istio.canonical_service"),
            tags.get("istio.namespace"),
            tags.get("istio.canonical_revision"),
            tags.get("istio.mesh_id"),
        )
        hit = naming_cache.get(key)
        if hit is None:
            hit = _make_naming_entry(span, tags, interner)
            naming_cache[key] = hit

        raw_status = tags.get("http.status_code")
        st = status_cache.get(raw_status)
        if st is None:
            status = raw_status or ""
            st = (
                statuses.intern(status),
                int(status[0]) if status[:1].isdigit() else 0,
            )
            status_cache[raw_status] = st

        eid_l.append(hit.eid)
        sid_l.append(hit.sid)
        rt_eid_l.append(hit.rt_eid)
        rt_sid_l.append(hit.rt_sid)
        stid_l.append(st[0])
        stcl_l.append(st[1])
        lat_l.append(span.get("duration", 0) / 1000)
        ts_us = span.get("timestamp", 0)
        ts_l.append(ts_us)
        ts_ms = ts_us / 1000
        for key_eid in (hit.eid, hit.rt_eid):
            prev = best_ts.get(key_eid)
            if prev is None or ts_ms > prev[0]:
                best_ts[key_eid] = (ts_ms, hit)

    valid = np.zeros(capacity, dtype=bool)
    kind = np.zeros(capacity, dtype=np.int8)
    parent_idx = np.full(capacity, -1, dtype=np.int32)
    endpoint_id = np.zeros(capacity, dtype=np.int32)
    service_id = np.zeros(capacity, dtype=np.int32)
    rt_endpoint_id = np.zeros(capacity, dtype=np.int32)
    rt_service_id = np.zeros(capacity, dtype=np.int32)
    status_id = np.zeros(capacity, dtype=np.int32)
    status_class = np.zeros(capacity, dtype=np.int8)
    # graftlint: disable=dtype-drift -- host span column: latency sums stay exact in f64; device path downcasts at upload
    latency_ms = np.zeros(capacity, dtype=np.float64)
    timestamp_us = np.zeros(capacity, dtype=np.int64)
    trace_of = np.zeros(capacity, dtype=np.int32)
    if n:
        valid[:n] = True
        kind[:n] = kind_l
        parent_idx[:n] = parent_l
        endpoint_id[:n] = eid_l
        service_id[:n] = sid_l
        rt_endpoint_id[:n] = rt_eid_l
        rt_service_id[:n] = rt_sid_l
        status_id[:n] = stid_l
        status_class[:n] = stcl_l
        latency_ms[:n] = lat_l
        timestamp_us[:n] = ts_l
        trace_of[:n] = trace_l

    _apply_best_ts(best_ts, interner)
    endpoint_infos = [i for i in interner.endpoint_infos if i is not None]
    timestamp_rel, ts_base = _compute_timestamp_rel(
        timestamp_us, n, capacity, ts_base_us
    )
    return SpanBatch(
        n_spans=n,
        valid=valid,
        kind=kind,
        parent_idx=parent_idx,
        endpoint_id=endpoint_id,
        service_id=service_id,
        rt_endpoint_id=rt_endpoint_id,
        rt_service_id=rt_service_id,
        status_id=status_id,
        status_class=status_class,
        latency_ms=latency_ms,
        timestamp_us=timestamp_us,
        timestamp_rel=timestamp_rel,
        ts_base_us=ts_base,
        trace_of=trace_of,
        interner=interner,
        statuses=statuses,
        endpoint_infos=endpoint_infos,
    )


# -- the raw-bytes path: the native SoA loader --------------------------------


def _entry_from_decoded(
    dec: Tuple[str, ...],
    url_present: bool,
    bits: int,
    interner: EndpointInterner,
) -> _NamingEntry:
    """Decoded native shape fields + presence bits -> resolved naming
    entry (the one definition the per-call and session paths share).
    Timestamp 0: the caller applies the freshest-timestamp info from the
    per-shape max, which dominates any intermediate."""
    name, url, method, svc, ns, rev, mesh = dec
    tags: Dict[str, str] = {}
    if url_present:
        tags["http.url"] = url
    if bits & native.SHAPE_HAS_METHOD:
        tags["http.method"] = method
    if bits & native.SHAPE_HAS_SVC:
        tags["istio.canonical_service"] = svc
    if bits & native.SHAPE_HAS_NS:
        tags["istio.namespace"] = ns
    if bits & native.SHAPE_HAS_REV:
        tags["istio.canonical_revision"] = rev
    if bits & native.SHAPE_HAS_MESH:
        tags["istio.mesh_id"] = mesh
    return _make_naming_entry(
        {"name": name, "timestamp": 0, "tags": tags}, tags, interner
    )


def _shape_cache(interner: EndpointInterner) -> dict:
    """Resolved naming entries by raw shape key, kept on the interner
    across calls: a chunked stream meets the same shapes every page, and
    re-resolving them (URL explode + naming joins) costs more than the
    native parse saves. Entries are immutable ids, and a hit skips only
    work whose outputs are already interned."""
    cache = getattr(interner, "_raw_shape_cache", None)
    if cache is None:
        cache = interner._raw_shape_cache = {}
    return cache


def _status_columns(new_statuses: Sequence[str], statuses: StringInterner):
    """Distinct native status strings -> (interner ids, status classes)."""
    ids = np.empty(len(new_statuses), np.int32)
    cls = np.zeros(len(new_statuses), np.int8)
    for i, s in enumerate(new_statuses):
        ids[i] = statuses.intern(s)
        cls[i] = int(s[0]) if s[:1].isdigit() else 0
    return ids, cls


def _raw_batch(parsed, pad, ts_base_us, interner, statuses, by_shape, by_status):
    """The SpanBatch of a native parse: every id column is a gather of the
    per-shape (eid, sid, rt_eid, rt_sid) and per-status (id, class)
    tables through the span's shape/status ids."""
    n = parsed["n_spans"]
    capacity = _pad_size(n) if pad else max(n, 1)
    valid = np.zeros(capacity, dtype=bool)
    valid[:n] = True

    def _padded(arr: np.ndarray, dtype, fill=0):
        out = np.full(capacity, fill, dtype=dtype)
        out[:n] = arr[:n]
        return out

    shape_ids = parsed["shape_id"][:n]
    status_ids = parsed["status_id"][:n]
    cols = [np.zeros(capacity, dtype=np.int32) for _ in range(5)]
    status_class = np.zeros(capacity, dtype=np.int8)
    if n:
        for col, table in zip(cols, by_shape):
            col[:n] = table[shape_ids]
        cols[4][:n] = by_status[0][status_ids]
        status_class[:n] = by_status[1][status_ids]
    endpoint_id, service_id, rt_endpoint_id, rt_service_id, status_id = cols

    timestamp_us = _padded(parsed["timestamp_us"], np.int64)
    timestamp_rel, ts_base = _compute_timestamp_rel(
        timestamp_us, n, capacity, ts_base_us
    )
    return SpanBatch(
        n_spans=n,
        valid=valid,
        kind=_padded(parsed["kind"], np.int8),
        parent_idx=_padded(parsed["parent_idx"], np.int32, fill=-1),
        endpoint_id=endpoint_id,
        service_id=service_id,
        rt_endpoint_id=rt_endpoint_id,
        rt_service_id=rt_service_id,
        status_id=status_id,
        status_class=status_class,
        latency_ms=_padded(parsed["latency_ms"], np.float64),  # graftlint: disable=dtype-drift -- host span column, f64 by design (see spans_to_batch)
        timestamp_us=timestamp_us,
        timestamp_rel=timestamp_rel,
        ts_base_us=ts_base,
        trace_of=_padded(parsed["trace_of"], np.int32),
        interner=interner,
        statuses=statuses,
        endpoint_infos=[i for i in interner.endpoint_infos if i is not None],
    )


def raw_spans_to_batch(
    raw: bytes,
    interner: Optional[EndpointInterner] = None,
    statuses: Optional[StringInterner] = None,
    pad: bool = True,
    ts_base_us: Optional[int] = None,
    skip_trace_ids: Sequence = (),
    skip_blob: Optional[bytes] = None,
    skipset=None,
    session: "Optional[RawIngestSession]" = None,
):
    """Native ingest: raw Zipkin response bytes (or a KMZC columnar frame)
    -> (SpanBatch, kept trace ids), without json.loads or a per-span dict
    walk.

    The C++ scanner (csrc/kmamiz_spans.cpp) emits SoA arrays plus the
    distinct naming shapes; only O(#shapes) string work (URL explode,
    naming, interning) runs here, through the same _make_naming_entry the
    dict path uses, so the batch equals spans_to_batch(json.loads(raw))
    after DataProcessor._filter_traces with `skip_trace_ids` as the
    processed set.

    Returns None when the payload is malformed, with the interner
    untouched. Raises RuntimeError for a fault on this side: the native
    library cannot build (it builds on first use), its answer does not
    decode, or the session's watermark has desynced.
    """
    # the session resolves against ITS OWN interner/status tables and
    # carries dedup state only through the skipset handle: with a
    # different interner or blob-style skip args it would silently ignore
    # what the caller passed, so those take the per-call path
    if (
        session is not None
        and not skip_trace_ids
        and skip_blob is None
        and (interner is None or interner is session.interner)
        and (statuses is None or statuses is session.statuses)
    ):
        return _raw_spans_to_batch_session(raw, session, pad, ts_base_us, skipset)

    parsed = native.parse_spans(
        raw, list(skip_trace_ids), skip_blob=skip_blob, skipset=skipset
    )
    if parsed is None:
        return None

    interner = interner or EndpointInterner()
    statuses = statuses or StringInterner()

    # resolve each distinct naming shape once, in first-encounter order.
    # Fields arrive as raw bytes; ALL misses decode BEFORE any interning:
    # a malformed shape rejects the payload with None instead of raising
    # mid-loop after earlier shapes mutated the shared interner.
    shape_cache = _shape_cache(interner)
    try:
        decoded = {
            key: tuple(f.decode("utf-8", "surrogatepass") for f in key[0])
            for shape in parsed["shapes"]
            if (key := (shape[0], shape[1], shape[2])) not in shape_cache
        }
    except UnicodeDecodeError:
        return None
    entries: List[_NamingEntry] = []
    for fields, url_present, bits in parsed["shapes"]:
        cache_key = (fields, url_present, bits)
        entry = shape_cache.get(cache_key)
        if entry is None:
            entry = _entry_from_decoded(
                decoded[cache_key], url_present, bits, interner
            )
            shape_cache[cache_key] = entry
        entries.append(entry)

    by_status = _status_columns(parsed["statuses"], statuses)

    # freshest timestamp per endpoint (the dict path's strict-> update
    # order: shapes come in first-appearance order)
    best_ts: Dict[int, Tuple[float, _NamingEntry]] = {}
    for shape_idx, hit in enumerate(entries):
        ts_ms = float(parsed["shape_max_ts_ms"][shape_idx])
        for key_eid in (hit.eid, hit.rt_eid):
            prev = best_ts.get(key_eid)
            if prev is None or ts_ms > prev[0]:
                best_ts[key_eid] = (ts_ms, hit)
    _apply_best_ts(best_ts, interner)

    by_shape = [
        np.array([getattr(e, f) for e in entries], dtype=np.int32)
        for f in ("eid", "sid", "rt_eid", "rt_sid")
    ]
    batch = _raw_batch(parsed, pad, ts_base_us, interner, statuses, by_shape, by_status)
    return batch, parsed["trace_ids"]


class KeptTraceIds(list):
    """Kept trace ids (list semantics, None markers kept) plus the raw
    interleaved skip-entry bytes of the SAME records — byte-identical to
    native.encode_skip_entry output, so the dedup registration can append
    one slice instead of re-encoding every id."""

    __slots__ = ("blob",)

    def __init__(self, ids, blob: Optional[bytes] = None) -> None:
        super().__init__(ids)
        self.blob = blob


class RawIngestSession:
    """Cross-call state of the persistent-session ingest path.

    Pairs the native ParseSession (persistent shape/status tables, delta
    string emission) with the Python-side resolutions its global ids
    index: naming entries per session shape id, the interner id gather
    tables, status ids/classes, and the per-endpoint freshest-timestamp
    bookkeeping that replaces the per-call _apply_best_ts walk with a
    vectorized winner selection. One session per (DataProcessor,
    interner); a rejected payload resets it (the native tables may hold
    entries Python never consumed)."""

    def __init__(
        self,
        interner: EndpointInterner,
        statuses: Optional[StringInterner] = None,
    ) -> None:
        self.interner = interner
        self.statuses = statuses or StringInterner()
        self.native = native.ParseSession()
        # one consumer at a time: the Python-side views must extend in the
        # order the native watermark advances (concurrent raw ingests queue
        # here instead of tripping the desync reset)
        self.lock = threading.Lock()
        self._reset_views()

    def _reset_views(self) -> None:
        self.entries: List[_NamingEntry] = []
        # eid, sid, rt_eid, rt_sid per session shape id
        self.by_shape = [np.zeros(0, np.int32) for _ in range(4)]
        self.st_ids = np.zeros(0, np.int32)
        self.st_cls = np.zeros(0, np.int8)
        # per-ENDPOINT winner bookkeeping: code = 2*shape_idx + is_rt
        # (session shape ids are stable, so codes stay comparable)
        self.applied_code = np.full(0, -1, np.int64)
        self.applied_ts = np.zeros(0, np.float64)  # graftlint: disable=dtype-drift -- epoch-ms bookkeeping exceeds f32 integer range

    def reset(self) -> None:
        """Fresh native session + cleared views (after a rejected payload,
        whose native-side interns Python never consumed)."""
        self.native = native.ParseSession()
        self._reset_views()

    def _grow_applied(self, n_ep: int) -> None:
        if self.applied_ts.size < n_ep:
            grow = n_ep - self.applied_ts.size
            self.applied_ts = np.concatenate([self.applied_ts, np.zeros(grow)])
            self.applied_code = np.concatenate(
                [self.applied_code, np.full(grow, -1, np.int64)]
            )


def _raw_spans_to_batch_session(
    raw: bytes,
    session: RawIngestSession,
    pad: bool,
    ts_base_us: Optional[int],
    skipset,
):
    """raw_spans_to_batch through a session, under its lock (one consumer
    at a time). The annotation names the session's class, so the static
    lock model resolves `session.lock` (analysis/concurrency/locks.py)."""
    with session.lock:
        return _session_batch_locked(raw, session, pad, ts_base_us, skipset)


def _session_batch_locked(raw, session, pad, ts_base_us, skipset):
    """Session twin of raw_spans_to_batch's body (caller holds
    session.lock): span columns arrive with session-global shape/status
    ids, so the warm path is pure array gathers — no per-shape dict walk,
    no string decode. Every deviation from the per-call path is a
    monotone-max equivalence (notes inline)."""
    interner = session.interner
    statuses = session.statuses
    parsed = native.parse_spans(raw, skipset=skipset, session=session.native)
    if parsed is None:
        # malformed payload: the native tables may hold unconsumed interns
        session.reset()
        return None
    if len(session.entries) != parsed["shape_base"]:
        # desynced watermark (shared-session misuse): a fault of the
        # caller, not of the payload
        base = parsed["shape_base"]
        session.reset()
        raise RuntimeError(
            f"raw-ingest session desynced: {len(session.entries)} shapes "
            f"resolved, the library's watermark is {base}"
        )

    # -- new shapes: decode EVERYTHING first (reject before interning), then
    # resolve through the interner-level shape cache, so a reset re-resolves
    # warm shapes cheaply and session shapes warm the per-call path too
    new_shapes = parsed["new_shapes"]
    if new_shapes:
        shape_cache = _shape_cache(interner)
        try:
            decoded = [
                tuple(f.decode("utf-8", "surrogatepass") for f in fields)
                for fields, _, _ in new_shapes
            ]
        except UnicodeDecodeError:
            session.reset()
            return None
        base = len(session.entries)
        for (fields, url_present, bits), dec in zip(new_shapes, decoded):
            cache_key = (fields, url_present, bits)
            entry = shape_cache.get(cache_key)
            if entry is None:
                entry = _entry_from_decoded(dec, url_present, bits, interner)
                shape_cache[cache_key] = entry
            session.entries.append(entry)
        fresh = session.entries[base:]
        session.by_shape = [
            np.concatenate([table, np.array([getattr(e, f) for e in fresh], np.int32)])
            for table, f in zip(session.by_shape, ("eid", "sid", "rt_eid", "rt_sid"))
        ]

    if parsed["new_statuses"]:
        add_ids, add_cls = _status_columns(parsed["new_statuses"], statuses)
        session.st_ids = np.concatenate([session.st_ids, add_ids])
        session.st_cls = np.concatenate([session.st_cls, add_cls])

    # everything decoded and resolved: acknowledge, so the next parse stops
    # re-emitting these shapes/statuses
    session.native.ack(parsed["shapes_total"], parsed["statuses_total"])

    # -- freshest timestamp per endpoint, vectorized --------------------------
    # The winner matches the per-call loop exactly: max cumulative shape ts
    # per endpoint, ties broken by the lowest (shape, eid-before-rt) code;
    # application is strict-> so replaying an applied max is a no-op (the
    # session ts is cumulative where the per-call path saw window-local
    # maxima: a monotone-max equivalence).
    n_shapes = parsed["shapes_total"]
    if n_shapes:
        # graftlint: disable=dtype-drift -- epoch-ms timestamps exceed f32 integer range
        shape_ts = np.asarray(parsed["shape_max_ts_ms"], dtype=np.float64)
        idx = np.arange(n_shapes, dtype=np.int64)
        eids_all = np.concatenate([session.by_shape[0], session.by_shape[2]]).astype(np.int64)
        ts_all = np.concatenate([shape_ts, shape_ts])
        code_all = np.concatenate([2 * idx, 2 * idx + 1])
        order = np.lexsort((code_all, -ts_all, eids_all))
        e_sorted = eids_all[order]
        first = np.ones(e_sorted.size, bool)
        first[1:] = e_sorted[1:] != e_sorted[:-1]
        win_eid = e_sorted[first]
        win_ts = ts_all[order][first]
        win_code = code_all[order][first]
        session._grow_applied(len(interner.endpoints))
        adv = win_ts > session.applied_ts[win_eid]
        # in-place fast path: the same winner as last time AND (checked
        # atomically under the interner lock) nobody else — e.g. the
        # dict-path tick — refreshed the info since, so only the timestamp
        # moves. A failed compare-and-set takes the exact slow path.
        fast = adv & (win_code == session.applied_code[win_eid])
        fast_pos = np.flatnonzero(fast)
        slow_pos = np.flatnonzero(adv & ~fast)
        if fast_pos.size:
            failed = interner.refresh_info_timestamps(
                win_eid[fast_pos],
                win_ts[fast_pos],
                expected_ts=session.applied_ts[win_eid[fast_pos]],
            )
            if failed:
                slow_pos = np.concatenate([slow_pos, fast_pos[failed]])
        for p in slow_pos.tolist():
            t, c = float(win_ts[p]), int(win_code[p])
            hit = session.entries[c >> 1]
            if c & 1:
                interner.intern_endpoint(hit.rt_uen, {**hit.rt_base, "timestamp": t})
            else:
                interner.intern_endpoint(hit.uen, {**hit.info_base, "timestamp": t})
        session.applied_ts[win_eid[adv]] = win_ts[adv]
        session.applied_code[win_eid[adv]] = win_code[adv]

    batch = _raw_batch(
        parsed,
        pad,
        ts_base_us,
        interner,
        statuses,
        session.by_shape,
        (session.st_ids, session.st_cls),
    )
    return batch, KeptTraceIds(parsed["trace_ids"], parsed["trace_ids_blob"])


ROW_SLOTS = 64  # spans per packed trace row (the packed ancestor-walk tile)


class PackedRows:
    """Trace-row packing of a SpanBatch for the packed ancestor walk.

    Each trace occupies a contiguous run of slots inside one ROW_SLOTS-slot
    row, so parent pointers become row-local and the CLIENT-skip /
    ancestor-chain hops are row-local gathers
    (kmamiz_tpu_torch.ops.window.dependency_edges_packed). The layout is
    the JAX package's, where the hops run as one-hot einsums on the TPU's
    matrix unit. Traces are bucketed by next-power-of-two size (vectorized packing, at
    most 2x slot waste); rows are padded to a power of two.
    """

    __slots__ = ("row_of", "slot_of", "n_rows", "n_spans", "max_trace_len")

    def __init__(self, row_of, slot_of, n_rows, n_spans, max_trace_len):
        self.row_of = row_of
        self.slot_of = slot_of
        self.n_rows = n_rows
        self.n_spans = n_spans
        # longest trace in the window: ancestor chains cannot exceed
        # max_trace_len - 1 hops, so the packed walk can cap its depth
        self.max_trace_len = max_trace_len

    def pack(self, values: np.ndarray, fill) -> np.ndarray:
        """Scatter a flat per-span array into [n_rows, ROW_SLOTS] layout."""
        out = np.full((self.n_rows, ROW_SLOTS), fill, dtype=values.dtype)
        out[self.row_of, self.slot_of] = values[: self.n_spans]
        return out

    def parent_slots(self, parent_idx: np.ndarray) -> np.ndarray:
        """Translate flat parent indices to row-local parent slots (-1 for
        no parent); feed the result through pack(..., -1)."""
        pslot = np.full(self.n_spans, -1, dtype=np.int32)
        has = parent_idx[: self.n_spans] >= 0
        pslot[has] = self.slot_of[parent_idx[: self.n_spans][has]]
        return pslot


def max_ancestor_chain(parent_idx: np.ndarray, n_spans: int) -> int:
    """Longest parent-chain length in HOPS across the window, memoized
    O(n) (each span's depth computes once). Used by the flat-gather
    merge fallback — the path taken exactly when pack_trace_rows cannot
    lay the window out (overlong traces, cross-trace parents) — to size
    its walk depth: a fixed cap there silently dropped ancestors past it
    while the reference walk is unbounded. A parent CYCLE
    (possible only under adversarial duplicate span ids; the reference's
    while-loop would not terminate on one) counts as a chain end at the
    revisited span."""
    if n_spans == 0:
        return 0
    p = np.asarray(parent_idx[:n_spans], dtype=np.int64)
    depth = np.full(n_spans, 0, dtype=np.int64)  # 0 = unknown; else nodes
    VISITING = -1
    for i in range(n_spans):
        if depth[i] > 0:
            continue
        path = []
        j = i
        while j >= 0 and depth[j] <= 0:
            if depth[j] == VISITING:
                j = -1  # cycle: treat the revisited span as a root edge
                break
            depth[j] = VISITING
            path.append(j)
            nxt = p[j]
            j = int(nxt) if 0 <= nxt < n_spans else -1
        base = int(depth[j]) if j >= 0 else 0
        for k in reversed(path):
            base += 1
            depth[k] = base
    return int(depth.max()) - 1  # hops = chain nodes - 1


def pack_trace_rows(
    trace_of: np.ndarray, n_spans: int, parent_idx: Optional[np.ndarray] = None
) -> Optional[PackedRows]:
    """Assign each span a (row, slot) so its whole trace shares one row.

    Returns None when the layout cannot hold the window — a trace longer
    than ROW_SLOTS, non-contiguous trace membership, or a parent pointer
    crossing traces — in which case callers use the flat gather path.
    """
    if n_spans == 0:
        return None
    t = np.asarray(trace_of[:n_spans])
    if np.any(np.diff(t) < 0):
        return None  # trace ids must be non-decreasing (contiguous traces)
    sizes = np.bincount(t)
    if sizes.size == 0 or sizes.max() > ROW_SLOTS or sizes.min() == 0:
        return None

    n_traces = sizes.size
    first_span = np.zeros(n_traces, dtype=np.int64)
    first_span[1:] = np.cumsum(sizes)[:-1]

    # bucket traces by pow2 size; rows are filled per bucket, vectorized
    bucket = np.maximum(
        1 << (np.ceil(np.log2(np.maximum(sizes, 1))).astype(np.int64)), 1
    )
    row_of_trace = np.zeros(n_traces, dtype=np.int64)
    base_of_trace = np.zeros(n_traces, dtype=np.int64)
    next_row = 0
    for b in np.unique(bucket):
        ids = np.nonzero(bucket == b)[0]
        per_row = ROW_SLOTS // int(b)
        rank = np.arange(len(ids))
        row_of_trace[ids] = next_row + rank // per_row
        base_of_trace[ids] = (rank % per_row) * int(b)
        next_row += -(-len(ids) // per_row)

    offs = np.arange(n_spans, dtype=np.int64) - first_span[t]
    row_of = row_of_trace[t]
    slot_of = base_of_trace[t] + offs
    n_rows = _pad_size(next_row, minimum=1)

    if parent_idx is not None:
        p = np.asarray(parent_idx[:n_spans])
        has_parent = p >= 0
        if np.any(row_of[p[has_parent]] != row_of[has_parent.nonzero()[0]]):
            return None  # cross-trace parent (span-id collision): bail out
    return PackedRows(row_of, slot_of, int(n_rows), n_spans, int(sizes.max()))

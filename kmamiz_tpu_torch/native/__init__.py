"""ctypes binding for the port's native host library.

Counterpart of kmamiz_tpu/native/__init__.py. The library is the port's
own copy of the JAX package's C++ (kmamiz_tpu_torch/csrc/kmamiz_native.cpp,
kmamiz_json.cpp, kmamiz_spans.cpp), built as ONE shared library with g++
by ops/host_build.py at first use, never at import. It carries the raw
Zipkin span scanner (raw bytes or KMZC columnar frames -> SoA arrays,
core.spans.raw_spans_to_batch) and the batched JSON body fold
(core.schema.merge_and_infer_bodies).

There is no pure-Python fallback: a missing compiler or a failed build
raises RuntimeError with the compiler's output, and every entry point
needs the library. A None return from parse_spans means a malformed
payload, never a missing library.

Bound here: the span parse with its blob, skip-set and session variants,
the skip-set and session handles, the group splitter of the streaming
path, the body fold, the envoy-log line parser and istio-proxy prefix
strip (core.envoy), and the profiling counters.
"""
from __future__ import annotations

import ctypes
import logging
import os
import struct
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

from kmamiz_tpu_torch.ops import host_build

logger = logging.getLogger("kmamiz_tpu_torch.native")

NAME = "kmamiz_native"
SOURCES = [
    host_build.CSRC / "kmamiz_native.cpp",
    host_build.CSRC / "kmamiz_json.cpp",
    host_build.CSRC / "kmamiz_spans.cpp",
]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_path: Optional[Path] = None

_size_p = ctypes.POINTER(ctypes.c_size_t)
# name: (argtypes, restype)
_SIGNATURES = {
    "km_free": ([ctypes.c_void_p], None),
    "km_process_body_groups": (
        [ctypes.c_char_p, ctypes.c_size_t, _size_p],
        ctypes.c_void_p,
    ),
    "km_parse_spans_mt": (
        [
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.c_int,
            _size_p,
        ],
        ctypes.c_void_p,
    ),
    "km_split_groups": (
        [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, _size_p],
        ctypes.c_void_p,
    ),
    "km_skipset_new": ([], ctypes.c_void_p),
    "km_skipset_free": ([ctypes.c_void_p], None),
    "km_skipset_extend": (
        [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t],
        ctypes.c_longlong,
    ),
    "km_skipset_clear": ([ctypes.c_void_p], None),
    "km_skipset_size": ([ctypes.c_void_p], ctypes.c_ulonglong),
    "km_parse_spans_hs": (
        [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, _size_p],
        ctypes.c_void_p,
    ),
    "km_session_new": ([], ctypes.c_void_p),
    "km_session_free": ([ctypes.c_void_p], None),
    "km_session_ack": ([ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32], None),
    "km_parse_spans_sess": (
        [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.c_int,
            _size_p,
        ],
        ctypes.c_void_p,
    ),
    "km_parse_envoy_lines": ([ctypes.c_char_p, ctypes.c_size_t, _size_p], ctypes.c_void_p),
    "km_strip_istio_prefix": ([ctypes.c_char_p, ctypes.c_size_t, _size_p], ctypes.c_void_p),
    "km_prof_snapshot": ([_size_p], ctypes.c_void_p),
    "km_prof_reset": ([], None),
    "km_wire_caps": ([], ctypes.c_uint),
}


def _load() -> ctypes.CDLL:
    """The bound library, built on first use. Raises RuntimeError when
    the build fails."""
    global _lib, _lib_path
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            path = host_build.build(NAME, SOURCES)
            lib = ctypes.CDLL(str(path))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib_path, _lib = path, lib
    return _lib


def library_path() -> Path:
    """Path of the loaded library (building and loading it first)."""
    _load()
    return _lib_path


def available() -> bool:
    """Build (on first use) and load the library: True, or RuntimeError.
    Call once at startup to keep the one-time compile off the request
    path."""
    _load()
    return True


def loaded() -> bool:
    """Whether this process has loaded the library (no build, no load)."""
    return _lib is not None


def supports_columnar() -> bool:
    """True when the library decodes "KMZC" columnar frames (km_wire_caps
    bit 0): always, for a library built from the current sources."""
    return bool(_load().km_wire_caps() & 1)


# -- native profiling counters ------------------------------------------------

# the scalar counters of km_prof_snapshot's wire (kmamiz_spans.cpp), in order
_PROF_SCALARS = (
    "parses",
    "spans",
    "merge_ns",
    "merge_lock_wait_ns",
    "merge_queue_depth_peak",
    "claim_contended",
    "intern_probes",
    "intern_hits",
    "fold_ns",
    "fold_chunks",
)


def prof_zero() -> dict:
    """The counters of a process that has parsed nothing: every counter 0,
    `available` False (the library is not loaded)."""
    out = {"available": False, "version": 0, "shards_used": 0, "shards": []}
    out.update(dict.fromkeys(_PROF_SCALARS, 0))
    return out


def prof_counters() -> dict:
    """Cumulative counters of the native parse/merge pipeline (see
    km_prof_snapshot in csrc/kmamiz_spans.cpp): the scalars, the wire
    version, and per-shard parse/wait ns and spans."""
    lib = _load()
    out_len = ctypes.c_size_t(0)
    ptr = lib.km_prof_snapshot(ctypes.byref(out_len))
    if not ptr:
        raise MemoryError("km_prof_snapshot could not allocate")
    try:
        raw = ctypes.string_at(ptr, out_len.value)
    finally:
        lib.km_free(ptr)
    version, shards_used = struct.unpack_from("<II", raw, 0)
    out = {"available": True, "version": version, "shards_used": shards_used}
    out.update(zip(_PROF_SCALARS, struct.unpack_from(f"<{len(_PROF_SCALARS)}Q", raw, 8)))
    off = 8 + 8 * len(_PROF_SCALARS)
    out["shards"] = [
        dict(zip(("parse_ns", "wait_ns", "spans"), struct.unpack_from("<3Q", raw, off + 24 * i)))
        for i in range(shards_used)
    ]
    return out


def prof_reset() -> None:
    """Zero the native profiling counters."""
    _load().km_prof_reset()


# ---------------------------------------------------------------------------
# envoy log lines (csrc/kmamiz_native.cpp)
# ---------------------------------------------------------------------------

# the envoy parser's output separators (kmamiz_native.cpp kFieldSep /
# kRecordSep)
_FIELD_SEP = "\x1f"
_RECORD_SEP = "\x1e"


def _call_lines_fn(fn, lines: List[str]) -> str:
    """One line-buffer entry over `lines` joined by newlines; its answer
    decoded as UTF-8 (bad bytes replaced). Raises MemoryError when the
    library cannot allocate its answer."""
    lib = _load()
    payload = "\n".join(lines).encode()
    out_len = ctypes.c_size_t(0)
    ptr = fn(payload, len(payload), ctypes.byref(out_len))
    if not ptr:
        raise MemoryError(f"{fn.__name__} could not allocate its answer")
    try:
        return ctypes.string_at(ptr, out_len.value).decode("utf-8", "replace")
    finally:
        lib.km_free(ptr)


def strip_istio_proxy_prefix(lines: List[str]) -> List[str]:
    """Istio-proxy container log lines -> 'time\\tpayload' lines: the lines
    carrying a script or wasm log, with the proxy's prefix cut (core.envoy's
    served path)."""
    out = _call_lines_fn(_load().km_strip_istio_prefix, lines)
    return out.split("\n")[:-1] if out else []


def parse_envoy_lines(lines: List[str]) -> List[dict]:
    """The per-line parse of core.envoy.parse_envoy_logs: one raw field
    dict per line with a [Request|Response ...] header (no namespace, pod
    or trace-id decoration)."""
    out = _call_lines_fn(_load().km_parse_envoy_lines, lines)
    records = []
    for record in out.split(_RECORD_SEP):
        if not record:
            continue
        fields = record.split(_FIELD_SEP)
        if len(fields) != 12:
            # a line whose text holds the separator bytes: dropped, as the
            # JAX binding drops it
            continue
        (
            time_str,
            log_type,
            request_id,
            trace_id,
            span_id,
            parent_span_id,
            method,
            path,
            status,
            content_type,
            body,
            body_present,
        ) = fields
        if not path:  # the method/path pattern needs a non-empty path
            method = ""
        records.append(
            {
                "time": time_str,
                "type": log_type,
                "requestId": request_id,
                "traceId": trace_id,
                "spanId": span_id,
                "parentSpanId": parent_span_id,
                "method": method or None,
                "path": path or None,
                "status": status or None,
                "contentType": content_type or None,
                "body": body if body_present == "1" else None,
            }
        )
    return records


# ---------------------------------------------------------------------------
# raw Zipkin JSON -> SoA span arrays (csrc/kmamiz_spans.cpp)
# ---------------------------------------------------------------------------

# naming-shape presence bits (must match kmamiz_spans.cpp)
SHAPE_HAS_METHOD = 1 << 2
SHAPE_HAS_SVC = 1 << 3
SHAPE_HAS_NS = 1 << 4
SHAPE_HAS_REV = 1 << 5
SHAPE_HAS_MESH = 1 << 6


def parse_threads() -> int:
    """Worker count for the native span scan: KMAMIZ_PARSE_THREADS, else 0
    (auto = hardware concurrency, capped at 16 in the library)."""
    try:
        return int(os.environ.get("KMAMIZ_PARSE_THREADS", "0"))
    except ValueError:
        return 0


def effective_parse_threads() -> int:
    """The worker count the native scan actually runs with: the setting
    when explicit, else the hardware-concurrency-capped-at-16 resolution
    kmamiz_spans.cpp applies to 0 (auto)."""
    raw = parse_threads()
    if raw > 0:
        return raw
    return max(1, min(os.cpu_count() or 1, 16))


def encode_skip_entry(tid) -> bytes:
    """One skip-set entry in the parse's blob layout (u8 present + u32
    len + utf8 bytes; None encodes as absent). DataProcessor keeps these
    encodings incrementally instead of re-walking its processed set."""
    if tid is None:
        return struct.pack("<BI", 0, 0)
    b = str(tid).encode("utf-8", "surrogatepass")
    return struct.pack("<BI", 1, len(b)) + b


class SkipSet:
    """Persistent native processed-trace set (km_skipset_* C API).

    The DataProcessor extends it incrementally as traces register
    (`extend` takes encode_skip_entry records, without a count header)
    and passes it to every parse, so a parse does not re-encode and
    re-hash the whole processed set. Thread-safe on the native side."""

    __slots__ = ("_lib", "_handle")

    def __init__(self) -> None:
        self._lib = _load()
        self._handle = self._lib.km_skipset_new()
        if not self._handle:
            raise MemoryError("km_skipset_new failed")

    @property
    def handle(self):
        return self._handle

    def extend(self, entries: bytes) -> int:
        """Add skip-entry records; returns records walked (-1 = malformed)."""
        if not entries:
            return 0
        return int(self._lib.km_skipset_extend(self._handle, bytes(entries), len(entries)))

    def clear(self) -> None:
        self._lib.km_skipset_clear(self._handle)

    def __len__(self) -> int:
        return int(self._lib.km_skipset_size(self._handle))

    def __del__(self) -> None:
        handle, self._handle = getattr(self, "_handle", None), None
        if handle:
            try:
                self._lib.km_skipset_free(handle)
            except (OSError, AttributeError):  # interpreter teardown
                pass


def _unpack_timings(prescan_us: int, parse_us: int, merge_packed: int) -> dict:
    # threads<<25 | merge_us (25-bit µs, ~33 s cap) — see kmamiz_spans.cpp
    return {
        "prescan_us": prescan_us,
        "parse_us": parse_us,
        "merge_us": merge_packed & 0x01FFFFFF,
        "threads": merge_packed >> 25,
    }


def _read_shape_records(buf, pos: int, count: int):
    """`count` serialized shape records (u8 url_present + u8 bits + 7x
    length-prefixed field bytes) -> (records, new_pos). Fields stay raw
    BYTES tuples: consumers cache resolutions keyed on them and decode
    only on a cache miss."""
    shapes = []
    for _ in range(count):
        url_present = buf[pos] != 0
        bits = buf[pos + 1]
        pos += 2
        fields = []
        for _f in range(7):
            (flen,) = struct.unpack_from("<I", buf, pos)
            pos += 4
            fields.append(bytes(buf[pos : pos + flen]))
            pos += flen
        shapes.append((tuple(fields), url_present, bits))
    return shapes, pos


def _read_status_records(buf, pos: int, count: int):
    statuses = []
    for _ in range(count):
        (slen,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        statuses.append(buf[pos : pos + slen].decode("utf-8", "surrogatepass"))
        pos += slen
    return statuses, pos


def _decode_session_payload(buf) -> dict:
    """Decode the session wire format (header ok=2): span columns carry
    session-GLOBAL shape/status ids; shape/status strings appear only for
    the unacked tail [base..total). Raises on a malformed buffer like the
    per-call decode (parse_spans's except clauses handle both)."""
    import numpy as np

    (
        _fmt,
        n,
        shapes_total,
        statuses_total,
        shape_base,
        status_base,
        n_groups,
        prescan_us,
        parse_us,
        merge_packed,
    ) = struct.unpack_from("<10I", buf, 0)
    timings = _unpack_timings(prescan_us, parse_us, merge_packed)
    pos = 40
    latency_ms = np.frombuffer(buf, np.float64, n, pos)
    pos += 8 * n
    timestamp_raw = np.frombuffer(buf, np.float64, n, pos)
    pos += 8 * n
    shape_max_ts_ms = np.frombuffer(buf, np.float64, shapes_total, pos)
    pos += 8 * shapes_total
    parent_idx = np.frombuffer(buf, np.int32, n, pos)
    pos += 4 * n
    shape_id = np.frombuffer(buf, np.int32, n, pos)
    pos += 4 * n
    status_id = np.frombuffer(buf, np.int32, n, pos)
    pos += 4 * n
    trace_of = np.frombuffer(buf, np.int32, n, pos)
    pos += 4 * n
    kind = np.frombuffer(buf, np.int8, n, pos)
    pos += n

    new_shapes, pos = _read_shape_records(buf, pos, shapes_total - shape_base)
    new_statuses, pos = _read_status_records(buf, pos, statuses_total - status_base)

    # kept trace ids, vectorized: presence + length arrays give every
    # record's offset in one cumsum; the ASCII fast path decodes the whole
    # interleaved section once and slices strings out of it (trace ids are
    # hex in real Zipkin data). The interleaved records are byte-identical
    # to the encode_skip_entry layout, so the raw slice also serves as the
    # caller's incremental dedup-blob append.
    present = np.frombuffer(buf, np.uint8, n_groups, pos)
    pos += n_groups
    tlens = np.frombuffer(buf, np.uint32, n_groups, pos).astype(np.int64)
    pos += 4 * n_groups
    blob_len = 5 * n_groups + int(tlens.sum())
    kept_blob = buf[pos : pos + blob_len]
    if len(kept_blob) != blob_len:
        raise ValueError("truncated kept-trace-id section")
    starts = 5 * (np.arange(n_groups, dtype=np.int64) + 1)
    starts[1:] += np.cumsum(tlens[:-1])
    ends = starts + tlens
    present_l = (present != 0).tolist()
    if kept_blob.isascii():
        s = kept_blob.decode("ascii")
        trace_ids = [
            s[a:b] if p else None
            for a, b, p in zip(starts.tolist(), ends.tolist(), present_l)
        ]
    else:
        trace_ids = [
            kept_blob[a:b].decode("utf-8", "surrogatepass") if p else None
            for a, b, p in zip(starts.tolist(), ends.tolist(), present_l)
        ]

    return {
        "n_spans": int(n),
        "kind": kind,
        "parent_idx": parent_idx,
        "shape_id": shape_id,
        "status_id": status_id,
        "trace_of": trace_of,
        "latency_ms": latency_ms,
        "timestamp_us": timestamp_raw.astype(np.int64),
        "shape_max_ts_ms": shape_max_ts_ms,
        "trace_ids": trace_ids,
        "trace_ids_blob": kept_blob,
        "timings": timings,
        "session_format": True,
        "shape_base": int(shape_base),
        "shapes_total": int(shapes_total),
        "status_base": int(status_base),
        "statuses_total": int(statuses_total),
        "new_shapes": new_shapes,
        "new_statuses": new_statuses,
    }


class ParseSession:
    """Persistent native parse session (km_session_* C API).

    Keeps the shape/status intern tables alive across parse calls, so a
    chunked stream does not re-serialize and re-decode the same naming
    shapes every page: spans arrive with session-global ids and only NEW
    (unacknowledged) shapes/statuses carry strings. The caller acks after
    consuming a payload; a rejected payload is never acked and its
    additions re-emit on the next call."""

    __slots__ = ("_lib", "_handle")

    def __init__(self) -> None:
        self._lib = _load()
        self._handle = self._lib.km_session_new()
        if not self._handle:
            raise MemoryError("km_session_new failed")

    @property
    def handle(self):
        return self._handle

    def ack(self, shapes_known: int, statuses_known: int) -> None:
        self._lib.km_session_ack(self._handle, int(shapes_known), int(statuses_known))

    def __del__(self) -> None:
        handle, self._handle = getattr(self, "_handle", None), None
        if handle:
            try:
                self._lib.km_session_free(handle)
            except (OSError, AttributeError):  # interpreter teardown
                pass


def parse_spans(
    raw: bytes,
    skip_trace_ids: Sequence = (),
    threads: Optional[int] = None,
    skip_blob: Optional[bytes] = None,
    skipset: Optional[SkipSet] = None,
    session: Optional[ParseSession] = None,
) -> Optional[dict]:
    """Scan a raw Zipkin JSON response ([[span,...],...]) or a KMZC
    columnar frame into SoA arrays.

    skip_trace_ids: already-processed trace ids (may contain None, as in
    DataProcessor._filter_traces); groups whose first span carries one are
    dropped whole. skip_blob: a pre-encoded skip blob (u32 count +
    encode_skip_entry per id) that REPLACES skip_trace_ids. Either of them
    takes precedence over the persistent `skipset`/`session` handles: a
    caller that passes ids means THAT set.

    threads: native worker count (None -> KMAMIZ_PARSE_THREADS, 0 ->
    auto). The parallel scan keeps the sequential semantics exactly.

    Returns None for a malformed payload (the library rejects it, or a
    string field is not UTF-8), else a dict of numpy arrays
    (kind/parent_idx/shape_id/status_id/trace_of/latency_ms/timestamp_us),
    the distinct naming shapes [(fields7, url_present, presence_bits)],
    shape_max_ts_ms, the distinct status strings, the kept trace ids (None
    markers kept) and the native phase timings. With a session the
    payload is the session format (_decode_session_payload). Raises
    RuntimeError when the library's answer cannot be decoded.
    """
    import numpy as np

    lib = _load()
    if threads is None:
        threads = parse_threads()
    out_len = ctypes.c_size_t(0)
    # the json buffer crosses ctypes without a copy (c_char_p on bytes)
    raw = bytes(raw) if not isinstance(raw, bytes) else raw
    if skip_trace_ids or skip_blob is not None:
        session = None
        skipset = None
    if session is not None:
        # persistent session: global ids + delta shape emission
        ptr = lib.km_parse_spans_sess(
            session.handle,
            skipset.handle if skipset is not None else None,
            raw,
            len(raw),
            int(threads),
            ctypes.byref(out_len),
        )
    elif skipset is not None:
        # persistent skip set: no per-call blob
        ptr = lib.km_parse_spans_hs(
            skipset.handle, raw, len(raw), int(threads), ctypes.byref(out_len)
        )
    else:
        if skip_blob is None:
            skip_blob = bytearray(struct.pack("<I", len(skip_trace_ids)))
            for t in skip_trace_ids:
                skip_blob += encode_skip_entry(t)
        ptr = lib.km_parse_spans_mt(
            bytes(skip_blob),
            len(skip_blob),
            raw,
            len(raw),
            int(threads),
            ctypes.byref(out_len),
        )
    if not ptr:
        return None
    try:
        buf = ctypes.string_at(ptr, out_len.value)
    finally:
        lib.km_free(ptr)

    try:
        (fmt,) = struct.unpack_from("<I", buf, 0)
        if fmt == 2:
            return _decode_session_payload(buf)
        (
            ok,
            n,
            n_shapes,
            n_statuses,
            n_groups,
            prescan_us,
            parse_us,
            merge_packed,
        ) = struct.unpack_from("<8I", buf, 0)
        if ok != 1:
            return None
        timings = _unpack_timings(prescan_us, parse_us, merge_packed)
        pos = 32
        # read-only VIEWS over `buf` (kept alive by the arrays' .base):
        # raw_spans_to_batch copies once into its padded arrays
        latency_ms = np.frombuffer(buf, np.float64, n, pos)
        pos += 8 * n
        timestamp_raw = np.frombuffer(buf, np.float64, n, pos)
        pos += 8 * n
        shape_max_ts_ms = np.frombuffer(buf, np.float64, n_shapes, pos)
        pos += 8 * n_shapes
        parent_idx = np.frombuffer(buf, np.int32, n, pos)
        pos += 4 * n
        shape_id = np.frombuffer(buf, np.int32, n, pos)
        pos += 4 * n
        status_id = np.frombuffer(buf, np.int32, n, pos)
        pos += 4 * n
        trace_of = np.frombuffer(buf, np.int32, n, pos)
        pos += 4 * n
        kind = np.frombuffer(buf, np.int8, n, pos)
        pos += n

        shapes, pos = _read_shape_records(buf, pos, n_shapes)
        statuses, pos = _read_status_records(buf, pos, n_statuses)

        trace_ids = []
        for _ in range(n_groups):
            present = buf[pos] != 0
            (tlen,) = struct.unpack_from("<I", buf, pos + 1)
            pos += 5
            tid = buf[pos : pos + tlen].decode("utf-8", "surrogatepass")
            pos += tlen
            trace_ids.append(tid if present else None)
    except UnicodeDecodeError:
        # string fields carried invalid UTF-8: JSON must be UTF-8, so the
        # payload is malformed — reject it, as json.loads would
        logger.warning("span payload contains invalid UTF-8; rejected")
        return None
    except (struct.error, IndexError, ValueError) as e:
        # the library accepted the payload but its answer does not decode:
        # a fault of this binding, not of the spans
        raise RuntimeError(f"native span payload undecodable: {e}") from e

    return {
        "n_spans": int(n),
        "kind": kind,
        "parent_idx": parent_idx,
        "shape_id": shape_id,
        "status_id": status_id,
        "trace_of": trace_of,
        "latency_ms": latency_ms,
        "timestamp_us": timestamp_raw.astype(np.int64),
        "shapes": shapes,
        "shape_max_ts_ms": shape_max_ts_ms,
        "statuses": statuses,
        "trace_ids": trace_ids,
        "timings": timings,
    }


def split_groups(raw: bytes, n_chunks: int) -> Optional[List[bytes]]:
    """Split a raw Zipkin response into at most n_chunks standalone
    responses, each covering whole trace groups (the streaming ingest's
    chunks). Returns None for a malformed input; raises RuntimeError when
    the library's answer does not decode."""
    lib = _load()
    raw = bytes(raw) if not isinstance(raw, bytes) else raw
    out_len = ctypes.c_size_t(0)
    ptr = lib.km_split_groups(raw, len(raw), int(n_chunks), ctypes.byref(out_len))
    if not ptr:
        return None
    try:
        buf = ctypes.string_at(ptr, out_len.value)
    finally:
        lib.km_free(ptr)
    try:
        (n_ranges,) = struct.unpack_from("<I", buf, 0)
        chunks = []
        for k in range(n_ranges):
            begin, end = struct.unpack_from("<2Q", buf, 4 + 16 * k)
            if not begin <= end <= len(raw):
                raise ValueError(f"range {begin}:{end} outside {len(raw)} bytes")
            chunks.append(b"[" + raw[begin:end] + b"]")
        return chunks
    except (struct.error, ValueError) as e:
        raise RuntimeError(f"native group split undecodable: {e}") from e


# ---------------------------------------------------------------------------
# batched JSON body merge + schema inference (csrc/kmamiz_json.cpp, the
# C++ twin of KMamiz's Rust json_utils.rs)
# ---------------------------------------------------------------------------

BodyGroup = Tuple[Sequence[Optional[str]], bool]  # (bodies, want_interface)


def process_body_groups(
    groups: Sequence[BodyGroup],
) -> List[Optional[Tuple[Optional[str], Optional[str], bool]]]:
    """Fold merge_string_body over each group's bodies and (optionally)
    infer the merged body's interface string, all in one native call.

    Returns one entry per group:
      (merged_body_or_None, interface_or_None, interface_needs_python)
    or None for a group the native side hands back to Python (excessive
    nesting). Raises RuntimeError when the library rejects the call's
    buffer or its answer cannot be decoded: both are faults of this
    binding, not of the bodies.
    """
    lib = _load()
    buf = bytearray()
    buf += struct.pack("<I", len(groups))
    for bodies, want_interface in groups:
        buf.append(1 if want_interface else 0)
        buf += struct.pack("<I", len(bodies))
        for body in bodies:
            if body is None:
                buf.append(0)
            else:
                raw = body.encode("utf-8", "surrogatepass")
                buf.append(1)
                buf += struct.pack("<I", len(raw))
                buf += raw

    out_len = ctypes.c_size_t(0)
    payload = bytes(buf)
    ptr = lib.km_process_body_groups(payload, len(payload), ctypes.byref(out_len))
    if not ptr:
        raise RuntimeError("km_process_body_groups rejected its input buffer")
    try:
        raw_out = ctypes.string_at(ptr, out_len.value)
    finally:
        lib.km_free(ptr)

    try:
        pos = 0
        (n_groups,) = struct.unpack_from("<I", raw_out, pos)
        pos += 4
        results: List[Optional[Tuple[Optional[str], Optional[str], bool]]] = []
        for _ in range(n_groups):
            status = raw_out[pos]
            pos += 1
            if status == 1:  # group handed back to Python
                results.append(None)
                continue
            merged: Optional[str] = None
            if raw_out[pos]:
                pos += 1
                (mlen,) = struct.unpack_from("<I", raw_out, pos)
                pos += 4
                merged = raw_out[pos : pos + mlen].decode("utf-8", "surrogatepass")
                pos += mlen
            else:
                pos += 1
            iface_flag = raw_out[pos]
            pos += 1
            interface: Optional[str] = None
            if iface_flag == 1:
                (ilen,) = struct.unpack_from("<I", raw_out, pos)
                pos += 4
                interface = raw_out[pos : pos + ilen].decode("utf-8", "surrogatepass")
                pos += ilen
            results.append((merged, interface, iface_flag == 2))
        return results
    except (struct.error, IndexError) as e:
        raise RuntimeError(f"km_process_body_groups output undecodable: {e}") from e

"""Columnar ingest wire format ("KMZC" frames).

A copy of kmamiz_tpu/core/wire.py: the Python codec of the compact SoA
binary frame the Envoy WASM filter emits, so that ingest can skip Zipkin
JSON (docs/INGEST_WIRE.md is the layout spec; the native decoder is
`parse_columnar_window` in csrc/kmamiz_spans.cpp, and the Go encoder in
envoy/filter/main.go mirrors `encode_groups` byte for byte).

Uses:
- `encode_groups` builds frames for tests and benches and documents the
  encoder contract the filter implements.
- `decode_groups` / `columnar_to_json` turn a frame back into Zipkin trace
  groups, so tests can hold the native decoder to the JSON path. The
  port's library always decodes frames itself (it is built from the
  current sources), so no ingest path transcodes.
- `is_columnar` is the sniff the ingest surfaces share.

Parity contract: a frame round-trips to the exact rows the JSON scanner
would produce — sid -1 means ABSENT (key omitted in JSON), distinct from
an empty string; kind 0 carries "neither SERVER nor CLIENT"; timestamps
and durations are integer microseconds (the only shape Zipkin emits).
Any malformed byte (magic, version, length, CRC, out-of-range sid, bad
kind) rejects the WHOLE frame with None, as malformed JSON is rejected.
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import Any, Dict, List, Optional

MAGIC = b"KMZC"
VERSION = 1
_HEADER = struct.Struct("<4sBBHII")  # magic, ver, flags, reserved, len, crc
# per-span fixed-width column record width: 10 x i32 + 1 x i8 + 2 x i64
_SPAN_BYTES = 10 * 4 + 1 + 2 * 8

_KIND_TO_CODE = {"SERVER": 1, "CLIENT": 2}
_CODE_TO_KIND = {1: "SERVER", 2: "CLIENT"}

# (span key, tag key) per i32 sid column, encoder order. id/parent are
# span-level; the naming fields ride in Zipkin tags exactly as the JSON
# scanner reads them (tag_handler in csrc/kmamiz_spans.cpp).
_TAG_COLUMNS = (
    "http.url",
    "http.method",
    "istio.canonical_service",
    "istio.namespace",
    "istio.canonical_revision",
    "istio.mesh_id",
)


def is_columnar(raw: bytes) -> bool:
    return raw[:4] == MAGIC


class _StringTable:
    def __init__(self) -> None:
        self._ids: Dict[str, int] = {}
        self.entries: List[bytes] = []

    def sid(self, value: Optional[str]) -> int:
        if value is None:
            return -1
        got = self._ids.get(value)
        if got is None:
            got = self._ids[value] = len(self.entries)
            self.entries.append(value.encode("utf-8"))
        return got


def encode_groups(groups: List[List[Dict[str, Any]]]) -> bytes:
    """Zipkin trace groups (the /ingest body shape) -> one KMZC frame.

    The group's traceId is taken from its first span (absent/None maps to
    sid -1, the same collapse the JSON prescan applies). Non-string tag
    values are dropped like the JSON scanner drops them.
    """
    tab = _StringTable()
    group_recs: List[tuple] = []
    cols: List[List[int]] = [[] for _ in range(10)]
    kinds: List[int] = []
    ts_col: List[int] = []
    dur_col: List[int] = []

    for spans in groups:
        tid = None
        if spans:
            tid = spans[0].get("traceId")
            if not isinstance(tid, str):
                tid = None
        group_recs.append((tab.sid(tid), len(spans)))
        for span in spans:
            tags = span.get("tags")
            if not isinstance(tags, dict):
                tags = {}

            def _s(value) -> Optional[str]:
                return value if isinstance(value, str) else None

            cols[0].append(tab.sid(_s(span.get("id"))))
            cols[1].append(tab.sid(_s(span.get("parentId"))))
            cols[2].append(tab.sid(_s(span.get("name"))))
            cols[3].append(tab.sid(_s(tags.get("http.url"))))
            cols[4].append(tab.sid(_s(tags.get("http.method"))))
            cols[5].append(tab.sid(_s(tags.get("istio.canonical_service"))))
            cols[6].append(tab.sid(_s(tags.get("istio.namespace"))))
            cols[7].append(tab.sid(_s(tags.get("istio.canonical_revision"))))
            cols[8].append(tab.sid(_s(tags.get("istio.mesh_id"))))
            cols[9].append(tab.sid(_s(tags.get("http.status_code"))))
            kinds.append(_KIND_TO_CODE.get(span.get("kind"), 0))
            ts_col.append(int(span.get("timestamp") or 0))
            dur_col.append(int(span.get("duration") or 0))

    n = len(kinds)
    body = bytearray()
    body += struct.pack("<I", len(tab.entries))
    for entry in tab.entries:
        body += struct.pack("<I", len(entry))
        body += entry
    body += struct.pack("<I", len(group_recs))
    for tid_sid, cnt in group_recs:
        body += struct.pack("<iI", tid_sid, cnt)
    body += struct.pack("<I", n)
    for col in cols:
        body += struct.pack(f"<{n}i", *col)
    body += struct.pack(f"<{n}b", *kinds)
    body += struct.pack(f"<{n}q", *ts_col)
    body += struct.pack(f"<{n}q", *dur_col)

    header = _HEADER.pack(
        MAGIC, VERSION, 0, 0, len(body), zlib.crc32(bytes(body))
    )
    return header + bytes(body)


def decode_groups(raw: bytes) -> Optional[List[List[Dict[str, Any]]]]:
    """KMZC frame -> Zipkin trace groups, or None on ANY malformation
    (same all-or-nothing contract as the native decoder)."""
    try:
        if len(raw) < _HEADER.size:
            return None
        magic, ver, flags, _res, body_len, crc = _HEADER.unpack_from(raw, 0)
        if magic != MAGIC or ver != VERSION or flags != 0:
            return None
        body = raw[_HEADER.size:]
        if len(body) != body_len or zlib.crc32(body) != crc:
            return None

        off = 0
        (n_strings,) = struct.unpack_from("<I", body, off)
        off += 4
        strs: List[str] = []
        for _ in range(n_strings):
            (slen,) = struct.unpack_from("<I", body, off)
            off += 4
            if off + slen > len(body):
                return None
            strs.append(body[off : off + slen].decode("utf-8"))
            off += slen

        def _sv(sid: int) -> Optional[str]:
            if sid == -1:
                return None
            if 0 <= sid < len(strs):
                return strs[sid]
            raise ValueError("sid out of range")

        (n_groups,) = struct.unpack_from("<I", body, off)
        off += 4
        group_recs = []
        span_sum = 0
        for _ in range(n_groups):
            tid_sid, cnt = struct.unpack_from("<iI", body, off)
            off += 8
            _sv(tid_sid)
            group_recs.append((tid_sid, cnt))
            span_sum += cnt
        (n,) = struct.unpack_from("<I", body, off)
        off += 4
        if span_sum != n or len(body) - off != n * _SPAN_BYTES:
            return None

        cols = []
        for _ in range(10):
            cols.append(struct.unpack_from(f"<{n}i", body, off))
            off += 4 * n
        kinds = struct.unpack_from(f"<{n}b", body, off)
        off += n
        ts_col = struct.unpack_from(f"<{n}q", body, off)
        off += 8 * n
        dur_col = struct.unpack_from(f"<{n}q", body, off)

        groups: List[List[Dict[str, Any]]] = []
        row = 0
        for tid_sid, cnt in group_recs:
            tid = _sv(tid_sid)
            spans = []
            for i in range(row, row + cnt):
                if kinds[i] not in (0, 1, 2):
                    return None
                span: Dict[str, Any] = {}
                if tid is not None:
                    span["traceId"] = tid
                sid_val = _sv(cols[0][i])
                if sid_val is not None:
                    span["id"] = sid_val
                parent = _sv(cols[1][i])
                if parent is not None:
                    span["parentId"] = parent
                name = _sv(cols[2][i])
                if name is not None:
                    span["name"] = name
                kind = _CODE_TO_KIND.get(kinds[i])
                if kind is not None:
                    span["kind"] = kind
                span["timestamp"] = ts_col[i]
                span["duration"] = dur_col[i]
                tags: Dict[str, str] = {}
                for col_idx, key in enumerate(_TAG_COLUMNS, start=3):
                    val = _sv(cols[col_idx][i])
                    if val is not None:
                        tags[key] = val
                status = _sv(cols[9][i])
                if status is not None:
                    tags["http.status_code"] = status
                if tags:
                    span["tags"] = tags
                spans.append(span)
            row += cnt
            groups.append(spans)
        return groups
    except (struct.error, ValueError, UnicodeDecodeError):
        return None


def columnar_to_json(raw: bytes) -> Optional[bytes]:
    """Transcode a KMZC frame to the equivalent Zipkin trace-group JSON
    bytes, or None on a malformed frame."""
    groups = decode_groups(raw)
    if groups is None:
        return None
    return json.dumps(groups, separators=(",", ":")).encode("utf-8")

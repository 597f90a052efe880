"""Crash-safe ingest WAL: append-only, fsynced, size-rotated, torn-tail
tolerant.

Counterpart of kmamiz_tpu/resilience/wal.py, with its segment format, so
a WAL that either package wrote replays in the other. Every raw ingest
payload that parses is appended before its spans merge into the graph;
after a kill -9 anywhere in a tick, a new process replays the WAL
through `ingest_raw_window` and arrives at the same graph (the edge
store's merge is a set union and a new processor's empty dedup map
rebuilds the state the payload sequence implies).

Record framing. Segments open with an 8-byte magic and frame each record
with its wire-format kind (0 = Zipkin JSON, 1 = KMZC columnar frame):

    [8B "KMWL\\x02\\0\\0\\0"]                                (once per segment)
    [u32 payload_len][u32 crc32(payload)][u8 kind][payload]  (per record)

Segments without the magic (the JAX package's v1 framing: [u32 len]
[u32 crc][payload], every record JSON) still replay; an append never
writes into one, it opens a new segment. Append is O_APPEND + flush +
fsync, so a record is either durable or detectably torn; replay stops
cleanly at the first short or corrupt record. Segments rotate at
SEGMENT_BYTES (64 MiB) and the newest KEEP_SEGMENTS (4) are kept, the JAX
defaults: a replay rebuilds at most the newest 192-256 MiB of payloads.

On with ``KMAMIZ_WAL=1`` (directory ``KMAMIZ_WAL_DIR``,
``./kmamiz-data/wal``); off by default, so the fsync per ingest is
opt-in. A non-default tenant logs under ``<dir>/tenants/<tenant>`` and
replays on its own.

The fleet's live migration ships a tenant's log as one handoff blob
(`export_handoff`): the magic ``KMHO\\x01\\0\\0\\0`` followed by the
records' v2 frames, segment boundaries collapsed, so the importing worker
(`import_handoff`) lays out segments of its own. The blob's bytes are the
JAX package's for the same records, and each package imports the other's.
"""
from __future__ import annotations

import logging
import os
import struct
import threading
import zlib
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

from kmamiz_tpu_torch import config

logger = logging.getLogger("kmamiz_tpu_torch.resilience.wal")

_HEADER = struct.Struct("<II")  # v1: payload_len, crc32
_HEADER_V2 = struct.Struct("<IIB")  # payload_len, crc32, kind
_SEGMENT_MAGIC = b"KMWL\x02\x00\x00\x00"
# the fleet migration's handoff blob: this magic, then v2 record frames
_HANDOFF_MAGIC = b"KMHO\x01\x00\x00\x00"

#: record wire-format kinds (the v2 frame's kind byte)
KIND_JSON = 0
KIND_COLUMNAR = 1

SEGMENT_BYTES = 64 * 1024 * 1024
KEEP_SEGMENTS = 4


def _is_columnar(payload: bytes) -> bool:
    return payload[:4] == b"KMZC"


class IngestWAL:
    """Append-only write-ahead log of raw ingest payloads."""

    def __init__(
        self,
        directory: str,
        segment_bytes: int = SEGMENT_BYTES,
        keep_segments: int = KEEP_SEGMENTS,
        fsync: bool = True,
    ) -> None:
        self._dir = Path(directory)
        self._segment_bytes = segment_bytes
        self._keep_segments = max(1, keep_segments)
        self._fsync = fsync
        self._lock = threading.Lock()
        self._fh = None
        self._records_appended = 0

    @classmethod
    def from_env(cls, tenant: str = "default") -> Optional["IngestWAL"]:
        """The env-configured WAL, or None unless KMAMIZ_WAL=1. A
        non-default tenant's log is ``<wal-dir>/tenants/<tenant>`` (the
        name checked again: it becomes a path component)."""
        if not config.wal_enabled():
            return None
        directory = config.wal_dir()
        if tenant not in (None, "", "default"):
            from kmamiz_tpu_torch.tenancy.arena import TenantNameError, valid_tenant

            if not valid_tenant(tenant):
                raise TenantNameError(f"invalid tenant name: {tenant!r}")
            directory = os.path.join(directory, "tenants", tenant)
        return cls(directory)

    @property
    def directory(self) -> Path:
        return self._dir

    @property
    def records_appended(self) -> int:
        with self._lock:
            return self._records_appended

    # -- segments ------------------------------------------------------------

    def _segments_locked(self) -> List[Path]:
        try:
            return sorted(p for p in self._dir.glob("*.wal") if p.is_file())
        except OSError:
            return []

    def _next_segment_path_locked(self) -> Path:
        segments = self._segments_locked()
        index = 0
        if segments:
            try:
                index = int(segments[-1].stem) + 1
            except ValueError:
                index = len(segments)
        return self._dir / f"{index:06d}.wal"

    @staticmethod
    def _is_v2_segment(path: Path) -> bool:
        try:
            with open(path, "rb") as f:
                return f.read(len(_SEGMENT_MAGIC)) == _SEGMENT_MAGIC
        except OSError:
            return False

    def _open_segment_locked(self, path: Path) -> None:
        """Open `path` for append, stamping the magic on an empty segment."""
        self._fh = open(path, "ab")
        if self._fh.tell() == 0:
            self._fh.write(_SEGMENT_MAGIC)

    def _open_locked(self) -> None:
        if self._fh is not None:
            return
        self._dir.mkdir(parents=True, exist_ok=True)
        segments = self._segments_locked()
        last = segments[-1] if segments else None
        if (
            last is not None
            and last.stat().st_size < self._segment_bytes
            and (last.stat().st_size == 0 or self._is_v2_segment(last))
        ):
            path = last
        else:
            # full, or a v1 segment: never mix framings
            path = self._next_segment_path_locked()
        self._open_segment_locked(path)

    def _rotate_if_needed_locked(self) -> None:
        if self._fh is None or self._fh.tell() < self._segment_bytes:
            return
        self._fh.close()
        self._fh = None
        self._open_segment_locked(self._next_segment_path_locked())
        segments = self._segments_locked()
        while len(segments) > self._keep_segments:
            victim = segments.pop(0)
            try:
                victim.unlink()
                logger.info("wal: retired segment %s", victim.name)
            except OSError:
                pass

    # -- append / replay -----------------------------------------------------

    def append(self, payload: bytes, kind: Optional[int] = None) -> None:
        """Durably append one record. Raises OSError on an I/O failure:
        the caller decides whether ingest goes on without durability.
        `kind` defaults to what the payload's leading bytes say."""
        if kind is None:
            kind = KIND_COLUMNAR if _is_columnar(payload) else KIND_JSON
        frame = _HEADER_V2.pack(len(payload), zlib.crc32(payload), kind) + payload
        with self._lock:
            self._open_locked()
            self._fh.write(frame)
            self._fh.flush()
            if self._fsync:
                # durability order is append order, and a rotation may
                # close the file the moment the lock drops
                # graftlint: disable=blocking-call-under-lock -- durability order must equal append order, and rotation may close the fd the moment the lock drops
                os.fsync(self._fh.fileno())
            self._records_appended += 1
            self._rotate_if_needed_locked()
        from kmamiz_tpu_torch.resilience import metrics

        metrics.incr("walRecords")

    def replay(self) -> Iterator[bytes]:
        """Every durable payload, oldest first."""
        for _kind, payload in self.replay_records():
            yield payload

    def replay_records(self) -> Iterator[Tuple[int, bytes]]:
        """Every durable (kind, payload), oldest first; v1 records report
        KIND_JSON. Stops cleanly at the first torn or corrupt record (the
        crash tail; later segments are not read past it), and at a kind
        byte that contradicts its payload."""
        with self._lock:
            segments = self._segments_locked()
        for segment in segments:
            try:
                data = segment.read_bytes()
            except OSError as err:
                logger.warning("wal: cannot read %s (%s)", segment.name, err)
                return
            v2 = data[: len(_SEGMENT_MAGIC)] == _SEGMENT_MAGIC
            offset = len(_SEGMENT_MAGIC) if v2 else 0
            header = _HEADER_V2 if v2 else _HEADER
            while offset + header.size <= len(data):
                if v2:
                    length, crc, kind = header.unpack_from(data, offset)
                else:
                    (length, crc), kind = header.unpack_from(data, offset), KIND_JSON
                start = offset + header.size
                end = start + length
                if end > len(data):
                    logger.warning("wal: torn record at %s+%d, stopping replay", segment.name, offset)
                    return
                payload = data[start:end]
                if zlib.crc32(payload) != crc:
                    logger.warning("wal: crc mismatch at %s+%d, stopping replay", segment.name, offset)
                    return
                if v2 and (
                    kind not in (KIND_JSON, KIND_COLUMNAR)
                    or (kind == KIND_COLUMNAR) != _is_columnar(payload)
                ):
                    logger.warning(
                        "wal: kind byte %d contradicts payload at %s+%d, stopping replay",
                        kind,
                        segment.name,
                        offset,
                    )
                    return
                yield kind, payload
                offset = end
            if offset != len(data):
                logger.warning(
                    "wal: %d trailing bytes in %s, stopping replay", len(data) - offset, segment.name
                )
                return

    def record_count(self) -> int:
        return sum(1 for _ in self.replay())

    # -- fleet migration handoff ---------------------------------------------

    def export_handoff(self) -> bytes:
        """Every durable record as one shippable blob: the handoff magic,
        then v2 frames. Built through replay_records, so a torn tail on
        the source is already dropped: the blob carries only the records
        a local crash replay would keep (the target must not rebuild MORE
        state than the source would after a kill -9)."""
        parts = [_HANDOFF_MAGIC]
        for kind, payload in self.replay_records():
            parts.append(_HEADER_V2.pack(len(payload), zlib.crc32(payload), kind))
            parts.append(payload)
        return b"".join(parts)

    def import_handoff(self, data: bytes) -> int:
        """Append a shipped handoff blob's records to this WAL, oldest
        first; returns how many were imported. The stop-clean contract of
        replay_records: a torn tail (the source died mid-export, a cut
        transfer) imports the intact prefix, and a crc mismatch or a kind
        byte that contradicts its payload stops at the last good record.
        A missing magic is a protocol error (the wrong endpoint, not a torn
        stream) and raises ValueError."""
        if data[: len(_HANDOFF_MAGIC)] != _HANDOFF_MAGIC:
            raise ValueError("handoff blob missing KMHO magic")
        offset = len(_HANDOFF_MAGIC)
        imported = 0
        while offset + _HEADER_V2.size <= len(data):
            length, crc, kind = _HEADER_V2.unpack_from(data, offset)
            start = offset + _HEADER_V2.size
            end = start + length
            if end > len(data):
                logger.warning("wal: torn handoff record at +%d, stopping import", offset)
                return imported
            payload = data[start:end]
            if zlib.crc32(payload) != crc:
                logger.warning("wal: handoff crc mismatch at +%d, stopping import", offset)
                return imported
            if kind not in (KIND_JSON, KIND_COLUMNAR) or (kind == KIND_COLUMNAR) != _is_columnar(payload):
                logger.warning(
                    "wal: handoff kind byte %d contradicts payload at +%d, stopping import", kind, offset
                )
                return imported
            self.append(payload, kind)
            imported += 1
            offset = end
        if offset != len(data):
            logger.warning("wal: %d trailing handoff bytes, stopping import", len(data) - offset)
        return imported

    def truncate(self) -> None:
        """Drop every segment (a migration's target starts its tenant's
        namespace clean before the import)."""
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
            for segment in self._segments_locked():
                try:
                    segment.unlink()
                except OSError:
                    pass

    def bytes_on_disk(self) -> int:
        with self._lock:
            segments = self._segments_locked()
        total = 0
        for segment in segments:
            try:
                total += segment.stat().st_size
            except OSError:
                pass
        return total

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

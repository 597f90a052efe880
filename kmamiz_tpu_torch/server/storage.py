"""Pluggable persistence: the reference's MongoOperator behind a Store API.

The reference persists nine Mongoose collections
(KMamiz src/services/MongoOperator.ts:6-14). This framework keeps
the same collection names behind a small document-store interface with two
backends: in-memory (tests/simulator) and JSON-file-per-collection (the
default standalone deployment; STORAGE_URI=file://<dir>).

A copy of kmamiz_tpu/server/storage.py, importing the port's modules.
"""
from __future__ import annotations

import copy
import json
import logging
import threading
import uuid
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

from kmamiz_tpu_torch.server import schemas

logger = logging.getLogger("kmamiz_tpu_torch.storage")


def _boundary_check_reads(collection: str, docs: List[dict]) -> List[dict]:
    """Read-side boundary: migrate old documents forward, QUARANTINE
    invalid ones (skip + log the boundary error). Reads stay fail-open so
    one corrupt/foreign document cannot wedge its collection — the
    periodic replace-all sync (which reads ids only) rewrites the
    collection and purges the quarantined doc on its next rotation;
    writes remain fail-closed (insert_many/save raise)."""
    out = []
    for d in docs:
        try:
            d = schemas.migrate(collection, d)
            schemas.validate_doc(collection, d)
        except schemas.SchemaValidationError as err:
            logger.error(
                "quarantined invalid document %s in %s: %s",
                d.get("_id", "<no id>"),
                collection,
                err,
            )
            continue
        out.append(d)
    return out


COLLECTIONS = (
    "AggregatedData",
    "HistoricalData",
    "CombinedRealtimeData",
    "EndpointDataType",
    "EndpointDependencies",
    "UserDefinedLabel",
    "TaggedInterface",
    "TaggedSwagger",
    "TaggedDiffData",
    # extension past the reference's nine models: the online forecast
    # model's history profiles (DataProcessor.snapshot_history)
    "ModelHistoryState",
)


class Store:
    """Minimal document-store interface (find_all / insert_many / save /
    delete_many / clear)."""

    def find_all(self, collection: str) -> List[dict]:
        raise NotImplementedError

    def find_ids(self, collection: str) -> List[str]:
        """All _ids in a collection WITHOUT materializing/validating the
        documents — the cheap read the periodic replace-all sync uses to
        rotate a collection (and the purge path for quarantined docs)."""
        raise NotImplementedError

    def insert_many(self, collection: str, docs: List[dict]) -> List[dict]:
        raise NotImplementedError

    def save(self, collection: str, doc: dict) -> dict:
        """Upsert by _id; assigns an _id when missing."""
        raise NotImplementedError

    def delete_many(self, collection: str, ids: List[str]) -> int:
        raise NotImplementedError

    def clear_collection(self, collection: str) -> None:
        raise NotImplementedError

    def clear_database(self) -> None:
        for c in COLLECTIONS:
            self.clear_collection(c)

    # -- reference MongoOperator query equivalents --------------------------

    def get_aggregated_data(self, namespace: Optional[str] = None) -> Optional[dict]:
        docs = self.find_all("AggregatedData")
        if not docs:
            return None
        doc = docs[0]
        if namespace:
            doc = {
                **doc,
                "services": [
                    s for s in doc["services"] if s["namespace"] == namespace
                ],
            }
        return doc

    def get_historical_data(
        self,
        namespace: Optional[str] = None,
        time_offset_ms: Optional[float] = 30 * 86_400_000,
        now_ms: Optional[float] = None,
    ) -> List[dict]:
        """time_offset_ms is a look-back DURATION, defaulting to the
        reference's 30-day retention window (MongoOperator.ts
        getHistoricalData timeOffset); pass None for an unbounded read
        (read-only / simulator modes)."""
        import time as _time

        now = now_ms if now_ms is not None else _time.time() * 1000
        docs = self.find_all("HistoricalData")
        if time_offset_ms is not None:
            docs = [
                d
                for d in docs
                if now - time_offset_ms <= d["date"] <= now
            ]
        if namespace:
            docs = [
                {
                    **d,
                    "services": [
                        s for s in d["services"] if s["namespace"] == namespace
                    ],
                }
                for d in docs
            ]
        return docs


class MemoryStore(Store):
    """Documents are deep-copied at the store boundary (both directions):
    callers freely mutate what they read (e.g. label injection into
    historical reads) and what they wrote, the way Mongo's per-query
    materialization isolates the reference."""

    def __init__(self) -> None:
        self._data: Dict[str, Dict[str, dict]] = {c: {} for c in COLLECTIONS}
        # reentrant: FileStore wraps mutate+journal-append in one critical
        # section that nests these methods' own acquisition
        self._lock = threading.RLock()

    def find_all(self, collection: str) -> List[dict]:
        with self._lock:
            docs = copy.deepcopy(list(self._data[collection].values()))
        return _boundary_check_reads(collection, docs)

    def find_ids(self, collection: str) -> List[str]:
        with self._lock:
            return list(self._data[collection].keys())

    def insert_many(self, collection: str, docs: List[dict]) -> List[dict]:
        for doc in docs:
            schemas.validate_doc(collection, doc)
        out = []
        with self._lock:
            for doc in docs:
                d = schemas.stamp(copy.deepcopy(doc))
                d.setdefault("_id", uuid.uuid4().hex)
                self._data[collection][d["_id"]] = d
                out.append(copy.deepcopy(d))
        return out

    def save(self, collection: str, doc: dict) -> dict:
        schemas.validate_doc(collection, doc)
        with self._lock:
            d = schemas.stamp(copy.deepcopy(doc))
            d.setdefault("_id", uuid.uuid4().hex)
            self._data[collection][d["_id"]] = d
            return copy.deepcopy(d)

    def delete_many(self, collection: str, ids: List[str]) -> int:
        with self._lock:
            n = 0
            for i in ids:
                if self._data[collection].pop(i, None) is not None:
                    n += 1
            return n

    def clear_collection(self, collection: str) -> None:
        with self._lock:
            self._data[collection] = {}


class FileStore(MemoryStore):
    """Snapshot + append-journal store: each collection persists as a JSON
    snapshot (`<name>.json`) plus a JSONL journal of mutations since the
    snapshot (`<name>.journal`). Mutations append one journal line — O(delta)
    I/O per write instead of rewriting the collection (the aggregation tick
    inserts per-minute historical docs every few seconds at 10k endpoints,
    where full rewrites amplified to multi-MB
    contract KMamiz src/services/DispatchStorage.ts:24-36). The
    journal compacts into the snapshot once it outgrows `compact_bytes` and
    the snapshot, keeping reload cost bounded."""

    DEFAULT_COMPACT_BYTES = 1 << 20  # 1 MiB of journal before compaction

    def __init__(
        self, directory: str, compact_bytes: int = DEFAULT_COMPACT_BYTES
    ) -> None:
        super().__init__()
        self._dir = Path(directory)
        self._dir.mkdir(parents=True, exist_ok=True)
        self._compact_bytes = compact_bytes
        self._journal_sizes: Dict[str, int] = {c: 0 for c in COLLECTIONS}
        for c in COLLECTIONS:
            self._load_collection(c)

    # -- load: snapshot + journal replay -------------------------------------

    def _snapshot_path(self, collection: str) -> Path:
        return self._dir / f"{collection}.json"

    def _journal_path(self, collection: str) -> Path:
        return self._dir / f"{collection}.journal"

    def _load_collection(self, collection: str) -> None:
        path = self._snapshot_path(collection)
        if path.exists():
            try:
                docs = json.loads(path.read_text())
                self._data[collection] = {
                    d["_id"]: d for d in docs if "_id" in d
                }
            except (json.JSONDecodeError, KeyError, TypeError, AttributeError):
                # fail open on ANY corrupt snapshot shape (e.g. JSON that
                # parses to non-dicts): start empty, let the journal and
                # the next sync rebuild — a boot crash would be worse
                # than a cold cache
                pass
        journal = self._journal_path(collection)
        if not journal.exists():
            return
        # records are delimited by real newlines only — splitlines() would
        # also split on U+2028/U+2029 inside JSON strings and corrupt replay
        raw = journal.read_bytes()
        parts = raw.split(b"\n")
        # the final segment is only a record if the file ends with \n
        # (parts[-1] == b""); otherwise it is a torn tail, even when it
        # happens to parse — appending after an unterminated line would
        # merge two records
        complete, tail = parts[:-1], parts[-1]
        valid_bytes = 0
        torn = bool(tail)
        for line in complete:
            if not line:
                valid_bytes += 1  # stray blank line
                continue
            try:
                entry = json.loads(line)
            except (json.JSONDecodeError, UnicodeDecodeError):
                torn = True
                break  # keep everything before the bad line
            valid_bytes += len(line) + 1
            op = entry.get("op")
            if op == "put":
                doc = entry["doc"]
                self._data[collection][doc["_id"]] = doc
            elif op == "delete":
                for i in entry["ids"]:
                    self._data[collection].pop(i, None)
            elif op == "clear":
                # journaled clear marker: makes clear_collection atomic
                # under any crash point (see clear_collection)
                self._data[collection].clear()
        if torn:
            # truncate NOW so later appends don't land after a bad line
            # and vanish on the following reload
            with open(journal, "r+b") as f:
                f.truncate(valid_bytes)
        self._journal_sizes[collection] = valid_bytes

    # -- write path: append one line, compact when outgrown ------------------

    def _append(self, collection: str, entries: List[dict]) -> None:
        """Append journal records in one write; caller holds self._lock."""
        data = b"".join(
            json.dumps(e, ensure_ascii=False).encode("utf-8") + b"\n"
            for e in entries
        )
        with open(self._journal_path(collection), "ab") as f:
            f.write(data)
        self._journal_sizes[collection] += len(data)
        if self._journal_sizes[collection] >= self._compact_bytes:
            snapshot = self._snapshot_path(collection)
            if (
                not snapshot.exists()
                or self._journal_sizes[collection]
                >= snapshot.stat().st_size
            ):
                self._compact(collection)

    def _compact(self, collection: str) -> None:
        """Fold the journal into the snapshot atomically: write the new
        snapshot to a temp file, rename over, then truncate the journal.
        A crash between the two leaves a journal whose replay is a no-op
        (puts of docs already in the snapshot). Caller holds self._lock."""
        path = self._snapshot_path(collection)
        tmp = path.with_suffix(".json.tmp")
        docs = list(self._data[collection].values())
        tmp.write_text(json.dumps(docs, ensure_ascii=False))
        tmp.replace(path)
        open(self._journal_path(collection), "w").close()
        self._journal_sizes[collection] = 0

    def insert_many(self, collection: str, docs: List[dict]) -> List[dict]:
        with self._lock:
            out = super().insert_many(collection, docs)
            self._append(collection, [{"op": "put", "doc": d} for d in out])
        return out

    def save(self, collection: str, doc: dict) -> dict:
        with self._lock:
            out = super().save(collection, doc)
            self._append(collection, [{"op": "put", "doc": out}])
        return out

    def delete_many(self, collection: str, ids: List[str]) -> int:
        with self._lock:
            n = super().delete_many(collection, ids)
            self._append(collection, [{"op": "delete", "ids": list(ids)}])
        return n

    def clear_collection(self, collection: str) -> None:
        with self._lock:
            super().clear_collection(collection)
            # atomic under any crash point: journal a "clear"
            # marker FIRST — a crash before the snapshot swap replays
            # old-journal + clear = {}; then swap in the empty snapshot
            # (crash before truncate replays clear over [] = {}); then
            # truncate. Every intermediate state reloads as post-clear.
            self._append(collection, [{"op": "clear"}])
            path = self._snapshot_path(collection)
            tmp = path.with_suffix(".json.tmp")
            tmp.write_text("[]")
            tmp.replace(path)
            open(self._journal_path(collection), "w").close()
            self._journal_sizes[collection] = 0


def store_from_uri(uri: str) -> Store:
    if uri.startswith("file://"):
        return FileStore(uri[len("file://"):])
    if uri.startswith("mongodb://"):
        from kmamiz_tpu_torch.server.mongo import MongoStore

        return MongoStore.from_uri(uri)
    if uri in ("memory://", "memory", ""):
        return MemoryStore()
    raise ValueError(f"unsupported STORAGE_URI: {uri}")

"""String interning: the bridge between the string-keyed reference model and
id-indexed device arrays.

The reference keys everything by tab-joined strings
(uniqueServiceName = "svc\\tns\\tversion",
uniqueEndpointName = "svc\\tns\\tver\\tMETHOD\\turl"; see
KMamiz src/classes/Traces.ts:35,46). On the device those become int32 ids
into per-kind intern tables; all device arrays are id-indexed and strings
never leave the host.
"""
from __future__ import annotations

import threading
from typing import Dict, Hashable, Iterable, List, Optional


class StringInterner:
    """Bidirectional key<->int32 table with insertion-order ids.

    Keys are usually strings (the reference's tab-joined names), but any
    hashable value is a valid key: the DP status interner keys segments by
    the RAW http.status_code value (str, int, or None for spans without the
    tag) so that device segments align with the host's raw-status groupby.
    """

    __slots__ = ("_to_id", "_strings")

    def __init__(self, strings: Optional[Iterable[Hashable]] = None) -> None:
        self._to_id: Dict[Hashable, int] = {}
        self._strings: List[Hashable] = []
        if strings:
            for s in strings:
                self.intern(s)

    def intern(self, s: Hashable) -> int:
        i = self._to_id.get(s)
        if i is None:
            i = len(self._strings)
            self._to_id[s] = i
            self._strings.append(s)
        return i

    def get(self, s: Hashable) -> Optional[int]:
        return self._to_id.get(s)

    def lookup(self, i: int) -> Hashable:
        return self._strings[i]

    def __len__(self) -> int:
        return len(self._strings)

    def __contains__(self, s: Hashable) -> bool:
        return s in self._to_id

    @property
    def strings(self) -> List[Hashable]:
        return self._strings


class EndpointInterner:
    """Intern tables for the graph's naming hierarchy.

    endpoints (uniqueEndpointName), services (uniqueServiceName), the
    endpoint->service mapping as a growable int32 relation, and optional
    per-endpoint metadata (TEndpointInfo dicts) kept in lockstep with the
    endpoint table.
    """

    def __init__(self) -> None:
        self.endpoints = StringInterner()
        self.services = StringInterner()
        self._endpoint_service: List[int] = []
        self._endpoint_infos: List[Optional[dict]] = []
        # per-endpoint info timestamp MIRROR in lockstep with
        # _endpoint_infos (0.0 while info is None): lets bulk consumers
        # (graph-store recency metadata, the raw-ingest path's
        # freshest-timestamp refresh) read all timestamps as one numpy
        # array instead of walking 10k+ info dicts per window
        self._info_ts: List[float] = []
        # shared across ingest threads (the /ingest backfill races the
        # realtime tick, and the streaming pipeline overlaps the parse of
        # chunk k+1 with the merge of chunk k): the GIL makes dict ops
        # atomic but not the check-then-insert sequence, which could hand
        # two ids to one endpoint. Interning is O(#shapes) per window on
        # the raw path, so the lock is off the per-span hot loop.
        self._intern_lock = threading.RLock()

    def intern_endpoint(
        self, unique_endpoint_name: str, info: Optional[dict] = None
    ) -> int:
        """Intern an endpoint name; optionally attach/refresh its metadata
        (the freshest-timestamp info wins)."""
        with self._intern_lock:
            eid = self.endpoints.get(unique_endpoint_name)
            if eid is None:
                eid = self.endpoints.intern(unique_endpoint_name)
                parts = unique_endpoint_name.split("\t")
                service_name = "\t".join(parts[:3])
                sid = self.services.intern(service_name)
                self._endpoint_service.append(sid)
                self._endpoint_infos.append(None)
                self._info_ts.append(0.0)
            if info is not None:
                existing = self._endpoint_infos[eid]
                if existing is None or info.get("timestamp", 0) > existing.get(
                    "timestamp", 0
                ):
                    self._endpoint_infos[eid] = info
                    self._info_ts[eid] = float(info.get("timestamp", 0) or 0)
            return eid

    def info_timestamps(self):
        """Snapshot of the per-endpoint info-timestamp mirror as a
        float64 numpy array (index = endpoint id; 0.0 = no info)."""
        import numpy as np

        with self._intern_lock:
            # graftlint: disable=dtype-drift -- host-side mirror; epoch-ms exceeds f32 integer range
            return np.asarray(self._info_ts, dtype=np.float64)

    def refresh_info_timestamps(self, eids, ts_ms, expected_ts=None):
        """Bulk freshest-timestamp refresh: for each (eid, ts) pair,
        advance the existing info's timestamp in place when strictly
        newer — the raw-ingest path's vectorized equivalent of
        re-interning `{**info, "timestamp": ts}` per endpoint. Info
        CONTENT is unchanged by design: callers use this only when the
        winning naming shape for the endpoint is the one already
        applied.

        `expected_ts` makes the update a compare-and-set: position i
        applies only if the info's CURRENT timestamp equals
        expected_ts[i] — a mismatch means another writer (e.g. the
        dict-path realtime tick) refreshed the info since the caller
        last applied, possibly with different content that an in-place
        stamp must not bless. Returns the list of positions that did
        NOT apply (missing info, stale expectation); callers route
        those through the full intern_endpoint slow path. The check and
        the write share one lock hold, closing the snapshot-then-apply
        race a separate mirror read would leave open."""
        failed: List[int] = []
        eids_l = eids.tolist() if hasattr(eids, "tolist") else list(eids)
        ts_l = ts_ms.tolist() if hasattr(ts_ms, "tolist") else list(ts_ms)
        exp_l = (
            None
            if expected_ts is None
            else (
                expected_ts.tolist()
                if hasattr(expected_ts, "tolist")
                else list(expected_ts)
            )
        )
        with self._intern_lock:
            infos = self._endpoint_infos
            mirror = self._info_ts
            for i, (eid, ts) in enumerate(zip(eids_l, ts_l)):
                info = infos[eid]
                if info is None:
                    failed.append(i)
                    continue
                cur = info.get("timestamp", 0)
                if exp_l is not None and cur != exp_l[i]:
                    failed.append(i)
                    continue
                if ts > cur:
                    info["timestamp"] = ts
                    mirror[eid] = ts
        return failed

    def service_of(self, endpoint_id: int) -> int:
        return self._endpoint_service[endpoint_id]

    def info_of(self, endpoint_id: int) -> Optional[dict]:
        return self._endpoint_infos[endpoint_id]

    @property
    def endpoint_service_ids(self) -> List[int]:
        return self._endpoint_service

    @property
    def endpoint_infos(self) -> List[Optional[dict]]:
        return self._endpoint_infos

"""Device-resident endpoint-dependency graph store.

Counterpart of kmamiz_tpu/graph/store.py, reduced to what the Data
Processor tick uses. The edge set lives as capacity-padded int32 column
tensors (src_ep, dst_ep, distance) on the graph's device, SENTINEL-padded
at a power-of-two capacity that grows by re-padding; window merges (the
reference's set-union combineWith, EndpointDependencies.ts:499-563) are
sort+unique unions (ops/sortutil.py).

The store also serves the graph scorers (ops/scorers.py): the per-endpoint
service/ml/record tables, the deprecated-endpoint horizon, an output memo
keyed on (graph version, label epoch, horizon), and the dirty-service
incremental recompute that scores only the edges incident to services a
window touched and splices their lanes into the cached outputs.

Intentional deviation from the reference, kept from the JAX package:
merging keeps the full edge union. The reference's combineWith overwrites
same-window duplicate records (JS Map.set), silently dropping edges
observed in the overwritten record.
"""
from __future__ import annotations

import hashlib
import threading
import time
from typing import Optional

import numpy as np
import torch

from kmamiz_tpu_torch import config
from kmamiz_tpu_torch.core.interning import EndpointInterner, StringInterner
from kmamiz_tpu_torch.core.spans import (
    KIND_SERVER,
    SpanBatch,
    _pad_size as _pow2,
    max_ancestor_chain,
    pack_trace_rows,
)
from kmamiz_tpu_torch.device import DeviceLike, resolve_device
from kmamiz_tpu_torch.ops import scorers as scorer_ops
from kmamiz_tpu_torch.ops import window as window_ops
from kmamiz_tpu_torch.ops.sortutil import SENTINEL, compact_unique

#: window merges the dirty-service journal keeps; an older incremental
#: base degrades to the full recompute (KMAMIZ_DIRTY_JOURNAL_MAX's default)
DIRTY_JOURNAL_MAX = 256
#: dirty-service fraction above which the incremental recompute stops
#: paying for itself: 0 disables it, 1 always allows it
#: (KMAMIZ_DIRTY_FRACTION's default)
DIRTY_FRACTION = 0.25


def _fit_edges(src, dst, dist, cap):
    """Slice or SENTINEL-pad merged edge columns to exactly `cap` rows."""
    n = int(src.shape[0])
    if cap <= n:
        # compact_unique packs valid edges first, so the prefix is exact
        return src[:cap], dst[:cap], dist[:cap]
    fill = torch.full((cap - n,), SENTINEL, dtype=torch.int32, device=src.device)
    return (
        torch.cat([src, fill]),
        torch.cat([dst, fill]),
        torch.cat([dist, fill]),
    )


def _merge_edges(src_a, dst_a, dist_a, mask_a, src_b, dst_b, dist_b, mask_b):
    src = torch.cat([src_a, src_b])
    dst = torch.cat([dst_a, dst_b])
    dist = torch.cat([dist_a, dist_b])
    mask = torch.cat([mask_a, mask_b])
    (s, d, ds), valid = compact_unique((src, dst, dist), mask)
    return s, d, ds, valid


def _union_walk(edges, src, dst, dist, mask):
    """Union a walk's candidate edges into the store columns; returns the
    merged columns and the valid count as a device scalar."""
    s, d, ds, v = _merge_edges(
        src,
        dst,
        dist,
        mask,
        edges.ancestor_ep.reshape(-1),
        edges.descendant_ep.reshape(-1),
        edges.distance.reshape(-1),
        edges.mask.reshape(-1),
    )
    return s, d, ds, v.sum()


class EndpointGraph:
    """Capacity-padded edge set keyed (src_ep -> dst_ep, distance).

    Edge semantics: src depends-ON dst (src is the CLIENT-side ancestor).

    Capacity policy: the edge columns are padded to a power-of-two
    capacity and re-padded to the next one when a union's valid count
    outgrows it (the JAX package's 'repack' growth mode). Merges run
    asynchronously on the device; the valid count of the last merge is
    read back at the next access of the store (`_finalize_pending`), so a
    tick never waits on its own union.
    """

    def __init__(
        self,
        capacity: int = 1024,
        device: DeviceLike = None,
        interner: Optional[EndpointInterner] = None,
        ml_interner: Optional[StringInterner] = None,
    ) -> None:
        self.device = resolve_device(device)
        self.interner = interner or EndpointInterner()
        # method+label strings of the scorers' ep_ml table
        self.ml_interner = ml_interner or StringInterner()

        def fill():
            return torch.full(
                (capacity,), SENTINEL, dtype=torch.int32, device=self.device
            )

        self._src, self._dst, self._dist = fill(), fill(), fill()
        # the live-row mask of the columns, made once per adopted merge so
        # that a snapshot (a memoized scorer read) launches nothing
        self._mask = self._src != SENTINEL
        self._n_edges = 0
        self._pending = None  # deferred (src, dst, dist, count) of last merge
        # distance bounds ever merged (host-tracked): the scorers' dist_bits
        # promise. Walks emit dist >= 1; loaded records can carry anything.
        self._max_dist = 0
        self._min_dist = 1
        # monotonic counters of graph changes (merges) and of label-mapping
        # changes (invalidate_labels); (version, label epoch) keys payloads
        # derived from the graph: the scorer memo and the forecast memo
        self._version = 0
        self._label_epoch = 0
        # -- scorer caches ----------------------------------------------------
        # per-endpoint host tables (key, (ep_service, ep_ml, ep_record,
        # ep_cap)) and their device mirrors, the fresh mask's device mirror
        self._ep_tables_cache = None
        self._ep_tables_dev = None
        self._fresh_dev = None
        # output memo: full key -> ServiceScores/CohesionScores; entries of
        # older versions are pruned on a miss
        self._scorer_memo = {}
        # incremental bases: key without the version -> (version, outputs)
        self._scorer_prev = {}
        # dirty-service journal: (version, frozenset(service ids)) per
        # window merge; merges it cannot attribute (bulk edges, loads,
        # label changes) raise the floor, below which a base is too old
        self._dirty_journal = []
        self._dirty_floor = 0
        self.scorer_stats = {
            "hits": 0,
            "misses": 0,
            "uploads": 0,
            "incremental": 0,
            "full": 0,
        }
        # per-endpoint host-side metadata, padded on demand
        self._ep_record = np.zeros(0, dtype=bool)
        self._ep_last_ts = np.zeros(0, dtype=np.float64)
        # the DP tick mutates from server threads while other threads read;
        # every state transition and snapshot happens under this lock
        self._lock = threading.RLock()

    # -- capacity management -------------------------------------------------

    @property
    def capacity(self) -> int:
        self._finalize_pending()
        return int(self._src.shape[0])

    @property
    def n_edges(self) -> int:
        self._finalize_pending()
        return self._n_edges

    @property
    def version(self) -> int:
        """Monotonic counter of graph state changes (merges)."""
        with self._lock:
            return self._version

    @property
    def label_epoch(self) -> int:
        """Monotonic counter of label-mapping changes."""
        with self._lock:
            return self._label_epoch

    def _ensure_ep_arrays(self, n: int) -> None:
        if len(self._ep_record) < n:
            grow = n - len(self._ep_record)
            self._ep_record = np.concatenate(
                [self._ep_record, np.zeros(grow, dtype=bool)]
            )
            self._ep_last_ts = np.concatenate(
                [self._ep_last_ts, np.zeros(grow, dtype=np.float64)]
            )

    # -- ingestion -----------------------------------------------------------

    def _to_device(self, *host_arrays):
        return [
            torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
            for a in host_arrays
        ]

    def merge_window(self, batch: SpanBatch) -> None:
        """Union this window's dependency edges into the store and update
        per-endpoint record/last-usage metadata: the packed ancestor walk
        plus the union, or the flat walk when the window cannot be packed
        into trace rows (overlong traces, cross-trace parents)."""
        with self._lock:
            self._merge_window_locked(batch)

    def _merge_window_locked(self, batch: SpanBatch) -> None:
        self._version += 1
        self._note_dirty_locked(batch)
        packed = pack_trace_rows(batch.trace_of, batch.n_spans, batch.parent_idx)
        self._finalize_pending_locked()
        if packed is not None:
            # ancestor chains cannot outrun the longest trace; cap the walk
            # depth (pow2 buckets, as in the JAX package)
            depth = min(
                window_ops.MAX_DEPTH,
                _pow2(max(1, packed.max_trace_len - 1), minimum=4),
            )
            dev_in = self._to_device(
                packed.pack(packed.parent_slots(batch.parent_idx), -1),
                packed.pack(batch.kind, 0),
                packed.pack(batch.valid, False),
                packed.pack(batch.endpoint_id, 0),
            )
            edges = window_ops.dependency_edges_packed(*dev_in, max_depth=depth)
        else:
            # size the walk to the window's TRUE longest parent chain
            # (pow2-bucketed, floored at the packed path's default): the
            # deep-trace case is exactly what routes here, and the
            # reference walk is unbounded
            depth = _pow2(
                max(max_ancestor_chain(batch.parent_idx, batch.n_spans), 1),
                minimum=window_ops.MAX_DEPTH,
            )
            dev_in = self._to_device(
                batch.parent_idx, batch.kind, batch.valid, batch.endpoint_id
            )
            edges = window_ops.dependency_edges(*dev_in, max_depth=depth)
        # the walk's depth bounds every distance it emits
        self._max_dist = max(self._max_dist, depth)
        self._pending = _union_walk(edges, *self._store_cols_locked())
        self._update_ep_metadata(batch)

    def merge_window_edges(self, edges, batch: SpanBatch) -> bool:
        """Host-edge fast path for tick merges: union a window's
        already-computed (caller_uen, callee_uen, distance) triples — the
        edge set the host dependency walk just produced for this same
        window — instead of re-deriving it with the walk. Every walked
        (ancestor, server, distance) pair appears in some SERVER record's
        dependingBy list, so the triples cover exactly the rows the walk
        would emit.

        Returns False, with the store untouched, when an endpoint name is
        missing from the interner (the caller then falls back to
        merge_window); True once the union is dispatched."""
        with self._lock:
            eps = self.interner.endpoints
            src_l, dst_l, dist_l = [], [], []
            for caller, callee, dist in edges:
                s_id = eps.get(caller)
                d_id = eps.get(callee)
                if s_id is None or d_id is None:
                    return False
                src_l.append(s_id)
                dst_l.append(d_id)
                dist_l.append(dist)
            self._version += 1
            self._note_dirty_locked(batch)
            self._update_ep_metadata(batch)
            if not src_l:
                return True
            self._finalize_pending_locked()
            self._max_dist = max(self._max_dist, max(dist_l))
            self._min_dist = min(self._min_dist, min(dist_l))
            self._union_host_edges_locked(src_l, dst_l, dist_l)
            return True

    def _union_host_edges_locked(self, src, dst, dist) -> None:
        """Pow2-pad host edge columns (so windows of similar size share
        shapes) and union them into the store."""
        n = len(src)
        cols = []
        for vals in (src, dst, dist):
            col = np.full(_pow2(max(n, 1)), SENTINEL, dtype=np.int32)
            col[:n] = vals
            cols.append(col)
        d_src, d_dst, d_dist = self._to_device(*cols)
        s, d, ds, v = _merge_edges(
            *self._store_cols_locked(), d_src, d_dst, d_dist, d_src != SENTINEL
        )
        self._pending = (s, d, ds, v.sum())

    def _update_ep_metadata(self, batch: SpanBatch) -> None:
        """Per-endpoint record/last-usage metadata (host-side, no device
        sync)."""
        n_ep = len(self.interner.endpoints)
        self._ensure_ep_arrays(n_ep)
        server_eps = batch.endpoint_id[batch.valid & (batch.kind == KIND_SERVER)]
        self._ep_record[server_eps] = True
        if batch.interner is self.interner:
            # same interner: endpoint ids line up, so the recency update
            # is one vectorized max over the interner's timestamp mirror
            ts = batch.interner.info_timestamps()
            k = min(ts.size, n_ep)
            if k:
                np.maximum(self._ep_last_ts[:k], ts[:k], out=self._ep_last_ts[:k])
            return
        for info in batch.endpoint_infos:
            eid = self.interner.endpoints.get(info["uniqueEndpointName"])
            if eid is not None and eid < n_ep:
                self._ep_last_ts[eid] = max(self._ep_last_ts[eid], info["timestamp"])

    def _finalize_pending(self) -> None:
        """Resolve the deferred merge: read the edge count and re-pad the
        merged columns to the next power-of-2 capacity."""
        with self._lock:
            self._finalize_pending_locked()

    def _finalize_pending_locked(self) -> None:
        if self._pending is None:
            return
        pending, self._pending = self._pending, None
        self._apply_merged(*pending)

    def _store_cols_locked(self):
        """The store's (src, dst, dist, mask) column view."""
        return self._src, self._dst, self._dist, self._mask

    def _apply_merged(self, src, dst, dist, valid_count) -> None:
        """Adopt a merged edge set: read the count (the one device sync of
        a merge), then re-pad to the next power-of-2 capacity."""
        valid_count = int(valid_count.item())
        new_cap = _pow2(valid_count, minimum=int(self._src.shape[0]))
        if new_cap == int(src.shape[0]):
            self._src, self._dst, self._dist = src, dst, dist
        else:
            self._src, self._dst, self._dist = _fit_edges(src, dst, dist, cap=new_cap)
        self._mask = self._src != SENTINEL
        self._n_edges = valid_count

    def edge_arrays(self):
        """(src_ep, dst_ep, dist, mask) snapshot of the stored edges, on
        the graph's device (merges replace the tensors, never write them,
        so the snapshot stays valid after the lock releases)."""
        with self._lock:
            self._finalize_pending_locked()
            return self._store_cols_locked()

    def merge_edges(self, src, dst, dist) -> None:
        """Bulk set-union of host (src, dst, dist) edge columns into the
        store — the import path."""
        with self._lock:
            self._version += 1
            # bulk edges are not attributed to services: the next scorer
            # call takes the full recompute
            self._mark_dirty_full_locked()
            self._finalize_pending_locked()
            src_a = np.asarray(src, dtype=np.int64)
            dist_a = np.asarray(dist, dtype=np.int64)[src_a != SENTINEL]
            if dist_a.size:
                self._max_dist = max(self._max_dist, int(dist_a.max()))
                self._min_dist = min(self._min_dist, int(dist_a.min()))
            self._union_host_edges_locked(src, dst, dist)

    # -- name-based export/import (the state carried across packages) --------

    def export_named_edges(self) -> dict:
        """Name-based edge snapshot: ``{"names", "src", "dst", "dist"}``
        where src/dst index into ``names`` (uniqueEndpointName strings),
        NOT into this store's interner ids — the same layout as the JAX
        package's export, so either package folds the other's."""
        src, dst, dist, mask = (a.cpu().numpy() for a in self.edge_arrays())
        live = np.nonzero(mask)[0]
        used = np.unique(np.concatenate([src[live], dst[live]]))
        return {
            "names": [self.interner.endpoints.lookup(int(eid)) for eid in used],
            "src": np.searchsorted(used, src[live]).tolist(),
            "dst": np.searchsorted(used, dst[live]).tolist(),
            "dist": dist[live].astype(np.int64).tolist(),
        }

    def fold_named_edges(self, export: dict) -> int:
        """Fold an exported edge snapshot into this store: intern the
        shipped endpoint names (id order local to THIS store), then bulk
        set-union through merge_edges. Returns the number of live edges
        folded."""
        names = list(export.get("names", ()))
        src_idx = np.asarray(export.get("src", ()), dtype=np.int64)
        dst_idx = np.asarray(export.get("dst", ()), dtype=np.int64)
        dist = np.asarray(export.get("dist", ()), dtype=np.int32)
        if not (src_idx.shape == dst_idx.shape == dist.shape):
            raise ValueError("named-edge export columns disagree on length")
        if src_idx.size:
            if not names:
                raise ValueError("named-edge export has edges but no name table")
            lo = int(min(src_idx.min(), dst_idx.min()))
            hi = int(max(src_idx.max(), dst_idx.max()))
            if lo < 0 or hi >= len(names):
                raise ValueError("named-edge export indexes past its name table")
        ids = np.fromiter(
            (self.interner.intern_endpoint(str(n)) for n in names),
            dtype=np.int32,
            count=len(names),
        )
        with self._lock:
            self._ensure_ep_arrays(len(self.interner.endpoints))
        if src_idx.size == 0:
            return 0
        self.merge_edges(ids[src_idx], ids[dst_idx], dist)
        return int(src_idx.size)

    # -- warm start from the persisted dependency cache ----------------------

    def load_dependencies(self, records) -> None:
        """Rebuild the edge store from cached dependency records (the
        EndpointDependencies JSON): records' dependingOn/dependingBy
        entries become (src, dst, dist) edges, every record endpoint is
        marked as a record holder, and its last use is kept for the
        deprecated-endpoint horizon. The state the scorers need that the
        named-edge export does not carry."""
        with self._lock:
            self._load_dependencies_locked(records)

    def _load_dependencies_locked(self, records) -> None:
        self._version += 1
        # record bits and recency change even when no edge loads
        self._mark_dirty_full_locked()
        src_l, dst_l, dist_l = [], [], []
        for r in records:
            info = r.get("endpoint", {})
            uen = info.get("uniqueEndpointName")
            if uen is None:
                continue
            eid = self.interner.intern_endpoint(uen, info)
            for d in r.get("dependingOn", []):
                dep_info = d.get("endpoint", {})
                dep_uen = dep_info.get("uniqueEndpointName")
                if dep_uen is None:
                    continue
                dep_id = self.interner.intern_endpoint(dep_uen, dep_info)
                src_l.append(eid)
                dst_l.append(dep_id)
                dist_l.append(d.get("distance", 1))
            for d in r.get("dependingBy", []):
                dep_info = d.get("endpoint", {})
                dep_uen = dep_info.get("uniqueEndpointName")
                if dep_uen is None:
                    continue
                dep_id = self.interner.intern_endpoint(dep_uen, dep_info)
                src_l.append(dep_id)
                dst_l.append(eid)
                dist_l.append(d.get("distance", 1))
            self._ensure_ep_arrays(len(self.interner.endpoints))
            self._ep_record[eid] = True
            last_used = r.get("lastUsageTimestamp") or info.get("timestamp") or 0
            self._ep_last_ts[eid] = max(self._ep_last_ts[eid], last_used)
        if not src_l:
            return
        self._finalize_pending_locked()
        # loaded records carry arbitrary distances: widen both bounds
        self._max_dist = max(self._max_dist, max(dist_l))
        self._min_dist = min(self._min_dist, min(dist_l))
        self._union_host_edges_locked(src_l, dst_l, dist_l)
        self.invalidate_labels()

    def active_services(self, now_ms=None) -> np.ndarray:
        """bool[num_services]: services owning at least one non-deprecated
        endpoint record."""
        with self._lock:
            n_ep = len(self.interner.endpoints)
            self._ensure_ep_arrays(n_ep)
            fresh = self._fresh_mask_locked(_pow2(max(n_ep, 1)), now_ms)
            out = np.zeros(len(self.interner.services), dtype=bool)
            if n_ep:
                ep_svc = np.asarray(self.interner.endpoint_service_ids[:n_ep], dtype=np.int64)
                live = self._ep_record[:n_ep] & fresh[:n_ep]
                out[ep_svc[live]] = True
            return out

    # -- labels and the dirty-service journal --------------------------------

    def invalidate_labels(self) -> None:
        """Call when the label mapping changes: the per-endpoint tables
        rebuild on the next scorer call, and the label epoch (a key of
        every scorer and forecast memo entry) moves on."""
        with self._lock:
            self._ep_tables_cache = None
            self._label_epoch += 1
            self._mark_dirty_full_locked()

    def _mark_dirty_full_locked(self) -> None:
        """Forget incremental bases and memoized outputs: the next scorer
        call takes the full recompute. For every mutation the journal
        cannot attribute to a set of services."""
        self._dirty_journal.clear()
        self._dirty_floor = self._version
        self._scorer_memo.clear()
        self._scorer_prev.clear()
        self._ep_tables_dev = None
        self._fresh_dev = None

    def _note_dirty_locked(self, batch: SpanBatch) -> None:
        """Journal the services a window merge touched under the version
        the merge produced. Bounded: an overflow raises the floor."""
        ep_svc = np.asarray(self.interner.endpoint_service_ids, dtype=np.int32)
        ids = batch.endpoint_id[batch.valid]
        ids = ids[(ids >= 0) & (ids < ep_svc.shape[0])]
        touched = frozenset(int(s) for s in np.unique(ep_svc[ids]))
        self._dirty_journal.append((self._version, touched))
        cap = max(1, DIRTY_JOURNAL_MAX)
        while len(self._dirty_journal) > cap:
            self._dirty_floor = self._dirty_journal.pop(0)[0]

    # -- scorer inputs ---------------------------------------------------------

    def _ep_tables(self, label_of=None):
        """Padded per-endpoint service/ml/record arrays (+ padded size),
        cached until the intern table or the record set grows, or the
        labels are invalidated."""
        with self._lock:
            return self._ep_tables_locked(label_of)

    def _ep_tables_locked(self, label_of=None):
        n_ep = len(self.interner.endpoints)
        self._ensure_ep_arrays(n_ep)
        cache_key = (n_ep, int(self._ep_record[:n_ep].sum()), label_of is not None)
        cached = self._ep_tables_cache
        if cached is not None and cached[0] == cache_key:
            return cached[1]
        ep_cap = _pow2(max(n_ep, 1))
        ep_service = np.zeros(ep_cap, dtype=np.int32)
        ep_ml = np.zeros(ep_cap, dtype=np.int32)
        ep_record = np.zeros(ep_cap, dtype=bool)
        ep_service[:n_ep] = self.interner.endpoint_service_ids
        ep_record[:n_ep] = self._ep_record[:n_ep]
        for eid in range(n_ep):
            name = self.interner.endpoints.lookup(eid)
            parts = name.split("\t")
            method = parts[3] if len(parts) > 3 else ""
            # without a label the endpoint is its own granularity; a label
            # collapses same-(method, label) endpoints
            label = (label_of(name) if label_of else None) or name
            ep_ml[eid] = self.ml_interner.intern(f"{method}\t{label}")
        result = (ep_service, ep_ml, ep_record, ep_cap)
        self._ep_tables_cache = (cache_key, result)
        return result

    def _fresh_mask_locked(self, ep_cap: int, now_ms=None) -> np.ndarray:
        """bool[ep_cap]: endpoints whose last use lies within the
        deprecated-endpoint threshold (the host path prunes stale records
        and links to them; the scorers mask the same endpoints out of
        records and edges). All True when the threshold is unset."""
        fresh = np.ones(ep_cap, dtype=bool)
        deprecated_ms = config.parse_threshold_ms(config.settings.deprecated_endpoint_threshold)
        if deprecated_ms:
            cutoff = (now_ms if now_ms is not None else time.time() * 1000) - deprecated_ms
            n_ep = min(len(self.interner.endpoints), ep_cap)
            self._ensure_ep_arrays(n_ep)
            fresh[:n_ep] = self._ep_last_ts[:n_ep] >= cutoff
        return fresh

    def _scorer_inputs(self, label_of=None, now_ms=None):
        """The uncached path's inputs, taken under one lock hold: device
        edge columns with the fresh horizon applied, host tables, and the
        service capacity."""
        with self._lock:
            self._finalize_pending_locked()
            src, dst, dist, mask = self._store_cols_locked()
            ep_service, ep_ml, ep_record, ep_cap = self._ep_tables_locked(label_of)
            fresh = self._fresh_mask_locked(ep_cap, now_ms)
            svc_cap = _pow2(max(len(self.interner.services), 1))
        if not fresh.all():
            (fresh_d,) = self._to_device(fresh)
            mask = mask & fresh_d[src.clamp(0, ep_cap - 1)] & fresh_d[dst.clamp(0, ep_cap - 1)]
            ep_record = ep_record & fresh
        return src, dst, dist, mask, ep_service, ep_ml, ep_record, svc_cap

    def _scorer_dist_bits(self) -> Optional[int]:
        """The dist_bits promise of the sparse scorer dispatch, from the
        tracked distance bounds: 3 when every distance ever merged fits
        0 <= d < 8, 4 up to d < 16, else None (the legacy pipeline).
        _max_dist is an upper bound (walk depths), so it never lies."""
        if self._min_dist < 0:
            return None
        if self._max_dist < 8:
            return 3
        if self._max_dist < 16:
            return 4
        return None

    # -- scorers ----------------------------------------------------------------

    def service_scores(self, label_of=None, now_ms=None) -> scorer_ops.ServiceScores:
        """Cached service scorers: repeated reads between merges are memo
        hits, small merges take the dirty-service incremental path, the
        rest the full recompute (the same lanes either way; see
        service_scores_uncached). A new label mapping needs
        invalidate_labels(), which moves the label epoch."""
        return self._scored("svc", label_of, now_ms)

    def service_scores_uncached(self, label_of=None, now_ms=None) -> scorer_ops.ServiceScores:
        """The per-call pipeline (host-table snapshot, fresh upload, full
        recompute), bypassing every cache: the parity oracle of the cached
        path."""
        src, dst, dist, mask, ep_service, ep_ml, ep_record, svc_cap = self._scorer_inputs(
            label_of, now_ms
        )
        ep_service_d, ep_ml_d, ep_record_d = self._to_device(ep_service, ep_ml, ep_record)
        return scorer_ops.service_scores(
            src, dst, dist, mask, ep_service_d, ep_ml_d, ep_record_d,
            num_services=svc_cap, dist_bits=self._scorer_dist_bits(),
        )

    def usage_cohesion(self, now_ms=None) -> scorer_ops.CohesionScores:
        """Cached cohesion scorers: output memo and device-resident input
        tables. No incremental path: the outputs carry capacity-length
        pair tables sorted over the whole edge set, which a per-service
        lane splice cannot patch."""
        return self._scored("coh", None, now_ms)

    def usage_cohesion_uncached(self, now_ms=None) -> scorer_ops.CohesionScores:
        """Cache-bypassing parity oracle (see service_scores_uncached)."""
        src, dst, dist, mask, ep_service, _ep_ml, ep_record, svc_cap = self._scorer_inputs(
            None, now_ms
        )
        ep_service_d, ep_record_d = self._to_device(ep_service, ep_record)
        return scorer_ops.usage_cohesion(
            src, dst, dist, mask, ep_service_d, ep_record_d, num_services=svc_cap
        )

    def scorer_cache_stats(self) -> dict:
        """Counters of the scorer caches: memo hits and misses, host-to-
        device uploads on the scorer path, incremental and full
        recomputes."""
        with self._lock:
            stats = dict(self.scorer_stats)
            stats["memo_entries"] = len(self._scorer_memo)
            stats["journal_len"] = len(self._dirty_journal)
        total = stats["hits"] + stats["misses"]
        stats["hit_rate"] = (stats["hits"] / total) if total else 0.0
        return stats

    def _count_uploads(self, arrays):
        """Host-to-device copies of the scorer path, counted."""
        out = self._to_device(*arrays)
        with self._lock:
            self.scorer_stats["uploads"] += len(out)
        return out

    def _scorer_snapshot(self, label_of, now_ms):
        """One lock hold across the snapshot: the edge columns, host
        tables, and every cache-key ingredient (graph version, label
        epoch, fresh-mask fingerprint, dirty journal and floor)."""
        with self._lock:
            self._finalize_pending_locked()
            src, dst, dist, mask = self._store_cols_locked()
            ep_service, ep_ml, ep_record, ep_cap = self._ep_tables_locked(label_of)
            tab_key = self._ep_tables_cache[0] + (self._label_epoch,)
            fresh = self._fresh_mask_locked(ep_cap, now_ms)
            return dict(
                src=src,
                dst=dst,
                dist=dist,
                mask=mask,
                ep_service=ep_service,
                ep_ml=ep_ml,
                ep_record=ep_record,
                ep_cap=ep_cap,
                tab_key=tab_key,
                fresh=fresh,
                # no horizon hashes to None; an active one fingerprints the
                # mask, so endpoints ageing out change the key
                fresh_fp=None if fresh.all() else hash(fresh.tobytes()),
                svc_cap=_pow2(max(len(self.interner.services), 1)),
                n_services=len(self.interner.services),
                version=self._version,
                label_epoch=self._label_epoch,
                journal=list(self._dirty_journal),
                floor=self._dirty_floor,
            )

    def _device_tables(self, snap):
        """Device mirrors of the per-endpoint tables, uploaded once per
        table change; the fresh horizon gates the edge mask and the record
        bits on the device."""
        cached = self._ep_tables_dev
        if cached is not None and cached[0] == snap["tab_key"]:
            ep_service_d, ep_ml_d, ep_record_d = cached[1]
        else:
            ep_service_d, ep_ml_d, ep_record_d = self._count_uploads(
                (snap["ep_service"], snap["ep_ml"], snap["ep_record"])
            )
            with self._lock:
                self._ep_tables_dev = (snap["tab_key"], (ep_service_d, ep_ml_d, ep_record_d))
        mask = snap["mask"]
        if snap["fresh_fp"] is not None:
            ep_cap = snap["ep_cap"]
            fkey = (ep_cap, snap["fresh_fp"])
            fcached = self._fresh_dev
            if fcached is not None and fcached[0] == fkey:
                fresh_d = fcached[1]
            else:
                (fresh_d,) = self._count_uploads((snap["fresh"],))
                with self._lock:
                    self._fresh_dev = (fkey, fresh_d)
            mask = (
                mask
                & fresh_d[snap["src"].clamp(0, ep_cap - 1)]
                & fresh_d[snap["dst"].clamp(0, ep_cap - 1)]
            )
            ep_record_d = ep_record_d & fresh_d
        return ep_service_d, ep_ml_d, ep_record_d, mask

    def _scored(self, kind: str, label_of, now_ms):
        """Memo -> incremental -> full, for both scorer kinds. The key is
        (kind, label epoch, labeled?, svc_cap, ep_cap, fresh fingerprint)
        plus the graph version: merges move the version,
        invalidate_labels the epoch, horizon expiry the fingerprint and
        growth the caps. (The JAX package's key also holds its mesh; the
        multi-GPU path is not ported.)"""
        snap = self._scorer_snapshot(label_of, now_ms)
        base_key = (
            kind,
            snap["label_epoch"],
            label_of is not None,
            snap["svc_cap"],
            snap["ep_cap"],
            snap["fresh_fp"],
        )
        memo_key = base_key + (snap["version"],)
        with self._lock:
            hit = self._scorer_memo.get(memo_key)
            if hit is not None:
                self.scorer_stats["hits"] += 1
        if hit is not None:
            return hit
        result = self._compute_scores(kind, snap, base_key)
        with self._lock:
            self.scorer_stats["misses"] += 1
            if len(self._scorer_memo) >= 64:
                self._scorer_memo.clear()
            else:
                # keys embed the version: entries of older graph states are
                # unreachable, so prune them on the way in
                for k in [k for k in self._scorer_memo if k[-1] != snap["version"]]:
                    del self._scorer_memo[k]
            self._scorer_memo[memo_key] = result
            if len(self._scorer_prev) >= 32:
                self._scorer_prev.clear()
            self._scorer_prev[base_key] = (snap["version"], result)
        return result

    def _compute_scores(self, kind, snap, base_key):
        src, dst, dist = snap["src"], snap["dst"], snap["dist"]
        svc_cap = snap["svc_cap"]
        ep_service_d, ep_ml_d, ep_record_d, mask = self._device_tables(snap)
        with self._lock:
            prev = self._scorer_prev.get(base_key)
        if prev is not None:
            inc = self._incremental_scores(kind, snap, prev, mask, ep_service_d, ep_ml_d, ep_record_d)
            if inc is not None:
                return inc
        with self._lock:
            self.scorer_stats["full"] += 1
        if kind == "svc":
            return scorer_ops.service_scores(
                src, dst, dist, mask, ep_service_d, ep_ml_d, ep_record_d,
                num_services=svc_cap, dist_bits=self._scorer_dist_bits(),
            )
        return scorer_ops.usage_cohesion(
            src, dst, dist, mask, ep_service_d, ep_record_d, num_services=svc_cap
        )

    def _incremental_scores(self, kind, snap, prev, mask, ep_service_d, ep_ml_d, ep_record_d):
        """Dirty-service incremental recompute: score only the edges
        incident to the services the journal marks dirty since the cached
        base, then splice their lanes into the base. Returns None when not
        eligible, which sends the caller to the full recompute."""
        prev_version, prev_scores = prev
        if prev_version >= snap["version"] or prev_version < snap["floor"]:
            return None
        dirty = set()
        for v, svcs in snap["journal"]:
            if v > prev_version:
                dirty |= svcs
        if not dirty:
            # the merges since the base touched no service (empty
            # windows): the edge values are unchanged, the base is exact
            with self._lock:
                self.scorer_stats["incremental"] += 1
            return prev_scores
        if kind != "svc":
            return None
        if len(dirty) > DIRTY_FRACTION * max(snap["n_services"], 1):
            return None
        svc_cap = snap["svc_cap"]
        dirty_host = np.zeros(svc_cap, dtype=bool)
        dirty_host[list(dirty)] = True
        (dirty_d,) = self._count_uploads((dirty_host,))
        sub_s, sub_d, sub_ds, kept = scorer_ops.dirty_edge_subset(
            snap["src"], snap["dst"], snap["dist"], mask, ep_service_d, dirty_d
        )
        k = int(kept)  # the path's one device-to-host read
        cap = int(snap["src"].shape[0])
        sub_cap = _pow2(max(k, 1), minimum=min(256, cap))
        if sub_cap >= cap:
            return None  # a subset as large as the store: the full run wins
        sub_s, sub_d, sub_ds = sub_s[:sub_cap], sub_d[:sub_cap], sub_ds[:sub_cap]
        inc = scorer_ops.service_scores(
            sub_s, sub_d, sub_ds, sub_s != SENTINEL, ep_service_d, ep_ml_d, ep_record_d,
            num_services=svc_cap, dist_bits=self._scorer_dist_bits(),
        )
        with self._lock:
            self.scorer_stats["incremental"] += 1
        return scorer_ops.merge_service_lanes(dirty_d, inc, prev_scores)


def graph_signature(graph) -> str:
    """Order-independent content hash of a graph: sha256 over the sorted
    masked (src, dst, distance) edge triples — the same digest as the JAX
    package's resilience.chaos.graph_signature, for graphs of either
    package."""
    src, dst, dist, mask = (
        a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
        for a in graph.edge_arrays()
    )
    live = np.nonzero(mask)[0]
    s, d, c = (np.asarray(x[live], dtype=np.int64) for x in (src, dst, dist))
    order = np.lexsort((c, d, s))
    rows = zip(s[order].tolist(), d[order].tolist(), c[order].tolist())
    text = "".join(f"{a},{b},{k};" for a, b, k in rows)
    return hashlib.sha256(text.encode("ascii")).hexdigest()

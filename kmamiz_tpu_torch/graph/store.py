"""Device-resident endpoint-dependency graph store.

Counterpart of kmamiz_tpu/graph/store.py, reduced to what the Data
Processor tick uses. The edge set lives as capacity-padded int32 column
tensors (src_ep, dst_ep, distance) on the graph's device, SENTINEL-padded
at a power-of-two capacity that grows by re-padding; window merges (the
reference's set-union combineWith, EndpointDependencies.ts:499-563) are
sort+unique unions (ops/sortutil.py).

Intentional deviation from the reference, kept from the JAX package:
merging keeps the full edge union. The reference's combineWith overwrites
same-window duplicate records (JS Map.set), silently dropping edges
observed in the overwritten record.
"""
from __future__ import annotations

import hashlib
import threading
import numpy as np
import torch

from kmamiz_tpu_torch.core.interning import EndpointInterner
from kmamiz_tpu_torch.core.spans import (
    KIND_SERVER,
    SpanBatch,
    _pad_size as _pow2,
    max_ancestor_chain,
    pack_trace_rows,
)
from kmamiz_tpu_torch.device import DeviceLike, resolve_device
from kmamiz_tpu_torch.ops import window as window_ops
from kmamiz_tpu_torch.ops.sortutil import SENTINEL, compact_unique


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

    def __init__(self, capacity: int = 1024, device: DeviceLike = None) -> None:
        self.device = resolve_device(device)
        self.interner = EndpointInterner()

        def fill():
            return torch.full(
                (capacity,), SENTINEL, dtype=torch.int32, device=self.device
            )

        self._src, self._dst, self._dist = fill(), fill(), fill()
        self._n_edges = 0
        self._pending = None  # deferred (src, dst, dist, count) of last merge
        # monotonic counters of graph changes (merges) and of label-mapping
        # changes; (version, label epoch) keys payloads derived from the
        # graph, such as the forecast memo. Nothing relabels yet, so the
        # label epoch stays 0 until the scorers' label tables are ported.
        self._version = 0
        self._label_epoch = 0
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
            self._update_ep_metadata(batch)
            if not src_l:
                return True
            self._finalize_pending_locked()
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
        return self._src, self._dst, self._dist, self._src != SENTINEL

    def _apply_merged(self, src, dst, dist, valid_count) -> None:
        """Adopt a merged edge set: read the count (the one device sync of
        a merge), then re-pad to the next power-of-2 capacity."""
        valid_count = int(valid_count.item())
        new_cap = _pow2(valid_count, minimum=int(self._src.shape[0]))
        if new_cap == int(src.shape[0]):
            self._src, self._dst, self._dist = src, dst, dist
        else:
            self._src, self._dst, self._dist = _fit_edges(src, dst, dist, cap=new_cap)
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
            self._finalize_pending_locked()
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

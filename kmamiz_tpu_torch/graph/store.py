"""Device-resident endpoint-dependency graph store.

Counterpart of kmamiz_tpu/graph/store.py, reduced to what the Data
Processor's tick and raw ingest use. The edge set lives as capacity-padded
int32 column tensors (src_ep, dst_ep, distance) on the graph's device,
SENTINEL-padded at a power-of-two capacity that grows by re-padding;
window merges (the reference's set-union combineWith,
EndpointDependencies.ts:499-563) are sort+unique unions
(ops/sortutil.py). Window inputs upload through a
double-buffered pipeline (ops/double_buffer.py). The streaming path
stages its windows instead: each window's walk self-compacts on the
device, staged windows collapse into one pending union while the next
chunk parses, and the store adopts it at the next read.

Every store belongs to a tenant (`tenant`, "default" unless given) and
admits itself into the process-wide tenant arena (tenancy/arena.py): the
arena's (tenant, version) index, its capacity buckets and its stacked
[T, cap] views. The tenancy router's stacked merge reads a window as id
columns (`intern_window_edges`), unions every same-bucket tenant's window
in one batched program, and each store adopts its lane
(`adopt_batched_merged`); a store that moved since the stack was read
raises StoreVersionDrift, and the router merges that window serially.

On a device mesh (parallel/mesh.py: `active_mesh` finds more than one
card) a staged window's packed rows upload per shard, each shard walks
and self-compacts its rows on its device, and the drain unions the
per-shard prefixes on the store's device; the service scorers shard
their tuple expansion and local dedup over the mesh the same way. A
single card keeps the single-device path.

Not ported: the JAX store's 'segment' growth mode (a capacity crossing
that recompiles no XLA program; PyTorch compiles nothing per shape).

The store also serves the graph scorers (ops/scorers.py): the per-endpoint
service/ml/record tables, the deprecated-endpoint horizon, an output memo
keyed on (graph version, label epoch, horizon), and the dirty-service
incremental recompute that scores only the edges incident to services a
window touched and splices their lanes into the cached outputs.

Telemetry: every store reports its device arenas (the edge columns, the
staged windows and pre-union, the scorer tables) to
`kmamiz_arena_bytes{arena="graph.*"}` at scrape time; a scorer
recompute is the tick phase `scorers` and the step timer's `scorers`,
and each window upload's wait the step timer's `transfer`.

Intentional deviation from the reference, kept from the JAX package:
merging keeps the full edge union. The reference's combineWith overwrites
same-window duplicate records (JS Map.set), silently dropping edges
observed in the overwritten record.
"""
from __future__ import annotations

import hashlib
import threading
import time
import weakref
from typing import Dict, Optional

import numpy as np
import torch

from kmamiz_tpu_torch import config
from kmamiz_tpu_torch.core.interning import EndpointInterner, StringInterner
from kmamiz_tpu_torch.core.profiling import step_timer
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
from kmamiz_tpu_torch.ops.double_buffer import AsyncCount, UploadPipeline
from kmamiz_tpu_torch.parallel import mesh as pmesh
from kmamiz_tpu_torch.telemetry import device as tel_device
from kmamiz_tpu_torch.telemetry.tracing import phase_span
from kmamiz_tpu_torch.ops.sortutil import (
    EDGE_KEY_MAX_DIST,
    EDGE_KEY_MAX_EP,
    SENTINEL,
    compact_unique,
    compact_unique_edges_packed,
)

#: window merges the dirty-service journal keeps; an older incremental
#: base degrades to the full recompute (KMAMIZ_DIRTY_JOURNAL_MAX's default)
DIRTY_JOURNAL_MAX = 256
#: dirty-service fraction above which the incremental recompute stops
#: paying for itself: 0 disables it, 1 always allows it
#: (KMAMIZ_DIRTY_FRACTION's default)
DIRTY_FRACTION = 0.25
#: rows of a staged window's compacted prefix (KMAMIZ_STAGE_CAP's
#: default): a window with more distinct edges still merges exactly,
#: through the drain's re-walk; this only sets the fast path's width
STAGE_CAP = 1 << 18
#: staged rows (prefixes plus held walk inputs) past which staging drains
#: inline, bounding an unread stream's device memory
#: (KMAMIZ_STAGE_MAX_ROWS's default)
STAGE_MAX_ROWS = 1 << 24


def count_ready(count: AsyncCount) -> bool:
    """Whether a staged count has landed on the host. The staged merges
    read a count that has not landed only where they must, and defer it
    elsewhere; the tests replace this probe to drive the deferred
    branches on the CPU, where every count is ready."""
    return count.ready()


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


class StoreVersionDrift(RuntimeError):
    """A stacked-merge lane was built from an arena snapshot the store has
    since moved past (a merge landed between the snapshot and the adopt).
    The caller re-merges its window serially against the current store:
    merges are set unions, so the result is the same."""


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


def _packed_depth(packed) -> int:
    """Walk depth of a packed window: ancestor chains cannot outrun the
    longest trace (pow2 buckets, as in the JAX package)."""
    return min(window_ops.MAX_DEPTH, _pow2(max(1, packed.max_trace_len - 1), minimum=4))


def _packed_inputs(packed, batch: SpanBatch):
    """The packed walk's host inputs: parent slots, kind, valid, endpoint."""
    return (
        packed.pack(packed.parent_slots(batch.parent_idx), -1),
        packed.pack(batch.kind, 0),
        packed.pack(batch.valid, False),
        packed.pack(batch.endpoint_id, 0),
    )


def _held_slots(dev_in) -> int:
    """Packed slots a staged window's held walk inputs pin: its parent-slot
    tensor's, or the sum of its shards' on a mesh."""
    first = dev_in[0]
    if isinstance(first, torch.Tensor):
        return int(first.numel())
    return sum(int(x.numel()) for x in first)


def _window_edges_packed(parent_slot, kind, valid, endpoint_id, max_depth):
    """Walk only: a packed window's flat (ancestor, descendant,
    distance, mask) candidate columns, the store untouched; the re-walk of
    a staged window whose compacted prefix truncated."""
    edges = window_ops.dependency_edges_packed(
        parent_slot, kind, valid, endpoint_id, max_depth=max_depth
    )
    return (
        edges.ancestor_ep.reshape(-1),
        edges.descendant_ep.reshape(-1),
        edges.distance.reshape(-1),
        edges.mask.reshape(-1),
    )


def _window_edges_compact(
    parent_slot, kind, valid, endpoint_id, max_depth, stage_cap, packed_key
):
    """The staged merge's walk: a window's candidates self-compacted to a
    sorted unique prefix, sliced to stage_cap rows. Returns (src, dst,
    dist, count); count is the true unique total, so count > stage_cap
    means the prefix truncated. packed_key takes the single-int32-key
    sort; the caller guarantees its id and distance bounds."""
    a, d, ds, mask = _window_edges_packed(parent_slot, kind, valid, endpoint_id, max_depth)
    if packed_key:
        (s, d, ds), v = compact_unique_edges_packed(a, d, ds, mask)
    else:
        (s, d, ds), v = compact_unique((a, d, ds), mask)
    return s[:stage_cap], d[:stage_cap], ds[:stage_cap], v.sum()


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
        tenant: str = "default",
    ) -> None:
        self.device = resolve_device(device)
        self.tenant = tenant
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
        # double-buffered uploads of the window merges (ops/double_buffer.py):
        # touched only under self._lock, drained at the read fence
        self._uploads = UploadPipeline(self.device)
        # staged windows (compacted prefix columns, their AsyncCount, the
        # walk inputs, depth and mesh) awaiting the union; bounded by
        # STAGE_MAX_ROWS through _staged_rows
        self._staged = []
        self._staged_rows = 0
        # the mid-stream pre-union: the staged windows so far collapsed into
        # one pending union that already holds the store's edges, its
        # AsyncCount, the truncation checks it deferred (count, cap, walk
        # inputs, depth, mesh) and the packed slots those checks hold, which
        # count toward the backstop too
        self._preunion = None
        self._preunion_count = None
        self._preunion_checks = []
        self._preunion_rows = 0
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
        _track_store_arenas(self)
        # every graph admits itself into the process-wide tenant arena,
        # which holds it by weakref (re-admitting a tenant replaces it)
        from kmamiz_tpu_torch.tenancy.arena import default_arena

        default_arena().admit(tenant, self)

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
                # graftlint: disable=dtype-drift -- host-side mirror; epoch-ms exceeds f32 integer range
                [self._ep_last_ts, np.zeros(grow, dtype=np.float64)]
            )

    # -- ingestion -----------------------------------------------------------

    def _to_device(self, *host_arrays):
        """Upload a window's host arrays through the pipeline; returns
        (tensors, wait_ms). The copies are asynchronous on the card: work
        enqueued on the tensors runs after the bytes land, and wait_ms is
        the stall this call paid (the whole copy at depth 0, otherwise the
        retire of the oldest group past the pipeline's depth)."""
        out, ms = self._uploads.put(host_arrays)
        step_timer.record("transfer", ms)
        return out, ms

    def _to_device_sharded(self, mesh, *host_arrays):
        """_to_device onto the mesh: each [rows, ROW_SLOTS] array uploads
        as mesh-many row blocks, block i to the mesh's i-th device, so each
        shard's walk runs on its own rows. Returns (per array, its sharded
        value; wait_ms)."""
        devices = mesh.axis_devices("spans")
        n = len(devices)
        blocks = [b for a in host_arrays for b in np.split(a, n)]
        out, ms = self._uploads.put(blocks, devices=devices * len(host_arrays))
        step_timer.record("transfer", ms)
        return tuple(tuple(out[k * n : (k + 1) * n]) for k in range(len(host_arrays))), ms

    def _deploy_mesh(self, n_rows: int):
        """The active mesh for this store's device when a window (or an
        edge capacity) of n_rows is worth sharding (at least one row per
        device), else None. Consulted per call, so a multi-card process
        shards every big window while one card keeps the single-device
        path."""
        mesh = pmesh.active_mesh(self.device)
        if mesh is None or n_rows < mesh.shape["spans"]:
            return None
        return mesh

    @staticmethod
    def _pad_rows_for(mesh, arr, fill):
        """Pad a [rows, ROW_SLOTS] host array's leading dim to a multiple
        of the mesh's device count (a no-op for pow2 device counts:
        pack_trace_rows already pow2-pads rows)."""
        n_dev = mesh.shape["spans"]
        rows = arr.shape[0]
        target = -(-rows // n_dev) * n_dev
        if target == rows:
            return arr
        out = np.full((target, arr.shape[1]), fill, dtype=arr.dtype)
        out[:rows] = arr
        return out

    def _upload(self, *host_arrays):
        """Plain synchronous copies, for the scorer path's tables (the JAX
        store puts them with a plain device_put too)."""
        return [
            torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
            for a in host_arrays
        ]

    def arena_bytes(self) -> Dict[str, int]:
        """Device bytes per arena (the tensors' sizes, no device call):
        `edges` (the columns and their mask), `staged` (staged windows,
        the pre-union) and `scorer_tables` (the scorers' device tables)."""

        def nb(*items) -> int:
            total = 0
            for item in items:
                if isinstance(item, torch.Tensor):
                    total += item.nbytes
                elif isinstance(item, (tuple, list)):
                    total += nb(*item)
            return total

        with self._lock:
            tables = self._ep_tables_dev[1] if self._ep_tables_dev is not None else ()
            return {
                "edges": nb(self._src, self._dst, self._dist, self._mask),
                "staged": nb(self._staged, self._preunion),
                "scorer_tables": nb(tables, self._fresh_dev),
            }

    def upload_stats(self) -> dict:
        """Upload-pipeline counters: depth, uploads, in_flight,
        peak_in_flight, blocked_ms, fences."""
        with self._lock:
            return self._uploads.stats()

    def merge_window(self, batch: SpanBatch, stage: bool = False) -> float:
        """Union this window's dependency edges into the store and update
        per-endpoint record/last-usage metadata: the packed ancestor walk
        plus the union, or the flat walk when the window cannot be packed
        into trace rows (overlong traces, cross-trace parents). Returns
        this call's upload wait in ms.

        stage=True (the streaming path) runs only the walk and its
        self-compaction per window and stages the compacted prefix; the
        staged windows collapse into one pending union while later chunks
        parse (the pre-union), and the store adopts it at the next read
        (_finalize_pending). A window that cannot be packed merges fused
        either way."""
        with self._lock:
            return self._merge_window_locked(batch, stage)

    def _merge_window_locked(self, batch: SpanBatch, stage: bool = False) -> float:
        self._version += 1
        self._note_dirty_locked(batch)
        packed = pack_trace_rows(batch.trace_of, batch.n_spans, batch.parent_idx)
        if stage and packed is not None:
            return self._stage_window_locked(batch, packed)
        self._finalize_pending_locked()
        if packed is not None:
            # ancestor chains cannot outrun the longest trace; cap the walk
            # depth (pow2 buckets, as in the JAX package)
            depth = _packed_depth(packed)
            dev_in, transfer_ms = self._to_device(*_packed_inputs(packed, batch))
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
            dev_in, transfer_ms = self._to_device(
                batch.parent_idx, batch.kind, batch.valid, batch.endpoint_id
            )
            edges = window_ops.dependency_edges(*dev_in, max_depth=depth)
        # the walk's depth bounds every distance it emits
        self._max_dist = max(self._max_dist, depth)
        self._pending = _union_walk(edges, *self._store_cols_locked())
        self._update_ep_metadata(batch)
        return transfer_ms

    def _stage_window_locked(self, batch: SpanBatch, packed) -> float:
        """The staged merge of one packed window: upload, walk and
        self-compact it to a sorted unique prefix of STAGE_CAP rows, with
        its unique count read back asynchronously. The walk inputs stay
        held for the re-walk a truncated prefix needs (count > STAGE_CAP)."""
        depth = _packed_depth(packed)
        self._max_dist = max(self._max_dist, depth)
        packed_key = (
            len(self.interner.endpoints) <= EDGE_KEY_MAX_EP and depth <= EDGE_KEY_MAX_DIST
        )
        host_in = _packed_inputs(packed, batch)
        mesh = self._deploy_mesh(host_in[0].shape[0])
        if mesh is not None:
            fills = (-1, 0, False, 0)
            dev_in, transfer_ms = self._to_device_sharded(
                mesh, *(self._pad_rows_for(mesh, a, f) for a, f in zip(host_in, fills))
            )
            parts = pmesh.sharded_window_edges_compact(
                mesh, *dev_in, max_depth=depth, stage_cap=STAGE_CAP, packed_key=packed_key
            )
            # the shards' prefixes and counts gather on the store's device
            # (peer copies), where the drain's union runs; a shard
            # truncated when the largest count exceeds its prefix
            s, d, ds, counts = (pmesh.unshard(p, self.device) for p in parts)
            count = counts.max()
        else:
            dev_in, transfer_ms = self._to_device(*host_in)
            s, d, ds, count = _window_edges_compact(
                *dev_in, max_depth=depth, stage_cap=STAGE_CAP, packed_key=packed_key
            )
        self._staged.append((s, d, ds, AsyncCount(count), dev_in, depth, mesh))
        # the held walk inputs dominate a large window's staged memory, so
        # they count toward the backstop too: one packed slot (~10 B over
        # the four arrays) ~ one compacted edge row (3 int32)
        self._staged_rows += int(s.shape[0]) + _held_slots(dev_in)
        self._update_ep_metadata(batch)
        if self._staged_rows + self._preunion_rows > STAGE_MAX_ROWS:
            # backstop: an unread stream must not grow device memory
            # without bound
            self._finalize_pending_locked()
        elif self._preunion is not None or len(self._staged) >= 2:
            # drain overlap: collapse what is staged into one pending union
            # now, while the stream's next chunk parses on the host
            self._preunion_staged_locked()
        return transfer_ms

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

    def capacity_bucket(self) -> int:
        """The power-of-two capacity of the edge columns: the tenant
        arena's bucket key (same-bucket graphs stack into [T, cap])."""
        return self.capacity

    def intern_window_edges(self, edges):
        """The host half of merge_window_edges without any state change: a
        window's (caller_uen, callee_uen, distance) triples as
        (src_ids, dst_ids, dist) int lists, or None when the window is
        empty or an endpoint is missing from the interner (the caller
        merges serially then). The tenancy router stacks these before any
        tenant's merge."""
        with self._lock:
            eps = self.interner.endpoints
            src_l, dst_l, dist_l = [], [], []
            for caller, callee, dist in edges:
                s_id = eps.get(caller)
                d_id = eps.get(callee)
                if s_id is None or d_id is None:
                    return None
                src_l.append(s_id)
                dst_l.append(d_id)
                dist_l.append(dist)
        if not src_l:
            return None
        return src_l, dst_l, dist_l

    def adopt_batched_merged(
        self, src, dst, dist, valid_count, batch: SpanBatch, max_dist: int, min_dist: int,
        expected_version=None,
    ) -> None:
        """Adopt one lane of a stacked same-bucket union
        (tenancy.batch.batched_merge_edges) as this window's merge, with
        merge_window_edges' bookkeeping: version, dirty journal, endpoint
        metadata, distance bounds, the deferred count. The lane was
        computed outside the lock from an arena snapshot, so it is adopted
        only while the store still sits at that snapshot's version with
        nothing staged or pending; otherwise StoreVersionDrift."""
        with self._lock:
            drifted = expected_version is not None and self._version != expected_version
            if drifted or self._pending is not None or self._staged or self._preunion is not None:
                raise StoreVersionDrift(
                    f"store v{self._version} (expected v{expected_version}); the stacked lane is stale"
                )
            self._version += 1
            self._note_dirty_locked(batch)
            self._update_ep_metadata(batch)
            self._max_dist = max(self._max_dist, max_dist)
            self._min_dist = min(self._min_dist, min_dist)
            self._pending = (src, dst, dist, valid_count)

    def _union_host_edges_locked(self, src, dst, dist) -> None:
        """Pow2-pad host edge columns (so windows of similar size share
        shapes) and union them into the store."""
        n = len(src)
        cols = []
        for vals in (src, dst, dist):
            col = np.full(_pow2(max(n, 1)), SENTINEL, dtype=np.int32)
            col[:n] = vals
            cols.append(col)
        (d_src, d_dst, d_dist), _wait_ms = self._to_device(*cols)
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

    def stage_fence(self) -> dict:
        """Explicit stage hand-off fence: retire every in-flight upload and
        resolve any deferred or staged merge before a score/serve stage
        reads the graph. The same fence _finalize_pending applies lazily at
        read time, named and counted in the upload stats. Returns the
        graph version and the uploads still in flight."""
        with self._lock:
            self._uploads.note_fence()
            self._finalize_pending_locked()
            return {
                "version": self._version,
                "in_flight": self._uploads.stats()["in_flight"],
            }

    def _finalize_pending_locked(self) -> None:
        # retire the uploads still in flight first: this is the read fence
        # the pipeline defers its waits to
        self._uploads.drain()
        if self._staged or self._preunion is not None:
            self._drain_staged_locked()  # resolves _pending too
            return
        if self._pending is None:
            return
        pending, self._pending = self._pending, None
        self._apply_merged(*pending)

    def _store_cols_locked(self):
        """The store's (src, dst, dist, mask) column view."""
        return self._src, self._dst, self._dist, self._mask

    def _apply_merged(self, src, dst, dist, valid_count) -> None:
        """Adopt a merged edge set: read the count (a device scalar or an
        AsyncCount; the one device sync of a merge), then re-pad to the
        next power-of-2 capacity."""
        valid_count = int(valid_count)
        new_cap = _pow2(valid_count, minimum=int(self._src.shape[0]))
        if new_cap == int(src.shape[0]):
            self._src, self._dst, self._dist = src, dst, dist
        else:
            self._src, self._dst, self._dist = _fit_edges(src, dst, dist, cap=new_cap)
        self._mask = self._src != SENTINEL
        self._n_edges = valid_count

    # -- staged merges (the streaming path) ----------------------------------

    def _base_edge_cols(self):
        """Starting columns for a union: the pre-union when one exists (it
        already holds the store's edges; its count slices it to a pow2
        bucket), else the store columns."""
        if self._preunion is not None:
            s0, d0, ds0 = self._preunion
            # the count's copy was issued a chunk ago; slicing
            # unconditionally keeps the chained unions' widths
            # deterministic
            k = min(int(s0.shape[0]), _pow2(max(int(self._preunion_count), 1), minimum=256))
            if k < int(s0.shape[0]):
                s0, d0, ds0 = s0[:k], d0[:k], ds0[:k]
            return [s0], [d0], [ds0], [s0 != SENTINEL]
        src, dst, dist, mask = self._store_cols_locked()
        return [src], [dst], [dist], [mask]

    def _preunion_staged_locked(self) -> None:
        """Collapse the windows staged so far into one pending union (drain
        overlap): the device sorts while the host parses the next chunk,
        and the stream's final drain unions only the tail. Counts that have
        landed slice their prefixes; the others defer their truncation
        checks to the drain."""
        if not self._staged or self._pending is not None:
            return
        staged, self._staged = self._staged, []
        self._staged_rows = 0
        srcs, dsts, dists, masks = self._base_edge_cols()
        # carried-over checks whose counts have landed: the ones that did
        # not truncate release their walk inputs now, truncated ones
        # re-walk into this union
        still_deferred = []
        for chk in self._preunion_checks:
            count_c, cap_c, dev_in_c, depth_c, mesh_c = chk
            if not count_ready(count_c):
                still_deferred.append(chk)
                continue
            self._preunion_rows -= _held_slots(dev_in_c)
            if int(count_c) > cap_c:
                walked = self._rewalk_staged(dev_in_c, depth_c, mesh_c)
                for cols, col in zip((srcs, dsts, dists, masks), walked):
                    cols.append(col)
        self._preunion_checks = still_deferred
        deferred = []
        self._collect_staged_cols(staged, srcs, dsts, dists, masks, deferred)
        (s, d, ds), v = self._union_edge_cols(srcs, dsts, dists, masks)
        self._preunion = (s, d, ds)
        self._preunion_count = AsyncCount(v.sum())
        self._preunion_checks.extend(deferred)
        self._preunion_rows += sum(_held_slots(c[2]) for c in deferred)

    def _drain_staged_locked(self) -> None:
        """ONE set-union over the store (or the pre-union) and every staged
        window's compacted prefix: the batched equivalent of k fused
        merges. A window whose prefix truncated (count > STAGE_CAP) re-walks
        here from its held inputs, so correctness never depends on the
        cap."""
        staged, self._staged = self._staged, []
        self._staged_rows = 0
        # a fused merge pending before the stream resolves first, so the
        # union below sees the freshest store columns
        if self._pending is not None:
            pending, self._pending = self._pending, None
            self._apply_merged(*pending)
        if not staged and self._preunion is not None:
            # nothing staged since the last pre-union: adopt it as the
            # merged result instead of sorting it again
            s, d, ds = self._preunion
            count = self._preunion_count
            checks = self._preunion_checks
            self._preunion = None
            self._preunion_count = None
            self._preunion_checks = []
            self._preunion_rows = 0
            self._apply_merged(*self._with_rewalks(s, d, ds, count, checks))
            return
        srcs, dsts, dists, masks = self._base_edge_cols()
        deferred = list(self._preunion_checks)
        self._preunion = None
        self._preunion_count = None
        self._preunion_checks = []
        self._preunion_rows = 0
        self._collect_staged_cols(staged, srcs, dsts, dists, masks, deferred)
        (s, d, ds), v = self._union_edge_cols(srcs, dsts, dists, masks)
        # the deferred truncation checks resolve after the union is issued,
        # so their reads overlap its execution
        self._apply_merged(*self._with_rewalks(s, d, ds, AsyncCount(v.sum()), deferred))

    def _with_rewalks(self, s, d, ds, count, checks):
        """Merged columns and their count, with the full candidates of
        every checked window whose prefix truncated (count > cap) unioned
        in."""
        extra = [
            self._rewalk_staged(dev_in, depth, mesh)
            for c, cap, dev_in, depth, mesh in checks
            if int(c) > cap
        ]
        if not extra:
            return s, d, ds, count
        (s, d, ds), v = self._union_edge_cols(
            [s] + [e[0] for e in extra],
            [d] + [e[1] for e in extra],
            [ds] + [e[2] for e in extra],
            [s != SENTINEL] + [e[3] for e in extra],
        )
        return s, d, ds, v.sum()

    def _collect_staged_cols(self, staged, srcs, dsts, dists, masks, deferred) -> None:
        """Append each staged window's compacted prefix to the union
        columns: a landed count slices the prefix to its pow2 width (or
        re-walks the window now when it truncated); a count still in
        flight joins at full width and pushes its truncation check into
        `deferred`. A mesh entry holds one prefix per shard and the largest
        shard count: the check and the slice apply per shard."""
        for s, d, ds, count, dev_in, depth, mesh in staged:
            n_dev = 1 if mesh is None else mesh.shape["spans"]
            cap = int(s.shape[0]) // n_dev
            if count_ready(count):
                n = int(count)
                if n > cap:  # truncated: re-walk now
                    cols = self._rewalk_staged(dev_in, depth, mesh)
                    for out, col in zip((srcs, dsts, dists, masks), cols):
                        out.append(col)
                    continue
                # slice the prefix to its true unique count (pow2-bucketed)
                # instead of sorting STAGE_CAP rows of padding
                k = min(cap, _pow2(max(n, 1), minimum=256))
                if k < cap:
                    s, d, ds = (a.reshape(n_dev, -1)[:, :k].reshape(-1) for a in (s, d, ds))
            else:
                # the final chunk's walk may still be queued: the whole
                # prefix joins the union now and the check resolves after it
                deferred.append((count, cap, dev_in, depth, mesh))
            srcs.append(s)
            dsts.append(d)
            dists.append(ds)
            masks.append(s != SENTINEL)

    def _rewalk_staged(self, dev_in, depth, mesh):
        """Full (uncompacted) candidate walk of a staged window whose
        compacted prefix truncated, on the store's device: correctness
        never depends on the stage cap. A mesh entry re-walks its shards
        with the sharded packed walk and gathers the candidates."""
        if mesh is None:
            return _window_edges_packed(*dev_in, depth)
        walked = pmesh.sharded_dependency_edges_packed(mesh, *dev_in, max_depth=depth)
        return tuple(
            torch.cat([x.reshape(-1).to(self.device, non_blocking=True) for x in col]) for col in walked
        )

    def _union_edge_cols(self, cols_src, cols_dst, cols_dist, cols_mask):
        src = torch.cat(cols_src)
        dst = torch.cat(cols_dst)
        dist = torch.cat(cols_dist)
        mask = torch.cat(cols_mask)
        if (
            len(self.interner.endpoints) <= EDGE_KEY_MAX_EP
            and self._min_dist >= 1
            and self._max_dist <= EDGE_KEY_MAX_DIST
        ):
            return compact_unique_edges_packed(src, dst, dist, mask)
        return compact_unique((src, dst, dist), mask)

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
        # graftlint: disable=host-sync-in-hot-path -- a migration's export reads the edge set back once, off the tick
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
            (fresh_d,) = self._upload(fresh)
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
        path. On a mesh whose device count divides the edge capacity, the
        sharded scorer (parallel/mesh.sharded_service_scores)."""
        src, dst, dist, mask, ep_service, ep_ml, ep_record, svc_cap = self._scorer_inputs(
            label_of, now_ms
        )
        ep_service_d, ep_ml_d, ep_record_d = self._upload(ep_service, ep_ml, ep_record)
        cap = int(src.shape[0])
        mesh = self._deploy_mesh(cap)
        if mesh is not None and cap % mesh.shape["spans"] == 0:
            return pmesh.sharded_service_scores(
                mesh, src, dst, dist, mask, ep_service_d, ep_ml_d, ep_record_d, num_services=svc_cap
            )
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
        ep_service_d, ep_record_d = self._upload(ep_service, ep_record)
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
        out = self._upload(*arrays)
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
        (kind, label epoch, labeled?, svc_cap, ep_cap, fresh fingerprint,
        mesh size) plus the graph version: merges move the version,
        invalidate_labels the epoch, horizon expiry the fingerprint,
        growth the caps, and a mesh that appears or goes (or a capacity the
        device count no longer divides) the mesh size, so a sharded entry
        is never served to the single-device path or the reverse."""
        with phase_span("scorers"):
            return self._scored_inner(kind, label_of, now_ms)

    def _scored_inner(self, kind: str, label_of, now_ms):
        snap = self._scorer_snapshot(label_of, now_ms)
        cap = int(snap["src"].shape[0])
        mesh = self._deploy_mesh(cap) if kind == "svc" else None
        if mesh is not None and cap % mesh.shape["spans"]:
            mesh = None
        base_key = (
            kind,
            snap["label_epoch"],
            label_of is not None,
            snap["svc_cap"],
            snap["ep_cap"],
            snap["fresh_fp"],
            None if mesh is None else mesh.shape["spans"],
        )
        memo_key = base_key + (snap["version"],)
        with self._lock:
            hit = self._scorer_memo.get(memo_key)
            if hit is not None:
                self.scorer_stats["hits"] += 1
        if hit is not None:
            return hit
        with step_timer.phase("scorers"):
            result = self._compute_scores(kind, snap, base_key, mesh)
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

    def _compute_scores(self, kind, snap, base_key, mesh):
        src, dst, dist = snap["src"], snap["dst"], snap["dist"]
        svc_cap = snap["svc_cap"]
        ep_service_d, ep_ml_d, ep_record_d, mask = self._device_tables(snap)
        if mesh is not None:
            # the sharded full recompute (the incremental splice is the
            # single-device path's, as in the JAX store)
            with self._lock:
                self.scorer_stats["full"] += 1
            return pmesh.sharded_service_scores(
                mesh, src, dst, dist, mask, ep_service_d, ep_ml_d, ep_record_d, num_services=svc_cap
            )
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


# -- telemetry: the arena gauges ---------------------------------------------

_ARENA_STORES = []  # weakrefs of live EndpointGraph instances
_ARENA_LOCK = threading.Lock()
_ARENA_REGISTERED = False


def _track_store_arenas(store: EndpointGraph) -> None:
    """Register `store` with the telemetry arena gauges: every live store
    sums into one kmamiz_arena_bytes{arena="graph.*"} reading at scrape
    time; the merge path reports nothing."""
    global _ARENA_REGISTERED
    with _ARENA_LOCK:
        _ARENA_STORES.append(weakref.ref(store))
        if _ARENA_REGISTERED:
            return
        _ARENA_REGISTERED = True

    def _sum(key: str):
        def read() -> int:
            with _ARENA_LOCK:
                _ARENA_STORES[:] = [r for r in _ARENA_STORES if r() is not None]
                live = [r() for r in _ARENA_STORES]
            return sum(s.arena_bytes()[key] for s in live if s is not None)

        return read

    for key in ("edges", "staged", "scorer_tables"):
        tel_device.track_arena(f"graph.{key}", _sum(key))


def graph_signature(graph) -> str:
    """Order-independent content hash of a graph: sha256 over the sorted
    masked (src, dst, distance) edge triples — the same digest as the JAX
    package's resilience.chaos.graph_signature, for graphs of either
    package."""
    src, dst, dist, mask = (
        # graftlint: disable=host-sync-in-hot-path -- a digest reads the edge set back by definition; checks and a migration's verify call it, not the tick
        a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
        for a in graph.edge_arrays()
    )
    live = np.nonzero(mask)[0]
    s, d, c = (np.asarray(x[live], dtype=np.int64) for x in (src, dst, dist))
    order = np.lexsort((c, d, s))
    rows = zip(s[order].tolist(), d[order].tolist(), c[order].tolist())
    text = "".join(f"{a},{b},{k};" for a, b, k in rows)
    return hashlib.sha256(text.encode("ascii")).hexdigest()

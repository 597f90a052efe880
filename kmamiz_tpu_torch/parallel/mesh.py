"""Device-mesh sharding of the span-window pipeline, driven by one process.

Counterpart of kmamiz_tpu/parallel/mesh.py. The scaling axis of this
system is spans-per-window and endpoints-per-graph (SURVEY.md §5): the
window is sharded over a mesh of devices, each device computes its local
segment statistics or walk, and the partial results merge.

The JAX package is single-controller: one process drives every device of
a `jax.sharding.Mesh`, and its sharded programs are `shard_map`s whose
collectives are XLA's `ppermute`, `psum` and `pmax`. The port keeps that
shape. A `Mesh` is a grid of `torch.device`s that the one process serving
the window drives; a *sharded value* is a tuple of per-shard tensors, shard
i on the mesh's i-th device (row-major over the grid); each shard's work is
the port's single-device op, launched on that shard's device, so every
shard's segment sums go through the hand-written kernel
(ops/segment_stats.py) on a card and its plain version on the CPU.

The collectives are built from peer copies, with no library collective:
`ppermute` is `Tensor.to(next_device, non_blocking=True)` (NVLink between
the cards of one host), the rings keep the reference's step order and
chunk ownership, and `psum`/`pmax` reduce onto the first shard's device in
shard order and copy the result back out. A device may repeat in a mesh:
`make_mesh(devices=[torch.device("cuda", 0)] * 8)` is eight virtual shards
of one card, where a copy to the same device is no copy at all (the
counterpart of the reference tests' eight virtual CPU devices).

Activation: the serving components (the store's staged merges and
scorers, the processor's device stats, the tenant arena) consult
`active_mesh(device)` on every window. With more than one card in the
process the window shards over all of them; a single card or the CPU
returns None and the single-device path runs unchanged.
"""
from __future__ import annotations

import os
from functools import lru_cache
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from kmamiz_tpu_torch.core.spans import (
    ROW_SLOTS,
    SpanBatch,
    _pad_size,
    pack_trace_rows,
    spans_to_batch,
)
from kmamiz_tpu_torch.ops import scorers as scorer_ops
from kmamiz_tpu_torch.ops import window as window_ops
from kmamiz_tpu_torch.ops.segment_stats import segment_stats
from kmamiz_tpu_torch.ops.sortutil import (
    compact_unique,
    compact_unique_edges_packed,
    lex_unique,
    scatter_compact,
)

#: a sharded value: shard i lies on the mesh's i-th device
Shards = Tuple[torch.Tensor, ...]

MERGES = ("psum", "ring", "hierarchical")


class Mesh:
    """A grid of devices with named axes, as `jax.sharding.Mesh` holds
    them: `devices` is an ndarray of `torch.device` whose dimensions are
    `axis_names`, and `shape[name]` is the size of an axis. A device may
    repeat (virtual shards of one device). Hashable, so a mesh keys the
    memoized trainers as a JAX mesh does."""

    def __init__(self, devices, axis_names: Sequence[str]) -> None:
        grid = np.array(devices, dtype=object)
        grid = np.vectorize(torch.device, otypes=[object])(grid) if grid.size else grid
        if grid.ndim != len(axis_names):
            raise ValueError(f"a {grid.ndim}-d device grid needs {grid.ndim} axis names, got {tuple(axis_names)}")
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, grid.shape))
        self._key = (tuple(str(d) for d in grid.flat), grid.shape, self.axis_names)

    def device_list(self) -> List[torch.device]:
        """Every device in row-major order: the shard order of a value
        sharded over all the axes."""
        return list(self.devices.flat)

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along `axis`, the other axes at index 0: the shard
        order of a value sharded over that axis alone."""
        k = self.axis_names.index(axis)
        return list(np.moveaxis(self.devices, k, 0).reshape(self.devices.shape[k], -1)[:, 0])

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key == other._key

    def __hash__(self) -> int:
        return hash(self._key)

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)}, {[str(d) for d in self.devices.flat]})"


def process_devices(device) -> List[torch.device]:
    """The devices of `device`'s type that this process drives: every
    visible card for `cuda`, the one CPU for `cpu`. The one place the mesh
    reads the machine; tests patch it to virtual shards."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(dev.type)]


def make_mesh(n_devices: int = 0, axis: str = "spans", devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D mesh over `devices` (repeats allowed), or over the process's
    cards when None; `n_devices` keeps the first n."""
    devs = list(devices) if devices is not None else process_devices("cuda")
    if n_devices:
        devs = devs[:n_devices]
    return Mesh(devs, (axis,))


@lru_cache(maxsize=8)
def _mesh_for(devices: Tuple[torch.device, ...], axis: str) -> Mesh:
    return make_mesh(axis=axis, devices=devices)


def active_mesh(device=None, axis: str = "spans") -> Optional[Mesh]:
    """The mesh the deployed path shards over for work on `device`'s type
    (the card when None), or None below two devices.

    Environment switches, read per call so a caller can flip them:
      KMAMIZ_MESH=0          single-device even with many cards
      KMAMIZ_MESH_DEVICES=N  cap the mesh at the first N devices
    """
    if os.environ.get("KMAMIZ_MESH", "1") in ("0", "off", "false"):
        return None
    devs = process_devices("cuda" if device is None else device)
    limit = int(os.environ.get("KMAMIZ_MESH_DEVICES", "0") or 0)
    if limit:
        devs = devs[:limit]
    if len(devs) < 2:
        return None
    return _mesh_for(tuple(devs), axis)


# ---------------------------------------------------------------------------
# sharded values
# ---------------------------------------------------------------------------


def _to(x: torch.Tensor, device) -> torch.Tensor:
    """x on `device`: a peer copy that does not wait for the host between
    cards, a plain (waited-for) copy onto the CPU, no copy where x lies."""
    device = torch.device(device)
    return x.to(device, non_blocking=device.type == "cuda")


def shard(x, devices: Sequence[torch.device]) -> Shards:
    """`x` (a tensor or host array) split along its leading dimension into
    len(devices) equal blocks, block i copied to devices[i]. A tuple or
    list of shards passes through (its length checked)."""
    n = len(devices)
    if isinstance(x, (tuple, list)):
        if len(x) != n:
            raise ValueError(f"{len(x)} shards for {n} devices")
        return tuple(x)
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    if t.shape[0] % n:
        raise ValueError(f"a leading dimension of {t.shape[0]} does not shard over {n} devices")
    return tuple(_to(b, d) for b, d in zip(t.split(t.shape[0] // n), devices))


def replicate(x: torch.Tensor, devices: Sequence[torch.device]) -> Shards:
    """One copy of `x` on every device (no copy where it already lies)."""
    return tuple(_to(x, d) for d in devices)


def unshard(xs: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The shards concatenated along their leading dimension on `device`."""
    return torch.cat([_to(x, device) for x in xs])


# ---------------------------------------------------------------------------
# collectives from peer copies
#
# The reference writes its merges as the classic ring algorithms over
# lax.ppermute (reduce-scatter, then all-gather) so cross-shard merges
# overlap chunk transfers with adds and can leave the result
# segment-sharded. Here the shift is a peer copy per shard; the step order,
# the chunk each shard owns and the final rotation are the reference's, so
# a ring merge adds in the reference's order.
# ---------------------------------------------------------------------------


def _combine(op: str):
    if op == "add":
        return torch.add
    if op == "max":
        return torch.maximum
    raise ValueError(f"unknown reduction {op!r}")


def ppermute(xs: Sequence[torch.Tensor]) -> Shards:
    """The ring shift (lax.ppermute over the pairs (i, i+1 mod n)): shard i
    receives shard i-1's tensor, copied to its own device."""
    return tuple(_to(xs[i - 1], xs[i].device) for i in range(len(xs)))


def ring_reduce_scatter(xs: Sequence[torch.Tensor], op: str = "add") -> Shards:
    """Reduce xs (one full-length [n*c, ...] partial per shard) so shard i
    holds the fully merged chunk i: n-1 shifts, each followed by one
    combine, then a final rotation that lands chunk i on shard i. The
    leading dimension must divide into n chunks (pad first, as
    sharded_window_stats does)."""
    n = len(xs)
    length = xs[0].shape[0]
    if length % n:
        raise ValueError(f"ring_reduce_scatter needs len divisible by {n}, got {length}")
    c = length // n
    combine = _combine(op)

    def chunk(i: int, j: int) -> torch.Tensor:
        j %= n
        return xs[i][j * c : (j + 1) * c]

    carry = tuple(chunk(i, i) for i in range(n))
    for k in range(n - 1):
        carry = ppermute(carry)
        carry = tuple(combine(carry[i], chunk(i, i - 1 - k)) for i in range(n))
    # shard i now holds merged chunk i+1; rotate once so i owns chunk i
    return ppermute(carry)


def ring_all_gather(chunks: Sequence[torch.Tensor]) -> Shards:
    """Shard-owned chunks [c, ...] -> the replicated [n*c, ...] on every
    shard, through n-1 ring shifts."""
    n = len(chunks)
    slots = [[None] * n for _ in range(n)]
    rolling = tuple(chunks)
    for k in range(n):
        for i in range(n):
            slots[i][(i - k) % n] = rolling[i]  # whose chunk shard i holds at step k
        if k != n - 1:
            rolling = ppermute(rolling)
    return tuple(torch.cat(s) for s in slots)


def ring_all_reduce(xs: Sequence[torch.Tensor], op: str = "add") -> Shards:
    """psum/pmax built from the ring reduce-scatter and all-gather."""
    return ring_all_gather(ring_reduce_scatter(xs, op))


def _reduce(xs: Sequence[torch.Tensor], op: str) -> Shards:
    """Every shard combined onto the first shard's device in shard order,
    the result copied back to every shard."""
    combine = _combine(op)
    dev0 = xs[0].device
    total = xs[0]
    for x in xs[1:]:
        total = combine(total, _to(x, dev0))
    return replicate(total, [x.device for x in xs])


def psum(xs: Sequence[torch.Tensor]) -> Shards:
    """lax.psum over the shards, from peer copies."""
    return _reduce(xs, "add")


def pmax(xs: Sequence[torch.Tensor]) -> Shards:
    """lax.pmax over the shards, from peer copies."""
    return _reduce(xs, "max")


def hierarchical_all_reduce(xs: Sequence[torch.Tensor], n_chip: int, op: str = "add") -> Shards:
    """The multi-host all-reduce of a value sharded host-major over a
    ('host', chip) grid (shard h * n_chip + s on host h): a ring
    reduce-scatter within each host, ONE cross-host reduction of each
    1/n_chip-sized owned chunk (the slow wire carries only chunk-sized
    traffic), then a ring all-gather back within each host."""
    n = len(xs)
    if n % n_chip:
        raise ValueError(f"{n} shards do not form hosts of {n_chip}")
    hosts = [ring_reduce_scatter(xs[h * n_chip : (h + 1) * n_chip], op) for h in range(n // n_chip)]
    for s in range(n_chip):
        merged = _reduce([row[s] for row in hosts], op)
        hosts = [row[:s] + (merged[h],) + row[s + 1 :] for h, row in enumerate(hosts)]
    return tuple(x for row in hosts for x in ring_all_gather(row))


# ---------------------------------------------------------------------------
# window layout (host code)
# ---------------------------------------------------------------------------


class ShardedWindow(NamedTuple):
    """One window of spans laid out for an n-way mesh.

    Every array is [n_shards * per_shard]; rows are grouped so each shard's
    parent indices are shard-local (whole traces per shard)."""

    valid: np.ndarray
    kind: np.ndarray
    parent_idx: np.ndarray  # local to the shard slice
    endpoint_id: np.ndarray
    rt_endpoint_id: np.ndarray
    status_id: np.ndarray
    status_class: np.ndarray
    latency_ms: np.ndarray
    timestamp_rel: np.ndarray
    per_shard: int
    ts_base_us: int
    batches: List[SpanBatch]


def shard_window(
    trace_groups: Sequence[Sequence[dict]],
    n_shards: int,
    interner=None,
    statuses=None,
) -> ShardedWindow:
    """Pack whole trace groups into n_shards per-device batches sharing one
    intern table, then concatenate to a single global array layout."""
    from kmamiz_tpu_torch.core.interning import EndpointInterner, StringInterner

    interner = interner or EndpointInterner()
    statuses = statuses or StringInterner()

    # round-robin whole traces so parent chains never cross shards
    per_shard_groups: List[List[Sequence[dict]]] = [[] for _ in range(n_shards)]
    for i, group in enumerate(trace_groups):
        per_shard_groups[i % n_shards].append(group)

    # one window-wide timestamp base: per-shard rel offsets must be
    # comparable under the cross-shard max merge
    all_ts = [s.get("timestamp", 0) for g in trace_groups for s in g]
    ts_base = min(all_ts) if all_ts else 0

    batches = [
        spans_to_batch(groups, interner=interner, statuses=statuses, pad=False, ts_base_us=ts_base)
        for groups in per_shard_groups
    ]
    per_shard = max(max(b.capacity for b in batches), 8)

    def pad_to(arr, fill=0):
        out = np.full((n_shards, per_shard), fill, dtype=arr[0].dtype)
        for s, a in enumerate(arr):
            out[s, : len(a)] = a
        return out.reshape(-1)

    return ShardedWindow(
        valid=pad_to([b.valid for b in batches], False),
        kind=pad_to([b.kind for b in batches]),
        parent_idx=pad_to([b.parent_idx for b in batches], -1),
        endpoint_id=pad_to([b.endpoint_id for b in batches]),
        rt_endpoint_id=pad_to([b.rt_endpoint_id for b in batches]),
        status_id=pad_to([b.status_id for b in batches]),
        status_class=pad_to([b.status_class for b in batches]),
        latency_ms=pad_to([b.latency_ms.astype(np.float32) for b in batches]),
        timestamp_rel=pad_to([b.timestamp_rel for b in batches]),
        per_shard=per_shard,
        ts_base_us=ts_base,
        batches=batches,
    )


def shard_window_packed(sharded: ShardedWindow):
    """Trace-row pack each shard of a ShardedWindow for the packed walk.

    Traces were round-robined whole into shards (shard_window), so parent
    chains are shard-local and each shard packs independently with
    core.spans.pack_trace_rows, the layout the single-device store merge
    uses. Shards pad to a common row count so the leading dim shards
    evenly.

    Returns (parent_slot2, kind2, valid2, ep2) of shape
    [n_shards * rows_per_shard, ROW_SLOTS] plus the pow2-bucketed walk
    depth cap, or None when a shard cannot pack (the caller then walks
    the flat layout with sharded_dependency_edges)."""
    packs = []
    max_rows = 1
    max_chain = 1
    for b in sharded.batches:
        if b.n_spans == 0:
            # an empty shard packs trivially as all-invalid rows; only a
            # shard pack_trace_rows cannot lay out (overlong trace,
            # cross-trace parent) sends the window to the flat walk
            packs.append(None)
            continue
        pk = pack_trace_rows(b.trace_of, b.n_spans, b.parent_idx)
        if pk is None:
            return None
        packs.append(pk)
        max_rows = max(max_rows, pk.n_rows)
        max_chain = max(max_chain, pk.max_trace_len - 1)
    n_shards = len(packs)
    rows = _pad_size(max_rows)

    pslot2 = np.full((n_shards, rows, ROW_SLOTS), -1, dtype=np.int32)
    kind2 = np.zeros((n_shards, rows, ROW_SLOTS), dtype=np.int8)
    valid2 = np.zeros((n_shards, rows, ROW_SLOTS), dtype=bool)
    ep2 = np.zeros((n_shards, rows, ROW_SLOTS), dtype=np.int32)
    for s, (pk, b) in enumerate(zip(packs, sharded.batches)):
        if pk is None:
            continue  # empty shard: all-invalid rows already in place
        n = b.n_spans
        pslot2[s, : pk.n_rows] = pk.pack(pk.parent_slots(b.parent_idx), -1)
        kind2[s, : pk.n_rows] = pk.pack(b.kind[:n], 0)
        valid2[s, : pk.n_rows] = pk.pack(b.valid[:n], False)
        ep2[s, : pk.n_rows] = pk.pack(b.endpoint_id[:n], 0)

    depth = min(window_ops.MAX_DEPTH, _pad_size(max(1, max_chain), minimum=4))

    def flat(a):
        return a.reshape(n_shards * rows, ROW_SLOTS)

    return flat(pslot2), flat(kind2), flat(valid2), flat(ep2), depth


# ---------------------------------------------------------------------------
# sharded programs
# ---------------------------------------------------------------------------


def _merged(xs: Sequence[torch.Tensor], merge: str, n_chip: int, op: str = "add") -> Shards:
    """One cross-shard merge of per-shard [S, ...] partials, replicated on
    every shard. The rings pad S to a multiple of the ring's length."""
    if merge == "psum":
        return psum(xs) if op == "add" else pmax(xs)
    segments = xs[0].shape[0]
    pad = -segments % n_chip
    if pad:
        xs = [torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))]) for x in xs]
    if merge == "ring":
        out = ring_all_reduce(xs, op)
    else:
        out = hierarchical_all_reduce(xs, n_chip, op)
    return tuple(x[:segments] for x in out)


def sharded_window_stats(
    mesh: Mesh,
    rt_endpoint_id,
    status_id,
    status_class,
    latency_ms,
    timestamp_rel,
    valid_server,
    num_endpoints: int,
    num_statuses: int,
    axis: str = "spans",
    merge: str = "psum",
) -> window_ops.WindowStats:
    """Per-shard segment stats and a cross-shard merge over the mesh.

    The span columns are sharded values (or global tensors / host arrays,
    split here) along the span dimension; the result is the fully merged
    per-(endpoint, status) WindowStats on the first shard's device.

    Per shard, on its device: ops/window.stat_rows, segment_stats over the
    five stat rows (the kernel on a card), the merge; then the squared
    residuals against the merged mean, segment_stats again, and the merge
    again: the reference's two-pass pooled variance (the E[x^2]-E[x]^2 form
    cancels in float32). So the kernel launches twice per shard per call.

    merge: 'psum' reduces onto the first shard and copies back; 'ring' runs
    the ring reduce-scatter + all-gather; 'hierarchical' (a 2-D
    ('host', axis) mesh, the spans sharded over both axes, host-major) ring
    reduces within each host and crosses hosts with chunk-sized traffic."""
    if merge not in MERGES:
        raise ValueError(f"unknown merge {merge!r}; one of {MERGES}")
    devices = mesh.device_list() if merge == "hierarchical" else mesh.axis_devices(axis)
    n_chip = mesh.shape[axis] if merge == "hierarchical" else len(devices)
    cols = [
        shard(a, devices)
        for a in (rt_endpoint_id, status_id, status_class, latency_ms, timestamp_rel, valid_server)
    ]
    num_segments = num_endpoints * num_statuses
    inputs, sums, ts = [], [], []
    for i in range(len(devices)):
        values, seg, ts_in, _ = window_ops.stat_rows(*(c[i] for c in cols), num_endpoints, num_statuses)
        s, t = segment_stats(values, seg, ts_in, num_segments)
        inputs.append((values, seg))
        sums.append(s.t())  # [S, 5]: the merge runs over segments
        ts.append(t)
    m_sums = _merged(sums, merge, n_chip)
    m_ts = _merged(ts, merge, n_chip, op="max")
    resid = []
    for (values, seg), s in zip(inputs, m_sums):
        rows = window_ops.residual_rows(values, seg, s.t(), num_segments)
        r, _ = segment_stats(rows, seg, None, num_segments)
        resid.append(r[0])
    m_resid = _merged(resid, merge, n_chip)
    merged = m_sums[0].t()
    # empty segments report 0, as the single-device window_stats does
    ts_max = torch.where(merged[0] > 0, m_ts[0], 0)
    return window_ops.finish_stats(merged, m_resid[0], ts_max)


def _sharded_walk(walk, mesh: Mesh, cols, max_depth: int, axis: str):
    """`walk` (an ops/window walk) per shard on its device; its edge
    columns as sharded values."""
    devices = mesh.axis_devices(axis)
    shards = [shard(a, devices) for a in cols]
    outs = [walk(*(c[i] for c in shards), max_depth=max_depth) for i in range(len(devices))]
    return tuple(tuple(getattr(o, f) for o in outs) for f in ("ancestor_ep", "descendant_ep", "distance", "mask"))


def sharded_dependency_edges(
    mesh: Mesh,
    parent_idx,
    kind,
    valid,
    endpoint_id,
    max_depth: int = window_ops.MAX_DEPTH,
    axis: str = "spans",
):
    """Per-shard ancestor walk over the flat layout (the walk of windows
    shard_window_packed cannot lay out: overlong traces, cross-trace
    parents). Returns (ancestor_ep, descendant_ep, distance, mask), each a
    sharded value of per-shard [per_shard, max_depth] tensors."""
    return _sharded_walk(window_ops.dependency_edges, mesh, (parent_idx, kind, valid, endpoint_id), max_depth, axis)


def sharded_dependency_edges_packed(
    mesh: Mesh,
    parent_slot,
    kind,
    valid,
    endpoint_id,
    max_depth: int = window_ops.MAX_DEPTH,
    axis: str = "spans",
):
    """Per-shard packed ancestor walk over trace-packed [rows, ROW_SLOTS]
    blocks (rows sharded over `axis`): no cross-shard traffic, the walk is
    embarrassingly parallel once traces are shard-local. Returns
    (ancestor_ep, descendant_ep, distance, mask) as sharded values."""
    return _sharded_walk(
        window_ops.dependency_edges_packed, mesh, (parent_slot, kind, valid, endpoint_id), max_depth, axis
    )


def sharded_window_edges_compact(
    mesh: Mesh,
    parent_slot,
    kind,
    valid,
    endpoint_id,
    max_depth: int,
    stage_cap: int,
    packed_key: bool,
    axis: str = "spans",
):
    """The staged merge's walk over the mesh, the multi-device twin of
    graph/store._window_edges_compact: each shard walks its own
    trace-packed rows and compacts its candidates to a sorted unique prefix
    of stage_cap rows. Returns (src, dst, dist, count) as sharded values:
    per shard the prefix columns and a [1] true-unique count, so unsharded
    they are n * stage_cap edge columns and an [n] count vector; a shard
    whose count exceeds the prefix truncated and re-walks at the drain."""
    devices = mesh.axis_devices(axis)
    cols = [shard(a, devices) for a in (parent_slot, kind, valid, endpoint_id)]
    out = []
    for i in range(len(devices)):
        edges = window_ops.dependency_edges_packed(*(c[i] for c in cols), max_depth=max_depth)
        flat = (edges.ancestor_ep.reshape(-1), edges.descendant_ep.reshape(-1), edges.distance.reshape(-1))
        mask = edges.mask.reshape(-1)
        if packed_key:
            (s, d, ds), v = compact_unique_edges_packed(*flat, mask)
        else:
            (s, d, ds), v = compact_unique(flat, mask)
        out.append((s[:stage_cap], d[:stage_cap], ds[:stage_cap], v.sum().reshape(1)))
    return tuple(tuple(o[k] for o in out) for k in range(4))


def _params_to(params, device):
    return type(params)(*(None if p is None else _to(p, device) for p in params))


def _index_to(index, device):
    """An EdgeIndex (ops/sparse.py) with every tensor on `device`."""
    if index is None:
        return None
    return type(index)(
        *(
            _index_to(f, device) if isinstance(f, tuple) else (None if f is None else _to(f, device))
            for f in index
        )
    )


def make_sharded_slot_grad(mesh: Mesh, loss_fn, axis: str = "slots"):
    """Data-parallel grads over a SLOT MICROBATCH of training windows (the
    GraphSAGE trainer's stacked slots, models/stacked.py).

    loss_fn has the models/common loss signature. The returned
    batch_grads(params, feats[B, Nb, F], tl[B, Nb], ta[B, Nb], nm[B, Nb],
    src, dst, edge_mask, w[B], index=None) -> (grads, losses[3]) shards the
    batch axis over the mesh: params, the edge columns and the edge index
    are replicated (one copy per device; none where they already lie), and
    each shard computes its B/n slots' weighted grads with
    common.value_and_grad on its device (the fused kernel's forward and
    backward on a card). The grads, the weighted losses and the weight
    total merge onto the params' device in shard order, and the sums are
    divided by the merged weight: the unsharded weighted batch mean, so the
    optimizer update does not depend on the device count."""
    from kmamiz_tpu_torch.models import common

    devices = mesh.axis_devices(axis)
    n = len(devices)

    def batch_grads(params, feats, tl, ta, nm, src, dst, em, w, index=None):
        if feats.shape[0] % n:
            raise ValueError(
                f"slot batch of {feats.shape[0]} does not shard over "
                f"{n} devices; pick a batch size divisible by the mesh"
            )
        b = feats.shape[0] // n
        parts = []
        for i, dev in enumerate(devices):
            p = _params_to(params, dev)
            idx = _index_to(index, dev)
            edges = [_to(x, dev) for x in (src, dst, em)]
            blocks = [_to(x[i * b : (i + 1) * b], dev) for x in (feats, tl, ta, nm, w)]
            grads = None
            totals = torch.zeros(3, dtype=torch.float32, device=dev)
            for f, lt, at, m, wi in zip(*blocks):
                loss, (lat_l, ano_l), g = common.value_and_grad(
                    loss_fn, p, f, *edges, lt, at, m, index=idx
                )
                g = [None if x is None else x * wi for x in g]
                grads = g if grads is None else [None if a is None else a + c for a, c in zip(grads, g)]
                totals = totals + torch.stack([loss, lat_l, ano_l]) * wi
            parts.append((grads, totals, blocks[4].sum()))
        home = next(x for x in params if x is not None).device

        def merged(values):
            total = _to(values[0], home)
            for v in values[1:]:
                total = total + _to(v, home)
            return total

        wsum = torch.clamp(merged([wp for _, _, wp in parts]), min=1.0)
        grads = [
            None if parts[0][0][k] is None else merged([g[k] for g, _, _ in parts]) / wsum
            for k in range(len(params))
        ]
        return type(params)(*grads), merged([t for _, t, _ in parts]) / wsum

    return batch_grads


def sharded_service_scores(
    mesh: Mesh,
    src_ep: torch.Tensor,
    dst_ep: torch.Tensor,
    dist: torch.Tensor,
    mask: torch.Tensor,
    ep_service: torch.Tensor,
    ep_ml: torch.Tensor,
    ep_has_record: torch.Tensor,
    num_services: int,
    axis: str = "spans",
) -> scorer_ops.ServiceScores:
    """service_scores with the edge -> tuple expansion, the local dedup and
    the depended-by degree partials sharded over the mesh.

    Per shard, on its device: its edge rows expand into both direction
    tuples (ops/scorers.edge_direction_tuples), lex-sort and dedup locally
    (n local sorts in place of one global-size sort) and compact to a
    prefix; its partial depended-by degrees merge in one psum. Then the
    prefixes, concatenated on the first shard's device, feed the counting
    core the single-device legacy scorer uses (score_tuple_rows), whose
    global lex_unique collapses cross-shard duplicates: the results are
    the single-device scorer's. The endpoint tables are replicated."""
    devices = mesh.axis_devices(axis)
    edges = [shard(a, devices) for a in (src_ep, dst_ep, dist, mask)]
    tables = [replicate(t, devices) for t in (ep_service, ep_ml, ep_has_record)]
    num_endpoints = int(ep_service.shape[0])
    prefixes, degrees = [], []
    for i in range(len(devices)):
        s, d, ds, m = (e[i] for e in edges)
        rows = scorer_ops.edge_direction_tuples(s, d, ds, m, *(t[i] for t in tables))
        cols, uniq = lex_unique(rows[:-1], rows[-1])
        comp, valid = scatter_compact(cols, uniq)
        prefixes.append((*comp, valid))
        degrees.append(scorer_ops.depended_by_degrees(d, m, num_endpoints))
    by_deg = psum(degrees)[0]
    home = devices[0]
    o, l, dr, dd, ml, valid = (unshard([p[k] for p in prefixes], home) for k in range(6))
    is_gateway = scorer_ops.gateway_mask(
        dst_ep, mask, tables[0][0], tables[2][0], num_services, by_deg=by_deg
    )
    return scorer_ops.score_tuple_rows(o, l, dr, dd, ml, valid, is_gateway, num_services=num_services)

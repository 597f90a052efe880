"""Tensor ops of the span-window pipeline (the DP hot path).

Counterpart of kmamiz_tpu/ops/window.py, function for function:

- The per-span parent-chain walk (trace.rs:110-212 / Traces.ts:128-143) is
  a fixed-iteration ancestor enumeration: resolve each span's nearest
  non-CLIENT ancestor by iterated pointer jumps, then hop that
  skip-pointer MAX_DEPTH times, emitting (ancestor, descendant, distance)
  edge triples. The JAX package's `scan` loops are plain Python loops of
  gathers here.
- Every Map-groupby (realtime_data.rs:31-121 / RealtimeDataList.ts:23-33)
  is a segment reduction keyed by endpoint*num_statuses+status;
  window_stats runs it through the hand-written CUDA kernel
  (ops/segment_stats.py) on the card and its plain version on the CPU.

Inputs are the same fixed-shape padded arrays (core.spans.SpanBatch) the
JAX package takes, as tensors on any one device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from kmamiz_tpu_torch.core.spans import KIND_CLIENT, KIND_SERVER
from kmamiz_tpu_torch.ops.segment_stats import segment_stats

MAX_CLIENT_SKIP = 16  # max run of consecutive CLIENT spans in a parent chain
MAX_DEPTH = 32  # max SERVER-ancestor depth recorded (trace trees are shallow)


def skip_client_parents(
    parent_idx: torch.Tensor,
    kind: torch.Tensor,
    valid: torch.Tensor,
    max_client_skip: int = MAX_CLIENT_SKIP,
) -> torch.Tensor:
    """For each span, the index of its nearest non-CLIENT strict ancestor
    within the window (-1 if none)."""
    safe_parent = torch.where(valid, parent_idx, -1)
    c = safe_parent
    for _ in range(max_client_skip):
        c_safe = c.clamp(min=0).long()
        is_client_parent = (c >= 0) & (kind[c_safe] == KIND_CLIENT)
        c = torch.where(is_client_parent, safe_parent[c_safe], c)
    # a chain of >max_client_skip CLIENT spans leaves a CLIENT as the carry;
    # mask it to -1 (truncation) rather than emitting a CLIENT ancestor
    still_client = (c >= 0) & (kind[c.clamp(min=0).long()] == KIND_CLIENT)
    return torch.where(still_client, -1, c)


class Edges(NamedTuple):
    ancestor_ep: torch.Tensor  # int32[n, max_depth]
    descendant_ep: torch.Tensor  # int32[n, max_depth]
    distance: torch.Tensor  # int32[n, max_depth]
    mask: torch.Tensor  # bool[n, max_depth]
    ancestor_span: torch.Tensor  # int32[n, max_depth]


def dependency_edges(
    parent_idx: torch.Tensor,
    kind: torch.Tensor,
    valid: torch.Tensor,
    endpoint_id: torch.Tensor,
    max_depth: int = MAX_DEPTH,
    max_client_skip: int = MAX_CLIENT_SKIP,
) -> Edges:
    """Enumerate (ancestor_endpoint, descendant_endpoint, distance) triples.

    Returns arrays of shape [n, max_depth]: ancestor_ep, descendant_ep,
    distance, mask. A row i contributes edges only if span i is a valid
    SERVER span; ancestors are its non-CLIENT ancestor chain, distance
    counted per recorded hop exactly like the reference walk.
    """
    skip = skip_client_parents(parent_idx, kind, valid, max_client_skip)
    is_server = valid & (kind == KIND_SERVER)

    anc = skip
    steps = []
    for _ in range(max_depth):
        steps.append(anc)
        anc = torch.where(anc >= 0, skip[anc.clamp(min=0).long()], -1)
    ancestors = torch.stack(steps, dim=1)  # [n, max_depth]
    anc_valid = (ancestors >= 0) & is_server[:, None]
    anc_safe = ancestors.clamp(min=0).long()

    distances = torch.arange(
        1, max_depth + 1, dtype=torch.int32, device=parent_idx.device
    )[None, :]
    return Edges(
        ancestor_ep=torch.where(anc_valid, endpoint_id[anc_safe], -1),
        descendant_ep=torch.where(anc_valid, endpoint_id[:, None], -1),
        distance=torch.where(anc_valid, distances, 0),
        mask=anc_valid,
        ancestor_span=torch.where(anc_valid, ancestors, -1),
    )


class PackedEdges(NamedTuple):
    ancestor_ep: torch.Tensor  # int32[T*L, max_depth]
    descendant_ep: torch.Tensor  # int32[T*L, max_depth]
    distance: torch.Tensor  # int32[T*L, max_depth]
    mask: torch.Tensor  # bool[T*L, max_depth]
    ancestor_slot: torch.Tensor  # int32[T*L, max_depth] (packed flat index)


def dependency_edges_packed_sparse(
    parent_slot: torch.Tensor,
    kind: torch.Tensor,
    valid: torch.Tensor,
    endpoint_id: torch.Tensor,
    max_depth: int = MAX_DEPTH,
    max_client_skip: int = MAX_CLIENT_SKIP,
) -> PackedEdges:
    """dependency_edges over trace-packed rows ([T, L] from
    core.spans.pack_trace_rows): every hop is a row-local gather over the
    packed rows.

    Same CLIENT-skip pointer doubling, same truncation and same PackedEdges
    layout as the JAX package's packed walks; only the row layout and the
    meaning of ancestor_slot (packed flat index, not batch index) differ
    from dependency_edges.
    """
    t_rows, l_slots = parent_slot.shape
    device = parent_slot.device
    iota = torch.arange(l_slots, dtype=torch.int32, device=device)

    def gather_slot(idx, x):
        # out[t, j] = x[t, idx[t, j]] with -1 passthrough
        g = torch.gather(x, 1, idx.clamp(min=0).long())
        return torch.where(idx < 0, -1, g)

    is_client = kind == KIND_CLIENT
    safe_parent = torch.where(valid & (parent_slot >= 0), parent_slot, -1)

    # CLIENT-skip by pointer doubling: h is identity on non-CLIENT slots and
    # parent on CLIENT slots, so h^k applies exactly k conditional hops
    # (-1 absorbs). Binary decomposition keeps h^max_client_skip EXACT for
    # any cap, matching skip_client_parents' truncation step for step.
    h = torch.where(is_client, safe_parent, iota[None, :])
    result = iota[None, :].expand(h.shape)  # h^0 = identity
    k = max_client_skip
    power = h
    while k:
        if k & 1:
            # h^(a+b)[j] = h^a[h^b[j]]  (powers of one function commute)
            result = gather_slot(result, power)
        k >>= 1
        if k:
            power = gather_slot(power, power)
    skip_raw = gather_slot(safe_parent, result)
    # chains longer than the cap leave a CLIENT slot: truncate to -1
    still_client = (skip_raw >= 0) & torch.gather(
        is_client, 1, skip_raw.clamp(min=0).long()
    )
    skip = torch.where(still_client, -1, skip_raw)

    is_server = valid & (kind == KIND_SERVER)
    row_base = (
        torch.arange(t_rows, dtype=torch.int32, device=device) * l_slots
    )[:, None]

    anc = skip
    anc_eps, anc_slots, masks = [], [], []
    for _ in range(max_depth):
        anc_safe = anc.clamp(min=0).long()
        step_mask = (anc >= 0) & is_server
        ep_d = torch.gather(endpoint_id, 1, anc_safe)
        anc_eps.append(torch.where(step_mask, ep_d, -1))
        anc_slots.append(torch.where(step_mask, row_base + anc, -1))
        masks.append(step_mask)
        nxt = torch.gather(skip, 1, anc_safe)
        anc = torch.where(anc < 0, -1, nxt)

    def stack(parts):
        return torch.stack(parts, dim=-1).reshape(t_rows * l_slots, max_depth)

    mask = stack(masks)
    distances = torch.arange(1, max_depth + 1, dtype=torch.int32, device=device)[
        None, :
    ]
    return PackedEdges(
        ancestor_ep=stack(anc_eps),
        descendant_ep=torch.where(mask, endpoint_id.reshape(-1, 1), -1),
        distance=torch.where(mask, distances, 0),
        mask=mask,
        ancestor_slot=stack(anc_slots),
    )


#: The JAX package's dependency_edges_packed does each hop as a row-local
#: one-hot einsum, a TPU matrix-unit idiom (XLA work, not a Pallas kernel).
#: On a GPU a gather is the direct form, so both names run the gather walk;
#: the tests hold it bit-exact against both JAX walks.
dependency_edges_packed = dependency_edges_packed_sparse


class WindowStats(NamedTuple):
    """Per-(endpoint, status) segment statistics for one window."""

    count: torch.Tensor  # float32[S]
    error_4xx: torch.Tensor  # float32[S]
    error_5xx: torch.Tensor  # float32[S]
    latency_sum: torch.Tensor  # float32[S]
    latency_sq_sum: torch.Tensor  # float32[S]
    latency_mean: torch.Tensor  # float32[S]
    latency_cv: torch.Tensor  # float32[S]
    latest_timestamp_rel: torch.Tensor  # int32[S] (max offset from window base)


def stat_rows(
    endpoint_id: torch.Tensor,
    status_id: torch.Tensor,
    status_class: torch.Tensor,
    latency_ms: torch.Tensor,
    timestamp_rel: torch.Tensor,
    valid_server: torch.Tensor,
    num_endpoints: int,
    num_statuses: int,
):
    """The first segment_stats pass's inputs: (values[5, N] float32 —
    count, 4xx, 5xx, latency, latency^2 — seg[N], ts[N], num_segments),
    with invalid rows parked at segment num_segments."""
    num_segments = num_endpoints * num_statuses
    seg = endpoint_id.to(torch.int32) * num_statuses + status_id.to(torch.int32)
    seg = torch.where(valid_server, seg, num_segments)  # park invalid rows
    # float32 throughout, as the JAX package computes with x64 off
    w = valid_server.to(torch.float32)
    lat_f = latency_ms.to(torch.float32)
    values = torch.stack(
        [
            w,
            w * (status_class == 4),
            w * (status_class == 5),
            lat_f * w,
            lat_f * lat_f * w,
        ]
    )
    ts = torch.where(valid_server, timestamp_rel, 0).to(torch.int32)
    return values, seg, ts, num_segments


def residual_rows(
    values: torch.Tensor, seg: torch.Tensor, sums: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """The second pass's input: [1, N] squared residuals of each valid
    span's latency against its segment mean from the first pass. values[0]
    is the 0/1 validity weight and values[3] the weighted latency, so
    (values[3] - mean) * values[0] equals (latency - mean) * weight."""
    mean = sums[3] / sums[0].clamp(min=1)
    resid = (values[3] - mean[seg.clamp(max=num_segments - 1).long()]) * values[0]
    return (resid * resid)[None, :]


def window_stats(
    endpoint_id: torch.Tensor,
    status_id: torch.Tensor,
    status_class: torch.Tensor,
    latency_ms: torch.Tensor,
    timestamp_rel: torch.Tensor,
    valid_server: torch.Tensor,
    num_endpoints: int,
    num_statuses: int,
) -> WindowStats:
    """Segment-combine per (endpoint, status): request count, 4xx/5xx counts,
    latency mean + CV, and latest timestamp — the JAX package's
    backend="pallas" path, step for step: one segment_stats pass over the
    five stat rows, then a second over the squared residuals against the
    segment means (two-pass variance; the E[x^2]-E[x]^2 form cancels
    catastrophically in float32).

    timestamp_rel: int32 microsecond offsets from the window base (the
    caller adds the base back on the host)."""
    values, seg, ts_in, num_segments = stat_rows(
        endpoint_id,
        status_id,
        status_class,
        latency_ms,
        timestamp_rel,
        valid_server,
        num_endpoints,
        num_statuses,
    )
    sums, ts = segment_stats(values, seg, ts_in, num_segments)
    resid_sq, _ = segment_stats(
        residual_rows(values, seg, sums, num_segments), seg, None, num_segments
    )
    return finish_stats(sums, resid_sq[0], ts)


def finish_stats(sums: torch.Tensor, resid_sq: torch.Tensor, ts: torch.Tensor) -> WindowStats:
    """WindowStats from the first pass's [5, S] sums, the second pass's [S]
    squared-residual sums and the [S] timestamp maxima: what window_stats
    and the mesh's sharded_window_stats (parallel/mesh.py) both finish with."""
    # sums may be the strided [5, S] view of segment-major storage: every
    # row below is a strided [S] view, which the elementwise ops take as is
    count, e4, e5, lat_sum, lat_sq = sums.unbind(0)
    safe_count = count.clamp(min=1)
    mean = lat_sum / safe_count
    variance = resid_sq / safe_count
    std = torch.sqrt(variance.clamp(min=0.0))
    cv = torch.where(mean != 0, std / mean.clamp(min=1e-300), 0.0)
    return WindowStats(
        count=count,
        error_4xx=e4,
        error_5xx=e5,
        latency_sum=lat_sum,
        latency_sq_sum=lat_sq,
        latency_mean=torch.where(count > 0, mean, 0.0),
        latency_cv=torch.where(count > 0, cv, 0.0),
        latest_timestamp_rel=ts,
    )


def service_stats(
    service_of_segment: torch.Tensor,
    stats_count: torch.Tensor,
    stats_error_5xx: torch.Tensor,
    stats_cv: torch.Tensor,
    num_services: int,
):
    """Roll (endpoint,status) segments up to services: request counts, 5xx
    counts, and combined-weighted latency-CV sums (the risk pipeline's
    GetLatencyCVOfServices shape, RiskAnalyzer.ts:228-248)."""
    seg = torch.where(stats_count > 0, service_of_segment, num_services).long()

    def segment_sum(x):
        out = torch.zeros(num_services + 1, dtype=x.dtype, device=x.device)
        return out.index_add_(0, seg, x)[:-1]

    return (
        segment_sum(stats_count),
        segment_sum(stats_error_5xx),
        segment_sum(stats_cv * stats_count),
    )

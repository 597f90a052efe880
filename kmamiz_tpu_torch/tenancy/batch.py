"""Stacked same-bucket tenant programs: one batched program for T tenants.

Counterpart of kmamiz_tpu/tenancy/batch.py, whose kernels vmap the
single-tenant pipelines over a leading tenant axis. Here the tenant axis
is a batch dimension of the same torch ops, with no Python loop over
lanes:

- `batched_merge_edges` runs the store's window union (concat +
  ops/sortutil.compact_unique) along the last dimension of ``[T, n]``
  stacks, so each lane is its own sort and compaction, bit-equal to the
  tenant's serial union.
- `batched_service_scores` runs ops/scorers' legacy counting pipeline
  (edge_direction_tuples, gateway_mask, score_tuple_rows) once over all
  lanes, with each lane's endpoint and service ids offset by its lane, so
  lanes never share a sort run, a segment or a searchsorted range.

This is XLA work in the JAX package (no Pallas kernel), so it stays
torch ops.
"""
from __future__ import annotations

import torch

from kmamiz_tpu_torch.ops import scorers as scorer_ops
from kmamiz_tpu_torch.ops.sortutil import SENTINEL, compact_unique


def batched_merge_edges(src_a, dst_a, dist_a, mask_a, src_b, dst_b, dist_b, mask_b):
    """Union T tenants' window edges into their T stores in one batched
    program.

    a-side: ``[T, cap]`` stacked store columns (one capacity bucket);
    b-side: ``[T, wcap]`` stacked window columns, SENTINEL-padded to the
    group's widest window (masked out, so padding cannot change a lane's
    valid unique prefix). Returns the merged columns ``[T, cap + wcap]``
    (each lane's distinct rows sorted first, the rest SENTINEL), their
    validity, and the valid counts ``[T]``."""
    src = torch.cat([src_a, src_b], dim=-1)
    dst = torch.cat([dst_a, dst_b], dim=-1)
    dist = torch.cat([dist_a, dist_b], dim=-1)
    mask = torch.cat([mask_a, mask_b], dim=-1)
    (s, d, ds), valid = compact_unique((src, dst, dist), mask)
    # contiguous lanes: each store adopts its row as its own columns
    return s.contiguous(), d.contiguous(), ds.contiguous(), valid, valid.sum(dim=-1)


def sharded_merge_edges(stack, win):
    """batched_merge_edges over a tenant axis sharded into per-device
    groups (tenancy/arena.stacked_edges on a mesh): `stack` and `win` are
    (src, dst, dist, mask) tuples whose columns are sharded values of
    [T/n, ...] lane groups, group g on one device. Each group's lanes
    merge in one batched program on that group's device, bit-equal lane by
    lane to the unsharded program. Returns (src, dst, dist, counts), each a
    sharded value of the groups' results."""
    out = [
        batched_merge_edges(*(c[g] for c in stack), *(c[g] for c in win))
        for g in range(len(stack[0]))
    ]
    return tuple(tuple(o[k] for o in out) for k in (0, 1, 2, 4))


def batched_service_scores(src_ep, dst_ep, dist, mask, ep_service, ep_ml, ep_has_record, num_services: int):
    """scorers.service_scores's legacy pipeline over the tenant axis:
    ``[T, cap]`` edge stacks and ``[T, ep_cap]`` endpoint tables ->
    ServiceScores with ``[T, num_services]`` fields. num_services is the
    batch-wide power-of-two service capacity (each tenant reads its own
    prefix; the surplus lanes score zero)."""
    t, cap = src_ep.shape
    ep_cap = ep_service.shape[1]
    dev = src_ep.device
    lanes = torch.arange(t, device=dev, dtype=torch.int64).unsqueeze(1)
    # endpoint ids index the flattened [T * ep_cap] tables; a parked
    # (SENTINEL) row stays parked
    src_f = torch.where(src_ep == SENTINEL, SENTINEL, (src_ep.to(torch.int64) + lanes * ep_cap).clamp(max=SENTINEL - 1))
    dst_f = torch.where(dst_ep == SENTINEL, SENTINEL, (dst_ep.to(torch.int64) + lanes * ep_cap).clamp(max=SENTINEL - 1))
    # service ids become lane * num_services + id; an id outside a lane's
    # [0, num_services) goes to the dropped segment past every lane, as
    # the serial call drops it
    total_svc = t * num_services
    svc = ep_service.to(torch.int64)
    inside = (svc >= 0) & (svc < num_services)
    svc_f = torch.where(inside, svc + lanes * num_services, total_svc).to(torch.int32)
    src_f, dst_f = src_f.to(torch.int32).reshape(-1), dst_f.to(torch.int32).reshape(-1)
    dist_f, mask_f = dist.reshape(-1), mask.reshape(-1)
    ep_service_f, ep_ml_f, rec_f = svc_f.reshape(-1), ep_ml.reshape(-1), ep_has_record.reshape(-1)
    rows = scorer_ops.edge_direction_tuples(src_f, dst_f, dist_f, mask_f, ep_service_f, ep_ml_f, rec_f)
    gw = scorer_ops.gateway_mask(dst_f, mask_f, ep_service_f, rec_f, total_svc)
    flat = scorer_ops.score_tuple_rows(*rows, gw, num_services=total_svc)
    return scorer_ops.ServiceScores(*(f.reshape(t, num_services) for f in flat))

"""Device graph scorers over flat edge arrays.

Counterpart of kmamiz_tpu/ops/scorers.py (KMamiz
src/classes/EndpointDependencies.ts:369-657 and src/utils/RiskAnalyzer.ts):
the endpoint-dependency edge set lives as capacity-padded int32 columns
(graph/store.py) and every scorer is a pipeline of sort -> boundary mask
-> prefix-sum or segment-sum steps in plain PyTorch ops, on whichever
device holds the inputs. The JAX module holds no TPU kernel (no
`pl.pallas_call`): its jitted XLA programs become these ops, with no
hand-written kernel.

Semantics mirrored from the reference:
- link details count DISTINCT (linked endpoint's service, method+label,
  direction, distance) tuples per owning service;
- instability counts linked services with any by/on detail;
- ACS counts distance-1 linked services, gateway services get AIS+1;
- relying factor sums by_count/distance (+1 gateway);
- usage cohesion averages consumed-endpoint fractions over consumer
  services, at per-endpoint (merged-record) granularity.

Edge convention: (src_ep, dst_ep, dist) means src depends-ON dst (src is
the CLIENT-side ancestor, dst the SERVER-side descendant), i.e. dst is
depended-BY src.

Rules of the translation, so that the same inputs give the same lanes as
the JAX package:
- JAX clamps a gather's index and drops a scatter or segment-sum update
  whose index lies out of range; torch raises. Every gather here clamps
  its index explicitly, and every row outside a reduction's range (parked,
  masked or out-of-range ids) is routed to a dump segment that is cut off
  afterwards.
- Keys stay int32 (prefix sums use `cumsum(..., dtype=torch.int32)`), and
  the packing gates of the sparse pipeline are the JAX module's, so the
  dispatcher takes the same pipeline for the same shapes.
- `jnp.searchsorted`'s default side "left" is `right=False`; values and
  the sorted sequence share the int32 dtype.
- No host sync: no `.item()`, `nonzero`, boolean-mask indexing, dynamic
  `unique` or host-built tensor; capacities are fixed and padding is
  SENTINEL, as in ops/sortutil.py.
- Two sums are float and run through `index_add_`, whose addition order
  varies on CUDA: the legacy pipeline's relying factor and cohesion's
  per-owner fraction sum. They agree with the JAX package within rel 1e-5
  and 1e-6. The sparse pipeline's relying factor is an int32 prefix sum
  of 420/d (or per-distance int32 counts over d), the same bits as the
  JAX package's on any device: a division by a constant multiplies by
  the constant's float32 reciprocal, as XLA compiles it.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from kmamiz_tpu_torch.ops import sparse
from kmamiz_tpu_torch.ops.sortutil import SENTINEL, lex_unique, scatter_compact


class ServiceScores(NamedTuple):
    instability_on: torch.Tensor  # distinct linked services depended on
    instability_by: torch.Tensor  # distinct linked services depending by
    instability: torch.Tensor  # Ce/(Ce+Ca)
    ais: torch.Tensor
    ads: torch.Tensor
    acs: torch.Tensor  # ais * ads
    relying_factor: torch.Tensor
    is_gateway: torch.Tensor  # bool


def _true(device) -> torch.Tensor:
    return torch.ones(1, dtype=torch.bool, device=device)


def _gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] with the index clamped into range, as a JAX gather
    clamps it."""
    return table[idx.clamp(0, table.shape[0] - 1)]


def _segment_sum(values: torch.Tensor, ids: torch.Tensor, valid: torch.Tensor, n: int) -> torch.Tensor:
    """Sum of values per id in [0, n); rows not `valid` or with an id
    outside [0, n) land in a dump segment that is cut off (JAX's
    `segment_sum(..., num_segments=n + 1)[:-1]` with its dropped
    out-of-range updates)."""
    keep = valid & (ids >= 0) & (ids < n)
    seg = torch.where(keep, ids, n).to(torch.int64)
    out = torch.zeros(n + 1, dtype=values.dtype, device=values.device)
    return out.index_add_(0, seg, values)[:-1]


def _div_const(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d for a constant d as XLA computes it: x times the float32
    reciprocal of d. The same bits on every device (PyTorch divides truly
    on the CPU, and by the reciprocal of a Python scalar on CUDA)."""
    return x * torch.full((), 1.0 / d, dtype=x.dtype, device=x.device)


def _left(sorted_keys: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """jnp.searchsorted(sorted_keys, values) (side "left")."""
    return torch.searchsorted(sorted_keys, values.to(sorted_keys.dtype))


def _run_first(keys: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """First row of each run of equal keys, among the `ok` rows."""
    return torch.cat([ok[:1], keys[1:] != keys[:-1]]) & ok


def service_scores(
    src_ep: torch.Tensor,
    dst_ep: torch.Tensor,
    dist: torch.Tensor,
    mask: torch.Tensor,
    ep_service: torch.Tensor,
    ep_ml: torch.Tensor,
    ep_has_record: torch.Tensor,
    num_services: int,
    dist_bits: Optional[int] = None,
) -> ServiceScores:
    """All service-level structure scorers: the dispatcher between the
    legacy lexsort pipeline (service_scores_xla) and the packed-key sparse
    pipeline (service_scores_sparse), taking the JAX package's default
    choice: sparse when `dist_bits` is known and the packing gates hold.

    src_ep/dst_ep/dist/mask: flat edge columns (capacity-padded).
    ep_service: int32[num_endpoints] service of each endpoint.
    ep_ml: int32[num_endpoints] method+label intern id of each endpoint.
    ep_has_record: bool[num_endpoints], endpoints with a dependency record.
    dist_bits: the caller's promise that every valid row has
    0 <= dist < 2**dist_bits; None means unknown and takes the legacy
    pipeline (the sparse relying-factor dedup packs dist into its key).
    """
    if dist_bits is not None and _sparse_scorer_ok(
        num_services, int(ep_service.shape[0]), int(src_ep.shape[0]), dist_bits
    ):
        return service_scores_sparse(
            src_ep, dst_ep, dist, mask, ep_service, ep_ml, ep_has_record,
            num_services=num_services, dist_bits=dist_bits,
        )
    return service_scores_xla(
        src_ep, dst_ep, dist, mask, ep_service, ep_ml, ep_has_record,
        num_services=num_services,
    )


def service_scores_xla(
    src_ep: torch.Tensor,
    dst_ep: torch.Tensor,
    dist: torch.Tensor,
    mask: torch.Tensor,
    ep_service: torch.Tensor,
    ep_ml: torch.Tensor,
    ep_has_record: torch.Tensor,
    num_services: int,
) -> ServiceScores:
    """The legacy full pipeline (5-key lexsort counting core), under the
    JAX package's name: the fallback for unknown distance bounds and the
    parity oracle of the sparse pipeline."""
    rows = edge_direction_tuples(src_ep, dst_ep, dist, mask, ep_service, ep_ml, ep_has_record)
    is_gateway = gateway_mask(dst_ep, mask, ep_service, ep_has_record, num_services)
    return score_tuple_rows(*rows, is_gateway, num_services=num_services)


def _sparse_scorer_ok(num_services: int, num_endpoints: int, capacity: int, dist_bits: int) -> bool:
    """Static packing gates for the sparse counting core: every packed
    sort key must stay strictly below SENTINEL in int32."""
    if not (0 < dist_bits <= 6):
        return False
    gid_bits = max(1, (max(num_endpoints, 2) - 1).bit_length())
    return (
        2 * num_services * num_services < SENTINEL
        and num_services * (1 << gid_bits) < SENTINEL
        and capacity * (1 << dist_bits) < SENTINEL
    )


def service_scores_sparse(
    src_ep: torch.Tensor,
    dst_ep: torch.Tensor,
    dist: torch.Tensor,
    mask: torch.Tensor,
    ep_service: torch.Tensor,
    ep_ml: torch.Tensor,
    ep_has_record: torch.Tensor,
    num_services: int,
    dist_bits: int = 3,
) -> ServiceScores:
    """Sparse counting core: packed-int32 single-key sorts per direction
    table instead of the 5-key lexsort. Lane for lane the same as
    score_tuple_rows:

    - "on" side: per (owner, linked) pair only existence and "contains a
      distance-1 row" matter, so the key is (owner*S + linked)*2 +
      (d != 1) and counts are prefix-sum differences over searchsorted
      owner ranges.
    - "by" side pair lanes (instability_by, ais): the same with owner and
      linked swapped.
    - relying factor: dedup of (owner, gid, dist), gid the dense rank of
      the endpoint's (service, ml). Where the exact key fits, one sort per
      distance pair {2p, 2p+1} keyed (owner*n_ep + gid)*2 + (d & 1) with
      off-partition rows parked at SENTINEL, weights 420/d summed in
      int32; otherwise a sort of key (owner, gid) with dist as payload and
      a second sort of run_id*DCAP + dist. The payload's order among equal
      keys is unspecified and the result does not depend on it.

    Integer-derived lanes equal the legacy pipeline's; relying_factor sums
    the same distinct contributions in another order (fp32 tolerance).
    """
    dev = src_ep.device
    is_gateway = gateway_mask(dst_ep, mask, ep_service, ep_has_record, num_services)

    S = num_services
    n_ep = int(ep_service.shape[0])
    gid_bits = max(1, (max(n_ep, 2) - 1).bit_length())
    gid_cap = 1 << gid_bits
    dcap = 1 << dist_bits

    src_svc = _gather(ep_service, src_ep)
    dst_svc = _gather(ep_service, dst_ep)
    src_rec = _gather(ep_has_record, src_ep)
    dst_rec = _gather(ep_has_record, dst_ep)
    d32 = dist.to(torch.int32)
    not_d1 = (d32 != 1).to(torch.int32)

    def _ranged_count(flags, lo, hi):
        c = sparse.exclusive_cumsum(flags)
        return (c[hi] - c[lo]).to(torch.float32)

    def _pair_lanes(valid, owner, linked):
        # (owner, linked) pair distincts and "pair has a distance-1 row":
        # the d1 bit rides in the key's LSB (d1 rows sort first), so a
        # pair's first row has LSB 0 iff any of its rows is distance 1
        key = torch.where(valid, (owner * S + linked) * 2 + not_d1, SENTINEL)
        k = torch.sort(key).values
        first = _run_first(k >> 1, k != SENTINEL)
        # adjacent owner blocks share their boundary: one S+1-point search
        b = _left(k, torch.arange(S + 1, dtype=torch.int32, device=dev) * (S * 2))
        count = _ranged_count(first, b[:-1], b[1:])
        d1 = _ranged_count(first & ((k & 1) == 0), b[:-1], b[1:])
        return count, d1

    valid_on = mask & src_rec
    inst_on, ads = _pair_lanes(valid_on, src_svc, dst_svc)
    valid_by = mask & dst_rec
    inst_by, ais_links = _pair_lanes(valid_by, dst_svc, src_svc)

    total = inst_on + inst_by
    instability = torch.where(total > 0, inst_on / total.clamp(min=1), 0.0)
    ais = ais_links + is_gateway.to(torch.float32)
    acs = ais * ads

    # -- relying factor: distinct (owner, gid, dist), weight 1/max(d, 1) ----
    gid, _svc_of_gid = sparse.dense_rank_pairs(ep_service, ep_ml)
    src_gid = _gather(gid, src_ep)
    cap_rows = int(src_ep.shape[0])
    # 420 = lcm 1..7: every 1/max(d, 1) weight for d < 8 is an integral
    # multiple of 1/420, so int32 prefix sums of 420/d stay exact
    w420 = (420, 420, 210, 140, 105, 84, 70, 60)
    if dist_bits <= 3 and 2 * S * n_ep < SENTINEL and cap_rows * 420 < SENTINEL:
        # partition path: one payload-free sort per distance pair
        base = dst_svc * n_ep + src_gid
        bq = torch.arange(S + 1, dtype=torch.int32, device=dev) * (n_ep * 2)
        rfw = torch.zeros(S, dtype=torch.int32, device=dev)
        for p in range(dcap // 2):
            in_p = valid_by & ((d32 >> 1) == p)
            kp = torch.sort(torch.where(in_p, base * 2 + (d32 & 1), SENTINEL)).values
            firstp = _run_first(kp, kp != SENTINEL)
            w_even, w_odd = w420[2 * p], w420[2 * p + 1]
            if w_even == w_odd:
                wrow = torch.where(firstp, w_even, 0)
            else:
                wrow = torch.where(firstp, torch.where((kp & 1) == 0, w_even, w_odd), 0)
            ws = sparse.exclusive_cumsum(wrow)
            bp = _left(kp, bq)
            rfw = rfw + (ws[bp[1:]] - ws[bp[:-1]])
        rf = _div_const(rfw.to(torch.float32), 420.0)
    else:
        # payload fallback: the triple key cannot ride one int32, so dist
        # travels as the payload of the first sort
        key_by = torch.where(valid_by, dst_svc * gid_cap + src_gid, SENTINEL)
        k_by, order = torch.sort(key_by)
        d_by = d32[order]
        ok_by = k_by != SENTINEL
        run_first = _run_first(k_by, ok_by)
        b_by = _left(k_by, torch.arange(S + 1, dtype=torch.int32, device=dev) * gid_cap)
        # run ids are exclusive-prefix counts of run starts, so owner run
        # ranges come from the same searchsorted positions as the counts
        c_run = sparse.exclusive_cumsum(run_first)
        run_id = c_run[1:] - 1
        dq = d_by.clamp(0, dcap - 1)
        ks2 = torch.sort(torch.where(ok_by, run_id * dcap + dq, SENTINEL)).values
        first2 = _run_first(ks2, ks2 != SENTINEL)
        p2 = _left(ks2, c_run[b_by] * dcap)
        dval = ks2 & (dcap - 1)
        if dist_bits == 3 and cap_rows * 420 < SENTINEL:
            # 420 // max(d, 1) is w420[d] for d < 8, built on the device
            wsum = sparse.exclusive_cumsum(torch.where(first2, 420 // dval.clamp(min=1), 0))
            rf = _div_const((wsum[p2[1:]] - wsum[p2[:-1]]).to(torch.float32), 420.0)
        else:
            rf = torch.zeros(S, dtype=torch.float32, device=dev)
            for dv in range(dcap):
                cd = sparse.exclusive_cumsum(first2 & (dval == dv))
                rf = rf + _div_const((cd[p2[1:]] - cd[p2[:-1]]).to(torch.float32), float(max(dv, 1)))
    rf = rf + is_gateway.to(torch.float32)

    return ServiceScores(
        instability_on=inst_on,
        instability_by=inst_by,
        instability=instability,
        ais=ais,
        ads=ads,
        acs=acs,
        relying_factor=rf,
        is_gateway=is_gateway,
    )


def edge_direction_tuples(src_ep, dst_ep, dist, mask, ep_service, ep_ml, ep_has_record):
    """Expand flat edges into both direction-tuple rows: "on" = owner src
    sees linked dst; "by" = owner dst sees linked src. Returns (owner,
    linked, ddir, ddist, linked_ml, both_mask) for score_tuple_rows.

    Each direction exists only where its OWNER endpoint holds a dependency
    record (the reference derives details by iterating records, which only
    SERVER-seen endpoints own); the linked side stays ungated."""
    src_svc = _gather(ep_service, src_ep)
    dst_svc = _gather(ep_service, dst_ep)
    src_ml = _gather(ep_ml, src_ep)
    dst_ml = _gather(ep_ml, dst_ep)
    src_rec = _gather(ep_has_record, src_ep)
    dst_rec = _gather(ep_has_record, dst_ep)
    dist32 = dist.to(torch.int32)
    owner = torch.cat([src_svc, dst_svc])
    linked = torch.cat([dst_svc, src_svc])
    linked_ml = torch.cat([dst_ml, src_ml])
    ddist = torch.cat([dist32, dist32])
    # 0 = on/SERVER, 1 = by/CLIENT
    ddir = torch.cat([torch.zeros_like(dist32), torch.ones_like(dist32)])
    both_mask = torch.cat([mask & src_rec, mask & dst_rec])
    return owner, linked, ddir, ddist, linked_ml, both_mask


def depended_by_degrees(dst_ep, mask, num_endpoints: int) -> torch.Tensor:
    """float32[num_endpoints]: the live edges depending on each endpoint."""
    return _segment_sum(mask.to(torch.float32), dst_ep, mask, num_endpoints)


def gateway_mask(dst_ep, mask, ep_service, ep_has_record, num_services, by_deg=None):
    """bool[num_services]: a service owning an endpoint record with zero
    depended-by edges (reference: dependency.find(d =>
    d.dependingBy.length === 0)). The mesh's sharded scorer
    (parallel/mesh.py) passes its merged partial degrees as `by_deg`; a
    single device computes them here."""
    if by_deg is None:
        by_deg = depended_by_degrees(dst_ep, mask, ep_service.shape[0])
    gateway_ep = ep_has_record & (by_deg == 0)
    svc = ep_service.to(torch.int64)
    seg = torch.where((svc >= 0) & (svc < num_services), svc, num_services)
    flags = torch.zeros(num_services + 1, dtype=torch.int32, device=ep_service.device)
    flags.scatter_reduce_(0, seg, gateway_ep.to(torch.int32), "amax")
    return flags[:-1] > 0


def score_tuple_rows(
    owner: torch.Tensor,
    linked: torch.Tensor,
    ddir: torch.Tensor,
    ddist: torch.Tensor,
    linked_ml: torch.Tensor,
    both_mask: torch.Tensor,
    is_gateway: torch.Tensor,
    num_services: int,
) -> ServiceScores:
    """The counting core of the legacy pipeline over flat direction-tuple
    rows (owner, linked, dir, dist, ml): global dedup, prefix-boundary
    distincts, searchsorted per-owner reductions.

    (owner, linked, dir) first makes every per-owner reduction a
    contiguous run of the sorted order; dist before ml makes the rows of
    each (owner, linked, dir) triple min-dist-first."""
    (s_owner, s_linked, s_dir, s_dist, _s_ml), uniq = lex_unique(
        (owner, linked, ddir, ddist, linked_ml), both_mask
    )
    dev = s_owner.device
    park = num_services
    row_valid = s_owner != SENTINEL

    # rows of service k occupy [lo[k], hi[k]); parked rows (SENTINEL owner)
    # sort past every id. int32 prefix counts are exact.
    svc_ids = torch.arange(num_services, dtype=torch.int32, device=dev)
    lo = torch.searchsorted(s_owner, svc_ids)
    hi = torch.searchsorted(s_owner, svc_ids, right=True)

    def owner_count(flags) -> torch.Tensor:
        c = sparse.exclusive_cumsum(flags)
        return (c[hi] - c[lo]).to(torch.float32)

    # -- distinct (owner, linked, direction): prefix boundaries --------------
    prefix_neq = (
        (s_owner[1:] != s_owner[:-1])
        | (s_linked[1:] != s_linked[:-1])
        | (s_dir[1:] != s_dir[:-1])
    )
    triple_first = torch.cat([_true(dev), prefix_neq]) & row_valid
    fdir = s_dir == 0
    inst_on = owner_count(triple_first & fdir)
    inst_by = owner_count(triple_first & ~fdir)
    total = inst_on + inst_by
    instability = torch.where(total > 0, inst_on / total.clamp(min=1), 0.0)

    # -- ACS at distance 1: triples containing any distance-1 row ------------
    # read the triple's first row with dist >= 1 (warm-start rows of
    # distance 0 or below sort first and must not hide a distance-1 link)
    prev_dist = torch.cat([s_dist[:1], s_dist[:-1]])
    same_triple_as_prev = torch.cat([~_true(dev), ~prefix_neq])
    first_ge1 = (s_dist >= 1) & (~same_triple_as_prev | (prev_dist < 1)) & row_valid
    d1_row = first_ge1 & (s_dist == 1)
    ads = owner_count(d1_row & fdir)
    ais_links = owner_count(d1_row & ~fdir)

    ais = ais_links + is_gateway.to(torch.float32)
    acs = ais * ads

    # -- relying factor: sum by_count/distance over details ------------------
    rf_contrib = (
        uniq.to(torch.float32)
        * (s_dir == 1).to(torch.float32)
        / s_dist.clamp(min=1).to(torch.float32)
    )
    rf = _segment_sum(rf_contrib, s_owner, uniq, park)
    rf = rf + is_gateway.to(torch.float32)

    return ServiceScores(
        instability_on=inst_on,
        instability_by=inst_by,
        instability=instability,
        ais=ais,
        ads=ads,
        acs=acs,
        relying_factor=rf,
        is_gateway=is_gateway,
    )


class CohesionScores(NamedTuple):
    total_endpoints: torch.Tensor  # endpoint records per service
    consumer_count: torch.Tensor  # distinct consumer services
    usage_cohesion: torch.Tensor  # SIUC
    # (owner, consumer, consumes) pair table for the HTTP payload's
    # `consumers` list; rows where pair_valid, order sorted by
    # (owner, consumer)
    pair_owner: torch.Tensor
    pair_consumer: torch.Tensor
    pair_consumes: torch.Tensor
    pair_valid: torch.Tensor


def usage_cohesion(
    src_ep: torch.Tensor,
    dst_ep: torch.Tensor,
    dist: torch.Tensor,
    mask: torch.Tensor,
    ep_service: torch.Tensor,
    ep_has_record: torch.Tensor,
    num_services: int,
) -> CohesionScores:
    """SIUC: for each service, average over consumer services of
    (distinct endpoints consumed / total endpoint records). Distinctness
    is by raw endpoint id: label collapsing does not apply here."""
    park = num_services
    total_endpoints = _segment_sum(
        ep_has_record.to(torch.float32), ep_service, ep_has_record, park
    )

    # distance-1 by-edges: consumer = svc[src], consumed endpoint = dst.
    # One sort keyed (owner, consumer, consumed_ep): pair distincts are
    # full-row boundaries and (owner, consumer) groups prefix boundaries.
    d1 = mask & (dist == 1)
    consumer = _gather(ep_service, src_ep)
    owner = _gather(ep_service, dst_ep)
    (g_owner, g_consumer, _g_ep), pair_first = lex_unique((owner, consumer, dst_ep), d1)
    dev = g_owner.device
    row_valid = g_owner != SENTINEL
    group_first = (
        torch.cat(
            [
                _true(dev),
                (g_owner[1:] != g_owner[:-1]) | (g_consumer[1:] != g_consumer[:-1]),
            ]
        )
        & row_valid
    )
    cap = int(g_owner.shape[0])
    group_gid = (
        torch.cumsum(group_first.to(torch.int32), 0, dtype=torch.int32) - 1
    ).clamp(min=0)
    # consumed endpoints per (owner, consumer) group (exact small integers)
    pair_counts = torch.zeros(cap, dtype=torch.float32, device=dev).index_add_(
        0, group_gid.to(torch.int64), pair_first.to(torch.float32)
    )
    owner_total = _gather(total_endpoints, g_owner.clamp(max=park - 1))
    consumes_at_first = pair_counts[group_gid.to(torch.int64)]
    # a service owning zero endpoint records must not appear at all
    group_emit = group_first & (owner_total > 0)
    frac = torch.where(group_emit, consumes_at_first / owner_total.clamp(min=1), 0.0)
    frac_sum = _segment_sum(frac, g_owner, group_emit, park)
    consumer_count = _segment_sum(group_emit.to(torch.float32), g_owner, group_emit, park)
    cohesion = torch.where(
        consumer_count > 0, frac_sum / consumer_count.clamp(min=1), 0.0
    )
    return CohesionScores(
        total_endpoints=total_endpoints,
        consumer_count=consumer_count,
        usage_cohesion=cohesion,
        pair_owner=torch.where(group_emit, g_owner, SENTINEL),
        pair_consumer=torch.where(group_emit, g_consumer, SENTINEL),
        pair_consumes=consumes_at_first,
        pair_valid=group_emit,
    )


# ---------------------------------------------------------------------------
# risk pipeline (RiskAnalyzer.ts) as dense vector math
# ---------------------------------------------------------------------------


def _fixed_ratio(v: torch.Tensor) -> torch.Tensor:
    mx = torch.max(v)
    return torch.where(mx == 0, v, v / mx.clamp(min=1e-30))


def _linear(v: torch.Tensor, minimum: float = 0.1) -> torch.Tensor:
    return _fixed_ratio(v) * (1 - minimum) + minimum


def _sigmoid_adj(v: torch.Tensor) -> torch.Tensor:
    z = 2 * math.log(3.0)
    return 1 / (1 + torch.exp(-z * (v - 1.5)))


class RiskScores(NamedTuple):
    impact: torch.Tensor
    probability: torch.Tensor
    risk: torch.Tensor
    norm_risk: torch.Tensor


def risk_scores(
    relying_factor: torch.Tensor,
    acs: torch.Tensor,
    replicas: torch.Tensor,
    request_count: torch.Tensor,
    error_count: torch.Tensor,
    cv_weighted_sum: torch.Tensor,
    active: torch.Tensor,
) -> RiskScores:
    """risk = impact x probability per service (RiskAnalyzer.ts:10-122).

    active: bool[num_services], services present in this window (inactive
    lanes produce 0)."""
    minimum = 0.01
    norm_rf = _fixed_ratio(relying_factor)
    norm_acs = _fixed_ratio(acs)
    raw_impact = (norm_rf + norm_acs) / replicas.clamp(min=1)
    impact = _linear(raw_impact)

    total = torch.sum(torch.where(active, request_count, 0.0)).clamp(min=1.0)
    invoke_p = torch.where(active, request_count / total, 0.0)
    error_rate = torch.where(active, error_count / request_count.clamp(min=1.0), 0.0)
    norm_pro = invoke_p * (1 - minimum) + minimum
    norm_err = error_rate * (1 - minimum) + minimum
    base_prob = _linear(norm_pro * norm_err, minimum)

    latency_cv = torch.where(active, cv_weighted_sum / request_count.clamp(min=1.0), 0.0)
    reliability = _sigmoid_adj(latency_cv)
    raw_prob = reliability * base_prob.clamp(min=minimum)
    prob = raw_prob * (1 - minimum) + minimum

    risk = torch.where(active, impact * prob, 0.0)
    mn = torch.min(torch.where(active, risk, math.inf))
    mx = torch.max(torch.where(active, risk, -math.inf))
    rng = mx - mn
    # degenerate windows normalize every service to 0.1
    norm = torch.where(
        active,
        torch.where(rng == 0, 0.1, (risk - mn) / rng.clamp(min=1e-30) * 0.9 + 0.1),
        0.0,
    )
    return RiskScores(impact=impact, probability=prob, risk=risk, norm_risk=norm)


# -- incremental (dirty-service) recompute support ---------------------------
#
# Every ServiceScores lane for service s is a function of ONLY the edges
# incident to s's endpoints, so the edge subset { e : src_svc(e) in D or
# dst_svc(e) in D } reproduces every dirty service's lanes: the sorts give
# identical tuple values identical order regardless of input order and
# the int32 prefix counts are order-free. Lanes of non-dirty services
# computed from the subset are garbage and merge_service_lanes discards
# them. On the sparse pipeline every lane is bit-exact; the legacy
# pipeline's float relying-factor sum is bit-exact where index_add_ adds
# in row order (the CPU).


def dirty_edge_subset(src_ep, dst_ep, dist, mask, ep_service, dirty_svc):
    """Order-preserving compaction of the edges incident to any dirty
    service. Returns (src, dst, dist, kept_count) at the input capacity,
    kept_count a device scalar: the caller reads it once and slices to a
    pow2 sub-capacity before scoring the subset."""
    src_dirty = _gather(dirty_svc, _gather(ep_service, src_ep))
    dst_dirty = _gather(dirty_svc, _gather(ep_service, dst_ep))
    keep = mask & (src_dirty | dst_dirty)
    (s, d, ds), kept = scatter_compact((src_ep, dst_ep, dist), keep)
    return s, d, ds, kept.sum()


def merge_service_lanes(dirty_svc: torch.Tensor, inc: ServiceScores, base: ServiceScores) -> ServiceScores:
    """Lane-wise splice of an incremental recompute into cached scores:
    dirty services take the subset-recomputed value, every other service
    keeps its cached lane."""
    return ServiceScores(*[torch.where(dirty_svc, a, b) for a, b in zip(inc, base)])

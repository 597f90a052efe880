// Fused SDDMM/SpMM over an edge list: the neighbor aggregation of the
// model plane (GraphSAGE neighbor sums, ungated; STLGT neighbor bias,
// gated), behind kmamiz_tpu_torch.ops.sparse.
//
//   gate[e]  = sigmoid(q[src]·k[dst] / sqrt(H) + b) * mask[e]   (gated)
//            = mask[e]                                          (ungated)
//   bias[n]  = sum over edges with dst == n of gate * v[src]
//            + sum over edges with src == n of gate * v[dst]
//   deg[n]   = the same two sums of gate
//
// Id rule (the JAX package's XLA formulation, graphsage.neighbor_mean and
// stlgt/model.encode): a gather clamps its id into [0, n); a scatter to an
// id outside [0, n) is dropped. Masked-off edges write gate 0 and scatter
// nothing, whatever their ids (padded edges carry a sentinel).
//
// Replaces the TPU kernel kmamiz_tpu/ops/sparse.py (_fused_kernel behind
// _fused_call), which gathers and scatters through one-hot [edge tile, N]
// matmuls on the MXU with the whole node table resident in VMEM, and so
// caps N at 2,048 rows. The one-hot products were the TPU's fast path to a
// gather; they are not a product worth a tensor core here: each gathered
// row is used once per entry, so there is no dense operand to reuse and
// wgmma/mma have nothing to do. The work is gathers and fp32 FMAs.
//
// Design: a CSR-by-node reduction without atomics and without zero-fill,
// over the index that ops/sparse.py:edge_index builds (its sort keys come
// from fused_sddmm_spmm_kernel_keys below, int16 when N < 2^15, then one
// stable sort and one searchsorted in PyTorch: row_ptr[N+1]; per
// entry the neighbour id, which the gather clamps, and the edge id with its
// direction, j < E for the dst side of edge j and j - E for the src side;
// the entries of a row in edge-id order). Two kernels, one call:
//
// 1. fused_sddmm_spmm_kernel_gate (the SDDMM), run when the gate is wanted
//    and always in the gated mode: a power-of-two group of lanes per edge
//    slot reads q[src] and k[dst] with vector loads, reduces the dot with
//    xor shuffles in a fixed order, and writes gate[e] = sigmoid(...) *
//    mask once per edge (ungated: gate[e] = mask). Every slot gets its
//    gate, a live edge whose two ends are out of range included.
// 2. fused_sddmm_spmm_kernel (the SpMM): one warp per node row, grid-
//    stride over rows. The lanes split into groups of lpe = ceil(H / VW)
//    lanes, VW = 4 (float4) or 2 (float2) floats per lane when H allows,
//    so a step loads whole rows: 2 entries per step at H = 64, 4 at
//    H = 32, 3 at H = 18 (72 B rows, float2). The warp loads 32 entries'
//    ids and gates at once (one per lane) and hands them to the groups by
//    shuffle, so the row loads of a batch go out back to back. Each group
//    accumulates g·v[nbr] and g in registers in entry order; the groups'
//    partials are combined by shuffles in group order, and bias[n, :] and
//    deg[n] are written once, zeros for rows without entries. Ungated,
//    deg is the row length, exact.
//
// Every sum runs in an order fixed by the index, so two launches on the
// same inputs give the same bits. FMA in fp32 only (no TF32), as the Pallas
// kernel runs at Precision.HIGHEST.
//
// Bound: memory traffic. Edge ids and mask (9 B per edge), the node tables
// (N*H*4 B each: v, plus q and k when gated) read once, bias and deg (and
// the gate) written once. Ungated at N = 16,384, E = 262,144, H = 64 that
// is ~10.8 MB, ~3.2 us at 3.35 TB/s. The table at H = 64 is 4 MB and stays
// in the 50 MB L2, so the repeated row gathers are L2 reads, not HBM reads.
//
// Known weakness: one warp walks a whole row, so a hub endpoint's row sets
// the time of its warp (splitting long rows with a fixed-order combine is
// later work; the BASELINE graph's longest row is 1.4x its mean). Lanes
// past lpe * (32 / lpe) idle (5 of 32 at H = 18).
//
// The backward (training; the JAX package has no backward kernel: it
// differentiates its XLA gather/segment-sum formulation). For edge
// e = (s, d) with gather rows sc = clamp(s), dc = clamp(d), gate g_e and
// upstream grads d_bias[N, H], d_deg[N], d_gate[E]:
//
//   dv[m]  = sum over live edges with sc == m and d in [0, N) of g_e d_bias[d]
//          + sum over live edges with dc == m and s in [0, N) of g_e d_bias[s]
//   dg_e   = d_gate[e] + [d in range] (d_bias[d]·v[sc] + d_deg[d])
//                      + [s in range] (d_bias[s]·v[dc] + d_deg[s])
//   da_e   = dg_e g_e (1 - g_e)        (0 on masked edges: g_e = 0)
//   dq[m]  = sum over live edges with sc == m of da_e k[dc] / sqrt(H)
//   dk[m]  = sum over live edges with dc == m of da_e q[sc] / sqrt(H)
//   db     = sum of da_e
//
// The rows of dv, dq and dk are gather rows, so the backward reads the
// GATHER index of the same edge list (edge_index(..., for_backward=True):
// keys from fused_sddmm_spmm_kernel_keys with gather = 1, key = clamp(row)
// for every live side). It equals the forward index when every live id
// lies in [0, N); where one does not, the entry whose other end is out of
// range still carries da into dq/dk, and adds nothing to dv (that end's
// scatter was dropped in the forward). Built once with it, the gather
// index also holds pos[2E], the entry that holds slot j (-1 where the
// slot is parked past row_ptr[N]: the inverse of its sort), and split[N],
// the first src-side entry of each row (a row's dst-side entries, j < E,
// come first: the sort is stable in j). One C call,
// kmamiz_fused_sddmm_spmm_backward, launches the two kernels:
//
// 3. fused_sddmm_spmm_kernel_grad_edges (the SDDMM of da, gated only): per
//    warp, batches of 32 edge slots. The lanes load the batch's mask and
//    ids, one slot each (coalesced), and the next batch's before this
//    batch's rows are reduced; a ballot over the mask ranks the live
//    edges, whose ids go through shared memory to lane groups of lpe (a
//    power of two) lanes, so a masked slot costs no group step. A group
//    reduces one edge at a time (its d_bias and v rows at both ends: 4
//    vector loads in flight per lane), with xor shuffles in a fixed
//    order. The lane that loaded an edge (and, while
//    the rows were in flight, its gate, d_gate, d_deg at both ends and its
//    two entries pos[e], pos[E + e]) finishes da_e and writes (g_e, da_e)
//    into both of its entries of the gather index (gda[2E], float2), and
//    da[e] when asked. Each block writes the sum of its da in a fixed order
//    (lanes by xor shuffles, warps in order) as one partial of db.
// 4. fused_sddmm_spmm_kernel_grad_rows: one warp per gather row, lane
//    groups of lpe = ceil(H / VW) lanes as in (2). The warp loads 32
//    entries' neighbour ids and, gated, their (g, da) (two coalesced
//    streams, no per-entry edge-id lookup) and hands them to the groups by
//    shuffle; an entry's side is whether it lies at or past its row's
//    split. Gated, each group holds 2 entries' row loads in flight (two
//    tables an entry: d_bias, and k on the src side or q on the dst side),
//    then accumulates g·d_bias[nbr] (dv), da·k[nbr] (dq) and da·q[nbr]
//    (dk) in entry order; the groups combine in order, and each output
//    row is written once. The next row's bounds load while the current
//    row runs. Its first warp first sums the SDDMM's block partials in a
//    fixed order into db (the SDDMM ran before it on the stream), so no
//    reduction launch follows. Ungated (dv = the sum of d_bias[nbr] over
//    the row's entries whose other end is in range) the same loop holds
//    4 entries' row loads in flight per group, one table an entry.
//
// No atomics and no zero-fill: two launches give the same bits, db
// included (its partials follow the grid, which follows the card's SM
// count). Ungated, the whole backward is one launch of (4) for dv, none
// when v needs no grad.
//
// What bounds them on this card. The bytes their functions must move
// once (ids, the table rows the live edges touch, the outputs; ~6.6 MB for
// (3) and ~13 MB for (4) gated at N = 16,384, E = 262,144, H = 32, and
// ~4 MB more that (3) hands (4) through pos and gda) would take 2-5 us at
// 3.35 TB/s. The time goes to the row gathers, which hit the 50 MB L2:
// (3) gathers 4 rows an edge and (4) 2 an entry gated, each ~85 MB of L2
// reads at H = 32 (the ungated pass at H = 64 as much). Beside the
// gathers, time went to chains of dependent loads in front of them (an
// edge id per entry, then gate[edge] and da[edge] on separate sectors;
// mask, ids, rows and scalars per few edges) and to group steps spent on
// masked slots. The design above cuts the chain to ids, then rows, per
// batch of 32, reads (4)'s per-entry data as coalesced streams, and sends
// no masked slot to a group. Timed on an H100 (PERF.md §6), that made (3)
// faster and (4) gated a little; more entries in flight made the ungated
// pass faster (4 in its loop) but not the gated one, whose registers then
// spill or cost resident warps, and more resident warps made none faster.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

template <int VW>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ void fma(T& acc, float g, T x) { acc = fmaf(g, x, acc); }
  static __device__ __forceinline__ void add(T& acc, T x) { acc += x; }
  static __device__ __forceinline__ void scale(T& acc, float s) { acc *= s; }
  static __device__ __forceinline__ float dot(T a, T b) { return a * b; }
  static __device__ __forceinline__ T shfl(T x, int src) { return __shfl_sync(kFull, x, src); }
};
template <>
struct Vec<2> {
  using T = float2;
  static __device__ __forceinline__ T zero() { return make_float2(0.f, 0.f); }
  static __device__ __forceinline__ void fma(T& acc, float g, T x) {
    acc.x = fmaf(g, x.x, acc.x);
    acc.y = fmaf(g, x.y, acc.y);
  }
  static __device__ __forceinline__ void add(T& acc, T x) {
    acc.x += x.x;
    acc.y += x.y;
  }
  static __device__ __forceinline__ void scale(T& acc, float s) {
    acc.x *= s;
    acc.y *= s;
  }
  static __device__ __forceinline__ float dot(T a, T b) { return fmaf(a.y, b.y, a.x * b.x); }
  static __device__ __forceinline__ T shfl(T x, int src) {
    return make_float2(__shfl_sync(kFull, x.x, src), __shfl_sync(kFull, x.y, src));
  }
};
template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ void fma(T& acc, float g, T x) {
    acc.x = fmaf(g, x.x, acc.x);
    acc.y = fmaf(g, x.y, acc.y);
    acc.z = fmaf(g, x.z, acc.z);
    acc.w = fmaf(g, x.w, acc.w);
  }
  static __device__ __forceinline__ void add(T& acc, T x) {
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  static __device__ __forceinline__ void scale(T& acc, float s) {
    acc.x *= s;
    acc.y *= s;
    acc.z *= s;
    acc.w *= s;
  }
  static __device__ __forceinline__ float dot(T a, T b) {
    return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, a.x * b.x)));
  }
  static __device__ __forceinline__ T shfl(T x, int src) {
    return make_float4(__shfl_sync(kFull, x.x, src), __shfl_sync(kFull, x.y, src),
                       __shfl_sync(kFull, x.z, src), __shfl_sync(kFull, x.w, src));
  }
};

__device__ __forceinline__ int32_t gather_row(int32_t id, int32_t n) {
  return id < 0 ? 0 : (id >= n ? n - 1 : id);
}

// The SDDMM: gate[e] for every edge slot. lpe lanes (a power of two) per
// edge, 32 / lpe edges per warp step.
template <int VW, bool kGated>
__global__ void __launch_bounds__(kThreads)
    fused_sddmm_spmm_kernel_gate(const int32_t* __restrict__ src,
                                 const int32_t* __restrict__ dst,
                                 const uint8_t* __restrict__ mask,
                                 const float* __restrict__ q,
                                 const float* __restrict__ k,
                                 const float* __restrict__ b, int64_t e,
                                 int32_t n, int32_t h, int lpe, float sqrt_h,
                                 float* __restrict__ gate) {
  using V = Vec<VW>;
  const int lane = threadIdx.x & 31;
  const int per_warp = 32 / lpe;
  const int sl = lane & (lpe - 1);
  const int nvec = h / VW;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  const float b_edge = kGated ? *b : 0.f;
  for (int64_t w = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
       w * per_warp < e; w += warps) {
    const int64_t i = w * per_warp + lane / lpe;
    const bool live = i < e && mask[i];
    if (!kGated) {
      if (i < e && sl == 0) gate[i] = live ? 1.f : 0.f;
      continue;
    }
    float dot = 0.f;
    if (live) {
      const auto* qs = reinterpret_cast<const typename V::T*>(
          q + static_cast<int64_t>(gather_row(src[i], n)) * h);
      const auto* kd = reinterpret_cast<const typename V::T*>(
          k + static_cast<int64_t>(gather_row(dst[i], n)) * h);
      for (int c = sl; c < nvec; c += lpe) dot += V::dot(qs[c], kd[c]);
    }
    for (int off = lpe >> 1; off > 0; off >>= 1) dot += __shfl_xor_sync(kFull, dot, off);
    if (i < e && sl == 0) {
      gate[i] = live ? 1.f / (1.f + expf(-(dot / sqrt_h + b_edge))) : 0.f;
    }
  }
}

// The SpMM: one warp per node row over the CSR index. lpe lanes per entry
// (one vector of VW floats each, column chunks of lpe vectors when H needs
// more than 32 lanes), groups = 32 / lpe entries per step.
template <int VW, bool kGated>
__global__ void __launch_bounds__(kThreads)
    fused_sddmm_spmm_kernel(const int32_t* __restrict__ row_ptr,
                            const int32_t* __restrict__ nbr,
                            const int64_t* __restrict__ eid,
                            const float* __restrict__ v,
                            const float* __restrict__ gate, int64_t e,
                            int32_t n, int32_t h, int lpe,
                            float* __restrict__ bias, float* __restrict__ deg) {
  using V = Vec<VW>;
  const int lane = threadIdx.x & 31;
  const int groups = 32 / lpe;
  const int g = lane / lpe;
  const int sl = lane - g * lpe;
  const int nvec = h / VW;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
       row < n; row += warps) {
    const int32_t start = row_ptr[row];
    const int32_t end = row_ptr[row + 1];
    float d = 0.f;
    for (int c0 = 0; c0 < nvec; c0 += lpe) {
      const int c = c0 + sl;
      const bool active = g < groups && c < nvec;
      typename V::T acc = V::zero();
      for (int32_t base = start; base < end; base += 32) {
        const int cnt = min(32, end - base);
        int32_t my_id = 0;
        float my_g = 1.f;
        if (lane < cnt) {
          my_id = nbr[base + lane];
          if (kGated) {
            const int64_t j = eid[base + lane];
            my_g = gate[j >= e ? j - e : j];
          }
        }
#pragma unroll 4
        for (int t = 0; t < cnt; t += groups) {
          const int p = t + g;  // this group's entry in the batch
          const int from = p < 32 ? p : 31;
          const int32_t id = __shfl_sync(kFull, my_id, from);
          const float gg = kGated ? __shfl_sync(kFull, my_g, from) : 1.f;
          if (active && p < cnt) {
            const auto* row_v = reinterpret_cast<const typename V::T*>(
                v + static_cast<int64_t>(gather_row(id, n)) * h);
            V::fma(acc, gg, row_v[c]);
            if (kGated && c0 == 0) d += gg;
          }
        }
      }
      // groups' partials in group order, into the lanes of group 0
      typename V::T total = acc;
      for (int k = 1; k < groups; ++k) V::add(total, V::shfl(acc, sl + k * lpe));
      if (g == 0 && c < nvec) {
        reinterpret_cast<typename V::T*>(bias + row * h)[c] = total;
      }
    }
    if (kGated) {
      float d_total = d;
      for (int k = 1; k < groups; ++k) d_total += __shfl_sync(kFull, d, k * lpe);
      d = d_total;
    } else {
      d = static_cast<float>(end - start);
    }
    if (lane == 0) deg[row] = d;
  }
}

// edge_index's sort keys: for j < E the dst side of edge j, for j >= E the
// src side of edge j - E. key = that end's row, or n when the edge is
// masked off or the row lies outside [0, n); other = the opposite end.
// Key is int16 when n fits (two radix passes in the sort), else int32.
// With gather != 0 the keys of the gather index instead: key =
// gather_row(row) for every live side, n only when the edge is masked off.
template <typename Key>
__global__ void __launch_bounds__(kThreads)
    fused_sddmm_spmm_kernel_keys(const int32_t* __restrict__ src,
                                 const int32_t* __restrict__ dst,
                                 const uint8_t* __restrict__ mask, int64_t e,
                                 int32_t n, int gather, Key* __restrict__ keys,
                                 int32_t* __restrict__ other) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; j < 2 * e;
       j += stride) {
    const bool dst_side = j < e;
    const int64_t i = dst_side ? j : j - e;
    const int32_t row = dst_side ? dst[i] : src[i];
    int32_t key = n;
    if (mask[i]) {
      if (gather) {
        key = gather_row(row, n);
      } else if (row >= 0 && row < n) {
        key = row;
      }
    }
    keys[j] = static_cast<Key>(key);
    other[j] = dst_side ? src[i] : dst[i];
  }
}

// Entries per lane group whose row loads a row pass keeps in flight at
// once, and the blocks per SM that __launch_bounds__ keeps resident by
// capping registers (4 blocks of 8 warps leave 64 registers a thread).
// The gated row pass and the SDDMM run one wave of kRowMinBlocks and
// kEdgeMinBlocks blocks per SM; the ungated row pass runs uncapped over
// grid_for's grid. Each value can be set at build time (-D, as
// cuda_build.build's defines); `chip_smoke.py --backward-variants` times
// settings against these defaults on an H100 (PERF.md §6).
#ifndef KMZ_EDGE_MIN_BLOCKS
#define KMZ_EDGE_MIN_BLOCKS 4
#endif
#ifndef KMZ_ROW_UNROLL
#define KMZ_ROW_UNROLL 2
#endif
#ifndef KMZ_ROW_MIN_BLOCKS
#define KMZ_ROW_MIN_BLOCKS 4
#endif
#ifndef KMZ_ROW_UNGATED_UNROLL
#define KMZ_ROW_UNGATED_UNROLL 4
#endif
#ifndef KMZ_ROW_UNGATED_MIN_BLOCKS
#define KMZ_ROW_UNGATED_MIN_BLOCKS 1
#endif
constexpr int kEdgeMinBlocks = KMZ_EDGE_MIN_BLOCKS;  // the SDDMM: one edge per lane group
constexpr int kRowUnroll = KMZ_ROW_UNROLL;           // gated: two row loads an entry
constexpr int kRowMinBlocks = KMZ_ROW_MIN_BLOCKS;
constexpr int kRowUngatedUnroll = KMZ_ROW_UNGATED_UNROLL;  // ungated: one row load an entry
constexpr int kRowUngatedMinBlocks = KMZ_ROW_UNGATED_MIN_BLOCKS;
static_assert(kEdgeMinBlocks >= 1 && kRowUnroll >= 1 && kRowMinBlocks >= 1 &&
                  kRowUngatedUnroll >= 1 && kRowUngatedMinBlocks >= 1,
              "backward tuning values out of range");

// One edge slot of the SDDMM's batch: its mask and ids (i >= e: masked).
__device__ __forceinline__ void load_slot(int64_t i, int64_t e, const int32_t* __restrict__ src,
                                          const int32_t* __restrict__ dst,
                                          const uint8_t* __restrict__ mask, bool& live,
                                          int32_t& s, int32_t& d) {
  live = false;
  s = d = 0;
  if (i < e) {
    live = mask[i] != 0;
    s = src[i];
    d = dst[i];
  }
}

// The backward's SDDMM (kernel 3 of the header): da for every live edge,
// into both of its entries of the gather index (gda), into da[E] when da
// is given (0 on masked slots), and one partial of db per block. d_deg and
// d_gate may be null (no upstream grad).
template <int VW>
__global__ void __launch_bounds__(kThreads, kEdgeMinBlocks)
    fused_sddmm_spmm_kernel_grad_edges(const int32_t* __restrict__ src,
                                       const int32_t* __restrict__ dst,
                                       const uint8_t* __restrict__ mask,
                                       const int32_t* __restrict__ pos,
                                       const float* __restrict__ v,
                                       const float* __restrict__ d_bias,
                                       const float* __restrict__ d_deg,
                                       const float* __restrict__ d_gate,
                                       const float* __restrict__ gate, int64_t e,
                                       int32_t n, int32_t h, int lpe,
                                       float2* __restrict__ gda, float* __restrict__ da,
                                       float* __restrict__ partials) {
  using V = Vec<VW>;
  using T = typename V::T;
  __shared__ int32_t live_src[kWarpsPerBlock][32];
  __shared__ int32_t live_dst[kWarpsPerBlock][32];
  __shared__ float live_dot[kWarpsPerBlock][32];
  __shared__ float warp_sum[kWarpsPerBlock];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int groups = 32 / lpe;
  const int g = lane / lpe;
  const int sl = lane & (lpe - 1);
  const int nvec = h / VW;
  const int64_t batches = (e + 31) / 32;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  int64_t batch = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp;
  bool next_live;
  int32_t next_s, next_d;
  load_slot(batch * 32 + lane, batch < batches ? e : 0, src, dst, mask, next_live, next_s,
            next_d);
  float part = 0.f;
  for (; batch < batches; batch += stride) {
    const int64_t i = batch * 32 + lane;
    const bool live = next_live;
    const int32_t s = next_s, d = next_d;
    // the next batch's ids go out before this batch's rows are reduced
    const int64_t after = batch + stride;
    load_slot(after * 32 + lane, after < batches ? e : 0, src, dst, mask, next_live, next_s,
              next_d);
    const bool s_in = s >= 0 && s < n;
    const bool d_in = d >= 0 && d < n;
    // the live edge's scalars, in flight with its rows
    float g_e = 0.f, deg_d = 0.f, deg_s = 0.f, up = 0.f;
    int32_t p_dst = -1, p_src = -1;
    if (live) {
      g_e = gate[i];
      if (d_deg != nullptr) {
        if (d_in) deg_d = d_deg[d];
        if (s_in) deg_s = d_deg[s];
      }
      if (d_gate != nullptr) up = d_gate[i];
      p_dst = pos[i];
      p_src = pos[e + i];
    }
    // the live edges by rank, through shared memory, to the lane groups
    const unsigned ballot = __ballot_sync(kFull, live);
    const int count = __popc(ballot);
    const int rank = __popc(ballot & ((1u << lane) - 1u));
    if (live) {
      live_src[warp][rank] = s;
      live_dst[warp][rank] = d;
    }
    __syncwarp();
    // one live edge per group a step: its d_bias and v rows at both ends
    for (int t = 0; t < count; t += groups) {
      const int r = t + g;
      const float* vs = v;  // v[sc], read when d is in range (with d_bias[d])
      const float* vd = v;  // v[dc], read when s is in range (with d_bias[s])
      const float* bd = nullptr;  // d_bias[d]
      const float* bs = nullptr;  // d_bias[s]
      if (r < count) {
        const int32_t es = live_src[warp][r], ed = live_dst[warp][r];
        vs = v + static_cast<int64_t>(gather_row(es, n)) * h;
        vd = v + static_cast<int64_t>(gather_row(ed, n)) * h;
        if (ed >= 0 && ed < n) bd = d_bias + static_cast<int64_t>(ed) * h;
        if (es >= 0 && es < n) bs = d_bias + static_cast<int64_t>(es) * h;
      }
      float dot = 0.f;
      for (int c = sl; c < nvec; c += lpe) {
        T xb = V::zero(), xv = V::zero(), yb = V::zero(), yv = V::zero();
        if (bd != nullptr) {
          xb = reinterpret_cast<const T*>(bd)[c];
          xv = reinterpret_cast<const T*>(vs)[c];
        }
        if (bs != nullptr) {
          yb = reinterpret_cast<const T*>(bs)[c];
          yv = reinterpret_cast<const T*>(vd)[c];
        }
        dot += V::dot(xb, xv);
        dot += V::dot(yb, yv);
      }
      for (int off = lpe >> 1; off > 0; off >>= 1) dot += __shfl_xor_sync(kFull, dot, off);
      if (sl == 0 && r < count) live_dot[warp][r] = dot;
    }
    __syncwarp();
    float a = 0.f;
    if (live) {
      float dg = live_dot[warp][rank];
      dg += deg_d;
      dg += deg_s;
      dg += up;
      a = dg * (g_e * (1.f - g_e));
      const float2 entry = make_float2(g_e, a);
      if (p_dst >= 0) gda[p_dst] = entry;
      if (p_src >= 0) gda[p_src] = entry;
    }
    if (da != nullptr && i < e) da[i] = a;
    part += a;
    __syncwarp();  // the next batch reuses this warp's shared rows
  }
  // this block's partial of db: lanes by xor shuffles, warps in order
  for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(kFull, part, off);
  if (lane == 0) warp_sum[warp] = part;
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum = 0.f;
    for (int w = 0; w < kWarpsPerBlock; ++w) sum += warp_sum[w];
    partials[blockIdx.x] = sum;
  }
}

// The backward's row pass over the gather index (kernel 4 of the header):
// one warp per node row, lane groups as in fused_sddmm_spmm_kernel. dv, dq
// and dk may each be null (not wanted); split, gda, q and k are read only
// gated. Ungated, every entry of the gather index is a live edge with gate
// 1. db (gated, with the SDDMM's n_partials partials) may be null.
template <int VW, bool kGated>
__global__ void __launch_bounds__(kThreads, kGated ? kRowMinBlocks : kRowUngatedMinBlocks)
    fused_sddmm_spmm_kernel_grad_rows(const int32_t* __restrict__ row_ptr,
                                      const int32_t* __restrict__ nbr,
                                      const int32_t* __restrict__ split,
                                      const float2* __restrict__ gda,
                                      const float* __restrict__ d_bias,
                                      const float* __restrict__ q,
                                      const float* __restrict__ k, int32_t n, int32_t h,
                                      int lpe, float inv_sqrt_h, float* __restrict__ dv,
                                      float* __restrict__ dq, float* __restrict__ dk,
                                      const float* __restrict__ partials, int n_partials,
                                      float* __restrict__ db) {
  using V = Vec<VW>;
  using T = typename V::T;
  constexpr int U = kGated ? kRowUnroll : kRowUngatedUnroll;
  const int lane = threadIdx.x & 31;
  if (kGated && db != nullptr && blockIdx.x == 0 && threadIdx.x < 32) {
    float sum = 0.f;  // lanes stride the partials, then xor shuffles
    for (int b = lane; b < n_partials; b += 32) sum += partials[b];
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(kFull, sum, off);
    if (lane == 0) *db = sum;
  }
  const bool want_v = dv != nullptr;
  const bool want_q = kGated && dq != nullptr;
  const bool want_k = kGated && dk != nullptr;
  if (!want_v && !want_q && !want_k) return;
  const int groups = 32 / lpe;
  const int g = lane / lpe;
  const int sl = lane - g * lpe;
  const int nvec = h / VW;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  int64_t row = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  int32_t next_start = 0, next_end = 0, next_mid = 0;
  if (row < n) {
    next_start = row_ptr[row];
    next_end = row_ptr[row + 1];
    next_mid = kGated ? split[row] : next_end;
  }
  for (; row < n; row += warps) {
    const int32_t start = next_start, end = next_end, mid = next_mid;
    if (row + warps < n) {  // the next row's bounds, in flight with this row
      next_start = row_ptr[row + warps];
      next_end = row_ptr[row + warps + 1];
      next_mid = kGated ? split[row + warps] : next_end;
    }
    for (int c0 = 0; c0 < nvec; c0 += lpe) {
      const int c = c0 + sl;
      const bool active = g < groups && c < nvec;
      T acc_v = V::zero(), acc_q = V::zero(), acc_k = V::zero();
      for (int32_t base = start; base < end; base += 32) {
        const int cnt = min(32, end - base);
        int32_t my_id = 0;
        float my_g = 1.f, my_da = 0.f;
        if (lane < cnt) {
          my_id = nbr[base + lane];
          if (kGated) {
            const float2 entry = gda[base + lane];
            my_g = entry.x;
            my_da = entry.y;
          }
        }
        for (int t = 0; t < cnt; t += groups * U) {
          T xv[U], xo[U];
          float gg[U], dd[U];
          bool on_v[U], on_o[U], src_side[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int p = t + u * groups + g;  // this group's entry in the batch
            const int from = p < 32 ? p : 31;
            const int32_t id = __shfl_sync(kFull, my_id, from);
            gg[u] = kGated ? __shfl_sync(kFull, my_g, from) : 1.f;
            dd[u] = kGated ? __shfl_sync(kFull, my_da, from) : 0.f;
            const bool ok = active && p < cnt;
            src_side[u] = kGated && base + p >= mid;
            on_v[u] = ok && want_v && id >= 0 && id < n;
            on_o[u] = ok && (src_side[u] ? want_q : want_k);
            xv[u] = xo[u] = V::zero();
            if (on_v[u]) {
              xv[u] = reinterpret_cast<const T*>(d_bias + static_cast<int64_t>(id) * h)[c];
            }
            if (kGated && on_o[u]) {
              // this row is the edge's src: dq += da k[dst]; its dst: dk += da q[src]
              const float* table = src_side[u] ? k : q;
              xo[u] = reinterpret_cast<const T*>(table +
                                                 static_cast<int64_t>(gather_row(id, n)) * h)[c];
            }
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (on_v[u]) V::fma(acc_v, gg[u], xv[u]);
            if (kGated && on_o[u]) {
              if (src_side[u]) {
                V::fma(acc_q, dd[u], xo[u]);
              } else {
                V::fma(acc_k, dd[u], xo[u]);
              }
            }
          }
        }
      }
      // groups' partials in group order, into the lanes of group 0
      T tv = acc_v, tq = acc_q, tk = acc_k;
      for (int kk = 1; kk < groups; ++kk) {
        if (want_v) V::add(tv, V::shfl(acc_v, sl + kk * lpe));
        if (want_q) V::add(tq, V::shfl(acc_q, sl + kk * lpe));
        if (want_k) V::add(tk, V::shfl(acc_k, sl + kk * lpe));
      }
      if (g == 0 && c < nvec) {
        if (want_v) reinterpret_cast<T*>(dv + row * h)[c] = tv;
        if (want_q) {
          V::scale(tq, inv_sqrt_h);
          reinterpret_cast<T*>(dq + row * h)[c] = tq;
        }
        if (want_k) {
          V::scale(tk, inv_sqrt_h);
          reinterpret_cast<T*>(dk + row * h)[c] = tk;
        }
      }
    }
  }
}

int sm_count() {
  static int cached[64] = {0};
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0 || device >= 64) return 132;
  if (cached[device] == 0) {
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cached[device] = sms > 0 ? sms : 132;
  }
  return cached[device];
}

unsigned grid_for(int64_t warps_needed) {
  int64_t blocks = (warps_needed + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int64_t cap = static_cast<int64_t>(sm_count()) * (2048 / kThreads);
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return static_cast<unsigned>(blocks);
}

template <int VW>
int launch(const int32_t* src, const int32_t* dst, const uint8_t* mask,
           const int32_t* row_ptr, const int32_t* nbr, const int64_t* eid,
           const float* v, const float* q, const float* k, const float* b,
           bool gated, int64_t e, int32_t n, int32_t h, float sqrt_h,
           float* bias, float* deg, float* gate, cudaStream_t stream) {
  const int nvec = h / VW;
  if (gate != nullptr && e > 0) {
    int lpe = 1;  // a power of two for the xor reduction
    while (lpe < nvec && lpe < 32) lpe <<= 1;
    if (!gated) lpe = 1;
    const unsigned grid = grid_for((e + 32 / lpe - 1) / (32 / lpe));
    if (gated) {
      fused_sddmm_spmm_kernel_gate<VW, true><<<grid, kThreads, 0, stream>>>(
          src, dst, mask, q, k, b, e, n, h, lpe, sqrt_h, gate);
    } else {
      fused_sddmm_spmm_kernel_gate<VW, false><<<grid, kThreads, 0, stream>>>(
          src, dst, mask, q, k, b, e, n, h, lpe, sqrt_h, gate);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int lpe = nvec < 32 ? nvec : 32;
  const unsigned grid = grid_for(n);
  if (gated) {
    fused_sddmm_spmm_kernel<VW, true><<<grid, kThreads, 0, stream>>>(
        row_ptr, nbr, eid, v, gate, e, n, h, lpe, bias, deg);
  } else {
    fused_sddmm_spmm_kernel<VW, false><<<grid, kThreads, 0, stream>>>(
        row_ptr, nbr, eid, v, gate, e, n, h, lpe, bias, deg);
  }
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, uintptr_t bytes) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// row_ptr/nbr/eid: the CSR index of ops/sparse.py:edge_index. q, k and b
// are read only when gated != 0; gate may be null when not gated (then it
// is not written), and must be given when gated (the row pass reads it).
extern "C" int kmamiz_fused_sddmm_spmm(const int32_t* src, const int32_t* dst,
                                       const uint8_t* mask, const int32_t* row_ptr,
                                       const int32_t* nbr, const int64_t* eid,
                                       const float* v, const float* q,
                                       const float* k, const float* b, int gated,
                                       int64_t e, int32_t n, int32_t h,
                                       float sqrt_h, float* bias, float* deg,
                                       float* gate, cudaStream_t stream) {
  if (gated && gate == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  // vector width: whole rows of 16 or 8 bytes when H and the tables allow
  const bool v4 = h % 4 == 0 && aligned(v, 16) && aligned(q, 16) && aligned(k, 16) &&
                  aligned(bias, 16);
  const bool v2 = h % 2 == 0 && aligned(v, 8) && aligned(q, 8) && aligned(k, 8) &&
                  aligned(bias, 8);
  if (v4) {
    return launch<4>(src, dst, mask, row_ptr, nbr, eid, v, q, k, b, gated != 0, e, n, h,
                     sqrt_h, bias, deg, gate, stream);
  }
  if (v2) {
    return launch<2>(src, dst, mask, row_ptr, nbr, eid, v, q, k, b, gated != 0, e, n, h,
                     sqrt_h, bias, deg, gate, stream);
  }
  return launch<1>(src, dst, mask, row_ptr, nbr, eid, v, q, k, b, gated != 0, e, n, h,
                   sqrt_h, bias, deg, gate, stream);
}

// The sort keys and opposite ends of ops/sparse.py:edge_index for 2E
// entries: keys holds 2E keys of key_bytes each (2 only when n < 2^15),
// other 2E int32. gather != 0: the keys of the backward's gather index.
extern "C" int kmamiz_edge_index_keys(const int32_t* src, const int32_t* dst,
                                      const uint8_t* mask, int64_t e, int32_t n,
                                      int gather, int key_bytes, void* keys,
                                      int32_t* other, cudaStream_t stream) {
  if (key_bytes != 4 && !(key_bytes == 2 && n < 32768)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e == 0) return 0;
  int64_t blocks = (2 * e + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sm_count()) * (2048 / kThreads);
  if (blocks > cap) blocks = cap;
  const unsigned grid = static_cast<unsigned>(blocks);
  if (key_bytes == 2) {
    fused_sddmm_spmm_kernel_keys<<<grid, kThreads, 0, stream>>>(
        src, dst, mask, e, n, gather, static_cast<int16_t*>(keys), other);
  } else {
    fused_sddmm_spmm_kernel_keys<<<grid, kThreads, 0, stream>>>(
        src, dst, mask, e, n, gather, static_cast<int32_t*>(keys), other);
  }
  return static_cast<int>(cudaGetLastError());
}

namespace {

// stages of kmamiz_fused_sddmm_spmm_backward
constexpr int kStageEdges = 1;  // the SDDMM of da (gated only)
constexpr int kStageRows = 2;   // the row pass (and db)

// The backward's operands (see kmamiz_fused_sddmm_spmm_backward).
struct Backward {
  const int32_t *src, *dst;
  const uint8_t* mask;
  const int32_t *row_ptr, *nbr, *split, *pos;
  const float *v, *q, *k, *gate, *d_bias, *d_deg, *d_gate;
  int64_t e;
  int32_t n, h;
  float sqrt_h;
  float *dv, *dq, *dk, *db, *da;
  float2* gda;
  float* partials;
  int32_t partials_cap;
};

unsigned edges_grid(int64_t e, int32_t partials_cap) {
  // one wave of resident blocks at most: each warp then strides over
  // batches, the next one's ids in flight
  const int64_t batches = (e + 31) / 32;
  int64_t blocks = (batches + kWarpsPerBlock - 1) / kWarpsPerBlock;
  int64_t cap = static_cast<int64_t>(sm_count()) * kEdgeMinBlocks;
  if (cap > partials_cap) cap = partials_cap;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return static_cast<unsigned>(blocks);
}

template <int VW>
int launch_backward(const Backward& a, bool gated, bool edges, bool rows,
                    cudaStream_t stream) {
  const int nvec = a.h / VW;
  int n_partials = 0;
  if (edges) {
    int lpe = 1;  // a power of two for the xor reduction
    while (lpe < nvec && lpe < 32) lpe <<= 1;
    const unsigned grid = edges_grid(a.e, a.partials_cap);
    n_partials = static_cast<int>(grid);
    fused_sddmm_spmm_kernel_grad_edges<VW><<<grid, kThreads, 0, stream>>>(
        a.src, a.dst, a.mask, a.pos, a.v, a.d_bias, a.d_deg, a.d_gate, a.gate, a.e, a.n, a.h,
        lpe, a.gda, a.da, a.partials);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (!rows) return 0;
  const int lpe = nvec < 32 ? nvec : 32;
  // only db wanted: one block sums it
  const bool any_rows = a.dv != nullptr || a.dq != nullptr || a.dk != nullptr;
  unsigned grid = 1;
  if (any_rows) {
    grid = grid_for(a.n);
    // gated: at most one wave of resident blocks; warps stride over the rows
    const unsigned wave = sm_count() * kRowMinBlocks;
    if (gated && grid > wave) grid = wave;
  }
  if (gated) {
    fused_sddmm_spmm_kernel_grad_rows<VW, true><<<grid, kThreads, 0, stream>>>(
        a.row_ptr, a.nbr, a.split, a.gda, a.d_bias, a.q, a.k, a.n, a.h, lpe, 1.f / a.sqrt_h,
        a.dv, a.dq, a.dk, a.partials, n_partials, a.db);
  } else {
    fused_sddmm_spmm_kernel_grad_rows<VW, false><<<grid, kThreads, 0, stream>>>(
        a.row_ptr, a.nbr, a.split, a.gda, a.d_bias, a.q, a.k, a.n, a.h, lpe, 1.f / a.sqrt_h,
        a.dv, a.dq, a.dk, a.partials, n_partials, a.db);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int VW>
const void* backward_kernel(int which, bool gated) {
  if (which == 0) return reinterpret_cast<const void*>(fused_sddmm_spmm_kernel_grad_edges<VW>);
  return gated ? reinterpret_cast<const void*>(fused_sddmm_spmm_kernel_grad_rows<VW, true>)
               : reinterpret_cast<const void*>(fused_sddmm_spmm_kernel_grad_rows<VW, false>);
}

}  // namespace

// The fused kernel's backward in one call (kernels 3 and 4 of the header),
// on `stream`, without a sync. `stages` selects them: both for a training
// step's backward; one alone to time or check it. Operands:
//   edge list src/dst/mask (the SDDMM); the gather index row_ptr[N+1],
//   nbr[2E] and, gated, split[N] and pos[2E]; the forward's v, q, k
//   and gate; the upstream grads d_bias (required), d_deg and d_gate
//   (nullable).
// Outputs, each nullable (not wanted): dv, dq, dk [N, H] (dq and dk gated
// only), db (gated, needs both stages in this call), da[E] (the SDDMM).
// Scratch: gda[2E] (float2: each entry's (g, da), written by the SDDMM,
// read by the row pass) and partials[partials_cap] (db's block partials).
extern "C" int kmamiz_fused_sddmm_spmm_backward(
    const int32_t* src, const int32_t* dst, const uint8_t* mask, const int32_t* row_ptr,
    const int32_t* nbr, const int32_t* split, const int32_t* pos, const float* v,
    const float* q, const float* k, const float* gate, const float* d_bias,
    const float* d_deg, const float* d_gate, int gated, int stages, int64_t e, int32_t n,
    int32_t h, float sqrt_h, float* dv, float* dq, float* dk, float* db, float* da,
    float* gda, float* partials, int32_t partials_cap, cudaStream_t stream) {
  const bool edges = (stages & kStageEdges) != 0;
  const bool rows = (stages & kStageRows) != 0;
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (!edges && !rows) return invalid;
  // an empty edge list (e == 0) gives null pointers for its [E] and [2E]
  // operands, which no kernel then reads
  const bool has_edges = e > 0;
  if (edges && (!gated || v == nullptr || d_bias == nullptr || partials == nullptr ||
                partials_cap < 1 ||
                (has_edges && (src == nullptr || dst == nullptr || mask == nullptr ||
                               pos == nullptr || gate == nullptr || gda == nullptr)))) {
    return invalid;
  }
  if (rows) {
    if (row_ptr == nullptr || (has_edges && nbr == nullptr)) return invalid;
    if (dv != nullptr && d_bias == nullptr) return invalid;
    if (!gated && (dq != nullptr || dk != nullptr || db != nullptr)) return invalid;
    if (gated && (dv != nullptr || dq != nullptr || dk != nullptr) &&
        (split == nullptr || (has_edges && gda == nullptr))) {
      return invalid;
    }
    if ((dq != nullptr && k == nullptr) || (dk != nullptr && q == nullptr)) return invalid;
    if (db != nullptr && !edges) return invalid;  // the partials of this call's SDDMM
  } else if (db != nullptr || dv != nullptr || dq != nullptr || dk != nullptr) {
    return invalid;
  }
  const Backward a{src,    dst,   mask,   row_ptr, nbr, split, pos,
                   v,      q,     k,      gate,    d_bias, d_deg, d_gate,
                   e,      n,     h,      sqrt_h,  dv,  dq,    dk,
                   db,     da,    reinterpret_cast<float2*>(gda), partials, partials_cap};
  // vector width: whole rows of 16 or 8 bytes when H and the tables allow
  const bool v4 = h % 4 == 0 && aligned(v, 16) && aligned(d_bias, 16) && aligned(q, 16) &&
                  aligned(k, 16) && aligned(dv, 16) && aligned(dq, 16) && aligned(dk, 16);
  const bool v2 = h % 2 == 0 && aligned(v, 8) && aligned(d_bias, 8) && aligned(q, 8) &&
                  aligned(k, 8) && aligned(dv, 8) && aligned(dq, 8) && aligned(dk, 8);
  if (!aligned(gda, 8)) return invalid;
  if (v4) return launch_backward<4>(a, gated != 0, edges, rows, stream);
  if (v2) return launch_backward<2>(a, gated != 0, edges, rows, stream);
  return launch_backward<1>(a, gated != 0, edges, rows, stream);
}

// What the card makes of a backward kernel (which: 0 the SDDMM, 1 the row
// pass; vw: 1, 2 or 4 floats a vector load; gated): out[0] registers a
// thread, out[1] static shared memory a block (bytes), out[2] local memory
// a thread (bytes: spills), out[3] blocks resident on one SM, out[4]
// threads a block.
extern "C" int kmamiz_fused_sddmm_spmm_backward_info(int which, int vw, int gated, int* out) {
  const void* fn = vw == 4   ? backward_kernel<4>(which, gated != 0)
                   : vw == 2 ? backward_kernel<2>(which, gated != 0)
                             : backward_kernel<1>(which, gated != 0);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = blocks;
  out[4] = kThreads;
  return 0;
}

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
// scatter was dropped in the forward). Two kernels:
//
// 3. fused_sddmm_spmm_kernel_grad_edges (the SDDMM of da, gated only): a
//    power-of-two group of lanes per edge slot reads d_bias and v at both
//    ends with vector loads, reduces the two dots with xor shuffles in a
//    fixed order, and writes da[e] once per edge slot.
// 4. fused_sddmm_spmm_kernel_grad_rows: one warp per gather row, lane
//    groups as in (2); accumulates g·d_bias[nbr] (dv), and gated da·k[nbr]
//    on the row's src-side entries (dq) and da·q[nbr] on its dst-side
//    entries (dk; the entry's direction is j < E or j >= E), combines the
//    groups in order and writes each output row once. No atomics, no
//    zero-fill: the same bits on every run.
//
// db is torch.sum(da) in the wrapper (one reduction in a fixed order).
// Ungated, the whole backward is one launch of (4) for dv, none when v
// needs no grad. Bound, as the forward: memory traffic. (3) reads the ids
// and mask (9 B per edge), the gate, and at most four table rows per live
// edge (d_bias and v at both ends; each row once: N*H*4 B per table) and
// writes da (4 B per edge): ~9.5 MB gated at N = 16,384, E = 262,144,
// H = 32, ~2.8 us at 3.35 TB/s. (4) reads the gather index (12 B per live
// entry), the gate and da by entry (8 B), the tables d_bias, q, k once,
// and writes dv, dq, dk once (N*H*4 B each).

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

// The backward's SDDMM: da[e] for every edge slot (see the header). lpe
// lanes (a power of two) per edge, 32 / lpe edges per warp step. d_deg and
// d_gate may be null (no upstream grad).
template <int VW>
__global__ void __launch_bounds__(kThreads)
    fused_sddmm_spmm_kernel_grad_edges(const int32_t* __restrict__ src,
                                       const int32_t* __restrict__ dst,
                                       const uint8_t* __restrict__ mask,
                                       const float* __restrict__ v,
                                       const float* __restrict__ d_bias,
                                       const float* __restrict__ d_deg,
                                       const float* __restrict__ d_gate,
                                       const float* __restrict__ gate, int64_t e,
                                       int32_t n, int32_t h, int lpe,
                                       float* __restrict__ da) {
  using V = Vec<VW>;
  const int lane = threadIdx.x & 31;
  const int per_warp = 32 / lpe;
  const int sl = lane & (lpe - 1);
  const int nvec = h / VW;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  for (int64_t w = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
       w * per_warp < e; w += warps) {
    const int64_t i = w * per_warp + lane / lpe;
    const bool live = i < e && mask[i];
    int32_t s = 0, d = 0;
    bool s_in = false, d_in = false;
    float dot = 0.f;
    if (live) {
      s = src[i];
      d = dst[i];
      s_in = s >= 0 && s < n;
      d_in = d >= 0 && d < n;
      const auto* vs = reinterpret_cast<const typename V::T*>(
          v + static_cast<int64_t>(gather_row(s, n)) * h);
      const auto* vd = reinterpret_cast<const typename V::T*>(
          v + static_cast<int64_t>(gather_row(d, n)) * h);
      // the scatter into d (or s) was dropped in the forward when it lies
      // out of range: no grad flows back through it
      if (d_in) {
        const auto* gd = reinterpret_cast<const typename V::T*>(
            d_bias + static_cast<int64_t>(d) * h);
        for (int c = sl; c < nvec; c += lpe) dot += V::dot(gd[c], vs[c]);
      }
      if (s_in) {
        const auto* gs = reinterpret_cast<const typename V::T*>(
            d_bias + static_cast<int64_t>(s) * h);
        for (int c = sl; c < nvec; c += lpe) dot += V::dot(gs[c], vd[c]);
      }
    }
    for (int off = lpe >> 1; off > 0; off >>= 1) dot += __shfl_xor_sync(kFull, dot, off);
    if (i < e && sl == 0) {
      float out = 0.f;
      if (live) {
        float dg = dot;
        if (d_deg != nullptr) {
          if (d_in) dg += d_deg[d];
          if (s_in) dg += d_deg[s];
        }
        if (d_gate != nullptr) dg += d_gate[i];
        const float g = gate[i];
        out = dg * (g * (1.f - g));
      }
      da[i] = out;
    }
  }
}

// The backward's row pass over the gather index: one warp per node row,
// lane groups as in fused_sddmm_spmm_kernel. dv, dq and dk may each be
// null (not wanted); dq/dk are read only when gated. Ungated, every entry
// of the gather index is a live edge with gate 1.
template <int VW, bool kGated>
__global__ void __launch_bounds__(kThreads)
    fused_sddmm_spmm_kernel_grad_rows(const int32_t* __restrict__ row_ptr,
                                      const int32_t* __restrict__ nbr,
                                      const int64_t* __restrict__ eid,
                                      const float* __restrict__ d_bias,
                                      const float* __restrict__ gate,
                                      const float* __restrict__ da,
                                      const float* __restrict__ q,
                                      const float* __restrict__ k, int64_t e,
                                      int32_t n, int32_t h, int lpe, float inv_sqrt_h,
                                      float* __restrict__ dv, float* __restrict__ dq,
                                      float* __restrict__ dk) {
  using V = Vec<VW>;
  const int lane = threadIdx.x & 31;
  const int groups = 32 / lpe;
  const int g = lane / lpe;
  const int sl = lane - g * lpe;
  const int nvec = h / VW;
  const bool want_v = dv != nullptr;
  const bool want_qk = kGated && (dq != nullptr || dk != nullptr);
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
       row < n; row += warps) {
    const int32_t start = row_ptr[row];
    const int32_t end = row_ptr[row + 1];
    for (int c0 = 0; c0 < nvec; c0 += lpe) {
      const int c = c0 + sl;
      const bool active = g < groups && c < nvec;
      typename V::T acc_v = V::zero(), acc_q = V::zero(), acc_k = V::zero();
      for (int32_t base = start; base < end; base += 32) {
        const int cnt = min(32, end - base);
        int32_t my_id = 0;
        int my_src_side = 0;
        float my_g = 1.f, my_da = 0.f;
        if (lane < cnt) {
          my_id = nbr[base + lane];
          if (kGated) {
            const int64_t j = eid[base + lane];
            my_src_side = j >= e;
            const int64_t edge = my_src_side ? j - e : j;
            my_g = gate[edge];
            my_da = da != nullptr ? da[edge] : 0.f;
          }
        }
#pragma unroll 2
        for (int t = 0; t < cnt; t += groups) {
          const int p = t + g;  // this group's entry in the batch
          const int from = p < 32 ? p : 31;
          const int32_t id = __shfl_sync(kFull, my_id, from);
          const float gg = kGated ? __shfl_sync(kFull, my_g, from) : 1.f;
          const float dd = kGated ? __shfl_sync(kFull, my_da, from) : 0.f;
          const int src_side = kGated ? __shfl_sync(kFull, my_src_side, from) : 0;
          if (active && p < cnt) {
            if (want_v && id >= 0 && id < n) {
              V::fma(acc_v, gg, reinterpret_cast<const typename V::T*>(
                                    d_bias + static_cast<int64_t>(id) * h)[c]);
            }
            if (want_qk) {
              const int64_t other = static_cast<int64_t>(gather_row(id, n)) * h;
              if (src_side) {  // this row is the edge's src: dq += da k[dst]
                V::fma(acc_q, dd, reinterpret_cast<const typename V::T*>(k + other)[c]);
              } else {  // this row is the edge's dst: dk += da q[src]
                V::fma(acc_k, dd, reinterpret_cast<const typename V::T*>(q + other)[c]);
              }
            }
          }
        }
      }
      // groups' partials in group order, into the lanes of group 0
      typename V::T tv = acc_v, tq = acc_q, tk = acc_k;
      for (int kk = 1; kk < groups; ++kk) {
        if (want_v) V::add(tv, V::shfl(acc_v, sl + kk * lpe));
        if (want_qk) {
          V::add(tq, V::shfl(acc_q, sl + kk * lpe));
          V::add(tk, V::shfl(acc_k, sl + kk * lpe));
        }
      }
      if (g == 0 && c < nvec) {
        if (want_v) reinterpret_cast<typename V::T*>(dv + row * h)[c] = tv;
        if (kGated && dq != nullptr) {
          V::scale(tq, inv_sqrt_h);
          reinterpret_cast<typename V::T*>(dq + row * h)[c] = tq;
        }
        if (kGated && dk != nullptr) {
          V::scale(tk, inv_sqrt_h);
          reinterpret_cast<typename V::T*>(dk + row * h)[c] = tk;
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

template <int VW>
int launch_grad_edges(const int32_t* src, const int32_t* dst, const uint8_t* mask,
                      const float* v, const float* d_bias, const float* d_deg,
                      const float* d_gate, const float* gate, int64_t e, int32_t n,
                      int32_t h, float* da, cudaStream_t stream) {
  const int nvec = h / VW;
  int lpe = 1;  // a power of two for the xor reduction
  while (lpe < nvec && lpe < 32) lpe <<= 1;
  const unsigned grid = grid_for((e + 32 / lpe - 1) / (32 / lpe));
  fused_sddmm_spmm_kernel_grad_edges<VW><<<grid, kThreads, 0, stream>>>(
      src, dst, mask, v, d_bias, d_deg, d_gate, gate, e, n, h, lpe, da);
  return static_cast<int>(cudaGetLastError());
}

template <int VW>
int launch_grad_rows(const int32_t* row_ptr, const int32_t* nbr, const int64_t* eid,
                     const float* d_bias, const float* gate, const float* da,
                     const float* q, const float* k, bool gated, int64_t e, int32_t n,
                     int32_t h, float inv_sqrt_h, float* dv, float* dq, float* dk,
                     cudaStream_t stream) {
  const int nvec = h / VW;
  const int lpe = nvec < 32 ? nvec : 32;
  const unsigned grid = grid_for(n);
  if (gated) {
    fused_sddmm_spmm_kernel_grad_rows<VW, true><<<grid, kThreads, 0, stream>>>(
        row_ptr, nbr, eid, d_bias, gate, da, q, k, e, n, h, lpe, inv_sqrt_h, dv, dq, dk);
  } else {
    fused_sddmm_spmm_kernel_grad_rows<VW, false><<<grid, kThreads, 0, stream>>>(
        row_ptr, nbr, eid, d_bias, gate, da, q, k, e, n, h, lpe, inv_sqrt_h, dv, dq, dk);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// da[E] of the gated backward (kernel 3 of the header). d_deg and d_gate
// may be null; v, d_bias and gate may not.
extern "C" int kmamiz_fused_sddmm_spmm_grad_edges(const int32_t* src, const int32_t* dst,
                                                  const uint8_t* mask, const float* v,
                                                  const float* d_bias, const float* d_deg,
                                                  const float* d_gate, const float* gate,
                                                  int64_t e, int32_t n, int32_t h,
                                                  float* da, cudaStream_t stream) {
  if (v == nullptr || d_bias == nullptr || gate == nullptr || da == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e == 0) return 0;
  if (h % 4 == 0 && aligned(v, 16) && aligned(d_bias, 16)) {
    return launch_grad_edges<4>(src, dst, mask, v, d_bias, d_deg, d_gate, gate, e, n, h, da,
                                stream);
  }
  if (h % 2 == 0 && aligned(v, 8) && aligned(d_bias, 8)) {
    return launch_grad_edges<2>(src, dst, mask, v, d_bias, d_deg, d_gate, gate, e, n, h, da,
                                stream);
  }
  return launch_grad_edges<1>(src, dst, mask, v, d_bias, d_deg, d_gate, gate, e, n, h, da,
                              stream);
}

// dv, dq, dk [N, H] of the backward (kernel 4 of the header) over the
// gather index row_ptr/nbr/eid. Gated: gate and da are read, and dq/dk
// are written where given (q and k must be given with them). Any of dv,
// dq, dk may be null (not wanted); d_bias must be given with dv.
extern "C" int kmamiz_fused_sddmm_spmm_grad_rows(const int32_t* row_ptr, const int32_t* nbr,
                                                 const int64_t* eid, const float* d_bias,
                                                 const float* gate, const float* da,
                                                 const float* q, const float* k, int gated,
                                                 int64_t e, int32_t n, int32_t h,
                                                 float sqrt_h, float* dv, float* dq, float* dk,
                                                 cudaStream_t stream) {
  if (dv != nullptr && d_bias == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (gated && (gate == nullptr || ((dq != nullptr || dk != nullptr) &&
                                    (da == nullptr || q == nullptr || k == nullptr)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float inv = 1.f / sqrt_h;
  const bool v4 = h % 4 == 0 && aligned(d_bias, 16) && aligned(q, 16) && aligned(k, 16) &&
                  aligned(dv, 16) && aligned(dq, 16) && aligned(dk, 16);
  const bool v2 = h % 2 == 0 && aligned(d_bias, 8) && aligned(q, 8) && aligned(k, 8) &&
                  aligned(dv, 8) && aligned(dq, 8) && aligned(dk, 8);
  if (v4) {
    return launch_grad_rows<4>(row_ptr, nbr, eid, d_bias, gate, da, q, k, gated != 0, e, n, h,
                               inv, dv, dq, dk, stream);
  }
  if (v2) {
    return launch_grad_rows<2>(row_ptr, nbr, eid, d_bias, gate, da, q, k, gated != 0, e, n, h,
                               inv, dv, dq, dk, stream);
  }
  return launch_grad_rows<1>(row_ptr, nbr, eid, d_bias, gate, da, q, k, gated != 0, e, n, h,
                             inv, dv, dq, dk, stream);
}

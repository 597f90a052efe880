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
// caps N at 2,048 rows. Here there is no cap: one warp per edge (grid-
// stride over edges), lanes across the H columns of a row. The gated
// dot product is a warp-shuffle reduction in fp32; the scatter is float
// atomicAdd into the zero-filled outputs, so the [E, H] messages never
// reach device memory. FMA in fp32 only (no TF32), as the Pallas kernel
// runs at Precision.HIGHEST.
//
// Bound: memory traffic. Edge ids and mask (9 B per edge), the node tables
// (N*H*4 B each: v, plus q and k when gated) read once, bias and deg (and
// the gate) written once. Ungated at N = 16,384, E = 262,144, H = 64 that
// is ~10.8 MB, ~3.2 us at 3.35 TB/s.
//
// Known weaknesses: atomics serialise on hub endpoints and sum in a
// run-dependent order; lanes past H idle when H < 32 (H = 18 uses 18 of 32
// lanes). A deterministic CSR-by-node variant is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;

__device__ __forceinline__ int32_t gather_row(int32_t id, int32_t n) {
  return id < 0 ? 0 : (id >= n ? n - 1 : id);
}

template <bool kGated>
__global__ void fused_sddmm_spmm_kernel(const int32_t* __restrict__ src,
                                        const int32_t* __restrict__ dst,
                                        const uint8_t* __restrict__ mask,
                                        const float* __restrict__ v,
                                        const float* __restrict__ q,
                                        const float* __restrict__ k,
                                        const float* __restrict__ b,
                                        int64_t e, int32_t n, int32_t h,
                                        float sqrt_h,
                                        float* __restrict__ bias,
                                        float* __restrict__ deg,
                                        float* __restrict__ gate) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  const float b_edge = kGated ? *b : 0.f;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                   (threadIdx.x >> 5);
       i < e; i += warps) {
    if (!mask[i]) {
      if (gate != nullptr && lane == 0) gate[i] = 0.f;
      continue;
    }
    const int32_t s = src[i];
    const int32_t d = dst[i];
    const int64_t s_row = static_cast<int64_t>(gather_row(s, n)) * h;
    const int64_t d_row = static_cast<int64_t>(gather_row(d, n)) * h;
    float g = 1.f;
    if (kGated) {
      float dot = 0.f;
      for (int c = lane; c < h; c += 32) {
        dot = fmaf(q[s_row + c], k[d_row + c], dot);
      }
      for (int off = 16; off > 0; off >>= 1) {
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      }
      g = 1.f / (1.f + expf(-(dot / sqrt_h + b_edge)));
    }
    if (gate != nullptr && lane == 0) gate[i] = g;
    const bool s_in = s >= 0 && s < n;
    const bool d_in = d >= 0 && d < n;
    for (int c = lane; c < h; c += 32) {
      if (d_in) atomicAdd(&bias[static_cast<int64_t>(d) * h + c], g * v[s_row + c]);
      if (s_in) atomicAdd(&bias[static_cast<int64_t>(s) * h + c], g * v[d_row + c]);
    }
    if (lane == 0) {
      if (d_in) atomicAdd(&deg[d], g);
      if (s_in) atomicAdd(&deg[s], g);
    }
  }
}

}  // namespace

// q, k and b are read only when gated != 0; gate may be null (ungated
// callers that do not need it), in which case it is not written.
extern "C" int kmamiz_fused_sddmm_spmm(const int32_t* src, const int32_t* dst,
                                       const uint8_t* mask, const float* v,
                                       const float* q, const float* k,
                                       const float* b, int gated, int64_t e,
                                       int32_t n, int32_t h, float sqrt_h,
                                       float* bias, float* deg, float* gate,
                                       cudaStream_t stream) {
  // one warp per edge; enough blocks to give every edge its own warp,
  // capped so that a large edge list strides (132 SMs x 16 blocks)
  int64_t blocks = (e + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  const unsigned grid = static_cast<unsigned>(blocks);
  if (gated) {
    fused_sddmm_spmm_kernel<true><<<grid, kThreads, 0, stream>>>(
        src, dst, mask, v, q, k, b, e, n, h, sqrt_h, bias, deg, gate);
  } else {
    fused_sddmm_spmm_kernel<false><<<grid, kThreads, 0, stream>>>(
        src, dst, mask, v, q, k, b, e, n, h, sqrt_h, bias, deg, gate);
  }
  return static_cast<int>(cudaGetLastError());
}

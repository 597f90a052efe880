// Segment statistics of one span window: the per-(endpoint, status)
// reduction behind kmamiz_tpu_torch.ops.window.window_stats.
//
//   sums[r, s]  = sum of values[r, i] over spans i with seg[i] == s
//   ts_max[s]   = max(0, ts[i])      over the same spans (when ts is given)
//
// Spans whose segment id lies outside [0, num_segments) are dropped: the
// caller parks padded and non-SERVER rows at num_segments.
//
// Replaces the TPU kernel kmamiz_tpu/ops/pallas_kernels.py
// (_segment_stats_kernel behind segment_stats_matmul), which builds a dense
// [span block, segment block] one-hot tile and multiplies it on the MXU.
// That is N*S work, which loses to a scatter at the production shape even
// on the TPU. Here the reduction is a scatter of atomics.
//
// Layout: the outputs are one buffer, and the kernel zeroes it itself: a
// zeroing prologue, a grid-wide barrier, then the spans. That takes a
// cooperative launch (every block resident at once, so the grid is at most
// one wave and strides over the spans), and a call is one ctypes call and
// one launch. Built with SEGMENT_STATS_ZERO_BY_MEMSET defined, the same
// source instead zeroes with a cudaMemsetAsync before a plain launch of the
// span loop; `chip_smoke.py --zeroing` times the two against each other:
// the memset takes slightly less device time, but the call is host-bound at
// the tick and the one launch costs the host less than the memset and the
// launch.
// The sums are segment-major, [S, ld] floats with ld = m rounded up to a
// multiple of 4 (m = 5 gives ld = 8: one 32-byte sector per segment); the
// wrapper hands them back as the strided [m, S] view. ts_max, when ts is
// given, follows as [S] int32.
//
// Each span adds rows 0-3 with one 16-byte vector atomic (atomicAdd on a
// float4 in global memory, new in compute capability 9.0; it compiles to
// red.global.add.v4.f32) and each further row with a scalar atomic: at
// m = 5 that is 2 float atomics on one sector per span instead of 5 on five
// cache lines. The m = 1 pass keeps a scalar atomic into an [S] row, and
// the timestamp takes one atomicMax (0 is its identity: the buffer starts
// zeroed and a non-positive timestamp never wins).
//
// Bound: memory traffic. Each span reads m floats, a segment id and a
// timestamp ((m + 2) * 4 B) and the outputs are (m + 1) * S * 4 B. At the
// production window (N = 2^20 spans, S = 80,000 segments, m = 5) that is
// ~29.4 MB read and ~1.9 MB written, about 9.4 us at 3.35 TB/s; at the
// tick (16,384 spans into 65,536 segments) about 0.6 us, where the launch
// and the wrapper's host work set the time, not the body.
//
// Grid: one span per thread, blocks shrunk from 256 down to 32 threads
// until the window fills every SM (the tick's 16,384 spans run as 256
// blocks of 64), capped at the blocks resident at once; a larger window
// grid-strides.
//
// Known weakness: atomics on hot segments serialise, and the float sums
// land in a run-dependent order (a deterministic segmented reduce over
// seg-sorted spans is later work). Warp aggregation of equal ids
// (__match_any_sync) is not used: tick spans arrive in trace order, not
// grouped by endpoint.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void accumulate_span(int64_t i, const float* __restrict__ values,
                                                int m, int64_t n,
                                                const int32_t* __restrict__ seg,
                                                const int32_t* __restrict__ ts,
                                                int32_t num_segments, int ld,
                                                float* __restrict__ sums,
                                                int32_t* __restrict__ ts_max) {
  const int32_t s = seg[i];
  if (s < 0 || s >= num_segments) return;
  float* row = sums + static_cast<int64_t>(s) * ld;
  int r = 0;
  for (; r + 4 <= m; r += 4) {
    const float4 add = make_float4(values[r * n + i], values[(r + 1) * n + i],
                                   values[(r + 2) * n + i], values[(r + 3) * n + i]);
    atomicAdd(reinterpret_cast<float4*>(row + r), add);
  }
  for (; r < m; ++r) atomicAdd(row + r, values[r * n + i]);
  if (ts != nullptr) {
    const int32_t t = ts[i];
    if (t > 0) atomicMax(&ts_max[s], t);
  }
}

// The number of 4-byte words the outputs span: with ts the whole
// [S * ld + S] buffer, without ts the extent of the sums ((S - 1) * ld + m
// floats, what a strided [m, S] tensor holds).
__host__ __device__ inline int64_t output_words(int m, int32_t num_segments, int ld,
                                                bool with_ts) {
  const int64_t s = num_segments;
  return with_ts ? s * ld + s : (s > 0 ? (s - 1) * ld + m : 0);
}

__global__ void segment_stats_kernel(const float* __restrict__ values, int m,
                                     int64_t n, const int32_t* __restrict__ seg,
                                     const int32_t* __restrict__ ts,
                                     int32_t num_segments, int ld,
                                     float* __restrict__ sums,
                                     int32_t* __restrict__ ts_max) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
#ifndef SEGMENT_STATS_ZERO_BY_MEMSET
  const int64_t words = output_words(m, num_segments, ld, ts != nullptr);
  for (int64_t w = first; w < words; w += stride) sums[w] = 0.f;
  cooperative_groups::this_grid().sync();
#endif
  for (int64_t i = first; i < n; i += stride) {
    accumulate_span(i, values, m, n, seg, ts, num_segments, ld, sums, ts_max);
  }
}

// threads per block and blocks for n spans: the largest block (256 down to
// 32 threads) that still gives every SM a block, at most as many blocks as
// fit on the card at once (the cooperative launch needs them all resident)
cudaError_t launch_shape(int64_t n, int* threads, int64_t* blocks) {
  static int sms_of[64] = {0};
  static int resident_of[64][4] = {{0}};  // blocks per SM at 32..256 threads
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (sms_of[device] == 0) {
    err = cudaDeviceGetAttribute(&sms_of[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  const int sms = sms_of[device];
  int t = 256, slot = 3;
  while (t > 32 && (n + t - 1) / t < sms) {
    t /= 2;
    --slot;
  }
  if (resident_of[device][slot] == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident_of[device][slot],
                                                        segment_stats_kernel, t, 0);
    if (err != cudaSuccess) return err;
  }
  int64_t b = (n + t - 1) / t;
  const int64_t resident = static_cast<int64_t>(sms) * resident_of[device][slot];
  if (b > resident) b = resident;
  if (b < 1) b = 1;
  *threads = t;
  *blocks = b;
  return cudaSuccess;
}

}  // namespace

// out: sums, segment s's m floats at out + s * ld; with ts, ts_max
// [num_segments] int32 follows at out + num_segments * ld. The kernel
// zeroes output_words of it first. ld is m rounded up to a multiple of 4
// when m >= 4 (16-byte aligned rows for the vector atomic), else m; out
// must be 16-byte aligned.
extern "C" int kmamiz_segment_stats(const float* values, int m, int64_t n,
                                    const int32_t* seg, const int32_t* ts,
                                    int32_t num_segments, int ld, void* out,
                                    cudaStream_t stream) {
  float* sums = static_cast<float*>(out);
  int32_t* ts_max =
      ts == nullptr ? nullptr
                    : reinterpret_cast<int32_t*>(sums + static_cast<int64_t>(num_segments) * ld);
  int threads;
  int64_t blocks;
  cudaError_t err = launch_shape(n, &threads, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
#ifdef SEGMENT_STATS_ZERO_BY_MEMSET
  err = cudaMemsetAsync(out, 0, output_words(m, num_segments, ld, ts != nullptr) * 4, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  segment_stats_kernel<<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      values, m, n, seg, ts, num_segments, ld, sums, ts_max);
#else
  void* args[] = {&values, &m, &n, &seg, &ts, &num_segments, &ld, &sums, &ts_max};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(segment_stats_kernel),
                                    dim3(static_cast<unsigned>(blocks)), dim3(threads), args, 0,
                                    stream);
  if (err != cudaSuccess) return static_cast<int>(err);
#endif
  return static_cast<int>(cudaGetLastError());
}

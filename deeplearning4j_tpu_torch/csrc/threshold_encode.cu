// One-pass fixed-threshold encode (kernel K6) for Hopper.
//
// Replaces deeplearning4j_tpu/ops/compression.py::_encode_kernel (launched by
// _pallas_pack through one pallas_call).  Same function as the reference's
// plain twin _streaming_pack:
//   in   g f32[n], threshold t, capacity k;
//   out  int32[k]: sign(g_i) * (i + 1) for every i with |g_i| >= t, in
//        ascending i, then zeros.  The caller guarantees at most k selections;
//        any past k are dropped, as the plain version drops them.
// The output is bitwise the plain version's: the slot of a selected element is
// the number of selected elements before it, which fixes the order.
//
// Design.  On the TPU one block holds the whole bucket in VMEM and runs a
// cumsum over it, so the bucket was capped at 8 MB and needed n >= 1024.
// Here blocks run in parallel and in no order, so the running count across
// blocks takes three launches, with any n:
//   1. count:   each block counts the selections of its tile (2048 elements:
//               256 threads x 8 rounds, neighbouring threads on neighbouring
//               elements) into tile_counts[b];
//   2. scan:    one block turns tile_counts into exclusive tile_offsets and
//               writes the total count;
//   3. scatter: each block walks its tile again in the same rounds; in a
//               round a warp's selections come from __ballot_sync, an
//               element's place in its warp is __popc of the lanes below it,
//               and a warp's place in the round is the sum of the counts of
//               the warps before it (8 shared-memory counts); a running total
//               carries across rounds.  The selected element goes to
//               tile_offset + its place; then the blocks zero slots
//               [count, k).
// Bound on H100: bytes.  The function reads 4n bytes and writes 4k (k = n/16
// by default), 1.3 us for a 4 MiB bucket at 3.35 TB/s; this version reads g
// twice (steps 1 and 3).  A single pass with decoupled look-back is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRounds = 8;
constexpr int kTile = kThreads * kRounds;  // ENC_TILE in ops/compression.py
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool selected(const float* g, long long i, long long n, float t) {
  return i < n && fabsf(g[i]) >= t;
}

__global__ void __launch_bounds__(kThreads)
threshold_count_kernel(const float* __restrict__ g, long long n, float t,
                       int* __restrict__ tile_counts) {
  __shared__ int warp_counts[kWarps];
  const long long base = (long long)blockIdx.x * kTile;
  int c = 0;
  for (int r = 0; r < kRounds; ++r) c += selected(g, base + r * kThreads + threadIdx.x, n, t);
  c = __reduce_add_sync(kFull, c);
  if ((threadIdx.x & 31) == 0) warp_counts[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += warp_counts[w];
    tile_counts[blockIdx.x] = total;
  }
}

// One block of 1024 threads: exclusive scan of tile_counts in chunks of 1024.
__global__ void __launch_bounds__(1024)
threshold_scan_kernel(const int* __restrict__ tile_counts, int tiles,
                      int* __restrict__ tile_offsets, int* __restrict__ count) {
  __shared__ int warp_sums[32];
  __shared__ int carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < tiles; base += 1024) {
    const int i = base + threadIdx.x;
    const int v = i < tiles ? tile_counts[i] : 0;
    int x = v;  // inclusive scan within the warp
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {  // inclusive scan of the 32 warp totals
      int s = warp_sums[lane];
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, s, d);
        if (lane >= d) s += y;
      }
      warp_sums[lane] = s;
    }
    __syncthreads();
    const int before = carry + (warp > 0 ? warp_sums[warp - 1] : 0);
    if (i < tiles) tile_offsets[i] = before + x - v;
    __syncthreads();  // every thread has read carry
    if (threadIdx.x == 1023) carry = before + x;
    __syncthreads();
  }
  if (threadIdx.x == 0) *count = carry;
}

__global__ void __launch_bounds__(kThreads)
threshold_scatter_kernel(const float* __restrict__ g, long long n, float t, int k,
                         const int* __restrict__ tile_offsets, const int* __restrict__ count,
                         int* __restrict__ out) {
  __shared__ int warp_counts[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const long long base = (long long)blockIdx.x * kTile;
  long long running = tile_offsets[blockIdx.x];
  for (int r = 0; r < kRounds; ++r) {
    const long long i = base + r * kThreads + threadIdx.x;
    const float v = i < n ? g[i] : 0.0f;
    const bool sel = i < n && fabsf(v) >= t;
    const unsigned ballot = __ballot_sync(kFull, sel);
    if (lane == 0) warp_counts[warp] = __popc(ballot);
    __syncthreads();
    int warp_off = 0, round_total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_counts[w];
      if (w < warp) warp_off += c;
      round_total += c;
    }
    if (sel) {
      const long long slot = running + warp_off + __popc(ballot & below);
      if (slot < k) out[slot] = (v >= 0.0f ? 1 : -1) * (int)(i + 1);
    }
    running += round_total;
    __syncthreads();  // warp_counts is rewritten next round
  }
  // slots past the selections are zero
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long s = *count + (long long)blockIdx.x * kThreads + threadIdx.x; s < k; s += stride)
    out[s] = 0;
}

}  // namespace

// g f32[n] (contiguous, 1 <= n < 2^31 - 1), threshold t > 0, capacity k >= 1 ->
// out int32[k].  Scratch from the caller: tile_counts and tile_offsets int32[tiles]
// with tiles = ceil(n / 2048), count int32[1] (the number of selections).
// Returns 0, a CUDA error code, or -1 for arguments it does not take.
extern "C" int dl4j_threshold_encode(const void* g, long long n, float t, int k, void* out,
                                     void* tile_counts, void* tile_offsets, void* count,
                                     int tiles, void* stream) {
  if (n < 1 || n >= 2147483647LL || k < 1 || !(t > 0.0f) ||
      tiles != (int)((n + kTile - 1) / kTile))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gp = static_cast<const float*>(g);
  int* counts = static_cast<int*>(tile_counts);
  int* offsets = static_cast<int*>(tile_offsets);
  int* total = static_cast<int*>(count);
  threshold_count_kernel<<<tiles, kThreads, 0, s>>>(gp, n, t, counts);
  threshold_scan_kernel<<<1, 1024, 0, s>>>(counts, tiles, offsets, total);
  threshold_scatter_kernel<<<tiles, kThreads, 0, s>>>(gp, n, t, k, offsets, total,
                                                      static_cast<int*>(out));
  return (int)cudaGetLastError();
}

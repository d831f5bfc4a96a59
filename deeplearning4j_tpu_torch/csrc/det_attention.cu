// Row-deterministic attention for the decode program (kernel D1), Hopper.
//
// A repair with no Pallas counterpart: it replaces the broadcast-multiply and
// trailing-axis sums of deeplearning4j_tpu_torch/ops/kv_cache.py::
// det_attention_plain, which mirrors deeplearning4j_tpu/ops/kv_cache.py::
// det_attention (plain XLA there).  Same function: softmax(q.k^T / sqrt(d) +
// bias) . v over a key length L, bias additive (0 visible, NEG_INF masked).
//
// Design.  The decode contract is that a query row gives the same bits
// whether it is computed in a prefill (padded bucket, L keys), a decode step
// (B slots, L keys) or a re-encode (t rows, t keys).  So every row's
// reduction order depends on nothing but that row: one warp per (b, h, query
// row); each score's d-sum runs sequentially over d; lane j takes keys j,
// j+32, ... in ascending order; the max is combined by a shuffle butterfly
// (max is exact in any order); each lane sums exp(s - m) over its keys in
// ascending order and a fixed butterfly combines the lanes; for P.V each lane
// owns columns lane, lane+32, ... and adds keys 0..L-1 in order.  A masked
// key has s = NEG_INF exactly (|q.k| is absorbed), so exp(s - m) = 0.0 and it
// adds exact zeros: the bits do not change with the number of masked keys
// past a row's last visible one, nor with B or Tq.  Masked keys skip their
// dot product, and P.V stops after the row's last key with p != 0 (adding
// zeros changes nothing).
//
// Bound on H100: 4*d flops per visible (row, key) pair against reading q, k,
// v and the bias once, so the decode shapes are bound by bytes (a step reads
// the slots' whole K/V pages); this kernel re-reads K/V per row through L1/L2
// instead of sharing tiles between rows, which is what it trades for a
// per-row order.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;         // query rows per block
constexpr float NEG_LARGE = -1e30f;

__global__ void __launch_bounds__(WARPS * 32)
det_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ bias,
                     float* __restrict__ out, int B, int H, int Tq, int L, int d,
                     long long ks0, long long ks1, long long ks2,   // k/v strides (b, h, key)
                     long long bs0, long long bs1, long long bs2, long long bs3,
                     float scale) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + warp;
  if (row >= (long long)B * H * Tq) return;
  float* qs = smem + warp * (L + d);   // this row's q, then its L scores / weights
  float* ps = qs + d;
  const int t = (int)(row % Tq);
  const int h = (int)((row / Tq) % H);
  const int b = (int)(row / ((long long)Tq * H));
  const float* qr = q + row * d;
  const float* kb = k + b * ks0 + h * ks1;
  const float* vb = v + b * ks0 + h * ks1;
  const float* br = bias + b * bs0 + h * bs1 + t * bs2;

  for (int c = lane; c < d; c += 32) qs[c] = qr[c];
  __syncwarp();

  // scores, and this lane's max over its keys
  float mx = -INFINITY;
  for (int j = lane; j < L; j += 32) {
    const float bj = br[j * bs3];
    float x;
    if (bj <= NEG_LARGE / 2) {
      x = bj;                          // s * scale + bias rounds to bias here
    } else {
      const float* kr = kb + j * ks2;
      float s = 0.f;
      for (int c = 0; c < d; ++c) s = fmaf(qs[c], kr[c], s);
      x = s * scale + bj;
    }
    ps[j] = x;
    mx = fmaxf(mx, x);
  }
  #pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));

  // exp(s - m), summed per lane in ascending key order, then a fixed butterfly
  float sum = 0.f;
  int last = -1;                       // this lane's last key with a nonzero weight
  for (int j = lane; j < L; j += 32) {
    const float e = expf(ps[j] - mx);
    ps[j] = e;
    sum += e;
    if (e != 0.f) last = j;
  }
  #pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
    last = max(last, __shfl_xor_sync(0xffffffffu, last, off));
  }
  for (int j = lane; j < L; j += 32) ps[j] = ps[j] / sum;
  __syncwarp();

  // P.V: lane owns columns lane, lane+32, ...; keys in ascending order
  for (int c = lane; c < d; c += 32) {
    float acc = 0.f;
    for (int j = 0; j <= last; ++j) acc = fmaf(ps[j], vb[j * ks2 + c], acc);
    out[row * d + c] = acc;
  }
}

}  // namespace

// q [B,H,Tq,d] contiguous f32; k, v [B,H,L,d] f32 with strides (ks0, ks1, ks2,
// 1), the same for both; bias f32 addressed by strides (bs0..bs3) over
// [B,H,Tq,L] (0 for a broadcast axis); out [B,H,Tq,d] contiguous.
// Returns 0, a CUDA error code, or -1 for arguments it does not take.
extern "C" int dl4j_det_attention(const void* q, const void* k, const void* v,
                                  const void* bias, void* out, int B, int H, int Tq,
                                  int L, int d, long long ks0, long long ks1,
                                  long long ks2, long long bs0, long long bs1,
                                  long long bs2, long long bs3, float scale,
                                  void* stream) {
  if (B < 1 || H < 1 || Tq < 1 || L < 1 || d < 1) return -1;
  const size_t smem = (size_t)WARPS * (L + d) * sizeof(float);
  if (smem > 232448) return -1;
  if (smem > 48 * 1024) {
    const cudaError_t attr = cudaFuncSetAttribute(
        det_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return (int)attr;
  }
  const long long rows = (long long)B * H * Tq;
  const long long blocks = (rows + WARPS - 1) / WARPS;
  if (blocks > 2147483647LL) return -1;
  det_attention_kernel<<<(unsigned)blocks, WARPS * 32, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bias),
      static_cast<float*>(out), B, H, Tq, L, d, ks0, ks1, ks2, bs0, bs1, bs2, bs3, scale);
  return (int)cudaGetLastError();
}

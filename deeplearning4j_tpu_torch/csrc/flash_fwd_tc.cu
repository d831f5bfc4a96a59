// Flash-attention forward (kernel K1) for Hopper in bf16, on the tensor cores.
//
// Replaces deeplearning4j_tpu/ops/attention.py::_flash_kernel (launched by
// _flash_forward) for bf16 inputs; f32 inputs take the SIMT kernel in
// flash_fwd.cu.  Same function: O = softmax(q.k^T * scale + bias) . v and the
// per-row log-sum-exp, with an optional causal mask and an optional [B, S]
// key mask (1 = attend), f32 statistics, p rounded to bf16 before the P.V
// product (the reference's .astype, and flash_forward_plain), and the LSE
// sentinel +1e30 for rows that never saw a live key.
//
// Bound on H100: 4*B*H*T*S*D flops (about half when causal) on the bf16
// tensor cores (989 TFLOP/s) against ~2*(T+S)*B*H*D bf16 elements of traffic
// at 3.35 TB/s; at D 64 and T 1024 the two are within a small factor, so what
// decides the time is keeping the tensor cores fed: the SIMT kernel ran at
// ~3% of the bound.  Why mma.sync and not wgmma: at D 64 a warpgroup pipeline
// (TMA, wgmma, warp specialisation) saves a few hundredths of a ms a launch
// over mma.sync, against ~0.5 ms between either and the SIMT kernel, for far
// more risk.  The design (FlashAttention-2):
//   * a block of 4 warps owns 64 query rows of one (batch, head), 16 rows a
//     warp; Q is loaded once, by ldmatrix, into A fragments in registers;
//   * K/V tiles of 64 keys come by 16-byte cp.async copies into a two-stage
//     ring (the next tile in flight during this tile's math); rows are padded
//     by 16 bytes, so ldmatrix (K) and ldmatrix.trans (V) are free of bank
//     conflicts;
//   * S = Q.K^T by mma.sync m16n8k16 (bf16 in, f32 sums); the online max and
//     sum stay in registers, the max reduced over the 4 lanes that share a
//     row by shuffles, the sum kept per lane and reduced once at the end;
//     exponentials are ex2.approx of x*log2(e), as in the SIMT kernel;
//   * P never leaves registers: its C fragments, rounded to bf16, are the A
//     fragments of O += P.V;
//   * causal: tiles wholly above the diagonal are never loaded, masks are
//     computed only for tiles that need them, and the grid walks the query
//     tiles heaviest first.
// Ragged T and S are masked in the kernel; D <= 128 is zero-padded to 64 or
// 128; a D that is not a multiple of 8 (16 bytes) takes plain loads for the
// tiles instead of cp.async.

#include "flash_tiles.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 128;          // threads: 4 warps
constexpr int BQ = 64;           // query rows per block, 16 per warp
constexpr int BK = 64;           // keys per K/V tile
constexpr float NEG_LARGE = -1e30f;

template <int DP>
constexpr size_t smem_bytes() {
  return (size_t)(BQ + 4 * BK) * Tile<bf16, DP>::SP * sizeof(bf16);
}

template <int DP>
__global__ void __launch_bounds__(NT)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ kmask,
                    bf16* __restrict__ o, float* __restrict__ lse,
                    int H, int T_, int S, int D, float scale, int causal) {
  constexpr int SP = Tile<bf16, DP>::SP;
  constexpr int KC = DP / 16;    // 16-wide d chunks: Q's A fragments
  constexpr int ND = DP / 8;     // 8-wide d tiles of O
  constexpr int NS = BK / 8;     // 8-key tiles of S
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);     // [BQ][SP]
  bf16* Ks = Qs + BQ * SP;                           // [2][BK][SP]
  bf16* Vs = Ks + 2 * BK * SP;                       // [2][BK][SP]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest causal tiles first
  const int qw = q0 + 16 * warp;                     // this warp's first row
  const bf16* qb = q + (size_t)bh * T_ * D;
  const bf16* kb = k + (size_t)bh * S * D;
  const bf16* vb = v + (size_t)bh * S * D;
  const int* km = kmask ? kmask + (size_t)(bh / H) * S : nullptr;
  const bool vec = D % Tile<bf16, DP>::E == 0 &&
                   ((reinterpret_cast<size_t>(q) | reinterpret_cast<size_t>(k) |
                     reinterpret_cast<size_t>(v)) & 15) == 0;

  int n_kt = (S + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (q0 + BQ - 1) / BK + 1);  // skip tiles above the diagonal

  load_tile<bf16, DP, NT>(Qs, qb, BQ, q0, T_, D, vec);
  load_tile<bf16, DP, NT>(Ks, kb, BK, 0, S, D, vec);
  load_tile<bf16, DP, NT>(Vs, vb, BK, 0, S, D, vec);
  cp_commit();

  unsigned qf[KC][4];
  float acc[ND][4];
  float m[2] = {NEG_LARGE, NEG_LARGE}, l[2] = {0.f, 0.f};  // rows g, g + 8
  #pragma unroll
  for (int j = 0; j < ND; ++j)
    #pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int buf = kt & 1, k0 = kt * BK;
    if (kt + 1 < n_kt) {
      load_tile<bf16, DP, NT>(Ks + (buf ^ 1) * BK * SP, kb, BK, k0 + BK, S, D, vec);
      load_tile<bf16, DP, NT>(Vs + (buf ^ 1) * BK * SP, vb, BK, k0 + BK, S, D, vec);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {
      #pragma unroll
      for (int c = 0; c < KC; ++c)
        ldsm_x4(qf[c], Qs + (16 * warp + a_row(lane)) * SP + 16 * c + a_col(lane));
    }
    const bf16* Kt = Ks + buf * BK * SP;
    const bf16* Vt = Vs + buf * BK * SP;

    // S = Q . K^T: 16 rows x 64 keys a warp, C fragments s[key tile]
    float s[NS][4];
    #pragma unroll
    for (int j = 0; j < NS; ++j)
      #pragma unroll
      for (int r = 0; r < 4; ++r) s[j][r] = 0.f;
    #pragma unroll
    for (int c = 0; c < KC; ++c)
      #pragma unroll
      for (int jp = 0; jp < NS / 2; ++jp) {
        unsigned b[4];
        ldsm_x4(b, Kt + (16 * jp + b_row(lane)) * SP + 16 * c + b_col(lane));
        mma_bf16(s[2 * jp], qf[c], b[0], b[1]);
        mma_bf16(s[2 * jp + 1], qf[c], b[2], b[3]);
      }

    // scale and bias (causal part + key-mask part, as in the reference);
    // keys past S are no keys at all.  Only tiles that hold such a key, or
    // a key past this warp's first row, or a key mask, need the test.
    const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > qw) || km != nullptr;
    float mx[2] = {-INFINITY, -INFINITY};
    #pragma unroll
    for (int j = 0; j < NS; ++j)
      #pragma unroll
      for (int r = 0; r < 4; ++r) {
        float x = s[j][r] * scale;
        if (edge) {
          const int kj = k0 + 8 * j + 2 * t + (r & 1), qi = qw + g + 8 * (r >> 1);
          if (kj >= S) {
            x = -INFINITY;
          } else {
            float bias = 0.f;
            if (causal && qi < kj) bias = NEG_LARGE;
            if (km != nullptr && km[kj] == 0) bias += NEG_LARGE;
            x += bias;
          }
        }
        s[j][r] = x;
        mx[r >> 1] = fmaxf(mx[r >> 1], x);
      }
    float corr[2];
    #pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = fast_exp(m[h] - m_new);
      m[h] = m_new;
      l[h] *= corr[h];
    }
    #pragma unroll
    for (int j = 0; j < NS; ++j)
      #pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p = fast_exp(s[j][r] - m[r >> 1]);
        l[r >> 1] += p;            // this lane's part of the row sum, unrounded
        s[j][r] = p;
      }
    #pragma unroll
    for (int j = 0; j < ND; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }

    // O += P . V: P's C fragments, rounded to bf16, are the A fragments
    #pragma unroll
    for (int c = 0; c < BK / 16; ++c) {
      unsigned a[4];
      c_to_a(a, s[2 * c], s[2 * c + 1]);
      #pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        unsigned b[4];
        ldsm_x4_t(b, Vt + (16 * c + a_row(lane)) * SP + 16 * dp + a_col(lane));
        mma_bf16(acc[2 * dp], a, b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();             // buffer `buf` is free for the tile after next
  }

  float inv[2];
  #pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] = fmaxf(l[h], 1e-30f);
    inv[h] = 1.f / l[h];
  }
  store_c_rows<DP>(o + (size_t)bh * T_ * D, acc, inv, qw, T_, D, lane);
  if (t == 0) {
    #pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = qw + g + 8 * h;
      if (qi < T_)
        lse[(size_t)bh * T_ + qi] = (m[h] > NEG_LARGE / 2) ? m[h] + logf(l[h]) : 1e30f;
    }
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, const int* kmask, void* o,
           float* lse, int B, int H, int T_, int S, int D, float scale, int causal,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DP>();
  // once per template instance (a thread-safe static initialiser)
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(B * H, (T_ + BQ - 1) / BQ);
  flash_fwd_tc_kernel<DP><<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      kmask, static_cast<bf16*>(o), lse, H, T_, S, D, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B,H,T,D], k/v [B,H,S,D] contiguous bf16; kmask [B,S] int32 or null;
// o like q; lse [B,H,T] f32.  Returns 0, a CUDA error code, or -1 for
// arguments the kernel does not take.
extern "C" int dl4j_flash_fwd_tc(const void* q, const void* k, const void* v,
                                 const void* kmask, void* o, void* lse, int B, int H,
                                 int T_, int S, int D, float scale, int causal,
                                 void* stream) {
  if (B < 1 || H < 1 || T_ < 1 || S < 1 || D < 1 || D > 128) return -1;
  if ((long long)B * H > 2147483647LL || (T_ + BQ - 1) / BQ > 65535) return -1;
  const int* km = static_cast<const int*>(kmask);
  float* lo = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return D <= 64 ? launch<64>(q, k, v, km, o, lo, B, H, T_, S, D, scale, causal, st)
                 : launch<128>(q, k, v, km, o, lo, B, H, T_, S, D, scale, causal, st);
}

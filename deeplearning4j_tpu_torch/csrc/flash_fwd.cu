// Flash-attention forward (kernel K1) for Hopper, SIMT float32.
//
// Replaces deeplearning4j_tpu/ops/attention.py::_flash_kernel (launched by
// _flash_forward) for float32 inputs; bf16 inputs take the tensor-core
// kernel in flash_fwd_tc.cu (wgmma).  Same function: O = softmax(q.k^T *
// scale + bias) . v and the per-row log-sum-exp, with an optional causal mask
// and an optional [B, S] key mask (1 = attend), f32 statistics, and the LSE
// sentinel +1e30 for rows that never saw a live key.
//
// Bound on H100: the work is 4*B*H*T*S*D flops (about half that when causal)
// against ~2*(T+S)*B*H*D elements of traffic, so at the slice's shapes it is
// bound by operations.  The main path computes in f32 with TF32 off (parity
// with the plain version at 2e-5), so the limit is the f32 FFMA pipes (67
// TFLOP/s), and the design makes the FMAs, not shared memory or the copies,
// the limit:
//   * register blocking: a block of 128 threads owns 64 query rows of one
//     (batch, head); each thread holds a 4-row x 4-key score tile and a 4-row
//     x D/8-column output tile, fed by float4 shared loads along d (8 FMAs
//     per shared load for S, 10.7 for P.V at D 64), loops fully unrolled.
//     8 rows per thread (128-row blocks, 230 registers) ran slower: fewer,
//     longer blocks balance worse over 132 SMs;
//   * K/V tiles of 32 keys staged by 16-byte cp.async.cg copies,
//     double-buffered: the next tile is in flight during the current tile's
//     math, one __syncthreads per tile on each side.  Tiles are row-major with
//     rows padded by 16 bytes, so neither the copies nor the float4 reads of
//     eight consecutive key rows conflict on banks; nothing is transposed;
//   * P is written once into a per-row shared tile and read back as float4
//     by the same warp (a __syncwarp, not a block barrier);
//   * causal: tiles wholly above the diagonal are never loaded, and the grid
//     walks the query tiles heaviest first, so the long diagonal tiles do not
//     form the tail.
// The online-softmax statistics stay in registers (reduced over the 8 threads
// that share a row with shuffles); exponentials are ex2.approx of x*log2(e).
// Ragged T, S and D are masked in the kernel (D <= 256, zero-padded to 64,
// 128 or 256); a D that is not a multiple of 16 bytes takes plain loads for
// the tiles instead of cp.async.  At head widths 129-256 (DP 256) the same
// body holds a 4-row x 32-column output tile a thread (128 registers) and the
// tiles take 205 KB of shared memory: one block an SM.  The kernel is a template on the element type;
// only float is instantiated.

#include "flash_tiles.cuh"

namespace {

constexpr int BK = 32;           // keys per tile
constexpr int TR = 4;            // query rows per thread
constexpr int BQ = 16 * TR;      // query rows per block
constexpr int NT = 128;          // threads: 16 row groups x 8
constexpr int PS = BK + 8;       // row stride of the P tile (floats)
constexpr float NEG_LARGE = -1e30f;

template <typename T, int DP>
constexpr size_t smem_bytes() {
  return (size_t)(BQ * Tile<T, DP>::SP + 4 * BK * Tile<T, DP>::SP) * sizeof(T) +
         (size_t)BQ * PS * sizeof(float);
}

template <typename T, int DP>
__global__ void __launch_bounds__(NT, DP <= 128 ? 2 : 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ kmask,
                 T* __restrict__ o, float* __restrict__ lse,
                 int H, int T_, int S, int D, float scale, int causal) {
  constexpr int SP = Tile<T, DP>::SP;
  constexpr int NG = DP / 32;    // float4 column groups per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);           // [BQ][SP]
  T* Ks = Qs + BQ * SP;                              // [2][BK][SP]
  T* Vs = Ks + 2 * BK * SP;                          // [2][BK][SP]
  float* Ps = reinterpret_cast<float*>(Vs + 2 * BK * SP);   // [BQ][PS]

  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest causal tiles first
  const T* qb = q + (size_t)bh * T_ * D;
  const T* kb = k + (size_t)bh * S * D;
  const T* vb = v + (size_t)bh * S * D;
  const int* km = kmask ? kmask + (size_t)(bh / H) * S : nullptr;
  const bool vec = D % Tile<T, DP>::E == 0 &&
                   ((reinterpret_cast<size_t>(q) | reinterpret_cast<size_t>(k) |
                     reinterpret_cast<size_t>(v)) & 15) == 0;

  int n_kt = (S + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (q0 + BQ - 1) / BK + 1);  // skip tiles above the diagonal

  load_tile<T, DP, NT>(Qs, qb, BQ, q0, T_, D, vec);
  load_tile<T, DP, NT>(Ks, kb, BK, 0, S, D, vec);
  load_tile<T, DP, NT>(Vs, vb, BK, 0, S, D, vec);
  cp_commit();

  float m[TR], l[TR], acc[TR][4 * NG];
  #pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = NEG_LARGE;
    l[i] = 0.f;
    #pragma unroll
    for (int c = 0; c < 4 * NG; ++c) acc[i][c] = 0.f;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int buf = kt & 1, k0 = kt * BK;
    if (kt + 1 < n_kt) {
      load_tile<T, DP, NT>(Ks + (buf ^ 1) * BK * SP, kb, BK, k0 + BK, S, D, vec);
      load_tile<T, DP, NT>(Vs + (buf ^ 1) * BK * SP, vb, BK, k0 + BK, S, D, vec);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const T* Kt = Ks + buf * BK * SP;
    const T* Vt = Vs + buf * BK * SP;

    float s[TR][4];
    #pragma unroll
    for (int i = 0; i < TR; ++i)
      #pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    #pragma unroll
    for (int c = 0; c < DP; c += 4) {
      float4 qv[TR], kv[4];
      #pragma unroll
      for (int i = 0; i < TR; ++i) qv[i] = ld4(Qs + (ty + 16 * i) * SP + c);
      #pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ld4(Kt + (tx + 8 * j) * SP + c);
      #pragma unroll
      for (int i = 0; i < TR; ++i)
        #pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    int kmv[4];
    #pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kj = k0 + tx + 8 * j;
      kmv[j] = (km != nullptr && kj < S) ? km[kj] : 1;
    }
    #pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int row = ty + 16 * i, qi = q0 + row;
      float x[4], mx = -INFINITY;
      #pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 8 * j;
        if (kj >= S) {
          x[j] = -INFINITY;      // past the ragged edge: no key at all
        } else {
          float b = 0.f;         // bias = causal part + key-mask part, as in the reference
          if (causal && qi < kj) b = NEG_LARGE;
          if (kmv[j] == 0) b += NEG_LARGE;
          x[j] = s[i][j] * scale + b;
        }
        mx = fmaxf(mx, x[j]);
      }
      #pragma unroll
      for (int off = 4; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = fast_exp(m[i] - m_new);
      float ps = 0.f;
      #pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = fast_exp(x[j] - m_new);
        ps += p;
        Ps[row * PS + tx + 8 * j] = round_to<T>(p);
      }
      #pragma unroll
      for (int off = 4; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * corr + ps;
      m[i] = m_new;
      #pragma unroll
      for (int c = 0; c < 4 * NG; ++c) acc[i][c] *= corr;
    }
    __syncwarp();                // P rows ty + 16i are this warp's own

    #pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pf[TR];
      #pragma unroll
      for (int i = 0; i < TR; ++i)
        pf[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * PS + kk);
      #pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float4 vv[NG];
        #pragma unroll
        for (int g = 0; g < NG; ++g) vv[g] = ld4(Vt + (kk + jj) * SP + g * 32 + tx * 4);
        #pragma unroll
        for (int i = 0; i < TR; ++i) {
          const float p = jj == 0 ? pf[i].x : jj == 1 ? pf[i].y : jj == 2 ? pf[i].z : pf[i].w;
          #pragma unroll
          for (int g = 0; g < NG; ++g) {
            acc[i][4 * g + 0] = fmaf(p, vv[g].x, acc[i][4 * g + 0]);
            acc[i][4 * g + 1] = fmaf(p, vv[g].y, acc[i][4 * g + 1]);
            acc[i][4 * g + 2] = fmaf(p, vv[g].z, acc[i][4 * g + 2]);
            acc[i][4 * g + 3] = fmaf(p, vv[g].w, acc[i][4 * g + 3]);
          }
        }
      }
    }
    __syncthreads();             // buffer `buf` and P are free for the next tiles
  }

  #pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= T_) continue;
    const float ls = fmaxf(l[i], 1e-30f);
    T* orow = o + ((size_t)bh * T_ + qi) * D;
    #pragma unroll
    for (int g = 0; g < NG; ++g)
      #pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = g * 32 + tx * 4 + c;
        if (d < D) orow[d] = from_f32<T>(acc[i][4 * g + c] / ls);
      }
    if (tx == 0)
      lse[(size_t)bh * T_ + qi] = (m[i] > NEG_LARGE / 2) ? m[i] + logf(ls) : 1e30f;
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, const int* kmask,
           void* o, float* lse, int B, int H, int T_, int S, int D,
           float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, DP>();
  // once per template instance (a thread-safe static initialiser)
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(B * H, (T_ + BQ - 1) / BQ);
  flash_fwd_kernel<T, DP><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      kmask, static_cast<T*>(o), lse, H, T_, S, D, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B,H,T,D], k/v [B,H,S,D] contiguous f32, D <= 256; kmask [B,S] int32 or null;
// o like q; lse [B,H,T] f32.
// Returns 0, a CUDA error code, or -1 for arguments the kernel does not take.
extern "C" int dl4j_flash_fwd(const void* q, const void* k, const void* v,
                              const void* kmask, void* o, void* lse,
                              int B, int H, int T_, int S, int D, float scale,
                              int causal, void* stream) {
  if (B < 1 || H < 1 || T_ < 1 || S < 1 || D < 1 || D > 256) return -1;
  if ((long long)B * H > 2147483647LL || (T_ + BQ - 1) / BQ > 65535) return -1;
  const int* km = static_cast<const int*>(kmask);
  float* lo = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64) return launch<float, 64>(q, k, v, km, o, lo, B, H, T_, S, D, scale, causal, st);
  if (D <= 128) return launch<float, 128>(q, k, v, km, o, lo, B, H, T_, S, D, scale, causal, st);
  return launch<float, 256>(q, k, v, km, o, lo, B, H, T_, S, D, scale, causal, st);
}

// Flash-attention backward (kernels K2 and K3) for Hopper, SIMT float32.
//
// K2 replaces deeplearning4j_tpu/ops/attention.py::_flash_bwd_dkdv_kernel and
// K3 replaces ::_flash_bwd_dq_kernel (both built on ::_bwd_tile, launched by
// ::_flash_backward) for f32 inputs; bf16 inputs take the tensor-core
// kernels in flash_bwd_tc.cu.  Same function: with s = q.k^T * scale + bias,
// p = exp(s - lse) rebuilt from the forward's saved log-sum-exp, dp = g.v^T
// and ds = p * (dp - delta) * scale (zeroed where bias <= NEG_INF / 2), K2
// gives dV = p^T.g and dK = ds^T.q, and K3 gives dQ = ds.k.  delta =
// rowsum(g * o) is computed outside, in f32, as in the reference.  The bias
// is the causal part plus the key-mask part, as in K1, and a row with no live
// key carries the LSE sentinel +1e30, so its p and every gradient it feeds are
// exactly 0.  p and ds take the input dtype before the products that read
// them; all sums are f32.  Ragged T and S (S != T too) are masked in the
// kernels; D <= 256, zero-padded to 64, 128 or 256.  At head widths 129-256
// (DP 256) a block owns one 128-wide half of its output columns (blockIdx.z:
// dK and dV, or dQ), so its accumulators stay those of DP 128 (the 4 x 32
// tile of dK and dV took every register at DP 128), while s and dp still
// sum over all 256 columns: the two halves' blocks both compute them, 1.5x
// K2's products and 1.7x K3's.  K2's tiles take 215 KB of shared memory, K3's
// 205 KB: one block an SM.
//
// Bound on H100: per live (query, key) pair K2 does four products of 2*D
// flops (s, dp, dV, dK: 8*D) and K3 three (s, dp, dQ: 6*D), against ~(4*T +
// 4*S)*D elements of traffic per batch*head, so at the training shapes both
// are bound by operations: the f32 FFMA pipes at 67 TFLOP/s (TF32 off, for
// parity with the plain version at 2e-5).  What stands between the kernels
// and that bound is the shared-memory loads that feed the FMAs, the
// instructions around them, and too few warps to hide their latency.  The
// design, as K1's (flash_fwd.cu):
//   * a block of 128 threads (16 row groups x 8) owns 64 rows of one (batch,
//     head) -- K2 64 keys with K and V resident, K3 64 query rows with Q and
//     G resident -- and streams tiles of 32 rows of the other side: K2 the
//     query tiles (Q, G, lse, delta), K3 the key tiles (K, V);
//   * each score-sized product (s, dp; K2 computes them transposed, keys x
//     queries) is a 4 x 4 register tile per thread fed by float4 loads along
//     d on both sides: 8 FMAs per shared load;
//   * p / ds go once into a per-row shared tile whose rows are the writing
//     warp's own, are read back as float4 after a __syncwarp, and feed the
//     output products: each thread accumulates 4 rows x D/8 columns (K2:
//     of both dK and dV, for exactly the keys whose p^T / ds^T it wrote;
//     K3: of dQ against row-major K): 10.7 FMAs per shared load at D 64;
//   * every tile is row-major with rows padded by 16 bytes, so the copies,
//     the float4 reads of eight consecutive rows and the float4 reads along
//     d are free of bank conflicts; nothing is transposed or staged twice;
//   * the streamed tiles are single-buffered and come by cp.async (16 bytes
//     a copy, 4 for lse and delta) in two copy groups, each issued as soon as
//     every warp is done with its buffer and waited for a product later (K3:
//     V after dp, K after dQ; K2: G, lse, delta after dV, Q after dK), so a
//     copy overlaps a product without a second buffer.  That keeps a block
//     at 61 KB (K3) / 71 KB (K2) of shared memory at D <= 64, so three
//     blocks (12 warps, 168 registers a thread) share an SM instead of two;
//   * causal: tiles wholly above the diagonal are never loaded, and the grid
//     (batch*head on x) walks the heaviest tiles first -- K2's lowest key
//     tiles, K3's highest query tiles -- so they do not form the tail.
// Exponentials are ex2.approx of x*log2(e), as in K1.  The kernels are
// templates on the element type; only float is instantiated.
//
// Why two kernels and no atomics: every gradient element is summed by one
// thread in a fixed order, so a launch is bitwise the last one on the same
// inputs, which the port's bit gates rest on (data-parallel replicas stay
// bitwise equal, an A/B of two exchanges compares bits).  A fused kernel
// that adds dQ with float atomics would break that; a deterministic fused
// one (dQ partials per key tile, reduced in a fixed order) would write and
// read back ~T*S/32*D*4 bytes of scratch per batch*head (~210 MB at [8, 12,
// 1024, 64], ~0.13 ms at 3.35 TB/s), most of what sharing s and dp between
// the two would save.  So K2 owns a key tile and K3 a query tile, as in the
// reference.

#include "flash_tiles.cuh"

namespace {

constexpr int NT = 128;          // threads: 16 row groups x 8
constexpr int BM = 64;           // rows a block owns: K2 keys, K3 query rows
constexpr int BN = 32;           // rows of a streamed tile: K2 queries, K3 keys
constexpr int KJ = BN / 8;       // streamed rows per thread in a score tile: tx + 8 j
constexpr int PS = BN + 8;       // row stride of the p / ds tiles (floats)

// acc[i][j] = sum_d A[ty + 16 i][d] * B[tx + 8 j][d] over two row-major
// tiles of row stride SP, by float4 loads along d on both sides
template <typename T, int DP>
__device__ __forceinline__ void dot_tile(float acc[4][KJ], const T* A, const T* B, int ty,
                                         int tx) {
  constexpr int SP = Tile<T, DP>::SP;
  #pragma unroll
  for (int i = 0; i < 4; ++i)
    #pragma unroll
    for (int j = 0; j < KJ; ++j) acc[i][j] = 0.f;
  #pragma unroll 4
  for (int c = 0; c < DP; c += 4) {
    float4 a[4], b[KJ];
    #pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = ld4(A + (ty + 16 * i) * SP + c);
    #pragma unroll
    for (int j = 0; j < KJ; ++j) b[j] = ld4(B + (tx + 8 * j) * SP + c);
    #pragma unroll
    for (int i = 0; i < 4; ++i)
      #pragma unroll
      for (int j = 0; j < KJ; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
  }
}

// output columns a block owns: all of DP up to 128; at DP 256 one 128-wide
// half, the first at out_col0 (blockIdx.z picks the half)
template <int DP> __host__ __device__ constexpr int out_cols() { return DP <= 128 ? DP : 128; }
template <int DP> __device__ __forceinline__ int out_col0() {
  return DP <= 128 ? 0 : (int)blockIdx.z * 128;
}

// acc[i][4 g + c] += sum_n W[ty + 16 i][n] * X[n][c0 + 32 g + 4 tx + c] over
// the BN rows n of a streamed tile: W a p / ds tile (stride PS), X row-major,
// c0 this block's first output column
template <typename T, int DP>
__device__ __forceinline__ void acc_tile(float (*acc)[out_cols<DP>() / 8], const float* W,
                                         const T* X, int ty, int tx) {
  constexpr int SP = Tile<T, DP>::SP, NG = out_cols<DP>() / 32;
  X += out_col0<DP>();
  #pragma unroll 2
  for (int n = 0; n < BN; n += 4) {
    float4 w[4];
    #pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = *reinterpret_cast<const float4*>(W + (ty + 16 * i) * PS + n);
    #pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float4 x[NG];
      #pragma unroll
      for (int g = 0; g < NG; ++g) x[g] = ld4(X + (n + jj) * SP + 32 * g + 4 * tx);
      #pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = jj == 0 ? w[i].x : jj == 1 ? w[i].y : jj == 2 ? w[i].z : w[i].w;
        #pragma unroll
        for (int g = 0; g < NG; ++g) {
          acc[i][4 * g + 0] = fmaf(p, x[g].x, acc[i][4 * g + 0]);
          acc[i][4 * g + 1] = fmaf(p, x[g].y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(p, x[g].z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(p, x[g].w, acc[i][4 * g + 3]);
        }
      }
    }
  }
}

// whether the bias blocks (query qi, key kj): its causal part or its
// key-mask part is NEG_INF there.  A blocked pair has p = exp(<= -1e30) = 0
// and ds = 0, and a live one a bias of 0, so the kernels compute p and ds
// only for live pairs, from s * scale - lse
__device__ __forceinline__ bool blocked(int qi, int kj, int causal, int kmv) {
  return (causal && qi < kj) || kmv == 0;
}

// rows [r0, r0 + BM) of the 4 x out_cols/8 accumulator tile of every thread
// into out [n, D] from this block's first output column, rows past n and
// columns past D dropped
template <typename T, int DP>
__device__ __forceinline__ void store_rows(T* out, const float (*acc)[out_cols<DP>() / 8],
                                           int r0, int n, int D, int ty, int tx) {
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= n) continue;
    #pragma unroll
    for (int g = 0; g < out_cols<DP>() / 32; ++g)
      #pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = out_col0<DP>() + 32 * g + 4 * tx + c;
        if (d < D) out[(size_t)r * D + d] = from_f32<T>(acc[i][4 * g + c]);
      }
  }
}

template <typename T>
__device__ __forceinline__ bool vec_ok(int D, const T* a, const T* b, const T* c, const T* d) {
  return D % Tile<T, 64>::E == 0 &&
         ((reinterpret_cast<size_t>(a) | reinterpret_cast<size_t>(b) |
           reinterpret_cast<size_t>(c) | reinterpret_cast<size_t>(d)) & 15) == 0;
}

// two resident BM-row tiles and two streamed BN-row tiles, then the f32
// p / ds tiles (K2: p^T and ds^T, lse and delta; K3: ds)
template <typename T, int DP, bool DKDV>
constexpr size_t smem_bytes() {
  return (size_t)(2 * BM + 2 * BN) * Tile<T, DP>::SP * sizeof(T) +
         (size_t)(DKDV ? 2 * BM * PS + 2 * BN : BM * PS) * sizeof(float);
}

template <typename T, int DP>
// three blocks an SM at D <= 64 (168 registers), two at D 128 (255), one at
// D 256 (shared memory)
__global__ void __launch_bounds__(NT, DP <= 64 ? 3 : DP <= 128 ? 2 : 1)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ g,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      const int* __restrict__ kmask, T* __restrict__ dk,
                      T* __restrict__ dv, int H, int T_, int S, int D, float scale,
                      int causal) {
  constexpr int SP = Tile<T, DP>::SP, NC = out_cols<DP>() / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);           // [BM][SP]  this block's keys
  T* Vs = Ks + BM * SP;                              // [BM][SP]
  T* Qs = Vs + BM * SP;                              // [BN][SP]  the streamed queries
  T* Gs = Qs + BN * SP;                              // [BN][SP]
  float* Ps = reinterpret_cast<float*>(Gs + BN * SP);       // [BM][PS]  p^T (keys x queries)
  float* Dss = Ps + BM * PS;                         // [BM][PS]  ds^T
  float* Ls = Dss + BM * PS;                         // [BN]  lse of the queries
  float* Dl = Ls + BN;                               // [BN]  delta of the queries

  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BM;   // lowest key tiles, the heaviest when causal, first
  const size_t qoff = (size_t)bh * T_ * D, koff = (size_t)bh * S * D;
  const T* qb = q + qoff;
  const T* gb = g + qoff;
  const float* lb = lse + (size_t)bh * T_;
  const float* db = delta + (size_t)bh * T_;
  const int* km = kmask ? kmask + (size_t)(bh / H) * S : nullptr;
  const bool vec = vec_ok(D, q, k, v, g);

  const int n_qt = (T_ + BN - 1) / BN;
  const int qt0 = causal ? k0 / BN : 0;   // query tiles wholly above the diagonal see no key here

  // G, lse and delta of query tile r0 in one copy group, Q in the next: G
  // is free (after dV) a product before Q (after dK), and the next tile
  // reads G first (dp^T) and Q second (s^T), so each copy overlaps a product
  auto load_g = [&](int r0) {
    load_tile<T, DP, NT>(Gs, gb, BN, r0, T_, D, vec);
    for (int e = tid; e < BN; e += NT) {
      const bool ok = r0 + e < T_;
      cp4(Ls + e, lb + (ok ? r0 + e : 0), ok);
      cp4(Dl + e, db + (ok ? r0 + e : 0), ok);
    }
    cp_commit();
  };
  auto load_q = [&](int r0) {
    load_tile<T, DP, NT>(Qs, qb, BN, r0, T_, D, vec);
    cp_commit();
  };
  if (qt0 < n_qt) {                 // else no query sees these keys: dK = dV = 0
    load_tile<T, DP, NT>(Ks, k + koff, BM, k0, S, D, vec);
    load_tile<T, DP, NT>(Vs, v + koff, BM, k0, S, D, vec);
    load_g(qt0 * BN);
    load_q(qt0 * BN);
  }

  int kmv[4];                       // the key mask of this thread's keys
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty + 16 * i;
    kmv[i] = (km != nullptr && kj < S) ? km[kj] : 1;
  }
  float adk[4][NC], adv[4][NC];     // keys ty + 16 i, columns c0 + 32 g + 4 tx + c
  #pragma unroll
  for (int i = 0; i < 4; ++i)
    #pragma unroll
    for (int c = 0; c < NC; ++c) adk[i][c] = adv[i][c] = 0.f;

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * BN;
    const bool more = qt + 1 < n_qt;
    cp_wait<1>();                   // K, V, G, lse, delta landed; Q may be in flight
    __syncthreads();
    float s[4][KJ], dp[4][KJ];      // transposed: key ty + 16 i, query tx + 8 j
    dot_tile<T, DP>(dp, Vs, Gs, ty, tx);
    cp_wait<0>();
    __syncthreads();                // Q landed
    dot_tile<T, DP>(s, Ks, Qs, ty, tx);
    #pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const int col = tx + 8 * j, qi = q0 + col;
      const float ls = Ls[col], dl = Dl[col];
      #pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = ty + 16 * i;
        float p = 0.f, ds = 0.f;
        if (qi < T_ && !blocked(qi, k0 + row, causal, kmv[i])) {
          p = fast_exp(s[i][j] * scale - ls);
          ds = p * (dp[i][j] - dl) * scale;
        }
        Ps[row * PS + col] = round_to<T>(p);
        Dss[row * PS + col] = round_to<T>(ds);
      }
    }
    __syncwarp();                   // p^T / ds^T rows ty + 16 i are this warp's own
    acc_tile<T, DP>(adv, Ps, Gs, ty, tx);
    __syncthreads();                // every warp is done with G, lse, delta
    if (more) load_g(q0 + BN);
    acc_tile<T, DP>(adk, Dss, Qs, ty, tx);
    __syncthreads();                // every warp is done with Q
    if (more) load_q(q0 + BN);
  }

  store_rows<T, DP>(dk + koff, adk, k0, S, D, ty, tx);
  store_rows<T, DP>(dv + koff, adv, k0, S, D, ty, tx);
}

template <typename T, int DP>
__global__ void __launch_bounds__(NT, DP <= 64 ? 3 : DP <= 128 ? 2 : 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ g,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const int* __restrict__ kmask, T* __restrict__ dq, int H, int T_,
                    int S, int D, float scale, int causal) {
  constexpr int SP = Tile<T, DP>::SP, NC = out_cols<DP>() / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);           // [BM][SP]  this block's query rows
  T* Gs = Qs + BM * SP;                              // [BM][SP]
  T* Ks = Gs + BM * SP;                              // [BN][SP]  the streamed keys
  T* Vs = Ks + BN * SP;                              // [BN][SP]
  float* Ds = reinterpret_cast<float*>(Vs + BN * SP);       // [BM][PS]  ds

  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // heaviest causal tiles first
  const size_t qoff = (size_t)bh * T_ * D, koff = (size_t)bh * S * D;
  const T* kb = k + koff;
  const T* vb = v + koff;
  const int* km = kmask ? kmask + (size_t)(bh / H) * S : nullptr;
  const bool vec = vec_ok(D, q, k, v, g);

  int n_kt = (S + BN - 1) / BN;
  if (causal) n_kt = min(n_kt, (q0 + BM - 1) / BN + 1);  // skip tiles above the diagonal

  // V of key tile r0 in one copy group, K in the next: V is free (after dp)
  // two products before K (after dQ), and the next tile reads V first (dp)
  // and K second (s), so each copy overlaps a product
  load_tile<T, DP, NT>(Qs, q + qoff, BM, q0, T_, D, vec);
  load_tile<T, DP, NT>(Gs, g + qoff, BM, q0, T_, D, vec);
  load_tile<T, DP, NT>(Vs, vb, BN, 0, S, D, vec);
  cp_commit();
  load_tile<T, DP, NT>(Ks, kb, BN, 0, S, D, vec);
  cp_commit();

  float ls[4], dl[4], acc[4][NC];   // rows ty + 16 i, columns 32 g + 4 tx + c
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    ls[i] = qi < T_ ? lse[(size_t)bh * T_ + qi] : 0.f;
    dl[i] = qi < T_ ? delta[(size_t)bh * T_ + qi] : 0.f;
    #pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BN;
    const bool more = kt + 1 < n_kt;
    cp_wait<1>();                   // Q, G, V landed; K may be in flight
    __syncthreads();
    int kmv[KJ];
    #pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const int kj = k0 + tx + 8 * j;
      kmv[j] = (km != nullptr && kj < S) ? km[kj] : 1;
    }
    float s[4][KJ], dp[4][KJ];      // query row ty + 16 i, key tx + 8 j
    dot_tile<T, DP>(dp, Gs, Vs, ty, tx);
    __syncthreads();                // every warp is done with V
    if (more) {
      load_tile<T, DP, NT>(Vs, vb, BN, k0 + BN, S, D, vec);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();                // K landed
    dot_tile<T, DP>(s, Qs, Ks, ty, tx);
    #pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
      #pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int kj = k0 + tx + 8 * j;
        float ds = 0.f;
        if (kj < S && !blocked(q0 + row, kj, causal, kmv[j]))
          ds = fast_exp(s[i][j] * scale - ls[i]) * (dp[i][j] - dl[i]) * scale;
        Ds[row * PS + tx + 8 * j] = round_to<T>(ds);
      }
    }
    __syncwarp();                   // ds rows ty + 16 i are this warp's own
    acc_tile<T, DP>(acc, Ds, Ks, ty, tx);
    __syncthreads();                // every warp is done with K
    if (more) {
      load_tile<T, DP, NT>(Ks, kb, BN, k0 + BN, S, D, vec);
      cp_commit();
    }
  }

  store_rows<T, DP>(dq + qoff, acc, q0, T_, D, ty, tx);
}

template <typename T, int DP>
int launch_dkdv(const void* q, const void* k, const void* v, const void* g,
                const float* lse, const float* delta, const int* kmask, void* dk,
                void* dv, int B, int H, int T_, int S, int D, float scale, int causal,
                cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, DP, true>();
  // once per template instance (a thread-safe static initialiser)
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(B * H, (S + BM - 1) / BM, DP / out_cols<DP>());
  flash_bwd_dkdv_kernel<T, DP><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), lse, delta, kmask, static_cast<T*>(dk),
      static_cast<T*>(dv), H, T_, S, D, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int launch_dq(const void* q, const void* k, const void* v, const void* g,
              const float* lse, const float* delta, const int* kmask, void* dq, int B,
              int H, int T_, int S, int D, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, DP, false>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(B * H, (T_ + BM - 1) / BM, DP / out_cols<DP>());
  flash_bwd_dq_kernel<T, DP><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), lse, delta, kmask, static_cast<T*>(dq), H, T_, S, D,
      scale, causal);
  return (int)cudaGetLastError();
}

bool bad_args(int B, int H, int T_, int S, int D) {
  return B < 1 || H < 1 || T_ < 1 || S < 1 || D < 1 || D > 256 ||
         (long long)B * H > 2147483647LL || (T_ + BM - 1) / BM > 65535 ||
         (S + BM - 1) / BM > 65535;
}

}  // namespace

// q, g, dq [B,H,T,D]; k, v, dk, dv [B,H,S,D]; all contiguous f32; lse, delta
// [B,H,T] f32; kmask [B,S] int32 or null.  Each returns 0, a CUDA error code,
// or -1 for arguments it does not take.
extern "C" int dl4j_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                                   const void* g, const void* lse, const void* delta,
                                   const void* kmask, void* dk, void* dv, int B, int H,
                                   int T_, int S, int D, float scale, int causal,
                                   void* stream) {
  if (bad_args(B, H, T_, S, D)) return -1;
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int* km = static_cast<const int*>(kmask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return launch_dkdv<float, 64>(q, k, v, g, l, dl, km, dk, dv, B, H, T_, S, D, scale, causal, st);
  if (D <= 128)
    return launch_dkdv<float, 128>(q, k, v, g, l, dl, km, dk, dv, B, H, T_, S, D, scale, causal, st);
  return launch_dkdv<float, 256>(q, k, v, g, l, dl, km, dk, dv, B, H, T_, S, D, scale, causal, st);
}

extern "C" int dl4j_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* g, const void* lse, const void* delta,
                                 const void* kmask, void* dq, int B, int H, int T_, int S,
                                 int D, float scale, int causal, void* stream) {
  if (bad_args(B, H, T_, S, D)) return -1;
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int* km = static_cast<const int*>(kmask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return launch_dq<float, 64>(q, k, v, g, l, dl, km, dq, B, H, T_, S, D, scale, causal, st);
  if (D <= 128)
    return launch_dq<float, 128>(q, k, v, g, l, dl, km, dq, B, H, T_, S, D, scale, causal, st);
  return launch_dq<float, 256>(q, k, v, g, l, dl, km, dq, B, H, T_, S, D, scale, causal, st);
}

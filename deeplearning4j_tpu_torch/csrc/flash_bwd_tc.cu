// Flash-attention backward for Hopper in bf16, on the tensor cores: dK/dV
// (kernel K2) and dQ (kernel K3).
//
// K2 replaces deeplearning4j_tpu/ops/attention.py::_flash_bwd_dkdv_kernel and
// K3 replaces ::_flash_bwd_dq_kernel (both built on ::_bwd_tile, launched by
// ::_flash_backward) for bf16 inputs; f32 inputs take the SIMT kernels in
// flash_bwd.cu.  Same function: with s = q.k^T * scale + bias, p = exp(s -
// lse) rebuilt from the forward's saved log-sum-exp, dp = g.v^T and ds = p *
// (dp - delta) * scale (zeroed where the bias blocks), dV = p^T.g, dK =
// ds^T.q and dQ = ds.k.  delta = rowsum(g * o) is computed outside, in f32.
// p and ds are rounded to bf16 before the products that read them; every sum
// is f32.  A row with the LSE sentinel +1e30 has p = 0 and feeds no gradient
// (its dQ is exactly 0).
//
// Bound on H100: per live (query, key) pair K2 does four products of 2*D
// flops (s, dp, dV, dK) and K3 three (s, dp, dQ) on the bf16 tensor cores
// (989 TFLOP/s), against ~(4*T + 4*S)*D bf16 elements of traffic per
// batch*head at 3.35 TB/s; at D 64 and T 1024 the two are within a small
// factor, so the work is keeping the tensor cores fed (the SIMT kernels ran
// at ~3% of the bound).  mma.sync, not wgmma, for the reason given in
// flash_fwd_tc.cu.  K2's design:
//   * a block of 4 warps owns 64 keys of one (batch, head), 16 keys a warp,
//     with K and V resident in shared memory; it streams the query tiles (Q,
//     G, lse, delta; 64 queries at D <= 64, 32 at D 128, where the
//     accumulators take twice the registers) through a two-stage cp.async
//     ring, the next tile in flight during this tile's math;
//   * S^T = K.Q^T and dP^T = V.G^T by mma.sync m16n8k16: K and V rows are
//     the A fragments (ldmatrix), Q and G rows the B fragments (ldmatrix);
//   * p^T and ds^T are computed in those C fragments and, rounded to bf16,
//     are the A fragments of dV += p^T.G and dK += ds^T.Q, whose B fragments
//     come by ldmatrix.trans of the same Q and G tiles: nothing of p or ds
//     goes through shared memory;
//   * causal: query tiles wholly above the diagonal are never loaded, masks
//     are computed only for tiles that need them, and the grid walks the
//     heaviest (lowest) key tiles first.
// K3's design is K1's (flash_fwd_tc.cu) with two score products:
//   * a block of 4 warps owns 64 query rows of one (batch, head), 16 a warp;
//     Q and G are loaded once, by ldmatrix, into A fragments kept in
//     registers, and lse and delta of the lane's two rows in registers;
//   * K and V tiles (64 keys at D <= 64, 32 at D 128, where Q's and G's
//     fragments and the dQ accumulators take twice the registers) stream
//     through a two-stage cp.async ring;
//   * S = Q.K^T and dP = G.V^T by mma.sync, K and V rows the B fragments
//     (ldmatrix); ds is computed in the C fragments with K2's expression for
//     p, so both kernels rebuild the same p; rounded to bf16, ds is the A
//     fragment of dQ += dS.K, whose B fragments come by ldmatrix.trans of
//     the same K tile (so a stage is refilled only after that product);
//   * causal: key tiles wholly above the diagonal are never loaded, masks
//     are computed only for tiles that need them, and the grid walks the
//     heaviest (highest) query tiles first.
// Both: rows padded by 16 bytes, so ldmatrix and ldmatrix.trans are free of
// bank conflicts; ragged T and S masked in the kernel (zero-filled copies,
// guarded stores); D <= 128 zero-padded to 64 or 128, a D that is not a
// multiple of 8 taking plain loads for the tiles.
// No atomics: each dK, dV and dQ element is summed by one thread (its lane of
// one warp's mma accumulators) in a fixed order, so a launch is bitwise the
// last one on the same inputs, which the port's data-parallel bit gates rest
// on (see flash_bwd.cu).

#include "flash_tiles.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 128;          // threads: 4 warps
constexpr int BM = 64;           // rows a block owns, 16 a warp: K2 keys, K3 queries

template <int DP> struct Dims {
  static constexpr int SP = Tile<bf16, DP>::SP;
  static constexpr int BN = DP <= 64 ? 64 : 32;   // rows of a streamed tile: K2 queries, K3 keys
  // K2: K, V; two stages of Q, G; two stages of lse, delta
  static constexpr size_t SMEM_DKDV = (size_t)(2 * BM + 4 * BN) * SP * sizeof(bf16) +
                                      (size_t)4 * BN * sizeof(float);
  // K3: Q, G; two stages of K, V
  static constexpr size_t SMEM_DQ = (size_t)(2 * BM + 4 * BN) * SP * sizeof(bf16);
};

template <int DP>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ g,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const int* __restrict__ kmask, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, int H, int T_, int S, int D, float scale,
                         int causal) {
  constexpr int SP = Dims<DP>::SP, BN = Dims<DP>::BN;
  constexpr int KC = DP / 16;    // 16-wide d chunks of K, V (A fragments)
  constexpr int ND = DP / 8;     // 8-wide d tiles of dK, dV
  constexpr int NQ = BN / 8;     // 8-query tiles of S^T, dP^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);     // [BM][SP]  this block's keys
  bf16* Vs = Ks + BM * SP;                           // [BM][SP]
  bf16* Qs = Vs + BM * SP;                           // [2][BN][SP]  the streamed queries
  bf16* Gs = Qs + 2 * BN * SP;                       // [2][BN][SP]
  float* Ls = reinterpret_cast<float*>(Gs + 2 * BN * SP);   // [2][BN]  lse of the queries
  float* Dl = Ls + 2 * BN;                           // [2][BN]  delta of the queries

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BM;   // lowest key tiles, the heaviest when causal, first
  const int kw = k0 + 16 * warp;    // this warp's first key
  const size_t qoff = (size_t)bh * T_ * D, koff = (size_t)bh * S * D;
  const bf16* qb = q + qoff;
  const bf16* gb = g + qoff;
  const float* lb = lse + (size_t)bh * T_;
  const float* db = delta + (size_t)bh * T_;
  const int* km = kmask ? kmask + (size_t)(bh / H) * S : nullptr;
  const bool vec = D % Tile<bf16, DP>::E == 0 &&
                   ((reinterpret_cast<size_t>(q) | reinterpret_cast<size_t>(k) |
                     reinterpret_cast<size_t>(v) | reinterpret_cast<size_t>(g)) & 15) == 0;

  const int n_qt = (T_ + BN - 1) / BN;
  const int qt0 = causal ? k0 / BN : 0;   // query tiles wholly above the diagonal see no key here

  // Q, G, lse and delta of query tile qt into stage st, one copy group
  auto load_q = [&](int qt, int st) {
    const int r0 = qt * BN;
    load_tile<bf16, DP, NT>(Qs + st * BN * SP, qb, BN, r0, T_, D, vec);
    load_tile<bf16, DP, NT>(Gs + st * BN * SP, gb, BN, r0, T_, D, vec);
    for (int e = tid; e < BN; e += NT) {
      const bool ok = r0 + e < T_;
      cp4(Ls + st * BN + e, lb + (ok ? r0 + e : 0), ok);
      cp4(Dl + st * BN + e, db + (ok ? r0 + e : 0), ok);
    }
  };
  if (qt0 < n_qt) {                 // else no query sees these keys: dK = dV = 0
    load_tile<bf16, DP, NT>(Ks, k + koff, BM, k0, S, D, vec);
    load_tile<bf16, DP, NT>(Vs, v + koff, BM, k0, S, D, vec);
    load_q(qt0, 0);
    cp_commit();
  }

  int kmv[2];                       // the key mask of this lane's keys gq, gq + 8
  #pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kj = kw + gq + 8 * h;
    kmv[h] = (km != nullptr && kj < S) ? km[kj] : 1;
  }
  float adk[ND][4], adv[ND][4];     // keys kw + gq (+ 8), d tile j
  #pragma unroll
  for (int j = 0; j < ND; ++j)
    #pragma unroll
    for (int r = 0; r < 4; ++r) adk[j][r] = adv[j][r] = 0.f;

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int st = (qt - qt0) & 1, q0 = qt * BN;
    if (qt + 1 < n_qt) {
      load_q(qt + 1, st ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* Qt = Qs + st * BN * SP;
    const bf16* Gt = Gs + st * BN * SP;
    const float* Lt = Ls + st * BN;
    const float* Dt = Dl + st * BN;

    // S^T = K . Q^T and dP^T = V . G^T: 16 keys x BN queries a warp
    float sT[NQ][4], dpT[NQ][4];
    #pragma unroll
    for (int j = 0; j < NQ; ++j)
      #pragma unroll
      for (int r = 0; r < 4; ++r) sT[j][r] = dpT[j][r] = 0.f;
    #pragma unroll
    for (int c = 0; c < KC; ++c) {
      unsigned ka[4], va[4];
      ldsm_x4(ka, Ks + (16 * warp + a_row(lane)) * SP + 16 * c + a_col(lane));
      ldsm_x4(va, Vs + (16 * warp + a_row(lane)) * SP + 16 * c + a_col(lane));
      #pragma unroll
      for (int jp = 0; jp < NQ / 2; ++jp) {
        unsigned b[4];
        ldsm_x4(b, Qt + (16 * jp + b_row(lane)) * SP + 16 * c + b_col(lane));
        mma_bf16(sT[2 * jp], ka, b[0], b[1]);
        mma_bf16(sT[2 * jp + 1], ka, b[2], b[3]);
        ldsm_x4(b, Gt + (16 * jp + b_row(lane)) * SP + 16 * c + b_col(lane));
        mma_bf16(dpT[2 * jp], va, b[0], b[1]);
        mma_bf16(dpT[2 * jp + 1], va, b[2], b[3]);
      }
    }

    // p^T and ds^T in place, for live pairs only (a blocked pair has p = 0
    // and ds = 0, a live one a bias of 0); queries past T are no queries.
    // Only tiles that hold such a query, or a query before this warp's last
    // key, or a key mask, need the test.
    const bool edge = q0 + BN > T_ || (causal && q0 < kw + 15) || km != nullptr;
    #pragma unroll
    for (int j = 0; j < NQ; ++j)
      #pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int col = 8 * j + 2 * t + (r & 1);
        float p = 0.f, ds = 0.f;
        bool live = true;
        if (edge) {
          const int qi = q0 + col, kj = kw + gq + 8 * (r >> 1);
          live = qi < T_ && !(causal && qi < kj) && kmv[r >> 1] != 0;
        }
        if (live) {
          p = fast_exp(sT[j][r] * scale - Lt[col]);
          ds = p * (dpT[j][r] - Dt[col]) * scale;
        }
        sT[j][r] = p;
        dpT[j][r] = ds;
      }

    // dV += p^T . G and dK += ds^T . Q: p^T and ds^T, rounded to bf16, are
    // the A fragments; G and Q (queries x d) the B fragments, by
    // ldmatrix.trans
    #pragma unroll
    for (int c = 0; c < BN / 16; ++c) {
      unsigned pa[4], da[4];
      c_to_a(pa, sT[2 * c], sT[2 * c + 1]);
      c_to_a(da, dpT[2 * c], dpT[2 * c + 1]);
      #pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        unsigned b[4];
        ldsm_x4_t(b, Gt + (16 * c + a_row(lane)) * SP + 16 * dp + a_col(lane));
        mma_bf16(adv[2 * dp], pa, b[0], b[1]);
        mma_bf16(adv[2 * dp + 1], pa, b[2], b[3]);
        ldsm_x4_t(b, Qt + (16 * c + a_row(lane)) * SP + 16 * dp + a_col(lane));
        mma_bf16(adk[2 * dp], da, b[0], b[1]);
        mma_bf16(adk[2 * dp + 1], da, b[2], b[3]);
      }
    }
    __syncthreads();                // stage `st` is free for the tile after next
  }

  const float one[2] = {1.f, 1.f};
  store_c_rows<DP>(dk + koff, adk, one, kw, S, D, lane);
  store_c_rows<DP>(dv + koff, adv, one, kw, S, D, lane);
}

template <int DP>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ g,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       const int* __restrict__ kmask, bf16* __restrict__ dq, int H, int T_,
                       int S, int D, float scale, int causal) {
  constexpr int SP = Dims<DP>::SP, BN = Dims<DP>::BN;
  constexpr int KC = DP / 16;    // 16-wide d chunks of Q, G (A fragments)
  constexpr int ND = DP / 8;     // 8-wide d tiles of dQ
  constexpr int NK = BN / 8;     // 8-key tiles of S, dP
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);     // [BM][SP]  this block's queries
  bf16* Gs = Qs + BM * SP;                           // [BM][SP]
  bf16* Ks = Gs + BM * SP;                           // [2][BN][SP]  the streamed keys
  bf16* Vs = Ks + 2 * BN * SP;                       // [2][BN][SP]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // heaviest causal tiles first
  const int qw = q0 + 16 * warp;                     // this warp's first query
  const size_t qoff = (size_t)bh * T_ * D, koff = (size_t)bh * S * D;
  const bf16* kb = k + koff;
  const bf16* vb = v + koff;
  const int* km = kmask ? kmask + (size_t)(bh / H) * S : nullptr;
  const bool vec = D % Tile<bf16, DP>::E == 0 &&
                   ((reinterpret_cast<size_t>(q) | reinterpret_cast<size_t>(k) |
                     reinterpret_cast<size_t>(v) | reinterpret_cast<size_t>(g)) & 15) == 0;

  int n_kt = (S + BN - 1) / BN;
  if (causal) n_kt = min(n_kt, (q0 + BM - 1) / BN + 1);  // skip tiles above the diagonal

  load_tile<bf16, DP, NT>(Qs, q + qoff, BM, q0, T_, D, vec);
  load_tile<bf16, DP, NT>(Gs, g + qoff, BM, q0, T_, D, vec);
  load_tile<bf16, DP, NT>(Ks, kb, BN, 0, S, D, vec);
  load_tile<bf16, DP, NT>(Vs, vb, BN, 0, S, D, vec);
  cp_commit();

  // lse and delta of this lane's rows qw + gq (+ 8); a row past T takes the
  // sentinel, so its p is 0
  float ls[2], dl[2];
  #pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = qw + gq + 8 * h;
    ls[h] = qi < T_ ? lse[(size_t)bh * T_ + qi] : 1e30f;
    dl[h] = qi < T_ ? delta[(size_t)bh * T_ + qi] : 0.f;
  }
  unsigned qf[KC][4], gf[KC][4];
  float acc[ND][4];              // rows qw + gq (+ 8), d tile j
  #pragma unroll
  for (int j = 0; j < ND; ++j)
    #pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int buf = kt & 1, k0 = kt * BN;
    if (kt + 1 < n_kt) {
      load_tile<bf16, DP, NT>(Ks + (buf ^ 1) * BN * SP, kb, BN, k0 + BN, S, D, vec);
      load_tile<bf16, DP, NT>(Vs + (buf ^ 1) * BN * SP, vb, BN, k0 + BN, S, D, vec);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {
      #pragma unroll
      for (int c = 0; c < KC; ++c) {
        ldsm_x4(qf[c], Qs + (16 * warp + a_row(lane)) * SP + 16 * c + a_col(lane));
        ldsm_x4(gf[c], Gs + (16 * warp + a_row(lane)) * SP + 16 * c + a_col(lane));
      }
    }
    const bf16* Kt = Ks + buf * BN * SP;
    const bf16* Vt = Vs + buf * BN * SP;

    // S = Q . K^T and dP = G . V^T: 16 rows x BN keys a warp
    float s[NK][4], dp[NK][4];
    #pragma unroll
    for (int j = 0; j < NK; ++j)
      #pragma unroll
      for (int r = 0; r < 4; ++r) s[j][r] = dp[j][r] = 0.f;
    #pragma unroll
    for (int c = 0; c < KC; ++c)
      #pragma unroll
      for (int jp = 0; jp < NK / 2; ++jp) {
        unsigned b[4];
        ldsm_x4(b, Kt + (16 * jp + b_row(lane)) * SP + 16 * c + b_col(lane));
        mma_bf16(s[2 * jp], qf[c], b[0], b[1]);
        mma_bf16(s[2 * jp + 1], qf[c], b[2], b[3]);
        ldsm_x4(b, Vt + (16 * jp + b_row(lane)) * SP + 16 * c + b_col(lane));
        mma_bf16(dp[2 * jp], gf[c], b[0], b[1]);
        mma_bf16(dp[2 * jp + 1], gf[c], b[2], b[3]);
      }

    // ds in place of s, for live pairs only (a blocked pair has ds = 0, a
    // live one a bias of 0); keys past S are no keys.  Only tiles that hold
    // such a key, or a key past this warp's first row, or a key mask, need
    // the test.
    const bool edge = k0 + BN > S || (causal && k0 + BN - 1 > qw) || km != nullptr;
    #pragma unroll
    for (int j = 0; j < NK; ++j)
      #pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int h = r >> 1;
        bool live = true;
        if (edge) {
          const int kj = k0 + 8 * j + 2 * t + (r & 1), qi = qw + gq + 8 * h;
          live = kj < S && !(causal && qi < kj) && (km == nullptr || km[kj] != 0);
        }
        float ds = 0.f;
        if (live) {
          const float p = fast_exp(s[j][r] * scale - ls[h]);
          ds = p * (dp[j][r] - dl[h]) * scale;
        }
        s[j][r] = ds;
      }

    // dQ += dS . K: dS's C fragments, rounded to bf16, are the A fragments;
    // K (keys x d) the B fragments, by ldmatrix.trans of the same tile
    #pragma unroll
    for (int c = 0; c < BN / 16; ++c) {
      unsigned a[4];
      c_to_a(a, s[2 * c], s[2 * c + 1]);
      #pragma unroll
      for (int dp2 = 0; dp2 < ND / 2; ++dp2) {
        unsigned b[4];
        ldsm_x4_t(b, Kt + (16 * c + a_row(lane)) * SP + 16 * dp2 + a_col(lane));
        mma_bf16(acc[2 * dp2], a, b[0], b[1]);
        mma_bf16(acc[2 * dp2 + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();             // stage `buf` is free for the tile after next
  }

  const float one[2] = {1.f, 1.f};
  store_c_rows<DP>(dq + qoff, acc, one, qw, T_, D, lane);
}

template <int DP>
int launch_dkdv(const void* q, const void* k, const void* v, const void* g, const float* lse,
                const float* delta, const int* kmask, void* dk, void* dv, int B, int H,
                int T_, int S, int D, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = Dims<DP>::SMEM_DKDV;
  // once per template instance (a thread-safe static initialiser)
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkdv_tc_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(B * H, (S + BM - 1) / BM);
  flash_bwd_dkdv_tc_kernel<DP><<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(g), lse, delta, kmask, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), H, T_, S, D, scale, causal);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_dq(const void* q, const void* k, const void* v, const void* g, const float* lse,
              const float* delta, const int* kmask, void* dq, int B, int H, int T_, int S,
              int D, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = Dims<DP>::SMEM_DQ;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_tc_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(B * H, (T_ + BM - 1) / BM);
  flash_bwd_dq_tc_kernel<DP><<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(g), lse, delta, kmask, static_cast<bf16*>(dq), H, T_, S, D,
      scale, causal);
  return (int)cudaGetLastError();
}

bool bad_args(int B, int H, int T_, int S, int D) {
  return B < 1 || H < 1 || T_ < 1 || S < 1 || D < 1 || D > 128 ||
         (long long)B * H > 2147483647LL || (T_ + BM - 1) / BM > 65535 ||
         (S + BM - 1) / BM > 65535;
}

}  // namespace

// q, g, dq [B,H,T,D]; k, v, dk, dv [B,H,S,D]; all contiguous bf16; lse,
// delta [B,H,T] f32; kmask [B,S] int32 or null.  Each returns 0, a CUDA
// error code, or -1 for arguments the kernel does not take.
extern "C" int dl4j_flash_bwd_dkdv_tc(const void* q, const void* k, const void* v,
                                      const void* g, const void* lse, const void* delta,
                                      const void* kmask, void* dk, void* dv, int B, int H,
                                      int T_, int S, int D, float scale, int causal,
                                      void* stream) {
  if (bad_args(B, H, T_, S, D)) return -1;
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int* km = static_cast<const int*>(kmask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return D <= 64
      ? launch_dkdv<64>(q, k, v, g, l, dl, km, dk, dv, B, H, T_, S, D, scale, causal, st)
      : launch_dkdv<128>(q, k, v, g, l, dl, km, dk, dv, B, H, T_, S, D, scale, causal, st);
}

extern "C" int dl4j_flash_bwd_dq_tc(const void* q, const void* k, const void* v,
                                    const void* g, const void* lse, const void* delta,
                                    const void* kmask, void* dq, int B, int H, int T_, int S,
                                    int D, float scale, int causal, void* stream) {
  if (bad_args(B, H, T_, S, D)) return -1;
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int* km = static_cast<const int*>(kmask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return D <= 64
      ? launch_dq<64>(q, k, v, g, l, dl, km, dq, B, H, T_, S, D, scale, causal, st)
      : launch_dq<128>(q, k, v, g, l, dl, km, dq, B, H, T_, S, D, scale, causal, st);
}

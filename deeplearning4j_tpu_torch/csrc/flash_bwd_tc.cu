// Flash-attention backward for Hopper in bf16 and f16, on the warpgroup MMA
// (wgmma): dK/dV (kernel K2) and dQ (kernel K3).
//
// K2 replaces deeplearning4j_tpu/ops/attention.py::_flash_bwd_dkdv_kernel and
// K3 replaces ::_flash_bwd_dq_kernel (both built on ::_bwd_tile, launched by
// ::_flash_backward) for bf16 and f16 inputs; f32 inputs take the SIMT kernels in
// flash_bwd.cu.  Same function: with s = q.k^T * scale + bias, p = exp(s -
// lse) rebuilt from the forward's saved log-sum-exp, dp = g.v^T and ds = p *
// (dp - delta) * scale (zeroed where the bias blocks), dV = p^T.g, dK =
// ds^T.q and dQ = ds.k.  delta = rowsum(g * o) is computed outside, in f32.
// p and ds are rounded to the input type before the products that read them; every sum
// is f32.  A row with the LSE sentinel +1e30 has p = 0 and feeds no gradient
// (its dQ is exactly 0).
//
// Bound on H100: per live (query, key) pair K2 does four products of 2*D
// flops (s, dp, dV, dK) and K3 three (s, dp, dQ) on the bf16/f16 tensor cores
// (989 TFLOP/s), against ~(4*T + 4*S)*D 2-byte elements of traffic per
// batch*head at 3.35 TB/s; at D 64 and T 1024 the two are within a small
// factor, so the work is keeping the tensor cores fed.  Only wgmma reaches
// their full rate: with mma.sync each warp reads its B operand from shared
// memory for 16 rows, with wgmma the warpgroup reads it once for 64.  The
// fragment layer (descriptors, the swizzled layout, TMA, mbarriers) is in
// wgmma.cuh.
//
// K2's design:
//   * a block is one warpgroup (4 warps) and owns 64 keys of one (batch,
//     head), 16 keys a warp; K and V are resident in shared memory;
//   * the query tiles (Q, G: 64 queries at D <= 64, 32 at D 128, where the
//     dK and dV accumulators take twice the registers) stream through a
//     ring of three stages filled by TMA: one thread arms the stage's
//     mbarrier with the bytes to come and issues the copies, the lanes of
//     its warp copy the tile's lse and delta beside them (cp.async, arriving
//     on the same barrier), and a stage is refilled as soon as every
//     product that reads it has retired;
//   * S^T = K.Q^T and dP^T = V.G^T by wgmma with both operands from shared
//     memory (K, V as A; Q, G as K-major B);
//   * p^T and ds^T are computed in those accumulators and, rounded to E,
//     are the register A operands of dV += p^T.G and dK += ds^T.Q, whose B
//     are the same Q and G tiles read MN-major: nothing of p or ds goes
//     through shared memory;
//   * causal: query tiles wholly above the diagonal are never loaded, masks
//     are computed only for tiles that need them, and the grid walks the
//     heaviest (lowest) key tiles first.
// K3's design is K2's with the roles turned:
//   * a block (one warpgroup) owns 64 query rows of one (batch, head); Q and
//     G are resident, lse and delta of the lane's two rows in registers;
//   * key tiles (K, V; 64 keys) stream through a ring of two stages, filled
//     by TMA as in K2;
//   * S = Q.K^T and dP = G.V^T by wgmma from shared memory; ds is computed in
//     the accumulators with K2's expression for p, so both kernels rebuild
//     the same p; rounded to E, it is the register A operand of dQ +=
//     ds.K, with the same K tile read MN-major (so a stage is refilled only
//     after that product);
//   * causal: key tiles wholly above the diagonal are never loaded, masks are
//     computed only for tiles that need them, and the grid walks the heaviest
//     (highest) query tiles first.
// Both: p = 2^(s * scale * log2 e - lse * log2 e), one FFMA and one ex2 a
// pair, computed for every pair and then selected by the mask: a branch
// around the exponential (inline asm, which the compiler does not
// predicate) would make every element a divergent region.  Within a block
// the products and the exponentials take turns (one wgmma batch, its wait,
// the exponentials, the next batch); the blocks that share an SM (three or
// four at D <= 64, two at D 128, as registers and 50-99 KB of shared memory
// allow) fill each other's gaps.  A software pipeline inside the
// warpgroup (the next tile's scores, or the last tile's gradient products,
// in flight during the exponentials) was tried and measured slower: it
// needs a second set of A operands or accumulators, and the registers cost
// a block an SM.  Tiles are 128-byte swizzled; TMA zero-fills rows past T or
// S and columns past D (D <= 128 padded to 64 or 128).  Where TMA cannot
// address a tensor (a row of D that is not a multiple of 16 bytes, a base
// that is not 16-byte aligned), the block's threads write the same swizzled
// tiles with plain loads and stores: routed by shape in the entry, never as
// a fallback on failure.
// Head widths 129-256 (DP 256; TMA and plain stores write four 64-column
// panels, a panel wholly past D zero-filled):
//   * K2 splits the output columns over the grid: a block owns one 128-wide
//     half of dK and dV (blockIdx.z), m64n128 accumulators as at DP 128,
//     while S^T and dP^T still contract over all 256 columns.  Two consumer
//     warpgroups that exchange p^T or ds^T through shared memory were the
//     other way; the split keeps the one-warpgroup body, with no named
//     barrier and no exchange, for 1.5x the products (S^T and dP^T are
//     computed by both halves' blocks).  K, V and three query stages take
//     162 KB of shared memory: one block an SM;
//   * K3 keeps dQ whole, an m64n256 accumulator (128 registers a thread),
//     dQ += ds.K one m64n256k16 per 16 keys; Q, G and two key stages take
//     194 KB: one block an SM.
// The element type (bf16 or f16) changes only the instruction's type, the
// packing of p and ds, and the tensor maps.
// No atomics: each dK, dV and dQ element is summed by one thread (its lane of
// one warpgroup's accumulators) in a fixed order, so a launch is bitwise the
// last one on the same inputs, which the port's data-parallel bit gates rest
// on (see flash_bwd.cu).
//
// dl4j_wgmma_tile_check runs the fragment layer alone on one tile each way,
// for the card tests.

#include "flash_tiles.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;

constexpr int NT = 128;          // threads: one warpgroup
constexpr int BM = 64;           // rows a block owns, 16 a warp: K2 keys, K3 queries

template <int DP> struct Cfg {
  static constexpr int DO = DP <= 128 ? DP : 128;   // K2's output columns a block
  static constexpr int BN2 = DP <= 64 ? 64 : 32;   // K2's streamed query tile
  static constexpr int BN3 = 64;                    // K3's streamed key tile
  static constexpr int NS2 = 3;                     // K2's ring stages
  static constexpr int NS3 = 2;                     // K3's
  // bytes, each tile a multiple of 1024 (so every panel stays aligned)
  static constexpr int ROWS_BM = BM * DP * 2, ROWS_BN2 = BN2 * DP * 2, ROWS_BN3 = BN3 * DP * 2;
  // K2: K, V; the stages' Q, G; the stages' lse, delta
  static constexpr size_t SMEM_DKDV =
      1024 + 2 * ROWS_BM + (size_t)NS2 * (2 * ROWS_BN2 + 2 * BN2 * sizeof(float));
  // K3: Q, G; the stages' K, V
  static constexpr size_t SMEM_DQ = 1024 + 2 * ROWS_BM + (size_t)NS3 * 2 * ROWS_BN3;
};

// blocks an SM holds at least (the registers a thread may take follow): at D
// <= 64 three, at D 128 two, at D 256 one
template <int DP> constexpr int blocks_per_sm() { return DP <= 64 ? 3 : DP <= 128 ? 2 : 1; }

template <int DP, typename E>
__global__ void __launch_bounds__(NT, blocks_per_sm<DP>())
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_g,
                            const E* __restrict__ q, const E* __restrict__ k,
                            const E* __restrict__ v, const E* __restrict__ g,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            const int* __restrict__ kmask, E* __restrict__ dk,
                            E* __restrict__ dv, int H, int T_, int S, int D, float scale,
                            int causal, int tma) {
  constexpr int BN = Cfg<DP>::BN2, NS = Cfg<DP>::NS2;
  constexpr int KC = DP / 16;    // k16 slices of S^T, dP^T (over d)
  constexpr int ND = Cfg<DP>::DO / 8;   // 8-wide d blocks of dK, dV this block owns
  constexpr int NQ = BN / 8;     // 8-query blocks of S^T, dP^T
  constexpr unsigned STAGE_TX = 2 * Cfg<DP>::ROWS_BN2;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[NS + 1];   // the stages', then K and V's
  E* Ks = reinterpret_cast<E*>(align1024(smem_raw));   // [BM, DP] this block's keys
  E* Vs = Ks + BM * DP;
  E* Qs = Vs + BM * DP;                          // [NS][BN, DP] the streamed queries
  E* Gs = Qs + NS * BN * DP;
  float* Ls = reinterpret_cast<float*>(Gs + NS * BN * DP);   // [NS][BN] their lse
  float* Dl = Ls + NS * BN;                                   // [NS][BN] their delta

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BM;   // lowest key tiles, the heaviest when causal, first
  const int kw = k0 + 16 * warp;    // this warp's first key
  // the first column of dK, dV this block owns (DP 256: a half a block)
  const int d0 = Cfg<DP>::DO < DP ? (int)blockIdx.z * Cfg<DP>::DO : 0;
  const size_t qoff = (size_t)bh * T_ * D, koff = (size_t)bh * S * D;
  const int* km = kmask ? kmask + (size_t)(bh / H) * S : nullptr;

  const int n_qt = (T_ + BN - 1) / BN;
  const int qt0 = causal ? k0 / BN : 0;   // query tiles wholly above the diagonal see no key here
  const int n = max(n_qt - qt0, 0);       // tiles this block walks

  if (tid == 0) {
    // a stage: TMA's thread and warp 0's lanes (their lse, delta copies);
    // K and V: TMA's thread.  By plain stores: every thread.
    for (int s = 0; s < NS; ++s) mbar_init(&bars[s], tma ? 33 : NT);
    mbar_init(&bars[NS], tma ? 1 : NT);
    mbar_init_fence();
  }
  __syncthreads();

  // query tile qt0 + i into stage i % NS
  auto issue = [&](int i) {
    const int st = i % NS, r0 = (qt0 + i) * BN;
    E* qd = Qs + st * BN * DP;
    E* gd = Gs + st * BN * DP;
    if (tma) {
      if (warp == 0) {
        if (lane == 0) {
          mbar_arrive_tx(&bars[st], STAGE_TX);
          tma_rows<DP>(qd, &tm_q, &bars[st], BN, r0, bh);
          tma_rows<DP>(gd, &tm_g, &bars[st], BN, r0, bh);
        }
        // lse and delta by 4-byte copies (a batch*head's row of T floats
        // need not start 16-byte aligned, as TMA wants), zero past T; each
        // lane's copies arrive on the stage's barrier when they have landed
        for (int e = lane; e < BN; e += 32) {
          const bool ok = r0 + e < T_;
          const size_t at = (size_t)bh * T_ + (ok ? r0 + e : 0);
          cp4(Ls + st * BN + e, lse + at, ok);
          cp4(Dl + st * BN + e, delta + at, ok);
        }
        cp_async_arrive(&bars[st]);
      }
    } else {
      load_rows_plain<DP, NT>(qd, q + qoff, BN, r0, T_, D);
      load_rows_plain<DP, NT>(gd, g + qoff, BN, r0, T_, D);
      for (int e = tid; e < BN; e += NT) {
        const bool ok = r0 + e < T_;
        Ls[st * BN + e] = ok ? lse[(size_t)bh * T_ + r0 + e] : 0.f;
        Dl[st * BN + e] = ok ? delta[(size_t)bh * T_ + r0 + e] : 0.f;
      }
      fence_proxy_async();
      mbar_arrive(&bars[st]);
    }
  };
  if (n > 0) {                      // else no query sees these keys: dK = dV = 0
    if (tma) {
      if (tid == 0) {
        mbar_arrive_tx(&bars[NS], 2 * Cfg<DP>::ROWS_BM);
        tma_rows<DP>(Ks, &tm_k, &bars[NS], BM, k0, bh);
        tma_rows<DP>(Vs, &tm_v, &bars[NS], BM, k0, bh);
      }
    } else {
      load_rows_plain<DP, NT>(Ks, k + koff, BM, k0, S, D);
      load_rows_plain<DP, NT>(Vs, v + koff, BM, k0, S, D);
      fence_proxy_async();
      mbar_arrive(&bars[NS]);
    }
    for (int i = 0; i < min(NS, n); ++i) issue(i);
    mbar_wait(&bars[NS], 0);
  }

  int kmv[2];                       // the key mask of this lane's keys gq, gq + 8
  #pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kj = kw + gq + 8 * h;
    kmv[h] = (km != nullptr && kj < S) ? km[kj] : 1;
  }
  const float sl2 = scale * LOG2E;  // p = 2^(s^T * scale * log2 e - lse * log2 e)
  float adk[ND][4], adv[ND][4];     // keys kw + gq (+ 8), d block j
  #pragma unroll
  for (int j = 0; j < ND; ++j)
    #pragma unroll
    for (int r = 0; r < 4; ++r) adk[j][r] = adv[j][r] = 0.f;

  for (int i = 0; i < n; ++i) {
    const int st = i % NS, q0 = (qt0 + i) * BN;
    mbar_wait(&bars[st], (i / NS) & 1);
    const E* Qt = Qs + st * BN * DP;
    const E* Gt = Gs + st * BN * DP;
    const float* Lt = Ls + st * BN;
    const float* Dt = Dl + st * BN;

    // S^T = K . Q^T and dP^T = V . G^T: 64 keys x BN queries
    float sT[NQ][4], dpT[NQ][4];
    wgmma_fence();
    #pragma unroll
    for (int c = 0; c < KC; ++c)
      wgmma_ss(sT, kmajor_desc(Ks, BM, c), kmajor_desc(Qt, BN, c), c);
    #pragma unroll
    for (int c = 0; c < KC; ++c)
      wgmma_ss(dpT, kmajor_desc(Vs, BM, c), kmajor_desc(Gt, BN, c), c);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(sT);
    fence_acc(dpT);

    // p^T and ds^T in place, for live pairs only (a blocked pair has p = 0
    // and ds = 0, a live one a bias of 0); queries past T are no queries.
    // Only tiles that hold such a query, or a query before this warp's last
    // key, or a key mask, need the test.
    const bool edge = q0 + BN > T_ || (causal && q0 < kw + 15) || km != nullptr;
    #pragma unroll
    for (int j = 0; j < NQ; ++j) {
      // lse (in log2 units) and delta of this lane's queries 8 j + 2 t, + 1
      float2 l2 = *reinterpret_cast<const float2*>(Lt + 8 * j + 2 * t);
      const float2 dl = *reinterpret_cast<const float2*>(Dt + 8 * j + 2 * t);
      l2.x *= LOG2E;
      l2.y *= LOG2E;
      #pragma unroll
      for (int r = 0; r < 4; ++r) {
        bool live = true;
        if (edge) {
          const int qi = q0 + 8 * j + 2 * t + (r & 1), kj = kw + gq + 8 * (r >> 1);
          live = qi < T_ && !(causal && qi < kj) && kmv[r >> 1] != 0;
        }
        // computed for every pair and selected: a branch around the
        // exponential would make a divergent region of every element
        const float p = fast_exp2(fmaf(sT[j][r], sl2, -((r & 1) ? l2.y : l2.x)));
        const float ds = p * (dpT[j][r] - ((r & 1) ? dl.y : dl.x)) * scale;
        sT[j][r] = live ? p : 0.f;
        dpT[j][r] = live ? ds : 0.f;
      }
    }

    // dV += p^T . G and dK += ds^T . Q: p^T and ds^T, rounded to E, are
    // the register A operands; G and Q (queries x d) the MN-major B
    unsigned pa[BN / 16][4], da[BN / 16][4];
    #pragma unroll
    for (int c = 0; c < BN / 16; ++c) {
      c_to_a<E>(pa[c], sT[2 * c], sT[2 * c + 1]);
      c_to_a<E>(da[c], dpT[2 * c], dpT[2 * c + 1]);
    }
    wgmma_fence();
    #pragma unroll
    for (int c = 0; c < BN / 16; ++c) wgmma_rs(adv, pa[c], mnmajor_desc(Gt + d0 * BN, BN, c), 1);
    #pragma unroll
    for (int c = 0; c < BN / 16; ++c) wgmma_rs(adk, da[c], mnmajor_desc(Qt + d0 * BN, BN, c), 1);
    wgmma_commit();
    wgmma_wait<0>();
    __syncthreads();                // every product that read stage `st` has retired
    if (i + NS < n) issue(i + NS);
  }
  fence_acc(adk);
  fence_acc(adv);

  const float one[2] = {1.f, 1.f};
  store_c_rows<Cfg<DP>::DO>(dk + koff, adk, one, kw, S, D, lane, d0);
  store_c_rows<Cfg<DP>::DO>(dv + koff, adv, one, kw, S, D, lane, d0);
}

template <int DP, typename E>
__global__ void __launch_bounds__(NT, blocks_per_sm<DP>())
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_g,
                          const E* __restrict__ q, const E* __restrict__ k,
                          const E* __restrict__ v, const E* __restrict__ g,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const int* __restrict__ kmask, E* __restrict__ dq, int H, int T_,
                          int S, int D, float scale, int causal, int tma) {
  constexpr int BN = Cfg<DP>::BN3, NS = Cfg<DP>::NS3;
  constexpr int KC = DP / 16;    // k16 slices of S, dP (over d)
  constexpr int ND = DP / 8;     // 8-wide d blocks of dQ
  constexpr int NK = BN / 8;     // 8-key blocks of S, dP
  constexpr unsigned STAGE_TX = 2 * Cfg<DP>::ROWS_BN3;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[NS + 1];   // the stages', then Q and G's
  E* Qs = reinterpret_cast<E*>(align1024(smem_raw));   // [BM, DP] this block's queries
  E* Gs = Qs + BM * DP;
  E* Ks = Gs + BM * DP;                          // [NS][BN, DP] the streamed keys
  E* Vs = Ks + NS * BN * DP;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // heaviest causal tiles first
  const int qw = q0 + 16 * warp;                     // this warp's first query
  const size_t qoff = (size_t)bh * T_ * D, koff = (size_t)bh * S * D;
  const int* km = kmask ? kmask + (size_t)(bh / H) * S : nullptr;

  int n = (S + BN - 1) / BN;
  if (causal) n = min(n, (q0 + BM - 1) / BN + 1);  // skip tiles above the diagonal

  if (tid == 0) {
    for (int s = 0; s <= NS; ++s) mbar_init(&bars[s], tma ? 1 : NT);
    mbar_init_fence();
  }
  __syncthreads();

  // key tile i into stage i % NS
  auto issue = [&](int i) {
    const int st = i % NS, r0 = i * BN;
    E* kd = Ks + st * BN * DP;
    E* vd = Vs + st * BN * DP;
    if (tma) {
      if (tid == 0) {
        mbar_arrive_tx(&bars[st], STAGE_TX);
        tma_rows<DP>(kd, &tm_k, &bars[st], BN, r0, bh);
        tma_rows<DP>(vd, &tm_v, &bars[st], BN, r0, bh);
      }
    } else {
      load_rows_plain<DP, NT>(kd, k + koff, BN, r0, S, D);
      load_rows_plain<DP, NT>(vd, v + koff, BN, r0, S, D);
      fence_proxy_async();
      mbar_arrive(&bars[st]);
    }
  };
  if (tma) {
    if (tid == 0) {
      mbar_arrive_tx(&bars[NS], 2 * Cfg<DP>::ROWS_BM);
      tma_rows<DP>(Qs, &tm_q, &bars[NS], BM, q0, bh);
      tma_rows<DP>(Gs, &tm_g, &bars[NS], BM, q0, bh);
    }
  } else {
    load_rows_plain<DP, NT>(Qs, q + qoff, BM, q0, T_, D);
    load_rows_plain<DP, NT>(Gs, g + qoff, BM, q0, T_, D);
    fence_proxy_async();
    mbar_arrive(&bars[NS]);
  }
  for (int i = 0; i < min(NS, n); ++i) issue(i);

  // lse and delta of this lane's rows qw + gq (+ 8); a row past T takes the
  // sentinel, so its p is 0
  float ls2[2], dl[2];               // lse in log2 units
  #pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = qw + gq + 8 * h;
    ls2[h] = qi < T_ ? lse[(size_t)bh * T_ + qi] * LOG2E : 1e30f;
    dl[h] = qi < T_ ? delta[(size_t)bh * T_ + qi] : 0.f;
  }
  const float sl2 = scale * LOG2E;  // p = 2^(s * scale * log2 e - lse * log2 e)
  float acc[ND][4];              // rows qw + gq (+ 8), d block j
  #pragma unroll
  for (int j = 0; j < ND; ++j)
    #pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;
  mbar_wait(&bars[NS], 0);

  for (int i = 0; i < n; ++i) {
    const int st = i % NS, k0 = i * BN;
    mbar_wait(&bars[st], (i / NS) & 1);
    const E* Kt = Ks + st * BN * DP;
    const E* Vt = Vs + st * BN * DP;

    // S = Q . K^T and dP = G . V^T: 64 rows x BN keys
    float s[NK][4], dp[NK][4];
    wgmma_fence();
    #pragma unroll
    for (int c = 0; c < KC; ++c)
      wgmma_ss(s, kmajor_desc(Qs, BM, c), kmajor_desc(Kt, BN, c), c);
    #pragma unroll
    for (int c = 0; c < KC; ++c)
      wgmma_ss(dp, kmajor_desc(Gs, BM, c), kmajor_desc(Vt, BN, c), c);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    fence_acc(dp);

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
        const float p = fast_exp2(fmaf(s[j][r], sl2, -ls2[h]));
        const float ds = p * (dp[j][r] - dl[h]) * scale;
        s[j][r] = live ? ds : 0.f;
      }

    // dQ += ds . K: ds, rounded to E, is the register A operand; K (keys
    // x d) the MN-major B, the same stage
    unsigned a[BN / 16][4];
    #pragma unroll
    for (int c = 0; c < BN / 16; ++c) c_to_a<E>(a[c], s[2 * c], s[2 * c + 1]);
    wgmma_fence();
    #pragma unroll
    for (int c = 0; c < BN / 16; ++c) wgmma_rs(acc, a[c], mnmajor_desc(Kt, BN, c), 1);
    wgmma_commit();
    wgmma_wait<0>();
    __syncthreads();             // every product that read stage `st` has retired
    if (i + NS < n) issue(i + NS);
  }
  fence_acc(acc);

  const float one[2] = {1.f, 1.f};
  store_c_rows<DP>(dq + qoff, acc, one, qw, T_, D, lane);
}

// One warpgroup, one tile each way, for the card tests of the fragment
// layer: c1 = a . b^T (a [64, DP], b [N, DP], both through K-major
// descriptors) and c2 = bf16(c1) . g (g [N, DP] through the MN-major
// descriptor, c1's accumulators repacked as the register A), in f32; the
// tiles come by TMA when `tma`, else by plain stores.
template <int DP, int N>
__global__ void __launch_bounds__(NT)
wgmma_tile_check_kernel(const __grid_constant__ CUtensorMap tm_a,
                        const __grid_constant__ CUtensorMap tm_b,
                        const __grid_constant__ CUtensorMap tm_g, const bf16* a,
                        const bf16* b, const bf16* g, float* c1, float* c2, int tma) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar;
  bf16* As = reinterpret_cast<bf16*>(align1024(smem_raw));
  bf16* Bs = As + BM * DP;
  bf16* Gs = Bs + N * DP;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  if (tid == 0) {
    mbar_init(&bar, tma ? 1 : NT);
    mbar_init_fence();
  }
  __syncthreads();
  if (tma) {
    if (tid == 0) {
      mbar_arrive_tx(&bar, (BM + 2 * N) * DP * 2);
      tma_rows<DP>(As, &tm_a, &bar, BM, 0, 0);
      tma_rows<DP>(Bs, &tm_b, &bar, N, 0, 0);
      tma_rows<DP>(Gs, &tm_g, &bar, N, 0, 0);
    }
  } else {
    load_rows_plain<DP, NT>(As, a, BM, 0, BM, DP);
    load_rows_plain<DP, NT>(Bs, b, N, 0, N, DP);
    load_rows_plain<DP, NT>(Gs, g, N, 0, N, DP);
    fence_proxy_async();
    mbar_arrive(&bar);
  }
  mbar_wait(&bar, 0);
  float d1[N / 8][4], d2[DP / 8][4];
  wgmma_fence();
  #pragma unroll
  for (int c = 0; c < DP / 16; ++c) wgmma_ss(d1, kmajor_desc(As, BM, c), kmajor_desc(Bs, N, c), c);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(d1);
  unsigned pa[N / 16][4];
  #pragma unroll
  for (int c = 0; c < N / 16; ++c) c_to_a(pa[c], d1[2 * c], d1[2 * c + 1]);
  wgmma_fence();
  #pragma unroll
  for (int c = 0; c < N / 16; ++c) wgmma_rs(d2, pa[c], mnmajor_desc(Gs, N, c), c);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(d2);
  #pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + gq + 8 * h;
    #pragma unroll
    for (int j = 0; j < N / 8; ++j)
      #pragma unroll
      for (int e = 0; e < 2; ++e) c1[r * N + 8 * j + 2 * t + e] = d1[j][2 * h + e];
    #pragma unroll
    for (int j = 0; j < DP / 8; ++j)
      #pragma unroll
      for (int e = 0; e < 2; ++e) c2[r * DP + 8 * j + 2 * t + e] = d2[j][2 * h + e];
  }
}

template <int DP, typename E>
int launch_dkdv(const void* q, const void* k, const void* v, const void* g, const float* lse,
                const float* delta, const int* kmask, void* dk, void* dv, int B, int H,
                int T_, int S, int D, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = Cfg<DP>::SMEM_DKDV;
  constexpr int BN = Cfg<DP>::BN2;
  // once per template instance (a thread-safe static initialiser)
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkdv_wgmma_kernel<DP, E>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const int BH = B * H;
  const bool tma = tma_route({q, k, v, g}, D);
  CUtensorMap mq{}, mk{}, mv{}, mg{};
  if (tma) {
    int rc;
    if ((rc = map_rows<E>(&mq, q, BH, T_, D, BN)) || (rc = map_rows<E>(&mg, g, BH, T_, D, BN)) ||
        (rc = map_rows<E>(&mk, k, BH, S, D, BM)) || (rc = map_rows<E>(&mv, v, BH, S, D, BM)))
      return rc;
  }
  const dim3 grid(BH, (S + BM - 1) / BM, DP / Cfg<DP>::DO);
  flash_bwd_dkdv_wgmma_kernel<DP, E><<<grid, NT, smem, stream>>>(
      mq, mk, mv, mg, static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<const E*>(g), lse, delta, kmask,
      static_cast<E*>(dk), static_cast<E*>(dv), H, T_, S, D, scale, causal, (int)tma);
  return (int)cudaGetLastError();
}

template <int DP, typename E>
int launch_dq(const void* q, const void* k, const void* v, const void* g, const float* lse,
              const float* delta, const int* kmask, void* dq, int B, int H, int T_, int S,
              int D, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = Cfg<DP>::SMEM_DQ;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma_kernel<DP, E>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const int BH = B * H;
  const bool tma = tma_route({q, k, v, g}, D);
  CUtensorMap mq{}, mk{}, mv{}, mg{};
  if (tma) {
    int rc;
    if ((rc = map_rows<E>(&mq, q, BH, T_, D, BM)) || (rc = map_rows<E>(&mg, g, BH, T_, D, BM)) ||
        (rc = map_rows<E>(&mk, k, BH, S, D, Cfg<DP>::BN3)) ||
        (rc = map_rows<E>(&mv, v, BH, S, D, Cfg<DP>::BN3)))
      return rc;
  }
  const dim3 grid(BH, (T_ + BM - 1) / BM);
  flash_bwd_dq_wgmma_kernel<DP, E><<<grid, NT, smem, stream>>>(
      mq, mk, mv, mg, static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<const E*>(g), lse, delta, kmask,
      static_cast<E*>(dq), H, T_, S, D, scale, causal, (int)tma);
  return (int)cudaGetLastError();
}

template <int DP, int N>
int launch_check(const void* a, const void* b, const void* g, void* c1, void* c2, int tma,
                 cudaStream_t stream) {
  constexpr size_t smem = 1024 + (size_t)(BM + 2 * N) * DP * 2;
  static const cudaError_t attr = cudaFuncSetAttribute(
      wgmma_tile_check_kernel<DP, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap ma{}, mb{}, mg{};
  if (tma) {
    int rc;
    if ((rc = map_rows<bf16>(&ma, a, 1, BM, DP, BM)) || (rc = map_rows<bf16>(&mb, b, 1, N, DP, N)) ||
        (rc = map_rows<bf16>(&mg, g, 1, N, DP, N)))
      return rc;
  }
  wgmma_tile_check_kernel<DP, N><<<1, NT, smem, stream>>>(
      ma, mb, mg, static_cast<const bf16*>(a), static_cast<const bf16*>(b),
      static_cast<const bf16*>(g), static_cast<float*>(c1), static_cast<float*>(c2), tma);
  return (int)cudaGetLastError();
}

bool bad_args(int B, int H, int T_, int S, int D) {
  return B < 1 || H < 1 || T_ < 1 || S < 1 || D < 1 || D > 256 ||
         (long long)B * H > 2147483647LL || (T_ + BM - 1) / BM > 65535 ||
         (S + BM - 1) / BM > 65535;
}

template <typename E>
int run_dkdv(const void* q, const void* k, const void* v, const void* g, const void* lse,
         const void* delta, const void* kmask, void* dk, void* dv, int B, int H, int T_, int S,
         int D, float scale, int causal, void* stream) {
  if (bad_args(B, H, T_, S, D)) return -1;
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int* km = static_cast<const int*>(kmask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return launch_dkdv<64, E>(q, k, v, g, l, dl, km, dk, dv, B, H, T_, S, D, scale, causal, st);
  if (D <= 128)
    return launch_dkdv<128, E>(q, k, v, g, l, dl, km, dk, dv, B, H, T_, S, D, scale, causal, st);
  return launch_dkdv<256, E>(q, k, v, g, l, dl, km, dk, dv, B, H, T_, S, D, scale, causal, st);
}

template <typename E>
int run_dq(const void* q, const void* k, const void* v, const void* g, const void* lse,
       const void* delta, const void* kmask, void* dq_, int B, int H, int T_, int S, int D,
       float scale, int causal, void* stream) {
  if (bad_args(B, H, T_, S, D)) return -1;
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int* km = static_cast<const int*>(kmask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return launch_dq<64, E>(q, k, v, g, l, dl, km, dq_, B, H, T_, S, D, scale, causal, st);
  if (D <= 128)
    return launch_dq<128, E>(q, k, v, g, l, dl, km, dq_, B, H, T_, S, D, scale, causal, st);
  return launch_dq<256, E>(q, k, v, g, l, dl, km, dq_, B, H, T_, S, D, scale, causal, st);
}

}  // namespace

// q, g, dq [B,H,T,D]; k, v, dk, dv [B,H,S,D]; all contiguous bf16 (the _tc
// entries) or f16 (the _tc_f16 entries), D <= 256; lse, delta [B,H,T] f32;
// kmask [B,S] int32 or null.  Each returns 0, a CUDA error code (or the
// driver's, from encoding a tensor map), or -1 for arguments the kernel does
// not take.
extern "C" int dl4j_flash_bwd_dkdv_tc(const void* q, const void* k, const void* v,
                                      const void* g, const void* lse, const void* delta,
                                      const void* kmask, void* dk, void* dv, int B, int H,
                                      int T_, int S, int D, float scale, int causal,
                                      void* stream) {
  return run_dkdv<bf16>(q, k, v, g, lse, delta, kmask, dk, dv, B, H, T_, S, D, scale, causal,
                        stream);
}

extern "C" int dl4j_flash_bwd_dkdv_tc_f16(const void* q, const void* k, const void* v,
                                          const void* g, const void* lse, const void* delta,
                                          const void* kmask, void* dk, void* dv, int B, int H,
                                          int T_, int S, int D, float scale, int causal,
                                          void* stream) {
  return run_dkdv<f16>(q, k, v, g, lse, delta, kmask, dk, dv, B, H, T_, S, D, scale, causal,
                       stream);
}

extern "C" int dl4j_flash_bwd_dq_tc(const void* q, const void* k, const void* v,
                                    const void* g, const void* lse, const void* delta,
                                    const void* kmask, void* dq_, int B, int H, int T_, int S,
                                    int D, float scale, int causal, void* stream) {
  return run_dq<bf16>(q, k, v, g, lse, delta, kmask, dq_, B, H, T_, S, D, scale, causal, stream);
}

extern "C" int dl4j_flash_bwd_dq_tc_f16(const void* q, const void* k, const void* v,
                                        const void* g, const void* lse, const void* delta,
                                        const void* kmask, void* dq_, int B, int H, int T_,
                                        int S, int D, float scale, int causal, void* stream) {
  return run_dq<f16>(q, k, v, g, lse, delta, kmask, dq_, B, H, T_, S, D, scale, causal, stream);
}

// a [64, dp], b and g [n, dp] contiguous bf16 (16-byte aligned when tma);
// c1 [64, n] and c2 [64, dp] f32; (dp, n) in {64, 128} x {32, 64}.  Returns
// 0, a CUDA error code, or -1 for another (dp, n).
extern "C" int dl4j_wgmma_tile_check(const void* a, const void* b, const void* g, void* c1,
                                     void* c2, int dp, int n, int tma, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dp == 64 && n == 64) return launch_check<64, 64>(a, b, g, c1, c2, tma, st);
  if (dp == 64 && n == 32) return launch_check<64, 32>(a, b, g, c1, c2, tma, st);
  if (dp == 128 && n == 64) return launch_check<128, 64>(a, b, g, c1, c2, tma, st);
  if (dp == 128 && n == 32) return launch_check<128, 32>(a, b, g, c1, c2, tma, st);
  return -1;
}

// Flash-attention forward (kernel K1) for Hopper in bf16 and f16, on the
// warpgroup MMA (wgmma).
//
// Replaces deeplearning4j_tpu/ops/attention.py::_flash_kernel (launched by
// _flash_forward) for bf16 and f16 inputs; f32 inputs take the SIMT kernel in
// flash_fwd.cu.  Same function: O = softmax(q.k^T * scale + bias) . v and the
// per-row log-sum-exp, with an optional causal mask and an optional [B, S]
// key mask (1 = attend), f32 statistics, p rounded to the input type before
// the P.V product (the reference's .astype, and flash_forward_plain), the row sum
// clamped at 1e-30, and the LSE sentinel +1e30 for rows that never saw a
// live key (their O is 0: a blocked key adds nothing to any row here).
//
// Bound on H100: 4*B*H*T*S*D flops (about half when causal) on the bf16/f16
// tensor cores (989 TFLOP/s) against ~2*(T+S)*B*H*D 2-byte elements of traffic
// at 3.35 TB/s; at D 64 and T 1024 the two are within a small factor, so the
// work is keeping the tensor cores fed.  Only wgmma reaches their full rate
// (with mma.sync each warp reads K and V from shared memory for its own 16
// rows, with wgmma the warpgroup reads them once for 64).  At D 64 the
// exponentials take as long as the two products (4096 ex2 a 64 x 64 tile at
// 16 a clock an SM, against 2 * 64^3 * 2 flops at ~4096 a clock), so the
// design overlaps them.  The fragment layer (descriptors, the swizzled
// layout, TMA, mbarriers, the tensor maps) is in wgmma.cuh; this is K3's
// skeleton (flash_bwd_tc.cu) with one product fewer and an online softmax:
//   * a block is WG warpgroups; each owns 64 query rows of one (batch,
//     head), 16 rows a warp, resident in shared memory (loaded once by
//     TMA), the K-major A of S = Q.K^T;
//   * key tiles (64 keys) stream through two rings of NS slots, one for K
//     and one for V, shared by the block's warpgroups and filled by TMA: one
//     thread arms a slot's mbarrier with the bytes to come and issues the
//     copy.  K and V have rings of their own because they are released at
//     different times (a tile's K when its scores retire, its V a tile
//     later), so each slot is refilled as soon as its product retires and
//     every copy is issued a tile ahead of its use;
//   * S = Q.K^T by wgmma with both operands from shared memory; the online
//     softmax runs on its accumulators in log2 units: the row max of the
//     raw scores (negated where the scale is) times |scale| * log2 e, then p
//     = 2^(s * scale * log2 e - max), one FFMA and one ex2 a pair, computed
//     for every pair and selected by the mask (a branch around the
//     exponential would make a divergent region of every element); the
//     maxima are reduced as trees and over the 4 lanes that share a row by
//     shuffles, the sum kept per lane and reduced once at the end;
//   * p, rounded to the input type, is the register A operand of O += P.V,
//     with V read MN-major: nothing of p goes through shared memory;
//   * the next tile's S = Q.K^T is issued before this tile's P.V, and its
//     softmax runs while P.V is in flight (two wgmma batches: S_next, then
//     P.V; wait<1> retires S_next).  O is rescaled by the new max only once
//     P.V has retired (wait<0>), since its accumulators are written
//     asynchronously; the last tile's P.V is peeled off the loop, so every
//     batch in the loop is unconditional;
//   * causal: key tiles wholly above the diagonal are never loaded, masks
//     are computed only for tiles that need them, and the grid walks the
//     heaviest (highest) query tiles first.
// Four blocks share an SM at D 64 (two at D 128) and fill each other's
// gaps.  At head widths 129-256 (DP 256) the same body runs with O as one
// m64n256 accumulator (128 registers a thread), S contracted over 16 k16
// slices and P.V as one m64n256k16 per 16 keys; Q and the two-slot K and V
// rings take 161 KB of shared memory, so one block an SM.  A 256-wide tile is
// four 64-column panels, each one TMA box of the {64, rows, 1} map (a panel
// wholly past D is zero-filled by the copy engine).  The element type (bf16
// or f16) changes only the instruction's type, the packing of p and the
// tensor maps.  Measured slower on the card (scripts/flash_fwd_tc_variants.py):
// two consumer warpgroups a block on one ring (WG = 2) and three-slot
// rings, each of which costs a block an SM, and the grid in other orders.
// TMA zero-fills rows past T or S and columns past D (D <= 256 padded to 64,
// 128 or 256).  Where TMA cannot address a tensor (a row of D that is not a
// multiple of 16 bytes, a base that is not 16-byte aligned), the block's
// threads write the same swizzled tiles with plain loads and stores: routed
// by shape in the entry, never as a fallback on failure.  No atomics: a
// launch is bitwise the last one on the same inputs.

#include <type_traits>

#include "flash_tiles.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;

constexpr int BM = 64;           // query rows a warpgroup owns, 16 a warp
constexpr int BN = 64;           // keys a streamed K or V tile
constexpr float NEG_LARGE = -1e30f;
constexpr float LN2 = 0.6931471805599453f;

template <int DP> struct Cfg {
  static constexpr int WG = 1;                      // consumer warpgroups a block
  static constexpr int NS = 2;                      // slots of each ring (K, V)
  static constexpr int NTH = 128 * WG;              // threads
  static constexpr int BQ = BM * WG;                // query rows a block
  // bytes, each tile a multiple of 1024 (so every panel stays aligned)
  static constexpr int Q_TX = BM * DP * 2;          // one [BM, DP] tile of Q
  static constexpr int KV_TX = BN * DP * 2;         // one [BN, DP] tile of K or V
  // Q (a tile a warpgroup); the K and V slots
  static constexpr size_t SMEM = 1024 + (size_t)WG * Q_TX + (size_t)NS * 2 * KV_TX;
  // blocks an SM holds at least (the registers a thread may take follow)
  static constexpr int MIN_BLOCKS = DP <= 64 ? 4 / WG : DP <= 128 ? 2 / WG : 1;
};

template <int DP, typename E>
__global__ void __launch_bounds__(Cfg<DP>::NTH, Cfg<DP>::MIN_BLOCKS)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const E* __restrict__ q, const E* __restrict__ k,
                       const E* __restrict__ v, const int* __restrict__ kmask,
                       E* __restrict__ o, float* __restrict__ lse, int H, int T_, int S,
                       int D, float scale, int causal, int tma) {
  constexpr int WG = Cfg<DP>::WG, NS = Cfg<DP>::NS, NTH = Cfg<DP>::NTH, BQ = Cfg<DP>::BQ;
  constexpr int KC = DP / 16;    // k16 slices of S (over d)
  constexpr int ND = DP / 8;     // 8-wide d blocks of O
  constexpr int NK = BN / 8;     // 8-key blocks of S
  extern __shared__ unsigned char smem_raw[];
  // the K slots', the V slots', then Q's
  __shared__ __align__(8) uint64_t bars[2 * NS + 1];
  uint64_t* kbar = bars;
  uint64_t* vbar = bars + NS;
  E* Qs = reinterpret_cast<E*>(align1024(smem_raw));   // [WG][BM, DP] the queries
  E* Ks = Qs + WG * BM * DP;                        // [NS][BN, DP] the streamed keys
  E* Vs = Ks + NS * BN * DP;                        // [NS][BN, DP] their values

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, gq = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest causal tiles first
  const int qw = q0 + 16 * warp;                     // this warp's first query
  const E* Qw = Qs + wg * BM * DP;                   // this warpgroup's queries
  const size_t qoff = (size_t)bh * T_ * D, koff = (size_t)bh * S * D;
  const int* km = kmask ? kmask + (size_t)(bh / H) * S : nullptr;

  int n = (S + BN - 1) / BN;
  if (causal) n = min(n, (q0 + BQ - 1) / BN + 1);  // skip tiles above the diagonal

  if (tid == 0) {
    for (int s = 0; s <= 2 * NS; ++s) mbar_init(&bars[s], tma ? 1 : NTH);
    mbar_init_fence();
  }
  __syncthreads();

  // rows of key tile j of k (or v) into slot j % NS of Ks (or Vs), arriving
  // on that slot's barrier
  auto issue = [&](const CUtensorMap* map, const E* src, E* ring, uint64_t* bar, int j) {
    E* dst = ring + (j % NS) * BN * DP;
    if (tma) {
      if (tid == 0) {
        mbar_arrive_tx(&bar[j % NS], Cfg<DP>::KV_TX);
        tma_rows<DP>(dst, map, &bar[j % NS], BN, j * BN, bh);
      }
    } else {
      load_rows_plain<DP, NTH>(dst, src + koff, BN, j * BN, S, D);
      fence_proxy_async();
      mbar_arrive(&bar[j % NS]);
    }
  };
  auto issue_k = [&](int j) { issue(&tm_k, k, Ks, kbar, j); };
  auto issue_v = [&](int j) { issue(&tm_v, v, Vs, vbar, j); };
  if (tma) {
    if (tid == 0) {
      mbar_arrive_tx(&bars[2 * NS], WG * Cfg<DP>::Q_TX);
      #pragma unroll
      for (int w = 0; w < WG; ++w)
        tma_rows<DP>(Qs + w * BM * DP, &tm_q, &bars[2 * NS], BM, q0 + w * BM, bh);
    }
  } else {
    #pragma unroll
    for (int w = 0; w < WG; ++w)
      load_rows_plain<DP, NTH>(Qs + w * BM * DP, q + qoff, BM, q0 + w * BM, T_, D);
    fence_proxy_async();
    mbar_arrive(&bars[2 * NS]);
  }
  for (int j = 0; j < min(NS, n); ++j) {
    issue_k(j);
    issue_v(j);
  }

  // scores in log2 units: p = 2^(s * sl2 - m), one FFMA and one ex2 a pair;
  // the max is taken over the raw scores (negated where the scale is)
  const float sl2 = scale * LOG2E;
  const float asl2 = fabsf(sl2);
  float m[2] = {NEG_LARGE, NEG_LARGE}, l[2] = {0.f, 0.f}, corr[2];  // rows qw + gq (+ 8)
  float acc[ND][4];                  // O: rows qw + gq (+ 8), d block j
  #pragma unroll
  for (int j = 0; j < ND; ++j)
    #pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;
  float s[NK][4];                    // S, then p, of one key tile
  unsigned pa[BN / 16][4];           // p rounded to E: the A operands of O += P . V

  // S = Q . K^T of key tile j, one wgmma batch, committed
  auto scores = [&](int j) {
    const E* Kt = Ks + (j % NS) * BN * DP;
    #pragma unroll
    for (int c = 0; c < KC; ++c) wgmma_ss(s, kmajor_desc(Qw, BM, c), kmajor_desc(Kt, BN, c), c);
    wgmma_commit();
  };
  // O += P . V of key tile j, one wgmma batch, committed
  auto pv = [&](int j) {
    const E* Vt = Vs + (j % NS) * BN * DP;
    #pragma unroll
    for (int c = 0; c < BN / 16; ++c) wgmma_rs(acc, pa[c], mnmajor_desc(Vt, BN, c), 1);
    wgmma_commit();
  };
  // the online softmax of key tile j in place of its scores: the new max m,
  // corr = 2^(old m - new m) for O and l, and l's new part.  Keys past S are
  // no keys; only tiles that hold such a key, or a key past this warp's
  // first row, or a key mask, need the test.  POS: the scale is not
  // negative (the max of the scaled scores is that of the raw ones).
  auto softmax = [&](int j, auto pos) {
    constexpr bool POS = decltype(pos)::value;
    const int k0 = j * BN;
    const bool edge = k0 + BN > S || (causal && k0 + BN - 1 > qw) || km != nullptr;
    unsigned live = ~0u;             // bit 4 jj + r: pair (jj, r) of this lane
    if (edge) {
      #pragma unroll
      for (int jj = 0; jj < NK; ++jj)
        #pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int kj = k0 + 8 * jj + 2 * t + (r & 1), qi = qw + gq + 8 * (r >> 1);
          const bool ok = kj < S && !(causal && qi < kj) && (km == nullptr || km[kj] != 0);
          live &= ~((ok ? 0u : 1u) << (4 * jj + r));
        }
    }
    // the tile's row maxima of the raw scores, as a tree
    float mx[2][NK / 2];
    #pragma unroll
    for (int h = 0; h < 2; ++h)
      #pragma unroll
      for (int jj = 0; jj < NK / 2; ++jj) {
        float a0 = POS ? s[jj][2 * h] : -s[jj][2 * h];
        float a1 = POS ? s[jj][2 * h + 1] : -s[jj][2 * h + 1];
        float b0 = POS ? s[jj + NK / 2][2 * h] : -s[jj + NK / 2][2 * h];
        float b1 = POS ? s[jj + NK / 2][2 * h + 1] : -s[jj + NK / 2][2 * h + 1];
        if (edge) {
          a0 = (live >> (4 * jj + 2 * h)) & 1 ? a0 : -INFINITY;
          a1 = (live >> (4 * jj + 2 * h + 1)) & 1 ? a1 : -INFINITY;
          b0 = (live >> (4 * (jj + NK / 2) + 2 * h)) & 1 ? b0 : -INFINITY;
          b1 = (live >> (4 * (jj + NK / 2) + 2 * h + 1)) & 1 ? b1 : -INFINITY;
        }
        mx[h][jj] = fmaxf(fmaxf(a0, a1), fmaxf(b0, b1));
      }
    float msc[2];                    // -(the new max), for the FFMAs
    #pragma unroll
    for (int h = 0; h < 2; ++h) {
      #pragma unroll
      for (int w = NK / 4; w >= 1; w /= 2)
        #pragma unroll
        for (int jj = 0; jj < w; ++jj) mx[h][jj] = fmaxf(mx[h][jj], mx[h][jj + w]);
      float x = mx[h][0];
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      // a tile with no live key in the row leaves m (an all -inf max times
      // a zero scale is NaN, which fmaxf drops)
      const float m_new = fmaxf(m[h], asl2 * x);
      corr[h] = fast_exp2(m[h] - m_new);
      m[h] = m_new;
      msc[h] = -m_new;
    }
    // computed for every pair and selected: a branch around the
    // exponential would make every element a divergent region
    float ls[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    #pragma unroll
    for (int jj = 0; jj < NK; ++jj)
      #pragma unroll
      for (int r = 0; r < 4; ++r) {
        float p = fast_exp2(fmaf(s[jj][r], sl2, msc[r >> 1]));
        if (edge) p = (live >> (4 * jj + r)) & 1 ? p : 0.f;
        ls[r >> 1][jj & 1] += p;     // this lane's part of the row sum, unrounded
        s[jj][r] = p;
      }
    #pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + (ls[h][0] + ls[h][1]);
  };
  auto softmax_tile = [&](int j) {
    if (sl2 >= 0.f) softmax(j, std::true_type{});
    else softmax(j, std::false_type{});
  };
  auto to_a = [&]() {
    #pragma unroll
    for (int c = 0; c < BN / 16; ++c) c_to_a<E>(pa[c], s[2 * c], s[2 * c + 1]);
  };

  // key tile 0's scores; then its K slot takes tile NS
  mbar_wait(&bars[2 * NS], 0);
  mbar_wait(&kbar[0], 0);
  wgmma_fence();
  scores(0);
  wgmma_wait<0>();
  fence_acc(s);
  __syncthreads();                   // every product that read K slot 0 has retired
  if (NS < n) issue_k(NS);
  softmax_tile(0);                   // O is 0: no rescale
  // tile i's P . V with tile i + 1's scores in flight: S_{i+1} is committed
  // first, so wait<1> retires it while P . V may still run; O is rescaled by
  // the new max once P . V has retired.  Then K slot (i + 1) % NS takes tile
  // i + 1 + NS and V slot i % NS tile i + NS.
  for (int i = 0; i + 1 < n; ++i) {
    to_a();
    mbar_wait(&kbar[(i + 1) % NS], ((i + 1) / NS) & 1);
    mbar_wait(&vbar[i % NS], (i / NS) & 1);
    wgmma_fence();
    scores(i + 1);
    pv(i);
    wgmma_wait<1>();
    fence_acc(s);
    softmax_tile(i + 1);
    wgmma_wait<0>();
    fence_acc(acc);
    fence_a(pa);
    #pragma unroll
    for (int j = 0; j < ND; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }
    __syncthreads();                 // every product that read those slots has retired
    if (i + 1 + NS < n) issue_k(i + 1 + NS);
    if (i + NS < n) issue_v(i + NS);
  }
  to_a();
  mbar_wait(&vbar[(n - 1) % NS], ((n - 1) / NS) & 1);
  wgmma_fence();
  pv(n - 1);
  wgmma_wait<0>();
  fence_acc(acc);
  fence_a(pa);

  float inv[2];
  #pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] = fmaxf(l[h], 1e-30f);
    inv[h] = 1.f / l[h];
  }
  store_c_rows<DP>(o + qoff, acc, inv, qw, T_, D, lane);
  if (t == 0) {
    #pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = qw + gq + 8 * h;
      if (qi < T_)
        lse[(size_t)bh * T_ + qi] = (m[h] > NEG_LARGE / 2) ? m[h] * LN2 + logf(l[h]) : 1e30f;
    }
  }
}

template <int DP, typename E>
int launch(const void* q, const void* k, const void* v, const int* kmask, void* o,
           float* lse, int B, int H, int T_, int S, int D, float scale, int causal,
           cudaStream_t stream) {
  constexpr size_t smem = Cfg<DP>::SMEM;
  // once per template instance (a thread-safe static initialiser)
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<DP, E>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const int BH = B * H;
  const bool tma = tma_route({q, k, v}, D);
  CUtensorMap mq{}, mk{}, mv{};
  if (tma) {
    int rc;
    if ((rc = map_rows<E>(&mq, q, BH, T_, D, BM)) || (rc = map_rows<E>(&mk, k, BH, S, D, BN)) ||
        (rc = map_rows<E>(&mv, v, BH, S, D, BN)))
      return rc;
  }
  const dim3 grid(BH, (T_ + Cfg<DP>::BQ - 1) / Cfg<DP>::BQ);
  flash_fwd_wgmma_kernel<DP, E><<<grid, Cfg<DP>::NTH, smem, stream>>>(
      mq, mk, mv, static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), kmask, static_cast<E*>(o), lse, H, T_, S, D, scale,
      causal, (int)tma);
  return (int)cudaGetLastError();
}

template <typename E>
int forward(const void* q, const void* k, const void* v, const void* kmask, void* o,
            void* lse, int B, int H, int T_, int S, int D, float scale, int causal,
            void* stream) {
  if (B < 1 || H < 1 || T_ < 1 || S < 1 || D < 1 || D > 256) return -1;
  if ((long long)B * H > 2147483647LL || (T_ + BM - 1) / BM > 65535) return -1;
  const int* km = static_cast<const int*>(kmask);
  float* lo = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64) return launch<64, E>(q, k, v, km, o, lo, B, H, T_, S, D, scale, causal, st);
  if (D <= 128) return launch<128, E>(q, k, v, km, o, lo, B, H, T_, S, D, scale, causal, st);
  return launch<256, E>(q, k, v, km, o, lo, B, H, T_, S, D, scale, causal, st);
}

}  // namespace

// q [B,H,T,D], k/v [B,H,S,D] contiguous bf16 (dl4j_flash_fwd_tc) or f16
// (dl4j_flash_fwd_tc_f16), D <= 256; kmask [B,S] int32 or null; o like q;
// lse [B,H,T] f32.  Returns 0, a CUDA error code (or the driver's, from
// encoding a tensor map), or -1 for arguments the kernel does not take.
extern "C" int dl4j_flash_fwd_tc(const void* q, const void* k, const void* v,
                                 const void* kmask, void* o, void* lse, int B, int H,
                                 int T_, int S, int D, float scale, int causal,
                                 void* stream) {
  return forward<bf16>(q, k, v, kmask, o, lse, B, H, T_, S, D, scale, causal, stream);
}

extern "C" int dl4j_flash_fwd_tc_f16(const void* q, const void* k, const void* v,
                                     const void* kmask, void* o, void* lse, int B, int H,
                                     int T_, int S, int D, float scale, int causal,
                                     void* stream) {
  return forward<f16>(q, k, v, kmask, o, lse, B, H, T_, S, D, scale, causal, stream);
}

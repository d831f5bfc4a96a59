// Row-deterministic attention for the decode program (kernel D1), Hopper.
//
// A repair with no Pallas counterpart: it replaces the broadcast-multiply and
// trailing-axis sums of deeplearning4j_tpu_torch/ops/kv_cache.py::
// det_attention_plain, which mirrors deeplearning4j_tpu/ops/kv_cache.py::
// det_attention (plain XLA there).  Same function: softmax(q.k^T / sqrt(d) +
// bias) . v over a key length L, bias additive (0 visible, NEG_INF masked).
//
// Contract.  A query row gives the same bits whether it is computed in a
// prefill (a padded bucket of rows, L keys), a decode step (one row per slot,
// L keys) or a re-encode (t rows, t keys).  The design fixes the arithmetic of
// a row, not the thread that does it:
//   * keys fall in chunks of C = 64, aligned to key 0, whatever L, Tq or B;
//   * one partial (m_c, l_c, o_c) per (row, chunk), always computed by
//     chunk_partial() with the same thread mapping: each score's d-sum is a
//     sequential chain of __fmaf_rn over d; x = s * scale + bias; m_c is the
//     chunk's max over visible keys; p = 2^((x - m_c) log2 e) by one ex2;
//     l_c sums p over keys in ascending order; o_c sums p * v over keys in
//     ascending order.  A masked key (bias <= NEG_INF / 2) and an absent key
//     (past L) give p = 0 exactly and select v = 0, so scratch rows of the
//     page pool (which may hold anything) are never multiplied in;
//   * a chunk where the row sees no key has m_c = -inf and is skipped by
//     combine_factors(), in every launch shape;
//   * partials are combined in ascending chunk order (combine_factors(),
//     combine_one()): m' =
//     max(m, m_c), l' = l a + l_c b, o' = o a + o_c b, a = 2^((m - m') log2 e),
//     b = 2^((m_c - m') log2 e); out = o / l.
// Every operation on that path is an explicit rounding intrinsic, so the
// compiler cannot contract it differently in the two launches below.
// A row that sees no key at all keeps the plain version's answer: weights
// exp(bias - max bias) over all L keys (empty_row()).
//
// Two launch shapes share those two functions, so the choice never shows in
// the bits:
//   * tiled (prefill, re-encode): one block per (b, h, tile of 32 query rows),
//     heaviest tiles first; a pre-pass finds the tile's last visible key, and
//     the block walks the chunks up to it with K/V staged in shared memory by
//     16-byte cp.async copies, double-buffered (the next chunk is in flight
//     during the current one's math).  Every row of the tile reuses each
//     staged chunk; each thread holds a 4-row x 4-key score tile and a 4-row x
//     4-column (x DP/64) output tile, fed by float4 shared loads.
//   * split-key (decode step, any call with <= 32 rows): one block per
//     (b, h, row tile, chunk) writes its partials to scratch, skipping chunks
//     no row sees without reading K/V; a second launch combines each row's
//     partials in ascending chunk order, one warp per row.
// Head widths 129-256 (DP 256) keep C = 64 and chunk_partial as they are, so
// the contract holds unchanged: the tiled launch's double-buffered K/V (308
// KB at DP 256) does not fit in a block's 227 KB, so at DP 256 it stages one
// chunk at a time (the next chunk's copy issued after this one's math, 175 KB,
// the split launch's size), and each thread's output tile is 4 rows x 16
// columns.
//
// Bound on H100: 4*d flops per visible (row, key) pair against reading q, the
// bias, the K/V rows some query sees, and writing out once.  The step (48
// rows, each over its slot's cached keys) is bound by bytes, a 512-row prefill
// by operations on the f32 FFMA pipes: no tensor cores, since TF32 would break
// the 2e-5 agreement with the plain version and the per-row order fixes the
// d-sum as a sequential chain.

#include <cuda_runtime.h>

namespace {

constexpr int C = 64;            // keys per chunk
constexpr int RT = 32;           // query rows per tile
constexpr int NT = 128;          // threads: 8 row groups x 16
constexpr int PS = C + 4;        // row stride of the P tile (floats)
constexpr float NEG_HALF = -5e29f;          // bias at or below: masked
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp16(float* dst, const float* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 16 : 0;   // 0: no bytes read, the 16 bytes zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Args {
  const float* q; const float* k; const float* v; const float* bias; float* out;
  float* part;                   // split-key scratch: [B*H*Tq][nch][d + 2]
  int H, Tq, L, d, nch;
  long long qs0, qs1, qs2, ks0, ks1, ks2, bs0, bs1, bs2, bs3;
  float scale;
};

template <int DP> struct Smem {
  static constexpr int SP = DP + 4;                   // row stride of Q/K/V tiles
  static constexpr int NB = DP <= 128 ? 2 : 1;        // tiled: K/V buffers (DP 256: one)
  static constexpr int FLOATS = RT * SP + 2 * NB * C * SP + RT * PS;
  static constexpr int SPLIT_FLOATS = RT * SP + 2 * C * SP + RT * PS;  // split: one chunk
};

// The running state's update by one chunk's partial, in ascending chunk
// order; a chunk the row does not see (m_c = -inf) leaves it unchanged.
// Returns false for such a chunk; else the factors of the old state (a) and
// of the partial (b) to apply to l and each o.
__device__ __forceinline__ bool combine_factors(float& m, float mc, float& a, float& b) {
  if (mc == -INFINITY) return false;
  if (m == -INFINITY) {          // the first chunk the row sees: take it as is
    m = mc;
    a = 0.f;
    b = 1.f;
    return true;
  }
  const float mn = fmaxf(m, mc);
  a = ex2(__fmul_rn(__fsub_rn(m, mn), LOG2E));
  b = ex2(__fmul_rn(__fsub_rn(mc, mn), LOG2E));
  m = mn;
  return true;
}

__device__ __forceinline__ float combine_one(float x, float xc, float a, float b, bool first) {
  return first ? xc : __fmaf_rn(x, a, __fmul_rn(xc, b));
}

// A row that sees no key: the plain version's answer, weights
// exp(bias - max bias) over all L keys, for one column.
__device__ float empty_row(const float* br, long long bs3, const float* vb, long long ks2,
                           int L, int col) {
  float mb = -INFINITY;
  for (int j = 0; j < L; ++j) mb = fmaxf(mb, br[j * bs3]);
  float sum = 0.f, acc = 0.f;
  for (int j = 0; j < L; ++j) {
    const float w = expf(br[j * bs3] - mb);
    sum += w;
    acc = fmaf(w, vb[j * ks2 + col], acc);
  }
  return acc / sum;
}

// Row tile [RT, d] of q into Qs, zero-padded to [RT, DP].
template <int DP>
__device__ void load_q(const Args& a, float* Qs, int b, int h, int r0) {
  constexpr int SP = Smem<DP>::SP;
  for (int e = threadIdx.x; e < RT * DP; e += NT) {
    const int r = e / DP, c = e % DP;
    float x = 0.f;
    if (r0 + r < a.Tq && c < a.d) x = a.q[b * a.qs0 + h * a.qs1 + (r0 + r) * a.qs2 + c];
    Qs[r * SP + c] = x;
  }
}

// Chunk `ch` of K and V into Ks/Vs by 16-byte cp.async copies (zero-filled
// past L and past d); the caller commits.
template <int DP>
__device__ void load_kv(const Args& a, float* Ks, float* Vs, int b, int h, int ch) {
  constexpr int SP = Smem<DP>::SP;
  constexpr int SEG = DP / 4;
  const int k0 = ch * C;
  const float* kb = a.k + b * a.ks0 + h * a.ks1;
  const float* vb = a.v + b * a.ks0 + h * a.ks1;
  for (int e = threadIdx.x; e < C * SEG; e += NT) {
    const int r = e / SEG, c4 = (e % SEG) * 4;
    const bool ok = k0 + r < a.L && c4 < a.d;
    const long long off = ok ? (long long)(k0 + r) * a.ks2 + c4 : 0;
    cp16(Ks + r * SP + c4, kb + off, ok);
    cp16(Vs + r * SP + c4, vb + off, ok);
  }
}

// This thread's bias values for chunk `ch` (rows ty + 8i, keys tx + 16j) and
// which keys are visible; returns whether any is.
__device__ __forceinline__ bool load_bias(const Args& a, int b, int h, int r0, int ch,
                                          float (&bj)[4][4], bool (&vis)[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  bool any = false;
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 8 * i;
    #pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = ch * C + tx + 16 * j;
      float x = -INFINITY;
      if (r < a.Tq && key < a.L) x = a.bias[b * a.bs0 + h * a.bs1 + r * a.bs2 + key * a.bs3];
      bj[i][j] = x;
      vis[i][j] = x > NEG_HALF;
      any |= vis[i][j];
    }
  }
  return any;
}

// One chunk's partial for rows ty + 8i of the tile: m_c, l_c and o_c over
// columns g*64 + tx*4 + c.  The same function, with the same thread mapping,
// in both launch shapes.  A half-warp (one ty) whose rows all lie past the
// tile's `rows` valid ones skips it: the other rows' arithmetic is the same.
template <int DP>
__device__ __forceinline__ void chunk_partial(const float* Qs, const float* Ks, const float* Vs,
                                              float* Ps, const float (&bj)[4][4],
                                              const bool (&vis)[4][4], float scale, int rows,
                                              float (&mc)[4], float (&lc)[4],
                                              float (&oc)[4][DP / 16]) {
  constexpr int SP = Smem<DP>::SP;
  constexpr int NG = DP / 64;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const unsigned half = 0xffffu << (threadIdx.x & 16);   // this half-warp's lanes
  if (ty >= rows) {
    #pragma unroll
    for (int i = 0; i < 4; ++i) mc[i] = -INFINITY;
    return;
  }
  float s[4][4];
  #pragma unroll
  for (int i = 0; i < 4; ++i)
    #pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  #pragma unroll 4
  for (int c = 0; c < DP; c += 4) {
    float4 qv[4], kv[4];
    #pragma unroll
    for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 8 * i) * SP + c);
    #pragma unroll
    for (int j = 0; j < 4; ++j) kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * SP + c);
    #pragma unroll
    for (int i = 0; i < 4; ++i)
      #pragma unroll
      for (int j = 0; j < 4; ++j) {
        float t = __fmaf_rn(qv[i].x, kv[j].x, s[i][j]);
        t = __fmaf_rn(qv[i].y, kv[j].y, t);
        t = __fmaf_rn(qv[i].z, kv[j].z, t);
        s[i][j] = __fmaf_rn(qv[i].w, kv[j].w, t);
      }
  }
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    float x[4], mx = -INFINITY;
    #pragma unroll
    for (int j = 0; j < 4; ++j) {
      x[j] = __fadd_rn(__fmul_rn(s[i][j], scale), bj[i][j]);
      if (vis[i][j]) mx = fmaxf(mx, x[j]);
    }
    #pragma unroll
    for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(half, mx, off));
    mc[i] = mx;
    #pragma unroll
    for (int j = 0; j < 4; ++j)
      Ps[(ty + 8 * i) * PS + tx + 16 * j] =
          vis[i][j] ? ex2(__fmul_rn(__fsub_rn(x[j], mx), LOG2E)) : 0.f;
  }
  __syncwarp(half);              // P rows ty + 8i are this half-warp's own
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    lc[i] = 0.f;
    #pragma unroll
    for (int c = 0; c < 4 * NG; ++c) oc[i][c] = 0.f;
  }
  #pragma unroll 2
  for (int kk = 0; kk < C; kk += 4) {
    float4 pr[4];
    #pragma unroll
    for (int i = 0; i < 4; ++i) pr[i] = *reinterpret_cast<const float4*>(Ps + (ty + 8 * i) * PS + kk);
    #pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float4 vv[NG];
      #pragma unroll
      for (int g = 0; g < NG; ++g)
        vv[g] = *reinterpret_cast<const float4*>(Vs + (kk + jj) * SP + g * 64 + tx * 4);
      #pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = jj == 0 ? pr[i].x : jj == 1 ? pr[i].y : jj == 2 ? pr[i].z : pr[i].w;
        const bool live = p != 0.f;
        lc[i] = __fadd_rn(lc[i], p);
        #pragma unroll
        for (int g = 0; g < NG; ++g) {
          oc[i][4 * g + 0] = __fmaf_rn(p, live ? vv[g].x : 0.f, oc[i][4 * g + 0]);
          oc[i][4 * g + 1] = __fmaf_rn(p, live ? vv[g].y : 0.f, oc[i][4 * g + 1]);
          oc[i][4 * g + 2] = __fmaf_rn(p, live ? vv[g].z : 0.f, oc[i][4 * g + 2]);
          oc[i][4 * g + 3] = __fmaf_rn(p, live ? vv[g].w : 0.f, oc[i][4 * g + 3]);
        }
      }
    }
  }
}

// Tiled launch: grid (B*H, row tiles); tiles in reverse, heaviest first.
template <int DP>
__global__ void __launch_bounds__(NT)
det_attention_tiled(Args a) {
  constexpr int SP = Smem<DP>::SP;
  constexpr int NG = DP / 64;
  constexpr int NB = Smem<DP>::NB;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + RT * SP;       // [NB][C][SP]
  float* Vs = Ks + NB * C * SP;   // [NB][C][SP]
  float* Ps = Vs + NB * C * SP;   // [RT][PS]
  __shared__ int last_key;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * RT;
  const int rows = min(RT, a.Tq - r0);

  // the tile's last visible key: chunks past it are never loaded
  if (threadIdx.x == 0) last_key = -1;
  __syncthreads();
  int last = -1;
  const float* bt = a.bias + b * a.bs0 + h * a.bs1 + (long long)r0 * a.bs2;
  if (a.bs3 == 1 && a.bs2 % 4 == 0 && a.L % 4 == 0 && reinterpret_cast<size_t>(bt) % 16 == 0) {
    const int n4 = a.L / 4;      // float4 loads, eight in flight per thread
    #pragma unroll 8
    for (int e = threadIdx.x; e < rows * n4; e += NT) {
      const int r = e / n4, c = (e % n4) * 4;
      const float4 x = *reinterpret_cast<const float4*>(bt + r * a.bs2 + c);
      if (x.x > NEG_HALF) last = max(last, c);
      if (x.y > NEG_HALF) last = max(last, c + 1);
      if (x.z > NEG_HALF) last = max(last, c + 2);
      if (x.w > NEG_HALF) last = max(last, c + 3);
    }
  } else {
    #pragma unroll 8
    for (int e = threadIdx.x; e < rows * a.L; e += NT) {
      const int r = e / a.L, key = e % a.L;
      if (bt[r * a.bs2 + key * a.bs3] > NEG_HALF) last = max(last, key);
    }
  }
  if (last >= 0) atomicMax(&last_key, last);
  load_q<DP>(a, Qs, b, h, r0);
  __syncthreads();
  const int nch = last_key < 0 ? 0 : last_key / C + 1;

  float m[4], l[4], o[4][4 * NG];
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
    #pragma unroll
    for (int c = 0; c < 4 * NG; ++c) o[i][c] = 0.f;
  }
  if (nch > 0) load_kv<DP>(a, Ks, Vs, b, h, 0);
  cp_commit();
  for (int ch = 0; ch < nch; ++ch) {
    const int buf = NB == 2 ? ch & 1 : 0;
    if (NB == 2 && ch + 1 < nch) {
      load_kv<DP>(a, Ks + (buf ^ 1) * C * SP, Vs + (buf ^ 1) * C * SP, b, h, ch + 1);
      cp_commit();
    }
    float bj[4][4];
    bool vis[4][4];
    load_bias(a, b, h, r0, ch, bj, vis);   // in flight while the copies land
    if (NB == 2 && ch + 1 < nch) cp_wait<1>();
    else cp_wait<0>();
    __syncthreads();
    float mc[4], lc[4], oc[4][4 * NG];
    chunk_partial<DP>(Qs, Ks + buf * C * SP, Vs + buf * C * SP, Ps, bj, vis, a.scale, rows, mc,
                      lc, oc);
    #pragma unroll
    for (int i = 0; i < 4; ++i) {
      float fa, fb;
      const bool first = m[i] == -INFINITY;
      if (!combine_factors(m[i], mc[i], fa, fb)) continue;
      l[i] = combine_one(l[i], lc[i], fa, fb, first);
      #pragma unroll
      for (int c = 0; c < 4 * NG; ++c) o[i][c] = combine_one(o[i][c], oc[i][c], fa, fb, first);
    }
    __syncthreads();             // buffer `buf` and Ps are free for the next chunks
    if (NB == 1 && ch + 1 < nch) {   // one buffer: the next chunk once this one is done
      load_kv<DP>(a, Ks, Vs, b, h, ch + 1);
      cp_commit();
    }
  }

  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 8 * i;
    if (r >= a.Tq) continue;
    float* orow = a.out + ((long long)bh * a.Tq + r) * a.d;
    #pragma unroll
    for (int g = 0; g < NG; ++g)
      #pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = g * 64 + tx * 4 + c;
        if (col >= a.d) continue;
        orow[col] = m[i] == -INFINITY
            ? empty_row(a.bias + b * a.bs0 + h * a.bs1 + r * a.bs2, a.bs3,
                        a.v + b * a.ks0 + h * a.ks1, a.ks2, a.L, col)
            : __fdiv_rn(o[i][4 * g + c], l[i]);
      }
  }
}

// Split-key launch, first pass: grid (B*H, row tiles, chunks); one chunk's
// partials for a tile of rows, to scratch.
template <int DP>
__global__ void __launch_bounds__(NT)
det_attention_split(Args a) {
  constexpr int SP = Smem<DP>::SP;
  constexpr int NG = DP / 64;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + RT * SP;
  float* Vs = Ks + C * SP;
  float* Ps = Vs + C * SP;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int r0 = blockIdx.y * RT, ch = blockIdx.z;
  const int W = a.d + 2;
  float bj[4][4];
  bool vis[4][4];
  const bool any = __syncthreads_or(load_bias(a, b, h, r0, ch, bj, vis));
  if (!any) {                    // no row sees this chunk: K/V are not read
    if (tx == 0)
      #pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + ty + 8 * i;
        if (r < a.Tq) a.part[(((long long)bh * a.Tq + r) * a.nch + ch) * W] = -INFINITY;
      }
    return;
  }
  load_kv<DP>(a, Ks, Vs, b, h, ch);
  cp_commit();
  load_q<DP>(a, Qs, b, h, r0);
  cp_wait<0>();
  __syncthreads();
  float mc[4], lc[4], oc[4][4 * NG];
  chunk_partial<DP>(Qs, Ks, Vs, Ps, bj, vis, a.scale, min(RT, a.Tq - r0), mc, lc, oc);
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 8 * i;
    if (r >= a.Tq) continue;
    float* pr = a.part + (((long long)bh * a.Tq + r) * a.nch + ch) * W;
    if (tx == 0) {
      pr[0] = mc[i];
      pr[1] = lc[i];
    }
    #pragma unroll
    for (int g = 0; g < NG; ++g)
      #pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = g * 64 + tx * 4 + c;
        if (col < a.d) pr[2 + col] = oc[i][4 * g + c];
      }
  }
}

// Split-key launch, second pass: one warp per row combines its partials in
// ascending chunk order; lane owns columns lane, lane + 32, ... (NG of them:
// 4 up to d 128, 8 at d 256)
template <int NG>
__global__ void __launch_bounds__(NT)
det_attention_combine(Args a, long long n_rows) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (NT / 32) + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const int W = a.d + 2;
  const float* part = a.part + row * a.nch * W;
  float m = -INFINITY, l = 0.f, o[NG];
  #pragma unroll
  for (int g = 0; g < NG; ++g) o[g] = 0.f;
  constexpr int U = 8;           // chunks whose partials are loaded before they are combined
  for (int c0 = 0; c0 < a.nch; c0 += U) {
    float mv[U], lv[U], ov[U][NG];
    #pragma unroll
    for (int u = 0; u < U; ++u) {
      const float* pr = part + (c0 + u) * W;
      const bool in = c0 + u < a.nch;
      mv[u] = in ? pr[0] : -INFINITY;
      lv[u] = in ? pr[1] : 0.f;
      #pragma unroll
      for (int g = 0; g < NG; ++g) ov[u][g] = in && lane + 32 * g < a.d ? pr[2 + lane + 32 * g] : 0.f;
    }
    #pragma unroll
    for (int u = 0; u < U; ++u) {
      float fa, fb;
      const bool first = m == -INFINITY;
      if (!combine_factors(m, mv[u], fa, fb)) continue;
      l = combine_one(l, lv[u], fa, fb, first);
      #pragma unroll
      for (int g = 0; g < NG; ++g) o[g] = combine_one(o[g], ov[u][g], fa, fb, first);
    }
  }
  const int t = (int)(row % a.Tq), bh = (int)(row / a.Tq);
  const int b = bh / a.H, h = bh % a.H;
  #pragma unroll
  for (int g = 0; g < NG; ++g) {
    const int col = lane + 32 * g;
    if (col >= a.d) continue;
    a.out[row * a.d + col] = m == -INFINITY
        ? empty_row(a.bias + b * a.bs0 + h * a.bs1 + t * a.bs2, a.bs3,
                    a.v + b * a.ks0 + h * a.ks1, a.ks2, a.L, col)
        : __fdiv_rn(o[g], l);
  }
}

template <int DP>
int launch(const Args& a, int B, int split, cudaStream_t st) {
  const size_t smem = (size_t)Smem<DP>::FLOATS * sizeof(float);
  const size_t smem_split = (size_t)Smem<DP>::SPLIT_FLOATS * sizeof(float);
  // once per template instance (a thread-safe static initialiser)
  static const cudaError_t attr = [&] {
    cudaError_t e = cudaFuncSetAttribute(det_attention_tiled<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(det_attention_split<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_split);
    return e;
  }();
  if (attr != cudaSuccess) return (int)attr;
  const unsigned tiles = (unsigned)((a.Tq + RT - 1) / RT);
  const unsigned bh = (unsigned)(B * a.H);
  if (split) {
    det_attention_split<DP><<<dim3(bh, tiles, (unsigned)a.nch), NT, smem_split, st>>>(a);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const long long rows = (long long)B * a.H * a.Tq;
    det_attention_combine<(DP <= 128 ? 4 : 8)>
        <<<(unsigned)((rows + NT / 32 - 1) / (NT / 32)), NT, 0, st>>>(a, rows);
  } else {
    det_attention_tiled<DP><<<dim3(bh, tiles), NT, smem, st>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// d <= 256; q [B,H,Tq,d] f32 with strides (qs0, qs1, qs2, 1); k, v [B,H,L,d] f32 with
// strides (ks0, ks1, ks2, 1), the same for both, 16-byte aligned rows (d and
// the strides multiples of 4); bias f32 addressed by strides (bs0..bs3) over
// [B,H,Tq,L] (0 for a broadcast axis); out [B,H,Tq,d] contiguous.  split != 0
// takes the split-key launch, whose scratch `part` holds B*H*Tq*ceil(L/64)*
// (d + 2) floats.  Returns 0, a CUDA error code, or -1 for arguments it does
// not take.
extern "C" int dl4j_det_attention(const void* q, const void* k, const void* v,
                                  const void* bias, void* out, void* part, int B, int H,
                                  int Tq, int L, int d, long long qs0, long long qs1,
                                  long long qs2, long long ks0, long long ks1, long long ks2,
                                  long long bs0, long long bs1, long long bs2, long long bs3,
                                  float scale, int split, void* stream) {
  if (B < 1 || H < 1 || Tq < 1 || L < 1 || d < 1 || d > 256 || d % 4) return -1;
  if ((long long)B * H > 2147483647LL || (Tq + RT - 1) / RT > 65535) return -1;
  if (ks0 % 4 || ks1 % 4 || ks2 % 4 || reinterpret_cast<size_t>(k) % 16 ||
      reinterpret_cast<size_t>(v) % 16)
    return -1;
  if (split && (part == nullptr || (L + C - 1) / C > 65535)) return -1;
  Args a{static_cast<const float*>(q), static_cast<const float*>(k),
         static_cast<const float*>(v), static_cast<const float*>(bias),
         static_cast<float*>(out), static_cast<float*>(part),
         H, Tq, L, d, (L + C - 1) / C,
         qs0, qs1, qs2, ks0, ks1, ks2, bs0, bs1, bs2, bs3, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 64) return launch<64>(a, B, split, st);
  if (d <= 128) return launch<128>(a, B, split, st);
  return launch<256>(a, B, split, st);
}

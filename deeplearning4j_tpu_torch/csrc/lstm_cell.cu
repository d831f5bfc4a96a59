// The LSTM forward over a sequence (kernel K5a) and the cell backward (kernel
// K5b) for Hopper.
//
// Replaces deeplearning4j_tpu/ops/lstm_kernel.py::_fwd_kernel and ::_bwd_kernel
// (one pallas_call each through _pallas_call).  The TPU's K5a is one cell step
// inside lax.scan, where XLA fused h·RW and the gate sums into the step; the
// card has no such fusion, so K5a here takes over the whole step loop of one
// layer (the seam the reference module names for a multi-step-fused variant):
//   K5a  for t over T steps (backwards when reverse): z_t = (zx_t + h_{t-1}·RW) + b,
//        rounded where the plain version rounds (after the product and after
//        each add: bf16 rounds, f32 is exact), then the cell from (z_t, c_{t-1})
//        in gate order [i|f|o|g]: i, f, o = sigmoid, g = tanh, c = f*c + i*g,
//        h = o*tanh(c), then with a mask m the hold m*new + (1 - m)*old.
//        Writes hs [mb, T, n], z and c of every step time-major ([T, mb, 4n],
//        [T, mb, n]: K5b's per-step slices are contiguous) and the last (h, c);
//   K5b  the closed-form backward (_bwd_math): the gates recomputed from (z, c),
//        then dz [mb, 4n] and dc [mb, n] from the cotangents dh, dc'.
// Inputs and outputs are float32, bfloat16 or float16 (one dtype); the math
// runs in f32 and each stored value is rounded to the dtype.
// The cell's products and sums are written with __fmul_rn / __fadd_rn /
// __fsub_rn in the plain version's order, so nvcc cannot contract them into
// FMAs: in f32 the cell rounds as the plain PyTorch version's separate ops do,
// and differs from it only where expf / tanhf differ.  h·RW is a sum in a
// fixed order of its own (FMAs), so a second launch is bitwise the first.
//
// K5a's design: one persistent cooperative launch per layer and sequence.  A
// tile is 16 rows x 8 units (all four gate columns of its units, 32 columns
// of z), so the cell needs nothing from another block.  A block keeps its
// tile's RW columns (n x 32 floats, 32 KB at n = 256) in shared memory for all
// T steps when every tile fits on the card at once (one tile a block); else
// the blocks loop over the tiles and stage RW's chunk from L2 each step.  Each
// step a block stages h_{t-1} of its 16 rows in chunks of 256 k through L2
// (ld.global.cg: other blocks wrote it); 256 threads each compute a 4-row x
// 4-gate register tile of the product over one of 8 k splits (float4 shared
// loads: 64 FFMAs to 8 loads); the 8 partial sums meet in shared memory, and
// 128 threads add them in split order and run z, the cell and the hold in
// registers.  Then a grid barrier (a counter of arrived blocks, release /
// acquire), and the next step.  The launch is cudaLaunchCooperativeKernel on a
// grid no larger than the card holds at once (cudaOccupancy...), so every
// block is resident before any waits; a grid the card cannot hold is refused
// and reported, never run.  The grid follows (mb, n): the char-RNN's
// [64, 50, 256] gets 128 blocks, the stream's [1, 1, 256] 32.
// K5b: a 2-D grid, the row from blockIdx.y and a chunk of 64 units of the row
// from blockIdx.x, one unit a thread, so a thread finds its place with no
// division (the grid-stride loop's 64-bit idx / n costs tens of dependent
// instructions before the first address), and it issues all 7 loads before
// the first exponential.  The char-RNN's [64, 256] gets 256 blocks of 64
// threads over the 132 SMs, where the grid-stride launch ran 64 blocks of 256.
//
// Bound on H100: K5a at the char-RNN's [64, 50, 256] f32 does 64·50·256·1024
// FMAs (0.025 ms at the 67 TFLOP/s FFMA peak) and moves RW once, zx, z, hs and
// c (34 MB, 0.010 ms): bound by operations; in practice by its 50 dependent
// steps, each a short product, the partial sums and a grid barrier.  K5b moves
// 12 values per (r, j) (4 z, c, dh, dc' in; 4 dz, dc out) for ~45 operations:
// bound by memory bandwidth (3.35 TB/s), 0.79 MB at [64, 256], under a
// microsecond, so a launch is bound by launch latency and one round trip to
// memory.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

__device__ __forceinline__ float get(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float get(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void put(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}
__device__ __forceinline__ float get(const __half* p, long long i) { return __half2float(p[i]); }
__device__ __forceinline__ void put(__half* p, long long i, float v) { p[i] = __float2half_rn(v); }

// PyTorch's CUDA sigmoid: 1 / (1 + exp(-x)) in f32
__device__ __forceinline__ float sigm(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// ---- K5a: the forward over a sequence, one persistent cooperative launch ----

constexpr int kSeqThreads = 256;
constexpr int kTileRows = 16;                                     // rows of a tile
constexpr int kTileUnits = 8;                                     // units: 32 columns of z
constexpr int kRowsPerThread = 4;                                 // rows rg, rg+4, rg+8, rg+12
constexpr int kRowGroups = kTileRows / kRowsPerThread;            // 4
constexpr int kSplits = kSeqThreads / (kTileUnits * kRowGroups);  // 8 k splits, a warp each
constexpr int kChunk = 256;           // k of h staged in shared memory at once
constexpr int kHStride = kChunk + 4;  // padded: the 4 rows a warp reads start 4 banks apart
constexpr int kKPad = 4 * kSplits;    // k is padded with zeros to a multiple of 32
static_assert(kTileUnits * kRowGroups == 32, "a warp is one k split");

struct SeqArgs {
  const void* zx;     // [mb, T, 4n]
  const void* rw;     // [n, 4n]
  const void* b;      // [4n]
  const void* h0;     // [mb, n]
  const void* c0;     // [mb, n]
  const float* mask;  // [mb, T] or null
  void* hs;           // [mb, T, n]
  void* zs;           // [T, mb, 4n]
  void* cs;           // [T, mb, n]
  void* h_out;        // [mb, n]
  void* c_out;        // [mb, n]
  unsigned* arrived;  // zeroed: blocks that have finished a step, summed over steps
  int mb, T, n, n_pad, reverse, row_tiles, tiles, vec;
};

// a value as the plain version stores it: bf16 and f16 round, f32 is exact
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (std::is_same<T, float>::value)
    return v;
  else if constexpr (std::is_same<T, __half>::value)
    return __half2float(__float2half_rn(v));
  else
    return __bfloat162float(__float2bfloat16_rn(v));
}

// a load through L2 only (ld.global.cg): another block wrote it in this launch
__device__ __forceinline__ float get_cg(const float* p, long long i) { return __ldcg(p + i); }
__device__ __forceinline__ float get_cg(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p) + i)));
}
__device__ __forceinline__ float get_cg(const __half* p, long long i) {
  return __half2float(__ushort_as_half(__ldcg(reinterpret_cast<const unsigned short*>(p) + i)));
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Every block of the grid has written step s before any block reads it, on a
// counter that only grows (target = gridDim.x * (s + 1)): the block's writes
// are ordered before its thread 0 by the block barrier, published by a release
// add and seen by the other blocks' acquire loads (as CUTLASS's GenericBarrier
// does; no full fence).
__device__ __forceinline__ void grid_barrier(unsigned* arrived, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(arrived), "r"(1u) : "memory");
    while (load_acquire(arrived) < target) {
    }
  }
  __syncthreads();
}

// h_s[r][k] = h[r0 + r][k0 + k] for k < klen, zero past mb or n, in f32
template <typename T>
__device__ __forceinline__ void stage_h(float* h_s, const T* h, long long row_stride, int r0,
                                        int k0, int klen, const SeqArgs& a) {
  if (a.vec) {  // 16-byte rows, n a multiple of their width: 16 bytes a load
    constexpr int kW = 16 / sizeof(T);  // 4 floats, or 8 bf16 or f16
    for (int i = threadIdx.x; i < kTileRows * kChunk / kW; i += kSeqThreads) {
      const int r = i / (kChunk / kW), k = (i % (kChunk / kW)) * kW;
      if (k >= klen) continue;
      const int gr = r0 + r, gk = k0 + k;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gr < a.mb && gk < a.n) v = __ldcg(reinterpret_cast<const uint4*>(h + gr * row_stride + gk));
      float* dst = h_s + r * kHStride + k;
      if constexpr (std::is_same<T, float>::value) {
        *reinterpret_cast<uint4*>(dst) = v;
      } else if constexpr (std::is_same<T, __half>::value) {
        const __half2* w = reinterpret_cast<const __half2*>(&v);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 f = __half22float2(w[q]);
          dst[2 * q] = f.x;
          dst[2 * q + 1] = f.y;
        }
      } else {
        const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // a bf16 is the top half of its f32
          dst[2 * q] = __uint_as_float(w[q] << 16);
          dst[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
        }
      }
    }
    return;
  }
  for (int i = threadIdx.x; i < kTileRows * kChunk; i += kSeqThreads) {
    const int r = i / kChunk, k = i % kChunk;
    if (k >= klen) continue;
    const int gr = r0 + r, gk = k0 + k;
    h_s[r * kHStride + k] = (gr < a.mb && gk < a.n) ? get_cg(h, gr * row_stride + gk) : 0.0f;
  }
}

// rw_s[k][u][g] = RW[k0 + k][g*n + u0 + u] for k < klen, zero past n
template <typename T>
__device__ __forceinline__ void stage_rw(float* rw_s, const T* rw, int u0, int k0, int klen,
                                         int n) {
  for (int i = threadIdx.x; i < klen * kTileUnits * 4; i += kSeqThreads) {
    const int u = i % kTileUnits, g = (i / kTileUnits) % 4, k = i / (kTileUnits * 4);
    const int gk = k0 + k, j = u0 + u;
    rw_s[(k * kTileUnits + u) * 4 + g] =
        (gk < n && j < n) ? get(rw, (long long)gk * 4 * n + (long long)g * n + j) : 0.0f;
  }
}

// One tile of step s: the product over k, the partial sums, then z, the cell
// and the hold of its 16 x 8 (row, unit) pairs, and their stores.
template <typename T, bool kResident>
__device__ __forceinline__ void tile_step(const SeqArgs& a, float* rw_s, float* h_s,
                                          float* part, int tile, int s) {
  const int tid = threadIdx.x;
  const int u = tid % kTileUnits, rg = (tid / kTileUnits) % kRowGroups, ks = tid / 32;
  const int r0 = (tile % a.row_tiles) * kTileRows, u0 = (tile / a.row_tiles) * kTileUnits;
  const int n = a.n;
  const int t = a.reverse ? a.T - 1 - s : s;
  const int tp = a.reverse ? t + 1 : t - 1;  // the step before, in walking order
  const T* h_prev = s == 0 ? static_cast<const T*>(a.h0)
                           : static_cast<const T*>(a.hs) + (long long)tp * n;
  const long long h_stride = s == 0 ? n : (long long)a.T * n;

  // the cell's thread for (row, unit) loads its step inputs first: their
  // latency runs under the product
  const int row = tid / kTileUnits, uu = tid % kTileUnits;
  const int gr = r0 + row, j = u0 + uu;
  const bool live = tid < kTileRows * kTileUnits && gr < a.mb && j < n;
  const long long cell = (long long)gr * n + j;
  float zxv[4] = {0.0f, 0.0f, 0.0f, 0.0f}, bv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float cp = 0.0f, hp = 0.0f, m = 1.0f;
  if (live) {
    const T* zx = static_cast<const T*>(a.zx) + ((long long)gr * a.T + t) * 4 * n + j;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      zxv[q] = get(zx, (long long)q * n);
      bv[q] = get(static_cast<const T*>(a.b), q * n + j);
    }
    cp = s == 0 ? get(static_cast<const T*>(a.c0), cell)
                : get_cg(static_cast<const T*>(a.cs), ((long long)tp * a.mb + gr) * n + j);
    if (a.mask != nullptr) {
      m = a.mask[(long long)gr * a.T + t];
      hp = s == 0 ? get(static_cast<const T*>(a.h0), cell)
                  : get_cg(static_cast<const T*>(a.hs), ((long long)gr * a.T + tp) * n + j);
    }
  }

  float acc[kRowsPerThread][4];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int g = 0; g < 4; ++g) acc[i][g] = 0.0f;
  for (int k0 = 0; k0 < a.n_pad; k0 += kChunk) {
    const int klen = min(kChunk, a.n_pad - k0);  // a multiple of kKPad
    __syncthreads();  // the last chunk's (or tile's) readers are done with h_s, rw_s, part
    stage_h<T>(h_s, h_prev, h_stride, r0, k0, klen, a);
    if (!kResident) stage_rw<T>(rw_s, static_cast<const T*>(a.rw), u0, k0, klen, n);
    __syncthreads();
    const float* w_s = kResident ? rw_s + k0 * kTileUnits * 4 : rw_s;
    for (int k = 4 * ks; k < klen; k += kKPad) {
      float4 hv[kRowsPerThread], wv[4];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        hv[i] = *reinterpret_cast<const float4*>(h_s + (rg + kRowGroups * i) * kHStride + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wv[kk] = *reinterpret_cast<const float4*>(w_s + ((k + kk) * kTileUnits + u) * 4);
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float hk[4] = {hv[i].x, hv[i].y, hv[i].z, hv[i].w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          acc[i][0] = fmaf(hk[kk], wv[kk].x, acc[i][0]);
          acc[i][1] = fmaf(hk[kk], wv[kk].y, acc[i][1]);
          acc[i][2] = fmaf(hk[kk], wv[kk].z, acc[i][2]);
          acc[i][3] = fmaf(hk[kk], wv[kk].w, acc[i][3]);
        }
      }
    }
  }
  float4* part4 = reinterpret_cast<float4*>(part);  // [split][row][unit] -> 4 gates
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
    part4[(ks * kTileRows + rg + kRowGroups * i) * kTileUnits + u] =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  __syncthreads();
  if (!live) return;
  float4 sum = part4[row * kTileUnits + uu];
#pragma unroll
  for (int q = 1; q < kSplits; ++q) {  // in split order: a fixed sum
    const float4 p = part4[(q * kTileRows + row) * kTileUnits + uu];
    sum = make_float4(__fadd_rn(sum.x, p.x), __fadd_rn(sum.y, p.y), __fadd_rn(sum.z, p.z),
                      __fadd_rn(sum.w, p.w));
  }
  const float hr[4] = {sum.x, sum.y, sum.z, sum.w};
  float z[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)  // (zx_t + h·RW) + b, rounded after each op
    z[q] = rnd<T>(__fadd_rn(rnd<T>(__fadd_rn(zxv[q], rnd<T>(hr[q]))), bv[q]));
  const float i = sigm(z[0]);
  const float f = sigm(z[1]);
  const float o = sigm(z[2]);
  const float g = tanhf(z[3]);
  // c' = f * c + i * g;  h' = o * tanh(c'), each as stored in T
  const float cu = __fadd_rn(__fmul_rn(f, cp), __fmul_rn(i, g));
  float hn = rnd<T>(__fmul_rn(o, tanhf(cu)));
  float cn = rnd<T>(cu);
  if (a.mask != nullptr) {  // m * new + (1 - m) * old
    hn = __fadd_rn(__fmul_rn(m, hn), __fmul_rn(__fsub_rn(1.0f, m), hp));
    cn = __fadd_rn(__fmul_rn(m, cn), __fmul_rn(__fsub_rn(1.0f, m), cp));
  }
  T* zs = static_cast<T*>(a.zs) + ((long long)t * a.mb + gr) * 4 * n + j;
#pragma unroll
  for (int q = 0; q < 4; ++q) put(zs, (long long)q * n, z[q]);
  put(static_cast<T*>(a.cs), ((long long)t * a.mb + gr) * n + j, cn);
  put(static_cast<T*>(a.hs), ((long long)gr * a.T + t) * n + j, hn);
  if (s == a.T - 1) {
    put(static_cast<T*>(a.h_out), cell, hn);
    put(static_cast<T*>(a.c_out), cell, cn);
  }
}

// Resident: grid == tiles, block b owns tile b and keeps its RW columns in
// shared memory for every step.  Streamed: the blocks loop over the tiles and
// stage RW's chunk beside h's.
template <typename T, bool kResident>
__global__ void __launch_bounds__(kSeqThreads, 2) lstm_seq_fwd_kernel(const SeqArgs a) {
  extern __shared__ float4 smem_f4[];
  float* rw_s = reinterpret_cast<float*>(smem_f4);
  float* h_s = rw_s + (kResident ? a.n_pad : kChunk) * kTileUnits * 4;
  float* part = h_s + kTileRows * kHStride;
  if (kResident)
    stage_rw<T>(rw_s, static_cast<const T*>(a.rw), (blockIdx.x / a.row_tiles) * kTileUnits, 0,
                a.n_pad, a.n);
  for (int s = 0; s < a.T; ++s) {
    for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x)
      tile_step<T, kResident>(a, rw_s, h_s, part, tile, s);
    if (s + 1 < a.T) grid_barrier(a.arrived, gridDim.x * (unsigned)(s + 1));
  }
}

constexpr size_t kSeqFixedSmem =
    (size_t)(kTileRows * kHStride + kSplits * kTileRows * kTileUnits * 4) * sizeof(float);

template <typename T, bool kResident>
int seq_blocks_per_sm(size_t smem) {
  const void* fn = reinterpret_cast<const void*>(&lstm_seq_fwd_kernel<T, kResident>);
  int occ = 0;
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, kSeqThreads, smem) !=
          cudaSuccess) {
    cudaGetLastError();  // not sticky: the caller takes the other layout or reports
    return 0;
  }
  return occ;
}

template <typename T, bool kResident>
int launch_seq(SeqArgs a, int grid, size_t smem, int* plan, cudaStream_t s) {
  if (plan != nullptr) {
    plan[0] = grid;
    plan[1] = kResident;
  }
  void* params[] = {&a};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(&lstm_seq_fwd_kernel<T, kResident>), grid, kSeqThreads,
      params, smem, s);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// The resident layout when every tile fits on the card at once, else the
// streamed one on as many blocks as the card holds.
template <typename T>
int launch_seq_fwd(const SeqArgs& a, int* plan, cudaStream_t s) {
  int dev = 0, sms = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t resident = kSeqFixedSmem + (size_t)a.n_pad * kTileUnits * 4 * sizeof(float);
  if (resident <= (size_t)optin &&
      (long long)seq_blocks_per_sm<T, true>(resident) * sms >= a.tiles)
    return launch_seq<T, true>(a, a.tiles, resident, plan, s);
  const size_t streamed = kSeqFixedSmem + (size_t)kChunk * kTileUnits * 4 * sizeof(float);
  const long long held = (long long)seq_blocks_per_sm<T, false>(streamed) * sms;
  if (held < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  return launch_seq<T, false>(a, (int)(held < a.tiles ? held : a.tiles), streamed, plan, s);
}

// K5b's threads a block: [64, 256] gets 256 blocks, enough for every SM
constexpr int kBwdThreads = 64;

// K5b's arithmetic for one (row, unit), in the plain version's order
struct CellGrad {
  float di, df, d_o, dg, dc;
};

__device__ __forceinline__ CellGrad cell_bwd(float zi, float zf, float zo, float zg, float cv,
                                             float dhv, float dcnv) {
  const float i = sigm(zi);
  const float f = sigm(zf);
  const float o = sigm(zo);
  const float g = tanhf(zg);
  const float cn = __fadd_rn(__fmul_rn(f, cv), __fmul_rn(i, g));
  const float tc = tanhf(cn);
  // do = dh * tc;  dct = dcn + dh * o * (1 - tc * tc)
  const float d_o = __fmul_rn(dhv, tc);
  const float dct =
      __fadd_rn(dcnv, __fmul_rn(__fmul_rn(dhv, o), __fsub_rn(1.0f, __fmul_rn(tc, tc))));
  // dz = [dct*g*i*(1-i), dct*c*f*(1-f), do*o*(1-o), dct*i*(1-g*g)];  dc = dct*f
  return {__fmul_rn(__fmul_rn(__fmul_rn(dct, g), i), __fsub_rn(1.0f, i)),
          __fmul_rn(__fmul_rn(__fmul_rn(dct, cv), f), __fsub_rn(1.0f, f)),
          __fmul_rn(__fmul_rn(d_o, o), __fsub_rn(1.0f, o)),
          __fmul_rn(__fmul_rn(dct, i), __fsub_rn(1.0f, __fmul_rn(g, g))),
          __fmul_rn(dct, f)};
}

// K5b: thread x of block (bx, r) owns unit bx*blockDim + x of row r (rows
// past gridDim.y by a stride).  A row's start is one 64-bit multiply; offsets
// within a row are 32-bit, so no index needs a division.  Every load is
// issued before the first exponential.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
lstm_cell_bwd_kernel(const T* __restrict__ z, const T* __restrict__ c, const T* __restrict__ dh,
                     const T* __restrict__ dcn, T* __restrict__ dz_out, T* __restrict__ dc_out,
                     int mb, int n) {
  const int j = (int)(blockIdx.x * blockDim.x + threadIdx.x);
  if (j >= n) return;
  for (int r = blockIdx.y; r < mb; r += gridDim.y) {
    const size_t row = (size_t)r * (unsigned)n;
    const T* zr = z + 4 * row;  // the gates' columns, a row apart by n
    const float zi = get(zr, j), zf = get(zr, j + n), zo = get(zr, j + 2 * n),
                zg = get(zr, j + 3 * n);
    const float cv = get(c + row, j), dhv = get(dh + row, j), dcnv = get(dcn + row, j);
    const CellGrad x = cell_bwd(zi, zf, zo, zg, cv, dhv, dcnv);
    T* dzr = dz_out + 4 * row;
    put(dzr, j, x.di);
    put(dzr, j + n, x.df);
    put(dzr, j + 2 * n, x.d_o);
    put(dzr, j + 3 * n, x.dg);
    put(dc_out + row, j, x.dc);
  }
}

template <typename T>
int launch_bwd(const void* z, const void* c, const void* dh, const void* dcn, void* dz_out,
               void* dc_out, int mb, int n, cudaStream_t s) {
  // blockIdx.y the row (a stride past 65535 rows), blockIdx.x 64 units of it
  const dim3 grid((unsigned)((n + kBwdThreads - 1) / kBwdThreads),
                  (unsigned)(mb < 65535 ? mb : 65535));
  lstm_cell_bwd_kernel<T><<<grid, kBwdThreads, 0, s>>>(
      static_cast<const T*>(z), static_cast<const T*>(c), static_cast<const T*>(dh),
      static_cast<const T*>(dcn), static_cast<T*>(dz_out), static_cast<T*>(dc_out), mb, n);
  return (int)cudaGetLastError();
}

}  // namespace

// K5a.  zx [mb, T, 4n], rw [n, 4n], b [4n], h0, c0 [mb, n], mask [mb, T] f32 or
// null -> hs [mb, T, n], zs [T, mb, 4n], cs [T, mb, n], h_out, c_out [mb, n];
// contiguous rows, f32 (dtype 0), bf16 (dtype 1) or f16 (dtype 2); arrived: one zeroed
// unsigned.  plan, when not null, receives the grid and whether RW stayed
// resident.  Returns 0, a CUDA error code, or -1 for arguments it does not take.
extern "C" int dl4j_lstm_seq_fwd(const void* zx, const void* rw, const void* b, const void* h0,
                                 const void* c0, const void* mask, void* hs, void* zs, void* cs,
                                 void* h_out, void* c_out, void* arrived, int mb, int T, int n,
                                 int reverse, int dtype, int* plan, void* stream) {
  if (mb < 1 || T < 1 || n < 1 || arrived == nullptr || dtype < 0 || dtype > 2) return -1;
  SeqArgs a{zx, rw, b, h0, c0, static_cast<const float*>(mask), hs, zs, cs, h_out, c_out,
            static_cast<unsigned*>(arrived), mb, T, n, (n + kKPad - 1) / kKPad * kKPad,
            reverse != 0, (mb + kTileRows - 1) / kTileRows, 0, 0};
  a.tiles = a.row_tiles * ((n + kTileUnits - 1) / kTileUnits);
  a.vec = n % (dtype ? 8 : 4) == 0 && reinterpret_cast<uintptr_t>(h0) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(hs) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_seq_fwd<__nv_bfloat16>(a, plan, s);
  if (dtype == 2) return launch_seq_fwd<__half>(a, plan, s);
  return launch_seq_fwd<float>(a, plan, s);
}

// z [mb, 4n], c, dh, dcn [mb, n] -> dz_out [mb, 4n], dc_out [mb, n]; as above.
extern "C" int dl4j_lstm_cell_bwd(const void* z, const void* c, const void* dh,
                                  const void* dcn, void* dz_out, void* dc_out, int mb, int n,
                                  int dtype, void* stream) {
  if (mb < 1 || n < 1 || dtype < 0 || dtype > 2) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_bwd<__nv_bfloat16>(z, c, dh, dcn, dz_out, dc_out, mb, n, s);
  if (dtype == 2) return launch_bwd<__half>(z, c, dh, dcn, dz_out, dc_out, mb, n, s);
  return launch_bwd<float>(z, c, dh, dcn, dz_out, dc_out, mb, n, s);
}

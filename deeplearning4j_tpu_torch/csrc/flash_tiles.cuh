// Helpers shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu,
// flash_fwd_tc.cu, flash_bwd_tc.cu): dtype conversions, ex2 exponentials,
// cp.async copies, float4 shared loads, the loader of row-major tiles padded
// by 16 bytes a row (the SIMT kernels), and, for the wgmma kernels, the
// packing of f32 accumulator pairs into bf16 or f16 A fragments and the row
// stores of accumulator tiles (wgmma.cuh: a warp's part of a wgmma tile has
// mma.sync's m16n8 layout).
// Each source includes this header and still builds alone
// (utils/cuda_build.py hashes the headers into every library's name).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f32<__half>(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// a value takes the input dtype before the product that reads it (identity
// for f32), as the reference's .astype(...) does
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32<T>(from_f32<T>(x));
}

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float fast_exp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * LOG2E));
  return y;
}
// 2^x (the caller folds log2 e into its operands)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 16 (cp16) or 4 (cp4) bytes global -> shared; !pred reads nothing and
// zero-fills the destination
__device__ __forceinline__ void cp16(void* dst, const void* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four neighbouring elements along d, as f32
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename T, int DP> struct Tile {
  static constexpr int E = 16 / sizeof(T);       // elements per 16-byte copy
  static constexpr int SP = DP + E;              // row stride (elements): +16 bytes
};

// Rows r0 .. r0+rows-1 of a [n, D] matrix into a [rows, SP] shared tile,
// zero past n and past D, by the block's NT threads: 16-byte cp.async
// copies when `vec` (D a multiple of 16 bytes, 16-byte aligned base), else
// plain loads and stores.  The caller commits and waits.
template <typename T, int DP, int NT>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int rows, int r0, int n, int D,
                                          bool vec) {
  constexpr int E = Tile<T, DP>::E, SP = Tile<T, DP>::SP, SEG = DP / E;
  if (vec) {
    for (int e = threadIdx.x; e < rows * SEG; e += NT) {
      const int r = e / SEG, c = (e % SEG) * E;
      const bool ok = r0 + r < n && c < D;
      cp16(dst + r * SP + c, src + (ok ? (size_t)(r0 + r) * D + c : 0), ok);
    }
  } else {
    for (int e = threadIdx.x; e < rows * DP; e += NT) {
      const int r = e / DP, c = e % DP;
      dst[r * SP + c] = (r0 + r < n && c < D) ? src[(size_t)(r0 + r) * D + c] : from_f32<T>(0.f);
    }
  }
}

// -- accumulator fragments (mma.sync's m16n8 layout, f32) ---------------------
//
// In a warp, lane = 4 g + t.  An A fragment (16 x 16 bf16 or f16, row-major)
// is four registers of two elements: a0 (row g, cols 2t, 2t+1), a1 (row g+8,
// the same cols), a2 (row g, cols 8+2t, 9+2t), a3 (row g+8, cols 8+2t,
// 9+2t).  An f32 accumulator block of 16 rows x 8 columns is four floats:
// c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8).  So the accumulators of
// two neighbouring 8-column blocks, packed to the input type, are the A
// fragment of the 16 columns they cover: a product's output feeds the next
// product from registers.

// two f32 rounded to E (bf16: cvt.rn.bf16x2.f32, f16: cvt.rn.f16x2.f32), the
// lower column in the low half
template <typename E> __device__ __forceinline__ unsigned pack2(float lo, float hi);
template <> __device__ __forceinline__ unsigned pack2<__nv_bfloat16>(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}
template <> __device__ __forceinline__ unsigned pack2<__half>(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// two neighbouring elements, rounded from f32, in one 4-byte store
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}
__device__ __forceinline__ void store2(__half* p, float x0, float x1) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(x0, x1);
}

// the A fragment of 16 columns from the accumulators of its two 8-column blocks
template <typename E = __nv_bfloat16>
__device__ __forceinline__ void c_to_a(unsigned a[4], const float lo[4], const float hi[4]) {
  a[0] = pack2<E>(lo[0], lo[1]);
  a[1] = pack2<E>(lo[2], lo[3]);
  a[2] = pack2<E>(hi[0], hi[1]);
  a[3] = pack2<E>(hi[2], hi[3]);
}

// rows [r0, r0 + 16) of a warp's 16 x DP f32 accumulator tile (acc[j] covers
// columns d0 + 8 j .. d0 + 8 j + 7) into out [n, D] as E, times mul[0] (row g)
// and mul[1] (row g + 8); rows past n and columns past D dropped
template <int DP, typename E>
__device__ __forceinline__ void store_c_rows(E* out, const float (*acc)[4], const float mul[2],
                                             int r0, int n, int D, int lane, int d0 = 0) {
  const int g = lane >> 2, t = lane & 3;
  #pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    if (r >= n) continue;
    E* row = out + (size_t)r * D;
    #pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int d = d0 + 8 * j + 2 * t;
      const float x0 = acc[j][2 * h] * mul[h], x1 = acc[j][2 * h + 1] * mul[h];
      if (d + 1 < D && (D & 1) == 0) {
        store2(row + d, x0, x1);
      } else {
        if (d < D) row[d] = from_f32<E>(x0);
        if (d + 1 < D) row[d + 1] = from_f32<E>(x1);
      }
    }
  }
}

}  // namespace

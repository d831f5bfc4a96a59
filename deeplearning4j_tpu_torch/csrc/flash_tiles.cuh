// Helpers shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// dtype conversions, ex2 exponentials, cp.async copies, float4 shared loads
// and the loader of row-major tiles padded by 16 bytes a row.  Each source
// includes this header and still builds alone (utils/cuda_build.py hashes
// the headers into every library's name).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
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

}  // namespace

// Hopper's warpgroup MMA (wgmma), its shared-memory descriptors, and the
// tensor-memory copies (TMA) and mbarriers that feed it, for the bf16 and f16
// flash kernels: the forward (flash_fwd_tc.cu) and the backward
// (flash_bwd_tc.cu).  Both input types are 2 bytes, so every layout below is
// the same for either; only the instruction's type, the A operand's packing
// (flash_tiles.cuh) and the tensor map's element type differ.
// The host half (tensor maps, the choice between TMA and plain stores) is
// here too, so both sources encode their maps the same way.  Each source
// that includes this header still builds alone (utils/cuda_build.py hashes
// the headers into every library's name).  sm_90a only: plain sm_90 refuses
// wgmma.
//
// -- tiles in shared memory ---------------------------------------------------
//
// A tile of R rows and DP 2-byte columns (DP 64, 128 or 256) is stored as DP / 64
// panels of 64 columns, panel p at byte p * R * 128; a panel's row r is 128
// bytes at r * 128 whose 16-byte chunks are permuted by the 128-byte swizzle:
// chunk c of row r sits at chunk c ^ (r % 8).  That is what TMA writes for a
// box of {64 columns, R rows} under CU_TENSOR_MAP_SWIZZLE_128B, and what a
// wgmma descriptor in 128-byte-swizzle mode reads, so long as each panel
// starts 1024-byte aligned (8 rows, one swizzle period; R is a multiple of
// 8).  sw128_off gives the element offset of (r, c) for code that writes a
// tile with plain stores.
//
// -- descriptors (PTX ISA, "Matrix Descriptor Format") ------------------------
//
// 64 bits: start address >> 4 in bits 0-13, leading byte offset (LBO) >> 4 in
// bits 16-29, stride byte offset (SBO) >> 4 in bits 32-45, base offset 0 in
// bits 49-51 (the panels are 1024-byte aligned), swizzle mode in bits 62-63
// (1 = 128-byte).
//   * K-major operand (the reduction dimension runs along the 128-byte rows:
//     A of any product here, and B = K or Q of S = Q.K^T, S^T = K.Q^T): an
//     instruction's k16 slice is 32 bytes of each row, so the slice at column
//     16 kk of panel p starts at panel + 32 kk bytes (the hardware applies the
//     swizzle to the address it forms); SBO = 1024, the step between 8-row
//     groups; LBO is not read.
//   * MN-major operand (B of dV += p^T.G, dK += ds^T.Q, dQ += ds.K: the
//     reduction runs down the rows, N along them; the instruction's transpose
//     bit for B is set): the k16 slice is rows 16 kk .. 16 kk + 15, starting
//     at panel 0 + 2048 kk bytes; SBO = 1024, the step between its two 8-row
//     groups; LBO = R * 128, the step from one 64-column panel to the next
//     along N.
//
// -- fragments ------------------------------------------------------------------
//
// wgmma.m64nNk16 (bf16 or f16 in, f32 sums) is issued by a warpgroup (4 warps) for a
// 64-row tile; warp w owns rows 16 w .. 16 w + 15, and within a warp the
// layout is mma.sync's m16n8 one (flash_tiles.cuh), repeated along N: with
// lane = 4 g + t, accumulator d[j][0..1] is (row g, columns 8 j + 2 t, +1) and
// d[j][2..3] is (row g + 8, the same columns).  The register A operand of a
// k16 slice is mma.sync's A fragment of the warp's 16 rows, so the
// accumulators of columns 16 c .. 16 c + 15 (d[2c], d[2c+1]), rounded to the
// input type by c_to_a, are the A operand of a product whose reduction runs over those
// columns: p^T and ds^T (K2) and ds (K3) never leave registers.
//
// -- asynchrony -----------------------------------------------------------------
//
// wgmma_fence() before the first wgmma of a batch (it orders earlier register
// writes to accumulators and A operands before the wgmma reads them);
// wgmma_commit() closes the batch and wgmma_wait<N>() waits until at most N
// batches are in flight.  The compiler does not know that the accumulators
// change after the asm statement returns: fence_acc() after a wait pins every
// later read of them below it, and fence_a() keeps a register A operand of a
// batch in flight unchanged until the wait that retires it.

#pragma once

#include <cuda.h>            // CUtensorMap and the driver's enums: types only, nothing links libcuda
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024-byte-aligned address at or after p (a block's dynamic
// shared memory is asked for 1024 bytes more than its tiles take)
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// element offset of (r, c) in a swizzled tile of `rows` rows (see above)
__device__ __forceinline__ int sw128_off(int r, int c, int rows) {
  const int cc = c & 63;
  return (c >> 6) * rows * 64 + r * 64 + (((cc >> 3) ^ (r & 7)) << 3) + (cc & 7);
}

// -- mbarriers ------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// after the inits, before any other thread or the copy engine uses the barriers
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// one arrival, and `bytes` more to come from TMA copies before the phase ends
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}
// an arrival on `bar` once this thread's earlier cp.async copies have
// landed (counted among the barrier's expected arrivals)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
// plain stores to shared memory made visible to the async proxy (wgmma, TMA)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// -- TMA: a box of a tensor map into shared memory, completing on `bar` -------

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// rows r0 .. r0 + rows - 1 of batch*head bh through a {64, rows, 1} box map
// (map_rows below), one box a 64-column panel (a box wholly past D is
// zero-filled and still counts its bytes)
template <int DP, typename E>
__device__ __forceinline__ void tma_rows(E* dst, const CUtensorMap* map,
                                         uint64_t* bar, int rows, int r0, int bh) {
  #pragma unroll
  for (int p = 0; p < DP / 64; ++p) tma_load_3d(dst + p * rows * 64, map, bar, 64 * p, r0, bh);
}

// rows r0 .. r0 + rows - 1 of a [n, D] matrix into a swizzled [rows, DP]
// tile, zero past n and D, by the block's NTH threads with plain loads (the
// route where TMA cannot address the tensor); the caller fences and arrives
template <typename E> __device__ __forceinline__ E zero_elem();
template <> __device__ __forceinline__ __nv_bfloat16 zero_elem<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}
template <> __device__ __forceinline__ __half zero_elem<__half>() { return __float2half_rn(0.f); }

template <int DP, int NTH, typename E>
__device__ __forceinline__ void load_rows_plain(E* dst, const E* src, int rows, int r0, int n,
                                                int D) {
  for (int e = threadIdx.x; e < rows * DP; e += NTH) {
    const int r = e / DP, c = e % DP;
    dst[sw128_off(r, c, rows)] =
        (r0 + r < n && c < D) ? src[(size_t)(r0 + r) * D + c] : zero_elem<E>();
  }
}

// -- descriptors and wgmma ----------------------------------------------------------

// a descriptor of a tile of element type E (bf16 or f16): the wgmma wrappers
// below take the instruction's type from it
template <typename E> struct SmemDesc {
  uint64_t v;
};

__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)1 << 62;
}
// the k16 slice at column 16 kk of a K-major tile of `rows` rows
template <typename E>
__device__ __forceinline__ SmemDesc<E> kmajor_desc(const E* tile, int rows, int kk) {
  return {sw128_desc(tile + (kk >> 2) * rows * 64 + (kk & 3) * 16, 16, 1024)};
}
// the k16 slice at rows 16 kk .. 16 kk + 15 of an MN-major tile of `rows` rows
template <typename E>
__device__ __forceinline__ SmemDesc<E> mnmajor_desc(const E* tile, int rows, int kk) {
  return {sw128_desc(tile + kk * 16 * 64, (uint32_t)rows * 128, 1024)};
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
template <int J> __device__ __forceinline__ void fence_acc(float (&d)[J][4]) {
  #pragma unroll
  for (int j = 0; j < J; ++j)
    #pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+f"(d[j][r])::"memory");
}
// the same for register A operands: an A operand read by a batch still in
// flight must keep its registers until the wait that retires it
template <int J> __device__ __forceinline__ void fence_a(unsigned (&a)[J][4]) {
  #pragma unroll
  for (int j = 0; j < J; ++j)
    #pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[j][r])::"memory");
}

// The instructions, one macro a shape, TY the input type's PTX name (bf16 or
// f16): the accumulator list (DL4J_ACCn: n = N / 2 registers a thread) and
// its operands (DL4J_OUTn, d[N/8][4] as "+f").
#define DL4J_ACC16 \
  "%0, %1, %2, %3, %4, %5, %6, %7" ", " \
  "%8, %9, %10, %11, %12, %13, %14, %15"
#define DL4J_OUT16 \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), \
  "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), \
  "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), \
  "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
#define DL4J_ACC32 \
  "%0, %1, %2, %3, %4, %5, %6, %7" ", " \
  "%8, %9, %10, %11, %12, %13, %14, %15" ", " \
  "%16, %17, %18, %19, %20, %21, %22, %23" ", " \
  "%24, %25, %26, %27, %28, %29, %30, %31"
#define DL4J_OUT32 \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), \
  "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), \
  "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), \
  "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), \
  "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), \
  "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), \
  "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), \
  "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
#define DL4J_ACC64 \
  "%0, %1, %2, %3, %4, %5, %6, %7" ", " \
  "%8, %9, %10, %11, %12, %13, %14, %15" ", " \
  "%16, %17, %18, %19, %20, %21, %22, %23" ", " \
  "%24, %25, %26, %27, %28, %29, %30, %31" ", " \
  "%32, %33, %34, %35, %36, %37, %38, %39" ", " \
  "%40, %41, %42, %43, %44, %45, %46, %47" ", " \
  "%48, %49, %50, %51, %52, %53, %54, %55" ", " \
  "%56, %57, %58, %59, %60, %61, %62, %63"
#define DL4J_OUT64 \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), \
  "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), \
  "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), \
  "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), \
  "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), \
  "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), \
  "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), \
  "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), \
  "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), \
  "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), \
  "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), \
  "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), \
  "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), \
  "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), \
  "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), \
  "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
#define DL4J_ACC128 \
  "%0, %1, %2, %3, %4, %5, %6, %7" ", " \
  "%8, %9, %10, %11, %12, %13, %14, %15" ", " \
  "%16, %17, %18, %19, %20, %21, %22, %23" ", " \
  "%24, %25, %26, %27, %28, %29, %30, %31" ", " \
  "%32, %33, %34, %35, %36, %37, %38, %39" ", " \
  "%40, %41, %42, %43, %44, %45, %46, %47" ", " \
  "%48, %49, %50, %51, %52, %53, %54, %55" ", " \
  "%56, %57, %58, %59, %60, %61, %62, %63" ", " \
  "%64, %65, %66, %67, %68, %69, %70, %71" ", " \
  "%72, %73, %74, %75, %76, %77, %78, %79" ", " \
  "%80, %81, %82, %83, %84, %85, %86, %87" ", " \
  "%88, %89, %90, %91, %92, %93, %94, %95" ", " \
  "%96, %97, %98, %99, %100, %101, %102, %103" ", " \
  "%104, %105, %106, %107, %108, %109, %110, %111" ", " \
  "%112, %113, %114, %115, %116, %117, %118, %119" ", " \
  "%120, %121, %122, %123, %124, %125, %126, %127"
#define DL4J_OUT128 \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), \
  "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), \
  "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), \
  "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), \
  "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), \
  "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), \
  "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), \
  "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), \
  "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), \
  "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), \
  "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), \
  "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), \
  "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), \
  "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), \
  "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), \
  "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]), \
  "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]), \
  "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]), \
  "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]), \
  "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]), \
  "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]), \
  "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]), \
  "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]), \
  "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]), \
  "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]), \
  "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]), \
  "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]), \
  "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]), \
  "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]), \
  "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]), \
  "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]), \
  "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
#define DL4J_WGMMA_SS_N32(TY)                                                   \
  asm volatile(                                                                 \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " "               \
      "{" DL4J_ACC16 "}, "                                                        \
      "%16, %17, p, 1, 1, 0, 0;\n}\n"                                         \
      : DL4J_OUT16                                                              \
      : "l"(da.v), "l"(db.v), "r"(acc)                                          \
      : "memory")
#define DL4J_WGMMA_SS_N64(TY)                                                   \
  asm volatile(                                                                 \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "               \
      "{" DL4J_ACC32 "}, "                                                        \
      "%32, %33, p, 1, 1, 0, 0;\n}\n"                                         \
      : DL4J_OUT32                                                              \
      : "l"(da.v), "l"(db.v), "r"(acc)                                          \
      : "memory")
#define DL4J_WGMMA_RS_N64(TY)                                                   \
  asm volatile(                                                                 \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "               \
      "{" DL4J_ACC32 "}, "                                                        \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                     \
      : DL4J_OUT32                                                              \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db.v), "r"(acc)          \
      : "memory")
#define DL4J_WGMMA_RS_N128(TY)                                                   \
  asm volatile(                                                                 \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "               \
      "{" DL4J_ACC64 "}, "                                                        \
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                     \
      : DL4J_OUT64                                                              \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db.v), "r"(acc)          \
      : "memory")
#define DL4J_WGMMA_RS_N256(TY)                                                   \
  asm volatile(                                                                 \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " "               \
      "{" DL4J_ACC128 "}, "                                                        \
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"                     \
      : DL4J_OUT128                                                              \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db.v), "r"(acc)          \
      : "memory")

// d (+)= A.B with A and B from shared memory, both K-major (scale-d = acc:
// 0 overwrites d); d[N/8][4] for N = 32, 64; E (bf16 or f16) from the
// descriptors
template <typename E>
__device__ __forceinline__ void wgmma_ss(float (&d)[4][4], SmemDesc<E> da, SmemDesc<E> db,
                                         int acc) {
  if constexpr (std::is_same<E, __half>::value) DL4J_WGMMA_SS_N32("f16");
  else DL4J_WGMMA_SS_N32("bf16");
}

template <typename E>
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], SmemDesc<E> da, SmemDesc<E> db,
                                         int acc) {
  if constexpr (std::is_same<E, __half>::value) DL4J_WGMMA_SS_N64("f16");
  else DL4J_WGMMA_SS_N64("bf16");
}

// d (+)= A.B with A from registers (a: this warp's A fragment of the k16
// slice) and B from shared memory, MN-major; d[N/8][4] for N = 64, 128, 256
template <typename E>
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4], const unsigned (&a)[4],
                                         SmemDesc<E> db, int acc) {
  if constexpr (std::is_same<E, __half>::value) DL4J_WGMMA_RS_N64("f16");
  else DL4J_WGMMA_RS_N64("bf16");
}

template <typename E>
__device__ __forceinline__ void wgmma_rs(float (&d)[16][4], const unsigned (&a)[4],
                                         SmemDesc<E> db, int acc) {
  if constexpr (std::is_same<E, __half>::value) DL4J_WGMMA_RS_N128("f16");
  else DL4J_WGMMA_RS_N128("bf16");
}

template <typename E>
__device__ __forceinline__ void wgmma_rs(float (&d)[32][4], const unsigned (&a)[4],
                                         SmemDesc<E> db, int acc) {
  if constexpr (std::is_same<E, __half>::value) DL4J_WGMMA_RS_N256("f16");
  else DL4J_WGMMA_RS_N256("bf16");
}

// -- host: tensor maps ------------------------------------------------------------

// cuTensorMapEncodeTiled, a driver-API call, reached through the runtime so
// that a library links only the runtime
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// a [BH, n, D] tensor of E (bf16 or f16) in boxes of {64 columns, rows, 1},
// 128-byte swizzled; rows past n and columns past D read as zero
template <typename E>
inline int map_rows(CUtensorMap* m, const void* base, int BH, int n, int D, int rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)n, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)n * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapDataType type = std::is_same<E, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return (int)enc(m, type, 3, const_cast<void*>(base), dims, strides,
                  box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

inline bool aligned16(std::initializer_list<const void*> ps) {
  for (const void* p : ps)
    if (reinterpret_cast<size_t>(p) & 15) return false;
  return true;
}

// TMA takes a tensor whose rows are a multiple of 16 bytes at a 16-byte
// aligned base
inline bool tma_route(std::initializer_list<const void*> ps, int D) {
  return D % 8 == 0 && aligned16(ps);
}

}  // namespace

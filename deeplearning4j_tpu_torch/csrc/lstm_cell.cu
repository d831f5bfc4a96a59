// Fused LSTM cell forward (kernel K5a) and backward (kernel K5b) for Hopper.
//
// Replaces deeplearning4j_tpu/ops/lstm_kernel.py::_fwd_kernel and ::_bwd_kernel
// (one pallas_call each through _pallas_call).  Same functions:
//   K5a  (h', c') from the preactivations z [mb, 4n], gate order [i|f|o|g], and
//        the cell state c [mb, n]: i, f, o = sigmoid, g = tanh,
//        c' = f*c + i*g, h' = o*tanh(c');
//   K5b  the closed-form backward (_bwd_math): the gates recomputed from (z, c),
//        then dz [mb, 4n] and dc [mb, n] from the cotangents dh, dc'.
// Inputs and outputs are float32 or bfloat16 (one dtype); the math runs in f32
// and each result is rounded once to the output dtype.  The products and sums
// are written with __fmul_rn / __fadd_rn / __fsub_rn in the plain version's
// order, so nvcc cannot contract them into FMAs: in f32 the kernels round as
// the plain PyTorch version's separate ops do, and differ from it only where
// expf / tanhf differ.
//
// Design.  On the TPU a grid of batch tiles walks (bm, 4n) blocks through VMEM,
// which wanted n >= 128 lanes and tiles of >= 8 rows.  Here any mb and n work.
// K5a: one thread owns one (row r, unit j): it reads z[r, j], z[r, n+j],
// z[r, 2n+j], z[r, 3n+j] and c[r, j] and writes its outputs; neighbouring
// threads take neighbouring j, so every read and write is coalesced.  A
// grid-stride loop covers mb*n.
// K5b: a 2-D grid, the row from blockIdx.y and a chunk of 64 units of the row
// from blockIdx.x, one unit a thread, so a thread finds its place with no
// division (the grid-stride loop's 64-bit idx / n costs tens of dependent
// instructions before the first address), and it issues all 7 loads before
// the first exponential.  The char-RNN's [64, 256] gets 256 blocks of 64
// threads over the 132 SMs, where the grid-stride launch ran 64 blocks of 256.
//
// Bound on H100: K5a moves 7 values per (r, j) (4 z, c in; h', c' out) for ~25
// operations, K5b 12 values (4 z, c, dh, dc' in; 4 dz, dc out) for ~45: both are
// bound by memory bandwidth (3.35 TB/s).  At the char-RNN's [64, 256] f32 that is
// 0.46 MB and 0.79 MB, well under a microsecond, so a single step's launch is
// bound by launch latency and one round trip to memory; fusing steps or the
// h·RW product is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float get(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float get(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void put(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// PyTorch's CUDA sigmoid: 1 / (1 + exp(-x)) in f32
__device__ __forceinline__ float sigm(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

template <typename T>
__global__ void __launch_bounds__(256)
lstm_cell_fwd_kernel(const T* __restrict__ z, const T* __restrict__ c, T* __restrict__ h_out,
                     T* __restrict__ c_out, long long total, int n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += stride) {
    const long long r = idx / n;
    const int j = (int)(idx - r * n);
    const long long zr = r * 4 * (long long)n + j;
    const float i = sigm(get(z, zr));
    const float f = sigm(get(z, zr + n));
    const float o = sigm(get(z, zr + 2 * n));
    const float g = tanhf(get(z, zr + 3 * n));
    // c' = f * c + i * g;  h' = o * tanh(c')
    const float cn = __fadd_rn(__fmul_rn(f, get(c, idx)), __fmul_rn(i, g));
    put(c_out, idx, cn);
    put(h_out, idx, __fmul_rn(o, tanhf(cn)));
  }
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

unsigned grid_for(long long total) {
  long long blocks = (total + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond 16 blocks per SM
  return (unsigned)blocks;
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

// z [mb, 4n], c [mb, n] -> h_out, c_out [mb, n]; contiguous rows, f32 (bf16 = 0)
// or bf16 (bf16 = 1).  Returns 0, a CUDA error code, or -1 for arguments it does
// not take.
extern "C" int dl4j_lstm_cell_fwd(const void* z, const void* c, void* h_out, void* c_out,
                                  int mb, int n, int bf16, void* stream) {
  if (mb < 1 || n < 1) return -1;
  const long long total = (long long)mb * n;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    lstm_cell_fwd_kernel<__nv_bfloat16><<<grid_for(total), 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(z), static_cast<const __nv_bfloat16*>(c),
        static_cast<__nv_bfloat16*>(h_out), static_cast<__nv_bfloat16*>(c_out), total, n);
  else
    lstm_cell_fwd_kernel<float><<<grid_for(total), 256, 0, s>>>(
        static_cast<const float*>(z), static_cast<const float*>(c), static_cast<float*>(h_out),
        static_cast<float*>(c_out), total, n);
  return (int)cudaGetLastError();
}

// z [mb, 4n], c, dh, dcn [mb, n] -> dz_out [mb, 4n], dc_out [mb, n]; as above.
extern "C" int dl4j_lstm_cell_bwd(const void* z, const void* c, const void* dh,
                                  const void* dcn, void* dz_out, void* dc_out, int mb, int n,
                                  int bf16, void* stream) {
  if (mb < 1 || n < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_bwd<__nv_bfloat16>(z, c, dh, dcn, dz_out, dc_out, mb, n, s)
              : launch_bwd<float>(z, c, dh, dcn, dz_out, dc_out, mb, n, s);
}

// Flash-attention backward (kernels K2 and K3) for Hopper, plain SIMT float32.
//
// K2 replaces deeplearning4j_tpu/ops/attention.py::_flash_bwd_dkdv_kernel and
// K3 replaces ::_flash_bwd_dq_kernel (both built on ::_bwd_tile).  Same
// function: with s = q.k^T * scale + bias, p = exp(s - lse) rebuilt from the
// forward's saved log-sum-exp, dp = g.v^T and ds = p * (dp - delta) * scale
// (zeroed where bias <= NEG_INF / 2), K2 gives dV = p^T.g and dK = ds^T.q, and
// K3 gives dQ = ds.k.  delta = rowsum(g * o) is computed outside, in f32, as
// in the reference.  The bias is the causal part plus the key-mask part, as
// in K1, and a row with no live key carries the LSE sentinel +1e30, so its p
// and every gradient it feeds are exactly 0.  bf16 inputs: p and ds are
// rounded to bf16 before the products that take them, and all sums stay f32.
//
// Design.  On the TPU the grid runs in order and each kernel carries its
// accumulator in VMEM across the innermost grid axis.  CUDA blocks run in no
// order, so each block owns its accumulator in registers and loops where the
// TPU grid ran in sequence: K2 has one block per (batch*head, 64-key tile) and
// walks the query tiles from the causal diagonal on; K3 has one block per
// (batch*head, 64-query tile) and walks the key tiles up to the diagonal.
// Neither uses atomics, so both are deterministic.  Tiles are staged in
// shared memory as f32 (K and V transposed for the q.k^T and g.v^T products,
// as in K1), every product is a 4x4 register tile per thread over 256 threads,
// and p / ds go through shared memory to the second products.  Ragged T and S
// are masked in the kernel; D <= 128 (padded to 64 or 128).
//
// Bound on H100: 14*D flops per live (query, key) pair (K2: four products of
// 2*D, K3: three) against ~(4*T + 4*S)*D elements of traffic per batch*head,
// so at the training shapes the kernels are bound by operations.  They use
// the f32 SIMT pipes (67 TFLOP/s) and no TF32, so they agree with the plain
// f32 version at f32 tolerance; wgmma, TMA and pipelining are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;           // query rows per tile
constexpr int BK = 64;           // keys per tile
constexpr int NT = 256;          // threads: 16 x 16, each a 4x4 tile
constexpr int KS = BK + 4;       // row stride of the transposed / P tiles
constexpr float NEG_LARGE = -1e30f;

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

// p and ds take the input dtype before the products that read them
// (identity for f32), as _bwd_tile's .astype(...) does
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32<T>(from_f32<T>(x));
}

// rows [r0, r0+BQ) of a [n, D] matrix into S[r][d] (stride DP + 4), zero-padded
template <typename T, int DP>
__device__ __forceinline__ void load_rows(float* S, const T* src, int r0, int n, int D) {
  for (int e = threadIdx.x; e < BQ * DP; e += NT) {
    const int r = e / DP, d = e % DP;
    float x = 0.f;
    if (r0 + r < n && d < D) x = to_f32<T>(src[(size_t)(r0 + r) * D + d]);
    S[r * (DP + 4) + d] = x;
  }
}

// rows [r0, r0+BK) of a [n, D] matrix into S[d][r] (stride KS), zero-padded
template <typename T, int DP>
__device__ __forceinline__ void load_rows_t(float* S, const T* src, int r0, int n, int D) {
  for (int e = threadIdx.x; e < BK * DP; e += NT) {
    const int r = e / DP, d = e % DP;
    float x = 0.f;
    if (r0 + r < n && d < D) x = to_f32<T>(src[(size_t)(r0 + r) * D + d]);
    S[d * KS + r] = x;
  }
}

// acc[i][j] = sum_d A[ty*4+i][d] * Bt[d][tx*4+j]; A stride DP+4, Bt stride KS
template <int DP>
__device__ __forceinline__ void tile_nt(float acc[4][4], const float* A, const float* Bt,
                                        int ty, int tx) {
  #pragma unroll
  for (int i = 0; i < 4; ++i)
    #pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  #pragma unroll 8
  for (int d = 0; d < DP; ++d) {
    const float4 b = *reinterpret_cast<const float4*>(&Bt[d * KS + tx * 4]);
    #pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = A[(ty * 4 + i) * (DP + 4) + d];
      acc[i][0] = fmaf(a, b.x, acc[i][0]);
      acc[i][1] = fmaf(a, b.y, acc[i][1]);
      acc[i][2] = fmaf(a, b.z, acc[i][2]);
      acc[i][3] = fmaf(a, b.w, acc[i][3]);
    }
  }
}

// The _bwd_tile element math for score (qi, kj): p and ds from s and dp.
// A key past S or a query past T gives p = ds = 0.
__device__ __forceinline__ void p_ds(float s, float dp, int qi, int kj, int T_, int S,
                                     const int* km, int causal, float scale, float lse,
                                     float delta, float* p, float* ds) {
  if (qi >= T_ || kj >= S) {
    *p = 0.f;
    *ds = 0.f;
    return;
  }
  float b = 0.f;
  if (causal && qi < kj) b = NEG_LARGE;
  if (km != nullptr && km[kj] == 0) b += NEG_LARGE;
  const float pp = expf(s * scale + b - lse);
  *p = pp;
  *ds = (b > NEG_LARGE / 2) ? pp * (dp - delta) * scale : 0.f;
}

template <typename T, int DP>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ g,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      const int* __restrict__ kmask, T* __restrict__ dk,
                      T* __restrict__ dv, int H, int T_, int S, int D, float scale,
                      int causal) {
  constexpr int QS = DP + 4;
  constexpr int NC = DP / 16;    // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Kt = smem;              // [DP][KS]  this block's key tile, transposed
  float* Vt = Kt + DP * KS;      // [DP][KS]
  float* Qs = Vt + DP * KS;      // [BQ][QS]  the current query tile
  float* Gs = Qs + BQ * QS;      // [BQ][QS]
  float* Ps = Gs + BQ * QS;      // [BQ][KS]
  float* Ds = Ps + BQ * KS;      // [BQ][KS]
  float* Ls = Ds + BQ * KS;      // [BQ]  lse of the tile's rows
  float* Dl = Ls + BQ;           // [BQ]  delta of the tile's rows

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y, k0 = blockIdx.x * BK;
  const size_t qoff = (size_t)bh * T_ * D, koff = (size_t)bh * S * D;
  const int* km = kmask ? kmask + (size_t)(bh / H) * S : nullptr;

  load_rows_t<T, DP>(Kt, k + koff, k0, S, D);
  load_rows_t<T, DP>(Vt, v + koff, k0, S, D);

  float akv[2][4][NC];           // [dk|dv][key ty*4+i][column]
  #pragma unroll
  for (int a = 0; a < 2; ++a)
    #pragma unroll
    for (int i = 0; i < 4; ++i)
      #pragma unroll
      for (int c = 0; c < NC; ++c) akv[a][i][c] = 0.f;

  const int n_qt = (T_ + BQ - 1) / BQ;
  const int qt0 = causal ? k0 / BQ : 0;  // query tiles wholly above the diagonal see no key here
  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous tile's readers are done with Qs, Gs, Ps, Ds
    load_rows<T, DP>(Qs, q + qoff, q0, T_, D);
    load_rows<T, DP>(Gs, g + qoff, q0, T_, D);
    if (tid < BQ) {
      const bool in = q0 + tid < T_;
      Ls[tid] = in ? lse[(size_t)bh * T_ + q0 + tid] : 0.f;
      Dl[tid] = in ? delta[(size_t)bh * T_ + q0 + tid] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_nt<DP>(s, Qs, Kt, ty, tx);
    tile_nt<DP>(dp, Gs, Vt, ty, tx);
    #pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      float4 pv, dv4;
      float* pa = reinterpret_cast<float*>(&pv);
      float* da = reinterpret_cast<float*>(&dv4);
      #pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p, ds;
        p_ds(s[i][j], dp[i][j], q0 + r, k0 + tx * 4 + j, T_, S, km, causal, scale,
             Ls[r], Dl[r], &p, &ds);
        pa[j] = round_to<T>(p);
        da[j] = round_to<T>(ds);
      }
      *reinterpret_cast<float4*>(&Ps[r * KS + tx * 4]) = pv;
      *reinterpret_cast<float4*>(&Ds[r * KS + tx * 4]) = dv4;
    }
    __syncthreads();

    // dV[key][d] += sum_r P[r][key] G[r][d];  dK[key][d] += sum_r dS[r][key] Q[r][d]
    #pragma unroll 4
    for (int r = 0; r < BQ; ++r) {
      const float4 p4 = *reinterpret_cast<const float4*>(&Ps[r * KS + ty * 4]);
      const float4 d4 = *reinterpret_cast<const float4*>(&Ds[r * KS + ty * 4]);
      const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
      const float dr[4] = {d4.x, d4.y, d4.z, d4.w};
      #pragma unroll
      for (int gq = 0; gq < DP / 64; ++gq) {
        const float4 gv = *reinterpret_cast<const float4*>(&Gs[r * QS + gq * 64 + tx * 4]);
        const float4 qv = *reinterpret_cast<const float4*>(&Qs[r * QS + gq * 64 + tx * 4]);
        #pragma unroll
        for (int i = 0; i < 4; ++i) {
          akv[1][i][gq * 4 + 0] = fmaf(pr[i], gv.x, akv[1][i][gq * 4 + 0]);
          akv[1][i][gq * 4 + 1] = fmaf(pr[i], gv.y, akv[1][i][gq * 4 + 1]);
          akv[1][i][gq * 4 + 2] = fmaf(pr[i], gv.z, akv[1][i][gq * 4 + 2]);
          akv[1][i][gq * 4 + 3] = fmaf(pr[i], gv.w, akv[1][i][gq * 4 + 3]);
          akv[0][i][gq * 4 + 0] = fmaf(dr[i], qv.x, akv[0][i][gq * 4 + 0]);
          akv[0][i][gq * 4 + 1] = fmaf(dr[i], qv.y, akv[0][i][gq * 4 + 1]);
          akv[0][i][gq * 4 + 2] = fmaf(dr[i], qv.z, akv[0][i][gq * 4 + 2]);
          akv[0][i][gq * 4 + 3] = fmaf(dr[i], qv.w, akv[0][i][gq * 4 + 3]);
        }
      }
    }
  }

  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty * 4 + i;
    if (kj >= S) continue;
    #pragma unroll
    for (int gq = 0; gq < DP / 64; ++gq)
      #pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = gq * 64 + tx * 4 + c;
        if (d < D) {
          dk[koff + (size_t)kj * D + d] = from_f32<T>(akv[0][i][gq * 4 + c]);
          dv[koff + (size_t)kj * D + d] = from_f32<T>(akv[1][i][gq * 4 + c]);
        }
      }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ g,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const int* __restrict__ kmask, T* __restrict__ dq, int H, int T_,
                    int S, int D, float scale, int causal) {
  constexpr int QS = DP + 4;
  constexpr int NC = DP / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;              // [BQ][QS]  this block's query tile
  float* Gs = Qs + BQ * QS;      // [BQ][QS]
  float* Kt = Gs + BQ * QS;      // [DP][KS]  the current key tile, transposed
  float* Vt = Kt + DP * KS;      // [DP][KS]
  float* Ks = Vt + DP * KS;      // [BK][QS]  the same key tile, row-major
  float* Ds = Ks + BK * QS;      // [BQ][KS]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const size_t qoff = (size_t)bh * T_ * D, koff = (size_t)bh * S * D;
  const int* km = kmask ? kmask + (size_t)(bh / H) * S : nullptr;

  load_rows<T, DP>(Qs, q + qoff, q0, T_, D);
  load_rows<T, DP>(Gs, g + qoff, q0, T_, D);
  float ls[4], dl[4];
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    ls[i] = qi < T_ ? lse[(size_t)bh * T_ + qi] : 0.f;
    dl[i] = qi < T_ ? delta[(size_t)bh * T_ + qi] : 0.f;
  }

  float acc[4][NC];
  #pragma unroll
  for (int i = 0; i < 4; ++i)
    #pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  int n_kt = (S + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (q0 + BQ - 1) / BK + 1);  // skip tiles above the diagonal

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done with Kt, Vt, Ks, Ds
    load_rows_t<T, DP>(Kt, k + koff, k0, S, D);
    load_rows_t<T, DP>(Vt, v + koff, k0, S, D);
    load_rows<T, DP>(Ks, k + koff, k0, S, D);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_nt<DP>(s, Qs, Kt, ty, tx);
    tile_nt<DP>(dp, Gs, Vt, ty, tx);
    #pragma unroll
    for (int i = 0; i < 4; ++i) {
      float4 dv4;
      float* da = reinterpret_cast<float*>(&dv4);
      #pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p, ds;
        p_ds(s[i][j], dp[i][j], q0 + ty * 4 + i, k0 + tx * 4 + j, T_, S, km, causal,
             scale, ls[i], dl[i], &p, &ds);
        da[j] = round_to<T>(ds);
      }
      *reinterpret_cast<float4*>(&Ds[(ty * 4 + i) * KS + tx * 4]) = dv4;
    }
    __syncthreads();

    // dQ[r][d] += sum_key dS[r][key] K[key][d]
    #pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float dr[4];
      #pragma unroll
      for (int i = 0; i < 4; ++i) dr[i] = Ds[(ty * 4 + i) * KS + kk];
      #pragma unroll
      for (int gq = 0; gq < DP / 64; ++gq) {
        const float4 kv = *reinterpret_cast<const float4*>(&Ks[kk * QS + gq * 64 + tx * 4]);
        #pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][gq * 4 + 0] = fmaf(dr[i], kv.x, acc[i][gq * 4 + 0]);
          acc[i][gq * 4 + 1] = fmaf(dr[i], kv.y, acc[i][gq * 4 + 1]);
          acc[i][gq * 4 + 2] = fmaf(dr[i], kv.z, acc[i][gq * 4 + 2]);
          acc[i][gq * 4 + 3] = fmaf(dr[i], kv.w, acc[i][gq * 4 + 3]);
        }
      }
    }
  }

  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= T_) continue;
    #pragma unroll
    for (int gq = 0; gq < DP / 64; ++gq)
      #pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = gq * 64 + tx * 4 + c;
        if (d < D) dq[qoff + (size_t)qi * D + d] = from_f32<T>(acc[i][gq * 4 + c]);
      }
  }
}

template <typename T, int DP>
int launch_dkdv(const void* q, const void* k, const void* v, const void* g,
                const float* lse, const float* delta, const int* kmask, void* dk,
                void* dv, int B, int H, int T_, int S, int D, float scale, int causal,
                cudaStream_t stream) {
  const size_t smem =
      (size_t)(2 * DP * KS + 2 * BQ * (DP + 4) + 2 * BQ * KS + 2 * BQ) * sizeof(float);
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((S + BK - 1) / BK, B * H);
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
  const size_t smem =
      (size_t)(2 * BQ * (DP + 4) + 2 * DP * KS + BK * (DP + 4) + BQ * KS) * sizeof(float);
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((T_ + BQ - 1) / BQ, B * H);
  flash_bwd_dq_kernel<T, DP><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), lse, delta, kmask, static_cast<T*>(dq), H, T_, S, D,
      scale, causal);
  return (int)cudaGetLastError();
}

bool bad_args(int B, int H, int T_, int S, int D) {
  return B < 1 || H < 1 || T_ < 1 || S < 1 || D < 1 || D > 128 || B * H > 65535;
}

}  // namespace

// q, g, dq [B,H,T,D]; k, v, dk, dv [B,H,S,D]; all contiguous, f32 (is_bf16 = 0)
// or bf16; lse, delta [B,H,T] f32; kmask [B,S] int32 or null.
// Each returns 0, a CUDA error code, or -1 for arguments it does not take.
extern "C" int dl4j_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                                   const void* g, const void* lse, const void* delta,
                                   const void* kmask, void* dk, void* dv, int B, int H,
                                   int T_, int S, int D, float scale, int causal,
                                   int is_bf16, void* stream) {
  if (bad_args(B, H, T_, S, D)) return -1;
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int* km = static_cast<const int*>(kmask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return D <= 64
        ? launch_dkdv<__nv_bfloat16, 64>(q, k, v, g, l, dl, km, dk, dv, B, H, T_, S, D, scale, causal, st)
        : launch_dkdv<__nv_bfloat16, 128>(q, k, v, g, l, dl, km, dk, dv, B, H, T_, S, D, scale, causal, st);
  return D <= 64
      ? launch_dkdv<float, 64>(q, k, v, g, l, dl, km, dk, dv, B, H, T_, S, D, scale, causal, st)
      : launch_dkdv<float, 128>(q, k, v, g, l, dl, km, dk, dv, B, H, T_, S, D, scale, causal, st);
}

extern "C" int dl4j_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* g, const void* lse, const void* delta,
                                 const void* kmask, void* dq, int B, int H, int T_, int S,
                                 int D, float scale, int causal, int is_bf16,
                                 void* stream) {
  if (bad_args(B, H, T_, S, D)) return -1;
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int* km = static_cast<const int*>(kmask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return D <= 64
        ? launch_dq<__nv_bfloat16, 64>(q, k, v, g, l, dl, km, dq, B, H, T_, S, D, scale, causal, st)
        : launch_dq<__nv_bfloat16, 128>(q, k, v, g, l, dl, km, dq, B, H, T_, S, D, scale, causal, st);
  return D <= 64
      ? launch_dq<float, 64>(q, k, v, g, l, dl, km, dq, B, H, T_, S, D, scale, causal, st)
      : launch_dq<float, 128>(q, k, v, g, l, dl, km, dq, B, H, T_, S, D, scale, causal, st);
}

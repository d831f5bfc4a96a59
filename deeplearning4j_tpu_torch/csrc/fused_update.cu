// Fused Adam / Nadam step (kernel K4) for Hopper.
//
// Replaces deeplearning4j_tpu/ops/update_kernel.py::_kernel (launched by
// _pallas_flat).  Same function: one elementwise pass over a layer's flat f32
// buffers p, g, m, v that writes both moment EMAs, the bias-corrected step and
// the param subtract, with the scalars [lr, bc1, bc2] read from device memory
// (no host sync).  The chain is written with __fmul_rn / __fadd_rn /
// __fdiv_rn / __fsqrt_rn / __fsub_rn in _update_math's exact order, so nvcc
// cannot contract it into FMAs and the result is bitwise the plain PyTorch
// version's, which runs the same chain one rounded op at a time.
//
// Design.  On the TPU the flat buffers are padded to (rows, 128) tiles and the
// grid walks row blocks in VMEM.  Here a grid-stride loop over the flat length
// reads each element once and writes three outputs; no padding is needed.
//
// Bound on H100: 28 bytes per element (four f32 reads, three f32 writes)
// against ~12 flops, so it is bound by memory bandwidth (3.35 TB/s).

#include <cuda_runtime.h>

namespace {

template <bool NADAM>
__global__ void __launch_bounds__(256)
fused_update_kernel(const float* __restrict__ p, const float* __restrict__ g,
                    const float* __restrict__ m, const float* __restrict__ v,
                    const float* __restrict__ sc, float* __restrict__ p_out,
                    float* __restrict__ m_out, float* __restrict__ v_out, long long n,
                    float beta1, float one_m_beta1, float beta2, float one_m_beta2,
                    float eps) {
  const float lr = sc[0], bc1 = sc[1], bc2 = sc[2];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float gi = g[i];
    // m_new = beta1 * m + (1 - beta1) * g
    const float m_new = __fadd_rn(__fmul_rn(beta1, m[i]), __fmul_rn(one_m_beta1, gi));
    // v_new = beta2 * v + (1 - beta2) * g * g
    const float v_new =
        __fadd_rn(__fmul_rn(beta2, v[i]), __fmul_rn(__fmul_rn(one_m_beta2, gi), gi));
    // denominator sqrt(v_new / bc2) + eps
    const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v_new, bc2)), eps);
    float step;
    if (NADAM) {
      // m_hat = beta1 * (m_new / bc1) + (1 - beta1) * g / bc1; step = lr * m_hat / den
      const float m_hat = __fadd_rn(__fmul_rn(beta1, __fdiv_rn(m_new, bc1)),
                                    __fdiv_rn(__fmul_rn(one_m_beta1, gi), bc1));
      step = __fdiv_rn(__fmul_rn(lr, m_hat), den);
    } else {
      // step = lr * (m_new / bc1) / den
      step = __fdiv_rn(__fmul_rn(lr, __fdiv_rn(m_new, bc1)), den);
    }
    p_out[i] = __fsub_rn(p[i], step);
    m_out[i] = m_new;
    v_out[i] = v_new;
  }
}

}  // namespace

// p, g, m, v, p_out, m_out, v_out: n contiguous f32 each; sc: [lr, bc1, bc2]
// f32 on the device.  nadam selects the Nadam step.  Returns 0, a CUDA error
// code, or -1 for arguments it does not take.
extern "C" int dl4j_fused_update(const void* p, const void* g, const void* m,
                                 const void* v, const void* sc, void* p_out,
                                 void* m_out, void* v_out, long long n, int nadam,
                                 float beta1, float one_m_beta1, float beta2,
                                 float one_m_beta2, float eps, void* stream) {
  if (n < 1) return -1;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond 16 blocks per SM
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* pf = static_cast<const float*>(p);
  const float* gf = static_cast<const float*>(g);
  const float* mf = static_cast<const float*>(m);
  const float* vf = static_cast<const float*>(v);
  const float* s = static_cast<const float*>(sc);
  float* po = static_cast<float*>(p_out);
  float* mo = static_cast<float*>(m_out);
  float* vo = static_cast<float*>(v_out);
  if (nadam)
    fused_update_kernel<true><<<(unsigned)blocks, threads, 0, st>>>(
        pf, gf, mf, vf, s, po, mo, vo, n, beta1, one_m_beta1, beta2, one_m_beta2, eps);
  else
    fused_update_kernel<false><<<(unsigned)blocks, threads, 0, st>>>(
        pf, gf, mf, vf, s, po, mo, vo, n, beta1, one_m_beta1, beta2, one_m_beta2, eps);
  return (int)cudaGetLastError();
}

// One beam step of single-head location attention (K5) for Hopper, full f32.
//
// Replaces end_to_end_asr_pytorch_tpu/ops/pallas/att_kernel.py:
// loc_attention_fused (reached from models/attention.py:step_beam with
// attention.use_pallas). For every utterance b and hypothesis k:
//   f_tj   = sum_c fsm[b,k,t,c] * w_f[c,j]      (location features, F -> d)
//   energy = (sum_j v_j tanh(qb[b,k,j] + keys[b,t,j] + f_tj)) / tau, masked
//            to -1e30 at t >= enc_len[b]
//   align  = softmax_t(energy),   ctx_j = sum_t align_t * vals[b,t,j]
// (the arithmetic of loc_att_common.cuh). The (B, K, T, d) tanh argument
// that the plain chain writes to device memory stays in registers.
//
// Bound on the H100: the f32 operations, ~(2F + 5) per (b, k, t, j) element
// (0.37 GFLOP at B=32, K=8, T=176, d=300, F=10: ~5.4 us at 67 TFLOP/s),
// just above the unique bytes (keys, vals and fsm, ~16 MB: ~4.7 us). Design:
// one block per (b, k) hypothesis (256 blocks at B=32). The block stages its
// query row, v, w_f and its fsm row (T x F) in shared memory, computes f on
// the fly inside the energy loop (one warp per frame, lanes over d), keeps
// the T energies in shared memory for a block softmax and then reads the
// values for the context. The K hypotheses of one utterance re-read the same
// keys and values, from L2 after the first. The TPU kernel's sharing of one
// key read across the K rows of a grid cell, and the Toeplitz band and lane
// padding of d that feed it on the TPU, are not carried over.
#include "loc_att_common.cuh"

#define K5_THREADS 256

__global__ void __launch_bounds__(K5_THREADS) loc_att_kernel(
    const float* __restrict__ qb, const float* __restrict__ keys,
    const float* __restrict__ fsm, const float* __restrict__ w_f,
    const float* __restrict__ v, const float* __restrict__ vals,
    const int* __restrict__ lens, float* __restrict__ ctx,
    float* __restrict__ align, int K, int T, int d, int F, int vdim,
    float inv_tau) {
  extern __shared__ float sm[];
  __shared__ float red[32];
  float* q_s = sm;                  // d
  float* v_s = q_s + d;             // d
  float* wf_s = v_s + d;            // F x d
  float* fsm_s = wf_s + F * d;      // T x F
  float* e_s = fsm_s + T * F;       // T
  const int bk = blockIdx.x, b = bk / K;
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    q_s[j] = qb[(size_t)bk * d + j];
    v_s[j] = v[j];
  }
  for (int i = threadIdx.x; i < F * d; i += blockDim.x) wf_s[i] = w_f[i];
  const float* fsm_row = fsm + (size_t)bk * T * F;
  for (int i = threadIdx.x; i < T * F; i += blockDim.x) fsm_s[i] = fsm_row[i];
  __syncthreads();

  const int n = loc_valid(lens[b], T);
  auto feat = [&](int t, int j) {
    float f = 0.f;
    for (int c = 0; c < F; ++c) f += fsm_s[t * F + c] * wf_s[c * d + j];
    return f;
  };
  loc_energies(e_s, q_s, v_s, keys + (size_t)b * T * d, feat, T, d, n,
               inv_tau);
  __syncthreads();
  loc_softmax(e_s, align + (size_t)bk * T, T, red);
  loc_context(e_s, vals + (size_t)b * T * vdim, ctx + (size_t)bk * vdim,
              loc_weighted(n, T), vdim);
}

extern "C" size_t loc_att_smem_bytes(int T, int d, int F) {
  return (size_t)(2 * d + F * d + T * F + T) * sizeof(float);
}

// qb (B,K,d), keys (B,T,d), fsm (B,K,T,F), w_f (F,d), v (d), vals
// (B,T,vdim), lens (B) int32 -> ctx (B,K,vdim), align (B,K,T).
extern "C" int loc_att_launch(const float* qb, const float* keys,
                              const float* fsm, const float* w_f,
                              const float* v, const float* vals,
                              const int* lens, float* ctx, float* align,
                              int B, int K, int T, int d, int F, int vdim,
                              float inv_tau, void* stream) {
  if (B < 1 || K < 1 || T < 1 || d < 1 || F < 1 || vdim < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = loc_att_smem_bytes(T, d, F);
  cudaError_t e = cudaFuncSetAttribute(
      loc_att_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  loc_att_kernel<<<B * K, K5_THREADS, smem, (cudaStream_t)stream>>>(
      qb, keys, fsm, w_f, v, vals, lens, ctx, align, K, T, d, F, vdim,
      inv_tau);
  return (int)cudaGetLastError();
}

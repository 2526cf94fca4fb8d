// The training step of single-head location attention (K7) for Hopper,
// forward and hand-written backward, full f32.
//
// Replaces end_to_end_asr_pytorch_tpu/ops/pallas/att_train_kernel.py:
// _fwd_call / _fwd_kernel (forward) and _vjp_bwd / _bwd_kernel (backward),
// the custom VJP of loc_att_train (reached from models/attention.py:step
// with attention.use_pallas_train). The location conv and its projection
// stay outside: f = conv_features @ w_f arrives as an input.
//
// Forward, per utterance b (loc_att_common.cuh):
//   th_t = tanh(q + keys_t + f_t),  energy_t = (th_t . v) / tau masked to
//   -1e30 at t >= len,  align = softmax(energy),  ctx = sum_t align_t vals_t.
// Backward, per utterance, recomputing th (nothing of the chain is saved):
//   dal_t   = dalign_t + dctx . vals_t
//   dener_t = align_t * (dal_t - sum_s dal_s align_s) / tau
//   dtarg_t = dener_t * v * (1 - th_t^2)     (= dkeys_t = df_t)
//   dq = sum_t dtarg_t,  dvals_t = align_t * dctx,
//   dv = sum_b sum_t dener_t * th_t          (summed over the whole batch).
//
// Bound on the H100: bytes. The forward must read keys, f and vals (3 x
// B*T*d*4 bytes, 20.3 MB at B=32, T=176, d=300: ~6.1 us); the backward
// reads them again and writes dtarg and dvals (~33.8 MB: ~10.1 us), against
// ~20 f32 operations per element. Design: one block per utterance (32 blocks
// at B=32 on 132 SMs: the known limit of this first version), d rounded up
// to whole warps of threads. The forward runs one warp per frame for the
// energies and keeps the T energies in shared memory for the softmax. The
// backward gives each thread one column j of d and walks T serially, so dq
// and this utterance's share of dv build up in registers in a fixed order;
// the shares (B, d) go to a scratch buffer and a second small kernel of the
// same launch sums them over b in order. dv is therefore reproducible from
// run to run (no float atomics), where the TPU kernel carried it across its
// sequential grid.
#include "loc_att_common.cuh"

__global__ void __launch_bounds__(1024) loc_att_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ keys,
    const float* __restrict__ f, const float* __restrict__ v,
    const float* __restrict__ vals, const int* __restrict__ lens,
    float* __restrict__ ctx, float* __restrict__ align, int T, int d,
    int vdim, float inv_tau) {
  extern __shared__ float sm[];
  __shared__ float red[32];
  float* q_s = sm;        // d
  float* v_s = q_s + d;   // d
  float* e_s = v_s + d;   // T
  const int b = blockIdx.x;
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    q_s[j] = q[(size_t)b * d + j];
    v_s[j] = v[j];
  }
  __syncthreads();
  const int n = loc_valid(lens[b], T);
  const float* fb = f + (size_t)b * T * d;
  auto feat = [&](int t, int j) { return fb[(size_t)t * d + j]; };
  loc_energies(e_s, q_s, v_s, keys + (size_t)b * T * d, feat, T, d, n,
               inv_tau);
  __syncthreads();
  loc_softmax(e_s, align + (size_t)b * T, T, red);
  loc_context(e_s, vals + (size_t)b * T * vdim, ctx + (size_t)b * vdim,
              loc_weighted(n, T), vdim);
}

__global__ void __launch_bounds__(1024) loc_att_bwd_kernel(
    const float* __restrict__ q, const float* __restrict__ keys,
    const float* __restrict__ f, const float* __restrict__ v,
    const float* __restrict__ vals, const int* __restrict__ lens,
    const float* __restrict__ align, const float* __restrict__ dctx,
    const float* __restrict__ dalign, float* __restrict__ dq,
    float* __restrict__ dtarg, float* __restrict__ dvals,
    float* __restrict__ dv_part, int T, int d, int vdim, float inv_tau) {
  extern __shared__ float sm[];
  __shared__ float red[32];
  float* dctx_s = sm;            // vdim
  float* a_s = dctx_s + vdim;    // T: align
  float* den_s = a_s + T;        // T: dal, then dener
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int j = threadIdx.x; j < vdim; j += blockDim.x)
    dctx_s[j] = dctx[(size_t)b * vdim + j];
  for (int t = threadIdx.x; t < T; t += blockDim.x)
    a_s[t] = align[(size_t)b * T + t];
  __syncthreads();
  // frames at or past nt carry align == 0, hence dener == 0
  const int nt = loc_weighted(loc_valid(lens[b], T), T);
  const float* vb = vals + (size_t)b * T * vdim;

  // dal_t = dalign_t + dctx . vals_t, one warp per frame
  for (int t = warp; t < nt; t += nw) {
    float acc = 0.f;
    for (int j = lane; j < vdim; j += 32)
      acc += dctx_s[j] * vb[(size_t)t * vdim + j];
    acc = loc_warp_sum(acc);
    if (lane == 0) den_s[t] = dalign[(size_t)b * T + t] + acc;
  }
  __syncthreads();
  float part = 0.f;
  for (int t = threadIdx.x; t < nt; t += blockDim.x)
    part += den_s[t] * a_s[t];
  const float s = loc_block_reduce<false>(part, red);
  for (int t = threadIdx.x; t < T; t += blockDim.x)
    den_s[t] = t < nt ? a_s[t] * (den_s[t] - s) * inv_tau : 0.f;
  __syncthreads();

  // dtarg, dq and this utterance's dv share: one thread per column j
  const size_t base = (size_t)b * T * d;
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    const float qj = q[(size_t)b * d + j], vj = v[j];
    float dqj = 0.f, dvj = 0.f;
    for (int t = 0; t < T; ++t) {
      const size_t o = base + (size_t)t * d + j;
      float g = 0.f;
      if (t < nt) {
        const float th = tanhf(qj + keys[o] + f[o]);
        g = den_s[t] * vj * (1.f - th * th);
        dqj += g;
        dvj += den_s[t] * th;
      }
      dtarg[o] = g;
    }
    dq[(size_t)b * d + j] = dqj;
    dv_part[(size_t)b * d + j] = dvj;
  }

  // dvals_t = align_t * dctx
  float* dvb = dvals + (size_t)b * T * vdim;
  for (int i = threadIdx.x; i < T * vdim; i += blockDim.x)
    dvb[i] = a_s[i / vdim] * dctx_s[i % vdim];
}

// dv_j = sum_b dv_part[b][j], summed in order of b.
__global__ void loc_att_dv_kernel(const float* __restrict__ dv_part,
                                  float* __restrict__ dv, int B, int d) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= d) return;
  float acc = 0.f;
  for (int b = 0; b < B; ++b) acc += dv_part[(size_t)b * d + j];
  dv[j] = acc;
}

// q (B,d), keys / f (B,T,d), v (d), vals (B,T,vdim), lens (B) int32 ->
// ctx (B,vdim), align (B,T).
extern "C" int loc_att_fwd_launch(const float* q, const float* keys,
                                  const float* f, const float* v,
                                  const float* vals, const int* lens,
                                  float* ctx, float* align, int B, int T,
                                  int d, int vdim, float inv_tau,
                                  void* stream) {
  if (B < 1 || T < 1 || d < 1 || vdim < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(2 * d + T) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      loc_att_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  loc_att_fwd_kernel<<<B, loc_threads(d), smem, (cudaStream_t)stream>>>(
      q, keys, f, v, vals, lens, ctx, align, T, d, vdim, inv_tau);
  return (int)cudaGetLastError();
}

// The forward's inputs and align (B,T), dctx (B,vdim), dalign (B,T) ->
// dq (B,d), dtarg (B,T,d), dvals (B,T,vdim), dv (d); dv_part is B*d floats
// of scratch. Two kernels on the stream: the per-utterance backward, then
// the ordered dv sum.
extern "C" int loc_att_bwd_launch(const float* q, const float* keys,
                                  const float* f, const float* v,
                                  const float* vals, const int* lens,
                                  const float* align, const float* dctx,
                                  const float* dalign, float* dq,
                                  float* dtarg, float* dvals, float* dv_part,
                                  float* dv, int B, int T, int d, int vdim,
                                  float inv_tau, void* stream) {
  if (B < 1 || T < 1 || d < 1 || vdim < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(vdim + 2 * T) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      loc_att_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  loc_att_bwd_kernel<<<B, loc_threads(d), smem, st>>>(
      q, keys, f, v, vals, lens, align, dctx, dalign, dq, dtarg, dvals,
      dv_part, T, d, vdim, inv_tau);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  loc_att_dv_kernel<<<(d + 255) / 256, 256, 0, st>>>(dv_part, dv, B, d);
  return (int)cudaGetLastError();
}

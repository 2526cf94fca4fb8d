// Device helpers of the location-attention kernels: the energy chain over
// T, the masked softmax and the context product of one attention row, for
// K7 (loc_att_train.cu) in f32 and in bf16, and the mask constants, length
// clamps and warp reductions that K5 (loc_att.cu) shares.
//
// One row is one query against one utterance's keys (B, T, d) and values
// (B, T, vdim):
//   energy_t = (sum_j v_j * tanh(q_j + key_tj + f_tj)) * (1 / tau)   t < len
//   energy_t = -1e30                                                 t >= len
//   align = softmax(energy),  ctx_j = sum_t align_t * val_tj
// with the TPU kernels' -1e30 mask value and no infinities. Frames at or
// past len are not computed: their align is exactly 0 (exp(-1e30 - m)
// underflows), so the context skips them. A row with len <= 0 has every
// energy at -1e30 and a uniform alignment over all T frames, as in the
// reference.
//
// Inputs of type X (float, or __nv_bfloat16 under amp training) are widened
// exactly; every sum and the softmax run in f32. With bf16 inputs the
// arithmetic rounds where the TPU kernel on bf16 inputs rounds in interpret
// mode: q + key and then + f each rounded to bf16, tanh of that kept in f32
// (XLA carries the bf16 tanh in f32), and the bf16 operand of a product
// (align in the context, dctx and dener in the backward) rounded to bf16.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define LOC_NEG_INF (-1e30f)
#define LOC_FLT_LOWEST (-3.402823466e38f)

__device__ __forceinline__ float loc_warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float loc_warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Block-wide max (IS_MAX) or sum, returned to every thread. blockDim.x is a
// multiple of 32; red holds 32 floats of shared scratch.
template <bool IS_MAX>
__device__ float loc_block_reduce(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  x = IS_MAX ? loc_warp_max(x) : loc_warp_sum(x);
  __syncthreads();  // red may still be read from the previous reduction
  if (lane == 0) red[warp] = x;
  __syncthreads();
  if (warp == 0) {
    float y = lane < nw ? red[lane] : (IS_MAX ? LOC_FLT_LOWEST : 0.f);
    y = IS_MAX ? loc_warp_max(y) : loc_warp_sum(y);
    if (lane == 0) red[0] = y;
  }
  __syncthreads();
  return red[0];
}

// Frames that carry a valid energy (clamped to [0, T]).
__device__ __forceinline__ int loc_valid(int len, int T) {
  return len < 0 ? 0 : (len > T ? T : len);
}

// Frames whose alignment can be non-zero.
__device__ __forceinline__ int loc_weighted(int n_valid, int T) {
  return n_valid > 0 ? n_valid : T;
}

// An input element widened to f32 (exact), and an f32 value stored as X
// (bf16: rounded to nearest even).
__device__ __forceinline__ float loc_ld(float x) { return x; }
__device__ __forceinline__ float loc_ld(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void loc_st(float* p, float x) { *p = x; }
__device__ __forceinline__ void loc_st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// a as the bf16 operand of a product over inputs of type X sees it: a
// itself for f32 inputs, a rounded to bf16 for bf16 inputs.
template <class X>
__device__ __forceinline__ float loc_as(float a) { return a; }
template <>
__device__ __forceinline__ float loc_as<__nv_bfloat16>(float a) {
  return __bfloat162float(__float2bfloat16(a));
}

// tanh(q + key + f) with q already widened (see the header comment for the
// bf16 rounding).
__device__ __forceinline__ float loc_tanh(float q, float k, float f) {
  return tanhf(q + k + f);
}
__device__ __forceinline__ float loc_tanh(float q, __nv_bfloat16 k,
                                          __nv_bfloat16 f) {
  const float s = loc_as<__nv_bfloat16>(q + __bfloat162float(k));
  return tanhf(loc_as<__nv_bfloat16>(s + __bfloat162float(f)));
}

// e_s[t] for every t < T, one warp per frame, lanes over d. feat(t, j) is
// the location feature f_tj (of type X). The caller synchronises before
// reading e_s.
template <class X, class Feat>
__device__ void loc_energies(float* e_s, const float* q_s, const float* v_s,
                             const X* __restrict__ keys, Feat feat, int T,
                             int d, int n_valid, float inv_tau) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int t = warp; t < T; t += nw) {
    float acc = 0.f;
    if (t < n_valid) {  // uniform across the warp
      const X* kt = keys + (size_t)t * d;
      for (int j = lane; j < d; j += 32)
        acc += loc_tanh(q_s[j], kt[j], feat(t, j)) * v_s[j];
      acc = loc_warp_sum(acc);
    }
    if (lane == 0) e_s[t] = t < n_valid ? acc * inv_tau : LOC_NEG_INF;
  }
}

// Softmax of e_s over T in place, also written to align (global). Each
// thread keeps to its own frames; the closing barrier publishes e_s.
__device__ void loc_softmax(float* e_s, float* __restrict__ align, int T,
                            float* red) {
  float m = LOC_FLT_LOWEST;
  for (int t = threadIdx.x; t < T; t += blockDim.x) m = fmaxf(m, e_s[t]);
  m = loc_block_reduce<true>(m, red);
  float s = 0.f;
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    const float e = expf(e_s[t] - m);
    e_s[t] = e;
    s += e;
  }
  s = loc_block_reduce<false>(s, red);
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    const float a = e_s[t] / s;
    e_s[t] = a;
    align[t] = a;
  }
  __syncthreads();
}

// ctx_j = sum_{t < n} a_s[t] * vals[t][j], threads over j (bf16 values
// weighted by a_s rounded to bf16).
template <class X>
__device__ void loc_context(const float* a_s, const X* __restrict__ vals,
                            float* __restrict__ ctx, int n, int vdim) {
  for (int j = threadIdx.x; j < vdim; j += blockDim.x) {
    float acc = 0.f;
    for (int t = 0; t < n; ++t)
      acc += loc_as<X>(a_s[t]) * loc_ld(vals[(size_t)t * vdim + j]);
    ctx[j] = acc;
  }
}

// Threads for a block whose work is spread over d columns: d rounded up to
// whole warps, between 128 and 1024.
static inline int loc_threads(int d) {
  const int t = ((d + 31) / 32) * 32;
  return t < 128 ? 128 : (t > 1024 ? 1024 : t);
}

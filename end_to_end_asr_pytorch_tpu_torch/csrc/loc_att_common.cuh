// Device helpers of the location-attention kernels: the mask constants,
// length clamps and warp reductions that K5 (loc_att.cu) and K7
// (loc_att_train.cu) share, and K7's widening and bf16 rounding.
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

// K6: CTC prefix phase-1 psi over the whole vocabulary, fused with its
// last-token and blank epilogues, for Hopper. Replaces
// end_to_end_asr_pytorch_tpu/ops/pallas/psi_kernel.py:psi_fused:
//
//   psi[b,k,v] = v == blank     ? -1e30
//              : v == last[b,k] ? psi_same[b,k]
//              : md[b,k] + log(sum_t w[b,k,t] * probs[b,t,v] + 1e-38)
//
// with w = wd rounded to the element type of probs (bf16 under decode amp,
// f32 otherwise), each product and the sum in f32, psi f32. The blank merge
// comes last, so it wins when last == blank.
//
// Bound on the H100: bytes. Each beam step reads the whole (B, T, V) probs
// tensor once (57.7 MB in bf16 at B=32, T=176, V=5120, more than the 50 MB
// L2) for 2 K operations per element. Design: grid (ceil(V / BV), B) of NT
// threads, each thread owning CPT adjacent vocabulary columns. A block
// stages w[b] for up to KC hypotheses in shared memory, then walks T,
// loading TU rows of its columns ahead (one 8-byte bf16 / 16-byte f32 load
// per row, neighbouring threads on neighbouring columns) and keeping KC x CPT
// f32 sums in registers. The log and the two merges run in registers before
// one vector store per (hypothesis, thread). K > KC walks T again for each
// further chunk of KC hypotheses. The 1e-38 floor is an f32 subnormal: the
// library is built without fast-math or flush-to-zero, so an all-zero column
// gives md - 87.4982 and not -inf.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define NT 64             // threads per block
#define CPT 4             // vocabulary columns per thread
#define BV (NT * CPT)     // vocabulary columns per block
#define KC 8              // hypotheses per walk over T
#define TU 8              // probs rows loaded ahead

__device__ __forceinline__ void load_cols(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}

__device__ __forceinline__ void load_cols(const __nv_bfloat16* p, float* out) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}

// wd rounded to the probs type, as the TPU kernel's wd.astype(probs.dtype)
__device__ __forceinline__ float round_like(float x, const float*) { return x; }
__device__ __forceinline__ float round_like(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename TP>
__global__ void __launch_bounds__(NT) psi_kernel(
    const float* __restrict__ wd, const TP* __restrict__ probs,
    const float* __restrict__ md, const float* __restrict__ psi_same,
    const int* __restrict__ last, float* __restrict__ out,
    int K, int T, int V, int blank) {
  extern __shared__ float w_s[];                 // KC x T
  const int b = blockIdx.y;
  const int v0 = blockIdx.x * BV + threadIdx.x * CPT;
  const bool active = v0 < V;                    // V % CPT == 0
  const TP* pb = probs + (size_t)b * T * V + (active ? v0 : 0);
  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kn = min(KC, K - k0);
    __syncthreads();                             // last chunk's readers done
    for (int i = threadIdx.x; i < kn * T; i += NT)
      w_s[i] = round_like(wd[((size_t)b * K + k0) * T + i], pb);
    __syncthreads();
    float acc[KC][CPT];
#pragma unroll
    for (int k = 0; k < KC; ++k)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[k][c] = 0.f;
    if (active) {
      for (int t0 = 0; t0 < T; t0 += TU) {
        float p[TU][CPT];
#pragma unroll
        for (int u = 0; u < TU; ++u) {
          if (t0 + u < T) {
            load_cols(pb + (size_t)(t0 + u) * V, p[u]);
          } else {
#pragma unroll
            for (int c = 0; c < CPT; ++c) p[u][c] = 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < TU; ++u) {
          if (t0 + u >= T) break;
#pragma unroll
          for (int k = 0; k < KC; ++k) {
            if (k < kn) {
              const float w = w_s[k * T + t0 + u];
#pragma unroll
              for (int c = 0; c < CPT; ++c) acc[k][c] = fmaf(w, p[u][c], acc[k][c]);
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        if (k >= kn) break;
        const int row = b * K + k0 + k;
        const float m = md[row], ps = psi_same[row];
        const int l = last[row];
        float r[CPT];
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int v = v0 + c;
          float x = m + logf(acc[k][c] + 1e-38f);
          x = v == l ? ps : x;
          r[c] = v == blank ? -1e30f : x;
        }
        *reinterpret_cast<float4*>(out + (size_t)row * V + v0) =
            make_float4(r[0], r[1], r[2], r[3]);
      }
    }
  }
}

// probs_bf16: probs is (B, T, V) bf16, else f32. V must be a multiple of
// CPT (the wrapper checks it).
extern "C" int psi_launch(const float* wd, const void* probs, int probs_bf16,
                          const float* md, const float* psi_same,
                          const int* last, float* out, int B, int K, int T,
                          int V, int blank, void* stream) {
  if (V % CPT != 0 || B <= 0 || K <= 0 || T <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)KC * T * sizeof(float);
  void* fn = probs_bf16 ? (void*)psi_kernel<__nv_bfloat16>
                        : (void*)psi_kernel<float>;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((V + BV - 1) / BV, B);
  cudaStream_t s = (cudaStream_t)stream;
  if (probs_bf16)
    psi_kernel<__nv_bfloat16><<<grid, NT, smem, s>>>(
        wd, (const __nv_bfloat16*)probs, md, psi_same, last, out, K, T, V,
        blank);
  else
    psi_kernel<float><<<grid, NT, smem, s>>>(
        wd, (const float*)probs, md, psi_same, last, out, K, T, V, blank);
  return (int)cudaGetLastError();
}

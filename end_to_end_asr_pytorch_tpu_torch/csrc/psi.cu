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
// L2) for 2 K operations per element. The kernel's job is to keep enough
// bytes in flight and to read probs exactly once.
//
// Design: one block of 4 warps per (utterance, 128 vocabulary columns). It
// walks T in chunks (32 frames in bf16, 16 in f32) through a ring of PSI_NS
// shared-memory stages filled by cp.async (16-byte pieces of probs rows,
// bypassing L1; the chunk of w beside them), keeping PSI_NS - 1 chunks
// (26 KB in bf16) in flight per block and 5-6 blocks per SM. A chunk is
// staged per stage and never whole, so shared memory does not grow with T.
// (Measured on the H100 against 256 columns per block, 16-frame chunks, 3
// to 8 stages and up to 12 blocks per SM, this was the fastest at B=32 and
// 128 and at T=8000.)
//  - bf16 probs: the product runs on mma.sync m16n8k16 (bf16 operands, f32
//    accumulators): the vocabulary is M (A = the probs tile, loaded with
//    ldmatrix.trans from its [t][v] layout; rows padded to 272 bytes, an
//    odd number of 16-byte units, so the 8-row phases hit distinct banks;
//    2 m-tiles per warp), the hypotheses are N (one n8 tile per 8, B = the
//    w chunk rounded to bf16 as it is read), 16 frames are one k-step.
//    Products of bf16 values are exact in f32, so this is the TPU kernel's
//    own arithmetic (preferred_element_type f32) in another summation
//    order. Up to PSI_KG = 16 hypotheses share one walk, so K <= 16 reads
//    probs once (more walk again per 16).
//  - f32 probs: exact f32 products on CUDA cores (fmaf), from the same
//    ring: each thread owns 4 adjacent columns and every 4th hypothesis.
// The epilogue stages the sums through shared memory (aliasing the ring)
// and runs log, the last-token merge and the blank merge in registers as
// it writes psi in 16-byte stores along V. The 1e-38 floor is an f32
// subnormal: the library is built without fast-math or flush-to-zero, so
// an all-zero column gives md - 87.4982 and not -inf.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define PSI_NT 128        // threads per block (4 warps)
#define PSI_BV 128        // vocabulary columns per block
#define PSI_KG 16         // hypotheses per walk over T
#define PSI_NS 4          // ring stages

// Per probs element type TP: TC frames per chunk (bf16: two k-steps of the
// mma), blocks per SM, and the shared-memory geometry of one ring stage:
// probs rows of PR elements (bf16: padded to an odd number of 16-byte
// units for ldmatrix.trans), then the w chunk as f32 [PSI_KG][TC]. bf16:
// warp w owns columns 32w .. 32w + 31 (2 m-tiles); f32: thread t owns
// columns 4 (t % 32) .. + 3 and hypotheses t / 32, t / 32 + 4, ...
template <typename TP> struct PsiCfg;
template <> struct PsiCfg<__nv_bfloat16> {
  static constexpr int TC = 32, MINB = 5;
  static constexpr int PR = PSI_BV + 8;
  static constexpr int PROBS = TC * PR * 2;
  static constexpr int BYTES = PROBS + PSI_KG * TC * 4;
};
template <> struct PsiCfg<float> {
  static constexpr int TC = 16, MINB = 6;
  static constexpr int PR = PSI_BV;
  static constexpr int PROBS = TC * PR * 4;
  static constexpr int BYTES = PROBS + PSI_KG * TC * 4;
};

__device__ __forceinline__ void psi_cp16(void* dst, const void* src,
                                         bool valid) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(dst);
  // src-size 0 fills the 16 bytes with zeros (frames past T, columns past V)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void psi_cp4(void* dst, const void* src,
                                        bool valid) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(a),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void psi_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void psi_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t psi_pack(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// Stage chunk c (frames c*TC ..) of probs[b][:, v0 : v0 + PSI_BV] and of
// wd[b][k0 : k0 + kn] into `st`.
template <typename TP>
__device__ __forceinline__ void psi_load_stage(
    unsigned char* st, const TP* __restrict__ pb, const float* __restrict__ wb,
    int c, int T, int V, int v0, int kn) {
  using G = PsiCfg<TP>;
  constexpr int EPC = 16 / sizeof(TP);        // elements per 16-byte copy
  constexpr int CPR = PSI_BV / EPC;           // copies per probs row
  const int t0 = c * G::TC;
  TP* ps = reinterpret_cast<TP*>(st);
  for (int i = threadIdx.x; i < G::TC * CPR; i += PSI_NT) {
    const int r = i / CPR, v = v0 + (i % CPR) * EPC;
    const bool ok = t0 + r < T && v < V;      // V % EPC == 0
    psi_cp16(ps + r * G::PR + (i % CPR) * EPC,
             ok ? pb + (size_t)(t0 + r) * V + v : pb, ok);
  }
  float* ws = reinterpret_cast<float*>(st + G::PROBS);
  for (int i = threadIdx.x; i < kn * G::TC; i += PSI_NT) {
    const int h = i / G::TC, t = t0 + i % G::TC;
    psi_cp4(ws + i, t < T ? wb + (size_t)h * T + t : wb, t < T);
  }
}

// The sums of one walk: bf16 [2 m-tiles][2 n-tiles][4] per thread; f32
// [4 hypotheses][4 columns].
struct PsiAcc { float a[16]; };

__device__ __forceinline__ void psi_chunk(__nv_bfloat16, PsiAcc& acc,
                                          const unsigned char* st, int kn) {
  using G = PsiCfg<__nv_bfloat16>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const __nv_bfloat16* ps = reinterpret_cast<const __nv_bfloat16*>(st);
  const float* ws = reinterpret_cast<const float*>(st + G::PROBS);
  constexpr int MT = PSI_BV / 64, NTL = PSI_KG / 8;  // per warp
  const int g = lane >> 2, q = (lane & 3) * 2;
#pragma unroll
  for (int k16 = 0; k16 < G::TC / 16; ++k16) {
    uint32_t a[MT][4];
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      // matrices (t 0-7, v 0-7), (t 0-7, v 8-15), (t 8-15, v 0-7),
      // (t 8-15, v 8-15) of the [t][v] tile, transposed: A[v][t]
      const int t = k16 * 16 + (lane & 7) + (lane >> 4) * 8;
      const int v = warp * (PSI_BV / 4) + j * 16 + ((lane >> 3) & 1) * 8;
      const uint32_t addr =
          (uint32_t)__cvta_generic_to_shared(ps + t * G::PR + v);
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
          : "=r"(a[j][0]), "=r"(a[j][1]), "=r"(a[j][2]), "=r"(a[j][3])
          : "r"(addr));
    }
#pragma unroll
    for (int n = 0; n < NTL; ++n) {
      if (n * 8 >= kn) break;
      // B[t][h] = bf16(w[h][t]): b0 rows t = q, q+1, b1 rows q+8, q+9
      const float* wr = ws + (n * 8 + g) * G::TC + k16 * 16;
      const float2 w0 = *reinterpret_cast<const float2*>(wr + q);
      const float2 w1 = *reinterpret_cast<const float2*>(wr + q + 8);
      const uint32_t b0 = psi_pack(w0.x, w0.y), b1 = psi_pack(w1.x, w1.y);
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        float* d = acc.a + (j * NTL + n) * 4;
        asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
            : "r"(a[j][0]), "r"(a[j][1]), "r"(a[j][2]), "r"(a[j][3]),
              "r"(b0), "r"(b1));
      }
    }
  }
}

__device__ __forceinline__ void psi_chunk(float, PsiAcc& acc,
                                          const unsigned char* st, int kn) {
  using G = PsiCfg<float>;
  const int cg = threadIdx.x & 31, hg = threadIdx.x >> 5;
  const float* ps = reinterpret_cast<const float*>(st);
  const float* ws = reinterpret_cast<const float*>(st + G::PROBS);
#pragma unroll 2
  for (int t = 0; t < G::TC; ++t) {
    const float4 p = *reinterpret_cast<const float4*>(ps + t * G::PR + cg * 4);
#pragma unroll
    for (int i = 0; i < PSI_KG / 4; ++i) {
      if (hg + 4 * i >= kn) break;
      const float w = ws[(hg + 4 * i) * G::TC + t];
      float* d = acc.a + i * 4;
      d[0] = fmaf(w, p.x, d[0]);
      d[1] = fmaf(w, p.y, d[1]);
      d[2] = fmaf(w, p.z, d[2]);
      d[3] = fmaf(w, p.w, d[3]);
    }
  }
}

// The sums into out_s[h][v - v0] (BV + 4 floats a row).
__device__ __forceinline__ void psi_stage_sums(__nv_bfloat16, const PsiAcc& acc,
                                               float* out_s, int kn) {
  constexpr int OPR = PSI_BV + 4, MT = PSI_BV / 64, NTL = PSI_KG / 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = (lane & 3) * 2;
#pragma unroll
  for (int n = 0; n < PSI_KG / 8; ++n) {
    if (n * 8 >= kn) break;
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      const float* d = acc.a + (j * NTL + n) * 4;
      const int v = warp * (PSI_BV / 4) + j * 16 + g, h = n * 8 + q;
      out_s[h * OPR + v] = d[0];
      out_s[(h + 1) * OPR + v] = d[1];
      out_s[h * OPR + v + 8] = d[2];
      out_s[(h + 1) * OPR + v + 8] = d[3];
    }
  }
}

__device__ __forceinline__ void psi_stage_sums(float, const PsiAcc& acc,
                                               float* out_s, int kn) {
  constexpr int OPR = PSI_BV + 4;
  const int cg = threadIdx.x & 31, hg = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < PSI_KG / 4; ++i) {
    if (hg + 4 * i >= kn) break;
    const float* d = acc.a + i * 4;
    *reinterpret_cast<float4*>(out_s + (hg + 4 * i) * OPR + cg * 4) =
        make_float4(d[0], d[1], d[2], d[3]);
  }
}

template <typename TP>
__global__ void __launch_bounds__(PSI_NT, PsiCfg<TP>::MINB) psi_kernel(
    const float* __restrict__ wd, const TP* __restrict__ probs,
    const float* __restrict__ md, const float* __restrict__ psi_same,
    const int* __restrict__ last, float* __restrict__ out,
    int K, int T, int V, int blank) {
  using G = PsiCfg<TP>;
  constexpr int OPR = PSI_BV + 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* out_s = reinterpret_cast<float*>(smem);   // aliases the ring
  const int b = blockIdx.y;
  const int v0 = blockIdx.x * PSI_BV;
  const TP* pb = probs + (size_t)b * T * V;
  const int nch = (T + G::TC - 1) / G::TC;
  for (int k0 = 0; k0 < K; k0 += PSI_KG) {
    const int kn = min(PSI_KG, K - k0);
    const float* wb = wd + ((size_t)b * K + k0) * T;
    __syncthreads();              // the last group's out_s readers are done
#pragma unroll
    for (int s = 0; s < PSI_NS - 1; ++s) {
      if (s < nch) psi_load_stage<TP>(smem + s * G::BYTES, pb, wb, s, T, V,
                                      v0, kn);
      psi_commit();
    }
    PsiAcc acc;
#pragma unroll
    for (int i = 0; i < 16; ++i) acc.a[i] = 0.f;
    for (int c = 0; c < nch; ++c) {
      psi_wait<PSI_NS - 2>();
      __syncthreads();            // chunk c landed; chunk c-1's readers done
      const int n = c + PSI_NS - 1;
      if (n < nch) psi_load_stage<TP>(smem + (n % PSI_NS) * G::BYTES, pb, wb,
                                      n, T, V, v0, kn);
      psi_commit();
      psi_chunk(TP(), acc, smem + (c % PSI_NS) * G::BYTES, kn);
    }
    psi_wait<0>();
    __syncthreads();              // every ring read done: out_s may alias it
    psi_stage_sums(TP(), acc, out_s, kn);
    __syncthreads();
    for (int i = threadIdx.x; i < kn * (PSI_BV / 4); i += PSI_NT) {
      const int h = i / (PSI_BV / 4), c = (i % (PSI_BV / 4)) * 4;
      const int v = v0 + c;
      if (v >= V) continue;       // V % 4 == 0
      const int row = b * K + k0 + h;
      const float m = md[row], ps = psi_same[row];
      const int l = last[row];
      const float4 s = *reinterpret_cast<const float4*>(out_s + h * OPR + c);
      const float sv[4] = {s.x, s.y, s.z, s.w};
      float r[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = m + logf(sv[j] + 1e-38f);
        x = v + j == l ? ps : x;
        r[j] = v + j == blank ? -1e30f : x;
      }
      *reinterpret_cast<float4*>(out + (size_t)row * V + v) =
          make_float4(r[0], r[1], r[2], r[3]);
    }
  }
}

// Dynamic shared memory of one block: the ring (the staged sums alias it).
template <typename TP> constexpr int psi_smem() {
  return PSI_NS * PsiCfg<TP>::BYTES > PSI_KG * (PSI_BV + 4) * 4
             ? PSI_NS * PsiCfg<TP>::BYTES
             : PSI_KG * (PSI_BV + 4) * 4;
}
extern "C" int psi_smem_bytes(int probs_bf16) {
  return probs_bf16 ? psi_smem<__nv_bfloat16>() : psi_smem<float>();
}

// probs_bf16: probs is (B, T, V) bf16, else f32. V must be a multiple of 8
// (bf16) or 4 (f32): whole 16-byte rows (the wrapper checks it).
extern "C" int psi_launch(const float* wd, const void* probs, int probs_bf16,
                          const float* md, const float* psi_same,
                          const int* last, float* out, int B, int K, int T,
                          int V, int blank, void* stream) {
  if (V % (probs_bf16 ? 8 : 4) != 0 || B <= 0 || B > 65535 || K <= 0 ||
      T <= 0 || V <= 0)
    return (int)cudaErrorInvalidValue;
  const int smem = psi_smem_bytes(probs_bf16);
  void* fn = probs_bf16 ? (void*)psi_kernel<__nv_bfloat16>
                        : (void*)psi_kernel<float>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((V + PSI_BV - 1) / PSI_BV, B);
  cudaStream_t s = (cudaStream_t)stream;
  if (probs_bf16)
    psi_kernel<__nv_bfloat16><<<grid, PSI_NT, smem, s>>>(
        wd, (const __nv_bfloat16*)probs, md, psi_same, last, out, K, T, V,
        blank);
  else
    psi_kernel<float><<<grid, PSI_NT, smem, s>>>(
        wd, (const float*)probs, md, psi_same, last, out, K, T, V, blank);
  return (int)cudaGetLastError();
}

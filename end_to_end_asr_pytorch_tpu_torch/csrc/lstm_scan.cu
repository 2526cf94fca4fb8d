// Masked LSTM forward time scan (K2, forward only) for Hopper, full f32.
//
// Replaces end_to_end_asr_pytorch_tpu/ops/pallas/lstm_kernel.py:_run_fwd
// (reached through lstm_scan_fused). x_proj (T, B, 4H) = x @ W_ih + b is
// computed outside; the kernel walks all T steps of
//   gates = x_proj[t] + h @ W_hh ; c' = s(f) c + s(i) tanh(g) ; h' = s(o) tanh(c')
// in torch gate order (i, f, g, o). Masked steps hold the carry and emit 0.
// `reverse` walks time from T-1 down to 0 by index, which is the TPU
// wrapper's flip of x_proj and mask without the copies (valid because masks
// are contiguous prefixes).
//
// Bound on the H100: the T serial steps, each a (B, H) x (H, 4H) product in
// f32 (no tensor cores at full f32: 67 TFLOP/s), plus one grid-wide barrier
// per step. Design: ONE persistent cooperative launch per (layer,
// direction). Block j owns U hidden units across all four gates, so the gate
// epilogue needs no cross-block reduction; its (H x 4U) slice of W_hh stays
// in shared memory for the whole scan and its cell state stays in shared
// memory too. Each step a block loads its threads' gate inputs and mask
// first (they do not depend on h, so their HBM latency overlaps the
// product), then streams h_{t-1} (kept k-major, (H, B), in a double buffer
// in global memory / L2) through a 64 KB shared-memory chunk (128 rows of h
// per chunk at U=4), accumulates 2 rows x 4 gates per thread in registers,
// writes its slice of h_t and y_t, and meets the other blocks at
// grid.sync(). U is a template constant, so the chunk indexing is shifts.
// The grid must be co-resident; the wrapper checks it with the occupancy
// API and cudaLaunchCooperativeKernel refuses a grid that is not.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#define NT 256     // threads per block
#define HS 16384   // floats of the shared-memory chunk of h (64 KB)

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.f / (1.f + expf(-x));
}

// U hidden units per block (power of two, 1..128): RB = 2 * NT / U rows of
// the batch per pass (2 per thread), KC = HS / RB rows of h per chunk.
template <int U>
__global__ void __launch_bounds__(NT) lstm_fwd_kernel(
    const float* __restrict__ xp, const float* __restrict__ whh,
    const float* __restrict__ mask, float* __restrict__ ys, float* hbuf,
    int T, int B, int H, int reverse) {
  constexpr int RP = NT / U;
  constexpr int RB = 2 * RP;
  constexpr int KC = HS / RB;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  const int G = 4 * H;
  float4* w_s = smem4;                       // H*U: gates (i,f,g,o) of unit u
  float* h_s = (float*)(smem4 + H * U);      // KC x RB chunk of h, k-major
  float* c_s = h_s + HS;                     // B x U cell state
  const int u0 = blockIdx.x * U;

  for (int idx = threadIdx.x; idx < H * U; idx += NT) {
    const int k = idx / U, u = idx % U;
    const float* row = whh + (size_t)k * G + u0 + u;
    w_s[idx] = make_float4(row[0], row[H], row[2 * H], row[3 * H]);
  }
  for (int idx = threadIdx.x; idx < B * U; idx += NT) c_s[idx] = 0.f;
  __syncthreads();

  const int rp = threadIdx.x % RP;
  const int u = threadIdx.x / RP;
  const int unit = u0 + u;
  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const float* hprev = hbuf + (size_t)(s & 1) * H * B;
    float* hnext = hbuf + (size_t)((s + 1) & 1) * H * B;
    for (int r0 = 0; r0 < B; r0 += RB) {
      float a[2][4], m[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int row = r0 + 2 * rp + j;
        const bool ok = row < B;
        const float* x = xp + ((size_t)t * B + (ok ? row : 0)) * G + unit;
        a[j][0] = ok ? x[0] : 0.f;
        a[j][1] = ok ? x[H] : 0.f;
        a[j][2] = ok ? x[2 * H] : 0.f;
        a[j][3] = ok ? x[3 * H] : 0.f;
        m[j] = ok ? mask[(size_t)t * B + row] : 0.f;
      }
      for (int k0 = 0; k0 < H; k0 += KC) {
#pragma unroll 8
        for (int idx = threadIdx.x; idx < KC * RB; idx += NT) {
          const int kk = idx / RB, r = idx % RB;
          const int row = r0 + r;
          h_s[idx] = (k0 + kk < H && row < B)
                         ? hprev[(size_t)(k0 + kk) * B + row] : 0.f;
        }
        __syncthreads();
        const int kmax = min(KC, H - k0);
#pragma unroll 8
        for (int kk = 0; kk < kmax; ++kk) {
          const float2 hv = *reinterpret_cast<const float2*>(
              h_s + kk * RB + 2 * rp);
          const float4 w = w_s[(k0 + kk) * U + u];
          a[0][0] = fmaf(hv.x, w.x, a[0][0]); a[0][1] = fmaf(hv.x, w.y, a[0][1]);
          a[0][2] = fmaf(hv.x, w.z, a[0][2]); a[0][3] = fmaf(hv.x, w.w, a[0][3]);
          a[1][0] = fmaf(hv.y, w.x, a[1][0]); a[1][1] = fmaf(hv.y, w.y, a[1][1]);
          a[1][2] = fmaf(hv.y, w.z, a[1][2]); a[1][3] = fmaf(hv.y, w.w, a[1][3]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int row = r0 + 2 * rp + j;
        if (row >= B) continue;
        const float c_old = c_s[row * U + u];
        const float h_old = hprev[(size_t)unit * B + row];
        const float c_new = sigmoidf_(a[j][1]) * c_old
                            + sigmoidf_(a[j][0]) * tanhf(a[j][2]);
        const float h_new = sigmoidf_(a[j][3]) * tanhf(c_new);
        c_s[row * U + u] = m[j] * c_new + (1.f - m[j]) * c_old;
        hnext[(size_t)unit * B + row] = m[j] * h_new + (1.f - m[j]) * h_old;
        ys[((size_t)t * B + row) * H + unit] = m[j] * h_new;
      }
    }
    grid.sync();
  }
}

typedef void (*lstm_fn)(const float*, const float*, const float*, float*,
                        float*, int, int, int, int);

static lstm_fn kernel_for(int U) {
  switch (U) {
    case 1: return lstm_fwd_kernel<1>;
    case 2: return lstm_fwd_kernel<2>;
    case 4: return lstm_fwd_kernel<4>;
    case 8: return lstm_fwd_kernel<8>;
    case 16: return lstm_fwd_kernel<16>;
    case 32: return lstm_fwd_kernel<32>;
    case 64: return lstm_fwd_kernel<64>;
    case 128: return lstm_fwd_kernel<128>;
    default: return nullptr;
  }
}

extern "C" size_t lstm_smem_bytes(int B, int H, int U) {
  return (size_t)H * U * sizeof(float4) + (size_t)(HS + B * U) * sizeof(float);
}

// Blocks of the U-unit kernel that can be resident at once on the whole
// card (0 when one block's shared memory does not fit).
extern "C" int lstm_max_coresident(int B, int H, int U, int* out) {
  lstm_fn fn = kernel_for(U);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = lstm_smem_bytes(B, H, U);
  *out = 0;
  if (smem > (size_t)optin) return 0;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, NT, smem);
  if (e != cudaSuccess) return (int)e;
  *out = per_sm * sms;
  return 0;
}

extern "C" int lstm_fwd_launch(const float* xp, const float* whh,
                               const float* mask, float* ys, float* hbuf,
                               int T, int B, int H, int U, int reverse,
                               void* stream) {
  lstm_fn fn = kernel_for(U);
  if (fn == nullptr || H % U != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = lstm_smem_bytes(B, H, U);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {(void*)&xp, (void*)&whh, (void*)&mask, (void*)&ys,
                  (void*)&hbuf, (void*)&T, (void*)&B, (void*)&H,
                  (void*)&reverse};
  e = cudaLaunchCooperativeKernel((void*)fn, dim3(H / U), dim3(NT), args,
                                  smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Masked LSTM time scan for Hopper: forward (K2, with optional training
// residuals) and backward (K2b), f32 throughout, and K2's bf16 variant.
//
// Forward: replaces end_to_end_asr_pytorch_tpu/ops/pallas/lstm_kernel.py:
// _run_fwd (reached through lstm_scan_fused). x_proj (T, B, 4H) = x @ W_ih + b
// is computed outside; the kernel walks all T steps of
//   gates = x_proj[t] + h @ W_hh ; c' = s(f) c + s(i) tanh(g) ; h' = s(o) tanh(c')
// in torch gate order (i, f, g, o). Masked steps hold the carry and emit 0.
// `reverse` walks time from T-1 down to 0 by index, which is the TPU
// wrapper's flip of x_proj and mask without the copies (valid because masks
// are contiguous prefixes). When `cs_out` / `gates_out` are non-null the
// kernel also writes the residuals the backward needs, as _fwd_kernel does:
// the carried cell state (T, B, H) and the post-activation gates (T, B, 4H);
// when they are null (serving) it writes neither.
//
// bf16 variant (decode amp; the TPU kernel's outputs take x_proj.dtype): the
// same kernel instantiated with TX = bf16 for x_proj and ys only. Each
// x_proj element is widened to f32 as it is read, W_hh, the carries and the
// gate math stay f32, and ys is rounded to bf16 (round to nearest even) as it
// is written. It keeps no residuals.
//
// Backward: replaces lstm_kernel.py:_bwd_kernel / _run_bwd. It walks time
// opposite to the forward and emits dxp (T, B, 4H), the gradient of x_proj;
// dW_hh = hs_prev^T . dxp is one GEMM outside the kernel, as in the TPU
// wrapper. Per step: dh = dh_carry + dys[t]; with tc = tanh(c_t),
//   dc = dc_carry + dh o (1 - tc^2), dgates = m [dc g i(1-i), dc c_prev f(1-f),
//   dc i (1-g^2), dh tc o(1-o)], dh_prev = dgates . W_hh^T,
//   dh_carry <- dh_prev + (1-m) dh_carry, dc_carry <- m dc f + (1-m) dc_carry.
// Masked steps give zero gate gradients, both carries pass through them and
// their dys is dropped. "Previous step" is t-1 for a forward scan and t+1
// for a reversed one (zero at the first step walked by the forward).
//
// Bound on the H100: the T serial steps, each a (B, H) x (H, 4H) product in
// f32 (no tensor cores at full f32: 67 TFLOP/s), plus one grid-wide barrier
// per step. Design, the same for both directions of the pass: ONE persistent
// cooperative launch per (layer, direction). Block j owns U hidden units
// across all four gates; its slice of W_hh (4U columns in the forward, U
// rows in the backward, stored as float4 over the gates) and its carries
// stay in shared memory for the whole scan. Each step a block first loads
// its threads' step inputs (they do not depend on the product, so their HBM
// latency overlaps it), then streams the previous step's full h (forward,
// (H, B)) or full dgates (backward, (H, B) of float4: the backward product
// reduces over all 4H gate columns, so every block needs all of them)
// through a 64 KB shared-memory chunk, accumulates in registers, writes its
// slice of the step's outputs into a global double buffer and meets the
// other blocks at grid.sync(). U is a template constant, so the chunk
// indexing is shifts. The grid must be co-resident; the wrapper checks it
// with the occupancy API and cudaLaunchCooperativeKernel refuses a grid that
// is not.
#include "scan_common.cuh"

// U hidden units per block (power of two, 1..128): RB = 2 * NT / U rows of
// the batch per pass (2 per thread), KC = HS / RB rows of h per chunk. TX is
// the element type of x_proj and ys (float, or bf16 without residuals).
template <int U, typename TX>
__global__ void __launch_bounds__(NT) lstm_fwd_kernel(
    const TX* __restrict__ xp, const float* __restrict__ whh,
    const float* __restrict__ mask, TX* __restrict__ ys, float* hbuf,
    float* __restrict__ cs_out, float* __restrict__ gates_out,
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
  const bool keep = cs_out != nullptr;

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
        const TX* x = xp + ((size_t)t * B + (ok ? row : 0)) * G + unit;
        a[j][0] = ok ? to_f32(x[0]) : 0.f;
        a[j][1] = ok ? to_f32(x[H]) : 0.f;
        a[j][2] = ok ? to_f32(x[2 * H]) : 0.f;
        a[j][3] = ok ? to_f32(x[3 * H]) : 0.f;
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
        const float gi = sigmoidf_(a[j][0]), gf = sigmoidf_(a[j][1]);
        const float gg = tanhf(a[j][2]), go = sigmoidf_(a[j][3]);
        const float c_old = c_s[row * U + u];
        const float h_old = hprev[(size_t)unit * B + row];
        const float c_new = gf * c_old + gi * gg;
        const float h_new = go * tanhf(c_new);
        const float c_keep = m[j] * c_new + (1.f - m[j]) * c_old;
        const size_t o = (size_t)t * B + row;
        c_s[row * U + u] = c_keep;
        hnext[(size_t)unit * B + row] = m[j] * h_new + (1.f - m[j]) * h_old;
        ys[o * H + unit] = from_f32<TX>(m[j] * h_new);
        if (keep) {
          cs_out[o * H + unit] = c_keep;
          float* gr = gates_out + o * G + unit;
          gr[0] = gi; gr[H] = gf; gr[2 * H] = gg; gr[3 * H] = go;
        }
      }
    }
    grid.sync();
  }
}

// Backward (K2b). Block j owns units u0..u0+U-1: w_s[k*U + u] holds
// W_hh[u0+u, g*H + k] for the four gates g, dgbuf[k*B + row] the previous
// walked step's dgates of unit k (float4 over the gates). Rows per pass are
// rb = min(RB, B rounded up to even), so a small batch streams longer chunks.
template <int U>
__global__ void __launch_bounds__(NT) lstm_bwd_kernel(
    const float* __restrict__ gates, const float* __restrict__ cs,
    const float* __restrict__ dys, const float* __restrict__ mask,
    const float* __restrict__ whh, float* __restrict__ dxp, float4* dgbuf,
    int T, int B, int H, int reverse) {
  constexpr int RP = NT / U;
  constexpr int RB = 2 * RP;
  constexpr int HS4 = HS / 4;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  const int G = 4 * H;
  float4* w_s = smem4;                       // H*U
  float4* d_s = smem4 + H * U;               // kc x rb chunk of dgates
  float* dh_s = (float*)(d_s + HS4);         // B x U: (1-m) dh_carry
  float* dc_s = dh_s + B * U;                // B x U: dc_carry
  const int u0 = blockIdx.x * U;

  for (int idx = threadIdx.x; idx < H * U; idx += NT) {
    const int k = idx / U, u = idx % U;
    const float* row = whh + (size_t)(u0 + u) * G + k;
    w_s[idx] = make_float4(row[0], row[H], row[2 * H], row[3 * H]);
  }
  for (int idx = threadIdx.x; idx < B * U; idx += NT) {
    dh_s[idx] = 0.f;
    dc_s[idx] = 0.f;
  }
  __syncthreads();

  const int rp = threadIdx.x % RP;
  const int u = threadIdx.x / RP;
  const int unit = u0 + u;
  const int rb = min(RB, (B + 1) & ~1);
  const int kc = HS4 / rb;
  const bool active = 2 * rp < rb;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < T; ++s) {
    const int t = reverse ? s : T - 1 - s;
    const int tp = reverse ? t + 1 : t - 1;
    const bool has_prev = tp >= 0 && tp < T;
    const float4* dprev = dgbuf + (size_t)((s + 1) & 1) * H * B;
    float4* dnext = dgbuf + (size_t)(s & 1) * H * B;
    for (int r0 = 0; r0 < B; r0 += rb) {
      float gi[2], gf[2], gg[2], go[2], ct[2], cp[2], dy[2], m[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int row = r0 + 2 * rp + j;
        const bool ok = active && row < B;
        const size_t o = (size_t)t * B + (ok ? row : 0);
        const float* gr = gates + o * G + unit;
        gi[j] = ok ? gr[0] : 0.f;
        gf[j] = ok ? gr[H] : 0.f;
        gg[j] = ok ? gr[2 * H] : 0.f;
        go[j] = ok ? gr[3 * H] : 0.f;
        ct[j] = ok ? cs[o * H + unit] : 0.f;
        cp[j] = (ok && has_prev) ? cs[((size_t)tp * B + row) * H + unit] : 0.f;
        dy[j] = ok ? dys[o * H + unit] : 0.f;
        m[j] = ok ? mask[o] : 0.f;
      }
      float acc[2] = {0.f, 0.f};
      for (int k0 = 0; k0 < H; k0 += kc) {
        for (int idx = threadIdx.x; idx < kc * rb; idx += NT) {
          const int kk = idx / rb, r = idx % rb;
          const int row = r0 + r;
          d_s[idx] = (k0 + kk < H && row < B)
                         ? dprev[(size_t)(k0 + kk) * B + row] : zero4;
        }
        __syncthreads();
        if (active) {
          const int kmax = min(kc, H - k0);
#pragma unroll 4
          for (int kk = 0; kk < kmax; ++kk) {
            const float4 w = w_s[(k0 + kk) * U + u];
            const float4 d0 = d_s[kk * rb + 2 * rp];
            const float4 d1 = d_s[kk * rb + 2 * rp + 1];
            acc[0] = fmaf(d0.x, w.x, acc[0]); acc[0] = fmaf(d0.y, w.y, acc[0]);
            acc[0] = fmaf(d0.z, w.z, acc[0]); acc[0] = fmaf(d0.w, w.w, acc[0]);
            acc[1] = fmaf(d1.x, w.x, acc[1]); acc[1] = fmaf(d1.y, w.y, acc[1]);
            acc[1] = fmaf(d1.z, w.z, acc[1]); acc[1] = fmaf(d1.w, w.w, acc[1]);
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int row = r0 + 2 * rp + j;
        if (!active || row >= B) continue;
        const int ci = row * U + u;
        const float dh_carry = acc[j] + dh_s[ci];
        const float dh = dh_carry + dy[j];
        const float tc = tanhf(ct[j]);
        const float dov = dh * tc;
        const float dc = dc_s[ci] + dh * go[j] * (1.f - tc * tc);
        const float di = dc * gg[j], dg = dc * gi[j], df = dc * cp[j];
        const float4 dgt = make_float4(
            m[j] * (di * gi[j] * (1.f - gi[j])),
            m[j] * (df * gf[j] * (1.f - gf[j])),
            m[j] * (dg * (1.f - gg[j] * gg[j])),
            m[j] * (dov * go[j] * (1.f - go[j])));
        dh_s[ci] = (1.f - m[j]) * dh_carry;
        dc_s[ci] = m[j] * (dc * gf[j]) + (1.f - m[j]) * dc_s[ci];
        float* out = dxp + ((size_t)t * B + row) * G + unit;
        out[0] = dgt.x; out[H] = dgt.y; out[2 * H] = dgt.z; out[3 * H] = dgt.w;
        dnext[(size_t)unit * B + row] = dgt;
      }
    }
    grid.sync();
  }
}

#define FWD_KERNEL(u) lstm_fwd_kernel<u, TX>
#define BWD_KERNEL(u) lstm_bwd_kernel<u>

template <typename TX>
static void* fwd_for(int U) {
  switch (U) { SCAN_CASES(FWD_KERNEL) }
}

static void* bwd_for(int U) {
  switch (U) { SCAN_CASES(BWD_KERNEL) }
}

// Kernel kinds: the f32 forward, the backward, the bf16 forward.
enum { KIND_FWD = 0, KIND_BWD = 1, KIND_FWD_BF16 = 2 };

// Dynamic shared memory of one block: the W_hh slice (float4 per unit and
// k), the 64 KB chunk, and the carries (one B x U array forward, two back).
extern "C" size_t lstm_smem_bytes(int B, int H, int U, int kind) {
  return (size_t)H * U * sizeof(float4) +
         (size_t)(HS + (kind == KIND_BWD ? 2 : 1) * B * U) * sizeof(float);
}

static void* kernel_ptr(int U, int kind) {
  switch (kind) {
    case KIND_FWD: return fwd_for<float>(U);
    case KIND_BWD: return bwd_for(U);
    case KIND_FWD_BF16: return fwd_for<__nv_bfloat16>(U);
    default: return nullptr;
  }
}

// Blocks of the U-unit kernel of that kind that can be resident at once on
// the whole card (0 when one block's shared memory does not fit).
extern "C" int lstm_max_coresident(int B, int H, int U, int kind, int* out) {
  return scan_max_coresident(kernel_ptr(U, kind),
                             lstm_smem_bytes(B, H, U, kind), out);
}

// cs_out / gates_out may both be null (no residuals).
extern "C" int lstm_fwd_launch(const float* xp, const float* whh,
                               const float* mask, float* ys, float* hbuf,
                               float* cs_out, float* gates_out, int T, int B,
                               int H, int U, int reverse, void* stream) {
  void* fn = kernel_ptr(U, KIND_FWD);
  if (fn == nullptr || H % U != 0 || (cs_out == nullptr) != (gates_out == nullptr))
    return (int)cudaErrorInvalidValue;
  void* args[] = {(void*)&xp, (void*)&whh, (void*)&mask, (void*)&ys,
                  (void*)&hbuf, (void*)&cs_out, (void*)&gates_out, (void*)&T,
                  (void*)&B, (void*)&H, (void*)&reverse};
  return scan_launch(fn, U, H, lstm_smem_bytes(B, H, U, KIND_FWD), args,
                     stream);
}

// The bf16 variant: xp and ys are bf16 (T, B, 4H) / (T, B, H), no residuals.
extern "C" int lstm_fwd_bf16_launch(const void* xp, const float* whh,
                                    const float* mask, void* ys, float* hbuf,
                                    int T, int B, int H, int U, int reverse,
                                    void* stream) {
  void* fn = kernel_ptr(U, KIND_FWD_BF16);
  if (fn == nullptr || H % U != 0) return (int)cudaErrorInvalidValue;
  const __nv_bfloat16* x = (const __nv_bfloat16*)xp;
  __nv_bfloat16* y = (__nv_bfloat16*)ys;
  float* none = nullptr;
  void* args[] = {(void*)&x, (void*)&whh, (void*)&mask, (void*)&y,
                  (void*)&hbuf, (void*)&none, (void*)&none, (void*)&T,
                  (void*)&B, (void*)&H, (void*)&reverse};
  return scan_launch(fn, U, H, lstm_smem_bytes(B, H, U, KIND_FWD_BF16), args,
                     stream);
}

// dgbuf: 2 * H * B float4, zero-filled by the caller.
extern "C" int lstm_bwd_launch(const float* gates, const float* cs,
                               const float* dys, const float* mask,
                               const float* whh, float* dxp, void* dgbuf,
                               int T, int B, int H, int U, int reverse,
                               void* stream) {
  void* fn = kernel_ptr(U, KIND_BWD);
  if (fn == nullptr || H % U != 0) return (int)cudaErrorInvalidValue;
  float4* dg = (float4*)dgbuf;
  void* args[] = {(void*)&gates, (void*)&cs, (void*)&dys, (void*)&mask,
                  (void*)&whh, (void*)&dxp, (void*)&dg, (void*)&T, (void*)&B,
                  (void*)&H, (void*)&reverse};
  return scan_launch(fn, U, H, lstm_smem_bytes(B, H, U, KIND_BWD), args,
                     stream);
}

// Masked GRU time scan for Hopper: forward (K4, with optional training
// residuals) and backward (K4b), f32 throughout, and K4's bf16 variant.
//
// Forward: replaces end_to_end_asr_pytorch_tpu/ops/pallas/gru_kernel.py:
// _fwd_kernel / _run_fwd (reached through gru_scan_fused). x_proj (T, B, 3H)
// = x @ W_ih + b_ih is computed outside; the kernel walks all T steps of
//   hp = h @ W_hh + b_hh ; r = s(xp_r + hp_r) ; z = s(xp_z + hp_z) ;
//   n = tanh(xp_n + r hp_n) ; h' = (1 - z) n + z h
// in torch gate order (r, z, n). b_hh stays separate from x_proj because r
// multiplies hp_n with its bias. Masked steps hold the carry and emit 0.
// `reverse` walks time from T-1 down to 0 by index (the TPU wrapper's flip
// of x_proj and mask, without the copies; valid because masks are
// contiguous prefixes). When `gates_out` / `hpn_out` are non-null the kernel
// also writes the residuals the backward needs, as _fwd_kernel does: the
// post-activation gates (T, B, 3H) and hp_n (T, B, H), bias included.
//
// bf16 variant (decode amp; the TPU kernel's ys take x_proj.dtype): the same
// kernel instantiated with TX = bf16 for x_proj and ys only. Each x_proj
// element is widened to f32 as it is read; W_hh, b_hh, the carry and the
// gate math stay f32; ys is rounded to bf16 (round to nearest even) as it is
// written. It keeps no residuals.
//
// Backward: replaces gru_kernel.py:_bwd_kernel / _run_bwd. It walks time
// opposite to the forward. Per step, with h_prev the forward's previous
// output (t-1, or t+1 reversed; zero at the first step the forward walked):
//   dh = dh_carry + dys[t] ; dz = dh (h_prev - n) ; dn = dh (1 - z) ;
//   dan = dn (1 - n^2) ; dar = dan hp_n r (1 - r) ; daz = dz z (1 - z) ;
//   dxp = m [dar, daz, dan] ; dhp = m [dar, daz, dan r] ;
//   dh_carry <- dhp . W_hh^T + m dh z + (1 - m) dh_carry.
// It writes dxp and dhp (T, B, 3H); dW_hh = hs_prev^T . dhp and
// db_hh = sum dhp are one GEMM and one sum outside the kernel, as in the TPU
// wrapper.
//
// Bound on the H100: the T serial steps, each a (B, H) x (H, 3H) product in
// f32 (67 TFLOP/s without tensor cores), plus one grid-wide barrier per
// step. Design, lstm_scan.cu's: ONE persistent cooperative launch per
// (layer, direction). Block j owns U hidden units across the three gates;
// its slice of W_hh (float4 per unit and k, the fourth lane zero) stays in
// shared memory for the whole scan, and so does the backward's carry (the
// forward's carry is its own h, which it reads back from the double buffer).
// Each step a block loads its threads' step inputs first (they do not depend
// on the product, so their latency overlaps it), then streams the previous
// step's full h (forward, (H, B)) or full dhp (backward, (H, B) of float4:
// its product reduces over all 3H columns, so every block needs all of
// them) through a 64 KB shared-memory chunk of rb = B (rounded up to even,
// at most 2 NT / U) rows, accumulates in registers, writes its slice of the
// step's outputs into a global double buffer and meets the other blocks at
// grid.sync(). The grid must be co-resident; the wrapper checks it with the
// occupancy API and cudaLaunchCooperativeKernel refuses a grid that is not.
#include "scan_common.cuh"

// U hidden units per block (power of two, 1..128): each thread owns unit
// u0 + threadIdx / RP and two rows of the batch per pass; rb rows per pass
// (rb = min(2 RP, B rounded up to even)), kc = HS / rb rows of h per chunk.
// TX is the element type of x_proj and ys (float, or bf16 without
// residuals).
template <int U, typename TX>
__global__ void __launch_bounds__(NT) gru_fwd_kernel(
    const TX* __restrict__ xp, const float* __restrict__ whh,
    const float* __restrict__ bhh, const float* __restrict__ mask,
    TX* __restrict__ ys, float* hbuf, float* __restrict__ gates_out,
    float* __restrict__ hpn_out, int T, int B, int H, int reverse) {
  constexpr int RP = NT / U;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  const int G = 3 * H;
  float4* w_s = smem4;                       // H*U: gates (r,z,n,0) of unit u
  float* h_s = (float*)(smem4 + H * U);      // kc x rb chunk of h, k-major
  const int u0 = blockIdx.x * U;
  const bool keep = gates_out != nullptr;

  for (int idx = threadIdx.x; idx < H * U; idx += NT) {
    const int k = idx / U, u = idx % U;
    const float* row = whh + (size_t)k * G + u0 + u;
    w_s[idx] = make_float4(row[0], row[H], row[2 * H], 0.f);
  }
  __syncthreads();

  const int rp = threadIdx.x % RP;
  const int u = threadIdx.x / RP;
  const int unit = u0 + u;
  const float br = bhh[unit], bz = bhh[H + unit], bn = bhh[2 * H + unit];
  const int rb = min(2 * RP, (B + 1) & ~1);
  const int kc = HS / rb;
  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const float* hprev = hbuf + (size_t)(s & 1) * H * B;
    float* hnext = hbuf + (size_t)((s + 1) & 1) * H * B;
    for (int r0 = 0; r0 < B; r0 += rb) {
      float x[2][3], a[2][3], m[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int row = r0 + 2 * rp + j;
        const bool ok = 2 * rp < rb && row < B;
        const TX* xr = xp + ((size_t)t * B + (ok ? row : 0)) * G + unit;
        x[j][0] = ok ? to_f32(xr[0]) : 0.f;
        x[j][1] = ok ? to_f32(xr[H]) : 0.f;
        x[j][2] = ok ? to_f32(xr[2 * H]) : 0.f;
        m[j] = ok ? mask[(size_t)t * B + row] : 0.f;
        a[j][0] = a[j][1] = a[j][2] = 0.f;
      }
      for (int k0 = 0; k0 < H; k0 += kc) {
#pragma unroll 8
        for (int idx = threadIdx.x; idx < kc * rb; idx += NT) {
          const int kk = idx / rb, r = idx % rb;
          const int row = r0 + r;
          h_s[idx] = (k0 + kk < H && row < B)
                         ? hprev[(size_t)(k0 + kk) * B + row] : 0.f;
        }
        __syncthreads();
        if (2 * rp < rb) {
          const int kmax = min(kc, H - k0);
#pragma unroll 8
          for (int kk = 0; kk < kmax; ++kk) {
            const float2 hv = *reinterpret_cast<const float2*>(
                h_s + kk * rb + 2 * rp);
            const float4 w = w_s[(k0 + kk) * U + u];
            a[0][0] = fmaf(hv.x, w.x, a[0][0]);
            a[0][1] = fmaf(hv.x, w.y, a[0][1]);
            a[0][2] = fmaf(hv.x, w.z, a[0][2]);
            a[1][0] = fmaf(hv.y, w.x, a[1][0]);
            a[1][1] = fmaf(hv.y, w.y, a[1][1]);
            a[1][2] = fmaf(hv.y, w.z, a[1][2]);
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int row = r0 + 2 * rp + j;
        if (2 * rp >= rb || row >= B) continue;
        const float hr = a[j][0] + br, hz = a[j][1] + bz, hn = a[j][2] + bn;
        const float r = sigmoidf_(x[j][0] + hr);
        const float z = sigmoidf_(x[j][1] + hz);
        const float n = tanhf(x[j][2] + r * hn);
        const float h_old = hprev[(size_t)unit * B + row];
        const float h_new = (1.f - z) * n + z * h_old;
        const size_t o = (size_t)t * B + row;
        hnext[(size_t)unit * B + row] = m[j] * h_new + (1.f - m[j]) * h_old;
        ys[o * H + unit] = from_f32<TX>(m[j] * h_new);
        if (keep) {
          float* gr = gates_out + o * G + unit;
          gr[0] = r; gr[H] = z; gr[2 * H] = n;
          hpn_out[o * H + unit] = hn;
        }
      }
    }
    grid.sync();
  }
}

// Backward (K4b). Block j owns units u0..u0+U-1: w_s[k*U + u] holds
// W_hh[u0+u, g*H + k] for the three gates g, dgbuf[k*B + row] the previous
// walked step's dhp of unit k (float4 over the gates, the fourth lane zero),
// dh_s[row*U + u] the part of the next carry that is not the product:
// m dh z + (1 - m) dh_carry.
template <int U>
__global__ void __launch_bounds__(NT) gru_bwd_kernel(
    const float* __restrict__ gates, const float* __restrict__ hpn,
    const float* __restrict__ ys, const float* __restrict__ dys,
    const float* __restrict__ mask, const float* __restrict__ whh,
    float* __restrict__ dxp, float* __restrict__ dhp, float4* dgbuf,
    int T, int B, int H, int reverse) {
  constexpr int RP = NT / U;
  constexpr int HS4 = HS / 4;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  const int G = 3 * H;
  float4* w_s = smem4;                       // H*U
  float4* d_s = smem4 + H * U;               // kc x rb chunk of dhp
  float* dh_s = (float*)(d_s + HS4);         // B x U
  const int u0 = blockIdx.x * U;

  for (int idx = threadIdx.x; idx < H * U; idx += NT) {
    const int k = idx / U, u = idx % U;
    const float* row = whh + (size_t)(u0 + u) * G + k;
    w_s[idx] = make_float4(row[0], row[H], row[2 * H], 0.f);
  }
  for (int idx = threadIdx.x; idx < B * U; idx += NT) dh_s[idx] = 0.f;
  __syncthreads();

  const int rp = threadIdx.x % RP;
  const int u = threadIdx.x / RP;
  const int unit = u0 + u;
  const int rb = min(2 * RP, (B + 1) & ~1);
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
      float gr[2], gz[2], gn[2], hn[2], hp[2], dy[2], m[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int row = r0 + 2 * rp + j;
        const bool ok = active && row < B;
        const size_t o = (size_t)t * B + (ok ? row : 0);
        const float* g = gates + o * G + unit;
        gr[j] = ok ? g[0] : 0.f;
        gz[j] = ok ? g[H] : 0.f;
        gn[j] = ok ? g[2 * H] : 0.f;
        hn[j] = ok ? hpn[o * H + unit] : 0.f;
        hp[j] = (ok && has_prev) ? ys[((size_t)tp * B + row) * H + unit] : 0.f;
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
            acc[0] = fmaf(d0.z, w.z, acc[0]);
            acc[1] = fmaf(d1.x, w.x, acc[1]); acc[1] = fmaf(d1.y, w.y, acc[1]);
            acc[1] = fmaf(d1.z, w.z, acc[1]);
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
        const float dz = dh * (hp[j] - gn[j]);
        const float dn = dh * (1.f - gz[j]);
        const float dan = dn * (1.f - gn[j] * gn[j]);
        const float dr = dan * hn[j];
        const float dar = m[j] * (dr * gr[j] * (1.f - gr[j]));
        const float daz = m[j] * (dz * gz[j] * (1.f - gz[j]));
        const float dhn = m[j] * (dan * gr[j]);
        dh_s[ci] = m[j] * (dh * gz[j]) + (1.f - m[j]) * dh_carry;
        const size_t o = ((size_t)t * B + row) * G + unit;
        dxp[o] = dar; dxp[o + H] = daz; dxp[o + 2 * H] = m[j] * dan;
        dhp[o] = dar; dhp[o + H] = daz; dhp[o + 2 * H] = dhn;
        dnext[(size_t)unit * B + row] = make_float4(dar, daz, dhn, 0.f);
      }
    }
    grid.sync();
  }
}

#define FWD_KERNEL(u) gru_fwd_kernel<u, TX>
#define BWD_KERNEL(u) gru_bwd_kernel<u>

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
// k), the 64 KB chunk, and the backward's B x U carry.
extern "C" size_t gru_smem_bytes(int B, int H, int U, int kind) {
  return (size_t)H * U * sizeof(float4) +
         (size_t)(HS + (kind == KIND_BWD ? B * U : 0)) * sizeof(float);
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
extern "C" int gru_max_coresident(int B, int H, int U, int kind, int* out) {
  return scan_max_coresident(kernel_ptr(U, kind),
                             gru_smem_bytes(B, H, U, kind), out);
}

// gates_out / hpn_out may both be null (no residuals).
extern "C" int gru_fwd_launch(const float* xp, const float* whh,
                              const float* bhh, const float* mask, float* ys,
                              float* hbuf, float* gates_out, float* hpn_out,
                              int T, int B, int H, int U, int reverse,
                              void* stream) {
  void* fn = kernel_ptr(U, KIND_FWD);
  if (fn == nullptr || H % U != 0 ||
      (gates_out == nullptr) != (hpn_out == nullptr))
    return (int)cudaErrorInvalidValue;
  void* args[] = {(void*)&xp, (void*)&whh, (void*)&bhh, (void*)&mask,
                  (void*)&ys, (void*)&hbuf, (void*)&gates_out,
                  (void*)&hpn_out, (void*)&T, (void*)&B, (void*)&H,
                  (void*)&reverse};
  return scan_launch(fn, U, H, gru_smem_bytes(B, H, U, KIND_FWD), args,
                     stream);
}

// The bf16 variant: xp and ys are bf16 (T, B, 3H) / (T, B, H), no residuals.
extern "C" int gru_fwd_bf16_launch(const void* xp, const float* whh,
                                   const float* bhh, const float* mask,
                                   void* ys, float* hbuf, int T, int B, int H,
                                   int U, int reverse, void* stream) {
  void* fn = kernel_ptr(U, KIND_FWD_BF16);
  if (fn == nullptr || H % U != 0) return (int)cudaErrorInvalidValue;
  const __nv_bfloat16* x = (const __nv_bfloat16*)xp;
  __nv_bfloat16* y = (__nv_bfloat16*)ys;
  float* none = nullptr;
  void* args[] = {(void*)&x, (void*)&whh, (void*)&bhh, (void*)&mask,
                  (void*)&y, (void*)&hbuf, (void*)&none, (void*)&none,
                  (void*)&T, (void*)&B, (void*)&H, (void*)&reverse};
  return scan_launch(fn, U, H, gru_smem_bytes(B, H, U, KIND_FWD_BF16), args,
                     stream);
}

// dgbuf: 2 * H * B float4, zero-filled by the caller.
extern "C" int gru_bwd_launch(const float* gates, const float* hpn,
                              const float* ys, const float* dys,
                              const float* mask, const float* whh, float* dxp,
                              float* dhp, void* dgbuf, int T, int B, int H,
                              int U, int reverse, void* stream) {
  void* fn = kernel_ptr(U, KIND_BWD);
  if (fn == nullptr || H % U != 0) return (int)cudaErrorInvalidValue;
  float4* dg = (float4*)dgbuf;
  void* args[] = {(void*)&gates, (void*)&hpn, (void*)&ys, (void*)&dys,
                  (void*)&mask, (void*)&whh, (void*)&dxp, (void*)&dhp,
                  (void*)&dg, (void*)&T, (void*)&B, (void*)&H,
                  (void*)&reverse};
  return scan_launch(fn, U, H, gru_smem_bytes(B, H, U, KIND_BWD), args,
                     stream);
}

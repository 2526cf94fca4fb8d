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
// bf16 variant (K4-bf16, decode amp; replaces the same _run_fwd on its bf16
// x_proj path, whose ys take x_proj.dtype): bf16 x_proj, f32 W_hh and b_hh,
// an f32 carry and gate math, ys rounded once to bf16. What bounds it on the
// H100: the T serial steps, each a (B, H) x (H, 3H) product (at B=32,
// H=512: 5.0e7 FLOP per pass, ~0.05 us at the bf16 tensor rate) behind one
// barrier and one exchange of h across the blocks, so latency and not the
// operation rate sets its time. Design: lstm_scan.cu's K2-bf16, the shared
// tensor-core scan of scan_tc.cuh (one cluster of up to 16 blocks per
// (layer, direction) and group of 8 or 16 batch rows, or a cooperative grid
// where the clusters do not fit, W_hh fragments in registers, the carry
// split into three bf16 parts, the exchange through distributed shared
// memory); this file keeps only the gate epilogue (GruCell).
//
// Backward (K4b): replaces gru_kernel.py:_bwd_kernel / _run_bwd. It walks
// time opposite to the forward. Per step, with h_prev the forward's
// previous output (t-1, or t+1 reversed; zero at the first step the forward
// walked):
//   dh = dh_carry + dys[t] ; dz = dh (h_prev - n) ; dn = dh (1 - z) ;
//   dan = dn (1 - n^2) ; dar = dan hp_n r (1 - r) ; daz = dz z (1 - z) ;
//   dxp = m [dar, daz, dan] ; dhp = m [dar, daz, dan r] ;
//   dh_carry <- dhp . W_hh^T + m dh z + (1 - m) dh_carry.
// It writes dxp and dhp (T, B, 3H); dW_hh = hs_prev^T . dhp and
// db_hh = sum dhp are one GEMM and one sum outside the kernel, as in the TPU
// wrapper. It runs on the tensor cores: see the note at GruBwdCell below.
//
// Bound of the f32 forward on the H100: the T serial steps, each a
// (B, H) x (H, 3H) product in f32 (67 TFLOP/s without tensor cores), plus
// one grid-wide barrier per step. Design: ONE persistent
// cooperative launch per (layer, direction). Block j owns U hidden units
// across the three gates; its slice of W_hh (float4 per unit and k, the
// fourth lane zero) stays in shared memory for the whole scan. Each step a
// block loads its threads' step inputs first (they do not depend on the
// product, so their latency overlaps it), then streams the previous step's
// full h ((H, B)) through a 64 KB shared-memory chunk of rb = B (rounded up
// to even, at most 2 NT / U) rows, accumulates in registers, writes its
// slice of the step's outputs into a global double buffer and meets the
// other blocks at grid.sync(). The grid must be co-resident; the wrapper
// checks it with the occupancy API and cudaLaunchCooperativeKernel refuses
// a grid that is not.
#include "scan_common.cuh"
#include "scan_tc.cuh"

// U hidden units per block (power of two, 1..128): each thread owns unit
// u0 + threadIdx / RP and two rows of the batch per pass; rb rows per pass
// (rb = min(2 RP, B rounded up to even)), kc = HS / rb rows of h per chunk.
template <int U>
__global__ void __launch_bounds__(NT) gru_fwd_kernel(
    const float* __restrict__ xp, const float* __restrict__ whh,
    const float* __restrict__ bhh, const float* __restrict__ mask,
    float* __restrict__ ys, float* hbuf, float* __restrict__ gates_out,
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
        const float* xr = xp + ((size_t)t * B + (ok ? row : 0)) * G + unit;
        x[j][0] = ok ? xr[0] : 0.f;
        x[j][1] = ok ? xr[H] : 0.f;
        x[j][2] = ok ? xr[2 * H] : 0.f;
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
        ys[o * H + unit] = m[j] * h_new;
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

#define FWD_KERNEL(u) gru_fwd_kernel<u>

// Kernel kinds of the f32 cooperative scan: the forward only (K4b runs on
// the tensor cores).
enum { KIND_FWD = 0 };

static void* kernel_ptr(int U, int kind) {
  if (kind != KIND_FWD) return nullptr;
  switch (U) { SCAN_CASES(FWD_KERNEL) }
}

// Dynamic shared memory of one forward block: the W_hh slice (float4 per
// unit and k) and the 64 KB chunk.
extern "C" size_t gru_smem_bytes(int B, int H, int U, int kind) {
  return (size_t)H * U * sizeof(float4) + (size_t)HS * sizeof(float);
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

// K4-bf16's gate epilogue: p the product sums h @ W_hh (r, z, n), x the
// step's x_proj, b_hh added to the product as in hp = h @ W_hh + b_hh.
struct GruCell {
  using X = __nv_bfloat16;      // x_proj and ys
  static constexpr int NG = 3;  // gates
  static constexpr int NS = 0;  // no state beside h
  const float* bhh;
  int H;
  __device__ __forceinline__ float step(const float* p, const float* x,
                                        float h_old, float*, int, bool,
                                        int unit, int, int) const {
    const float hr = p[0] + bhh[unit], hz = p[1] + bhh[H + unit];
    const float hn = p[2] + bhh[2 * H + unit];
    const float r = sigmoidf_(x[0] + hr);
    const float z = sigmoidf_(x[1] + hz);
    const float n = tanhf(x[2] + r * hn);
    return (1.f - z) * n + z * h_old;
  }
};

// Groups of K4-bf16 (clusters of C blocks; TC_GRID: cooperative groups)
// that can be resident at once, into *out.
extern "C" int gru_tc_max_groups(int H, int U, int C, int kw, int kg,
                                 int rows, int mode, int* out) {
  return tc_max_groups<GruCell>(H, U, C, kw, kg, rows, mode, out);
}

// K4-bf16: xp (T, B, 3H) and ys (T, B, H) bf16; wrem a scratch of
// C * warps * kw * 1024 bytes; hbuf (TC_GRID only) 2 * groups * rows * H
// floats. The launch takes groups g0 .. g0 + groups - 1 of `rows` rows.
extern "C" int gru_tc_launch(const void* xp, const float* whh,
                             const float* bhh, const float* mask, void* ys,
                             void* wrem, float* hbuf, int T, int B, int H,
                             int U, int C, int kw, int kg, int rows, int g0,
                             int groups, int mode, int reverse,
                             void* stream) {
  TcArgs a = {xp, whh, mask, ys, (uint4*)wrem, hbuf, T, B, H, U, C, kw, kg,
              rows, g0, reverse, 0};
  return tc_scan_launch(a, GruCell{bhh, H}, groups, mode, stream);
}

// ------------------------------------------------- K4b on the tensor cores
// Backward (K4b): replaces end_to_end_asr_pytorch_tpu/ops/pallas/
// gru_kernel.py:149 _run_bwd (pallas_call at :158). What bounds it on the
// H100: the T serial steps, each a (B, 3H) x (3H, H) product (at B=32,
// H=512: 5.0e7 FLOP, ~0.75 us at the f32 rate, ~0.3 us for six bf16 passes
// at the tensor rate) behind one barrier and one exchange of the step's
// dhp (B x 3H f32) across the blocks: latency, not the operation rate.
// Design: scan_tc.cuh's backward scan. C blocks (16 at H=512) per group
// of 8 or 16 batch rows, W_hh fragments in registers (w_hi) and L2 (w_mid,
// w_lo), dhp split into three bf16 parts so that the tensor-core product
// equals the f32 one, and the next step's gates, hp_n, h_prev, dys and
// mask brought in by coalesced cp.async while the step runs. The groups
// form one cooperative grid that exchanges dhp through L2 behind
// grid.sync() where the card holds them all (at H=512 up to B=128: for
// dhp, three times the forward's h, this exchange measured faster than a
// cluster's), else clusters that exchange it through distributed shared
// memory behind barrier.cluster. This file keeps the gate epilogue
// (GruBwdCell); dW_hh and db_hh stay one GEMM and one sum outside the
// kernel.
struct GruBwdCell {
  static constexpr int NG = 3;  // gates (r, z, n)
  static constexpr int NI = 6;  // inputs per unit: r, z, n, hp_n, h_prev, dy
  static constexpr int NS = 1;  // m dh z + (1 - m) dh_carry
  const float *gates, *hpn, *ys, *dys;
  float *dxp, *dhp;
  int B, H;
  // U floats of input `i` at time t (tp the forward's previous step) for
  // batch row b from unit u0; null: zeros (no previous step)
  __device__ __forceinline__ const float* src(int i, int t, int tp,
                                              bool has_prev, int b,
                                              int u0) const {
    const size_t o = (size_t)t * B + b;
    switch (i) {
      case 0: case 1: case 2: return gates + o * 3 * H + i * H + u0;
      case 3: return hpn + o * H + u0;
      case 4: return has_prev ? ys + ((size_t)tp * B + b) * H + u0 : nullptr;
      default: return dys + o * H + u0;
    }
  }
  __device__ __forceinline__ void step(float p, const float* x, bool mb,
                                       float* st, int, float* dg, int t,
                                       int b, int unit) const {
    const float r = x[0], z = x[1], n = x[2], hn = x[3], hp = x[4];
    const float m = mb ? 1.f : 0.f;
    const float dh_carry = p + st[0];
    const float dh = dh_carry + x[5];
    const float dz = dh * (hp - n);
    const float dn = dh * (1.f - z);
    const float dan = dn * (1.f - n * n);
    const float dr = dan * hn;
    const float dar = m * (dr * r * (1.f - r));
    const float daz = m * (dz * z * (1.f - z));
    const float dhn = m * (dan * r);
    st[0] = m * (dh * z) + (1.f - m) * dh_carry;
    const size_t o = ((size_t)t * B + b) * 3 * H + unit;
    dxp[o] = dar; dxp[o + H] = daz; dxp[o + 2 * H] = m * dan;
    dhp[o] = dar; dhp[o + H] = daz; dhp[o + 2 * H] = dhn;
    dg[0] = dar; dg[1] = daz; dg[2] = dhn;
  }
};

// Groups of K4b's tensor-core backward that can be resident at once.
extern "C" int gru_tc_bwd_max_groups(int H, int U, int C, int kw, int kg,
                                     int rows, int mode, int* out) {
  return tc_bwd_max_groups<GruBwdCell>(H, U, C, kw, kg, rows, mode, out);
}

// K4b on the tensor cores: gates (T, B, 3H), hp_n / ys / dys (T, B, H),
// mask (T, B) f32, w_hh (H, 3H); writes dxp and dhp (T, B, 3H). wrem a
// scratch of C * warps * kw * 1024 bytes; hbuf (TC_GRID only) 2 * groups *
// rows * 3H floats. The launch takes groups g0 .. g0 + groups - 1.
extern "C" int gru_tc_bwd_launch(const float* gates, const float* hpn,
                                 const float* ys, const float* dys,
                                 const float* mask, const float* whh,
                                 float* dxp, float* dhp, void* wrem,
                                 float* hbuf, int T, int B, int H, int U,
                                 int C, int kw, int kg, int rows, int g0,
                                 int groups, int mode, int reverse,
                                 void* stream) {
  TcBwdArgs a = {whh, mask, (uint4*)wrem, hbuf, T, B, H, U, C, kw, kg, rows,
                 g0, reverse, 0};
  return tc_bwd_launch(a, GruBwdCell{gates, hpn, ys, dys, dxp, dhp, B, H},
                       groups, mode, stream);
}

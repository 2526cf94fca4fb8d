// Masked GRU time scan for Hopper on the tensor cores: forward (K4, f32
// with optional training residuals, and its bf16 decode variant K4-bf16)
// and backward (K4b, f32).
//
// Forward: replaces end_to_end_asr_pytorch_tpu/ops/pallas/gru_kernel.py:109
// _run_fwd (pallas_call at :114, reached through gru_scan_fused). x_proj
// (T, B, 3H) = x @ W_ih + b_ih is computed outside; the kernel walks all T
// steps of
//   hp = h @ W_hh + b_hh ; r = s(xp_r + hp_r) ; z = s(xp_z + hp_z) ;
//   n = tanh(xp_n + r hp_n) ; h' = (1 - z) n + z h
// in torch gate order (r, z, n). b_hh stays separate from x_proj because r
// multiplies hp_n with its bias. Masked steps hold the carry and emit 0.
// `reverse` walks time from T-1 down to 0 by index (the TPU wrapper's flip
// of x_proj and mask, without the copies; valid because masks are
// contiguous prefixes). In f32, when `gates_out` / `hpn_out` are non-null
// the kernel also writes the residuals the backward needs, as _fwd_kernel
// does: the post-activation gates (T, B, 3H) and hp_n (T, B, H), bias
// included; when they are null (serving) it writes neither. The bf16
// variant (K4-bf16, decode amp; the same _run_fwd on its bf16 x_proj path,
// whose ys take x_proj.dtype) reads bf16 x_proj and writes ys rounded once
// to bf16; W_hh, b_hh, the carry and the gate math are f32 in both.
//
// What bounds it on the H100: the T serial steps, each a (B, H) x (H, 3H)
// product (at B=32, H=512: 5.0e7 FLOP, ~0.75 us at the f32 rate, ~0.05 us
// per bf16 pass at the tensor rate) behind one barrier and one exchange of
// h across the blocks, so latency and not the operation rate sets its
// time. Design: lstm_scan.cu's K2, the shared tensor-core scan of
// scan_tc.cuh (one cluster of up to 16 blocks per (layer, direction) and
// group of 8 or 16 batch rows, or one cooperative grid of such groups
// where the clusters do not fit; W_hh fragments in registers; the f32
// carry split into three bf16 parts so that the product equals the f32
// one, with the remainder passes of an f32 W_hh that bf16 does not hold,
// as in training and the f32 decode; the exchange through distributed
// shared memory; x_proj prefetched with cp.async). This file keeps only
// the gate epilogue (GruCellT).
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
#include "scan_common.cuh"
#include "scan_tc.cuh"

// K4's gate epilogue: p the product sums h @ W_hh (r, z, n), x the step's
// x_proj, b_hh added to the product as in hp = h @ W_hh + b_hh. X is the
// element type of x_proj and ys; RES: the f32 forward, which also writes
// the residuals where gates_out is non-null (training): the post-activation
// gates and hp_n = p_n + b_hh, for every step and row, masked or not.
template <class XT, bool RES>
struct GruCellT {
  using X = XT;
  static constexpr int NG = 3;  // gates
  static constexpr int NS = 0;  // no state beside h
  const float* bhh;
  float *gates_out, *hpn_out;   // (T, B, 3H), (T, B, H); null: serving
  int B, H;
  __device__ __forceinline__ float step(const float* p, const float* x,
                                        float h_old, float*, int, bool,
                                        int unit, int t, int b) const {
    const float hr = p[0] + bhh[unit], hz = p[1] + bhh[H + unit];
    const float hn = p[2] + bhh[2 * H + unit];
    const float r = sigmoidf_(x[0] + hr);
    const float z = sigmoidf_(x[1] + hz);
    const float n = tanhf(x[2] + r * hn);
    if (RES && gates_out != nullptr) {
      const size_t o = (size_t)t * B + b;
      float* gr = gates_out + o * 3 * H + unit;
      gr[0] = r; gr[H] = z; gr[2 * H] = n;
      hpn_out[o * H + unit] = hn;
    }
    return (1.f - z) * n + z * h_old;
  }
};
using GruCell = GruCellT<__nv_bfloat16, false>;   // K4-bf16
using GruF32Cell = GruCellT<float, true>;         // K4

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
  return tc_scan_launch(a, GruCell{bhh, nullptr, nullptr, B, H}, groups,
                        mode, stream);
}

// Groups of K4 in f32 that can be resident at once, into *out.
extern "C" int gru_tc_f32_max_groups(int H, int U, int C, int kw, int kg,
                                     int rows, int mode, int* out) {
  return tc_max_groups<GruF32Cell>(H, U, C, kw, kg, rows, mode, out);
}

// K4 in f32: xp (T, B, 3H), ys (T, B, H); gates_out (T, B, 3H) and hpn_out
// (T, B, H) both null (serving) or both set (training residuals); wrem and
// hbuf as K4-bf16's.
extern "C" int gru_tc_f32_launch(const float* xp, const float* whh,
                                 const float* bhh, const float* mask,
                                 float* ys, float* gates_out, float* hpn_out,
                                 void* wrem, float* hbuf, int T, int B, int H,
                                 int U, int C, int kw, int kg, int rows,
                                 int g0, int groups, int mode, int reverse,
                                 void* stream) {
  if ((gates_out == nullptr) != (hpn_out == nullptr))
    return (int)cudaErrorInvalidValue;
  TcArgs a = {xp, whh, mask, ys, (uint4*)wrem, hbuf, T, B, H, U, C, kw, kg,
              rows, g0, reverse, 0};
  return tc_scan_launch(a, GruF32Cell{bhh, gates_out, hpn_out, B, H}, groups,
                        mode, stream);
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

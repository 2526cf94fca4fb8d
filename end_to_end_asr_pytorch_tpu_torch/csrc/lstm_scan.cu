// Masked LSTM time scan for Hopper on the tensor cores: forward (K2, f32
// with optional training residuals, and its bf16 decode variant K2-bf16)
// and backward (K2b, f32).
//
// Forward: replaces end_to_end_asr_pytorch_tpu/ops/pallas/lstm_kernel.py:
// _run_fwd (reached through lstm_scan_fused). x_proj (T, B, 4H) = x @ W_ih + b
// is computed outside; the kernel walks all T steps of
//   gates = x_proj[t] + h @ W_hh ; c' = s(f) c + s(i) tanh(g) ; h' = s(o) tanh(c')
// in torch gate order (i, f, g, o). Masked steps hold the carry and emit 0.
// `reverse` walks time from T-1 down to 0 by index, which is the TPU
// wrapper's flip of x_proj and mask without the copies (valid because masks
// are contiguous prefixes). In f32, when `cs_out` / `gates_out` are non-null
// the kernel also writes the residuals the backward needs, as _fwd_kernel
// does: the carried cell state (T, B, H) and the post-activation gates
// (T, B, 4H); when they are null (serving) it writes neither. The bf16
// variant (K2-bf16, decode amp; the same _run_fwd on its bf16 x_proj path,
// whose outputs take x_proj.dtype) reads bf16 x_proj and writes ys rounded
// once to bf16; W_hh, the carry, the cell state and the gate math are f32
// in both.
//
// What bounds it on the H100: the T serial steps, each a (B, H) x (H, 4H)
// product (at B=32, H=512: 6.7e7 FLOP, ~1 us at the f32 rate, ~0.07 us per
// bf16 pass at the tensor rate) behind one barrier and one exchange of h
// across the blocks, so latency and not the operation rate sets its time.
// Design (scan_tc.cuh): one cluster of up to 16 blocks per (layer,
// direction) and group of 8 or 16 batch rows (one cooperative grid of such
// groups where the batch needs more clusters than fit, or where the width
// needs more than 16 blocks to hold W_hh, e.g. H=1024, with the groups in
// waves), any H that is a multiple of 4, the block's bf16 W_hh slice
// resident in registers as mma.sync fragments for all T steps, the f32
// carry split into three bf16 parts per step so the tensor-core product
// equals the f32 one (an f32 W_hh that bf16 does not hold, as in training
// and the f32 decode, adds the remainder passes, its w_mid / w_lo fragments
// read back from L2), the exchange of h through distributed shared memory
// behind barrier.cluster, and the next step's x_proj brought in with
// cp.async during the barrier. This file keeps only the gate epilogue
// (LstmCellT).
//
// Backward (K2b): replaces lstm_kernel.py:185 _run_bwd (pallas_call at
// :198). It walks time opposite to the forward and emits dxp (T, B, 4H),
// the gradient of x_proj; dW_hh = hs_prev^T . dxp is one GEMM outside the
// kernel, as in the TPU wrapper. Per step, with p = dgates_next . W_hh^T
// (the previous walked step's gate gradients; zero on masked rows) and
// tc = tanh(c_t):
//   dh = p + dh_carry + dys[t] ; dc = dc_carry + dh o (1 - tc^2) ;
//   dgates = m [dc g i(1-i), dc c_prev f(1-f), dc i (1-g^2), dh tc o(1-o)] ;
//   dh_carry <- (1-m) (p + dh_carry) ; dc_carry <- m dc f + (1-m) dc_carry.
// Masked steps give zero gate gradients, both carries pass through them and
// their dys is dropped. "Previous step" is t-1 for a forward scan and t+1
// for a reversed one (zero at the first step walked by the forward). What
// bounds it on the H100: the T serial steps, each a (B, 4H) x (4H, H)
// product (6.7e7 FLOP at B=32, H=512; ~0.4 us for its six bf16 passes at
// the tensor rate) behind one barrier and one exchange of the step's
// dgates (B x 4H f32, four times the forward's h) across the blocks:
// latency, not the operation rate. Design: scan_tc.cuh's backward scan (C
// blocks, 16 at H=512, per group of 8 batch rows: 16 rows of the dgates
// planes do not fit a block's shared memory; W_hh fragments in registers
// and L2, dgates split into three bf16 parts, the next step's gates, c,
// c_prev and dys brought in by coalesced cp.async), one cooperative grid
// of the groups that exchanges dgates through L2 where the card holds them
// all, else clusters or further grids in waves. This file keeps the
// epilogue (LstmBwdCell).
#include "scan_common.cuh"
#include "scan_tc.cuh"

// K2's gate epilogue: p the product sums h @ W_hh, x the step's x_proj
// (i, f, g, o), c the cell state of this row and unit (held when masked).
// X is the element type of x_proj and ys; RES: the f32 forward, which also
// writes the residuals where cs_out is non-null (training).
template <class XT, bool RES>
struct LstmCellT {
  using X = XT;
  static constexpr int NG = 4;  // gates
  static constexpr int NS = 1;  // state floats per row and unit: c
  float *cs_out, *gates_out;    // (T, B, H), (T, B, 4H); null: serving
  int B, H;
  __device__ __forceinline__ float step(const float* p, const float* x,
                                        float, float* c, int, bool m,
                                        int unit, int t, int b) const {
    const float gi = sigmoidf_(x[0] + p[0]), gf = sigmoidf_(x[1] + p[1]);
    const float gg = tanhf(x[2] + p[2]), go = sigmoidf_(x[3] + p[3]);
    const float c_new = gf * c[0] + gi * gg;
    if (m) c[0] = c_new;
    if (RES && cs_out != nullptr) {
      const size_t o = (size_t)t * B + b;
      cs_out[o * H + unit] = c[0];
      float* gr = gates_out + o * 4 * H + unit;
      gr[0] = gi; gr[H] = gf; gr[2 * H] = gg; gr[3 * H] = go;
    }
    return go * tanhf(c_new);
  }
};
using LstmCell = LstmCellT<__nv_bfloat16, false>;   // K2-bf16
using LstmF32Cell = LstmCellT<float, true>;         // K2

// Groups of K2-bf16 (clusters of C blocks; TC_GRID: cooperative groups)
// that can be resident at once, into *out.
extern "C" int lstm_tc_max_groups(int H, int U, int C, int kw, int kg,
                                  int rows, int mode, int* out) {
  return tc_max_groups<LstmCell>(H, U, C, kw, kg, rows, mode, out);
}

// K2-bf16: xp (T, B, 4H) and ys (T, B, H) bf16; wrem a scratch of
// C * warps * kw * 1024 bytes; hbuf (TC_GRID only) 2 * groups * rows * H
// floats. The launch takes groups g0 .. g0 + groups - 1 of `rows` rows.
extern "C" int lstm_tc_launch(const void* xp, const float* whh,
                              const float* mask, void* ys, void* wrem,
                              float* hbuf, int T, int B, int H, int U, int C,
                              int kw, int kg, int rows, int g0, int groups,
                              int mode, int reverse, void* stream) {
  TcArgs a = {xp, whh, mask, ys, (uint4*)wrem, hbuf, T, B, H, U, C, kw, kg,
              rows, g0, reverse, 0};
  return tc_scan_launch(a, LstmCell{nullptr, nullptr, B, H}, groups, mode,
                        stream);
}

// Groups of K2 in f32 that can be resident at once, into *out.
extern "C" int lstm_tc_f32_max_groups(int H, int U, int C, int kw, int kg,
                                      int rows, int mode, int* out) {
  return tc_max_groups<LstmF32Cell>(H, U, C, kw, kg, rows, mode, out);
}

// K2 in f32: xp (T, B, 4H), ys (T, B, H); cs_out (T, B, H) and gates_out
// (T, B, 4H) both null (serving) or both set (training residuals); wrem
// and hbuf as K2-bf16's.
extern "C" int lstm_tc_f32_launch(const float* xp, const float* whh,
                                  const float* mask, float* ys, float* cs_out,
                                  float* gates_out, void* wrem, float* hbuf,
                                  int T, int B, int H, int U, int C, int kw,
                                  int kg, int rows, int g0, int groups,
                                  int mode, int reverse, void* stream) {
  if ((cs_out == nullptr) != (gates_out == nullptr))
    return (int)cudaErrorInvalidValue;
  TcArgs a = {xp, whh, mask, ys, (uint4*)wrem, hbuf, T, B, H, U, C, kw, kg,
              rows, g0, reverse, 0};
  return tc_scan_launch(a, LstmF32Cell{cs_out, gates_out, B, H}, groups,
                        mode, stream);
}

// K2b's epilogue on the backward scan: p the unit's row of the previous
// walked step's dgates . W_hh^T, x its seven inputs, st its two carries.
// dxp and the exchanged dgates are the same values.
struct LstmBwdCell {
  static constexpr int NG = 4;  // gates (i, f, g, o): dgates' 4H columns
  static constexpr int NI = 7;  // inputs per unit: i, f, g, o, c, c_prev, dy
  static constexpr int NS = 2;  // (1 - m) (p + dh_carry), dc_carry
  const float *gates, *cs, *dys;
  float* dxp;
  int B, H;
  // U floats of input `i` at time t (tp the forward's previous step) for
  // batch row b from unit u0; null: zeros (no previous step)
  __device__ __forceinline__ const float* src(int i, int t, int tp,
                                              bool has_prev, int b,
                                              int u0) const {
    const size_t o = (size_t)t * B + b;
    switch (i) {
      case 0: case 1: case 2: case 3: return gates + o * 4 * H + i * H + u0;
      case 4: return cs + o * H + u0;
      case 5: return has_prev ? cs + ((size_t)tp * B + b) * H + u0 : nullptr;
      default: return dys + o * H + u0;
    }
  }
  __device__ __forceinline__ void step(float p, const float* x, bool mb,
                                       float* st, int ss, float* dg, int t,
                                       int b, int unit) const {
    const float gi = x[0], gf = x[1], gg = x[2], go = x[3];
    const float c = x[4], cp = x[5];
    const float m = mb ? 1.f : 0.f;
    const float dh_carry = p + st[0];
    const float dh = dh_carry + x[6];
    const float tc = tanhf(c);
    const float dov = dh * tc;
    const float dc = st[ss] + dh * go * (1.f - tc * tc);
    const float di = m * ((dc * gg) * gi * (1.f - gi));
    const float df = m * ((dc * cp) * gf * (1.f - gf));
    const float dgg = m * ((dc * gi) * (1.f - gg * gg));
    const float dgo = m * (dov * go * (1.f - go));
    st[0] = (1.f - m) * dh_carry;
    st[ss] = m * (dc * gf) + (1.f - m) * st[ss];
    const size_t o = ((size_t)t * B + b) * 4 * H + unit;
    dxp[o] = di; dxp[o + H] = df; dxp[o + 2 * H] = dgg; dxp[o + 3 * H] = dgo;
    dg[0] = di; dg[1] = df; dg[2] = dgg; dg[3] = dgo;
  }
};

// Groups of K2b's tensor-core backward that can be resident at once (0
// where a block's shared memory does not fit, as for 16 rows at H=512).
extern "C" int lstm_tc_bwd_max_groups(int H, int U, int C, int kw, int kg,
                                      int rows, int mode, int* out) {
  return tc_bwd_max_groups<LstmBwdCell>(H, U, C, kw, kg, rows, mode, out);
}

// K2b on the tensor cores: gates (T, B, 4H), cs / dys (T, B, H), mask
// (T, B) f32, w_hh (H, 4H); writes dxp (T, B, 4H). wrem a scratch of
// C * warps * kw * 1024 bytes; hbuf (TC_GRID only) 2 * groups * rows * 4H
// floats. The launch takes groups g0 .. g0 + groups - 1.
extern "C" int lstm_tc_bwd_launch(const float* gates, const float* cs,
                                  const float* dys, const float* mask,
                                  const float* whh, float* dxp, void* wrem,
                                  float* hbuf, int T, int B, int H, int U,
                                  int C, int kw, int kg, int rows, int g0,
                                  int groups, int mode, int reverse,
                                  void* stream) {
  TcBwdArgs a = {whh, mask, (uint4*)wrem, hbuf, T, B, H, U, C, kw, kg, rows,
                 g0, reverse, 0};
  return tc_bwd_launch(a, LstmBwdCell{gates, cs, dys, dxp, B, H}, groups,
                       mode, stream);
}

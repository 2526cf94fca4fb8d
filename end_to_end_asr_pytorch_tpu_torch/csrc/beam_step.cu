// K8: the tail of one joint CTC / attention / LM beam step, fused, for
// Hopper. Replaces end_to_end_asr_pytorch_tpu/ops/pallas/beam_step_kernel.py:
// fused_score_select. From the model's and the LM's logits and the CTC
// prefix state it computes, per utterance b (K hypotheses, vocabulary V,
// T encoder frames), what decode/beam.py's step does after the model calls:
//
//   log-softmax of the attention and LM rows;
//   eos scores ((base + aw la[eos]) + cw ctc_eos) + lw ll[eos], masked, over
//   (t + 1), merged into the finished set by a stable top-K of 2K entries
//   (metadata (t << 8) + slot);
//   psi[k, v] = md + log(sum_t exp(phi_diff - md) exp(lp[t, v]) + 1e-38),
//   the last token's column from the phi_same product, blank -1e30;
//   tot = (base + where(v not eos / pad, aw la + lw ll, -1e30)) + cw psi,
//   -1e30 on dead slots; a stable top-K over the K x V scores (ties: lowest
//   flat index k V + v, as the port's stable sorts and lax.top_k);
//   the K winners' CTC states by the Hillis-Steele doubling of
//   ops/ctc_prefix._cumsum / _cumlogsumexp, pass for pass.
//
// The score compositions use __fadd_rn / __fmul_rn so that nvcc does not
// contract them into FMAs: the plain version on the card runs them as
// separate ops, and the mass ties of -1e30 sums decide which states dead
// slots gather. No fast-math (the 1e-38 floor is an f32 subnormal).
//
// Bound on the H100: bytes. A step reads the (T, V) log-probs, the K x T x 2
// prefix state and the logits once, and writes the new state (about 1.5 MB
// at B=32, K=8, V=31, T=176: 0.45 us); the psi products are 2 K T V FLOP per
// utterance, far below the compute line. Design, simple first: one block of
// NT threads per utterance. Phase 1 stages exp(lp) in TC x VT tiles of shared
// memory (V is streamed, never staged whole), with the step weights of KC
// hypotheses at a time in shared memory (one warp per hypothesis builds its
// row), one (hypothesis, column) sum per thread. Scores and psi go to a
// (B, K, V) scratch in device memory (L2-resident), which K rounds of block
// argmax read. Phase 2 walks the winners one at a time through shared-memory
// scans of length T. Shared memory grows with T (8 T floats), not with K T.
#include <climits>
#include <cuda_runtime.h>

#define NT 256            // threads per block
#define NW (NT / 32)      // warps per block
#define KC 8              // hypotheses per psi pass, one warp each
#define VT 32             // vocabulary columns per tile
#define TC 64             // frames per staged tile
#define NEG_INF (-1e30f)
#define CLIP (-1e5f)      // ops/ctc_prefix.CLIP
#define MAX_K 256         // the beam's packed-metadata limit
#define MAX_SMEM 232448   // bytes a block may use on Hopper

static_assert(KC * VT == NT, "one (hypothesis, column) pair per thread");
static_assert(KC == NW, "one warp per hypothesis of a psi pass");

__device__ __forceinline__ float neg_inf_f() { return __int_as_float(0xff800000); }

// torch.logaddexp's formula
__device__ __forceinline__ float logaddexp(float a, float b) {
  if (isinf(a) && a == b) return a;
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// (value desc, index asc): the order of a stable descending sort
__device__ __forceinline__ void keep_better(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) { v = v2; i = i2; }
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float v2 = __shfl_xor_sync(0xffffffffu, v, o);
    const int i2 = __shfl_xor_sync(0xffffffffu, i, o);
    keep_better(v, i, v2, i2);
  }
}

// The first entry of vals[0, n) in (value desc, index asc) order that comes
// strictly after (pv, pi) in that order (pi < 0: the first of all). Every
// thread of the block calls it and gets the pair. Selecting "after the last
// pick" needs no marks, so mass ties of equal values come out in index
// order, as a stable sort gives them.
__device__ void block_select(const float* vals, int n, float pv, int pi,
                             float* red_v, int* red_i, float& out_v, int& out_i) {
  float bv = neg_inf_f();
  int bi = INT_MAX;
  for (int j = threadIdx.x; j < n; j += NT) {
    const float x = vals[j];
    if (pi < 0 || x < pv || (x == pv && j > pi)) keep_better(bv, bi, x, j);
  }
  warp_best(bv, bi);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  __syncthreads();                       // red_* is free again
  if (lane == 0) { red_v[w] = bv; red_i[w] = bi; }
  __syncthreads();
  bv = lane < NW ? red_v[lane] : neg_inf_f();
  bi = lane < NW ? red_i[lane] : INT_MAX;
  warp_best(bv, bi);
  out_v = bv;
  out_i = min(bi, n - 1);                // only NaN scores leave it unset
}

// Inclusive scans over [0, T) by Hillis-Steele doubling, the passes of
// ops/ctc_prefix._cumsum / _cumlogsumexp (x + shift(x, s, fill)). The input
// is in a (written and synchronised), b is scratch; returns the buffer that
// holds the result.
__device__ float* scan_sum(float* a, float* b, int T) {
  for (int s = 1; s < T; s <<= 1) {
    for (int t = threadIdx.x; t < T; t += NT) b[t] = a[t] + (t >= s ? a[t - s] : 0.f);
    __syncthreads();
    float* c = a; a = b; b = c;
  }
  return a;
}

__device__ float* scan_lse(float* a, float* b, int T) {
  for (int s = 1; s < T; s <<= 1) {
    for (int t = threadIdx.x; t < T; t += NT)
      b[t] = logaddexp(a[t], t >= s ? a[t - s] : NEG_INF);
    __syncthreads();
    float* c = a; a = b; b = c;
  }
  return a;
}

__host__ __device__ inline size_t work_floats(int T) { return (size_t)(KC > 5 ? KC : 5) * T; }

extern "C" size_t beam_step_smem_bytes(int K, int T) {
  return (size_t)2 * K * sizeof(long long)          // finished-set metadata
         + (size_t)(2 * K + 6 * K) * sizeof(float)  // its scores, row stats
         + (size_t)2 * K * sizeof(int)              // winners
         + (size_t)NW * (sizeof(float) + sizeof(int))
         + (size_t)(TC * VT + work_floats(T)) * sizeof(float);
}

__global__ void __launch_bounds__(NT) beam_step_kernel(
    const float* __restrict__ logits, const float* __restrict__ lm,
    const float* __restrict__ base, const unsigned char* __restrict__ valid,
    const long long* __restrict__ last, const float* __restrict__ fin_norm,
    const long long* __restrict__ fin_meta, const float* __restrict__ r,
    const float* __restrict__ lp, const int* __restrict__ min_len,
    const int* __restrict__ max_len, long long* __restrict__ v_idx,
    long long* __restrict__ k_idx, unsigned char* __restrict__ new_valid,
    float* __restrict__ new_base, float* __restrict__ fin_norm_o,
    long long* __restrict__ fin_meta_o, float* __restrict__ r_o,
    float* __restrict__ psi_pick, float* __restrict__ tot_s,
    float* __restrict__ psi_s, int t, int K, int T, int V, float aw,
    float cw, float lw, int eos, int pad, int blank) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long* meta2 = reinterpret_cast<long long*>(smem);     // 2K
  float* val2 = reinterpret_cast<float*>(meta2 + 2 * K);     // 2K
  float* mx_a = val2 + 2 * K;                                // K each:
  float* ls_a = mx_a + K;   // attention row max, log-sum
  float* mx_l = ls_a + K;   // LM row max, log-sum
  float* ls_l = mx_l + K;
  float* md_s = ls_l + K;   // psi row shift
  float* ps_s = md_s + K;   // psi of repeating the last token
  int* win = reinterpret_cast<int*>(ps_s + K);               // 2K
  float* red_v = reinterpret_cast<float*>(win + 2 * K);      // NW
  int* red_i = reinterpret_cast<int*>(red_v + NW);           // NW
  float* tile = reinterpret_cast<float*>(red_i + NW);        // TC x VT
  float* work = tile + TC * VT;                              // work_floats(T)

  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const size_t bK = (size_t)b * K;
  const float* lg = logits + bK * V;
  const float* lmb = lm ? lm + bK * V : nullptr;
  const float* rb = r + bK * T * 2;
  const float* lpb = lp + (size_t)b * T * V;
  const float phi_m1 = t == 0 ? 0.f : NEG_INF;
  const int mn = min_len[b], ml = max_len[b];

  // 1. log-softmax normalisers, (x - max) - log(sum exp(x - max)): a warp
  // per attention or LM row
  for (int row = w; row < 2 * K; row += NW) {
    const bool is_lm = row >= K;
    if (is_lm && lmb == nullptr) break;
    const int k = row - (is_lm ? K : 0);
    const float* x = (is_lm ? lmb : lg) + (size_t)k * V;
    float m = neg_inf_f();
    for (int v = lane; v < V; v += 32) m = fmaxf(m, x[v]);
    m = warp_max(m);
    float s = 0.f;
    for (int v = lane; v < V; v += 32) s += expf(x[v] - m);
    s = warp_sum(s);
    if (lane == 0) {
      (is_lm ? mx_l : mx_a)[k] = m;
      (is_lm ? ls_l : ls_a)[k] = logf(s);
    }
  }
  __syncthreads();
  auto logp = [&](int k, int v, float& la, float& ll) {
    la = (lg[(size_t)k * V + v] - mx_a[k]) - ls_a[k];
    ll = lmb ? (lmb[(size_t)k * V + v] - mx_l[k]) - ls_l[k] : 0.f;
  };

  // 2. eos scores beside the finished set
  const float inv_len = 1.f / (float)max(t + 1, 1);
  for (int k = tid; k < K; k += NT) {
    float la, ll;
    logp(k, eos, la, ll);
    const float* re = rb + ((size_t)k * T + T - 1) * 2;
    const float ce = logaddexp(re[0], re[1]);
    const float te = __fadd_rn(__fadd_rn(__fadd_rn(base[bK + k], __fmul_rn(aw, la)),
                                         __fmul_rn(cw, ce)),
                               __fmul_rn(lw, ll));
    const bool ok = valid[bK + k] && (t + 1 >= mn || t + 1 >= ml);
    val2[k] = fin_norm[bK + k];
    meta2[k] = fin_meta[bK + k];
    val2[K + k] = ok ? __fmul_rn(te, inv_len) : NEG_INF;
    meta2[K + k] = ((long long)t << 8) + k;
  }
  __syncthreads();

  // 3. the finished-set merge: K picks over the 2K entries
  {
    float pv = 0.f;
    int pi = -1;
    for (int j = 0; j < K; ++j) {
      block_select(val2, 2 * K, pv, pi, red_v, red_i, pv, pi);
      if (tid == 0) {
        fin_norm_o[bK + j] = val2[pi];
        fin_meta_o[bK + j] = meta2[pi];
      }
    }
  }

  // 4. psi and the continuation scores, KC hypotheses per pass
  float* wd = work;                                          // KC x T
  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kn = min(KC, K - k0);
    if (w < kn) {
      const int k = k0 + w;
      const float* rk = rb + (size_t)k * T * 2;
      float* wk = wd + (size_t)w * T;
      float m = neg_inf_f(), ms = neg_inf_f();
      for (int tt = lane; tt < T; tt += 32) {
        const float pd = tt == 0 ? phi_m1
                                 : logaddexp(rk[(tt - 1) * 2 + 1], rk[(tt - 1) * 2]);
        const float ps = tt == 0 ? phi_m1 : rk[(tt - 1) * 2 + 1];
        wk[tt] = pd;
        m = fmaxf(m, pd);
        ms = fmaxf(ms, ps);
      }
      m = fmaxf(warp_max(m), NEG_INF / 2);
      ms = fmaxf(warp_max(ms), NEG_INF / 2);
      const int l = (int)last[bK + k];
      float s = 0.f;
      for (int tt = lane; tt < T; tt += 32) {
        wk[tt] = expf(wk[tt] - m);
        const float ps = tt == 0 ? phi_m1 : rk[(tt - 1) * 2 + 1];
        s = fmaf(expf(ps - ms), expf(lpb[(size_t)tt * V + l]), s);
      }
      s = warp_sum(s);
      if (lane == 0) {
        md_s[k] = m;
        ps_s[k] = ms + logf(s + 1e-38f);
      }
    }
    const int kk = tid / VT, vv = tid % VT, k = k0 + kk;
    for (int v0 = 0; v0 < V; v0 += VT) {
      const int v = v0 + vv;
      float acc = 0.f;
      for (int t0 = 0; t0 < T; t0 += TC) {
        const int tn = min(TC, T - t0);
        __syncthreads();           // the step weights are in; the last tile is read
        for (int i = tid; i < TC * VT; i += NT) {
          const int tt = i / VT, c = i % VT;
          tile[i] = (tt < tn && v0 + c < V)
                        ? expf(lpb[(size_t)(t0 + tt) * V + v0 + c]) : 0.f;
        }
        __syncthreads();
        if (kk < kn) {
          const float* wrow = wd + (size_t)kk * T + t0;
          for (int tt = 0; tt < tn; ++tt) acc = fmaf(wrow[tt], tile[tt * VT + vv], acc);
        }
      }
      if (kk < kn && v < V) {
        float psi = md_s[k] + logf(acc + 1e-38f);
        psi = v == (int)last[bK + k] ? ps_s[k] : psi;
        psi = v == blank ? NEG_INF : psi;
        float la, ll;
        logp(k, v, la, ll);
        const float step = __fadd_rn(__fmul_rn(aw, la), __fmul_rn(lw, ll));
        const float masked = (v != eos && v != pad) ? step : NEG_INF;
        float tot = __fadd_rn(__fadd_rn(base[bK + k], masked), __fmul_rn(cw, psi));
        tot = (valid[bK + k] && t < ml) ? tot : NEG_INF;
        psi_s[(bK + k) * V + v] = psi;
        tot_s[(bK + k) * V + v] = tot;
      }
    }
    __syncthreads();               // wd is rewritten by the next pass
  }

  // 5. the joint top-K over the K x V scores
  {
    const float* tb = tot_s + bK * V;
    float pv = 0.f;
    int pi = -1;
    for (int j = 0; j < K; ++j) {
      block_select(tb, K * V, pv, pi, red_v, red_i, pv, pi);
      if (tid == 0) {
        const float pp = psi_s[bK * V + pi];
        k_idx[bK + j] = pi / V;
        v_idx[bK + j] = pi % V;
        new_valid[bK + j] = pv > NEG_INF / 2;
        new_base[bK + j] = __fsub_rn(pv, __fmul_rn(cw, pp));
        psi_pick[bK + j] = pp;
        win[j] = pi / V;
        win[K + j] = pi % V;
      }
    }
  }

  // 6. the winners' CTC states: cumsum of the clamped token log-probs, its
  // cumulative logsumexp, then the blank side over the blank cumsum
  float* bcum = work;
  float* b0 = work + T;
  float* b1 = b0 + T;
  float* b2 = b1 + T;
  float* b3 = b2 + T;
  for (int tt = tid; tt < T; tt += NT) b0[tt] = fmaxf(lpb[(size_t)tt * V + blank], CLIP);
  __syncthreads();
  {
    const float* bc = scan_sum(b0, b1, T);
    for (int tt = tid; tt < T; tt += NT) bcum[tt] = bc[tt];
  }
  for (int j = 0; j < K; ++j) {
    __syncthreads();               // winners, bcum written; the last winner done
    const int kw = win[j], vw = win[K + j];
    const float* rk = rb + (size_t)kw * T * 2;
    const bool same = vw == (int)last[bK + kw];
    float* ro = r_o + ((bK + j) * T) * 2;
    for (int tt = tid; tt < T; tt += NT) b0[tt] = fmaxf(lpb[(size_t)tt * V + vw], CLIP);
    __syncthreads();
    const float* scum = scan_sum(b0, b1, T);
    float* spare = scum == b0 ? b1 : b0;
    for (int tt = tid; tt < T; tt += NT) {
      float ps = phi_m1;
      if (tt > 0) {
        const float rnb = rk[(tt - 1) * 2], rbb = rk[(tt - 1) * 2 + 1];
        ps = fmaxf(same ? rbb : logaddexp(rbb, rnb), NEG_INF);
      }
      b2[tt] = ps - (tt == 0 ? 0.f : scum[tt - 1]);
    }
    __syncthreads();
    const float* cl = scan_lse(b2, spare, T);
    for (int tt = tid; tt < T; tt += NT) {
      const float x = scum[tt] + cl[tt];
      b3[tt] = x;
      ro[(size_t)tt * 2] = x;
    }
    __syncthreads();               // b0, b1, b2 are free
    for (int tt = tid; tt < T; tt += NT)
      b0[tt] = tt == 0 ? NEG_INF : b3[tt - 1] - bcum[tt - 1];
    __syncthreads();
    const float* cu = scan_lse(b0, b1, T);
    for (int tt = tid; tt < T; tt += NT) ro[(size_t)tt * 2 + 1] = bcum[tt] + cu[tt];
  }
}

// logits / lm (lm may be null: no LM) (B, K, V) f32; base, fin_norm (B, K)
// f32; valid (B, K) bool; last, fin_meta (B, K) int64; r (B, K, T, 2) f32;
// lp (B, T, V) f32; min_len, max_len (B,) int32. Outputs v_idx, k_idx,
// fin_meta_o (B, K) int64; new_valid (B, K) bool; new_base, fin_norm_o,
// psi_pick (B, K) f32; r_o (B, K, T, 2) f32; scratch tot_s, psi_s (B, K, V).
extern "C" int beam_step_launch(
    const float* logits, const float* lm, const float* base,
    const unsigned char* valid, const long long* last, const float* fin_norm,
    const long long* fin_meta, const float* r, const float* lp,
    const int* min_len, const int* max_len, long long* v_idx,
    long long* k_idx, unsigned char* new_valid, float* new_base,
    float* fin_norm_o, long long* fin_meta_o, float* r_o, float* psi_pick,
    float* tot_s, float* psi_s, int t, int B, int K, int T, int V, float aw,
    float cw, float lw, int eos, int pad, int blank, void* stream) {
  if (B < 1 || K < 1 || K > MAX_K || T < 1 || V < 1 || t < 0
      || (long long)K * V > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const size_t smem = beam_step_smem_bytes(K, T);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      beam_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  beam_step_kernel<<<B, NT, smem, (cudaStream_t)stream>>>(
      logits, lm, base, valid, last, fin_norm, fin_meta, r, lp, min_len,
      max_len, v_idx, k_idx, new_valid, new_base, fin_norm_o, fin_meta_o, r_o,
      psi_pick, tot_s, psi_s, t, K, T, V, aw, cw, lw, eos, pad, blank);
  return (int)cudaGetLastError();
}

// K8: the tail of one joint CTC / attention / LM beam step, fused, for
// Hopper. Replaces end_to_end_asr_pytorch_tpu/ops/pallas/beam_step_kernel.py:
// fused_score_select (pallas_call at :310). From the model's and the LM's
// logits and the CTC prefix state it computes, per utterance b (K
// hypotheses, vocabulary V, T encoder frames), what decode/beam.py's step
// does after the model calls:
//
//   log-softmax of the attention and LM rows;
//   eos scores ((base + aw la[eos]) + cw ctc_eos) + lw ll[eos], masked, over
//   (t + 1), merged into the finished set by a stable top-K of 2K entries
//   (metadata (t << 8) + slot);
//   psi[k, v] = md + log(sum_t exp(phi_diff - md) probs[t, v] + 1e-38), with
//   probs = exp(lp) the beam's loop-invariant operand, the last token's
//   column from the phi_same product, blank -1e30;
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
// Bound on the H100: bytes. A step reads the (T, V) probs, the K x T x 2
// prefix state and the logits once and writes the new state: at B=32, K=8,
// T=176 about 1.5 MB at V=31 (0.45 us) and 126 MB at V=5120 (38 us, the
// probs alone 115 MB); the psi products, 2 K T V FLOP per utterance, stay
// far below the compute line. So the design spreads the probs stream over
// the card: a thread block cluster of C blocks per utterance (C = 1 for a
// small vocabulary, up to 16: the wrapper picks it), each block one slice
// of the vocabulary.
//   1. Each block takes its slice's row max and sum of exponentials; after
//      a cluster barrier every block combines the C partials through
//      distributed shared memory: M = max m_i, S = sum s_i exp(m_i - M).
//   2. Psi: the step weights of up to KC hypotheses are staged once in
//      shared memory; the slice's probs stream through two TT-frame tiles
//      filled by cp.async (the next tile in flight while the current one
//      is summed); each thread keeps its columns' sums for every hypothesis
//      in registers (or, for a slice of at most 32 columns, one hypothesis
//      and column per thread). The scores and psi of the slice stay in
//      shared memory.
//   3. Each block selects its slice's K best by (value desc, flat index
//      asc); after a second cluster barrier every block reads the C x K
//      candidates through distributed shared memory and ranks them. Every
//      global winner is among its own slice's K best, so this is exactly
//      the global stable top-K, and the candidates carry their psi: nothing
//      goes through device memory. Block 0 merges the finished set and
//      writes the picks.
//   4. The winners' CTC states: winner j goes to block j mod C, and a block
//      with several winners runs them at once in groups of warps (named
//      barriers), each through shared-memory scans of length T.
#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#define NT 256            // threads per block
#define NW (NT / 32)      // warps per block
#define KC 8              // hypotheses per psi pass
#define TT 16             // frames per probs tile
#define CWM (2 * NT)      // columns per psi chunk: at most two per thread
#define NEG_INF (-1e30f)
#define CLIP (-1e5f)      // ops/ctc_prefix.CLIP
#define MAX_K 256         // the beam's packed-metadata limit
#define MAX_C 16          // blocks per cluster (the H100's non-portable size)
#define MAX_SMEM 232448   // bytes a block may use on Hopper

static_assert(KC * 32 == NT, "one (hypothesis, column) pair per thread");

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
__device__ __forceinline__ bool better(float v2, int i2, float v, int i) {
  return v2 > v || (v2 == v && i2 < i);
}

__device__ __forceinline__ void keep_better(float& v, int& i, float v2, int i2) {
  if (better(v2, i2, v, i)) { v = v2; i = i2; }
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float v2 = __shfl_xor_sync(0xffffffffu, v, o);
    const int i2 = __shfl_xor_sync(0xffffffffu, i, o);
    keep_better(v, i, v2, i2);
  }
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a), "l"(src));
}
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a), "l"(src));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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
// ops/ctc_prefix._cumsum / _cumlogsumexp (x + shift(x, s, fill)), run by the
// n threads (thread gt of them) behind named barrier `id`. The input is in a
// (written and synchronised), b is scratch; returns the buffer that holds
// the result.
__device__ float* scan_sum(float* a, float* b, int T, int gt, int n, int id) {
  for (int s = 1; s < T; s <<= 1) {
    for (int t = gt; t < T; t += n) b[t] = a[t] + (t >= s ? a[t - s] : 0.f);
    bar_sync(id, n);
    float* c = a; a = b; b = c;
  }
  return a;
}

__device__ float* scan_lse(float* a, float* b, int T, int gt, int n, int id) {
  for (int s = 1; s < T; s <<= 1) {
    for (int t = gt; t < T; t += n)
      b[t] = logaddexp(a[t], t >= s ? a[t - s] : NEG_INF);
    bar_sync(id, n);
    float* c = a; a = b; b = c;
  }
  return a;
}

struct BeamArgs {
  const float* logits;          // (B, K, V)
  const float* lm;              // (B, K, V) or null: no LM
  const float* base;            // (B, K)
  const unsigned char* valid;   // (B, K)
  const long long* last;        // (B, K)
  const float* fin_norm;        // (B, K)
  const long long* fin_meta;    // (B, K)
  const float* r;               // (B, K, T, 2)
  const float* lp;              // (B, T, V)
  const float* probs;           // (B, T, V) = exp(lp)
  const int* min_len;           // (B,)
  const int* max_len;           // (B,)
  long long* v_idx;
  long long* k_idx;
  unsigned char* new_valid;
  float* new_base;
  float* fin_norm_o;
  long long* fin_meta_o;
  float* r_o;
  float* psi_pick;
  int t, K, T, V, C, vs, g6;    // vs: slice width; g6: winner groups
  float aw, cw, lw;
  int eos, pad, blank;
};

// Byte offsets of one block's dynamic shared memory.
struct BeamLayout {
  size_t red_v, red_i, part, nrm, md, ps, wd, tile, sc, psc, cv, ci, cp, mv,
      mi, mp, wf, wv, wp, meta2, val2, total;
};

__host__ __device__ inline size_t al16(size_t x) { return (x + 15) & ~(size_t)15; }

__host__ __device__ inline BeamLayout beam_layout(int K, int T, int vs, int C,
                                                  int g6) {
  BeamLayout L;
  size_t o = 0;
  auto take = [&](size_t& at, size_t bytes) { at = o; o = al16(o + bytes); };
  take(L.red_v, NW * 4);
  take(L.red_i, NW * 4);
  take(L.part, (size_t)4 * K * 4);   // this slice's (max, sum) of 2K rows
  take(L.nrm, (size_t)4 * K * 4);    // the combined (max, log-sum)
  take(L.md, (size_t)K * 4);         // psi row shift
  take(L.ps, (size_t)K * 4);         // psi of repeating the last token
  take(L.wd, (size_t)KC * T * 4);    // step weights of a pass
  const size_t cwm = vs < CWM ? vs : CWM;
  const size_t tile = 2 * TT * cwm, p6 = (size_t)(1 + 4 * g6) * T;
  take(L.tile, (tile > p6 ? tile : p6) * 4);  // probs tiles, then phase 4
  take(L.sc, (size_t)K * vs * 4);    // the slice's scores
  take(L.psc, (size_t)K * vs * 4);   // and psi
  take(L.cv, (size_t)K * 4);         // its K candidates: value,
  take(L.ci, (size_t)K * 4);         // flat index k V + v,
  take(L.cp, (size_t)K * 4);         // psi
  take(L.mv, (size_t)C * K * 4);     // the cluster's candidates
  take(L.mi, (size_t)C * K * 4);
  take(L.mp, (size_t)C * K * 4);
  take(L.wf, (size_t)K * 4);         // the winners
  take(L.wv, (size_t)K * 4);
  take(L.wp, (size_t)K * 4);
  take(L.meta2, (size_t)2 * K * 8);  // the finished-set merge (block 0)
  take(L.val2, (size_t)2 * K * 4);
  L.total = o;
  return L;
}

// One chunk [c0, c0 + cw) of the slice: psi and the continuation scores of
// hypotheses k0 .. k0 + kn - 1. HPT hypotheses and CPT columns per thread:
// (KC, 2) for wide slices, (1, 1) for at most 32 columns (thread = one
// hypothesis of 8, one column of 32). The chunk's first tile is issued
// already when `issued`.
template <int HPT, int CPT>
__device__ void psi_chunk(const BeamArgs& a, const BeamLayout& L,
                          unsigned char* smem, int b, int v_lo, int vn,
                          int k0, int kn, int c0, int cw, bool issued) {
  const int T = a.T, V = a.V, K = a.K, tid = threadIdx.x;
  const float* pb = a.probs + (size_t)b * T * V + v_lo + c0;
  float* tile = (float*)(smem + L.tile);
  const float* wd = (const float*)(smem + L.wd);
  const int cwm = a.vs < CWM ? a.vs : CWM;
  const bool vec = V % 4 == 0 && (v_lo + c0) % 4 == 0 && cw % 4 == 0;
  const int ntile = (T + TT - 1) / TT;
  auto issue = [&](int n) {
    float* dst = tile + (size_t)(n & 1) * TT * cwm;
    const int t0 = n * TT, tn = min(TT, T - t0);
    if (vec) {
      const int c4 = cw / 4;
      for (int i = tid; i < tn * c4; i += NT) {
        const int tt = i / c4, c = 4 * (i - tt * c4);
        cp16(dst + tt * cw + c, pb + (size_t)(t0 + tt) * V + c);
      }
    } else {
      for (int i = tid; i < tn * cw; i += NT) {
        const int tt = i / cw, c = i - tt * cw;
        cp4(dst + tt * cw + c, pb + (size_t)(t0 + tt) * V + c);
      }
    }
    cp_commit();
  };
  if (!issued) issue(0);
  // this thread's columns and hypotheses
  const int hk = HPT == 1 ? tid / 32 : 0;          // its hypothesis (HPT 1)
  const int col0 = HPT == 1 ? tid % 32 : tid;
  float acc[CPT][HPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j)
#pragma unroll
    for (int h = 0; h < HPT; ++h) acc[j][h] = 0.f;
  for (int n = 0; n < ntile; ++n) {
    if (n + 1 < ntile) {
      issue(n + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* tl = tile + (size_t)(n & 1) * TT * cwm;
    const int t0 = n * TT, tn = min(TT, T - t0);
    if (HPT == 1) {
      if (hk < kn && col0 < cw) {
        const float* wr = wd + (size_t)hk * T + t0;
        for (int tt = 0; tt < tn; ++tt)
          acc[0][0] = fmaf(wr[tt], tl[tt * cw + col0], acc[0][0]);
      }
    } else {
      for (int tt = 0; tt < tn; ++tt) {
        float p[CPT];
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int c = col0 + j * NT;
          p[j] = c < cw ? tl[tt * cw + c] : 0.f;
        }
#pragma unroll
        for (int h = 0; h < HPT; ++h) {
          const float w = wd[(size_t)h * T + t0 + tt];
#pragma unroll
          for (int j = 0; j < CPT; ++j) acc[j][h] = fmaf(w, p[j], acc[j][h]);
        }
      }
    }
    __syncthreads();                     // the tile's buffer is free again
  }

  // psi and the continuation scores of this thread's (hypothesis, column)s
  const size_t bK = (size_t)b * K;
  const float* nrm = (const float*)(smem + L.nrm);
  const float* md_s = (const float*)(smem + L.md);
  const float* ps_s = (const float*)(smem + L.ps);
  float* sc = (float*)(smem + L.sc);
  float* psc = (float*)(smem + L.psc);
  const int ml = a.max_len[b];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int c = col0 + j * NT;
    if (c >= cw) continue;
    const int v = v_lo + c0 + c;
#pragma unroll
    for (int h = 0; h < HPT; ++h) {
      const int kk = HPT == 1 ? hk : h;
      if (kk >= kn) continue;
      const int k = k0 + kk;
      float psi = md_s[k] + logf(acc[j][h] + 1e-38f);
      psi = v == (int)a.last[bK + k] ? ps_s[k] : psi;
      psi = v == a.blank ? NEG_INF : psi;
      const float la = (a.logits[(bK + k) * V + v] - nrm[2 * k]) - nrm[2 * k + 1];
      const float ll = a.lm ? (a.lm[(bK + k) * V + v] - nrm[2 * (K + k)])
                                  - nrm[2 * (K + k) + 1]
                            : 0.f;
      const float step = __fadd_rn(__fmul_rn(a.aw, la), __fmul_rn(a.lw, ll));
      const float masked = (v != a.eos && v != a.pad) ? step : NEG_INF;
      float tot = __fadd_rn(__fadd_rn(a.base[bK + k], masked),
                            __fmul_rn(a.cw, psi));
      tot = (a.valid[bK + k] && a.t < ml) ? tot : NEG_INF;
      sc[(size_t)k * vn + c0 + c] = tot;
      psc[(size_t)k * vn + c0 + c] = psi;
    }
  }
}

__global__ void __launch_bounds__(NT) beam_step_kernel(BeamArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = a.K, T = a.T, V = a.V, C = a.C;
  const BeamLayout L = beam_layout(K, T, a.vs, C, a.g6);
  float* red_v = (float*)(smem + L.red_v);
  int* red_i = (int*)(smem + L.red_i);
  float* part = (float*)(smem + L.part);
  float* nrm = (float*)(smem + L.nrm);
  float* md_s = (float*)(smem + L.md);
  float* ps_s = (float*)(smem + L.ps);
  float* wd = (float*)(smem + L.wd);
  float* sc = (float*)(smem + L.sc);
  float* psc = (float*)(smem + L.psc);
  float* cv = (float*)(smem + L.cv);
  int* ci = (int*)(smem + L.ci);
  float* cpsi = (float*)(smem + L.cp);
  float* mv = (float*)(smem + L.mv);
  int* mi = (int*)(smem + L.mi);
  float* mp = (float*)(smem + L.mp);
  int* wf = (int*)(smem + L.wf);
  float* wv = (float*)(smem + L.wv);
  float* wp = (float*)(smem + L.wp);

  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const int b = blockIdx.x / C, tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int v_lo = rank * a.vs, vn = min(a.vs, V - v_lo);
  const size_t bK = (size_t)b * K;
  const float* lg = a.logits + bK * V;
  const float* lmb = a.lm ? a.lm + bK * V : nullptr;
  const float* rb = a.r + bK * T * 2;
  const float* lpb = a.lp + (size_t)b * T * V;
  const float* pb = a.probs + (size_t)b * T * V;
  const float phi_m1 = a.t == 0 ? 0.f : NEG_INF;
  const int mn = a.min_len[b], ml = a.max_len[b];
  const int cw0 = min(vn, CWM);
  // the slice's first probs tile is on its way during the set-up (the
  // first psi_chunk call below starts from it)
  {
    float* tile = (float*)(smem + L.tile);
    const int tn = min(TT, T);
    const bool vec = V % 4 == 0 && v_lo % 4 == 0 && cw0 % 4 == 0;
    const float* src = pb + v_lo;
    if (vec) {
      const int c4 = cw0 / 4;
      for (int i = tid; i < tn * c4; i += NT) {
        const int tt = i / c4, c = 4 * (i - tt * c4);
        cp16(tile + tt * cw0 + c, src + (size_t)tt * V + c);
      }
    } else {
      for (int i = tid; i < tn * cw0; i += NT) {
        const int tt = i / cw0, c = i - tt * cw0;
        cp4(tile + tt * cw0 + c, src + (size_t)tt * V + c);
      }
    }
    cp_commit();
  }

  // 1. log-softmax normalisers: this slice's (max, sum exp(x - max)) of each
  // attention or LM row, a warp per row, then combined over the cluster
  for (int row = w; row < 2 * K; row += NW) {
    const bool is_lm = row >= K;
    if (is_lm && lmb == nullptr) break;
    const float* x = (is_lm ? lmb : lg) + (size_t)(row - (is_lm ? K : 0)) * V + v_lo;
    float m = neg_inf_f();
    for (int v = lane; v < vn; v += 32) m = fmaxf(m, x[v]);
    m = warp_max(m);
    float s = 0.f;
    for (int v = lane; v < vn; v += 32) s += expf(x[v] - m);
    s = warp_sum(s);
    if (lane == 0) { part[2 * row] = m; part[2 * row + 1] = s; }
  }
  cl.sync();
  for (int row = tid; row < 2 * K; row += NT) {
    if (row >= K && lmb == nullptr) break;
    float M = neg_inf_f();
    for (int q = 0; q < C; ++q) M = fmaxf(M, cl.map_shared_rank(part, q)[2 * row]);
    float S = 0.f;
    for (int q = 0; q < C; ++q) {
      const float* pq = cl.map_shared_rank(part, q);
      S += pq[2 * row + 1] * expf(pq[2 * row] - M);
    }
    nrm[2 * row] = M;
    nrm[2 * row + 1] = logf(S);
  }

  // 2. psi and the continuation scores of the slice, KC hypotheses per pass
  bool issued = true;
  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kn = min(KC, K - k0);
    __syncthreads();                     // wd is free; nrm is written
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
      const int l = (int)a.last[bK + k];
      const bool mine = l >= v_lo && l < v_lo + vn;
      float s = 0.f;
      for (int tt = lane; tt < T; tt += 32) {
        wk[tt] = expf(wk[tt] - m);
        if (mine) {
          const float ps = tt == 0 ? phi_m1 : rk[(tt - 1) * 2 + 1];
          s = fmaf(expf(ps - ms), pb[(size_t)tt * V + l], s);
        }
      }
      s = warp_sum(s);
      if (lane == 0) {
        md_s[k] = m;
        ps_s[k] = ms + logf(s + 1e-38f);
      }
    }
    __syncthreads();
    for (int c0 = 0; c0 < vn; c0 += CWM) {
      const int cw = min(CWM, vn - c0);
      if (cw <= 32)
        psi_chunk<1, 1>(a, L, smem, b, v_lo, vn, k0, kn, c0, cw, issued);
      else
        psi_chunk<KC, 2>(a, L, smem, b, v_lo, vn, k0, kn, c0, cw, issued);
      issued = false;
    }
  }
  __syncthreads();

  // 3. block 0: the eos scores and the finished-set merge (K picks over
  // the 2K entries); every block: its slice's K best candidates
  if (rank == 0) {
    long long* meta2 = (long long*)(smem + L.meta2);
    float* val2 = (float*)(smem + L.val2);
    const float inv_len = 1.f / (float)max(a.t + 1, 1);
    for (int k = tid; k < K; k += NT) {
      const float la = (lg[(size_t)k * V + a.eos] - nrm[2 * k]) - nrm[2 * k + 1];
      const float ll = lmb ? (lmb[(size_t)k * V + a.eos] - nrm[2 * (K + k)])
                                 - nrm[2 * (K + k) + 1]
                           : 0.f;
      const float* re = rb + ((size_t)k * T + T - 1) * 2;
      const float ce = logaddexp(re[0], re[1]);
      const float te = __fadd_rn(
          __fadd_rn(__fadd_rn(a.base[bK + k], __fmul_rn(a.aw, la)),
                    __fmul_rn(a.cw, ce)),
          __fmul_rn(a.lw, ll));
      const bool ok = a.valid[bK + k] && (a.t + 1 >= mn || a.t + 1 >= ml);
      val2[k] = a.fin_norm[bK + k];
      meta2[k] = a.fin_meta[bK + k];
      val2[K + k] = ok ? __fmul_rn(te, inv_len) : NEG_INF;
      meta2[K + k] = ((long long)a.t << 8) + k;
    }
    __syncthreads();
    float pv = 0.f;
    int pi = -1;
    for (int j = 0; j < K; ++j) {
      block_select(val2, 2 * K, pv, pi, red_v, red_i, pv, pi);
      if (tid == 0) {
        a.fin_norm_o[bK + j] = val2[pi];
        a.fin_meta_o[bK + j] = meta2[pi];
      }
    }
  }
  {
    float pv = 0.f;
    int pi = -1;
    for (int j = 0; j < K; ++j) {
      block_select(sc, K * vn, pv, pi, red_v, red_i, pv, pi);
      if (tid == 0) {
        const int k = pi / vn, c = pi - k * vn;
        cv[j] = pv;
        ci[j] = k * V + v_lo + c;
        cpsi[j] = psc[pi];
      }
    }
  }

  // 4. the joint top-K: every block ranks the cluster's C x K candidates
  cl.sync();
  const int nc = C * K;
  for (int i = tid; i < nc; i += NT) {
    const int q = i / K, e = i - q * K;
    mv[i] = cl.map_shared_rank(cv, q)[e];
    mi[i] = cl.map_shared_rank(ci, q)[e];
    mp[i] = cl.map_shared_rank(cpsi, q)[e];
  }
  __syncthreads();
  cluster_arrive();                      // done with the peers' memory
  for (int j = tid; j < K; j += NT) {    // only NaN scores leave a rank unset
    wf[j] = mi[j]; wv[j] = mv[j]; wp[j] = mp[j];
  }
  __syncthreads();
  for (int i = tid; i < nc; i += NT) {
    const float v = mv[i];
    const int f = mi[i];
    int rk = 0;
    for (int j = 0; j < nc; ++j) rk += better(mv[j], mi[j], v, f);
    if (rk < K) { wf[rk] = f; wv[rk] = v; wp[rk] = mp[i]; }
  }
  __syncthreads();
  if (rank == 0) {
    for (int j = tid; j < K; j += NT) {
      const int f = wf[j];
      a.k_idx[bK + j] = f / V;
      a.v_idx[bK + j] = f % V;
      a.new_valid[bK + j] = wv[j] > NEG_INF / 2;
      a.new_base[bK + j] = __fsub_rn(wv[j], __fmul_rn(a.cw, wp[j]));
      a.psi_pick[bK + j] = wp[j];
    }
  }

  // 5. the winners' CTC states (winner j in block j mod C): cumsum of the
  // clamped token log-probs, its cumulative logsumexp, then the blank side
  // over the blank cumsum; g groups of warps take a block's winners in turn
  const int nwb = rank < K ? (K - rank + C - 1) / C : 0;
  if (nwb > 0) {
    float* bcum = (float*)(smem + L.tile);
    {
      float* s0 = bcum + T;
      float* s1 = s0 + T;
      for (int tt = tid; tt < T; tt += NT) s0[tt] = fmaxf(lpb[(size_t)tt * V + a.blank], CLIP);
      __syncthreads();
      const float* bc = scan_sum(s0, s1, T, tid, NT, 0);
      for (int tt = tid; tt < T; tt += NT) bcum[tt] = bc[tt];
      __syncthreads();
    }
    int g = 1;
    while (2 * g <= a.g6 && 2 * g <= nwb) g *= 2;
    const int gn = NT / g, gi = tid / gn, gt = tid - gi * gn, id = 1 + gi;
    float* b0 = bcum + T + (size_t)gi * 4 * T;
    float* b1 = b0 + T;
    float* b2 = b1 + T;
    float* b3 = b2 + T;
    for (int i = gi; i < nwb; i += g) {
      const int j = rank + i * C;
      const int kw = wf[j] / V, vw = wf[j] % V;
      const float* rk = rb + (size_t)kw * T * 2;
      const bool same = vw == (int)a.last[bK + kw];
      float* ro = a.r_o + ((bK + j) * T) * 2;
      bar_sync(id, gn);                  // the group's last winner is done
      for (int tt = gt; tt < T; tt += gn) b0[tt] = fmaxf(lpb[(size_t)tt * V + vw], CLIP);
      bar_sync(id, gn);
      const float* scum = scan_sum(b0, b1, T, gt, gn, id);
      float* spare = scum == b0 ? b1 : b0;
      for (int tt = gt; tt < T; tt += gn) {
        float ps = phi_m1;
        if (tt > 0) {
          const float rnb = rk[(tt - 1) * 2], rbb = rk[(tt - 1) * 2 + 1];
          ps = fmaxf(same ? rbb : logaddexp(rbb, rnb), NEG_INF);
        }
        b2[tt] = ps - (tt == 0 ? 0.f : scum[tt - 1]);
      }
      bar_sync(id, gn);
      const float* cl2 = scan_lse(b2, spare, T, gt, gn, id);
      for (int tt = gt; tt < T; tt += gn) {
        const float x = scum[tt] + cl2[tt];
        b3[tt] = x;
        ro[(size_t)tt * 2] = x;
      }
      bar_sync(id, gn);                  // b0, b1, b2 are free
      for (int tt = gt; tt < T; tt += gn)
        b0[tt] = tt == 0 ? NEG_INF : b3[tt - 1] - bcum[tt - 1];
      bar_sync(id, gn);
      const float* cu = scan_lse(b0, b1, T, gt, gn, id);
      for (int tt = gt; tt < T; tt += gn) ro[(size_t)tt * 2 + 1] = bcum[tt] + cu[tt];
    }
  }
  cluster_wait();                        // no block leaves while read
}

// Slice width of a split of V over C blocks, or 0 when a slice would be
// empty or C is out of range.
static int slice_width(int V, int C) {
  if (C < 1 || C > MAX_C || C > V) return 0;
  const int vs = (V + C - 1) / C;
  return (C - 1) * vs < V ? vs : 0;
}

// Groups of warps for the winners of one block: a power of two, at most
// NW and ceil(K / C), whose scratch fits.
static int winner_groups(int K, int T, int vs, int C) {
  const int nw = (K + C - 1) / C;
  int g = 1;
  while (2 * g <= NW && 2 * g <= nw &&
         beam_layout(K, T, vs, C, 2 * g).total <= MAX_SMEM)
    g *= 2;
  return g;
}

extern "C" size_t beam_step_smem_bytes(int K, int T, int V, int C) {
  const int vs = slice_width(V, C);
  return vs ? beam_layout(K, T, vs, C, winner_groups(K, T, vs, C)).total : 0;
}

static cudaLaunchConfig_t beam_config(int B, int C, size_t smem,
                                      cudaLaunchAttribute* attr,
                                      cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(B * C);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Sets the kernel's shared-memory limit (raised only, once per size and
// device: the host time of a launch at V=31 is most of its time) and, for
// clusters of more than 8 blocks, the non-portable cluster size.
static int beam_prepare(size_t smem, int C) {
  static size_t smem_set[64] = {0};
  static bool wide_set[64] = {false};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) dev = 63;
  if (smem > smem_set[dev]) {
    e = cudaFuncSetAttribute(beam_step_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set[dev] = smem;
  }
  if (C > 8 && !wide_set[dev]) {
    e = cudaFuncSetAttribute(beam_step_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
    wide_set[dev] = true;
  }
  return 0;
}

// Clusters of C blocks (one utterance each) that can be resident at once,
// into *out (0 where the split or its shared memory does not fit).
extern "C" int beam_step_max_clusters(int K, int T, int V, int C, int* out) {
  *out = 0;
  const size_t smem = beam_step_smem_bytes(K, T, V, C);
  if (K < 1 || K > MAX_K || T < 1 || smem == 0 || smem > MAX_SMEM) return 0;
  int e = beam_prepare(smem, C);
  if (e != 0) return e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = beam_config(1, C, smem, attr, 0);
  return (int)cudaOccupancyMaxActiveClusters(out, beam_step_kernel, &cfg);
}

// logits / lm (lm may be null: no LM) (B, K, V) f32; base, fin_norm (B, K)
// f32; valid (B, K) bool; last, fin_meta (B, K) int64; r (B, K, T, 2) f32;
// lp and probs = exp(lp) (B, T, V) f32; min_len, max_len (B,) int32. Outputs
// v_idx, k_idx, fin_meta_o (B, K) int64; new_valid (B, K) bool; new_base,
// fin_norm_o, psi_pick (B, K) f32; r_o (B, K, T, 2) f32. C blocks (one
// cluster) per utterance.
extern "C" int beam_step_launch(
    const float* logits, const float* lm, const float* base,
    const unsigned char* valid, const long long* last, const float* fin_norm,
    const long long* fin_meta, const float* r, const float* lp,
    const float* probs, const int* min_len, const int* max_len,
    long long* v_idx, long long* k_idx, unsigned char* new_valid,
    float* new_base, float* fin_norm_o, long long* fin_meta_o, float* r_o,
    float* psi_pick, int t, int B, int K, int T, int V, int C, float aw,
    float cw, float lw, int eos, int pad, int blank, void* stream) {
  const int vs = slice_width(V, C);
  if (B < 1 || K < 1 || K > MAX_K || T < 1 || t < 0 || vs == 0 ||
      (long long)K * V > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const int g6 = winner_groups(K, T, vs, C);
  const size_t smem = beam_layout(K, T, vs, C, g6).total;
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  int e = beam_prepare(smem, C);
  if (e != 0) return e;
  BeamArgs a = {logits, lm, base, valid, last, fin_norm, fin_meta, r, lp,
                probs, min_len, max_len, v_idx, k_idx, new_valid, new_base,
                fin_norm_o, fin_meta_o, r_o, psi_pick, t, K, T, V, C, vs, g6,
                aw, cw, lw, eos, pad, blank};
  if (C == 1) {        // a grid launched without clusters: clusters of 1
    beam_step_kernel<<<B, NT, smem, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
  }
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = beam_config(B, C, smem, attr, (cudaStream_t)stream);
  void* args[] = {(void*)&a};
  cudaError_t ce = cudaLaunchKernelExC(&cfg, (const void*)beam_step_kernel, args);
  if (ce != cudaSuccess) return (int)ce;
  return (int)cudaGetLastError();
}

// One beam step of single-head location attention (K5) for Hopper, full f32.
//
// Replaces end_to_end_asr_pytorch_tpu/ops/pallas/att_kernel.py:57
// loc_attention_fused (pallas_call at :69; reached from
// models/attention.py:step_beam with attention.use_pallas). For every
// utterance b and hypothesis k:
//   f_tj   = sum_c fsm[b,k,t,c] * w_f[c,j]      (location features, F -> d)
//   energy = (sum_j v_j tanh(qb[b,k,j] + keys[b,t,j] + f_tj)) / tau, masked
//            to -1e30 at t >= enc_len[b]
//   align  = softmax_t(energy),   ctx_j = sum_t align_t * vals[b,t,j]
// (the arithmetic of loc_att_common.cuh: frames past the length get align
// exactly 0; a row with enc_len <= 0 gets a uniform alignment over all T).
//
// Bound on the H100: the f32 operations, ~(2F + 5) per (b, k, t, j) element
// with each tanh counted as one (0.27 GFLOP at B=32, K=8, T=176, d=300,
// F=10 with the slice's ragged lengths: ~4 us at 67 TFLOP/s), above the
// unique bytes (keys, vals and fsm, ~12 MB: ~3.7 us). In practice each
// element's tanhf (two SFU operations beside a polynomial) sets the time.
//
// Design: one thread block cluster of C blocks per utterance (C <= 8,
// picked by ops/cuda/att_kernel.py:pick_slices so that the clusters of a
// batch are resident together where they can be). The frames whose
// alignment can be non-zero, [0, n) (all T where enc_len <= 0), are split
// evenly: block `rank` owns [rank ts, rank ts + ts), ts = ceil(n / C), for
// all K hypotheses, so no block idles past the length and the K rows share
// every read of keys and values, as the TPU kernel's grid cell does:
//   1. Its frames stream through shared memory in tiles of TT frames, two
//      buffers filled by cp.async (the next tile in flight while the
//      current one is used): first the keys and fsm rows, then the values.
//      w_f is split once per block into bf16 parts laid out as the B
//      fragments of mma.sync (built from global memory while the first
//      tile lands).
//   2. Energies: a warp item is 32 (hypothesis, frame) pairs by 64
//      columns of d. Location features on the tensor cores: f = fsm . w_f
//      over 16 pairs x 8 columns is six m16n8k16 products of the bf16
//      parts (hi, mid, lo) of fsm and w_f, the largest apart, which equals
//      the f32 product to f32 rounding; the accumulators start at
//      q + key. Each lane then takes tanh of its 32 elements (4 pairs x 8
//      columns), weighs them by v and sums them; the four lanes of a pair
//      add up by shuffles and the item's sums go to shared memory by
//      chunk, summed in chunk order (deterministic). Rows of q, keys and v
//      are zero-padded to whole chunks. Frames at or past enc_len are not
//      computed.
//   3. Per hypothesis the block takes its frames' max m_r and sum
//      s_r = sum exp(e - m_r), and its partial context sum_t exp(e - m_r)
//      vals[t] (threads over (column, 4 hypotheses)).
//   4. After barrier.cluster every block reads the C partials through
//      distributed shared memory: M = max m_r, S = sum s_r exp(m_r - M);
//      block `rank` writes its share of the K x vdim context,
//      sum_r exp(m_r - M) ctx_r / S, and the alignment of its own frames,
//      exp(e - M) / S. A second barrier keeps every block alive until its
//      peers have read it.
// The frames past the length get align 0, written by the C blocks in
// turn. A block left without a frame (n < C) loads and computes nothing
// and contributes m = -FLT_MAX, s = 0 and a zero context. Two blocks of
// 256 threads fit an SM (128 registers: at 80, for three, the fragments
// spilled); on an H100 30 clusters of 8 such blocks are resident at once
// but 32 of 7, so B=32 runs as clusters of 7.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "loc_att_common.cuh"

namespace cg = cooperative_groups;

#define K5_THREADS 256
#define K5_WARPS (K5_THREADS / 32)
#define K5_MAX_C 8          // blocks per cluster (portable size)
#define K5_CW 64            // columns of d per energy item
#define K5_FT 16            // fsm taps per tensor-core product (one k-step)
#define K5_KR 4             // hypotheses per context pass
static_assert(K5_KR == 4, "the context reads one float4 of weights a frame");
// Blocks per SM, and their shared memory: (228 KB - 2 x 1 KB reserved) / 2.
#define K5_BLOCKS_PER_SM 2
#define K5_SMEM_PER_SM 233472
#define K5_MAX_SMEM 232448  // bytes a block may use on Hopper

struct K5Args {
  const float *qb, *keys, *fsm, *w_f, *v, *vals;
  const int* lens;
  float *ctx, *align;
  int K, T, d, F, vdim, C;
  int ts, TT;               // frames per block at most, per tile
  int dP, vP, KP, nc;       // padded strides; nc chunks of K5_CW columns
  int vec_q, vec_k, vec_v;  // 16-byte copies of qb / keys / vals rows
  int vec_d;                // 16-byte copies of v
  int vec_f;                // 16-byte copies of fsm runs (if aligned)
  float inv_tau;
};

// Offsets (floats) of one block's dynamic shared memory; every region
// starts on 16 bytes.
struct K5Layout {
  size_t q, wb, v, slot, slot_size, part, e, p, stat, total;
};

__host__ __device__ inline size_t k5_up4(size_t x) {
  return (x + 3) & ~(size_t)3;
}

__host__ __device__ inline K5Layout k5_layout(int K, int d, int F, int vdim,
                                              int C, int ts, int TT, int dP,
                                              int vP, int KP, int nc) {
  K5Layout L;
  size_t o = 0;
  L.q = o;    o += k5_up4((size_t)K * dP);             // qb rows
  // w_f as the tensor-core product's B fragments, split: three parts x
  // nc K5_CW / 8 column tiles x 32 lanes x 2 words
  L.wb = o;   o += (size_t)3 * nc * (K5_CW / 8) * 32 * 2;
  L.v = o;    o += k5_up4((size_t)dP);                 // v, zero-padded
  // a tile: keys (TT x dP) and fsm (K x TT F), or vals (TT x vP)
  const size_t ek = (size_t)TT * dP + k5_up4((size_t)K * TT * F);
  const size_t ev = (size_t)TT * vP;
  L.slot_size = k5_up4(ek > ev ? ek : ev);
  L.slot = o; o += 2 * L.slot_size;
  // energy partials (nc x TT K) while the energies run, then the partial
  // context (K x vdim) that the peers read
  const size_t pp = (size_t)nc * TT * K, cc = (size_t)K * vdim;
  L.part = o; o += k5_up4(pp > cc ? pp : cc);
  L.e = o;    o += k5_up4((size_t)ts * KP);            // energies
  L.p = o;    o += k5_up4((size_t)ts * KP);            // exp(e - m_r)
  // m_r, s_r (read by the peers), M, S, and the C blocks' m_r (then the
  // combine weights) and s_r
  L.stat = o; o += k5_up4((size_t)(4 + 2 * C) * KP);
  L.total = o;
  return L;
}

// (x0, x1) -> bf16 pairs hi, mid, lo with x = hi + mid + lo, x0 in the low
// halves (the order of an mma.sync fragment register).
__device__ __forceinline__ void k5_split(float x0, float x1, uint32_t& h,
                                         uint32_t& m, uint32_t& l) {
  const __nv_bfloat162 hb = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(hb);
  const float r0 = x0 - hf.x, r1 = x1 - hf.y;
  const __nv_bfloat162 mb = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(mb);
  const __nv_bfloat162 lb = __floats2bfloat162_rn(r0 - mf.x, r1 - mf.y);
  h = *reinterpret_cast<const uint32_t*>(&hb);
  m = *reinterpret_cast<const uint32_t*>(&mb);
  l = *reinterpret_cast<const uint32_t*>(&lb);
}

// d += a (16 x 16, bf16) . b (16 x 8, bf16), f32 accumulators.
__device__ __forceinline__ void k5_mma(float* d, const uint32_t* a,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void k5_cp16(void* dst, const void* src) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
               "l"(src));
}
__device__ __forceinline__ void k5_cp4(void* dst, const void* src) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a),
               "l"(src));
}
__device__ __forceinline__ void k5_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void k5_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// n rows of `len` floats from src (row stride len) to dst (row stride ld),
// 16 bytes a copy where vec, else 4.
__device__ __forceinline__ void k5_rows(float* dst, int ld,
                                        const float* src, int n, int len,
                                        bool vec) {
  if (vec) {
    const int l4 = len / 4;
    for (int i = threadIdx.x; i < n * l4; i += K5_THREADS) {
      const int r = i / l4, c = i - r * l4;
      k5_cp16(dst + (size_t)r * ld + 4 * c, src + (size_t)r * len + 4 * c);
    }
  } else {
    for (int i = threadIdx.x; i < n * len; i += K5_THREADS) {
      const int r = i / len, c = i - r * len;
      k5_cp4(dst + (size_t)r * ld + c, src + (size_t)r * len + c);
    }
  }
}

// WIDE: F > K5_FT, the taps past the tensor-core product added one by one.
template <bool WIDE>
__global__ void __launch_bounds__(K5_THREADS, K5_BLOCKS_PER_SM)
    loc_att_kernel(K5Args a) {
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int K = a.K, T = a.T, d = a.d, F = a.F, vdim = a.vdim;
  const int TT = a.TT, KP = a.KP, dP = a.dP;
  const K5Layout L = k5_layout(K, d, F, vdim, a.C, a.ts, TT, dP, a.vP, KP,
                               a.nc);
  float* q_s = sm + L.q;
  uint2* wb_s = reinterpret_cast<uint2*>(sm + L.wb);
  float* v_s = sm + L.v;
  float* part = sm + L.part;
  float* ctx_s = sm + L.part;   // after the energies
  float* e_s = sm + L.e;
  float* p_s = sm + L.p;
  float* m_s = sm + L.stat;     // KP each: m_r, s_r, M, S; then C x KP
                                // each: the peers' m_r (then w), s_r
  float* s_s = m_s + KP;
  float* M_s = s_s + KP;
  float* S_s = M_s + KP;
  float* w_s = S_s + KP;
  float* ps_s = w_s + a.C * KP;
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / a.C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // the frames whose alignment can be non-zero, [0, nw), split evenly:
  // this block's [t0, t1) (tw of them), te of them with an energy
  const int n = loc_valid(a.lens[b], T), nw = loc_weighted(n, T);
  const int ts = (nw + a.C - 1) / a.C;
  const int t0 = min(nw, rank * ts), t1 = min(nw, t0 + ts);
  const int tw = t1 - t0;
  const int te = max(0, min(t1, n) - t0);
  const int nt = (tw + TT - 1) / TT;
  const int ns = 2 * nt;        // energy tiles, then value tiles

  // stage s into buffer s & 1: one commit group each
  auto fetch = [&](int s) {
    float* slot = sm + L.slot + (size_t)(s & 1) * L.slot_size;
    if (s < nt) {
      const int ta = s * TT, tn = min(TT, te - ta);
      if (tn > 0) {
        const int t = t0 + ta;
        k5_rows(slot, a.dP, a.keys + ((size_t)b * T + t) * d, tn, d,
                a.vec_k);
        // fsm: per hypothesis tn F contiguous floats, to k x TT F
        float* fs = slot + (size_t)TT * a.dP;
        const bool v16 = a.vec_f && (size_t)t * F % 4 == 0;
        const int row = tn * F, r4 = v16 ? row / 4 : 0;
        const float* src = a.fsm + ((size_t)b * K * T + t) * F;
        for (int i = tid; i < K * r4; i += K5_THREADS) {
          const int k = i / r4, c = 4 * (i - k * r4);
          k5_cp16(fs + (size_t)k * TT * F + c, src + (size_t)k * T * F + c);
        }
        const int rt = row - 4 * r4;
        for (int i = tid; i < K * rt; i += K5_THREADS) {
          const int k = i / rt, c = 4 * r4 + i - k * rt;
          k5_cp4(fs + (size_t)k * TT * F + c, src + (size_t)k * T * F + c);
        }
      }
    } else {
      const int ta = (s - nt) * TT, tn = min(TT, tw - ta);
      k5_rows(slot, a.vP, a.vals + ((size_t)b * T + t0 + ta) * vdim, tn,
              vdim, a.vec_v);
    }
    k5_commit();
  };
  if (te > 0) {   // q and v join the first tile's commit group
    k5_rows(q_s, dP, a.qb + (size_t)b * K * d, K, d, a.vec_q);
    k5_rows(v_s, d, a.v, 1, d, a.vec_d);
  }
  if (ns > 0) fetch(0);
  if (ns > 1) fetch(1);
  const int nb = a.nc * (K5_CW / 8) * 32;   // (column tile, lane) pairs
  if (te > 0) {   // while the copies land
    // zeros past d in every row the energies read (q, v, and the keys of
    // each buffer that takes keys: a buffer takes values only after its
    // last keys), so that those columns add 0; the copies write none of
    // these floats
    const int pad = dP - d;
    float* const zr[4] = {q_s, v_s, sm + L.slot, sm + L.slot + L.slot_size};
    const int nr[4] = {K, 1, TT, nt > 1 ? TT : 0};
    for (int z = 0; z < 4; ++z)
      for (int i = tid; i < nr[z] * pad; i += K5_THREADS)
        zr[z][(size_t)(i / pad) * dP + d + i % pad] = 0.f;
    // the B fragments of w_f: lane (gr, tg) of column tile n holds column
    // 8 n + gr, taps 2 tg, 2 tg + 1 and 2 tg + 8, 2 tg + 9 (zero past F
    // and d), split
    for (int i = tid; i < nb; i += K5_THREADS) {
      const int cb = (i >> 5) * 8 + ((i & 31) >> 2), c0 = 2 * (i & 3);
      uint32_t h[2], m[2], l[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int c = c0 + 8 * hh;
        const float* w = a.w_f + (size_t)c * d + cb;
        k5_split(c < F && cb < d ? __ldg(w) : 0.f,
                 c + 1 < F && cb < d ? __ldg(w + d) : 0.f, h[hh], m[hh],
                 l[hh]);
      }
      wb_s[i] = make_uint2(h[0], h[1]);
      wb_s[nb + i] = make_uint2(m[0], m[1]);
      wb_s[2 * nb + i] = make_uint2(l[0], l[1]);
    }
  }

  for (int s = 0; s < ns; ++s) {
    if (s + 1 < ns) k5_wait<1>();
    else k5_wait<0>();
    __syncthreads();
    const float* slot = sm + L.slot + (size_t)(s & 1) * L.slot_size;
    if (s < nt) {
      // ---- energies of tile s: frames ta .. ta + tf, tn of them valid
      const int ta = s * TT, tf = min(TT, tw - ta);
      const int tn = max(0, min(tf, te - ta));
      const int np = tn * K, items = (np + 31) / 32 * a.nc;
      const float* ks = slot;                    // keys, TT x dP
      const float* fs = slot + (size_t)TT * dP;  // fsm, K x TT F
      const int gr = lane >> 2, c0 = 2 * (lane & 3);
      for (int it = warp; it < items; it += K5_WARPS) {
        const int gi = it / a.nc, ch = it - gi * a.nc;
        // the lane's pairs: rows gr, gr + 8 (m-tile 0), gr + 16, gr + 24
        // of the item's 32 (past np: copies of the last)
        int qo[4], ko[4], fo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int p = min(gi * 32 + gr + 8 * i, np - 1);
          const int t = p / K, k = p - t * K;
          qo[i] = k * dP;
          ko[i] = t * dP;
          fo[i] = (k * TT + t) * F;
        }
        // A fragments: the pairs' fsm taps c0, c0 + 1, c0 + 8, c0 + 9,
        // each split into three bf16 parts
        uint32_t ah[2][4], am[2][4], al[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int c = c0 + 8 * h, o = fo[2 * m + r] + c;
              k5_split(c < F ? fs[o] : 0.f, c + 1 < F ? fs[o + 1] : 0.f,
                       ah[m][2 * h + r], am[m][2 * h + r], al[m][2 * h + r]);
            }
        float e4[4] = {0.f, 0.f, 0.f, 0.f};
        const int cend = min(d, ch * K5_CW + K5_CW);
        for (int col0 = ch * K5_CW; col0 < cend; col0 += 8) {
          const int bi = (col0 / 8) * 32 + lane;   // B fragment, split
          const uint2 bh = wb_s[bi], bm = wb_s[nb + bi];
          const uint2 bl = wb_s[2 * nb + bi];
          // the lane's elements: columns ce, ce + 1 of its four pairs
          // (zero past d: q, keys, w_f and v are zero-padded)
          const int ce = col0 + c0;
          const float2 v2 = *reinterpret_cast<const float2*>(v_s + ce);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            // arg = (q + key) + f: the accumulators start at q + key, then
            // f = fsm . w_f of 16 pairs x 8 columns takes the six products
            // of the parts that reach f32 accuracy, the largest apart
            float dh[4], dl[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int i = 2 * m + r;
              const float2 q2 =
                  *reinterpret_cast<const float2*>(q_s + qo[i] + ce);
              const float2 k2 =
                  *reinterpret_cast<const float2*>(ks + ko[i] + ce);
              dh[2 * r] = q2.x + k2.x;
              dh[2 * r + 1] = q2.y + k2.y;
            }
            k5_mma(dh, ah[m], bh.x, bh.y);
            k5_mma(dl, ah[m], bm.x, bm.y);
            k5_mma(dl, am[m], bh.x, bh.y);
            k5_mma(dl, ah[m], bl.x, bl.y);
            k5_mma(dl, am[m], bm.x, bm.y);
            k5_mma(dl, al[m], bh.x, bh.y);
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int i = 2 * m + r;
              float x0 = dh[2 * r] + dl[2 * r];
              float x1 = dh[2 * r + 1] + dl[2 * r + 1];
              if (WIDE) {
                for (int c = K5_FT; c < F; ++c) {   // taps past one k-step
                  const float f = fs[fo[i] + c];
                  const float* w = a.w_f + (size_t)c * d + ce;
                  if (ce < d) x0 = fmaf(f, __ldg(w), x0);
                  if (ce + 1 < d) x1 = fmaf(f, __ldg(w + 1), x1);
                }
              }
              e4[i] = fmaf(tanhf(x0), v2.x, e4[i]);
              e4[i] = fmaf(tanhf(x1), v2.y, e4[i]);
            }
          }
        }
        // each pair's sum over the four lanes that share its row
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          e4[i] += __shfl_xor_sync(0xffffffffu, e4[i], 1);
          e4[i] += __shfl_xor_sync(0xffffffffu, e4[i], 2);
          const int p = gi * 32 + gr + 8 * i;
          if ((lane & 3) == 0 && p < np)
            part[(size_t)ch * TT * K + p] = e4[i];
        }
      }
      __syncthreads();
      for (int i = tid; i < tf * K; i += K5_THREADS) {
        const int tl = i / K, k = i - tl * K;
        float e = LOC_NEG_INF;
        if (tl < tn) {
          float sum = 0.f;
          for (int c = 0; c < a.nc; ++c) sum += part[(size_t)c * TT * K + i];
          e = sum * a.inv_tau;
        }
        e_s[(size_t)(ta + tl) * KP + k] = e;
      }
    } else {
      if (s == nt) {
        // ---- this block's softmax partials: m_r, exp(e - m_r), s_r
        for (int k = warp; k < KP; k += K5_WARPS) {
          if (k >= K) {     // padding hypotheses: zero weights
            for (int t = lane; t < tw; t += 32) p_s[(size_t)t * KP + k] = 0.f;
            continue;
          }
          float m = LOC_FLT_LOWEST;
          for (int t = lane; t < tw; t += 32)
            m = fmaxf(m, e_s[(size_t)t * KP + k]);
          m = loc_warp_max(m);
          float sum = 0.f;
          for (int t = lane; t < tw; t += 32) {
            const float pe = expf(e_s[(size_t)t * KP + k] - m);
            p_s[(size_t)t * KP + k] = pe;
            sum += pe;
          }
          sum = loc_warp_sum(sum);
          if (lane == 0) { m_s[k] = m; s_s[k] = sum; }
        }
        __syncthreads();
      }
      // ---- partial context of value tile s - nt
      const int ta = (s - nt) * TT, tf = min(TT, tw - ta);
      // units of one column and K5_KR hypotheses, K5_KR sums each
      const int nu = vdim * (KP / K5_KR);
      for (int u = tid; u < nu; u += K5_THREADS) {
        const int k0 = K5_KR * (u / vdim), j = u - (k0 / K5_KR) * vdim;
        float acc[K5_KR];
#pragma unroll
        for (int i = 0; i < K5_KR; ++i)
          acc[i] = (s == nt || k0 + i >= K)
                       ? 0.f : ctx_s[(size_t)(k0 + i) * vdim + j];
        for (int tl = 0; tl < tf; ++tl) {
          const float val = slot[(size_t)tl * a.vP + j];
          const float4 p4 = *reinterpret_cast<const float4*>(
              p_s + (size_t)(ta + tl) * KP + k0);
          acc[0] = fmaf(p4.x, val, acc[0]);
          acc[1] = fmaf(p4.y, val, acc[1]);
          acc[2] = fmaf(p4.z, val, acc[2]);
          acc[3] = fmaf(p4.w, val, acc[3]);
        }
#pragma unroll
        for (int i = 0; i < K5_KR; ++i)
          if (k0 + i < K) ctx_s[(size_t)(k0 + i) * vdim + j] = acc[i];
      }
    }
    __syncthreads();
    if (s + 2 < ns) fetch(s + 2);
  }
  if (nt == 0) {   // nothing of this utterance in the block's frames
    for (int k = tid; k < K; k += K5_THREADS) {
      m_s[k] = LOC_FLT_LOWEST;
      s_s[k] = 0.f;
    }
    for (int i = tid; i < K * vdim; i += K5_THREADS) ctx_s[i] = 0.f;
  }

  // ---- combine the C blocks' partials through distributed shared memory
  cluster.sync();
  for (int i = tid; i < a.C * K; i += K5_THREADS) {   // one read each
    const int r = i / K, k = i - r * K;
    w_s[r * KP + k] = *cluster.map_shared_rank(m_s + k, r);
    ps_s[r * KP + k] = *cluster.map_shared_rank(s_s + k, r);
  }
  __syncthreads();
  for (int k = tid; k < K; k += K5_THREADS) {
    float M = LOC_FLT_LOWEST;
    for (int r = 0; r < a.C; ++r) M = fmaxf(M, w_s[r * KP + k]);
    float S = 0.f;
    for (int r = 0; r < a.C; ++r) {
      const float w = expf(w_s[r * KP + k] - M);
      w_s[r * KP + k] = w;
      S += ps_s[r * KP + k] * w;
    }
    M_s[k] = M;
    S_s[k] = S;
  }
  __syncthreads();
  const int no = K * vdim, per = (no + a.C - 1) / a.C;
  const int o0 = rank * per, o1 = min(no, o0 + per);
  for (int o = o0 + tid; o < o1; o += K5_THREADS) {
    const int k = o / vdim;
    float pv[K5_MAX_C];   // every peer's read in flight at once
#pragma unroll
    for (int r = 0; r < K5_MAX_C; ++r)
      pv[r] = r < a.C ? *cluster.map_shared_rank(ctx_s + o, r) : 0.f;
    float acc = 0.f;
#pragma unroll
    for (int r = 0; r < K5_MAX_C; ++r)
      if (r < a.C) acc = fmaf(pv[r], w_s[r * KP + k], acc);
    a.ctx[(size_t)b * no + o] = acc / S_s[k];
  }
  for (int i = tid; i < K * tw; i += K5_THREADS) {
    const int k = i / tw, tl = i - k * tw;
    a.align[((size_t)b * K + k) * T + t0 + tl] =
        expf(e_s[(size_t)tl * KP + k] - M_s[k]) / S_s[k];
  }
  // frames at or past the length: exactly 0, split evenly too
  const int zs = (T - nw + a.C - 1) / a.C;
  const int z0 = min(T, nw + rank * zs), nz = min(T, z0 + zs) - z0;
  for (int i = tid; i < K * nz; i += K5_THREADS) {
    const int k = i / nz, tl = i - k * nz;
    a.align[((size_t)b * K + k) * T + z0 + tl] = 0.f;
  }
  cluster.sync();   // the peers may still read this block's partials
}

// ---------------------------------------------------------------- host side

static K5Args k5_args(int K, int T, int d, int F, int vdim, int C, int TT) {
  K5Args a = {};
  a.K = K; a.T = T; a.d = d; a.F = F; a.vdim = vdim; a.C = C;
  a.ts = (T + C - 1) / C;
  a.TT = TT;
  // rows padded to whole chunks of K5_CW plus 8 floats: every chunk's
  // loads stay in the row, and the rows of q (one per hypothesis) fall on
  // other banks
  a.nc = (d + K5_CW - 1) / K5_CW;
  a.dP = a.nc * K5_CW + 8;
  a.vP = (vdim + 3) & ~3;
  a.KP = (K + K5_KR - 1) / K5_KR * K5_KR;
  return a;
}

static size_t k5_bytes(const K5Args& a) {
  return k5_layout(a.K, a.d, a.F, a.vdim, a.C, a.ts, a.TT, a.dP, a.vP, a.KP,
                   a.nc).total * sizeof(float);
}

// The launch's arguments for this shape and C blocks per utterance: the
// fewest tiles of a slice whose buffers let K5_BLOCKS_PER_SM blocks fit an
// SM (else one block alone), each tile a whole number of 32-pair groups
// where 32 / gcd(K, 32) frames allow it (a tile of 13 frames of 8
// hypotheses would leave 19% of its lanes idle). TT = 0: no tile fits.
static K5Args k5_plan(int K, int T, int d, int F, int vdim, int C) {
  const int ts = (T + C - 1) / C;
  const size_t budget = K5_SMEM_PER_SM / K5_BLOCKS_PER_SM - 1024;
  int g = 32, k = K;                 // frames per whole groups of pairs
  while (k % 2 == 0 && g > 1) { k /= 2; g /= 2; }
  K5Args a = {};
  for (int n = 1; n <= ts; ++n) {
    int TT = (ts + n - 1) / n;
    if (TT > g) TT = (TT + g - 1) / g * g;
    if (TT > ts) TT = ts;
    a = k5_args(K, T, d, F, vdim, C, TT);
    if (k5_bytes(a) <= budget) return a;
  }
  a = k5_args(K, T, d, F, vdim, C, 1);
  if (k5_bytes(a) > K5_MAX_SMEM) a.TT = 0;
  return a;
}

// Raises the shared-memory limit of instantiation `wide` (once per size
// and device: the host time of a launch is most of its time in the beam
// loop).
static int k5_prepare(const void* fn, bool wide, size_t smem) {
  static size_t smem_set[2][64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) dev = 63;
  if (smem > smem_set[wide][dev]) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e == cudaSuccess)   // the largest shared-memory carveout
      e = cudaFuncSetAttribute(
          fn, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    if (e != cudaSuccess) return (int)e;
    smem_set[wide][dev] = smem;
  }
  return 0;
}

static cudaLaunchConfig_t k5_config(int B, int C, size_t smem,
                                    cudaLaunchAttribute* attr,
                                    cudaStream_t stream) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * C);
  cfg.blockDim = dim3(K5_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of C blocks (one utterance each) that can be resident at once
// for this shape, into *out (0 where no tile fits or C is out of range).
extern "C" int loc_att_max_clusters(int K, int T, int d, int F, int vdim,
                                    int C, int* out) {
  *out = 0;
  if (K < 1 || T < 1 || d < 1 || F < 1 || vdim < 1 || C < 1 ||
      C > K5_MAX_C)
    return 0;
  const K5Args a = k5_plan(K, T, d, F, vdim, C);
  if (a.TT == 0) return 0;
  const size_t smem = k5_bytes(a);
  const bool wide = F > K5_FT;
  const void* fn = wide ? (const void*)loc_att_kernel<true>
                        : (const void*)loc_att_kernel<false>;
  const int e = k5_prepare(fn, wide, smem);
  if (e != 0) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = k5_config(1, C, smem, attr, 0);
  return (int)cudaOccupancyMaxActiveClusters(out, fn, &cfg);
}

// qb (B,K,d), keys (B,T,d), fsm (B,K,T,F), w_f (F,d), v (d), vals
// (B,T,vdim), lens (B) int32 -> ctx (B,K,vdim), align (B,K,T). One cluster
// of C blocks (1 <= C <= 8) per utterance.
extern "C" int loc_att_launch(const float* qb, const float* keys,
                              const float* fsm, const float* w_f,
                              const float* v, const float* vals,
                              const int* lens, float* ctx, float* align,
                              int B, int K, int T, int d, int F, int vdim,
                              int C, float inv_tau, void* stream) {
  if (B < 1 || K < 1 || T < 1 || d < 1 || F < 1 || vdim < 1 || C < 1 ||
      C > K5_MAX_C)
    return (int)cudaErrorInvalidValue;
  K5Args a = k5_plan(K, T, d, F, vdim, C);
  if (a.TT == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = k5_bytes(a);
  const bool wide = F > K5_FT;
  const void* fn = wide ? (const void*)loc_att_kernel<true>
                        : (const void*)loc_att_kernel<false>;
  int e = k5_prepare(fn, wide, smem);
  if (e != 0) return e;
  a.qb = qb; a.keys = keys; a.fsm = fsm; a.w_f = w_f; a.v = v; a.vals = vals;
  a.lens = lens; a.ctx = ctx; a.align = align; a.inv_tau = inv_tau;
  a.vec_q = d % 4 == 0 && (uintptr_t)qb % 16 == 0;
  a.vec_d = d % 4 == 0 && (uintptr_t)v % 16 == 0;
  a.vec_k = d % 4 == 0 && (uintptr_t)keys % 16 == 0;
  a.vec_v = vdim % 4 == 0 && (uintptr_t)vals % 16 == 0;
  // fsm runs start on 16 bytes where the tile's first frame allows
  a.vec_f = (T * F) % 4 == 0 && (a.TT * F) % 4 == 0 &&
            (uintptr_t)fsm % 16 == 0;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      k5_config(B, C, smem, attr, (cudaStream_t)stream);
  void* args[] = {(void*)&a};
  cudaError_t ce = cudaLaunchKernelExC(&cfg, fn, args);
  if (ce != cudaSuccess) return (int)ce;
  return (int)cudaGetLastError();
}

// The training step of single-head location attention (K7) for Hopper,
// forward and hand-written backward, in f32 and with bf16 inputs (amp
// training).
//
// Replaces end_to_end_asr_pytorch_tpu/ops/pallas/att_train_kernel.py:
// _fwd_call / _fwd_kernel (forward) and _vjp_bwd / _bwd_kernel (backward),
// the custom VJP of loc_att_train (reached from models/attention.py:step
// with attention.use_pallas_train; under --amp with bf16 q, keys, f, v and
// vals). The location conv and its projection stay outside: f =
// conv_features @ w_f arrives as an input.
//
// Forward, per utterance b:
//   th_t = tanh(q + keys_t + f_t),  energy_t = (th_t . v) / tau masked to
//   -1e30 at t >= len,  align = softmax(energy),  ctx = sum_t align_t vals_t.
// Backward, per utterance, recomputing th (nothing of the chain is saved):
//   dal_t   = dalign_t + dctx . vals_t
//   dener_t = align_t * (dal_t - sum_s dal_s align_s) / tau
//   dtarg_t = dener_t * v * (1 - th_t^2)     (= dkeys_t = df_t)
//   dq = sum_t dtarg_t,  dvals_t = align_t * dctx,
//   dv = sum_b sum_t dener_t * th_t          (summed over the whole batch).
//
// Bound on the H100: bytes. The forward must read keys and f (valid
// frames) and vals (weighted frames), ~15 MB at B=32, T=176, d=300 with the
// main path's ragged lengths (~4.5 us); the backward reads them again and
// writes dtarg and dvals (~29 MB: ~8.5 us), against ~20 f32 operations per
// element and one accurate tanhf (no tanh.approx: dtarg's check is 1e-5).
// The first version ran one block per utterance: 32 of 132 SMs at B=32,
// one 128-byte line in flight per warp. What bounds this one is latency:
// each block is a chain of dependent loads and cluster barriers (an
// utterance of one frame still takes ~6 us in the forward, an empty launch
// ~1 us), so the design spreads the frames over as many blocks as fit the
// card at once and keeps each warp's loads of a step in flight together.
//
// Design: one thread block cluster of C blocks per utterance (C <= 16, the
// non-portable size above 8), picked by ops/cuda/att_train_kernel.py:
// pick_clusters from an occupancy query: the fewest waves, then about 1.5
// blocks per SM (C = 6 at B=32, 2 at B=128). The frames whose alignment
// can be non-zero, [0, nw) (all T for a zero-length row), are split into C
// contiguous slices of ceil(nw / C); block `rank` owns one, and a block
// past the end owns none. Rows are read four elements at a time (16 bytes
// in f32; 8 in bf16, whose 600-byte rows are only 8-byte aligned); the
// backward first asks L2 for the keys and f rows it reads after dal (the
// forward gains nothing from asking for its vals rows); widths that are not
// a multiple of 4, or unaligned rows, take the scalar instantiation (V = 1)
// of the same kernels. Sums over the cluster take each warp's partial,
// gathered through distributed shared memory in rank order.
// Forward:
//   1. energies of the block's frames: a warp per frame, K7_FR frames and
//      K7_CJ 32-lane steps of their rows in flight at once (bf16: q + key
//      and + f as packed bf16 adds, which round as the f32 sums do);
//   2. the cluster max M of the energies, p = exp(e - M) and S = sum p in
//      rank order, align = p / S of the block's frames;
//   3. only then the block's partial context, from the final align (bf16:
//      align rounded), threads over (4-column vector, frame group), K7_UF
//      frames in flight; the C partials summed in rank order through
//      distributed shared memory, each rank writing its share of the
//      columns. (K5's one-barrier combine, which rescales each block's
//      partial by exp(m_r - M) / S, would not round align as bf16 does.)
// Backward:
//   1. dal of the block's frames (warps over frames, as the energies) and
//      the cluster's sum of dal . align in rank order; dener of its frames
//      in shared memory;
//   2. dtarg over its frames x d, threads over (4-column vector, frame
//      group), K7_UF frames in flight, tanh recomputed; dq and dv partials
//      per column summed over the frame groups in order, then over the
//      ranks in rank order through distributed shared memory (dq written
//      by the rank that owns the column, this utterance's dv into a (B, d)
//      scratch);
//   3. rank 0 takes a ticket for the cluster (atomicInc on a counter that
//      wraps to 0 by itself, between __threadfence()s; the cluster barrier
//      before it releases every block's scratch writes) while the blocks
//      store dvals and the zero rows of dtarg and dvals past nw, split
//      over the ranks (every output element is written);
//   4. the last cluster to finish sums the scratch over b in a fixed order.
//      No float atomics: every output is bit-identical from call to call.
//
// Each kernel is a template on the input type X and the vector width V.
// X = float is the f32 kernel. X = __nv_bfloat16 reads bf16 q, keys, f, v
// and vals and the f32 align, dctx and dalign, and rounds where the TPU
// kernel does on bf16 inputs (loc_att_common.cuh): ctx and align stay f32;
// dq, dtarg, dvals and dv are written in bf16, each rounded once from its
// f32 value (dq from the f32 sum of the unrounded dtarg, dvals from align *
// dctx in f32, dv from the ordered f32 sum).
#include <cooperative_groups.h>
#include <stdint.h>

#include "loc_att_common.cuh"

namespace cg = cooperative_groups;

#define K7_THREADS 256
#define K7_WARPS (K7_THREADS / 32)
#define K7_FR 2      // frames of one warp in flight (energies, dal)
#define K7_CJ 3      // 32-lane column steps of those rows in flight
#define K7_UF 4      // frames of one thread in flight (context, dtarg)
#define K7_MAX_C 16  // blocks per cluster (the H100's non-portable size)
#define K7_MAX_SMEM 232448

template <class X>
struct K7Args {
  const X *q, *keys, *f, *v, *vals;
  const int* lens;
  const float *align_in, *dctx, *dalign;  // the backward's f32 inputs
  float *ctx, *align;                      // the forward's outputs
  X *dq, *dtarg, *dvals, *dv;              // the backward's outputs
  float* dvb;        // (B, d) scratch: dv of each utterance
  unsigned* ticket;  // clusters of this launch done so far (wraps to 0)
  int* sm_ids;       // null, or (B C): the SM each block ran on
  int T, d, vdim, C;
  int ts;            // ceil(T / C): the most frames a block owns
  float inv_tau;
};

// Offsets (floats) of a block's dynamic shared memory, each on 16 bytes.
struct K7Layout {
  size_t q, v, dc, a, e, red, part, stat, total;
};

__host__ __device__ inline size_t k7_up4(size_t x) {
  return (x + 3) & ~(size_t)3;
}

// Frame groups of a block whose threads run over ncv column vectors.
__host__ __device__ inline int k7_groups(int ncv) {
  return ncv >= K7_THREADS ? 1 : K7_THREADS / ncv;
}

__host__ __device__ inline K7Layout k7_layout(bool bwd, int V, int d,
                                              int vdim, int ts) {
  K7Layout L = {};
  size_t o = 0;
  L.q = o;  o += k7_up4(d);                     // q, widened
  L.v = o;  o += k7_up4(d);                     // v, widened
  if (bwd) {
    L.dc = o;  o += k7_up4(vdim);               // dctx
    L.a = o;   o += k7_up4(ts);                 // align of the frames
  }
  L.e = o;    o += k7_up4(ts);  // forward: energies, then align; bwd: dener
  // per frame group and column: the context partials, or the dq and dv
  // partials (then the last cluster's dv sums)
  const size_t red = bwd ? 2 * (size_t)k7_groups(d / V) * d
                         : (size_t)k7_groups(vdim / V) * vdim;
  L.red = o;  o += k7_up4(red > K7_THREADS ? red : K7_THREADS);
  L.part = o; o += k7_up4(bwd ? 2 * (size_t)d : (size_t)vdim);  // peers read
  // each warp's partial of the two reductions over the cluster (read by
  // the peers), then the cluster's partials of one
  L.stat = o; o += k7_up4(2 * K7_WARPS + K7_WARPS * K7_MAX_C);
  L.total = o;
  return L;
}

// Threads over (column vector c0, frame group fg): lanes threads per group.
struct K7Map {
  int c0, fg, lanes, groups;
};

__device__ __forceinline__ K7Map k7_map(int ncv) {
  K7Map m;
  m.lanes = ncv < K7_THREADS ? ncv : K7_THREADS;
  m.groups = k7_groups(ncv);
  m.c0 = threadIdx.x % m.lanes;
  m.fg = threadIdx.x / m.lanes;
  return m;
}

// V consecutive elements of X as one load: a float4 of f32, a uint2 of
// four bf16 (rows of 4 bf16 are only 8-byte aligned), or one element.
template <class X, int V>
struct K7Vec { typedef X T; };
template <>
struct K7Vec<float, 4> { typedef float4 T; };
template <>
struct K7Vec<__nv_bfloat16, 4> { typedef uint2 T; };

template <class X, int V>
__device__ __forceinline__ typename K7Vec<X, V>::T k7_raw(const X* p) {
  return *reinterpret_cast<const typename K7Vec<X, V>::T*>(p);
}

__device__ __forceinline__ __nv_bfloat162 k7_b2(uint32_t u) {
  return *reinterpret_cast<const __nv_bfloat162*>(&u);
}

// A loaded vector widened to f32 (exact).
__device__ __forceinline__ void k7_wide(float4 r, float (&x)[4]) {
  x[0] = r.x; x[1] = r.y; x[2] = r.z; x[3] = r.w;
}
__device__ __forceinline__ void k7_wide(uint2 r, float (&x)[4]) {
  const float2 lo = __bfloat1622float2(k7_b2(r.x));
  const float2 hi = __bfloat1622float2(k7_b2(r.y));
  x[0] = lo.x; x[1] = lo.y; x[2] = hi.x; x[3] = hi.y;
}
template <class X>
__device__ __forceinline__ void k7_wide(X r, float (&x)[1]) {
  x[0] = loc_ld(r);
}

template <class X, int V>
__device__ __forceinline__ void k7_ld(const X* p, float (&x)[V]) {
  k7_wide(k7_raw<X, V>(p), x);
}

// The tanh arguments q + key + f of V columns from q (widened) and loaded
// keys and f. bf16: q + key, then + f, each rounded to bf16; a packed bf16
// add rounds the exact sum once, which for two bf16 values is the f32 sum
// rounded to bf16.
__device__ __forceinline__ void k7_targ(const float (&q)[4], float4 k,
                                        float4 f, float (&x)[4]) {
  x[0] = q[0] + k.x + f.x;
  x[1] = q[1] + k.y + f.y;
  x[2] = q[2] + k.z + f.z;
  x[3] = q[3] + k.w + f.w;
}
__device__ __forceinline__ void k7_targ(const float (&q)[4], uint2 k,
                                        uint2 f, float (&x)[4]) {
  const __nv_bfloat162 lo = __hadd2(
      __hadd2(__floats2bfloat162_rn(q[0], q[1]), k7_b2(k.x)), k7_b2(f.x));
  const __nv_bfloat162 hi = __hadd2(
      __hadd2(__floats2bfloat162_rn(q[2], q[3]), k7_b2(k.y)), k7_b2(f.y));
  const float2 l = __bfloat1622float2(lo), h = __bfloat1622float2(hi);
  x[0] = l.x; x[1] = l.y; x[2] = h.x; x[3] = h.y;
}
template <class X>
__device__ __forceinline__ void k7_targ(const float (&q)[1], X k, X f,
                                        float (&x)[1]) {
  x[0] = loc_as<X>(loc_as<X>(q[0] + loc_ld(k)) + loc_ld(f));
}

__device__ __forceinline__ void k7_st(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void k7_st(__nv_bfloat16* p, const float (&x)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
  uint2 a;
  a.x = *reinterpret_cast<const uint32_t*>(&lo);
  a.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = a;
}
template <class X>
__device__ __forceinline__ void k7_st(X* p, const float (&x)[1]) {
  loc_st(p, x[0]);
}

// Asks L2 for `bytes` from p, one 128-byte line per request.
__device__ __forceinline__ void k7_prefetch(const void* p, size_t bytes) {
  const char* c = static_cast<const char*>(p);
  for (size_t o = (size_t)threadIdx.x * 128; o < bytes;
       o += (size_t)K7_THREADS * 128)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(c + o));
}

// n elements of zeros from p (n a multiple of V, p on V elements).
template <class X, int V>
__device__ __forceinline__ void k7_zero(X* p, size_t n) {
  float z[V];
#pragma unroll
  for (int k = 0; k < V; ++k) z[k] = 0.f;
  for (size_t i = threadIdx.x; i < n / V; i += K7_THREADS) k7_st(p + i * V, z);
}

// Where sm_ids is given, the SM this block runs on (how far a launch
// spreads over the card).
__device__ __forceinline__ void k7_record_sm(int* sm_ids) {
  if (sm_ids != nullptr && threadIdx.x == 0) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    sm_ids[blockIdx.x] = (int)sm;
  }
}

// The frames block `rank` owns: [t0, t0 + tw) of the nw weighted ones.
struct K7Slice {
  int n, nw, t0, tw;
};

__device__ __forceinline__ K7Slice k7_slice(int len, int T, int C, int rank) {
  K7Slice s;
  s.n = loc_valid(len, T);
  s.nw = loc_weighted(s.n, T);
  const int ts = (s.nw + C - 1) / C;
  s.t0 = min(s.nw, rank * ts);
  s.tw = min(s.nw, s.t0 + ts) - s.t0;
  return s;
}

// A max (IS_MAX) or sum over the cluster of its K7_WARPS x C warp
// partials: lane 0 of each warp puts the warp's partial w into mine[warp]
// (a round's own slots, which the peers read after the cluster barrier);
// then every block gathers the C blocks' partials rank by rank into `all`
// and reduces them in that order.
template <bool IS_MAX>
__device__ __forceinline__ float k7_cluster_reduce(cg::cluster_group& cl,
                                                   float* mine, float* all,
                                                   float w, int C) {
  if ((threadIdx.x & 31) == 0) mine[threadIdx.x >> 5] = w;
  cl.sync();
  if ((int)threadIdx.x < C * K7_WARPS)
    all[threadIdx.x] = *cl.map_shared_rank(mine + threadIdx.x % K7_WARPS,
                                           (int)threadIdx.x / K7_WARPS);
  __syncthreads();
  float r = IS_MAX ? LOC_FLT_LOWEST : 0.f;
  for (int i = 0; i < C * K7_WARPS; ++i)
    r = IS_MAX ? fmaxf(r, all[i]) : r + all[i];
  return r;
}

// Sum of the C blocks' part[j] in rank order (every read in flight).
__device__ __forceinline__ float k7_rank_sum(cg::cluster_group& cl,
                                             float* part, int C) {
  float pv[K7_MAX_C];
#pragma unroll
  for (int r = 0; r < K7_MAX_C; ++r)
    pv[r] = r < C ? *cl.map_shared_rank(part, r) : 0.f;
  float s = 0.f;
#pragma unroll
  for (int r = 0; r < K7_MAX_C; ++r)
    if (r < C) s += pv[r];
  return s;
}

template <class X, int V>
__global__ void __launch_bounds__(K7_THREADS) loc_att_fwd_kernel(
    K7Args<X> a) {
  typedef typename K7Vec<X, V>::T R;
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cl = cg::this_cluster();
  const int T = a.T, d = a.d, vdim = a.vdim, C = a.C;
  const K7Layout L = k7_layout(false, V, d, vdim, a.ts);
  float* q_s = sm + L.q;
  float* v_s = sm + L.v;
  float* e_s = sm + L.e;
  float* red = sm + L.red;
  float* part = sm + L.part;
  float* stat = sm + L.stat;
  const int rank = (int)cl.block_rank(), b = blockIdx.x / C;
  k7_record_sm(a.sm_ids);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = a.lens[b];   // in flight while q and v load
  for (int j = tid; j < d; j += K7_THREADS) {
    q_s[j] = loc_ld(a.q[(size_t)b * d + j]);
    v_s[j] = loc_ld(a.v[j]);
  }
  const K7Slice sl = k7_slice(len, T, C, rank);
  const int t0 = sl.t0, tw = sl.tw;
  const int te = max(0, min(tw, sl.n - t0));   // frames with an energy
  const size_t row0 = (size_t)b * T + t0;
  const X* kb = a.keys + row0 * d;
  const X* fb = a.f + row0 * d;
  const X* vb = a.vals + row0 * vdim;
  __syncthreads();

  // 1. energies: warp w takes frames w, w + K7_WARPS, ..., K7_FR at once,
  // and keeps their max (a zero-length row: every frame at -1e30)
  const int ncv = d / V;
  float m = warp == 0 && te < tw ? LOC_NEG_INF : LOC_FLT_LOWEST;
  for (int t = warp; t < te; t += K7_WARPS * K7_FR) {
    float acc[K7_FR];
#pragma unroll
    for (int i = 0; i < K7_FR; ++i) acc[i] = 0.f;
    for (int c0 = lane; c0 < ncv; c0 += 32 * K7_CJ) {
      R kx[K7_CJ][K7_FR], fx[K7_CJ][K7_FR];
#pragma unroll
      for (int j = 0; j < K7_CJ; ++j)
#pragma unroll
        for (int i = 0; i < K7_FR; ++i) {
          const int c = c0 + 32 * j, ti = t + i * K7_WARPS;
          if (c < ncv && ti < te) {
            kx[j][i] = k7_raw<X, V>(kb + (size_t)ti * d + c * V);
            fx[j][i] = k7_raw<X, V>(fb + (size_t)ti * d + c * V);
          }
        }
#pragma unroll
      for (int j = 0; j < K7_CJ; ++j) {
        const int c = c0 + 32 * j;
        if (c >= ncv) break;
        float qv[V], vv[V];
#pragma unroll
        for (int k = 0; k < V; ++k) {
          qv[k] = q_s[c * V + k];
          vv[k] = v_s[c * V + k];
        }
#pragma unroll
        for (int i = 0; i < K7_FR; ++i)
          if (t + i * K7_WARPS < te) {
            float x[V];
            k7_targ(qv, kx[j][i], fx[j][i], x);
#pragma unroll
            for (int k = 0; k < V; ++k)
              acc[i] = fmaf(tanhf(x[k]), vv[k], acc[i]);
          }
      }
    }
#pragma unroll
    for (int i = 0; i < K7_FR; ++i) {
      const float e = loc_warp_sum(acc[i]) * a.inv_tau;
      const int ti = t + i * K7_WARPS;
      if (ti < te) {
        m = fmaxf(m, e);
        if (lane == 0) e_s[ti] = e;
      }
    }
  }
  for (int t = te + tid; t < tw; t += K7_THREADS) e_s[t] = LOC_NEG_INF;

  // 2. the softmax over the cluster: M, then the sum S in rank order of
  // each block's warp partials
  const float M = k7_cluster_reduce<true>(cl, stat, stat + 2 * K7_WARPS, m, C);
  float s = 0.f;
  for (int t = tid; t < tw; t += K7_THREADS) {
    const float p = expf(e_s[t] - M);
    e_s[t] = p;
    s += p;
  }
  const float S = k7_cluster_reduce<false>(cl, stat + K7_WARPS,
                                           stat + 2 * K7_WARPS,
                                           loc_warp_sum(s), C);
  float* al = a.align + (size_t)b * T;
  for (int t = tid; t < tw; t += K7_THREADS) {
    const float p = e_s[t] / S;
    e_s[t] = p;
    al[t0 + t] = p;
  }
  {  // frames past the weighted ones: align 0, split over the ranks
    const int zs = (T - sl.nw + C - 1) / C;
    const int z0 = min(T, sl.nw + rank * zs), z1 = min(T, z0 + zs);
    for (int t = z0 + tid; t < z1; t += K7_THREADS) al[t] = 0.f;
  }
  __syncthreads();

  // 3. this block's context from the final align of its frames
  const int ncvv = vdim / V;
  const K7Map mv = k7_map(ncvv);
  if (mv.fg < mv.groups) {
    const int step = mv.groups;
    for (int c = mv.c0; c < ncvv; c += mv.lanes) {
      float acc[V];
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = 0.f;
      int t = mv.fg;
      for (; t + (K7_UF - 1) * step < tw; t += K7_UF * step) {
        float x[K7_UF][V];
#pragma unroll
        for (int u = 0; u < K7_UF; ++u)
          k7_ld<X, V>(vb + (size_t)(t + u * step) * vdim + c * V, x[u]);
#pragma unroll
        for (int u = 0; u < K7_UF; ++u) {
          const float w = loc_as<X>(e_s[t + u * step]);
#pragma unroll
          for (int k = 0; k < V; ++k) acc[k] = fmaf(w, x[u][k], acc[k]);
        }
      }
      for (; t < tw; t += step) {
        float x[V];
        k7_ld<X, V>(vb + (size_t)t * vdim + c * V, x);
        const float w = loc_as<X>(e_s[t]);
#pragma unroll
        for (int k = 0; k < V; ++k) acc[k] = fmaf(w, x[k], acc[k]);
      }
#pragma unroll
      for (int k = 0; k < V; ++k) red[(size_t)mv.fg * vdim + c * V + k] = acc[k];
    }
  }
  __syncthreads();
  for (int j = tid; j < vdim; j += K7_THREADS) {
    float p = 0.f;
    for (int g = 0; g < mv.groups; ++g) p += red[(size_t)g * vdim + j];
    part[j] = p;
  }
  cl.sync();
  // 4. rank r writes its share of ctx's columns
  const int per = (vdim + C - 1) / C;
  const int j0 = min(vdim, rank * per), j1 = min(vdim, j0 + per);
  for (int j = j0 + tid; j < j1; j += K7_THREADS)
    a.ctx[(size_t)b * vdim + j] = k7_rank_sum(cl, part + j, C);
  cl.sync();   // the peers may still read this block's partials
}

template <class X, int V>
__global__ void __launch_bounds__(K7_THREADS) loc_att_bwd_kernel(
    K7Args<X> a) {
  typedef typename K7Vec<X, V>::T R;
  extern __shared__ __align__(16) float sm[];
  __shared__ int last;
  cg::cluster_group cl = cg::this_cluster();
  const int T = a.T, d = a.d, vdim = a.vdim, C = a.C;
  const K7Layout L = k7_layout(true, V, d, vdim, a.ts);
  float* q_s = sm + L.q;
  float* v_s = sm + L.v;
  float* dc_s = sm + L.dc;
  float* a_s = sm + L.a;
  float* den_s = sm + L.e;    // dal, then dener
  float* red = sm + L.red;
  float* dqp = sm + L.part;   // this block's dq partial, then its dv one
  float* dvp = dqp + d;
  float* stat = sm + L.stat;
  const int rank = (int)cl.block_rank(), b = blockIdx.x / C;
  k7_record_sm(a.sm_ids);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = a.lens[b];   // in flight while q, v and dctx load
  for (int j = tid; j < d; j += K7_THREADS) {
    q_s[j] = loc_ld(a.q[(size_t)b * d + j]);
    v_s[j] = loc_ld(a.v[j]);
  }
  for (int j = tid; j < vdim; j += K7_THREADS)
    dc_s[j] = a.dctx[(size_t)b * vdim + j];
  const K7Slice sl = k7_slice(len, T, C, rank);
  const int t0 = sl.t0, tw = sl.tw;
  const size_t row0 = (size_t)b * T + t0;
  const X* kb = a.keys + row0 * d;
  const X* fb = a.f + row0 * d;
  const X* vb = a.vals + row0 * vdim;
  k7_prefetch(kb, (size_t)tw * d * sizeof(X));
  k7_prefetch(fb, (size_t)tw * d * sizeof(X));
  for (int t = tid; t < tw; t += K7_THREADS)
    a_s[t] = a.align_in[row0 + t];
  __syncthreads();

  // 1. dal = dalign + dctx . vals (bf16: dctx rounded), warps over frames,
  // each warp also summing dal . align over its frames
  const int ncvv = vdim / V;
  float p = 0.f;
  for (int t = warp; t < tw; t += K7_WARPS * K7_FR) {
    float acc[K7_FR];
#pragma unroll
    for (int i = 0; i < K7_FR; ++i) acc[i] = 0.f;
    for (int c0 = lane; c0 < ncvv; c0 += 32 * K7_CJ) {
      R x[K7_CJ][K7_FR];
#pragma unroll
      for (int j = 0; j < K7_CJ; ++j)
#pragma unroll
        for (int i = 0; i < K7_FR; ++i) {
          const int c = c0 + 32 * j, ti = t + i * K7_WARPS;
          if (c < ncvv && ti < tw)
            x[j][i] = k7_raw<X, V>(vb + (size_t)ti * vdim + c * V);
        }
#pragma unroll
      for (int j = 0; j < K7_CJ; ++j) {
        const int c = c0 + 32 * j;
        if (c >= ncvv) break;
        float dc[V];
#pragma unroll
        for (int k = 0; k < V; ++k) dc[k] = loc_as<X>(dc_s[c * V + k]);
#pragma unroll
        for (int i = 0; i < K7_FR; ++i)
          if (t + i * K7_WARPS < tw) {
            float w[V];
            k7_wide(x[j][i], w);
#pragma unroll
            for (int k = 0; k < V; ++k) acc[i] = fmaf(dc[k], w[k], acc[i]);
          }
      }
    }
#pragma unroll
    for (int i = 0; i < K7_FR; ++i) {
      const int ti = t + i * K7_WARPS;
      if (ti < tw) {
        const float dal = a.dalign[row0 + ti] + loc_warp_sum(acc[i]);
        p = fmaf(dal, a_s[ti], p);
        if (lane == 0) den_s[ti] = dal;
      }
    }
  }
  const float s = k7_cluster_reduce<false>(cl, stat, stat + 2 * K7_WARPS, p,
                                           C);
  for (int t = tid; t < tw; t += K7_THREADS)
    den_s[t] = a_s[t] * (den_s[t] - s) * a.inv_tau;
  __syncthreads();

  // 2. dtarg over the frames x d (tanh recomputed), dq and dv partials
  const int ncv = d / V;
  const K7Map md = k7_map(ncv);
  X* gb = a.dtarg + row0 * d;
  float* red_v = red + (size_t)md.groups * d;
  if (md.fg < md.groups) {
    const int step = md.groups;
    for (int c = md.c0; c < ncv; c += md.lanes) {
      float qv[V], vv[V], aq[V], av[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        qv[k] = q_s[c * V + k];
        vv[k] = v_s[c * V + k];
        aq[k] = av[k] = 0.f;
      }
      // frame t's dtarg row, dq and dv terms (bf16: dv's dener rounded)
      auto frame = [&](int t, R kx, R fx) {
        const float den = den_s[t], den_r = loc_as<X>(den);
        float x[V], g[V];
        k7_targ(qv, kx, fx, x);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float th = tanhf(x[k]);
          g[k] = den * vv[k] * (1.f - th * th);
          aq[k] += g[k];
          av[k] = fmaf(den_r, th, av[k]);
        }
        k7_st(gb + (size_t)t * d + c * V, g);
      };
      int t = md.fg;
      for (; t + (K7_UF - 1) * step < tw; t += K7_UF * step) {
        R kx[K7_UF], fx[K7_UF];
#pragma unroll
        for (int u = 0; u < K7_UF; ++u) {
          kx[u] = k7_raw<X, V>(kb + (size_t)(t + u * step) * d + c * V);
          fx[u] = k7_raw<X, V>(fb + (size_t)(t + u * step) * d + c * V);
        }
#pragma unroll
        for (int u = 0; u < K7_UF; ++u) frame(t + u * step, kx[u], fx[u]);
      }
      for (; t < tw; t += step)
        frame(t, k7_raw<X, V>(kb + (size_t)t * d + c * V),
              k7_raw<X, V>(fb + (size_t)t * d + c * V));
#pragma unroll
      for (int k = 0; k < V; ++k) {
        red[(size_t)md.fg * d + c * V + k] = aq[k];
        red_v[(size_t)md.fg * d + c * V + k] = av[k];
      }
    }
  }

  __syncthreads();
  for (int j = tid; j < d; j += K7_THREADS) {
    float pq = 0.f, pv = 0.f;
    for (int g = 0; g < md.groups; ++g) {
      pq += red[(size_t)g * d + j];
      pv += red_v[(size_t)g * d + j];
    }
    dqp[j] = pq;
    dvp[j] = pv;
  }
  cl.sync();

  // 4. rank r's share of the columns: dq, and this utterance's dv
  const int per = (d + C - 1) / C;
  const int j0 = min(d, rank * per), j1 = min(d, j0 + per);
  for (int j = j0 + tid; j < j1; j += K7_THREADS) {
    loc_st(a.dq + (size_t)b * d + j, k7_rank_sum(cl, dqp + j, C));
    a.dvb[(size_t)b * d + j] = k7_rank_sum(cl, dvp + j, C);
  }
  // the cluster's shares written (the barrier releases them to rank 0's
  // fence) and no peer reads this block's partials any more: rank 0 takes
  // the cluster's ticket while the others store dvals
  cl.sync();
  if (rank == 0 && tid == 0) {
    const unsigned nc = gridDim.x / C;
    __threadfence();
    const int done = atomicInc(a.ticket, nc - 1) == nc - 1;
    __threadfence();
    for (int r = 0; r < C; ++r) *cl.map_shared_rank(&last, r) = done;
  }

  // 5. dvals = align dctx over the frames x vdim, then the zero rows past
  // the weighted frames, split over the ranks
  const K7Map mv = k7_map(ncvv);
  X* hb = a.dvals + row0 * vdim;
  if (mv.fg < mv.groups)
    for (int c = mv.c0; c < ncvv; c += mv.lanes) {
      float dc[V];
#pragma unroll
      for (int k = 0; k < V; ++k) dc[k] = dc_s[c * V + k];
      for (int t = mv.fg; t < tw; t += mv.groups) {
        float o[V];
        const float w = a_s[t];
#pragma unroll
        for (int k = 0; k < V; ++k) o[k] = w * dc[k];
        k7_st(hb + (size_t)t * vdim + c * V, o);
      }
    }
  {
    const int zs = (T - sl.nw + C - 1) / C;
    const int z0 = min(T, sl.nw + rank * zs), nz = min(T, z0 + zs) - z0;
    k7_zero<X, V>(a.dtarg + ((size_t)b * T + z0) * d, (size_t)nz * d);
    k7_zero<X, V>(a.dvals + ((size_t)b * T + z0) * vdim, (size_t)nz * vdim);
  }
  cl.sync();
  if (!last) return;

  // 6. the last cluster: dv = sum over b of the scratch, rank r its share
  // of the columns, each in groups of b summed in order, then the groups
  const int B = gridDim.x / C, np = j1 - j0;
  if (np >= K7_THREADS) {
    for (int j = j0 + tid; j < j1; j += K7_THREADS) {
      float acc = 0.f;
#pragma unroll 8
      for (int bb = 0; bb < B; ++bb) acc += __ldcg(a.dvb + (size_t)bb * d + j);
      loc_st(a.dv + j, acc);
    }
  } else if (np > 0) {
    const int G = K7_THREADS / np, bs = (B + G - 1) / G;
    const int jl = tid % np, g = tid / np;
    if (g < G) {
      const int b0 = min(B, g * bs), b1 = min(B, b0 + bs);
      float acc = 0.f;
#pragma unroll 8
      for (int bb = b0; bb < b1; ++bb)
        acc += __ldcg(a.dvb + (size_t)bb * d + j0 + jl);
      red[(size_t)g * np + jl] = acc;
    }
    __syncthreads();
    if (tid < np) {
      float acc = 0.f;
      for (int gg = 0; gg < G; ++gg) acc += red[(size_t)gg * np + tid];
      loc_st(a.dv + j0 + tid, acc);
    }
  }
}

// ---------------------------------------------------------------- host side

// kind: bit 0 the backward, bit 1 bf16 inputs, bit 2 the scalar variant
static const void* k7_kernel(int kind) {
  typedef __nv_bfloat16 H;
  switch (kind) {
    case 0: return (const void*)loc_att_fwd_kernel<float, 4>;
    case 1: return (const void*)loc_att_bwd_kernel<float, 4>;
    case 2: return (const void*)loc_att_fwd_kernel<H, 4>;
    case 3: return (const void*)loc_att_bwd_kernel<H, 4>;
    case 4: return (const void*)loc_att_fwd_kernel<float, 1>;
    case 5: return (const void*)loc_att_bwd_kernel<float, 1>;
    case 6: return (const void*)loc_att_fwd_kernel<H, 1>;
    case 7: return (const void*)loc_att_bwd_kernel<H, 1>;
  }
  return nullptr;
}

static size_t k7_smem(int kind, int T, int d, int vdim, int C) {
  const int ts = (T + C - 1) / C;
  return k7_layout(kind & 1, kind & 4 ? 1 : 4, d, vdim, ts).total *
         sizeof(float);
}

// 0 where the shape and variant are valid, else an error.
static int k7_valid(int kind, int B, int T, int d, int vdim, int C) {
  if (kind < 0 || kind > 7 || B < 1 || T < 1 || d < 1 || vdim < 1 ||
      C < 1 || C > K7_MAX_C)
    return (int)cudaErrorInvalidValue;
  if (!(kind & 4) && (d % 4 != 0 || vdim % 4 != 0))
    return (int)cudaErrorInvalidValue;
  if (k7_smem(kind, T, d, vdim, C) > K7_MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// Raises the kernel's shared-memory limit and allows clusters of more than
// 8 blocks, once per size and device (the step calls K7 96 times per
// training step).
static int k7_prepare(int kind, size_t smem, int C) {
  static size_t smem_set[8][64] = {};
  static bool wide_set[8][64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) dev = 63;
  const void* fn = k7_kernel(kind);
  if (smem > smem_set[kind][dev]) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set[kind][dev] = smem;
  }
  if (C > 8 && !wide_set[kind][dev]) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
    if (e != cudaSuccess) return (int)e;
    wide_set[kind][dev] = true;
  }
  return 0;
}

static cudaLaunchConfig_t k7_config(int B, int C, size_t smem,
                                    cudaLaunchAttribute* attr,
                                    cudaStream_t stream) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * C);
  cfg.blockDim = dim3(K7_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of C blocks (one utterance each) of kernel `kind` that can be
// resident at once for this shape, into *out (0 where it does not fit).
extern "C" int loc_att_train_max_clusters(int kind, int T, int d, int vdim,
                                          int C, int* out) {
  *out = 0;
  if (k7_valid(kind, 1, T, d, vdim, C) != 0) return 0;
  const size_t smem = k7_smem(kind, T, d, vdim, C);
  const int e = k7_prepare(kind, smem, C);
  if (e != 0) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = k7_config(1, C, smem, attr, 0);
  return (int)cudaOccupancyMaxActiveClusters(out, k7_kernel(kind), &cfg);
}

template <class X>
static int k7_launch(int kind, K7Args<X>& a, int B, void* stream) {
  int e = k7_valid(kind, B, a.T, a.d, a.vdim, a.C);
  if (e != 0) return e;
  if (!(kind & 4)) {   // 4-element vectors: every row on 4 elements
    const uintptr_t al = 4 * sizeof(X);
    const void* ptrs[] = {a.q, a.keys, a.f, a.v, a.vals, a.dq, a.dtarg,
                          a.dvals};
    for (const void* p : ptrs)
      if ((uintptr_t)p % al != 0) return (int)cudaErrorInvalidValue;
  }
  const size_t smem = k7_smem(kind, a.T, a.d, a.vdim, a.C);
  e = k7_prepare(kind, smem, a.C);
  if (e != 0) return e;
  a.ts = (a.T + a.C - 1) / a.C;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      k7_config(B, a.C, smem, attr, (cudaStream_t)stream);
  void* args[] = {(void*)&a};
  const cudaError_t ce = cudaLaunchKernelExC(&cfg, k7_kernel(kind), args);
  if (ce != cudaSuccess) return (int)ce;
  return (int)cudaGetLastError();
}

// q (B,d), keys / f (B,T,d), v (d), vals (B,T,vdim) of type X, lens (B)
// int32 -> ctx (B,vdim), align (B,T) in f32. C blocks per utterance; vec:
// the 4-element kernel (d and vdim multiples of 4, rows aligned), else the
// scalar one; sm_ids null, or B*C ints for the SM of each block.
template <class X>
static int fwd_launch(const X* q, const X* keys, const X* f, const X* v,
                      const X* vals, const int* lens, float* ctx,
                      float* align, int* sm_ids, int B, int T, int d,
                      int vdim, int C, int vec, float inv_tau,
                      void* stream) {
  K7Args<X> a = {};
  a.q = q; a.keys = keys; a.f = f; a.v = v; a.vals = vals; a.lens = lens;
  a.ctx = ctx; a.align = align; a.sm_ids = sm_ids;
  a.T = T; a.d = d; a.vdim = vdim; a.C = C; a.inv_tau = inv_tau;
  const int kind = (sizeof(X) == 2 ? 2 : 0) | (vec ? 0 : 4);
  return k7_launch(kind, a, B, stream);
}

// The forward's inputs and align (B,T), dctx (B,vdim), dalign (B,T) in f32
// -> dq (B,d), dtarg (B,T,d), dvals (B,T,vdim), dv (d) of type X. dvb is
// B*d floats of scratch; ticket one unsigned int, 0 before the first launch
// on its stream (each launch leaves it at 0); sm_ids as the forward's.
template <class X>
static int bwd_launch(const X* q, const X* keys, const X* f, const X* v,
                      const X* vals, const int* lens, const float* align,
                      const float* dctx, const float* dalign, X* dq,
                      X* dtarg, X* dvals, X* dv, float* dvb,
                      unsigned* ticket, int* sm_ids, int B, int T, int d,
                      int vdim, int C, int vec, float inv_tau,
                      void* stream) {
  K7Args<X> a = {};
  a.q = q; a.keys = keys; a.f = f; a.v = v; a.vals = vals; a.lens = lens;
  a.align_in = align; a.dctx = dctx; a.dalign = dalign;
  a.dq = dq; a.dtarg = dtarg; a.dvals = dvals; a.dv = dv;
  a.dvb = dvb; a.ticket = ticket; a.sm_ids = sm_ids;
  a.T = T; a.d = d; a.vdim = vdim; a.C = C; a.inv_tau = inv_tau;
  const int kind = 1 | (sizeof(X) == 2 ? 2 : 0) | (vec ? 0 : 4);
  return k7_launch(kind, a, B, stream);
}

extern "C" int loc_att_fwd_launch(const float* q, const float* keys,
                                  const float* f, const float* v,
                                  const float* vals, const int* lens,
                                  float* ctx, float* align, int* sm_ids,
                                  int B, int T, int d, int vdim, int C,
                                  int vec, float inv_tau, void* stream) {
  return fwd_launch(q, keys, f, v, vals, lens, ctx, align, sm_ids, B, T, d,
                    vdim, C, vec, inv_tau, stream);
}

extern "C" int loc_att_fwd_bf16_launch(
    const __nv_bfloat16* q, const __nv_bfloat16* keys,
    const __nv_bfloat16* f, const __nv_bfloat16* v,
    const __nv_bfloat16* vals, const int* lens, float* ctx, float* align,
    int* sm_ids, int B, int T, int d, int vdim, int C, int vec,
    float inv_tau, void* stream) {
  return fwd_launch(q, keys, f, v, vals, lens, ctx, align, sm_ids, B, T, d,
                    vdim, C, vec, inv_tau, stream);
}

extern "C" int loc_att_bwd_launch(
    const float* q, const float* keys, const float* f, const float* v,
    const float* vals, const int* lens, const float* align,
    const float* dctx, const float* dalign, float* dq, float* dtarg,
    float* dvals, float* dv, float* dvb, unsigned* ticket, int* sm_ids,
    int B, int T, int d, int vdim, int C, int vec, float inv_tau,
    void* stream) {
  return bwd_launch(q, keys, f, v, vals, lens, align, dctx, dalign, dq,
                    dtarg, dvals, dv, dvb, ticket, sm_ids, B, T, d, vdim, C,
                    vec, inv_tau, stream);
}

extern "C" int loc_att_bwd_bf16_launch(
    const __nv_bfloat16* q, const __nv_bfloat16* keys,
    const __nv_bfloat16* f, const __nv_bfloat16* v,
    const __nv_bfloat16* vals, const int* lens, const float* align,
    const float* dctx, const float* dalign, __nv_bfloat16* dq,
    __nv_bfloat16* dtarg, __nv_bfloat16* dvals, __nv_bfloat16* dv,
    float* dvb, unsigned* ticket, int* sm_ids, int B, int T, int d,
    int vdim, int C, int vec, float inv_tau, void* stream) {
  return bwd_launch(q, keys, f, v, vals, lens, align, dctx, dalign, dq,
                    dtarg, dvals, dv, dvb, ticket, sm_ids, B, T, d, vdim, C,
                    vec, inv_tau, stream);
}

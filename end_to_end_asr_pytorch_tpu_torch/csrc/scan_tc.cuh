// The tensor-core time scan shared by K2 and K4 (lstm_scan.cu, gru_scan.cu:
// f32, with optional training residuals, and their bf16 decode variants
// K2-bf16 and K4-bf16): the split of the f32 carry, the fragment loads, the
// step exchange and the launch. Each kernel keeps only its gate epilogue (a
// Cell: the element type X of x_proj and ys, f32 or bf16; NG gates; NS
// floats of state per unit and row; and step()).
//
// Per (layer, direction) and per group of 8 or 16 batch rows (picked by
// ops/cuda/scan_tc.py), C blocks walk all T steps together: one thread
// block cluster (TC_CLUSTER, C <= 16; the card runs clusters in waves where
// they do not all fit), or C blocks of one cooperative grid that holds as
// many groups as can be resident (TC_GRID; the only mode for a width whose
// W_hh needs more than 16 blocks; further groups take further launches). Block `rank` owns U = H / C hidden units, i.e. GC = NG * U gate
// columns, padded with zero columns to MT m-tiles of 16. Its step product is
// computed transposed, gates^T (GC x rows) = W_slice^T (GC x H) . h^T
// (H x rows), with mma.sync m16n8k16 (bf16 operands, f32 accumulators);
// H is padded with zeros to kg groups of kw k-steps of 16. Warp (mi, kgi)
// owns the 16 gate columns of m-tile mi and k-steps kgi*kw ..
// kgi*kw+kw-1, and holds their W fragments in registers for the whole
// scan.
//
// Exact to f32 arithmetic: each step the f32 carry h is split into three
// bf16 parts, hi = bf16(h), mid = bf16(h - hi), lo = bf16(h - hi - mid), whose
// sum is h; the products of bf16 values are exact in f32 and are summed in
// f32 (hi in one accumulator, mid + lo in another). W is split as it is
// loaded, w = w_hi + w_mid + w_lo; a block whose remainder is zero (W_hh
// rounded to bf16, decode amp's main path) runs the three w_hi passes only;
// otherwise (K2 and K4 in f32: training and f32-decode W_hh is not
// bf16-valued) it adds (hi + mid) . w_mid + hi . w_lo, whose fragments it
// keeps in a global scratch in fragment order (read back from L2 each
// step).
//
// Step exchange: each block writes its U units of the new h (f32, rows x U)
// to its own double-buffered slot; after one barrier every block copies all
// C slots, splitting them into the three bf16 planes (rows x (Hk + 8)
// each, padded rows for conflict-free ldmatrix). TC_CLUSTER keeps the slots in
// shared memory and reads its peers' through distributed shared memory
// (map_shared_rank) after barrier.cluster; TC_GRID keeps them in a global
// buffer read through L2 (__ldcg) after grid.sync() of a cooperative launch.
// The next step's x_proj rows and mask go to shared memory with cp.async
// while the barrier and the product of the current step run.
#pragma once
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define TC_KW 16           // at most 16 k-steps (256 of H) per warp
#define TC_MAX_THREADS 512 // at most 16 warps per block
#define TC_MAX_ROWS 16     // batch rows per group
#define TC_MAX_CLUSTER 16  // blocks per cluster (non-portable size)

enum { TC_CLUSTER = 0, TC_GRID = 1 };

struct TcArgs {
  const void* xp;           // (T, B, NG*H) of the Cell's X
  const float* whh;         // (H, NG*H)
  const float* mask;        // (T, B), 1 / 0
  void* ys;                 // (T, B, H) of the Cell's X
  uint4* wrem;              // C * warps * kw * 32 * 2 uint4: w_mid, w_lo frags
  float* hbuf;              // TC_GRID: (groups, 2, rows, H) exchange slots
  int T, B, H, U, C, kw, kg, rows, g0, reverse;  // g0: first group
  int Hk;  // H zero-padded to the k-groups (tc_kext; set by the launch)
};

// Byte offsets of one block's dynamic shared memory.
struct TcLayout {
  size_t s, p, own, st, xs, ms, total;
};

__host__ __device__ inline size_t tc_align(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// H zero-padded to the kg groups of kw k-steps of 16 (at least to whole
// k-steps). The planes of h are Hk + 8 wide (8 against bank conflicts).
// Where neither H nor the gate columns need padding (H=512, 320, 1024,
// ...) the kernel is compiled without it (PAD false): the padded widths
// live in the step loop made ptxas spill 80-112 bytes there.
__host__ __device__ inline int tc_kext(int H, int kw, int kg) {
  const int ks = (H + 15) / 16;
  return 16 * (kw * kg > ks ? kw * kg : ks);
}

// Gate columns of a block padded to whole m-tiles of 16.
__host__ __device__ inline int tc_cols(int NG, int U) {
  return (NG * U + 15) / 16 * 16;
}

// xbytes: bytes of one x_proj element (2 for bf16, 4 for f32).
__host__ __device__ inline TcLayout tc_layout(int Hk, int U, int NG, int NS,
                                              int rows, int kg, int mode,
                                              int xbytes = 2) {
  TcLayout L;
  size_t o = 0;
  const int GC = NG * U, SR = Hk + 8;
  L.s = o;    // three bf16 planes of h, rows x SR
  o = tc_align(o + (size_t)3 * rows * SR * 2);
  L.p = o;    // kg partial products, tc_cols x (rows + 1) f32
  o = tc_align(o + (size_t)kg * tc_cols(NG, U) * (rows + 1) * 4);
  L.own = o;  // TC_CLUSTER: two slots of this block's h, rows x U f32
  if (mode == TC_CLUSTER) o = tc_align(o + (size_t)2 * rows * U * 4);
  L.st = o;   // the cell's state, NS x rows x U f32
  o = tc_align(o + (size_t)NS * rows * U * 4);
  L.xs = o;   // two buffers of x_proj rows, rows x GC elements
  o = tc_align(o + (size_t)2 * rows * GC * xbytes);
  L.ms = o;   // two buffers of mask rows
  o = tc_align(o + (size_t)2 * rows * 4);
  L.total = o;
  return L;
}

__device__ __forceinline__ uint32_t tc_pack(__nv_bfloat16 lo,
                                            __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// v = hi + mid + lo exactly (for |v| in bf16's normal range).
__device__ __forceinline__ void tc_split3(float v, __nv_bfloat16& hi,
                                          __nv_bfloat16& mid,
                                          __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(v);
  const float r = v - __bfloat162float(hi);
  mid = __float2bfloat16_rn(r);
  lo = __float2bfloat16_rn(r - __bfloat162float(mid));
}

__device__ __forceinline__ void tc_mma(float* d, const uint32_t* a,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void tc_ldsm4(uint32_t* r, const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void tc_ldsm2(uint32_t* r, const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

__device__ __forceinline__ void tc_cp16(void* dst, const void* src) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
               "l"(src));
}
__device__ __forceinline__ void tc_cp8(void* dst, const void* src) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(a),
               "l"(src));
}
__device__ __forceinline__ void tc_cp4(void* dst, const void* src) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a),
               "l"(src));
}
__device__ __forceinline__ float tc_f32(float v) { return v; }
__device__ __forceinline__ float tc_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void tc_store(float* p, float v) { *p = v; }
__device__ __forceinline__ void tc_store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void tc_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void tc_cp_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void tc_cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void tc_cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// This block's exchange slot `buf` (rows x ostride f32, its units first);
// `group` counts the launch's groups from 0.
template <int MODE>
__device__ __forceinline__ float* tc_slot(const TcArgs& a, float* own_s,
                                          int group, int rank, int buf) {
  if (MODE == TC_CLUSTER) return own_s + (size_t)buf * a.rows * a.U;
  return a.hbuf + ((size_t)(group * 2 + buf) * a.rows) * a.H + rank * a.U;
}

// Copies slot `buf` of every block of the group into the three bf16 planes
// of S (rows x SR each), splitting each f32 value.
template <int MODE>
__device__ __forceinline__ void tc_fetch(const TcArgs& a, float* own_s,
                                         __nv_bfloat16* S, int SR, int group,
                                         int buf) {
  const int U4 = a.U / 4, H4 = a.H / 4;
  const size_t plane = (size_t)a.rows * SR;
  const int n = a.rows * H4;
  // FB loads in flight per thread before any is split and stored
  constexpr int FB = 2;
  for (int i0 = threadIdx.x; i0 < n; i0 += FB * blockDim.x) {
    float4 v[FB];
#pragma unroll
    for (int f = 0; f < FB; ++f) {
      const int i = i0 + f * blockDim.x;
      if (i >= n) break;
      const int r = i / H4, k4 = i - r * H4;
      const int q = k4 / U4, j = k4 - q * U4;
      if (MODE == TC_CLUSTER) {
        float* src = cg::this_cluster().map_shared_rank(
            own_s + (size_t)buf * a.rows * a.U, q);
        v[f] = *reinterpret_cast<const float4*>(src + r * a.U + 4 * j);
      } else {
        v[f] = __ldcg(reinterpret_cast<const float4*>(
            tc_slot<MODE>(a, own_s, group, q, buf) + (size_t)r * a.H +
            4 * j));
      }
    }
#pragma unroll
    for (int f = 0; f < FB; ++f) {
      const int i = i0 + f * blockDim.x;
      if (i >= n) break;
      const int r = i / H4, k4 = i - r * H4;
      __nv_bfloat16 h[4], m[4], l[4];
      tc_split3(v[f].x, h[0], m[0], l[0]);
      tc_split3(v[f].y, h[1], m[1], l[1]);
      tc_split3(v[f].z, h[2], m[2], l[2]);
      tc_split3(v[f].w, h[3], m[3], l[3]);
      __nv_bfloat16* d = S + (size_t)r * SR + 4 * k4;
      *reinterpret_cast<uint2*>(d) =
          make_uint2(tc_pack(h[0], h[1]), tc_pack(h[2], h[3]));
      *reinterpret_cast<uint2*>(d + plane) =
          make_uint2(tc_pack(m[0], m[1]), tc_pack(m[2], m[3]));
      *reinterpret_cast<uint2*>(d + 2 * plane) =
          make_uint2(tc_pack(l[0], l[1]), tc_pack(l[2], l[3]));
    }
  }
}

// W[k][column] of column pointer w (nullptr: a padding column), 0 past H.
__device__ __forceinline__ float tc_w(const float* w, int k, int H, int G) {
  return w != nullptr && k < H ? w[(size_t)k * G] : 0.f;
}

// The 8 W values of one lane's A fragment at k-step row k (its k, k+1,
// k+8, k+9 of columns wa and wb = wa's column + 8), in register order.
__device__ __forceinline__ void tc_wfrag(const float* wa, const float* wb,
                                         int k, int H, int G, float* v) {
  v[0] = tc_w(wa, k, H, G);     v[1] = tc_w(wa, k + 1, H, G);
  v[2] = tc_w(wb, k, H, G);     v[3] = tc_w(wb, k + 1, H, G);
  v[4] = tc_w(wa, k + 8, H, G); v[5] = tc_w(wa, k + 9, H, G);
  v[6] = tc_w(wb, k + 8, H, G); v[7] = tc_w(wb, k + 9, H, G);
}

// cp.async of step t's x_proj rows (this block's GC columns) and mask rows
// into one buffer; one commit group. U is a multiple of 4: f32 rows take
// 16-byte copies, bf16 rows 8-byte ones, or 16 where U is a multiple of 8.
template <int NG, class X>
__device__ __forceinline__ void tc_prefetch(const TcArgs& a, X* xs,
                                            float* ms, int t, int b0, int nb,
                                            int u0) {
  constexpr int E = sizeof(X);
  const int GC = NG * a.U, G = NG * a.H;
  // elements per copy: 16 bytes, or 8 where U is not a multiple of 16 bytes
  const int vec = a.U % (16 / E) == 0 ? 16 / E : 8 / E;
  const int nv = a.U / vec;
  const int n = nb * NG * nv;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / (NG * nv), rem = i - r * NG * nv;
    const int g = rem / nv, j = rem - g * nv;
    const X* src = (const X*)a.xp + ((size_t)t * a.B + b0 + r) * G +
                   g * a.H + u0 + j * vec;
    X* dst = xs + r * GC + g * a.U + j * vec;
    if (vec * E == 16) tc_cp16(dst, src);
    else tc_cp8(dst, src);
  }
  for (int r = threadIdx.x; r < nb; r += blockDim.x)
    tc_cp4(ms + r, a.mask + (size_t)t * a.B + b0 + r);
  tc_cp_commit();
}

// The scan. NTILE n-tiles of 8 rows (rows = 8 NTILE); blockDim = 32 * MT * kg
// with MT = tc_cols / 16. Grid: C blocks per group of `rows` batch rows,
// groups g0, g0 + 1, ... of the batch. PAD: Hk > H or tc_cols > NG U.
template <class Cell, int MODE, int NTILE, bool PAD>
__global__ void __launch_bounds__(TC_MAX_THREADS, 1)
    tc_scan_kernel(TcArgs a, Cell cell) {
  constexpr int NG = Cell::NG;
  using X = typename Cell::X;
  const int U = a.U, H = a.H, GC = NG * U;
  const int PC = PAD ? tc_cols(NG, U) : GC, MT = PC / 16;
  const int rank = blockIdx.x % a.C, group = blockIdx.x / a.C;
  const int u0 = rank * U, b0 = (a.g0 + group) * a.rows;
  const int nb = min(a.rows, a.B - b0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mi = warp % MT, kgi = warp / MT;
  const int SR = (PAD ? a.Hk : H) + 8, RS = a.rows + 1;
  const size_t plane = (size_t)a.rows * SR;

  extern __shared__ __align__(16) unsigned char tc_smem[];
  const TcLayout L = tc_layout(PAD ? a.Hk : H, U, NG, Cell::NS, a.rows, a.kg,
                               MODE, sizeof(X));
  __nv_bfloat16* S = (__nv_bfloat16*)(tc_smem + L.s);
  float* P = (float*)(tc_smem + L.p);
  float* own_s = (float*)(tc_smem + L.own);
  float* st = (float*)(tc_smem + L.st);
  X* xs = (X*)(tc_smem + L.xs);
  float* ms = (float*)(tc_smem + L.ms);

  // zero both slots (slot 0 is the initial h; rows past the batch stay 0)
  // and the state
  {
    const int ostride = MODE == TC_CLUSTER ? U : H;
    for (int b = 0; b < 2; ++b) {
      float* h0 = tc_slot<MODE>(a, own_s, group, rank, b);
      for (int i = threadIdx.x; i < a.rows * U; i += blockDim.x)
        h0[(i / U) * ostride + i % U] = 0.f;
    }
    for (int i = threadIdx.x; i < Cell::NS * a.rows * U; i += blockDim.x)
      st[i] = 0.f;
    // the planes' padding columns H .. Hk stay zero (the fetch writes
    // columns below H only)
    if (PAD) {
      const int pad = a.Hk - H;
      for (int i = threadIdx.x; i < 3 * a.rows * pad; i += blockDim.x)
        S[(size_t)(i / pad) * SR + H + i % pad] = __float2bfloat16_rn(0.f);
    }
  }
  tc_prefetch<NG>(a, xs, ms, a.reverse ? a.T - 1 : 0, b0, nb, u0);

  // W fragments: A[m][k] = W[k][col(m)], m = block column mi*16 + ...;
  // columns past GC and rows past H are zero, so the padding k-steps and
  // columns add zeros (and land in P's padding rows, which nobody reads)
  const int G = NG * H;
  const int ca = mi * 16 + (lane >> 2), cb = ca + 8;
  const float* wa =
      ca < GC ? a.whh + (ca / U) * H + u0 + ca % U : (const float*)nullptr;
  const float* wb =
      cb < GC ? a.whh + (cb / U) * H + u0 + cb % U : (const float*)nullptr;
  uint32_t wr[TC_KW][4];
  bool nonzero = false;
#pragma unroll
  for (int i = 0; i < TC_KW; ++i) {
    if (i < a.kw) {
      float v[8];
      tc_wfrag(wa, wb, (kgi * a.kw + i) * 16 + 2 * (lane & 3), H, G, v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat16 h0 = __float2bfloat16_rn(v[2 * e]);
        const __nv_bfloat16 h1 = __float2bfloat16_rn(v[2 * e + 1]);
        nonzero |= v[2 * e] != __bfloat162float(h0) ||
                   v[2 * e + 1] != __bfloat162float(h1);
        wr[i][e] = tc_pack(h0, h1);
      }
    }
  }
  const bool any_rem = __syncthreads_or(nonzero) != 0;
  // w_mid, w_lo fragments of this lane (read back by this lane only)
  uint4* rem = a.wrem + (((size_t)rank * (blockDim.x >> 5) + warp) * a.kw) *
                            64 + lane * 2;
  if (any_rem) {
    for (int i = 0; i < a.kw; ++i) {
      float v[8];
      tc_wfrag(wa, wb, (kgi * a.kw + i) * 16 + 2 * (lane & 3), H, G, v);
      __nv_bfloat16 h[8], m[8], l[8];
      for (int e = 0; e < 8; ++e) tc_split3(v[e], h[e], m[e], l[e]);
      rem[i * 64] = make_uint4(tc_pack(m[0], m[1]), tc_pack(m[2], m[3]),
                               tc_pack(m[4], m[5]), tc_pack(m[6], m[7]));
      rem[i * 64 + 1] = make_uint4(tc_pack(l[0], l[1]), tc_pack(l[2], l[3]),
                                   tc_pack(l[4], l[5]), tc_pack(l[6], l[7]));
    }
  }

  if (MODE == TC_CLUSTER) tc_cluster_arrive();
  for (int s = 0; s < a.T; ++s) {
    const int t = a.reverse ? a.T - 1 - s : s;
    const int cur = s & 1;
    if (MODE == TC_CLUSTER) tc_cluster_wait();
    else cg::this_grid().sync();

    tc_fetch<MODE>(a, own_s, S, SR, group, cur);
    __syncthreads();

    float acc[NTILE][4], acl[NTILE][4];
#pragma unroll
    for (int n = 0; n < NTILE; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = acl[n][e] = 0.f;
    const int lr = (lane & 7) + ((lane >> 4) << 3);
    const int lk = ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int i = 0; i < TC_KW; ++i) {
      if (i < a.kw) {
        const int k0 = (kgi * a.kw + i) * 16 + lk;
        uint4 wm, wl;
        if (any_rem) {
          wm = rem[i * 64];
          wl = rem[i * 64 + 1];
        }
        // n-tiles in pairs (ldmatrix.x4), or one (x2) when NTILE is 1
#pragma unroll
        for (int pr = 0; pr < (NTILE + 1) / 2; ++pr) {
          constexpr bool two = NTILE > 1;
          const int n0 = 2 * pr, n1 = two ? 2 * pr + 1 : 0;
          const __nv_bfloat16* b = S + (size_t)(16 * pr + lr) * SR + k0;
          uint32_t bh[4], bm[4], bl[4];
          if (two) {
            tc_ldsm4(bh, b);
            tc_ldsm4(bm, b + plane);
            tc_ldsm4(bl, b + 2 * plane);
          } else {
            tc_ldsm2(bh, b);
            tc_ldsm2(bm, b + plane);
            tc_ldsm2(bl, b + 2 * plane);
          }
          tc_mma(acc[n0], wr[i], bh[0], bh[1]);
          tc_mma(acl[n0], wr[i], bm[0], bm[1]);
          tc_mma(acl[n0], wr[i], bl[0], bl[1]);
          if (two) {
            tc_mma(acc[n1], wr[i], bh[2], bh[3]);
            tc_mma(acl[n1], wr[i], bm[2], bm[3]);
            tc_mma(acl[n1], wr[i], bl[2], bl[3]);
          }
          if (any_rem) {
            const uint32_t m4[4] = {wm.x, wm.y, wm.z, wm.w};
            const uint32_t l4[4] = {wl.x, wl.y, wl.z, wl.w};
            tc_mma(acl[n0], m4, bh[0], bh[1]);
            tc_mma(acl[n0], m4, bm[0], bm[1]);
            tc_mma(acl[n0], l4, bh[0], bh[1]);
            if (two) {
              tc_mma(acl[n1], m4, bh[2], bh[3]);
              tc_mma(acl[n1], m4, bm[2], bm[3]);
              tc_mma(acl[n1], l4, bh[2], bh[3]);
            }
          }
        }
      }
    }
    {
      float* p = P + (size_t)kgi * PC * RS;
      const int r = 2 * (lane & 3);
#pragma unroll
      for (int n = 0; n < NTILE; ++n) {
        p[ca * RS + n * 8 + r] = acc[n][0] + acl[n][0];
        p[ca * RS + n * 8 + r + 1] = acc[n][1] + acl[n][1];
        p[cb * RS + n * 8 + r] = acc[n][2] + acl[n][2];
        p[cb * RS + n * 8 + r + 1] = acc[n][3] + acl[n][3];
      }
    }
    tc_cp_wait();
    __syncthreads();

    // epilogue: one (row, unit) pair per thread and pass
    const X* x = xs + (size_t)cur * a.rows * GC;
    const float* mk = ms + cur * a.rows;
    const float* hold = tc_slot<MODE>(a, own_s, group, rank, cur);
    float* hnew = tc_slot<MODE>(a, own_s, group, rank, cur ^ 1);
    const int ostride = MODE == TC_CLUSTER ? U : H;
    for (int i = threadIdx.x; i < nb * U; i += blockDim.x) {
      const int r = i / U, u = i - r * U;
      float pre[NG], xv[NG];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float* pc = P + (size_t)(g * U + u) * RS + r;
        float sum = pc[0];
        for (int j = 1; j < a.kg; ++j) sum += pc[(size_t)j * PC * RS];
        pre[g] = sum;
        xv[g] = tc_f32(x[r * GC + g * U + u]);
      }
      const bool m = mk[r] != 0.f;
      const float h_old = MODE == TC_CLUSTER ? hold[r * ostride + u]
                                             : __ldcg(hold + r * ostride + u);
      const float h_new = cell.step(pre, xv, h_old, st + r * U + u,
                                    a.rows * U, m, u0 + u, t, b0 + r);
      hnew[r * ostride + u] = m ? h_new : h_old;
      tc_store((X*)a.ys + ((size_t)t * a.B + b0 + r) * H + u0 + u,
               m ? h_new : 0.f);
    }
    if (s + 1 < a.T)
      tc_prefetch<NG>(a, xs + (size_t)(cur ^ 1) * a.rows * GC,
                      ms + (cur ^ 1) * a.rows,
                      a.reverse ? a.T - 2 - s : s + 1, b0, nb, u0);
    if (MODE == TC_CLUSTER) tc_cluster_arrive();
  }
  // no block leaves while a peer may still read its slots
  if (MODE == TC_CLUSTER) tc_cluster_wait();
}

// ---------------------------------------------------------------- host side

template <class Cell, int MODE, bool PAD>
static void* tc_kernel_ptr(int rows) {
  if (rows == 8) return (void*)tc_scan_kernel<Cell, MODE, 1, PAD>;
  if (rows == 16) return (void*)tc_scan_kernel<Cell, MODE, 2, PAD>;
  return nullptr;
}

// The instantiation for `rows`, `mode` and a width of U units per block
// whose k extent is Hk.
template <class Cell>
static void* tc_kernel_for(int rows, int mode, int H, int Hk, int U) {
  const bool pad = Hk != H || tc_cols(Cell::NG, U) != Cell::NG * U;
  if (mode == TC_CLUSTER)
    return pad ? tc_kernel_ptr<Cell, TC_CLUSTER, true>(rows)
               : tc_kernel_ptr<Cell, TC_CLUSTER, false>(rows);
  return pad ? tc_kernel_ptr<Cell, TC_GRID, true>(rows)
             : tc_kernel_ptr<Cell, TC_GRID, false>(rows);
}

// Checks the split (C blocks of U units, kg k-groups of kw k-steps that
// cover H's k-steps) and returns the block size, or 0 when it is not one
// this kernel takes.
static int tc_threads(int H, int U, int C, int kw, int kg, int rows, int NG) {
  if (H <= 0 || U <= 0 || C <= 0 || U * C != H || U % 4 != 0 || kw <= 0 ||
      kw > TC_KW || kg <= 0 || 16 * kw * kg < H || (rows != 8 && rows != 16))
    return 0;
  const int threads = 32 * (tc_cols(NG, U) / 16) * kg;
  return threads <= TC_MAX_THREADS ? threads : 0;
}

// Sets the kernel's attributes, then reports into *out how many groups
// (clusters, or for TC_GRID blocks over C) can be resident at once: 0 for
// a cluster of more than 16 blocks.
static int tc_prepare(void* fn, int C, int threads, size_t smem, int mode,
                      int* out) {
  int dev = 0, optin = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  *out = 0;
  if (smem > (size_t)optin || (mode == TC_CLUSTER && C > TC_MAX_CLUSTER))
    return 0;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (mode == TC_GRID) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                      smem);
    if (e != cudaSuccess) return (int)e;
    *out = per_sm * sms / C;
    return 0;
  }
  if (C > 8) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaOccupancyMaxActiveClusters(out, fn, &cfg);
  return (int)e;
}

// One launch of `groups` groups of C blocks on `stream`: clusters of C
// (TC_CLUSTER), which the card runs in waves where they do not all fit, or
// one cooperative grid (TC_GRID), which must be resident as a whole.
static int tc_launch(void* fn, void** args, int C, int groups, int threads,
                     size_t smem, int mode, void* stream) {
  int resident = 0;
  int e = tc_prepare(fn, C, threads, smem, mode, &resident);
  if (e != 0) return e;
  if (resident < 1 || (mode == TC_GRID && resident < groups))
    return (int)cudaErrorCooperativeLaunchTooLarge;
  cudaError_t ce;
  if (mode == TC_GRID) {
    ce = cudaLaunchCooperativeKernel(fn, dim3(C * groups), dim3(threads), args,
                                     smem, (cudaStream_t)stream);
  } else {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(C * groups);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = (cudaStream_t)stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    ce = cudaLaunchKernelExC(&cfg, fn, args);
  }
  if (ce != cudaSuccess) return (int)ce;
  return (int)cudaGetLastError();
}

// Groups of the Cell's scan that can be resident at once, into *out.
template <class Cell>
static int tc_max_groups(int H, int U, int C, int kw, int kg, int rows,
                         int mode, int* out) {
  const int threads = tc_threads(H, U, C, kw, kg, rows, Cell::NG);
  const int Hk = tc_kext(H, kw, kg);
  void* fn = tc_kernel_for<Cell>(rows, mode, H, Hk, U);
  if (threads == 0 || fn == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = tc_layout(Hk, U, Cell::NG, Cell::NS, rows, kg, mode,
                                sizeof(typename Cell::X)).total;
  return tc_prepare(fn, C, threads, smem, mode, out);
}

// Groups g0 .. g0 + groups - 1 of the batch; hbuf (TC_GRID) holds
// `groups` groups.
template <class Cell>
static int tc_scan_launch(TcArgs a, Cell cell, int groups, int mode,
                          void* stream) {
  const int threads = tc_threads(a.H, a.U, a.C, a.kw, a.kg, a.rows, Cell::NG);
  a.Hk = tc_kext(a.H, a.kw, a.kg);
  void* fn = tc_kernel_for<Cell>(a.rows, mode, a.H, a.Hk, a.U);
  if (threads == 0 || fn == nullptr || a.B <= 0 || a.T <= 0 || groups < 1 ||
      a.g0 < 0 || (a.g0 + groups - 1) * a.rows >= a.B ||
      (mode == TC_GRID && a.hbuf == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = tc_layout(a.Hk, a.U, Cell::NG, Cell::NS, a.rows, a.kg,
                                mode, sizeof(typename Cell::X)).total;
  void* args[] = {(void*)&a, (void*)&cell};
  return tc_launch(fn, args, a.C, groups, threads, smem, mode, stream);
}

// ------------------------------------------------------- the backward scan
// The f32 backward of a recurrent scan on the same tensor cores (K2b in
// lstm_scan.cu, K4b in gru_scan.cu: each adds its own Cell). Per walked step it
// computes the carry's product dhp . W_hh^T, which reduces over the K =
// NG * H gate columns of the previous walked step's dhp, then the Cell's
// epilogue. Block `rank` owns U = H / C hidden units (output rows of the
// transposed product): carry^T (U x rows) = W_hh[u0:u0+U, :] (U x K) .
// dhp^T (K x rows), U zero-padded to m-tiles of 16 and K to kg groups of
// kw k-steps of 16. Warp (mi, kgi) holds its W_hh fragments in registers
// for all T steps (A[m][k] = W_hh[u0 + m][k], contiguous along k).
//
// Exact to f32 arithmetic as the forward: dhp is split into three bf16
// parts each step; training W_hh is not bf16-valued, so W_hh is split too
// (w_hi in registers; w_mid, w_lo fragments in a global scratch read back
// from L2) and the six cross terms above f32 rounding are summed:
// hi.w_hi in one f32 sum, mid.w_hi + lo.w_hi + hi.w_mid + mid.w_mid +
// hi.w_lo in another (ops/cuda/scan_tc.py split_product).
//
// Exchange: each block writes its slice of the step's dhp (rows x NG U f32)
// to its own double-buffered slot; after one barrier every block copies all
// C slots into the three bf16 planes (rows x (Kk + 8)) of the next step's
// product: through distributed shared memory behind barrier.cluster
// (TC_CLUSTER), or through L2 behind grid.sync() (TC_GRID, slots in a
// global buffer in k order). The Cell's NI per-unit inputs of the next
// walked step (U contiguous floats per input and row, so the copies are 16
// bytes and coalesce) and the mask come in with cp.async while the barrier,
// the exchange and the product of the current step run.
struct TcBwdArgs {
  const float* whh;   // (H, NG*H)
  const float* mask;  // (T, B), 1 / 0
  uint4* wrem;        // C * warps * kw * 64 uint4: w_mid, w_lo fragments
  float* hbuf;        // TC_GRID: (groups, 2, rows, NG*H) exchange slots
  int T, B, H, U, C, kw, kg, rows, g0, reverse;
  int Kk;             // NG*H zero-padded to kg * kw * 16 (set by the launch)
};

__host__ __device__ inline int tc_bwd_mp(int U) { return (U + 15) / 16 * 16; }

__host__ __device__ inline TcLayout tc_bwd_layout(int Kk, int U, int NG,
                                                  int NI, int NS, int rows,
                                                  int kg, int mode) {
  TcLayout L;
  size_t o = 0;
  L.s = o;    // three bf16 planes of dhp, rows x (Kk + 8)
  o = tc_align(o + (size_t)3 * rows * (Kk + 8) * 2);
  L.p = o;    // kg partial products, MP x (rows + 1) f32
  o = tc_align(o + (size_t)kg * tc_bwd_mp(U) * (rows + 1) * 4);
  L.own = o;  // TC_CLUSTER: two slots of this block's dhp, rows x NG U f32
  if (mode == TC_CLUSTER) o = tc_align(o + (size_t)2 * rows * NG * U * 4);
  L.st = o;   // the cell's carry state, NS x rows x U f32
  o = tc_align(o + (size_t)NS * rows * U * 4);
  L.xs = o;   // two buffers of the step inputs, rows x NI x U f32
  o = tc_align(o + (size_t)2 * rows * NI * U * 4);
  L.ms = o;   // two buffers of mask rows
  o = tc_align(o + (size_t)2 * rows * 4);
  L.total = o;
  return L;
}

// Walked step s -> real time t and the step the forward walked before it
// (tp, outside [0, T) at the forward's first step).
__device__ __forceinline__ void tc_bwd_time(const TcBwdArgs& a, int s, int& t,
                                            int& tp) {
  t = a.reverse ? s : a.T - 1 - s;
  tp = a.reverse ? t + 1 : t - 1;
}

// cp.async of walked step s's inputs (the Cell's NI planes of U floats per
// row; a null source is zero-filled) and mask rows into one buffer.
template <class Cell>
__device__ __forceinline__ void tc_bwd_prefetch(const TcBwdArgs& a,
                                                const Cell& cell, float* xs,
                                                float* ms, int s, int b0,
                                                int nb, int u0) {
  constexpr int NI = Cell::NI;
  int t, tp;
  tc_bwd_time(a, s, t, tp);
  const bool has_prev = tp >= 0 && tp < a.T;
  const int U4 = a.U / 4;
  const int n = nb * NI * U4;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / (NI * U4), rem = i - r * NI * U4;
    const int pl = rem / U4, j = rem - pl * U4;
    const float* src = cell.src(pl, t, tp, has_prev, b0 + r, u0);
    float* dst = xs + (size_t)(r * NI + pl) * a.U + 4 * j;
    if (src != nullptr) tc_cp16(dst, src + 4 * j);
    else *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int r = threadIdx.x; r < nb; r += blockDim.x)
    tc_cp4(ms + r, a.mask + (size_t)t * a.B + b0 + r);
  tc_cp_commit();
}

// Copies slot `buf` of every block of the group (dhp, K = NG H columns per
// row in k = g H + unit order) into the three bf16 planes of S.
template <int MODE>
__device__ __forceinline__ void tc_bwd_fetch(const TcBwdArgs& a, int NG,
                                             float* own_s, __nv_bfloat16* S,
                                             int SR, int group, int buf) {
  const int K = NG * a.H, K4 = K / 4, H4 = a.H / 4, U4 = a.U / 4;
  const int GU = NG * a.U;
  const size_t plane = (size_t)a.rows * SR;
  const int n = a.rows * K4;
  constexpr int FB = 2;
  for (int i0 = threadIdx.x; i0 < n; i0 += FB * blockDim.x) {
    float4 v[FB];
#pragma unroll
    for (int f = 0; f < FB; ++f) {
      const int i = i0 + f * blockDim.x;
      if (i >= n) break;
      const int r = i / K4, k4 = i - r * K4;
      if (MODE == TC_CLUSTER) {
        const int g = k4 / H4, rem = k4 - g * H4;
        const int q = rem / U4, j = rem - q * U4;
        const float* src = cg::this_cluster().map_shared_rank(
            own_s + (size_t)buf * a.rows * GU, q);
        v[f] = *reinterpret_cast<const float4*>(src + r * GU + g * a.U +
                                                4 * j);
      } else {
        v[f] = __ldcg(reinterpret_cast<const float4*>(
            a.hbuf + ((size_t)(group * 2 + buf) * a.rows + r) * K + 4 * k4));
      }
    }
#pragma unroll
    for (int f = 0; f < FB; ++f) {
      const int i = i0 + f * blockDim.x;
      if (i >= n) break;
      const int r = i / K4, k4 = i - r * K4;
      __nv_bfloat16 h[4], m[4], l[4];
      tc_split3(v[f].x, h[0], m[0], l[0]);
      tc_split3(v[f].y, h[1], m[1], l[1]);
      tc_split3(v[f].z, h[2], m[2], l[2]);
      tc_split3(v[f].w, h[3], m[3], l[3]);
      __nv_bfloat16* d = S + (size_t)r * SR + 4 * k4;
      *reinterpret_cast<uint2*>(d) =
          make_uint2(tc_pack(h[0], h[1]), tc_pack(h[2], h[3]));
      *reinterpret_cast<uint2*>(d + plane) =
          make_uint2(tc_pack(m[0], m[1]), tc_pack(m[2], m[3]));
      *reinterpret_cast<uint2*>(d + 2 * plane) =
          make_uint2(tc_pack(l[0], l[1]), tc_pack(l[2], l[3]));
    }
  }
}

// The backward scan. NTILE n-tiles of 8 rows; blockDim = 32 * MT * kg with
// MT = ceil(U / 16). Grid: C blocks per group of `rows` batch rows.
template <class Cell, int MODE, int NTILE>
__global__ void __launch_bounds__(TC_MAX_THREADS, 1)
    tc_bwd_kernel(TcBwdArgs a, Cell cell) {
  constexpr int NG = Cell::NG, NI = Cell::NI, NS = Cell::NS;
  const int U = a.U, H = a.H, K = NG * H, GU = NG * U;
  const int MP = tc_bwd_mp(U), MT = MP / 16;
  const int rank = blockIdx.x % a.C, group = blockIdx.x / a.C;
  const int u0 = rank * U, b0 = (a.g0 + group) * a.rows;
  const int nb = min(a.rows, a.B - b0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mi = warp % MT, kgi = warp / MT;
  const int SR = a.Kk + 8, RS = a.rows + 1;
  const size_t plane = (size_t)a.rows * SR;

  extern __shared__ __align__(16) unsigned char tc_smem[];
  const TcLayout L = tc_bwd_layout(a.Kk, U, NG, NI, NS, a.rows, a.kg, MODE);
  __nv_bfloat16* S = (__nv_bfloat16*)(tc_smem + L.s);
  float* P = (float*)(tc_smem + L.p);
  float* own_s = (float*)(tc_smem + L.own);
  float* st = (float*)(tc_smem + L.st);
  float* xs = (float*)(tc_smem + L.xs);
  float* ms = (float*)(tc_smem + L.ms);

  // zero both slots (slot 0 is the zero dhp before the first walked step;
  // rows past the batch stay 0), the state and the planes' padding columns
  for (int b = 0; b < 2; ++b)
    for (int i = threadIdx.x; i < a.rows * GU; i += blockDim.x) {
      if (MODE == TC_CLUSTER) {
        own_s[(size_t)b * a.rows * GU + i] = 0.f;
      } else {
        const int r = i / GU, c = i - r * GU, g = c / U;
        a.hbuf[((size_t)(group * 2 + b) * a.rows + r) * K + g * H + u0 +
               c - g * U] = 0.f;
      }
    }
  for (int i = threadIdx.x; i < NS * a.rows * U; i += blockDim.x) st[i] = 0.f;
  if (a.Kk > K) {
    const int pad = a.Kk - K;
    for (int i = threadIdx.x; i < 3 * a.rows * pad; i += blockDim.x)
      S[(size_t)(i / pad) * SR + K + i % pad] = __float2bfloat16_rn(0.f);
  }
  tc_bwd_prefetch(a, cell, xs, ms, 0, b0, nb, u0);

  // W fragments: A[m][k] = W_hh[u0 + m][k]; rows past U and k past K zero
  const int ca = mi * 16 + (lane >> 2), cb = ca + 8;
  const float* wa = ca < U ? a.whh + (size_t)(u0 + ca) * K : nullptr;
  const float* wb = cb < U ? a.whh + (size_t)(u0 + cb) * K : nullptr;
  uint32_t wr[TC_KW][4];
  bool nonzero = false;
#pragma unroll
  for (int i = 0; i < TC_KW; ++i) {
    if (i < a.kw) {
      float v[8];
      tc_wfrag(wa, wb, (kgi * a.kw + i) * 16 + 2 * (lane & 3), K, 1, v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat16 h0 = __float2bfloat16_rn(v[2 * e]);
        const __nv_bfloat16 h1 = __float2bfloat16_rn(v[2 * e + 1]);
        nonzero |= v[2 * e] != __bfloat162float(h0) ||
                   v[2 * e + 1] != __bfloat162float(h1);
        wr[i][e] = tc_pack(h0, h1);
      }
    }
  }
  const bool any_rem = __syncthreads_or(nonzero) != 0;
  uint4* rem = a.wrem + (((size_t)rank * (blockDim.x >> 5) + warp) * a.kw) *
                            64 + lane * 2;
  if (any_rem) {
    for (int i = 0; i < a.kw; ++i) {
      float v[8];
      tc_wfrag(wa, wb, (kgi * a.kw + i) * 16 + 2 * (lane & 3), K, 1, v);
      __nv_bfloat16 h[8], m[8], l[8];
      for (int e = 0; e < 8; ++e) tc_split3(v[e], h[e], m[e], l[e]);
      rem[i * 64] = make_uint4(tc_pack(m[0], m[1]), tc_pack(m[2], m[3]),
                               tc_pack(m[4], m[5]), tc_pack(m[6], m[7]));
      rem[i * 64 + 1] = make_uint4(tc_pack(l[0], l[1]), tc_pack(l[2], l[3]),
                                   tc_pack(l[4], l[5]), tc_pack(l[6], l[7]));
    }
  }

  if (MODE == TC_CLUSTER) tc_cluster_arrive();
  for (int s = 0; s < a.T; ++s) {
    int t, tp;
    tc_bwd_time(a, s, t, tp);
    const int cur = s & 1;
    if (MODE == TC_CLUSTER) tc_cluster_wait();
    else cg::this_grid().sync();

    tc_bwd_fetch<MODE>(a, NG, own_s, S, SR, group, cur);
    __syncthreads();

    float acc[NTILE][4], acl[NTILE][4];
#pragma unroll
    for (int n = 0; n < NTILE; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = acl[n][e] = 0.f;
    const int lr = (lane & 7) + ((lane >> 4) << 3);
    const int lk = ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int i = 0; i < TC_KW; ++i) {
      if (i < a.kw) {
        const int k0 = (kgi * a.kw + i) * 16 + lk;
        uint4 wm, wl;
        if (any_rem) {
          wm = rem[i * 64];
          wl = rem[i * 64 + 1];
        }
#pragma unroll
        for (int pr = 0; pr < (NTILE + 1) / 2; ++pr) {
          constexpr bool two = NTILE > 1;
          const int n0 = 2 * pr, n1 = two ? 2 * pr + 1 : 0;
          const __nv_bfloat16* b = S + (size_t)(16 * pr + lr) * SR + k0;
          uint32_t bh[4], bm[4], bl[4];
          if (two) {
            tc_ldsm4(bh, b);
            tc_ldsm4(bm, b + plane);
            tc_ldsm4(bl, b + 2 * plane);
          } else {
            tc_ldsm2(bh, b);
            tc_ldsm2(bm, b + plane);
            tc_ldsm2(bl, b + 2 * plane);
          }
          tc_mma(acc[n0], wr[i], bh[0], bh[1]);
          tc_mma(acl[n0], wr[i], bm[0], bm[1]);
          tc_mma(acl[n0], wr[i], bl[0], bl[1]);
          if (two) {
            tc_mma(acc[n1], wr[i], bh[2], bh[3]);
            tc_mma(acl[n1], wr[i], bm[2], bm[3]);
            tc_mma(acl[n1], wr[i], bl[2], bl[3]);
          }
          if (any_rem) {
            const uint32_t m4[4] = {wm.x, wm.y, wm.z, wm.w};
            const uint32_t l4[4] = {wl.x, wl.y, wl.z, wl.w};
            tc_mma(acl[n0], m4, bh[0], bh[1]);
            tc_mma(acl[n0], m4, bm[0], bm[1]);
            tc_mma(acl[n0], l4, bh[0], bh[1]);
            if (two) {
              tc_mma(acl[n1], m4, bh[2], bh[3]);
              tc_mma(acl[n1], m4, bm[2], bm[3]);
              tc_mma(acl[n1], l4, bh[2], bh[3]);
            }
          }
        }
      }
    }
    {
      float* p = P + (size_t)kgi * MP * RS;
      const int r = 2 * (lane & 3);
#pragma unroll
      for (int n = 0; n < NTILE; ++n) {
        p[ca * RS + n * 8 + r] = acc[n][0] + acl[n][0];
        p[ca * RS + n * 8 + r + 1] = acc[n][1] + acl[n][1];
        p[cb * RS + n * 8 + r] = acc[n][2] + acl[n][2];
        p[cb * RS + n * 8 + r + 1] = acc[n][3] + acl[n][3];
      }
    }
    tc_cp_wait();
    __syncthreads();

    // epilogue: one (row, unit) pair per thread and pass
    const float* x = xs + (size_t)cur * a.rows * NI * U;
    const float* mk = ms + cur * a.rows;
    const int nxt = cur ^ 1;
    for (int i = threadIdx.x; i < nb * U; i += blockDim.x) {
      const int r = i / U, u = i - r * U;
      const float* pc = P + (size_t)u * RS + r;
      float p = pc[0];
      for (int j = 1; j < a.kg; ++j) p += pc[(size_t)j * MP * RS];
      float xv[NI], dg[NG];
#pragma unroll
      for (int q = 0; q < NI; ++q) xv[q] = x[(size_t)(r * NI + q) * U + u];
      cell.step(p, xv, mk[r] != 0.f, st + r * U + u, a.rows * U, dg, t,
                b0 + r, u0 + u);
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        if (MODE == TC_CLUSTER)
          own_s[((size_t)nxt * a.rows + r) * GU + g * U + u] = dg[g];
        else
          a.hbuf[((size_t)(group * 2 + nxt) * a.rows + r) * K + g * H + u0 +
                 u] = dg[g];
      }
    }
    if (s + 1 < a.T)
      tc_bwd_prefetch(a, cell, xs + (size_t)nxt * a.rows * NI * U,
                      ms + nxt * a.rows, s + 1, b0, nb, u0);
    if (MODE == TC_CLUSTER) tc_cluster_arrive();
  }
  if (MODE == TC_CLUSTER) tc_cluster_wait();
}

template <class Cell, int MODE>
static void* tc_bwd_kernel_ptr(int rows) {
  if (rows == 8) return (void*)tc_bwd_kernel<Cell, MODE, 1>;
  if (rows == 16) return (void*)tc_bwd_kernel<Cell, MODE, 2>;
  return nullptr;
}

template <class Cell>
static void* tc_bwd_kernel_for(int rows, int mode) {
  return mode == TC_CLUSTER ? tc_bwd_kernel_ptr<Cell, TC_CLUSTER>(rows)
                            : tc_bwd_kernel_ptr<Cell, TC_GRID>(rows);
}

// Checks the backward split (C blocks of U units, kg k-groups of kw
// k-steps that cover the NG H columns) and returns the block size, or 0.
static int tc_bwd_threads(int H, int U, int C, int kw, int kg, int rows,
                          int NG) {
  if (H <= 0 || U <= 0 || C <= 0 || U * C != H || U % 4 != 0 || kw <= 0 ||
      kw > TC_KW || kg <= 0 || 16 * kw * kg < NG * H ||
      (rows != 8 && rows != 16))
    return 0;
  const int threads = 32 * (tc_bwd_mp(U) / 16) * kg;
  return threads <= TC_MAX_THREADS ? threads : 0;
}

template <class Cell>
static size_t tc_bwd_smem(int kw, int kg, int U, int rows, int mode) {
  return tc_bwd_layout(16 * kw * kg, U, Cell::NG, Cell::NI, Cell::NS, rows,
                       kg, mode).total;
}

// Groups of the Cell's backward scan that can be resident at once, into
// *out (0 where one block's shared memory does not fit).
template <class Cell>
static int tc_bwd_max_groups(int H, int U, int C, int kw, int kg, int rows,
                             int mode, int* out) {
  const int threads = tc_bwd_threads(H, U, C, kw, kg, rows, Cell::NG);
  void* fn = tc_bwd_kernel_for<Cell>(rows, mode);
  if (threads == 0 || fn == nullptr) return (int)cudaErrorInvalidValue;
  return tc_prepare(fn, C, threads, tc_bwd_smem<Cell>(kw, kg, U, rows, mode),
                    mode, out);
}

// Groups g0 .. g0 + groups - 1 of the batch; hbuf (TC_GRID) holds
// `groups` groups.
template <class Cell>
static int tc_bwd_launch(TcBwdArgs a, Cell cell, int groups, int mode,
                         void* stream) {
  const int threads =
      tc_bwd_threads(a.H, a.U, a.C, a.kw, a.kg, a.rows, Cell::NG);
  a.Kk = 16 * a.kw * a.kg;
  void* fn = tc_bwd_kernel_for<Cell>(a.rows, mode);
  if (threads == 0 || fn == nullptr || a.B <= 0 || a.T <= 0 || groups < 1 ||
      a.g0 < 0 || (a.g0 + groups - 1) * a.rows >= a.B ||
      (mode == TC_GRID && a.hbuf == nullptr))
    return (int)cudaErrorInvalidValue;
  void* args[] = {(void*)&a, (void*)&cell};
  return tc_launch(fn, args, a.C, groups, threads,
                   tc_bwd_smem<Cell>(a.kw, a.kg, a.U, a.rows, mode), mode,
                   stream);
}

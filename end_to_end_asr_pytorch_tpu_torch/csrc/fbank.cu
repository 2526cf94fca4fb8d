// Fused log-mel filterbank (K1) for Hopper, at f32 accuracy on the tensor
// cores.
//
// Replaces end_to_end_asr_pytorch_tpu/ops/pallas/fbank_kernel.py:fbank_fused.
// wave (B, S) f32 -> out (B, T, n_mels) f32, T = (S + 2*pad - n_fft) / hop +
// 1, pad = n_fft / 2: log(mel_fb^T (re^2 + im^2) + log_eps) with re = frames
// . cosw and im = frames . msinw over the torch.stft-style center
// reflect-padded frames (the padding is computed from indices; no padded
// copy of the wave is made).
//
// Bound on the H100: operations. The windowed DFT is one GEMM per tile (M
// the frames, K = n_fft, N the 2 n_bins cos/-sin columns): 2 n_fft (2
// n_bins) operations per frame (~0.32 MFLOP at n_fft=400) against ~640
// bytes of new audio. At the f32 CUDA-core rate that is 0.114 ms at B=32
// (7 s waves), and a CUDA-core DFT is held below even that by the loads of
// its operands (about one per two FMAs). The TPU kernel runs the product
// on its matrix unit at Precision.HIGHEST, a six-pass bf16 split; so does
// this kernel:
//  - Both operands are split into three bf16 parts, x = hi + mid + lo
//    exactly (tc_split3 of scan_tc.cuh), and the product runs on
//    mma.sync m16n8k16 (bf16 operands, f32 accumulators) as six passes:
//    hi.hi in one accumulator, mid.hi + lo.hi + hi.mid + mid.mid + hi.lo
//    in another, added at the end. The products of bf16 values are exact
//    in f32, so the result is of f32 grade (a single bf16 or TF32 pass
//    would leave ~1e-3 relative error in the power).
//  - The DFT matrix is interleaved, column 2j = cos_j and 2j+1 = -sin_j, so
//    one m16n8 accumulator holds re and im of the same bins and the power
//    is formed in registers. fbank_split_kernel (launched first by
//    fbank_launch, on every call) writes its three bf16 parts once, in the
//    order the main kernel copies them: per (pass, k-step of 16) one
//    contiguous stage of 3 x 224 columns (fewer in the last pass) x 16 k,
//    each 32-byte column row swizzled (16-byte halves swapped on bit 2 of
//    the column) so that the 8-row ldmatrix phases hit distinct banks. It
//    also transposes the filterbank and finds each filter's nonzero bins.
//  - One block of 8 warps per (64-frame tile, utterance). It stages the
//    tile's waveform span once with cp.async (16-byte copies inside the
//    wave, 4-byte ones with the reflection at its ends) into the power
//    tile's room, then splits it into three bf16 planes, as rows of hop
//    samples padded to hop + 8 (an odd number of 16-byte units: frame rows
//    sit hop samples apart, an even number of units, which would make 8-row
//    ldmatrix phases conflict). Frame f, sample n sits at row f + n / hop,
//    column n % hop: implicit im2col; a 16-sample k-step never straddles a
//    row because hop is a multiple of 16 (of 80, the TPU kernel's own
//    assert).
//  - Warps are 2 (32 frames) x 4 (7 n8 tiles); a pass covers 224 of the
//    interleaved columns, the last pass only what is left (at n_fft=400:
//    224 + 192 of 402 columns, 51 of 56 tiles). K streams through a ring of
//    4 stages (L2-resident, shared by all blocks), each filled by one TMA
//    bulk copy that completes on the slot's full mbarrier; every warp
//    arrives on the slot's empty mbarrier when it is done with it, and
//    thread 0 refills it. No block-wide barrier stands in the loop, so a
//    warp that is ahead is held only by data. Each pass leaves its power
//    tile in shared memory.
//  - The mel product runs on CUDA cores in f32 over each filter's nonzero
//    bins only (adding the exact zeros outside them changes no sum), a warp
//    per filter reading its weights from the transposed filterbank; only
//    log(mel + eps) is written to device memory, in coalesced rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_tc.cuh"

#define FB_TM 64                     // frames per block (the mel loop's 2 x 32)
#define FB_WARPS 8                   // 2 along M x 4 along N
#define FB_THREADS (FB_WARPS * 32)
#define FB_NW 4                      // warps along N
#define FB_NTW 7                     // n8 tiles per warp in a full pass
#define FB_PC (FB_NW * FB_NTW * 8)   // interleaved columns of a full pass
#define FB_NSTAGE 4
#define FB_STAGE (3 * FB_PC * 32)    // bytes of one full (pass, k-step) stage

// Byte offsets of one block's dynamic shared memory.
struct FbLayout {
  int rs;       // bf16 elements per span row (hop + 8)
  int rows;     // span rows of a tile
  int plane;    // bf16 elements per split plane (rows * rs)
  int ntiles;   // n8 tiles of the 2 n_bins interleaved columns
  int passes;   // full passes of FB_PC columns, then the rest
  int pb;       // floats per power row (odd)
  size_t a, ring, pow, rng, bar, total;
};

__host__ __device__ inline FbLayout fb_layout(int n_fft, int hop, int n_bins,
                                              int n_mels) {
  FbLayout L;
  L.rs = hop + 8;
  L.rows = FB_TM - 1 + (n_fft + hop - 1) / hop;
  L.plane = L.rows * L.rs;
  L.ntiles = (2 * n_bins + 7) / 8;
  L.passes = (L.ntiles + FB_NW * FB_NTW - 1) / (FB_NW * FB_NTW);
  L.pb = L.passes * FB_PC / 2 + 1;
  size_t o = 0;
  L.a = o;    // three bf16 planes of the span: hi, mid, lo
  o = tc_align(o + (size_t)3 * L.plane * 2);
  L.ring = o; // the DFT stages; after the last pass, the mel output tile
  size_t ring = (size_t)FB_NSTAGE * FB_STAGE;
  size_t tile = (size_t)FB_TM * n_mels * 4;
  o = tc_align(o + (ring > tile ? ring : tile));
  L.pow = o;  // FB_TM x pb power; before the first pass, the f32 span
  size_t pw = (size_t)FB_TM * L.pb, span = (size_t)L.rows * hop;
  o = tc_align(o + (pw > span ? pw : span) * 4);
  L.rng = o;  // each filter's first and last + 1 nonzero bin
  o = tc_align(o + (size_t)2 * n_mels * 4);
  L.bar = o;  // the ring's full and empty mbarriers
  o = tc_align(o + (size_t)2 * FB_NSTAGE * 8);
  L.total = o;
  return L;
}

// n8 tiles per warp in pass `pass`: FB_NTW, and in the last pass what is
// left, spread over the FB_NW warps.
__host__ __device__ inline int fb_ntw(const FbLayout& L, int pass) {
  if (pass < L.passes - 1) return FB_NTW;
  const int rest = L.ntiles - (L.passes - 1) * FB_NW * FB_NTW;
  return (rest + FB_NW - 1) / FB_NW;
}

// Offset (bf16 elements) of column row n, k (0..15) in a stage's part.
__host__ __device__ inline int fb_swz(int n, int k) {
  return n * 16 + ((((k >> 3) ^ (n >> 2)) & 1) << 3) + (k & 7);
}

// The scratch fbank_launch writes and reads: the split DFT stages, each
// filter's nonzero range (2 n_mels ints), the filterbank transposed
// (n_mels x n_bins f32).
struct FbScratch {
  size_t rng, melt, total;
};
__host__ __device__ inline FbScratch fb_scratch(int n_fft, int n_bins,
                                                int n_mels) {
  FbScratch X;
  X.rng = (size_t)fb_layout(n_fft, 16, n_bins, n_mels).passes *
          (n_fft / 16) * FB_STAGE;
  X.melt = X.rng + tc_align((size_t)2 * n_mels * 4);
  X.total = X.melt + (size_t)n_mels * n_bins * 4;
  return X;
}

// The interleaved DFT matrix D[k][2j] = cosw[k][j], D[k][2j+1] = msinw[k][j]
// (zero past 2 n_bins), split into hi / mid / lo, as stages: pass p's
// columns p * FB_PC .. for its 32 ntw columns, k-step ks: parts 0..2, each
// 32 ntw column rows of 16 k, at byte p * (n_fft / 16) * FB_STAGE + ks *
// 3072 ntw (only the last pass may be narrower). Also the filterbank
// transposed, and (block m < n_mels) filter m's first and last + 1 nonzero
// bin in rng[m], rng[n_mels + m] (an empty filter gets lo = n_bins, hi = 0).
__global__ void fbank_split_kernel(const float* __restrict__ cosw,
                                   const float* __restrict__ msinw,
                                   const float* __restrict__ mel,
                                   int n_fft, int hop, int n_bins,
                                   int n_mels, unsigned char* __restrict__ x) {
  const FbScratch X = fb_scratch(n_fft, n_bins, n_mels);
  int* rng = reinterpret_cast<int*>(x + X.rng);
  float* melt = reinterpret_cast<float*>(x + X.melt);
  if (blockIdx.x < n_mels && threadIdx.x < 32) {
    const int m = blockIdx.x;
    int lo = n_bins, hi = 0;
    for (int k = threadIdx.x; k < n_bins; k += 32)
      if (mel[(size_t)k * n_mels + m] != 0.f) {
        lo = min(lo, k);
        hi = k + 1;
      }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    if (threadIdx.x == 0) {
      rng[m] = lo;
      rng[n_mels + m] = hi;
    }
  }
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_mels * n_bins;
       i += stride)
    melt[i] = mel[(size_t)(i % n_bins) * n_mels + i / n_bins];
  const FbLayout L = fb_layout(n_fft, hop, n_bins, n_mels);
  const int ks_n = n_fft / 16;
  __nv_bfloat16* dft = reinterpret_cast<__nv_bfloat16*>(x);
  for (int pass = 0; pass < L.passes; ++pass) {
    const int pc = FB_NW * fb_ntw(L, pass) * 8;
    __nv_bfloat16* base = dft + (size_t)pass * ks_n * (FB_STAGE / 2);
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < ks_n * pc * 16;
         i += stride) {
      const int kk = i & 15, n = (i >> 4) % pc, ks = (i >> 4) / pc;
      const int col = pass * FB_PC + n, bin = col >> 1, k = ks * 16 + kk;
      float v = 0.f;
      if (bin < n_bins)
        v = (col & 1) ? msinw[(size_t)k * n_bins + bin]
                      : cosw[(size_t)k * n_bins + bin];
      __nv_bfloat16 hi, mid, lo;
      tc_split3(v, hi, mid, lo);
      __nv_bfloat16* st = base + (size_t)ks * 3 * pc * 16 + fb_swz(n, kk);
      st[0] = hi;
      st[pc * 16] = mid;
      st[2 * pc * 16] = lo;
    }
  }
}

__device__ __forceinline__ uint32_t fb_sa(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void fb_bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(fb_sa(bar)),
               "r"(count));
}
__device__ __forceinline__ void fb_bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(fb_sa(bar))
               : "memory");
}
__device__ __forceinline__ void fb_bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(fb_sa(bar)),
      "r"(parity)
      : "memory");
}

// Stage s (pass s / ks_n, k-step s % ks_n) into its ring slot: one bulk
// copy that completes on the slot's full barrier.
__device__ __forceinline__ void fb_fetch(unsigned char* ring, uint64_t* full,
                                         const unsigned char* dft,
                                         const FbLayout& L, int ks_n, int s) {
  const int pass = s / ks_n, slot = s % FB_NSTAGE;
  const uint32_t bytes = 3072u * fb_ntw(L, pass);
  const unsigned char* src =
      dft + (size_t)pass * ks_n * FB_STAGE + (size_t)(s % ks_n) * bytes;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   fb_sa(full + slot)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(fb_sa(ring + slot * FB_STAGE)),
      "l"(src), "r"(bytes), "r"(fb_sa(full + slot))
      : "memory");
}

__device__ __forceinline__ void fb_cp4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   fb_sa(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void fb_ldsm4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void fb_ldsm2(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// One pass: NTW n8 tiles per warp (32 NTW columns of the block) over all
// of K, then their power into pow_s. Compile-time NTW keeps each k-step one
// straight-line block the scheduler can interleave. Warps meet only at the
// ring's barriers: a stage's full barrier before its use, its empty
// barrier (one arrival per warp) after; thread 0 refills the slot of the
// stage before the current one once every warp has left it.
template <int NTW>
__device__ __forceinline__ void fb_pass(const FbLayout& L,
                                        const __nv_bfloat16* a_s,
                                        unsigned char* ring, uint64_t* full,
                                        uint64_t* empty,
                                        const unsigned char* dft,
                                        float* pow_s, int pass, int hop,
                                        int ks_n) {
  constexpr int PC = FB_NW * NTW * 8, NQ = (NTW + 1) / 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / FB_NW, wn = warp % FB_NW;
  const int n_stages = L.passes * ks_n;
  // A (frames x k): ldmatrix.x4 rows are frames, 8-sample halves of the step
  int a_off[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
    a_off[mt] = (wm * 32 + mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                    L.rs + (lane >> 4) * 8;
  // B (columns x k): an x4 covers n-tiles 2q, 2q + 1; an x2 the last of an
  // odd count
  int b_off[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int n = wn * NTW * 8 + q * 16 + (lane & 7) +
                  (2 * q + 1 < NTW ? (lane >> 4) * 8 : 0);
    b_off[q] = 2 * fb_swz(n, ((lane >> 3) & 1) * 8);
  }
  const uint32_t a_base = fb_sa(a_s), ring_base = fb_sa(ring);
  float big[2][NTW][4], small[2][NTW][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) big[mt][nt][e] = small[mt][nt][e] = 0.f;

  for (int ks = 0; ks < ks_n; ++ks) {
    const int s = pass * ks_n + ks, slot = s % FB_NSTAGE;
    if (threadIdx.x == 0 && s > 0 && s - 1 + FB_NSTAGE < n_stages) {
      fb_bar_wait(empty + (s - 1) % FB_NSTAGE, ((s - 1) / FB_NSTAGE) & 1);
      fb_fetch(ring, full, dft, L, ks_n, s - 1 + FB_NSTAGE);
    }
    __syncwarp();               // warp 0 whole again for ldmatrix
    fb_bar_wait(full + slot, (s / FB_NSTAGE) & 1);

    const int k0 = ks * 16;
    const int roff = (k0 / hop) * L.rs + k0 % hop;
    uint32_t a[2][3][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int p = 0; p < 3; ++p)
        fb_ldsm4(a[mt][p],
                 a_base + 2u * (uint32_t)(p * L.plane + a_off[mt] + roff));
    const uint32_t st = ring_base + (uint32_t)(slot * FB_STAGE);
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const bool pair = 2 * q + 1 < NTW;
      uint32_t bf[3][4];
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        const uint32_t addr = st + (uint32_t)(p * PC * 32 + b_off[q]);
        if (pair) fb_ldsm4(bf[p], addr);
        else fb_ldsm2(bf[p], addr);
      }
      // six products of parts: hi.hi into one sum; mid.hi, lo.hi, hi.mid,
      // mid.mid, hi.lo into the other
#pragma unroll
      for (int h = 0; h < (pair ? 2 : 1); ++h)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          float* bg = big[mt][2 * q + h];
          float* sm = small[mt][2 * q + h];
          tc_mma(bg, a[mt][0], bf[0][2 * h], bf[0][2 * h + 1]);
          tc_mma(sm, a[mt][1], bf[0][2 * h], bf[0][2 * h + 1]);
          tc_mma(sm, a[mt][2], bf[0][2 * h], bf[0][2 * h + 1]);
          tc_mma(sm, a[mt][0], bf[1][2 * h], bf[1][2 * h + 1]);
          tc_mma(sm, a[mt][1], bf[1][2 * h], bf[1][2 * h + 1]);
          tc_mma(sm, a[mt][0], bf[2][2 * h], bf[2][2 * h + 1]);
        }
    }
    __syncwarp();
    if (lane == 0) fb_bar_arrive(empty + slot);
  }

  // power of bin pass * FB_PC / 2 + (its column) / 2 for rows g, g + 8
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int f = wm * 32 + mt * 16 + (lane >> 2);
      const int bin = pass * (FB_PC / 2) + wn * NTW * 4 + nt * 4 + (lane & 3);
      const float* bg = big[mt][nt];
      const float* sm = small[mt][nt];
      const float re0 = bg[0] + sm[0], im0 = bg[1] + sm[1];
      const float re1 = bg[2] + sm[2], im1 = bg[3] + sm[3];
      pow_s[f * L.pb + bin] = re0 * re0 + im0 * im0;
      pow_s[(f + 8) * L.pb + bin] = re1 * re1 + im1 * im1;
    }
}

__global__ void __launch_bounds__(FB_THREADS, 1) fbank_kernel(
    const float* __restrict__ wave, int S, int pad,
    const unsigned char* __restrict__ x, const float* __restrict__ mel,
    float* __restrict__ out, int T, int n_fft, int hop, int n_bins,
    int n_mels, float log_eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const FbLayout L = fb_layout(n_fft, hop, n_bins, n_mels);
  const FbScratch X = fb_scratch(n_fft, n_bins, n_mels);
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem + L.a);
  unsigned char* ring = smem + L.ring;
  float* pow_s = reinterpret_cast<float*>(smem + L.pow);
  int* rng_s = reinterpret_cast<int*>(smem + L.rng);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar);
  uint64_t* empty = full + FB_NSTAGE;
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * FB_TM;
  const int ks_n = n_fft / 16;
  const int n_stages = L.passes * ks_n;

  if (tid == 0) {
    for (int i = 0; i < FB_NSTAGE; ++i) {
      fb_bar_init(full + i, 1);
      fb_bar_init(empty + i, FB_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < FB_NSTAGE && s < n_stages; ++s)
      fb_fetch(ring, full, x, L, ks_n, s);
  }

  // the tile's span of the reflect-padded signal (padded index t0 hop + i,
  // i < rows hop) as f32 into the power tile's room: 16-byte copies where
  // four samples lie inside the wave (and the wave is aligned), else 4-byte
  // copies with the reflection, or zeros past the padded signal
  const float* w = wave + (size_t)b * S;
  const int n_span = L.rows * hop, q0 = t0 * hop - pad, Sp = S + 2 * pad;
  const bool vec =
      ((reinterpret_cast<uintptr_t>(w) + 4 * (intptr_t)q0) & 15) == 0;
  for (int i = 4 * tid; i < n_span; i += 4 * FB_THREADS) {
    const int q = q0 + i;
    if (vec && q >= 0 && q + 4 <= S) {
      tc_cp16(pow_s + i, w + q);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = t0 * hop + i + j;
        int r = p - pad;
        if (r < 0) r = -r;
        else if (r >= S) r = 2 * (S - 1) - r;
        fb_cp4(pow_s + i + j, p < Sp ? w + r : w, p < Sp);
      }
    }
  }
  tc_cp_commit();
  const int* rng = reinterpret_cast<const int*>(x + X.rng);
  for (int i = tid; i < 2 * n_mels; i += FB_THREADS) rng_s[i] = rng[i];
  tc_cp_wait();
  __syncthreads();              // the span landed, the barriers initialised
  // split into three bf16 planes, rows of hop padded to rs, four samples
  // at a time (row r = floor((i + 0.5) / (hop / 4)) is exact in f32 here)
  const int q4 = hop / 4;
  const float inv_q4 = 1.f / q4;
  for (int i = tid; i < L.rows * q4; i += FB_THREADS) {
    const int r = (int)((i + 0.5f) * inv_q4), c = (i - r * q4) * 4;
    const float4 v = *reinterpret_cast<const float4*>(pow_s + r * hop + c);
    __nv_bfloat16 h[4], m[4], l[4];
    tc_split3(v.x, h[0], m[0], l[0]);
    tc_split3(v.y, h[1], m[1], l[1]);
    tc_split3(v.z, h[2], m[2], l[2]);
    tc_split3(v.w, h[3], m[3], l[3]);
    uint2* dst = reinterpret_cast<uint2*>(a_s + r * L.rs + c);
    dst[0] = make_uint2(tc_pack(h[0], h[1]), tc_pack(h[2], h[3]));
    dst[L.plane / 4] = make_uint2(tc_pack(m[0], m[1]), tc_pack(m[2], m[3]));
    dst[L.plane / 2] = make_uint2(tc_pack(l[0], l[1]), tc_pack(l[2], l[3]));
  }
  __syncthreads();              // the planes written, the span read

  for (int pass = 0; pass < L.passes; ++pass) {
#define FB_PASS(N) \
  fb_pass<N>(L, a_s, ring, full, empty, x, pow_s, pass, hop, ks_n)
    switch (fb_ntw(L, pass)) {
      case 7: FB_PASS(7); break;
      case 6: FB_PASS(6); break;
      case 5: FB_PASS(5); break;
      case 4: FB_PASS(4); break;
      case 3: FB_PASS(3); break;
      case 2: FB_PASS(2); break;
      default: FB_PASS(1); break;
    }
#undef FB_PASS
  }
  __syncthreads();              // every power tile written, the ring free

  // mel product over each filter's nonzero bins: a warp shares one filter
  // (broadcast weights of the transposed filterbank, copied into the free
  // ring behind the output tile where it fits, else read through L1)
  const float* melt = reinterpret_cast<const float*>(x + X.melt);
  float* out_s = reinterpret_cast<float*>(ring);
  const size_t tile = tc_align((size_t)FB_TM * n_mels * 4);
  const int n_w = n_mels * n_bins;
  if (tile + (size_t)n_w * 4 <= (size_t)FB_NSTAGE * FB_STAGE) {
    float* melt_s = reinterpret_cast<float*>(ring + tile);
    for (int i = 4 * tid; i + 4 <= n_w; i += 4 * FB_THREADS)
      tc_cp16(melt_s + i, melt + i);
    for (int i = n_w / 4 * 4 + tid; i < n_w; i += FB_THREADS)
      fb_cp4(melt_s + i, melt + i, true);
    tc_cp_commit();
    tc_cp_wait();
    __syncthreads();
    melt = melt_s;
  }
  for (int i = tid; i < n_mels * 32; i += FB_THREADS) {
    const int m = i / 32, f = i % 32;   // frames f and f + 32 share weights
    const int hi = rng_s[n_mels + m];
    const float* p0 = pow_s + f * L.pb;
    const float* p1 = p0 + 32 * L.pb;
    const float* wm = melt + (size_t)m * n_bins;
    float a0 = 0.f, a1 = 0.f;
#pragma unroll 4
    for (int k = rng_s[m]; k < hi; ++k) {
      const float wk = wm[k];
      a0 = fmaf(p0[k], wk, a0);
      a1 = fmaf(p1[k], wk, a1);
    }
    out_s[f * n_mels + m] = logf(a0 + log_eps);
    out_s[(f + 32) * n_mels + m] = logf(a1 + log_eps);
  }
  __syncthreads();
  const int nf = min(FB_TM, T - t0);
  float* o = out + ((size_t)b * T + t0) * n_mels;
  for (int i = tid; i < nf * n_mels; i += FB_THREADS) o[i] = out_s[i];
}

extern "C" size_t fbank_smem_bytes(int n_fft, int hop, int n_bins,
                                   int n_mels) {
  return fb_layout(n_fft, hop, n_bins, n_mels).total;
}

extern "C" size_t fbank_scratch_bytes(int n_fft, int n_bins, int n_mels) {
  return fb_scratch(n_fft, n_bins, n_mels).total;
}

// n_fft and hop multiples of 16 (the wrapper holds them to 80); scratch a
// 16-byte aligned buffer of fbank_scratch_bytes. Launches the split, then
// the main kernel.
extern "C" int fbank_launch(const float* wave, int B, int S, int pad,
                            const float* cosw, const float* msinw,
                            const float* mel, void* scratch, float* out,
                            int T, int n_fft, int hop, int n_bins,
                            int n_mels, float log_eps, void* stream) {
  if (n_fft % 16 != 0 || hop % 16 != 0 || B <= 0 || B > 65535 || T <= 0)
    return (int)cudaErrorInvalidValue;
  const FbLayout L = fb_layout(n_fft, hop, n_bins, n_mels);
  cudaError_t e = cudaFuncSetAttribute(
      fbank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L.total);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned char* x = (unsigned char*)scratch;
  const int split_n = (n_fft / 16) * FB_PC * 16;   // a full pass
  const int split_blocks = max((split_n + 255) / 256, n_mels);
  fbank_split_kernel<<<split_blocks, 256, 0, s>>>(cosw, msinw, mel, n_fft,
                                                   hop, n_bins, n_mels, x);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T + FB_TM - 1) / FB_TM, B);
  fbank_kernel<<<grid, FB_THREADS, L.total, s>>>(
      wave, S, pad, x, mel, out, T, n_fft, hop, n_bins, n_mels, log_eps);
  return (int)cudaGetLastError();
}

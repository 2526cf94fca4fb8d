// The floor of the bf16 scans' step exchange (scan_tc.cuh), timed by
// chip_smoke.py's scan_floor phase: T rounds of nothing but the barrier and
// the exchange of h that K2-bf16 / K4-bf16 pay every step, for the two
// designs the scans could be built on: TC_GRID, one cooperative grid of
// H / U blocks with grid.sync() and h through L2, and TC_CLUSTER, one
// cluster of C blocks per group of rows with barrier.cluster and h through
// distributed shared memory. It computes nothing; it replaces no TPU kernel.
#include "scan_tc.cuh"

// The floor of the step exchange: T rounds of writing this block's slot,
// the barrier and the fetch of every slot, with no product and no
// epilogue. `sink` keeps the fetch from being optimised away.
template <int MODE>
__global__ void __launch_bounds__(TC_MAX_THREADS, 1)
    tc_floor_kernel(TcArgs a, float* sink) {
  const int rank = blockIdx.x % a.C, slot = blockIdx.x / a.C;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const TcLayout L = tc_layout(a.Hk, a.U, 1, 0, a.rows, 1, MODE);
  __nv_bfloat16* S = (__nv_bfloat16*)(tc_smem + L.s);
  float* own_s = (float*)(tc_smem + L.own);
  const int ostride = MODE == TC_CLUSTER ? a.U : a.H;
  if (MODE == TC_CLUSTER) tc_cluster_arrive();
  for (int s = 0; s < a.T; ++s) {
    const int cur = s & 1;
    if (MODE == TC_CLUSTER) tc_cluster_wait();
    else cg::this_grid().sync();
    tc_fetch<MODE>(a, own_s, S, a.Hk + 8, slot, cur);
    __syncthreads();
    float* hnew = tc_slot<MODE>(a, own_s, slot, rank, cur ^ 1);
    for (int i = threadIdx.x; i < a.rows * a.U; i += blockDim.x) {
      const int r = i / a.U, u = i - r * a.U;
      hnew[r * ostride + u] =
          __bfloat162float(S[r * (a.Hk + 8) + u]) + 1.f;
    }
    if (MODE == TC_CLUSTER) tc_cluster_arrive();
  }
  if (MODE == TC_CLUSTER) tc_cluster_wait();
  if (threadIdx.x == 0) sink[blockIdx.x] = __bfloat162float(S[a.H - 1]);
}

static void* floor_kernel(int mode) {
  return mode == TC_CLUSTER ? (void*)tc_floor_kernel<TC_CLUSTER>
                            : (void*)tc_floor_kernel<TC_GRID>;
}

// One launch of T exchange rounds for `groups` groups of `rows` rows, with
// C blocks of U = H / C units and `threads` threads each. hbuf (TC_GRID):
// 2 * groups * rows * H floats; sink: C * groups floats.
extern "C" int scan_floor_launch(float* hbuf, float* sink, int T, int H,
                                 int C, int rows, int groups, int threads,
                                 int mode, void* stream) {
  if (C <= 0 || H % C != 0 || (H / C) % 4 != 0 || rows <= 0 ||
      rows > TC_MAX_ROWS || threads <= 0 || threads > TC_MAX_THREADS ||
      threads % 32 != 0 || (mode == TC_GRID && hbuf == nullptr))
    return (int)cudaErrorInvalidValue;
  TcArgs a = {nullptr, nullptr, nullptr, nullptr, nullptr, hbuf,
              T, rows * groups, H, H / C, C, 1, 1, rows, 0, 0, 0};
  a.Hk = tc_kext(H, 1, 1);
  const size_t smem = tc_layout(a.Hk, H / C, 1, 0, rows, 1, mode).total;
  void* args[] = {(void*)&a, (void*)&sink};
  return tc_launch(floor_kernel(mode), args, C, groups, threads, smem, mode,
                   stream);
}

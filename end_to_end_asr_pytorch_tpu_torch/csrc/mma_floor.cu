// The ceiling of mma.sync m16n8k16 (bf16 operands, f32 accumulators) on
// this card, timed by chip_smoke.py's mma_floor phase: every SM runs one
// block of `warps` warps, each issuing `iters` rounds of 28 independent
// products on register operands (no loads), the shape of K1's inner loop
// (2 x 7 tiles) without its data. The hand-written tensor-core kernels
// (K1, the scans) all run on mma.sync, not on wgmma; this is their roof. It
// computes nothing; it replaces no TPU kernel.
#include <cuda_runtime.h>
#include <stdint.h>

#define MF_C 28   // independent accumulators per warp

__global__ void mma_floor_kernel(float* sink, int iters) {
  float acc[MF_C][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, 7u, 9u};
  const uint32_t b0 = 5u, b1 = 11u;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < MF_C; ++c)
      asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(acc[c][0]), "+f"(acc[c][1]), "+f"(acc[c][2]),
            "+f"(acc[c][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < MF_C; ++c)
    s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  sink[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// One launch of `sms` blocks of 32 `warps` threads; sink holds sms * 32
// warps floats. Products per launch: sms * warps * iters * MF_C.
extern "C" int mma_floor_launch(float* sink, int sms, int warps, int iters,
                                void* stream) {
  mma_floor_kernel<<<sms, 32 * warps, 0, (cudaStream_t)stream>>>(sink,
                                                                  iters);
  return (int)cudaGetLastError();
}

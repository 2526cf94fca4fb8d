// The gate activation of the recurrent scans (lstm_scan.cu, gru_scan.cu),
// and what K4's cooperative f32 forward (gru_scan.cu) needs: the block size
// and shared-memory chunk, the co-residency query and the cooperative
// launch of one persistent grid of H / U blocks (U hidden units per block,
// a template constant).
#pragma once
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#define NT 256     // threads per block
#define HS 16384   // floats of the shared-memory chunk (64 KB)

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.f / (1.f + expf(-x));
}

// The instantiation for U hidden units per block (nullptr for another U).
#define SCAN_CASES(...)                                  \
  case 1: return (void*)__VA_ARGS__(1);                  \
  case 2: return (void*)__VA_ARGS__(2);                  \
  case 4: return (void*)__VA_ARGS__(4);                  \
  case 8: return (void*)__VA_ARGS__(8);                  \
  case 16: return (void*)__VA_ARGS__(16);                \
  case 32: return (void*)__VA_ARGS__(32);                \
  case 64: return (void*)__VA_ARGS__(64);                \
  case 128: return (void*)__VA_ARGS__(128);              \
  default: return nullptr;

// Blocks of kernel `fn` with `smem` bytes of dynamic shared memory that can
// be resident at once on the whole card, into *out (0 when one block's
// shared memory does not fit).
static int scan_max_coresident(void* fn, size_t smem, int* out) {
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return (int)e;
  *out = 0;
  if (smem > (size_t)optin) return 0;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, NT, smem);
  if (e != cudaSuccess) return (int)e;
  *out = per_sm * sms;
  return 0;
}

// One cooperative launch of H / U blocks of NT threads on `stream`.
static int scan_launch(void* fn, int U, int H, size_t smem, void** args,
                       void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchCooperativeKernel(fn, dim3(H / U), dim3(NT), args, smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

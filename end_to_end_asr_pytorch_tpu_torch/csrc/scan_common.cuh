// The gate activation of the recurrent scans (lstm_scan.cu, gru_scan.cu).
#pragma once
#include <cuda_runtime.h>

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.f / (1.f + expf(-x));
}

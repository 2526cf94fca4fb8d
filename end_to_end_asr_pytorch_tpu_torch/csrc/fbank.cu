// Fused log-mel filterbank (K1) for Hopper, full f32.
//
// Replaces end_to_end_asr_pytorch_tpu/ops/pallas/fbank_kernel.py:fbank_fused.
// wave (B, S) -> out (B, T, n_mels), T = (S + 2*pad - n_fft) / hop + 1, with
// torch.stft-style center reflect padding computed from indices (no padded
// copy of the wave is made).
//
// Bound on the H100: operations. The windowed DFT is 2 * n_fft * n_bins
// multiply-adds per frame (~320 KFLOP at n_fft=400) against ~640 bytes of
// new audio per frame, far above the f32 machine balance; no tensor cores at
// full f32, so the ceiling is the 67 TFLOP/s f32 rate. The design keeps every
// intermediate on chip: one block per (64-frame tile, utterance) stages the
// tile's waveform span in shared memory once, each thread accumulates the
// real and imaginary parts of one DFT bin for 8 frames in registers (the
// window-premultiplied cos/-sin rows are streamed from L2, one load feeding
// 16 FMAs; the frame samples are shared-memory broadcasts), the power tile
// stays in shared memory for the mel product, and only log(mel + eps) is
// written. The TPU kernel's 80-sample subchunk framing is a TPU layout
// device and is not carried over: any n_fft / hop works here.
#include <cuda_runtime.h>

#define TILE_T 64
#define NTHREADS 256
#define FPT 8  // frames per thread in the DFT phase

__global__ void __launch_bounds__(NTHREADS) fbank_kernel(
    const float* __restrict__ wave, int S, int pad,
    const float* __restrict__ cosw, const float* __restrict__ msinw,
    const float* __restrict__ mel, float* __restrict__ out, int T,
    int n_fft, int hop, int n_bins, int n_mels, float log_eps) {
  extern __shared__ float smem[];
  const int span = (TILE_T - 1) * hop + n_fft;
  float* wav_s = smem;          // span samples of the padded signal
  float* pow_s = smem + span;   // TILE_T x n_bins power spectrum
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TILE_T;
  const float* w = wave + (size_t)b * S;
  const int Sp = S + 2 * pad;

  for (int i = threadIdx.x; i < span; i += NTHREADS) {
    const int p = t0 * hop + i;  // index into the reflect-padded signal
    float v = 0.f;
    if (p < Sp) {
      int q = p - pad;
      if (q < 0) q = -q;
      else if (q >= S) q = 2 * (S - 1) - q;
      v = w[q];
    }
    wav_s[i] = v;
  }
  __syncthreads();

  const int n_groups = TILE_T / FPT;
  for (int task = threadIdx.x; task < n_groups * n_bins; task += NTHREADS) {
    const int k = task % n_bins;
    const int g = task / n_bins;
    float re[FPT], im[FPT];
#pragma unroll
    for (int j = 0; j < FPT; ++j) { re[j] = 0.f; im[j] = 0.f; }
    const float* base = wav_s + g * FPT * hop;
    for (int n = 0; n < n_fft; ++n) {
      const float c = __ldg(cosw + (size_t)n * n_bins + k);
      const float s = __ldg(msinw + (size_t)n * n_bins + k);
#pragma unroll
      for (int j = 0; j < FPT; ++j) {
        const float x = base[j * hop + n];
        re[j] = fmaf(x, c, re[j]);
        im[j] = fmaf(x, s, im[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < FPT; ++j)
      pow_s[(g * FPT + j) * n_bins + k] = re[j] * re[j] + im[j] * im[j];
  }
  __syncthreads();

  const int nf = min(TILE_T, T - t0);
  for (int task = threadIdx.x; task < nf * n_mels; task += NTHREADS) {
    const int m = task % n_mels;
    const int f = task / n_mels;
    const float* pw = pow_s + f * n_bins;
    float acc = 0.f;
    for (int k = 0; k < n_bins; ++k)
      acc = fmaf(pw[k], __ldg(mel + (size_t)k * n_mels + m), acc);
    out[((size_t)b * T + t0 + f) * n_mels + m] = logf(acc + log_eps);
  }
}

extern "C" size_t fbank_smem_bytes(int n_fft, int hop, int n_bins) {
  return (size_t)((TILE_T - 1) * hop + n_fft + TILE_T * n_bins) * sizeof(float);
}

extern "C" int fbank_launch(const float* wave, int B, int S, int pad,
                            const float* cosw, const float* msinw,
                            const float* mel, float* out, int T, int n_fft,
                            int hop, int n_bins, int n_mels, float log_eps,
                            void* stream) {
  const size_t smem = fbank_smem_bytes(n_fft, hop, n_bins);
  cudaError_t e = cudaFuncSetAttribute(
      fbank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T + TILE_T - 1) / TILE_T, B);
  fbank_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      wave, S, pad, cosw, msinw, mel, out, T, n_fft, hop, n_bins, n_mels,
      log_eps);
  return (int)cudaGetLastError();
}

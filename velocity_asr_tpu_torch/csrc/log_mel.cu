// Fused log-mel: window-folded DFT, power, HTK mel filterbank, log.
//
// Replaces: velocity_asr_tpu/ops/mel_pallas.py `_mel_kernel`, launched by
// `_mel_spectrogram_pallas_jit`.
//
// Computes, per frame r of n_fft samples (already reflect-padded and
// framed by the caller):
//   re = frames[r] @ dft_real, im = frames[r] @ dft_imag   (n_fft -> n_freq)
//   out[r] = log((re^2 + im^2) @ fb_t + 1e-10)            (n_freq -> n_mels)
// where dft_real/dft_imag fold in the periodic Hann window. Everything is
// true fp32 FMAs: no TF32 and no tensor cores.
//
// What bounds it on an H100: fp32 operations. A frame costs
// 4*400*201 + 2*201*80 ~ 354 kFLOP against 1.6 kB read and 320 B
// written, about 180 FLOP per byte where the fp32 ridge is 20 (67 TFLOP/s
// over 3.35 TB/s); at the main path's few hundred frames the grid is
// also too small to fill the card.
//
// What the design does about that: a block takes kFrames frames into
// shared memory and each thread owns one frequency bin, so a DFT row
// read once from device memory (or L2) feeds 2*kFrames FMAs from
// registers. The (kFrames, n_freq) power spectrum stays in shared memory
// and never goes to device memory; the mel product and the log read it
// from there, one output (frame, mel) per thread.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFrames = 16;  // frames per block

__global__ void __launch_bounds__(kThreads) log_mel_kernel(
    const float* __restrict__ frames, const float* __restrict__ dft_real,
    const float* __restrict__ dft_imag, const float* __restrict__ fb_t,
    float* __restrict__ out, int n_frames, int n_fft, int n_freq, int n_mels) {
  extern __shared__ float smem[];
  float* s_frames = smem;                   // (kFrames, n_fft)
  float* s_power = smem + kFrames * n_fft;  // (kFrames, n_freq)
  const int r0 = blockIdx.x * kFrames;
  const int rows = min(kFrames, n_frames - r0);

  for (int i = threadIdx.x; i < kFrames * n_fft; i += kThreads) {
    const int r = i / n_fft;
    s_frames[i] = r < rows ? frames[static_cast<size_t>(r0) * n_fft + i] : 0.f;
  }
  __syncthreads();

  for (int f = threadIdx.x; f < n_freq; f += kThreads) {
    float re[kFrames], im[kFrames];
#pragma unroll
    for (int r = 0; r < kFrames; ++r) re[r] = im[r] = 0.f;
#pragma unroll 4
    for (int k = 0; k < n_fft; ++k) {
      const float cr = dft_real[static_cast<size_t>(k) * n_freq + f];
      const float ci = dft_imag[static_cast<size_t>(k) * n_freq + f];
#pragma unroll
      for (int r = 0; r < kFrames; ++r) {
        const float v = s_frames[r * n_fft + k];
        re[r] = fmaf(v, cr, re[r]);
        im[r] = fmaf(v, ci, im[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kFrames; ++r)
      s_power[r * n_freq + f] = re[r] * re[r] + im[r] * im[r];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < rows * n_mels; i += kThreads) {
    const int r = i / n_mels, m = i % n_mels;
    float acc = 0.f;
    for (int f = 0; f < n_freq; ++f)
      acc = fmaf(s_power[r * n_freq + f], fb_t[static_cast<size_t>(f) * n_mels + m], acc);
    out[static_cast<size_t>(r0 + r) * n_mels + m] = logf(acc + 1e-10f);
  }
}

}  // namespace

extern "C" cudaError_t log_mel_f32(const float* frames,
                                   const float* dft_real,
                                   const float* dft_imag, const float* fb_t,
                                   float* out, int n_frames, int n_fft,
                                   int n_freq, int n_mels,
                                   cudaStream_t stream) {
  if (n_frames <= 0 || n_fft <= 0 || n_freq <= 0 || n_mels <= 0)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * kFrames * (n_fft + n_freq);
  cudaError_t err = cudaFuncSetAttribute(
      log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (n_frames + kFrames - 1) / kFrames;
  log_mel_kernel<<<blocks, kThreads, smem, stream>>>(
      frames, dft_real, dft_imag, fb_t, out, n_frames, n_fft, n_freq, n_mels);
  return cudaGetLastError();
}

// Fused log-mel: framing, periodic Hann window, 400-point real FFT, power,
// sparse HTK mel filterbank, log.
//
// Replaces: velocity_asr_tpu/ops/mel_pallas.py `_mel_kernel`, launched by
// `_mel_spectrogram_pallas_jit`.
//
// Computes, for every frame t of every row b of the reflect-padded signal
// (batch, padded_len) fp32, x = padded[b, t * hop : t * hop + 400]:
//   X[k]   = sum_n window[n] x[n] exp(-2 pi i k n / 400),  k = 0..200
//   out[b, t, m] = log(sum_k fb[m, k] |X[k]|^2 + 1e-10)
// in fp32 IEEE arithmetic (logf; no fast math, no tensor cores).
//
// What bounds it on an H100: device-memory bytes. The least work per
// frame is a real FFT (~2.5 * 400 * log2(400) ~ 8.6 kFLOP), 3 * 201 for
// the power, 2 * 393 for the filterbank's nonzeros and 80 logs, against
// 640 B of new audio (hop 160) and 320 B of output: about 11 FLOP per
// byte, under the fp32 ridge of 20 (67 TFLOP/s over 3.35 TB/s).
//
// What the design does about that:
// - One warp owns a frame and reads its 400 samples straight from the
//   padded signal (neighbouring frames overlap in L1/L2), so the framed
//   (frames, 400) matrix is never written to device memory; the window
//   is applied on load. Output rows are written once, coalesced.
// - The real 400-point transform is a 200-point complex FFT of
//   z[n] = x[2n] + i x[2n+1] (the windowed frame as it lies in shared
//   memory, read as float2), then the split X[k] = E[k] + W400^k O[k]
//   with E, O the even and odd samples' transforms recovered from Z[k]
//   and conj(Z[200 - k]). 200 = 8 * 5 * 5: a radix-8 stage (25 tasks:
//   n = 25 n1 + n2), then two radix-5 stages (40 tasks each), each stage
//   a small direct DFT in registers followed by its twiddle, ping-ponging
//   between two shared buffers of the warp. The three stages need no
//   bit reversal (the index maps are written out). 8 * 5 * 5 rather than
//   2^3 * 5^2 in radix-2 steps: three passes over shared memory instead
//   of five, and each pass has 25-40 independent tasks for 32 lanes.
// - Every twiddle comes from one table of W400^j = cos - i sin(2 pi j /
//   400), j < 400, built on the host in float64 and rounded to fp32
//   (W200^j = W400^2j, W8 = W400^50, W5 = W400^80, W25 = W400^16), kept
//   in shared memory with the window.
// - The filterbank is a band table built on the host from
//   audio.mel_filterbank: per band its first bin and its run of nonzero
//   weights (1-14 bins each, 393 in all at 80 bands), so the mel sum is
//   393 FMAs per frame, not a dense 201 x 80 product.
// - Enough warps for one utterance: 4 frames (warps) a block, so 400
//   frames are 100 blocks; a longer batch runs a grid of one wave of
//   resident blocks whose warps walk the frames in strides, loading the
//   tables once per block.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kFft = 400;            // n_fft: the kernel's transform size
constexpr int kHalf = kFft / 2;      // complex points of the packed FFT
constexpr int kWarps = 4;            // frames in flight per block
constexpr int kThreads = 32 * kWarps;

struct Layout {
  // byte offsets into dynamic shared memory (float2 arrays first)
  size_t twiddle, buffers, window, weight, first, offset, bytes;
};

__host__ __device__ inline Layout layout(int n_mels, int n_weights) {
  Layout l;
  l.twiddle = 0;                                          // float2[kFft]
  l.buffers = l.twiddle + sizeof(float2) * kFft;          // float2[kWarps][2][kHalf]
  l.window = l.buffers + sizeof(float2) * kWarps * 2 * kHalf;  // float[kFft]
  l.weight = l.window + sizeof(float) * kFft;             // float[n_weights]
  l.first = l.weight + sizeof(float) * n_weights;         // int[n_mels]
  l.offset = l.first + sizeof(int) * n_mels;              // int[n_mels + 1]
  l.bytes = l.offset + sizeof(int) * (n_mels + 1);
  return l;
}

// a * w with w = W^j stored as (cos, sin): (cos - i sin) * a
__device__ __forceinline__ float2 twiddle_mul(float2 a, float2 w) {
  return make_float2(fmaf(a.x, w.x, a.y * w.y), fmaf(a.y, w.x, -a.x * w.y));
}

// acc + a * w, w as in twiddle_mul
__device__ __forceinline__ float2 twiddle_mac(float2 acc, float2 a, float2 w) {
  acc.x = fmaf(a.x, w.x, fmaf(a.y, w.y, acc.x));
  acc.y = fmaf(a.y, w.x, fmaf(-a.x, w.y, acc.y));
  return acc;
}

__global__ void __launch_bounds__(kThreads) log_mel_kernel(
    const float* __restrict__ padded, const float* __restrict__ window,
    const float2* __restrict__ twiddle, const int* __restrict__ band_first,
    const int* __restrict__ band_offset, const float* __restrict__ band_weight,
    float* __restrict__ out, int batch, int padded_len, int n_frames, int hop,
    int n_mels, int n_weights) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout l = layout(n_mels, n_weights);
  float2* s_tw = reinterpret_cast<float2*>(smem + l.twiddle);
  float* s_win = reinterpret_cast<float*>(smem + l.window);
  float* s_w = reinterpret_cast<float*>(smem + l.weight);
  int* s_first = reinterpret_cast<int*>(smem + l.first);
  int* s_off = reinterpret_cast<int*>(smem + l.offset);

  for (int i = threadIdx.x; i < kFft; i += kThreads) {
    s_tw[i] = twiddle[i];
    s_win[i] = window[i];
  }
  for (int i = threadIdx.x; i < n_weights; i += kThreads) s_w[i] = band_weight[i];
  for (int i = threadIdx.x; i < n_mels; i += kThreads) s_first[i] = band_first[i];
  for (int i = threadIdx.x; i <= n_mels; i += kThreads) s_off[i] = band_offset[i];
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  float2* za = reinterpret_cast<float2*>(smem + l.buffers) + warp * 2 * kHalf;
  float2* zb = za + kHalf;
  float2 w8[8], w5[5];
#pragma unroll
  for (int m = 0; m < 8; ++m) w8[m] = s_tw[50 * m];   // W8^m = W400^(50 m)
#pragma unroll
  for (int m = 0; m < 5; ++m) w5[m] = s_tw[80 * m];   // W5^m = W400^(80 m)

  const int rows = batch * n_frames;
  for (int r = blockIdx.x * kWarps + warp; r < rows; r += gridDim.x * kWarps) {
    const int b = r / n_frames;
    const int t = r - b * n_frames;
    const float* src = padded + static_cast<size_t>(b) * padded_len + static_cast<size_t>(t) * hop;
    float* zf = reinterpret_cast<float*>(za);
    __syncwarp();  // the previous frame's mel sums have read za
    // the windowed frame; as float2, z[n] = x[2n] + i x[2n+1]
    for (int n = lane; n < kFft; n += 32) zf[n] = src[n] * s_win[n];
    __syncwarp();

    // radix 8 over n1 (n = 25 n1 + n2), then W200^(n2 k1): zb[k1 * 25 + n2]
    if (lane < 25) {
      const int n2 = lane;
      float2 a[8];
#pragma unroll
      for (int n1 = 0; n1 < 8; ++n1) a[n1] = za[25 * n1 + n2];
#pragma unroll
      for (int k1 = 0; k1 < 8; ++k1) {
        float2 y = make_float2(0.f, 0.f);
#pragma unroll
        for (int n1 = 0; n1 < 8; ++n1) y = twiddle_mac(y, a[n1], w8[(n1 * k1) % 8]);
        zb[k1 * 25 + n2] = twiddle_mul(y, s_tw[2 * n2 * k1]);
      }
    }
    __syncwarp();

    // radix 5 over a (n2 = 5 a + bb), then W25^(bb c): za[k1 * 25 + bb * 5 + c]
    for (int task = lane; task < 40; task += 32) {
      const int k1 = task / 5, bb = task % 5;
      float2 v[5];
#pragma unroll
      for (int a = 0; a < 5; ++a) v[a] = zb[k1 * 25 + 5 * a + bb];
#pragma unroll
      for (int c = 0; c < 5; ++c) {
        float2 u = make_float2(0.f, 0.f);
#pragma unroll
        for (int a = 0; a < 5; ++a) u = twiddle_mac(u, v[a], w5[(a * c) % 5]);
        za[k1 * 25 + bb * 5 + c] = twiddle_mul(u, s_tw[16 * bb * c]);
      }
    }
    __syncwarp();

    // radix 5 over bb: Z[k1 + 8 c + 40 d] into zb, in natural order
    for (int task = lane; task < 40; task += 32) {
      const int k1 = task / 5, c = task % 5;
      float2 v[5];
#pragma unroll
      for (int bb = 0; bb < 5; ++bb) v[bb] = za[k1 * 25 + bb * 5 + c];
#pragma unroll
      for (int d = 0; d < 5; ++d) {
        float2 z = make_float2(0.f, 0.f);
#pragma unroll
        for (int bb = 0; bb < 5; ++bb) z = twiddle_mac(z, v[bb], w5[(bb * d) % 5]);
        zb[k1 + 8 * c + 40 * d] = z;
      }
    }
    __syncwarp();

    // the real split and the power spectrum, into za as floats
    float* power = reinterpret_cast<float*>(za);
    for (int k = lane; k <= kHalf; k += 32) {
      const float2 zk = zb[k % kHalf];
      const float2 zc = zb[(kHalf - k) % kHalf];  // conjugated below
      const float2 e = make_float2(0.5f * (zk.x + zc.x), 0.5f * (zk.y - zc.y));
      // O = -i (Z[k] - conj(Z[200 - k])) / 2
      const float2 o = make_float2(0.5f * (zk.y + zc.y), -0.5f * (zk.x - zc.x));
      const float2 wo = twiddle_mul(o, s_tw[k]);
      const float re = e.x + wo.x, im = e.y + wo.y;
      power[k] = fmaf(re, re, im * im);
    }
    __syncwarp();

    float* dst = out + static_cast<size_t>(r) * n_mels;
    for (int m = lane; m < n_mels; m += 32) {
      const int f0 = s_first[m], o0 = s_off[m], o1 = s_off[m + 1];
      float acc = 0.f;
      for (int i = o0; i < o1; ++i) acc = fmaf(s_w[i], power[f0 + i - o0], acc);
      dst[m] = logf(acc + 1e-10f);
    }
  }
}

// Resident blocks per SM and SMs of the current device, cached for the
// last (device, shared bytes) asked about.
cudaError_t grid_limit(size_t smem, int* blocks) {
  static int cached_device = -1, cached_blocks = 0;
  static size_t cached_smem = 0;
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device != cached_device || smem != cached_smem) {
    int sms, per_sm;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, log_mel_kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    cached_device = device;
    cached_smem = smem;
    cached_blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  *blocks = cached_blocks;
  return cudaSuccess;
}

}  // namespace

// Log-mel of every frame of `padded` (batch, padded_len) fp32, the
// reflect-padded signal: out (batch, n_frames, n_mels) fp32 with
// n_frames = 1 + (padded_len - 400) / hop. `window` (400,) is the
// periodic Hann window, `twiddle` (400, 2) holds cos and sin of
// 2 pi j / 400, and the band table `band_first` (n_mels,),
// `band_offset` (n_mels + 1,) int32 and `band_weight` (n_weights,) fp32
// gives band m's weights band_weight[band_offset[m]:band_offset[m + 1]]
// on the bins from band_first[m] on. One launch on `stream`.
extern "C" cudaError_t log_mel_f32(const float* padded, const float* window,
                                   const float* twiddle, const int* band_first,
                                   const int* band_offset,
                                   const float* band_weight, float* out,
                                   int batch, int padded_len, int n_frames,
                                   int hop, int n_mels, int n_weights,
                                   cudaStream_t stream) {
  if (batch <= 0 || n_frames <= 0 || hop <= 0 || n_mels <= 0 || n_weights <= 0 ||
      static_cast<long long>(n_frames - 1) * hop + kFft > padded_len)
    return cudaErrorInvalidValue;
  const size_t smem = layout(n_mels, n_weights).bytes;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int limit;
  cudaError_t err = grid_limit(smem, &limit);
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(batch) * n_frames;
  const long long wanted = (rows + kWarps - 1) / kWarps;
  const int blocks = static_cast<int>(wanted < limit ? wanted : limit);
  log_mel_kernel<<<blocks, kThreads, smem, stream>>>(
      padded, window, reinterpret_cast<const float2*>(twiddle), band_first, band_offset,
      band_weight, out, batch, padded_len, n_frames, hop, n_mels, n_weights);
  return cudaGetLastError();
}

// What the build gave log_mel_f32's kernel for a band table of n_mels
// bands and n_weights weights: out = {registers per thread, local
// (spill) bytes per thread, dynamic shared bytes per block, resident
// blocks per SM, threads per block}.
extern "C" cudaError_t log_mel_occupancy(int n_mels, int n_weights, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, log_mel_kernel);
  if (err != cudaSuccess) return err;
  const size_t smem = layout(n_mels, n_weights).bytes;
  int per_sm;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, log_mel_kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(smem);
  out[3] = per_sm;
  out[4] = kThreads;
  return cudaSuccess;
}

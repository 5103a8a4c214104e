// Int8 dense: symmetric int8 activations (one scale per row, or one
// calibrated scale per tensor) against per-output-channel int8 weights.
//
// Replaces: velocity_asr_tpu/ops/int8_matmul.py `_int8_dynamic_kernel`
// (int8_dense_dynamic_f32) and `_int8_kernel` (int8_dense_static_f32),
// both launched by `int8_dot_pallas`.
//
// Computes, for x (M, K) fp32, codes w_q (N, K) int8 (torch's Linear
// layout, contiguous in K) and w_scale (N,) fp32:
//   s[m]     = max(max_k |x[m,k]| / 127, 1e-10)        (dynamic), or
//              the device scalar *x_scale                (static)
//   q[m,k]   = clamp(rint(x[m,k] / s[m]), -127, 127)     (half to even)
//   out[m,n] = float(sum_k q[m,k] * w_q[n,k]) * (s[m] * w_scale[n])
// which is the arithmetic of `int8_dot_xla` (int8_matmul.py:43-67), the
// function the JAX package computes for every projection of the synth
// checkpoint. rintf rounds half to even as jnp.round does (roundf would
// round half away from zero); the division is IEEE (no fast math).
//
// What bounds it on an H100: bytes. At the main path's shapes (M = 16 to
// 6400 rows, K = 48 to 384, N = 30 to 192) a call reads x in fp32 and
// writes out in fp32 against 2*K int8 operations per output, far below
// the int8 ridge of ~590 operations per byte (1,979 TOP/s over
// 3.35 TB/s). At batch 1 the grid is also too small to fill the card.
//
// What the design does about that: it keeps everything between x and
// out on chip and does each step once. A block owns kRows rows and
// every output channel. A warp per row takes the row's |x| max with a
// shuffle reduction; the block then quantizes its rows over all of K
// into int8 codes in shared memory (4 per 32-bit word), once, and keeps
// them while it walks N in tiles of kCols channels. For each tile it
// stages the weight codes kChunk at a time beside them, and each thread
// accumulates a 2x4 tile of outputs in int32 with __dp4a (4 int8
// products per instruction). x and the weight codes are read 16 bytes
// at a time where K and the pointers allow it, so few loads wait on
// memory in turn. Shared rows are padded to an odd number of words, so
// the 16 weight rows (and the 2 code rows) that a warp reads at once
// fall in different banks. The K tail (K not a multiple of 4 or of
// kChunk) is zero codes on both sides. The codes of kRows rows and a
// weight stage fit in a block's default 48 KB of shared memory for K up
// to 1,012 (every projection of the repo's configs has K <= 384); the
// launcher refuses a larger K. x_q_out, when given, receives the codes,
// a check that the kernel quantizes as the plain version does. wgmma's
// s8 path and TMA are left for a later version.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;                // rows of x (and out) per block
constexpr int kCols = 64;                // output channels per N tile
constexpr int kChunk = 256;              // weight codes of K per stage
constexpr int kWords = kChunk / 4;       // 32-bit words per staged row
constexpr int kStride = kWords + 1;      // odd: no bank conflicts
constexpr int kTx = 16;                  // threads along N
constexpr int kTy = kThreads / kTx;      // threads along M
constexpr int kMicroM = kRows / kTy;     // 2 rows per thread
constexpr int kMicroN = kCols / kTx;                // 4 columns per thread
constexpr int kStaticSmem = (kCols * kStride + kRows) * 4;

__device__ __forceinline__ int quantize(float v, float scale) {
  return static_cast<int>(fminf(fmaxf(rintf(v / scale), -127.f), 127.f));
}

__device__ __forceinline__ float abs_max4(float4 v) {
  return fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
}

// 32-bit words a row of K codes takes in shared memory: odd, so rows
// that a warp reads at once fall in different banks.
__host__ __device__ __forceinline__ int code_stride(int K) {
  return ((K + 3) / 4) | 1;
}

template <bool kStatic>
__global__ void __launch_bounds__(kThreads) int8_dense_kernel(
    const float* __restrict__ x, const float* __restrict__ x_scale,
    const int8_t* __restrict__ w_q, const float* __restrict__ w_scale,
    float* __restrict__ out, int8_t* __restrict__ x_q_out, int M, int K,
    int N) {
  extern __shared__ int s_xq[];  // kRows rows of code_stride(K) words
  __shared__ int s_wq[kCols][kStride];
  __shared__ float s_scale[kRows];

  const int m0 = blockIdx.x * kRows;
  const int words = (K + 3) / 4;
  const int stride = code_stride(K);
  // 16-byte loads of x (4 values) and of w_q (16 codes) where aligned
  const bool x_vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool w_vec = K % 16 == 0 && reinterpret_cast<uintptr_t>(w_q) % 16 == 0;

  // 1. One activation scale per row.
  if (kStatic) {
    if (threadIdx.x < kRows) s_scale[threadIdx.x] = *x_scale;
  } else {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
    for (int r = warp; r < kRows; r += kThreads / 32) {
      const int m = m0 + r;
      float amax = 0.f;
      if (m < M) {
        const float* row = x + static_cast<size_t>(m) * K;
        if (x_vec) {
          const float4* row4 = reinterpret_cast<const float4*>(row);
#pragma unroll 4
          for (int k4 = lane; k4 < K / 4; k4 += 32) amax = fmaxf(amax, abs_max4(row4[k4]));
        } else {
#pragma unroll 4
          for (int k = lane; k < K; k += 32) amax = fmaxf(amax, fabsf(row[k]));
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
      if (lane == 0) s_scale[r] = fmaxf(amax / 127.f, 1e-10f);
    }
  }
  __syncthreads();

  // 2. The rows' codes over all of K, 4 to a word, once.
#pragma unroll 2
  for (int i = threadIdx.x; i < kRows * words; i += kThreads) {
    const int r = i / words, w = i % words;
    const int m = m0 + r;
    unsigned packed = 0;
    if (m < M) {
      const size_t off = static_cast<size_t>(m) * K + 4 * w;
      float v[4];
      if (x_vec) {
        const float4 f = *reinterpret_cast<const float4*>(x + off);
        v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = 4 * w + e < K ? x[off + e] : 0.f;
      }
      const float s = s_scale[r];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (4 * w + e < K) {
          const int q = quantize(v[e], s);
          if (x_q_out != nullptr) x_q_out[off + e] = static_cast<int8_t>(q);
          packed |= (static_cast<unsigned>(q) & 0xffu) << (8 * e);
        }
      }
    }
    s_xq[r * stride + w] = static_cast<int>(packed);
  }

  const int tx = threadIdx.x % kTx, ty = threadIdx.x / kTx;
  for (int n0 = 0; n0 < N; n0 += kCols) {
    int acc[kMicroM][kMicroN] = {};
    for (int w0 = 0; w0 < words; w0 += kWords) {
      const int n_words = min(kWords, words - w0);
      __syncthreads();  // codes written; the previous stage consumed

      // 3. This tile's weight codes for words [w0, w0 + n_words).
      if (w_vec) {
#pragma unroll 4
        for (int i = threadIdx.x; i < kCols * (kWords / 4); i += kThreads) {
          const int c = i / (kWords / 4), w = 4 * (i % (kWords / 4));
          const int n = n0 + c;
          uint4 packed = make_uint4(0u, 0u, 0u, 0u);
          if (n < N && w < n_words)
            packed = *reinterpret_cast<const uint4*>(
                w_q + static_cast<size_t>(n) * K + 4 * (w0 + w));
          s_wq[c][w] = static_cast<int>(packed.x);
          s_wq[c][w + 1] = static_cast<int>(packed.y);
          s_wq[c][w + 2] = static_cast<int>(packed.z);
          s_wq[c][w + 3] = static_cast<int>(packed.w);
        }
      } else {
        for (int i = threadIdx.x; i < kCols * kWords; i += kThreads) {
          const int c = i / kWords, w = i % kWords;
          const int n = n0 + c;
          const int k = 4 * (w0 + w);
          unsigned packed = 0;
          if (n < N && w < n_words) {
            const int8_t* row = w_q + static_cast<size_t>(n) * K;
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (k + e < K)
                packed |= static_cast<unsigned>(static_cast<uint8_t>(row[k + e]))
                          << (8 * e);
          }
          s_wq[c][w] = static_cast<int>(packed);
        }
      }
      __syncthreads();

      // 4. int32 sums of 4 int8 products per __dp4a.
#pragma unroll 8
      for (int w = 0; w < n_words; ++w) {
        int a[kMicroM], b[kMicroN];
#pragma unroll
        for (int i = 0; i < kMicroM; ++i) a[i] = s_xq[(ty + kTy * i) * stride + w0 + w];
#pragma unroll
        for (int j = 0; j < kMicroN; ++j) b[j] = s_wq[tx + kTx * j][w];
#pragma unroll
        for (int i = 0; i < kMicroM; ++i)
#pragma unroll
          for (int j = 0; j < kMicroN; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
      }
    }

    // 5. Dequantize: float(acc) * (s[m] * w_scale[n]), int8_dot_xla's order.
#pragma unroll
    for (int i = 0; i < kMicroM; ++i) {
      const int r = ty + kTy * i;
      const int m = m0 + r;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < kMicroN; ++j) {
        const int n = n0 + tx + kTx * j;
        if (n < N)
          out[static_cast<size_t>(m) * N + n] =
              static_cast<float>(acc[i][j]) * (s_scale[r] * w_scale[n]);
      }
    }
  }
}

template <bool kStatic>
cudaError_t launch(const float* x, const float* x_scale, const int8_t* w_q,
                   const float* w_scale, float* out, int8_t* x_q_out, int M,
                   int K, int N, cudaStream_t stream) {
  if (M <= 0 || K <= 0 || N <= 0) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(kRows) * code_stride(K) * 4;
  // a block's codes and weight stage within the default 48 KB: K <= 1012
  if (smem + kStaticSmem > 48 * 1024) return cudaErrorInvalidValue;
  const dim3 grid((M + kRows - 1) / kRows);
  int8_dense_kernel<kStatic><<<grid, kThreads, smem, stream>>>(
      x, x_scale, w_q, w_scale, out, x_q_out, M, K, N);
  return cudaGetLastError();
}

}  // namespace

// out (M, N) = dequantized int8 product of x (M, K) with per-row dynamic
// scales. x_q_out, when not null, receives x's (M, K) int8 codes.
extern "C" cudaError_t int8_dense_dynamic_f32(const float* x, const int8_t* w_q,
                                              const float* w_scale, float* out,
                                              int8_t* x_q_out, int M, int K,
                                              int N, cudaStream_t stream) {
  return launch<false>(x, nullptr, w_q, w_scale, out, x_q_out, M, K, N, stream);
}

// The same with one activation scale, read on the device from x_scale, so
// the host never waits for it.
extern "C" cudaError_t int8_dense_static_f32(const float* x, const float* x_scale,
                                             const int8_t* w_q,
                                             const float* w_scale, float* out,
                                             int8_t* x_q_out, int M, int K,
                                             int N, cudaStream_t stream) {
  return launch<true>(x, x_scale, w_q, w_scale, out, x_q_out, M, K, N, stream);
}

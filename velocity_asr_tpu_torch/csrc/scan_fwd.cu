// Selective-scan forward for the offline SSM blocks.
//
// Replaces: velocity_asr_tpu/ops/scan_pallas.py `_make_fwd_kernel`
// (save_bounds=False, with_state=False), launched by `_pallas_scan_fwd`.
//
// Computes, in fp32, per batch element b and channel d:
//   h[t] = exp(dt[t,d] * A) * h[t-1] + B[t] * (dt[t,d] * x[t,d]),  h[-1] = 0
//   y[t,d] = sum_n C[t,n] * h[t,n,d]
// with x, dt, y (batch, L, D), B, C (batch, L, N), A (N,). The D*x skip
// is added by the caller, as on the TPU.
//
// What bounds it on an H100: not bytes and not FLOPs but the serial chain
// over t. At the main path's shapes (batch 1, D=384, L=100..300) the
// inputs are ~1.5 MB and ~50 MFLOP, a microsecond of work for the card,
// while every step of the recurrence depends on the one before.
//
// What the design does about that: it spreads the independent work as
// wide as the recurrence allows. Each channel's states are split over G
// lanes of one warp (S states per thread, kept in registers), so a step
// costs a thread S exps and 2S FMAs, and the y reduction over n is a
// G-lane butterfly of shuffles. B[t] and C[t] for a tile of time steps
// are staged once per block in shared memory (lane g owns states
// n = j*G + g, so neighbouring lanes read neighbouring banks); x and dt
// are staged beside them. Each input is read once from device memory and
// y is written once; the (batch, L, D, N) state never leaves registers.
// expf is the IEEE one: no fast math.
//
// Any state size N >= 1 runs. The launcher picks the narrowest (G, S)
// with G*S >= N, up to G*S = 256 (G=32 lanes of 8 states); states past N
// get A = B = C = 0, so they stay 0 and add nothing. Above 256 the block
// walks the states in passes of 256, each a full sweep over t that adds
// its part of y (the states of one channel are independent).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;  // threads per block

template <int G, int S>  // G lanes share one channel, S states per lane
__global__ void __launch_bounds__(kThreads) scan_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ Bm,
    const float* __restrict__ Cm, float* __restrict__ y, int L, int D,
    int N) {
  constexpr int NP = G * S;  // states per pass
  // Time steps staged per tile: 32, fewer for the widest passes, so that
  // B and C stay within 16 KB of static shared memory.
  constexpr int kTile = NP <= 64 ? 32 : 2048 / NP;
  constexpr int kChannels = kThreads / G;  // channels per block
  __shared__ float s_B[kTile][NP];
  __shared__ float s_C[kTile][NP];
  __shared__ float s_x[kTile][kChannels];
  __shared__ float s_dt[kTile][kChannels];

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kChannels;
  const int c = threadIdx.x / G;  // channel within the block
  const int g = threadIdx.x % G;  // this lane owns states n0 + j*G + g
  const int d = d0 + c;
  const size_t seq_d = static_cast<size_t>(b) * L * D;
  const size_t seq_n = static_cast<size_t>(b) * L * N;

  for (int n0 = 0; n0 < N; n0 += NP) {
    const int live = min(NP, N - n0);  // states of this pass below N
    float a[S], h[S];
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const int n = j * G + g;
      a[j] = n < live ? A[n0 + n] : 0.f;
      h[j] = 0.f;
    }

    for (int t0 = 0; t0 < L; t0 += kTile) {
      const int steps = min(kTile, L - t0);
      __syncthreads();  // the previous tile is consumed
      for (int i = threadIdx.x; i < kTile * NP; i += kThreads) {
        const int tt = i / NP, n = i % NP;
        const bool ok = tt < steps && n < live;
        const size_t off = seq_n + static_cast<size_t>(t0 + tt) * N + n0 + n;
        s_B[tt][n] = ok ? Bm[off] : 0.f;
        s_C[tt][n] = ok ? Cm[off] : 0.f;
      }
      for (int i = threadIdx.x; i < kTile * kChannels; i += kThreads) {
        const int tt = i / kChannels, cc = i % kChannels;
        const bool ok = tt < steps && d0 + cc < D;
        const size_t off = seq_d + static_cast<size_t>(t0 + tt) * D + d0 + cc;
        s_x[tt][cc] = ok ? x[off] : 0.f;
        s_dt[tt][cc] = ok ? dt[off] : 0.f;
      }
      __syncthreads();

      for (int tt = 0; tt < steps; ++tt) {
        const float delta = s_dt[tt][c];
        const float u = delta * s_x[tt][c];
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < S; ++j) {
          const int n = j * G + g;
          h[j] = expf(delta * a[j]) * h[j] + s_B[tt][n] * u;
          acc += s_C[tt][n] * h[j];
        }
        // Every lane of the warp takes part, also those past D (they
        // hold zeros), so the full mask is exact.
#pragma unroll
        for (int off = G / 2; off > 0; off >>= 1)
          acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (g == 0 && d < D) {
          float& out = y[seq_d + static_cast<size_t>(t0 + tt) * D + d];
          out = n0 == 0 ? acc : out + acc;  // the thread's own earlier write
        }
      }
    }
  }
}

template <int G, int S>
cudaError_t launch(const float* x, const float* dt, const float* A,
                   const float* B, const float* C, float* y, int batch,
                   int L, int D, int N, cudaStream_t stream) {
  constexpr int kChannels = kThreads / G;
  dim3 grid((D + kChannels - 1) / kChannels, batch);
  scan_fwd_kernel<G, S><<<grid, kThreads, 0, stream>>>(x, dt, A, B, C, y, L,
                                                        D, N);
  return cudaGetLastError();
}

}  // namespace

// Any N >= 1: the narrowest (lanes G, states per lane S) with G*S >= N,
// and passes of 256 states beyond that. N = 16, 32 and 64 (the repo's
// model configs) fill their lanes exactly. Returns cudaErrorInvalidValue
// for an empty or negative size and otherwise the launch's error code.
extern "C" cudaError_t scan_fwd_f32(const float* x, const float* dt,
                                    const float* A, const float* B,
                                    const float* C, float* y, int batch,
                                    int L, int D, int N, cudaStream_t stream) {
  if (batch <= 0 || L <= 0 || D <= 0 || N <= 0) return cudaErrorInvalidValue;
  if (N <= 4) return launch<1, 4>(x, dt, A, B, C, y, batch, L, D, N, stream);
  if (N <= 8) return launch<1, 8>(x, dt, A, B, C, y, batch, L, D, N, stream);
  if (N <= 16) return launch<2, 8>(x, dt, A, B, C, y, batch, L, D, N, stream);
  if (N <= 32) return launch<4, 8>(x, dt, A, B, C, y, batch, L, D, N, stream);
  if (N <= 64) return launch<8, 8>(x, dt, A, B, C, y, batch, L, D, N, stream);
  if (N <= 128) return launch<16, 8>(x, dt, A, B, C, y, batch, L, D, N, stream);
  return launch<32, 8>(x, dt, A, B, C, y, batch, L, D, N, stream);
}

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
// wide as the recurrence allows. Each channel's N states are split over G
// lanes of one warp (N/G = 8 states per thread, kept in registers), so a
// step costs a thread 8 exps and 16 FMAs, and the y reduction over n is
// a G-lane butterfly of shuffles. B[t] and C[t] for a tile of time steps
// are staged once per block in shared memory (lane g owns states
// n = j*G + g, so neighbouring lanes read neighbouring banks); x and dt
// are staged beside them. Each input is read once from device memory and
// y is written once; the (batch, L, D, N) state never leaves registers.
// expf is the IEEE one: no fast math.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;          // threads per block
constexpr int kTile = 32;             // time steps staged per pass
constexpr int kStatesPerThread = 8;   // N / G

template <int G>  // lanes sharing one channel
__global__ void __launch_bounds__(kThreads) scan_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ Bm,
    const float* __restrict__ Cm, float* __restrict__ y, int L, int D) {
  constexpr int N = G * kStatesPerThread;
  constexpr int kChannels = kThreads / G;  // channels per block
  __shared__ float s_B[kTile][N];
  __shared__ float s_C[kTile][N];
  __shared__ float s_x[kTile][kChannels];
  __shared__ float s_dt[kTile][kChannels];

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kChannels;
  const int c = threadIdx.x / G;  // channel within the block
  const int g = threadIdx.x % G;  // this lane owns states n = j*G + g
  const int d = d0 + c;
  const size_t seq_d = static_cast<size_t>(b) * L * D;
  const size_t seq_n = static_cast<size_t>(b) * L * N;

  float a[kStatesPerThread], h[kStatesPerThread];
#pragma unroll
  for (int j = 0; j < kStatesPerThread; ++j) {
    a[j] = A[j * G + g];
    h[j] = 0.f;
  }

  for (int t0 = 0; t0 < L; t0 += kTile) {
    const int steps = min(kTile, L - t0);
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < kTile * N; i += kThreads) {
      const int tt = i / N, n = i % N;
      const size_t off = seq_n + static_cast<size_t>(t0 + tt) * N + n;
      s_B[tt][n] = tt < steps ? Bm[off] : 0.f;
      s_C[tt][n] = tt < steps ? Cm[off] : 0.f;
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
      for (int j = 0; j < kStatesPerThread; ++j) {
        const int n = j * G + g;
        h[j] = expf(delta * a[j]) * h[j] + s_B[tt][n] * u;
        acc += s_C[tt][n] * h[j];
      }
      // Every lane of the warp takes part, also those past D (they hold
      // zeros), so the full mask is exact.
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (g == 0 && d < D) y[seq_d + static_cast<size_t>(t0 + tt) * D + d] = acc;
    }
  }
}

template <int G>
cudaError_t launch(const float* x, const float* dt, const float* A,
                   const float* B, const float* C, float* y, int batch,
                   int L, int D, cudaStream_t stream) {
  constexpr int kChannels = kThreads / G;
  dim3 grid((D + kChannels - 1) / kChannels, batch);
  scan_fwd_kernel<G><<<grid, kThreads, 0, stream>>>(x, dt, A, B, C, y, L, D);
  return cudaGetLastError();
}

}  // namespace

// Returns cudaErrorInvalidValue for a state size it was not built for
// (N must be 16, 32 or 64: the state sizes of the repo's model configs)
// and otherwise the launch's error code.
extern "C" cudaError_t scan_fwd_f32(const float* x, const float* dt,
                                    const float* A, const float* B,
                                    const float* C, float* y, int batch,
                                    int L, int D, int N, cudaStream_t stream) {
  if (batch <= 0 || L <= 0 || D <= 0) return cudaErrorInvalidValue;
  switch (N) {
    case 16: return launch<2>(x, dt, A, B, C, y, batch, L, D, stream);
    case 32: return launch<4>(x, dt, A, B, C, y, batch, L, D, stream);
    case 64: return launch<8>(x, dt, A, B, C, y, batch, L, D, stream);
    default: return cudaErrorInvalidValue;
  }
}

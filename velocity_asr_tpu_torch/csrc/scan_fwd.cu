// Selective-scan forward for the SSM blocks: offline, streaming and the
// forward half of training.
//
// Replaces: velocity_asr_tpu/ops/scan_pallas.py `_make_fwd_kernel`:
// save_bounds=False with with_state=False, launched by `_pallas_scan_fwd`
// (entry `scan_fwd_f32`); save_bounds=False with with_state=True,
// launched by `_pallas_scan_fwd_state` (entry `scan_fwd_state_f32`); and
// save_bounds=True with with_state=False, launched by `_pallas_scan_fwd`
// under the training VJP (entry `scan_fwd_bounds_f32`); and
// save_bounds=True with with_state=True, launched by
// `_pallas_scan_fwd_state(save_bounds=True)` under the carried-state VJP
// of the streaming-aware objective (entry `scan_fwd_bounds_state_f32`).
//
// Computes, in fp32, per batch element b and channel d:
//   h[t] = exp(dt[t,d] * A) * h[t-1] + B[t] * (dt[t,d] * x[t,d])
//   y[t,d] = sum_n C[t,n] * h[t,n,d]
// with x, dt, y (batch, L, D), B, C (batch, L, N), A (N,). The offline
// entry starts from h[-1] = 0. The streaming entry seeds h[-1] from h0
// and stores h_final = h[L-1]; both are (batch, D, N) fp32, the layout of
// the JAX oracle's carry (the Pallas kernel's (batch, N, D) is its VMEM
// choice; the JAX wrapper swaps it back). The D*x skip is added by the
// caller, as on the TPU.
//
// The training entry also stores the state entering every chunk of
// kTrainChunk = 16 steps (the JAX TRAIN_CHUNK), bounds[b, c] = h[16c - 1]
// (zeros for chunk 0), as (batch, ceil(L/16), D, N) fp32: the residuals
// from which scan_bwd.cu recomputes each chunk's states. A last chunk
// shorter than 16 steps needs no padding: its entry state is stored like
// any other. The bounds add batch * ceil(L/16) * D * N * 4 bytes of
// writes (30 MB at (16, 300, 384, 64), more than x, dt and y together).
// Seeded by h0 (the streaming-aware training forward), bounds[b, 0] is h0
// itself and h_final is stored as in the streaming entry: the same
// instantiation flags combined, no other code.
//
// What bounds it on an H100: not bytes and not FLOPs but the serial chain
// over t. At the main path's shapes (batch 1, D=384, L=100..300) the
// inputs are ~1.5 MB and ~50 MFLOP, a microsecond of work for the card,
// while every step of the recurrence depends on the one before. The
// carried state adds 2 * batch * D * N * 4 bytes (196 KB at batch 1,
// N=64), read once before the first step and written once after the
// last.
//
// What the design does about that: it spreads the independent work as
// wide as the recurrence allows. Each channel's states are split over G
// lanes of one warp (S states per thread, kept in registers), so a step
// costs a thread S exps and 2S FMAs, and the y reduction over n is a
// G-lane butterfly of shuffles. B[t] and C[t] for a tile of time steps
// are staged once per block in shared memory (lane g owns states
// n = j*G + g, so neighbouring lanes read neighbouring banks, and
// neighbouring words of h0 and h_final); x and dt are staged beside
// them. Each input is read once from device memory and y is written
// once; the (batch, L, D, N) state never leaves registers.
// expf is the IEEE one: no fast math.
//
// Any state size N >= 1 runs. The launcher picks the narrowest (G, S)
// with G*S >= N, up to G*S = 256 (G=32 lanes of 8 states); states past N
// get A = B = C = 0, so they stay 0 and add nothing, and are neither
// loaded from h0 nor stored to h_final. Above 256 the block walks the
// states in passes of 256, each a full sweep over t that adds its part
// of y (the states of one channel are independent) and loads and stores
// its own slice of the carried state.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;  // threads per block
constexpr int kTrainChunk = 16;  // steps between saved bounds (TRAIN_CHUNK)

// G lanes share one channel, S states per lane; kWithState seeds h from
// h0 and stores h_final (both (batch, D, N)), else h starts at 0;
// kSaveBounds stores the state entering every kTrainChunk steps.
template <int G, int S, bool kWithState, bool kSaveBounds>
__global__ void __launch_bounds__(kThreads) scan_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ Bm,
    const float* __restrict__ Cm, const float* __restrict__ h0,
    float* __restrict__ y, float* __restrict__ h_final,
    float* __restrict__ bounds, int L, int D, int N) {
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
  // this channel's carried states, (batch, D, N); only read for d < D
  const size_t state = (static_cast<size_t>(b) * D + d) * N;

  for (int n0 = 0; n0 < N; n0 += NP) {
    const int live = min(NP, N - n0);  // states of this pass below N
    float a[S], h[S];
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const int n = j * G + g;
      a[j] = n < live ? A[n0 + n] : 0.f;
      if constexpr (kWithState)
        h[j] = n < live && d < D ? h0[state + n0 + n] : 0.f;
      else
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
        if constexpr (kSaveBounds) {
          const int t = t0 + tt;
          if (t % kTrainChunk == 0 && d < D) {
            // (batch, ceil(L/16), D, N): lane g's states are neighbours
            const int n_chunks = (L + kTrainChunk - 1) / kTrainChunk;
            float* bound = bounds + ((static_cast<size_t>(b) * n_chunks +
                                      t / kTrainChunk) * D + d) * N + n0;
#pragma unroll
            for (int j = 0; j < S; ++j) {
              const int n = j * G + g;
              if (n < live) bound[n] = h[j];
            }
          }
        }
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

    if constexpr (kWithState) {
      if (d < D) {
#pragma unroll
        for (int j = 0; j < S; ++j) {
          const int n = j * G + g;
          if (n < live) h_final[state + n0 + n] = h[j];
        }
      }
    }
  }
}

template <int G, int S, bool kWithState, bool kSaveBounds>
cudaError_t launch(const float* x, const float* dt, const float* A,
                   const float* B, const float* C, const float* h0, float* y,
                   float* h_final, float* bounds, int batch, int L, int D,
                   int N, cudaStream_t stream) {
  constexpr int kChannels = kThreads / G;
  dim3 grid((D + kChannels - 1) / kChannels, batch);
  scan_fwd_kernel<G, S, kWithState, kSaveBounds><<<grid, kThreads, 0, stream>>>(
      x, dt, A, B, C, h0, y, h_final, bounds, L, D, N);
  return cudaGetLastError();
}

// Any N >= 1: the narrowest (lanes G, states per lane S) with G*S >= N,
// and passes of 256 states beyond that. N = 16, 32 and 64 (the repo's
// model configs) fill their lanes exactly. Returns cudaErrorInvalidValue
// for an empty or negative size and otherwise the launch's error code.
template <bool kWithState, bool kSaveBounds>
cudaError_t dispatch(const float* x, const float* dt, const float* A,
                     const float* B, const float* C, const float* h0,
                     float* y, float* h_final, float* bounds, int batch,
                     int L, int D, int N, cudaStream_t stream) {
  if (batch <= 0 || L <= 0 || D <= 0 || N <= 0) return cudaErrorInvalidValue;
#define VELOCITY_SCAN_LAUNCH(G, S)                                          \
  launch<G, S, kWithState, kSaveBounds>(x, dt, A, B, C, h0, y, h_final,     \
                                        bounds, batch, L, D, N, stream)
  if (N <= 4) return VELOCITY_SCAN_LAUNCH(1, 4);
  if (N <= 8) return VELOCITY_SCAN_LAUNCH(1, 8);
  if (N <= 16) return VELOCITY_SCAN_LAUNCH(2, 8);
  if (N <= 32) return VELOCITY_SCAN_LAUNCH(4, 8);
  if (N <= 64) return VELOCITY_SCAN_LAUNCH(8, 8);
  if (N <= 128) return VELOCITY_SCAN_LAUNCH(16, 8);
  return VELOCITY_SCAN_LAUNCH(32, 8);
#undef VELOCITY_SCAN_LAUNCH
}

}  // namespace

// The offline scan: h[-1] = 0, no carried state.
extern "C" cudaError_t scan_fwd_f32(const float* x, const float* dt,
                                    const float* A, const float* B,
                                    const float* C, float* y, int batch,
                                    int L, int D, int N, cudaStream_t stream) {
  return dispatch<false, false>(x, dt, A, B, C, nullptr, y, nullptr, nullptr,
                                batch, L, D, N, stream);
}

// The streaming scan: h[-1] = h0, h_final = h[L-1]; h0 and h_final are
// (batch, D, N) fp32 and must not overlap.
extern "C" cudaError_t scan_fwd_state_f32(const float* x, const float* dt,
                                          const float* A, const float* B,
                                          const float* C, const float* h0,
                                          float* y, float* h_final, int batch,
                                          int L, int D, int N,
                                          cudaStream_t stream) {
  return dispatch<true, false>(x, dt, A, B, C, h0, y, h_final, nullptr, batch,
                               L, D, N, stream);
}

// The training forward: h[-1] = 0, and bounds (batch, ceil(L/16), D, N)
// fp32 receives the state entering each 16-step chunk (chunk 0: zeros).
extern "C" cudaError_t scan_fwd_bounds_f32(const float* x, const float* dt,
                                           const float* A, const float* B,
                                           const float* C, float* y,
                                           float* bounds, int batch, int L,
                                           int D, int N, cudaStream_t stream) {
  return dispatch<false, true>(x, dt, A, B, C, nullptr, y, nullptr, bounds,
                               batch, L, D, N, stream);
}

// The streaming-aware training forward: h[-1] = h0, h_final = h[L-1], and
// bounds (batch, ceil(L/16), D, N) fp32 receives the state entering each
// 16-step chunk (chunk 0: h0). h0, h_final and bounds must not overlap.
extern "C" cudaError_t scan_fwd_bounds_state_f32(
    const float* x, const float* dt, const float* A, const float* B,
    const float* C, const float* h0, float* y, float* bounds, float* h_final,
    int batch, int L, int D, int N, cudaStream_t stream) {
  return dispatch<true, true>(x, dt, A, B, C, h0, y, h_final, bounds, batch,
                              L, D, N, stream);
}

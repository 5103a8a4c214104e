// Selective-scan backward for training.
//
// Replaces: velocity_asr_tpu/ops/scan_pallas.py `_make_bwd_kernel`
// (with_state=False), launched by `_pallas_scan_bwd`, plus the sum of its
// per-batch dA over the batch that `_pallas_scan_bwd` does after it
// (entry `scan_bwd_f32`); and `_make_bwd_kernel(with_state=True)`,
// launched by `_pallas_scan_bwd` with `gh` under the carried-state VJP of
// the streaming-aware objective (entry `scan_bwd_state_f32`).
//
// Given the forward's inputs x, dt (batch, L, D), A (N,), B, C (batch, L,
// N), the chunk-entry states `bounds` (batch, ceil(L/16), D, N) that
// scan_fwd_bounds_f32 saved and the cotangent g = dLoss/dy (batch, L, D),
// it computes, in fp32, with dec[t] = exp(dt[t] * A) and u[t] = dt[t] x[t]:
//
//   h[t]   = dec[t] * h[t-1] + B[t] * u[t]      (recomputed per chunk)
//   lam[t] = C[t] * g[t] + dec[t+1] * lam[t+1]  (the adjoint, lam[L] = 0)
//   ds[t,d]  = sum_n B[t,n] lam[t,n,d]
//   dx[t,d]  = ds[t,d] dt[t,d]
//   ddt[t,d] = sum_n A[n] dec[t] h[t-1] lam[t] + ds[t,d] x[t,d]
//   dB[t,n]  = sum_d u[t,d] lam[t,n,d]
//   dC[t,n]  = sum_d g[t,d] h[t,n,d]
//   dA[n]    = sum_{b,t,d} dt[t,d] dec[t] h[t-1] lam[t]
//
// (the D*x skip's terms are the caller's, as on the TPU).
//
// With a carried state (kWithState), the forward started from h[-1] = h0
// and also returned h_final = h[L-1]: the adjoint starts from its
// cotangent, lam[L] = gh (batch, D, N), instead of 0, and what is left of
// it after step 0, dec[0] * lam[0] = dLoss/dh[-1], is stored as dh0 in the
// same layout (the JAX kernel's dh0_ref[:] = lam_ref[:] after its chunk-0
// program). The bounds then start from h0, which the recompute reads like
// any other bound. With gh = 0 and bounds from h0 = 0 the arithmetic is
// scan_bwd_f32's.
//
// What bounds it on an H100: as in the forward, the serial chain over t
// (twice here: the recompute and the adjoint), and then the reductions
// that cross the forward's thread layout. At (16, 300, 384, 64) the
// inputs and outputs are ~72 MB (the bounds 30 MB of it) and the
// arithmetic ~16 flop per (b, t, d, n), 1.9 GFLOP: 0.02-0.03 ms at the
// card's peaks, while a block waits on 2 x 300 dependent steps.
//
// What the design does about that:
// - The forward's layout: each channel's states are split over G lanes
//   of one warp, S = 4 states per lane in registers (the forward keeps 8;
//   the backward holds the 17 states of a chunk, 17 * S registers), and
//   kC = 128 / G channels per block. ds and the ddt sum over n are
//   G-lane butterflies of shuffles, as y is in the forward.
// - A chunk's 16 input rows of x, dt, g, B and C are staged once in
//   shared memory, its 17 states recomputed into registers from its
//   saved bound (fully unrolled, so the array stays in registers), then
//   the adjoint runs over the same 16 steps in reverse; the
//   (batch, L, D, N) state never leaves the chip.
// - dB and dC sum over all D channels, which span D / kC blocks. Within
//   a block the sum runs over the channels of a warp (shuffles) and then
//   over its warps (shared memory); each block writes its partial sums to
//   a workspace, and a second launch sums the partials in a fixed order.
//   dA's partials go the same way and are summed over the batch too. No
//   float atomics: two launches on the same inputs give the same bits.
// - A last chunk shorter than 16 steps is masked, not padded: its
//   missing steps load dt = x = g = B = C = 0, which makes them the
//   identity (dec = 1, u = 0) and writes nothing.
// - N above 64 runs in passes of 64 states; ds, dx and ddt are linear in
//   the states' contributions, so each pass adds its part (the thread's
//   own earlier write), and dB, dC and dA are per state. With a carried
//   state each pass seeds its lanes' lam from its own slice of gh and
//   stores its own slice of dh0: gh and dh0 add 2 * batch * D * N * 4
//   bytes, read once and written once.
// expf is the IEEE one: no fast math.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;    // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;       // steps per saved bound (TRAIN_CHUNK)
constexpr int kReduceThreads = 256;

__host__ __device__ inline int n_chunks(int L) { return (L + kChunk - 1) / kChunk; }

// Lanes per channel for N states: the narrowest G with 4 * G >= N, up to
// 16 (64 states a pass).
inline int lanes_for(int N) {
  return N <= 4 ? 1 : N <= 8 ? 2 : N <= 16 ? 4 : N <= 32 ? 8 : 16;
}

// Blocks per batch element: kThreads / G channels each.
inline int blocks_per_batch(int D, int G) {
  const int channels = kThreads / G;
  return (D + channels - 1) / channels;
}

// kWithState seeds the adjoint from gh and stores dh0 (both (batch, D, N)).
template <int G, int S, bool kWithState>
__global__ void __launch_bounds__(kThreads) scan_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ Bm,
    const float* __restrict__ Cm, const float* __restrict__ bounds,
    const float* __restrict__ gy, const float* __restrict__ gh,
    float* __restrict__ dx, float* __restrict__ ddt,
    float* __restrict__ part_dB, float* __restrict__ part_dC,
    float* __restrict__ part_dA, float* __restrict__ dh0, int L, int D,
    int N) {
  constexpr int NP = G * S;  // states per pass
  constexpr int kC = kThreads / G;  // channels per block
  static_assert(32 % G == 0, "a channel's lanes lie in one warp");
  __shared__ float s_B[kChunk][NP];
  __shared__ float s_C[kChunk][NP];
  __shared__ float s_x[kChunk][kC];
  __shared__ float s_dt[kChunk][kC];
  __shared__ float s_g[kChunk][kC];
  // per warp, the chunk's dB and dC rows summed over the warp's channels
  __shared__ float s_dB[kWarps][kChunk][NP];
  __shared__ float s_dC[kWarps][kChunk][NP];

  const int b = blockIdx.y;
  const int blk = blockIdx.x;
  const int n_blk = gridDim.x;
  const int d0 = blk * kC;
  const int c = threadIdx.x / G;  // channel within the block
  const int g = threadIdx.x % G;  // this lane owns states n0 + j*G + g
  const int warp = threadIdx.x / 32;
  const bool warp_leader = (threadIdx.x % 32) < G;  // first channel of its warp
  const int d = d0 + c;
  const int nc = n_chunks(L);
  const size_t seq_d = static_cast<size_t>(b) * L * D;
  const size_t seq_n = static_cast<size_t>(b) * L * N;
  // this block's partial rows: (batch, n_blk, L, N) and (batch, n_blk, N)
  const size_t part = (static_cast<size_t>(b) * n_blk + blk) * L * N;
  const size_t part_a = (static_cast<size_t>(b) * n_blk + blk) * N;
  // this channel's carried states, (batch, D, N); only read for d < D
  const size_t state = (static_cast<size_t>(b) * D + d) * N;

  for (int n0 = 0; n0 < N; n0 += NP) {
    const int live = min(NP, N - n0);  // states of this pass below N
    float a[S], lam[S], da[S];
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const int n = j * G + g;
      a[j] = n < live ? A[n0 + n] : 0.f;
      if constexpr (kWithState)
        lam[j] = n < live && d < D ? gh[state + n0 + n] : 0.f;
      else
        lam[j] = 0.f;
      da[j] = 0.f;
    }

    for (int ci = nc - 1; ci >= 0; --ci) {
      const int t0 = ci * kChunk;
      const int steps = min(kChunk, L - t0);
      __syncthreads();  // the previous chunk's shared rows are consumed
      for (int i = threadIdx.x; i < kChunk * NP; i += kThreads) {
        const int tt = i / NP, n = i % NP;
        const bool ok = tt < steps && n < live;
        const size_t off = seq_n + static_cast<size_t>(t0 + tt) * N + n0 + n;
        s_B[tt][n] = ok ? Bm[off] : 0.f;
        s_C[tt][n] = ok ? Cm[off] : 0.f;
      }
      for (int i = threadIdx.x; i < kChunk * kC; i += kThreads) {
        const int tt = i / kC, cc = i % kC;
        const bool ok = tt < steps && d0 + cc < D;
        const size_t off = seq_d + static_cast<size_t>(t0 + tt) * D + d0 + cc;
        s_x[tt][cc] = ok ? x[off] : 0.f;
        s_dt[tt][cc] = ok ? dt[off] : 0.f;
        s_g[tt][cc] = ok ? gy[off] : 0.f;
      }
      __syncthreads();

      // 1. the chunk's states from its saved entry state: h[k] is the
      //    state after step t0 + k - 1 (h[0] the bound)
      float h[kChunk + 1][S];
      {
        const float* bound = bounds + ((static_cast<size_t>(b) * nc + ci) * D + d) * N + n0;
#pragma unroll
        for (int j = 0; j < S; ++j) {
          const int n = j * G + g;
          h[0][j] = n < live && d < D ? bound[n] : 0.f;
        }
      }
#pragma unroll
      for (int tt = 0; tt < kChunk; ++tt) {
        const float delta = s_dt[tt][c];
        const float u = delta * s_x[tt][c];
#pragma unroll
        for (int j = 0; j < S; ++j) {
          const int n = j * G + g;
          h[tt + 1][j] = expf(delta * a[j]) * h[tt][j] + s_B[tt][n] * u;
        }
      }

      // 2. the adjoint, in reverse over the chunk
#pragma unroll
      for (int tt = kChunk - 1; tt >= 0; --tt) {
        const float delta = s_dt[tt][c];
        const float xv = s_x[tt][c];
        const float u = delta * xv;
        const float gv = s_g[tt][c];
        float ds = 0.f, dd_a = 0.f;
        float db[S], dc[S];
#pragma unroll
        for (int j = 0; j < S; ++j) {
          const int n = j * G + g;
          const float dec = expf(delta * a[j]);
          lam[j] += s_C[tt][n] * gv;
          const float dd = lam[j] * h[tt][j] * dec;  // dLoss/d(dec[t]) * dec[t]
          da[j] += dd * delta;
          dd_a += dd * a[j];
          ds += s_B[tt][n] * lam[j];
          db[j] = u * lam[j];
          dc[j] = gv * h[tt + 1][j];
          lam[j] *= dec;  // carried into step t - 1
        }
        // ds and the ddt sum over this channel's G lanes; every lane of
        // the warp takes part (lanes past D or N hold zeros)
#pragma unroll
        for (int off = G / 2; off > 0; off >>= 1) {
          ds += __shfl_xor_sync(0xffffffffu, ds, off);
          dd_a += __shfl_xor_sync(0xffffffffu, dd_a, off);
        }
        if (g == 0 && d < D && tt < steps) {
          const size_t o = seq_d + static_cast<size_t>(t0 + tt) * D + d;
          const float vx = ds * delta, vdt = dd_a + ds * xv;
          dx[o] = n0 == 0 ? vx : dx[o] + vx;  // the thread's own earlier write
          ddt[o] = n0 == 0 ? vdt : ddt[o] + vdt;
        }
        // dB and dC over the warp's channels (lanes G apart share a state)
#pragma unroll
        for (int j = 0; j < S; ++j) {
#pragma unroll
          for (int off = G; off < 32; off <<= 1) {
            db[j] += __shfl_xor_sync(0xffffffffu, db[j], off);
            dc[j] += __shfl_xor_sync(0xffffffffu, dc[j], off);
          }
        }
        if (warp_leader) {
#pragma unroll
          for (int j = 0; j < S; ++j) {
            s_dB[warp][tt][j * G + g] = db[j];
            s_dC[warp][tt][j * G + g] = dc[j];
          }
        }
      }
      __syncthreads();
      // the block's partial: the warps' rows summed in a fixed order
      for (int i = threadIdx.x; i < kChunk * NP; i += kThreads) {
        const int tt = i / NP, n = i % NP;
        if (tt < steps && n < live) {
          float sb = 0.f, sc = 0.f;
#pragma unroll
          for (int w = 0; w < kWarps; ++w) {
            sb += s_dB[w][tt][n];
            sc += s_dC[w][tt][n];
          }
          const size_t o = part + static_cast<size_t>(t0 + tt) * N + n0 + n;
          part_dB[o] = sb;
          part_dC[o] = sc;
        }
      }
    }

    if constexpr (kWithState) {
      // lam has crossed step 0: dLoss/dh[-1] for this pass's states
      if (d < D) {
#pragma unroll
        for (int j = 0; j < S; ++j) {
          const int n = j * G + g;
          if (n < live) dh0[state + n0 + n] = lam[j];
        }
      }
    }

    // dA over the block's channels: the warp's, then the warps'
#pragma unroll
    for (int j = 0; j < S; ++j) {
#pragma unroll
      for (int off = G; off < 32; off <<= 1)
        da[j] += __shfl_xor_sync(0xffffffffu, da[j], off);
    }
    __syncthreads();  // the last chunk's partial rows are read
    if (warp_leader) {
#pragma unroll
      for (int j = 0; j < S; ++j) s_dB[warp][0][j * G + g] = da[j];
    }
    __syncthreads();
    for (int n = threadIdx.x; n < live; n += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += s_dB[w][0][n];
      part_dA[part_a + n0 + n] = s;
    }
  }
}

// dB, dC (batch, L, N): the blocks' partials summed over blocks in order;
// dA (N,): summed over batch and blocks in order.
__global__ void __launch_bounds__(kReduceThreads) scan_bwd_reduce_kernel(
    const float* __restrict__ part_dB, const float* __restrict__ part_dC,
    const float* __restrict__ part_dA, float* __restrict__ dB,
    float* __restrict__ dC, float* __restrict__ dA, int batch, int L, int N,
    int n_blk) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kReduceThreads + threadIdx.x;
  const size_t per_batch = static_cast<size_t>(L) * N;
  if (i < batch * per_batch) {
    const size_t b = i / per_batch, tn = i % per_batch;
    float sb = 0.f, sc = 0.f;
    for (int k = 0; k < n_blk; ++k) {
      const size_t o = (b * n_blk + k) * per_batch + tn;
      sb += part_dB[o];
      sc += part_dC[o];
    }
    dB[i] = sb;
    dC[i] = sc;
  }
  if (i < static_cast<size_t>(N)) {
    float s = 0.f;
    for (size_t k = 0; k < static_cast<size_t>(batch) * n_blk; ++k)
      s += part_dA[k * N + i];
    dA[i] = s;
  }
}

struct Args {
  const float *x, *dt, *A, *B, *C, *bounds, *g, *gh;
  float *dx, *ddt, *dA, *dB, *dC, *dh0, *work;
  int batch, L, D, N;
};

template <int G, int S, bool kWithState>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int n_blk = blocks_per_batch(a.D, G);
  const size_t rows = static_cast<size_t>(a.batch) * n_blk * a.L * a.N;
  float* part_dB = a.work;
  float* part_dC = part_dB + rows;
  float* part_dA = part_dC + rows;
  dim3 grid(n_blk, a.batch);
  scan_bwd_kernel<G, S, kWithState><<<grid, kThreads, 0, stream>>>(
      a.x, a.dt, a.A, a.B, a.C, a.bounds, a.g, a.gh, a.dx, a.ddt, part_dB,
      part_dC, part_dA, a.dh0, a.L, a.D, a.N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t outputs = static_cast<size_t>(a.batch) * a.L * a.N;
  const size_t n = outputs > static_cast<size_t>(a.N) ? outputs : a.N;
  const unsigned reduce_blocks =
      static_cast<unsigned>((n + kReduceThreads - 1) / kReduceThreads);
  scan_bwd_reduce_kernel<<<reduce_blocks, kReduceThreads, 0, stream>>>(
      part_dB, part_dC, part_dA, a.dB, a.dC, a.dA, a.batch, a.L, a.N, n_blk);
  return cudaGetLastError();
}

// S = 4 states a lane; N > 64 in passes of 64. Returns
// cudaErrorInvalidValue for an empty or negative size and otherwise the
// launches' error code.
template <bool kWithState>
cudaError_t dispatch(const Args& a, cudaStream_t stream) {
  if (a.batch <= 0 || a.L <= 0 || a.D <= 0 || a.N <= 0) return cudaErrorInvalidValue;
  switch (lanes_for(a.N)) {
    case 1: return launch<1, 4, kWithState>(a, stream);
    case 2: return launch<2, 4, kWithState>(a, stream);
    case 4: return launch<4, 4, kWithState>(a, stream);
    case 8: return launch<8, 4, kWithState>(a, stream);
    default: return launch<16, 4, kWithState>(a, stream);
  }
}

}  // namespace

// Floats of workspace scan_bwd_f32 and scan_bwd_state_f32 need: the
// blocks' partial dB and dC rows and dA sums.
extern "C" long long scan_bwd_workspace_floats(int batch, int L, int D, int N) {
  if (batch <= 0 || L <= 0 || D <= 0 || N <= 0) return 0;
  const long long n_blk = blocks_per_batch(D, lanes_for(N));
  return static_cast<long long>(batch) * n_blk * (2LL * L * N + N);
}

// The backward of the no-state scan: dx, ddt (batch, L, D), dA (N,),
// dB, dC (batch, L, N), all fp32, from the forward's inputs, its bounds
// (batch, ceil(L/16), D, N) and g = dLoss/dy (batch, L, D). `work` holds
// scan_bwd_workspace_floats(batch, L, D, N) floats. Two launches on
// `stream`: the scan, then the sum of the blocks' partials.
extern "C" cudaError_t scan_bwd_f32(const float* x, const float* dt,
                                    const float* A, const float* B,
                                    const float* C, const float* bounds,
                                    const float* g, float* dx, float* ddt,
                                    float* dA, float* dB, float* dC,
                                    float* work, int batch, int L, int D,
                                    int N, cudaStream_t stream) {
  const Args a{x, dt, A, B, C, bounds, g, nullptr, dx, ddt, dA, dB, dC,
               nullptr, work, batch, L, D, N};
  return dispatch<false>(a, stream);
}

// The backward of the carried-state scan: as scan_bwd_f32, with the
// bounds of scan_fwd_bounds_state_f32 (chunk 0 holds h0), gh = dLoss/d
// h_final and dh0 = dLoss/dh0, both (batch, D, N) fp32; gh and dh0 must
// not overlap. Two launches, as scan_bwd_f32.
extern "C" cudaError_t scan_bwd_state_f32(const float* x, const float* dt,
                                          const float* A, const float* B,
                                          const float* C, const float* bounds,
                                          const float* g, const float* gh,
                                          float* dx, float* ddt, float* dA,
                                          float* dB, float* dC, float* dh0,
                                          float* work, int batch, int L, int D,
                                          int N, cudaStream_t stream) {
  const Args a{x, dt, A, B, C, bounds, g, gh, dx, ddt, dA, dB, dC, dh0, work,
               batch, L, D, N};
  return dispatch<true>(a, stream);
}

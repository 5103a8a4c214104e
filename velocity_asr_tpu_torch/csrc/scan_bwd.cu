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
// scan_bwd_f32's, bit for bit.
//
// What bounds it on an H100: the instructions issued per (b, t, d, n)
// step of the serial chain over t (twice: the recompute and the adjoint)
// and the reductions that cross the thread layout, on SMs that hold only
// a few warps. At (16, 300, 384, 64) the inputs and outputs are ~72 MB
// (the bounds 30 MB of it) and the arithmetic ~20 flop per (b, t, d, n),
// 2.4 GFLOP: 0.02-0.04 ms at the card's peaks, while each block walks 2 x
// 300 dependent steps.
//
// What the design does about that:
// - Layout: each channel's states are split over G lanes of one warp,
//   S = 4 consecutive states per lane in registers (so a lane's B, C and
//   decays of a step are one float4 in shared memory), kC = 128 / G
//   channels per block; ds and the ddt sum over n are G-lane butterflies
//   of shuffles, whose results are staged per chunk and turned into dx
//   and ddt when the chunk is written out.
// - A chunk's 16 input rows of B, C and of (dt, u = dt x, g, x) (one
//   float4 per step and channel) are staged once in shared memory and its
//   states recomputed from its saved bound (fully unrolled, in
//   registers), then the adjoint runs over the same 16 steps in reverse;
//   the (batch, L, D, N) state never leaves the chip.
// - The decays are kept: exp(dt * A) is computed once per (t, d, n), in
//   the recompute, and stored in shared memory (16 x 128 x S floats, each
//   thread its own float4 per step), where the adjoint reads it back:
//   half the expf of computing it in both passes. The registers keep
//   hd = dec[t] h[t-1] instead of the states: the adjoint's
//   dLoss/d(dec) dec is lam hd, and h[t] = hd + B[t] u[t] for dC. Once a
//   warp has read step t's decays, it writes its dB and dC rows of step
//   t over them (the warp's own 32 float4 hold its 2 x G x S values), so
//   the rows need no shared memory of their own.
// - One launch, deterministic. dB and dC sum over all D channels, which
//   span D / kC blocks. Within a block the sum runs over the channels of
//   a warp (shuffles), then over its warps in order (shared memory). The
//   blocks of a batch element form thread-block clusters of 8 along D;
//   after each chunk every block stores each eighth of its partial rows
//   into the shared memory of the rank that owns that eighth (a slot per
//   rank, through distributed shared memory), and each rank sums its
//   slots in rank order and writes the cluster's partial rows to a
//   workspace: at (16, 300, 384, 64) 6 clusters per batch element,
//   14.7 MB, where per-block partials were 118 MB. The cluster barrier
//   is split: a rank arrives once it has read its slots and waits on
//   that arrival only before the ranks store into them again, a chunk
//   later. dA's partials go the same way, once per
//   pass. When a cluster has written all its partials it fences and
//   counts itself in on an integer counter of its batch element and on
//   one of the whole grid; the last cluster of a batch element sums its
//   clusters' partial rows in cluster order into dB and dC, and the last
//   cluster of the grid sums dA over (batch, cluster) in order. The
//   batch + 1 counters sit at the end of the call's workspace, zeroed by
//   a memset on the launch's stream just before the kernel, so no state
//   outlives a call. No float atomics: two launches on the same inputs
//   give the same bits.
// - What this layout does not do is fill the card. 128 registers and
//   ~52 KB of shared memory a block leave 4 resident blocks per SM, 62
//   clusters of 8 on an H100 (scan_bwd_occupancy). The grid is batch x
//   6 clusters at D = 384, N = 64: 48 at batch 8 (0.77 of a wave) and 96
//   at batch 16 (1.55 waves, the second 55% full). The cluster grain (64
//   channels of one batch element, every block as long as L) is what
//   keeps the partial rows small, and it is also what leaves a tail: at
//   3 resident blocks per SM the 396 slots hold at most 49 clusters of 8
//   before placement, too near 48 to promise batch 8 one wave.
// - A last chunk shorter than 16 steps is masked, not padded: its
//   missing steps load dt = x = g = B = C = 0, which makes them the
//   identity (dec = 1, u = 0) and writes nothing.
// - N above 64 runs in passes of 64 states; ds, dx and ddt are linear in
//   the states' contributions, so each pass adds its part (the block's
//   own earlier write), and dB, dC and dA are per state. With a carried
//   state each pass seeds its lanes' lam from its own slice of gh and
//   stores its own slice of dh0.
// expf is the IEEE one: no fast math.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;    // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;       // steps per saved bound (TRAIN_CHUNK)
constexpr int kCluster = 8;      // blocks of a batch element summed through DSMEM
constexpr int kMinBlocks = 4;    // resident blocks per SM: 128 registers, <= 56 KB shared
constexpr int kStates = 4;       // S: states per lane

__host__ __device__ inline int n_chunks(int L) { return (L + kChunk - 1) / kChunk; }

// Lanes per channel for N states: the narrowest G with 4 * G >= N, up to
// 16 (64 states a pass).
inline int lanes_for(int N) {
  return N <= 4 ? 1 : N <= 8 ? 2 : N <= 16 ? 4 : N <= 32 ? 8 : 16;
}

// Clusters per batch element: kThreads / G channels a block, kCluster
// blocks a cluster (blocks past D compute on zeros).
inline int clusters_per_batch(int D, int G) {
  const int channels = kCluster * (kThreads / G);
  return (D + channels - 1) / channels;
}

// Shared memory of one block, in floats.
template <int G>
struct Smem {
  static constexpr int NP = G * kStates;    // states per pass
  static constexpr int kC = kThreads / G;   // channels per block
  static constexpr int kRow = kChunk * NP;  // one (16, NP) row set
  // decays [kChunk][kThreads][S], overwritten per warp by its dB and dC rows
  static constexpr int dec = 0;
  static constexpr int part = dec + kChunk * kThreads * kStates;  // [2][kChunk][NP]
  static constexpr int B = part + 2 * kRow;                        // [kChunk][NP]
  static constexpr int C = B + kRow;
  static constexpr int in = C + kRow;                              // float4 [kChunk][kC]
  static constexpr int out = in + 4 * kChunk * kC;                 // float2 [kChunk][kC]
  static constexpr int da = out + 2 * kChunk * kC;                 // [kWarps + 1][NP]
  static constexpr int flags = da + (kWarps + 1) * NP;             // 2 ints
  static constexpr int floats = flags + 2;
  static constexpr size_t bytes = sizeof(float) * floats;
};

struct Args {
  const float *x, *dt, *A, *B, *C, *bounds, *g, *gh;
  float *dx, *ddt, *dA, *dB, *dC, *dh0, *work;
  long long work_floats;
  int batch, L, D, N;
};

// The two halves of a cluster barrier: arrive (releasing this thread's
// shared-memory writes to the cluster) and wait (acquiring the others').
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// kWithState seeds the adjoint from gh and stores dh0 (both (batch, D, N)).
template <int G, bool kWithState>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, kMinBlocks)
scan_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ bounds,
                const float* __restrict__ gy, const float* __restrict__ gh,
                float* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ dA,
                float* __restrict__ dB, float* __restrict__ dC, float* __restrict__ dh0,
                float* __restrict__ part_bc, float* __restrict__ part_a,
                int* __restrict__ count, int L, int D, int N) {
  using M = Smem<G>;
  constexpr int S = kStates;
  constexpr int NP = M::NP;
  constexpr int kC = M::kC;
  constexpr int kRow = M::kRow;
  constexpr int kSlice = 2 * kRow / 4 / kCluster;  // a rank's float4s of a chunk's dB, dC
  static_assert(S == 4, "a lane's states are one float4");
  static_assert(32 % G == 0, "a channel's lanes lie in one warp");
  static_assert(2 * NP <= 32 * S, "a warp's dB and dC rows fit in its decays of a step");
  static_assert((2 * kRow / 4) % kCluster == 0, "the ranks share a chunk's rows evenly");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* s_dec = smem + M::dec;
  float* s_part = smem + M::part;
  float (*s_B)[NP] = reinterpret_cast<float (*)[NP]>(smem + M::B);
  float (*s_C)[NP] = reinterpret_cast<float (*)[NP]>(smem + M::C);
  // per step and channel: dt, u = dt x, g, x
  float4 (*s_in)[kC] = reinterpret_cast<float4 (*)[kC]>(smem + M::in);
  float2 (*s_out)[kC] = reinterpret_cast<float2 (*)[kC]>(smem + M::out);
  float (*s_da)[NP] = reinterpret_cast<float (*)[NP]>(smem + M::da);
  int* s_flags = reinterpret_cast<int*>(smem + M::flags);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int batch = gridDim.y;
  const int b = blockIdx.y;
  const int n_cl = gridDim.x / kCluster;
  const int cl = blockIdx.x / kCluster;
  const int d0 = blockIdx.x * kC;
  const int tid = threadIdx.x;
  const int c = tid / G;  // channel within the block
  const int g = tid % G;  // this lane owns states n0 + g*S + j, j < S
  const int warp = tid / 32;
  const bool warp_leader = tid % 32 < G;  // first channel of its warp
  const int d = d0 + c;
  const int nc = n_chunks(L);
  const size_t seq_d = static_cast<size_t>(b) * L * D;
  const size_t seq_n = static_cast<size_t>(b) * L * N;
  const size_t rows = static_cast<size_t>(L) * N;
  // this cluster's partial rows: dB then dC, each (batch, n_cl, L, N), and
  // its dA sums (batch, n_cl, N)
  float* my_dB = part_bc + (static_cast<size_t>(b) * n_cl + cl) * rows;
  float* my_dC = my_dB + static_cast<size_t>(batch) * n_cl * rows;
  float* my_dA = part_a + (static_cast<size_t>(b) * n_cl + cl) * N;
  // this channel's carried states, (batch, D, N); only read for d < D
  const size_t state = (static_cast<size_t>(b) * D + d) * N;
  // this thread's decays of step tt: my_dec[tt * kThreads]; the warp's
  // 32 float4 of step tt hold its dB and dC rows once read
  float4* my_dec = reinterpret_cast<float4*>(s_dec) + tid;
  // B and C rows are staged as float4 where they are 16-byte aligned
  const bool vec_bc = N % 4 == 0 && (reinterpret_cast<size_t>(Bm) | reinterpret_cast<size_t>(Cm)) % 16 == 0;

  for (int n0 = 0; n0 < N; n0 += NP) {
    const int live = min(NP, N - n0);  // states of this pass below N
    float a[S], lam[S], da[S];
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const int n = g * S + j;
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
      // (the previous chunk's inputs were consumed before its sums' barriers)
      if (vec_bc) {  // whole, aligned float4 rows (live is a multiple of 4)
        for (int i = tid; i < kChunk * NP / 4; i += kThreads) {
          const int tt = i / (NP / 4), n = i % (NP / 4) * 4;
          const bool ok = tt < steps && n < live;
          const size_t off = seq_n + static_cast<size_t>(t0 + tt) * N + n0 + n;
          const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
          reinterpret_cast<float4*>(s_B[tt])[n / 4] =
              ok ? *reinterpret_cast<const float4*>(Bm + off) : zero;
          reinterpret_cast<float4*>(s_C[tt])[n / 4] =
              ok ? *reinterpret_cast<const float4*>(Cm + off) : zero;
        }
      } else {
        for (int i = tid; i < kChunk * NP; i += kThreads) {
          const int tt = i / NP, n = i % NP;
          const bool ok = tt < steps && n < live;
          const size_t off = seq_n + static_cast<size_t>(t0 + tt) * N + n0 + n;
          s_B[tt][n] = ok ? Bm[off] : 0.f;
          s_C[tt][n] = ok ? Cm[off] : 0.f;
        }
      }
      for (int i = tid; i < kChunk * kC; i += kThreads) {
        const int tt = i / kC, cc = i % kC;
        const bool ok = tt < steps && d0 + cc < D;
        const size_t off = seq_d + static_cast<size_t>(t0 + tt) * D + d0 + cc;
        const float xv = ok ? x[off] : 0.f, delta = ok ? dt[off] : 0.f;
        s_in[tt][cc] = make_float4(delta, delta * xv, ok ? gy[off] : 0.f, xv);
      }
      __syncthreads();

      // 1. the chunk's states from its saved entry state, keeping the
      //    decays (shared memory) and hd[k] = dec[t] h[t-1] for step
      //    t = t0 + k (registers); h[t] = hd[k] + B[t] u[t]
      float h[S], hd[kChunk][S];
      {
        const float* bound = bounds + ((static_cast<size_t>(b) * nc + ci) * D + d) * N + n0;
#pragma unroll
        for (int j = 0; j < S; ++j) {
          const int n = g * S + j;
          h[j] = n < live && d < D ? bound[n] : 0.f;
        }
      }
#pragma unroll
      for (int tt = 0; tt < kChunk; ++tt) {
        const float4 in = s_in[tt][c];
        const float delta = in.x, u = in.y;
        const float4 bv = reinterpret_cast<const float4*>(s_B[tt])[g];
        const float bn[S] = {bv.x, bv.y, bv.z, bv.w};
        float dec[S];
#pragma unroll
        for (int j = 0; j < S; ++j) {
          dec[j] = expf(delta * a[j]);
          hd[tt][j] = dec[j] * h[j];
          h[j] = hd[tt][j] + bn[j] * u;
        }
        my_dec[tt * kThreads] = make_float4(dec[0], dec[1], dec[2], dec[3]);
      }

      // 2. the adjoint, in reverse over the chunk
#pragma unroll
      for (int tt = kChunk - 1; tt >= 0; --tt) {
        const float4 in = s_in[tt][c];
        const float delta = in.x, u = in.y, gv = in.z;
        const float4 dv = my_dec[tt * kThreads];
        const float4 bv = reinterpret_cast<const float4*>(s_B[tt])[g];
        const float4 cv = reinterpret_cast<const float4*>(s_C[tt])[g];
        const float dec[S] = {dv.x, dv.y, dv.z, dv.w};
        const float bn[S] = {bv.x, bv.y, bv.z, bv.w};
        const float cn[S] = {cv.x, cv.y, cv.z, cv.w};
        float ds = 0.f, dd_a = 0.f;
        float db[S], dc[S];
#pragma unroll
        for (int j = 0; j < S; ++j) {
          lam[j] += cn[j] * gv;
          const float dd = lam[j] * hd[tt][j];  // dLoss/d(dec[t]) * dec[t]
          da[j] += dd * delta;
          dd_a += dd * a[j];
          ds += bn[j] * lam[j];
          db[j] = u * lam[j];
          dc[j] = gv * (hd[tt][j] + bn[j] * u);  // g[t] h[t]
          lam[j] *= dec[j];  // carried into step t - 1
        }
        // ds and the ddt sum over this channel's G lanes; every lane of
        // the warp takes part (lanes past D or N hold zeros)
#pragma unroll
        for (int off = G / 2; off > 0; off >>= 1) {
          ds += __shfl_xor_sync(0xffffffffu, ds, off);
          dd_a += __shfl_xor_sync(0xffffffffu, dd_a, off);
        }
        if (g == 0) s_out[tt][c] = make_float2(ds, dd_a);
        // dB and dC over the warp's channels (lanes G apart share states)
#pragma unroll
        for (int j = 0; j < S; ++j) {
#pragma unroll
          for (int off = G; off < 32; off <<= 1) {
            db[j] += __shfl_xor_sync(0xffffffffu, db[j], off);
            dc[j] += __shfl_xor_sync(0xffffffffu, dc[j], off);
          }
        }
        __syncwarp();  // every lane has read its decays of step tt
        if (warp_leader) {
          float4* row = reinterpret_cast<float4*>(s_dec + (tt * kThreads + warp * 32) * S);
          row[g] = make_float4(db[0], db[1], db[2], db[3]);
          row[G + g] = make_float4(dc[0], dc[1], dc[2], dc[3]);
        }
      }
      __syncthreads();
      // dx and ddt of the chunk, a pass adding to the earlier passes' sums
      for (int i = tid; i < kChunk * kC; i += kThreads) {
        const int tt = i / kC, cc = i % kC;
        if (tt < steps && d0 + cc < D) {
          const size_t o = seq_d + static_cast<size_t>(t0 + tt) * D + d0 + cc;
          const float2 v = s_out[tt][cc];  // ds and the ddt sum over n
          const float4 in = s_in[tt][cc];
          const float vx = v.x * in.x, vdt = v.y + v.x * in.w;
          dx[o] = n0 == 0 ? vx : dx[o] + vx;
          ddt[o] = n0 == 0 ? vdt : ddt[o] + vdt;
        }
      }
      // every rank has read its slots of the previous chunk (the arrive
      // after its reads, a whole chunk ago, is long past)
      if (ci != nc - 1) cluster_wait();
      // the block's partial: the warps' rows summed in a fixed order, four
      // states at a time, stored into the shared memory of the rank that
      // owns those values, at this rank's slot
      for (int i = tid; i < 2 * kRow / 4; i += kThreads) {
        const int q = i * 4 / kRow, tt = (i * 4 % kRow) / NP, n = i * 4 % NP;
        const float4* row = reinterpret_cast<const float4*>(s_dec + tt * kThreads * S + q * NP + n);
        float4 s = row[0];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) {
          const float4 v = row[w * 32 * S / 4];
          s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
        }
        float4* owner = reinterpret_cast<float4*>(cluster.map_shared_rank(s_part, i / kSlice));
        owner[rank * kSlice + i % kSlice] = s;
      }
      cluster_arrive();  // every block's partial of this chunk is in place
      cluster_wait();
      // this rank's slice of the cluster's sum: its slots, ranks in order
      const float4* slots = reinterpret_cast<const float4*>(s_part);
      for (int k = tid; k < kSlice; k += kThreads) {
        const int i = rank * kSlice + k;
        const int q = i * 4 / kRow, tt = (i * 4 % kRow) / NP, n = i * 4 % NP;
        if (tt < steps && n < live) {
          float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int r = 0; r < kCluster; ++r) {
            const float4 v = slots[r * kSlice + k];
            s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
          }
          float* dst = (q == 0 ? my_dB : my_dC) + static_cast<size_t>(t0 + tt) * N + n0 + n;
          const float v[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (n + k < live) dst[k] = v[k];
        }
      }
      cluster_arrive();  // this rank has read its slots
    }
    cluster_wait();  // every rank has read its slots of the last chunk

    if constexpr (kWithState) {
      // lam has crossed step 0: dLoss/dh[-1] for this pass's states
      if (d < D) {
#pragma unroll
        for (int j = 0; j < S; ++j) {
          const int n = g * S + j;
          if (n < live) dh0[state + n0 + n] = lam[j];
        }
      }
    }

    // dA: the warp's channels, then the block's warps, then the ranks
#pragma unroll
    for (int j = 0; j < S; ++j) {
#pragma unroll
      for (int off = G; off < 32; off <<= 1)
        da[j] += __shfl_xor_sync(0xffffffffu, da[j], off);
    }
    if (warp_leader) {
#pragma unroll
      for (int j = 0; j < S; ++j) s_da[warp][g * S + j] = da[j];
    }
    __syncthreads();
    if (tid < NP) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += s_da[w][tid];
      s_da[kWarps][tid] = s;
    }
    cluster.sync();
    if (rank == 0 && tid < live) {
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < kCluster; ++r) s += cluster.map_shared_rank(s_da[kWarps], r)[tid];
      my_dA[n0 + tid] = s;
    }
    // s_da is written again only after the next pass's first chunk
    // barrier, so rank 0's remote reads above are done by then
  }

  // Count the cluster in. Every thread's partial writes are visible
  // device-wide before rank 0 increments the counters.
  __threadfence();
  cluster.sync();
  if (rank == 0 && tid == 0) {
    const int done_b = atomicAdd(&count[b], 1) + 1;
    const int done_all = atomicAdd(&count[batch], 1) + 1;
    s_flags[0] = done_b == n_cl;
    s_flags[1] = done_all == batch * n_cl;
    __threadfence();
  }
  cluster.sync();
  const int* flags = cluster.map_shared_rank(s_flags, 0);
  const bool last_b = flags[0] != 0, last_all = flags[1] != 0;
  cluster.sync();  // rank 0's flags are read: it may exit
  if (last_b) {
    // dB, dC of batch element b: its clusters' partial rows in cluster order
    const float* pb = part_bc + static_cast<size_t>(b) * n_cl * rows;
    const float* pc = pb + static_cast<size_t>(batch) * n_cl * rows;
    for (size_t i = static_cast<size_t>(rank) * kThreads + tid; i < rows;
         i += static_cast<size_t>(kCluster) * kThreads) {
      float sb = 0.f, sc = 0.f;
      for (int k = 0; k < n_cl; ++k) {
        sb += __ldcg(pb + k * rows + i);
        sc += __ldcg(pc + k * rows + i);
      }
      dB[static_cast<size_t>(b) * rows + i] = sb;
      dC[static_cast<size_t>(b) * rows + i] = sc;
    }
  }
  if (last_all) {
    // dA: every (batch, cluster) sum in order
    for (int n = rank * kThreads + tid; n < N; n += kCluster * kThreads) {
      float s = 0.f;
      for (int k = 0; k < batch * n_cl; ++k) s += __ldcg(part_a + static_cast<size_t>(k) * N + n);
      dA[n] = s;
    }
  }
}

// Floats of the clusters' dB and dC rows and dA sums for one call.
long long partial_floats(int batch, int L, int D, int N) {
  const long long n_cl = clusters_per_batch(D, lanes_for(N));
  return static_cast<long long>(batch) * n_cl * (2LL * L * N + N);
}

// Workspace for one call, in 4-byte words: the partials, then batch + 1
// int32 arrival counters.
long long workspace_floats(int batch, int L, int D, int N) {
  return partial_floats(batch, L, D, N) + batch + 1;
}

template <int G, bool kWithState>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kernel = scan_bwd_kernel<G, kWithState>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(Smem<G>::bytes));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int n_cl = clusters_per_batch(a.D, G);
  const size_t rows = static_cast<size_t>(a.batch) * n_cl * a.L * a.N;
  float* part_bc = a.work;
  float* part_a = part_bc + 2 * rows;
  int* count = reinterpret_cast<int*>(a.work + partial_floats(a.batch, a.L, a.D, a.N));
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(int) * (a.batch + 1), stream);
  if (err != cudaSuccess) return err;
  dim3 grid(n_cl * kCluster, a.batch);
  kernel<<<grid, kThreads, Smem<G>::bytes, stream>>>(
      a.x, a.dt, a.A, a.B, a.C, a.bounds, a.g, a.gh, a.dx, a.ddt, a.dA, a.dB, a.dC, a.dh0,
      part_bc, part_a, count, a.L, a.D, a.N);
  return cudaGetLastError();
}

// S = 4 states a lane; N > 64 in passes of 64. Returns
// cudaErrorInvalidValue for an empty or negative size or a workspace
// smaller than workspace_floats, and otherwise the launch's error code.
template <bool kWithState>
cudaError_t dispatch(const Args& a, cudaStream_t stream) {
  if (a.batch <= 0 || a.L <= 0 || a.D <= 0 || a.N <= 0 || a.batch > 65535 ||
      a.work_floats < workspace_floats(a.batch, a.L, a.D, a.N))
    return cudaErrorInvalidValue;
  switch (lanes_for(a.N)) {
    case 1: return launch<1, kWithState>(a, stream);
    case 2: return launch<2, kWithState>(a, stream);
    case 4: return launch<4, kWithState>(a, stream);
    case 8: return launch<8, kWithState>(a, stream);
    default: return launch<16, kWithState>(a, stream);
  }
}

template <int G, bool kWithState>
cudaError_t occupancy(int* out) {
  auto kernel = scan_bwd_kernel<G, kWithState>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(Smem<G>::bytes));
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int per_sm, clusters;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, Smem<G>::bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(kCluster, 1, 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = Smem<G>::bytes;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(Smem<G>::bytes);
  out[3] = per_sm;
  out[4] = clusters;
  out[5] = kThreads;
  return cudaSuccess;
}

}  // namespace

// 4-byte words of workspace scan_bwd_f32 and scan_bwd_state_f32 need
// (the cluster partials, then the arrival counters).
extern "C" long long scan_bwd_workspace_floats(int batch, int L, int D, int N) {
  if (batch <= 0 || L <= 0 || D <= 0 || N <= 0) return 0;
  return workspace_floats(batch, L, D, N);
}

// The backward of the no-state scan: dx, ddt (batch, L, D), dA (N,),
// dB, dC (batch, L, N), all fp32, from the forward's inputs, its bounds
// (batch, ceil(L/16), D, N) and g = dLoss/dy (batch, L, D). `work` holds
// `work_floats` >= scan_bwd_workspace_floats(batch, L, D, N) 4-byte
// words, which nothing else uses until the kernel ends. One memset of
// its arrival counters and one kernel launch on `stream`.
extern "C" cudaError_t scan_bwd_f32(const float* x, const float* dt,
                                    const float* A, const float* B,
                                    const float* C, const float* bounds,
                                    const float* g, float* dx, float* ddt,
                                    float* dA, float* dB, float* dC,
                                    float* work, long long work_floats,
                                    int batch, int L, int D, int N,
                                    cudaStream_t stream) {
  const Args a{x, dt, A, B, C, bounds, g, nullptr, dx, ddt, dA, dB, dC, nullptr,
               work, work_floats, batch, L, D, N};
  return dispatch<false>(a, stream);
}

// The backward of the carried-state scan: as scan_bwd_f32, with the
// bounds of scan_fwd_bounds_state_f32 (chunk 0 holds h0), gh = dLoss/d
// h_final and dh0 = dLoss/dh0, both (batch, D, N) fp32; gh and dh0 must
// not overlap. One launch, as scan_bwd_f32.
extern "C" cudaError_t scan_bwd_state_f32(const float* x, const float* dt,
                                          const float* A, const float* B,
                                          const float* C, const float* bounds,
                                          const float* g, const float* gh,
                                          float* dx, float* ddt, float* dA,
                                          float* dB, float* dC, float* dh0,
                                          float* work, long long work_floats,
                                          int batch, int L, int D, int N,
                                          cudaStream_t stream) {
  const Args a{x, dt, A, B, C, bounds, g, gh, dx, ddt, dA, dB, dC, dh0, work,
               work_floats, batch, L, D, N};
  return dispatch<true>(a, stream);
}

// What the build gave the backward's instantiation for `lanes` lanes per
// channel (1, 2, 4, 8 or 16) with or without a carried state: out =
// {registers per thread, local (spill) bytes per thread, dynamic shared
// bytes per block, resident blocks per SM, resident clusters of 8 on the
// device, threads per block}.
extern "C" cudaError_t scan_bwd_occupancy(int lanes, int with_state, int* out) {
  switch (lanes * 2 + (with_state ? 1 : 0)) {
    case 2: return occupancy<1, false>(out);
    case 3: return occupancy<1, true>(out);
    case 4: return occupancy<2, false>(out);
    case 5: return occupancy<2, true>(out);
    case 8: return occupancy<4, false>(out);
    case 9: return occupancy<4, true>(out);
    case 16: return occupancy<8, false>(out);
    case 17: return occupancy<8, true>(out);
    case 32: return occupancy<16, false>(out);
    case 33: return occupancy<16, true>(out);
    default: return cudaErrorInvalidValue;
  }
}

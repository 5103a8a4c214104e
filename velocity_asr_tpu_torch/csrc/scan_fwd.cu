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
// from which scan_bwd.cu recomputes each chunk's states. The bounds add
// batch * ceil(L/16) * D * N * 4 bytes of writes (30 MB at (16, 300, 384,
// 64), more than x, dt and y together). Seeded by h0 (the streaming-aware
// training forward), bounds[b, 0] is h0 itself and h_final is stored as
// in the streaming entry: the same instantiation flags combined, no other
// code.
//
// What bounds it on an H100: the instructions issued per (b, t, d, n).
// The (b, d, n) recurrences are independent of each other, and each is a
// chain of L dependent steps; every step needs one IEEE expf (8
// instructions, one of them on the SFU at 16 results a clock per SM),
// against ~1.5 MB of inputs at batch 1 and a few microseconds of bytes
// even with the training bounds. So the design spreads the recurrences
// over the whole card and keeps the serial part of each step to one FMA.
//
// The design:
// - Each thread holds S = 1, 2 or 4 consecutive states of one channel in
//   registers; G = 8, 16 or 32 lanes of one warp hold a channel's states
//   (lanes past N hold zeros), and a block of 64 * S threads holds
//   64 * S / G channels of one batch element. The launcher picks S from
//   batch * D * N alone (never from L): S = 1 below 2^16 states, 2 below
//   2^17, else 4, and at least N / 32. Small batches so spread one or two
//   states a thread over many blocks (batch 1, N = 64: S = 2, 96 blocks
//   of 4 warps, where the earlier kernel ran 48 of 2); large ones issue
//   fewer instructions per state (S = 4 shares a step's loads and dt * x
//   over four states: ~13.5 instructions a state and step, 8 of them the
//   expf). Above 32 * S states the block walks the states in passes, each
//   a full sweep over t that adds its part of y (the states of one
//   channel are independent). S and G are template parameters, so every
//   shared-memory stride is a constant.
// - Steps go in tiles of kTile = 16 (the training chunk). A tile's rows
//   of B and C (the pass's states) and of (x, dt) pairs (the block's
//   channels) are staged by cp.async into one of two slots of shared
//   memory while the block runs the previous tile from the other slot
//   (16-byte copies where N % 4 == 0, zero-filled past N and D): one
//   __syncthreads a tile, no copy in series with the chain.
// - A full tile's 16 steps are unrolled with no branch, in sub-tiles of
//   16 / S steps: first every decay exp(dt * a) and B * u of the sub-tile
//   (16 independent expf per lane), then the chain, one FMA a step and
//   state, h = fma(decay, h, B * u) (the earlier kernel's rounding:
//   states, bounds and h_final are bit-equal to its). A lane sums its
//   states' C * h per step and writes that partial to its warp's shared
//   rows; the ragged last tile runs the same arithmetic a step at a time.
// - y is reduced once per tile, inside the warp (the G lanes of a
//   channel are one warp's): each lane reads 16 partials and sums each
//   of its outputs' G (G / 2 and one shuffle at G = 32) pairwise in lane
//   order. The order depends on neither the tile's position nor L, so a
//   chunk scanned in two launches gives one launch's bits, and the bounds
//   entries' y is the offline entry's. The tile's y rows go to shared
//   memory and are stored, coalesced along D, after the next tile's
//   barrier.
// - The training bounds are stored at each tile's start (a tile is a
//   chunk), S-wide (16 bytes at S = 4, neighbouring lanes on neighbouring
//   n), outside the unrolled steps; h0 and h_final likewise, masked past
//   N and D.
// expf is the IEEE one: no fast math.
//
// A timeline entry (scan_fwd_timeline_f32, kTimeline) records clock64()
// at the phase boundaries of block (0, 0)'s thread 0, and every block's
// SM and start and end on the global timer; no path calls it.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kTile = 16;        // steps staged and reduced together
constexpr int kTrainChunk = 16;  // steps between saved bounds (TRAIN_CHUNK)
static_assert(kTile == kTrainChunk, "a tile's first step starts a training chunk");
constexpr int kPartStride = 33;  // floats per step row of a warp's partials (no bank conflicts)
constexpr int kResidentWarps = 24;  // per SM, that the register budget must allow
constexpr int kStamps = 6;          // timeline stamps per tile

// Bytes of shared memory a block of S states a thread and G lanes a
// channel takes: B and C, (x, dt) pairs and y rows in two slots each,
// then each warp's partials.
constexpr size_t smem_bytes(int S, int G) {
  return sizeof(float) * (2 * 2 * kTile * S * G + 3 * 2 * kTile * (64 * S / G) +
                          64 * S / 32 * kTile * kPartStride);
}

// S states a thread, G lanes a channel (8, 16 or 32: a channel is one
// warp's); a block of 64 * S threads.
template <int S, int G>
struct Layout {
  static constexpr int kThreads = 64 * S;
  static constexpr int kMinBlocks = kResidentWarps * 32 / kThreads;
  static constexpr int kChannels = kThreads / G;  // per block
  static constexpr int kStates = S * G;           // per pass
  static constexpr int kWarpChannels = 32 / G;
};

struct Params {
  const float* x;
  const float* dt;
  const float* A;
  const float* B;
  const float* C;
  const float* h0;
  float* y;
  float* h_final;
  float* bounds;
  long long* clocks;
  int L, D, N;
  int vec_bc;     // B and C rows take 16-byte copies
  int vec_state;  // h0, h_final and bounds take S-wide accesses
};

// What the launcher runs for (batch, D, N).
struct Plan {
  int S, lanes, channels, threads, passes;
  dim3 grid;
  size_t smem;
};

Plan plan_for(int batch, int D, int N) {
  const long long states = static_cast<long long>(batch) * D * N;
  int S = states >= (1LL << 17) ? 4 : states >= (1LL << 16) ? 2 : 1;
  while (S < 4 && 32 * S < N) S *= 2;
  Plan p;
  p.S = S;
  p.lanes = 8;
  while (p.lanes < 32 && p.lanes * S < N) p.lanes *= 2;
  p.threads = 64 * S;
  p.channels = p.threads / p.lanes;
  p.passes = (N + S * p.lanes - 1) / (S * p.lanes);
  p.grid = dim3((D + p.channels - 1) / p.channels, batch);
  p.smem = smem_bytes(S, p.lanes);
  return p;
}

bool aligned(const void* ptr, int bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 4 : 0) : "memory");
}

// 16 bytes, of which the first `bytes` are read and the rest zero-filled.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int S>
__device__ __forceinline__ void load_vec(const float* src, float (&v)[S]) {
  if constexpr (S == 4) {
    const float4 q = *reinterpret_cast<const float4*>(src);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else if constexpr (S == 2) {
    const float2 q = *reinterpret_cast<const float2*>(src);
    v[0] = q.x; v[1] = q.y;
  } else {
    v[0] = src[0];
  }
}

template <int S>
__device__ __forceinline__ void store_vec(float* dst, const float (&v)[S]) {
  if constexpr (S == 4)
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  else if constexpr (S == 2)
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  else
    dst[0] = v[0];
}

// A lane's S states (from state index nb) of one (batch, channel) row of
// N states: S-wide where allowed and whole, else one by one below N.
template <int S>
__device__ __forceinline__ void load_states(const float* row, int nb, int N, bool vec,
                                            float (&h)[S]) {
  if (vec && nb + S <= N) {
    load_vec<S>(row + nb, h);
  } else {
#pragma unroll
    for (int j = 0; j < S; ++j) h[j] = nb + j < N ? row[nb + j] : 0.f;
  }
}

template <int S>
__device__ __forceinline__ void store_states(float* row, int nb, int N, bool vec,
                                             const float (&h)[S]) {
  if (vec && nb + S <= N) {
    store_vec<S>(row + nb, h);
  } else {
#pragma unroll
    for (int j = 0; j < S; ++j)
      if (nb + j < N) row[nb + j] = h[j];
  }
}

// The update of one state, h = exp(dt a) h + B u with u = dt x, as one
// FMA on the chain: fma(decay, h, B * u), the rounding nvcc gave the
// earlier kernel's `expf(delta * a) * h + B * u` (the other contraction,
// fma(B, u, decay * h), gives other bits). Written with intrinsics so that
// every instantiation and both tile paths round it alike.
__device__ __forceinline__ float decay_of(float delta, float a) {
  return expf(__fmul_rn(delta, a));
}
__device__ __forceinline__ float update(float decay, float h, float b, float u) {
  return __fmaf_rn(decay, h, __fmul_rn(b, u));
}
// y's partial of a lane's S states at one step, sum_j C h in j order.
template <int S>
__device__ __forceinline__ float partial_of(const float (&cv)[S], const float (&h)[S]) {
  float acc = __fmul_rn(cv[0], h[0]);
#pragma unroll
  for (int j = 1; j < S; ++j) acc = __fmaf_rn(cv[j], h[j], acc);
  return acc;
}

// One step of a lane's S states; returns its partial of y.
template <int S>
__device__ __forceinline__ float scan_step(float (&h)[S], const float (&a)[S],
                                           const float* Bt, const float* Ct, float2 xd) {
  float bv[S], cv[S];
  load_vec<S>(Bt, bv);
  load_vec<S>(Ct, cv);
  const float delta = xd.y;
  const float u = __fmul_rn(delta, xd.x);
#pragma unroll
  for (int j = 0; j < S; ++j) h[j] = update(decay_of(delta, a[j]), h[j], bv[j], u);
  return partial_of<S>(cv, h);
}

// A full tile's 16 steps, unrolled, in sub-tiles of U = 16 / S steps:
// first every decay and B u of the sub-tile (no dependence on the chain:
// 16 exps in flight per lane), then the chain, one FMA a step and state,
// with each step's partial of y written to the warp's rows.
template <int S, int NP, int CH>
__device__ __forceinline__ void scan_tile(float (&h)[S], const float (&a)[S], const float* Bs,
                                          const float* Cs, const float2* xd, float* pw) {
  constexpr int U = kTile / S;
#pragma unroll
  for (int s0 = 0; s0 < kTile; s0 += U) {
    float dec[U][S], bv[U][S], u[U];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int tt = s0 + i;
      load_vec<S>(Bs + tt * NP, bv[i]);
      const float2 q = xd[tt * CH];
      const float delta = q.y;
      u[i] = __fmul_rn(delta, q.x);
#pragma unroll
      for (int j = 0; j < S; ++j) dec[i][j] = decay_of(delta, a[j]);
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int tt = s0 + i;
      float cv[S];
      load_vec<S>(Cs + tt * NP, cv);
#pragma unroll
      for (int j = 0; j < S; ++j) h[j] = update(dec[i][j], h[j], bv[i][j], u[i]);
      pw[tt * kPartStride] = partial_of<S>(cv, h);
    }
  }
}

// The warp's y of a tile, for G lanes a channel: each output (step,
// channel) is the pairwise sum, in lane order, of its G lanes' partials,
// taken by one lane (G <= 16) or by two lanes of 16 and a shuffle (G =
// 32); each lane reads 16 partials (kTile / per outputs of per). Written
// to dst (the block's y rows of the tile, CH channels a row) for steps
// below `steps`.
template <int G, int CH>
__device__ __forceinline__ void reduce_tile(const float* part, float* dst, int lane, int steps) {
  constexpr int per = G < kTile ? G : kTile;  // partials a lane sums for one output
  constexpr int R = G / per;                  // lanes per output
  constexpr int K = kTile / per;              // outputs per lane
  constexpr int chw = 32 / G;                 // channels of the warp
  const int o0 = lane / R, r = lane % R;
  const int tt0 = o0 / chw, cw = o0 % chw;    // output k is step tt0 + k * per
  const float* src = part + tt0 * kPartStride + cw * G + r * per;
  float v[kTile];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int j = 0; j < per; ++j) v[k * per + j] = src[k * per * kPartStride + j];
#pragma unroll
  for (int w = 1; w < per; w *= 2)
#pragma unroll
    for (int i = 0; i < kTile / (2 * w); ++i) v[i] = v[2 * i] + v[2 * i + 1];
  if constexpr (R > 1) v[0] += __shfl_xor_sync(0xffffffffu, v[0], 1);
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (r == 0 && tt0 + k * per < steps) dst[(tt0 + k * per) * CH + cw] = v[k];
}

// kWithState seeds h from h0 and stores h_final (both (batch, D, N)),
// else h starts at 0; kSaveBounds stores the state entering every
// kTrainChunk steps; kTimeline records the phase clocks of block (0, 0).
template <int S, int G, bool kWithState, bool kSaveBounds, bool kTimeline>
__global__ void __launch_bounds__(Layout<S, G>::kThreads, Layout<S, G>::kMinBlocks)
    scan_fwd_kernel(const Params p) {
  using Lay = Layout<S, G>;
  constexpr int kThreads = Lay::kThreads;
  constexpr int CH = Lay::kChannels;
  constexpr int NP = Lay::kStates;
  extern __shared__ __align__(16) float smem[];
  const int L = p.L, D = p.D, N = p.N;
  float* sB = smem;                   // [2][kTile][NP]
  float* sC = sB + 2 * kTile * NP;    // [2][kTile][NP]
  float2* sxdt = reinterpret_cast<float2*>(sC + 2 * kTile * NP);  // [2][kTile][CH] (x, dt)
  float* sy = reinterpret_cast<float*>(sxdt + 2 * kTile * CH);     // [2][kTile][CH]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* part = sy + 2 * kTile * CH + warp * kTile * kPartStride;  // [kTile][33]
  const int c = tid / G, g = tid % G;  // channel in the block, lane in the channel
  const int b = blockIdx.y, d0 = blockIdx.x * CH, d = d0 + c;
  const int n_tiles = (L + kTile - 1) / kTile;
  const float* xb = p.x + static_cast<size_t>(b) * L * D + d0;  // this block's channels
  const float* dtb = p.dt + static_cast<size_t>(b) * L * D + d0;
  float* yb = p.y + static_cast<size_t>(b) * L * D + d0;
  const float* Bb = p.B + static_cast<size_t>(b) * L * N;
  const float* Cb = p.C + static_cast<size_t>(b) * L * N;
  const size_t state = (static_cast<size_t>(b) * D + d) * N;  // read only for d < D
  const bool vec_state = p.vec_state != 0;
  // the timeline: every block's (SM, start ns, end ns), then block (0,
  // 0)'s clock64 stamps
  const int n_blocks = gridDim.x * gridDim.y;
  long long* block_record =
      kTimeline ? p.clocks + 1 + 3 * (blockIdx.y * gridDim.x + blockIdx.x) : nullptr;
  long long* clock_out = kTimeline ? p.clocks + 1 + 3 * n_blocks : nullptr;
  const bool timer = kTimeline && tid == 0 && blockIdx.x == 0 && blockIdx.y == 0;
  auto stamp = [&]() {
    if constexpr (kTimeline) {
      if (timer) *clock_out++ = clock64();
    }
  };
  auto global_ns = []() {
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    return static_cast<long long>(ns);
  };
  const long long ns_start = kTimeline && tid == 0 ? global_ns() : 0;

  // This thread's slots in a tile's copies and y stores: item i = tid +
  // r * kThreads of the tile's quads of B and C (16-byte copies, NP / 4 a
  // row) and of its (x, dt) pairs and y values (CH a row). Their rows and
  // offsets within the tile are the same for every tile; offsets within
  // a batch element fit 32 bits (valid_sizes).
  constexpr int kQuads = kTile * NP / 4, kQuadSlots = (kQuads + kThreads - 1) / kThreads;
  constexpr int kPairs = kTile * CH, kPairSlots = (kPairs + kThreads - 1) / kThreads;
  int pair_row[kPairSlots], pair_off[kPairSlots];
#pragma unroll
  for (int r = 0; r < kPairSlots; ++r) {
    const int i = tid + r * kThreads;
    // rows past the tile, or channels past D: never copied or stored
    pair_row[r] = i < kPairs && d0 + i % CH < D ? i / CH : kTile;
    pair_off[r] = (i / CH) * D + i % CH;
  }

  // Tile k's rows of B, C (states n0 .. n0 + NP) and of x, dt (the
  // block's channels) into `slot`, as one copy group.
  auto stage = [&](int k, int slot, int n0) {
    const int t0 = k * kTile, steps = min(kTile, L - t0);
    float* dB = sB + slot * kTile * NP;
    float* dC = sC + slot * kTile * NP;
    const float* Bt = Bb + t0 * N;
    const float* Ct = Cb + t0 * N;
    if (p.vec_bc) {  // N % 4 == 0: a quad of states is all below N or all past it
#pragma unroll
      for (int r = 0; r < kQuadSlots; ++r) {
        const int i = tid + r * kThreads;
        const int row = i / (NP / 4), n = n0 + 4 * (i % (NP / 4));
        if (i < kQuads && row < steps) {
          const int bytes = n < N ? 16 : 0;
          const int off = bytes ? row * N + n : 0;
          cp_async16(dB + 4 * i, Bt + off, bytes);
          cp_async16(dC + 4 * i, Ct + off, bytes);
        }
      }
    } else {
      for (int i = tid; i < steps * NP; i += kThreads) {
        const int n = n0 + i % NP;
        const bool ok = n < N;
        const int off = ok ? (i / NP) * N + n : 0;
        cp_async4(dB + i, Bt + off, ok);
        cp_async4(dC + i, Ct + off, ok);
      }
    }
    float2* dxdt = sxdt + slot * kTile * CH;
#pragma unroll
    for (int r = 0; r < kPairSlots; ++r) {
      const int i = tid + r * kThreads;
      if (i < kPairs && i / CH < steps) {
        const bool ok = pair_row[r] < steps;
        const int off = ok ? t0 * D + pair_off[r] : 0;
        cp_async4(&dxdt[i].x, xb + off, ok);
        cp_async4(&dxdt[i].y, dtb + off, ok);
      }
    }
    cp_async_commit();
  };

  // Tile k's y rows from `slot` to y, coalesced along D (a later pass
  // adds to what the same thread stored in the pass before).
  auto store_rows = [&](int k, int slot, int n0) {
    const int t0 = k * kTile, steps = min(kTile, L - t0);
    const float* src = sy + slot * kTile * CH;
#pragma unroll
    for (int r = 0; r < kPairSlots; ++r) {
      if (pair_row[r] < steps) {
        const int i = tid + r * kThreads;
        float* out = yb + t0 * D + pair_off[r];
        *out = n0 == 0 ? src[i] : *out + src[i];
      }
    }
  };

  stamp();  // kernel start
  for (int n0 = 0; n0 < N; n0 += NP) {
    const int nb = n0 + g * S;  // this lane's first state
    float a[S], h[S];
#pragma unroll
    for (int j = 0; j < S; ++j) a[j] = nb + j < N ? p.A[nb + j] : 0.f;
    if constexpr (kWithState) {
      if (d < D) {
        load_states<S>(p.h0 + state, nb, N, vec_state, h);
      } else {
#pragma unroll
        for (int j = 0; j < S; ++j) h[j] = 0.f;
      }
    } else {
#pragma unroll
      for (int j = 0; j < S; ++j) h[j] = 0.f;
    }

    stage(0, 0, n0);
    for (int k = 0; k < n_tiles; ++k) {
      const int slot = k & 1, steps = min(kTile, L - k * kTile);
      stamp();  // tile start
      cp_async_wait_all();
      __syncthreads();  // tile k staged by every thread; every warp done with tile k - 1
      stamp();  // staged
      if (k + 1 < n_tiles) stage(k + 1, slot ^ 1, n0);
      stamp();  // next tile's copies issued
      if (k > 0) store_rows(k - 1, slot ^ 1, n0);
      if constexpr (kSaveBounds) {
        // the state entering step 16k: (batch, ceil(L/16), D, N)
        if (d < D)
          store_states<S>(p.bounds + ((static_cast<size_t>(b) * n_tiles + k) * D + d) * N, nb,
                          N, vec_state, h);
      }
      stamp();  // stores
      const float* Bs = sB + slot * kTile * NP + g * S;
      const float* Cs = sC + slot * kTile * NP + g * S;
      const float2* xd = sxdt + slot * kTile * CH + c;
      float* pw = part + lane;
      if (steps == kTile) {
        scan_tile<S, NP, CH>(h, a, Bs, Cs, xd, pw);
      } else {
#pragma unroll 1
        for (int tt = 0; tt < steps; ++tt)
          pw[tt * kPartStride] = scan_step<S>(h, a, Bs + tt * NP, Cs + tt * NP, xd[tt * CH]);
      }
      __syncwarp();
      stamp();  // chain
      reduce_tile<G, CH>(part, sy + slot * kTile * CH + warp * Lay::kWarpChannels, lane, steps);
      stamp();  // tile reduced
    }
    __syncthreads();  // the last tile's rows are in sy
    store_rows(n_tiles - 1, (n_tiles - 1) & 1, n0);
    if constexpr (kWithState) {
      if (d < D) store_states<S>(p.h_final + state, nb, N, vec_state, h);
    }
    __syncthreads();  // a next pass restages slot 0 and rewrites sy
    stamp();  // pass end
  }
  if constexpr (kTimeline) {
    if (tid == 0) {
      const long long ns_end = global_ns();
      unsigned sm;
      asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
      block_record[0] = sm;
      block_record[1] = ns_start;
      block_record[2] = ns_end;
      if (timer) {
        // the global nanosecond clock at the first and the last stamp:
        // the SM clock the stamps ran at
        p.clocks[0] = n_blocks;
        clock_out[0] = ns_start;
        clock_out[1] = ns_end;
      }
    }
  }
}

template <int S, int G, bool kWithState, bool kSaveBounds, bool kTimeline>
cudaError_t launch(const Plan& plan, const Params& p, cudaStream_t stream) {
  auto kernel = scan_fwd_kernel<S, G, kWithState, kSaveBounds, kTimeline>;
  if constexpr (smem_bytes(S, G) > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(plan.smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<plan.grid, plan.threads, plan.smem, stream>>>(p);
  return cudaGetLastError();
}

// Sizes the kernel takes: non-empty, a batch within the grid's 65,535,
// and one batch element's rows within 32-bit offsets.
bool valid_sizes(int batch, int L, int D, int N) {
  return batch > 0 && L > 0 && D > 0 && N > 0 && batch <= 65535 &&
         static_cast<long long>(L + kTile) * (D > N ? D : N) < (1LL << 31);
}

template <int S, bool kWithState, bool kSaveBounds, bool kTimeline>
cudaError_t launch_lanes(const Plan& plan, const Params& p, cudaStream_t stream) {
  switch (plan.lanes) {
    case 8: return launch<S, 8, kWithState, kSaveBounds, kTimeline>(plan, p, stream);
    case 16: return launch<S, 16, kWithState, kSaveBounds, kTimeline>(plan, p, stream);
    default: return launch<S, 32, kWithState, kSaveBounds, kTimeline>(plan, p, stream);
  }
}

// Any N >= 1 and D >= 1. Returns cudaErrorInvalidValue for sizes
// valid_sizes refuses and otherwise the launch's error code.
template <bool kWithState, bool kSaveBounds, bool kTimeline = false>
cudaError_t dispatch(Params p, int batch, cudaStream_t stream) {
  if (!valid_sizes(batch, p.L, p.D, p.N)) return cudaErrorInvalidValue;
  const Plan plan = plan_for(batch, p.D, p.N);
  p.vec_bc = p.N % 4 == 0 && aligned(p.B, 16) && aligned(p.C, 16);
  const int w = 4 * plan.S;
  p.vec_state = p.N % plan.S == 0 && aligned(p.h0, w) && aligned(p.h_final, w) &&
                aligned(p.bounds, w);
  switch (plan.S) {
    case 1: return launch_lanes<1, kWithState, kSaveBounds, kTimeline>(plan, p, stream);
    case 2: return launch_lanes<2, kWithState, kSaveBounds, kTimeline>(plan, p, stream);
    default: return launch_lanes<4, kWithState, kSaveBounds, kTimeline>(plan, p, stream);
  }
}

template <int S, int G, bool kWithState, bool kSaveBounds>
cudaError_t occupancy(const Plan& plan, int* out) {
  auto kernel = scan_fwd_kernel<S, G, kWithState, kSaveBounds, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(plan.smem));
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int per_sm;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, plan.threads, plan.smem);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(plan.smem);
  out[3] = per_sm;
  out[4] = plan.threads;
  out[5] = plan.S;
  out[6] = plan.lanes;
  out[7] = plan.channels;
  out[8] = static_cast<int>(plan.grid.x);
  out[9] = static_cast<int>(plan.grid.y);
  out[10] = plan.passes;
  return cudaSuccess;
}

template <int S, bool kWithState, bool kSaveBounds>
cudaError_t occupancy_lanes(const Plan& plan, int* out) {
  switch (plan.lanes) {
    case 8: return occupancy<S, 8, kWithState, kSaveBounds>(plan, out);
    case 16: return occupancy<S, 16, kWithState, kSaveBounds>(plan, out);
    default: return occupancy<S, 32, kWithState, kSaveBounds>(plan, out);
  }
}

template <bool kWithState, bool kSaveBounds>
cudaError_t occupancy_for(const Plan& plan, int* out) {
  switch (plan.S) {
    case 1: return occupancy_lanes<1, kWithState, kSaveBounds>(plan, out);
    case 2: return occupancy_lanes<2, kWithState, kSaveBounds>(plan, out);
    default: return occupancy_lanes<4, kWithState, kSaveBounds>(plan, out);
  }
}

}  // namespace

// The offline scan: h[-1] = 0, no carried state.
extern "C" cudaError_t scan_fwd_f32(const float* x, const float* dt,
                                    const float* A, const float* B,
                                    const float* C, float* y, int batch,
                                    int L, int D, int N, cudaStream_t stream) {
  const Params p{x, dt, A, B, C, nullptr, y, nullptr, nullptr, nullptr, L, D, N, 0, 0};
  return dispatch<false, false>(p, batch, stream);
}

// The streaming scan: h[-1] = h0, h_final = h[L-1]; h0 and h_final are
// (batch, D, N) fp32 and must not overlap.
extern "C" cudaError_t scan_fwd_state_f32(const float* x, const float* dt,
                                          const float* A, const float* B,
                                          const float* C, const float* h0,
                                          float* y, float* h_final, int batch,
                                          int L, int D, int N,
                                          cudaStream_t stream) {
  const Params p{x, dt, A, B, C, h0, y, h_final, nullptr, nullptr, L, D, N, 0, 0};
  return dispatch<true, false>(p, batch, stream);
}

// The training forward: h[-1] = 0, and bounds (batch, ceil(L/16), D, N)
// fp32 receives the state entering each 16-step chunk (chunk 0: zeros).
extern "C" cudaError_t scan_fwd_bounds_f32(const float* x, const float* dt,
                                           const float* A, const float* B,
                                           const float* C, float* y,
                                           float* bounds, int batch, int L,
                                           int D, int N, cudaStream_t stream) {
  const Params p{x, dt, A, B, C, nullptr, y, nullptr, bounds, nullptr, L, D, N, 0, 0};
  return dispatch<false, true>(p, batch, stream);
}

// The streaming-aware training forward: h[-1] = h0, h_final = h[L-1], and
// bounds (batch, ceil(L/16), D, N) fp32 receives the state entering each
// 16-step chunk (chunk 0: h0). h0, h_final and bounds must not overlap.
extern "C" cudaError_t scan_fwd_bounds_state_f32(
    const float* x, const float* dt, const float* A, const float* B,
    const float* C, const float* h0, float* y, float* bounds, float* h_final,
    int batch, int L, int D, int N, cudaStream_t stream) {
  const Params p{x, dt, A, B, C, h0, y, h_final, bounds, nullptr, L, D, N, 0, 0};
  return dispatch<true, true>(p, batch, stream);
}

// Words scan_fwd_timeline_f32 writes for these sizes: the number of
// blocks; each block's (SM id, global timer ns at its start, at its end);
// then block (0, 0)'s thread 0's clock64() at the kernel's start, per
// pass of states 6 per tile of 16 steps (at the tile's start; staged;
// next tile's copies issued; previous y rows and this tile's bounds
// stored; chain done; tile reduced) and one at the pass's end (last rows
// and h_final stored); and its global timer at the first and the last of
// those stamps. 0 for an empty size.
extern "C" long long scan_fwd_timeline_clocks(int batch, int L, int D, int N) {
  if (!valid_sizes(batch, L, D, N)) return 0;
  const Plan plan = plan_for(batch, D, N);
  const long long n_tiles = (L + kTile - 1) / kTile;
  return 1 + 3LL * plan.grid.x * plan.grid.y + 1 + plan.passes * (kStamps * n_tiles + 1) + 2;
}

// The offline scan (save_bounds = 0) or the training forward (1), as
// scan_fwd_f32 / scan_fwd_bounds_f32 compute them, with block (0, 0)'s
// thread 0 writing the clocks above to `clocks` (n_clocks >=
// scan_fwd_timeline_clocks). For reading where a block's time goes; no
// path calls it.
extern "C" cudaError_t scan_fwd_timeline_f32(const float* x, const float* dt,
                                             const float* A, const float* B,
                                             const float* C, float* y, float* bounds,
                                             long long* clocks, long long n_clocks,
                                             int save_bounds, int batch, int L, int D,
                                             int N, cudaStream_t stream) {
  if (!valid_sizes(batch, L, D, N) || n_clocks < scan_fwd_timeline_clocks(batch, L, D, N) ||
      (save_bounds && bounds == nullptr))
    return cudaErrorInvalidValue;
  const Params p{x, dt, A, B, C, nullptr, y, nullptr, save_bounds ? bounds : nullptr,
                 clocks, L, D, N, 0, 0};
  if (save_bounds) return dispatch<false, true, true>(p, batch, stream);
  return dispatch<false, false, true>(p, batch, stream);
}

// What the launcher runs for (batch, D, N) and what the build and the
// card give that instantiation (with_state, save_bounds: the entry's
// flags): out = {registers per thread, local (spill) bytes per thread,
// dynamic shared bytes per block, resident blocks per SM, threads per
// block, states per thread S, lanes per channel G, channels per block,
// grid x (channel blocks), grid y (batch), passes of states}.
extern "C" cudaError_t scan_fwd_occupancy(int batch, int D, int N, int with_state,
                                          int save_bounds, int* out) {
  if (!valid_sizes(batch, 1, D, N)) return cudaErrorInvalidValue;
  const Plan plan = plan_for(batch, D, N);
  if (with_state)
    return save_bounds ? occupancy_for<true, true>(plan, out)
                       : occupancy_for<true, false>(plan, out);
  return save_bounds ? occupancy_for<false, true>(plan, out)
                     : occupancy_for<false, false>(plan, out);
}

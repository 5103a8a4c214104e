// Int8 dense: symmetric int8 activations (one scale per row, or one
// calibrated scale per tensor) against per-output-channel int8 weights,
// the products on the tensor cores.
//
// Replaces: velocity_asr_tpu/ops/int8_matmul.py `_int8_dynamic_kernel`
// (int8_dense_dynamic_f32) and `_int8_kernel` (int8_dense_static_f32),
// both launched by `int8_dot_pallas`.
//
// Computes, for x (M, K) fp32 or bf16 (x_type; bf16 is widened to fp32,
// which is exact), codes w_q (N, K) int8 (torch's Linear layout,
// contiguous in K) and w_scale (N,) fp32:
//   s[m]     = max(max_k |x[m,k]| / 127, 1e-10)        (dynamic), or
//              the device scalar *x_scale                (static)
//   q[m,k]   = clamp(rint(x[m,k] / s[m]), -127, 127)     (half to even)
//   out[m,n] = float(sum_k q[m,k] * w_q[n,k]) * (s[m] * w_scale[n])
// which is the arithmetic of `int8_dot_xla` (int8_matmul.py:43-67), the
// function the JAX package computes for every projection of the synth
// checkpoint: both quotients are the IEEE ones (see row_scale and
// codes4), and the int32 sum is exact, so the order of the products does
// not show.
//
// What bounds it on an H100: bytes. At the main path's shapes (M = 16 to
// 6400 rows, K = 48 to 384, N = 30 to 192) a call reads x and writes out
// in fp32 against 2*K int8 operations per output: at (4800, 192, 192)
// the bytes take 2.2 us at 3.35 TB/s and the products 0.18 us at the
// int8 rate. So the products use mma.sync m16n8k32 (s8 x s8 -> s32), not
// wgmma: its 64-row warpgroup tiles and descriptors buy nothing until a
// profile shows the products setting the pace.
//
// The design:
// - A block of 3 groups of 4 warps owns a range of at most 192 output
//   channels (the grid's y; more ranges, down to 8 channels, when the row
//   tiles are too few to give every SM a block) and walks row tiles of 16
//   rows (the mma's m16), one per group at a time: tile i of a range goes
//   to block i % grid_x, within it to the groups in turn. The grid's x is
//   at most what the card holds at once.
// - The block's weight codes are staged once, with 16-byte cp.async (for
//   bf16 x after the first tile's x, so the copy goes on while its codes
//   are made), a channel's codes at a stride of 32 or 96 modulo 128
//   bytes, so a lane's B fragment (8 codes) is one 64-bit load and the 4
//   channels a half-warp reads fall in different banks. When they fit 96 KB of
//   shared memory (K <= 480 at 192 channels, so every config's
//   projection) they stay for the block's whole walk; past that K runs in
//   stages, and the next stage's codes load into a second slot while the
//   current one multiplies. So any K is taken, and the shared memory
//   depends on the stage, not on K.
// - A group stages its tile's x (up to 384 values a row at a time) with
//   16-byte cp.async, read as it is: fp32 or bf16. Each row's 8 threads
//   take the row's |x| max (a shuffle over the 8) and its codes, which
//   they write into the A fragments of the mma in shared memory: the
//   values 8q..8q+7 of a 32-wide chunk go to the fragment's k 4q..4q+3
//   and 16+4q..16+4q+3, and the weight's 8-byte loads use the same map,
//   which the sum over k does not see. The codes come from v * (1 / s):
//   it rounds to the integer that the IEEE v / s does unless it lies
//   within a few ulps of a half-integer, and those rare values are
//   redone by the division (out of line, after the loop).
// - A group's 4 warps then split its channels (n8 tiles w, w + 4, ...);
//   each lane loads its 16-byte A fragment and 8-byte B fragments and
//   accumulates in int32. K is padded to a multiple of 32 with codes that
//   are 0; the N tail is masked at the store. Outputs are dequantized in
//   int8_dot_xla's order and stored from the accumulators, two floats a
//   thread (each warp store fills whole 32-byte sectors).
// - x_q_out, when given, receives the codes: a check that the kernel
//   quantizes as the plain version does. No atomics: one deterministic
//   launch per call.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kGroups = 3;                          // row tiles a block works on at once
constexpr int kGroupThreads = 128;                  // 4 warps a row tile
constexpr int kThreads = kGroups * kGroupThreads;
constexpr int kTileRows = 16;                       // the mma's m16
constexpr int kRowThreads = kGroupThreads / kTileRows;  // 8 threads quantize a row
constexpr int kMaxTiles8 = 24;                      // n8 tiles a block owns at most: 192 channels
constexpr int kWarpTiles8 = kMaxTiles8 / 4;         // of which each warp of a group takes 6
constexpr int kChunk = 32;                          // codes of K per mma: the mma's k32
constexpr int kStageChunks = 12;                    // chunks of x a stage holds: K = 384
constexpr int kFragBytes = 32 * 16;                 // one chunk's A fragments: 16 B a lane
constexpr int kWeightBudget = 96 * 1024;            // weight codes a block keeps
constexpr int kSmemMax = kWeightBudget + kGroups * (kTileRows * kStageChunks * kChunk * 4 +
                                                    kStageChunks * kFragBytes + kTileRows * 4);

enum XType { kF32 = 0, kBF16 = 1 };

// How a call is cut: every size the kernel needs, worked out on the host.
struct Plan {
  int row_tiles;     // ceil(M / 16)
  int n_tiles8;      // ceil(N / 8)
  int tiles8;        // n8 tiles per channel range (a block's)
  int n_splits;      // channel ranges: the grid's y
  int k_chunks;      // ceil(K / 32)
  int stage_chunks;  // chunks of K per stage
  int n_stages;      // stages per row tile
  int resident;      // 1: every chunk of the weight stays in shared memory
  int w_row_bytes;   // a channel's codes in shared memory (a slot's, when staged)
  int x_row_bytes;   // a row of a stage of x in shared memory
  int grid_x;        // blocks per channel range
  int smem;          // dynamic shared bytes
};

// Bytes a channel's codes of `chunks` chunks take in shared memory: a
// stride of 32 or 96 modulo 128, so the 4 channels a half-warp's B
// fragments read (32 bytes each) fall in different banks.
__host__ __device__ constexpr int row_stride(int chunks) {
  return kChunk * chunks + (chunks % 2 == 0 ? kChunk : 0);
}

// Everything but grid_x, which depends on how many blocks the card holds.
Plan make_plan(int M, int K, int N, int x_bytes, int sms) {
  Plan p;
  p.row_tiles = (M + kTileRows - 1) / kTileRows;
  p.n_tiles8 = (N + 7) / 8;
  // one step of kGroups row tiles per block; where those blocks leave SMs
  // idle (small M), more channel ranges, down to one n8 tile each
  const int row_blocks = (p.row_tiles + kGroups - 1) / kGroups;
  int splits = sms / row_blocks;
  if (splits > p.n_tiles8) splits = p.n_tiles8;
  const int least = (p.n_tiles8 + kMaxTiles8 - 1) / kMaxTiles8;
  if (splits < least) splits = least;
  p.tiles8 = (p.n_tiles8 + splits - 1) / splits;
  p.n_splits = (p.n_tiles8 + p.tiles8 - 1) / p.tiles8;
  p.k_chunks = (K + kChunk - 1) / kChunk;
  const int rows = 8 * p.tiles8;
  p.resident = rows * row_stride(p.k_chunks) <= kWeightBudget;
  int stage = p.k_chunks;
  if (!p.resident)  // the largest stage whose two slots fit the budget
    while (2 * rows * row_stride(stage) > kWeightBudget) --stage;
  if (stage > kStageChunks) stage = kStageChunks;
  p.stage_chunks = stage;
  p.n_stages = (p.k_chunks + stage - 1) / stage;
  p.w_row_bytes = row_stride(p.resident ? p.k_chunks : stage);
  p.x_row_bytes = stage * kChunk * x_bytes;
  const int weight = (p.resident ? 1 : 2) * rows * p.w_row_bytes;
  p.smem = weight + kGroups * (kTileRows * p.x_row_bytes + stage * kFragBytes + kTileRows * 4);
  p.grid_x = row_blocks;
  return p;
}

// 16 bytes from global to shared memory, asynchronously (both 16-byte
// aligned).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Wait until at most `pending` (0, 1 or 2) of the latest copy groups are
// in flight.
__device__ __forceinline__ void cp_async_wait_but(int pending) {
  if (pending == 0)
    cp_async_wait<0>();
  else if (pending == 1)
    cp_async_wait<1>();
  else
    cp_async_wait<2>();
}

// Up to 16 bytes (`bytes`, a multiple of the element) from an unaligned
// src, zeros after: the fallback of the 16-byte copies.
__device__ __forceinline__ void copy_bytes(void* dst, const unsigned char* src, int bytes) {
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (j < bytes) w[j / 4] |= static_cast<unsigned>(src[j]) << (8 * (j % 4));
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// Stage the weight codes of channels [n0, n0 + 8 * tiles8) over the
// chunks [chunk0, chunk0 + n_chunks) of K into dst, a channel every
// row_bytes (8 threads a channel, 16 bytes each in turn). Codes past K are
// left as they are: the activation codes there are 0. All the block's
// threads take part.
__device__ void load_weight(unsigned char* dst, const int8_t* __restrict__ w_q, int n0,
                            int tiles8, int chunk0, int n_chunks, int row_bytes, int K, int N,
                            bool vec) {
  const int k0 = chunk0 * kChunk;
  const int bytes = min(n_chunks * kChunk, K - k0);
  for (int row = threadIdx.x / 8; row < 8 * tiles8 && n0 + row < N; row += kThreads / 8) {
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(w_q) + static_cast<size_t>(n0 + row) * K + k0;
    unsigned char* d = dst + row * row_bytes;
    for (int b = 16 * (threadIdx.x % 8); b < bytes; b += 128) {
      if (vec)
        cp_async16(d + b, src + b);
      else
        copy_bytes(d + b, src + b, min(16, bytes - b));
    }
  }
}

// Stage row r of a row tile's x over the chunks [chunk0, chunk0 +
// n_chunks) into dst (the row's 8 threads, 16 bytes each in turn). Values
// past K are left as they are (the codes there are taken as 0), and so is
// a row past M (its codes reach only outputs that are not stored).
template <typename T>
__device__ __forceinline__ void load_x_row(unsigned char* dst, const T* __restrict__ x, int m,
                                           int chunk0, int n_chunks, int K, bool vec, int u) {
  const int k0 = chunk0 * kChunk;
  const int bytes = min(n_chunks * kChunk, K - k0) * static_cast<int>(sizeof(T));
  const unsigned char* src =
      reinterpret_cast<const unsigned char*>(x + static_cast<size_t>(m) * K + k0);
  for (int b = 16 * u; b < bytes; b += 16 * kRowThreads) {
    if (vec)
      cp_async16(dst + b, src + b);
    else
      copy_bytes(dst + b, src + b, min(16, bytes - b));
  }
}

// A 16-byte piece of x in shared memory as fp32 values (bf16 widened,
// exactly: its bits are the high half of an fp32); values from K on (the
// piece's first value is value k of the row) are 0.
__device__ __forceinline__ void piece_values(const float* src, float v[4], int k, int K) {
  const float4 f = *reinterpret_cast<const float4*>(src);
  v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  if (k + 4 > K) {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = k + j < K ? v[j] : 0.f;
  }
}

__device__ __forceinline__ void piece_values(const uint16_t* src, float v[8], int k, int K) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[2 * j] = __uint_as_float(w[j] << 16);
    v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
  if (k + 8 > K) {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = k + j < K ? v[j] : 0.f;
  }
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(uint16_t b) {
  return __uint_as_float(static_cast<unsigned>(b) << 16);
}

// The largest |x| of 8 values of a row in global memory from k, zeros
// past K (the first pass of a dynamic scale over several stages).
template <typename T>
__device__ __forceinline__ float abs_max_global(const T* row, int k, int K) {
  float a = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (k + j < K) a = fmaxf(a, fabsf(widen(row[k + j])));
  return a;
}

// The max over the kRowThreads consecutive lanes of a row.
__device__ __forceinline__ float row_max(float a) {
#pragma unroll
  for (int off = 1; off < kRowThreads; off <<= 1)
    a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, off));
  return a;
}

__device__ __forceinline__ unsigned pack4(int c0, int c1, int c2, int c3) {
  return __byte_perm(__byte_perm(c0, c1, 0x0040), __byte_perm(c2, c3, 0x0040), 0x5410);
}

__device__ __forceinline__ int clamp_code(float t) {
  return static_cast<int>(fminf(fmaxf(t, -127.f), 127.f));
}

// The dynamic scale max(a / 127, 1e-10) with the IEEE quotient, a >= 0:
// a * (1 / 127) is within an ulp of a / 127, and the correctly rounded
// quotient is the one of it and its two neighbours whose residual
// a - 127 q (exact with an FMA) is least. (Short of the division's
// latency, which sat on every row's path.)
__device__ __forceinline__ float row_scale(float a) {
  const float q = a * (1.f / 127.f);
  const float lo = __int_as_float(__float_as_int(q) - 1);
  const float hi = __int_as_float(__float_as_int(q) + 1);
  float best = q, res = fabsf(fmaf(-q, 127.f, a));
  const float res_lo = fabsf(fmaf(-lo, 127.f, a)), res_hi = fabsf(fmaf(-hi, 127.f, a));
  if (res_lo < res) best = lo, res = res_lo;
  if (res_hi < res) best = hi;
  return fmaxf(best, 1e-10f);
}

// 1 / s within an ulp (s >= 1e-10, a normal number).
__device__ __forceinline__ float reciprocal(float s) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(s));
  return r;
}

// The codes of 4 values, clamp(rint(v / s), -127, 127) with rint half to
// even and v / s the IEEE quotient, packed into a word (value j in byte
// j), from z = v * inv (inv within an ulp of 1 / s): z lies within 4
// ulps of v / s's float, so the two round to the same integer unless z is
// within a few ulps of a half-integer. Such a value sets `near` (the test
// |z - rint(z)| >= 0.5 - 2e-6 |z| holds 30 ulps and more), and its word
// is redone by codes4_divided.
__device__ __forceinline__ unsigned codes4(const float v[4], float inv, bool& near) {
  int c[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float z = v[j] * inv;
    const float t = rintf(z);
    near |= fabsf(z - t) >= fmaf(-2e-6f, fabsf(z), 0.5f);
    c[j] = clamp_code(t);
  }
  return pack4(c[0], c[1], c[2], c[3]);
}

// The same by the IEEE division.
__device__ __noinline__ unsigned codes4_divided(float v0, float v1, float v2, float v3,
                                                float s) {
  return pack4(clamp_code(rintf(v0 / s)), clamp_code(rintf(v1 / s)), clamp_code(rintf(v2 / s)),
               clamp_code(rintf(v3 / s)));
}

// D = A B + D for a 16 x 32 s8 A (row), a 32 x 8 s8 B (col), s32 D.
__device__ __forceinline__ void mma_s8(int* d, uint4 a, uint2 b) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ void store2(float* row, int n, int N, bool pair, float a, float b) {
  if (pair && n + 1 < N) {
    *reinterpret_cast<float2*>(row + n) = make_float2(a, b);
  } else {
    if (n < N) row[n] = a;
    if (n + 1 < N) row[n + 1] = b;
  }
}

template <bool kStatic, typename T>
__global__ void __launch_bounds__(kThreads) int8_dense_kernel(
    const T* __restrict__ x, const float* __restrict__ x_scale,
    const int8_t* __restrict__ w_q, const float* __restrict__ w_scale,
    float* __restrict__ out, int8_t* __restrict__ x_q_out, int M, int K, int N, Plan p) {
  constexpr int kVals = 16 / sizeof(T);  // values of x a 16-byte piece holds
  extern __shared__ __align__(16) unsigned char smem[];
  const int slot_bytes = 8 * p.tiles8 * p.w_row_bytes;
  const int group = threadIdx.x / kGroupThreads;
  const int gt = threadIdx.x % kGroupThreads;
  // the weight (every chunk, or two slots of a stage), then per group its
  // stage of x, its A fragments and its rows' scales
  unsigned char* s_w = smem;
  unsigned char* s_x = smem + (p.resident ? 1 : 2) * slot_bytes +
                       group * (kTileRows * p.x_row_bytes + p.stage_chunks * kFragBytes +
                                kTileRows * 4);
  unsigned char* s_frag = s_x + kTileRows * p.x_row_bytes;
  float* s_scale = reinterpret_cast<float*>(s_frag + p.stage_chunks * kFragBytes);

  const int r = gt / kRowThreads, u = gt % kRowThreads;  // quantizing: 8 threads a row
  const int warp = gt / 32, lane = gt % 32;               // products: a fragment lane
  const int g = lane / 4, q = lane % 4;
  const int n0 = blockIdx.y * p.tiles8 * 8;
  const int tiles8 = min(p.tiles8, p.n_tiles8 - static_cast<int>(blockIdx.y) * p.tiles8);
  const bool x_vec = K % kVals == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool w_vec = K % 16 == 0 && reinterpret_cast<uintptr_t>(w_q) % 16 == 0;
  const bool pair = N % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 8 == 0;
  // this block's row tiles: blockIdx.x, + grid_x, ...; group j of the
  // block takes the j-th of each kGroups
  const int my_tiles = (p.row_tiles - static_cast<int>(blockIdx.x) + p.grid_x - 1) / p.grid_x;
  const int iters = (my_tiles + kGroups - 1) / kGroups;
  const int steps = iters * p.n_stages;  // the same in every thread of the block
  const float static_scale = kStatic ? *x_scale : 0.f;

  // the channel scales of the fragment columns this lane stores
  float w_sc[kWarpTiles8][2];
#pragma unroll
  for (int jj = 0; jj < kWarpTiles8; ++jj) {
    const int n = n0 + 8 * (warp + 4 * jj) + 2 * q;
    w_sc[jj][0] = n < N ? w_scale[n] : 0.f;
    w_sc[jj][1] = n + 1 < N ? w_scale[n + 1] : 0.f;
  }

  // fp32 x: the weight's copy goes first; bf16 x (half the bytes): after
  // the first tile's x, going on while its codes are made. Each order was
  // the faster for its type in CUDA-graph device time on an H100.
  constexpr bool kWeightFirst = sizeof(T) == 4;
  if (kWeightFirst) {
    load_weight(s_w, w_q, n0, tiles8, 0, p.resident ? p.k_chunks : p.stage_chunks,
                p.w_row_bytes, K, N, w_vec);
    cp_async_commit();
  }

  int step = 0;
  for (int it = 0; it < iters; ++it) {
    const int local = group + kGroups * it;
    const bool active = local < my_tiles;
    const int tile_m = (static_cast<int>(blockIdx.x) + p.grid_x * local) * kTileRows;
    const int m = tile_m + r;
    const bool valid = active && m < M;
    int8_t* codes = x_q_out != nullptr && valid ? x_q_out + static_cast<size_t>(m) * K : nullptr;

    // A dynamic scale over several stages: a first pass over the row.
    float s = static_scale;
    if (!kStatic && p.n_stages > 1) {
      float amax = 0.f;
      if (valid) {
        const T* row = x + static_cast<size_t>(m) * K;
        for (int k = 8 * u; k < K; k += 8 * kRowThreads) amax = fmaxf(amax, abs_max_global(row, k, K));
      }
      s = row_scale(row_max(amax));
    }

    int acc[kWarpTiles8][4];
#pragma unroll
    for (int jj = 0; jj < kWarpTiles8; ++jj) acc[jj][0] = acc[jj][1] = acc[jj][2] = acc[jj][3] = 0;
    float s0 = 0.f, s1 = 0.f;  // the scales of the fragment's rows g and g + 8
    for (int st = 0; st < p.n_stages; ++st, ++step) {
      const int chunk0 = st * p.stage_chunks;
      const int n_chunks = min(p.stage_chunks, p.k_chunks - chunk0);
      // 1. This stage of the tile's x; then, at the first step, the weight
      //    (all of it, or its first stage) unless it went first, and, when
      //    it runs in stages, the next step's stage into the other slot.
      //    The codes need only x.
      if (valid) load_x_row(s_x + r * p.x_row_bytes, x, m, chunk0, n_chunks, K, x_vec, u);
      cp_async_commit();
      int after_x = 0;  // copy groups committed after this stage's x
      if (!kWeightFirst && step == 0) {
        load_weight(s_w, w_q, n0, tiles8, 0, p.resident ? p.k_chunks : p.stage_chunks,
                    p.w_row_bytes, K, N, w_vec);
        cp_async_commit();
        ++after_x;
      }
      const bool prefetch = !p.resident && step + 1 < steps;
      if (prefetch) {
        const int next0 = ((step + 1) % p.n_stages) * p.stage_chunks;
        load_weight(s_w + ((step + 1) & 1) * slot_bytes, w_q, n0, tiles8, next0,
                    min(p.stage_chunks, p.k_chunks - next0), p.w_row_bytes, K, N, w_vec);
        cp_async_commit();
        ++after_x;
      }
      cp_async_wait_but(after_x);
      __syncthreads();

      // 2. The row's scale and codes: thread u of the row takes the
      //    16-byte pieces u, u + 8, ... (kVals values each). The 8 values
      //    8i..8i+7 of the stage go to lane 4 (r % 8) + i % 4 of chunk i / 4:
      //    the first 4 to its word r / 8, the next to 2 + r / 8 (the mma's k
      //    4q..4q+3 and 16+4q..16+4q+3 hold 8q..8q+7; the weight is staged
      //    with the same map, and the sum over k does not see it).
      const T* xs = reinterpret_cast<const T*>(s_x + r * p.x_row_bytes);
      const int pieces = n_chunks * kChunk / kVals;
      // the stage's pieces that hold x (none for a row past M: its codes are 0)
      const int in_k = valid ? min(pieces, (K - chunk0 * kChunk + kVals - 1) / kVals) : 0;
      if (active) {  // warp-uniform: a warp's lanes load rows of one tile
        if (!kStatic && p.n_stages == 1) {
          float amax = 0.f;
#pragma unroll 3
          for (int pc = u; pc < in_k; pc += kRowThreads) {
            float v[kVals];
            piece_values(xs + pc * kVals, v, chunk0 * kChunk + pc * kVals, K);
#pragma unroll
            for (int j = 0; j < kVals; ++j) amax = fmaxf(amax, fabsf(v[j]));
          }
          s = row_scale(row_max(amax));
        }
        if (st == 0 && u == 0) s_scale[r] = s;
        const float inv = reciprocal(s);
        // where this thread's words go: piece u + 8 t holds the stage's
        // values f = (u + 8 t) kVals + 4 h, h < kVals / 4, whose word sits
        // in chunk f / 32 (t kVals / 4 chunks on per t), lane
        // 4 (r % 8) + (f / 8) % 4, word (f % 8 ? 2 : 0) + r / 8
        unsigned* frag[kVals / 4];
#pragma unroll
        for (int h = 0; h < kVals / 4; ++h) {
          const int f = u * kVals + 4 * h;
          frag[h] = reinterpret_cast<unsigned*>(
              s_frag + (f / 32) * kFragBytes + (4 * (r % 8) + (f / 8) % 4) * 16 +
              ((f % 8 ? 2 : 0) + r / 8) * 4);
        }
        constexpr int kFragStep = kVals / 4 * kFragBytes / 4;  // words per t
        unsigned redo = 0;  // pieces with a value near a half-integer quotient, a bit each
#pragma unroll 3
        for (int pc = u, t = 0; pc < pieces; pc += kRowThreads, ++t) {
          float v[kVals];
          piece_values(xs + pc * kVals, v, pc < in_k ? chunk0 * kChunk + pc * kVals : 0,
                       pc < in_k ? K : 0);
          bool near = false;
#pragma unroll
          for (int h = 0; h < kVals / 4; ++h) frag[h][t * kFragStep] = codes4(v + 4 * h, inv, near);
          redo |= static_cast<unsigned>(near) << t;
        }
        while (redo != 0) {  // rare: those pieces by the division
          const int t = __ffs(redo) - 1;
          redo &= redo - 1;
          const int pc = u + kRowThreads * t;
          float v[kVals];
          piece_values(xs + pc * kVals, v, pc < in_k ? chunk0 * kChunk + pc * kVals : 0,
                       pc < in_k ? K : 0);
#pragma unroll
          for (int h = 0; h < kVals / 4; ++h)
            frag[h][t * kFragStep] =
                codes4_divided(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3], s);
        }
        if (codes != nullptr) {  // the codes out, for checks
          for (int pc = u, t = 0; pc < in_k; pc += kRowThreads, ++t) {
#pragma unroll
            for (int h = 0; h < kVals / 4; ++h) {
              const unsigned word = frag[h][t * kFragStep];
              const int k = chunk0 * kChunk + pc * kVals + 4 * h;
#pragma unroll
              for (int j = 0; j < 4; ++j)
                if (k + j < K) codes[k + j] = static_cast<int8_t>(word >> (8 * j));
            }
          }
        }
      }
      cp_async_wait_but(prefetch ? 1 : 0);  // this step's weight has landed
      __syncthreads();

      // 3. The products of this stage: warp w of the group takes the n8
      //    tiles w, w + 4, ...
      if (st == 0) s0 = s_scale[g], s1 = s_scale[g + 8];
      // lane (g, q)'s B fragment of n8 tile j and chunk c: channel 8 j + g,
      // codes 32 c + 8 q .. + 7
      const unsigned char* b_lane =
          (p.resident ? s_w + chunk0 * kChunk : s_w + (step & 1) * slot_bytes) +
          (8 * warp + g) * p.w_row_bytes + 8 * q;
      const int b_tile = 32 * p.w_row_bytes;  // 4 n8 tiles on
      if (active) {
        for (int c = 0; c < n_chunks; ++c) {
          const uint4 a = *reinterpret_cast<const uint4*>(s_frag + c * kFragBytes + 16 * lane);
#pragma unroll
          for (int jj = 0; jj < kWarpTiles8; ++jj) {
            if (warp + 4 * jj < tiles8)
              mma_s8(acc[jj], a,
                     *reinterpret_cast<const uint2*>(b_lane + jj * b_tile + c * kChunk));
          }
        }
      }
      __syncthreads();  // x, the fragments, the scales and the weight slot are free again
    }

    // 4. Dequantize: float(acc) * (s[m] * w_scale[n]), int8_dot_xla's order.
    if (active) {
      const int m0 = tile_m + g, m1 = m0 + 8;
      float* out0 = out + static_cast<size_t>(m0 < M ? m0 : 0) * N;
      float* out1 = out + static_cast<size_t>(m1 < M ? m1 : 0) * N;
#pragma unroll
      for (int jj = 0; jj < kWarpTiles8; ++jj) {
        const int j = warp + 4 * jj;
        if (j < tiles8) {
          const int n = n0 + 8 * j + 2 * q;
          const float w0 = w_sc[jj][0], w1 = w_sc[jj][1];
          if (m0 < M)
            store2(out0, n, N, pair, static_cast<float>(acc[jj][0]) * (s0 * w0),
                   static_cast<float>(acc[jj][1]) * (s0 * w1));
          if (m1 < M)
            store2(out1, n, N, pair, static_cast<float>(acc[jj][2]) * (s1 * w0),
                   static_cast<float>(acc[jj][3]) * (s1 * w1));
        }
      }
    }
  }
}

// SMs of the current device, cached per device.
cudaError_t sm_count(int* sms) {
  static int cached[64] = {};
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 0 && device < 64 && cached[device] > 0) {
    *sms = cached[device];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess && device >= 0 && device < 64) cached[device] = *sms;
  return err;
}

// The kernel's opt-in to kSmemMax of dynamic shared memory, once per
// instantiation and device.
template <bool kStatic, typename T>
cudaError_t allow_smem() {
  static unsigned long long done = 0;  // a bit per device
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = device < 64 ? 1ull << device : 0ull;
  if (done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(int8_dense_kernel<kStatic, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (err == cudaSuccess) done |= bit;
  return err;
}

// Resident blocks per SM of the instantiation at `smem` dynamic shared
// bytes, remembered for the last few sizes asked about (the shapes of a
// forward differ in shared memory).
template <bool kStatic, typename T>
cudaError_t blocks_per_sm(int smem, int* per_sm) {
  constexpr int kSlots = 16;
  static int sizes[kSlots], counts[kSlots], next = 0;
  for (int i = 0; i < kSlots; ++i) {
    if (counts[i] > 0 && sizes[i] == smem) {
      *per_sm = counts[i];
      return cudaSuccess;
    }
  }
  int n;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, int8_dense_kernel<kStatic, T>, kThreads, smem);
  if (err != cudaSuccess) return err;
  *per_sm = n > 0 ? n : 1;
  sizes[next] = smem;
  counts[next] = *per_sm;
  next = (next + 1) % kSlots;
  return cudaSuccess;
}

// The plan of a call on the current device: the grid's x at most the
// blocks the card holds at once for this plan's shared memory, over the
// channel ranges.
template <bool kStatic, typename T>
cudaError_t plan_for(int M, int K, int N, Plan* p) {
  if (M <= 0 || K <= 0 || N <= 0) return cudaErrorInvalidValue;
  int sms;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  *p = make_plan(M, K, N, static_cast<int>(sizeof(T)), sms);
  if (p->n_splits > 65535) return cudaErrorInvalidValue;
  if (p->smem > 48 * 1024) {
    err = allow_smem<kStatic, T>();
    if (err != cudaSuccess) return err;
  }
  int per_sm;
  err = blocks_per_sm<kStatic, T>(p->smem, &per_sm);
  if (err != cudaSuccess) return err;
  const int cap = sms * per_sm / p->n_splits;
  if (p->grid_x > cap) p->grid_x = cap < 1 ? 1 : cap;
  return cudaSuccess;
}

template <bool kStatic, typename T>
cudaError_t launch(const void* x, const float* x_scale, const int8_t* w_q,
                   const float* w_scale, float* out, int8_t* x_q_out, int M, int K, int N,
                   cudaStream_t stream) {
  Plan p;
  cudaError_t err = plan_for<kStatic, T>(M, K, N, &p);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.grid_x, p.n_splits);
  int8_dense_kernel<kStatic, T><<<grid, kThreads, p.smem, stream>>>(
      static_cast<const T*>(x), x_scale, w_q, w_scale, out, x_q_out, M, K, N, p);
  return cudaGetLastError();
}

template <bool kStatic>
cudaError_t dispatch(const void* x, int x_type, const float* x_scale, const int8_t* w_q,
                     const float* w_scale, float* out, int8_t* x_q_out, int M, int K, int N,
                     cudaStream_t stream) {
  if (x_type == kF32)
    return launch<kStatic, float>(x, x_scale, w_q, w_scale, out, x_q_out, M, K, N, stream);
  if (x_type == kBF16)
    return launch<kStatic, uint16_t>(x, x_scale, w_q, w_scale, out, x_q_out, M, K, N, stream);
  return cudaErrorInvalidValue;
}

template <bool kStatic, typename T>
cudaError_t occupancy(int M, int K, int N, int* out) {
  Plan p;
  cudaError_t err = plan_for<kStatic, T>(M, K, N, &p);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, int8_dense_kernel<kStatic, T>);
  if (err != cudaSuccess) return err;
  int per_sm;
  err = blocks_per_sm<kStatic, T>(p.smem, &per_sm);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = p.smem;
  out[3] = per_sm;
  out[4] = kThreads;
  out[5] = p.grid_x * p.n_splits;
  out[6] = p.n_stages;
  return cudaSuccess;
}

}  // namespace

// out (M, N) fp32 = dequantized int8 product of x (M, K) with per-row
// dynamic scales; x is fp32 (x_type 0) or bf16 (x_type 1), read as it
// is. x_q_out, when not null, receives x's (M, K) int8 codes. One launch
// on `stream`.
extern "C" cudaError_t int8_dense_dynamic_f32(const void* x, const int8_t* w_q,
                                              const float* w_scale, float* out,
                                              int8_t* x_q_out, int x_type, int M, int K,
                                              int N, cudaStream_t stream) {
  return dispatch<false>(x, x_type, nullptr, w_q, w_scale, out, x_q_out, M, K, N, stream);
}

// The same with one activation scale, read on the device from x_scale, so
// the host never waits for it.
extern "C" cudaError_t int8_dense_static_f32(const void* x, const float* x_scale,
                                             const int8_t* w_q, const float* w_scale,
                                             float* out, int8_t* x_q_out, int x_type, int M,
                                             int K, int N, cudaStream_t stream) {
  return dispatch<true>(x, x_type, x_scale, w_q, w_scale, out, x_q_out, M, K, N, stream);
}

// What the build and the card give the instantiation (is_static, x_type)
// at (M, K, N): out = {registers per thread, local (spill) bytes per
// thread, dynamic shared bytes per block, resident blocks per SM, threads
// per block, the grid's blocks, stages of K}.
extern "C" cudaError_t int8_dense_occupancy(int is_static, int x_type, int M, int K, int N,
                                            int* out) {
  if (x_type != kF32 && x_type != kBF16) return cudaErrorInvalidValue;
  const bool bf16 = x_type == kBF16;
  if (is_static)
    return bf16 ? occupancy<true, uint16_t>(M, K, N, out) : occupancy<true, float>(M, K, N, out);
  return bf16 ? occupancy<false, uint16_t>(M, K, N, out) : occupancy<false, float>(M, K, N, out);
}

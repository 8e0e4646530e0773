// Block cull (K1): one batch of range queries against the resident scan lanes.
//
// Replaces delta_tpu/ops/state_cache.py:986 `_block_kernel_fn` (an XLA jit on
// the TPU). For M queries, C stat lanes and `cap` files it computes
//   keep[m, f] = alive[f] AND for every column c:
//                (isnan(max) | isnan(lo) | max >= lo) & (isnan(min) | isnan(hi) | min <= hi)
// then ORs keep over each 1024-file block and packs the block bits big-endian
// (`jnp.packbits` / `np.unpackbits` order: block 8*b + j is bit 7 - j of
// byte b), giving (M, ceil(cap / 1024 / 8)) bytes.
//
// What bounds it: M*C*cap compares (256 * 4 * 2^20 ~ 1e9 per batch on the
// main path) against ~35 MB of lanes, so the work is compares, and the lanes
// must not be fetched from HBM once per query.
//
// Design: one CTA owns one output byte column (8 blocks = 8192 files) and a
// tile of 32 queries, one bit each of a 32-bit mask. The tile's bounds sit in
// shared memory as (lo, hi) float2 pairs; each thread walks its 32 files
// (4 per block, neighbouring threads on neighbouring files), loads each
// file's (min, max) once per column and tests it against all 32 queries,
// stopping at the first column that drops every query. A warp OR-reduce
// (__reduce_or_sync) and a shared-memory pass give each block's any-bit, and
// thread q writes query q's byte: no atomics, each output byte written once.
//
// NaN means "no bound". It is tested explicitly when a value is loaded: a NaN
// query bound becomes -inf (lo) / +inf (hi), a NaN file min/max becomes
// -inf / +inf, after which a plain compare gives exactly the JAX verdict
// (an infinity is kept as an infinity, so the inverted +inf/-inf lanes of a
// null partition value still prune). Built without fast math / FTZ: the f32
// lanes can hold subnormals, and flushing them would change comparisons.
//
// The sharded block cull (K7) is the second entry point, dtt_block_cull_shard.
// It replaces delta_tpu/ops/state_cache.py:1014 `_sharded_block_kernel_fn`, a
// shard_map on the TPU mesh in which each device runs K1's test over its
// 1/shards slice of the file axis and any-reduces its own 1024-file blocks
// into UNPACKED u8, all-gathered along the file axis. One launch per shard,
// over that shard's (C, cap/shards) lanes and alive with the replicated
// (M, C) bounds; the same CTA body as K1 (templated on the output form)
// writes one byte per block, (M, cap/shards/1024), so the gathered map is
// K1's unpacked bit for bit. The shard's slice holds whole blocks (the
// wrapper asserts it). Bound as K1: compares.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 1024;                       // files per cull block
constexpr int kBlocksPerByte = 8;                  // blocks per output byte
constexpr int kThreads = 256;
constexpr int kFilesPerThread = kBlock / kThreads; // per block
constexpr int kQueries = 32;                       // queries per CTA
constexpr int kWarps = kThreads / 32;

// kPacked: K1, one bit a block, (M, out_w) bytes; else K7, one byte a block,
// (M, cap / kBlock) bytes.
template <bool kPacked>
__global__ void __launch_bounds__(kThreads)
block_cull_kernel(const float* __restrict__ mins, const float* __restrict__ maxs,
                  const uint8_t* __restrict__ alive, const float* __restrict__ lo,
                  const float* __restrict__ hi, uint8_t* __restrict__ out,
                  int C, long long cap, int M, int out_w) {
  extern __shared__ float2 s_bounds[];  // [C][kQueries] of (lo, hi)
  __shared__ uint32_t s_any[kWarps][kBlocksPerByte];

  const int tid = threadIdx.x;
  const long long byte = blockIdx.x;
  const int q0 = blockIdx.y * kQueries;
  const int nq = min(kQueries, M - q0);

  for (int i = tid; i < C * kQueries; i += kThreads) {
    const int c = i / kQueries, q = i % kQueries;
    float l = -INFINITY, h = INFINITY;
    if (q < nq) {
      const float a = lo[(long long)(q0 + q) * C + c];
      const float b = hi[(long long)(q0 + q) * C + c];
      l = isnan(a) ? -INFINITY : a;
      h = isnan(b) ? INFINITY : b;
    }
    s_bounds[i] = make_float2(l, h);
  }
  __syncthreads();

  const uint32_t qmask = nq >= 32 ? 0xffffffffu : ((1u << nq) - 1u);
  uint32_t any[kBlocksPerByte];
#pragma unroll
  for (int j = 0; j < kBlocksPerByte; ++j) {
    any[j] = 0u;
    const long long base = (byte * kBlocksPerByte + j) * kBlock;
    if (base >= cap) continue;  // cap is a multiple of kBlock: blocks are whole
#pragma unroll
    for (int k = 0; k < kFilesPerThread; ++k) {
      const long long f = base + tid + k * kThreads;
      uint32_t keep = alive[f] ? qmask : 0u;
      for (int c = 0; c < C && keep; ++c) {
        float mn = mins[(long long)c * cap + f];
        float mx = maxs[(long long)c * cap + f];
        mn = isnan(mn) ? -INFINITY : mn;
        mx = isnan(mx) ? INFINITY : mx;
        const float2* b = s_bounds + c * kQueries;
        uint32_t ok = 0u;
#pragma unroll
        for (int q = 0; q < kQueries; ++q) {
          const float2 bq = b[q];
          ok |= (uint32_t)((mx >= bq.x) & (mn <= bq.y)) << q;
        }
        keep &= ok;
      }
      any[j] |= keep;
    }
  }

  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int j = 0; j < kBlocksPerByte; ++j) {
    const uint32_t v = __reduce_or_sync(0xffffffffu, any[j]);
    if (lane == 0) s_any[warp][j] = v;
  }
  __syncthreads();
  if (tid < nq) {
    uint32_t bits = 0u;
    for (int j = 0; j < kBlocksPerByte; ++j) {
      uint32_t v = 0u;
      for (int w = 0; w < kWarps; ++w) v |= s_any[w][j];
      if (kPacked) {
        bits |= ((v >> tid) & 1u) << (7 - j);
      } else {
        const long long blk = byte * kBlocksPerByte + j;
        if (blk < out_w) out[(long long)(q0 + tid) * out_w + blk] = (uint8_t)((v >> tid) & 1u);
      }
    }
    if (kPacked) out[(long long)(q0 + tid) * out_w + byte] = (uint8_t)bits;
  }
}

}  // namespace

// mins/maxs (C, cap) f32, alive (cap,) u8 0/1, lo/hi (M, C) f32, out (M, out_w)
// u8 with out_w = ceil(cap / 1024 / 8); all contiguous, cap a multiple of 1024.
extern "C" int dtt_block_cull(const float* mins, const float* maxs,
                              const uint8_t* alive, const float* lo,
                              const float* hi, uint8_t* out, int C,
                              long long cap, int M, int out_w, void* stream) {
  const dim3 grid(out_w, (M + kQueries - 1) / kQueries);
  const size_t smem = sizeof(float2) * C * kQueries;
  block_cull_kernel<true><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      mins, maxs, alive, lo, hi, out, C, cap, M, out_w);
  return (int)cudaGetLastError();
}

// K7, one shard: mins/maxs (C, cap) f32, alive (cap,) u8 0/1 of this shard's
// slice, lo/hi (M, C) f32, out (M, cap / 1024) u8 (one byte a block); all
// contiguous, cap a multiple of 1024.
extern "C" int dtt_block_cull_shard(const float* mins, const float* maxs,
                                    const uint8_t* alive, const float* lo,
                                    const float* hi, uint8_t* out, int C,
                                    long long cap, int M, void* stream) {
  if (cap % kBlock) return (int)cudaErrorInvalidValue;
  const long long blocks = cap / kBlock;
  const dim3 grid((unsigned)((blocks + kBlocksPerByte - 1) / kBlocksPerByte),
                  (M + kQueries - 1) / kQueries);
  const size_t smem = sizeof(float2) * C * kQueries;
  block_cull_kernel<false><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      mins, maxs, alive, lo, hi, out, C, cap, M, (int)blocks);
  return (int)cudaGetLastError();
}

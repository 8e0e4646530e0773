// Pair compaction (K10): the matched rows of a probe, as dense pairs.
//
// Replaces delta_tpu/ops/key_cache.py:353 `_pair_compact_kernel`, an XLA
// jit on the TPU (`cumsum` of the matched flags, then two drop-mode
// scatters): the rows i with t_match[i], in sorted order, become
// out[0][k] = perm[i] (the physical slab row) and out[1][k] = s_first[i]
// (the first matching source row); slots past the count are zero and rows
// past out_cap are dropped.
//
// Design: a stream compaction. Tiles of 4096 rows count their matches, one
// exclusive scan (scan.cuh) gives each tile its first output slot, and each
// tile then walks its rows in order, 256 at a time, ranking the matched
// ones with warp ballots and a prefix over the 8 warps' counts.
//
// What bounds it: bytes — the flags read twice, perm and s_first read only
// where matched, the pairs written once.
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;

__global__ void count_kernel(const uint8_t* __restrict__ t_match, long long cap,
                             uint32_t* __restrict__ counts) {
  __shared__ uint32_t warp_n[kWarps];
  const long long base = (long long)blockIdx.x * kTile;
  uint32_t c = 0;
#pragma unroll 4
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + (long long)k * kThreads + threadIdx.x;
    if (i < cap) c += t_match[i] ? 1u : 0u;
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) c += __shfl_xor_sync(0xffffffffu, c, o);
  if ((threadIdx.x & 31) == 0) warp_n[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t total = 0;
    for (int w = 0; w < kWarps; ++w) total += warp_n[w];
    counts[blockIdx.x] = total;
  }
}

__global__ void scatter_kernel(const uint8_t* __restrict__ t_match,
                               const int32_t* __restrict__ s_first,
                               const int32_t* __restrict__ perm, long long cap,
                               const uint32_t* __restrict__ offs, int32_t* __restrict__ out,
                               long long out_cap) {
  __shared__ uint32_t warp_start[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long base = (long long)blockIdx.x * kTile;
  uint32_t next = offs[blockIdx.x];
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + (long long)k * kThreads + threadIdx.x;
    const bool hit = i < cap && t_match[i];
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_start[warp] = __popc(ballot);
    __syncthreads();
    uint32_t before = next, chunk = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) before += warp_start[w];
      chunk += warp_start[w];
    }
    if (hit) {
      const long long pos = (long long)before + __popc(ballot & ((1u << lane) - 1u));
      if (pos < out_cap) {
        out[pos] = perm[i];
        out[out_cap + pos] = s_first[i];
      }
    }
    next += chunk;
    __syncthreads();
  }
}

}  // namespace

// t_match (cap,) u8, s_first / perm (cap,) i32; out (2, out_cap) i32.
// scratch: the tile counts and their scan's aux.
extern "C" int dtt_pair_compact(const uint8_t* t_match, const int32_t* s_first,
                                const int32_t* perm, long long cap, int32_t* out,
                                long long out_cap, void* scratch, long long scratch_bytes,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (cap < 0 || out_cap < 0) return (int)cudaErrorInvalidValue;
  if (out_cap > 0) {
    cudaError_t err = cudaMemsetAsync(out, 0, 2 * out_cap * sizeof(int32_t), s);
    if (err != cudaSuccess) return (int)err;
  }
  if (cap > 0 && out_cap > 0) {
    const long long tiles = (cap + kTile - 1) / kTile;
    char* cur = (char*)scratch;
    char* end = cur + scratch_bytes;
    uint32_t* counts = (uint32_t*)dtt_scan::carve(cur, end, 4 * tiles);
    uint32_t* aux = (uint32_t*)dtt_scan::carve(cur, end, 4 * dtt_scan::scan_aux_elems(tiles));
    if (!counts || !aux) return (int)cudaErrorInvalidValue;
    count_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(t_match, cap, counts);
    dtt_scan::exclusive_scan(counts, tiles, aux, s);
    scatter_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(t_match, s_first, perm, cap, counts,
                                                        out, out_cap);
  }
  return (int)cudaGetLastError();
}

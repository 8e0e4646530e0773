// Device-wide exclusive prefix sum of uint32 counts, shared by the radix
// sort (K8, the digit histograms) and the pair compaction (K10, the tile
// counts).
//
// Three launches at most per level: each block of 1024 threads scans a chunk
// of 4096 counts in place (4 per thread, a warp-shuffle scan of the thread
// sums) and writes the chunk's total; the chunk totals are scanned the same
// way, recursively; then each chunk adds its total's prefix. `aux` holds
// the totals of every level: `scan_aux_elems(len)` elements.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace dtt_scan {

constexpr int kThreads = 1024;
constexpr int kPer = 4;
constexpr int kChunk = kThreads * kPer;

// Exclusive scan of one value per thread over the block (1024 threads);
// *total receives the block's sum.
__device__ __forceinline__ uint32_t block_exclusive_scan(uint32_t v, uint32_t* total) {
  __shared__ uint32_t warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint32_t s = warp_sums[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    warp_sums[lane] = s;  // inclusive over warps
  }
  __syncthreads();
  const uint32_t excl = (warp ? warp_sums[warp - 1] : 0u) + x - v;
  *total = warp_sums[kThreads / 32 - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return excl;
}

__global__ void scan_chunks(uint32_t* __restrict__ data, long long len,
                            uint32_t* __restrict__ sums) {
  const long long base = (long long)blockIdx.x * kChunk + (long long)threadIdx.x * kPer;
  uint32_t v[kPer];
  uint32_t local = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    v[k] = base + k < len ? data[base + k] : 0u;
    local += v[k];
  }
  uint32_t total;
  uint32_t run = block_exclusive_scan(local, &total);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (base + k < len) data[base + k] = run;
    run += v[k];
  }
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

__global__ void add_offsets(uint32_t* __restrict__ data, long long len,
                            const uint32_t* __restrict__ offs) {
  const uint32_t o = offs[blockIdx.x];
  const long long base = (long long)blockIdx.x * kChunk;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const long long i = base + (long long)k * kThreads + threadIdx.x;
    if (i < len) data[i] += o;
  }
}

inline long long scan_aux_elems(long long len) {
  long long total = 0;
  while (len > 1) {
    len = (len + kChunk - 1) / kChunk;
    total += len;
  }
  return total + 1;
}

inline void exclusive_scan(uint32_t* data, long long len, uint32_t* aux, cudaStream_t s) {
  if (len <= 0) return;
  const long long chunks = (len + kChunk - 1) / kChunk;
  scan_chunks<<<(unsigned)chunks, kThreads, 0, s>>>(data, len, aux);
  if (chunks > 1) {
    exclusive_scan(aux, chunks, aux + chunks, s);
    add_offsets<<<(unsigned)chunks, kThreads, 0, s>>>(data, len, aux);
  }
}

// Carve `bytes` (rounded up to 256) off a scratch buffer; nullptr when it
// does not fit.
inline void* carve(char*& cur, char* end, long long bytes) {
  const long long step = (bytes + 255) / 256 * 256;
  if (cur + step > end) return nullptr;
  void* p = cur;
  cur += step;
  return p;
}

}  // namespace dtt_scan

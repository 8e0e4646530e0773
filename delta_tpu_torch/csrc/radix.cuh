// The stable LSD radix passes shared by the slab sort (K8, slab_sort.cu)
// and the upload join's source sort (K12, join_probe.cu).
//
// Keys are uint64 (a signed key with its sign bit flipped, so the unsigned
// order is the signed one), each with an int32 payload, 8-bit digits. One
// pass per digit: a per-tile histogram (tiles of 4096 keys, digit-major so
// one flat exclusive scan gives every (digit, tile) its output offset), the
// scan (scan.cuh), and a stable scatter: each tile walks its keys in order,
// 256 at a time, ranking equal digits inside a warp with __match_any_sync
// and across the 8 warps through shared per-digit counters. A digit that is
// the same for every key is skipped: `varying` (the OR of every key XOR the
// first) names the digits that vary.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan.cuh"

namespace dtt_radix {

constexpr int kThreads = 256;  // == kRadix: thread t owns digit t's counters
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;
constexpr int kRadix = 256;
constexpr int kWarps = kThreads / 32;
constexpr uint64_t kSign = 0x8000000000000000ull;

__global__ void hist_kernel(const uint64_t* __restrict__ uk, long long n, int shift,
                            uint32_t* __restrict__ hist, long long tiles) {
  __shared__ uint32_t h[kRadix];
  h[threadIdx.x] = 0;
  __syncthreads();
  const long long base = (long long)blockIdx.x * kTile;
#pragma unroll 4
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + (long long)k * kThreads + threadIdx.x;
    if (i < n) atomicAdd(&h[(unsigned)(uk[i] >> shift) & 0xFFu], 1u);
  }
  __syncthreads();
  hist[(long long)threadIdx.x * tiles + blockIdx.x] = h[threadIdx.x];
}

__global__ void scatter_kernel(const uint64_t* __restrict__ uk_in,
                               const int32_t* __restrict__ p_in,
                               uint64_t* __restrict__ uk_out, int32_t* __restrict__ p_out,
                               long long n, int shift, const uint32_t* __restrict__ offs,
                               long long tiles) {
  __shared__ uint32_t base[kRadix];              // next output slot per digit
  __shared__ uint32_t start[kWarps][kRadix];     // per-warp count, then start
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  base[t] = offs[(long long)t * tiles + blockIdx.x];
  const long long tile0 = (long long)blockIdx.x * kTile;
  for (int k = 0; k < kItems; ++k) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) start[w][t] = 0;
    __syncthreads();
    const long long i = tile0 + (long long)k * kThreads + t;
    const bool live = i < n;
    const uint64_t u = live ? uk_in[i] : 0;
    const int32_t p = live ? p_in[i] : 0;
    const unsigned d = live ? ((unsigned)(u >> shift) & 0xFFu) : 0x100u;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const unsigned rank = __popc(peers & ((1u << lane) - 1u));
    if (live && rank == 0) start[warp][d] = __popc(peers);
    __syncthreads();
    uint32_t run = base[t];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const uint32_t c = start[w][t];
      start[w][t] = run;
      run += c;
    }
    base[t] = run;
    __syncthreads();
    if (live) {
      const uint32_t pos = start[warp][d] + rank;
      uk_out[pos] = u;
      p_out[pos] = p;
    }
    __syncthreads();
  }
}

inline unsigned grid_for(long long work) {
  long long g = (work + kThreads - 1) / kThreads;
  if (g > 132 * 16) g = 132 * 16;
  return (unsigned)(g < 1 ? 1 : g);
}

// Sorts uk[0]/pp[0] (n keys with their payload) by key; returns the
// buffer (0 or 1) that holds the result. hist: 256 x tiles counts; aux: the
// scan's totals (scan_aux_elems(256 x tiles)).
inline int sort_passes(uint64_t* uk[2], int32_t* pp[2], long long n, unsigned long long varying,
                       uint32_t* hist, uint32_t* aux, cudaStream_t s) {
  const long long tiles = (n + kTile - 1) / kTile;
  const long long hist_len = (long long)kRadix * tiles;
  int cur = 0;
  for (int digit = 0; digit < 8; ++digit) {
    const int shift = 8 * digit;
    if (((varying >> shift) & 0xFFull) == 0) continue;  // constant digit: identity
    hist_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(uk[cur], n, shift, hist, tiles);
    dtt_scan::exclusive_scan(hist, hist_len, aux, s);
    scatter_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(uk[cur], pp[cur], uk[1 - cur],
                                                        pp[1 - cur], n, shift, hist, tiles);
    cur = 1 - cur;
  }
  return cur;
}

}  // namespace dtt_radix

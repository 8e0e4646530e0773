// Pair compaction (K10): the matched rows of a probe, as dense pairs in
// PHYSICAL slab order.
//
// Replaces delta_tpu/ops/key_cache.py:353 `_pair_compact_kernel`, an XLA
// jit on the TPU (`cumsum` of the matched flags, then two drop-mode
// scatters), together with what its one consumer, the probe's finalize
// (delta_tpu/ops/key_cache.py:908-912), does next on the host: a stable
// argsort of the pairs by physical row. The rows i with t_match[i] become
// out[0][k] = perm[i] (the physical slab row) and out[1][k] = s_first[i]
// (the first matching source row), k ascending with perm[i]; slots past the
// count are zero. perm is a permutation, so that order has one answer. Where
// out_cap is below the count, the first out_cap pairs in physical order are
// kept (the JAX kernel keeps the first in sorted order; no caller passes
// such an out_cap).
//
// Design: two passes, no sort.
//   1. mark_kernel, one coalesced pass over the sorted rows (4 a thread,
//      their flags in one 4-byte load, perm and s_first in 16-byte loads
//      where any matched, all marked evict-first so that they push fewer of
//      sp's scattered writes out of L2): each matched row sets bit perm[i]
//      of a physical bitmap (cap/8 bytes, zeroed first) and stores
//      s_first[i] at sp[perm[i]], an int32 scratch of cap rows that is read
//      only where the bit is set, so never zeroed. A thread's rows that fall
//      in one word make one atomicOr.
//   2. emit_kernel, one pass over the bitmap in physical order: each CTA
//      takes 256 words (a tile id from a ticket, so the tiles before it have
//      started), a warp 32 of them; popcounts, a warp scan and a prefix over
//      the warps give each word its first slot, and a single-pass decoupled
//      look-back over the tiles before it (32 tiles a step) gives the
//      tile's. The warp then walks its words one at a time, lane l taking
//      bit l: consecutive lanes write consecutive slots and, in a band of
//      matched rows, read consecutive rows of sp. The last tile writes the
//      count.
// The C entry zeroes only the slots past the caller's count, and can copy
// the pairs [:, :mc] and the count to pinned host memory on the same stream,
// so the probe downloads exactly its pairs, already in order.
//
// What bounds it: bytes — the flags (cap), perm and s_first of the matched
// rows (8 mc), the pairs (8 out_cap). The reorder adds about mc random
// 4-byte writes and reads of sp and the bitmap's cap/8 bytes, most of them
// in L2.
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan.cuh"

namespace {

constexpr int kMarkThreads = 256;
constexpr int kMarkRows = 4;  // sorted rows a thread
constexpr int kEmitThreads = 256;
constexpr int kTileWords = kEmitThreads;  // bitmap words a CTA, 32 a warp
constexpr unsigned long long kAggregate = 1ull << 32, kInclusive = 2ull << 32;

__global__ void __launch_bounds__(kMarkThreads)
mark_kernel(const uint8_t* __restrict__ t_match, const int32_t* __restrict__ s_first,
            const int32_t* __restrict__ perm, long long cap, uint32_t* __restrict__ bits,
            int32_t* __restrict__ sp) {
  const long long i0 = ((long long)blockIdx.x * kMarkThreads + threadIdx.x) * kMarkRows;
  if (i0 >= cap) return;
  const bool whole = i0 + kMarkRows <= cap;
  uint32_t f = 0;
  if (whole && ((uintptr_t)(t_match + i0) & 3) == 0) {
    f = __ldcs((const uint32_t*)(t_match + i0));
  } else {
    for (int k = 0; k < kMarkRows; ++k)
      if (i0 + k < cap && t_match[i0 + k]) f |= 1u << (8 * k);
  }
  if (!f) return;
  int32_t p[kMarkRows], s[kMarkRows];
  if (whole && (((uintptr_t)(perm + i0) | (uintptr_t)(s_first + i0)) & 15) == 0) {
    const int4 pv = __ldcs((const int4*)(perm + i0)), sv = __ldcs((const int4*)(s_first + i0));
    p[0] = pv.x, p[1] = pv.y, p[2] = pv.z, p[3] = pv.w;
    s[0] = sv.x, s[1] = sv.y, s[2] = sv.z, s[3] = sv.w;
  } else {
#pragma unroll
    for (int k = 0; k < kMarkRows; ++k) {
      const bool hit = (f >> (8 * k)) & 0xffu;
      p[k] = hit ? perm[i0 + k] : -1;
      s[k] = hit ? s_first[i0 + k] : 0;
    }
  }
  // the thread's rows that fall in one bitmap word make one atomic: rows that
  // are neighbours in both orders (a band of matched rows) share words
  uint32_t word = 0xffffffffu, acc = 0;
#pragma unroll
  for (int k = 0; k < kMarkRows; ++k) {
    if (!((f >> (8 * k)) & 0xffu) || p[k] < 0 || p[k] >= cap) continue;
    sp[p[k]] = s[k];
    const uint32_t w = (uint32_t)p[k] >> 5;
    if (w != word) {
      if (acc) atomicOr(bits + word, acc);
      word = w;
      acc = 0;
    }
    acc |= 1u << (p[k] & 31);
  }
  if (acc) atomicOr(bits + word, acc);
}

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  return *(const volatile unsigned long long*)p;
}

// The tile's first slot: publish its count, then add up the tiles before
// it back to the nearest one that has published its inclusive prefix, 32
// tiles a step (lane l reads the status of the tile 32 s + l + 1 before).
// Warp 0; returns the prefix in every lane.
__device__ __forceinline__ unsigned look_back(unsigned long long* status, long long tile,
                                              unsigned total) {
  const int lane = threadIdx.x & 31;
  if (tile == 0) {
    if (lane == 0) atomicExch(status, kInclusive | total);
    return 0;
  }
  if (lane == 0) atomicExch(status + tile, kAggregate | total);
  unsigned prefix = 0;
  for (long long end = tile; end > 0; end -= 32) {
    const long long j = end - 1 - lane;
    unsigned long long st = kInclusive;  // past tile 0: adds nothing, stops the walk
    if (j >= 0) {
      do st = load_status(status + j); while ((st >> 32) == 0);
    }
    // the nearest inclusive prefix among these 32: lanes past it add nothing
    const unsigned incl = __ballot_sync(0xffffffffu, (st >> 32) == 2);
    const int stop = incl ? __ffs(incl) - 1 : 32;
    unsigned v = lane <= stop && j >= 0 ? (unsigned)st : 0u;
#pragma unroll
    for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    prefix += v;
    if (incl) break;
  }
  if (lane == 0) atomicExch(status + tile, kInclusive | (prefix + total));
  return prefix;
}

__global__ void __launch_bounds__(kEmitThreads)
emit_kernel(const uint32_t* __restrict__ bits, long long words, const int32_t* __restrict__ sp,
            unsigned long long* __restrict__ status, unsigned* __restrict__ ticket,
            unsigned* __restrict__ count, long long tiles, int32_t* __restrict__ out,
            long long out_cap) {
  __shared__ unsigned tile_s, prefix_s;
  __shared__ unsigned warp_sum[kEmitThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) tile_s = atomicAdd(ticket, 1u);
  __syncthreads();
  const long long tile = tile_s;
  // word wbase + l in lane l
  const long long wbase = tile * kTileWords + 32ll * warp;
  const uint32_t w = wbase + lane < words ? bits[wbase + lane] : 0u;
  const unsigned c = __popc(w);
  unsigned x = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  const unsigned ex = x - c, warp_total = __shfl_sync(0xffffffffu, x, 31);
  if (lane == 0) warp_sum[warp] = warp_total;
  __syncthreads();
  unsigned warp_off = 0, total = 0;
#pragma unroll
  for (int k = 0; k < kEmitThreads / 32; ++k) {
    if (k < warp) warp_off += warp_sum[k];
    total += warp_sum[k];
  }
  if (warp == 0) {
    const unsigned prefix = look_back(status, tile, total);
    if (lane == 0) {
      if (tile == tiles - 1) *count = prefix + total;
      prefix_s = prefix;
    }
  }
  __syncthreads();
  if (!warp_total) return;

  // the pairs, a word at a time across the warp: lane l takes bit l, so
  // consecutive lanes write consecutive slots and, in a band of matched
  // rows, read consecutive rows of sp
  const long long base = (long long)prefix_s + warp_off;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll 8
  for (int i = 0; i < 32; ++i) {
    const uint32_t word = __shfl_sync(0xffffffffu, w, i);
    const unsigned off = __shfl_sync(0xffffffffu, ex, i);
    const long long pos = base + off + __popc(word & below);
    if (((word >> lane) & 1u) && pos < out_cap) {
      const int32_t p = (int32_t)((wbase + i) * 32 + lane);
      out[pos] = p;
      out[out_cap + pos] = sp[p];
    }
  }
}

}  // namespace

// t_match (cap,) u8, s_first / perm (cap,) i32; out (2, out_cap) i32.
// scratch: the bitmap, the tiles' status words, the ticket and the count
// (zeroed here, in one memset), then sp (cap i32, never zeroed); see
// ops/key_cache._compact_scratch_bytes. mc: the caller's matched count, or
// -1: with mc >= 0 only the slots [min(mc, out_cap), out_cap) are zeroed
// (the kernel writes the ones below when the count is mc), else the whole
// output. host (pinned, 2 mc + 1 i32) or null: the pairs [:, :mc] and the
// count are copied there on the stream (mc <= out_cap).
extern "C" int dtt_pair_compact(const uint8_t* t_match, const int32_t* s_first,
                                const int32_t* perm, long long cap, int32_t* out,
                                long long out_cap, long long mc, int32_t* host, void* scratch,
                                long long scratch_bytes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (cap < 0 || out_cap < 0 || cap >= (1ll << 31) || (host && (mc < 0 || mc > out_cap)))
    return (int)cudaErrorInvalidValue;
  const long long words = (cap + 31) / 32;
  const long long tiles = (words + kTileWords - 1) / kTileWords;
  char* cur = (char*)scratch;
  char* end = cur + scratch_bytes;
  uint32_t* bits = (uint32_t*)dtt_scan::carve(cur, end, 4 * words);
  auto* status = (unsigned long long*)dtt_scan::carve(cur, end, 8 * tiles);
  unsigned* ticket = (unsigned*)dtt_scan::carve(cur, end, 8);
  const long long zeroed = cur - (char*)scratch;
  int32_t* sp = (int32_t*)dtt_scan::carve(cur, end, 4 * cap);
  if (!bits || !status || !ticket || !sp) return (int)cudaErrorInvalidValue;
  unsigned* count = ticket + 1;
  cudaError_t err = cudaMemsetAsync(scratch, 0, zeroed, s);
  if (err != cudaSuccess) return (int)err;
  const long long z = mc >= 0 ? (mc < out_cap ? mc : out_cap) : 0;
  if (out_cap > z) {
    err = cudaMemset2DAsync(out + z, 4 * out_cap, 0, 4 * (out_cap - z), 2, s);
    if (err != cudaSuccess) return (int)err;
  }
  if (cap > 0) {
    const long long per_block = (long long)kMarkThreads * kMarkRows;
    mark_kernel<<<(unsigned)((cap + per_block - 1) / per_block), kMarkThreads, 0, s>>>(
        t_match, s_first, perm, cap, bits, sp);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    emit_kernel<<<(unsigned)tiles, kEmitThreads, 0, s>>>(bits, words, sp, status, ticket, count,
                                                         tiles, out, out_cap);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (host) {
    if (mc > 0) {
      err = cudaMemcpy2DAsync(host, 4 * mc, out, 4 * out_cap, 4 * mc, 2, cudaMemcpyDeviceToHost,
                              s);
      if (err != cudaSuccess) return (int)err;
    }
    err = cudaMemcpyAsync(host + 2 * mc, count, 4, cudaMemcpyDeviceToHost, s);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

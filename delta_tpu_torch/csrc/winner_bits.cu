// Winner bits (K4): last-writer-wins over a replay-ordered action stream.
//
// Replaces delta_tpu/ops/replay_kernel.py:115 `_winner_bits_kernel` (an XLA
// jit on the TPU): winner[i] = path_id[i] >= 0 and i is the last row with
// that path id; the mask is packed big-endian into n / 8 bytes.
//
// The TPU version sorts (path_id, row) with a bitonic sort and marks run
// ends: O(n log n) passes over the stream. Path ids from SegmentColumns are
// dense codes 0..num_paths-1, so Hopper does it in O(n) with the same
// output, in two launches over the stream:
//   the atomic pass: last[id] = the last row of that id (atomicMax);
//   the pack pass: a row wins where last[id] is its own row; a warp's
//             ballot of 32 rows is, bit-reversed byte by byte, 4 output
//             bytes (bit 7 - j of byte b is row 8 b + j).
//
// The table cleans itself: no memset. `last` (int32, caller-owned, kept
// between calls) is all -1 before a call and after it: every id the atomic
// pass touches has exactly one winner, and the winner's thread writes -1
// back over its entry after reading it. A losing row that reads the entry
// after the reset sees -1, which is not its own row either. The one
// condition, that the atomic pass is complete before any reset, is the
// kernel boundary. (A grid-wide barrier in one cooperative launch was
// measured slower: PERF.md, section 6.)
//
// No read-back: an id >= num_paths is never written or read; it ORs 1 into
// `flag` (one int32 beside the table, 0 between calls). The pack pass's
// first thread copies the flag into the int32 after the packed mask in
// `out` and zeroes it, so the caller reads the error with the mask, in one
// download. Pads (-1) never win.
//
// Memory access: a warp's pass covers 32 * kSteps consecutive rows, lane l
// taking row base + 32 j + l at step j: each load of the stream, and for
// ids in first-appearance order (a log's) each access to `last`, is one
// coalesced request; all of a thread's loads go out before its atomics
// or resets, so they are in flight together. Equal ids are merged before
// the atomics: a step whose lanes hold one id (two single-instruction warp
// reductions tell) makes one atomic, from its top lane, and none where a
// later such step of the span holds that id; a step where a lane equals its
// neighbour merges equal lanes by __match_any_sync (the highest lane's
// atomic). So one path over a million rows takes a few thousand atomics,
// not a million on one address.
//
// What bounds it: bytes (4 per row read twice, 1/8 written) and the random
// accesses to `last`, which for a million paths (4 MB) stay in L2.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSteps = 8;  // rows a thread takes a pass, 32 apart

// A warp's first span starts at its global warp index * 32 * kSteps rows;
// spans step by the grid's rows (a multiple of 32 * kSteps, so a warp's
// lanes loop together).
__device__ __forceinline__ long long warp_base() {
  return ((long long)blockIdx.x * kThreads + threadIdx.x) / 32 * (32 * kSteps);
}

__global__ void __launch_bounds__(kThreads)
last_row_kernel(const int32_t* __restrict__ path_id, long long n, int32_t* __restrict__ last,
                int num_paths, int* __restrict__ flag) {
  const long long stride = (long long)gridDim.x * kThreads * kSteps;
  const int lane = threadIdx.x & 31;
  for (long long base = warp_base(); base < n; base += stride) {
    int q[kSteps];
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const long long i = base + 32 * j + lane;
      q[j] = i < n ? path_id[i] : -1;
    }
    int uni[kSteps];  // the step's one id where every lane with an id has it
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      if (q[j] >= num_paths) {
        atomicOr(flag, 1);
        q[j] = -1;
      }
      const int lo = __reduce_min_sync(0xffffffffu, q[j] >= 0 ? q[j] : INT_MAX);
      const int hi = __reduce_max_sync(0xffffffffu, q[j]);
      uni[j] = lo == hi ? lo : INT_MIN;
    }
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      bool fire = q[j] >= 0;
#pragma unroll
      for (int k = j + 1; k < kSteps; ++k) fire = fire && uni[k] != q[j];
      if (uni[j] != INT_MIN) {  // every lane takes the ballot: no short circuit
        const unsigned valid = __ballot_sync(0xffffffffu, q[j] >= 0);
        fire = fire && lane == 31 - __clz(valid);
      } else {
        const int next = __shfl_down_sync(0xffffffffu, q[j], 1);
        if (__any_sync(0xffffffffu, q[j] >= 0 && lane < 31 && next == q[j])) {
          const unsigned peers = __match_any_sync(0xffffffffu, q[j]);
          fire = fire && lane == 31 - __clz(peers);
        }
      }
      if (fire) atomicMax(last + q[j], (int)(base + 32 * j + lane));
    }
  }
}

// Step j's ballot holds the winners of rows base + 32 j .. + 31 (bit l is
// row 32 j + l), so its byte-wise bit reversal is output word base / 32 + j.
// Lane j keeps word j and lanes 0..kSteps-1 store theirs (32 bytes,
// coalesced; bytes past n / 8 are not stored).
__global__ void __launch_bounds__(kThreads)
winner_pack_kernel(const int32_t* __restrict__ path_id, long long n,
                   int32_t* __restrict__ last, int num_paths, int* __restrict__ flag,
                   uint8_t* __restrict__ out, int* __restrict__ err_out) {
  const long long n_bytes = n / 8;
  const bool out4 = (reinterpret_cast<uintptr_t>(out) & 3) == 0;
  const long long stride = (long long)gridDim.x * kThreads * kSteps;
  const int lane = threadIdx.x & 31;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const int f = *flag;
    *err_out = f;
    if (f) *flag = 0;
  }
  for (long long base = warp_base(); base < n; base += stride) {
    int q[kSteps], seen[kSteps];
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const long long i = base + 32 * j + lane;
      const int p = i < n ? path_id[i] : -1;
      q[j] = (p >= 0 && p < num_paths) ? p : -1;
    }
#pragma unroll
    for (int j = 0; j < kSteps; ++j) seen[j] = q[j] >= 0 ? last[q[j]] : -2;
    unsigned won = 0u;
    uint32_t mine = 0u;
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const bool w = seen[j] == (int)(base + 32 * j + lane);
      won |= (unsigned)w << j;
      const unsigned ballot = __ballot_sync(0xffffffffu, w);
      if (lane == j) mine = __byte_perm(__brev(ballot), 0, 0x0123);
    }
#pragma unroll
    for (int j = 0; j < kSteps; ++j)
      if (won & (1u << j)) last[q[j]] = -1;  // the winner cleans its entry
    const long long b = base / 8 + 4 * lane;  // this lane's word's first byte
    if (lane < kSteps && b < n_bytes) {
      if (out4 && b + 4 <= n_bytes) {
        *reinterpret_cast<uint32_t*>(out + b) = mine;
      } else {
        for (long long k = 0; k < 4 && b + k < n_bytes; ++k)
          out[b + k] = (uint8_t)(mine >> (8 * k));
      }
    }
  }
}

}  // namespace

// path_id (n,) i32 with n a multiple of 8, 0 < n < 2^31; last (>= num_paths,)
// i32, all -1; flag (1,) i32, 0; out (round_up(n / 8, 4) + 4,) u8: the
// packed mask, then at byte round_up(n / 8, 4) the int32 error flag. `last`
// and `flag` are left as they were found.
extern "C" int dtt_winner_bits(const int32_t* path_id, long long n, int32_t* last,
                               int num_paths, int* flag, uint8_t* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int* err_out = reinterpret_cast<int*>(out + ((n / 8 + 3) / 4) * 4);
  // a thread a kSteps rows: every warp's first span starts below n
  const unsigned grid = (unsigned)(((n + kSteps - 1) / kSteps + kThreads - 1) / kThreads);
  last_row_kernel<<<grid, kThreads, 0, s>>>(path_id, n, last, num_paths, flag);
  winner_pack_kernel<<<grid, kThreads, 0, s>>>(path_id, n, last, num_paths, flag, out,
                                               err_out);
  return (int)cudaGetLastError();
}

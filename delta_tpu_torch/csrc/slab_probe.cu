// Slab probe (K9): membership of the MERGE source keys in the sorted key
// slab, fused with the pairing step.
//
// Replaces delta_tpu/ops/key_cache.py:206 `_probe_sorted_kernel`, an XLA
// jit on the TPU that sorts the source, gives each 4096-row slab block a
// window of candidate source keys and brute-compares them (dense compares
// suit the TPU's vector unit; gathers there are slow), with a second tier
// for the widest windows and an overflow flag past it. Hopper gathers
// well, so this kernel searches instead, with the same outputs and no
// overflow:
//
//   1. search: one thread per source key binary-searches the real rows
//      [0, n) of the sorted slab (never the int64.max padding, so a real
//      key equal to int64.max is found). A hit records its run's first row
//      and resets that row's `run_first` slot to m.
//   2. min: each hit does atomicMin(run_first[row], j): the smallest source
//      index among equal source keys (join_kernel._first_match_recovery's
//      tie rule).
//   3. runs: the source that won its run walks the run of equal slab keys:
//      s_first = j for every row, t_match = the row's validity, the run's
//      any-valid flag, and the matched count (atomicAdd).
//   4. bits: one thread per 8 sources: s_match (its run holds a valid row),
//      packed big-endian like jnp.packbits; multi when a matched source is
//      not its run's winner (its key occurs twice in the source).
//   5. head: [multi | overflow = 0 | matched count, 4 bytes LE | s_bits].
// t_match and s_first start as 0 and m over all cap rows.
//
// What bounds it: bytes — the two cap-long outputs it must write (5 bytes a
// row) and the source keys; the searches touch log2(n) slab keys each, and
// a run is walked by one thread, so a slab whose matched keys repeat many
// times (thousands of equal rows) serializes on those threads.
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int64_t load_key(const void* s, int is_i32, long long j) {
  return is_i32 ? (int64_t)((const int32_t*)s)[j] : ((const int64_t*)s)[j];
}

__global__ void fill_kernel(uint8_t* __restrict__ t_match, int32_t* __restrict__ s_first,
                            long long cap, int32_t m) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < cap;
       i += (long long)gridDim.x * blockDim.x) {
    t_match[i] = 0;
    s_first[i] = m;
  }
}

__global__ void search_kernel(const int64_t* __restrict__ sk, long long n,
                              const void* __restrict__ s, int is_i32, long long m,
                              int32_t* __restrict__ s_pos, int32_t* __restrict__ run_first) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  const int64_t x = load_key(s, is_i32, j);
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (sk[mid] < x) lo = mid + 1; else hi = mid;
  }
  const bool hit = lo < n && sk[lo] == x;
  s_pos[j] = hit ? (int32_t)lo : -1;
  if (hit) run_first[lo] = (int32_t)m;
}

__global__ void min_kernel(const int32_t* __restrict__ s_pos, long long m,
                           int32_t* __restrict__ run_first) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  const int32_t lb = s_pos[j];
  if (lb >= 0) atomicMin(&run_first[lb], (int32_t)j);
}

__global__ void runs_kernel(const int64_t* __restrict__ sk, const uint8_t* __restrict__ sv,
                            long long n, const int32_t* __restrict__ s_pos, long long m,
                            const int32_t* __restrict__ run_first,
                            uint8_t* __restrict__ run_valid, uint8_t* __restrict__ t_match,
                            int32_t* __restrict__ s_first, uint32_t* __restrict__ flags) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  const int32_t lb = s_pos[j];
  if (lb < 0 || run_first[lb] != (int32_t)j) return;
  const int64_t key = sk[lb];
  uint32_t matched = 0;
  for (long long i = lb; i < n && sk[i] == key; ++i) {
    const uint8_t v = sv[i];
    s_first[i] = (int32_t)j;
    t_match[i] = v;
    matched += v;
  }
  run_valid[lb] = matched ? 1 : 0;
  if (matched) atomicAdd(&flags[0], matched);
}

__global__ void bits_kernel(const int32_t* __restrict__ s_pos, long long m,
                            const int32_t* __restrict__ run_first,
                            const uint8_t* __restrict__ run_valid, uint8_t* __restrict__ head,
                            uint32_t* __restrict__ flags) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b * 8 >= m) return;
  uint8_t bits = 0;
  bool multi = false;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const long long j = b * 8 + k;
    const int32_t lb = s_pos[j];
    if (lb >= 0 && run_valid[lb]) {
      bits |= (uint8_t)(0x80u >> k);
      multi |= run_first[lb] != (int32_t)j;
    }
  }
  head[6 + b] = bits;
  if (multi) flags[1] = 1;
}

__global__ void head_kernel(uint8_t* __restrict__ head, const uint32_t* __restrict__ flags) {
  const uint32_t mc = flags[0];
  head[0] = flags[1] ? 1 : 0;
  head[1] = 0;  // the search never overflows
  head[2] = mc & 0xFF;
  head[3] = (mc >> 8) & 0xFF;
  head[4] = (mc >> 16) & 0xFF;
  head[5] = (mc >> 24) & 0xFF;
}

unsigned blocks(long long work) {
  const long long g = (work + kThreads - 1) / kThreads;
  return (unsigned)(g < 1 ? 1 : g);
}

}  // namespace

// sk (cap,) i64 sorted, sv (cap,) u8, s (m,) i32 or i64 (m % 8 == 0);
// outputs head (6 + m/8,) u8, t_match (cap,) u8, s_first (cap,) i32.
// scratch: run_first i32[n], run_valid u8[n], s_pos i32[m], flags u32[2].
extern "C" int dtt_slab_probe(const int64_t* sk, const uint8_t* sv, long long n, long long cap,
                              const void* s, int s_is_i32, long long m, uint8_t* head,
                              uint8_t* t_match, int32_t* s_first, void* scratch,
                              long long scratch_bytes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n < 0 || n > cap || m % 8 || m >= (1ll << 31) || cap >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  char* cur = (char*)scratch;
  char* end = cur + scratch_bytes;
  int32_t* run_first = (int32_t*)dtt_scan::carve(cur, end, 4 * (n > 0 ? n : 1));
  uint8_t* run_valid = (uint8_t*)dtt_scan::carve(cur, end, n > 0 ? n : 1);
  int32_t* s_pos = (int32_t*)dtt_scan::carve(cur, end, 4 * (m > 0 ? m : 1));
  uint32_t* flags = (uint32_t*)dtt_scan::carve(cur, end, 8);
  if (!run_first || !run_valid || !s_pos || !flags) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(flags, 0, 8, st);
  if (err != cudaSuccess) return (int)err;
  if (cap > 0) {
    long long g = (cap + kThreads - 1) / kThreads;
    if (g > 132 * 16) g = 132 * 16;
    fill_kernel<<<(unsigned)g, kThreads, 0, st>>>(t_match, s_first, cap, (int32_t)m);
  }
  if (m > 0) {
    search_kernel<<<blocks(m), kThreads, 0, st>>>(sk, n, s, s_is_i32, m, s_pos, run_first);
    min_kernel<<<blocks(m), kThreads, 0, st>>>(s_pos, m, run_first);
    runs_kernel<<<blocks(m), kThreads, 0, st>>>(sk, sv, n, s_pos, m, run_first, run_valid,
                                                t_match, s_first, flags);
    bits_kernel<<<blocks(m / 8), kThreads, 0, st>>>(s_pos, m, run_first, run_valid, head,
                                                    flags);
  }
  head_kernel<<<1, 1, 0, st>>>(head, flags);
  return (int)cudaGetLastError();
}

// Upload join probe (K12): the MERGE join's membership kernel for a target
// key lane uploaded whole (no resident slab).
//
// Replaces delta_tpu/ops/join_kernel.py:127 `_single_device_kernel`, an XLA
// jit on the TPU that sorts both sides and counts with two-way
// searchsorted:
//   t_bits = packbits(count_in_s(t) > 0), s_bits = packbits(count_in_t(s) > 0),
//   multi  = any(count_in_s(t) > 1),
// bits big-endian as jnp.packbits. The inputs are padded by the caller
// (ops/join_kernel.inner_join_async) with per-side sentinels, so a pad or a
// NULL key never matches anything; keys are int32 or int64 (both sides the
// same type).
//
// Design: the TPU kernel sorts both sides because dense compares suit it.
// Here the large side is the target (~12.6M keys at bench config 2, against
// 2^20 source keys), so only the source is sorted, with the one-sweep radix
// sort of the slab sort (radix.cuh; int32 keys sort as one uint32 word):
//   1. each target key is binary-searched for [lo, hi) in the sorted source:
//      hi - lo is its count, which gives t_bits and multi; where the count is
//      above 0 a flag is set at lo, the first sorted position of that run;
//   2. each sorted source position reads the flag at its own run's lower
//      bound and scatters it through the sort permutation to source order,
//      and the source flags are packed.
// O((n + m) log m), no sort of the target and no walk over duplicate runs.
//
// What bounds it: on this card, memory traffic and the target's dependent
// binary-search loads (log2 m of them per key, into a 4-8 MB sorted source
// that stays in L2), not compares.
//
// The sharded join probe (K13) is the second entry point, dtt_join_probe_shard.
// It replaces delta_tpu/ops/join_kernel.py:150 `_sharded_kernel`, a shard_map
// over the TPU mesh: the target stays sharded (contiguous slabs of
// cap_t / p), the padded source is all-gathered (tiled, so in its original
// order), each shard counts its target keys' hits in the sorted source
// (packed t bits, any(count > 1)) and the source's hits in its sorted slab,
// and `psum`s reduce the source hits and the multi flags. Here one launch a
// shard runs the passes above over (its slab, the whole gathered source):
// the source direction comes from the same run flags, so the slab is never
// sorted, and the outputs are the shard's packed t bits, ONE BYTE PER SOURCE
// ROW (1 where some key of this slab equals it) and its multi byte. The
// combine kernel (shard_combine.cu) ORs the source bytes over the shards and
// packs them, and ORs the multi bytes. Every shard sees the whole source, so
// a key repeated across two source shards still counts as a multi-match on
// the one target shard that holds it, as in the TPU kernel.
#include <cuda_runtime.h>
#include <stdint.h>

#include "radix.cuh"

namespace {

using namespace dtt_radix;

// The source's sort through radix.cuh: int32 keys sort as uint32 with the
// sign bit flipped (at most 4 digit bytes, one uint32 word), int64 as uint64;
// the last pass writes the sorted keys as int64 and the permutation.
template <typename K>
struct JoinSrc {
  const K* s;
  __device__ __forceinline__ uint64_t key(long long i) const {
    if (sizeof(K) == 4) return (uint64_t)((uint32_t)s[i] ^ 0x80000000u);
    return (uint64_t)(int64_t)s[i] ^ kSign;
  }
  __device__ __forceinline__ uint32_t tag(long long) const { return 0u; }
};

template <typename K>
struct JoinDst {
  int64_t* sk;
  int32_t* perm;
  __device__ __forceinline__ void put(long long pos, uint64_t u, uint32_t row) const {
    sk[pos] = sizeof(K) == 4 ? (int64_t)(int32_t)((uint32_t)u ^ 0x80000000u)
                             : (int64_t)(u ^ kSign);
    perm[pos] = (int32_t)row;
  }
};

__device__ __forceinline__ long long lower_bound(const int64_t* __restrict__ sk, long long m,
                                                 int64_t key) {
  long long lo = 0, hi = m;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (sk[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ long long upper_bound(const int64_t* __restrict__ sk, long long lo,
                                                 long long m, int64_t key) {
  long long hi = m;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (sk[mid] <= key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// One thread per output byte: 8 consecutive target keys.
template <typename K>
__global__ void target_kernel(const K* __restrict__ t, long long n_bytes,
                              const int64_t* __restrict__ sk, long long m,
                              uint8_t* __restrict__ t_bits, uint8_t* __restrict__ run_flag,
                              unsigned int* __restrict__ multi) {
  bool local_multi = false;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < n_bytes;
       j += (long long)gridDim.x * blockDim.x) {
    unsigned byte = 0;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int64_t key = (int64_t)t[8 * j + e];
      const long long lo = lower_bound(sk, m, key);
      if (lo < m && sk[lo] == key) {
        const long long hi = upper_bound(sk, lo + 1, m, key);
        byte |= 0x80u >> e;
        run_flag[lo] = 1;
        local_multi |= hi - lo > 1;
      }
    }
    t_bits[j] = (uint8_t)byte;
  }
  if (local_multi) atomicOr(multi, 1u);
}

__global__ void source_kernel(const int64_t* __restrict__ sk, const int32_t* __restrict__ perm,
                              long long m, const uint8_t* __restrict__ run_flag,
                              uint8_t* __restrict__ s_match) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += (long long)gridDim.x * blockDim.x) {
    s_match[perm[i]] = run_flag[lower_bound(sk, m, sk[i])];
  }
}

__global__ void multi_kernel(const unsigned int* __restrict__ multi,
                             uint8_t* __restrict__ multi_out) {
  *multi_out = *multi ? 1 : 0;
}

__global__ void pack_kernel(const uint8_t* __restrict__ s_match, long long m_bytes,
                            uint8_t* __restrict__ s_bits, const unsigned int* __restrict__ multi,
                            uint8_t* __restrict__ multi_out) {
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < m_bytes;
       j += (long long)gridDim.x * blockDim.x) {
    unsigned byte = 0;
#pragma unroll
    for (int e = 0; e < 8; ++e) byte |= (s_match[8 * j + e] ? 0x80u : 0u) >> e;
    s_bits[j] = (uint8_t)byte;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *multi_out = *multi ? 1 : 0;
}

// s_hit == nullptr: K12 (packed source bits into s_bits); else K13's shard
// (one byte a source row into s_hit, s_bits unused).
template <typename K>
int run(const K* t, long long cap_t, const K* s, long long cap_s, uint8_t* t_bits,
        uint8_t* s_bits, uint8_t* s_hit, uint8_t* multi_out, void* scratch,
        long long scratch_bytes, cudaStream_t st) {
  const long long m = cap_s;
  char* cur = (char*)scratch;
  char* end = cur + scratch_bytes;
  int64_t* sk = (int64_t*)dtt_scan::carve(cur, end, 8 * m);
  int32_t* perm = (int32_t*)dtt_scan::carve(cur, end, 4 * m);
  uint8_t* run_flag = (uint8_t*)dtt_scan::carve(cur, end, m);
  uint8_t* s_match = (uint8_t*)dtt_scan::carve(cur, end, m);
  unsigned int* multi = (unsigned int*)dtt_scan::carve(cur, end, 16);
  if (!sk || !perm || !run_flag || !s_match || !multi) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(run_flag, 0, m, st);
  if (err == cudaSuccess) err = cudaMemsetAsync(multi, 0, 16, st);
  if (err == cudaSuccess) err = sort_rows(JoinSrc<K>{s}, JoinDst<K>{sk, perm}, m, cur, end, st);
  if (err != cudaSuccess) return (int)err;
  target_kernel<K><<<grid_for(cap_t / 8), kThreads, 0, st>>>(t, cap_t / 8, sk, m, t_bits,
                                                             run_flag, multi);
  if (s_hit) {
    source_kernel<<<grid_for(m), kThreads, 0, st>>>(sk, perm, m, run_flag, s_hit);
    multi_kernel<<<1, 1, 0, st>>>(multi, multi_out);
  } else {
    source_kernel<<<grid_for(m), kThreads, 0, st>>>(sk, perm, m, run_flag, s_match);
    pack_kernel<<<grid_for(m / 8), kThreads, 0, st>>>(s_match, m / 8, s_bits, multi,
                                                      multi_out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// t (cap_t,), s (cap_s,) int32 (is32 = 1) or int64; cap_t and cap_s
// multiples of 8, cap_s >= 8. Outputs t_bits (cap_t/8,) u8, s_bits
// (cap_s/8,) u8, multi (1,) u8. scratch (each part aligned to 256): the
// sorted keys (int64) and the permutation (int32), two byte flags of cap_s,
// the multi word, then the radix sort's (dtt_radix::sort_rows).
extern "C" int dtt_join_probe(const void* t, long long cap_t, const void* s, long long cap_s,
                              int is32, uint8_t* t_bits, uint8_t* s_bits, uint8_t* multi,
                              void* scratch, long long scratch_bytes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (cap_t < 0 || cap_s < 8 || cap_t % 8 || cap_s % 8 || cap_s >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  if (is32)
    return run<int32_t>((const int32_t*)t, cap_t, (const int32_t*)s, cap_s, t_bits, s_bits,
                        nullptr, multi, scratch, scratch_bytes, st);
  return run<int64_t>((const int64_t*)t, cap_t, (const int64_t*)s, cap_s, t_bits, s_bits,
                      nullptr, multi, scratch, scratch_bytes, st);
}

// K13, one shard: t (cap_t,) this shard's target slab, s (cap_s,) the whole
// gathered source, as dtt_join_probe's. Outputs t_bits (cap_t/8,) u8, s_hit
// (cap_s,) u8 (0/1 a source row), multi (1,) u8; the same scratch.
extern "C" int dtt_join_probe_shard(const void* t, long long cap_t, const void* s,
                                    long long cap_s, int is32, uint8_t* t_bits, uint8_t* s_hit,
                                    uint8_t* multi, void* scratch, long long scratch_bytes,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (cap_t < 0 || cap_s < 8 || cap_t % 8 || cap_s % 8 || cap_s >= (1ll << 31) || !s_hit)
    return (int)cudaErrorInvalidValue;
  if (is32)
    return run<int32_t>((const int32_t*)t, cap_t, (const int32_t*)s, cap_s, t_bits, nullptr,
                        s_hit, multi, scratch, scratch_bytes, st);
  return run<int64_t>((const int64_t*)t, cap_t, (const int64_t*)s, cap_s, t_bits, nullptr,
                      s_hit, multi, scratch, scratch_bytes, st);
}

// Morton interleave (K16) and the Z-order sorts around it: integer columns
// ranked on the card, then k columns of 16-bit ranks -> one 64-bit Z-order
// key a row (bit b of column c at position b*k + c), then the key's stable
// order on the card.
//
// Replaces delta_tpu/ops/zorder.py:34 `morton_order`: its jitted
// `interleave` (:47, 16 x k static rounds of shifts, masks and ORs over
// uint64 lanes that XLA fuses) and the host's stable argsorts around it
// (`rank_u16`'s, :27, and the key's, :62). A bit whose position b*k + c is
// 64 or more is dropped, as XLA's `uint64 << s` gives 0 for s >= 64 (in
// C++ such a shift is undefined, so each one is guarded).
//
// The interleave (morton_kernel). What bounds it: a shift-and-OR a bit is
// 16 k guarded 64-bit shifts a row, several 32-bit instructions each: at
// k = 2 and n = 4M about 10^9 instructions, several times what its bytes
// take (PERF.md, K16). So a 256-entry table in shared memory, built by each CTA for
// this k, holds in T[v] bit b of v at position b*k (positions of 64 or more
// left out), and a rank r contributes (T[r & 255] | T[r >> 8] << 8k) << c:
// two lookups and three shifts a column, each shift by a uniform amount.
// A thread takes 4 rows: one 16-byte load of each column's ranks and two
// 16-byte stores of keys; a tail of n not a multiple of 4, or a column
// whose base is not 16-byte aligned (k n not a multiple of 4), takes a
// scalar path. The grid is the CTAs that fill the card once, so the table
// is built once a CTA.
//
// The sorts run dtt_radix::sort_rows (radix.cuh), stable LSD passes over
// the bytes that vary, with a source and a sink of this file:
//   rank (dtt_morton_rank): a column's values (int32 or int64) as the
//     unsigned key of their signed order; the sink writes the row's rank
//     (pos * 65535) / max(n - 1, 1) at the row's tag, into the ranks row the
//     interleave reads. Equal values keep their row order, so the ranks are
//     `rank_u16`'s (a stable argsort's positions, scaled).
//   key order (dtt_morton_sort): the key as it is, unsigned; the sink
//     writes the int32 permutation, so only it goes back to the host. At
//     k = 2 the key spans 32 bits: four passes of uint32 digit words.
// An all-equal key or column varies in no byte and runs no pass: the
// sort's identity kernel hands every row to the sink in place.
#include <cuda_runtime.h>
#include <stdint.h>

#include "radix.cuh"

namespace {

using namespace dtt_radix;

constexpr int kMortonThreads = 256;
constexpr int kRowsAThread = 4;

__global__ void __launch_bounds__(kMortonThreads)
morton_kernel(const int32_t* __restrict__ ranks, int k, long long n, int cols_aligned,
              long long* __restrict__ key) {
  __shared__ unsigned long long table[256];
  {
    const unsigned v = threadIdx.x;
    unsigned long long t = 0;
#pragma unroll
    for (int b = 0; b < 8; ++b)
      if (b * k < 64) t |= (unsigned long long)((v >> b) & 1u) << (b * k);
    table[v] = t;
  }
  __syncthreads();
  const int hi = 8 * k;             // the high byte's shift; >= 64 drops it
  const int cols = k < 64 ? k : 64;  // a column at c >= 64 shifts out whole
  const long long groups = (n + kRowsAThread - 1) / kRowsAThread;
  for (long long g = (long long)blockIdx.x * kMortonThreads + threadIdx.x; g < groups;
       g += (long long)gridDim.x * kMortonThreads) {
    const long long i0 = g * kRowsAThread;
    const bool full = i0 + kRowsAThread <= n;
    unsigned long long out[kRowsAThread] = {0, 0, 0, 0};
    for (int c = 0; c < cols; ++c) {
      const int32_t* col = ranks + (long long)c * n;
      unsigned r[kRowsAThread];
      if (full && (cols_aligned || c == 0)) {
        const int4 v = __ldg((const int4*)(col + i0));
        r[0] = v.x, r[1] = v.y, r[2] = v.z, r[3] = v.w;
      } else {
#pragma unroll
        for (int q = 0; q < kRowsAThread; ++q) r[q] = i0 + q < n ? (unsigned)col[i0 + q] : 0u;
      }
#pragma unroll
      for (int q = 0; q < kRowsAThread; ++q) {
        unsigned long long spread = table[r[q] & 255u];
        if (hi < 64) spread |= table[(r[q] >> 8) & 255u] << hi;
        out[q] |= spread << c;
      }
    }
    if (full) {
      longlong2* o = (longlong2*)(key + i0);
      o[0] = make_longlong2((long long)out[0], (long long)out[1]);
      o[1] = make_longlong2((long long)out[2], (long long)out[3]);
    } else {
#pragma unroll
      for (int q = 0; q < kRowsAThread; ++q)
        if (i0 + q < n) key[i0 + q] = (long long)out[q];
    }
  }
}

unsigned morton_grid(long long n) {
  static int fill[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 1;
  int f = dev < 64 ? fill[dev] : 0;
  if (!f) {
    int sms = 0, ctas = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, morton_kernel, kMortonThreads, 0);
    f = (sms > 0 ? sms : 1) * (ctas > 0 ? ctas : 1);
    if (dev < 64) fill[dev] = f;
  }
  const long long per_cta = (long long)kRowsAThread * kMortonThreads;
  const long long want = (n + per_cta - 1) / per_cta;
  return (unsigned)(want < f ? (want < 1 ? 1 : want) : f);
}

// a column's values as the unsigned key of their signed order: int32
// values in the low 4 bytes only, so a column of small ints varies in few
template <typename V>
struct RankSrc;

template <>
struct RankSrc<int32_t> {
  const int32_t* v;
  __device__ __forceinline__ uint64_t key(long long i) const {
    return (uint64_t)((uint32_t)v[i] ^ 0x80000000u);
  }
  __device__ __forceinline__ uint32_t tag(long long) const { return 0u; }
};

template <>
struct RankSrc<int64_t> {
  const int64_t* v;
  __device__ __forceinline__ uint64_t key(long long i) const { return (uint64_t)v[i] ^ kSign; }
  __device__ __forceinline__ uint32_t tag(long long) const { return 0u; }
};

struct RankDst {
  int32_t* ranks;
  long long denom;  // max(n - 1, 1)
  __device__ __forceinline__ void put(long long pos, uint64_t, uint32_t rw) const {
    ranks[rw & 0x7FFFFFFFu] = (int32_t)(pos * 65535 / denom);
  }
};

struct KeySrc {
  const uint64_t* keys;
  __device__ __forceinline__ uint64_t key(long long i) const { return keys[i]; }
  __device__ __forceinline__ uint32_t tag(long long) const { return 0u; }
};

struct PermDst {
  int32_t* perm;
  __device__ __forceinline__ void put(long long pos, uint64_t, uint32_t rw) const {
    perm[pos] = (int32_t)(rw & 0x7FFFFFFFu);
  }
};

}  // namespace

// ranks (k, n) int32 row-major, each below 2^16, 16-byte aligned; key (n,)
// int64, 16-byte aligned.
extern "C" int dtt_morton(const int32_t* ranks, int k, long long n, long long* key,
                          void* stream) {
  if (k < 1 || n < 0 || ((uintptr_t)ranks & 15) || ((uintptr_t)key & 15))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  const int cols_aligned = n % 4 == 0;  // every column's base on 16 bytes
  morton_kernel<<<morton_grid(n), kMortonThreads, 0, (cudaStream_t)stream>>>(ranks, k, n,
                                                                            cols_aligned, key);
  return (int)cudaGetLastError();
}

// values (n,) int32 (is32 = 1) or int64; ranks (n,) int32 out: the stable
// rank of each row scaled to [0, 2^16). n below 2^31 (the tag's bit 31).
// scratch: the radix sort's (ops/key_cache._radix_scratch_bytes(n)). Reads
// the sort's `diff` back to the host: the call synchronises the stream.
extern "C" int dtt_morton_rank(const void* values, int is32, long long n, int32_t* ranks,
                               void* scratch, long long scratch_bytes, void* stream) {
  if (n < 0 || n >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  char* cur = (char*)scratch;
  char* end = cur + scratch_bytes;
  const RankDst dst{ranks, n > 1 ? n - 1 : 1};
  cudaError_t err =
      is32 ? sort_rows(RankSrc<int32_t>{(const int32_t*)values}, dst, n, cur, end,
                       (cudaStream_t)stream)
           : sort_rows(RankSrc<int64_t>{(const int64_t*)values}, dst, n, cur, end,
                       (cudaStream_t)stream);
  return (int)err;
}

// key (n,) int64 bit patterns, ordered as unsigned; perm (n,) int32 out:
// the stable order (np.argsort(key.view(uint64), kind="stable")). n below
// 2^31; scratch and the synchronisation as dtt_morton_rank's.
extern "C" int dtt_morton_sort(const int64_t* key, long long n, int32_t* perm, void* scratch,
                               long long scratch_bytes, void* stream) {
  if (n < 0 || n >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  char* cur = (char*)scratch;
  char* end = cur + scratch_bytes;
  return (int)sort_rows(KeySrc{(const uint64_t*)key}, PermDst{perm}, n, cur, end,
                        (cudaStream_t)stream);
}

// Slab sort (K8): the MERGE key slab's int64 lane in key order.
//
// Replaces delta_tpu/ops/key_cache.py:166 `_sort_kernel`, an XLA jit of
// `jax.lax.sort((enc, iota))` on the TPU: rows at or past n encode as
// int64.max, and the outputs are the sorted keys, the permutation, its
// inverse (`inv[perm[i]] = i`) and the sorted validity
// `valid[perm] & (perm < n)`.
//
// What bounds it on this card: bytes. A radix sort reads and writes every
// row once a digit pass, so the design moves as few bytes a pass as the keys
// allow (radix.cuh): the one-sweep LSD sort of the n real rows only,
// narrowed to the bytes that vary. At bench config 2 the keys vary in their
// low 4 bytes: one histogram read of the keys, then 4 passes of a uint32
// digit word and an int32 row word, 8 bytes a row each way. The row word
// carries the row's validity in bit 31 (rows are below 2^31), so the last
// pass writes the rebuilt key, perm and sv itself, with no gather of
// `valid`. The inverse `inv[perm[i]] = i` goes through a partition of the
// rows by bucket and a window of inv in shared memory (below), so its
// stores are coalesced.
// Padding rows are the largest possible key and come after every real row
// in index order, so a stable sort of all cap rows is the sorted real rows
// followed by the pads in order: they are written in place. The sort is
// stable by construction, so it equals torch.sort(stable=True). The table's
// byte bound (each input read once, each output written once) is out of
// reach of any radix sort: it does not count the passes.
#include <cuda_runtime.h>
#include <stdint.h>

#include "radix.cuh"

namespace {

using namespace dtt_radix;

struct SlabSrc {
  const int64_t* keys;
  const uint8_t* valid;
  __device__ __forceinline__ uint64_t key(long long i) const {
    return (uint64_t)keys[i] ^ kSign;
  }
  __device__ __forceinline__ uint32_t tag(long long i) const {
    return valid[i] ? 0x80000000u : 0u;
  }
};

struct SlabDst {
  int64_t* sk;
  int32_t* perm;
  uint8_t* sv;
  __device__ __forceinline__ void put(long long pos, uint64_t u, uint32_t rw) const {
    sk[pos] = (int64_t)(u ^ kSign);
    perm[pos] = (int32_t)(rw & 0x7FFFFFFFu);
    sv[pos] = (uint8_t)(rw >> 31);
  }
};

// The inverse inv[perm[i]] = i scatters to random rows: straight, one
// uncoalesced 4-byte store a row. It runs in two coalesced steps instead.
// inv_partition_kernel moves each (row, i) pair into its row's bucket of
// 2^shift rows: a tile of 4096 perm entries counts its buckets in shared
// memory, reserves a run in each bucket (one global atomic a bucket a
// tile), stages the pairs by bucket and writes the runs. A bucket b holds
// exactly the rows [b << shift, (b + 1) << shift) (perm is a permutation of
// [0, n)), so its pairs start at b << shift. inv_window_kernel then builds
// each window of 2^15 rows of inv in shared memory (128 KB) from its
// bucket's pairs and writes it out whole. shift is 15 up to 2^25 rows (one
// window a bucket); above, 2^(shift - 15) windows read one bucket.
constexpr int kInvItems = 16;                // perm entries a partition thread
constexpr int kInvTile = kThreads * kInvItems;
constexpr int kInvWindow = 15;               // log2 of rows a window
constexpr int kInvBuckets = 1024;            // at most

inline int inv_shift(long long n) {
  int shift = kInvWindow;
  while (((n - 1) >> shift) + 1 > kInvBuckets) ++shift;
  return shift;
}

__global__ void __launch_bounds__(kThreads)
inv_partition_kernel(const int32_t* __restrict__ perm, long long n, int shift, int nb,
                     unsigned int* __restrict__ fill, int2* __restrict__ pairs) {
  extern __shared__ __align__(16) unsigned char smem[];
  int2* stage = reinterpret_cast<int2*>(smem);                 // kInvTile pairs
  uint32_t* cnt = reinterpret_cast<uint32_t*>(stage + kInvTile);  // [nb]: count
  uint32_t* start = cnt + nb;                                  // [nb]: in the tile
  long long* base = reinterpret_cast<long long*>(start + nb);   // [nb]: in pairs
  __shared__ uint32_t warp_sums[kWarps];
  const int t = threadIdx.x;
  for (int b = t; b < nb; b += kThreads) cnt[b] = 0u;
  __syncthreads();
  const long long i0 = (long long)blockIdx.x * kInvTile;
  int32_t row[kInvItems];
  uint32_t slot[kInvItems] = {};
#pragma unroll
  for (int k = 0; k < kInvItems; ++k) {
    const long long i = i0 + k * kThreads + t;
    row[k] = i < n ? perm[i] : -1;
    if (row[k] >= 0) slot[k] = atomicAdd(&cnt[row[k] >> shift], 1u);
  }
  __syncthreads();
  // the buckets' starts in the tile: each thread scans a run of buckets
  const int per = (nb + kThreads - 1) / kThreads;
  uint32_t run = 0u;
  for (int b = t * per; b < nb && b < (t + 1) * per; ++b) run += cnt[b];
  uint32_t off = cta_exclusive_scan(run, warp_sums);
  for (int b = t * per; b < nb && b < (t + 1) * per; ++b) {
    start[b] = off;
    off += cnt[b];
    if (cnt[b]) base[b] = ((long long)b << shift) + atomicAdd(fill + b, cnt[b]);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kInvItems; ++k)
    if (row[k] >= 0)
      stage[start[row[k] >> shift] + slot[k]] = make_int2(row[k], (int)(i0 + k * kThreads + t));
  __syncthreads();
  const long long rem = n - i0;
  const int tile_n = rem < kInvTile ? (int)rem : kInvTile;
  for (int j = t; j < tile_n; j += kThreads) {
    const int2 p = stage[j];
    const int b = p.x >> shift;
    pairs[base[b] + (j - start[b])] = p;
  }
}

constexpr int kWindowThreads = 1024;

__global__ void __launch_bounds__(kWindowThreads)
inv_window_kernel(const int2* __restrict__ pairs, long long n, int shift,
                  int32_t* __restrict__ inv) {
  extern __shared__ int32_t win[];  // 2^kInvWindow rows of inv
  const long long w0 = (long long)blockIdx.x << kInvWindow;
  const long long p0 = (long long)(blockIdx.x >> (shift - kInvWindow)) << shift;
  const long long p1 = p0 + (1ll << shift) < n ? p0 + (1ll << shift) : n;
  for (long long j = p0 + threadIdx.x; j < p1; j += kWindowThreads) {
    const int2 p = pairs[j];
    const long long r = p.x - w0;
    if (r >= 0 && r < (1ll << kInvWindow)) win[r] = p.y;
  }
  __syncthreads();
  const long long w1 = w0 + (1ll << kInvWindow) < n ? w0 + (1ll << kInvWindow) : n;
  for (long long r = w0 + threadIdx.x; r < w1; r += kWindowThreads) inv[r] = win[r - w0];
}

// The pads [n, cap): the largest key, identity perm and inv, invalid.
__global__ void pads_kernel(long long n, long long cap, int64_t* __restrict__ sk,
                            int32_t* __restrict__ perm, int32_t* __restrict__ inv,
                            uint8_t* __restrict__ sv) {
  for (long long i = n + (long long)blockIdx.x * blockDim.x + threadIdx.x; i < cap;
       i += (long long)gridDim.x * blockDim.x) {
    sk[i] = INT64_MAX;
    perm[i] = (int32_t)i;
    inv[i] = (int32_t)i;
    sv[i] = 0;
  }
}

cudaError_t inverse(const int32_t* perm, long long n, int32_t* inv, int2* pairs,
                    unsigned int* fill, cudaStream_t s) {
  const int shift = inv_shift(n);
  const int nb = (int)(((n - 1) >> shift) + 1);
  cudaError_t err = cudaMemsetAsync(fill, 0, 4 * nb, s);
  if (err != cudaSuccess) return err;
  const int part_smem = kInvTile * (int)sizeof(int2) + 16 * nb;
  err = cudaFuncSetAttribute(inv_partition_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             part_smem);
  if (err != cudaSuccess) return err;
  inv_partition_kernel<<<(unsigned)((n + kInvTile - 1) / kInvTile), kThreads, part_smem, s>>>(
      perm, n, shift, nb, fill, pairs);
  const int win_smem = (int)sizeof(int32_t) << kInvWindow;
  err = cudaFuncSetAttribute(inv_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             win_smem);
  if (err != cudaSuccess) return err;
  inv_window_kernel<<<(unsigned)(((n - 1) >> kInvWindow) + 1), kWindowThreads, win_smem, s>>>(
      pairs, n, shift, inv);
  return cudaGetLastError();
}

}  // namespace

// keys (cap,) i64, valid (cap,) u8; outputs sk (cap,) i64, perm/inv (cap,)
// i32, sv (cap,) u8. scratch (each part aligned to 256): the inverse's
// (row, i) pairs (8 * n bytes) and bucket counters (4 * kInvBuckets), then
// the radix sort's (dtt_radix::sort_rows; ops/key_cache.py
// `_sort_scratch_bytes`).
extern "C" int dtt_slab_sort(const int64_t* keys, const uint8_t* valid, long long n,
                             long long cap, int64_t* sk, int32_t* perm, int32_t* inv,
                             uint8_t* sv, void* scratch, long long scratch_bytes,
                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n < 0 || n > cap || cap >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  if (cap == 0) return (int)cudaSuccess;
  char* cur = (char*)scratch;
  char* end = cur + scratch_bytes;
  int2* pairs = (int2*)dtt_scan::carve(cur, end, 8 * (n > 0 ? n : 1));
  unsigned int* fill = (unsigned int*)dtt_scan::carve(cur, end, 4 * kInvBuckets);
  if (!pairs || !fill) return (int)cudaErrorInvalidValue;
  cudaError_t err = sort_rows(SlabSrc{keys, valid}, SlabDst{sk, perm, sv}, n, cur, end, s);
  if (err == cudaSuccess && n > 0) err = inverse(perm, n, inv, pairs, fill, s);
  if (err != cudaSuccess) return (int)err;
  if (cap > n) pads_kernel<<<grid_for(cap - n), kThreads, 0, s>>>(n, cap, sk, perm, inv, sv);
  return (int)cudaGetLastError();
}

// Slab sort (K8): the MERGE key slab's int64 lane in key order.
//
// Replaces delta_tpu/ops/key_cache.py:166 `_sort_kernel`, an XLA jit of
// `jax.lax.sort((enc, iota))` on the TPU: rows at or past n encode as
// int64.max, and the outputs are the sorted keys, the permutation, its
// inverse (`inv[perm[i]] = i`) and the sorted validity
// `valid[perm] & (perm < n)`.
//
// Design: an LSD radix sort of the n real rows only (radix.cuh): keys map
// to uint64 with the sign bit flipped (order-preserving), 8-bit digits, one
// stable pass per digit. A pass whose digit is the same for every real key
// is the identity and is skipped: one OR reduction of `key ^ key[0]` (read
// back to the host) names the varying bytes, so keys below 2^25 take 4
// passes, not 8.
// Padding rows are the largest possible key and come after every real row
// in index order, so a stable sort of all cap rows is the sorted real rows
// followed by the pads in order: the finish kernel writes them directly.
// The sort is stable by construction, so it equals torch.sort(stable=True).
//
// What bounds it: bytes. Each pass reads the keys and the permutation twice
// (histogram, scatter) and writes them once; the scatter's writes land in
// 256 buckets per tile, so they are partly uncoalesced.
#include <cuda_runtime.h>
#include <stdint.h>

#include "radix.cuh"

namespace {

using namespace dtt_radix;

__global__ void encode_kernel(const int64_t* __restrict__ keys, long long n,
                              uint64_t* __restrict__ uk, int32_t* __restrict__ perm,
                              unsigned long long* __restrict__ diff) {
  const uint64_t first = (uint64_t)keys[0] ^ kSign;
  unsigned long long local = 0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const uint64_t u = (uint64_t)keys[i] ^ kSign;
    uk[i] = u;
    perm[i] = (int32_t)i;
    local |= u ^ first;
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) local |= __shfl_xor_sync(0xffffffffu, local, o);
  if ((threadIdx.x & 31) == 0 && local) atomicOr(diff, local);
}

__global__ void finish_kernel(const uint64_t* __restrict__ uk, const int32_t* __restrict__ p,
                              long long n, long long cap, const uint8_t* __restrict__ valid,
                              int64_t* __restrict__ sk, int32_t* __restrict__ perm,
                              int32_t* __restrict__ inv, uint8_t* __restrict__ sv) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < cap;
       i += (long long)gridDim.x * blockDim.x) {
    if (i < n) {
      const int32_t pi = p[i];
      sk[i] = (int64_t)(uk[i] ^ kSign);
      perm[i] = pi;
      inv[pi] = (int32_t)i;
      sv[i] = valid[pi];
    } else {
      sk[i] = INT64_MAX;
      perm[i] = (int32_t)i;
      inv[i] = (int32_t)i;
      sv[i] = 0;
    }
  }
}

}  // namespace

// keys (cap,) i64, valid (cap,) u8; outputs sk (cap,) i64, perm/inv (cap,)
// i32, sv (cap,) u8. scratch: two uint64 and two int32 ping-pong lanes of n,
// the digit histogram (256 x tiles), its scan's aux, the diff word.
extern "C" int dtt_slab_sort(const int64_t* keys, const uint8_t* valid, long long n,
                             long long cap, int64_t* sk, int32_t* perm, int32_t* inv,
                             uint8_t* sv, void* scratch, long long scratch_bytes,
                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n < 0 || n > cap || cap >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const long long tiles = (n + kTile - 1) / kTile;
    const long long hist_len = (long long)kRadix * tiles;
    char* cur = (char*)scratch;
    char* end = cur + scratch_bytes;
    uint64_t* uk[2] = {(uint64_t*)dtt_scan::carve(cur, end, 8 * n),
                       (uint64_t*)dtt_scan::carve(cur, end, 8 * n)};
    int32_t* pp[2] = {(int32_t*)dtt_scan::carve(cur, end, 4 * n),
                      (int32_t*)dtt_scan::carve(cur, end, 4 * n)};
    uint32_t* hist = (uint32_t*)dtt_scan::carve(cur, end, 4 * hist_len);
    uint32_t* aux = (uint32_t*)dtt_scan::carve(cur, end,
                                               4 * dtt_scan::scan_aux_elems(hist_len));
    unsigned long long* diff = (unsigned long long*)dtt_scan::carve(cur, end, 8);
    if (!uk[0] || !uk[1] || !pp[0] || !pp[1] || !hist || !aux || !diff)
      return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaMemsetAsync(diff, 0, 8, s);
    if (err != cudaSuccess) return (int)err;
    encode_kernel<<<grid_for(n), kThreads, 0, s>>>(keys, n, uk[0], pp[0], diff);
    unsigned long long h_diff = 0;
    err = cudaMemcpyAsync(&h_diff, diff, 8, cudaMemcpyDeviceToHost, s);
    if (err == cudaSuccess) err = cudaStreamSynchronize(s);
    if (err != cudaSuccess) return (int)err;
    const int cur_buf = sort_passes(uk, pp, n, h_diff, hist, aux, s);
    finish_kernel<<<grid_for(cap), kThreads, 0, s>>>(uk[cur_buf], pp[cur_buf], n, cap, valid,
                                                     sk, perm, inv, sv);
  } else if (cap > 0) {
    finish_kernel<<<grid_for(cap), kThreads, 0, s>>>(nullptr, nullptr, 0, cap, valid, sk, perm,
                                                     inv, sv);
  }
  return (int)cudaGetLastError();
}

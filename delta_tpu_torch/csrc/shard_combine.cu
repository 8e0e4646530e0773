// Cross-shard combine: the arithmetic of the TPU kernels' `psum`.
//
// Replaces the `jax.lax.psum` reductions inside the shard_map kernels of
// delta_tpu/ops/replay_kernel.py:206 (the three sums of the sharded replay)
// and delta_tpu/ops/join_kernel.py:150 (the source hits and the multi flag
// of the sharded join probe). On the TPU, XLA runs the reduction over ICI;
// here the shards' partial results are first copied to the lead device
// (communication, parallel/mesh.all_gather), stacked as (n, k) rows, and one
// launch of this kernel reduces them there:
//   op 0 (sum):      out (k,) int64 = the sum of the n rows (wrapping, as
//                    JAX's int64 psum);
//   op 1 (or_pack):  out (ceil(k/8),) u8 = packbits(OR of the n rows != 0),
//                    big-endian (`jnp.packbits` order);
//   op 2 (or):       out (k,) u8 = OR of the n rows != 0.
//
// Design: one thread per output element (op 0, op 2) or per output byte (op
// 1, its 8 columns), walking the n rows down the column; neighbouring
// threads read neighbouring bytes of a row. n is the
// shard count (at most a few dozen), k up to the source capacity (2^20 at
// bench config 2).
//
// What bounds it: bytes (n * k read once, k or k/8 written).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void sum_kernel(const long long* __restrict__ rows, int n, long long k,
                           long long* __restrict__ out) {
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < k;
       j += (long long)gridDim.x * blockDim.x) {
    unsigned long long acc = 0;
    for (int i = 0; i < n; ++i) acc += (unsigned long long)rows[(long long)i * k + j];
    out[j] = (long long)acc;
  }
}

__global__ void or_kernel(const uint8_t* __restrict__ rows, int n, long long k,
                          uint8_t* __restrict__ out) {
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < k;
       j += (long long)gridDim.x * blockDim.x) {
    unsigned v = 0;
    for (int i = 0; i < n; ++i) v |= rows[(long long)i * k + j];
    out[j] = v ? 1 : 0;
  }
}

__global__ void or_pack_kernel(const uint8_t* __restrict__ rows, int n, long long k,
                               uint8_t* __restrict__ out) {
  const long long k_bytes = (k + 7) / 8;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < k_bytes;
       j += (long long)gridDim.x * blockDim.x) {
    unsigned byte = 0;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const long long col = 8 * j + e;
      if (col >= k) break;
      unsigned v = 0;
      for (int i = 0; i < n; ++i) v |= rows[(long long)i * k + col];
      byte |= (v ? 0x80u : 0u) >> e;
    }
    out[j] = (uint8_t)byte;
  }
}

unsigned grid_for(long long work) {
  long long g = (work + kThreads - 1) / kThreads;
  if (g < 1) g = 1;
  if (g > 65535) g = 65535;
  return (unsigned)g;
}

}  // namespace

// rows (n, k): int64 for op 0, u8 for ops 1 and 2, contiguous on the lead
// device; out as above. n >= 1, k >= 0.
extern "C" int dtt_shard_combine(const void* rows, int n, long long k, int op, void* out,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n < 1 || k < 0 || op < 0 || op > 2) return (int)cudaErrorInvalidValue;
  if (k == 0) return (int)cudaGetLastError();
  if (op == 0)
    sum_kernel<<<grid_for(k), kThreads, 0, s>>>((const long long*)rows, n, k, (long long*)out);
  else if (op == 1)
    or_pack_kernel<<<grid_for((k + 7) / 8), kThreads, 0, s>>>((const uint8_t*)rows, n, k,
                                                              (uint8_t*)out);
  else
    or_kernel<<<grid_for(k), kThreads, 0, s>>>((const uint8_t*)rows, n, k, (uint8_t*)out);
  return (int)cudaGetLastError();
}

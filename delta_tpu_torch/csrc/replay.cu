// Log replay with tombstones and sums (K5).
//
// Replaces delta_tpu/ops/replay_kernel.py:56 `_replay_kernel` (an XLA jit on
// the TPU): the winner of each path is its row with the largest `seq`;
// alive = winner & is_add; tombstone = winner & ~is_add & deletion_ts >
// min_retention_ts; and three sums: live files (i32), their total size (i64,
// wrapping as JAX's int64 sum does) and retained tombstones (i32).
//
// The TPU version sorts (path_id, seq) with a bitonic sort and marks run
// ends. `seq` is unique (actions_to_arrays refuses collisions) and path ids
// are dense codes 0..num_paths-1, so Hopper needs no sort:
//   kernel A: best[path] = max seq of that path (64-bit atomicMax on a
//             num_paths table filled with INT64_MIN first);
//   kernel B: one thread per row tests seq == best[path], writes alive and
//             tombstone, and the block reduces the three sums (warp
//             shuffles, then one atomicAdd per block; the size sum is an
//             unsigned 64-bit atomicAdd, so it wraps exactly like JAX's).
// Pads (path_id < 0) never win. An id >= num_paths is never written or
// read: it raises a flag, and the wrapper raises.
//
// What bounds it: bytes (4 + 8 read twice, 1 + 8 + 8 once per row, 2 bytes
// written) and the random 8-byte accesses to `best`, which for a million
// paths (8 MB) stay in L2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void best_seq_kernel(const int32_t* __restrict__ path_id,
                                const long long* __restrict__ seq, long long n,
                                long long* __restrict__ best, int num_paths,
                                int* __restrict__ err) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int p = path_id[i];
  if (p < 0) return;
  if (p < num_paths)
    atomicMax(best + p, seq[i]);
  else
    atomicOr(err, 1);
}

__global__ void best_fill_kernel(long long* __restrict__ best, int num_paths) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < num_paths) best[i] = (long long)(-9223372036854775807LL - 1);
}

__global__ void replay_kernel(const int32_t* __restrict__ path_id,
                              const long long* __restrict__ seq,
                              const uint8_t* __restrict__ is_add,
                              const long long* __restrict__ size,
                              const long long* __restrict__ deletion_ts,
                              long long n, const long long* __restrict__ best,
                              int num_paths, long long min_retention_ts,
                              uint8_t* __restrict__ alive,
                              uint8_t* __restrict__ tombstone,
                              unsigned long long* __restrict__ sums) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  unsigned int files = 0, tombs = 0;
  unsigned long long bytes = 0;
  if (i < n) {
    const int p = path_id[i];
    const bool winner = p >= 0 && p < num_paths && seq[i] == best[p];
    const bool add = is_add[i] != 0;
    const bool a = winner && add;
    const bool t = winner && !add && deletion_ts[i] > min_retention_ts;
    alive[i] = a;
    tombstone[i] = t;
    files = a;
    tombs = t;
    bytes = a ? (unsigned long long)size[i] : 0ull;
  }
  for (int off = 16; off > 0; off >>= 1) {
    files += __shfl_down_sync(0xffffffffu, files, off);
    tombs += __shfl_down_sync(0xffffffffu, tombs, off);
    bytes += __shfl_down_sync(0xffffffffu, bytes, off);
  }
  __shared__ unsigned int s_files[kThreads / 32], s_tombs[kThreads / 32];
  __shared__ unsigned long long s_bytes[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_files[warp] = files;
    s_tombs[warp] = tombs;
    s_bytes[warp] = bytes;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long f = 0, t = 0, b = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      f += s_files[w];
      t += s_tombs[w];
      b += s_bytes[w];
    }
    if (f) atomicAdd(sums + 0, f);
    if (b) atomicAdd(sums + 1, b);
    if (t) atomicAdd(sums + 2, t);
  }
}

}  // namespace

// path_id (n,) i32, seq/size/deletion_ts (n,) i64, is_add (n,) u8; best
// (num_paths,) i64 scratch, err (1,) i32 scratch; alive/tombstone (n,) u8;
// sums (3,) u64: live files, their bytes (wrapping), tombstones.
extern "C" int dtt_replay(const int32_t* path_id, const long long* seq,
                          const uint8_t* is_add, const long long* size,
                          const long long* deletion_ts, long long n,
                          long long* best, int num_paths, int* err,
                          long long min_retention_ts, uint8_t* alive,
                          uint8_t* tombstone, unsigned long long* sums,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(err, 0, sizeof(int), s);
  if (e == cudaSuccess) e = cudaMemsetAsync(sums, 0, 3 * sizeof(unsigned long long), s);
  if (e != cudaSuccess) return (int)e;
  if (num_paths > 0)
    best_fill_kernel<<<(unsigned)((num_paths + kThreads - 1) / kThreads), kThreads, 0,
                       s>>>(best, num_paths);
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
    best_seq_kernel<<<blocks, kThreads, 0, s>>>(path_id, seq, n, best, num_paths, err);
    replay_kernel<<<blocks, kThreads, 0, s>>>(path_id, seq, is_add, size, deletion_ts,
                                              n, best, num_paths, min_retention_ts,
                                              alive, tombstone, sums);
  }
  return (int)cudaGetLastError();
}

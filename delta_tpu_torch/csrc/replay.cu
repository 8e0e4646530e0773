// Log replay with tombstones and sums: K5 and the sharded replay K6, one body.
//
// Replaces delta_tpu/ops/replay_kernel.py:56 `_replay_kernel` (K5, an XLA jit
// on the TPU) and :206 `replay_sharded` (K6, a shard_map of it over the TPU
// mesh with a `psum` of the sums). The winner of each path is its row with
// the largest `seq`; alive = winner & is_add; tombstone = winner & ~is_add &
// deletion_ts > min_retention_ts; and three sums: live files (i32), their
// total size (i64, wrapping as JAX's int64 sum does) and retained tombstones
// (i32). Pads (path_id < 0) never win. An id >= num_paths is never written
// or read: it is counted, and the wrapper raises.
//
// The TPU version sorts (path_id, seq) with a bitonic sort and marks run
// ends. `seq` is unique (actions_to_arrays refuses collisions) and path ids
// are dense codes 0..num_paths-1, so Hopper needs no sort: a table `best` of
// each path's largest seq, then one test a row.
//
// One entry point, dtt_replay_shards, runs all the shards of one device in
// one call: a by-value table (`Shards`, at most 64 slabs: five column
// pointers, the row count and the slab's first row in the mask buffer) and
// ONE `best` table, which all the device's shards share:
//   memset: the sums row (4 words) and `best` (num_paths words), one
//           cudaMemsetAsync. A slot holds the best seq XOR the sign bit,
//           so a zeroed slot is empty and INT64_MIN keeps its order;
//   pass A: best[path] = max over its rows, an unsigned 64-bit atomicMax a
//           row (its result unused: the thread does not wait on it);
//   pass B: the winner test, the masks and the sums. The sums row
//           receives all the device's shards' live files, their bytes
//           (wrapping u64), their tombstones and, in a fourth word, their
//           rows with an id >= num_paths: the device's reduction is done
//           in this launch.
// Both passes are one grid over all the shards, blockIdx.y the shard, and a
// CTA walks its shard's rows grid-stride (a few CTAs an SM in all), four
// rows a thread a step, a warp's width apart: each load and store of a warp
// is 32 consecutive rows (one 128-byte line of path_id, 256 bytes of seq),
// and where neighbouring rows have neighbouring paths (a log's first adds)
// a warp's atomics and gathers fall in a few sectors of `best`. A CTA adds
// its sums to the row once: four 8-byte atomics a CTA.
//
// Sharing `best` is sound only because the caller gives every path to one
// shard: replay_kernel._bucket_by_path puts all the actions of a path on the
// shard `_mix64(path_id) % n_shards`. A caller that puts one path on two
// shards of one device gets ONE winner for both (the later seq), not one a
// shard. The sums row is the TPU kernel's psum where one device holds
// every shard; across devices the combine kernel (shard_combine.cu) adds
// the devices' rows on the lead device. K5 (dtt_replay) is this body with
// one shard.
//
// What bounds it: bytes (path_id and seq read twice, is_add, size and
// deletion_ts once, 2 bytes of masks written a row) and the random 8-byte
// accesses to `best`, which for a million paths (8 MB) stay in L2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;  // rows a thread a step
constexpr int kMaxShards = 64;
constexpr int kWords = 4;  // a shard's sums row: files, bytes, tombstones, bad ids
constexpr unsigned long long kSign = 0x8000000000000000ull;

struct Shards {
  const int32_t* path_id[kMaxShards];
  const long long* seq[kMaxShards];
  const uint8_t* is_add[kMaxShards];
  const long long* size[kMaxShards];
  const long long* deletion_ts[kMaxShards];
  long long n[kMaxShards];
  long long out_off[kMaxShards];  // the slab's first row in alive / tombstone
};

__device__ __forceinline__ unsigned long long enc(long long s) {
  return (unsigned long long)s ^ kSign;
}

// pass A: a warp takes 32 consecutive rows an instruction, so that where
// the paths of neighbouring rows are neighbours (a log's first adds) its
// atomics fall in few sectors; a thread's four rows are loaded before any
// of its atomics
__global__ void __launch_bounds__(kThreads)
best_kernel(const __grid_constant__ Shards sh, unsigned long long* __restrict__ best,
            int num_paths) {
  const int s = blockIdx.y;
  const long long n = sh.n[s];
  const int32_t* pid = sh.path_id[s];
  const long long* seq = sh.seq[s];
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += kRows * stride) {
    int p[kRows];
    long long q[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long long j = i + r * stride;
      p[r] = j < n ? __ldg(pid + j) : -1;
      q[r] = j < n ? __ldg(seq + j) : 0;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (p[r] >= 0 && p[r] < num_paths) atomicMax(best + p[r], enc(q[r]));
  }
}

// pass B: the same rows as pass A; a row's size and deletion time are read
// only where it wins
__global__ void __launch_bounds__(kThreads)
mask_kernel(const __grid_constant__ Shards sh, const unsigned long long* __restrict__ best,
            int num_paths, long long min_retention_ts, uint8_t* __restrict__ alive,
            uint8_t* __restrict__ tombstone, unsigned long long* __restrict__ sums) {
  const int s = blockIdx.y;
  const long long n = sh.n[s];
  const int32_t* pid = sh.path_id[s];
  const long long* seq = sh.seq[s];
  const uint8_t* is_add = sh.is_add[s];
  const long long* size = sh.size[s];
  const long long* deletion_ts = sh.deletion_ts[s];
  alive += sh.out_off[s];
  tombstone += sh.out_off[s];
  unsigned files = 0, tombs = 0, bad = 0;
  unsigned long long bytes = 0;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += kRows * stride) {
    int p[kRows];
    long long q[kRows];
    bool add[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long long j = i + r * stride;
      p[r] = j < n ? __ldg(pid + j) : -1;
      q[r] = j < n ? __ldg(seq + j) : 0;
      add[r] = j < n && __ldg(is_add + j);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long long j = i + r * stride;
      if (j >= n) break;
      bad += p[r] >= num_paths;
      const bool win = p[r] >= 0 && p[r] < num_paths && enc(q[r]) == __ldg(best + p[r]);
      const bool a = win && add[r];
      const bool t = win && !add[r] && __ldg(deletion_ts + j) > min_retention_ts;
      alive[j] = a;
      tombstone[j] = t;
      if (a) ++files, bytes += (unsigned long long)__ldg(size + j);
      tombs += t;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    files += __shfl_down_sync(0xffffffffu, files, off);
    tombs += __shfl_down_sync(0xffffffffu, tombs, off);
    bad += __shfl_down_sync(0xffffffffu, bad, off);
    bytes += __shfl_down_sync(0xffffffffu, bytes, off);
  }
  __shared__ unsigned long long s_sum[kThreads / 32][kWords];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_sum[warp][0] = files;
    s_sum[warp][1] = bytes;
    s_sum[warp][2] = tombs;
    s_sum[warp][3] = bad;
  }
  __syncthreads();
  if (threadIdx.x < kWords) {
    unsigned long long v = 0;
    for (int w = 0; w < kThreads / 32; ++w) v += s_sum[w][threadIdx.x];
    if (v) atomicAdd(sums + threadIdx.x, v);
  }
}

// CTAs a shard: enough for the largest slab, at most what fills the card
// (the occupancy of the heavier kernel) shared among the shards
int grid_x(long long max_rows, int n_shards) {
  static int per_sm[64], sms[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 1;
  int fill = 0, ctas = 0;
  if (dev < 64 && sms[dev]) {
    fill = sms[dev] * per_sm[dev];
  } else {
    int count = 0;
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, mask_kernel, kThreads, 0);
    ctas = ctas > 0 ? ctas : 1;
    fill = count * ctas;
    if (dev < 64) per_sm[dev] = ctas, sms[dev] = count;
  }
  const long long step = (long long)kThreads * kRows;  // rows a CTA a step
  const long long want = (max_rows + step - 1) / step;
  long long cap = fill / n_shards;
  if (cap < 1) cap = 1;
  return (int)(want < cap ? want : cap);
}

// alive / tombstone are rows 0 and 1 of one (2, total) u8 buffer; scratch
// is the sums row (4 words) and then `best` (num_paths words)
int run(const Shards& sh, int n_shards, int num_paths, long long min_retention_ts,
        unsigned long long* scratch, uint8_t* masks, long long total, cudaStream_t st) {
  long long max_rows = 0;
  for (int s = 0; s < n_shards; ++s) max_rows = sh.n[s] > max_rows ? sh.n[s] : max_rows;
  cudaError_t e = cudaMemsetAsync(
      scratch, 0, ((long long)kWords + num_paths) * sizeof(unsigned long long), st);
  if (e != cudaSuccess) return (int)e;
  if (max_rows > 0) {
    unsigned long long* best = scratch + kWords;
    const dim3 grid(grid_x(max_rows, n_shards), n_shards);
    best_kernel<<<grid, kThreads, 0, st>>>(sh, best, num_paths);
    mask_kernel<<<grid, kThreads, 0, st>>>(sh, best, num_paths, min_retention_ts, masks,
                                           masks + total, scratch);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// K6 on one device: n_shards (1..64) slabs, cols[5 s + c] the pointer of
// column c (path_id i32, seq i64, is_add u8, size i64, deletion_ts i64) of
// slab s, rows[s] its rows (below 2^31). Ids are global, below num_paths,
// and every path lies on one slab of the device. scratch (4 + num_paths,)
// int64: its first 4 words come back as the slabs' sums. masks (2, total)
// u8: slab s's alive and tombstone bytes at rows 0 and 1, from column
// off(s) = the sum of the earlier slabs' rows; total must be the sum of all
// the slabs' rows.
extern "C" int dtt_replay_shards(const void* const* cols, const long long* rows, int n_shards,
                                 int num_paths, long long min_retention_ts, long long* scratch,
                                 uint8_t* masks, long long total, void* stream) {
  if (n_shards < 1 || n_shards > kMaxShards || num_paths < 0) return (int)cudaErrorInvalidValue;
  Shards sh{};
  long long off = 0;
  for (int s = 0; s < n_shards; ++s) {
    if (rows[s] < 0 || rows[s] >= (1ll << 31)) return (int)cudaErrorInvalidValue;
    sh.path_id[s] = (const int32_t*)cols[5 * s];
    sh.seq[s] = (const long long*)cols[5 * s + 1];
    sh.is_add[s] = (const uint8_t*)cols[5 * s + 2];
    sh.size[s] = (const long long*)cols[5 * s + 3];
    sh.deletion_ts[s] = (const long long*)cols[5 * s + 4];
    sh.n[s] = rows[s];
    sh.out_off[s] = off;
    off += rows[s];
  }
  if (off != total) return (int)cudaErrorInvalidValue;
  return run(sh, n_shards, num_paths, min_retention_ts, (unsigned long long*)scratch, masks,
             total, (cudaStream_t)stream);
}

// K5: dtt_replay_shards with one slab of n rows; scratch (4 + num_paths,)
// int64, its first 4 words the sums row; masks (2, total) u8, total = n.
extern "C" int dtt_replay(const int32_t* path_id, const long long* seq, const uint8_t* is_add,
                          const long long* size, const long long* deletion_ts, long long n,
                          int num_paths, long long min_retention_ts, long long* scratch,
                          uint8_t* masks, long long total, void* stream) {
  const void* cols[5] = {path_id, seq, is_add, size, deletion_ts};
  return dtt_replay_shards(cols, &n, 1, num_paths, min_retention_ts, scratch, masks, total,
                           stream);
}

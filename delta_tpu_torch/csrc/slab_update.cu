// Slab updates (K11): the updates of the MERGE key slab.
//
// Replace delta_tpu/ops/key_cache.py:379 `_update_kernels`, six XLA jits
// on the TPU:
//   kill / revive  `v.at[r].set(False|True, mode="drop")`
//   append         `k.at[r].set(nk), v.at[r].set(nv)`
//   widen          `k.astype(int64)`                       -> dtt_slab_widen
//   map_rows       `where(r < cap, inv[r], cap)`
//   slice_append   `dynamic_update_slice(k, nk, start)`
// which the JAX package's tail advance calls up to three times in a row
// (scatter, kill, revive), each time with a map_rows and a second flip of
// the sorted view's validity when that view is live.
//
// Design: ONE launch applies a whole slab advance (dtt_slab_advance). The
// host resolves the advance to distinct rows with their final validity, so
// the kernel keeps no order between its parts, and one thread writes each
// element, over three parts of one index space:
//   * the slice: a rows from `start`, their keys (int32 or int64 as
//     shipped, cast up) and validity bytes;
//   * the row list: d rows, each with its validity byte (or one `value` for
//     all), and with its key when the list carries keys;
//   * the runs: nr ranges (start, count) of rows with one validity byte
//     each: a removed file's rows, with no index uploaded.
// Where the sorted view stays live (no key changes: the caller passes no
// sorted lane with a slice or keyed rows), the same thread also writes the
// row's validity at its sorted position, sorted_valid[inv[r]]: map_rows is
// folded in and no second pass reads the lane. A row of the list follows
// XLA's drop mode: a negative index counts from the end, an index still
// outside [0, cap) is dropped (the callers pad with cap).
//
// In place, or into new lanes: each written lane comes with its source;
// when the source is another tensor (a probe in flight holds the old one,
// or a single update keeps the JAX contract of binding a new array), that
// lane is copied first, once (cudaMemcpyAsync), and then written. The key
// slab writes in place unless a probe holds the lane (ops/key_cache.py).
//
// kill, revive, append, map_rows and slice_append run this kernel with one
// part: a list with one value, a keyed list, a list that only writes
// map_rows' output (`mapped[k] = inv[r]`, cap for a dropped row), a slice.
//
// What bounds it: bytes. In place, the rows an advance touches (an index,
// a key, a validity byte, the mirror's inv entry and sorted byte a row): a
// few KB to a few MB, so the launch itself is the floor. Into new lanes,
// the copies (cap bytes a validity lane, 8 cap for keys) dominate.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Advance {
  int64_t* keys;              // (cap,), or null when no key is written
  uint8_t* valid;             // (cap,), or null: the list writes `mapped` only
  uint8_t* sorted_valid;      // (cap,) the sorted view's mirror, or null
  const int32_t* inv;         // (cap,) inv_perm, for the mirror and `mapped`
  int32_t* mapped;            // (d,) map_rows' output, or null
  const int32_t* rows;        // (d,)
  const uint8_t* rows_valid;  // (d,), or null: `value` for every row
  const void* rows_keys;      // (d,), or null
  const void* slice_keys;     // (a,)
  const uint8_t* slice_valid; // (a,)
  const long long* run_start; // (nr,)
  const long long* run_pre;   // (nr + 1,) exclusive prefix of the runs' counts
  const uint8_t* run_valid;   // (nr,)
  long long cap, d, a, start, run_rows;
  int nr, keys_i32;
  uint8_t value;
};

__device__ __forceinline__ int64_t load_key(const void* k, int is_i32, long long j) {
  return is_i32 ? (int64_t)((const int32_t*)k)[j] : ((const int64_t*)k)[j];
}

__global__ void __launch_bounds__(kThreads) advance_kernel(const __grid_constant__ Advance t) {
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < t.a) {
    const long long r = t.start + i;
    t.keys[r] = load_key(t.slice_keys, t.keys_i32, i);
    t.valid[r] = t.slice_valid[i];
    return;
  }
  i -= t.a;
  if (i < t.d) {
    long long r = t.rows[i];
    if (r < 0) r += t.cap;
    const bool in = r >= 0 && r < t.cap;
    if (t.mapped) t.mapped[i] = in ? t.inv[r] : (int32_t)t.cap;
    if (!in || !t.valid) return;
    const uint8_t v = t.rows_valid ? t.rows_valid[i] : t.value;
    if (t.rows_keys) t.keys[r] = load_key(t.rows_keys, t.keys_i32, i);
    t.valid[r] = v;
    if (t.sorted_valid) t.sorted_valid[t.inv[r]] = v;
    return;
  }
  i -= t.d;
  if (i >= t.run_rows) return;
  int lo = 0, hi = t.nr - 1;  // the run holding element i
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.run_pre[mid] <= i) lo = mid;
    else hi = mid - 1;
  }
  const long long r = t.run_start[lo] + (i - t.run_pre[lo]);
  if (r < 0 || r >= t.cap) return;
  const uint8_t v = t.run_valid[lo];
  t.valid[r] = v;
  if (t.sorted_valid) t.sorted_valid[t.inv[r]] = v;
}

__global__ void widen_kernel(const int32_t* __restrict__ in, int64_t* __restrict__ out,
                             long long cap) {
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < cap;
       i += (long long)gridDim.x * kThreads)
    out[i] = (int64_t)in[i];
}

unsigned blocks(long long work) {
  const long long g = (work + kThreads - 1) / kThreads;
  return (unsigned)(g < 1 ? 1 : (g > 132 * 16 ? 132 * 16 : g));
}

// dst <- src when they differ: a lane written into a new tensor
cudaError_t copy_lane(void* dst, const void* src, long long bytes, cudaStream_t s) {
  if (!src || src == dst || bytes == 0) return cudaSuccess;
  return cudaMemcpyAsync(dst, src, bytes, cudaMemcpyDeviceToDevice, s);
}

}  // namespace

// One slab advance. keys (cap,) i64, valid / sorted_valid (cap,) u8, inv
// (cap,) i32; each written lane with its source (null, or the lane itself:
// in place; another tensor: copied into the lane first). The parts: rows
// (d,) i32 with rows_valid (d,) u8 (null: `value`) and rows_keys (d,) (or
// null); the slice of a rows at `start` (clamped to [0, cap - a], as
// dynamic_update_slice) with slice_keys (a,) and slice_valid (a,) u8; the
// runs: run_start (nr,) i64, run_pre (nr + 1,) i64 (the exclusive prefix of
// their counts, run_pre[nr] = run_rows) and run_valid (nr,) u8. Keys are
// int32 (keys_i32) or int64. mapped (d,) i32, or null. The rows of the three
// parts are distinct.
extern "C" int dtt_slab_advance(int64_t* keys, const int64_t* keys_src, uint8_t* valid,
                                const uint8_t* valid_src, uint8_t* sorted_valid,
                                const uint8_t* sorted_src, const int32_t* inv, int32_t* mapped,
                                long long cap, const int32_t* rows, const uint8_t* rows_valid,
                                const void* rows_keys, long long d, int value, long long start,
                                const void* slice_keys, const uint8_t* slice_valid, long long a,
                                const long long* runs, const uint8_t* run_valid, int nr,
                                long long run_rows, int keys_i32, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (cap <= 0 || d < 0 || a < 0 || a > cap || nr < 0 || run_rows < 0 ||
      (nr == 0) != (run_rows == 0))
    return (int)cudaErrorInvalidValue;
  const bool keyed = a > 0 || rows_keys;
  if ((keyed && !keys) || (!valid && (a > 0 || nr > 0 || sorted_valid)) ||
      ((sorted_valid || mapped) && !inv) || (sorted_valid && keyed))
    return (int)cudaErrorInvalidValue;
  // dynamic_update_slice clamps the start so the whole slice fits
  if (start > cap - a) start = cap - a;
  if (start < 0) start = 0;
  cudaError_t err = keyed ? copy_lane(keys, keys_src, cap * (long long)sizeof(int64_t), s)
                          : cudaSuccess;
  if (err == cudaSuccess && valid) err = copy_lane(valid, valid_src, cap, s);
  if (err == cudaSuccess && sorted_valid) err = copy_lane(sorted_valid, sorted_src, cap, s);
  if (err != cudaSuccess) return (int)err;
  const long long total = a + d + run_rows;
  if (total == 0) return (int)cudaGetLastError();
  Advance t{};
  t.keys = keys;
  t.valid = valid;
  t.sorted_valid = sorted_valid;
  t.inv = inv;
  t.mapped = mapped;
  t.rows = rows;
  t.rows_valid = rows_valid;
  t.rows_keys = rows_keys;
  t.slice_keys = slice_keys;
  t.slice_valid = slice_valid;
  t.run_start = runs;
  t.run_pre = runs ? runs + nr : nullptr;
  t.run_valid = run_valid;
  t.cap = cap;
  t.d = d;
  t.a = a;
  t.start = start;
  t.run_rows = run_rows;
  t.nr = nr;
  t.keys_i32 = keys_i32;
  t.value = (uint8_t)(value != 0);
  advance_kernel<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, s>>>(t);
  return (int)cudaGetLastError();
}

extern "C" int dtt_slab_widen(const int32_t* in, int64_t* out, long long cap, void* stream) {
  if (cap > 0) widen_kernel<<<blocks(cap), kThreads, 0, (cudaStream_t)stream>>>(in, out, cap);
  return (int)cudaGetLastError();
}

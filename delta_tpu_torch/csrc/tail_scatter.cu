// Tail scatters (K2, K3): apply a commit tail to the resident scan lanes.
//
// Replace delta_tpu/ops/state_cache.py:959 `_scatter_bool_fn`
// (`a.at[r].set(value, mode="drop")`) and :970 `_scatter_cols_fn`
// (`a.at[:, r].set(v, mode="drop")`), XLA jits on the TPU, which the JAX
// package's tail apply calls four times in a row: the dead rows' alive bits
// False, the added rows' alive bits True, then the added rows' min and max
// columns.
//
// Index semantics are XLA's: a negative index counts from the end (r + cap),
// and an index still outside [0, cap) is dropped, never written. The callers
// pad the dead rows to a power of two with `cap`, which is dropped.
//
// Unlike the JAX version, which binds a new array, these update the resident
// lanes IN PLACE: the lanes are the state cache's, and a tail of a few
// thousand rows must not copy 35 MB of lanes.
//
// Design: at a tail's size (512 dead rows, 1,024 added, 4 columns) the device
// work is a few microseconds and the launch is the cost, so ONE launch
// applies a whole tail (dtt_tail_apply): one thread a written element, over
// the dead rows, then the added rows' alive bits, then their min and max
// columns. The added rows are a range (start, k): no index vector is
// uploaded, and the dead rows, the mins and the maxs arrive in one buffer.
// A dead row inside the added range ends True, as the sequential calls
// leave it: its dead-row thread does not write, so no two threads race for
// a byte. dtt_scatter_bool and dtt_scatter_cols are the same kernel with the
// other parts empty (the added rows then an index vector).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Tail {
  uint8_t* alive;         // (cap,)
  float* lanes[2];        // mins, maxs: (C, cap), or null
  const float* vals[2];   // lo, hi: (C, k), or null
  const int32_t* dead;    // (nd,)
  const int32_t* rows;    // (k,) the added rows, or null: the range [start, start + k)
  long long cap, start;
  int C, nd, k;
  uint8_t dead_value;
  bool add_alive;         // the added rows' alive bits become 1
};

__device__ __forceinline__ long long xla_index(long long r, long long cap) {
  return r < 0 ? r + cap : r;
}

// the added row j, XLA-wrapped (outside [0, cap): dropped)
__device__ __forceinline__ long long added(const Tail& t, long long j) {
  return xla_index(t.rows ? (long long)t.rows[j] : t.start + j, t.cap);
}

// whether row r (in [0, cap)) is one of the added range's rows after the wrap
__device__ __forceinline__ bool in_range(const Tail& t, long long r) {
  const long long a = r - t.start, b = r - t.cap - t.start;
  return (a >= 0 && a < t.k) || (b >= 0 && b < t.k);
}

__global__ void __launch_bounds__(kThreads) tail_kernel(const __grid_constant__ Tail t) {
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < t.nd) {
    const long long r = xla_index(t.dead[i], t.cap);
    if (r >= 0 && r < t.cap && !(t.add_alive && in_range(t, r))) t.alive[r] = t.dead_value;
    return;
  }
  i -= t.nd;
  if (i < t.k) {
    const long long r = added(t, i);
    if (t.add_alive && r >= 0 && r < t.cap) t.alive[r] = 1;
    return;
  }
  i -= t.k;
  const long long per = (long long)t.C * t.k;
  if (i >= 2 * per) return;
  const int side = i >= per;
  const long long e = i - side * per;
  if (!t.vals[side]) return;
  const long long c = e / t.k, j = e % t.k;
  const long long r = added(t, j);
  if (r >= 0 && r < t.cap) t.lanes[side][c * t.cap + r] = t.vals[side][e];
}

int launch(const Tail& t, cudaStream_t st) {
  const long long total = (long long)t.nd + t.k + 2ll * t.C * t.k;
  if (total > 0)
    tail_kernel<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, st>>>(t);
  return (int)cudaGetLastError();
}

}  // namespace

// One commit tail: alive (cap,) u8, mins and maxs (C, cap) f32; dead (nd,)
// i32 set False unless inside the added range; the added range [start,
// start + k) set True in alive and to lo, hi (C, k) f32 in mins, maxs.
extern "C" int dtt_tail_apply(uint8_t* alive, float* mins, float* maxs, int C, long long cap,
                              const int32_t* dead, int nd, long long start, int k,
                              const float* lo, const float* hi, void* stream) {
  if (C < 0 || nd < 0 || k < 0 || !alive || (C > 0 && k > 0 && !(mins && maxs && lo && hi)))
    return (int)cudaErrorInvalidValue;
  Tail t{};
  t.alive = alive;
  t.lanes[0] = mins, t.lanes[1] = maxs;
  t.vals[0] = lo, t.vals[1] = hi;
  t.dead = dead, t.nd = nd;
  t.cap = cap, t.start = start, t.C = C, t.k = k;
  t.dead_value = 0;
  t.add_alive = true;
  return launch(t, (cudaStream_t)stream);
}

// K2 alone: a (cap,) u8, rows (n,) i32 set to value
extern "C" int dtt_scatter_bool(uint8_t* a, const int32_t* rows, int n, uint8_t value,
                                long long cap, void* stream) {
  Tail t{};
  t.alive = a;
  t.dead = rows, t.nd = n;
  t.cap = cap;
  t.dead_value = value;
  return launch(t, (cudaStream_t)stream);
}

// K3 alone: a (C, cap) f32, rows (n,) i32, v (C, n) f32
extern "C" int dtt_scatter_cols(float* a, const int32_t* rows, const float* v, int C, int n,
                                long long cap, void* stream) {
  Tail t{};
  t.lanes[0] = a;
  t.vals[0] = v;
  t.rows = rows, t.k = n;
  t.cap = cap, t.C = C;
  return launch(t, (cudaStream_t)stream);
}

// Slab updates (K11): the six small updates of the MERGE key slab.
//
// Replace delta_tpu/ops/key_cache.py:379 `_update_kernels`, six XLA jits
// on the TPU:
//   kill / revive  `v.at[r].set(False|True, mode="drop")`  -> dtt_slab_flip
//   append         `k.at[r].set(nk), v.at[r].set(nv)`       -> dtt_slab_append
//   widen          `k.astype(int64)`                       -> dtt_slab_widen
//   map_rows       `where(r < cap, inv[r], cap)`           -> dtt_slab_map_rows
//   slice_append   `dynamic_update_slice(k, nk, start)`    -> dtt_slab_slice_append
//
// Scatter indices follow XLA: a negative index counts from the end, and an
// index still outside [0, cap) is dropped. Rows within one call are
// distinct. `dynamic_update_slice` clamps its start so the slice fits.
//
// JAX arrays are immutable: a probe in flight keeps the lanes it pinned
// while an advance binds new ones. So every update here writes a NEW lane
// (`out`): the old lane is copied (cudaMemcpyAsync), then the rows are
// written. map_rows and widen write fresh outputs anyway.
//
// What bounds them: bytes — the lane copy (cap bytes, or 8 cap for keys)
// dominates the rows written at advance sizes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ long long xla_index(int r, long long cap) {
  const long long i = r;
  return i < 0 ? i + cap : i;
}

__device__ __forceinline__ int64_t load_key(const void* nk, int is_i32, long long j) {
  return is_i32 ? (int64_t)((const int32_t*)nk)[j] : ((const int64_t*)nk)[j];
}

__global__ void flip_kernel(uint8_t* __restrict__ out, long long cap,
                            const int32_t* __restrict__ rows, long long d, uint8_t value) {
  const long long k = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (k >= d) return;
  const long long r = xla_index(rows[k], cap);
  if (r >= 0 && r < cap) out[r] = value;
}

__global__ void append_kernel(int64_t* __restrict__ keys, uint8_t* __restrict__ valid,
                              long long cap, const int32_t* __restrict__ rows,
                              const void* __restrict__ nk, int nk_is_i32,
                              const uint8_t* __restrict__ nv, long long a) {
  const long long k = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (k >= a) return;
  const long long r = xla_index(rows[k], cap);
  if (r >= 0 && r < cap) {
    keys[r] = load_key(nk, nk_is_i32, k);
    valid[r] = nv[k];
  }
}

__global__ void widen_kernel(const int32_t* __restrict__ in, int64_t* __restrict__ out,
                             long long cap) {
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < cap;
       i += (long long)gridDim.x * kThreads)
    out[i] = (int64_t)in[i];
}

__global__ void map_rows_kernel(const int32_t* __restrict__ inv, long long cap,
                                const int32_t* __restrict__ rows, int32_t* __restrict__ out,
                                long long d) {
  const long long k = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (k >= d) return;
  const long long r = rows[k];
  out[k] = (r >= 0 && r < cap) ? inv[r] : (int32_t)cap;
}

__global__ void slice_kernel(int64_t* __restrict__ keys, uint8_t* __restrict__ valid,
                             long long start, const void* __restrict__ nk, int nk_is_i32,
                             const uint8_t* __restrict__ nv, long long a) {
  const long long k = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (k >= a) return;
  keys[start + k] = load_key(nk, nk_is_i32, k);
  valid[start + k] = nv[k];
}

unsigned blocks(long long work) {
  const long long g = (work + kThreads - 1) / kThreads;
  return (unsigned)(g < 1 ? 1 : (g > 132 * 16 ? 132 * 16 : g));
}

unsigned blocks_all(long long work) {  // one thread per element, no grid stride
  const long long g = (work + kThreads - 1) / kThreads;
  return (unsigned)(g < 1 ? 1 : g);
}

}  // namespace

// kill (value 0) / revive (value 1): out = in with rows set; in, out (cap,) u8
extern "C" int dtt_slab_flip(const uint8_t* in, uint8_t* out, long long cap,
                             const int32_t* rows, long long d, uint8_t value, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemcpyAsync(out, in, cap, cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return (int)err;
  if (d > 0) flip_kernel<<<blocks_all(d), kThreads, 0, s>>>(out, cap, rows, d, value);
  return (int)cudaGetLastError();
}

// keys (cap,) i64, valid (cap,) u8 -> keys_out, valid_out; rows (a,) i32,
// nk (a,) i32 or i64, nv (a,) u8
extern "C" int dtt_slab_append(const int64_t* keys, const uint8_t* valid, int64_t* keys_out,
                               uint8_t* valid_out, long long cap, const int32_t* rows,
                               const void* nk, int nk_is_i32, const uint8_t* nv, long long a,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemcpyAsync(keys_out, keys, cap * sizeof(int64_t),
                                    cudaMemcpyDeviceToDevice, s);
  if (err == cudaSuccess) err = cudaMemcpyAsync(valid_out, valid, cap, cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return (int)err;
  if (a > 0)
    append_kernel<<<blocks_all(a), kThreads, 0, s>>>(keys_out, valid_out, cap, rows, nk,
                                                     nk_is_i32, nv, a);
  return (int)cudaGetLastError();
}

extern "C" int dtt_slab_widen(const int32_t* in, int64_t* out, long long cap, void* stream) {
  if (cap > 0) widen_kernel<<<blocks(cap), kThreads, 0, (cudaStream_t)stream>>>(in, out, cap);
  return (int)cudaGetLastError();
}

extern "C" int dtt_slab_map_rows(const int32_t* inv, long long cap, const int32_t* rows,
                                 int32_t* out, long long d, void* stream) {
  if (d > 0)
    map_rows_kernel<<<blocks_all(d), kThreads, 0, (cudaStream_t)stream>>>(inv, cap, rows, out,
                                                                          d);
  return (int)cudaGetLastError();
}

extern "C" int dtt_slab_slice_append(const int64_t* keys, const uint8_t* valid,
                                     int64_t* keys_out, uint8_t* valid_out, long long cap,
                                     long long start, const void* nk, int nk_is_i32,
                                     const uint8_t* nv, long long a, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (a > cap) return (int)cudaErrorInvalidValue;
  // dynamic_update_slice clamps the start so the whole slice fits
  if (start > cap - a) start = cap - a;
  if (start < 0) start = 0;
  cudaError_t err = cudaMemcpyAsync(keys_out, keys, cap * sizeof(int64_t),
                                    cudaMemcpyDeviceToDevice, s);
  if (err == cudaSuccess) err = cudaMemcpyAsync(valid_out, valid, cap, cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return (int)err;
  if (a > 0)
    slice_kernel<<<blocks_all(a), kThreads, 0, s>>>(keys_out, valid_out, start, nk, nk_is_i32,
                                                    nv, a);
  return (int)cudaGetLastError();
}

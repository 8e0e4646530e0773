// Cross-shard combine: the arithmetic of the TPU kernels' `psum`.
//
// Replaces the `jax.lax.psum` reductions inside the shard_map kernels of
// delta_tpu/ops/replay_kernel.py:206 (the sums of the sharded replay,
// :229-231) and delta_tpu/ops/join_kernel.py:150 (the source hits and the
// multi flag of the sharded join probe, :169-170). On the TPU, XLA runs the
// reduction over ICI; here the shards' partial results are first copied to
// the lead device (communication, parallel/mesh.all_gather) as (n, k) rows,
// and one launch of this kernel reduces one or two such row sets there:
//   op 0 (sum): out (k,) int64 = the sum of the n rows (wrapping, as JAX's
//               int64 psum);
//   op 1 (or):  out (k,) u8 = the bytewise OR of the n rows. K13's devices
//               hand it their packed source hits and their 0/1 multi bytes:
//               the OR of packed bytes is the packing of the OR, so this is
//               JAX's packbits(psum(min(hits, 1))) and its psum of the flag.
// Where one device holds every shard the producers reduce in their own
// launches (K6's one sums row, K13's packed hits), and this kernel runs only
// across distinct devices and for multichip's step count.
//
// What bounds it: bytes (n * k elements read once, k written), and for the
// path's small sets the launch itself. So one launch takes both of K13's
// sets, described in the launch's parameters (rows, out, k, n, op), one row
// of CTAs a set (blockIdx.y, so a thread reads its descriptor at a
// block-uniform index), as many as the set's chunks need up to 8 an SM,
// walking them grid-stride. A thread owns one chunk: 16 consecutive bytes of
// each row (two int64 of a sum, sixteen bytes of an or, one 16-byte load a
// row), and walks the n rows down it, starting the loads of 8 rows before it
// reduces any, so a warp has 512 contiguous bytes of each of 8 rows in
// flight. A chunk past the end of a row (a row of a length not a multiple of
// 16 bytes), or a set whose rows do not all start on a 16-byte boundary,
// takes the scalar path: one element a load, the same output.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSets = 2;
constexpr int kBatch = 8;  // rows whose loads a thread starts before it reduces any
constexpr int kVec = 16;   // bytes of a row a thread: one 16-byte load a row
constexpr int kCtasAnSm = 8;
constexpr int kSum = 0, kOr = 1;

struct Set {
  const char* rows;  // row 0; row i at rows + i * k elements
  char* out;
  long long k;
  int n;
  int op;
  int vec;  // every row 16-byte aligned
};

struct Sets {
  Set s[kMaxSets];
};

template <int Op>
__device__ __forceinline__ void fold(ulonglong2& a, const ulonglong2& v) {
  if (Op == kSum) {
    a.x += v.x, a.y += v.y;
  } else {
    a.x |= v.x, a.y |= v.y;
  }
}

// chunk t of every row (bytes [16t, 16t + 16)), kBatch rows' loads in flight
template <int Op>
__device__ __forceinline__ ulonglong2 vec_chunk(const char* __restrict__ rows, long long pitch,
                                                int n, long long t) {
  ulonglong2 a = make_ulonglong2(0ull, 0ull);
  const char* p = rows + (long long)kVec * t;
  for (int i0 = 0; i0 < n; i0 += kBatch) {
    ulonglong2 v[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q)
      if (i0 + q < n) v[q] = __ldg((const ulonglong2*)(p + (long long)(i0 + q) * pitch));
#pragma unroll
    for (int q = 0; q < kBatch; ++q)
      if (i0 + q < n) fold<Op>(a, v[q]);
  }
  return a;
}

// the scalar path: columns [j0, j1) one element a load
template <typename E, int Op>
__device__ __forceinline__ void scalar_cols(const Set& s, long long j0, long long j1) {
  const E* rows = (const E*)s.rows;
#pragma unroll 1
  for (long long j = j0; j < j1; ++j) {
    E a = 0;
#pragma unroll 1
    for (int i = 0; i < s.n; ++i) {
      const E v = rows[(long long)i * s.k + j];
      a = Op == kSum ? (E)(a + v) : (E)(a | v);
    }
    ((E*)s.out)[j] = a;
  }
}

__global__ void __launch_bounds__(kThreads)
combine_kernel(const __grid_constant__ Sets sets) {
  const Set& s = sets.s[blockIdx.y];
  const int esz = s.op == kSum ? 8 : 1;
  const long long bytes = s.k * esz;  // a row's, the pitch too
  const long long chunks = (bytes + kVec - 1) / kVec;
  for (long long t = (long long)blockIdx.x * kThreads + threadIdx.x; t < chunks;
       t += (long long)gridDim.x * kThreads) {
    const long long b0 = t * kVec;
    if (s.vec && b0 + kVec <= bytes) {
      *(ulonglong2*)(s.out + b0) = s.op == kSum ? vec_chunk<kSum>(s.rows, bytes, s.n, t)
                                                : vec_chunk<kOr>(s.rows, bytes, s.n, t);
    } else {
      const long long j0 = b0 / esz, j1 = (b0 + kVec) / esz;
      if (s.op == kSum)
        scalar_cols<unsigned long long, kSum>(s, j0, j1 < s.k ? j1 : s.k);
      else
        scalar_cols<uint8_t, kOr>(s, j0, j1 < s.k ? j1 : s.k);
    }
  }
}

bool aligned(const void* p, int to) { return ((uintptr_t)p & (to - 1)) == 0; }

// CTAs a set at most: kCtasAnSm on each SM of the current device
long long max_ctas() {
  static int ctas[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return kCtasAnSm;
  int c = dev < 64 ? ctas[dev] : 0;
  if (!c) {
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    c = (sms > 0 ? sms : 1) * kCtasAnSm;
    if (dev < 64) ctas[dev] = c;
  }
  return c;
}

}  // namespace

// count (1 or 2) reductions in one launch, described by desc: five int64
// words a reduction, {rows, out, k, n, op}. rows holds n >= 1 contiguous
// rows of k >= 0 elements (int64 for op 0, 8-byte aligned; u8 for op 1),
// row i at rows + i * k elements; out (k,) of the same type, 16-byte
// aligned, on the same device. No launch when every k is 0.
extern "C" int dtt_shard_combine(const long long* desc, int count, void* stream) {
  if (count < 1 || count > kMaxSets) return (int)cudaErrorInvalidValue;
  Sets sets{};
  long long most = 0;  // the largest set's chunks
  for (int i = 0; i < count; ++i) {
    const long long* d = desc + 5 * i;
    const void* rows = (const void*)d[0];
    void* out = (void*)d[1];
    const long long k = d[2], n = d[3], op = d[4];
    const int esz = op == kSum ? 8 : 1;
    if (n < 1 || n > (1ll << 30) || k < 0 || (op != kSum && op != kOr) ||
        !aligned(rows, esz) || !aligned(out, kVec))
      return (int)cudaErrorInvalidValue;
    Set& s = sets.s[i];
    s.rows = (const char*)rows;
    s.out = (char*)out;
    s.k = k;
    s.n = (int)n;
    s.op = (int)op;
    s.vec = aligned(rows, kVec) && (n == 1 || (k * esz) % kVec == 0);
    const long long chunks = (k * esz + kVec - 1) / kVec;
    most = chunks > most ? chunks : most;
  }
  if (most == 0) return (int)cudaGetLastError();
  long long ctas = (most + kThreads - 1) / kThreads;
  const long long cap = max_ctas();
  ctas = ctas < cap ? ctas : cap;
  combine_kernel<<<dim3((unsigned)ctas, count), kThreads, 0, (cudaStream_t)stream>>>(sets);
  return (int)cudaGetLastError();
}

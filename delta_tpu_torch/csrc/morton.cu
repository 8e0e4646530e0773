// Morton interleave (K16): k columns of 16-bit ranks -> one 64-bit Z-order
// key per row, bit b of column c at position b*k + c.
//
// Replaces delta_tpu/ops/zorder.py:34 `morton_order`'s jitted `interleave`
// (:47, 16 x k static rounds of shifts, masks and ORs over uint64 lanes that
// XLA fuses). Here one thread per row reads its k ranks and builds the key
// in a register. A bit whose position b*k + c is 64 or more is dropped, as
// XLA's `uint64 << s` gives 0 for s >= 64 (in C++ such a shift is
// undefined, so it is guarded). The key is written as an int64 bit pattern;
// the host sorts it as unsigned.
//
// What bounds it: bytes. Each row reads k int32 ranks and writes one int64
// key; the 16 k shift-and-OR steps per row are far below the card's rate.
// Consecutive threads read consecutive ranks of each column (the ranks are
// laid out column after column), so every load is coalesced.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBits = 16;

__global__ void morton_kernel(const int32_t* __restrict__ ranks, int k, long long n,
                              long long* __restrict__ key) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  unsigned long long out = 0;
  for (int c = 0; c < k; ++c) {
    const unsigned long long r = (uint32_t)ranks[(long long)c * n + row];
    for (int b = 0; b < kBits; ++b) {
      const int s = b * k + c;
      if (s < 64) out |= ((r >> b) & 1ull) << s;
    }
  }
  key[row] = (long long)out;
}

}  // namespace

// ranks (k, n) int32 row-major, each below 2^16; key (n,) int64.
extern "C" int dtt_morton(const int32_t* ranks, int k, long long n, long long* key,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaGetLastError();
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  morton_kernel<<<blocks, kThreads, 0, s>>>(ranks, k, n, key);
  return (int)cudaGetLastError();
}

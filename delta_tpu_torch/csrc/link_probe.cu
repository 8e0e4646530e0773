// Link-probe warm-up (K17): out[i] = a[i] + 1 over int32.
//
// Replaces delta_tpu/parallel/link.py:315, the `jax.jit(lambda a: a + 1)`
// over 8 int32 that `_probe` runs before it times the host<->device link.
// Its job is the first execution on the card: context creation, module
// load and the first launch are paid here, so the timings after it see the
// steady-state link. `_probe` checks the output against a + 1, so a warm-up
// that fails raises instead of being skipped.
//
// What bounds it: at the probe's 8 elements, the launch; at any length,
// bytes (4 read and 4 written per element, one thread per element,
// coalesced).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void link_probe_kernel(const int32_t* __restrict__ a, long long n,
                                  int32_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = a[i] + 1;
}

}  // namespace

// a, out: (n,) int32 on the card.
extern "C" int dtt_link_probe(const int32_t* a, long long n, int32_t* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaGetLastError();
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  link_probe_kernel<<<blocks, kThreads, 0, s>>>(a, n, out);
  return (int)cudaGetLastError();
}

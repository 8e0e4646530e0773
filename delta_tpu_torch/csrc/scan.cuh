// Scratch carving shared by the radix sort (K8, csrc/radix.cuh) and the pair
// compaction (K10, csrc/pair_compact.cu): each part of a caller's scratch
// buffer starts at a 256-byte boundary, as the Python side sizes it
// (ops/key_cache._aligned).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace dtt_scan {

// Carve `bytes` (rounded up to 256) off a scratch buffer; nullptr when it
// does not fit.
inline void* carve(char*& cur, char* end, long long bytes) {
  const long long step = (bytes + 255) / 256 * 256;
  if (cur + step > end) return nullptr;
  void* p = cur;
  cur += step;
  return p;
}

}  // namespace dtt_scan

// The stable LSD radix sort shared by the slab sort (K8, slab_sort.cu) and
// the upload join's source sort (K12 and K13, join_probe.cu): a one-sweep
// sort (Adinets & Merrill, "Onesweep: A Faster Least Significant Digit Radix
// Sort for GPUs", 2022), narrowed to the bytes that vary.
//
// Keys are uint64 (a signed key with its sign bit flipped, so the unsigned
// order is the signed one), each row carrying a 32-bit tag word: its row
// index, with bit 31 free for the caller (the slab sort keeps the row's
// validity there). A source (`Src`) gives key(i) and tag(i) for the first
// pass; a sink (`Dst`) takes (position, key, row word) from the last.
//
// What bounds it on this card: bytes. An LSD sort must read and write every
// row once a digit pass; the design keeps the passes few and narrow and
// makes each pass one read and one coalesced write:
//   1. `hist_kernel`: ONE read of the keys gives `diff` (the OR of every key
//      XOR the first) and the 256-bucket histogram of every byte (shared
//      counters per CTA, a warp whose lanes share a byte adds once, then
//      global atomics); `offsets_kernel` scans them into each byte's digit
//      offsets. `diff` (8 bytes) is read back to the host, one round trip
//      of the call: it decides which passes run.
//   2. Narrowing: only bytes that vary are passes. When they span at most 4
//      bytes (byte-aligned), a pass moves a uint32 digit word plus the row
//      word, 8 bytes a row; the bits outside the window are the same in
//      every key, so the last pass rebuilds the key exactly from the word
//      and the first key. A wider span moves the whole uint64, 12 bytes.
//   3. One launch a pass (`pass_kernel`): tiles of 4096 rows are claimed in
//      order through an atomic counter; each CTA counts its tile's digits
//      and publishes the counts with a flag first, ranks the tile in shared
//      memory (a warp's equal digits from 8 ballots, per-warp digit counters
//      across the 8 warps), looks back over the earlier tiles' flags for its
//      exclusive prefix (decoupled look-back, 8 flags a round trip), then
//      writes the tile out of shared memory in digit order, so each digit's
//      run goes out contiguous.
//   4. The first pass takes the row index from the position and reads the
//      source itself; the last pass hands each row to the sink, which
//      writes the caller's outputs: no encode or finish trip over the rows.
// Stability holds by construction: LSD passes, in-tile ranks in row order
// (warp, item, lane), tiles in row order through the look-back.
//
// Occupancy (the build log's -Xptxas -v; PERF.md): 256 threads a CTA, 16
// rows a thread, registers capped for three CTAs an SM; shared memory per
// CTA is the 4096-row staging (32 KB for uint32 words, 48 KB for uint64,
// dynamic) plus 11 KB of counters.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan.cuh"

namespace dtt_radix {

constexpr int kRadix = 256;
constexpr int kBytes = 8;
constexpr uint64_t kSign = 0x8000000000000000ull;

constexpr int kHistThreads = 512;
constexpr int kHistItems = 4;       // keys a lane in flight
constexpr int kHistGrid = 132 * 2;  // two CTAs an SM on an H100

constexpr int kThreads = 256;  // == kRadix: thread t owns digit t's counters
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;
constexpr int kWarpRows = 32 * kItems;
constexpr int kTile = kThreads * kItems;
constexpr int kLook = 8;  // look-back flags a thread loads a round trip

// look-back words: the flag in the high half, the count in the low half
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kInclusive = 2ull << 32;

__device__ __forceinline__ void store_flag(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long load_flag(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// Exclusive scan of one value a thread over a CTA of kThreads threads.
__device__ __forceinline__ uint32_t cta_exclusive_scan(uint32_t v, uint32_t* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  uint32_t before = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) before += w < warp ? warp_sums[w] : 0u;
  __syncthreads();  // warp_sums is reused by the next call
  return before + x - v;
}

template <class Src>
__global__ void __launch_bounds__(kHistThreads)
hist_kernel(Src src, long long n, uint32_t* __restrict__ hist,
            unsigned long long* __restrict__ diff) {
  __shared__ uint32_t h[kBytes][kRadix];
  for (int i = threadIdx.x; i < kBytes * kRadix; i += blockDim.x) (&h[0][0])[i] = 0u;
  __syncthreads();
  const uint64_t first = src.key(0);
  const int lane = threadIdx.x & 31;
  unsigned long long local = 0;
  const long long warps = (long long)gridDim.x * (blockDim.x / 32);
  // warp-uniform loop: every lane runs each round, the last one partly dead;
  // kHistItems keys a lane in flight
  for (long long base = ((long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32) *
                        (32 * kHistItems);
       base < n; base += warps * 32 * kHistItems) {
    uint64_t u[kHistItems];
#pragma unroll
    for (int k = 0; k < kHistItems; ++k) {
      const long long i = base + k * 32 + lane;
      u[k] = i < n ? src.key(i) : first;
    }
#pragma unroll
    for (int k = 0; k < kHistItems; ++k) {
      const bool live = base + k * 32 + lane < n;
      const unsigned act = __ballot_sync(0xffffffffu, live);  // lane 0 is live if any is
      local |= u[k] ^ first;
#pragma unroll
      for (int b = 0; b < kBytes; ++b) {
        // a warp whose live lanes share the byte adds once; else one add a
        // lane
        const unsigned d = (unsigned)(u[k] >> (8 * b)) & 0xFFu;
        const unsigned d0 = __shfl_sync(0xffffffffu, d, 0);
        if (__all_sync(0xffffffffu, !live || d == d0)) {
          if (lane == 0 && act) atomicAdd(&h[b][d0], (unsigned)__popc(act));
        } else if (live) {
          atomicAdd(&h[b][d], 1u);
        }
      }
    }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) local |= __shfl_xor_sync(0xffffffffu, local, o);
  if (lane == 0 && local) atomicOr(diff, local);
  __syncthreads();
  for (int i = threadIdx.x; i < kBytes * kRadix; i += blockDim.x) {
    const uint32_t c = (&h[0][0])[i];
    if (c) atomicAdd(hist + i, c);
  }
}

// One CTA of kThreads: offs[b][d] = the rows whose byte b is below d.
__global__ void __launch_bounds__(kThreads)
offsets_kernel(const uint32_t* __restrict__ hist, uint32_t* __restrict__ offs) {
  __shared__ uint32_t warp_sums[kWarps];
  for (int b = 0; b < kBytes; ++b) {
    const uint32_t v = hist[b * kRadix + threadIdx.x];
    offs[b * kRadix + threadIdx.x] = cta_exclusive_scan(v, warp_sums);
  }
}

// One digit pass over n rows. kFirst: the rows come from `src` (word =
// key >> word_shift, row word = index | tag); else from (w_in, r_in). kLast:
// each row goes to `dst` with its rebuilt key; else to (w_out, r_out). goff:
// this digit's 256 offsets; look: tiles x 256 look-back words, zeroed;
// ctr: the tile counter, zeroed.
template <class Src, class Dst, typename W, bool kFirst, bool kLast>
__global__ void __launch_bounds__(kThreads, 3)
pass_kernel(Src src, Dst dst, const W* __restrict__ w_in, const uint32_t* __restrict__ r_in,
            W* __restrict__ w_out, uint32_t* __restrict__ r_out, long long n, int word_shift,
            int digit_shift, const uint32_t* __restrict__ goff,
            unsigned long long* __restrict__ look, unsigned int* __restrict__ ctr) {
  extern __shared__ __align__(16) unsigned char stage[];
  W* s_w = reinterpret_cast<W*>(stage);                          // kTile words
  uint32_t* s_r = reinterpret_cast<uint32_t*>(stage + kTile * sizeof(W));  // kTile rows
  __shared__ uint32_t s_wc[kWarps][kRadix];  // per-warp digit counts, then starts
  __shared__ uint32_t s_start[kRadix];       // tile-local start of each digit
  __shared__ uint32_t s_shift[kRadix];       // global position - tile-local index
  __shared__ uint32_t s_warp_sums[kWarps];
  __shared__ uint32_t s_cnt[kRadix];         // the tile's digit counts
  __shared__ unsigned int s_tile;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) s_tile = atomicAdd(ctr, 1u);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s_wc[w][t] = 0u;
  s_cnt[t] = 0u;
  __syncthreads();
  const long long tile = s_tile;
  const long long wbase = tile * kTile + (long long)warp * kWarpRows;

  W wv[kItems];
  uint32_t rv[kItems], rank[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = wbase + k * 32 + lane;
    wv[k] = 0;
    rv[k] = 0;
    if (i < n) {
      if (kFirst) {
        wv[k] = (W)(src.key(i) >> word_shift);
        rv[k] = (uint32_t)i | src.tag(i);
      } else {
        wv[k] = w_in[i];
        rv[k] = r_in[i];
      }
    }
  }

  // the tile's digit counts, published before the ranking so that later
  // tiles' look-backs find them sooner
  unsigned long long* mine = look + tile * kRadix + t;
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    if (wbase + k * 32 + lane < n)
      atomicAdd(&s_cnt[(unsigned)(wv[k] >> digit_shift) & 0xFFu], 1u);
  __syncthreads();
  store_flag(mine, (tile == 0 ? kInclusive : kAggregate) | s_cnt[t]);

  // rank inside each warp, in (item, lane) order: the lanes holding the
  // same digit, from one ballot a digit bit (the hardware match is slower)
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const bool live = wbase + k * 32 + lane < n;
    const unsigned d = (unsigned)(wv[k] >> digit_shift) & 0xFFu;
    unsigned peers = __ballot_sync(0xffffffffu, live);
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const bool bit = (d >> b) & 1u;
      const unsigned bal = __ballot_sync(0xffffffffu, bit);
      peers &= bit ? bal : ~bal;
    }
    const int leader = __ffs(peers) - 1;  // a dead lane's is unused
    uint32_t old = 0u;
    if (live && lane == leader) {
      old = s_wc[warp][d];
      s_wc[warp][d] = old + (uint32_t)__popc(peers);
    }
    old = __shfl_sync(0xffffffffu, old, leader);
    rank[k] = old + (uint32_t)__popc(peers & ((1u << lane) - 1u));
    __syncwarp();
  }
  __syncthreads();

  // thread t = digit t: the warps' starts and the tile's count
  uint32_t count = 0u;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const uint32_t c = s_wc[w][t];
    s_wc[w][t] = count;
    count += c;
  }
  const uint32_t start = cta_exclusive_scan(count, s_warp_sums);
  s_start[t] = start;
  __syncthreads();

  // stage the tile in digit order
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (wbase + k * 32 + lane < n) {
      const unsigned d = (unsigned)(wv[k] >> digit_shift) & 0xFFu;
      const uint32_t p = s_start[d] + s_wc[warp][d] + rank[k];
      s_w[p] = wv[k];
      s_r[p] = rv[k];
    }
  }

  // decoupled look-back for digit t's exclusive prefix over earlier tiles:
  // kLook predecessors a round trip, summed back to the nearest inclusive
  // prefix; an empty flag is loaded again from there
  uint32_t excl = 0u;
  if (tile > 0) {
    for (long long j = tile - 1;;) {
      unsigned long long v[kLook];
#pragma unroll
      for (int u = 0; u < kLook; ++u)
        v[u] = j - u >= 0 ? load_flag(look + (j - u) * kRadix + t) : kInclusive;
      bool stop = false, done = false;
      int used = 0;
#pragma unroll
      for (int u = 0; u < kLook; ++u) {
        const unsigned long long f = v[u] & ~0xFFFFFFFFull;
        if (!stop) {
          if (f == 0) {
            stop = true;
          } else {
            excl += (uint32_t)v[u];
            ++used;
            if (f == kInclusive) stop = done = true;
          }
        }
      }
      if (done) break;
      j -= used;
    }
    store_flag(mine, kInclusive | (excl + count));
  }
  s_shift[t] = goff[t] + excl - start;
  __syncthreads();

  // write out in digit order: each digit's run is contiguous. The bits
  // outside a uint32 window are the first key's (they are every key's).
  const uint64_t outside =
      kLast && sizeof(W) == 4 ? src.key(0) & ~(0xFFFFFFFFull << word_shift) : 0ull;
  const long long rem = n - tile * kTile;
  const int tile_n = rem < kTile ? (int)rem : kTile;
  for (int i = t; i < tile_n; i += kThreads) {
    const W w = s_w[i];
    const uint32_t r = s_r[i];
    const long long pos = (long long)s_shift[(unsigned)(w >> digit_shift) & 0xFFu] + i;
    if (kLast) {
      dst.put(pos, outside | ((uint64_t)w << word_shift), r);
    } else {
      w_out[pos] = w;
      r_out[pos] = r;
    }
  }
}

// Every real row in place: the sort when no byte varies.
template <class Src, class Dst>
__global__ void identity_kernel(Src src, Dst dst, long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    dst.put(i, src.key(i), (uint32_t)i | src.tag(i));
}

inline unsigned grid_for(long long work, int threads = kThreads) {
  long long g = (work + threads - 1) / threads;
  if (g > 132 * 16) g = 132 * 16;
  return (unsigned)(g < 1 ? 1 : g);
}

inline long long tiles_for(long long n) { return (n + kTile - 1) / kTile; }

template <class Src, class Dst, typename W, bool kFirst, bool kLast>
cudaError_t launch_pass(Src src, Dst dst, const void* w_in, const uint32_t* r_in, void* w_out,
                        uint32_t* r_out, long long n, int word_shift, int digit_shift,
                        const uint32_t* goff, unsigned long long* look,
                        unsigned int* ctr, cudaStream_t s) {
  auto kernel = pass_kernel<Src, Dst, W, kFirst, kLast>;
  const int smem = kTile * (int)(sizeof(W) + sizeof(uint32_t));
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)tiles_for(n), kThreads, smem, s>>>(
      src, dst, (const W*)w_in, r_in, (W*)w_out, r_out, n, word_shift, digit_shift, goff, look,
      ctr);
  return cudaGetLastError();
}

template <class Src, class Dst, typename W>
cudaError_t run_passes(Src src, Dst dst, long long n, const int* bytes, int passes,
                       int word_shift, const uint32_t* offs,
                       unsigned long long* look, unsigned int* ctr, void* wb[2], uint32_t* rb[2],
                       cudaStream_t s) {
  const long long tiles = tiles_for(n);
  cudaError_t err = cudaSuccess;
  for (int p = 0; p < passes && err == cudaSuccess; ++p) {
    const bool first_pass = p == 0, last_pass = p == passes - 1;
    const void* wi = first_pass ? nullptr : wb[(p - 1) & 1];
    const uint32_t* ri = first_pass ? nullptr : rb[(p - 1) & 1];
    void* wo = last_pass ? nullptr : wb[p & 1];
    uint32_t* ro = last_pass ? nullptr : rb[p & 1];
    const int ds = 8 * bytes[p] - word_shift;
    const uint32_t* goff = offs + bytes[p] * kRadix;
    unsigned long long* lk = look + (long long)p * tiles * kRadix;
    if (first_pass && last_pass)
      err = launch_pass<Src, Dst, W, true, true>(src, dst, wi, ri, wo, ro, n, word_shift, ds,
                                                 goff, lk, ctr + p, s);
    else if (first_pass)
      err = launch_pass<Src, Dst, W, true, false>(src, dst, wi, ri, wo, ro, n, word_shift, ds,
                                                  goff, lk, ctr + p, s);
    else if (last_pass)
      err = launch_pass<Src, Dst, W, false, true>(src, dst, wi, ri, wo, ro, n, word_shift, ds,
                                                  goff, lk, ctr + p, s);
    else
      err = launch_pass<Src, Dst, W, false, false>(src, dst, wi, ri, wo, ro, n, word_shift, ds,
                                                   goff, lk, ctr + p, s);
  }
  return err;
}

// Sorts the n rows of `src` by key, stably, handing each to `dst` at its
// sorted position. Carves off [cur, end), each part rounded up to 256 bytes
// (dtt_scan::carve): the histograms, diff and tile counters; the digit
// offsets; 8 passes of look-back words; two ping-pong word and row lanes
// (ops/key_cache.py `_radix_scratch_bytes`).
template <class Src, class Dst>
cudaError_t sort_rows(Src src, Dst dst, long long n, char*& cur, char* end, cudaStream_t s) {
  if (n <= 0) return cudaSuccess;
  const long long tiles = tiles_for(n);
  char* head = (char*)dtt_scan::carve(cur, end, 4 * kBytes * kRadix + 8 + 4 * kBytes);
  uint32_t* offs = (uint32_t*)dtt_scan::carve(cur, end, 4 * kBytes * kRadix);
  unsigned long long* look =
      (unsigned long long*)dtt_scan::carve(cur, end, 8ll * kBytes * kRadix * tiles);
  void* wb[2] = {dtt_scan::carve(cur, end, 8 * n), nullptr};
  uint32_t* rb[2] = {(uint32_t*)dtt_scan::carve(cur, end, 4 * n), nullptr};
  wb[1] = dtt_scan::carve(cur, end, 8 * n);
  rb[1] = (uint32_t*)dtt_scan::carve(cur, end, 4 * n);
  if (!head || !offs || !look || !wb[0] || !wb[1] || !rb[0] || !rb[1])
    return cudaErrorInvalidValue;
  uint32_t* hist = (uint32_t*)head;
  unsigned long long* diff = (unsigned long long*)(head + 4 * kBytes * kRadix);
  unsigned int* ctr = (unsigned int*)(diff + 1);

  cudaError_t err = cudaMemsetAsync(head, 0, 4 * kBytes * kRadix + 8 + 4 * kBytes, s);
  if (err != cudaSuccess) return err;
  const unsigned hg = grid_for(n, kHistThreads);
  hist_kernel<Src><<<hg < kHistGrid ? hg : kHistGrid, kHistThreads, 0, s>>>(src, n, hist, diff);
  offsets_kernel<<<1, kThreads, 0, s>>>(hist, offs);
  err = cudaGetLastError();
  unsigned long long h_diff = 0;
  if (err == cudaSuccess) err = cudaMemcpyAsync(&h_diff, diff, 8, cudaMemcpyDeviceToHost, s);
  if (err == cudaSuccess) err = cudaStreamSynchronize(s);
  if (err != cudaSuccess) return err;

  int bytes[kBytes], passes = 0;
  for (int b = 0; b < kBytes; ++b)
    if ((h_diff >> (8 * b)) & 0xFFull) bytes[passes++] = b;
  if (passes == 0) {
    identity_kernel<Src, Dst><<<grid_for(n), kThreads, 0, s>>>(src, dst, n);
    return cudaGetLastError();
  }
  err = cudaMemsetAsync(look, 0, 8ll * kRadix * tiles * passes, s);
  if (err != cudaSuccess) return err;
  const int lo = bytes[0], hi = bytes[passes - 1];
  if (hi - lo < 4)
    return run_passes<Src, Dst, uint32_t>(src, dst, n, bytes, passes, 8 * lo, offs, look, ctr, wb,
                                          rb, s);
  return run_passes<Src, Dst, uint64_t>(src, dst, n, bytes, passes, 0, offs, look, ctr, wb, rb,
                                        s);
}

}  // namespace dtt_radix

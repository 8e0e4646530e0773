// Slab probe (K9): membership of the MERGE source keys in the sorted key
// slab, fused with the pairing step.
//
// Replaces delta_tpu/ops/key_cache.py:206 `_probe_sorted_kernel`, an XLA
// jit on the TPU that sorts the source, gives each 4096-row slab block a
// window of candidate source keys and brute-compares them (dense compares
// suit the TPU's vector unit; gathers there are slow), with a second tier
// for the widest windows and an overflow flag past it. Its outputs, which
// this kernel keeps exactly (ops/key_cache.slab_probe_plain):
//   head    = [multi | overflow = 0 | matched count, 4 bytes LE | s_bits],
//             s_bits big-endian packed (jnp.packbits): source j equals a
//             VALID slab row among the real rows [0, n); multi: such a
//             source j is not the least index of its key in the source;
//   t_match = a valid real row whose key equals a source key;
//   s_first = for a real row whose key equals a source key, the least such
//             source index; m elsewhere (rows [n, cap) included).
//
// Design: the slab (10.3M rows at bench config 2) is ten times the source
// (2^20). A binary search per source key is ~24 dependent loads into a key
// lane larger than L2, and a run of equal slab keys (deletion-vector kills
// and re-appends) would be walked by one thread; a hash table of the source
// (as the upload join K12/K13 builds, join_probe.cu) takes one random L2
// sector a slab row. So the probe builds an open-addressing table of the
// SOURCE whose slots are in KEY ORDER over the slab's key range [sk[0],
// sk[n-1]]: a source key's home slot is its offset in that range scaled to
// the table. The slab is sorted, so a warp's 32 consecutive rows probe
// neighbouring slots (a sector or two) and the pass over the slab streams
// through the table once. A source key outside the range matches no real
// row and is not inserted.
//   1. build (one thread a source row): the ordered part has L = the power
//      of two at least 2 m slots (and 16), plus kWindow (8) at its end. A
//      key takes the first free slot of the kWindow slots from its home
//      slot (linear probing, the window read before any atomic); where all
//      kWindow are taken (keys crowded into a small part of the range,
//      as the dense run of fresh keys an upsert brings) it goes to the
//      overflow part, L slots hashed (Fibonacci) with unbounded linear
//      probing. A slot is the key
//      (stored XOR the sign bit, so the memset empties the table), in an
//      array of keys the probes walk, and a word in an array beside it,
//      read on a hit: bit 31 the valid-hit flag, bits 0-30 kFirst - the
//      least source index of the key (atomicMax keeps the least index; 0 =
//      no source row). A row whose predecessor holds the same key inserts
//      nothing (the wrapper pads the source with copies of one sentinel,
//      which would hammer one slot). The key that would store as 0
//      (INT32_MIN or INT64_MIN) keeps its word apart (`marker`).
//   2. slab (one warp 256 rows, each thread 8 rows a warp's width apart, so
//      every load and store of the warp is one contiguous run): a real row
//      probes with its int64 key (with an int32 source a key outside int32
//      range is a miss, never narrowed): its window up to the key or a free
//      slot, and the overflow part only where the window is full. It
//      writes t_match and s_first once, and a valid hit sets its slot's
//      flag (read first, so a hot key is written once). Rows in [n, cap)
//      write (0, m). The matched count is a warp then a CTA reduction and
//      one atomic a CTA.
//   3. source (one thread 8 sources, one s_bits byte): each finds its key's
//      slot; the flag is its bit, and a flagged slot whose least index is
//      not the source's own sets multi. The last CTA to finish writes the
//      head (a ticket counter after a __threadfence).
// Four device operations: a memset and three kernels; every output byte is
// written once; nothing walks a run, nothing reads back to the host.
//
// Why a key is found: slots only ever fill. A key in the ordered part sits
// at the first slot of its window that was free or its own when it was
// inserted, so every slot before it is taken; a key in the overflow part
// found its whole window taken, and it still is. So a probe that meets a
// free slot in the window, or the window's end, has its answer.
//
// What bounds it: the slab pass's bytes (8 B of key and 1 of validity in, 5
// out a row; the ordered keys are read in order, once). Where the source
// keys crowd a small part of the slab's range, their windows fill and those
// probes pay the overflow part's random sector as the hashed design does.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;      // slab rows a thread
constexpr int kWindow = 8;    // ordered slots a key may take from its home
constexpr unsigned kFlag = 0x80000000u;
constexpr unsigned kFirst = 0x7FFFFFFFu;

template <typename K>
struct Table;

template <>
struct Table<int32_t> {
  using Word = unsigned int;
  static constexpr int kSlot = 4;
  __device__ static Word enc(int32_t k) { return (unsigned)k ^ 0x80000000u; }
  // a slab key: false when no int32 source key can equal it
  __device__ static bool enc_slab(int64_t k, Word& u) {
    if (k < INT32_MIN || k > INT32_MAX) return false;
    u = enc((int32_t)k);
    return true;
  }
};

template <>
struct Table<int64_t> {
  using Word = unsigned long long;
  static constexpr int kSlot = 8;
  __device__ static Word enc(int64_t k) { return (unsigned long long)k ^ 0x8000000000000000ull; }
  __device__ static bool enc_slab(int64_t k, Word& u) {
    u = enc(k);
    return true;
  }
};

// The table: the keys, then the words, of the ordered part (L + kWindow
// slots) and the overflow part (L slots).
template <typename K>
struct Hash {
  using Word = typename Table<K>::Word;
  Word* keys;
  unsigned* words;
  unsigned* marker;  // the word of the key that stores as 0
  int lg;            // L = 2^lg
  // the slab's real key range [lo, hi] as stored keys (empty: lo > hi), and
  // the home slot of u: (u - lo) itself where the range fits L, else
  // (u - lo) * scale / 2^64
  Word lo, hi;
  bool direct;
  uint64_t scale;

  // the range from the sorted slab's first and last real keys
  __device__ void set_range(const int64_t* sk, long long n) {
    lo = 1, hi = 0;
    if (n <= 0) return;
    int64_t a = sk[0], b = sk[n - 1];
    if (sizeof(K) == 4) {
      a = a < INT32_MIN ? INT32_MIN : a;
      b = b > INT32_MAX ? INT32_MAX : b;
      if (a > b) return;
    }
    lo = Table<K>::enc((K)a), hi = Table<K>::enc((K)b);
    const uint64_t span = (uint64_t)(hi - lo);  // the range's size less one
    direct = span < (1ull << lg);
    // floor(2^(64 + lg) / (span + 1)); a span of 2^64 - 1 gives 2^lg
    scale = direct ? 0
                   : span == ~0ull ? (1ull << lg)
                                   : (uint64_t)(((unsigned __int128)1 << (64 + lg)) /
                                                ((unsigned __int128)span + 1));
  }
  __device__ __forceinline__ bool in_range(Word u) const { return u >= lo && u <= hi; }
  __device__ __forceinline__ uint64_t home(Word u) const {
    const uint64_t x = (uint64_t)(Word)(u - lo);
    return direct ? x : __umul64hi(x, scale);
  }
  __device__ __forceinline__ uint64_t overflow_home(Word u) const {
    return (1ull << lg) + kWindow + (((uint64_t)u * 0x9E3779B97F4A7C15ull) >> (64 - lg));
  }
  __device__ __forceinline__ uint64_t overflow_next(uint64_t h) const {
    const uint64_t base = (1ull << lg) + kWindow;
    return base + ((h - base + 1) & ((1ull << lg) - 1));
  }
};

// The slot of u (in range, not 0) where it is or would go, walked from its
// home slot `h` whose key is `key`; nullptr where u is no source key.
template <typename K>
__device__ __forceinline__ unsigned* walk(const Hash<K>& t, typename Hash<K>::Word u,
                                          uint64_t h, typename Hash<K>::Word key) {
  const uint64_t end = h + kWindow;
  while (key != u && key != 0 && ++h < end) key = t.keys[h];
  if (key == u) return t.words + h;
  if (key == 0) return nullptr;
  h = t.overflow_home(u);  // the window is full: the overflow part
  for (key = t.keys[h]; key != u && key != 0; key = t.keys[h]) h = t.overflow_next(h);
  return key == u ? t.words + h : nullptr;
}

// kRows lookups at once: every home slot is loaded before any probe walks
// on, then every hit's word, so a thread has kRows loads in flight. look[e]
// false: no lookup. After run, word[e] is the slot's word (0: the key is no
// source key) and at[e] where it lives.
template <typename K>
struct Lookups {
  using Word = typename Table<K>::Word;
  Word u[kRows], key[kRows];
  uint64_t h[kRows];
  unsigned word[kRows];
  unsigned* at[kRows];

  __device__ __forceinline__ void run(const Hash<K>& t, bool (&look)[kRows]) {
#pragma unroll
    for (int e = 0; e < kRows; ++e) {
      look[e] = look[e] && (u[e] == 0 || t.in_range(u[e]));
      key[e] = 0;
      h[e] = 0;
      if (look[e] && u[e] != 0) {
        h[e] = t.home(u[e]);
        key[e] = t.keys[h[e]];
      }
    }
#pragma unroll
    for (int e = 0; e < kRows; ++e)
      at[e] = !look[e] ? nullptr : u[e] == 0 ? t.marker : walk<K>(t, u[e], h[e], key[e]);
#pragma unroll
    for (int e = 0; e < kRows; ++e) word[e] = at[e] ? *(volatile unsigned*)at[e] : 0u;
  }
};

// One thread a source row. A row whose predecessor holds the same key is
// skipped (the run's first row has the run's least index).
template <typename K>
__global__ void __launch_bounds__(kThreads)
build_kernel(const K* __restrict__ s, long long m, Hash<K> t, const int64_t* sk, long long n) {
  using Word = typename Table<K>::Word;
  t.set_range(sk, n);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += (long long)gridDim.x * blockDim.x) {
    const K k = s[i];
    if (i > 0 && s[i - 1] == k) continue;
    const Word u = Table<K>::enc(k);
    unsigned* word = t.marker;
    if (u != 0) {
      if (!t.in_range(u)) continue;  // matches no real row
      word = nullptr;
      // the window read before any atomic: a slot seen taken stays taken,
      // so only a slot seen free (or holding u) is tried
      const uint64_t h0 = t.home(u);
      for (uint64_t h = h0; h < h0 + kWindow && !word; ++h) {
        Word prev = t.keys[h];
        if (prev == 0) prev = atomicCAS(t.keys + h, (Word)0, u);
        if (prev == 0 || prev == u) word = t.words + h;
      }
      for (uint64_t h = t.overflow_home(u); !word; h = t.overflow_next(h)) {
        const Word prev = atomicCAS(t.keys + h, (Word)0, u);
        if (prev == 0 || prev == u) word = t.words + h;
      }
    }
    atomicMax(word, kFirst - (unsigned)i);
  }
}

template <typename K>
__global__ void __launch_bounds__(kThreads)
slab_kernel(const int64_t* __restrict__ sk, const uint8_t* __restrict__ sv, long long n,
            long long cap, int32_t m, Hash<K> t, uint8_t* __restrict__ t_match,
            int32_t* __restrict__ s_first, unsigned* count) {
  using T = Table<K>;
  t.set_range(sk, n);
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (kThreads / 32);
  unsigned matched = 0;
  for (long long chunk = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
       chunk * 32 * kRows < cap; chunk += warps) {
    const long long r0 = chunk * 32 * kRows + lane;
    Lookups<K> q;
    bool look[kRows];
    uint8_t ok[kRows];
#pragma unroll
    for (int e = 0; e < kRows; ++e) {
      const long long r = r0 + 32 * e;
      const int64_t key = r < n ? __ldcs(sk + r) : 0;
      ok[e] = r < n ? __ldcs(sv + r) : 0;
      q.u[e] = 0;
      look[e] = r < n && T::enc_slab(key, q.u[e]);
    }
    q.run(t, look);
#pragma unroll
    for (int e = 0; e < kRows; ++e) {
      const long long r = r0 + 32 * e;
      if (r >= cap) break;
      uint8_t hit = 0;
      int32_t first = m;
      const unsigned w = q.word[e];
      if (w) {
        first = (int32_t)(kFirst - (w & kFirst));
        if (ok[e]) {
          hit = 1;
          ++matched;
          if (!(w & kFlag)) atomicOr(q.at[e], kFlag);
        }
      }
      __stcs(t_match + r, hit);
      __stcs(s_first + r, first);
    }
  }
  matched = __reduce_add_sync(0xffffffffu, matched);
  __shared__ unsigned part[kThreads / 32];
  if (lane == 0) part[threadIdx.x >> 5] = matched;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned sum = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) sum += part[w];
    if (sum) atomicAdd(count, sum);
  }
}

// One thread 8 (kRows) source rows: their s_bits byte; multi; the last CTA
// writes the head's first six bytes.
template <typename K>
__global__ void __launch_bounds__(kThreads)
source_kernel(const K* __restrict__ s, long long m_bytes, Hash<K> t, const int64_t* sk,
              long long n, const unsigned* count, unsigned* multi, unsigned* done,
              uint8_t* __restrict__ head) {
  using T = Table<K>;
  t.set_range(sk, n);
  bool local_multi = false;
  for (long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x; b < m_bytes;
       b += (long long)gridDim.x * blockDim.x) {
    Lookups<K> q;
    bool look[kRows];
#pragma unroll
    for (int e = 0; e < kRows; ++e) {
      q.u[e] = T::enc(s[8 * b + e]);
      look[e] = true;
    }
    q.run(t, look);
    unsigned byte = 0;
#pragma unroll
    for (int e = 0; e < kRows; ++e) {
      const unsigned w = q.word[e];
      if (w & kFlag) {
        byte |= 0x80u >> e;
        local_multi |= (long long)(kFirst - (w & kFirst)) != 8 * b + e;
      }
    }
    head[6 + b] = (uint8_t)byte;
  }
  if (__any_sync(0xffffffffu, local_multi) && (threadIdx.x & 31) == 0) {
    atomicOr(multi, 1u);
    __threadfence();
  }
  __syncthreads();
  __shared__ bool last;
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last && threadIdx.x == 0) {
    __threadfence();
    const unsigned mc = *(const volatile unsigned*)count;
    head[0] = *(const volatile unsigned*)multi ? 1 : 0;
    head[1] = 0;  // the probe never overflows
    head[2] = mc & 0xFF;
    head[3] = (mc >> 8) & 0xFF;
    head[4] = (mc >> 16) & 0xFF;
    head[5] = (mc >> 24) & 0xFF;
  }
}

unsigned grid_for(long long items, long long most) {
  const long long b = (items + kThreads - 1) / kThreads;
  return (unsigned)(b < 1 ? 1 : b > most ? most : b);
}

// L: the power of two at least 2 m (and 16).
int slots_log2(long long m) {
  int k = 4;
  while ((1ll << k) < 2 * m) ++k;
  return k;
}

template <typename K>
int run(const int64_t* sk, const uint8_t* sv, long long n, long long cap, const K* s,
        long long m, uint8_t* head, uint8_t* t_match, int32_t* s_first, void* scratch,
        long long scratch_bytes, cudaStream_t st) {
  const int lg = slots_log2(m);
  const long long slots = (2ll << lg) + kWindow;
  const long long key_bytes = ((long long)Table<K>::kSlot * slots + 255) / 256 * 256;
  const long long word_bytes = (4 * slots + 255) / 256 * 256;
  if (scratch_bytes < key_bytes + word_bytes + 256) return (int)cudaErrorInvalidValue;
  char* base = (char*)scratch;
  unsigned* counters = (unsigned*)(base + key_bytes + word_bytes);  // count, multi, done
  Hash<K> t{};
  t.keys = (typename Table<K>::Word*)base;
  t.words = (unsigned*)(base + key_bytes);
  t.marker = counters + 3;
  t.lg = lg;
  cudaError_t err = cudaMemsetAsync(scratch, 0, key_bytes + word_bytes + 256, st);
  if (err != cudaSuccess) return (int)err;
  if (m > 0) build_kernel<K><<<grid_for(m, 16384), kThreads, 0, st>>>(s, m, t, sk, n);
  if (cap > 0) {
    const long long chunks = (cap + 32 * kRows - 1) / (32 * kRows);
    slab_kernel<K><<<grid_for(chunks * 32, 1ll << 30), kThreads, 0, st>>>(
        sk, sv, n, cap, (int32_t)m, t, t_match, s_first, counters);
  }
  source_kernel<K><<<grid_for(m / 8, 16384), kThreads, 0, st>>>(
      s, m / 8, t, sk, n, counters, counters + 1, counters + 2, head);
  return (int)cudaGetLastError();
}

}  // namespace

// sk (cap,) i64 sorted over [0, n), sv (cap,) u8, s (m,) i32 or i64 (m % 8
// == 0); outputs head (6 + m/8,) u8, t_match (cap,) u8, s_first (cap,) i32.
// scratch: the table of 2 L + 8 slots (L the power of two >= 2 m, and 16):
// the keys (4 bytes a slot for an int32 source, 8 for int64) and the words
// (4 bytes a slot), each rounded up to 256 bytes, then 256 bytes of
// counters (ops/key_cache._probe_scratch_bytes).
extern "C" int dtt_slab_probe(const int64_t* sk, const uint8_t* sv, long long n, long long cap,
                              const void* s, int s_is_i32, long long m, uint8_t* head,
                              uint8_t* t_match, int32_t* s_first, void* scratch,
                              long long scratch_bytes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n < 0 || n > cap || m < 0 || m % 8 || m >= (1ll << 31) - 1 || cap >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  if (s_is_i32)
    return run<int32_t>(sk, sv, n, cap, (const int32_t*)s, m, head, t_match, s_first, scratch,
                        scratch_bytes, st);
  return run<int64_t>(sk, sv, n, cap, (const int64_t*)s, m, head, t_match, s_first, scratch,
                      scratch_bytes, st);
}

// Upload join probe (K12) and its sharded form (K13): the MERGE join's
// membership kernel for a target key lane uploaded whole (no resident slab).
//
// K12 replaces delta_tpu/ops/join_kernel.py:127 `_single_device_kernel`, an
// XLA jit on the TPU that sorts both sides and counts with two-way
// searchsorted:
//   t_bits = packbits(count_in_s(t) > 0), s_bits = packbits(count_in_t(s) > 0),
//   multi  = any(count_in_s(t) > 1),
// bits big-endian as jnp.packbits. The inputs are padded by the caller
// (ops/join_kernel.inner_join_async) with per-side sentinels, so a pad or a
// NULL key never matches anything; keys are int32 or int64 (both sides the
// same type). The kernel computes the function for any keys, sentinels or not.
//
// K13, dtt_join_probe_shard, replaces delta_tpu/ops/join_kernel.py:150
// `_sharded_kernel`, a shard_map over the TPU mesh: the target stays sharded
// (contiguous slabs of cap_t / p), the padded source is all-gathered (tiled,
// so in its original order), each shard counts its slab's keys in the source
// and the source's keys in its slab, and `psum`s reduce the source hits and
// the multi flags. Here one call a distinct device runs the passes below over
// ALL of that device's slabs against the gathered source: its outputs are
// the slabs' packed t bits (in the order given), the source hits packed
// big-endian as K12's (a bit set where a key of one of the slabs equals the
// row's) and one multi byte. Where one device holds every shard, that launch
// is the whole reduction. Across devices, one launch of the combine kernel
// (shard_combine.cu) ORs the devices' packed hit bytes (the OR of packed
// bytes is the packing of the OR) and their multi bytes: the TPU kernel's
// psum. Every device sees the whole source, so a key repeated across two
// source pieces still counts as a multi-match on the slab that holds it, as
// in the TPU kernel.
//
// Design: the TPU kernel sorts because dense compares suit it. Here the large
// side is the target (12.6M keys at bench config 2, 16.7M over the mesh,
// against 2^20 source keys), and a binary search costs ~20 dependent L2 loads
// a key, so the join builds an open-addressing hash table of the source once
// and probes it:
//   1. build (one thread a source row): a power-of-two table of at least
//      2 cap_s slots (so a probe always ends at an empty slot), linear
//      probing, one slot a distinct key holding its count: lanes of a warp
//      with equal keys are counted together (__match_any_sync) and their
//      leader inserts with atomicCAS on the key and adds the count;
//   2. target (one thread 8 keys, one t_bits byte): one probe a key, usually
//      one 32-byte L2 sector; a match sets the slot's hit flag (read first,
//      so a hot key is written once) and ORs count > 1 into multi;
//   3. source (one thread 8 rows): each row finds its own key's slot and
//      writes its hit flag, packed big-endian.
// A slot is the key (4 or 8 bytes, stored XOR the sign bit, so a zeroed slot
// is empty) and a word of count (31 bits) and hit flag (bit 31), padded to 8
// or 16 bytes: one vector load. The key that would store as 0 (INT32_MIN or
// INT64_MIN) keeps its count and flag in a word of its own. No sort, no
// read-back to the host, nothing walks a duplicate run.
//
// What bounds it: the target lane's bytes (one read) and the probes' L2
// sectors (one or two a key into a 16-32 MB table that stays in L2); the
// build's and the source pass's work is cap_s, a twelfth of the target's.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSlabs = 64;
constexpr unsigned kHit = 0x80000000u;

struct Slabs {
  const void* t[kMaxSlabs];
  long long n_bytes[kMaxSlabs];  // keys / 8: the slab's t_bits bytes
  long long out_off[kMaxSlabs];  // its first byte in t_bits
  int n;
};

template <typename K>
struct Table;

template <>
struct Table<int32_t> {
  using Word = unsigned int;
  static constexpr int kSlot = 8;
  __device__ static Word enc(int32_t k) { return (unsigned)k ^ 0x80000000u; }
  __device__ static void load(const char* tab, uint64_t h, Word& key, unsigned& cnt) {
    const uint2 v = *(const uint2*)(tab + 8 * h);
    key = v.x;
    cnt = v.y;
  }
  __device__ static Word* key_at(char* tab, uint64_t h) { return (Word*)(tab + 8 * h); }
  __device__ static unsigned* cnt_at(char* tab, uint64_t h) { return (unsigned*)(tab + 8 * h + 4); }
};

template <>
struct Table<int64_t> {
  using Word = unsigned long long;
  static constexpr int kSlot = 16;
  __device__ static Word enc(int64_t k) { return (unsigned long long)k ^ 0x8000000000000000ull; }
  __device__ static void load(const char* tab, uint64_t h, Word& key, unsigned& cnt) {
    const ulonglong2 v = *(const ulonglong2*)(tab + 16 * h);
    key = v.x;
    cnt = (unsigned)v.y;
  }
  __device__ static Word* key_at(char* tab, uint64_t h) { return (Word*)(tab + 16 * h); }
  __device__ static unsigned* cnt_at(char* tab, uint64_t h) { return (unsigned*)(tab + 16 * h + 8); }
};

// Fibonacci hashing: the top log2(slots) bits of the key times 2^64 / phi
__device__ __forceinline__ uint64_t home(uint64_t u, int shift) {
  return (u * 0x9E3779B97F4A7C15ull) >> shift;
}

// 8 keys from 16-byte loads (the slab is 16-byte aligned, 8 keys a thread)
template <typename K>
__device__ __forceinline__ void load8(const K* p, long long j, K (&k)[8]);

template <>
__device__ __forceinline__ void load8<int32_t>(const int32_t* p, long long j, int32_t (&k)[8]) {
  const int4 a = __ldg((const int4*)(p + 8 * j)), b = __ldg((const int4*)(p + 8 * j) + 1);
  k[0] = a.x, k[1] = a.y, k[2] = a.z, k[3] = a.w, k[4] = b.x, k[5] = b.y, k[6] = b.z, k[7] = b.w;
}

template <>
__device__ __forceinline__ void load8<int64_t>(const int64_t* p, long long j, int64_t (&k)[8]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const longlong2 v = __ldg((const longlong2*)(p + 8 * j) + q);
    k[2 * q] = v.x, k[2 * q + 1] = v.y;
  }
}

template <typename K>
__global__ void __launch_bounds__(kThreads)
build_kernel(const K* __restrict__ s, long long m, char* tab, uint64_t mask, int shift,
             unsigned* marker) {
  using T = Table<K>;
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // base is the same for a warp's lanes, so they iterate together
  for (long long base = (long long)blockIdx.x * blockDim.x; base < m; base += stride) {
    const long long i = base + threadIdx.x;
    const bool in = i < m;
    const unsigned live = __ballot_sync(0xffffffffu, in);
    if (!in) continue;
    const typename T::Word u = T::enc(s[i]);
    const unsigned peers = __match_any_sync(live, (unsigned long long)u);
    if (lane != __ffs(peers) - 1) continue;
    const unsigned c = __popc(peers);
    if (u == 0) {
      atomicAdd(marker, c);
      continue;
    }
    for (uint64_t h = home(u, shift);; h = (h + 1) & mask) {
      const typename T::Word prev = atomicCAS(T::key_at(tab, h), (typename T::Word)0, u);
      if (prev == 0 || prev == u) {
        atomicAdd(T::cnt_at(tab, h), c);
        break;
      }
    }
  }
}

template <typename K>
__global__ void __launch_bounds__(kThreads)
target_kernel(const __grid_constant__ Slabs sl, char* tab, uint64_t mask, int shift,
              unsigned* marker, uint8_t* __restrict__ t_bits, unsigned* multi) {
  using T = Table<K>;
  const int slab = blockIdx.y;
  const K* t = (const K*)sl.t[slab];
  const long long nb = sl.n_bytes[slab];
  uint8_t* out = t_bits + sl.out_off[slab];
  bool local_multi = false;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < nb;
       j += (long long)gridDim.x * blockDim.x) {
    K k[8];
    load8<K>(t, j, k);
    typename T::Word u[8], key[8];
    uint64_t h[8];
    unsigned cnt[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      u[e] = T::enc(k[e]);
      h[e] = home(u[e], shift);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) T::load(tab, h[e], key[e], cnt[e]);
    unsigned byte = 0;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      unsigned* flag;
      if (u[e] == 0) {
        cnt[e] = *(volatile unsigned*)marker;
        flag = marker;
      } else {
        while (key[e] != u[e] && key[e] != 0) {
          h[e] = (h[e] + 1) & mask;
          T::load(tab, h[e], key[e], cnt[e]);
        }
        if (key[e] == 0) cnt[e] = 0;
        flag = T::cnt_at(tab, h[e]);
      }
      const unsigned c = cnt[e] & ~kHit;
      if (c) {
        byte |= 0x80u >> e;
        if (!(cnt[e] & kHit)) atomicOr(flag, kHit);
        local_multi |= c > 1;
      }
    }
    out[j] = (uint8_t)byte;
  }
  if (__any_sync(0xffffffffu, local_multi) && (threadIdx.x & 31) == 0) atomicOr(multi, 1u);
}

// One thread 8 source rows: their hit flags, packed into a byte; block 0
// also writes the multi byte.
template <typename K>
__global__ void __launch_bounds__(kThreads)
source_kernel(const K* __restrict__ s, long long m_bytes, const char* tab, uint64_t mask,
              int shift, const unsigned* marker, uint8_t* __restrict__ out,
              const unsigned* multi, uint8_t* __restrict__ multi_out) {
  using T = Table<K>;
  if (blockIdx.x == 0 && threadIdx.x == 0) *multi_out = *multi ? 1 : 0;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < m_bytes;
       j += (long long)gridDim.x * blockDim.x) {
    K k[8];
    load8<K>(s, j, k);
    unsigned byte = 0;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const typename T::Word u = T::enc(k[e]);
      unsigned cnt;
      if (u == 0) {
        cnt = *marker;
      } else {
        typename T::Word key;
        uint64_t h = home(u, shift);
        T::load(tab, h, key, cnt);
        while (key != u) {  // every source key is in the table
          h = (h + 1) & mask;
          T::load(tab, h, key, cnt);
        }
      }
      byte |= ((cnt & kHit) ? 1u : 0u) << (7 - e);
    }
    out[j] = (uint8_t)byte;
  }
}

unsigned grid_for(long long items) {
  const long long b = (items + kThreads - 1) / kThreads;
  return (unsigned)(b < 1 ? 1 : b > 16384 ? 16384 : b);
}

// The table's slots: the power of two at least 2 cap_s (and 16).
int slots_log2(long long cap_s) {
  int k = 4;
  while ((1ll << k) < 2 * cap_s) ++k;
  return k;
}

// scratch: the table (zeroed here), then the marker word and the multi word
// (256-byte aligned parts). s_bits (cap_s / 8,) the packed source hits.
template <typename K>
int run(const Slabs& all, const K* s, long long cap_s, uint8_t* t_bits, uint8_t* s_bits,
        uint8_t* multi_out, void* scratch, long long scratch_bytes, cudaStream_t st) {
  const int lg = slots_log2(cap_s);
  const long long table_bytes = (((long long)Table<K>::kSlot << lg) + 255) / 256 * 256;
  if (scratch_bytes < table_bytes + 256) return (int)cudaErrorInvalidValue;
  char* tab = (char*)scratch;
  unsigned* marker = (unsigned*)(tab + table_bytes);
  unsigned* multi = marker + 1;
  const uint64_t mask = (1ull << lg) - 1;
  const int shift = 64 - lg;
  cudaError_t err = cudaMemsetAsync(scratch, 0, table_bytes + 256, st);
  if (err != cudaSuccess) return (int)err;
  build_kernel<K><<<grid_for(cap_s), kThreads, 0, st>>>(s, cap_s, tab, mask, shift, marker);
  long long most = 0;
  for (int i = 0; i < all.n; ++i) most = all.n_bytes[i] > most ? all.n_bytes[i] : most;
  if (most > 0)
    target_kernel<K><<<dim3(grid_for(most), all.n), kThreads, 0, st>>>(all, tab, mask, shift,
                                                                       marker, t_bits, multi);
  source_kernel<K><<<grid_for(cap_s / 8), kThreads, 0, st>>>(s, cap_s / 8, tab, mask, shift,
                                                              marker, s_bits, multi, multi_out);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// t (cap_t,), s (cap_s,) int32 (is32 = 1) or int64, 16-byte aligned; cap_t
// and cap_s multiples of 8, cap_s >= 8. Outputs t_bits (cap_t/8,) u8, s_bits
// (cap_s/8,) u8, multi (1,) u8. scratch: the hash table of the power of two
// >= 2 cap_s slots (8 bytes a slot for int32 keys, 16 for int64), rounded up
// to 256 bytes, then 256 bytes (ops/join_kernel._join_scratch_bytes).
extern "C" int dtt_join_probe(const void* t, long long cap_t, const void* s, long long cap_s,
                              int is32, uint8_t* t_bits, uint8_t* s_bits, uint8_t* multi,
                              void* scratch, long long scratch_bytes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (cap_t < 0 || cap_s < 8 || cap_t % 8 || cap_s % 8 || cap_s >= (1ll << 31) ||
      !aligned16(t) || !aligned16(s))
    return (int)cudaErrorInvalidValue;
  Slabs sl{};
  sl.n = 1;
  sl.t[0] = t;
  sl.n_bytes[0] = cap_t / 8;
  if (is32)
    return run<int32_t>(sl, (const int32_t*)s, cap_s, t_bits, s_bits, multi, scratch,
                        scratch_bytes, st);
  return run<int64_t>(sl, (const int64_t*)s, cap_s, t_bits, s_bits, multi, scratch,
                      scratch_bytes, st);
}

// K13 on one device: n_slabs (<= 64) target slabs (slabs[i] of slab_keys[i]
// keys, each a multiple of 8, 16-byte aligned) against s (cap_s,) the whole
// gathered source, keys as dtt_join_probe's. Outputs t_bits (sum of
// slab_keys / 8,) u8, the slabs' bits one after another; s_bits (cap_s / 8,)
// u8, the packed source hits of these slabs; multi (1,) u8; the same scratch.
extern "C" int dtt_join_probe_shard(const void* const* slabs, const long long* slab_keys,
                                    int n_slabs, const void* s, long long cap_s, int is32,
                                    uint8_t* t_bits, uint8_t* s_bits, uint8_t* multi,
                                    void* scratch, long long scratch_bytes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n_slabs < 1 || n_slabs > kMaxSlabs || cap_s < 8 || cap_s % 8 || cap_s >= (1ll << 31) ||
      !s_bits || !aligned16(s))
    return (int)cudaErrorInvalidValue;
  Slabs sl{};
  sl.n = n_slabs;
  long long off = 0;
  for (int i = 0; i < n_slabs; ++i) {
    if (slab_keys[i] < 0 || slab_keys[i] % 8 || !aligned16(slabs[i]))
      return (int)cudaErrorInvalidValue;
    sl.t[i] = slabs[i];
    sl.n_bytes[i] = slab_keys[i] / 8;
    sl.out_off[i] = off;
    off += slab_keys[i] / 8;
  }
  if (is32)
    return run<int32_t>(sl, (const int32_t*)s, cap_s, t_bits, s_bits, multi, scratch,
                        scratch_bytes, st);
  return run<int64_t>(sl, (const int64_t*)s, cap_s, t_bits, s_bits, multi, scratch,
                      scratch_bytes, st);
}

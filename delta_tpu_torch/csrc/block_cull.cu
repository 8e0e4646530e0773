// Block cull (K1): one batch of range queries against the resident scan lanes.
//
// Replaces delta_tpu/ops/state_cache.py:986 `_block_kernel_fn` (an XLA jit on
// the TPU). For M queries, C stat lanes and `cap` files it computes
//   keep[m, f] = alive[f] AND for every column c:
//                (isnan(max) | isnan(lo) | max >= lo) & (isnan(min) | isnan(hi) | min <= hi)
// then ORs keep over each 1024-file block and packs the block bits big-endian
// (`jnp.packbits` / `np.unpackbits` order: block 8*b + j is bit 7 - j of
// byte b), giving (M, ceil(cap / 1024 / 8)) bytes.
//
// What bounds it on this card: the bytes its data needs (alive and a
// column's lanes of the files still kept after the columns before it: ~9 MB,
// 0.003 ms, for config 6's point queries on clustered lanes), and, where the
// lanes are not clustered, the per-file tests (2 * M * C compares a file done
// directly). What holds it at 3-5x that bound: the rank-table launch (~2 us),
// cap / 1024 CTAs of fixed cost (load, table reads through L2, the block
// reduction and its atomics) in several waves (102 registers at 4 query
// tiles, 2 CTAs an SM; 48 at one tile), and the alive word a file. The design
// reads the lanes once per launch, whatever M, and replaces most compares by
// a warp's box test and binary searches:
//
//   * Rank tables (`tables_kernel`, one CTA per (64-query tile, column)):
//     the tile's `lo` sorted ascending with prefix masks, `lo_pref[k]` = the
//     queries at lo-sorted positions < k, and its `hi` sorted ascending with
//     suffix masks, `hi_suf[k]` = the queries at positions >= k. A file's
//     set {q : max >= lo_q} is a prefix of the lo order, `lo_pref[#{lo <=
//     max}]`, and {q : min <= hi_q} a suffix of the hi order, `hi_suf[#{hi
//     < min}]`: two 7-step searches and two mask loads replace 64 x 2
//     compares. The tables (2 KB a tile and column, with the bounds in
//     query order too) are read through L1.
//   * The cull (`cull_kernel`): one CTA a 1024-file block, 4 files a thread,
//     so cap / 1024 CTAs (1,024 at cap=2^20, several on each of the 132
//     SMs). Each thread loads a column's (min, max) of its 4 files with two
//     16-byte streaming loads and holds them while it walks up to 4 query
//     tiles (256 queries, their 64-bit keep masks in registers); a larger
//     batch re-reads the lanes once per 256 queries. A batch of at most 64
//     queries (a `files_for_scan` call has one) runs a one-tile instance of
//     the kernel: 48 registers instead of 102, so more CTAs fit an SM and
//     the launch takes fewer waves. Per column, the warp
//     first tests the box of its still-kept files (the min of their mins,
//     the max of their maxes: a lane a query, two ballots): a query that
//     misses the box misses every file in it, so on a clustered column most
//     tiles end there. In a tile where some query still keeps some file of
//     the warp, each file is tested against those queries directly when
//     they are at most 8, else by the two rank searches (on lanes that are
//     not clustered, this kernel took 0.047 and 0.118 ms at M=256 where a
//     design without the searches, box test then compares of every
//     candidate, took 0.115 and 0.61: one H100 at 700 W,
//     `tools/kernel_ab.py`'s shuffled and random lanes). Once no query
//     keeps any file of a warp, the warp skips the later columns' loads: a
//     point query on a clustered column reads little more than that column.
//   * The block's any-bit per query: a warp OR-reduce and a shared-memory
//     pass; thread q ORs query q's bit into its packed byte (zeroed by the
//     tables kernel) with a 32-bit atomicOr, a bit a CTA.
//
// The query axis is not padded: M is the batch's own size.
//
// NaN means "no bound". It is tested explicitly when a value is loaded: a NaN
// query bound becomes -inf (lo) / +inf (hi), a NaN file min/max becomes
// -inf / +inf, after which a plain compare gives exactly the JAX verdict
// (an infinity is kept as an infinity, so the inverted +inf/-inf lanes of a
// null partition value still prune). The searches compare the same values
// with the same operators (max >= lo as lo <= max, min <= hi as not hi <
// min), and equal values sort together, so ties keep their verdicts. Built
// without fast math / FTZ: the f32 lanes can hold subnormals, and flushing
// them would change comparisons.
//
// The sharded block cull (K7) is the second entry point,
// dtt_block_cull_shards. It replaces delta_tpu/ops/state_cache.py:1014
// `_sharded_block_kernel_fn`, a shard_map on the TPU mesh in which each
// device runs K1's test over its 1/shards slice of the file axis and
// any-reduces its own 1024-file blocks into UNPACKED u8, all-gathered along
// the file axis. Here ONE launch a distinct device covers all its shards: a
// by-value table of at most 64 shards (each slice's lanes, its capacity and
// the output column of its first block), one rank table built once for the
// device, and one cull grid with blockIdx.y the shard (a shard's blocks past
// its own capacity return at once). The same CTA body as K1 (templated on
// the output form) writes one byte per block at (q, col + block) of an
// (M, out_w) map: where every shard is on the lead device that map is the
// gathered (M, total blocks) result itself, so the bytes are K1's unpacked
// bit for bit with no gather. Each slice holds whole blocks (the wrapper
// asserts it). K1 is the same launch with one shard, packed.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 1024;                 // files per cull block (one CTA)
constexpr int kThreads = 256;
constexpr int kFiles = kBlock / kThreads;    // 4 a thread: one float4 a lane
constexpr int kWarps = kThreads / 32;
constexpr int kQ = 64;                       // queries a tile: one 64-bit mask
constexpr int kGroup = 4;                    // tiles held in registers a sweep
                                             // (1 when the batch has one tile)
constexpr int kDirect = 8;                   // up to this many queries: compares
constexpr int kMaxShards = 64;               // shards a launch (a device's)

// The slices one launch culls, blockIdx.y the slice: its lanes (C, cap[s])
// and alive (cap[s],), and the output column of its first block.
struct Slices {
  const float* mins[kMaxShards];
  const float* maxs[kMaxShards];
  const uint8_t* alive[kMaxShards];
  long long cap[kMaxShards];
  long long col[kMaxShards];
};

// One (64-query tile, column): absent queries of a partial tile sort last
// as +inf and have no bit in any mask.
struct Table {
  float lo[kQ];                // lo ascending (NaN -> -inf)
  float hi[kQ];                // hi ascending (NaN -> +inf)
  unsigned long long lo_pref[kQ + 1];  // queries at lo-sorted positions < k
  unsigned long long hi_suf[kQ + 1];   // queries at hi-sorted positions >= k
  float lo_q[kQ];              // lo, hi in query order (NaN -> -inf, +inf)
  float hi_q[kQ];
};
static_assert(sizeof(Table) == 2064, "ops/state_cache.py _TABLE_BYTES");

// grid (tiles, max(C, 1)), kQ threads; also zeroes zero_words words of the
// packed output.
__global__ void __launch_bounds__(kQ)
tables_kernel(const float* __restrict__ lo, const float* __restrict__ hi, int M, int C,
              Table* __restrict__ tabs, uint32_t* __restrict__ zero, long long zero_words) {
  const long long stride = (long long)gridDim.x * gridDim.y * blockDim.x;
  for (long long w = ((long long)blockIdx.y * gridDim.x + blockIdx.x) * blockDim.x + threadIdx.x;
       w < zero_words; w += stride)
    zero[w] = 0u;
  const int tile = blockIdx.x, c = blockIdx.y, i = threadIdx.x, q = tile * kQ + i;
  if (c >= C) return;
  __shared__ float s_lo[kQ], s_hi[kQ];
  __shared__ int s_lq[kQ], s_hq[kQ];
  const bool live = q < M;
  float l = INFINITY, h = INFINITY;
  if (live) {
    l = lo[(long long)q * C + c];
    h = hi[(long long)q * C + c];
    l = isnan(l) ? -INFINITY : l;
    h = isnan(h) ? INFINITY : h;
  }
  s_lo[i] = l;
  s_hi[i] = h;
  __syncthreads();
  int rl = 0, rh = 0;  // ranks: value, then index, order
  for (int j = 0; j < kQ; ++j) {
    const float a = s_lo[j], b = s_hi[j];
    rl += (a < l) | ((a == l) & (j < i));
    rh += (b < h) | ((b == h) & (j < i));
  }
  Table* T = tabs + (long long)tile * C + c;
  T->lo[rl] = l;
  T->hi[rh] = h;
  T->lo_q[i] = l;
  T->hi_q[i] = h;
  s_lq[rl] = live ? i : -1;
  s_hq[rh] = live ? i : -1;
  __syncthreads();
  // thread p holds the bits of the queries at sorted position p; an OR-scan
  // over the 64 positions (two warps) gives the prefix and suffix masks
  const int lane = i & 31, warp = i >> 5;
  unsigned long long pre = s_lq[i] >= 0 ? 1ull << s_lq[i] : 0ull;  // inclusive prefix
  unsigned long long suf = s_hq[i] >= 0 ? 1ull << s_hq[i] : 0ull;  // inclusive suffix
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long a = __shfl_up_sync(0xffffffffu, pre, o);
    const unsigned long long b = __shfl_down_sync(0xffffffffu, suf, o);
    if (lane >= o) pre |= a;
    if (lane + o < 32) suf |= b;
  }
  __shared__ unsigned long long s_pre0, s_suf1;
  if (i == 31) s_pre0 = pre;
  if (i == 32) s_suf1 = suf;
  __syncthreads();
  if (warp == 1) pre |= s_pre0;
  if (warp == 0) suf |= s_suf1;
  T->lo_pref[i + 1] = pre;
  T->hi_suf[i] = suf;
  if (i == 0) {
    T->lo_pref[0] = 0ull;
    T->hi_suf[kQ] = 0ull;
  }
}

// #{k : a[k] <= x} over the kQ ascending values of a (7 steps for 64).
__device__ __forceinline__ int count_le(const float* a, float x) {
  int k = 0;
#pragma unroll
  for (int s = kQ / 2; s; s >>= 1) k += __ldg(a + k + s - 1) <= x ? s : 0;
  return k + (__ldg(a + k) <= x);
}

// #{k : a[k] < x}
__device__ __forceinline__ int count_lt(const float* a, float x) {
  int k = 0;
#pragma unroll
  for (int s = kQ / 2; s; s >>= 1) k += __ldg(a + k + s - 1) < x ? s : 0;
  return k + (__ldg(a + k) < x);
}

// kPacked: K1, one bit a block ORed into (M, out_w) zeroed bytes; else K7,
// one byte a block, (M, cap / kBlock) bytes. kG: query tiles a sweep.
template <bool kPacked, int kG>
__global__ void __launch_bounds__(kThreads)
cull_kernel(const __grid_constant__ Slices S, const Table* __restrict__ tabs,
            uint8_t* __restrict__ out, int C, int M, long long out_w) {
  __shared__ unsigned long long s_any[kWarps][kG];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sh = blockIdx.y;
  const long long cap = S.cap[sh], blk = blockIdx.x;
  if (blk * kBlock >= cap) return;  // CTA-uniform: past this slice's blocks
  const float* __restrict__ mins = S.mins[sh];
  const float* __restrict__ maxs = S.maxs[sh];
  const uint8_t* __restrict__ alive = S.alive[sh];
  const long long f0 = blk * kBlock + (long long)tid * kFiles;
  const uint32_t al = *reinterpret_cast<const uint32_t*>(alive + f0);
  const int tiles = (M + kQ - 1) / kQ;

  for (int g0 = 0; g0 < tiles; g0 += kG) {
    const int ng = min(kG, tiles - g0);
    unsigned long long keep[kG][kFiles];
#pragma unroll
    for (int t = 0; t < kG; ++t) {
      const int nq = M - (g0 + t) * kQ;
      const unsigned long long live =
          t >= ng ? 0ull : (nq >= kQ ? ~0ull : (1ull << nq) - 1ull);
#pragma unroll
      for (int f = 0; f < kFiles; ++f) keep[t][f] = ((al >> (8 * f)) & 0xFFu) ? live : 0ull;
    }
    // column 0's lanes are loaded beside alive, the later ones on demand
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (C > 0) {
      a = __ldcs(reinterpret_cast<const float4*>(mins + f0));
      b = __ldcs(reinterpret_cast<const float4*>(maxs + f0));
    }
    for (int c = 0; c < C; ++c) {
      bool kept[kFiles];
      bool any = false;
#pragma unroll
      for (int f = 0; f < kFiles; ++f) {
        unsigned long long k = 0ull;
#pragma unroll
        for (int t = 0; t < kG; ++t) k |= keep[t][f];
        kept[f] = k != 0ull;
        any |= kept[f];
      }
      if (!__any_sync(0xffffffffu, any)) break;  // warp-uniform
      if (c > 0) {
        a = __ldcs(reinterpret_cast<const float4*>(mins + (long long)c * cap + f0));
        b = __ldcs(reinterpret_cast<const float4*>(maxs + (long long)c * cap + f0));
      }
      float mn[kFiles] = {a.x, a.y, a.z, a.w}, mx[kFiles] = {b.x, b.y, b.z, b.w};
      // the warp's box over the files some query still keeps
      float bmn = INFINITY, bmx = -INFINITY;
#pragma unroll
      for (int f = 0; f < kFiles; ++f) {
        mn[f] = isnan(mn[f]) ? -INFINITY : mn[f];
        mx[f] = isnan(mx[f]) ? INFINITY : mx[f];
        if (kept[f]) {
          bmn = fminf(bmn, mn[f]);
          bmx = fmaxf(bmx, mx[f]);
        }
      }
#pragma unroll
      for (int o = 16; o; o >>= 1) {
        bmn = fminf(bmn, __shfl_xor_sync(0xffffffffu, bmn, o));
        bmx = fmaxf(bmx, __shfl_xor_sync(0xffffffffu, bmx, o));
      }
      // queries that miss the box miss every file in it: every tile's box
      // test first (lane l tests queries l and l + 32 of the tile, two
      // ballots), then the files of a tile where some query still keeps
      // some file of the warp
      const Table* T = tabs + (long long)g0 * C + c;
      unsigned long long box[kG];
#pragma unroll
      for (int t = 0; t < kG; ++t) {
        box[t] = 0ull;
        if (t < ng) {
          const float* lq = T[t * C].lo_q;
          const float* hq = T[t * C].hi_q;
          const unsigned a0 = __ballot_sync(0xffffffffu, (__ldg(lq + lane) <= bmx) &
                                                             (__ldg(hq + lane) >= bmn));
          const unsigned a1 = __ballot_sync(0xffffffffu, (__ldg(lq + lane + 32) <= bmx) &
                                                             (__ldg(hq + lane + 32) >= bmn));
          box[t] = ((unsigned long long)a1 << 32) | a0;
        }
      }
#pragma unroll
      for (int t = 0; t < kG; ++t) {
        bool live = false;
#pragma unroll
        for (int f = 0; f < kFiles; ++f) {
          keep[t][f] &= box[t];
          live |= keep[t][f] != 0ull;
        }
        if (!__any_sync(0xffffffffu, live)) continue;  // warp-uniform
        // the queries some file of the warp still has: few of them are
        // tested directly, more by the two rank searches a file
        unsigned long long cand = 0ull;
#pragma unroll
        for (int f = 0; f < kFiles; ++f) cand |= keep[t][f];
        cand = ((unsigned long long)__reduce_or_sync(0xffffffffu, (unsigned)(cand >> 32)) << 32) |
               __reduce_or_sync(0xffffffffu, (unsigned)cand);
        if (__popcll(cand) <= kDirect) {
          unsigned long long hit[kFiles] = {};
          for (unsigned long long rest = cand; rest; rest &= rest - 1) {
            const int q = __ffsll(rest) - 1;
            const float lq = __ldg(T[t * C].lo_q + q), hq = __ldg(T[t * C].hi_q + q);
#pragma unroll
            for (int f = 0; f < kFiles; ++f)
              hit[f] |= (unsigned long long)((mx[f] >= lq) & (mn[f] <= hq)) << q;
          }
#pragma unroll
          for (int f = 0; f < kFiles; ++f) keep[t][f] &= hit[f];
        } else {
#pragma unroll
          for (int f = 0; f < kFiles; ++f)
            keep[t][f] &= __ldg(T[t * C].lo_pref + count_le(T[t * C].lo, mx[f])) &
                          __ldg(T[t * C].hi_suf + count_lt(T[t * C].hi, mn[f]));
        }
      }
    }

#pragma unroll
    for (int t = 0; t < kG; ++t) {
      unsigned long long v = 0ull;
#pragma unroll
      for (int f = 0; f < kFiles; ++f) v |= keep[t][f];
      const unsigned lo32 = __reduce_or_sync(0xffffffffu, (unsigned)v);
      const unsigned hi32 = __reduce_or_sync(0xffffffffu, (unsigned)(v >> 32));
      if (lane == 0) s_any[warp][t] = ((unsigned long long)hi32 << 32) | lo32;
    }
    __syncthreads();
    if (tid < ng * kQ) {
      const int t = tid / kQ, bit = tid % kQ, q = (g0 + t) * kQ + bit;
      unsigned long long v = 0ull;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v |= s_any[w][t];
      const unsigned on = (unsigned)(v >> bit) & 1u;
      if (q < M) {
        if (kPacked) {
          if (on) {
            const uintptr_t addr = (uintptr_t)(out + (long long)q * out_w + (blk >> 3));
            atomicOr(reinterpret_cast<unsigned*>(addr & ~(uintptr_t)3),
                     (0x80u >> (blk & 7)) << (8 * (addr & 3)));
          }
        } else {
          out[(long long)q * out_w + S.col[sh] + blk] = (uint8_t)on;
        }
      }
    }
    __syncthreads();  // s_any is reused by the next sweep
  }
}

int launch(bool packed, const Slices& S, int n, const float* lo, const float* hi,
           uint8_t* out, int C, int M, long long out_w, void* tables, cudaStream_t s) {
  if (n < 1 || n > kMaxShards || M < 0 || C < 0) return (int)cudaErrorInvalidValue;
  long long most = 0;
  for (int i = 0; i < n; ++i) {
    if (S.cap[i] < 0 || S.cap[i] % kBlock || S.col[i] < 0 ||
        (!packed && S.col[i] + S.cap[i] / kBlock > out_w))
      return (int)cudaErrorInvalidValue;
    if (((uintptr_t)S.mins[i] | (uintptr_t)S.maxs[i]) % 16 || (uintptr_t)S.alive[i] % 4)
      return (int)cudaErrorMisalignedAddress;
    most = S.cap[i] > most ? S.cap[i] : most;
  }
  if ((uintptr_t)out % 4 || (uintptr_t)tables % 16) return (int)cudaErrorMisalignedAddress;
  if (M == 0 || most == 0) return (int)cudaSuccess;
  const int tiles = (M + kQ - 1) / kQ;
  // K1 ORs bits into 32-bit words of its output: the wrapper's buffer holds
  // whole words
  const long long zero_words = packed ? ((long long)M * out_w + 3) / 4 : 0;
  tables_kernel<<<dim3(tiles, C > 0 ? C : 1), kQ, 0, s>>>(lo, hi, M, C, (Table*)tables,
                                                           (uint32_t*)out, zero_words);
  const dim3 grid((unsigned)(most / kBlock), (unsigned)n);
  const Table* T = (const Table*)tables;
  if (packed && tiles == 1)
    cull_kernel<true, 1><<<grid, kThreads, 0, s>>>(S, T, out, C, M, out_w);
  else if (packed)
    cull_kernel<true, kGroup><<<grid, kThreads, 0, s>>>(S, T, out, C, M, out_w);
  else if (tiles == 1)
    cull_kernel<false, 1><<<grid, kThreads, 0, s>>>(S, T, out, C, M, out_w);
  else
    cull_kernel<false, kGroup><<<grid, kThreads, 0, s>>>(S, T, out, C, M, out_w);
  return (int)cudaGetLastError();
}

}  // namespace

// mins/maxs (C, cap) f32 (16-byte aligned), alive (cap,) u8 0/1, lo/hi (M, C)
// f32, out (M, out_w) u8 with out_w = ceil(cap / 1024 / 8) in a buffer of
// whole 32-bit words; all contiguous, cap a multiple of 1024. tables: scratch
// of ceil(M / 64) * max(C, 1) Tables (ops/state_cache.py `_rank_table_bytes`).
extern "C" int dtt_block_cull(const float* mins, const float* maxs, const uint8_t* alive,
                              const float* lo, const float* hi, uint8_t* out, int C,
                              long long cap, int M, int out_w, void* tables, void* stream) {
  if (cap % kBlock || out_w != (int)((cap / kBlock + 7) / 8)) return (int)cudaErrorInvalidValue;
  Slices S{};
  S.mins[0] = mins;
  S.maxs[0] = maxs;
  S.alive[0] = alive;
  S.cap[0] = cap;
  return launch(true, S, 1, lo, hi, out, C, M, out_w, tables, (cudaStream_t)stream);
}

// K7, one device's n shards: lanes (n, 3) pointers (mins, maxs: (C, caps[i])
// f32, alive (caps[i],) u8 0/1, each contiguous, caps[i] a multiple of
// 1024), cols (n,) the output column of each shard's first block; lo/hi
// (M, C) f32 on this device; out (M, out_w) u8, one byte a block; tables as
// dtt_block_cull's.
extern "C" int dtt_block_cull_shards(const void* const* lanes, const long long* caps,
                                     const long long* cols, int n, const float* lo,
                                     const float* hi, uint8_t* out, int C, int M,
                                     long long out_w, void* tables, void* stream) {
  if (n < 1 || n > kMaxShards) return (int)cudaErrorInvalidValue;
  Slices S{};
  for (int i = 0; i < n; ++i) {
    S.mins[i] = (const float*)lanes[3 * i];
    S.maxs[i] = (const float*)lanes[3 * i + 1];
    S.alive[i] = (const uint8_t*)lanes[3 * i + 2];
    S.cap[i] = caps[i];
    S.col[i] = cols[i];
  }
  return launch(false, S, n, lo, hi, out, C, M, out_w, tables, (cudaStream_t)stream);
}

// The page codec: raw Snappy compression (snappy_compress) and
// decompression (snappy_decompress) of a batch of Parquet pages.
//
// Replaces no kernel of the JAX package: it compresses and decompresses its
// pages on the host, in Arrow's C++ (delta_tpu/exec/parquet.py:103-187
// `_compresses_well` and `write_parquet_file`, delta_tpu/log/checkpoints.py
// `pq.write_table(..., compression="snappy")`). The port may import only
// torch, numpy and the standard library, so its host codec is Python; the
// work goes to the card, in the format's own units of independent work: a
// page to decompress, a 64 KiB fragment to compress.
//
// snappy_compress (dtt_snappy_compress). Each page is cut into fragments of
// at most 64 KiB, compressed independently, each with a fresh hash table
// (the layout of Google's compressor, so every offset fits 2 bytes). One
// 256-thread block a fragment, the launch one block for each fragment of
// the batch (a 64 MiB launch set is 1,024 blocks over the card's 132 SMs).
// What bounds it on this card: the greedy parse is one chain (each match is
// taken at or past the end of the last one); a warp that walked every
// position, extending and emitting each match in turn on that chain, took
// 3.1 ms a fragment. The fragment now sits in shared memory (64 KiB) with a
// 2^15-entry uint16 hash table (64 KiB) and is worked in tiles of 4,096
// positions, three passes a tile:
//   (a) candidates: warp 0 hashes 32 positions a step: a position's
//       candidate is the last earlier position of the step with its hash
//       (__match_any_sync), else the table's entry, and the last lane of each
//       hash writes the table, so every position is in the table as the
//       "most recent occurrence" has it, up to collisions. Then every thread
//       verifies the candidates of 16 positions and measures their matches,
//       4 bytes a compare, up to 255 bytes, and a suffix pass packs for
//       each position the first verified match at or after it.
//   (b) the walk: warp 1 takes the chosen matches in order, one shared load
//       a match (the next match from the end of the last); a match of 255
//       bytes or more is extended there, 32 bytes a ballot. Meanwhile warp 0
//       hashes the next tile.
//   (c) the tile's elements (the literal before each match, then the match
//       as copies of at most 64 bytes) are placed by a block scan of their
//       encoded sizes and written at once: tags by a thread an element,
//       literal bytes by a warp a literal past 32 bytes.
// The parse is that of the warp-a-fragment design before it, over a table
// twice as large (its 2^14 entries fitted a warp's 96 KiB): fewer hash
// collisions, so every case page stays within 1.015x of the plain
// compressor's bytes (1.07x on two-bit random bytes before). Output goes to
// the fragment's slot of kFragCap bytes (snappy's bound 32 + n + n/6 for
// n = 64 KiB, rounded up), its size to sizes[f]; the host writes each page's
// varint preamble and joins its fragments, from the one download it needs.
// A fragment now costs the walk's chain (~8,000 matches of store_sales'
// bytes at ~130 cycles) beside the hash steps (2,048, ~430 cycles each, most
// of it __match_any_sync): 0.76 ms, and a batch about one fragment's time
// while it has no more fragments than the card has SMs.
//
// snappy_decompress (dtt_snappy_decompress). One 512-thread block a page
// (a page's elements depend on each other in order; the pages of a batch
// run side by side). What bounds it on this card: finding the elements is
// one chain (an element starts where the one before ends), and a copy may
// read any output byte written before it. A warp that parsed a tag at a
// time, every lane on the same tag, took 72 ms a 1 MiB page of ~260,000
// elements. The input now comes into a 16 KiB ring in shared memory by
// cp.async, the next chunk's while one decodes, and the page is decoded a
// chunk of 4,096 input positions at a time:
//   (a) find the elements in parallel: every lane decodes a candidate
//       element at its position (32 lanes a group, 8 groups a warp, a warp's
//       256 positions a segment). Pointer jumping over the lanes (shuffles,
//       5 rounds) gives where the chain from each position leaves its group,
//       the later groups where it leaves its segment; one thread follows the
//       chain across the 16 segments (a load each); each warp then finds its
//       own members, lane k the k-th element of a group by jumps of 1, 2, 4,
//       8 and 16 (ballots count them), and a warp scan and a scan over the
//       warps give each its index and output position. Every element's
//       checks run at once; the first failing one, in order, sets the page's
//       error word, and the chunk writes nothing.
//   (b) run the elements in batches of 8,192 output bytes: every thread
//       resolves 16 output bytes (a binary search for its element, then a
//       walk): a literal's byte from the input, a copy's from the output
//       ring (the last 64 KiB of output in shared memory; further back, from
//       the page's slot, already written) when its source lies before the
//       batch, else a pointer to the batch's own byte it repeats; pointer
//       jumping over the batch (a 16-bit word a byte, a value once resolved)
//       settles the copies that read the batch in a few rounds, overlapping
//       copies (offset below the length) included: byte j of a copy of
//       offset d at o reads o - d + j % d, before the copy. The batch then
//       goes to the ring and to the slot, coalesced.
// It decodes any raw Snappy stream: copy-4 offsets past the ring read the
// slot, literals of 1-4 length bytes span chunks (their bytes come from the
// ring or from device memory). Each page's output slot comes from the page
// header (uncompressed_page_size) through the table; a page sets its error
// word, and stops, when the preamble disagrees with its slot, a tag or a
// literal runs past its input, a copy's offset is 0 or reaches before the
// page, or the output would pass its slot; nothing is written outside the
// slot. A 1 MiB page of store_sales' bytes now costs 161 chunks of ~30,000
// cycles (2.45 ms): about half in the batches (a byte's source, then ~4
// rounds), a third finding the elements, the rest placing and checking
// them; bytes are in + out.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// the compressor
constexpr int kFrag = 65536;
constexpr int kHashBits = 15;
constexpr int kHashSize = 1 << kHashBits;
constexpr long long kFragCap = 76544;   // >= 32 + 65536 + 65536 / 6, a multiple of 128
constexpr int kCThreads = 256;
constexpr int kTile = 4096;              // positions a tile
constexpr int kPer = kTile / kCThreads;  // a thread's positions in a tile
constexpr int kLenCap = 255;             // match lengths measured in parallel up to this
constexpr int kTileElems = kTile / 4;    // chosen matches start 4 or more bytes apart
constexpr int kElemsPer = kTileElems / kCThreads;
constexpr int kShortLit = 32;            // a literal past this is copied by a warp
constexpr unsigned kNoMatch = 0xffffffffu;

// the decompressor
constexpr int kDThreads = 512;
constexpr int kChunk = 4096;              // input positions a chunk
constexpr int kSpan = kChunk + 64 + 16;   // aligned input a chunk's tags may read
constexpr int kInRing = 16384;            // the input ring: a chunk and the next one
constexpr int kBatch = 8192;              // output bytes resolved at once
constexpr int kBytes = kBatch / kDThreads;
constexpr int kRing = 65536;              // the last output bytes kept in shared memory
constexpr int kMaxElems = kChunk / 2;     // every element takes 2 input bytes or more
constexpr int kWarps = kDThreads / 32;
constexpr int kSeg = kChunk / kWarps;     // a warp's positions in a chunk
constexpr int kGroups = kSeg / 32;
constexpr int kLeave = 0xffff;            // the chain leaves the chunk (or the input ends)
constexpr uint16_t kDone = 0x8000;        // a batch byte's word once its value is known
constexpr int kNoError = 0x7fffffff;

// error words of snappy_decompress (ops/page_codec.py names them)
constexpr int kErrPreamble = 1;   // truncated or too long
constexpr int kErrLength = 2;     // the preamble disagrees with the page's slot
constexpr int kErrTruncated = 3;  // a tag or a literal runs past the input
constexpr int kErrOffset = 4;     // a copy's offset is 0 or before the page
constexpr int kErrOverflow = 5;   // the output would pass the slot
constexpr int kErrShort = 6;      // the input ended before the slot was filled

__device__ __forceinline__ uint32_t hash32(uint32_t w) {
  return (w * 0x1e35a7bdu) >> (32 - kHashBits);
}

// 4 bytes at any offset of a shared buffer, from two aligned words.
__device__ __forceinline__ uint32_t load32s(const uint8_t* buf, int p) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(buf);
  return __funnelshift_r(w[p >> 2], w[(p >> 2) + 1], (p & 3) * 8);
}

// The block's exclusive prefix sum of v; *total gets the sum over the block.
// ws: 33 words of shared memory. Every thread of the block calls it.
template <typename T>
__device__ __forceinline__ T block_scan(T v, T* ws, T* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  T incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) ws[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const T w = lane < nw ? ws[lane] : T(0);
    T wi = w;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const T y = __shfl_up_sync(kFull, wi, d);
      if (lane >= d) wi += y;
    }
    if (lane < nw) ws[lane] = wi - w;
    if (lane == 31) ws[32] = wi;
  }
  __syncthreads();
  const T r = ws[warp] + incl - v;
  *total = ws[32];
  __syncthreads();  // ws is free again
  return r;
}

// -- snappy_compress ---------------------------------------------------------

// A literal's tag and length bytes, for gap bytes (at most 64 KiB).
__device__ __forceinline__ int literal_head(int gap) {
  return gap == 0 ? 0 : (gap - 1 < 60 ? 1 : (gap - 1 < 256 ? 2 : 3));
}

__device__ __forceinline__ void put_literal_head(uint8_t* out, int gap) {
  const int n = gap - 1;
  if (n < 60) {
    out[0] = (uint8_t)(n << 2);
  } else if (n < 256) {
    out[0] = (uint8_t)(60 << 2);
    out[1] = (uint8_t)n;
  } else {
    out[0] = (uint8_t)(61 << 2);
    out[1] = (uint8_t)n;
    out[2] = (uint8_t)(n >> 8);
  }
}

// A copy's bytes, cut as Google's EmitCopy cuts it: 64s while 68 or more
// remain, a 60 past 64, then the rest; 2 bytes below 12 at an offset < 2048.
__device__ __forceinline__ int copy_bytes(int offset, int len) {
  int b = 0;
  while (len >= 68) {
    b += 3;
    len -= 64;
  }
  if (len > 64) {
    b += 3;
    len -= 60;
  }
  return b + ((len < 12 && offset < 2048) ? 2 : 3);
}

__device__ __forceinline__ void put_copy64(uint8_t* out, int& o, int offset, int len) {
  if (len < 12 && offset < 2048) {
    out[o] = (uint8_t)(1 | ((len - 4) << 2) | ((offset >> 8) << 5));
    out[o + 1] = (uint8_t)offset;
    o += 2;
  } else {
    out[o] = (uint8_t)(2 | ((len - 1) << 2));
    out[o + 1] = (uint8_t)offset;
    out[o + 2] = (uint8_t)(offset >> 8);
    o += 3;
  }
}

__device__ __forceinline__ void put_copy(uint8_t* out, int o, int offset, int len) {
  while (len >= 68) {
    put_copy64(out, o, offset, 64);
    len -= 64;
  }
  if (len > 64) {
    put_copy64(out, o, offset, 60);
    len -= 60;
  }
  put_copy64(out, o, offset, len);
}

struct CompressShared {
  uint8_t in[kFrag + 16];
  uint16_t table[kHashSize];
  uint16_t cand[2][kTile];   // a position's candidate, else 0xffff: this tile's and the next's
  uint32_t next[kTile];      // the first verified match at or after a position: end << 8 | length
  uint16_t at[kTileElems];   // the walk's chosen matches: start
  uint16_t len[kTileElems];  //   and length (past 255 once extended)
  int lit_at[kTileElems];    // where a long literal's bytes go
  uint32_t first[kCThreads]; // the first verified match of a thread's positions, then of those after them
  int ws[33];
  int walk[2];               // the walk's chosen count and its cursor
};

// Warp 0's candidates for the positions [base, tend), 32 a step, in order: a
// position's candidate is the last earlier position of the step with its
// hash, else the table's; the last lane of each hash writes the table. The
// 4 bytes of the next step are read ahead; verifying a candidate is left to
// the length pass.
__device__ __forceinline__ void hash_tile(CompressShared& sh, int base, int tend, int n,
                                          uint16_t* cand, int lane) {
  int p = base + lane;
  bool has = p + 4 <= n;
  uint32_t w = has ? load32s(sh.in, p) : 0u;
  for (int b = base; b < tend; b += 32) {
    const int pn = p + 32;
    const bool has_n = pn + 4 <= n;
    const uint32_t w_n = has_n ? load32s(sh.in, pn) : 0u;
    const uint32_t h = hash32(w);
    const unsigned peers = __match_any_sync(kFull, has ? h : (0x80000000u | lane));
    const unsigned below = peers & ((1u << lane) - 1u);
    const int c = below ? b + 31 - __clz(below) : (has ? (int)sh.table[h] : 0);
    __syncwarp();
    if (has && (peers >> lane) == 1u) sh.table[h] = (uint16_t)p;
    __syncwarp();
    if (p < tend) cand[p - base] = has && c < p ? (uint16_t)c : (uint16_t)0xffff;
    p = pn;
    has = has_n;
    w = w_n;
  }
}

__global__ void __launch_bounds__(kCThreads)
compress_kernel(const uint8_t* __restrict__ src, const long long* __restrict__ frags,
                uint8_t* __restrict__ scratch, int32_t* __restrict__ sizes) {
  extern __shared__ __align__(16) uint8_t smem[];
  CompressShared& sh = *reinterpret_cast<CompressShared*>(smem);
  const int f = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long off = frags[2 * f];
  const int n = (int)frags[2 * f + 1];
  const uint8_t* g = src + off;
  for (int i = tid; i < n; i += kCThreads * 8) {  // 8 loads in flight a thread
    uint8_t v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = i + k * kCThreads < n ? g[i + k * kCThreads] : 0;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (i + k * kCThreads < n) sh.in[i + k * kCThreads] = v[k];
  }
  if (tid < 16) sh.in[n + tid] = 0;
  for (int i = tid; i < kHashSize; i += kCThreads) sh.table[i] = 0;
  __syncthreads();
  if (warp == 0 && n >= 4) hash_tile(sh, 0, min(kTile, n), n, sh.cand[0], lane);
  __syncthreads();
  uint8_t* out = scratch + (long long)f * kFragCap;
  // output bytes so far; the end of the last match: where the pending literal
  // starts and the walk goes on (the same in every thread)
  int op = 0, cur = 0;
  for (int base = 0, t = 0; base + 4 <= n; base += kTile, ++t) {
    const int tend = min(base + kTile, n);
    const uint16_t* cand = sh.cand[t & 1];
    // (a) every thread: its positions' verified matches and their lengths
    // (up to kLenCap), and for each the first match at or after it among them
    const int lo = tid * kPer;
    uint32_t nx[kPer];
    uint32_t run = kNoMatch;
#pragma unroll
    for (int k = kPer - 1; k >= 0; --k) {
      const int p = base + lo + k;
      const int c = p < tend ? (int)cand[lo + k] : 0xffff;
      if (c != 0xffff && load32s(sh.in, c) == load32s(sh.in, p)) {
        int L = 4;
        while (L < kLenCap && p + L + 4 <= n && load32s(sh.in, p + L) == load32s(sh.in, c + L))
          L += 4;
        while (L < kLenCap && p + L < n && sh.in[p + L] == sh.in[c + L]) ++L;
        run = ((uint32_t)p << 8) | (uint32_t)min(L, kLenCap);
      }
      nx[k] = run;
    }
    sh.first[tid] = run;
    __syncthreads();
    if (warp == 0) {  // for each thread, the first match of the threads after it
      constexpr int kT = kCThreads / 32;
      uint32_t v[kT];
      uint32_t m = kNoMatch;
#pragma unroll
      for (int k = kT - 1; k >= 0; --k) {
        v[k] = m;
        m = min(m, sh.first[lane * kT + k]);  // a later start packs to a larger word
      }
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) m = min(m, __shfl_down_sync(kFull, m, d));
      uint32_t after = __shfl_down_sync(kFull, m, 1);
      if (lane == 31) after = kNoMatch;
#pragma unroll
      for (int k = 0; k < kT; ++k) sh.first[lane * kT + k] = min(v[k], after);
    }
    __syncthreads();
    {
      const uint32_t later = sh.first[tid];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {  // the walk's word: the match's end, not its start
        const uint32_t w = min(nx[k], later);
        sh.next[lo + k] = w == kNoMatch ? w : w + ((w & 0xffu) << 8);
      }
    }
    __syncthreads();
    const int lit0 = cur;  // the literal before the tile's first chosen match
    if (warp == 1) {
      // (b) warp 1 walks the chosen matches, one shared load a step; lane
      // k % 32 keeps the k-th, stored 32 at a time
      int k = 0, at = max(cur, base), my_m = 0, my_l = 0;
      while (at < tend) {
        const uint32_t w = sh.next[at - base];
        if (w == kNoMatch) break;
        int L = (int)(w & 0xffu);
        const int m = (int)(w >> 8) - L;
        if (L == kLenCap) {  // a long match: on 32 bytes a ballot
          const int c = cand[m - base];
          while (m + L < n) {
            const int q = m + L + lane;
            const bool eq = q < n && sh.in[c + L + lane] == sh.in[q];
            const unsigned e = __ballot_sync(kFull, eq);
            if (e == kFull) {
              L += 32;
              continue;
            }
            L += __ffs(~e) - 1;
            break;
          }
        }
        my_m = lane == (k & 31) ? m : my_m;
        my_l = lane == (k & 31) ? L : my_l;
        if ((k & 31) == 31) {
          sh.at[k - 31 + lane] = (uint16_t)my_m;
          sh.len[k - 31 + lane] = (uint16_t)my_l;
        }
        ++k;
        cur = m + L;
        at = cur;
      }
      if (lane < (k & 31)) {
        sh.at[(k & ~31) + lane] = (uint16_t)my_m;
        sh.len[(k & ~31) + lane] = (uint16_t)my_l;
      }
      if (lane == 0) {
        sh.walk[0] = k;
        sh.walk[1] = cur;
      }
    } else if (warp == 0 && base + kTile + 4 <= n) {
      // meanwhile warp 0 finds the next tile's candidates
      hash_tile(sh, base + kTile, min(base + 2 * kTile, n), n, sh.cand[(t + 1) & 1], lane);
    }
    __syncthreads();
    const int nk = sh.walk[0];
    cur = sh.walk[1];
    if (nk == 0) continue;
    // (c) the tile's elements (the literal before a match, then the match)
    // placed by a block scan; thread t owns elements [t * kElemsPer, + kElemsPer)
    int sz = 0;
#pragma unroll
    for (int k = 0; k < kElemsPer; ++k) {
      const int i = tid * kElemsPer + k;
      if (i < nk) {
        const int m = sh.at[i];
        const int lit = i == 0 ? lit0 : (int)sh.at[i - 1] + (int)sh.len[i - 1];
        const int gap = m - lit;
        sz += literal_head(gap) + gap + copy_bytes(m - (int)cand[m - base], sh.len[i]);
      }
    }
    int total;
    int o = op + block_scan(sz, sh.ws, &total);
#pragma unroll
    for (int k = 0; k < kElemsPer; ++k) {
      const int i = tid * kElemsPer + k;
      if (i < nk) {
        const int m = sh.at[i];
        const int lit = i == 0 ? lit0 : (int)sh.at[i - 1] + (int)sh.len[i - 1];
        const int gap = m - lit;
        const int head = literal_head(gap);
        if (gap) put_literal_head(out + o, gap);
        if (gap > kShortLit) {
          sh.lit_at[i] = o + head;
        } else {
          for (int b = 0; b < gap; ++b) out[o + head + b] = sh.in[lit + b];
        }
        o += head + gap;
        const int offset = m - (int)cand[m - base];
        put_copy(out, o, offset, sh.len[i]);
        o += copy_bytes(offset, sh.len[i]);
      }
    }
    __syncthreads();
    for (int i = warp; i < nk; i += kCThreads / 32) {  // long literals, a warp each
      const int m = sh.at[i];
      const int lit = i == 0 ? lit0 : (int)sh.at[i - 1] + (int)sh.len[i - 1];
      const int gap = m - lit;
      if (gap > kShortLit) {
        const int at = sh.lit_at[i];
        for (int b = lane; b < gap; b += 32) out[at + b] = sh.in[lit + b];
      }
    }
    op += total;
    __syncthreads();
  }
  const int gap = n - cur;  // the last literal
  if (gap > 0) {
    const int head = literal_head(gap);
    if (tid == 0) put_literal_head(out + op, gap);
    for (int b = tid; b < gap; b += kCThreads) out[op + head + b] = sh.in[cur + b];
    op += head + gap;
  }
  if (tid == 0) sizes[f] = op;
}

// -- snappy_decompress -------------------------------------------------------

// The element whose tag is at aligned offset a of the input ring: its input
// bytes (tag, length or offset bytes, a literal's bytes), its output bytes,
// and a literal's head bytes or a copy's offset.
struct Elem {
  long long in_len, out_len, offset;
  int kind, head, extra;
};

// The 5 bytes at aligned offset a of the input ring (a tag and its 4
// following bytes), from two aligned words.
__device__ __forceinline__ unsigned long long tag_bytes(const uint8_t* ring, unsigned a) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(ring);
  constexpr unsigned kWords = kInRing / 4 - 1;
  const unsigned i = a >> 2;
  return (((unsigned long long)w[(i + 1) & kWords] << 32) | w[i & kWords]) >> ((a & 3) * 8);
}

// An element's input bytes from its tag bytes, at most 2^30 (a longer one
// runs past any page).
__device__ __forceinline__ int in_len(unsigned long long v) {
  const unsigned t = (unsigned)v & 0xffu;
  if (t & 3) return (0x5320u >> ((t & 3) * 4)) & 0xfu;  // a copy: 2, 3 or 5
  const unsigned lit = t >> 2;
  if (lit < 60) return (int)lit + 2;
  const int nb = (int)lit - 59;
  const unsigned long long L = (v >> 8) & (nb == 4 ? 0xffffffffull : ((1ull << (8 * nb)) - 1));
  return (int)min(L + 2 + nb, 1ull << 30);
}

__device__ __forceinline__ Elem decode(const uint8_t* ring, unsigned a) {
  const unsigned long long v = tag_bytes(ring, a);
  const unsigned t = (unsigned)v & 0xffu;
  const unsigned long long rest = v >> 8;
  Elem el;
  el.kind = (int)(t & 3);
  el.head = 1;
  el.extra = 0;
  el.offset = 0;
  if (el.kind == 0) {
    unsigned long long lit = t >> 2;
    if (lit >= 60) {
      el.extra = (int)lit - 59;  // 1-4 length bytes
      lit = rest & (el.extra == 4 ? 0xffffffffull : ((1ull << (8 * el.extra)) - 1));
      el.head += el.extra;
    }
    el.out_len = (long long)lit + 1;
    el.in_len = el.head + el.out_len;
  } else if (el.kind == 1) {
    el.extra = 1;
    el.out_len = 4 + ((t >> 2) & 7);
    el.offset = ((t >> 5) << 8) | (rest & 0xff);
    el.in_len = 2;
  } else {
    el.extra = el.kind == 2 ? 2 : 4;
    el.out_len = (t >> 2) + 1;
    el.offset = (long long)(rest & (el.kind == 2 ? 0xffffull : 0xffffffffull));
    el.in_len = 1 + el.extra;
  }
  return el;
}

// A batch byte's word: 2 words of padding after every 16, so the 32 lanes of
// a warp, 16 bytes apart, fall in 32 banks.
__device__ __forceinline__ int pad(int i) { return i + ((i >> 4) << 1); }

struct DecompressShared {
  uint8_t ring[kRing];       // output: the last kRing bytes
  uint8_t inr[kInRing];      // input: 16-byte units by their offset from the aligned base
  uint16_t gx[kChunk];       // where the chain from a position leaves its warp's segment
  uint16_t at[kMaxElems];    // the chain's positions, a warp's segment at a time
  long long from[kMaxElems]; // an element's output start within its warp's segment
  int est[kMaxElems + 1];    // an element's output start (the chunk's end after the last)
  int esr[kMaxElems];        // a literal's input position, or minus a copy's offset
  uint16_t st[kBatch + kBatch / 8];  // a batch byte, at pad(i): kDone | value, or the byte it repeats
  long long ws_out[kWarps];  // a segment's output bytes, then those before it
  int ws_n[kWarps];          // a segment's elements, then those before it
  int entry[kWarps + 1];     // the chain's first position in each segment
  int word[4];               // the preamble's error and length; the chunk's first error; its end
};

__global__ void __launch_bounds__(kDThreads)
decompress_kernel(const uint8_t* __restrict__ src, const long long* __restrict__ pages,
                  uint8_t* __restrict__ out, int32_t* __restrict__ err) {
  extern __shared__ __align__(16) uint8_t smem[];
  DecompressShared& sh = *reinterpret_cast<DecompressShared*>(smem);
  const int page = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long* row = pages + 4 * (long long)page;
  const uint8_t* in = src + row[0];
  // a page's bytes are below 2^31 (the wrapper checks): 32-bit positions
  const int n = (int)row[1];
  uint8_t* dst = out + row[2];
  const int cap = (int)row[3];
  if (tid == 0) {
    int e = 0, pos = 0;
    unsigned len = 0;
    for (int shift = 0;; shift += 7) {
      if (pos >= n || shift > 28) {
        e = kErrPreamble;
        break;
      }
      const unsigned b = in[pos++];
      len |= (b & 0x7fu) << shift;
      if (!(b & 0x80u)) break;
    }
    if (!e && len != (unsigned)cap) e = kErrLength;
    sh.word[0] = e;
    sh.word[1] = pos;
  }
  __syncthreads();
  int e = sh.word[0];
  int s = sh.word[1];  // the chunk's first element
  int op = 0;          // output bytes so far
  // the input in 16-byte units from the aligned address at or below its
  // first byte; offsets below are from that address (byte x at x + delta)
  const unsigned delta = (unsigned)((uintptr_t)in & 15);
  const uint8_t* abase = in - delta;
  const unsigned units = (unsigned)(((long long)delta + n + 15) >> 4);
  unsigned r_lo = 0, r_hi = 0;  // the units in the ring, loaded or in flight
  auto load = [&](unsigned a0, unsigned a1) {
    for (unsigned u = (a0 >> 4) + tid; u < (a1 >> 4) && u < units; u += kDThreads)
      __pipeline_memcpy_async(sh.inr + ((u << 4) & (kInRing - 1)), abase + ((size_t)u << 4), 16);
    __pipeline_commit();
  };
  while (!e && s < n) {
    const unsigned a_s = ((unsigned)s + delta) & ~15u;
    if (a_s < r_lo || a_s + kSpan > r_hi) {  // not prefetched: the first chunk, or past a long literal
      __pipeline_wait_prior(0);
      __syncthreads();
      r_lo = a_s;
      r_hi = a_s + kSpan;
      load(r_lo, r_hi);
    }
    const unsigned ready = r_hi;  // [a_s, ready) is this chunk's
    // the next chunks' input, in flight while this one decodes; it takes the
    // ring's units below a_s - kChunk
    const unsigned ahead = a_s + kInRing - kChunk;
    if (ahead > r_hi) {
      load(r_hi, ahead);
      r_hi = ahead;
      if (r_hi > (unsigned)kInRing) r_lo = max(r_lo, r_hi - kInRing);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    if (tid == 0) sh.word[2] = kNoError;
    __syncthreads();  // every thread's copies of this chunk's units have landed
    const int lim = min(n - s, kChunk);
    const unsigned a0 = (unsigned)s + delta;
    // (a) an element at every position: where the next one would start
    // (kLeave past the chunk or the input). Warp w owns the segment
    // [w * kSeg, + kSeg), in groups of 32 positions, a lane a position.
    const int seg0 = warp * kSeg;
    int nxt[kGroups], gout[kGroups];
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int x = seg0 + g * 32 + lane;
      int j = kLeave;
      if (x < lim) {
        const int nx = x + in_len(tag_bytes(sh.inr, a0 + x));
        if (nx < lim) j = nx;
      }
      nxt[g] = j;
    }
    // where the chain from each position leaves its group: pointer jumping
    // over the lanes (5 rounds pass 16 elements), the groups side by side
#pragma unroll
    for (int g = 0; g < kGroups; ++g) gout[g] = nxt[g];
#pragma unroll
    for (int r = 0; r < 5; ++r) {
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const int gb = seg0 + g * 32;
        const bool in = gout[g] < gb + 32;
        const int q = __shfl_sync(kFull, gout[g], in ? gout[g] - gb : lane);
        if (in) gout[g] = q;
      }
    }
    // ... and its segment, from the later groups' already done
#pragma unroll
    for (int g = kGroups - 1; g >= 0; --g) {
      int p = gout[g];
      if (p < seg0 + kSeg) p = sh.gx[p];
      sh.gx[seg0 + g * 32 + lane] = (uint16_t)p;
      __syncwarp();
    }
    __syncthreads();
    if (tid == 0) {  // the chain's entry into each segment: one load a segment
      int e = 0;
      for (int w = 0; w < kWarps; ++w) {
        sh.entry[w] = e;
        if (e < (w + 1) * kSeg) e = sh.gx[e];
      }
      sh.entry[kWarps] = e;
    }
    __syncthreads();
    // each warp's members of the chain, in order: the entry into each group
    // from the one before (a shuffle a group), then in every group at once
    // lane k finds the k-th element from the entry by jumps of 1, 2, 4, 8, 16
    int cnt = 0;
    {
      int pe[kGroups];
      int p = sh.entry[warp];
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const int gb = seg0 + g * 32;
        pe[g] = p;
        const bool in = p < gb + 32;
        const int q = __shfl_sync(kFull, gout[g], in ? p - gb : lane);
        if (in) p = q;
      }
      int pos[kGroups];
      int jump[kGroups];
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        jump[g] = nxt[g];
        pos[g] = pe[g];
      }
#pragma unroll
      for (int r = 0; r < 5; ++r) {
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          const int gb = seg0 + g * 32;
          const bool in = pos[g] < gb + 32;
          const int q = __shfl_sync(kFull, jump[g], in ? pos[g] - gb : lane);
          if (in && ((lane >> r) & 1)) pos[g] = q;
          if (r < 4) {  // the jumps of 2^(r+1) elements
            const bool jin = jump[g] < gb + 32;
            const int y = __shfl_sync(kFull, jump[g], jin ? jump[g] - gb : lane);
            if (jin) jump[g] = y;
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const bool member = pos[g] < seg0 + g * 32 + 32;
        const unsigned m = __ballot_sync(kFull, member);
        if (member) sh.at[seg0 / 2 + cnt + lane] = (uint16_t)pos[g];
        cnt += __popc(m);
      }
    }
    __syncwarp();
    // each member's output start within the segment: a warp scan
    long long run = 0;
    for (int i0 = 0; i0 < cnt; i0 += 32) {
      const int i = i0 + lane;
      const long long len = i < cnt ? decode(sh.inr, a0 + sh.at[seg0 / 2 + i]).out_len : 0;
      long long incl = len;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const long long y = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += y;
      }
      if (i < cnt) sh.from[seg0 / 2 + i] = run + incl - len;
      run += __shfl_sync(kFull, incl, 31);
    }
    if (lane == 0) {
      sh.ws_n[warp] = cnt;
      sh.ws_out[warp] = run;
    }
    __syncthreads();
    if (tid == 0) {  // the segments' elements and bytes before each
      int nb = 0;
      long long ob = 0;
      for (int w = 0; w < kWarps; ++w) {
        const int c = sh.ws_n[w];
        const long long o = sh.ws_out[w];
        sh.ws_n[w] = nb;
        sh.ws_out[w] = ob;
        nb += c;
        ob += o;
      }
      sh.word[3] = nb;
    }
    __syncthreads();
    const int nel = sh.word[3];
    // every element's checks at once; the first failing one, in order, stops the page
    for (int i = lane; i < cnt; i += 32) {
      const int x = sh.at[seg0 / 2 + i];
      const int idx = sh.ws_n[warp] + i;
      const long long o = op + sh.ws_out[warp] + sh.from[seg0 / 2 + i];
      const Elem el = decode(sh.inr, a0 + x);
      const long long p = (long long)s + x;  // the tag's input position
      int c = 0;
      if (p + 1 + el.extra > n) {
        c = kErrTruncated;
      } else if (el.kind == 0) {
        if (p + el.in_len > n) c = kErrTruncated;
        else if (o + el.out_len > cap) c = kErrOverflow;
      } else if (el.offset == 0 || el.offset > o) {
        c = kErrOffset;
      } else if (o + el.out_len > cap) {
        c = kErrOverflow;
      }
      if (c) {
        atomicMin(&sh.word[2], (idx << 3) | c);
      } else {
        sh.est[idx] = (int)o;
        sh.esr[idx] = el.kind == 0 ? (int)(p + el.head) : -(int)el.offset;
        if (idx == nel - 1) {
          sh.word[1] = (int)(p + el.in_len);
          sh.est[nel] = (int)(o + el.out_len);
        }
      }
    }
    __syncthreads();
    if (sh.word[2] != kNoError) {  // the chunk's first faulty element: the page stops, unwritten
      e = sh.word[2] & 7;
      break;
    }
    const int end = sh.est[nel];
    // (b) the chunk's output, kBatch bytes at a time: a thread resolves 16
    // bytes in a row (their words padded apart: no bank conflicts)
    for (int b0 = op; b0 < end; b0 += kBatch) {
      const int b1 = min(b0 + kBatch, end);
      const int q0 = b0 + tid * kBytes;
      const int q1 = min(q0 + kBytes, b1);
      int pending = 0;
      if (q0 < b1) {
        const int* __restrict__ est = sh.est;
        const int* __restrict__ esr = sh.esr;
        const uint8_t* __restrict__ ring = sh.ring;
        const uint8_t* __restrict__ inr = sh.inr;
        uint16_t* __restrict__ st = sh.st;
        int lo = 0, hi = nel - 1;  // the last element starting at or before q0
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (est[mid] <= q0) lo = mid;
          else hi = mid - 1;
        }
        int k = lo;
        int from = est[k], to = est[k + 1], sr = esr[k];
        for (int q = q0; q < q1; ++q) {
          while (to <= q) {
            ++k;
            from = to;
            to = est[k + 1];
            sr = esr[k];
          }
          const int j = q - from;
          uint16_t w;
          if (sr >= 0) {  // a literal's byte, from the ring while it holds it
            const int x = sr + j;
            const unsigned a = (unsigned)x + delta;
            w = kDone | (a >= a_s && a < ready ? inr[a & (kInRing - 1)] : in[x]);
          } else {  // a copy's: out[from - d + j % d], written before the copy
            const int d = -sr;
            const int sp = from - d + (d >= to - from ? j : j % d);
            if (sp >= b0) {
              w = (uint16_t)(sp - b0);
              pending = 1;
            } else {
              w = kDone | (sp >= b0 - kRing ? ring[sp & (kRing - 1)] : dst[sp]);
            }
          }
          st[pad(q - b0)] = w;
        }
      }
      // a copy that repeats this batch: pointer jumping to a value
      while (__syncthreads_or(pending)) {
        pending = 0;
        uint16_t w[kBytes];  // the thread's words, all loads in flight at once
#pragma unroll
        for (int i = 0; i < kBytes; ++i) w[i] = q0 + i < q1 ? sh.st[pad(q0 - b0 + i)] : kDone;
#pragma unroll
        for (int i = 0; i < kBytes; ++i) {
          if (!(w[i] & kDone)) {
            w[i] = sh.st[pad(w[i])];
            sh.st[pad(q0 - b0 + i)] = w[i];
            pending |= !(w[i] & kDone);
          }
        }
      }
      for (int i = tid; i < b1 - b0; i += kDThreads) {
        const uint8_t v = (uint8_t)sh.st[pad(i)];
        sh.ring[(b0 + i) & (kRing - 1)] = v;
        dst[b0 + i] = v;
      }
      __syncthreads();
    }
    op = end;
    s = sh.word[1];
    __syncthreads();
  }
  __pipeline_wait_prior(0);
  if (!e && op != cap) e = kErrShort;
  if (tid == 0) err[page] = e;
}

}  // namespace

// src: the batch's pages one after another on the card; frags: (nfrag, 2)
// int64 (offset in src, length <= 65536); scratch: nfrag * 76544 bytes;
// sizes: (nfrag,) int32, each fragment's compressed bytes. One block a
// fragment.
extern "C" int dtt_snappy_compress(const uint8_t* src, const long long* frags, int nfrag,
                                   uint8_t* scratch, int32_t* sizes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nfrag <= 0) return (int)cudaGetLastError();
  const int smem = (int)sizeof(CompressShared);
  cudaError_t err = cudaFuncSetAttribute(compress_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  compress_kernel<<<nfrag, kCThreads, smem, s>>>(src, frags, scratch, sizes);
  return (int)cudaGetLastError();
}

// src: the compressed bodies on the card, read in aligned 16-byte units (a
// page's first and last unit may reach up to 15 bytes past its body, inside
// the allocation); pages: (npages, 4) int64 (input offset, input length,
// output offset, output length); out: the output slots; err: (npages,)
// int32, 0 where the page decoded into its slot. One block a page.
extern "C" int dtt_snappy_decompress(const uint8_t* src, const long long* pages, int npages,
                                     uint8_t* out, int32_t* err, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (npages <= 0) return (int)cudaGetLastError();
  const int smem = (int)sizeof(DecompressShared);
  cudaError_t e = cudaFuncSetAttribute(decompress_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  decompress_kernel<<<npages, kDThreads, smem, s>>>(src, pages, out, err);
  return (int)cudaGetLastError();
}

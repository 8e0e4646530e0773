// The page codec: raw Snappy compression (snappy_compress) and
// decompression (snappy_decompress) of a batch of Parquet pages.
//
// Replaces no kernel of the JAX package: it compresses and decompresses its
// pages on the host, in Arrow's C++ (delta_tpu/exec/parquet.py:103-187
// `_compresses_well` and `write_parquet_file`, delta_tpu/log/checkpoints.py
// `pq.write_table(..., compression="snappy")`). The port may import only
// torch, numpy and the standard library, so its host codec is Python; the
// work goes to the card, in the format's own units of independent work.
//
// snappy_compress (dtt_snappy_compress). Each page is cut into fragments of
// at most 64 KiB, compressed independently, each with a fresh hash table
// (the layout of Google's compressor, so every offset fits 2 bytes). One
// warp a fragment: the warp copies the fragment and clears a 2^14-entry
// uint16 hash table in shared memory (64 + 32 KiB), then walks it 32
// positions a step: each lane hashes the 4 bytes at its position; its
// candidate is the last earlier lane of the step with the same hash
// (__match_any_sync), else the table's entry; the last lane of each hash
// writes the table. So every position is in the table, as the plain
// compressor's "most recent occurrence" has it, up to hash collisions. The
// greedy parse then takes, in order, each verified match at or past the end
// of the last one: the warp extends it 32 bytes a step by a ballot and
// copies the literal before it out. Output goes to the fragment's slot of
// kFragCap bytes (snappy's bound 32 + n + n/6 for n = 64 KiB, rounded up),
// its size to sizes[f]; the host writes each page's varint preamble and
// joins its fragments, from the one download it needs. What bounds it: the
// per-step chain (two shared loads, a match, a table write) and a match's
// emission; a batch takes about one fragment's walk while it has no more
// fragments than the card holds CTAs of 96 KiB (2 an SM). Bytes are ~2x the
// input.
//
// snappy_decompress (dtt_snappy_decompress). One warp a page. The page's
// input goes through an 8 KiB window in shared memory and its last 64 KiB
// of output stay in a ring there, so a tag's bytes and a copy's source are
// shared-memory loads; every lane parses the same tag (uniform control
// flow), a literal is copied by the warp from the window, a copy too: byte
// j of a copy of offset d at output position o is out[o - d + j % d],
// already written, so an overlapping copy (d below its length) needs no
// rounds. Output is written to the ring only, and copied out to the page's
// slot 32 KiB at a time (coalesced), so an element costs shared-memory
// work alone; a copy from further back than the ring keeps safely (a
// 4-byte offset) reads the page's slot, already flushed.
// Each page's output slot comes from the page header
// (uncompressed_page_size) through the table; a page sets its error word,
// and stops, when the preamble disagrees with its slot, a tag or a literal
// runs past its input, a copy's offset is 0 or reaches before the page, or
// the output would pass its slot: nothing is written outside it. What
// bounds it: the serial tag parse of a page (a few shared loads a tag);
// bytes are in + out.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFrag = 65536;
constexpr int kHashBits = 14;
constexpr int kHashSize = 1 << kHashBits;
constexpr long long kFragCap = 76544;  // >= 32 + 65536 + 65536 / 6, a multiple of 128
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRing = 65536;   // the decompressor's window of output
constexpr int kInBuf = 8192;   // the decompressor's window of input
constexpr int kPiece = 4096;   // a literal's bytes are copied this many at a time
constexpr int kFlush = 32768;  // output bytes the decompressor copies out at once

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

// Lane 0 writes the tag bytes; every lane advances op alike.
__device__ __forceinline__ void emit_literal(const uint8_t* in, int from, int to, uint8_t* out,
                                             int& op, int lane) {
  const int len = to - from;
  if (len <= 0) return;
  const int n = len - 1;
  if (n < 60) {
    if (lane == 0) out[op] = (uint8_t)(n << 2);
    op += 1;
  } else {
    const int nb = n < 256 ? 1 : (n < 65536 ? 2 : 3);
    if (lane == 0) {
      out[op] = (uint8_t)((59 + nb) << 2);
      for (int b = 0; b < nb; ++b) out[op + 1 + b] = (uint8_t)(n >> (8 * b));
    }
    op += 1 + nb;
  }
  for (int i = lane; i < len; i += 32) out[op + i] = in[from + i];
  op += len;
}

__device__ __forceinline__ void emit_copy64(int offset, int len, uint8_t* out, int& op,
                                            int lane) {
  if (len < 12 && offset < 2048) {
    if (lane == 0) {
      out[op] = (uint8_t)(1 | ((len - 4) << 2) | ((offset >> 8) << 5));
      out[op + 1] = (uint8_t)offset;
    }
    op += 2;
  } else {
    if (lane == 0) {
      out[op] = (uint8_t)(2 | ((len - 1) << 2));
      out[op + 1] = (uint8_t)offset;
      out[op + 2] = (uint8_t)(offset >> 8);
    }
    op += 3;
  }
}

__device__ __forceinline__ void emit_copy(int offset, int len, uint8_t* out, int& op, int lane) {
  while (len >= 68) {
    emit_copy64(offset, 64, out, op, lane);
    len -= 64;
  }
  if (len > 64) {
    emit_copy64(offset, 60, out, op, lane);
    len -= 60;
  }
  emit_copy64(offset, len, out, op, lane);
}

// 4 bytes at any offset of a shared buffer, from two aligned words.
__device__ __forceinline__ uint32_t load32s(const uint8_t* buf, int p) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(buf);
  return __funnelshift_r(w[p >> 2], w[(p >> 2) + 1], (p & 3) * 8);
}

__global__ void __launch_bounds__(32)
compress_kernel(const uint8_t* __restrict__ src, const long long* __restrict__ frags,
                uint8_t* __restrict__ scratch, int32_t* __restrict__ sizes) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* in = smem;
  uint16_t* table = reinterpret_cast<uint16_t*>(smem + kFrag + 16);
  const int f = blockIdx.x;
  const int lane = threadIdx.x;
  const long long off = frags[2 * f];
  const int n = (int)frags[2 * f + 1];
  const uint8_t* g = src + off;
  for (int i = lane; i < n; i += 32) in[i] = g[i];
  for (int i = lane; i < kHashSize; i += 32) table[i] = 0;
  __syncwarp();
  uint8_t* out = scratch + (long long)f * kFragCap;
  int op = 0, lit = 0, cur = 0;
  // 32 positions a step: each lane hashes its own; its candidate is the
  // last earlier position of the step with its hash (__match_any_sync), or
  // the table's; the last lane of each hash writes the table. Then the
  // greedy parse takes, in order, the verified matches at or past `cur`.
  for (int base = 0; base + 4 <= n; base += 32) {
    const int p = base + lane;
    const bool has = p + 4 <= n;
    const uint32_t w = has ? load32s(in, p) : 0u;
    const uint32_t h = hash32(w);
    const unsigned peers = __match_any_sync(kFull, has ? h : (0x80000000u | lane));
    const unsigned below = peers & ((1u << lane) - 1u);
    const int cand = below ? base + 31 - __clz(below) : (has ? (int)table[h] : 0);
    __syncwarp();
    if (has && (peers >> lane) == 1u) table[h] = (uint16_t)p;
    __syncwarp();
    const bool ok = has && cand < p && load32s(in, cand) == w;
    unsigned m = __ballot_sync(kFull, ok && p >= cur);
    while (m) {
      const int j = __ffs(m) - 1;
      const int mp = base + j;
      const int mc = __shfl_sync(kFull, cand, j);
      emit_literal(in, lit, mp, out, op, lane);
      int len = 4;
      while (mp + len < n) {
        const int k = mp + len + lane;
        const bool eq = k < n && in[mc + len + lane] == in[k];
        const unsigned e = __ballot_sync(kFull, eq);
        if (e == kFull) {
          len += 32;
          continue;
        }
        len += __ffs(~e) - 1;
        break;
      }
      emit_copy(mp - mc, len, out, op, lane);
      cur = mp + len;
      lit = cur;
      m = __ballot_sync(kFull, ok && p >= cur);
    }
  }
  emit_literal(in, lit, n, out, op, lane);
  if (lane == 0) sizes[f] = op;
}

__global__ void __launch_bounds__(32)
decompress_kernel(const uint8_t* __restrict__ src, const long long* __restrict__ pages,
                  uint8_t* __restrict__ out, int32_t* __restrict__ err) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ring = smem;           // the last kRing bytes of output
  uint8_t* ibuf = smem + kRing;   // the input from `base` on
  const int page = blockIdx.x;
  const int lane = threadIdx.x;
  const long long* row = pages + 4 * (long long)page;
  const uint8_t* in = src + row[0];
  // a page's bytes are below 2^31 (the wrapper checks): 32-bit positions
  const int n = (int)row[1];
  uint8_t* dst = out + row[2];
  const int cap = (int)row[3];
  int base = 0;
  for (int i = lane; i < kInBuf && i < n; i += 32) ibuf[i] = in[i];
  __syncwarp();
  // the window holds the input [base, base + kInBuf): move it to `at`
  auto refill = [&](int at) {
    __syncwarp();
    for (int i = lane; i < kInBuf && at + i < n; i += 32) ibuf[i] = in[at + i];
    base = at;
    __syncwarp();
  };
  // output goes to the ring; [flushed, op) is copied to the page's slot
  // once it reaches kFlush bytes, long before the ring wraps onto it
  int flushed = 0;
  auto flush = [&](int upto) {
    __syncwarp();
    for (int i = flushed + lane; i < upto; i += 32) dst[i] = ring[i & (kRing - 1)];
    flushed = upto;
    __syncwarp();
  };
  int e = 0, pos = 0, op = 0;
  unsigned len = 0;
  for (int shift = 0;; shift += 7) {
    if (pos >= n || shift > 28) {
      e = kErrPreamble;
      break;
    }
    const unsigned b = ibuf[pos++];
    len |= (b & 0x7fu) << shift;
    if (!(b & 0x80u)) break;
  }
  if (!e && len != (unsigned)cap) e = kErrLength;
  while (!e && pos < n) {
    if (pos + 5 > base + kInBuf) refill(pos);  // the tag and its length bytes
    const uint8_t* t = ibuf + (pos - base);
    const unsigned tag = t[0];
    const int kind = tag & 3;
    if (kind == 0) {
      unsigned lit = tag >> 2;
      int head = 1;
      if (lit >= 60) {
        const int nb = (int)lit - 59;
        if (pos + 1 + nb > n) {
          e = kErrTruncated;
          break;
        }
        lit = 0;
        for (int b = 0; b < nb; ++b) lit |= (unsigned)t[1 + b] << (8 * b);
        head += nb;
      }
      pos += head;
      const long long ln = (long long)lit + 1;
      if (pos + ln > n) {
        e = kErrTruncated;
        break;
      }
      if (op + ln > cap) {
        e = kErrOverflow;
        break;
      }
      const int L = (int)ln;
      for (int q = 0; q < L; q += kPiece) {
        const int piece = min(kPiece, L - q);
        const int at = pos + q;
        if (at + piece > base + kInBuf) refill(at);
        for (int i = lane; i < piece; i += 32)
          ring[(op + i) & (kRing - 1)] = ibuf[at - base + i];
        op += piece;
        if (op - flushed >= kFlush) flush(op);
      }
      pos += L;
    } else {
      int clen, offset;
      const int extra = kind == 1 ? 1 : (kind == 2 ? 2 : 4);
      if (pos + 1 + extra > n) {
        e = kErrTruncated;
        break;
      }
      if (kind == 1) {
        clen = 4 + ((tag >> 2) & 7);
        offset = (int)(((tag >> 5) << 8) | t[1]);
      } else if (kind == 2) {
        clen = (tag >> 2) + 1;
        offset = (int)(t[1] | ((unsigned)t[2] << 8));
      } else {
        clen = (tag >> 2) + 1;
        const unsigned o = t[1] | ((unsigned)t[2] << 8) | ((unsigned)t[3] << 16) |
                           ((unsigned)t[4] << 24);
        offset = o > (unsigned)op ? -1 : (int)o;
      }
      pos += 1 + extra;
      if (offset <= 0 || offset > op) {
        e = kErrOffset;
        break;
      }
      if (op + clen > cap) {
        e = kErrOverflow;
        break;
      }
      // byte j is out[op - offset + j % offset], written before this copy
      for (int j = lane; j < clen; j += 32) {
        uint8_t v;
        if (offset <= kRing - 64) {
          // from the ring: a copy's reads and writes (64 bytes at most)
          // never share a slot
          v = ring[(op - offset + (offset >= clen ? j : j % offset)) & (kRing - 1)];
        } else {
          // further back than the ring keeps safely: from the slot, flushed
          v = dst[op - offset + j];
        }
        ring[(op + j) & (kRing - 1)] = v;
      }
      op += clen;
      if (op - flushed >= kFlush) flush(op);
    }
    __syncwarp();  // this element's bytes are visible to every lane's next copy
  }
  if (!e && op != cap) e = kErrShort;
  if (!e) flush(op);
  if (lane == 0) err[page] = e;
}

}  // namespace

// src: the batch's pages one after another on the card; frags: (nfrag, 2)
// int64 (offset in src, length <= 65536); scratch: nfrag * 76544 bytes;
// sizes: (nfrag,) int32, each fragment's compressed bytes.
extern "C" int dtt_snappy_compress(const uint8_t* src, const long long* frags, int nfrag,
                                   uint8_t* scratch, int32_t* sizes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nfrag <= 0) return (int)cudaGetLastError();
  const int smem = kFrag + 16 + kHashSize * (int)sizeof(uint16_t);
  cudaError_t err = cudaFuncSetAttribute(compress_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  compress_kernel<<<nfrag, 32, smem, s>>>(src, frags, scratch, sizes);
  return (int)cudaGetLastError();
}

// src: the compressed bodies on the card; pages: (npages, 4) int64 (input
// offset, input length, output offset, output length); out: the output
// slots; err: (npages,) int32, 0 where the page decoded into its slot.
extern "C" int dtt_snappy_decompress(const uint8_t* src, const long long* pages, int npages,
                                     uint8_t* out, int32_t* err, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (npages <= 0) return (int)cudaGetLastError();
  const int smem = kRing + kInBuf;
  cudaError_t e = cudaFuncSetAttribute(decompress_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  decompress_kernel<<<npages, 32, smem, s>>>(src, pages, out, err);
  return (int)cudaGetLastError();
}

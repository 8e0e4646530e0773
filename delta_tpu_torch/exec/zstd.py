"""Zstandard decompression (RFC 8878 frames; Parquet's ZSTD codec, number 6).

The JAX package writes ZSTD pages under ``delta.tpu.write.compression=zstd``
(``pyarrow``), so the port's reader needs the codec. Python has no zstd
module and the port depends on no package for it, so this is a decoder of
its own, in the standard library: correct first, not fast.

What it covers (RFC 8878 section numbers):

* frames (3.1.1): the header (single segment or a window, the content
  size, the content checksum, verified with the port's own XXH64), several
  frames back to back, and skippable frames (3.1.2), which are skipped;
* blocks (3.1.1.2): Raw, RLE and Compressed;
* the literals section (3.1.1.3.1): Raw, RLE, Huffman-compressed with one
  or four streams, and Treeless (the previous block's Huffman table), the
  Huffman tree written directly or with FSE-compressed weights (4.2.1);
* the sequences section (3.1.1.3.2): literal length, match length and
  offset codes each in Predefined, RLE, FSE-compressed (4.1.1) or Repeat
  mode, and the three repeat offsets (3.1.1.5).

A frame that names a dictionary raises :class:`ZstdError` (Parquet pages
never use one). Every malformed input raises :class:`ZstdError`, a
``ValueError``.

``decompress(data, trace=set())`` adds to ``trace`` the name of every
format feature the input used (``"block.rle"``, ``"literals.huffman4"``,
``"seq.ll.repeat"``, ``"offset.repeat3"``, ...), so tests can show that a
corpus reaches each path.
"""
from __future__ import annotations

import struct
from typing import List, Optional, Set, Tuple

__all__ = ["decompress", "xxh64", "ZstdError"]

_MAGIC = 0xFD2FB528
_SKIPPABLE_MASK = 0xFFFFFFF0
_SKIPPABLE = 0x184D2A50
_BLOCK_MAX = 1 << 17


class ZstdError(ValueError):
    """The bytes are not a well-formed Zstandard frame sequence."""


# -- XXH64 --------------------------------------------------------------------------

_M64 = (1 << 64) - 1
_P1 = 0x9E3779B185EBCA87
_P2 = 0xC2B2AE3D27D4EB4F
_P3 = 0x165667B19E3779F9
_P4 = 0x85EBCA77C2B2AE63
_P5 = 0x27D4EB2F165667C5


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * _P2) & _M64
    return (_rotl(acc, 31) * _P1) & _M64


def xxh64(data, seed: int = 0) -> int:
    """XXH64 of ``data`` (Cyan4973/xxHash ``doc/xxhash_spec.md``)."""
    data = bytes(data)
    n = len(data)
    p = 0
    if n >= 32:
        v1 = (seed + _P1 + _P2) & _M64
        v2 = (seed + _P2) & _M64
        v3 = seed & _M64
        v4 = (seed - _P1) & _M64
        stripes = n // 32
        lanes = struct.unpack_from(f"<{stripes * 4}Q", data, 0)
        for i in range(0, stripes * 4, 4):
            v1 = _rotl((v1 + lanes[i] * _P2) & _M64, 31) * _P1 & _M64
            v2 = _rotl((v2 + lanes[i + 1] * _P2) & _M64, 31) * _P1 & _M64
            v3 = _rotl((v3 + lanes[i + 2] * _P2) & _M64, 31) * _P1 & _M64
            v4 = _rotl((v4 + lanes[i + 3] * _P2) & _M64, 31) * _P1 & _M64
        p = stripes * 32
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M64
        for v in (v1, v2, v3, v4):
            h = ((h ^ _round(0, v)) * _P1 + _P4) & _M64
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while p + 8 <= n:
        (k,) = struct.unpack_from("<Q", data, p)
        h = (_rotl(h ^ _round(0, k), 27) * _P1 + _P4) & _M64
        p += 8
    if p + 4 <= n:
        (k,) = struct.unpack_from("<I", data, p)
        h = (_rotl(h ^ (k * _P1 & _M64), 23) * _P2 + _P3) & _M64
        p += 4
    while p < n:
        h = (_rotl(h ^ (data[p] * _P5 & _M64), 11) * _P1) & _M64
        p += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    h ^= h >> 32
    return h


# -- bit readers --------------------------------------------------------------------


class _Backward:
    """A backward bitstream (FSE and Huffman streams, RFC 8878 4.1): read
    from the end, the highest set bit of the last byte marks the start.
    Reading past the beginning yields zero bits and is counted, so the
    caller can tell an exact end from an over-read."""

    __slots__ = ("data", "start", "pos", "acc", "n", "pad")

    def __init__(self, data, start: int, end: int):
        if end <= start:
            raise ZstdError("empty bitstream")
        last = data[end - 1]
        if last == 0:
            raise ZstdError("bitstream without its end marker")
        hb = last.bit_length() - 1
        self.data = data
        self.start = start
        self.pos = end - 1
        self.acc = last & ((1 << hb) - 1)
        self.n = hb
        self.pad = 0

    def _refill(self, k: int) -> None:
        take = min(7, self.pos - self.start)
        if take:
            self.acc = ((self.acc & ((1 << self.n) - 1)) << (8 * take)) | int.from_bytes(
                self.data[self.pos - take:self.pos], "little")
            self.n += 8 * take
            self.pos -= take
        if self.n < k:
            self.acc <<= k - self.n
            self.pad += k - self.n
            self.n = k

    def read(self, k: int) -> int:
        if k == 0:
            return 0
        if self.n < k:
            self._refill(k)
        self.n -= k
        return (self.acc >> self.n) & ((1 << k) - 1)

    def remaining(self) -> int:
        """Bits left to read; negative after an over-read."""
        return self.n + 8 * (self.pos - self.start) - self.pad


# -- FSE ----------------------------------------------------------------------------


def _read_ncount(data, start: int, end: int, max_symbol: int,
                 max_log: int) -> Tuple[int, List[int], int]:
    """An FSE table description (RFC 8878 4.1.1): (accuracy log, normalized
    counts with -1 for "less than 1", the position after it)."""
    bp = start * 8
    limit = end * 8

    def peek(k: int) -> int:
        b = bp >> 3
        return (int.from_bytes(data[b:b + 4], "little") >> (bp & 7)) & ((1 << k) - 1)

    if bp + 4 > limit:
        raise ZstdError("truncated FSE table description")
    log = peek(4) + 5
    bp += 4
    if log > max_log:
        raise ZstdError(f"FSE accuracy log {log} above {max_log}")
    remaining = (1 << log) + 1
    threshold = 1 << log
    nbits = log + 1
    counts: List[int] = []
    prev0 = False
    while remaining > 1:
        if prev0:
            while True:
                r = peek(2)
                bp += 2
                counts.extend([0] * r)
                if r != 3:
                    break
            if len(counts) > max_symbol:
                raise ZstdError("FSE table description past the last symbol")
        top = (2 * threshold - 1) - remaining
        v = peek(nbits)
        low = v & (threshold - 1)
        if low < top:
            count = low
            bp += nbits - 1
        else:
            count = v & (2 * threshold - 1)
            if count >= threshold:
                count -= top
            bp += nbits
        count -= 1
        remaining -= -count if count < 0 else count
        counts.append(count)
        if len(counts) > max_symbol + 1:
            raise ZstdError("FSE table description past the last symbol")
        prev0 = count == 0
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1 or bp > limit:
        raise ZstdError("corrupt FSE table description")
    return log, counts, (bp + 7) >> 3


def _fse_table(counts: List[int], log: int):
    """The decoding table of a normalized distribution (RFC 8878 4.1.1):
    (symbol, bits to read, state base) per state."""
    size = 1 << log
    sym = [0] * size
    high = size - 1
    nxt = [0] * len(counts)
    for s, c in enumerate(counts):
        if c == -1:
            sym[high] = s
            high -= 1
            nxt[s] = 1
        else:
            nxt[s] = c
    step = (size >> 1) + (size >> 3) + 3
    mask = size - 1
    p = 0
    for s, c in enumerate(counts):
        for _ in range(c):
            sym[p] = s
            p = (p + step) & mask
            while p > high:
                p = (p + step) & mask
    if p != 0:
        raise ZstdError("FSE distribution does not fill its table")
    nb = [0] * size
    base = [0] * size
    for u in range(size):
        s = sym[u]
        x = nxt[s]
        nxt[s] = x + 1
        b = log - (x.bit_length() - 1)
        nb[u] = b
        base[u] = (x << b) - size
    return sym, nb, base, log


def _rle_table(symbol: int):
    return [symbol], [0], [0], 0


_LL_DEFAULT = [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
               2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1]
_ML_DEFAULT = [1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
               1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1,
               -1, -1, -1, -1, -1]
_OF_DEFAULT = [1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
               -1, -1, -1, -1, -1]
_PREDEFINED = {"ll": (_LL_DEFAULT, 6), "of": (_OF_DEFAULT, 5), "ml": (_ML_DEFAULT, 6)}
_MAX_SYMBOL = {"ll": 35, "of": 31, "ml": 52}
_MAX_LOG = {"ll": 9, "of": 8, "ml": 9}
_predefined_tables: dict = {}

# literal length and match length codes: (baseline, extra bits) (RFC 8878 3.1.1.3.2.1.1)
_LL_CODES = [(i, 0) for i in range(16)] + [
    (16, 1), (18, 1), (20, 1), (22, 1), (24, 2), (28, 2), (32, 3), (40, 3), (48, 4),
    (64, 6), (128, 7), (256, 8), (512, 9), (1024, 10), (2048, 11), (4096, 12),
    (8192, 13), (16384, 14), (32768, 15), (65536, 16)]
_ML_CODES = [(i + 3, 0) for i in range(32)] + [
    (35, 1), (37, 1), (39, 1), (41, 1), (43, 2), (47, 2), (51, 3), (59, 3), (67, 4),
    (83, 4), (99, 5), (131, 7), (259, 8), (515, 9), (1027, 10), (2051, 11), (4099, 12),
    (8195, 13), (16387, 14), (32771, 15), (65539, 16)]


def _predefined(kind: str):
    t = _predefined_tables.get(kind)
    if t is None:
        counts, log = _PREDEFINED[kind]
        t = _predefined_tables[kind] = _fse_table(counts, log)
    return t


# -- Huffman ------------------------------------------------------------------------


def _huffman_weights_fse(data, start: int, end: int) -> List[int]:
    """Huffman weights compressed with FSE (RFC 8878 4.2.1.2): two
    interleaved states over one distribution, until the stream is spent."""
    log, counts, pos = _read_ncount(data, start, end, 255, 6)
    sym, nb, base, _ = _fse_table(counts, log)
    br = _Backward(data, pos, end)
    s1 = br.read(log)
    s2 = br.read(log)
    out: List[int] = []
    while True:
        out.append(sym[s1])
        s1 = base[s1] + br.read(nb[s1])
        if br.remaining() < 0:
            out.append(sym[s2])
            break
        out.append(sym[s2])
        s2 = base[s2] + br.read(nb[s2])
        if br.remaining() < 0:
            out.append(sym[s1])
            break
        if len(out) > 255:
            raise ZstdError("too many Huffman weights")
    return out


def _huffman_table(data, pos: int, end: int):
    """A Huffman tree description (RFC 8878 4.2.1): ((symbol, bits) per
    index of ``max_bits`` bits, max_bits), and the position after it."""
    if pos >= end:
        raise ZstdError("truncated Huffman tree description")
    h = data[pos]
    pos += 1
    if h >= 128:
        nw = h - 127
        nbytes = (nw + 1) // 2
        if pos + nbytes > end:
            raise ZstdError("truncated Huffman weights")
        weights = [(data[pos + i // 2] >> 4) if i % 2 == 0 else (data[pos + i // 2] & 15)
                   for i in range(nw)]
        pos += nbytes
    else:
        if pos + h > end:
            raise ZstdError("truncated Huffman weights")
        weights = _huffman_weights_fse(data, pos, pos + h)
        pos += h
    if any(w > 11 for w in weights):
        raise ZstdError("Huffman weight above 11")
    total = sum(1 << (w - 1) for w in weights if w)
    if total == 0:
        raise ZstdError("Huffman tree of no symbol")
    max_bits = total.bit_length()
    rest = (1 << max_bits) - total
    if rest & (rest - 1) or max_bits > 11:
        raise ZstdError("Huffman weights do not complete a tree")
    weights.append(rest.bit_length())
    if len(weights) > 256:
        raise ZstdError("more than 256 Huffman symbols")
    size = 1 << max_bits
    sym = bytearray(size)
    bits = bytearray(size)
    p = 0
    for w in range(1, max_bits + 1):
        span = 1 << (w - 1)
        for s, ws in enumerate(weights):
            if ws == w:
                sym[p:p + span] = bytes((s,)) * span
                bits[p:p + span] = bytes((max_bits + 1 - w,)) * span
                p += span
    if p != size:
        raise ZstdError("Huffman table does not fill")
    return (sym, bits, max_bits), pos


def _huffman_stream(data, start: int, end: int, count: int, table) -> bytes:
    """``count`` symbols of one Huffman stream, which must end exactly."""
    sym, bits, max_bits = table
    if end <= start:
        raise ZstdError("empty Huffman stream")
    last = data[end - 1]
    if last == 0:
        raise ZstdError("Huffman stream without its end marker")
    hb = last.bit_length() - 1
    acc = last & ((1 << hb) - 1)
    n = hb
    pos = end - 1
    pad = 0
    mask = (1 << max_bits) - 1
    out = bytearray(count)
    for i in range(count):
        if n < max_bits:
            take = min(7, pos - start)
            if take:
                acc = ((acc & ((1 << n) - 1)) << (8 * take)) | int.from_bytes(
                    data[pos - take:pos], "little")
                n += 8 * take
                pos -= take
            if n < max_bits:
                acc <<= max_bits - n
                pad += max_bits - n
                n = max_bits
        idx = (acc >> (n - max_bits)) & mask
        out[i] = sym[idx]
        n -= bits[idx]
    if n + 8 * (pos - start) - pad != 0:
        raise ZstdError("Huffman stream does not end with its last symbol")
    return bytes(out)


# -- blocks -------------------------------------------------------------------------


class _FrameState:
    __slots__ = ("huffman", "tables", "reps", "trace")

    def __init__(self, trace: Optional[Set[str]]):
        self.huffman = None
        self.tables = {"ll": None, "of": None, "ml": None}
        self.reps = [1, 4, 8]
        self.trace = trace

    def saw(self, what: str) -> None:
        if self.trace is not None:
            self.trace.add(what)


def _literals(data, pos: int, end: int, st: _FrameState) -> Tuple[bytes, int]:
    """The literals section (RFC 8878 3.1.1.3.1): (literals, position after)."""
    if pos >= end:
        raise ZstdError("truncated literals section")
    b0 = data[pos]
    kind = b0 & 3
    fmt = (b0 >> 2) & 3
    if kind in (0, 1):
        if fmt in (0, 2):
            size, pos = b0 >> 3, pos + 1
        elif fmt == 1:
            size, pos = (b0 >> 4) + (data[pos + 1] << 4), pos + 2
        else:
            size = (b0 >> 4) + (data[pos + 1] << 4) + (data[pos + 2] << 12)
            pos += 3
        if kind == 0:
            st.saw("literals.raw")
            if pos + size > end:
                raise ZstdError("raw literals run past the block")
            return bytes(data[pos:pos + size]), pos + size
        st.saw("literals.rle")
        if pos >= end:
            raise ZstdError("truncated RLE literals")
        return bytes((data[pos],)) * size, pos + 1
    hlen = {0: 3, 1: 3, 2: 4, 3: 5}[fmt]
    if pos + hlen > end:
        raise ZstdError("truncated literals header")
    v = int.from_bytes(data[pos:pos + hlen], "little")
    bits = {3: 10, 4: 14, 5: 18}[hlen]
    regen = (v >> 4) & ((1 << bits) - 1)
    comp = (v >> (4 + bits)) & ((1 << bits) - 1)
    pos += hlen
    streams = 1 if fmt == 0 else 4
    cend = pos + comp
    if cend > end:
        raise ZstdError("compressed literals run past the block")
    if kind == 2:
        st.saw("literals.huffman-tree")
        st.huffman, pos = _huffman_table(data, pos, cend)
    else:
        st.saw("literals.treeless")
        if st.huffman is None:
            raise ZstdError("treeless literals before any Huffman table")
    st.saw(f"literals.huffman{streams}")
    if streams == 1:
        return _huffman_stream(data, pos, cend, regen, st.huffman), cend
    if pos + 6 > cend:
        raise ZstdError("truncated literals jump table")
    s1, s2, s3 = struct.unpack_from("<3H", data, pos)
    pos += 6
    each = (regen + 3) // 4
    sizes = [each, each, each, regen - 3 * each]
    if sizes[3] < 0:
        raise ZstdError("literals too short for four streams")
    bounds = [pos, pos + s1, pos + s1 + s2, pos + s1 + s2 + s3, cend]
    if bounds[3] > cend:
        raise ZstdError("literals jump table past the section")
    out = b"".join(_huffman_stream(data, bounds[i], bounds[i + 1], sizes[i], st.huffman)
                   for i in range(4))
    return out, cend


def _table(kind: str, mode: int, data, pos: int, end: int, st: _FrameState):
    name = ("predefined", "rle", "fse", "repeat")[mode]
    st.saw(f"seq.{kind}.{name}")
    if mode == 0:
        t = _predefined(kind)
    elif mode == 1:
        if pos >= end:
            raise ZstdError("truncated RLE sequence code")
        if data[pos] > _MAX_SYMBOL[kind]:
            raise ZstdError(f"RLE {kind} code {data[pos]} out of range")
        t = _rle_table(data[pos])
        pos += 1
    elif mode == 2:
        log, counts, pos = _read_ncount(data, pos, end, _MAX_SYMBOL[kind], _MAX_LOG[kind])
        t = _fse_table(counts, log)
    else:
        t = st.tables[kind]
        if t is None:
            raise ZstdError(f"repeat {kind} table before any table")
    st.tables[kind] = t
    return t, pos


def _block(data, pos: int, end: int, out: bytearray, st: _FrameState) -> None:
    """One compressed block (RFC 8878 3.1.1.3), appended to ``out``."""
    lits, pos = _literals(data, pos, end, st)
    if pos >= end:
        raise ZstdError("truncated sequences section")
    b0 = data[pos]
    if b0 == 0:
        nseq, pos = 0, pos + 1
    elif b0 < 128:
        nseq, pos = b0, pos + 1
    elif b0 < 255:
        nseq, pos = ((b0 - 128) << 8) + data[pos + 1], pos + 2
    else:
        nseq, pos = data[pos + 1] + (data[pos + 2] << 8) + 0x7F00, pos + 3
    if nseq == 0:
        if pos != end:
            raise ZstdError("bytes after an empty sequences section")
        out += lits
        return
    if pos >= end:
        raise ZstdError("truncated sequence modes")
    modes = data[pos]
    pos += 1
    if modes & 3:
        raise ZstdError("reserved bits set in the sequence modes")
    llt, pos = _table("ll", modes >> 6, data, pos, end, st)
    oft, pos = _table("of", (modes >> 4) & 3, data, pos, end, st)
    mlt, pos = _table("ml", (modes >> 2) & 3, data, pos, end, st)
    ll_sym, ll_nb, ll_base, ll_log = llt
    of_sym, of_nb, of_base, of_log = oft
    ml_sym, ml_nb, ml_base, ml_log = mlt
    br = _Backward(data, pos, end)
    read = br.read
    ll_s = read(ll_log)
    of_s = read(of_log)
    ml_s = read(ml_log)
    reps = st.reps
    lp = 0
    nlits = len(lits)
    trace = st.trace
    for i in range(nseq):
        of_code = of_sym[of_s]
        ll_code = ll_sym[ll_s]
        ml_code = ml_sym[ml_s]
        if of_code > 31:
            raise ZstdError(f"offset code {of_code} out of range")
        ov = (1 << of_code) + read(of_code)
        mb, mbits = _ML_CODES[ml_code]
        ml = mb + read(mbits)
        lb, lbits = _LL_CODES[ll_code]
        ll = lb + read(lbits)
        if ov > 3:
            off = ov - 3
            reps[2] = reps[1]
            reps[1] = reps[0]
            reps[0] = off
        else:
            idx = ov - 1 + (ll == 0)
            if trace is not None:
                trace.add(f"offset.repeat{idx + 1}")
            if idx == 0:
                off = reps[0]
            else:
                off = reps[0] - 1 if idx == 3 else reps[idx]
                if idx != 1:
                    reps[2] = reps[1]
                reps[1] = reps[0]
                reps[0] = off
        if i + 1 < nseq:
            ll_s = ll_base[ll_s] + read(ll_nb[ll_s])
            ml_s = ml_base[ml_s] + read(ml_nb[ml_s])
            of_s = of_base[of_s] + read(of_nb[of_s])
        if lp + ll > nlits:
            raise ZstdError("a sequence takes more literals than the block has")
        out += lits[lp:lp + ll]
        lp += ll
        start = len(out) - off
        if off <= 0 or start < 0:
            raise ZstdError(f"match offset {off} outside the output")
        if off >= ml:
            out += out[start:start + ml]
        else:  # overlapping: the last `off` bytes repeat
            pattern = bytes(out[start:])
            out += (pattern * (ml // off + 1))[:ml]
    if br.remaining() != 0:
        raise ZstdError("sequences bitstream not consumed exactly")
    out += lits[lp:]


def _frame(data, pos: int, n: int, out: bytearray, trace) -> int:
    """One Zstandard frame after its magic number; returns the position after."""
    if pos >= n:
        raise ZstdError("truncated frame header")
    fhd = data[pos]
    pos += 1
    fcs_flag = fhd >> 6
    single = (fhd >> 5) & 1
    if fhd & 8:
        raise ZstdError("reserved bit set in the frame header")
    checksum = (fhd >> 2) & 1
    did_size = (0, 1, 2, 4)[fhd & 3]
    if not single:
        pos += 1  # window descriptor: the whole frame stays in memory
    dict_id = int.from_bytes(data[pos:pos + did_size], "little")
    pos += did_size
    if dict_id:
        raise ZstdError(f"frame uses dictionary {dict_id}; dictionaries are not supported")
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    if pos + fcs_size > n:
        raise ZstdError("truncated frame header")
    fcs = None
    if fcs_size:
        fcs = int.from_bytes(data[pos:pos + fcs_size], "little") + (256 if fcs_size == 2 else 0)
    pos += fcs_size
    st = _FrameState(trace)
    begin = len(out)
    while True:
        if pos + 3 > n:
            raise ZstdError("truncated block header")
        bh = int.from_bytes(data[pos:pos + 3], "little")
        pos += 3
        last = bh & 1
        btype = (bh >> 1) & 3
        bsize = bh >> 3
        if btype == 0:
            st.saw("block.raw")
            if pos + bsize > n:
                raise ZstdError("raw block runs past the input")
            out += data[pos:pos + bsize]
            pos += bsize
        elif btype == 1:
            st.saw("block.rle")
            if pos >= n:
                raise ZstdError("truncated RLE block")
            out += bytes((data[pos],)) * bsize
            pos += 1
        elif btype == 2:
            st.saw("block.compressed")
            if bsize > _BLOCK_MAX or pos + bsize > n:
                raise ZstdError("compressed block runs past the input")
            _block(data, pos, pos + bsize, out, st)
            pos += bsize
        else:
            raise ZstdError("reserved block type")
        if last:
            break
    if fcs is not None and len(out) - begin != fcs:
        raise ZstdError(f"frame decoded to {len(out) - begin} bytes, its header says {fcs}")
    if checksum:
        st.saw("frame.checksum")
        if pos + 4 > n:
            raise ZstdError("truncated content checksum")
        want = int.from_bytes(data[pos:pos + 4], "little")
        if xxh64(out[begin:]) & 0xFFFFFFFF != want:
            raise ZstdError("content checksum mismatch")
        pos += 4
    return pos


def decompress(data, size: Optional[int] = None, trace: Optional[Set[str]] = None) -> bytes:
    """Every frame of ``data`` decompressed and concatenated; skippable
    frames are skipped. ``size``, where given, is checked against the
    output length."""
    data = bytes(data)
    n = len(data)
    out = bytearray()
    pos = 0
    frames = 0
    try:
        while pos < n:
            if pos + 4 > n:
                raise ZstdError("truncated magic number")
            magic = int.from_bytes(data[pos:pos + 4], "little")
            pos += 4
            if magic & _SKIPPABLE_MASK == _SKIPPABLE:
                if trace is not None:
                    trace.add("frame.skippable")
                if pos + 4 > n:
                    raise ZstdError("truncated skippable frame")
                skip = int.from_bytes(data[pos:pos + 4], "little")
                pos += 4 + skip
                if pos > n:
                    raise ZstdError("skippable frame runs past the input")
                continue
            if magic != _MAGIC:
                raise ZstdError(f"bad magic number {magic:#010x}")
            pos = _frame(data, pos, n, out, trace)
            frames += 1
    except (IndexError, KeyError) as e:
        raise ZstdError(f"truncated or corrupt input ({type(e).__name__})") from e
    if trace is not None and frames > 1:
        trace.add("frame.multiple")
    if size is not None and len(out) != size:
        raise ZstdError(f"decompressed {len(out)} bytes, {size} expected")
    return bytes(out)

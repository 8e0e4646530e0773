"""Raw Snappy (the block format Parquet pages use): the plain compressor
and decompressor, and the batched calls every writer and reader of the
port goes through.

Format (google/snappy ``format_description.txt``): a varint of the
uncompressed length, then elements — a literal (tag ``00``, length in the
tag or in 1-4 following bytes) or a copy of earlier output (tags
``01``/``10``/``11``: 1-, 2- or 4-byte offsets; a copy may overlap what it
writes, repeating a short pattern).

:func:`compress_pages` and :func:`decompress_pages` take a batch of pages
and a device: on ``cuda`` the page codec's kernels (``ops/page_codec``:
one pinned upload, one launch and one download for the whole batch), on
``cpu`` the plain versions here, a page at a time. They default to the
card, as the port's other entry points do, and nothing picks the CPU in
the card's place: a kernel that fails raises out of the call.

The plain compressor (:func:`compress`) cuts its input into 64 KiB
fragments, as Google's does (every offset fits 2 bytes), and parses each
greedily: a match starts where the 4 bytes at a position occurred before
in the fragment (the most recent occurrence, found for every position at
once by a stable sort of the 4-byte words) and runs to its first
differing byte, measured for every candidate at once. The parse follows
the candidates from match end to match end, and every element's bytes
are placed in one pass, so no Python loop runs once an input byte. Its bytes
are not the kernel's, nor Google's: each is valid Snappy, and each
decoder reads them all.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

__all__ = ["compress", "decompress", "compress_pages", "decompress_pages", "SnappyError",
           "FRAGMENT"]

#: the bytes a compressor takes as one independent fragment
FRAGMENT = 65536


class SnappyError(ValueError):
    """The bytes are not a well-formed raw Snappy block."""


def decompress(data) -> bytes:
    buf = memoryview(data)
    n = len(buf)
    pos = shift = length = 0
    while True:
        if pos >= n:
            raise SnappyError("truncated length preamble")
        b = buf[pos]
        pos += 1
        length |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
        if shift > 32:
            raise SnappyError("length preamble too long")
    out = bytearray()
    while pos < n:
        tag = buf[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            ln = tag >> 2
            if ln >= 60:
                extra = ln - 59
                if pos + extra > n:
                    raise SnappyError("literal length runs past the input")
                ln = int.from_bytes(buf[pos:pos + extra], "little")
                pos += extra
            ln += 1
            if pos + ln > n:
                raise SnappyError("literal runs past the input")
            out += buf[pos:pos + ln]
            pos += ln
            continue
        extra = (0, 1, 2, 4)[kind]
        if pos + extra > n:
            raise SnappyError("copy runs past the input")
        if kind == 1:
            ln = 4 + ((tag >> 2) & 7)
            off = ((tag >> 5) << 8) | buf[pos]
        else:
            ln = (tag >> 2) + 1
            off = int.from_bytes(buf[pos:pos + extra], "little")
        pos += extra
        start = len(out) - off
        if off == 0 or start < 0:
            raise SnappyError(f"copy offset {off} outside the output")
        if off >= ln:
            out += out[start:start + ln]
        else:  # overlapping: the last `off` bytes repeat
            pattern = bytes(out[start:])
            out += (pattern * (ln // off + 1))[:ln]
    if len(out) != length:
        raise SnappyError(f"decompressed {len(out)} bytes, the preamble says {length}")
    return bytes(out)


def _put_varint(out: bytearray, n: int) -> None:
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _fragment(a: np.ndarray, base: int, out: List[np.ndarray]) -> None:
    """Compress ``a`` (at most 64 KiB, at ``base`` in its page) into one
    array appended to ``out``: the greedy parse, then every element's bytes
    placed at once."""
    n = len(a)
    m = n - 3
    cand = np.zeros(0, np.int64)
    if n >= 8:
        a32 = a.astype(np.uint32)
        w = a32[:m] | (a32[1:m + 1] << 8) | (a32[2:m + 2] << 16) | (a32[3:] << 24)
        order = np.argsort(w, kind="stable")
        same = w[order[1:]] == w[order[:-1]]
        prev = np.full(m, -1, np.int64)
        prev[order[1:][same]] = order[:-1][same]
        cand = np.flatnonzero(prev >= 0)
    if not len(cand):
        out.append(_literals(a, np.zeros(1, np.int64), np.full(1, n, np.int64)))
        return
    # each candidate's match: 4 bytes, one more for each next position whose
    # most recent occurrence is the next one along, then 8 bytes at a time
    step = np.zeros(m, bool)
    step[:-1] = (prev[:-1] >= 0) & (prev[1:] == prev[:-1] + 1)
    stops = np.flatnonzero(~step)
    length = 4 + stops[np.searchsorted(stops, cand)] - cand
    src = prev[cand]
    _extend(a, cand, src, length)
    nxt = np.searchsorted(cand, cand + length).tolist()
    chosen = []
    k, kk = 0, len(cand)
    while k < kk:
        chosen.append(k)
        k = nxt[k]
    pos, ln = cand[chosen], length[chosen]
    off = pos - src[chosen]
    lit_lo = np.concatenate([[0], pos + ln])
    lit_hi = np.concatenate([pos, [n]])
    out.append(_elements(a, lit_lo, lit_hi, off, ln))


def _extend(a: np.ndarray, cand: np.ndarray, src: np.ndarray, length: np.ndarray) -> None:
    """Lengthen each match (``cand`` copying ``src``) toward its first
    differing byte: up to 8 rounds of 8 bytes, then byte by byte where
    fewer than 8 remain in the fragment (a match cut short stays valid)."""
    n = len(a)
    act = np.arange(len(cand))
    tail = []
    if n >= 8:
        a64 = a.astype(np.uint64)
        w8 = a64[:n - 7].copy()
        for b in range(1, 8):
            w8 |= a64[b:n - 7 + b] << np.uint64(8 * b)
        for _ in range(8):
            near = cand[act] + length[act] + 8 > n
            tail.append(act[near])
            act = act[~near]
            if not len(act):
                break
            x = w8[cand[act] + length[act]] ^ w8[src[act] + length[act]]
            whole = x == 0
            length[act[whole]] += 8
            xp = x[~whole]
            tz = np.zeros(len(xp), np.int64)
            for b in range(7):  # equal low bytes before the first difference
                tz += (((xp >> np.uint64(8 * b)) & np.uint64(0xFF)) == 0) & (tz == b)
            length[act[~whole]] += tz
            act = act[whole]
    else:
        tail.append(act)
    act = np.concatenate(tail) if tail else act[:0]
    for _ in range(8):
        j = cand[act] + length[act]
        act = act[j < n]
        if not len(act):
            break
        j = cand[act] + length[act]
        act = act[a[j] == a[src[act] + length[act]]]
        length[act] += 1


def _literals(a: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    return _elements(a, lo, hi, np.zeros(0, np.int64), np.zeros(0, np.int64))


def _elements(a: np.ndarray, lit_lo: np.ndarray, lit_hi: np.ndarray, off: np.ndarray,
              ln: np.ndarray) -> np.ndarray:
    """The bytes of ``len(off)`` (literal, copy) pairs and a last literal:
    literal ``i`` is ``a[lit_lo[i]:lit_hi[i]]`` (none where empty), copy
    ``i`` repeats ``ln[i]`` bytes from ``off[i]`` back, cut as Google's
    ``EmitCopy`` cuts it (64s while 68 or more remain, a 60 past 64, then
    the rest, every piece 4 or more; a 1-byte offset below 12 bytes and an
    offset under 2048)."""
    gap = lit_hi - lit_lo
    g1 = gap - 1
    lit_tag = np.where(gap == 0, 0, np.where(g1 < 60, 1, np.where(g1 < 256, 2, 3)))
    full, rem = ln // 64, ln % 64
    short = (full > 0) & (rem < 4)
    full -= short
    rem += 64 * short
    p60 = (rem > 64).astype(np.int64)
    rem -= 60 * p60
    small = (rem < 12) & (off < 2048)
    copy_bytes = 3 * full + 3 * p60 + np.where(small, 2, 3)
    k = len(off)
    seg = lit_tag + gap
    seg[:k] += copy_bytes
    ends = np.cumsum(seg)
    o = ends - seg
    buf = np.zeros(int(ends[-1]) if len(ends) else 0, np.uint8)
    # literal tags
    t = lit_tag == 1
    buf[o[t]] = (g1[t] << 2).astype(np.uint8)
    t = lit_tag == 2
    buf[o[t]] = 60 << 2
    buf[o[t] + 1] = g1[t].astype(np.uint8)
    t = lit_tag == 3
    buf[o[t]] = 61 << 2
    buf[o[t] + 1] = (g1[t] & 0xFF).astype(np.uint8)
    buf[o[t] + 2] = (g1[t] >> 8).astype(np.uint8)
    # literal bytes
    total = int(gap.sum())
    if total:
        idx = np.arange(total) + np.repeat(o + lit_tag - np.cumsum(gap) + gap, gap)
        buf[idx] = a[np.arange(total) + np.repeat(lit_lo - np.cumsum(gap) + gap, gap)]
    if not k:
        return buf
    lo, hi = (off & 0xFF).astype(np.uint8), (off >> 8).astype(np.uint8)
    c = o[:k] + lit_tag[:k] + gap[:k]
    # the 64-byte pieces
    nf = int(full.sum())
    if nf:
        at = np.repeat(c - 3 * (np.cumsum(full) - full), full) + 3 * np.arange(nf)
        buf[at] = 2 | (63 << 2)
        buf[at + 1] = np.repeat(lo, full)
        buf[at + 2] = np.repeat(hi, full)
    c = c + 3 * full
    t = p60 == 1
    buf[c[t]] = 2 | (59 << 2)
    buf[c[t] + 1] = lo[t]
    buf[c[t] + 2] = hi[t]
    c = c + 3 * p60
    buf[c[small]] = (1 | ((rem[small] - 4) << 2) | ((off[small] >> 8) << 5)).astype(np.uint8)
    buf[c[small] + 1] = lo[small]
    big = ~small
    buf[c[big]] = (2 | ((rem[big] - 1) << 2)).astype(np.uint8)
    buf[c[big] + 1] = lo[big]
    buf[c[big] + 2] = hi[big]
    return buf


def compress(data) -> bytes:
    """Raw Snappy of ``data`` (the plain version of ``snappy_compress``)."""
    a = np.frombuffer(bytes(data), np.uint8)
    head = bytearray()
    _put_varint(head, len(a))
    parts: List[np.ndarray] = []
    for s in range(0, len(a), FRAGMENT):
        _fragment(a[s:s + FRAGMENT], s, parts)
    return bytes(head) + b"".join(p.tobytes() for p in parts)


def compress_pages(pages: Sequence, device="cuda") -> List[bytes]:
    """Raw Snappy of each page of the batch, on ``device``."""
    if not len(pages):
        return []
    from delta_tpu_torch.utils.device import resolve

    dev = resolve(device)
    if dev.type == "cpu":
        return [compress(p) for p in pages]
    from delta_tpu_torch.ops import page_codec

    return page_codec.compress(pages, dev)


def decompress_pages(bodies: Sequence, sizes: Sequence[int], device="cuda",
                     labels: Optional[Sequence[str]] = None) -> List[bytes]:
    """Each raw Snappy body of the batch decompressed, on ``device``; each
    must give exactly ``sizes[i]`` bytes (the page header's uncompressed
    size). Raises :class:`SnappyError` naming ``labels[i]`` (the file and
    the column) for the first page that does not."""
    if not len(bodies):
        return []
    from delta_tpu_torch.utils.device import resolve

    dev = resolve(device)
    if dev.type != "cpu":
        from delta_tpu_torch.ops import page_codec

        return page_codec.decompress(bodies, sizes, dev, labels)
    out = []
    for i, (body, size) in enumerate(zip(bodies, sizes)):
        try:
            page = decompress(body)
            if len(page) != size:
                raise SnappyError(f"{len(page)} bytes where the page header says {size}")
        except SnappyError as e:
            label = labels[i] if labels is not None else f"page {i}"
            raise SnappyError(f"{label}: corrupt SNAPPY page: {e}") from None
        out.append(page)
    return out

"""Raw Snappy decompression (the block format Parquet pages use).

The JAX package's writer snappy-compresses string, float and low-entropy
integer columns (``delta_tpu/exec/parquet.py:158-170``), so the port's
reader needs the codec; the port writes its own files uncompressed and
carries no compressor. Format (google/snappy ``format_description.txt``): a
varint of the uncompressed length, then elements — a literal (tag ``00``,
length in the tag or in 1-4 following bytes) or a copy of earlier output
(tags ``01``/``10``/``11``: 1-, 2- or 4-byte offsets; a copy may overlap
what it writes, repeating a short pattern).
"""
from __future__ import annotations

__all__ = ["decompress", "SnappyError"]


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
                ln = int.from_bytes(buf[pos:pos + extra], "little")
                pos += extra
            ln += 1
            if pos + ln > n:
                raise SnappyError("literal runs past the input")
            out += buf[pos:pos + ln]
            pos += ln
            continue
        if kind == 1:
            ln = 4 + ((tag >> 2) & 7)
            off = ((tag >> 5) << 8) | buf[pos]
            pos += 1
        elif kind == 2:
            ln = (tag >> 2) + 1
            off = buf[pos] | (buf[pos + 1] << 8)
            pos += 2
        else:
            ln = (tag >> 2) + 1
            off = int.from_bytes(buf[pos:pos + 4], "little")
            pos += 4
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

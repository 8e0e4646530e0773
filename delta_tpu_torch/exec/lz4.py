"""LZ4 block decompression (Parquet's LZ4_RAW codec, number 7).

The JAX package writes LZ4_RAW pages under ``delta.tpu.write.compression=lz4``
(``pyarrow``), so the port's reader needs the codec; the port carries no
compressor. Format (lz4/lz4 ``doc/lz4_Block_format.md``): a run of
sequences, each a token byte (literal length in the high nibble, match
length - 4 in the low one, 15 meaning "more length bytes follow", each
adding up to 255), the literals, then a 2-byte little-endian offset back
into the output; the last sequence stops after its literals. A match may
overlap what it writes, repeating a short pattern.
"""
from __future__ import annotations

__all__ = ["decompress", "Lz4Error"]


class Lz4Error(ValueError):
    """The bytes are not a well-formed LZ4 block."""


def decompress(data, size: int) -> bytes:
    """The block ``data`` decompressed; ``size`` is the expected output
    length (a Parquet page header carries it), checked at the end."""
    buf = memoryview(data)
    n = len(buf)
    out = bytearray()
    pos = 0
    if n == 0:
        if size:
            raise Lz4Error(f"empty block, {size} bytes expected")
        return b""
    while True:
        if pos >= n:
            raise Lz4Error("truncated block: a sequence without its token")
        token = buf[pos]
        pos += 1
        lit = token >> 4
        if lit == 15:
            while True:
                if pos >= n:
                    raise Lz4Error("truncated literal length")
                b = buf[pos]
                pos += 1
                lit += b
                if b != 255:
                    break
        if pos + lit > n:
            raise Lz4Error("literals run past the input")
        out += buf[pos:pos + lit]
        pos += lit
        if pos == n:
            break  # the last sequence: literals only
        if pos + 2 > n:
            raise Lz4Error("truncated match offset")
        off = buf[pos] | (buf[pos + 1] << 8)
        pos += 2
        ml = token & 15
        if ml == 15:
            while True:
                if pos >= n:
                    raise Lz4Error("truncated match length")
                b = buf[pos]
                pos += 1
                ml += b
                if b != 255:
                    break
        ml += 4
        start = len(out) - off
        if off == 0 or start < 0:
            raise Lz4Error(f"match offset {off} outside the output")
        if off >= ml:
            out += out[start:start + ml]
        else:  # overlapping: the last `off` bytes repeat
            pattern = bytes(out[start:])
            out += (pattern * (ml // off + 1))[:ml]
        if len(out) > size:
            raise Lz4Error(f"output exceeds the expected {size} bytes")
    if len(out) != size:
        raise Lz4Error(f"decompressed {len(out)} bytes, {size} expected")
    return bytes(out)

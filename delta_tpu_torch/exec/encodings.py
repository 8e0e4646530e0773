"""Parquet value and level encodings, decoded and encoded with numpy.

Decoders for what flat data files carry: PLAIN for every physical type in
scope, the RLE/bit-packed hybrid (definition levels, dictionary indices,
RLE booleans), the dictionary encodings (PLAIN_DICTIONARY and
RLE_DICTIONARY: hybrid indices into a PLAIN dictionary page) and
BYTE_STREAM_SPLIT. Fixed-width values decode as one ``np.frombuffer``; a
bit-packed run unpacks as one ``np.unpackbits`` and a weighted sum, so the
Python work is per run, not per value. BYTE_ARRAY values are
length-prefixed one after another and decode value by value (each becomes
a Python object anyway).

The encoders are the writer's: PLAIN, the hybrid for levels, a
dictionary (:func:`dictionary_encode`: a PLAIN dictionary page and
RLE_DICTIONARY indices, that stops collecting at its page limit and leaves
the rest of the chunk to PLAIN pages, as Arrow's writer falls back) and
BYTE_STREAM_SPLIT, all vectorised but the dictionary of BYTE_ARRAY values
(a dict lookup a value, in batches, until the limit).

DECIMAL values are unscaled integers: :func:`decimal_from_bytes` turns
big-endian two's complement of any width from 1 to 16 bytes (a
FIXED_LEN_BYTE_ARRAY page, or BYTE_ARRAY values padded to one width) into
int64 lanes (at most 8 bytes) or Python ints (wider), and
:func:`decimal_to_bytes` writes the low ``width`` bytes of each value back,
as Arrow's Parquet writer does (a value wider than its precision keeps its
low bytes).
"""
from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["PLAIN", "PLAIN_DICTIONARY", "RLE", "RLE_DICTIONARY",
           "BYTE_STREAM_SPLIT", "ENCODING_NAMES", "BOOLEAN", "INT32", "INT64", "INT96",
           "FLOAT", "DOUBLE", "BYTE_ARRAY", "FIXED_LEN_BYTE_ARRAY", "TYPE_NAMES",
           "read_varint", "decode_hybrid", "decode_plain", "decode_byte_stream_split",
           "decode_dictionary_indices", "encode_hybrid_bits", "encode_hybrid", "encode_plain",
           "decode_fixed", "decimal_from_bytes", "decimal_to_bytes", "decimal_width",
           "encode_byte_stream_split", "dictionary_encode", "encode_dictionary_indices",
           "dictionary_bit_width", "DICTIONARY_PAGE_LIMIT"]

# Encoding (parquet.thrift)
PLAIN, PLAIN_DICTIONARY, RLE = 0, 2, 3
RLE_DICTIONARY, BYTE_STREAM_SPLIT = 8, 9
ENCODING_NAMES = {0: "PLAIN", 2: "PLAIN_DICTIONARY", 3: "RLE", 4: "BIT_PACKED",
                  5: "DELTA_BINARY_PACKED", 6: "DELTA_LENGTH_BYTE_ARRAY",
                  7: "DELTA_BYTE_ARRAY", 8: "RLE_DICTIONARY", 9: "BYTE_STREAM_SPLIT"}

# physical Type (parquet.thrift)
BOOLEAN, INT32, INT64, INT96, FLOAT, DOUBLE, BYTE_ARRAY, FIXED_LEN_BYTE_ARRAY = range(8)
TYPE_NAMES = {0: "BOOLEAN", 1: "INT32", 2: "INT64", 3: "INT96", 4: "FLOAT", 5: "DOUBLE",
              6: "BYTE_ARRAY", 7: "FIXED_LEN_BYTE_ARRAY"}

_FIXED = {INT32: np.dtype("<i4"), INT64: np.dtype("<i8"), FLOAT: np.dtype("<f4"),
          DOUBLE: np.dtype("<f8")}


class EncodingError(ValueError):
    """The page's bytes do not decode as its header says."""


def read_varint(buf, pos: int) -> Tuple[int, int]:
    shift = result = 0
    while True:
        if pos >= len(buf):
            raise EncodingError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _unpack_bits(raw: np.ndarray, bit_width: int, count: int) -> np.ndarray:
    """``count`` little-endian ``bit_width``-bit values packed LSB first."""
    if bit_width == 0:
        return np.zeros(count, np.int64)
    bits = np.unpackbits(raw, bitorder="little")[: count * bit_width]
    bits = bits.reshape(count, bit_width).astype(np.int64)
    return bits @ (np.int64(1) << np.arange(bit_width, dtype=np.int64))


def decode_hybrid(buf, pos: int, end: int, bit_width: int, num_values: int) -> np.ndarray:
    """The RLE/bit-packed hybrid over ``buf[pos:end]`` (no length prefix):
    ``num_values`` values as int64."""
    if bit_width > 32:
        raise EncodingError(f"hybrid bit width {bit_width} > 32")
    data = np.frombuffer(buf, np.uint8)
    byte_width = (bit_width + 7) // 8
    pieces: List[np.ndarray] = []
    got = 0
    while got < num_values:
        if pos >= end:
            raise EncodingError(f"hybrid runs end after {got} of {num_values} values")
        header, pos = read_varint(buf, pos)
        if header & 1:  # bit-packed: (header >> 1) groups of 8 values
            count = (header >> 1) * 8
            nbytes = (header >> 1) * bit_width
            if pos + nbytes > end:
                raise EncodingError("bit-packed run past the end of its buffer")
            pieces.append(_unpack_bits(data[pos:pos + nbytes], bit_width, count))
            pos += nbytes
        else:
            count = header >> 1
            value = int.from_bytes(bytes(buf[pos:pos + byte_width]), "little")
            pos += byte_width
            pieces.append(np.full(count, value, np.int64))
        got += count
    if not pieces:
        return np.zeros(0, np.int64)
    out = pieces[0] if len(pieces) == 1 else np.concatenate(pieces)
    return out[:num_values]


def _fixed_width_byte_arrays(buf, pos: int, end: int, count: int):
    """PLAIN BYTE_ARRAY values of one length, as an ``S`` array in one
    numpy pass, or None where the lengths differ (or a value is empty or
    ends in a NUL byte)."""
    if count == 0 or pos + 4 > end:
        return None
    (n0,) = struct.unpack_from("<I", buf, pos)
    width = 4 + n0
    if n0 == 0 or pos + count * width > end:
        return None
    block = np.frombuffer(buf, np.uint8, count * width, pos).reshape(count, width)
    if not (block[:, :4].copy().view("<u4").ravel() == n0).all() or not block[:, -1].all():
        return None
    return np.ascontiguousarray(block[:, 4:]).view(f"S{n0}").ravel()


def decode_plain(buf, pos: int, end: int, ptype: int, count: int):
    """``count`` PLAIN values of physical type ``ptype``: a numpy array for
    fixed widths and booleans; for BYTE_ARRAY a fixed-width ``S`` array
    where every value has one length and none ends in a NUL byte (numpy
    strips trailing NULs), else a list of ``bytes``."""
    if ptype in _FIXED:
        dt = _FIXED[ptype]
        if pos + count * dt.itemsize > end:
            raise EncodingError(f"{count} PLAIN {TYPE_NAMES[ptype]} values past the page end")
        return np.frombuffer(buf, dt, count, pos)
    if ptype == BOOLEAN:
        nbytes = (count + 7) // 8
        if pos + nbytes > end:
            raise EncodingError("PLAIN booleans past the page end")
        raw = np.frombuffer(buf, np.uint8, nbytes, pos)
        return np.unpackbits(raw, count=count, bitorder="little").astype(bool)
    if ptype == BYTE_ARRAY:
        fixed = _fixed_width_byte_arrays(buf, pos, end, count)
        if fixed is not None:
            return fixed
        out = []
        mv = memoryview(buf)
        unpack = struct.Struct("<I").unpack_from
        for _ in range(count):
            if pos + 4 > end:
                raise EncodingError("PLAIN BYTE_ARRAY values past the page end")
            (n,) = unpack(mv, pos)
            pos += 4
            if pos + n > end:
                raise EncodingError("PLAIN BYTE_ARRAY value past the page end")
            out.append(bytes(mv[pos:pos + n]))
            pos += n
        return out
    raise EncodingError(f"PLAIN {TYPE_NAMES.get(ptype, ptype)} is not decoded here")


def decode_fixed(buf, pos: int, end: int, width: int, count: int) -> np.ndarray:
    """``count`` PLAIN FIXED_LEN_BYTE_ARRAY values of ``width`` bytes, as a
    ``(count, width)`` uint8 array."""
    if pos + count * width > end:
        raise EncodingError(f"{count} PLAIN FIXED_LEN_BYTE_ARRAY values past the page end")
    return np.frombuffer(buf, np.uint8, count * width, pos).reshape(count, width)


_U64 = (1 << 64) - 1


def decimal_from_bytes(raw: np.ndarray, wide: bool) -> np.ndarray:
    """Big-endian two's complement rows of a ``(n, w)`` uint8 array as
    unscaled integers: int64 where ``wide`` is False (a wider value keeps
    its low 8 bytes), else an object array of Python ints."""
    n, w = raw.shape
    if w == 0:
        return np.zeros(n, object if wide else np.int64)
    neg = raw[:, 0] >= 0x80
    if w <= 8:
        pad = np.where(neg, 0xFF, 0).astype(np.uint8)[:, None].repeat(8 - w, 1)
        lo = np.ascontiguousarray(np.concatenate([pad, raw], 1)).view(">i8").ravel()
        return lo.astype(object) if wide else lo.astype(np.int64)
    lo = np.ascontiguousarray(raw[:, w - 8:]).view(">u8").ravel()
    if not wide:
        return lo.astype(np.uint64).view(np.int64)
    hi = decimal_from_bytes(np.ascontiguousarray(raw[:, :w - 8]), False)
    return hi.astype(object) * (1 << 64) + lo.astype(np.uint64).astype(object)


def decimal_width(precision: int) -> int:
    """The fewest bytes that hold every unscaled value of ``precision``
    digits (Arrow's FIXED_LEN_BYTE_ARRAY width)."""
    top = 10 ** precision - 1
    w = 1
    while top >= 1 << (8 * w - 1):
        w += 1
    return w


def decimal_to_bytes(values: np.ndarray, width: int) -> np.ndarray:
    """Unscaled integers (int64 or Python ints) as a ``(n, width)`` uint8
    array of big-endian two's complement: each value's low ``width``
    bytes."""
    n = len(values)
    if values.dtype != object:
        full = np.ascontiguousarray(values.astype(">i8")).view(np.uint8).reshape(n, 8)
        if width <= 8:
            return full[:, 8 - width:]
        sign = np.where(values < 0, 0xFF, 0).astype(np.uint8)[:, None].repeat(width - 8, 1)
        return np.concatenate([sign, full], 1)
    lo = np.array([int(v) & _U64 for v in values.tolist()], np.uint64) if n else \
        np.zeros(0, np.uint64)
    lo_b = np.ascontiguousarray(lo.astype(">u8")).view(np.uint8).reshape(n, 8)
    if width <= 8:
        return lo_b[:, 8 - width:]
    hi = np.array([(int(v) >> 64) & _U64 for v in values.tolist()], np.uint64) if n else \
        np.zeros(0, np.uint64)
    hi_b = np.ascontiguousarray(hi.astype(">u8")).view(np.uint8).reshape(n, 8)
    return np.concatenate([hi_b[:, 16 - width:], lo_b], 1)


def decode_byte_stream_split(buf, pos: int, end: int, ptype: int, count: int) -> np.ndarray:
    """BYTE_STREAM_SPLIT: byte k of every value stored together, stream
    after stream."""
    dt = _FIXED.get(ptype)
    if dt is None:
        raise EncodingError(f"BYTE_STREAM_SPLIT of {TYPE_NAMES.get(ptype, ptype)}")
    w = dt.itemsize
    if pos + count * w > end:
        raise EncodingError("BYTE_STREAM_SPLIT values past the page end")
    raw = np.frombuffer(buf, np.uint8, count * w, pos).reshape(w, count)
    return np.ascontiguousarray(raw.T).view(dt).reshape(count)


def decode_dictionary_indices(buf, pos: int, end: int, count: int) -> np.ndarray:
    """RLE_DICTIONARY / PLAIN_DICTIONARY data: one byte of bit width, then
    the hybrid."""
    if count == 0:
        return np.zeros(0, np.int64)
    bit_width = buf[pos]
    return decode_hybrid(buf, pos + 1, end, bit_width, count)


# -- encoding (the writer) -------------------------------------------------------


def _put_varint(out: bytearray, n: int) -> None:
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def encode_hybrid_bits(bits: np.ndarray) -> bytes:
    """Bit-width-1 hybrid (definition levels of a flat optional column): one
    RLE run when all values agree, else one bit-packed run."""
    out = bytearray()
    n = len(bits)
    if n == 0:
        return b""
    if bits.all() or not bits.any():
        _put_varint(out, n << 1)
        out.append(1 if bits[0] else 0)
        return bytes(out)
    groups = (n + 7) // 8
    _put_varint(out, (groups << 1) | 1)
    out += np.packbits(np.asarray(bits, bool), bitorder="little").tobytes()
    return bytes(out)


def encode_plain(ptype: int, values) -> bytes:
    """PLAIN bytes of ``values`` (numpy for fixed widths and booleans, a
    ``(count, width)`` uint8 array for FIXED_LEN_BYTE_ARRAY, a sequence of
    ``bytes`` for BYTE_ARRAY)."""
    if ptype in _FIXED:
        return np.ascontiguousarray(values, _FIXED[ptype]).tobytes()
    if ptype == BOOLEAN:
        return np.packbits(np.asarray(values, bool), bitorder="little").tobytes()
    if ptype == FIXED_LEN_BYTE_ARRAY:  # a (count, width) uint8 array
        return np.ascontiguousarray(values, np.uint8).tobytes()
    if ptype == BYTE_ARRAY:
        vs: Sequence[bytes] = values
        n = len(vs)
        lens = np.fromiter((len(v) for v in vs), np.int64, n)
        starts = np.zeros(n, np.int64)
        np.cumsum(4 + lens[:-1], out=starts[1:])
        out = np.empty(int(4 * n + lens.sum()), np.uint8)
        # each value's 4-byte length, then its bytes, scattered in one pass
        out[(starts[:, None] + np.arange(4)).ravel()] = \
            lens.astype("<u4").view(np.uint8).reshape(n, 4).ravel()
        data = np.frombuffer(b"".join(vs), np.uint8)
        if data.size:
            data_starts = np.zeros(n, np.int64)
            np.cumsum(lens[:-1], out=data_starts[1:])
            out[np.repeat(starts + 4 - data_starts, lens) + np.arange(data.size)] = data
        return out.tobytes()
    raise EncodingError(f"PLAIN {TYPE_NAMES.get(ptype, ptype)} is not encoded here")


def encode_hybrid(values: np.ndarray, bit_width: int) -> bytes:
    """The hybrid of ``bit_width``-bit values (definition and repetition
    levels): one RLE run when all agree, else one bit-packed run."""
    vals = np.asarray(values, np.int64)
    n = len(vals)
    out = bytearray()
    if n == 0 or bit_width == 0:
        return b""
    if (vals == vals[0]).all():
        _put_varint(out, n << 1)
        out += int(vals[0]).to_bytes((bit_width + 7) // 8, "little")
        return bytes(out)
    groups = (n + 7) // 8
    padded = np.zeros(groups * 8, np.uint32)
    padded[:n] = vals
    bits = ((padded[:, None] >> np.arange(bit_width, dtype=np.uint32)) & 1).astype(np.uint8).ravel()
    _put_varint(out, (groups << 1) | 1)
    out += np.packbits(bits, bitorder="little").tobytes()
    return bytes(out)


def encode_byte_stream_split(ptype: int, values) -> bytes:
    """BYTE_STREAM_SPLIT of fixed-width values: byte k of every value
    together, stream after stream."""
    dt = _FIXED.get(ptype)
    if dt is None:
        raise EncodingError(f"BYTE_STREAM_SPLIT of {TYPE_NAMES.get(ptype, ptype)}")
    raw = np.ascontiguousarray(values, dt).view(np.uint8).reshape(-1, dt.itemsize)
    return np.ascontiguousarray(raw.T).tobytes()


#: Arrow's ``dictionary_pagesize_limit``: a chunk whose dictionary page
#: reaches it writes the rest of its values PLAIN
DICTIONARY_PAGE_LIMIT = 1 << 20
#: the values Arrow's writer takes a batch (``write_batch_size``): the
#: dictionary's size is checked after each
_BATCH = 1024


def dictionary_bit_width(entries: int) -> int:
    """The indices' bit width for a dictionary of ``entries`` (1 at least)."""
    return max(int(entries - 1).bit_length(), 1)


def _dictionary_bytes(ptype: int, values, limit: int, cuts: np.ndarray):
    """BYTE_ARRAY values: a dict lookup a value, batch by batch, until the
    dictionary's PLAIN size reaches ``limit``; then on to the next cut."""
    ids: dict = {}
    keys: List[bytes] = []
    idx: List[int] = []
    size = 0
    n = len(values)
    stop = n
    pos = 0
    while pos < stop:
        end = min(pos + _BATCH, stop)
        for v in values[pos:end]:
            i = ids.get(v)
            if i is None:
                i = ids[v] = len(keys)
                keys.append(v)
                size += 4 + len(v)
            idx.append(i)
        pos = end
        if stop == n and size >= limit and pos < n:
            stop = int(cuts[np.searchsorted(cuts, pos)])
    return keys, np.asarray(idx, np.int64), stop


def _dictionary_keys(ptype: int, values) -> Tuple[np.ndarray, int]:
    """Fixed-width values as keys that compare as their bytes (a float's
    bit pattern: -0.0 and each NaN stay themselves), and their width."""
    if ptype == FIXED_LEN_BYTE_ARRAY:
        raw = np.ascontiguousarray(values, np.uint8)
        return raw.view(np.dtype((np.void, raw.shape[1]))).ravel(), raw.shape[1]
    dt = _FIXED[ptype]
    arr = np.ascontiguousarray(values, dt)
    return arr.view(np.dtype(f"<u{dt.itemsize}")), dt.itemsize


def dictionary_encode(ptype: int, values, limit: int = DICTIONARY_PAGE_LIMIT,
                      cuts: Optional[np.ndarray] = None):
    """A column chunk's dictionary: ``(dictionary values, indices, k)``.
    The first ``k`` values are dictionary-encoded (``indices``, int64, in
    the order of first appearance); where the dictionary's PLAIN size
    reaches ``limit`` after a batch of 1024 values, ``k`` is the first of
    ``cuts`` (the permitted cut points: record boundaries, ascending,
    ending at ``len(values)``) at or past that batch, and the rest are
    written PLAIN. BYTE_ARRAY values are a sequence of ``bytes``, and the
    dictionary is a list of them; fixed widths numpy, and the dictionary
    an array of the same kind."""
    n = len(values)
    if cuts is None:
        cuts = np.arange(n + 1)
    if ptype == BYTE_ARRAY:
        return _dictionary_bytes(ptype, values, limit, cuts)
    if ptype == BOOLEAN:
        raise EncodingError("a BOOLEAN column is not dictionary-encoded")
    keys, width = _dictionary_keys(ptype, values)
    if n == 0:
        return values[:0], np.zeros(0, np.int64), 0
    uniq, first, inv = np.unique(keys, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(len(uniq), np.int64)
    rank[order] = np.arange(len(uniq))
    first_sorted = first[order]
    full = -(-limit // width)  # entries at which the page reaches the limit
    k = n
    if len(uniq) >= full:
        at = int(first_sorted[full - 1]) + 1
        at = min(n, -(-at // _BATCH) * _BATCH)
        if at < n:
            k = int(cuts[np.searchsorted(cuts, at)])
    entries = int(np.searchsorted(first_sorted, k))
    return values[first_sorted[:entries]], rank[inv.ravel()[:k]], k


def encode_dictionary_indices(indices: np.ndarray, bit_width: int) -> bytes:
    """RLE_DICTIONARY data: one byte of bit width, then the hybrid."""
    return bytes([bit_width]) + encode_hybrid(indices, bit_width)

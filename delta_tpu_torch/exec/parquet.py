"""Parquet data files without ``pyarrow``: reader, writer and file stats.

The port's own copy of ``delta_tpu.exec.parquet``, which encodes and
decodes through Arrow's C++ Parquet module. The port does not depend on
``pyarrow``, so this module carries a codec of its own for flat data files
(``exec/thrift`` for the footer and page headers, ``exec/encodings`` for
the values, ``exec/snappy``, ``exec/zstd`` and ``exec/lz4`` for the JAX
package's compressed pages):

* :func:`read_parquet_file` / :func:`read_parquet_files`: a file's columns
  (all, or a projection; all row groups, or a subset) as the port's
  ``HostTable`` (``expr/vectorized``);
* :func:`write_parquet_file`: the JAX package's encoding policy
  (dictionary pages for strings, BYTE_STREAM_SPLIT floats, SNAPPY where it
  pays, ``delta.tpu.write.compression`` and ``.byteStreamSplit``), data
  pages cut near 1 MiB, RLE definition levels, row groups of
  ``delta.tpu.write.rowGroupRows`` rows and min/max/null statistics per
  column chunk in the footer; :func:`write_nested` a checkpoint's file
  (SNAPPY and a dictionary on every leaf);
* the page codec: every SNAPPY page a file write or read touches goes in
  one batch through ``exec/snappy`` (the kernels on ``cuda``, the plain
  versions on ``cpu``);
* :func:`chunk_statistics`: one column chunk's footer statistics as the
  Python values ``pyarrow``'s ``Statistics.min``/``max`` give (the row-group
  planner's input, ``exec/rowgroups``);
* :func:`json_stat_value`, :func:`collect_stats`, :func:`stats_json`: the
  protocol's per-file stats, with the JAX package's output.

Scope: flat and nested (struct, list, map) columns; physical types
BOOLEAN, INT32, INT64, FLOAT, DOUBLE, BYTE_ARRAY and FIXED_LEN_BYTE_ARRAY;
logical types int8/16/32/64, date, timestamp (ms, µs), string/binary and
DECIMAL (stored as INT32, INT64, FIXED_LEN_BYTE_ARRAY or BYTE_ARRAY; the
writer stores FIXED_LEN_BYTE_ARRAY of the fewest bytes, as ``pyarrow``
does); codecs UNCOMPRESSED, SNAPPY, GZIP, ZSTD and LZ4_RAW; data pages v1
and v2. Anything else — INT96, an unsigned column, LZ4 (Hadoop framing) or
BROTLI, a DELTA_* encoding — raises ``NotImplementedError`` naming the
column and what it lacks.

Columns map to ``HostColumn`` kinds as ``pyarrow`` types map to the JAX
package's evaluator: integers -> ``int`` (int64 values), floats ->
``double`` (float64 values), strings -> ``str``, binary -> ``object``
(``bytes``), dates -> ``date`` (epoch days), timestamps -> ``ts`` (epoch
µs), booleans -> ``bool``, decimals -> ``decimal`` (unscaled integers:
int64 up to 18 digits, Python ints beyond), a nested column -> ``nested``
(an ``expr/nested.NCol``, its type the column's spec). ``HostColumn.type``
keeps the stored type (``int32``, ``float32``, ``decimal128(7, 2)``, ...),
so a file read and written again keeps its schema.
"""
from __future__ import annotations

import datetime as _dt
import decimal as _decimal
import json
import math
import os
import struct
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from delta_tpu_torch.exec import encodings as enc
from delta_tpu_torch.exec import lz4, snappy, thrift, zstd
from delta_tpu_torch.expr.nested import NCol, decimal_ps, decimal_type, leaf_kind, to_decimal
from delta_tpu_torch.expr.vectorized import DEFAULT_TYPE, HostColumn, HostTable
from delta_tpu_torch.utils.config import conf

__all__ = [
    "write_parquet_file",
    "write_parquet_files",
    "read_parquet_file",
    "read_parquet_files",
    "read_parquet_batch",
    "read_metadata",
    "column_names",
    "collect_stats",
    "stats_json",
    "json_stat_value",
    "chunk_statistics",
    "ROW_GROUP_ROWS",
]

MAGIC = b"PAR1"
#: the default of ``delta.tpu.write.rowGroupRows``, the rows per row group
#: the writer emits
ROW_GROUP_ROWS = 131_072

# CompressionCodec, PageType, FieldRepetitionType, ConvertedType (parquet.thrift)
UNCOMPRESSED, SNAPPY, GZIP, ZSTD, LZ4_RAW = 0, 1, 2, 6, 7
_CODEC_NAMES = {0: "UNCOMPRESSED", 1: "SNAPPY", 2: "GZIP", 3: "LZO", 4: "BROTLI",
                5: "LZ4", 6: "ZSTD", 7: "LZ4_RAW"}
DATA_PAGE, DICTIONARY_PAGE, DATA_PAGE_V2 = 0, 2, 3
OPTIONAL, REPEATED = 1, 2
_UTF8, _ENUM, _DECIMAL, _DATE, _TS_MILLIS, _TS_MICROS = 0, 4, 5, 6, 9, 10
_INT_8, _INT_16, _INT_32, _INT_64, _JSON = 15, 16, 17, 18, 19

_EPOCH_DAY = _dt.date(1970, 1, 1)
_EPOCH_TS = _dt.datetime(1970, 1, 1)


# -- stats (the JAX package's exec/parquet.py:33-100) ---------------------------


def json_stat_value(v: Any, round_up: bool = False) -> Any:
    """Encode one Python min/max value for the protocol's JSON stats."""
    if isinstance(v, _dt.datetime):
        if round_up and v.microsecond % 1000:
            # maxValues truncated to ms must round UP or data skipping would
            # prune files containing sub-millisecond maxima
            v = v + _dt.timedelta(microseconds=1000 - v.microsecond % 1000)
        return v.strftime("%Y-%m-%dT%H:%M:%S.%f")[:-3] + "Z"
    if isinstance(v, _dt.date):
        return v.isoformat()
    if isinstance(v, float) and (math.isnan(v) or math.isinf(v)):
        return None
    if isinstance(v, bytes):
        return None  # binary stats not representable in JSON stats
    if isinstance(v, _decimal.Decimal):
        return None
    return v


def _py(kind: str, v: Any) -> Any:
    """A column value as the Python object ``pyarrow``'s ``as_py`` gives."""
    if kind == "int":
        return int(v)
    if kind == "double":
        return float(v)
    if kind == "bool":
        return bool(v)
    if kind == "date":
        return _EPOCH_DAY + _dt.timedelta(days=int(v))
    if kind == "ts":
        return _EPOCH_TS + _dt.timedelta(microseconds=int(v))
    return v


def _min_max(col: HostColumn) -> Optional[Tuple[Any, Any]]:
    """(min, max) over the valid values, as ``pyarrow.compute.min``/``max``
    give them (NaN skipped unless every value is NaN); None when every value
    is NULL."""
    vals = col.values[col.valid]
    if len(vals) == 0:
        return None
    if col.kind == "double":
        finite = vals[~np.isnan(vals)]
        if len(finite) == 0:
            return math.nan, math.nan
        return float(finite.min()), float(finite.max())
    if col.kind in ("str", "object"):
        lst = vals.tolist()
        return min(lst), max(lst)
    return _py(col.kind, vals.min()), _py(col.kind, vals.max())


def collect_stats(table: HostTable, num_indexed_cols: int = 32) -> Dict[str, Any]:
    """Per-file stats over the first ``num_indexed_cols`` leaf columns."""
    mins: Dict[str, Any] = {}
    maxs: Dict[str, Any] = {}
    nulls: Dict[str, Any] = {}
    names = table.column_names[: num_indexed_cols if num_indexed_cols >= 0 else None]
    for name in names:
        col = table.columns[name]
        null_count = int(len(col.valid) - col.valid.sum())
        nulls[name] = null_count
        skippable = col.kind in ("int", "double", "str", "date", "ts", "bool")
        if not skippable or null_count == table.num_rows:
            continue
        mm = _min_max(col)
        mn = json_stat_value(mm[0])
        mx = json_stat_value(mm[1], round_up=True)
        if mn is not None:
            mins[name] = mn
        if mx is not None:
            maxs[name] = mx
    return {
        "numRecords": table.num_rows,
        "minValues": mins,
        "maxValues": maxs,
        "nullCount": nulls,
    }


def stats_json(table: HostTable, num_indexed_cols: int = 32) -> str:
    return json.dumps(collect_stats(table, num_indexed_cols))


# -- column types ----------------------------------------------------------------

#: stored type -> (kind, physical type, LogicalType, ConvertedType); a
#: decimal's entry is built by :func:`_type_entry`
_TYPES = {
    "bool": ("bool", enc.BOOLEAN, None, None),
    "int8": ("int", enc.INT32, thrift.LogicalType(INTEGER=thrift.IntType(
        bitWidth=8, isSigned=True)), _INT_8),
    "int16": ("int", enc.INT32, thrift.LogicalType(INTEGER=thrift.IntType(
        bitWidth=16, isSigned=True)), _INT_16),
    "int32": ("int", enc.INT32, None, None),
    "int64": ("int", enc.INT64, None, None),
    "float32": ("double", enc.FLOAT, None, None),
    "float64": ("double", enc.DOUBLE, None, None),
    "string": ("str", enc.BYTE_ARRAY, thrift.LogicalType(STRING=thrift.Empty()), _UTF8),
    "binary": ("object", enc.BYTE_ARRAY, None, None),
    "date32": ("date", enc.INT32, thrift.LogicalType(DATE=thrift.Empty()), _DATE),
    "timestamp[us]": ("ts", enc.INT64, thrift.LogicalType(TIMESTAMP=thrift.TimestampType(
        isAdjustedToUTC=False, unit=thrift.TimeUnit(MICROS=thrift.Empty()))), None),
    "timestamp[us, tz=UTC]": ("ts", enc.INT64, thrift.LogicalType(
        TIMESTAMP=thrift.TimestampType(isAdjustedToUTC=True,
                                       unit=thrift.TimeUnit(MICROS=thrift.Empty()))),
        _TS_MICROS),
}
_INT_RANGE = {"int8": 8, "int16": 16, "int32": 32, "int64": 64}


def _type_entry(stype: str):
    """``_TYPES``'s entry of a stored type, a decimal's included (None for
    an unknown type)."""
    ps = decimal_ps(stype)
    if ps is None:
        return _TYPES.get(stype)
    return ("decimal", enc.FIXED_LEN_BYTE_ARRAY,
            thrift.LogicalType(DECIMAL=thrift.DecimalType(scale=ps[1], precision=ps[0])),
            _DECIMAL)


def _leaf_element(name: str, stype: str, repetition: int):
    """The ``SchemaElement`` the writer gives a leaf of ``stype``."""
    entry = _type_entry(stype)
    if entry is None:
        raise _unsupported(name, f"type {stype!r}")
    _, ptype, lt, ct = entry
    ps = decimal_ps(stype)
    if ps is None:
        return thrift.SchemaElement(type=ptype, repetition_type=repetition, name=name,
                                    converted_type=ct, logicalType=lt)
    if not 1 <= ps[0] <= 38:
        raise _unsupported(name, f"a DECIMAL of precision {ps[0]}")
    return thrift.SchemaElement(type=ptype, type_length=enc.decimal_width(ps[0]),
                                repetition_type=repetition, name=name, converted_type=ct,
                                logicalType=lt, scale=ps[1], precision=ps[0])


def _unsupported(name: str, what: str) -> NotImplementedError:
    return NotImplementedError(f"Parquet column {name!r}: {what} is not supported by the "
                               "port's Parquet codec")


def _leaf_type(el) -> Tuple[str, int]:
    """(stored type, scale of a timestamp to µs) of a leaf
    ``SchemaElement``; raises for what the codec does not cover."""
    name, pt, lt, ct = el.name, el.type, el.logicalType, el.converted_type
    if (lt is not None and lt.DECIMAL is not None) or ct == _DECIMAL:
        if pt not in (enc.INT32, enc.INT64, enc.FIXED_LEN_BYTE_ARRAY, enc.BYTE_ARRAY):
            raise _unsupported(name, f"a DECIMAL stored as {enc.TYPE_NAMES.get(pt, pt)}")
        dec = lt.DECIMAL if lt is not None and lt.DECIMAL is not None else el
        precision, scale = int(dec.precision or 0), int(dec.scale or 0)
        if not 1 <= precision <= 38:
            raise _unsupported(name, f"a DECIMAL of precision {precision}")
        return decimal_type(precision, scale), 1
    if pt in (enc.INT96, enc.FIXED_LEN_BYTE_ARRAY):
        raise _unsupported(name, f"physical type {enc.TYPE_NAMES[pt]}")
    if pt == enc.BOOLEAN:
        return "bool", 1
    if pt in (enc.FLOAT, enc.DOUBLE):
        return ("float32" if pt == enc.FLOAT else "float64"), 1
    if pt == enc.BYTE_ARRAY:
        if lt is not None and (lt.STRING is not None or lt.ENUM is not None
                               or lt.JSON is not None):
            return "string", 1
        if ct in (_UTF8, _ENUM, _JSON):
            return "string", 1
        if lt is not None and any(getattr(lt, f) is not None for f in ("BSON", "UUID")):
            raise _unsupported(name, "a BSON/UUID BYTE_ARRAY column")
        return "binary", 1
    # INT32 / INT64
    if lt is not None and lt.INTEGER is not None:
        if not lt.INTEGER.isSigned:
            raise _unsupported(name, f"an unsigned {lt.INTEGER.bitWidth}-bit integer column")
        return f"int{lt.INTEGER.bitWidth}", 1
    if ct in (11, 12, 13, 14):
        raise _unsupported(name, "an unsigned integer column")
    if pt == enc.INT32:
        if (lt is not None and lt.DATE is not None) or ct == _DATE:
            return "date32", 1
        if _has_logical(lt):
            raise _unsupported(name, "an INT32 column of this logical type")
        if ct is not None and ct not in (_INT_8, _INT_16, _INT_32):
            raise _unsupported(name, "an INT32 column of this converted type")
        return {_INT_8: "int8", _INT_16: "int16"}.get(ct, "int32"), 1
    ts = lt.TIMESTAMP if lt is not None else None
    if ts is not None:
        unit = ts.unit
        tz = ", tz=UTC" if ts.isAdjustedToUTC else ""
        if unit.MICROS is not None:
            return f"timestamp[us{tz}]", 1
        if unit.MILLIS is not None:
            return f"timestamp[us{tz}]", 1000
        raise _unsupported(name, "a nanosecond timestamp column")
    if ct in (_TS_MICROS, _TS_MILLIS):
        return "timestamp[us, tz=UTC]", (1000 if ct == _TS_MILLIS else 1)
    if _has_logical(lt):
        raise _unsupported(name, "an INT64 column of this logical type")
    if ct is not None and ct != _INT_64:
        raise _unsupported(name, "an INT64 column of this converted type")
    return "int64", 1


def _has_logical(lt) -> bool:
    return lt is not None and any(getattr(lt, f) is not None
                                  for f, _ in thrift.LogicalType.FIELDS.values())


# -- reading ---------------------------------------------------------------------


def read_metadata(abs_path: str):
    """The file's footer (``thrift.FileMetaData``)."""
    with open(abs_path, "rb") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        if size < 12:
            raise ValueError(f"{abs_path}: {size} bytes is too short for a Parquet file")
        f.seek(size - 8)
        tail = f.read(8)
        if tail[4:] != MAGIC:
            raise ValueError(f"{abs_path}: not a Parquet file (no PAR1 footer)")
        (n,) = struct.unpack("<I", tail[:4])
        if n + 12 > size:
            raise ValueError(f"{abs_path}: footer length {n} exceeds the file")
        f.seek(size - 8 - n)
        meta, _ = thrift.read(thrift.FileMetaData, f.read(n))
    return meta


def _top_level(schema) -> Dict[str, Tuple[Any, int]]:
    """top-level name -> (element, leaf index) for flat leaves, or (element,
    -1) for a group (nested) column."""
    out: Dict[str, Tuple[Any, int]] = {}
    root = schema[0]
    i, leaf = 1, 0
    for _ in range(root.num_children or 0):
        el = schema[i]

        def skip(j):  # index after the subtree at j, and its leaf count
            n = schema[j].num_children or 0
            j += 1
            leaves = 0 if n else 1
            for _ in range(n):
                j, lv = skip(j)
                leaves += lv
            return j, leaves

        nxt, leaves = skip(i)
        nested = bool(el.num_children) or el.repetition_type == REPEATED
        out[el.name] = (el, -1 if nested else leaf)
        leaf += leaves
        i = nxt
    return out


def _decompress(codec: int, raw, size: int, name: str) -> bytes:
    """A page body of a codec other than SNAPPY (the batch's), on the host."""
    if codec == GZIP:
        try:
            return zlib.decompress(raw, 47)  # gzip or zlib header
        except zlib.error as e:
            raise ValueError(f"Parquet column {name!r}: corrupt GZIP page: {e}") from e
    if codec == ZSTD:
        try:
            return zstd.decompress(raw, size)
        except zstd.ZstdError as e:
            raise ValueError(f"Parquet column {name!r}: corrupt ZSTD page: {e}") from e
    if codec == LZ4_RAW:
        try:
            return lz4.decompress(raw, size)
        except lz4.Lz4Error as e:
            raise ValueError(f"Parquet column {name!r}: corrupt LZ4_RAW page: {e}") from e
    raise _unsupported(name, f"codec {_CODEC_NAMES.get(codec, codec)}")


class _Page:
    """A page of a column chunk, its header parsed: ``levels`` a v2 page's
    level bytes (stored uncompressed ahead of its body), ``body`` the bytes
    as stored until :func:`_inflate` replaces them with the page's
    uncompressed ones (``size`` bytes)."""

    __slots__ = ("header", "levels", "body", "size", "compressed")

    def __init__(self, header, levels, body, size, compressed):
        self.header, self.levels, self.body = header, levels, body
        self.size, self.compressed = size, compressed


def _chunk_start(md) -> int:
    start = md.dictionary_page_offset if md.dictionary_page_offset else md.data_page_offset
    return min(start, md.data_page_offset)


def _parse_pages(data, md, name: str, pos: int = 0) -> List[_Page]:
    """The pages of one column chunk whose bytes start at ``data[pos]``:
    headers until the chunk's values are all seen."""
    end = min(pos + md.total_compressed_size, len(data))
    pages: List[_Page] = []
    seen = 0
    while seen < md.num_values:
        ph, pos = thrift.read(thrift.PageHeader, data, pos)
        body_end = pos + ph.compressed_page_size
        if body_end > end:
            raise ValueError(f"Parquet column {name!r}: page runs past its column chunk")
        if ph.type == DICTIONARY_PAGE:
            dh = ph.dictionary_page_header
            if dh.encoding not in (enc.PLAIN, enc.PLAIN_DICTIONARY):
                raise _unsupported(name, f"dictionary encoding "
                                   f"{enc.ENCODING_NAMES.get(dh.encoding, dh.encoding)}")
            pages.append(_Page(ph, None, data[pos:body_end], ph.uncompressed_page_size, True))
        elif ph.type == DATA_PAGE:
            pages.append(_Page(ph, None, data[pos:body_end], ph.uncompressed_page_size, True))
            seen += ph.data_page_header.num_values
        elif ph.type == DATA_PAGE_V2:
            dh = ph.data_page_header_v2
            lv = (dh.repetition_levels_byte_length or 0) + (dh.definition_levels_byte_length or 0)
            pages.append(_Page(ph, data[pos:pos + lv], data[pos + lv:body_end],
                               ph.uncompressed_page_size - lv,
                               dh.is_compressed is None or bool(dh.is_compressed)))
            seen += dh.num_values
        pos = body_end
    return pages


def _inflate(chunks: Sequence[Tuple[List[_Page], int, str, str]], device) -> None:
    """Every page of ``chunks`` (pages, codec, column name, the file's
    path) uncompressed in place: the SNAPPY pages of them all in one batch
    on ``device`` (``exec/snappy.decompress_pages``), GZIP, ZSTD and
    LZ4_RAW pages by their host decoders."""
    jobs: List[_Page] = []
    labels: List[str] = []
    for pages, codec, name, source in chunks:
        for p in pages:
            if not p.compressed or codec == UNCOMPRESSED:
                continue
            if codec == SNAPPY:
                jobs.append(p)
                labels.append(f"{source}: column {name!r}" if source else f"column {name!r}")
            else:
                p.body = _decompress(codec, p.body, p.size, name)
    if jobs:
        out = snappy.decompress_pages([p.body for p in jobs], [p.size for p in jobs], device,
                                      labels)
        for p, body in zip(jobs, out):
            p.body = body


def _decode_values(name: str, buf, pos: int, end: int, encoding: int, ptype: int,
                   count: int, dictionary, width: int = 0):
    if encoding == enc.PLAIN:
        if ptype == enc.FIXED_LEN_BYTE_ARRAY:
            return enc.decode_fixed(buf, pos, end, width, count)
        return enc.decode_plain(buf, pos, end, ptype, count)
    if encoding in (enc.RLE_DICTIONARY, enc.PLAIN_DICTIONARY):
        if dictionary is None:
            raise ValueError(f"Parquet column {name!r}: dictionary-encoded page "
                             "without a dictionary page")
        idx = enc.decode_dictionary_indices(buf, pos, end, count)
        if len(idx) and int(idx.max()) >= len(dictionary):
            raise ValueError(f"Parquet column {name!r}: dictionary index out of range")
        return dictionary[idx]
    if encoding == enc.BYTE_STREAM_SPLIT and ptype != enc.FIXED_LEN_BYTE_ARRAY:
        return enc.decode_byte_stream_split(buf, pos, end, ptype, count)
    if encoding == enc.RLE and ptype == enc.BOOLEAN:
        (n,) = struct.unpack_from("<I", buf, pos)
        return enc.decode_hybrid(buf, pos + 4, pos + 4 + n, 1, count).astype(bool)
    raise _unsupported(name, f"encoding {enc.ENCODING_NAMES.get(encoding, encoding)}")


def _dictionary(name: str, page, ptype: int, count: int, width: int):
    if ptype == enc.FIXED_LEN_BYTE_ARRAY:
        return enc.decode_fixed(page, 0, len(page), width, count)
    return _as_array(ptype, enc.decode_plain(page, 0, len(page), ptype, count))


def _as_array(ptype: int, vals):
    # np.fromiter keeps each bytes object whole (np.array would make a
    # fixed-width bytes array and strip trailing NULs)
    if ptype == enc.BYTE_ARRAY and isinstance(vals, list):
        return np.fromiter(vals, object, len(vals))
    return vals


def _empty_dense(ptype: int, width: int):
    if ptype == enc.FIXED_LEN_BYTE_ARRAY:
        return np.zeros((0, width), np.uint8)
    return _as_array(ptype, [])


def _decode_chunk(pages: List[_Page], el, md, num_rows: int):
    """One flat column chunk from its inflated pages: (physical values,
    valid mask), values zero/None at NULL rows."""
    name = el.name
    ptype = md.type
    width = int(el.type_length or 0)
    optional = el.repetition_type == OPTIONAL
    dictionary = None
    values: List[Any] = []
    valids: List[np.ndarray] = []
    for pg in pages:
        ph, page = pg.header, pg.body
        if ph.type == DICTIONARY_PAGE:
            dictionary = _dictionary(name, page, ptype, ph.dictionary_page_header.num_values,
                                     width)
        elif ph.type == DATA_PAGE:
            dh = ph.data_page_header
            n = dh.num_values
            p = 0
            if optional:
                if dh.definition_level_encoding != enc.RLE:
                    raise _unsupported(name, "definition levels encoded "
                                       f"{enc.ENCODING_NAMES.get(dh.definition_level_encoding)}")
                (ln,) = struct.unpack_from("<I", page, 0)
                valid = enc.decode_hybrid(page, 4, 4 + ln, 1, n).astype(bool)
                p = 4 + ln
            else:
                valid = np.ones(n, bool)
            k = int(valid.sum())
            vals = _decode_values(name, page, p, len(page), dh.encoding, ptype, k, dictionary,
                                  width)
            values.append(_as_array(ptype, vals))
            valids.append(valid)
        else:  # DATA_PAGE_V2
            dh = ph.data_page_header_v2
            n = dh.num_values
            dl, rl = dh.definition_levels_byte_length, dh.repetition_levels_byte_length or 0
            # a flat column's repetition levels (if a writer stores any) are
            # all 0: the definition levels follow them
            if optional:
                valid = enc.decode_hybrid(pg.levels, rl, rl + dl, 1, n).astype(bool)
            else:
                valid = np.ones(n, bool)
            k = n - int(dh.num_nulls or 0) if optional else n
            if k != int(valid.sum()):
                raise ValueError(f"Parquet column {name!r}: page null count disagrees "
                                 "with its definition levels")
            vals = _decode_values(name, page, 0, len(page), dh.encoding, ptype, k, dictionary,
                                  width)
            values.append(_as_array(ptype, vals))
            valids.append(valid)
    valid = np.concatenate(valids) if valids else np.zeros(0, bool)
    if len(valid) != num_rows:
        raise ValueError(f"Parquet column {name!r}: {len(valid)} values in a row group "
                         f"of {num_rows} rows")
    dense = np.concatenate(values) if values else _empty_dense(ptype, width)
    return dense, valid


def _decimal_dense(stype: str, ptype: int, dense) -> np.ndarray:
    """A decimal chunk's physical values as unscaled integers (int64 up to
    18 digits, else Python ints)."""
    wide = decimal_ps(stype)[0] > 18
    if ptype == enc.FIXED_LEN_BYTE_ARRAY:
        return enc.decimal_from_bytes(np.asarray(dense, np.uint8), wide)
    if ptype == enc.BYTE_ARRAY:
        vals = [int.from_bytes(bytes(b), "big", signed=True) for b in np.asarray(dense).tolist()]
        if wide:
            out = np.empty(len(vals), object)
            out[:] = vals
            return out
        return np.array([((v + (1 << 63)) % (1 << 64)) - (1 << 63) for v in vals], np.int64)
    vals = np.asarray(dense).astype(np.int64)
    return vals.astype(object) if wide else vals


def _leaf_values(stype: str, scale: int, dense, present: np.ndarray, ptype: int):
    """Dense physical values placed at the ``present`` slots."""
    kind = leaf_kind(stype)
    n = len(present)
    if kind in ("str", "object"):
        out = np.empty(n, object)
        if len(dense):
            flat = dense
            if kind == "str":
                if flat.dtype.kind == "S":
                    # fixed-width bytes: decode each distinct value once
                    uniq, inv = np.unique(flat, return_inverse=True)
                    flat = np.array([u.decode("utf-8") for u in uniq.tolist()],
                                    object)[inv.ravel()]
                else:
                    flat = np.fromiter((b.decode("utf-8") for b in flat.tolist()), object,
                                       len(flat))
            elif flat.dtype.kind == "S":
                flat = flat.astype(object)
            out[present] = flat
        return out
    if kind == "decimal":
        flat = _decimal_dense(stype, ptype, dense)
        if flat.dtype == object:
            out = np.empty(n, object)
            out.fill(0)
        else:
            out = np.zeros(n, np.int64)
        out[present] = flat
        return out
    np_dt = {"bool": bool, "double": np.float64}.get(kind, np.int64)
    out = np.zeros(n, np_dt)
    if len(dense):
        flat = np.asarray(dense)
        out[present] = flat.astype(np_dt) * scale if scale != 1 else flat
    return out


def _to_column(stype: str, scale: int, chunks: List[Tuple[Any, np.ndarray]],
               ptype: int) -> HostColumn:
    kind = leaf_kind(stype)
    valid = np.concatenate([v for _, v in chunks]) if chunks else np.zeros(0, bool)
    flat = np.concatenate([d for d, _ in chunks]) if chunks else _empty_dense(ptype, 1)
    vals = _leaf_values(stype, scale, flat, valid, ptype)
    return HostColumn(kind, vals, valid, stype if stype != DEFAULT_TYPE.get(kind) else None)


def column_names(meta) -> List[str]:
    """The file's top-level column names (``pyarrow``'s
    ``schema_arrow.names``)."""
    return list(_top_level(meta.schema))


class _PendingRead:
    """One file's read with its page headers parsed and its pages not yet
    inflated (:func:`_load_file`, then :func:`_inflate` of ``todo``, then
    :func:`_finish_file`)."""

    __slots__ = ("meta", "top", "names", "groups", "row_groups", "tree", "flat", "types",
                 "pages", "todo")


def _load_file(abs_path: str, columns: Optional[Sequence[str]], row_groups, meta) -> _PendingRead:
    r = _PendingRead()
    if meta is None:
        meta = read_metadata(abs_path)
    r.meta, r.row_groups = meta, row_groups
    r.top = _top_level(meta.schema)
    r.names = list(r.top) if columns is None else list(columns)
    for c in r.names:
        if c not in r.top:
            raise KeyError(f"{abs_path}: no column {c!r} (columns: {list(r.top)})")
    all_groups = meta.row_groups or []
    r.groups = all_groups if row_groups is None else [all_groups[i] for i in row_groups]
    r.tree = None
    r.flat, r.types, r.pages, r.todo = {}, {}, {}, []
    with open(abs_path, "rb") as f:

        def load(md, name):
            f.seek(_chunk_start(md))
            return _parse_pages(f.read(md.total_compressed_size), md, name)

        for c in r.names:
            el, leaf = r.top[c]
            if leaf < 0:
                if r.tree is None:
                    r.tree = {node.name: node for node in _schema_tree(meta.schema).children}
                _load_top(r.tree[c], r.groups, load, abs_path, r.pages, r.todo)
                continue
            r.types[c] = _leaf_type(el)
            r.flat[c] = []
            for rg in r.groups:
                md = rg.columns[leaf].meta_data
                pgs = load(md, c)
                r.flat[c].append(pgs)
                r.todo.append((pgs, md.codec, c, abs_path))
    return r


def _finish_file(r: _PendingRead) -> HostTable:
    cols: Dict[str, HostColumn] = {}
    for c in r.names:
        el, leaf = r.top[c]
        if leaf < 0:
            ncol = _read_top(r.tree[c], r.groups, r.pages)
            cols[c] = HostColumn("nested", ncol, ncol.valid, _spec_of(ncol, c))
            continue
        stype, scale = r.types[c]
        chunks = [_decode_chunk(pgs, el, rg.columns[leaf].meta_data, rg.num_rows)
                  for pgs, rg in zip(r.flat[c], r.groups)]
        cols[c] = _to_column(stype, scale, chunks, el.type)
    n = (int(r.meta.num_rows) if r.row_groups is None
         else sum(int(rg.num_rows) for rg in r.groups))
    return HostTable(cols, n)


def read_parquet_file(abs_path: str, columns: Optional[Sequence[str]] = None,
                      row_groups: Optional[Sequence[int]] = None, meta=None,
                      device="cuda") -> HostTable:
    """A data file's columns (all, or ``columns`` in the order given) as a
    ``HostTable``: every row group, or those of ``row_groups`` in the order
    given. ``meta`` is the file's footer where the caller has read it. A
    nested column is a ``nested`` column (Dremel levels, ``expr/nested``).
    The page headers of every chunk read are parsed first, then the SNAPPY
    pages of them all inflate in one batch on ``device``, then the values
    decode."""
    return read_parquet_batch([(abs_path, columns, row_groups, meta)], device)[0]


def read_parquet_batch(reads: Sequence[Tuple[str, Optional[Sequence[str]], Any, Any]],
                       device="cuda") -> List[HostTable]:
    """Several reads (``(abs_path, columns, row_groups, meta)`` each, as
    :func:`read_parquet_file` takes them) with the SNAPPY pages of them all
    in one batch on ``device``: a scan over many small files pays one
    launch set, not one a file."""
    pending = [_load_file(*r) for r in reads]
    _inflate([t for r in pending for t in r.todo], device)
    return [_finish_file(r) for r in pending]


def _spec_of(col: NCol, name: str):
    """The spec of a decoded nested column (raises where a leaf could not
    be decoded)."""
    if col.kind == "leaf":
        if col.unsupported:
            raise _unsupported(*col.unsupported)
        return col.stype
    if col.kind == "struct":
        return ("struct", tuple((k, _spec_of(c, k)) for k, c in col.fields.items()))
    if col.kind == "list":
        return ("list", _spec_of(col.element, name))
    key, value = list(col.element.fields.values())[:2]
    return ("map", _spec_of(key, name), _spec_of(value, name))


def _stat_value(el, ptype: int, raw: bytes) -> Any:
    """One PLAIN-encoded footer statistic as ``pyarrow`` gives it: int,
    float, bool, str for a string column and bytes for a binary one, a
    ``date``, a ``datetime`` (aware in UTC where the column is adjusted to
    UTC), a ``Decimal``. Raises for a column the codec does not cover."""
    stype, scale = _leaf_type(el)
    ps = decimal_ps(stype)
    if ps is not None:
        if ptype in (enc.FIXED_LEN_BYTE_ARRAY, enc.BYTE_ARRAY):
            v = int.from_bytes(bytes(raw), "big", signed=True)
        else:
            v = int.from_bytes(bytes(raw), "little", signed=True)
        return to_decimal(v, ps[1])
    if ptype == enc.BYTE_ARRAY:
        return raw.decode("utf-8") if stype == "string" else bytes(raw)
    if ptype == enc.BOOLEAN:
        return raw[0] != 0
    v = enc.decode_plain(raw, 0, len(raw), ptype, 1)[0]
    if ptype in (enc.FLOAT, enc.DOUBLE):
        return float(v)
    v = int(v)
    if stype == "date32":
        return _EPOCH_DAY + _dt.timedelta(days=v)
    if stype.startswith("timestamp"):
        ts = _EPOCH_TS + _dt.timedelta(microseconds=v * scale)
        return ts.replace(tzinfo=_dt.timezone.utc) if "UTC" in stype else ts
    return v


def chunk_statistics(meta, rg: int, leaf: int):
    """Row group ``rg``'s statistics for leaf column ``leaf``: ``(null_count
    or None, (min, max) or None)``, or None where the chunk has none. Only
    ``min_value``/``max_value`` are read; the deprecated ``min``/``max``
    fields count as absent (a group without bounds is kept)."""
    md = meta.row_groups[rg].columns[leaf].meta_data
    st = md.statistics
    if st is None:
        return None
    bounds = None
    if st.min_value is not None and st.max_value is not None:
        el = _leaves(meta.schema)[leaf]
        bounds = (_stat_value(el, md.type, st.min_value), _stat_value(el, md.type, st.max_value))
    return st.null_count, bounds


def _leaves(schema) -> List[Any]:
    """The leaf ``SchemaElement`` of each column chunk, in chunk order."""
    return [el for el in schema[1:] if not el.num_children]


def read_parquet_files(abs_paths: Sequence[str], columns: Optional[Sequence[str]] = None,
                       device="cuda") -> List[HostTable]:
    """Read data files, their pages in one batch; one table per file."""
    return read_parquet_batch([(p, columns, None, None) for p in abs_paths], device)


# -- writing ---------------------------------------------------------------------


def _stored_type(name: str, col: HostColumn) -> str:
    if col.type is not None:
        entry = _type_entry(col.type) if isinstance(col.type, str) else None
        if entry is None or entry[0] != col.kind:
            raise _unsupported(name, f"type {col.type!r} for a {col.kind} column")
        return col.type
    if col.kind not in DEFAULT_TYPE:
        raise _unsupported(name, f"a {col.kind} column")
    return DEFAULT_TYPE[col.kind]


def _physical(stype: str, kind: str, vals: np.ndarray):
    """The PLAIN-encodable values (dense, valid rows only) of one chunk."""
    if kind == "str":
        return [v.encode("utf-8") for v in vals.tolist()]
    if kind == "object":
        return [bytes(v) for v in vals.tolist()]
    if kind == "decimal":
        return enc.decimal_to_bytes(vals, enc.decimal_width(decimal_ps(stype)[0]))
    if stype == "float32":
        return vals.astype(np.float32)
    if stype in _INT_RANGE:
        bits = _INT_RANGE[stype]
        if len(vals) and (vals.min() < -(1 << (bits - 1)) or vals.max() >= 1 << (bits - 1)):
            raise ValueError(f"a value does not fit {stype}")
        return vals.astype(np.int32 if bits < 64 else np.int64)
    if kind in ("date",):
        return vals.astype(np.int32)
    return vals


def _stat_bytes(ptype: int, v) -> bytes:
    if ptype == enc.BYTE_ARRAY:
        return bytes(v)
    if ptype == enc.BOOLEAN:
        return b"\x01" if v else b"\x00"
    return enc.encode_plain(ptype, np.asarray([v]))


def _chunk_stats(ptype: int, stype: str, vals, physical, nulls: int):
    """A chunk's footer statistics: ``vals`` are its dense values, as the
    column holds them, ``physical`` the same values as they are encoded. A
    decimal's bounds are the signed order of its unscaled values."""
    st = thrift.Statistics(null_count=nulls)
    ps = decimal_ps(stype)
    if ps is not None:
        if len(vals):
            width = enc.decimal_width(ps[0])
            bounds = np.array([vals.min(), vals.max()], vals.dtype)
            raw = enc.decimal_to_bytes(bounds, width)
            st.min_value, st.max_value = raw[0].tobytes(), raw[1].tobytes()
    elif ptype == enc.BYTE_ARRAY:
        if physical:
            st.min_value, st.max_value = min(physical), max(physical)
    elif len(physical):
        vals = physical
        if ptype in (enc.FLOAT, enc.DOUBLE):
            vals = vals[~np.isnan(vals)]
        if len(vals):
            mn, mx = vals.min(), vals.max()
            if ptype in (enc.FLOAT, enc.DOUBLE):  # the spec's signed zeros
                mn = -abs(mn) if mn == 0 else mn
                mx = abs(mx) if mx == 0 else mx
            st.min_value, st.max_value = _stat_bytes(ptype, mn), _stat_bytes(ptype, mx)
    if st.min_value is not None:
        st.is_min_value_exact = st.is_max_value_exact = True
    return st


#: Arrow's ``data_page_size``: a chunk's data pages are cut at the first
#: record boundary past each multiple of this many bytes of encoded values
PAGE_BYTES = 1 << 20
#: the bytes of a column's first buffer that ``_compresses_well`` samples
_SAMPLE = 65536
#: ``delta.tpu.write.compression`` -> codec; the JAX package's other codecs
#: are not written by the port (ROADMAP.md queue A item 3)
_WRITE_CODECS = {"none": UNCOMPRESSED, "uncompressed": UNCOMPRESSED, "snappy": SNAPPY,
                 "gzip": GZIP}
_UNWRITTEN = ("zstd", "lz4", "lz4_raw", "brotli")


def _write_codec(name: str) -> int:
    key = str(name).lower()
    if key in _UNWRITTEN:
        raise NotImplementedError(
            f"delta.tpu.write.compression={name!r}: the port writes SNAPPY, GZIP or no codec; "
            "ZSTD, LZ4 and BROTLI writes are ROADMAP.md queue A item 3")
    if key not in _WRITE_CODECS:
        raise ValueError(f"delta.tpu.write.compression={name!r}: not a Parquet codec "
                         "(auto, none, uncompressed, snappy, gzip)")
    return _WRITE_CODECS[key]


class _Leaf:
    """One column chunk's source: a flat column (``col``: its values and
    validity are the levels) or a nested leaf shredded into definition and
    repetition levels (``d``, ``r``: one entry a level, ``dense``: the
    values at the full definition level), with how it is written: its
    ``codec``, a ``dictionary``, or BYTE_STREAM_SPLIT (``bss``)."""

    __slots__ = ("path", "stype", "col", "d", "r", "dense", "max_d", "max_r",
                 "row_starts", "dense_starts", "codec", "dictionary", "bss")

    def __init__(self, path, stype, col=None, d=None, r=None, dense=None, max_d=1, max_r=0):
        self.path, self.stype, self.col = path, stype, col
        self.d, self.r, self.dense, self.max_d, self.max_r = d, r, dense, max_d, max_r
        self.codec, self.dictionary, self.bss = UNCOMPRESSED, False, False
        if col is None:
            self.row_starts = np.concatenate([np.flatnonzero(r == 0), [len(r)]])
            self.dense_starts = np.concatenate([[0], np.cumsum(d == max_d)])

    def values(self, lo: int, hi: int):
        """The dense values of rows ``lo:hi``."""
        if self.col is not None:
            return self.col.values[lo:hi][np.asarray(self.col.valid[lo:hi], bool)]
        v0 = int(self.dense_starts[self.row_starts[lo]])
        return self.dense[v0:int(self.dense_starts[self.row_starts[hi]])]

    def value_starts(self, lo: int, hi: int) -> np.ndarray:
        """The index among the dense values of rows ``lo:hi`` at which each
        row boundary ``lo..hi`` falls."""
        if self.col is not None:
            return np.concatenate([[0], np.cumsum(np.asarray(self.col.valid[lo:hi], bool))])
        at = self.dense_starts[self.row_starts[lo:hi + 1]]
        return at - at[0]

    def levels(self, lo: int, hi: int) -> Tuple[bytes, int]:
        """Rows ``lo:hi``: (a v1 page's level bytes, its entry count)."""
        if self.col is not None:
            lv = enc.encode_hybrid_bits(np.asarray(self.col.valid[lo:hi], bool))
            return struct.pack("<I", len(lv)) + lv, hi - lo
        e0, e1 = int(self.row_starts[lo]), int(self.row_starts[hi])
        body = bytearray()
        if self.max_r:
            lv = enc.encode_hybrid(self.r[e0:e1], _levels_bits(self.max_r))
            body += struct.pack("<I", len(lv)) + lv
        if self.max_d:
            lv = enc.encode_hybrid(self.d[e0:e1], _levels_bits(self.max_d))
            body += struct.pack("<I", len(lv)) + lv
        return bytes(body), e1 - e0


def _leaves_of(name: str, col: HostColumn, n: int, schema: List[Any]) -> List[_Leaf]:
    """A top-level column's schema elements (appended to ``schema``) and
    its chunks' sources."""
    if col.kind != "nested":
        stype = _stored_type(name, col)
        schema.append(_leaf_element(name, stype, OPTIONAL))
        return [_Leaf([name], stype, col=col)]
    return _nested_leaves(name, col.type, col.values, n, schema)


def _nested_leaves(name: str, spec, ncol: NCol, n: int, schema: List[Any]) -> List[_Leaf]:
    start = len(schema)
    _schema_elements(name, spec, schema)
    shredded: List[Tuple] = []
    _shred(spec, ncol, n, shredded, name)
    return [_Leaf(path, stype, d=d, r=r, dense=dense, max_d=md, max_r=mr)
            for path, (stype, d, r, dense, md, mr) in zip(_leaf_paths(schema[start:]),
                                                          shredded)]


def _page_cuts(cum: np.ndarray) -> List[int]:
    """Row boundaries ``0..R`` of a run of data pages, cut at the first row
    boundary past each multiple of ``PAGE_BYTES``; ``cum[r]`` is the encoded
    bytes before row ``r``."""
    rows = len(cum) - 1
    total = int(cum[-1]) if rows else 0
    if total <= PAGE_BYTES:
        return [0, rows]
    targets = np.arange(1, total // PAGE_BYTES + 1, dtype=np.int64) * PAGE_BYTES
    cuts = np.unique(np.searchsorted(cum, targets, side="left"))
    return [0] + [c for c in cuts.tolist() if 0 < c < rows] + [rows]


class _PageOut:
    """A page as the writer emits it, before its codec: ``kind``
    (DICTIONARY_PAGE or DATA_PAGE), ``count`` (dictionary entries, or the
    data page's level entries), ``encoding`` and its uncompressed ``body``;
    ``stored`` the bytes after the codec."""

    __slots__ = ("kind", "count", "encoding", "body", "stored")

    def __init__(self, kind, count, encoding, body):
        self.kind, self.count, self.encoding, self.body = kind, count, encoding, body
        self.stored = body


def _value_bytes(physical) -> np.ndarray:
    """The PLAIN bytes before each BYTE_ARRAY value (``len + 1`` entries)."""
    lens = np.fromiter((len(v) for v in physical), np.int64, len(physical)) + 4
    return np.concatenate([[0], np.cumsum(lens)])


def _encode_chunk(leaf: _Leaf, lo: int, hi: int, stats: bool):
    """Rows ``lo:hi`` of ``leaf`` as pages: (pages, encodings, entries,
    footer statistics or None). A dictionary leaf gets a PLAIN dictionary
    page and RLE_DICTIONARY data pages until the dictionary reaches its
    page limit, then PLAIN pages; a ``bss`` leaf BYTE_STREAM_SPLIT pages;
    any other PLAIN. Data pages are cut near ``PAGE_BYTES`` of encoded
    values at record boundaries."""
    kind, ptype, _, _ = _type_entry(leaf.stype)
    vals = leaf.values(lo, hi)
    physical = _physical(leaf.stype, kind, vals)
    vstarts = leaf.value_starts(lo, hi)
    rows = hi - lo
    n_vals = len(physical)
    width = {enc.INT32: 4, enc.FLOAT: 4, enc.INT64: 8, enc.DOUBLE: 8}.get(ptype, 1)
    if ptype == enc.FIXED_LEN_BYTE_ARRAY:
        width = enc.decimal_width(decimal_ps(leaf.stype)[0])
    pages: List[_PageOut] = []
    encodings = [enc.RLE]
    cut_row = 0
    entries = 0

    def data_pages(r0: int, r1: int, cum: np.ndarray, encode, encoding: int) -> None:
        nonlocal entries
        bounds = _page_cuts(cum)
        for a, b in zip(bounds[:-1], bounds[1:]):
            lv, count = leaf.levels(lo + r0 + a, lo + r0 + b)
            v0, v1 = int(vstarts[r0 + a]), int(vstarts[r0 + b])
            pages.append(_PageOut(DATA_PAGE, count, encoding, lv + encode(v0, v1)))
            entries += count

    if leaf.dictionary:
        dvals, idx, k = enc.dictionary_encode(ptype, physical, cuts=vstarts)
        cut_row = rows if k >= n_vals else int(np.searchsorted(vstarts, k, side="left"))
        bw = enc.dictionary_bit_width(len(dvals))
        pages.append(_PageOut(DICTIONARY_PAGE, len(dvals), enc.PLAIN,
                              enc.encode_plain(ptype, dvals)))
        data_pages(0, cut_row, vstarts[:cut_row + 1] * bw // 8,
                   lambda v0, v1: enc.encode_dictionary_indices(idx[v0:v1], bw),
                   enc.RLE_DICTIONARY)
        encodings += [enc.PLAIN, enc.RLE_DICTIONARY]
    if cut_row < rows or not pages:
        rest = vstarts[cut_row:]
        if ptype == enc.BYTE_ARRAY:
            cum_v = _value_bytes(physical)
            cum = cum_v[rest] - cum_v[rest[0]]
        else:
            cum = (rest - rest[0]) * width // (8 if ptype == enc.BOOLEAN else 1)
        if leaf.bss:
            data_pages(cut_row, rows, cum,
                       lambda v0, v1: enc.encode_byte_stream_split(ptype, physical[v0:v1]),
                       enc.BYTE_STREAM_SPLIT)
            encodings.append(enc.BYTE_STREAM_SPLIT)
        else:
            data_pages(cut_row, rows, cum,
                       lambda v0, v1: enc.encode_plain(ptype, physical[v0:v1]), enc.PLAIN)
            if enc.PLAIN not in encodings:
                encodings.append(enc.PLAIN)
    st = (_chunk_stats(ptype, leaf.stype, vals, physical, entries - n_vals)
          if stats else None)
    return pages, encodings, entries, st


def _gzip(body: bytes) -> bytes:
    c = zlib.compressobj(6, zlib.DEFLATED, 31)  # gzip framing, as Arrow writes GZIP
    return c.compress(body) + c.flush()


class _FileOut:
    """A file being written: its schema and leaves, its row groups' bounds
    and encoded chunks (:func:`_encode_file`), its SNAPPY pages still to
    compress (``jobs``)."""

    __slots__ = ("schema", "leaves", "num_rows", "version", "bounds", "groups", "jobs")


def _encode_file(schema: List[Any], leaves: Sequence[_Leaf], num_rows: int, rg_rows: int,
                 stats: bool, version: int) -> _FileOut:
    """Row groups of ``rg_rows`` rows cut at record boundaries (repetition
    level 0), each leaf's chunk encoded, GZIP pages compressed, SNAPPY
    pages listed in ``jobs`` for one batch; footer statistics where
    ``stats``."""
    f = _FileOut()
    f.schema, f.leaves, f.num_rows, f.version = schema, leaves, num_rows, version
    step = max(int(rg_rows), 1)
    f.bounds = [(lo, min(lo + step, num_rows)) for lo in range(0, num_rows, step)]
    if not f.bounds and version == 1:
        f.bounds = [(0, 0)]
    f.groups = [[_encode_chunk(leaf, lo, hi, stats) for leaf in leaves] for lo, hi in f.bounds]
    f.jobs = []
    for chunks in f.groups:
        for leaf, (pages, _, _, _) in zip(leaves, chunks):
            for p in pages:
                if leaf.codec == SNAPPY:
                    f.jobs.append(p)
                elif leaf.codec == GZIP:
                    p.stored = _gzip(p.body)
    return f


def _compress_files(files: Sequence[_FileOut], device) -> None:
    """The SNAPPY pages of every file, in one batch on ``device``."""
    jobs = [p for f in files for p in f.jobs]
    for p, stored in zip(jobs, snappy.compress_pages([p.body for p in jobs], device)):
        p.stored = stored


def _write_file(schema: List[Any], leaves: Sequence[_Leaf], num_rows: int, rg_rows: int,
                stats: bool, version: int, device) -> bytes:
    """The file's bytes: :func:`_encode_file`, its SNAPPY pages in one
    batch on ``device``, v1 data pages."""
    f = _encode_file(schema, leaves, num_rows, rg_rows, stats, version)
    _compress_files([f], device)
    return _file_bytes(f)


def _file_bytes(f: _FileOut) -> bytes:
    """An encoded, compressed file's bytes: its pages and the footer."""
    schema, leaves, num_rows, version = f.schema, f.leaves, f.num_rows, f.version
    bounds, groups = f.bounds, f.groups
    out = bytearray(MAGIC)
    row_groups = []
    for rg_i, ((lo, hi), chunks) in enumerate(zip(bounds, groups)):
        cols = []
        rg_start = len(out)
        rg_raw = 0
        for leaf, (pages, encodings, entries, st) in zip(leaves, chunks):
            ptype = _type_entry(leaf.stype)[1]
            start = len(out)
            dict_at = data_at = None
            raw = 0
            for p in pages:
                if p.kind == DICTIONARY_PAGE:
                    dict_at = len(out)
                    header = thrift.PageHeader(
                        type=DICTIONARY_PAGE, uncompressed_page_size=len(p.body),
                        compressed_page_size=len(p.stored),
                        dictionary_page_header=thrift.DictionaryPageHeader(
                            num_values=p.count, encoding=p.encoding)).write()
                else:
                    if data_at is None:
                        data_at = len(out)
                    header = thrift.PageHeader(
                        type=DATA_PAGE, uncompressed_page_size=len(p.body),
                        compressed_page_size=len(p.stored),
                        data_page_header=thrift.DataPageHeader(
                            num_values=p.count, encoding=p.encoding,
                            definition_level_encoding=enc.RLE,
                            repetition_level_encoding=enc.RLE)).write()
                out += header
                out += p.stored
                raw += len(header) + len(p.body)
            rg_raw += raw
            md = thrift.ColumnMetaData(
                type=ptype, encodings=encodings, path_in_schema=leaf.path, codec=leaf.codec,
                num_values=entries, total_uncompressed_size=raw,
                total_compressed_size=len(out) - start, data_page_offset=data_at,
                dictionary_page_offset=dict_at, statistics=st)
            cols.append(thrift.ColumnChunk(file_offset=start, meta_data=md))
        row_groups.append(thrift.RowGroup(columns=cols, total_byte_size=rg_raw,
                                          num_rows=hi - lo, file_offset=rg_start,
                                          total_compressed_size=len(out) - rg_start,
                                          ordinal=rg_i))
    meta = thrift.FileMetaData(
        version=version, schema=schema, num_rows=num_rows, row_groups=row_groups,
        created_by="delta_tpu_torch parquet writer",
        column_orders=[thrift.ColumnOrder(TYPE_ORDER=thrift.Empty()) for _ in leaves])
    footer = meta.write()
    out += footer
    out += struct.pack("<I", len(footer))
    out += MAGIC
    return bytes(out)


def _probe_sample(col: HostColumn, stype: str) -> Optional[bytes]:
    """The first 64 KiB of the buffer Arrow holds a flat column's values
    in, NULL slots zero as Arrow fills them (``_compresses_well`` samples
    it): integers, dates and timestamps at their width, booleans
    bit-packed, decimals as 16-byte little-endian words, floats as they
    are, strings and binary their bytes without offsets, a nested column's
    last leaf (Arrow's last buffer of its flattened children). None for an
    empty column."""
    if col.kind == "nested":  # the last buffer of the flattened children
        node = col.values
        while node.kind != "leaf":
            node = list(node.fields.values())[-1] if node.kind == "struct" else node.element
        return _probe_sample(HostColumn(leaf_kind(node.stype), node.values, node.valid,
                                        node.stype), node.stype)
    n = len(col.valid)
    if n == 0:
        return None
    valid = np.asarray(col.valid, bool)
    kind = col.kind
    if kind == "bool":
        take = min(n, 8 * _SAMPLE)
        bits = np.asarray(col.values[:take], bool) & valid[:take]
        return np.packbits(bits, bitorder="little").tobytes()
    if kind in ("str", "object"):
        parts, size = [], 0
        for v, ok in zip(col.values.tolist(), valid.tolist()):
            if ok:
                b = v.encode("utf-8") if kind == "str" else bytes(v)
                parts.append(b)
                size += len(b)
                if size >= _SAMPLE:
                    break
        return b"".join(parts)[:_SAMPLE]
    if kind == "decimal":
        take = min(n, _SAMPLE // 16)
        v = np.where(valid[:take], col.values[:take], 0)
        v = v.astype(object) if col.values.dtype == object else v.astype(np.int64)
        return np.ascontiguousarray(enc.decimal_to_bytes(v, 16)[:, ::-1]).tobytes()
    width = {"int8": 1, "int16": 2, "int32": 4, "date32": 4, "float32": 4}.get(stype, 8)
    dt = np.dtype(f"<f{width}") if kind == "double" else np.dtype(f"<i{width}")
    take = min(n, _SAMPLE // width)
    v = np.where(valid[:take], np.asarray(col.values[:take]), 0)
    return v.astype(dt).tobytes()


def _compresses_well(samples: Sequence[Optional[bytes]], device) -> List[bool]:
    """The JAX package's ``_compresses_well`` for each sample: True for an
    empty column or a sample under 1,024 bytes, else whether Snappy takes
    it below 0.9 of its size. The samples are compressed in one batch on
    ``device``."""
    out = [True] * len(samples)
    probe = [i for i, s in enumerate(samples) if s is not None and len(s) >= 1024]
    for i, z in zip(probe, snappy.compress_pages([samples[i] for i in probe], device)):
        out[i] = len(z) < 0.9 * len(samples[i])
    return out


def write_parquet_file(table: HostTable, abs_path: str, compression: Optional[str] = None,
                       device="cuda") -> Tuple[int, int]:
    """Write one Parquet file; returns (size_bytes, mtime_ms). Every column
    is OPTIONAL; row groups of ``delta.tpu.write.rowGroupRows`` rows, data
    pages cut near 1 MiB, a nested column written by its levels with its
    row groups cut at the same rows as the flat columns'.

    The JAX package's encoding policy (``delta_tpu/exec/parquet.py``
    ``write_parquet_file``): a dictionary for top-level string and binary
    columns, BYTE_STREAM_SPLIT for float columns unless
    ``delta.tpu.write.byteStreamSplit`` is off, PLAIN elsewhere. Under
    ``delta.tpu.write.compression=auto`` (or ``compression``) SNAPPY goes
    to the dictionary and float columns and to any other top-level column
    whose sample of Arrow's buffer compresses below 0.9
    (:func:`_compresses_well`, its probes in one batch on ``device``); a
    nested column's leaves stay uncompressed (the reference's per-column
    codecs name top-level columns only). A named codec goes to every leaf.
    The file's SNAPPY pages are compressed in one more batch."""
    return write_parquet_files([(table, abs_path)], compression, device)[0]


def write_parquet_files(items: Sequence[Tuple[HostTable, str]],
                        compression: Optional[str] = None,
                        device="cuda") -> List[Tuple[int, int]]:
    """:func:`write_parquet_file` of each ``(table, abs_path)``, the probes
    of them all in one batch on ``device`` and their SNAPPY pages in one
    more: a write of many small files pays two launch sets, not two a
    file."""
    codec_name = str(compression if compression is not None
                     else conf.get("delta.tpu.write.compression", "auto"))
    codec_all = None if codec_name.lower() == "auto" else _write_codec(codec_name)
    bss = bool(conf.get("delta.tpu.write.byteStreamSplit", True))
    rg_rows = max(int(conf.get("delta.tpu.write.rowGroupRows", ROW_GROUP_ROWS)), 1)
    files = []
    probed: List[Tuple[_Leaf, Optional[bytes]]] = []
    for table, _ in items:
        schema = [thrift.SchemaElement(name="schema", num_children=len(table.columns))]
        leaves: List[_Leaf] = []
        for name, col in table.columns.items():
            lv = _leaves_of(name, col, table.num_rows, schema)
            leaves.extend(lv)
            if col.kind == "nested":
                for leaf in lv:
                    leaf.codec = UNCOMPRESSED if codec_all is None else codec_all
                continue
            leaf = lv[0]
            leaf.dictionary = col.kind in ("str", "object")
            floating = leaf.stype in ("float32", "float64")
            leaf.bss = floating and bss
            if codec_all is not None:
                leaf.codec = codec_all
            elif leaf.dictionary or floating:
                leaf.codec = SNAPPY
            else:
                probed.append((leaf, _probe_sample(col, leaf.stype)))
        files.append((schema, leaves, table.num_rows))
    for (leaf, _), ok in zip(probed, _compresses_well([s for _, s in probed], device)):
        leaf.codec = SNAPPY if ok else UNCOMPRESSED
    encoded = [_encode_file(schema, leaves, n, rg_rows, stats=True, version=2)
               for schema, leaves, n in files]
    _compress_files(encoded, device)
    out = []
    for f, (_, abs_path) in zip(encoded, items):
        os.makedirs(os.path.dirname(abs_path) or ".", exist_ok=True)
        tmp = f"{abs_path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as fh:
            fh.write(_file_bytes(f))
        os.replace(tmp, abs_path)
        st_ = os.stat(abs_path)
        out.append((st_.st_size, int(st_.st_mtime * 1000)))
    return out


# -- nested columns ---------------------------------------------------------------
#
# What ``pyarrow`` does for the JAX package's checkpoint reads and writes
# (``log/columnar.py:492`` ``decode_checkpoint_parts``, ``log/checkpoints.py:
# 863-921``) and its nested data columns: struct, map and list columns by
# definition and repetition levels (Dremel), vectorised in numpy: a column's
# levels decode run by run, and the structure (validity, list offsets) of
# every node on a leaf's path comes from a few masks and searches over them,
# with no loop over rows.

_MAP, _MAP_KEY_VALUE, _LIST = 1, 2, 3


class _SNode:
    """A schema element in the tree, with the definition and repetition
    levels at it."""

    __slots__ = ("el", "name", "children", "d", "r", "leaf")

    def __init__(self, el, d, r):
        self.el, self.name, self.children, self.d, self.r, self.leaf = el, el.name, [], d, r, -1


def _schema_tree(schema) -> _SNode:
    root = _SNode(schema[0], 0, 0)
    pos, leaf = 1, 0

    def build(parent: _SNode, count: int):
        nonlocal pos, leaf
        for _ in range(count):
            el = schema[pos]
            pos += 1
            rep = el.repetition_type or 0
            node = _SNode(el, parent.d + (rep != 0), parent.r + (rep == REPEATED))
            parent.children.append(node)
            if el.num_children:
                build(node, el.num_children)
            else:
                node.leaf = leaf
                leaf += 1

    build(root, root.el.num_children or 0)
    return root


def _levels_bits(max_level: int) -> int:
    return max(int(max_level).bit_length(), 0)


def _decode_leaf(pages: List[_Page], md, node: _SNode, name: str):
    """One leaf's column chunk from its inflated pages: (definition levels,
    repetition levels, the dense values of the entries at the leaf's full
    definition level)."""
    ptype = md.type
    width = int(node.el.type_length or 0)
    max_d, max_r = node.d, node.r
    wd, wr = _levels_bits(max_d), _levels_bits(max_r)
    dictionary = None
    defs: List[np.ndarray] = []
    reps: List[np.ndarray] = []
    values: List[Any] = []
    for pg in pages:
        ph = pg.header
        if ph.type == DICTIONARY_PAGE:
            dictionary = _dictionary(name, pg.body, ptype, ph.dictionary_page_header.num_values,
                                     width)
            continue
        if ph.type == DATA_PAGE:
            dh = ph.data_page_header
            n = dh.num_values
            page = pg.body
            p = 0
            r = np.zeros(n, np.int64)
            if max_r:
                (ln,) = struct.unpack_from("<I", page, p)
                r = enc.decode_hybrid(page, p + 4, p + 4 + ln, wr, n)
                p += 4 + ln
            d = np.full(n, max_d, np.int64)
            if max_d:
                (ln,) = struct.unpack_from("<I", page, p)
                d = enc.decode_hybrid(page, p + 4, p + 4 + ln, wd, n)
                p += 4 + ln
            body, bp = page, p
        else:  # DATA_PAGE_V2
            dh = ph.data_page_header_v2
            n = dh.num_values
            rl, dl = dh.repetition_levels_byte_length or 0, dh.definition_levels_byte_length or 0
            r = (enc.decode_hybrid(pg.levels, 0, rl, wr, n) if max_r
                 else np.zeros(n, np.int64))
            d = (enc.decode_hybrid(pg.levels, rl, rl + dl, wd, n) if max_d
                 else np.full(n, max_d, np.int64))
            body, bp = pg.body, 0
        k = int((d == max_d).sum())
        vals = _decode_values(name, body, bp, len(body), dh.encoding, ptype, k, dictionary, width)
        defs.append(d)
        reps.append(r)
        values.append(_as_array(ptype, vals))
    cat = lambda xs: np.concatenate(xs) if xs else np.zeros(0, np.int64)
    dense = np.concatenate(values) if values else _empty_dense(ptype, width)
    return cat(defs), cat(reps), dense


def _assemble_leaf(node_path: List[_SNode], d: np.ndarray, r: np.ndarray, dense,
                   built: Dict[int, Any]) -> None:
    """Walk one leaf's path from the top, computing each node's slots in this
    leaf's entries (a row's entries start where the repetition level is 0;
    a repeated node's elements where it is at most the node's and the
    definition level reaches the node); record each node's validity, or a
    repeated node's offsets over its parent's slots, the first time it is
    met, and the leaf's values."""
    slots = np.nonzero(r == 0)[0]
    for node in node_path:
        key = id(node)
        if node.el.repetition_type == REPEATED:
            elems = np.nonzero((r <= node.r) & (d >= node.d))[0]
            if key not in built:
                offs = np.empty(len(slots) + 1, np.int64)
                offs[:-1] = np.searchsorted(elems, slots)
                offs[-1] = len(elems)
                built[key] = offs
            slots = elems
        elif key not in built:
            built[key] = d[slots] >= node.d
        if node.leaf >= 0:
            present = d[slots] == node.d
            built[("leaf", key)] = (present, dense)


def _ncol(node: _SNode, built, leaf_types) -> NCol:
    """The NCol of a schema node from what the leaves' walks recorded. A
    group over one repeated child is a map where it is annotated MAP, or
    unannotated over two fields (key and value, read by position), else a
    list."""
    if node.el.repetition_type == REPEATED:
        # a repeated field outside a LIST/MAP group: a required list
        offs = built[id(node)]
        return NCol("list", np.ones(len(offs) - 1, bool), offsets=offs,
                    element=_element_col(node, built, leaf_types))
    if node.leaf >= 0:
        return _leaf_col(node, built, leaf_types)
    valid = built[id(node)]
    if len(node.children) == 1 and node.children[0].el.repetition_type == REPEATED:
        rep = node.children[0]
        ct, lt = node.el.converted_type, node.el.logicalType
        listed = ct == _LIST or (lt is not None and lt.LIST is not None)
        mapped = ct in (_MAP, _MAP_KEY_VALUE) or (lt is not None and lt.MAP is not None)
        kind = "map" if mapped or (not listed and len(rep.children) == 2) else "list"
        return NCol(kind, valid, offsets=built[id(rep)],
                    element=_element_col(rep, built, leaf_types))
    return NCol("struct", valid, fields={c.name: _ncol(c, built, leaf_types)
                                         for c in node.children})


def _element_col(rep: _SNode, built, leaf_types) -> NCol:
    """The element of a repeated node (the spec's list rules): a repeated
    leaf's values; a repeated group's one child (the 3-level list's
    ``element``) unless the group is named ``array`` or ``*_tuple``; else
    the group itself as a struct (a map's key and value, read by
    position)."""
    if rep.leaf >= 0:
        return _leaf_col(rep, built, leaf_types)
    fields = {c.name: _ncol(c, built, leaf_types) for c in rep.children}
    first = next(iter(fields.values()))
    if len(fields) == 1 and rep.name != "array" and not rep.name.endswith("_tuple"):
        return first
    return NCol("struct", np.ones(len(first), bool), fields=fields)


def _leaf_col(node: _SNode, built, leaf_types) -> NCol:
    present, dense = built[("leaf", id(node))]
    stype = leaf_types.get(id(node))
    if isinstance(stype, NotImplementedError):
        return NCol("leaf", present, unsupported=(node.name, str(stype)))
    st, scale = stype
    return NCol("leaf", present, values=_leaf_values(st, scale, dense, present, node.el.type),
                stype=st)


def _leaf_paths_of(top: _SNode) -> List[Tuple[_SNode, List[_SNode]]]:
    """Each leaf under ``top`` with its path from ``top``."""
    out = []

    def walk(node, path):
        path = path + [node]
        if node.leaf >= 0:
            out.append((node, path))
        for c in node.children:
            walk(c, path)

    walk(top, [])
    return out


def _read_top(top: _SNode, groups, pages) -> NCol:
    """One top-level column of the row groups ``groups``; ``pages[(id(leaf
    node), row group index)]`` are each leaf chunk's inflated pages."""
    built: Dict[Any, Any] = {}
    leaf_types: Dict[int, Any] = {}
    for node, path in _leaf_paths_of(top):
        try:
            leaf_types[id(node)] = _leaf_type(node.el)
        except NotImplementedError as e:
            leaf_types[id(node)] = e
        name = ".".join(p.name for p in path)
        parts = [_decode_leaf(pages[(id(node), i)], rg.columns[node.leaf].meta_data, node, name)
                 for i, rg in enumerate(groups)]
        d = np.concatenate([p[0] for p in parts]) if parts else np.zeros(0, np.int64)
        r = np.concatenate([p[1] for p in parts]) if parts else np.zeros(0, np.int64)
        dense = (np.concatenate([p[2] for p in parts]) if parts
                 else _empty_dense(node.el.type, int(node.el.type_length or 0)))
        _assemble_leaf(path, d, r, dense, built)
    return _ncol(top, built, leaf_types)


def _load_top(top: _SNode, groups, load, source: str, pages: Dict[Any, List[_Page]],
              todo: List[Tuple[List[_Page], int, str, str]]) -> None:
    """Parse every leaf chunk of ``top`` (``load(md, name)`` gives a
    chunk's pages) into ``pages``, and list each for :func:`_inflate`."""
    for node, path in _leaf_paths_of(top):
        name = ".".join(p.name for p in path)
        for i, rg in enumerate(groups):
            md = rg.columns[node.leaf].meta_data
            pgs = load(md, name)
            pages[(id(node), i)] = pgs
            todo.append((pgs, md.codec, name, source))


def read_nested(data, columns: Optional[Sequence[str]] = None, device="cuda",
                source: str = "") -> Tuple[int, Dict[str, NCol]]:
    """A Parquet file's top-level columns (all, or those of ``columns``
    that it has), nested or flat, from its bytes: ``(num_rows, name ->
    NCol)``. Every row group is read; the file's SNAPPY pages inflate in
    one batch on ``device``; a leaf of a type the codec lacks decodes its
    validity and raises only when its values are asked for. ``source``
    (the file's path) prefixes a corrupt page's error."""
    data = memoryview(data)
    size = len(data)
    if size < 12 or bytes(data[size - 4:]) != MAGIC:
        raise ValueError("not a Parquet file (no PAR1 footer)")
    (n_foot,) = struct.unpack("<I", bytes(data[size - 8:size - 4]))
    if n_foot + 12 > size:
        raise ValueError(f"footer length {n_foot} exceeds the file's {size} bytes")
    meta, _ = thrift.read(thrift.FileMetaData, bytes(data[size - 8 - n_foot:size - 8]))
    if not meta.schema:
        raise ValueError("a Parquet footer without a schema")
    root = _schema_tree(meta.schema)
    want = {c.name: c for c in root.children}
    names = list(want) if columns is None else [c for c in columns if c in want]
    groups = meta.row_groups or []
    pages: Dict[Any, List[_Page]] = {}
    todo: List[Tuple[List[_Page], int, str, str]] = []
    for top in names:
        _load_top(want[top], groups, lambda md, name: _parse_pages(data, md, name,
                                                                   _chunk_start(md)),
                  source, pages, todo)
    _inflate(todo, device)
    return int(meta.num_rows or 0), {top: _read_top(want[top], groups, pages) for top in names}


# -- writing nested columns -------------------------------------------------------
#
# A column's type for :func:`write_nested`: a stored type of ``_TYPES`` or
# a decimal (a leaf), ``("struct", [(name, type), ...])``, ``("map", key
# type, value type)`` or ``("list", element type)``. Every field is OPTIONAL
# but a map's key (REQUIRED), as ``pyarrow`` writes them: a map is a MAP
# group over a repeated ``key_value`` group, a list a LIST group over a
# repeated ``list`` group whose child is ``element``.


def _schema_elements(name: str, spec, out: List[Any], repetition=OPTIONAL) -> None:
    if isinstance(spec, str):
        out.append(_leaf_element(name, spec, repetition))
        return
    kind = spec[0]
    if kind == "struct":
        if not spec[1]:
            raise _unsupported(name, "a struct with no fields")
        out.append(thrift.SchemaElement(repetition_type=repetition, name=name,
                                        num_children=len(spec[1])))
        for child, cspec in spec[1]:
            _schema_elements(child, cspec, out)
    elif kind == "map":
        out.append(thrift.SchemaElement(repetition_type=repetition, name=name, num_children=1,
                                        converted_type=_MAP,
                                        logicalType=thrift.LogicalType(MAP=thrift.Empty())))
        out.append(thrift.SchemaElement(repetition_type=REPEATED, name="key_value",
                                        num_children=2))
        _schema_elements("key", spec[1], out, repetition=0)
        _schema_elements("value", spec[2], out)
    elif kind == "list":
        out.append(thrift.SchemaElement(repetition_type=repetition, name=name, num_children=1,
                                        converted_type=_LIST,
                                        logicalType=thrift.LogicalType(LIST=thrift.Empty())))
        out.append(thrift.SchemaElement(repetition_type=REPEATED, name="list", num_children=1))
        _schema_elements("element", spec[1], out)
    else:
        raise _unsupported(name, f"column type {kind!r}")


def _shred(spec, col: NCol, n: int, out: List[Tuple[str, np.ndarray, np.ndarray, Any, int,
                                                       int]], name: str) -> None:
    """Every leaf of one top-level column as (stored type, definition
    levels, repetition levels, dense values, max definition, max
    repetition), vectorised: each entry is a slot of the node it reached,
    a list's entries repeat once an element."""

    def walk(spec, col, slot, d, r, alive, max_d, max_r, optional=True):
        if optional:
            ok = alive.copy()
            ok[alive] = col.valid[slot[alive]]
            d = d + ok
            alive, max_d = ok, max_d + 1
        if isinstance(spec, str):
            sel = slot[alive]
            if col.unsupported:
                raise _unsupported(*col.unsupported)
            out.append((spec, d, r, col.values[sel], max_d, max_r))
            return
        kind = spec[0]
        if kind == "struct":
            for (child, cspec) in spec[1]:
                walk(cspec, col.fields[child], slot, d, r, alive, max_d, max_r)
            return
        # the repeated group: an entry whose list has k >= 1 elements becomes k
        offs = col.offsets
        s = np.where(alive, slot, 0)
        count = np.where(alive, offs[s + 1] - offs[s], 0)
        has = count > 0
        reps = np.where(has, count, 1)
        src = np.repeat(np.arange(len(slot)), reps)
        starts = np.cumsum(reps) - reps
        j = np.arange(len(src)) - starts[src]
        e_alive = has[src]
        e_slot = np.where(e_alive, offs[s[src]] + j, 0)
        e_d = d[src] + e_alive
        e_r = np.where(j > 0, max_r + 1, r[src])
        el = col.element
        if kind == "list":
            walk(spec[1], el, e_slot, e_d, e_r, e_alive, max_d + 1, max_r + 1)
        else:
            keys = list(el.fields)
            walk(spec[1], el.fields[keys[0]], e_slot, e_d, e_r, e_alive, max_d + 1, max_r + 1,
                 optional=False)
            walk(spec[2], el.fields[keys[1]], e_slot, e_d, e_r, e_alive, max_d + 1, max_r + 1)

    walk(spec, col, np.arange(n), np.zeros(n, np.int64), np.zeros(n, np.int64),
         np.ones(n, bool), 0, 0)


def write_nested(columns: Sequence[Tuple[str, Any, NCol]], num_rows: int,
                 row_group_rows: int = ROW_GROUP_ROWS, device="cuda") -> bytes:
    """A Parquet file of nested or flat top-level columns ``(name, type,
    NCol)`` (types as above), as bytes, written as the JAX package's
    checkpoints are (``pq.write_table(..., compression="snappy")``): SNAPPY
    on every leaf (one batch on ``device``), a dictionary on every leaf but
    a boolean one (PLAIN past the dictionary's page limit), v1 data pages,
    the hybrid for levels, row groups of ``row_group_rows`` rows. No footer
    statistics."""
    schema = [thrift.SchemaElement(name="schema", num_children=len(columns))]
    leaves: List[_Leaf] = []
    for name, spec, col in columns:
        leaves.extend(_nested_leaves(name, spec, col, num_rows, schema))
    for leaf in leaves:
        leaf.codec = SNAPPY
        leaf.dictionary = _type_entry(leaf.stype)[1] != enc.BOOLEAN
    return _write_file(schema, leaves, num_rows, row_group_rows, stats=False, version=1,
                       device=device)


def _leaf_paths(elements: List[Any]) -> List[List[str]]:
    """The path in the schema of each leaf of one top-level column's
    elements (pre-order)."""
    paths: List[List[str]] = []
    pos = 0

    def walk(prefix):
        nonlocal pos
        el = elements[pos]
        pos += 1
        here = prefix + [el.name]
        if not el.num_children:
            paths.append(here)
        for _ in range(el.num_children or 0):
            walk(here)

    walk([])
    return paths

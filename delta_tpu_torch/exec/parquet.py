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
* :func:`write_parquet_file`: PLAIN values, uncompressed pages, RLE
  definition levels, row groups of ``delta.tpu.write.rowGroupRows`` rows
  and min/max/null statistics per column chunk in the footer;
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
    "read_parquet_file",
    "read_parquet_files",
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


def _decompress(codec: int, raw: bytes, size: int, name: str) -> bytes:
    if codec == UNCOMPRESSED:
        return raw
    if codec == SNAPPY:
        return snappy.decompress(raw)
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


def _read_chunk(f, el, md, num_rows: int):
    """One column chunk: (physical values, valid mask), values zero/None at
    NULL rows."""
    name = el.name
    ptype = md.type
    width = int(el.type_length or 0)
    optional = el.repetition_type == OPTIONAL
    start = md.dictionary_page_offset if md.dictionary_page_offset else md.data_page_offset
    if md.data_page_offset < start:
        start = md.data_page_offset
    f.seek(start)
    data = f.read(md.total_compressed_size)
    pos = 0
    dictionary = None
    values: List[Any] = []
    valids: List[np.ndarray] = []
    seen = 0
    while seen < md.num_values:
        ph, pos = thrift.read(thrift.PageHeader, data, pos)
        body_end = pos + ph.compressed_page_size
        if body_end > len(data):
            raise ValueError(f"Parquet column {name!r}: page runs past its column chunk")
        if ph.type == DICTIONARY_PAGE:
            dh = ph.dictionary_page_header
            if dh.encoding not in (enc.PLAIN, enc.PLAIN_DICTIONARY):
                raise _unsupported(name, f"dictionary encoding "
                                   f"{enc.ENCODING_NAMES.get(dh.encoding, dh.encoding)}")
            page = _decompress(md.codec, data[pos:body_end], ph.uncompressed_page_size, name)
            dictionary = _dictionary(name, page, ptype, dh.num_values, width)
        elif ph.type == DATA_PAGE:
            dh = ph.data_page_header
            n = dh.num_values
            page = _decompress(md.codec, data[pos:body_end], ph.uncompressed_page_size, name)
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
            seen += n
        elif ph.type == DATA_PAGE_V2:
            dh = ph.data_page_header_v2
            n = dh.num_values
            dl, rl = dh.definition_levels_byte_length, dh.repetition_levels_byte_length or 0
            # a flat column's repetition levels (if a writer stores any) are
            # all 0: the definition levels follow them
            if optional:
                valid = enc.decode_hybrid(data, pos + rl, pos + rl + dl, 1, n).astype(bool)
            else:
                valid = np.ones(n, bool)
            body = data[pos + dl + rl:body_end]
            if dh.is_compressed is None or dh.is_compressed:
                body = _decompress(md.codec, body, ph.uncompressed_page_size - dl - rl, name)
            k = n - int(dh.num_nulls or 0) if optional else n
            if k != int(valid.sum()):
                raise ValueError(f"Parquet column {name!r}: page null count disagrees "
                                 "with its definition levels")
            vals = _decode_values(name, body, 0, len(body), dh.encoding, ptype, k, dictionary,
                                  width)
            values.append(_as_array(ptype, vals))
            valids.append(valid)
            seen += n
        pos = body_end
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


def read_parquet_file(abs_path: str, columns: Optional[Sequence[str]] = None,
                      row_groups: Optional[Sequence[int]] = None, meta=None) -> HostTable:
    """A data file's columns (all, or ``columns`` in the order given) as a
    ``HostTable``: every row group, or those of ``row_groups`` in the order
    given. ``meta`` is the file's footer where the caller has read it. A
    nested column is a ``nested`` column (Dremel levels, ``expr/nested``)."""
    if meta is None:
        meta = read_metadata(abs_path)
    top = _top_level(meta.schema)
    names = list(top) if columns is None else list(columns)
    for c in names:
        if c not in top:
            raise KeyError(f"{abs_path}: no column {c!r} (columns: {list(top)})")
    cols: Dict[str, HostColumn] = {}
    all_groups = meta.row_groups or []
    groups = all_groups if row_groups is None else [all_groups[i] for i in row_groups]
    tree = None
    with open(abs_path, "rb") as f:
        for c in names:
            el, leaf = top[c]
            if leaf < 0:
                if tree is None:
                    tree = {node.name: node for node in _schema_tree(meta.schema).children}

                def chunk(md, node, name):
                    start = (md.dictionary_page_offset if md.dictionary_page_offset
                             else md.data_page_offset)
                    start = min(start, md.data_page_offset)
                    f.seek(start)
                    return _read_leaf_chunk(f.read(md.total_compressed_size), md, node, name,
                                            base=start)

                ncol = _read_top(tree[c], groups, chunk)
                cols[c] = HostColumn("nested", ncol, ncol.valid, _spec_of(ncol, c))
                continue
            stype, scale = _leaf_type(el)
            chunks = []
            for rg in groups:
                md = rg.columns[leaf].meta_data
                chunks.append(_read_chunk(f, el, md, rg.num_rows))
            cols[c] = _to_column(stype, scale, chunks, el.type)
    n = int(meta.num_rows) if row_groups is None else sum(int(rg.num_rows) for rg in groups)
    return HostTable(cols, n)


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


def read_parquet_files(abs_paths: Sequence[str],
                       columns: Optional[Sequence[str]] = None) -> List[HostTable]:
    """Read data files; one table per file."""
    return [read_parquet_file(p, columns) for p in abs_paths]


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


class _Leaf:
    """One column chunk's source: a flat column (``col``: its values and
    validity are the levels) or a nested leaf shredded into definition and
    repetition levels (``d``, ``r``: one entry a level, ``dense``: the
    values at the full definition level)."""

    __slots__ = ("path", "stype", "col", "d", "r", "dense", "max_d", "max_r",
                 "row_starts", "dense_starts")

    def __init__(self, path, stype, col=None, d=None, r=None, dense=None, max_d=1, max_r=0):
        self.path, self.stype, self.col = path, stype, col
        self.d, self.r, self.dense, self.max_d, self.max_r = d, r, dense, max_d, max_r
        if col is None:
            self.row_starts = np.concatenate([np.flatnonzero(r == 0), [len(r)]])
            self.dense_starts = np.concatenate([[0], np.cumsum(d == max_d)])

    def chunk(self, lo: int, hi: int):
        """Rows ``lo:hi``: (level bytes, dense values, levels, nulls)."""
        if self.col is not None:
            valid = np.asarray(self.col.valid[lo:hi], bool)
            levels = enc.encode_hybrid_bits(valid)
            return (struct.pack("<I", len(levels)) + levels, self.col.values[lo:hi][valid],
                    hi - lo, int((~valid).sum()))
        e0, e1 = int(self.row_starts[lo]), int(self.row_starts[hi])
        v0, v1 = int(self.dense_starts[e0]), int(self.dense_starts[e1])
        body = bytearray()
        if self.max_r:
            lv = enc.encode_hybrid(self.r[e0:e1], _levels_bits(self.max_r))
            body += struct.pack("<I", len(lv)) + lv
        if self.max_d:
            lv = enc.encode_hybrid(self.d[e0:e1], _levels_bits(self.max_d))
            body += struct.pack("<I", len(lv)) + lv
        return bytes(body), self.dense[v0:v1], e1 - e0, (e1 - e0) - (v1 - v0)


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


def _write_file(schema: List[Any], leaves: Sequence[_Leaf], num_rows: int, rg_rows: int,
                stats: bool, version: int) -> bytes:
    """The file's bytes: PLAIN values, one uncompressed v1 data page a
    column chunk, row groups of ``rg_rows`` rows cut at record boundaries
    (repetition level 0), footer statistics where ``stats``."""
    out = bytearray(MAGIC)
    row_groups = []
    step = max(int(rg_rows), 1)
    bounds = [(lo, min(lo + step, num_rows)) for lo in range(0, num_rows, step)]
    if not bounds and version == 1:
        bounds = [(0, 0)]
    for rg_i, (lo, hi) in enumerate(bounds):
        chunks = []
        rg_start = len(out)
        for leaf in leaves:
            kind, ptype, _, _ = _type_entry(leaf.stype)
            levels, vals, count, nulls = leaf.chunk(lo, hi)
            physical = _physical(leaf.stype, kind, vals)
            body = levels + enc.encode_plain(ptype, physical)
            header = thrift.PageHeader(
                type=DATA_PAGE, uncompressed_page_size=len(body), compressed_page_size=len(body),
                data_page_header=thrift.DataPageHeader(
                    num_values=count, encoding=enc.PLAIN, definition_level_encoding=enc.RLE,
                    repetition_level_encoding=enc.RLE)).write()
            offset = len(out)
            out += header
            out += body
            size = len(header) + len(body)
            md = thrift.ColumnMetaData(
                type=ptype, encodings=[enc.PLAIN, enc.RLE], path_in_schema=leaf.path,
                codec=UNCOMPRESSED, num_values=count, total_uncompressed_size=size,
                total_compressed_size=size, data_page_offset=offset,
                statistics=(_chunk_stats(ptype, leaf.stype, vals, physical, nulls)
                            if stats else None))
            chunks.append(thrift.ColumnChunk(file_offset=offset, meta_data=md))
        total = len(out) - rg_start
        row_groups.append(thrift.RowGroup(columns=chunks, total_byte_size=total,
                                          num_rows=hi - lo, file_offset=rg_start,
                                          total_compressed_size=total, ordinal=rg_i))
    meta = thrift.FileMetaData(
        version=version, schema=schema, num_rows=num_rows, row_groups=row_groups,
        created_by="delta_tpu_torch parquet writer",
        column_orders=[thrift.ColumnOrder(TYPE_ORDER=thrift.Empty()) for _ in leaves])
    footer = meta.write()
    out += footer
    out += struct.pack("<I", len(footer))
    out += MAGIC
    return bytes(out)


def write_parquet_file(table: HostTable, abs_path: str) -> Tuple[int, int]:
    """Write one Parquet file; returns (size_bytes, mtime_ms). Every column
    is OPTIONAL, PLAIN, uncompressed; one data page per column chunk; a
    nested column is written by its levels, its row groups cut at the same
    rows as the flat columns'."""
    schema = [thrift.SchemaElement(name="schema", num_children=len(table.columns))]
    leaves: List[_Leaf] = []
    for name, col in table.columns.items():
        leaves.extend(_leaves_of(name, col, table.num_rows, schema))
    rg_rows = max(int(conf.get("delta.tpu.write.rowGroupRows", ROW_GROUP_ROWS)), 1)
    data = _write_file(schema, leaves, table.num_rows, rg_rows, stats=True, version=2)
    os.makedirs(os.path.dirname(abs_path) or ".", exist_ok=True)
    tmp = f"{abs_path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, abs_path)
    st_ = os.stat(abs_path)
    return st_.st_size, int(st_.st_mtime * 1000)


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


def _read_leaf_chunk(data, md, node: _SNode, name: str, base: int = 0):
    """One leaf's column chunk: (definition levels, repetition levels, the
    dense values of the entries at the leaf's full definition level).
    ``data`` holds the file's bytes from offset ``base`` on."""
    ptype = md.type
    width = int(node.el.type_length or 0)
    max_d, max_r = node.d, node.r
    wd, wr = _levels_bits(max_d), _levels_bits(max_r)
    pos = (md.dictionary_page_offset if md.dictionary_page_offset
           else md.data_page_offset)
    pos = min(pos, md.data_page_offset) - base
    end = pos + md.total_compressed_size
    dictionary = None
    defs: List[np.ndarray] = []
    reps: List[np.ndarray] = []
    values: List[Any] = []
    seen = 0
    while seen < md.num_values:
        ph, pos = thrift.read(thrift.PageHeader, data, pos)
        body_end = pos + ph.compressed_page_size
        if body_end > end:
            raise ValueError(f"Parquet column {name!r}: page runs past its column chunk")
        if ph.type == DICTIONARY_PAGE:
            dh = ph.dictionary_page_header
            page = _decompress(md.codec, bytes(data[pos:body_end]), ph.uncompressed_page_size,
                               name)
            dictionary = _dictionary(name, page, ptype, dh.num_values, width)
        elif ph.type in (DATA_PAGE, DATA_PAGE_V2):
            if ph.type == DATA_PAGE:
                dh = ph.data_page_header
                n = dh.num_values
                page = _decompress(md.codec, bytes(data[pos:body_end]),
                                   ph.uncompressed_page_size, name)
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
            else:
                dh = ph.data_page_header_v2
                n = dh.num_values
                rl, dl = dh.repetition_levels_byte_length or 0, dh.definition_levels_byte_length or 0
                r = (enc.decode_hybrid(data, pos, pos + rl, wr, n) if max_r
                     else np.zeros(n, np.int64))
                d = (enc.decode_hybrid(data, pos + rl, pos + rl + dl, wd, n) if max_d
                     else np.full(n, max_d, np.int64))
                body = bytes(data[pos + rl + dl:body_end])
                if dh.is_compressed is None or dh.is_compressed:
                    body = _decompress(md.codec, body, ph.uncompressed_page_size - dl - rl, name)
                bp = 0
            k = int((d == max_d).sum())
            vals = _decode_values(name, body, bp, len(body), dh.encoding, ptype, k, dictionary,
                                  width)
            defs.append(d)
            reps.append(r)
            values.append(_as_array(ptype, vals))
            seen += n
        pos = body_end
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


def _read_top(top: _SNode, groups, chunk) -> NCol:
    """One top-level column of the row groups ``groups``; ``chunk(md, node,
    name)`` reads a leaf's chunk (``_read_leaf_chunk``'s triple)."""
    built: Dict[Any, Any] = {}
    leaf_types: Dict[int, Any] = {}

    def walk(node, path):
        path = path + [node]
        if node.leaf >= 0:
            try:
                leaf_types[id(node)] = _leaf_type(node.el)
            except NotImplementedError as e:
                leaf_types[id(node)] = e
            name = ".".join(p.name for p in path)
            parts = [chunk(rg.columns[node.leaf].meta_data, node, name) for rg in groups]
            d = np.concatenate([p[0] for p in parts]) if parts else np.zeros(0, np.int64)
            r = np.concatenate([p[1] for p in parts]) if parts else np.zeros(0, np.int64)
            dense = (np.concatenate([p[2] for p in parts]) if parts
                     else _empty_dense(node.el.type, int(node.el.type_length or 0)))
            _assemble_leaf(path, d, r, dense, built)
        for c in node.children:
            walk(c, path)

    walk(top, [])
    return _ncol(top, built, leaf_types)


def read_nested(data, columns: Optional[Sequence[str]] = None) -> Tuple[int, Dict[str, NCol]]:
    """A Parquet file's top-level columns (all, or those of ``columns``
    that it has), nested or flat, from its bytes: ``(num_rows, name ->
    NCol)``. Every row group is read; a leaf of a type the codec lacks
    decodes its validity and raises only when its values are asked for."""
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
    return int(meta.num_rows or 0), {
        top: _read_top(want[top], groups,
                       lambda md, node, name: _read_leaf_chunk(data, md, node, name))
        for top in names}


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
                 row_group_rows: int = ROW_GROUP_ROWS) -> bytes:
    """A Parquet file of nested or flat top-level columns ``(name, type,
    NCol)`` (types as above), as bytes: PLAIN values, uncompressed v1 data
    pages, the hybrid for levels, row groups of ``row_group_rows`` rows.
    No footer statistics."""
    schema = [thrift.SchemaElement(name="schema", num_children=len(columns))]
    leaves: List[_Leaf] = []
    for name, spec, col in columns:
        leaves.extend(_nested_leaves(name, spec, col, num_rows, schema))
    return _write_file(schema, leaves, num_rows, row_group_rows, stats=False, version=1)


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

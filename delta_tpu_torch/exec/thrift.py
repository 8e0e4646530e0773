"""Thrift compact protocol: the Parquet footer and page headers.

The JAX package reads and writes Parquet through ``pyarrow``; the port does
not depend on ``pyarrow``, so it carries the few Thrift structures a flat
Parquet file needs (``parquet.thrift``):
:data:`FileMetaData`, :data:`SchemaElement` with its ``LogicalType`` union,
:data:`RowGroup`, :data:`ColumnChunk`, :data:`ColumnMetaData`,
:data:`Statistics`, :data:`PageHeader` and the three page headers.

A structure is a :class:`Struct` subclass made by :func:`struct`: its
fields are attributes (``None`` when absent), declared with their Thrift
field ids. :func:`read` decodes one from a buffer and returns it with the
offset after it; a field id the declaration does not know is skipped, as
Thrift requires. :meth:`Struct.write` encodes the fields that are set, in
field-id order.
"""
from __future__ import annotations

import struct as _struct
from typing import Any, Dict, Sequence, Tuple

__all__ = ["Struct", "struct", "read", "ThriftError", "FileMetaData", "SchemaElement",
           "LogicalType", "RowGroup", "ColumnChunk", "ColumnMetaData", "Statistics",
           "PageHeader", "DataPageHeader", "DataPageHeaderV2", "DictionaryPageHeader",
           "KeyValue", "ColumnOrder", "IntType", "TimestampType",
           "TimeUnit", "DecimalType", "Empty"]

# compact-protocol wire types
_STOP, _TRUE, _FALSE, _BYTE, _I16, _I32, _I64, _DOUBLE, _BINARY, _LIST, _SET, _MAP, _STRUCT = (
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12)


class ThriftError(ValueError):
    """The bytes are not a well-formed compact-protocol structure."""


class Struct:
    """A Thrift structure: ``FIELDS`` maps field id -> (name, type)."""

    FIELDS: Dict[int, Tuple[str, Any]] = {}
    #: the field names; each is also a class attribute of value None, so an
    #: instance holds only the fields that were set (a page header a page)
    NAMES: frozenset = frozenset()
    #: (field id, name, type, compact wire type) in field-id order: the writer's walk
    PLAN: Tuple = ()

    def __init__(self, **kw):
        for k, v in kw.items():
            if k not in self.NAMES:
                raise TypeError(f"{type(self).__name__} has no field {k!r}")
            setattr(self, k, v)

    def __repr__(self) -> str:
        set_ = [f"{n}={getattr(self, n)!r}" for n, _ in self.FIELDS.values()
                if getattr(self, n) is not None]
        return f"{type(self).__name__}({', '.join(set_)})"

    def __eq__(self, other) -> bool:
        return type(self) is type(other) and all(
            getattr(self, n) == getattr(other, n) for n, _ in self.FIELDS.values())

    def write(self) -> bytes:
        out = bytearray()
        _write_struct(out, self)
        return bytes(out)


def struct(name: str, fields: Sequence[Tuple[int, str, Any]]) -> type:
    """A :class:`Struct` subclass with the given (id, name, type) fields.
    Types: ``"bool"``, ``"i8"``, ``"i16"``, ``"i32"``, ``"i64"``,
    ``"double"``, ``"binary"``, ``"string"``, a Struct subclass, or
    ``("list", type)``."""
    names = [n for _, n, _ in fields]
    return type(name, (Struct,), dict({n: None for n in names},
                                      FIELDS={fid: (n, t) for fid, n, t in fields},
                                      NAMES=frozenset(names),
                                      PLAN=tuple((fid, n, t, _wire(t))
                                                 for fid, n, t in sorted(fields))))


# -- reading -----------------------------------------------------------------


def _varint(buf, pos: int) -> Tuple[int, int]:
    shift = result = 0
    while True:
        if pos >= len(buf):
            raise ThriftError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ThriftError("varint too long")


def _zigzag(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def _read_value(buf, pos: int, wire: int, spec) -> Tuple[Any, int]:
    if wire in (_TRUE, _FALSE):  # a bool inside a list: one byte
        v = buf[pos]
        return v == _TRUE, pos + 1
    if wire == _BYTE:
        v = buf[pos]
        return (v - 256 if v > 127 else v), pos + 1
    if wire in (_I16, _I32, _I64):
        v, pos = _varint(buf, pos)
        return _zigzag(v), pos
    if wire == _DOUBLE:
        return _struct.unpack_from("<d", buf, pos)[0], pos + 8
    if wire == _BINARY:
        n, pos = _varint(buf, pos)
        if pos + n > len(buf):
            raise ThriftError("truncated binary")
        raw = bytes(buf[pos:pos + n])
        return (raw.decode("utf-8") if spec == "string" else raw), pos + n
    if wire in (_LIST, _SET):
        head = buf[pos]
        pos += 1
        size, ewire = head >> 4, head & 0x0F
        if size == 15:
            size, pos = _varint(buf, pos)
        espec = spec[1] if isinstance(spec, tuple) else None
        out = []
        for _ in range(size):
            v, pos = _read_value(buf, pos, ewire, espec)
            out.append(v)
        return out, pos
    if wire == _MAP:
        size, pos = _varint(buf, pos)
        if size == 0:
            return {}, pos
        kv = buf[pos]
        pos += 1
        out = {}
        for _ in range(size):
            k, pos = _read_value(buf, pos, kv >> 4, None)
            v, pos = _read_value(buf, pos, kv & 0x0F, None)
            out[k] = v
        return out, pos
    if wire == _STRUCT:
        cls = spec if isinstance(spec, type) and issubclass(spec, Struct) else None
        return _read_struct(buf, pos, cls)
    raise ThriftError(f"unknown compact wire type {wire}")


def _read_struct(buf, pos: int, cls) -> Tuple[Any, int]:
    obj = cls.__new__(cls) if cls is not None else None  # every field None
    last = 0
    while True:
        if pos >= len(buf):
            raise ThriftError("truncated struct")
        head = buf[pos]
        pos += 1
        wire = head & 0x0F
        if wire == _STOP:
            return obj, pos
        delta = head >> 4
        if delta:
            fid = last + delta
        else:
            v, pos = _varint(buf, pos)
            fid = _zigzag(v)
        last = fid
        field = cls.FIELDS.get(fid) if cls is not None else None
        if wire in (_TRUE, _FALSE):  # a bool field carries its value in the type
            value = wire == _TRUE
        else:
            value, pos = _read_value(buf, pos, wire, field[1] if field else None)
        if field is not None:
            setattr(obj, field[0], value)


def read(cls: type, buf, pos: int = 0) -> Tuple[Struct, int]:
    """Decode one ``cls`` at ``buf[pos:]``: (the structure, the offset after
    it). Raises :class:`ThriftError` on malformed bytes."""
    try:
        return _read_struct(memoryview(buf), pos, cls)
    except (IndexError, _struct.error) as e:
        raise ThriftError(f"truncated {cls.__name__}") from e


# -- writing -----------------------------------------------------------------

_WIRE = {"bool": _TRUE, "i8": _BYTE, "i16": _I16, "i32": _I32, "i64": _I64,
         "double": _DOUBLE, "binary": _BINARY, "string": _BINARY}


def _wire(spec) -> int:
    if isinstance(spec, tuple):
        return _LIST
    if isinstance(spec, type):
        return _STRUCT
    return _WIRE[spec]


def _put_varint(out: bytearray, n: int) -> None:
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _put_int(out: bytearray, v: int, bits: int) -> None:
    _put_varint(out, ((v << 1) ^ (v >> (bits - 1))) & ((1 << bits) - 1))


def _write_value(out: bytearray, spec, v) -> None:
    if spec == "bool":  # only inside a list
        out.append(_TRUE if v else _FALSE)
    elif spec == "i8":
        out.append(v & 0xFF)
    elif spec in ("i16", "i32", "i64"):
        _put_int(out, int(v), 64)
    elif spec == "double":
        out += _struct.pack("<d", v)
    elif spec in ("binary", "string"):
        raw = v.encode("utf-8") if isinstance(v, str) else bytes(v)
        _put_varint(out, len(raw))
        out += raw
    elif isinstance(spec, tuple):
        espec = spec[1]
        n = len(v)
        ewire = _wire(espec)
        if n < 15:
            out.append((n << 4) | ewire)
        else:
            out.append(0xF0 | ewire)
            _put_varint(out, n)
        for x in v:
            _write_value(out, espec, x)
    else:
        _write_struct(out, v)


def _write_struct(out: bytearray, obj: Struct) -> None:
    last = 0
    for fid, name, spec, wire in obj.PLAN:
        v = getattr(obj, name)
        if v is None:
            continue
        if spec == "bool":
            wire = _TRUE if v else _FALSE
        delta = fid - last
        if 0 < delta <= 15:
            out.append((delta << 4) | wire)
        else:
            out.append(wire)
            _put_int(out, fid, 16)
        last = fid
        if spec != "bool":
            _write_value(out, spec, v)
    out.append(_STOP)


# -- parquet.thrift ------------------------------------------------------------

Empty = struct("Empty", [])
TimeUnit = struct("TimeUnit", [(1, "MILLIS", Empty), (2, "MICROS", Empty), (3, "NANOS", Empty)])
DecimalType = struct("DecimalType", [(1, "scale", "i32"), (2, "precision", "i32")])
TimestampType = struct("TimestampType", [(1, "isAdjustedToUTC", "bool"), (2, "unit", TimeUnit)])
IntType = struct("IntType", [(1, "bitWidth", "i8"), (2, "isSigned", "bool")])
LogicalType = struct("LogicalType", [
    (1, "STRING", Empty), (2, "MAP", Empty), (3, "LIST", Empty), (4, "ENUM", Empty),
    (5, "DECIMAL", DecimalType), (6, "DATE", Empty), (7, "TIME", TimestampType),
    (8, "TIMESTAMP", TimestampType), (10, "INTEGER", IntType), (11, "UNKNOWN", Empty),
    (12, "JSON", Empty), (13, "BSON", Empty), (14, "UUID", Empty), (15, "FLOAT16", Empty),
])
SchemaElement = struct("SchemaElement", [
    (1, "type", "i32"), (2, "type_length", "i32"), (3, "repetition_type", "i32"),
    (4, "name", "string"), (5, "num_children", "i32"), (6, "converted_type", "i32"),
    (7, "scale", "i32"), (8, "precision", "i32"), (9, "field_id", "i32"),
    (10, "logicalType", LogicalType),
])
Statistics = struct("Statistics", [
    (1, "max", "binary"), (2, "min", "binary"), (3, "null_count", "i64"),
    (4, "distinct_count", "i64"), (5, "max_value", "binary"), (6, "min_value", "binary"),
    (7, "is_max_value_exact", "bool"), (8, "is_min_value_exact", "bool"),
])
KeyValue = struct("KeyValue", [(1, "key", "string"), (2, "value", "string")])
ColumnMetaData = struct("ColumnMetaData", [
    (1, "type", "i32"), (2, "encodings", ("list", "i32")),
    (3, "path_in_schema", ("list", "string")), (4, "codec", "i32"), (5, "num_values", "i64"),
    (6, "total_uncompressed_size", "i64"), (7, "total_compressed_size", "i64"),
    (8, "key_value_metadata", ("list", KeyValue)), (9, "data_page_offset", "i64"),
    (10, "index_page_offset", "i64"), (11, "dictionary_page_offset", "i64"),
    (12, "statistics", Statistics),
])
ColumnChunk = struct("ColumnChunk", [
    (1, "file_path", "string"), (2, "file_offset", "i64"), (3, "meta_data", ColumnMetaData),
])
RowGroup = struct("RowGroup", [
    (1, "columns", ("list", ColumnChunk)), (2, "total_byte_size", "i64"), (3, "num_rows", "i64"),
    (5, "file_offset", "i64"), (6, "total_compressed_size", "i64"), (7, "ordinal", "i16"),
])
ColumnOrder = struct("ColumnOrder", [(1, "TYPE_ORDER", Empty)])
FileMetaData = struct("FileMetaData", [
    (1, "version", "i32"), (2, "schema", ("list", SchemaElement)), (3, "num_rows", "i64"),
    (4, "row_groups", ("list", RowGroup)), (5, "key_value_metadata", ("list", KeyValue)),
    (6, "created_by", "string"), (7, "column_orders", ("list", ColumnOrder)),
])
DataPageHeader = struct("DataPageHeader", [
    (1, "num_values", "i32"), (2, "encoding", "i32"), (3, "definition_level_encoding", "i32"),
    (4, "repetition_level_encoding", "i32"), (5, "statistics", Statistics),
])
DictionaryPageHeader = struct("DictionaryPageHeader", [
    (1, "num_values", "i32"), (2, "encoding", "i32"), (3, "is_sorted", "bool"),
])
DataPageHeaderV2 = struct("DataPageHeaderV2", [
    (1, "num_values", "i32"), (2, "num_nulls", "i32"), (3, "num_rows", "i32"),
    (4, "encoding", "i32"), (5, "definition_levels_byte_length", "i32"),
    (6, "repetition_levels_byte_length", "i32"), (7, "is_compressed", "bool"),
    (8, "statistics", Statistics),
])
PageHeader = struct("PageHeader", [
    (1, "type", "i32"), (2, "uncompressed_page_size", "i32"), (3, "compressed_page_size", "i32"),
    (4, "crc", "i32"), (5, "data_page_header", DataPageHeader),
    (7, "dictionary_page_header", DictionaryPageHeader),
    (8, "data_page_header_v2", DataPageHeaderV2),
])

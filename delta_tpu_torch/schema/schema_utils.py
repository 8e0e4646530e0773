"""Schema checks of the write path (the port's own copy of part of
``delta_tpu.schema.schema_utils`` and ``delta_tpu.schema.arrow_interop``).

The JAX package maps a ``pyarrow`` schema onto the Delta types
(``schema_from_arrow``); the port maps a ``HostTable``'s columns, whose
stored type (``HostColumn.type``, or the kind's widest type) plays the
Arrow type's part. Nested and decimal columns are not ported: the port's
tables hold none.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

from delta_tpu_torch.schema.types import (
    ArrayType, BinaryType, BooleanType, ByteType, DataType, DateType, DoubleType, FloatType,
    IntegerType, LongType, MapType, NullType, ShortType, StringType, StructField, StructType,
    TimestampType,
)
from delta_tpu_torch.expr.vectorized import stored_type
from delta_tpu_torch.utils import errors
from delta_tpu_torch.utils.errors import SchemaMismatchError

__all__ = ["check_column_names", "check_partition_columns", "check_column_name_duplication",
           "enforce_write_compatibility", "delta_type_for", "stored_type_for",
           "schema_from_table"]

_INVALID_CHARS = set(' ,;{}()\n\t=')

#: HostColumn stored type -> Delta type (``delta_type_from_arrow``)
_DELTA_TYPES = {
    "bool": BooleanType, "int8": ByteType, "int16": ShortType, "int32": IntegerType,
    "int64": LongType, "float32": FloatType, "float64": DoubleType, "string": StringType,
    "binary": BinaryType, "date32": DateType, "timestamp[us]": TimestampType,
    "timestamp[us, tz=UTC]": TimestampType,
}
_TYPE_KIND = {"bool": "bool", "int8": "int", "int16": "int", "int32": "int", "int64": "int",
              "float32": "double", "float64": "double", "string": "str", "binary": "object",
              "date32": "date", "timestamp[us]": "ts"}
def delta_type_for(col) -> DataType:
    """The Delta type of a ``HostColumn``; an all-NULL column of no type is
    a string, as an Arrow null column is."""
    if col.kind == "null":
        return StringType()
    stype = stored_type(col)
    if stype not in _DELTA_TYPES:
        raise NotImplementedError(f"a {col.kind} column of type {col.type!r} has no Delta type "
                                  "in the port")
    return _DELTA_TYPES[stype]()


def stored_type_for(dt: DataType) -> Tuple[str, str]:
    """(kind, stored type) of a Delta type (``arrow_type_for``)."""
    for stype, cls in _DELTA_TYPES.items():
        if type(dt) is cls and stype != "timestamp[us, tz=UTC]":
            return _TYPE_KIND[stype], stype
    raise NotImplementedError(f"writing a {dt.simple_string()} column is not ported")


def schema_from_table(table) -> StructType:
    return StructType([StructField(name, delta_type_for(col), True)
                       for name, col in table.columns.items()])


def check_column_names(schema: StructType) -> None:
    def walk(dt: DataType, path: str):
        if isinstance(dt, StructType):
            for f in dt.fields:
                if any(c in _INVALID_CHARS for c in f.name):
                    raise errors.invalid_column_name(path + f.name)
                walk(f.data_type, path + f.name + ".")
        elif isinstance(dt, ArrayType):
            walk(dt.element_type, path)
        elif isinstance(dt, MapType):
            walk(dt.key_type, path)
            walk(dt.value_type, path)

    walk(schema, "")


def check_partition_columns(partition_columns: Sequence[str], schema: StructType) -> None:
    names = {f.name.lower() for f in schema.fields}
    for c in partition_columns:
        if c.lower() not in names:
            raise errors.partition_column_not_found(c, schema.simple_string())


def check_column_name_duplication(schema: StructType, context: str) -> None:
    """Reject case-insensitively duplicated column names."""
    seen = {}
    for f in schema.fields:
        low = f.name.lower()
        if low in seen:
            raise errors.duplicate_columns(context, seen[low], f.name)
        seen[low] = f.name


_WIDENING: List[Tuple[type, type]] = [
    (ByteType, ShortType), (ByteType, IntegerType), (ByteType, LongType),
    (ShortType, IntegerType), (ShortType, LongType), (IntegerType, LongType),
    (FloatType, DoubleType),
]


def _write_type_compatible(data_t: DataType, table_t: DataType) -> bool:
    if data_t == table_t or isinstance(data_t, NullType):
        return True
    return any(isinstance(data_t, a) and isinstance(table_t, b) for a, b in _WIDENING)


def enforce_write_compatibility(table_schema: StructType, data_schema: StructType) -> None:
    """Refuse a write whose columns are not in the table, or whose types the
    writer cannot cast implicitly; missing table columns fill with NULL."""
    extra, mismatched = [], []
    table_by_lower = {f.name.lower(): f for f in table_schema.fields}
    for f in data_schema.fields:
        t = table_by_lower.get(f.name.lower())
        if t is None:
            extra.append(f.name)
        elif not _write_type_compatible(f.data_type, t.data_type):
            mismatched.append(f"{f.name}: data {f.data_type.simple_string()} vs table "
                              f"{t.data_type.simple_string()}")
    if extra or mismatched:
        raise SchemaMismatchError(
            "A schema mismatch detected when writing to the Delta table.\n"
            + (f"Data columns not in the table schema: {extra}.\n" if extra else "")
            + (f"Type mismatches: {mismatched}.\n" if mismatched else "")
            + "To allow schema migration, set option mergeSchema=true.")

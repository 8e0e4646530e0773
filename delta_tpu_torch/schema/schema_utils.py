"""Schema checks of the write path (the port's own copy of part of
``delta_tpu.schema.schema_utils`` and ``delta_tpu.schema.arrow_interop``).

The JAX package maps a ``pyarrow`` schema onto the Delta types
(``schema_from_arrow``); the port maps a ``HostTable``'s columns, whose
stored type (``HostColumn.type``, or the kind's widest type) plays the
Arrow type's part: a decimal's ``decimal128(p, s)``, a nested column's
spec (``expr/nested``: ``("struct", ((name, spec), ...))``, ``("list",
spec)``, ``("map", key spec, value spec)``). :func:`merge_schemas` is the
JAX package's schema merge (``SchemaUtils.scala:817-922``).
"""
from __future__ import annotations

from typing import Any, Iterable, List, Optional, Sequence, Tuple

from delta_tpu_torch.schema.types import (
    ArrayType, BinaryType, BooleanType, ByteType, DataType, DateType, DecimalType, DoubleType,
    FloatType, IntegerType, LongType, MapType, NullType, ShortType, StringType, StructField,
    StructType, TimestampType,
)
from delta_tpu_torch.expr.nested import decimal_ps, decimal_type, leaf_kind
from delta_tpu_torch.expr.vectorized import stored_type
from delta_tpu_torch.utils import errors
from delta_tpu_torch.utils.errors import SchemaMismatchError

__all__ = ["check_column_names", "check_partition_columns", "check_column_name_duplication",
           "enforce_write_compatibility", "delta_type_for", "stored_type_for",
           "schema_from_table", "merge_schemas"]

_INVALID_CHARS = set(' ,;{}()\n\t=')

#: HostColumn stored type -> Delta type (``delta_type_from_arrow``)
_DELTA_TYPES = {
    "bool": BooleanType, "int8": ByteType, "int16": ShortType, "int32": IntegerType,
    "int64": LongType, "float32": FloatType, "float64": DoubleType, "string": StringType,
    "binary": BinaryType, "date32": DateType, "timestamp[us]": TimestampType,
    "timestamp[us, tz=UTC]": TimestampType,
}
def delta_type_for(col) -> DataType:
    """The Delta type of a ``HostColumn``; an all-NULL column of no type is
    a string, as an Arrow null column is."""
    if col.kind == "null":
        return StringType()
    return _delta_type_of(stored_type(col), col)


def _delta_type_of(spec: Any, col=None) -> DataType:
    """The Delta type of a stored type or nested spec
    (``delta_type_from_arrow``: struct fields nullable, a list's elements
    and a map's values may be NULL)."""
    if isinstance(spec, tuple):
        if spec[0] == "struct":
            return StructType([StructField(n, _delta_type_of(s), True) for n, s in spec[1]])
        if spec[0] == "list":
            return ArrayType(_delta_type_of(spec[1]))
        return MapType(_delta_type_of(spec[1]), _delta_type_of(spec[2]))
    ps = decimal_ps(spec)
    if ps is not None:
        return DecimalType(*ps)
    if spec not in _DELTA_TYPES:
        what = f"a {col.kind} column of type {col.type!r}" if col is not None else repr(spec)
        raise NotImplementedError(f"{what} has no Delta type in the port")
    return _DELTA_TYPES[spec]()


def stored_type_for(dt: DataType) -> Tuple[str, Any]:
    """(kind, stored type) of a Delta type (``arrow_type_for``); a nested
    type's stored type is its spec."""
    spec = _spec_for(dt)
    if isinstance(spec, tuple):
        return "nested", spec
    return leaf_kind(spec), spec


def _spec_for(dt: DataType) -> Any:
    if isinstance(dt, DecimalType):
        return decimal_type(dt.precision, dt.scale)
    if isinstance(dt, StructType):
        return ("struct", tuple((f.name, _spec_for(f.data_type)) for f in dt.fields))
    if isinstance(dt, ArrayType):
        return ("list", _spec_for(dt.element_type))
    if isinstance(dt, MapType):
        return ("map", _spec_for(dt.key_type), _spec_for(dt.value_type))
    for stype, cls in _DELTA_TYPES.items():
        if type(dt) is cls and stype != "timestamp[us, tz=UTC]":
            return stype
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
    """Data can be written into the table column: equal type, NullType, an
    implicit numeric widening, or nested types whose parts are."""
    if data_t == table_t or isinstance(data_t, NullType):
        return True
    if any(isinstance(data_t, a) and isinstance(table_t, b) for a, b in _WIDENING):
        return True
    if isinstance(data_t, StructType) and isinstance(table_t, StructType):
        table_by_lower = {f.name.lower(): f for f in table_t.fields}
        for f in data_t.fields:
            t = table_by_lower.get(f.name.lower())
            if t is None or not _write_type_compatible(f.data_type, t.data_type):
                return False
        return True
    if isinstance(data_t, ArrayType) and isinstance(table_t, ArrayType):
        return _write_type_compatible(data_t.element_type, table_t.element_type)
    if isinstance(data_t, MapType) and isinstance(table_t, MapType):
        return (_write_type_compatible(data_t.key_type, table_t.key_type)
                and _write_type_compatible(data_t.value_type, table_t.value_type))
    return False


def merge_schemas(current: StructType, new: StructType, allow_implicit_conversions: bool = False,
                  keep_existing_type: bool = False, fixed_type_columns: Iterable[str] = (),
                  path: str = "") -> StructType:
    """Merge ``new`` into ``current``: existing columns keep the current
    name case, position, nullability and metadata; new columns are
    appended. Byte/short/int always unify to the widest;
    ``allow_implicit_conversions`` accepts any implicit numeric cast,
    ``keep_existing_type`` keeps the current type at a primitive clash,
    ``fixed_type_columns`` may not change type. Two decimals of another
    precision or scale do not merge."""
    if not path:
        check_column_name_duplication(new, "in the data to save")
    fixed = {c.lower() for c in fixed_type_columns}
    merged: List[StructField] = []
    new_by_lower = {f.name.lower(): f for f in new.fields}
    for cur in current.fields:
        incoming = new_by_lower.pop(cur.name.lower(), None)
        if incoming is None:
            merged.append(cur)
            continue
        if not path and cur.name.lower() in fixed and cur.data_type != incoming.data_type:
            raise errors.generated_column_type_change(cur.name, cur.data_type.simple_string())
        merged_type = _merge_types(cur.data_type, incoming.data_type,
                                   allow_implicit_conversions, keep_existing_type,
                                   path + cur.name)
        merged.append(StructField(cur.name, merged_type, cur.nullable, dict(cur.metadata)))
    remaining = set(new_by_lower)
    merged.extend(f for f in new.fields if f.name.lower() in remaining)
    return StructType(merged)


_NUMERIC_PRECEDENCE = [ByteType, ShortType, IntegerType, LongType, FloatType, DoubleType]


def _precedence(t: DataType) -> Optional[int]:
    return next((i for i, cls in enumerate(_NUMERIC_PRECEDENCE) if isinstance(t, cls)), None)


def _merge_types(cur: DataType, new: DataType, widen: bool, keep_existing: bool,
                 path: str) -> DataType:
    if isinstance(cur, StructType) and isinstance(new, StructType):
        return merge_schemas(cur, new, widen, keep_existing, path=path + ".")
    if isinstance(cur, ArrayType) and isinstance(new, ArrayType):
        return ArrayType(_merge_types(cur.element_type, new.element_type, widen, keep_existing,
                                      path + ".element"), cur.contains_null)
    if isinstance(cur, MapType) and isinstance(new, MapType):
        return MapType(
            _merge_types(cur.key_type, new.key_type, widen, keep_existing, path + ".key"),
            _merge_types(cur.value_type, new.value_type, widen, keep_existing, path + ".value"),
            cur.value_contains_null)
    if isinstance(cur, NullType):
        return new
    if isinstance(new, NullType) or cur == new:
        return cur
    if keep_existing and not isinstance(cur, (StructType, ArrayType, MapType)):
        return cur
    if widen:
        pc, pn = _precedence(cur), _precedence(new)
        if pc is not None and pn is not None:
            return cur if pn <= pc else new
    if isinstance(cur, DecimalType) and isinstance(new, DecimalType):
        raise errors.decimal_merge_mismatch(cur.precision, new.precision, cur.scale, new.scale)
    int32_family = (ByteType, ShortType, IntegerType)
    if isinstance(cur, int32_family) and isinstance(new, int32_family):
        order = {ByteType: 0, ShortType: 1, IntegerType: 2}
        return cur if order[type(cur)] >= order[type(new)] else new
    raise SchemaMismatchError(f"Failed to merge fields '{path}': incompatible types "
                              f"{cur.simple_string()} and {new.simple_string()}")


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

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
           "schema_from_table", "merge_schemas", "find_column_position", "add_column",
           "drop_column_at", "replace_column_at", "find_field", "can_change_data_type",
           "normalize_column_names", "is_read_compatible",
           "ARRAY_ELEMENT_INDEX", "MAP_KEY_INDEX", "MAP_VALUE_INDEX"]

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
    """Reject case-insensitively duplicated column names, at any nesting
    level (the reference asks Spark's SchemaUtils before merging)."""

    def walk(dt: DataType, path: str):
        if isinstance(dt, StructType):
            seen = {}
            for f in dt.fields:
                low = f.name.lower()
                if low in seen:
                    raise errors.duplicate_columns(context, f"{path}{seen[low]}",
                                                   f"{path}{f.name}")
                seen[low] = f.name
                walk(f.data_type, path + f.name + ".")
        elif isinstance(dt, ArrayType):
            walk(dt.element_type, path + "element.")
        elif isinstance(dt, MapType):
            walk(dt.key_type, path + "key.")
            walk(dt.value_type, path + "value.")

    walk(schema, "")


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


# -- column positions: ALTER's ADD COLUMNS and CHANGE COLUMN -------------------

#: the container steps of a nested position (``find_column_position``)
ARRAY_ELEMENT_INDEX = 0
MAP_KEY_INDEX = 0
MAP_VALUE_INDEX = 1


def normalize_column_names(table_schema: StructType, data_schema: StructType
                           ) -> List[Tuple[str, str]]:
    """(data name, table name) case fixes (``normalizeColumnNames :223``)."""
    by_lower = {f.name.lower(): f for f in table_schema.fields}
    return [(f.name, by_lower[f.name.lower()].name) for f in data_schema.fields
            if f.name.lower() in by_lower and by_lower[f.name.lower()].name != f.name]


def is_read_compatible(existing: StructType, new: StructType) -> bool:
    """Can data written with ``existing`` be read as ``new``
    (``isReadCompatible :265``): ``new`` holds every existing column with
    its type and does not tighten nullability."""
    new_by_lower = {f.name.lower(): f for f in new.fields}
    for f in existing.fields:
        n = new_by_lower.get(f.name.lower())
        if n is None or not _type_read_compatible(f.data_type, n.data_type):
            return False
        if f.nullable and not n.nullable:
            return False
    return True


def _type_read_compatible(old: DataType, new: DataType) -> bool:
    if isinstance(old, StructType) and isinstance(new, StructType):
        return is_read_compatible(old, new)
    if isinstance(old, ArrayType) and isinstance(new, ArrayType):
        return _type_read_compatible(old.element_type, new.element_type)
    if isinstance(old, MapType) and isinstance(new, MapType):
        return (_type_read_compatible(old.key_type, new.key_type)
                and _type_read_compatible(old.value_type, new.value_type))
    return old == new


def _can_widen(from_t: DataType, to_t: DataType) -> bool:
    return any(isinstance(from_t, a) and isinstance(to_t, b) for a, b in _WIDENING)


def find_column_position(column: Sequence[str], schema: StructType) -> List[int]:
    """Resolve a dotted column path to nested ordinals
    (``findColumnPosition :480-530``): struct fields by case-insensitive
    name; ``element`` steps into an array's struct element, ``key``/``value``
    into a map's struct sides."""
    out: List[int] = []
    current: DataType = schema
    parts = list(column)
    i = 0
    while i < len(parts):
        name = parts[i]
        if not isinstance(current, StructType):
            if isinstance(current, ArrayType):
                if name.lower() != "element":
                    raise errors.array_access_element_path_hint(
                        '.'.join(parts[:i] + ['element'] + parts[i:]))
                out.append(ARRAY_ELEMENT_INDEX)
                current = current.element_type
                i += 1
                continue
            if isinstance(current, MapType):
                if name.lower() == "key":
                    out.append(MAP_KEY_INDEX)
                    current = current.key_type
                elif name.lower() == "value":
                    out.append(MAP_VALUE_INDEX)
                    current = current.value_type
                else:
                    raise errors.map_access_needs_key_or_value(name)
                i += 1
                continue
            raise errors.column_path_not_nested('.'.join(parts))
        pos = next(
            (j for j, f in enumerate(current.fields) if f.name.lower() == name.lower()),
            -1,
        )
        if pos == -1:
            raise errors.column_path_not_found(
                '.'.join(parts[: i + 1]), schema.simple_string())
        out.append(pos)
        current = current.fields[pos].data_type
        i += 1
    return out


def add_column(
    schema: StructType,
    field: StructField,
    position: Optional[Sequence[int]] = None,
) -> StructType:
    """Insert ``field`` at ``position`` (``addColumn :573-651``).

    ``position`` is a list of 0-based ordinals denoting a path through
    nested structs — e.g. ``[2, 1]`` inserts at index 1 inside the struct at
    top-level index 2. Inside containers, path steps use
    ``ARRAY_ELEMENT_INDEX`` / ``MAP_KEY_INDEX`` / ``MAP_VALUE_INDEX``. An
    int or None keeps the historical top-level behavior (None = append)."""
    if position is None:
        position = [len(schema.fields)]
    elif isinstance(position, int):
        position = [min(position, len(schema.fields))]
    position = list(position)
    if not position:
        raise errors.add_column_anchor_not_found(field.name)
    slice_pos = position[0]
    if slice_pos < 0:
        raise errors.add_column_index_below_zero(slice_pos, field.name)
    length = len(schema.fields)
    if slice_pos > length:
        raise errors.add_column_index_too_large(slice_pos, field.name, length)
    if len(position) == 1 and any(
        f.name.lower() == field.name.lower() for f in schema.fields
    ):
        raise errors.column_already_exists(field.name)
    if slice_pos == length:
        if len(position) > 1:
            raise errors.struct_not_found_at_position(slice_pos)
        return StructType(list(schema.fields) + [field])
    fields = list(schema.fields)
    if len(position) == 1:
        fields.insert(slice_pos, field)
        return StructType(fields)

    parent = fields[slice_pos]
    tail = position[1:]
    if not field.nullable and parent.nullable:
        raise errors.DeltaAnalysisError(
            "A non-nullable nested field can't be added to a nullable parent. "
            "Please set the nullability of the parent column accordingly."
        )
    dt = parent.data_type
    if isinstance(dt, StructType):
        new_dt: DataType = add_column(dt, field, tail)
    elif isinstance(dt, ArrayType) and isinstance(dt.element_type, StructType):
        if tail[0] != ARRAY_ELEMENT_INDEX:
            raise errors.DeltaAnalysisError(
                "Incorrectly accessing an ArrayType. Use arrayname.element."
                "elementname position to add to an array."
            )
        new_dt = ArrayType(
            add_column(dt.element_type, field, tail[1:]), dt.contains_null
        )
    elif isinstance(dt, MapType):
        if tail[0] == MAP_KEY_INDEX and isinstance(dt.key_type, StructType):
            new_dt = MapType(
                add_column(dt.key_type, field, tail[1:]),
                dt.value_type, dt.value_contains_null,
            )
        elif tail[0] == MAP_VALUE_INDEX and isinstance(dt.value_type, StructType):
            new_dt = MapType(
                dt.key_type,
                add_column(dt.value_type, field, tail[1:]),
                dt.value_contains_null,
            )
        else:
            raise errors.parent_not_struct(field.name)
    else:
        raise errors.parent_not_struct(field.name, dt.simple_string())
    fields[slice_pos] = StructField(
        parent.name, new_dt, parent.nullable, dict(parent.metadata)
    )
    return StructType(fields)


def _descend_replace(dt: DataType, tail: Sequence[int], recurse, verb: str):
    """Shared container traversal for positional edits: struct positions
    index fields; array/map positions use ARRAY_ELEMENT_INDEX /
    MAP_KEY_INDEX / MAP_VALUE_INDEX (the steps `find_column_position`
    emits). ``recurse(inner_struct, remaining_tail)`` produces the edited
    struct."""
    tail = list(tail)
    if isinstance(dt, StructType):
        return recurse(dt, tail)
    if isinstance(dt, ArrayType) and isinstance(dt.element_type, StructType):
        if tail[0] != ARRAY_ELEMENT_INDEX:
            raise errors.array_access_needs_element_step(verb)
        return ArrayType(recurse(dt.element_type, tail[1:]), dt.contains_null)
    if isinstance(dt, MapType):
        if tail[0] == MAP_KEY_INDEX and isinstance(dt.key_type, StructType):
            return MapType(
                recurse(dt.key_type, tail[1:]), dt.value_type,
                dt.value_contains_null,
            )
        if tail[0] == MAP_VALUE_INDEX and isinstance(dt.value_type, StructType):
            return MapType(
                dt.key_type, recurse(dt.value_type, tail[1:]),
                dt.value_contains_null,
            )
    raise errors.nested_op_only_in_struct(verb, dt.simple_string())


def drop_column_at(
    schema: StructType, position: Sequence[int]
) -> Tuple[StructType, StructField]:
    """Drop the field at a nested ``position``; returns (new schema, dropped
    field) (``dropColumn :663-689``)."""
    position = list(position)
    if not position:
        raise errors.DeltaAnalysisError("Don't know where to drop the column")
    slice_pos = position[0]
    if slice_pos < 0:
        raise errors.drop_column_index_below_zero(slice_pos)
    length = len(schema.fields)
    if slice_pos >= length:
        raise errors.drop_column_index_too_large(slice_pos, length)
    fields = list(schema.fields)
    if len(position) == 1:
        # an empty struct is legal here: CHANGE COLUMN moves are
        # drop-then-add, transiently emptying single-field structs; the
        # user-facing DROP path (`drop_column`) still refuses emptying a table
        dropped = fields.pop(slice_pos)
        return StructType(fields), dropped
    parent = fields[slice_pos]
    box: List[StructField] = []

    def recurse(inner: StructType, tail):
        new_inner, dropped = drop_column_at(inner, tail)
        box.append(dropped)
        return new_inner

    new_dt = _descend_replace(parent.data_type, position[1:], recurse, "drop")
    fields[slice_pos] = StructField(
        parent.name, new_dt, parent.nullable, dict(parent.metadata)
    )
    return StructType(fields), box[0]


def replace_column_at(
    schema: StructType, position: Sequence[int], new_field: StructField
) -> StructType:
    """Replace the field at a nested struct ``position`` (CHANGE COLUMN's
    in-place edit; container-index steps are not valid here)."""
    position = list(position)
    if not position:
        raise errors.DeltaAnalysisError("Don't know which column to replace")
    slice_pos = position[0]
    if not 0 <= slice_pos < len(schema.fields):
        raise errors.replace_column_index_oob(slice_pos)
    fields = list(schema.fields)
    if len(position) == 1:
        fields[slice_pos] = new_field
        return StructType(fields)
    parent = fields[slice_pos]
    new_dt = _descend_replace(
        parent.data_type, position[1:],
        lambda inner, tail: replace_column_at(inner, tail, new_field),
        "replace",
    )
    fields[slice_pos] = StructField(
        parent.name, new_dt, parent.nullable, dict(parent.metadata)
    )
    return StructType(fields)


def find_field(schema: StructType, name: str) -> Optional[StructField]:
    """Case-insensitive lookup; dotted names traverse nested structs, with
    ``element`` / ``key`` / ``value`` stepping through arrays and maps."""
    parts = name.split(".")
    current: DataType = schema
    field = None
    for p in parts:
        low = p.lower()
        if isinstance(current, ArrayType) and low == "element":
            current = current.element_type
            continue
        if isinstance(current, MapType) and low in ("key", "value"):
            current = current.key_type if low == "key" else current.value_type
            continue
        if not isinstance(current, StructType):
            return None
        field = next((f for f in current.fields if f.name.lower() == low), None)
        if field is None:
            return None
        current = field.data_type
    return field


def can_change_data_type(from_t: DataType, to_t: DataType) -> bool:
    """ALTER CHANGE COLUMN type changes: NullType→anything, value-preserving
    numeric widening, or nested containers whose element change is legal.
    (Comment/nullability-loosening changes are handled by the caller.)

    Deliberate divergence from the reference (``SchemaUtils.scala:694``,
    which allows only NullType→anything and nested recursion): we also
    accept the ``_WIDENING`` lattice (byte→short→int→long, float→double).
    Widening is lossless, our Arrow read path casts old files up to the
    table schema on scan, and the write path normalizes new data to the
    widened type — so the strictness the reference needs to protect its
    fixed-width Parquet readers does not apply here.
    """
    if isinstance(from_t, NullType):
        return True
    if _can_widen(from_t, to_t):
        return True
    if isinstance(from_t, StructType) and isinstance(to_t, StructType):
        from_by_lower = {f.name.lower(): f for f in from_t.fields}
        seen = set()
        for t in to_t.fields:
            f = from_by_lower.get(t.name.lower())
            if f is None:
                # adding a column mid-change is legal only when nullable
                # (SchemaUtils.scala:731-733)
                if not t.nullable:
                    return False
                continue
            seen.add(t.name.lower())
            # tightening nullability is never legal (:705-707)
            if f.nullable and not t.nullable:
                return False
            if not can_change_data_type(f.data_type, t.data_type):
                return False
        # dropping columns via CHANGE COLUMN is not legal (:735-737)
        if len(seen) < len(from_t.fields):
            return False
        return True
    if isinstance(from_t, ArrayType) and isinstance(to_t, ArrayType):
        if from_t.contains_null and not to_t.contains_null:
            return False
        return can_change_data_type(from_t.element_type, to_t.element_type)
    if isinstance(from_t, MapType) and isinstance(to_t, MapType):
        if from_t.value_contains_null and not to_t.value_contains_null:
            return False
        return can_change_data_type(from_t.key_type, to_t.key_type) and can_change_data_type(
            from_t.value_type, to_t.value_type
        )
    return from_t == to_t

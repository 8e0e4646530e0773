"""ALTER TABLE: SET/UNSET TBLPROPERTIES, ADD COLUMNS, CHANGE COLUMN and
ADD/DROP CONSTRAINT (the port's own copy of ``delta_tpu.commands.alter``).
Each is one metadata-only transaction; ADD CONSTRAINT first reads the
table and holds every row to the new check, as the reference does.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Dict, Optional, Sequence

from delta_tpu_torch.commands import operations as ops
from delta_tpu_torch.expr.parser import parse_predicate
from delta_tpu_torch.expr.vectorized import boolean_mask
from delta_tpu_torch.schema import schema_utils
from delta_tpu_torch.schema.constraints import CONSTRAINT_PROP_PREFIX
from delta_tpu_torch.schema.types import ArrayType, MapType, StructField, StructType
from delta_tpu_torch.utils import errors

__all__ = ["set_table_properties", "unset_table_properties", "add_columns", "change_column",
           "add_constraint", "drop_constraint"]


def set_table_properties(delta_log, properties: Dict[str, str]) -> int:
    def body(txn):
        meta = txn.metadata
        cfg = dict(meta.configuration or {})
        cfg.update({k: str(v) for k, v in properties.items()})
        txn.update_metadata(replace(meta, configuration=cfg))
        return txn.commit([], ops.SetTableProperties(properties))

    return delta_log.with_new_transaction(body)


def unset_table_properties(delta_log, keys: Sequence[str], if_exists: bool = False) -> int:
    def body(txn):
        meta = txn.metadata
        cfg = dict(meta.configuration or {})
        norm = {k.lower(): k for k in cfg}
        for k in keys:
            actual = norm.get(k.lower())
            if actual is None:
                if not if_exists:
                    raise errors.unset_nonexistent_property(k, delta_log.data_path)
                continue
            del cfg[actual]
        txn.update_metadata(replace(meta, configuration=cfg))
        return txn.commit([], ops.UnsetTableProperties(list(keys), if_exists))

    return delta_log.with_new_transaction(body)


def _position_spec(schema: StructType, parent_parts, leaf_spec):
    """The nested position of a column: ``parent_parts`` is the dotted path
    of the enclosing struct ([] = top level), ``leaf_spec`` None (append),
    "first" or ("after", sibling)."""
    if parent_parts:
        parent_pos = schema_utils.find_column_position(parent_parts, schema)
        parent = schema
        for step in parent_pos:
            if isinstance(parent, StructType):
                parent = parent.fields[step].data_type
            elif isinstance(parent, ArrayType):
                parent = parent.element_type
            elif isinstance(parent, MapType):
                parent = (parent.key_type if step == schema_utils.MAP_KEY_INDEX
                          else parent.value_type)
            else:
                raise errors.parent_is_not_struct(".".join(parent_parts))
        if not isinstance(parent, StructType):
            raise errors.parent_is_not_struct(".".join(parent_parts))
    else:
        parent_pos = []
        parent = schema
    if leaf_spec is None:
        idx = len(parent.fields)
    elif leaf_spec == "first":
        idx = 0
    elif isinstance(leaf_spec, tuple) and leaf_spec[0] == "after":
        sib = leaf_spec[1].lower()
        match = next((i for i, f in enumerate(parent.fields) if f.name.lower() == sib), None)
        if match is None:
            raise errors.position_after_column_not_found(leaf_spec[1])
        idx = match + 1
    else:
        raise errors.invalid_column_position_spec(leaf_spec)
    return list(parent_pos) + [idx]


def add_columns(delta_log, new_fields: Sequence[StructField],
                positions: Optional[Dict[str, object]] = None) -> int:
    """ADD COLUMNS: new columns must be nullable. A dotted name (``s.x``)
    adds inside the named nested struct; ``positions`` maps a name to
    ``"first"`` or ``("after", sibling)`` within its parent (default: the
    end)."""
    from delta_tpu_torch.schema.char_varchar import replace_char_varchar_with_string

    positions = positions or {}
    new_fields = list(replace_char_varchar_with_string(StructType(list(new_fields))).fields)

    def body(txn):
        meta = txn.metadata
        schema = meta.schema
        for f in new_fields:
            if not f.nullable:
                raise errors.add_columns_must_be_nullable(f.name)
            parts = f.name.split(".")
            leaf = replace(f, name=parts[-1])
            pos = _position_spec(schema, parts[:-1], positions.get(f.name))
            schema = schema_utils.add_column(schema, leaf, pos)
        txn.update_metadata(replace(meta, schema_string=schema.to_json()))
        return txn.commit([], ops.AddColumns([{"column": f.json_value()} for f in new_fields]))

    return delta_log.with_new_transaction(body)


def change_column(delta_log, name: str, new_type=None, nullable: Optional[bool] = None,
                  comment: Optional[str] = None, position=None) -> int:
    """CHANGE COLUMN: widen the type, relax nullability (never tighten), set
    a comment, or move the column (``position`` "first" or ("after",
    sibling)) within its parent. Dotted names edit nested struct fields."""

    def body(txn):
        meta = txn.metadata
        schema = meta.schema
        parts = name.split(".")
        pos = schema_utils.find_column_position(parts, schema)
        field = schema_utils.find_field(schema, name)
        if field is None:
            raise errors.column_not_in_schema(name)
        new_field = field
        if new_type is not None and new_type != field.data_type:
            if not schema_utils.can_change_data_type(field.data_type, new_type):
                raise errors.cannot_change_column_type(
                    name, field.data_type.simple_string(), new_type.simple_string())
            new_field = replace(new_field, data_type=new_type)
        if nullable is not None:
            if not nullable and field.nullable:
                raise errors.cannot_change_nullable_to_not_null(name)
            new_field = replace(new_field, nullable=nullable)
        if comment is not None:
            md = dict(new_field.metadata or {})
            md["comment"] = comment
            new_field = replace(new_field, metadata=md)
        if position is None:
            schema = schema_utils.replace_column_at(schema, pos, new_field)
        else:
            schema, _ = schema_utils.drop_column_at(schema, pos)
            schema = schema_utils.add_column(schema, new_field,
                                             _position_spec(schema, parts[:-1], position))
        txn.update_metadata(replace(meta, schema_string=schema.to_json()))
        return txn.commit([], ops.ChangeColumn(name, new_field.json_value()))

    return delta_log.with_new_transaction(body)


def add_constraint(delta_log, name: str, expr_sql: str) -> int:
    """ADD CONSTRAINT (``:519``): every existing row must satisfy the check
    before it commits (the reference runs a full scan too)."""
    from delta_tpu_torch.exec.scan import scan_to_table

    key = CONSTRAINT_PROP_PREFIX + name.lower()

    def body(txn):
        meta = txn.metadata
        cfg = dict(meta.configuration or {})
        if any(k.lower() == key for k in cfg):
            raise errors.constraint_already_exists(name)
        expr = parse_predicate(expr_sql)
        existing = scan_to_table(txn.snapshot)
        if existing.num_rows:
            bad = int((~boolean_mask(expr, existing)).sum())
            if bad:
                raise errors.new_check_constraint_violated(bad, delta_log.data_path, expr_sql)
        txn.read_whole_table()
        cfg[key] = expr_sql
        txn.update_metadata(replace(meta, configuration=cfg))
        return txn.commit([], ops.AddConstraint(name, expr_sql))

    return delta_log.with_new_transaction(body)


def drop_constraint(delta_log, name: str, if_exists: bool = True) -> int:
    key = CONSTRAINT_PROP_PREFIX + name.lower()

    def body(txn):
        meta = txn.metadata
        cfg = dict(meta.configuration or {})
        actual = next((k for k in cfg if k.lower() == key), None)
        if actual is None:
            if if_exists:
                return txn.commit([], ops.DropConstraint(name, None))
            raise errors.constraint_does_not_exist(name)
        expr = cfg.pop(actual)
        txn.update_metadata(replace(meta, configuration=cfg))
        return txn.commit([], ops.DropConstraint(name, expr))

    return delta_log.with_new_transaction(body)

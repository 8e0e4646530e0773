"""Char/varchar semantics (the port's own copy of
``delta_tpu.schema.char_varchar``): the declaration a CREATE and an ADD
COLUMNS commit, the write-side length check and padding
(:func:`apply_write_semantics`), and the read-side char(n) padding.
A char(n) column is stored as STRING plus the reference's type-string field
metadata (``CharVarcharUtils.scala:38``), or declared as ``char(n)``."""
from __future__ import annotations

from typing import Optional

import numpy as np

from delta_tpu_torch.expr import ir
from delta_tpu_torch.expr.vectorized import HostColumn, HostTable
from delta_tpu_torch.schema.types import (
    CharType, DataType, StringType, StructField, StructType, VarcharType, parse_data_type,
)
from delta_tpu_torch.utils import errors

__all__ = ["CHAR_VARCHAR_TYPE_STRING_METADATA_KEY", "replace_char_varchar_with_string",
           "raw_type", "apply_write_semantics", "pad_char_literals"]

CHAR_VARCHAR_TYPE_STRING_METADATA_KEY = "__CHAR_VARCHAR_TYPE_STRING"


def replace_char_varchar_with_string(schema: StructType) -> StructType:
    """Top-level char/varchar fields become STRING plus the type-string
    metadata (``CharVarcharUtils.scala:35-60``); nested ones are kept."""
    fields = []
    for f in schema.fields:
        if isinstance(f.data_type, (CharType, VarcharType)):
            md = dict(f.metadata or {})
            md[CHAR_VARCHAR_TYPE_STRING_METADATA_KEY] = f.data_type.name
            fields.append(StructField(f.name, StringType(), f.nullable, md))
        else:
            fields.append(f)
    return StructType(fields)


def raw_type(field: StructField) -> DataType:
    """The field's DECLARED type: char/varchar recovered from metadata,
    otherwise the stored type."""
    ts = (field.metadata or {}).get(CHAR_VARCHAR_TYPE_STRING_METADATA_KEY)
    if ts:
        try:
            dt = parse_data_type(ts)
        except ValueError:
            return field.data_type
        if isinstance(dt, (CharType, VarcharType)):
            return dt
    return field.data_type


def apply_write_semantics(table: HostTable, metadata) -> HostTable:
    """The write-path char/varchar step over a batch:

    - an over-length value first sheds trailing spaces down to the bound
      (the reference's char/varcharTypeWriteSideCheck trims before it
      errs): it truncates to exactly n characters, never a full rtrim;
    - a value still longer than n characters raises the length error;
    - char(n): values pad with spaces on the right to exactly n characters
      (the data file carries the padded form, so every reader agrees).
    """
    cols = dict(table.columns)
    for f in metadata.schema.fields:
        dt = raw_type(f)
        if not isinstance(dt, (CharType, VarcharType)):
            continue
        name = next((c for c in cols if c.lower() == f.name.lower()), None)
        if name is None or cols[name].kind != "str" or cols[name].type not in (None, "string"):
            continue
        col = cols[name]
        live = np.flatnonzero(col.valid)
        vals = col.values.copy()
        over = [i for i in live.tolist() if len(vals[i]) > dt.length]
        if over:
            still = [i for i in over if len(vals[i].rstrip(" ")) > dt.length]
            if still:
                raise errors.char_varchar_length_exceeded(
                    f.name, dt.name, dt.length, vals[still[0]].rstrip(" "))
            for i in over:
                vals[i] = vals[i][:dt.length]
        if isinstance(dt, CharType):
            for i in live.tolist():
                vals[i] = vals[i].ljust(dt.length)
        cols[name] = HostColumn("str", vals, col.valid, col.type)
    return HostTable(cols, table.num_rows)


def pad_char_literals(expr, metadata, target_qualifiers=None):
    """Read-side char padding (the reference's `ApplyCharTypePadding`):
    string literals compared against a char(n) column pad to width n, so
    `c = 'ab'` matches the stored 'ab   '. Applies to =, <, <=, >, >=, IN
    with a char column on either side; other shapes pass through.

    Only refs that RESOLVE to the target table pad (the reference pads
    resolved char-typed attributes, never by name coincidence):
    ``target_qualifiers=None`` means every qualifier names the target —
    right for single-table contexts (scan/UPDATE/DELETE filters). MERGE
    passes the set of qualifiers that resolve to the target (its target
    alias, lowercased) so a SOURCE column that merely shares a name with a
    target char column — ``s.status = 'x'`` — keeps its literal unpadded
    instead of silently matching nothing."""
    schema: StructType = metadata.schema
    widths = {}
    for f in schema.fields:
        dt = raw_type(f)
        if isinstance(dt, CharType):
            widths[f.name.lower()] = dt.length

    if not widths:
        return expr

    def width_of(node) -> Optional[int]:
        if not isinstance(node, ir.Column):
            return None
        low = node.name.lower()
        qual, _, col = low.rpartition(".")
        if qual and target_qualifiers is not None \
                and qual not in target_qualifiers:
            return None  # qualified ref resolving elsewhere (merge source)
        return widths.get(col)

    def pad(lit, n: int):
        if isinstance(lit, ir.Literal) and isinstance(lit.value, str) \
                and len(lit.value) < n:
            return ir.Literal(lit.value.ljust(n))
        return lit

    def lit_len(node) -> int:
        if isinstance(node, ir.Literal) and isinstance(node.value, str):
            return len(node.value)
        return 0

    def rpad_col(node, width: int):
        """Pad the COLUMN side out to the literal's length — the reference
        pads both sides to the longest (`ApplyCharTypePadding`), so a
        literal LONGER than char(n) still compares against the stored
        padded form: char(3) c = 'ab  ' matches stored 'ab '."""
        if isinstance(node, ir.Column) and width_of(node):
            return ir.Func("rpad", (node, ir.Literal(width), ir.Literal(" ")))
        return node

    def rewrite(node):
        t = type(node)
        if t in (ir.Eq, ir.Lt, ir.Le, ir.Gt, ir.Ge):
            n = width_of(node.left) or width_of(node.right)
            if n:
                width = max(n, lit_len(node.left), lit_len(node.right))
                l, r = pad(node.left, width), pad(node.right, width)
                if width > n:
                    l, r = rpad_col(l, width), rpad_col(r, width)
                return t(l, r)
        if t is ir.In:
            n = width_of(node.value)
            if n:
                width = max([n] + [lit_len(o) for o in node.options])
                value = node.value
                if width > n:
                    value = rpad_col(value, width)
                return ir.In(value, tuple(pad(o, width) for o in node.options))
        return None

    return expr.transform(rewrite)

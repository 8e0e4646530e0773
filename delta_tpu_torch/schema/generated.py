"""Generated columns: compute on write and validation (the port's own copy
of ``delta_tpu.schema.generated``, ``GeneratedColumn.scala:79-365``).

A generated column's value comes from other columns through the
expression in its field metadata under ``delta.generationExpression``;
writer version 4 gates it (``txn/transaction``). On write
(``exec/write``): a column missing from the batch is computed from the
expression; a column the batch provides is held null-safe-equal to the
computed value (the reference emits the equivalent CHECK constraint,
``:267``).

The determinism whitelist (``SupportedGenerationExpressions.scala``) is
the expression IR itself: every node the parser produces is deterministic,
so an expression that parses is whitelisted. Validation adds the
structural rules: references exist and name no generated column (no
chains, no self-reference).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from delta_tpu_torch.expr import ir
from delta_tpu_torch.expr.parser import parse_expression
from delta_tpu_torch.expr.vectorized import (
    HostColumn, HostTable, cast_column, evaluate, null_column, stored_type, where_column,
)
from delta_tpu_torch.schema import schema_utils
from delta_tpu_torch.schema.types import DataType, StructField, StructType
from delta_tpu_torch.utils import errors
from delta_tpu_torch.utils.errors import DeltaAnalysisError, InvariantViolationError

__all__ = ["GENERATION_EXPRESSION_KEY", "generated_field", "generation_expressions",
           "generated_column_names", "fixed_type_columns", "has_generated_columns",
           "validate_generated_columns", "compute_on_write", "recompute_stale",
           "columns_to_recompute"]

GENERATION_EXPRESSION_KEY = "delta.generationExpression"


def generated_field(name: str, data_type: DataType, expr_sql: str,
                    nullable: bool = True) -> StructField:
    """A StructField carrying a generation expression (the DDL helper)."""
    return StructField(name, data_type, nullable, metadata={GENERATION_EXPRESSION_KEY: expr_sql})


def generation_expressions(schema: StructType) -> Dict[str, ir.Expression]:
    """Column name -> parsed generation expression (an unknown function
    raises: the parser produces only deterministic IR)."""
    out: Dict[str, ir.Expression] = {}
    for f in schema.fields:
        sql = (f.metadata or {}).get(GENERATION_EXPRESSION_KEY)
        if sql is not None:
            try:
                out[f.name] = parse_expression(sql)
            except DeltaAnalysisError as e:
                raise errors.invalid_generation_expression(f.name, e) from e
    return out


def generated_column_names(schema: StructType) -> set:
    """Lowered names of the generated columns (MERGE's star coverage and
    insert projection share this one definition)."""
    return {name.lower() for name in generation_expressions(schema)}


def fixed_type_columns(schema: StructType) -> set:
    """Lowered names whose types schema evolution must never change: the
    generated columns and every column their expressions reference."""
    out = set()
    for name, expr in generation_expressions(schema).items():
        out.add(name.lower())
        out.update(r.lower() for r in ir.references(expr))
    return out


def has_generated_columns(schema: StructType) -> bool:
    return any(GENERATION_EXPRESSION_KEY in (f.metadata or {}) for f in schema.fields)


def validate_generated_columns(schema: StructType) -> None:
    """The structural rules (``validateGeneratedColumns``): expressions
    parse, references exist, and no generated column references a
    generated column (itself included)."""
    exprs = generation_expressions(schema)
    names = {f.name.lower() for f in schema.fields}
    gen_names = {c.lower() for c in exprs}
    for col, e in exprs.items():
        for r in ir.references(e):
            if r.lower() not in names:
                raise errors.generation_expr_unknown_column(col, r)
            if r.lower() in gen_names:
                raise errors.generation_expr_references_generated(col, r)


def _safe_cast(col_name: str, vals: HostColumn, dtype: DataType) -> HostColumn:
    """``vals`` as the declared type, refusing what Arrow's safe cast
    refuses: a cast the evaluator lacks, an integer that does not fit, a
    fraction cast to an integer."""
    kind, stype = schema_utils.stored_type_for(dtype)
    try:
        out = cast_column(vals, kind, stype)
    except NotImplementedError as exc:
        raise errors.generation_expr_type_mismatch(col_name, stored_type(vals), stype,
                                                   exc) from None
    if kind == "int" and vals.kind in ("int", "double"):
        lost = vals.valid & (out.values.astype(vals.values.dtype) != vals.values)
        if lost.any():
            raise errors.generation_expr_type_mismatch(
                col_name, stored_type(vals), stype,
                f"value {vals.values[np.argmax(lost)]!r} does not fit")
    return out


def _computed(col_name: str, e: ir.Expression, table: HostTable, dtype: DataType) -> HostColumn:
    return _safe_cast(col_name, evaluate(e, table), dtype)


def _find(table: HostTable, name: str) -> Optional[str]:
    return next((c for c in table.column_names if c.lower() == name.lower()), None)


def compute_on_write(table: HostTable, schema: StructType) -> HostTable:
    """Fill in missing generated columns; hold provided ones to the
    expression. Runs before ``normalize_data``, which turns a missing
    column into NULLs and so loses whether it was provided."""
    exprs = generation_expressions(schema)
    if not exprs:
        return table
    gen_low = {c.lower() for c in exprs}
    by_lower = {f.name.lower(): f for f in schema.fields}
    # a batch may omit a nullable base column the expressions reference
    # (normalize_data null-fills it later): null-fill it here first, so the
    # expressions compute over NULLs
    for f in schema.fields:
        if f.name.lower() in gen_low or _find(table, f.name) is not None:
            continue
        table = table.append_column(f.name, null_column(
            table.num_rows, *schema_utils.stored_type_for(f.data_type)))
    for col, e in exprs.items():
        f = by_lower[col.lower()]
        provided_name = _find(table, col)
        expected = _computed(col, e, table, f.data_type)
        if provided_name is None:
            table = table.append_column(col, expected)
            continue
        provided = table.columns[provided_name]
        if stored_type(provided) != stored_type(expected):
            provided = cast_column(provided, expected.kind, expected.type)
        # null-safe equality: equal values, or both NULL
        eq = provided.valid & expected.valid & (provided.values == expected.values)
        ok = eq | (~provided.valid & ~expected.valid)
        bad = int((~ok).sum())
        if bad:
            raise InvariantViolationError(
                f"CHECK constraint Generated Column ({col} <=> {e.sql()}) violated by {bad} "
                "row(s): provided values do not match the generation expression")
    return table


def recompute_stale(table: HostTable, schema: StructType, assigned: List[str],
                    mask: Optional[np.ndarray] = None) -> HostTable:
    """Recompute the generated columns whose base columns ``assigned`` (an
    UPDATE's or a MERGE update's SET targets) names; rows where ``mask`` is
    false keep their values. A stale copy would fail the write's check."""
    stale = columns_to_recompute(schema, assigned)
    if not stale:
        return table
    exprs = generation_expressions(schema)
    cols = dict(table.columns)
    for col in stale:
        actual = _find(table, col)
        old = cols[actual]
        new = cast_column(evaluate(exprs[col], table), old.kind, stored_type(old))
        cols[actual] = where_column(mask, new, old) if mask is not None else new
    return HostTable(cols, table.num_rows)


def columns_to_recompute(schema: StructType, assigned: List[str]) -> List[str]:
    """Generated columns whose references meet ``assigned`` and which were
    not themselves assigned."""
    assigned_low = {a.lower() for a in assigned}
    return [col for col, e in generation_expressions(schema).items()
            if col.lower() not in assigned_low
            and any(r.lower() in assigned_low for r in ir.references(e))]

"""Partition-predicate evaluation over AddFile.partitionValues (the port's
own copy of ``delta_tpu.expr.partition``).

Predicates are evaluated per file against the typed partition values.
Empty-string or missing values are NULL, cast failures are NULL, and a
predicate evaluating to NULL does not match the file (Spark filter
semantics).
"""
from __future__ import annotations

import decimal
from typing import Any, Dict, Iterable, List, Optional, Sequence

from delta_tpu_torch.expr import ir
from delta_tpu_torch.expr.parser import parse_expression
from delta_tpu_torch.protocol.actions import AddFile
from delta_tpu_torch.schema.types import (
    DateType, DecimalType, StringType, StructType, TimestampType,
)
from delta_tpu_torch.utils.timeparse import iso_to_date, iso_to_naive_utc

__all__ = ["typed_partition_row", "eval_on_file", "matches", "matches_maybe", "filter_files",
           "is_partition_predicate", "split_partition_and_data_predicates"]


_EXACT = decimal.Context(prec=80)


def _exact_decimal(raw: str, dt: DecimalType) -> Optional[decimal.Decimal]:
    """``raw`` as an exact ``Decimal``, or NULL where it does not parse or
    its digits, cut toward zero to ``dt``'s scale, exceed its precision."""
    try:
        d = decimal.Decimal(raw.strip())
    except decimal.InvalidOperation:
        return None
    if not d.is_finite():
        return None
    unscaled = int(d.scaleb(dt.scale, context=_EXACT).to_integral_value(
        rounding=decimal.ROUND_DOWN, context=_EXACT))
    return d if abs(unscaled) < 10 ** dt.precision else None


def typed_partition_row(add: AddFile, partition_schema: StructType,
                        exact_decimals: bool = False) -> Dict[str, Any]:
    """Partition values cast from their string form to the column types.

    A decimal value is a float, as the predicate evaluator compares it;
    ``exact_decimals=True`` gives the exact ``Decimal`` instead, for the
    callers that materialize it as a column (a float keeps about 16
    digits)."""
    row: Dict[str, Any] = {}
    for f in partition_schema.fields:
        raw: Optional[str] = None
        for k, v in (add.partition_values or {}).items():
            if k.lower() == f.name.lower():
                raw = v
                break
        if raw is None or raw == "" or raw == "__HIVE_DEFAULT_PARTITION__":
            row[f.name] = None
        elif isinstance(f.data_type, StringType):
            row[f.name] = raw
        elif exact_decimals and isinstance(f.data_type, DecimalType):
            row[f.name] = _exact_decimal(raw, f.data_type)
        elif isinstance(f.data_type, (DateType, TimestampType)):
            # natural temporal objects (not the device epoch-int encoding):
            # '2024-05-01'-style literals coerce against them
            try:
                if isinstance(f.data_type, DateType):
                    row[f.name] = iso_to_date(raw)
                else:
                    row[f.name] = iso_to_naive_utc(raw)
            except ValueError:
                row[f.name] = None  # cast failure -> NULL (Spark semantics)
        else:
            row[f.name] = ir.cast_value(raw, f.data_type)
    return row


def eval_on_file(expr: ir.Expression, add: AddFile, partition_schema: StructType):
    return expr.eval(typed_partition_row(add, partition_schema))


def matches(expr: ir.Expression, add: AddFile, partition_schema: StructType) -> bool:
    """Spark filter semantics: NULL -> no match."""
    return eval_on_file(expr, add, partition_schema) is True


def matches_maybe(expr: ir.Expression, add: AddFile, partition_schema: StructType) -> bool:
    """Conservative: NULL -> possible match (the conflict checker's rule)."""
    return eval_on_file(expr, add, partition_schema) is not False


def filter_files(files: Iterable[AddFile], predicates: Sequence[ir.Expression],
                 metadata) -> List[AddFile]:
    """Files surviving the conjunction of partition predicates."""
    if not predicates:
        return list(files)
    pschema = metadata.partition_schema
    pred = ir.and_all(list(predicates))
    return [f for f in files if matches(pred, f, pschema)]


def is_partition_predicate(expr: ir.Expression, partition_columns: Sequence[str]) -> bool:
    """True iff every referenced column is a partition column. Reference-free
    predicates (e.g. TRUE) are partition predicates too."""
    pset = {c.lower() for c in partition_columns}
    return all(r.lower() in pset for r in ir.references(expr))


def split_partition_and_data_predicates(expr_or_str, partition_columns: Sequence[str]):
    """A predicate's conjuncts split into (partition-only, needs-data)."""
    expr = parse_expression(expr_or_str) if isinstance(expr_or_str, str) else expr_or_str
    partition_preds: List[ir.Expression] = []
    data_preds: List[ir.Expression] = []
    for conj in ir.split_conjuncts(expr):
        (partition_preds if is_partition_predicate(conj, partition_columns)
         else data_preds).append(conj)
    return partition_preds, data_preds

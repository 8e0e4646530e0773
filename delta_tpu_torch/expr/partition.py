"""Partition-predicate evaluation over AddFile.partitionValues (the port's
own copy of ``delta_tpu.expr.partition``).

Predicates are evaluated per file against the typed partition values.
Empty-string or missing values are NULL, cast failures are NULL, and a
predicate evaluating to NULL does not match the file (Spark filter
semantics).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

from delta_tpu_torch.expr import ir
from delta_tpu_torch.protocol.actions import AddFile
from delta_tpu_torch.schema.types import DateType, StringType, StructType, TimestampType
from delta_tpu_torch.utils.timeparse import iso_to_date, iso_to_naive_utc

__all__ = ["typed_partition_row", "eval_on_file", "matches", "is_partition_predicate"]


def typed_partition_row(add: AddFile, partition_schema: StructType) -> Dict[str, Any]:
    """Partition values cast from their string form to the column types."""
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


def is_partition_predicate(expr: ir.Expression, partition_columns: Sequence[str]) -> bool:
    """True iff every referenced column is a partition column. Reference-free
    predicates (e.g. TRUE) are partition predicates too."""
    pset = {c.lower() for c in partition_columns}
    return all(r.lower() in pset for r in ir.references(expr))

"""Constraints and invariants: row-level write enforcement, vectorized (the
port's own copy of ``delta_tpu.schema.constraints``).

The reference wraps the write plan in ``DeltaInvariantCheckerExec``
(``constraints/DeltaInvariantCheckerExec.scala:42-99``), a per-row check;
a violation raises ``InvariantViolationException``. Here each constraint is
one vectorized predicate over the whole batch (the port's
``expr/vectorized`` evaluator), so enforcement costs one pass per
constraint.

Sources (``constraints/Constraints.scala:39-84``, ``Invariants.scala``):
NOT NULL from non-nullable schema fields; CHECK constraints from the table
properties ``delta.constraints.<name>``; legacy invariants from the field
metadata key ``delta.invariants``.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import List

import numpy as np

from delta_tpu_torch.expr import ir
from delta_tpu_torch.expr.parser import parse_predicate
from delta_tpu_torch.expr.vectorized import HostTable, boolean_mask
from delta_tpu_torch.protocol.actions import Metadata
from delta_tpu_torch.utils import errors
from delta_tpu_torch.utils.errors import InvariantViolationError

__all__ = ["Constraint", "NotNull", "Check", "from_metadata", "enforce",
           "CONSTRAINT_PROP_PREFIX"]

CONSTRAINT_PROP_PREFIX = "delta.constraints."
INVARIANTS_META_KEY = "delta.invariants"


@dataclass(frozen=True)
class Constraint:
    name: str


@dataclass(frozen=True)
class NotNull(Constraint):
    column: str


@dataclass(frozen=True)
class Check(Constraint):
    expr: ir.Expression


def from_metadata(metadata: Metadata) -> List[Constraint]:
    """Every constraint the table carries (``Constraints.scala:56-81``)."""
    out: List[Constraint] = []
    for f in metadata.schema.fields:
        if not f.nullable:
            out.append(NotNull(name=f"NOT NULL {f.name}", column=f.name))
        inv = (f.metadata or {}).get(INVARIANTS_META_KEY)
        if inv:
            rule = json.loads(inv) if isinstance(inv, str) else inv
            expr_sql = rule.get("expression", {}).get("expression")
            if expr_sql:
                out.append(Check(name=f"INVARIANT {expr_sql}", expr=parse_predicate(expr_sql)))
    for k, v in sorted((metadata.configuration or {}).items()):
        if k.lower().startswith(CONSTRAINT_PROP_PREFIX):
            out.append(Check(name=k[len(CONSTRAINT_PROP_PREFIX):], expr=parse_predicate(v)))
    return out


def enforce(constraints: List[Constraint], table: HostTable) -> None:
    """Check every constraint against a write batch; raise on the first
    violation with a sample row, as ``InvariantViolationException`` does. A
    CHECK is violated where it is FALSE or NULL."""
    if table.num_rows == 0:
        return
    for c in constraints:
        if isinstance(c, NotNull):
            name = next((n for n in table.column_names if n.lower() == c.column.lower()), None)
            if name is None:
                raise InvariantViolationError(
                    f"Column {c.column} declared NOT NULL is missing from the data")
            nulls = int((~np.asarray(table.columns[name].valid, bool)).sum())
            if nulls:
                raise errors.not_null_invariant_violated(c.column, nulls)
        elif isinstance(c, Check):
            ok = boolean_mask(c.expr, table)
            if not ok.all():
                idx = int(np.argmin(ok))
                raise errors.check_constraint_violated(c.name, c.expr.sql(),
                                                       table.take([idx]).rows()[0])

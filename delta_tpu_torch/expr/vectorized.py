"""Columnar expression evaluation over a host stats table, in numpy (the
port's own copy of ``delta_tpu.expr.vectorized``, cut to what the host
prune, ``ops/pruning._prune_host``, reaches).

The JAX package builds its stats table with ``pyarrow.Table.from_pylist``
and evaluates with ``pyarrow.compute``, falling back to row-at-a-time
:meth:`Expression.eval` for what Arrow lacks. This module keeps that
structure with numpy in Arrow's place, and takes Arrow's semantics where
they differ from the row evaluator's:

* the table's column types are inferred the way ``from_pylist`` infers
  them, value by value: the first non-null value sets the type, an int
  column widens to double on a float, a date column truncates datetimes,
  and any other mix, or an int outside int64, raises
  :class:`StatsTypeError` (``from_pylist`` raises there too);
* int64 arithmetic wraps; int64 against double compares as double;
  a string against a number casts the string to double, against a date or
  timestamp to that type; ``x / 0`` is NULL and int / int divides in
  double;
* a node whose operand types Arrow has no kernel for (or whose cast
  fails) falls back to the row evaluator for that node, as the JAX
  package's visitor does; every node's children are evaluated, so an
  error anywhere in the tree surfaces.

NULL is the validity mask; AND/OR are Kleene.
"""
from __future__ import annotations

import datetime as _dt
import math
import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from delta_tpu_torch.expr import ir
from delta_tpu_torch.schema.types import (
    DateType, DoubleType, FloatType, LongType, StringType,
)
from delta_tpu_torch.utils import errors

__all__ = ["HostColumn", "HostTable", "StatsTypeError", "table_from_rows",
           "evaluate", "to_keep_mask"]

_EPOCH_DAY = _dt.date(1970, 1, 1)
_EPOCH_TS = _dt.datetime(1970, 1, 1)
_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1


class StatsTypeError(errors.DeltaAnalysisError, TypeError):
    """A stats table column mixes values no single column type holds."""


class _NoKernel(Exception):
    """Arrow would refuse this node (no kernel for the operand types, or a
    cast that fails): the visitor falls back to the row evaluator."""


@dataclass
class HostColumn:
    """One column: ``kind`` is null | bool | int | double | str | date |
    ts | object; ``values`` numpy (int64 days for date, int64 µs for ts,
    object for str/object); ``valid`` True = non-NULL."""

    kind: str
    values: np.ndarray
    valid: np.ndarray


@dataclass
class _Scalar:
    kind: str
    value: Any  # numpy-compatible value for the kind
    valid: bool


# -- building the table -----------------------------------------------------


def _value_kind(v: Any) -> str:
    if isinstance(v, bool):
        return "bool"
    if isinstance(v, int):
        return "int"
    if isinstance(v, float):
        return "double"
    if isinstance(v, str):
        return "str"
    if isinstance(v, _dt.datetime):
        return "ts"
    if isinstance(v, _dt.date):
        return "date"
    return "object"


def _infer_kind(values: Sequence[Any]) -> str:
    """The column type ``from_pylist`` infers, scanning in order: the first
    non-null value sets it, int -> double on a float and date + datetime
    stay compatible; inference stops at the first other mix (the
    conversion then refuses the value)."""
    kind = "null"
    for v in values:
        if v is None:
            continue
        k = _value_kind(v)
        if kind == "null":
            kind = k
        elif kind == "int" and k == "double":
            kind = "double"
        elif (kind, k) in (("double", "int"), ("date", "ts")) or k == kind:
            continue
        else:
            break
    return kind


def _convert(name: str, kind: str, values: Sequence[Any]) -> HostColumn:
    n = len(values)
    valid = np.fromiter((v is not None for v in values), bool, n)

    def bad(v):
        return StatsTypeError(
            f"stats column {name!r}: cannot convert {v!r} to the column's type {kind}")

    if kind == "null":
        return HostColumn("null", np.zeros(n, np.int64), valid)
    if kind == "object":
        out = np.empty(n, object)
        for i, v in enumerate(values):
            if v is not None and _value_kind(v) != "object":
                raise bad(v)
            out[i] = v
        return HostColumn("object", out, valid)
    if kind == "str":
        out = np.empty(n, object)
        for i, v in enumerate(values):
            if v is not None and not isinstance(v, str):
                raise bad(v)
            out[i] = v
        return HostColumn("str", out, valid)
    if kind == "bool":
        out = np.zeros(n, bool)
        for i, v in enumerate(values):
            if v is not None:
                if not isinstance(v, bool):
                    raise bad(v)
                out[i] = v
        return HostColumn("bool", out, valid)
    if kind in ("int", "double"):
        out = np.zeros(n, np.int64 if kind == "int" else np.float64)
        for i, v in enumerate(values):
            if v is None:
                continue
            if isinstance(v, bool):
                if kind == "int":
                    raise bad(v)
                out[i] = float(v)
            elif isinstance(v, int):
                if not _I64_MIN <= v <= _I64_MAX:
                    raise StatsTypeError(f"stats column {name!r}: {v} does not fit int64")
                out[i] = v
            elif isinstance(v, float) and kind == "double":
                out[i] = v
            else:
                raise bad(v)
        return HostColumn(kind, out, valid)
    # date / ts
    out = np.zeros(n, np.int64)
    for i, v in enumerate(values):
        if v is None:
            continue
        if isinstance(v, bool):
            raise bad(v)
        if isinstance(v, int):
            out[i] = v
        elif kind == "date" and isinstance(v, _dt.date):
            d = v.date() if isinstance(v, _dt.datetime) else v
            out[i] = (d - _EPOCH_DAY).days
        elif kind == "ts" and isinstance(v, _dt.datetime):
            out[i] = _ts_micros(v)
        else:
            raise bad(v)
    return HostColumn(kind, out, valid)


def _ts_micros(v: _dt.datetime) -> int:
    if v.tzinfo is not None:
        v = v.astimezone(_dt.timezone.utc).replace(tzinfo=None)
    return (v - _EPOCH_TS) // _dt.timedelta(microseconds=1)


class HostTable:
    """Named columns of equal length, in first-seen column order."""

    def __init__(self, columns: Dict[str, HostColumn], num_rows: int):
        self.columns = columns
        self.num_rows = num_rows
        self._rows: Optional[List[Dict[str, Any]]] = None

    @property
    def column_names(self) -> List[str]:
        return list(self.columns)

    def column(self, name: str) -> HostColumn:
        if name in self.columns:
            return self.columns[name]
        lowered = name.lower()
        for c, col in self.columns.items():
            if c.lower() == lowered:
                return col
        raise errors.column_not_found_in_table(name, self.column_names)

    def rows(self) -> List[Dict[str, Any]]:
        """The table as Python rows, typed as the columns hold them."""
        if self._rows is None:
            cols = {k: _to_python(c) for k, c in self.columns.items()}
            self._rows = [{k: cols[k][i] for k in cols} for i in range(self.num_rows)]
        return self._rows


def table_from_rows(rows: Sequence[Dict[str, Any]]) -> HostTable:
    """A table from Python rows, typed as ``pyarrow.Table.from_pylist``
    types them (raises :class:`StatsTypeError` where it raises); a key
    missing from a row is NULL there."""
    names: Dict[str, None] = {}
    for r in rows:
        for k in r:
            names.setdefault(k, None)
    cols = {}
    for k in names:
        vals = [r.get(k) for r in rows]
        cols[k] = _convert(k, _infer_kind(vals), vals)
    return HostTable(cols, len(rows))


def _to_python(c: HostColumn) -> List[Any]:
    out: List[Any] = []
    for v, ok in zip(c.values.tolist(), c.valid.tolist()):
        if not ok:
            out.append(None)
        elif c.kind == "date":
            out.append(_EPOCH_DAY + _dt.timedelta(days=v))
        elif c.kind == "ts":
            out.append(_EPOCH_TS + _dt.timedelta(microseconds=v))
        else:
            out.append(v)
    return out


# -- value helpers ----------------------------------------------------------


def _lit(value: Any) -> _Scalar:
    if value is None:
        return _Scalar("null", 0, False)
    k = _value_kind(value)
    if k == "int" and not _I64_MIN <= value <= _I64_MAX:
        raise _NoKernel  # no int64 scalar: the row evaluator takes the node
    if k == "date":
        return _Scalar("date", (value - _EPOCH_DAY).days, True)
    if k == "ts":
        return _Scalar("ts", _ts_micros(value), True)
    return _Scalar(k, value, True)


def _arr(v, n: int) -> HostColumn:
    if isinstance(v, HostColumn):
        return v
    dtype = {"bool": bool, "int": np.int64, "double": np.float64, "date": np.int64,
             "ts": np.int64, "null": np.int64}.get(v.kind, object)
    vals = np.empty(n, dtype) if dtype is object else np.zeros(n, dtype)
    if v.valid:
        vals[:] = v.value
    return HostColumn(v.kind, vals, np.full(n, bool(v.valid)))


def _nulls(n: int, kind: str = "null") -> HostColumn:
    dtype = {"bool": bool, "double": np.float64, "str": object, "object": object}.get(kind, np.int64)
    return HostColumn(kind, np.zeros(n, dtype) if dtype is not object else np.empty(n, object),
                      np.zeros(n, bool))


def _parts(v, n: int):
    c = _arr(v, n)
    return c.values, c.valid


def _is_num(k: str) -> bool:
    return k in ("int", "double")


def _unify_numeric(l, r, n: int):
    """Arrow's implicit cast for numeric kernels: null takes the other side's
    type, int64 with double computes in double."""
    lk, rk = l.kind, r.kind
    if lk == "null" and rk == "null":
        return None
    if lk == "null" or rk == "null":
        k = rk if lk == "null" else lk
        if not (_is_num(k) or k in ("bool", "str", "date", "ts")):
            raise _NoKernel
        return k
    if _is_num(lk) and _is_num(rk):
        return "double" if "double" in (lk, rk) else "int"
    if lk == rk and lk in ("bool", "str", "date", "ts"):
        return lk
    raise _NoKernel


def _as(v, kind: str, n: int):
    """Values of ``v`` in ``kind`` (only the numeric widening and null)."""
    vals, valid = _parts(v, n)
    if v.kind == "null":
        vals = _nulls(n, kind).values
    elif kind == "double" and v.kind == "int":
        vals = vals.astype(np.float64)
    return vals, valid


def _str_to_double(v, n: int):
    """Arrow's string -> double cast (raises where any valid value does
    not parse)."""
    vals, valid = _parts(v, n)
    out = np.zeros(n, np.float64)
    for i in np.nonzero(valid)[0]:
        s = vals[i]
        if not re.fullmatch(r"\s*[+-]?(\d+\.?\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?|"
                            r"(?i:inf|infinity|nan))\s*", s):
            raise _NoKernel
        out[i] = float(s)
    return HostColumn("double", out, valid.copy())


def _str_to_temporal(v, kind: str, n: int):
    """Arrow's string -> date32 / timestamp[us] cast (strict ISO)."""
    vals, valid = _parts(v, n)
    out = np.zeros(n, np.int64)
    for i in np.nonzero(valid)[0]:
        s = vals[i]
        try:
            if kind == "date":
                if not re.fullmatch(r"\d{4}-\d{2}-\d{2}", s):
                    raise ValueError(s)
                out[i] = (_dt.date.fromisoformat(s) - _EPOCH_DAY).days
            else:
                if not re.fullmatch(r"\d{4}-\d{2}-\d{2}([T ]\d{2}(:\d{2}(:\d{2}(\.\d{1,9})?)?)?)?"
                                    r"(Z|[+-]\d{2}:?\d{2})?", s):
                    raise ValueError(s)
                out[i] = _ts_micros(_dt.datetime.fromisoformat(
                    s.replace(" ", "T").replace("Z", "+00:00")))
        except ValueError:
            raise _NoKernel from None
    return HostColumn(kind, out, valid.copy())


def _numeric_coerce(l, r, n: int):
    """Arrow's kernels refuse string-vs-number and string-vs-temporal; the
    string side casts (Spark's implicit cast)."""
    if l.kind == "str" and _is_num(r.kind):
        return _str_to_double(l, n), HostColumn("double", *_as(r, "double", n))
    if r.kind == "str" and _is_num(l.kind):
        return HostColumn("double", *_as(l, "double", n)), _str_to_double(r, n)
    if l.kind == "str" and r.kind in ("date", "ts"):
        return _str_to_temporal(l, r.kind, n), r
    if r.kind == "str" and l.kind in ("date", "ts"):
        return l, _str_to_temporal(r, l.kind, n)
    return l, r


def _str_cmp(op, a: np.ndarray, b: np.ndarray, valid: np.ndarray) -> np.ndarray:
    out = np.zeros(len(valid), bool)
    for i in np.nonzero(valid)[0]:
        out[i] = op(a[i].encode("utf-8"), b[i].encode("utf-8"))
    return out


_OPS = {
    ir.Eq: np.equal, ir.Ne: np.not_equal, ir.Lt: np.less, ir.Le: np.less_equal,
    ir.Gt: np.greater, ir.Ge: np.greater_equal,
}
_PYOPS = {
    ir.Eq: lambda a, b: a == b, ir.Ne: lambda a, b: a != b, ir.Lt: lambda a, b: a < b,
    ir.Le: lambda a, b: a <= b, ir.Gt: lambda a, b: a > b, ir.Ge: lambda a, b: a >= b,
}


def _compare(cls, l, r, n: int) -> HostColumn:
    l, r = _numeric_coerce(l, r, n)
    kind = _unify_numeric(l, r, n)
    if kind is None:
        return _nulls(n, "bool")
    lv, lok = _as(l, kind, n)
    rv, rok = _as(r, kind, n)
    valid = lok & rok
    if kind == "str":
        return HostColumn("bool", _str_cmp(_PYOPS[cls], lv, rv, valid), valid)
    with np.errstate(invalid="ignore"):
        out = _OPS[cls](lv, rv)
    return HostColumn("bool", np.asarray(out, bool) & valid, valid)


def _arith(cls, l, r, n: int) -> HostColumn:
    l, r = _numeric_coerce(l, r, n)
    kind = _unify_numeric(l, r, n)
    if kind is None:
        return _nulls(n)
    if not _is_num(kind):
        raise _NoKernel
    lv, lok = _as(l, kind, n)
    rv, rok = _as(r, kind, n)
    with np.errstate(all="ignore"):
        out = {ir.Add: np.add, ir.Sub: np.subtract, ir.Mul: np.multiply}[cls](lv, rv)
    return HostColumn(kind, out, lok & rok)


def _kleene(cls, l, r, n: int) -> HostColumn:
    for x in (l, r):
        if x.kind not in ("bool", "null"):
            raise _NoKernel
    lv, lok = _parts(l, n)
    rv, rok = _parts(r, n)
    lv, rv = lv.astype(bool) & lok, rv.astype(bool) & rok
    lf, rf = ~lv & lok, ~rv & rok
    if cls is ir.And:
        value = lv & rv
        valid = value | lf | rf
    else:
        value = lv | rv
        valid = (lok & rok) | value
    return HostColumn("bool", value, valid)


# -- the visitor ------------------------------------------------------------


class _Vectorizer:
    def __init__(self, table: HostTable):
        self.table = table
        self.n = table.num_rows

    def _fallback(self, e: ir.Expression) -> HostColumn:
        """Exact-semantics fallback: row-at-a-time eval, typed as
        ``pyarrow.array`` types the results."""
        vals = [e.eval(r) for r in self.table.rows()]
        return _convert("<row fallback>", _infer_kind(vals), vals)

    def visit(self, e: ir.Expression):
        m = getattr(self, "_v_" + type(e).__name__, None)
        if m is None:
            return self._fallback(e)
        try:
            return m(e)
        except _NoKernel:
            return self._fallback(e)

    def _v_Column(self, e):
        return self.table.column(e.name)

    def _v_Literal(self, e):
        return _lit(e.value)

    def _v_Alias(self, e):
        return self.visit(e.child)

    def _v_And(self, e):
        return _kleene(ir.And, self.visit(e.left), self.visit(e.right), self.n)

    def _v_Or(self, e):
        return _kleene(ir.Or, self.visit(e.left), self.visit(e.right), self.n)

    def _v_Not(self, e):
        c = self.visit(e.child)
        if c.kind not in ("bool", "null"):
            raise _NoKernel
        v, ok = _parts(c, self.n)
        return HostColumn("bool", ~v.astype(bool) & ok, ok)

    def _cmp(self, e):
        return _compare(type(e), self.visit(e.left), self.visit(e.right), self.n)

    _v_Eq = _v_Ne = _v_Lt = _v_Le = _v_Gt = _v_Ge = _cmp

    def _v_NullSafeEq(self, e):
        l, r = self.visit(e.left), self.visit(e.right)
        eq = _compare(ir.Eq, l, r, self.n)
        lok, rok = _parts(l, self.n)[1], _parts(r, self.n)[1]
        both_null = ~lok & ~rok
        return HostColumn("bool", np.where(eq.valid, eq.values, both_null), np.ones(self.n, bool))

    def _v_In(self, e):
        v = _arr(self.visit(e.value), self.n)
        if not all(isinstance(o, ir.Literal) for o in e.options):
            return self._fallback(e)
        opts = [o.value for o in e.options]
        vals = [o for o in opts if o is not None]
        if v.kind in ("int", "double"):
            for o in vals:  # the option array takes the column's type
                if isinstance(o, bool) or not isinstance(o, (int, float)):
                    raise _NoKernel
                if v.kind == "int" and (isinstance(o, float) and not o.is_integer()
                                        or not _I64_MIN <= o <= _I64_MAX):
                    raise _NoKernel
            found = np.isin(v.values, np.array(vals, v.values.dtype)) if vals else \
                np.zeros(self.n, bool)
            if v.kind == "double" and any(isinstance(o, float) and math.isnan(o) for o in vals):
                found |= np.isnan(v.values)  # Arrow's set lookup matches NaN
        elif v.kind in ("str", "bool"):
            want = str if v.kind == "str" else bool
            if any(not isinstance(o, want) for o in vals):
                raise _NoKernel
            s = set(vals)
            found = np.fromiter((x in s for x in v.values.tolist()), bool, self.n)
        elif v.kind == "null":
            return _nulls(self.n, "bool")
        else:
            raise _NoKernel
        found = found & v.valid
        valid = v.valid.copy()
        if any(o is None for o in opts):
            valid &= found  # SQL IN: not found with a NULL option is NULL
        return HostColumn("bool", found, valid)

    def _v_IsNull(self, e):
        c = _arr(self.visit(e.child), self.n)
        return HostColumn("bool", ~c.valid, np.ones(self.n, bool))

    def _v_IsNotNull(self, e):
        c = _arr(self.visit(e.child), self.n)
        return HostColumn("bool", c.valid.copy(), np.ones(self.n, bool))

    def _ar(self, e):
        return _arith(type(e), self.visit(e.left), self.visit(e.right), self.n)

    _v_Add = _v_Sub = _v_Mul = _ar

    def _v_Div(self, e):
        l = self.visit(e.left)
        r = _arr(self.visit(e.right), self.n)
        if r.kind not in ("int", "double", "null") or l.kind not in ("int", "double", "null"):
            raise _NoKernel
        rv, rok = _as(r, "double" if r.kind == "double" else "int", self.n)
        rok = rok & (rv != 0)
        lv, lok = _as(l, "double" if l.kind == "double" else "int", self.n)
        if l.kind == "null" or r.kind == "null":
            return _nulls(self.n, "double")
        with np.errstate(all="ignore"):
            out = lv.astype(np.float64) / np.where(rok, rv, 1).astype(np.float64)
        return HostColumn("double", out, lok & rok)

    def _v_Neg(self, e):
        c = self.visit(e.child)
        if c.kind == "null":
            return _nulls(self.n)
        if not _is_num(c.kind):
            raise _NoKernel
        v, ok = _parts(c, self.n)
        with np.errstate(all="ignore"):
            return HostColumn(c.kind, -v, ok)

    def _v_Cast(self, e):
        c = self.visit(e.child)
        dt = e.data_type
        v, ok = _parts(c, self.n)
        if c.kind == "null":
            return _nulls(self.n)
        if isinstance(dt, (DoubleType, FloatType)) and _is_num(c.kind):
            out = v.astype(np.float64)
            if isinstance(dt, FloatType):
                out = out.astype(np.float32).astype(np.float64)
            return HostColumn("double", out, ok)
        if isinstance(dt, LongType) and c.kind == "int":
            return c
        if isinstance(dt, DateType) and c.kind == "date":
            return c
        if isinstance(dt, DateType) and c.kind == "str":
            return _str_to_temporal(c, "date", self.n)
        if isinstance(dt, DateType) and c.kind == "ts":
            return HostColumn("date", np.floor_divide(v, 86_400_000_000), ok)
        if isinstance(dt, StringType) and c.kind == "str":
            return c
        raise _NoKernel  # the other casts keep the exact row semantics

    def _v_Like(self, e):
        if not isinstance(e.right, ir.Literal):
            return self._fallback(e)
        c = self.visit(e.left)
        p = e.right.value
        if c.kind != "str" or not isinstance(p, str) or "\\" in p:
            raise _NoKernel
        rx = re.compile("".join(".*" if ch == "%" else "." if ch == "_" else re.escape(ch)
                                for ch in p), re.DOTALL)
        return self._str_map(c, lambda s: rx.fullmatch(s) is not None, "bool")

    def _v_StartsWith(self, e):
        if not isinstance(e.right, ir.Literal):
            return self._fallback(e)
        c = self.visit(e.left)
        p = e.right.value
        if c.kind != "str" or not isinstance(p, str):
            raise _NoKernel
        return self._str_map(c, lambda s: s.startswith(p), "bool")

    def _str_map(self, c, fn, kind):
        v, ok = _parts(c, self.n)
        dtype = bool if kind == "bool" else object
        out = np.zeros(self.n, dtype) if dtype is bool else np.empty(self.n, object)
        for i in np.nonzero(ok)[0]:
            out[i] = fn(v[i])
        return HostColumn(kind, out, ok.copy())

    def _v_Coalesce(self, e):
        cols = [self.visit(c) for c in e.children]
        kinds = {c.kind for c in cols} - {"null"}
        if not kinds:
            return _nulls(self.n)
        if kinds <= {"int", "double"}:
            kind = "double" if "double" in kinds else "int"
        elif len(kinds) == 1 and next(iter(kinds)) in ("bool", "str", "date", "ts"):
            kind = next(iter(kinds))
        else:
            raise _NoKernel
        out, valid = _nulls(self.n, kind).values, np.zeros(self.n, bool)
        for c in cols:
            v, ok = _as(c, kind, self.n) if c.kind != kind else _parts(c, self.n)
            take = ok & ~valid
            out = np.where(take, v, out)
            valid |= ok
        return HostColumn(kind, out, valid)

    def _v_CaseWhen(self, e):
        result = self.visit(e.children[-1])
        parts = []
        for i in range(e.n_branches):
            cond = self.visit(e.children[2 * i])
            if cond.kind not in ("bool", "null"):
                raise _NoKernel
            parts.append((cond, self.visit(e.children[2 * i + 1])))
        kinds = {x.kind for x in [result] + [p[1] for p in parts]} - {"null"}
        if not kinds:
            return _nulls(self.n)
        if kinds <= {"int", "double"}:
            kind = "double" if "double" in kinds else "int"
        elif len(kinds) == 1 and next(iter(kinds)) in ("bool", "str", "date", "ts"):
            kind = next(iter(kinds))
        else:
            raise _NoKernel
        out, valid = _as(result, kind, self.n) if result.kind != kind else _parts(result, self.n)
        for cond, val in reversed(parts):
            cv, cok = _parts(cond, self.n)
            fire = cv.astype(bool) & cok
            vv, vok = _as(val, kind, self.n) if val.kind != kind else _parts(val, self.n)
            out = np.where(fire, vv, out)
            valid = np.where(fire, vok, valid)
        return HostColumn(kind, out, valid)

    def _v_Func(self, e):
        name = e.name
        if name in ("substring", "substr") and all(
                isinstance(a, ir.Literal) and isinstance(a.value, int)
                and not isinstance(a.value, bool) for a in e.children[1:]) \
                and len(e.children) > 1 and int(e.children[1].value) >= 0:
            c = self.visit(e.children[0])
            if c.kind != "str":
                raise _NoKernel
            start = max(int(e.children[1].value) - 1, 0)
            if len(e.children) > 2:
                stop = start + max(int(e.children[2].value), 0)
                return self._str_map(c, lambda s: s[start:stop], "str")
            return self._str_map(c, lambda s: s[start:], "str")
        if name in ("year", "month", "day") and len(e.children) == 1:
            c = self.visit(e.children[0])
            if c.kind not in ("date", "ts"):
                raise _NoKernel
            v, ok = _parts(c, self.n)
            days = v if c.kind == "date" else np.floor_divide(v, 86_400_000_000)
            field = _civil(days)[("year", "month", "day").index(name)]
            return HostColumn("int", field, ok)
        if name == "to_date" and len(e.children) == 1:
            c = self.visit(e.children[0])
            if c.kind != "str":
                return self._fallback(e)
            v, ok = _parts(c, self.n)
            sliced = HostColumn("str", np.array([s[:10] if o else None
                                                 for s, o in zip(v, ok)], object), ok)
            return _str_to_temporal(sliced, "date", self.n)
        if name in ("abs", "floor", "ceil") and len(e.children) == 1:
            c = self.visit(e.children[0])
            if c.kind == "null":
                return _nulls(self.n)
            if not _is_num(c.kind):
                raise _NoKernel
            v, ok = _parts(c, self.n)
            if name == "abs":
                with np.errstate(all="ignore"):
                    return HostColumn(c.kind, np.abs(v), ok)
            fn = np.floor if name == "floor" else np.ceil
            return HostColumn("double", fn(v.astype(np.float64)), ok)
        return self._fallback(e)  # the exact row semantics


def _civil(days: np.ndarray):
    """(year, month, day) of epoch days (civil-from-days, Hinnant)."""
    z = days.astype(np.int64) + 719468
    era = np.floor_divide(z, 146097)
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    day = doy - (153 * mp + 2) // 5 + 1
    month = np.where(mp < 10, mp + 3, mp - 9)
    year = yoe + era * 400 + (month <= 2)
    return year, month, day


def evaluate(expr: ir.Expression, table: HostTable) -> HostColumn:
    """Evaluate ``expr`` over every row of ``table``; result aligned by row."""
    return _arr(_Vectorizer(table).visit(expr), table.num_rows)


def to_keep_mask(verdict: HostColumn) -> np.ndarray:
    """A skipping verdict as the file keep mask: cast to bool (numbers are
    true when non-zero), NULL keeps. Raises where the cast would."""
    v, ok = verdict.values, verdict.valid
    if verdict.kind == "bool":
        b = v.astype(bool)
    elif verdict.kind in ("int", "double"):
        b = v != 0
    elif verdict.kind == "null":
        b = np.zeros(len(ok), bool)
    elif verdict.kind == "str":
        b = np.zeros(len(ok), bool)
        for i in np.nonzero(ok)[0]:
            s = v[i].strip().lower()
            if s in ("true", "1"):
                b[i] = True
            elif s not in ("false", "0"):
                raise StatsTypeError(f"cannot cast {v[i]!r} to bool")
    else:
        raise StatsTypeError(f"cannot cast a {verdict.kind} verdict to bool")
    return b | ~ok

"""Columnar expression evaluation over a host table, in numpy (the port's
own copy of ``delta_tpu.expr.vectorized``, cut to what the host prune,
``ops/pruning._prune_host``, and the MERGE command reach).

``HostTable`` also carries the table operations the JAX package's MERGE
and writer take from ``pyarrow`` (take, filter, slice, select, append,
rename, concat) and :func:`cast_column`, the unsafe cast to a schema's
declared type (``pc.cast(..., safe=False)``: integers wrap, doubles
truncate toward zero).

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
  error anywhere in the tree surfaces;
* a decimal is its unscaled integers (int64 up to 18 digits, Python ints
  beyond), computed exactly with Arrow's rules: an integer operand is a
  ``decimal(19, 0)`` (int32 ``(10, 0)``, int16 ``(5, 0)``, int8 ``(3,
  0)``), ``+``/``-`` give ``(max(p1 - s1, p2 - s2) + max(s1, s2) + 1,
  max(s1, s2))``, ``*`` ``(p1 + p2 + 1, s1 + s2)``, ``/`` the scale
  ``max(4, s1 + p2 - s2 + 1)`` (truncated; a decimal divisor of fewer
  than 19 integer digits takes the row evaluator, as the JAX package's
  visitor does), a precision past 38 has no kernel (the row evaluator
  takes the node); against a double, a decimal
  is a double; a cast to fewer fractional digits truncates toward zero and
  keeps a value past the precision (the unsafe cast), a double casts at
  its shortest decimal form, rounding half up (Spark's cast; Arrow's
  rounds the binary value half to even), and ``round`` of a decimal rounds
  half up (Spark's ``round``, where Arrow's is half to even);
* a nested column (struct, list, map) is carried, compared by nothing:
  only ``IS [NOT] NULL`` and the table operations read it.

NULL is the validity mask; AND/OR are Kleene.
"""
from __future__ import annotations

import datetime as _dt
import decimal as _decimal
import math
import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from delta_tpu_torch.expr import ir
from delta_tpu_torch.expr import nested as nested_mod
from delta_tpu_torch.expr.nested import decimal_ps, decimal_type, to_decimal
from delta_tpu_torch.schema.types import (
    ByteType, DateType, DecimalType, DoubleType, FloatType, IntegerType, LongType, ShortType,
    StringType,
)
from delta_tpu_torch.utils import errors

__all__ = ["HostColumn", "HostTable", "StatsTypeError", "table_from_rows",
           "evaluate", "to_keep_mask", "boolean_mask", "filter_table", "concat_tables",
           "column_from_values", "cast_column", "null_column", "DEFAULT_TYPE", "stored_type",
           "CastError", "where_column"]

_EPOCH_DAY = _dt.date(1970, 1, 1)
_EPOCH_TS = _dt.datetime(1970, 1, 1)
_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1
_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1


class StatsTypeError(errors.DeltaAnalysisError, TypeError):
    """A stats table column mixes values no single column type holds."""


class CastError(NotImplementedError, ValueError):
    """A cast Arrow refuses (its ``ArrowInvalid``, a ``ValueError``): an
    integer into a decimal too narrow for the integer type, between nested
    types. A ``NotImplementedError`` too, so the callers that turn a cast
    the port lacks into their own error treat it alike."""


# the (kind, stored type) of a cast out of a decimal that ``cast_column`` makes
_CASTS_OUT_OF_DECIMAL = {
    DoubleType: ("double", None), FloatType: ("double", "float32"), LongType: ("int", None),
    IntegerType: ("int", "int32"), ShortType: ("int", "int16"), ByteType: ("int", "int8"),
    StringType: ("str", None)}


class _NoKernel(Exception):
    """Arrow would refuse this node (no kernel for the operand types, or a
    cast that fails): the visitor falls back to the row evaluator."""


@dataclass
class HostColumn:
    """One column: ``kind`` is null | bool | int | double | str | date |
    ts | object | decimal | nested; ``values`` numpy (int64 days for date,
    int64 µs for ts, object for str/object, the unscaled integers for a
    decimal: int64 up to 18 digits, Python ints beyond) or, for a nested
    column, an ``expr/nested.NCol``; ``valid`` True = non-NULL. ``type`` is
    the stored column type where it is narrower than the kind says
    (``int8``, ``int16``, ``int32``, ``float32``, ``binary``,
    ``timestamp[us, tz=UTC]``: see ``exec/parquet``); None takes the kind's
    widest type. A decimal's type is always given (``decimal128(7, 2)``), a
    nested column's is its spec (``("list", "int64")``)."""

    kind: str
    values: np.ndarray
    valid: np.ndarray
    type: Optional[str] = None


#: each kind's widest stored type: an untagged column's type
DEFAULT_TYPE = {"bool": "bool", "int": "int64", "double": "float64", "str": "string",
                "object": "binary", "date": "date32", "ts": "timestamp[us]"}


def stored_type(col: HostColumn) -> str:
    """A column's stored type, its kind's widest where untagged."""
    return col.type if col.type is not None else DEFAULT_TYPE.get(col.kind, col.kind)


@dataclass
class _Scalar:
    kind: str
    value: Any  # numpy-compatible value for the kind
    valid: bool
    type: Optional[str] = None


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
    if isinstance(v, _decimal.Decimal):
        return "decimal"
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
        elif kind == "int" and k in ("double", "decimal"):
            kind = k
        elif (kind, k) in (("double", "int"), ("date", "ts"), ("decimal", "int")) or k == kind:
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
    if kind == "decimal":
        return _decimal_column(name, values, valid)
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


def _decimal_column(name: str, values: Sequence[Any], valid: np.ndarray) -> HostColumn:
    """Python ``Decimal``s (and ints) as ``pyarrow.array`` types them: the
    largest scale of any value, and the most integer digits of any value
    added to it."""
    scale, int_digits = 0, 1
    for v in values:
        if v is None:
            continue
        if isinstance(v, bool) or not isinstance(v, (int, _decimal.Decimal)):
            raise StatsTypeError(f"stats column {name!r}: cannot convert {v!r} to a decimal")
        if isinstance(v, int):
            int_digits = max(int_digits, len(str(abs(v))))
            continue
        if not v.is_finite():
            raise StatsTypeError(f"stats column {name!r}: {v} is not a finite decimal")
        t = v.as_tuple()
        digits, exp = len(t.digits), t.exponent
        p, sc = (digits + exp, 0) if exp >= 0 else (max(digits, -exp), -exp)
        scale = max(scale, sc)
        int_digits = max(int_digits, p - sc)
    precision = int_digits + scale
    if precision > 76:
        raise StatsTypeError(f"stats column {name!r}: a decimal of {precision} digits")
    spec = decimal_type(precision, scale)
    return HostColumn("decimal", nested_mod.ncol_from_py(spec, values).values, valid, spec)


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

    def to_pylist(self) -> List[Dict[str, Any]]:
        return [dict(r) for r in self.rows()]

    def take(self, idx) -> "HostTable":
        idx = np.asarray(idx, np.int64)
        return HostTable({k: HostColumn(c.kind, c.values[idx], c.valid[idx], c.type)
                          for k, c in self.columns.items()}, len(idx))

    def filter(self, mask) -> "HostTable":
        return self.take(np.flatnonzero(np.asarray(mask, bool)))

    def slice(self, start: int, length: Optional[int] = None) -> "HostTable":
        stop = self.num_rows if length is None else min(start + length, self.num_rows)
        return HostTable({k: HostColumn(c.kind, c.values[start:stop], c.valid[start:stop], c.type)
                          for k, c in self.columns.items()}, max(stop - start, 0))

    def select(self, names: Sequence[str]) -> "HostTable":
        return HostTable({n: self.columns[n] for n in names}, self.num_rows)

    def append_column(self, name: str, col: HostColumn) -> "HostTable":
        if len(col.valid) != self.num_rows:
            raise ValueError(f"column {name!r} has {len(col.valid)} rows, the table "
                             f"{self.num_rows}")
        cols = dict(self.columns)
        cols[name] = col
        return HostTable(cols, self.num_rows)

    def rename_columns(self, names: Sequence[str]) -> "HostTable":
        return HostTable(dict(zip(names, self.columns.values())), self.num_rows)


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
    if c.kind == "nested":
        return c.values.to_py(typed=True)
    if c.kind == "decimal":
        scale = decimal_ps(c.type)[1]
        return [to_decimal(v, scale) if ok else None
                for v, ok in zip(c.values.tolist(), c.valid.tolist())]
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
    if k == "decimal":
        col = _decimal_column("<literal>", [value], np.ones(1, bool))
        return _Scalar("decimal", col.values[0], True, col.type)
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
    if v.kind == "decimal" and decimal_ps(v.type)[0] <= 18:
        dtype = np.int64
    vals = np.empty(n, dtype) if dtype is object else np.zeros(n, dtype)
    if v.valid:
        vals[:] = v.value
    return HostColumn(v.kind, vals, np.full(n, bool(v.valid)), v.type)


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
    type, int64 with double computes in double, and a date with a timestamp
    computes as a timestamp (the date at midnight)."""
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
    if {lk, rk} == {"date", "ts"}:
        return "ts"
    raise _NoKernel


#: microseconds a day: a date lane (epoch days) widened to a timestamp's
_US_PER_DAY = 86_400_000_000


def _as(v, kind: str, n: int):
    """Values of ``v`` in ``kind`` (only the numeric widening, a date as a
    timestamp, and null)."""
    vals, valid = _parts(v, n)
    if v.kind == "null":
        vals = _nulls(n, kind).values
    elif kind == "double" and v.kind == "int":
        vals = vals.astype(np.float64)
    elif kind == "ts" and v.kind == "date":
        vals = vals.astype(np.int64) * _US_PER_DAY
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


def _str_cmp(cls, a: np.ndarray, b: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Strings compare as their UTF-8 bytes (Arrow's order), which is
    code-point order, Python's own str order: one pass over the valid
    rows."""
    out = np.zeros(len(valid), bool)
    idx = np.nonzero(valid)[0]
    if len(idx):
        out[idx] = np.asarray(_OPS[cls](a[idx], b[idx]), bool)
    return out


_OPS = {
    ir.Eq: np.equal, ir.Ne: np.not_equal, ir.Lt: np.less, ir.Le: np.less_equal,
    ir.Gt: np.greater, ir.Ge: np.greater_equal,
}


# -- decimals ---------------------------------------------------------------

#: (precision, 0) of an integer type cast to a decimal (Arrow's rule)
_INT_DECIMAL = {"int8": 3, "int16": 5, "int32": 10, "int64": 19, None: 19}
_POW10 = [10 ** k for k in range(80)]


def _decimal_operand(v, n: int):
    """(unscaled values, valid, precision, scale) of a decimal or integer
    operand; None for any other kind."""
    if v.kind == "decimal":
        p, sc = decimal_ps(v.type)
    elif v.kind == "int":
        p, sc = _INT_DECIMAL[v.type if v.type in _INT_DECIMAL else None], 0
    else:
        return None
    vals, valid = _parts(v, n)
    return vals, valid, p, sc


def _widened(vals: np.ndarray, wide: bool) -> np.ndarray:
    """Unscaled values as Python ints (``wide``) or int64."""
    if wide:
        return vals if vals.dtype == object else vals.astype(object)
    return vals.astype(np.int64) if vals.dtype != object else _wrap64(vals)


def _wrap64(vals: np.ndarray) -> np.ndarray:
    """Python ints to int64, each value's low 64 bits (what a value past
    an 18-digit decimal's precision keeps in its lane)."""
    try:
        return vals.astype(np.int64)  # every value fits: one pass
    except OverflowError:
        return np.array([((int(v) + (1 << 63)) & ((1 << 64) - 1)) - (1 << 63)
                         for v in vals.tolist()], np.int64)


def _rescale(vals: np.ndarray, by: int, wide: bool) -> np.ndarray:
    """Unscaled values moved ``by`` decimal places (down truncates toward
    zero, as Arrow's unsafe rescale does)."""
    if by < 0:  # exact first: the quotient may fit int64 where the dividend did not
        exact = vals.dtype == object or -by > 18
        return _widened(_trunc_div(_widened(vals, exact), _POW10[-by], exact), wide)
    vals = _widened(vals, wide)
    if by > 0:
        return vals * (_POW10[by] if wide else np.int64(_POW10[by]))
    return vals


def _trunc_div(a: np.ndarray, b, wide: bool) -> np.ndarray:
    """``a / b`` truncated toward zero, exactly."""
    if wide:
        q = np.abs(a) // np.abs(b)
        neg = (a < 0) != (np.asarray(b) < 0)
        return np.where(neg, -q, q).astype(object)
    q = np.abs(a) // np.abs(b)
    return np.where((a < 0) != (np.asarray(b) < 0), -q, q).astype(np.int64)


def _decimal_doubles(vals: np.ndarray, scale: int, dtype=np.float64) -> np.ndarray:
    """Unscaled values as float64 (or float32), as Arrow's decimal to real
    cast gives them: a magnitude the real type holds exactly (2^53, 2^24)
    times ``10 ** -scale``; a larger one split into its whole part plus its
    fraction times ``10 ** -scale``; each part converted as a 128-bit value
    (high word times 2^64, plus the low word). Returned as float64."""
    limit = 1 << (53 if dtype is np.float64 else 24)
    neg = vals < 0
    mag = np.where(neg, -vals, vals)
    small = mag <= limit
    power = dtype(10.0 ** -scale)
    out = np.empty(len(vals), dtype)
    out[small] = _real(mag[small], dtype) * power
    if not small.all():
        big = mag[~small]  # // and % (not np.divmod) work on object ints too
        unit = _POW10[scale] if mag.dtype == object else np.int64(_POW10[scale])
        whole, frac = big // unit, big % unit
        out[~small] = _real(whole, dtype) + _real(frac, dtype) * power
    return np.where(neg, -out, out).astype(np.float64)


def _real(mag: np.ndarray, dtype) -> np.ndarray:
    if mag.dtype != object:
        return mag.astype(dtype)
    hi = (mag // (1 << 64)).astype(np.float64).astype(dtype)
    lo = (mag % (1 << 64)).astype(np.float64).astype(dtype)
    return hi * dtype(2.0 ** 64) + lo


def _as_double(v, n: int):
    """A numeric or decimal operand as float64 lanes."""
    if v.kind == "decimal":
        vals, ok = _parts(v, n)
        return _decimal_doubles(vals, decimal_ps(v.type)[1]), ok
    return _as(v, "double", n)


def _involves_decimal(l, r) -> bool:
    return l.kind == "decimal" or r.kind == "decimal"


def _decimal_compare(cls, l, r, n: int) -> HostColumn:
    if "null" in (l.kind, r.kind):
        return _nulls(n, "bool")
    if "double" in (l.kind, r.kind):
        lv, lok = _as_double(l, n)
        rv, rok = _as_double(r, n)
    else:
        a, b = _decimal_operand(l, n), _decimal_operand(r, n)
        if a is None or b is None:
            raise _NoKernel
        sc = max(a[3], b[3])
        wide = max(a[2] + sc - a[3], b[2] + sc - b[3]) > 18
        lv, lok = _rescale(a[0], sc - a[3], wide), a[1]
        rv, rok = _rescale(b[0], sc - b[3], wide), b[1]
    valid = lok & rok
    with np.errstate(invalid="ignore"):
        out = np.asarray(_OPS[cls](lv, rv), bool)
    return HostColumn("bool", out & valid, valid)


def _decimal_arith(cls, l, r, n: int) -> HostColumn:
    if "null" in (l.kind, r.kind):
        return _nulls(n)
    if "double" in (l.kind, r.kind):
        lv, lok = _as_double(l, n)
        rv, rok = _as_double(r, n)
        with np.errstate(all="ignore"):
            out = {ir.Add: np.add, ir.Sub: np.subtract, ir.Mul: np.multiply}[cls](lv, rv)
        return HostColumn("double", out, lok & rok)
    a, b = _decimal_operand(l, n), _decimal_operand(r, n)
    if a is None or b is None:
        raise _NoKernel
    (av, aok, p1, s1), (bv, bok, p2, s2) = a, b
    if cls is ir.Mul:
        p, sc = p1 + p2 + 1, s1 + s2
    else:
        sc = max(s1, s2)
        p = max(p1 - s1, p2 - s2) + sc + 1
    if p > 38:
        raise _NoKernel  # Arrow: decimal precision out of range
    wide = p > 18
    if cls is ir.Mul:
        out = _widened(av, wide) * _widened(bv, wide)
    else:
        x, y = _rescale(av, sc - s1, wide), _rescale(bv, sc - s2, wide)
        out = x + y if cls is ir.Add else x - y
    return HostColumn("decimal", out, aok & bok, decimal_type(p, sc))


def _decimal_divide(l, r, n: int) -> HostColumn:
    """Arrow's decimal division (a zero divisor is NULL, as the JAX
    package's visitor nulls it first)."""
    if "null" in (l.kind, r.kind):
        return _nulls(n, "double" if "double" in (l.kind, r.kind) else "null")
    if "double" in (l.kind, r.kind):
        lv, lok = _as_double(l, n)
        rv, rok = _as_double(r, n)
        rok = rok & (rv != 0)
        with np.errstate(all="ignore"):
            out = lv / np.where(rok, rv, 1)
        return HostColumn("double", out, lok & rok)
    a, b = _decimal_operand(l, n), _decimal_operand(r, n)
    if a is None or b is None:
        raise _NoKernel
    (av, aok, p1, s1), (bv, bok, p2, s2) = a, b
    if r.kind == "decimal" and p2 - s2 < 19:
        # the JAX package's visitor nulls a zero divisor by casting the
        # literal 0 (an int64) into the divisor's type, which Arrow refuses
        # for fewer than 19 integer digits: that node takes the row evaluator
        raise _NoKernel
    sc = max(4, s1 + p2 - s2 + 1)
    p = p1 - s1 + s2 + sc
    if p > 38:
        raise _NoKernel  # Arrow: decimal precision out of range
    bok = bok & (bv != 0)
    wide = True  # the upscaled dividend passes 18 digits at any scale >= 4 past s1
    num = _rescale(av, sc - s1 + s2, wide)
    den = _widened(np.where(bok, bv, 1), wide)
    out = _trunc_div(num, den, wide)
    return HostColumn("decimal", out if p > 18 else _widened(out, False), aok & bok,
                      decimal_type(p, sc))


def _double_to_unscaled(vals: np.ndarray, precision: int, scale: int) -> np.ndarray:
    """Spark's double to decimal cast (``Decimal(double)``, then
    ``changePrecision`` with ``ROUND_HALF_UP``): the double's shortest
    decimal form at ``scale`` digits, rounded half away from zero; a value
    past the precision (or not finite) becomes 0, as Arrow's unsafe cast
    leaves it. Vectorised, with the values whose scaled double lies within
    a few ulps of a half redone exactly."""
    v = vals.astype(np.float64)
    top = _POW10[precision]
    with np.errstate(all="ignore"):
        y = v * 10.0 ** scale
        r = np.where(y >= 0, np.floor(y + 0.5), np.ceil(y - 0.5))
        fits = np.isfinite(y) & (np.abs(y) < 2.0 * 10.0 ** precision)
        near = fits & ((np.abs(np.abs(y - np.trunc(y)) - 0.5) <= 8 * np.spacing(np.abs(y)))
                       | (scale > 15))  # past 15 digits 10 ** scale is not a double
    out = np.zeros(len(v), object)
    out[fits] = r[fits].astype(object)
    unit = _decimal.Decimal(1).scaleb(-scale)
    for i in np.flatnonzero(near):
        d = _decimal.Decimal(repr(float(v[i]))).quantize(unit, _decimal.ROUND_HALF_UP,
                                                          context=nested_mod._EXACT)
        out[i] = int(d.scaleb(scale, context=nested_mod._EXACT))
    out[fits] = [int(x) if abs(int(x)) < top else 0 for x in out[fits].tolist()]
    return _widened(out, precision > 18)


def _to_decimal_column(col, precision: int, scale: int, n: int) -> HostColumn:
    """``col`` cast to ``decimal(precision, scale)`` as Arrow's unsafe cast
    does; raises :class:`CastError` where Arrow raises."""
    stype = decimal_type(precision, scale)
    wide = precision > 18
    vals, valid = _parts(col, n)
    if col.kind == "null":
        return null_column(n, "decimal", stype)
    if col.kind == "decimal":
        out = _rescale(vals, scale - decimal_ps(col.type)[1], wide)
    elif col.kind == "int":
        digits = _INT_DECIMAL[col.type if col.type in _INT_DECIMAL else None]
        if precision - scale < digits:
            raise CastError(f"Precision is not great enough for the result. It should be at "
                            f"least {digits + scale}")
        out = _rescale(vals, scale, wide)
    elif col.kind == "double":
        out = _double_to_unscaled(vals, precision, scale)
    else:
        raise CastError(f"casting a {col.kind} column to {stype} is not supported")
    return HostColumn("decimal", _widened(out, wide), valid.copy(), stype)


def _decimal_strings(vals: np.ndarray, valid: np.ndarray, scale: int) -> np.ndarray:
    out = np.empty(len(vals), object)
    for i in np.flatnonzero(valid):
        out[i] = format(to_decimal(vals[i], scale), "f")
    return out


def _decimal_round(vals: np.ndarray, scale: int, mode: str) -> np.ndarray:
    """Unscaled values rounded to a whole number, kept at ``scale``:
    ``floor``, ``ceil`` or ``half_up`` (half away from zero)."""
    if scale <= 0:
        return vals
    wide = vals.dtype == object
    unit = _POW10[scale] if wide else np.int64(_POW10[scale])
    q, rem = np.divmod(vals, unit)  # floor division
    if mode == "ceil":
        q = q + (rem != 0)
    elif mode == "half_up":
        twice = rem * 2
        q = q + ((twice > unit) | ((twice == unit) & (vals >= 0)))
    out = q * unit
    return out if wide else out.astype(np.int64)


def _compare(cls, l, r, n: int) -> HostColumn:
    if _involves_decimal(l, r):
        return _decimal_compare(cls, l, r, n)
    l, r = _numeric_coerce(l, r, n)
    kind = _unify_numeric(l, r, n)
    if kind is None:
        return _nulls(n, "bool")
    lv, lok = _as(l, kind, n)
    rv, rok = _as(r, kind, n)
    valid = lok & rok
    if kind == "str":
        return HostColumn("bool", _str_cmp(cls, lv, rv, valid), valid)
    with np.errstate(invalid="ignore"):
        out = _OPS[cls](lv, rv)
    return HostColumn("bool", np.asarray(out, bool) & valid, valid)


def _arith(cls, l, r, n: int) -> HostColumn:
    if _involves_decimal(l, r):
        return _decimal_arith(cls, l, r, n)
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
        ``pyarrow.array`` types the results. Only the columns ``e`` names
        become Python values (all of them where a name resolves to none,
        so the error lists the table's columns)."""
        refs = {r.lower() for r in ir.references(e)}
        names = [c for c in self.table.column_names if c.lower() in refs]
        rows = (self.table.select(names).rows() if {c.lower() for c in names} == refs
                else self.table.rows())
        vals = [e.eval(r) for r in rows]
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
        if v.kind == "decimal":
            # the option array takes the column's type: ints and Decimals
            # whose digits fit it, as ``pa.array(vals, type=...)`` takes them
            p, sc = decimal_ps(v.type)
            want = []
            for o in vals:
                if isinstance(o, bool) or not isinstance(o, (int, _decimal.Decimal)):
                    raise _NoKernel
                u = _decimal.Decimal(o).scaleb(sc, context=nested_mod._EXACT)
                if u != u.to_integral_value() or abs(u) >= _POW10[p]:
                    raise _NoKernel
                want.append(int(u))
            if v.values.dtype == object:
                want_set = set(want)
                found = np.fromiter((x in want_set for x in v.values.tolist()), bool, self.n)
            else:
                found = np.isin(v.values, np.array(want, np.int64))
        elif v.kind in ("int", "double"):
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
        if _involves_decimal(l, r):
            return _decimal_divide(l, r, self.n)
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
        if not _is_num(c.kind) and c.kind != "decimal":
            raise _NoKernel
        v, ok = _parts(c, self.n)
        with np.errstate(all="ignore"):
            return HostColumn(c.kind, -v, ok, c.type if c.kind == "decimal" else None)

    def _v_Cast(self, e):
        c = self.visit(e.child)
        dt = e.data_type
        v, ok = _parts(c, self.n)
        if c.kind == "null":
            return _nulls(self.n)
        if isinstance(dt, DecimalType):
            try:
                return _to_decimal_column(c, dt.precision, dt.scale, self.n)
            except CastError:
                raise _NoKernel from None
        if c.kind == "decimal":
            target = _CASTS_OUT_OF_DECIMAL.get(type(dt))
            if target is None:
                raise _NoKernel
            return cast_column(_arr(c, self.n), *target)
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
        if "decimal" in kinds:
            return self._coalesce_decimal(cols, kinds)
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

    def _coalesce_decimal(self, cols, kinds):
        """Decimals (and integers) coalesce in their common decimal type:
        the largest scale, and the most integer digits added to it."""
        if not kinds <= {"decimal", "int"}:
            raise _NoKernel
        ops = [_decimal_operand(c, self.n) for c in cols if c.kind != "null"]
        sc = max(o[3] for o in ops)
        p = max(o[2] - o[3] for o in ops) + sc
        if p > 38:
            raise _NoKernel
        common = [_to_decimal_column(c, p, sc, self.n) if c.kind != "null" else c for c in cols]
        out = null_column(self.n, "decimal", decimal_type(p, sc))
        vals, valid = out.values, out.valid
        for c in common:
            if c.kind == "null":
                continue
            take = c.valid & ~valid
            vals = np.where(take, c.values, vals)
            valid = valid | c.valid
        return HostColumn("decimal", _widened(vals, p > 18), valid, decimal_type(p, sc))

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

    def _date_arith(self, e):
        """``date_add``/``date_sub``/``datediff`` on the day lane with
        Arrow's semantics: a date's days, the count cast to int32, the sum
        or difference unchecked in int32, NULL where either side is. An
        operand that is not a date takes the row semantics, as in the JAX
        package."""
        a = self.visit(e.children[0])
        b = self.visit(e.children[1])
        if a.kind != "date":
            return self._fallback(e)
        av, aok = _parts(a, self.n)
        if e.name == "datediff":
            if b.kind != "date":
                return self._fallback(e)
            bv, bok = _parts(b, self.n)
            return HostColumn("int", _wrap_int32(av - bv), aok & bok)
        count = _int32_days(b, self.n)
        if count is None:
            return self._fallback(e)
        bv, bok = count
        out = av + bv if e.name == "date_add" else av - bv
        return HostColumn("date", _wrap_int32(out), aok & bok)

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
        if name in ("hour", "minute", "second") and len(e.children) == 1:
            c = self.visit(e.children[0])
            if c.kind != "ts":
                return self._fallback(e)  # int-µs inputs keep the row semantics
            # Arrow's temporal field kernels: floor to the unit, then the field
            v, ok = _parts(c, self.n)
            div, mod = {"hour": (3_600_000_000, 24), "minute": (60_000_000, 60),
                        "second": (1_000_000, 60)}[name]
            return HostColumn("int", np.floor_divide(v, div) % mod, ok)
        if name == "to_date" and len(e.children) == 1:
            c = self.visit(e.children[0])
            if c.kind != "str":
                return self._fallback(e)
            v, ok = _parts(c, self.n)
            sliced = HostColumn("str", np.array([s[:10] if o else None
                                                 for s, o in zip(v, ok)], object), ok)
            return _str_to_temporal(sliced, "date", self.n)
        if name in ("date_add", "date_sub", "datediff") and len(e.children) == 2:
            return self._date_arith(e)
        if name == "round" and _round_to_whole(e):
            c = self.visit(e.children[0])
            if c.kind == "decimal":  # Spark's round, half up, the type kept
                v, ok = _parts(c, self.n)
                return HostColumn("decimal", _decimal_round(v, decimal_ps(c.type)[1],
                                                            "half_up"), ok, c.type)
            return self._fallback(e)
        if name in ("abs", "floor", "ceil") and len(e.children) == 1:
            c = self.visit(e.children[0])
            if c.kind == "null":
                return _nulls(self.n)
            if c.kind == "decimal":
                v, ok = _parts(c, self.n)
                scale = decimal_ps(c.type)[1]
                with np.errstate(all="ignore"):
                    out = np.abs(v) if name == "abs" else _decimal_round(v, scale, name)
                return HostColumn("decimal", out, ok, c.type)
            if not _is_num(c.kind):
                raise _NoKernel
            v, ok = _parts(c, self.n)
            if name == "abs":
                with np.errstate(all="ignore"):
                    return HostColumn(c.kind, np.abs(v), ok)
            fn = np.floor if name == "floor" else np.ceil
            return HostColumn("double", fn(v.astype(np.float64)), ok)
        return self._fallback(e)  # the exact row semantics


def _int32_days(c: HostColumn, n: int):
    """A count as Arrow's safe cast to int32 gives it: (values, valid), or
    None where a valid value does not fit (Arrow raises, and the JAX
    package's visitor then takes the row semantics)."""
    if c.kind == "null":
        return np.zeros(n, np.int64), np.zeros(n, bool)
    if c.kind not in ("int", "bool", "double"):
        return None
    v, ok = _parts(c, n)
    if c.kind == "double":
        live = v[ok]
        if not np.all(np.isfinite(live)) or np.any(live != np.trunc(live)):
            return None
    v = np.where(ok, v, 0).astype(np.float64 if c.kind == "double" else np.int64)
    if np.any((v < _I32_MIN) | (v > _I32_MAX)):
        return None
    return v.astype(np.int64), ok


def _wrap_int32(v: np.ndarray) -> np.ndarray:
    """Arrow's unchecked int32 add/subtract: the low 32 bits, signed."""
    return ((v.astype(np.int64) - _I32_MIN) % (1 << 32)) + _I32_MIN


def _round_to_whole(e) -> bool:
    """``round(x)`` or ``round(x, 0)``: the one ``round`` the JAX package's
    visitor hands to Arrow."""
    if len(e.children) == 1:
        return True
    a = e.children[1]
    return (len(e.children) == 2 and isinstance(a, ir.Literal) and isinstance(a.value, int)
            and not isinstance(a.value, bool) and a.value == 0)


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


def boolean_mask(expr: ir.Expression, table: HostTable) -> np.ndarray:
    """A predicate as a NULL-free row mask (NULL -> False; numbers are true
    when non-zero), as ``pc.fill_null(pc.cast(..., bool), False)``."""
    v = evaluate(expr, table)
    if v.kind == "null":
        return np.zeros(table.num_rows, bool)
    if v.kind not in ("bool", "int", "double"):
        raise StatsTypeError(f"cannot cast a {v.kind} predicate to bool")
    return (v.values != 0) & v.valid if v.kind != "bool" else v.values.astype(bool) & v.valid


def filter_table(table: HostTable, expr: Optional[ir.Expression]) -> HostTable:
    """Keep rows where ``expr`` is exactly TRUE (NULL drops, like SQL WHERE)."""
    if expr is None or table.num_rows == 0:
        return table
    return table.filter(boolean_mask(expr, table))


def _concat_columns(cols: Sequence[HostColumn]) -> HostColumn:
    kinds = {c.kind for c in cols} - {"null"}
    if not kinds:
        return HostColumn("null", np.zeros(sum(len(c.valid) for c in cols), np.int64),
                          np.zeros(sum(len(c.valid) for c in cols), bool))
    if len(kinds) > 1:
        raise StatsTypeError(f"cannot concatenate columns of kinds {sorted(kinds)}")
    kind = kinds.pop()
    types = {c.type for c in cols if c.kind != "null"}
    if kind in ("decimal", "nested"):
        if len(types) > 1:
            raise StatsTypeError(f"cannot concatenate columns of types {sorted(map(str, types))}")
        stype = types.pop()
        full = [c if c.kind != "null" else null_column(len(c.valid), kind, stype) for c in cols]
        if kind == "nested":
            ncol = nested_mod.concat([c.values for c in full])
            return HostColumn("nested", ncol, ncol.valid, stype)
        parts = [c.values for c in full]
        if any(v.dtype == object for v in parts):
            parts = [v.astype(object) for v in parts]
        return HostColumn(kind, np.concatenate(parts), np.concatenate([c.valid for c in full]),
                          stype)
    parts = [c.values if c.kind != "null" else _nulls(len(c.valid), kind).values for c in cols]
    return HostColumn(kind, np.concatenate(parts), np.concatenate([c.valid for c in cols]),
                      types.pop() if len(types) == 1 else None)


def concat_tables(tables: Sequence[HostTable]) -> HostTable:
    """Row-wise concatenation; every table has the first one's columns (by
    name), a NULL column takes the others' type (``promote_options=
    "permissive"``)."""
    tables = list(tables)
    names = tables[0].column_names
    cols = {n: _concat_columns([t.columns[n] for t in tables]) for n in names}
    return HostTable(cols, sum(t.num_rows for t in tables))


_NP_KINDS = {"b": "bool", "i": "int", "f": "double"}
_NP_TYPES = {np.dtype(np.int8): "int8", np.dtype(np.int16): "int16",
             np.dtype(np.int32): "int32", np.dtype(np.float32): "float32"}


def column_from_values(name: str, values) -> HostColumn:
    """One column from a numpy array (a masked array's mask is NULL), or a
    Python list typed as ``pyarrow.array`` types it."""
    if isinstance(values, HostColumn):
        return values
    if isinstance(values, np.ndarray):
        valid = np.ones(len(values), bool)
        if isinstance(values, np.ma.MaskedArray):
            valid = ~np.ma.getmaskarray(values)
            values = values.filled(0 if values.dtype.kind in "biuf" else None)
        if values.dtype.kind == "u":
            raise StatsTypeError(f"column {name!r}: unsigned columns are not supported")
        kind = _NP_KINDS.get(values.dtype.kind)
        if kind is None:  # strings, objects: typed value by value
            vals = [v if ok else None for v, ok in zip(values.tolist(), valid)]
            return _convert(name, _infer_kind(vals), vals)
        stype = _NP_TYPES.get(values.dtype)
        np_dt = {"bool": bool, "int": np.int64, "double": np.float64}[kind]
        return HostColumn(kind, values.astype(np_dt), valid, stype)
    vals = list(values)
    return _convert(name, _infer_kind(vals), vals)


def null_column(n: int, kind: str, stype: Any = None) -> HostColumn:
    if kind in ("nested", "decimal"):
        ncol = nested_mod.ncol_nulls(stype, n)
        return HostColumn(kind, ncol if kind == "nested" else ncol.values, ncol.valid, stype)
    c = _nulls(n, kind)
    return HostColumn(c.kind, c.values, c.valid, stype)


def where_column(mask: np.ndarray, new: HostColumn, old: HostColumn) -> HostColumn:
    """``new`` where ``mask``, else ``old`` (one kind and type), row by
    row; a nested column is gathered from both."""
    if old.kind == "nested":
        n = len(mask)
        both = nested_mod.concat([old.values, new.values])
        ncol = both.take(np.where(mask, np.arange(n) + n, np.arange(n)))
        return HostColumn("nested", ncol, ncol.valid, old.type)
    vals = np.where(mask, new.values, old.values)
    if old.kind == "decimal":
        vals = _widened(vals, decimal_ps(old.type)[0] > 18)
    return HostColumn(old.kind, vals, np.where(mask, new.valid, old.valid), old.type)


_INT_BITS = {"int8": 8, "int16": 16, "int32": 32, None: 64, "int64": 64}


def _wrap(vals: np.ndarray, stype: Optional[str]) -> np.ndarray:
    bits = _INT_BITS[stype]
    if bits == 64:
        return vals.astype(np.int64)
    return vals.astype({8: np.int8, 16: np.int16, 32: np.int32}[bits]).astype(np.int64)


def cast_column(col: HostColumn, kind: str, stype: Any) -> HostColumn:
    """``col`` cast to (kind, stored type) as Arrow's unsafe cast does:
    integers wrap to the narrower width, doubles truncate toward zero
    (then wrap), a double narrowed to float32 rounds, bools cast to 0/1,
    numbers to bool by ``!= 0``, decimals as the module's docstring says;
    a NULL column takes the type. Casts Arrow would make between other
    kinds raise ``NotImplementedError``, those it refuses
    :class:`CastError`."""
    stype = None if stype == DEFAULT_TYPE.get(kind) else stype
    n = len(col.valid)
    valid = col.valid
    if col.kind == "null":
        return null_column(n, kind, stype)
    if kind == "decimal":
        return _to_decimal_column(col, *decimal_ps(stype), n)
    if kind == "nested" or col.kind == "nested":
        if col.kind == kind and col.type == stype:
            return col
        ncol = nested_mod.reshape(col.values, col.type, stype) if col.kind == kind else None
        if ncol is not None:
            return HostColumn("nested", ncol, ncol.valid, stype)
        raise CastError(f"casting a {col.kind} column of type {col.type!r} to {stype!r} is not "
                        "supported")
    if col.kind == "decimal":
        scale = decimal_ps(col.type)[1]
        if kind == "double":
            real = np.float32 if stype == "float32" else np.float64
            return HostColumn("double", _decimal_doubles(col.values, scale, real), valid, stype)
        if kind == "int":
            whole = _rescale(col.values, -scale, col.values.dtype == object)
            return HostColumn("int", _wrap(_widened(whole, False), stype), valid, stype)
        if kind == "str":
            return HostColumn("str", _decimal_strings(col.values, valid, scale), valid, None)
    if kind == "int" and col.kind in ("int", "double", "bool"):
        with np.errstate(all="ignore"):
            v = col.values
            if col.kind == "double":
                v = np.where(np.isfinite(v), np.trunc(v), 0)
                v = np.where(np.abs(v) < 2.0 ** 63, v, 0).astype(np.int64)
            return HostColumn("int", _wrap(v.astype(np.int64), stype), valid, stype)
    if kind == "double" and col.kind in ("int", "double", "bool"):
        v = col.values.astype(np.float64)
        if stype == "float32":
            with np.errstate(all="ignore"):
                v = v.astype(np.float32).astype(np.float64)
        return HostColumn("double", v, valid, stype)
    if kind == "bool" and col.kind in ("int", "double", "bool"):
        return HostColumn("bool", col.values != 0, valid, None)
    if kind == col.kind and kind in ("str", "date", "ts", "object"):
        return HostColumn(kind, col.values, valid, stype)
    if kind == "str" and col.kind == "int":
        out = np.empty(n, object)
        for i in np.nonzero(valid)[0]:
            out[i] = str(int(col.values[i]))
        return HostColumn("str", out, valid, None)
    raise NotImplementedError(f"casting a {col.kind} column to {kind} ({stype}) is not ported")

"""Expression IR: the engine's predicate language (the port's own copy of
``delta_tpu.expr.ir``).

The full node set the parser and predicate synthesis build, with the same
``sql()`` rendering and equality as the JAX package's, and the
row-at-a-time :meth:`Expression.eval` over a ``dict`` that partition
pruning and the host evaluator's fallback use. The columnar evaluators are
``delta_tpu_torch.expr.vectorized`` (host, numpy) and
``delta_tpu_torch.expr.device_eval`` (the card).

NULL is represented as Python ``None``; comparisons with NULL yield NULL;
AND/OR use Kleene logic, as in Spark SQL.
"""
from __future__ import annotations

import decimal as _decimal
import math
import re
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

from delta_tpu_torch.schema.types import (
    BooleanType,
    DataType,
    DateType,
    DecimalType,
    DoubleType,
    LongType,
    StringType,
    TimestampType,
)
from delta_tpu_torch.utils import errors

__all__ = [
    "Expression",
    "Column",
    "Literal",
    "Alias",
    "And",
    "Or",
    "Not",
    "Eq",
    "NullSafeEq",
    "Ne",
    "Lt",
    "Le",
    "Gt",
    "Ge",
    "In",
    "IsNull",
    "IsNotNull",
    "Add",
    "Sub",
    "Mul",
    "Div",
    "Mod",
    "Neg",
    "Cast",
    "Like",
    "StartsWith",
    "Coalesce",
    "CaseWhen",
    "Func",
    "TRUE",
    "FALSE",
    "and_all",
    "split_conjuncts",
    "references",
]


class Expression:
    children: Tuple["Expression", ...] = ()

    def eval(self, row: Dict[str, Any]) -> Any:
        raise NotImplementedError

    # -- tree utilities --------------------------------------------------

    def walk(self) -> Iterator["Expression"]:
        yield self
        for c in self.children:
            yield from c.walk()

    def transform(self, fn: Callable[["Expression"], Optional["Expression"]]) -> "Expression":
        replaced = fn(self)
        if replaced is not None:
            return replaced
        new_children = tuple(c.transform(fn) for c in self.children)
        if new_children == self.children:
            return self
        clone = object.__new__(type(self))
        clone.__dict__.update(self.__dict__)
        clone.children = new_children
        return clone

    def sql(self) -> str:
        raise NotImplementedError

    def __repr__(self) -> str:
        return self.sql()

    def __eq__(self, other: Any) -> bool:
        return type(self) is type(other) and self.sql() == other.sql()

    def __hash__(self) -> int:
        return hash((type(self).__name__, self.sql()))


def references(expr: Expression) -> List[str]:
    """Column names referenced (lower-cased for case-insensitive resolution)."""
    out = []
    for e in expr.walk():
        if isinstance(e, Column):
            out.append(e.name)
    return out


def split_conjuncts(expr: Expression) -> List[Expression]:
    if isinstance(expr, And):
        return split_conjuncts(expr.left) + split_conjuncts(expr.right)
    return [expr]


def and_all(exprs: Sequence[Expression]) -> Expression:
    if not exprs:
        return TRUE
    out = exprs[0]
    for e in exprs[1:]:
        out = And(out, e)
    return out


class Column(Expression):
    def __init__(self, name: str):
        self.name = name
        self.children = ()

    def eval(self, row: Dict[str, Any]) -> Any:
        if self.name in row:
            return row[self.name]
        # case-insensitive fallback (Delta is case-insensitive by default)
        lname = self.name.lower()
        for k, v in row.items():
            if k.lower() == lname:
                return v
        raise errors.column_not_found_in_row(self.name, row)

    def sql(self) -> str:
        if re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", self.name):
            return self.name
        escaped = self.name.replace("`", "``")
        return f"`{escaped}`"


class Literal(Expression):
    def __init__(self, value: Any, data_type: Optional[DataType] = None):
        self.value = value
        self.data_type = data_type or _infer_type(value)
        self.children = ()

    def eval(self, row: Dict[str, Any]) -> Any:
        return self.value

    def sql(self) -> str:
        if self.value is None:
            return "NULL"
        if isinstance(self.value, bool):
            return "TRUE" if self.value else "FALSE"
        if isinstance(self.value, str):
            escaped = self.value.replace("'", "''")
            return f"'{escaped}'"
        return str(self.value)


TRUE = Literal(True, BooleanType())
FALSE = Literal(False, BooleanType())


class Alias(Expression):
    def __init__(self, child: Expression, name: str):
        self.children = (child,)
        self.name = name

    @property
    def child(self) -> Expression:
        return self.children[0]

    def eval(self, row):
        return self.child.eval(row)

    def sql(self) -> str:
        return f"{self.child.sql()} AS {self.name}"


def _infer_type(v: Any) -> DataType:
    if v is None:
        return StringType()
    if isinstance(v, bool):
        return BooleanType()
    if isinstance(v, int):
        return LongType()
    if isinstance(v, float):
        return DoubleType()
    if isinstance(v, str):
        return StringType()
    return StringType()


class _Binary(Expression):
    op = ""

    def __init__(self, left: Expression, right: Expression):
        self.children = (left, right)

    @property
    def left(self) -> Expression:
        return self.children[0]

    @property
    def right(self) -> Expression:
        return self.children[1]

    def sql(self) -> str:
        return f"({self.left.sql()} {self.op} {self.right.sql()})"


class And(_Binary):
    op = "AND"

    def eval(self, row):
        l = self.left.eval(row)
        if l is False:
            return False
        r = self.right.eval(row)
        if r is False:
            return False
        if l is None or r is None:
            return None
        return True


class Or(_Binary):
    op = "OR"

    def eval(self, row):
        l = self.left.eval(row)
        if l is True:
            return True
        r = self.right.eval(row)
        if r is True:
            return True
        if l is None or r is None:
            return None
        return False


class Not(Expression):
    def __init__(self, child: Expression):
        self.children = (child,)

    @property
    def child(self):
        return self.children[0]

    def eval(self, row):
        v = self.child.eval(row)
        if v is None:
            return None
        return not v

    def sql(self) -> str:
        return f"(NOT {self.child.sql()})"


def _parse_temporal_str(s: str, like: Any):
    import datetime as _dt

    from delta_tpu_torch.utils.timeparse import iso_to_date, iso_to_naive_utc

    if isinstance(like, _dt.datetime):
        out = iso_to_naive_utc(s)
        if like.tzinfo is not None:
            out = out.replace(tzinfo=_dt.timezone.utc)  # compare as aware
        return out
    return iso_to_date(s)


def _coerce_pair(l: Any, r: Any) -> Tuple[Any, Any]:
    """Numeric cross-type comparisons; strings compare as strings — except
    against dates/timestamps, where the string side parses as ISO-8601
    (Spark's implicit cast of temporal literals)."""
    import datetime as _dt

    if isinstance(l, bool) or isinstance(r, bool):
        return l, r
    if isinstance(l, (int, float)) and isinstance(r, (int, float)):
        return l, r
    if isinstance(l, str) and isinstance(r, (_dt.datetime, _dt.date)):
        try:
            return _parse_temporal_str(l, r), r
        except ValueError:
            return l, r
    if isinstance(r, str) and isinstance(l, (_dt.datetime, _dt.date)):
        try:
            return l, _parse_temporal_str(r, l)
        except ValueError:
            return l, r
    return l, r


class _Comparison(_Binary):
    py = staticmethod(lambda l, r: None)

    def eval(self, row):
        l = self.left.eval(row)
        r = self.right.eval(row)
        if l is None or r is None:
            return None
        l, r = _coerce_pair(l, r)
        try:
            return self.py(l, r)
        except TypeError:
            raise errors.cannot_compare_types(
                type(l).__name__, type(r).__name__, self.sql())


class Eq(_Comparison):
    op = "="
    py = staticmethod(lambda l, r: l == r)


class NullSafeEq(_Binary):
    op = "<=>"

    def eval(self, row):
        l = self.left.eval(row)
        r = self.right.eval(row)
        return l == r  # None <=> None is True


class Ne(_Comparison):
    op = "!="
    py = staticmethod(lambda l, r: l != r)


class Lt(_Comparison):
    op = "<"
    py = staticmethod(lambda l, r: l < r)


class Le(_Comparison):
    op = "<="
    py = staticmethod(lambda l, r: l <= r)


class Gt(_Comparison):
    op = ">"
    py = staticmethod(lambda l, r: l > r)


class Ge(_Comparison):
    op = ">="
    py = staticmethod(lambda l, r: l >= r)


class In(Expression):
    def __init__(self, value: Expression, options: Sequence[Expression]):
        self.children = (value, *options)

    @property
    def value(self):
        return self.children[0]

    @property
    def options(self):
        return self.children[1:]

    def eval(self, row):
        v = self.value.eval(row)
        if v is None:
            return None
        saw_null = False
        for o in self.options:
            ov = o.eval(row)
            if ov is None:
                saw_null = True
            elif ov == v:
                return True
        return None if saw_null else False

    def sql(self) -> str:
        opts = ", ".join(o.sql() for o in self.options)
        return f"({self.value.sql()} IN ({opts}))"


class IsNull(Expression):
    def __init__(self, child: Expression):
        self.children = (child,)

    @property
    def child(self):
        return self.children[0]

    def eval(self, row):
        return self.child.eval(row) is None

    def sql(self) -> str:
        return f"({self.child.sql()} IS NULL)"


class IsNotNull(Expression):
    def __init__(self, child: Expression):
        self.children = (child,)

    @property
    def child(self):
        return self.children[0]

    def eval(self, row):
        return self.child.eval(row) is not None

    def sql(self) -> str:
        return f"({self.child.sql()} IS NOT NULL)"


class _Arith(_Binary):
    py = staticmethod(lambda l, r: None)

    def eval(self, row):
        l = self.left.eval(row)
        r = self.right.eval(row)
        if l is None or r is None:
            return None
        try:
            return self.py(l, r)
        except TypeError:
            raise errors.cannot_apply_operator(
                self.op, type(l).__name__, type(r).__name__, self.sql())


class Add(_Arith):
    op = "+"
    py = staticmethod(lambda l, r: l + r)


class Sub(_Arith):
    op = "-"
    py = staticmethod(lambda l, r: l - r)


class Mul(_Arith):
    op = "*"
    py = staticmethod(lambda l, r: l * r)


class Div(_Arith):
    op = "/"

    @staticmethod
    def py(l, r):
        if r == 0:
            return None  # Spark: div by zero yields NULL (ansi off)
        return l / r


class Mod(_Arith):
    op = "%"

    @staticmethod
    def py(l, r):
        """Spark's remainder (Java's ``%``): the sign of the dividend, for
        integers as for doubles (``math.fmod``) and decimals."""
        if r == 0:
            return None
        if isinstance(l, float) or isinstance(r, float):
            return math.fmod(l, r)
        if isinstance(l, int) and isinstance(r, int):
            m = abs(l) % abs(r)
            return m if l >= 0 else -m
        return l % r


class Neg(Expression):
    def __init__(self, child: Expression):
        self.children = (child,)

    @property
    def child(self):
        return self.children[0]

    def eval(self, row):
        v = self.child.eval(row)
        return None if v is None else -v

    def sql(self) -> str:
        return f"(- {self.child.sql()})"


class Cast(Expression):
    def __init__(self, child: Expression, data_type: DataType):
        self.children = (child,)
        self.data_type = data_type

    @property
    def child(self):
        return self.children[0]

    def eval(self, row):
        return cast_value(self.child.eval(row), self.data_type)

    def sql(self) -> str:
        return f"CAST({self.child.sql()} AS {self.data_type.simple_string().upper()})"


def cast_value(v: Any, dt: DataType) -> Any:
    """Spark-style permissive cast; invalid casts yield NULL (ansi off)."""
    if v is None:
        return None
    try:
        name = dt.name if not isinstance(dt, DecimalType) else "decimal"
        if isinstance(dt, BooleanType):
            if isinstance(v, str):
                s = v.strip().lower()
                if s in ("true", "t", "yes", "y", "1"):
                    return True
                if s in ("false", "f", "no", "n", "0"):
                    return False
                return None
            return bool(v)
        if name in ("byte", "short", "integer", "long"):
            if isinstance(v, bool):
                return int(v)
            if isinstance(v, str):
                v = v.strip()
                return int(float(v)) if "." in v or "e" in v.lower() else int(v)
            return int(v)
        if name in ("float", "double", "decimal"):
            return float(v)
        if isinstance(dt, StringType):
            if isinstance(v, bool):
                return "true" if v else "false"
            return str(v)
        if isinstance(dt, DateType):
            if isinstance(v, int):
                return v
            import datetime as _dt

            return (_dt.date.fromisoformat(str(v)[:10]) - _dt.date(1970, 1, 1)).days
        if isinstance(dt, TimestampType):
            if isinstance(v, int):
                return v
            import datetime as _dt

            s = str(v).replace(" ", "T")
            return int(_dt.datetime.fromisoformat(s).replace(tzinfo=_dt.timezone.utc).timestamp() * 1_000_000)
    except (ValueError, TypeError):
        return None
    return v


class Like(_Binary):
    """SQL LIKE with % and _ wildcards."""

    op = "LIKE"
    _rx_cache: Optional[Tuple[str, Any]] = None

    def eval(self, row):
        v = self.left.eval(row)
        p = self.right.eval(row)
        if v is None or p is None:
            return None
        if not isinstance(v, str) or not isinstance(p, str):
            raise errors.like_requires_strings(type(v).__name__, self.sql())
        cached = self._rx_cache
        if cached is None or cached[0] != p:
            rx = re.compile(
                "".join(".*" if ch == "%" else "." if ch == "_" else re.escape(ch) for ch in p),
                re.DOTALL,
            )
            self._rx_cache = cached = (p, rx)
        return cached[1].fullmatch(v) is not None


class StartsWith(_Binary):
    op = "STARTSWITH"

    def eval(self, row):
        v = self.left.eval(row)
        p = self.right.eval(row)
        if v is None or p is None:
            return None
        return str(v).startswith(str(p))

    def sql(self) -> str:
        return f"startswith({self.left.sql()}, {self.right.sql()})"


class Coalesce(Expression):
    def __init__(self, *options: Expression):
        self.children = tuple(options)

    def eval(self, row):
        for o in self.children:
            v = o.eval(row)
            if v is not None:
                return v
        return None

    def sql(self) -> str:
        return f"coalesce({', '.join(o.sql() for o in self.children)})"


class CaseWhen(Expression):
    """CASE WHEN c1 THEN v1 [WHEN ...] ELSE d END. Children layout:
    (c1, v1, c2, v2, ..., default)."""

    def __init__(self, branches: Sequence[Tuple[Expression, Expression]],
                 default: Optional[Expression] = None):
        flat: List[Expression] = []
        for c, v in branches:
            flat.extend((c, v))
        flat.append(default if default is not None else Literal(None))
        self.children = tuple(flat)
        self.n_branches = len(branches)

    def eval(self, row):
        for i in range(self.n_branches):
            if self.children[2 * i].eval(row) is True:
                return self.children[2 * i + 1].eval(row)
        return self.children[-1].eval(row)

    def sql(self) -> str:
        parts = ["CASE"]
        for i in range(self.n_branches):
            parts.append(f"WHEN {self.children[2*i].sql()} THEN {self.children[2*i+1].sql()}")
        parts.append(f"ELSE {self.children[-1].sql()} END")
        return " ".join(parts)


def _substring(s, pos, ln=None):
    """Spark substring window semantics: 1-based positive positions, 0
    treated as 1, negative positions count from the end — and when the
    window begins BEFORE the string (|pos| > length), the out-of-range
    prefix still consumes length: substring('abc', -5, 4) = 'ab'."""
    if s is None or pos is None:
        return None
    n = len(s)
    start0 = pos - 1 if pos > 0 else (n + pos if pos < 0 else 0)
    end0 = n if ln is None else start0 + max(ln, 0)
    return s[max(start0, 0):max(end0, 0)]


def _to_date(s, fmt=None):
    import datetime as _dt

    if s is None:
        return None
    if isinstance(s, _dt.datetime):
        return s.date()
    if isinstance(s, _dt.date):
        return s
    try:
        if fmt is None:
            return _dt.date.fromisoformat(str(s)[:10])
        return _dt.datetime.strptime(str(s), java_fmt_to_strftime(fmt)).date()
    except ValueError:
        return None  # Spark's to_date returns NULL on unparseable input


def _as_date(d):
    import datetime as _dt

    if isinstance(d, _dt.datetime):
        return d.date()
    if isinstance(d, _dt.date):
        return d
    return _dt.date(1970, 1, 1) + _dt.timedelta(days=int(d))


def _date_add(d, n, sign=1):
    import datetime as _dt

    if d is None or n is None:
        return None
    return _as_date(d) + _dt.timedelta(days=sign * int(n))


def _datediff(a, b):
    if a is None or b is None:
        return None
    return (_as_date(a) - _as_date(b)).days


def _pad(s, n, pad, left: bool):
    if s is None or n is None:
        return None
    n = int(n)
    if n <= 0:
        return ""
    if len(s) >= n:
        return s[:n]  # Spark truncates to the target width
    if not pad:
        return s
    fill = (pad * n)[: n - len(s)]
    return fill + s if left else s + fill


def _pow(x, y):
    if x is None or y is None:
        return None
    try:
        r = float(x) ** float(y)
    except ZeroDivisionError:
        return math.inf  # 0 ** negative: IEEE (and Spark/Arrow) say inf
    except OverflowError:
        return math.inf
    if isinstance(r, complex):
        return math.nan  # negative base, fractional exponent (IEEE pow)
    return r


_WIDE = _decimal.Context(prec=800)


def _round_half_up(x, n=0):
    """Spark's ``round``: half away from zero at ``n`` fractional digits
    (``RoundingMode.HALF_UP``), a double taken at its shortest decimal form
    as ``BigDecimal(double)`` takes it (``round(2.675, 2)`` is 2.68); the
    type kept. ``bround`` is the half-even one."""
    if x is None or n is None:
        return None
    n = int(n)
    if isinstance(x, bool):
        return x
    if isinstance(x, float):
        if not math.isfinite(x):
            return x
        d = _decimal.Decimal(repr(x))
    elif isinstance(x, int):
        if n >= 0:
            return x
        d = _decimal.Decimal(x)
    elif isinstance(x, _decimal.Decimal):
        d = x
    else:
        return round(x, n)
    if d.as_tuple().exponent >= -n:
        return x
    q = d.quantize(_decimal.Decimal(1).scaleb(-n), _decimal.ROUND_HALF_UP, context=_WIDE)
    if isinstance(x, float):
        return float(q)
    return int(q) if isinstance(x, int) else q


def _log(*args):
    if any(a is None for a in args):
        return None
    if len(args) == 1:
        return math.log(args[0]) if args[0] > 0 else None
    base, x = args
    if x <= 0 or base <= 0 or base == 1:
        return None  # Spark yields NULL outside the domain
    return math.log(x, base)


class Func(Expression):
    """Named scalar function — the engine's analogue of the reference's
    generated-column whitelist (``SupportedGenerationExpressions.scala``).
    Exact (row) semantics live here; the host and device evaluators vectorize
    the subset they can reproduce bit-for-bit and fall back otherwise."""

    FUNCS: Dict[str, Callable[..., Any]] = {
        "abs": lambda x: None if x is None else abs(x),
        "length": lambda x: None if x is None else len(x),
        "lower": lambda x: None if x is None else str(x).lower(),
        "upper": lambda x: None if x is None else str(x).upper(),
        "trim": lambda x: None if x is None else str(x).strip(" "),
        "concat": lambda *xs: None if any(x is None for x in xs) else "".join(str(x) for x in xs),
        "substring": _substring,
        "substr": _substring,
        "year": lambda d: None if d is None else _epoch_day_field(d, "year"),
        "month": lambda d: None if d is None else _epoch_day_field(d, "month"),
        "day": lambda d: None if d is None else _epoch_day_field(d, "day"),
        "hour": lambda t: None if t is None else ((t // 3_600_000_000) % 24),
        "minute": lambda t: None if t is None else ((t // 60_000_000) % 60),
        "second": lambda t: None if t is None else ((t // 1_000_000) % 60),
        "floor": lambda x: None if x is None else math.floor(x),
        "ceil": lambda x: None if x is None else math.ceil(x),
        "round": _round_half_up,
        "to_date": _to_date,
        "date_add": _date_add,
        "date_sub": lambda d, n: _date_add(d, n, sign=-1),
        "datediff": _datediff,
        "lpad": lambda s, n, pad=" ": _pad(s, n, pad, left=True),
        "rpad": lambda s, n, pad=" ": _pad(s, n, pad, left=False),
        "format_string": lambda fmt, *xs: (
            None if fmt is None or any(x is None for x in xs) else fmt % tuple(xs)
        ),
        "pow": lambda x, y: _pow(x, y),
        "power": lambda x, y: _pow(x, y),
        "exp": lambda x: None if x is None else math.exp(x),
        "log": _log,
        "sqrt": lambda x: None if x is None else (math.sqrt(x) if x >= 0 else None),
    }

    def __init__(self, name: str, args: Sequence[Expression]):
        self.name = name.lower()
        if self.name not in self.FUNCS:
            raise errors.unsupported_function(name)
        self.children = tuple(args)

    def eval(self, row):
        return self.FUNCS[self.name](*(a.eval(row) for a in self.children))

    def sql(self) -> str:
        return f"{self.name}({', '.join(a.sql() for a in self.children)})"


def _epoch_day_field(days: Any, field: str) -> Optional[int]:
    import datetime as _dt

    if isinstance(days, _dt.date):
        d = days
    else:
        d = _dt.date(1970, 1, 1) + _dt.timedelta(days=int(days))
    return getattr(d, field)


_JAVA_FMT = {
    "yyyy": "%Y", "yy": "%y", "MM": "%m", "dd": "%d",
    "HH": "%H", "mm": "%M", "ss": "%S",
}


def java_fmt_to_strftime(fmt: str) -> str:
    """Translate the common subset of Java SimpleDateFormat patterns (what
    the reference's to_date/unix_timestamp take) into strftime. Unknown
    letter runs raise — silently misparsing dates corrupts data."""
    out: List[str] = []
    i = 0
    while i < len(fmt):
        c = fmt[i]
        if c.isalpha():
            j = i
            while j < len(fmt) and fmt[j] == c:
                j += 1
            run = fmt[i:j]
            if run not in _JAVA_FMT:
                raise errors.unsupported_function(f"to_date format token {run!r}")
            out.append(_JAVA_FMT[run])
            i = j
        else:
            out.append(c)
            i += 1
    return "".join(out)

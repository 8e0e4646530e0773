"""Nested column values (struct, list, map) as numpy, and the stored types
of leaf values.

:class:`NCol` is one column of ``n`` slots in Arrow's layout: a leaf holds
numpy values and a validity mask, a struct one NCol a field over the same
slots, a list or map int64 offsets into an element NCol (a map's element is
a struct of key and value). The Parquet codec decodes into it and writes
from it (``exec/parquet``: Dremel levels), the host table carries it as a
``nested`` column (``expr/vectorized``), and the operations a table needs
(``take``, ``concat``, a slice, the Python values) run over whole arrays:
a list's elements are gathered with one ``np.repeat``, never a loop over
rows.

A column's type (its "spec") is a leaf's stored type (``int64``,
``string``, ``decimal128(10, 2)``, ...), ``("struct", ((name, spec),
...))``, ``("list", spec)`` or ``("map", key spec, value spec)``.
"""
from __future__ import annotations

import datetime as _dt
import decimal as _decimal
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["NCol", "leaf_kind", "decimal_ps", "decimal_type", "to_decimal", "ncol_from_py",
           "ncol_nulls", "embed", "concat", "spec_string"]

_EPOCH_DAY = _dt.date(1970, 1, 1)
_EPOCH_TS = _dt.datetime(1970, 1, 1)
_DEC_RE = re.compile(r"decimal(?:128|256)\((\d+), (-?\d+)\)$")
#: exact for every unscaled value of 38 digits at any scale
_EXACT = _decimal.Context(prec=80)

_LEAF_KINDS = {"bool": "bool", "int8": "int", "int16": "int", "int32": "int", "int64": "int",
               "float32": "double", "float64": "double", "string": "str", "binary": "object",
               "date32": "date", "timestamp[us]": "ts", "timestamp[us, tz=UTC]": "ts"}


def decimal_type(precision: int, scale: int) -> str:
    """The stored type of ``decimal(precision, scale)``, as Arrow names it
    (``decimal256`` past 38 digits: only an expression's value, never a
    column of a table)."""
    return f"decimal{128 if precision <= 38 else 256}({precision}, {scale})"


def decimal_ps(stype: Any) -> Optional[Tuple[int, int]]:
    """(precision, scale) of a decimal stored type, else None."""
    m = _DEC_RE.match(stype) if isinstance(stype, str) else None
    return (int(m.group(1)), int(m.group(2))) if m else None


def leaf_kind(stype: str) -> str:
    """The host kind of a leaf stored type (``KeyError`` for an unknown
    one)."""
    if decimal_ps(stype) is not None:
        return "decimal"
    return _LEAF_KINDS[stype]


def to_decimal(unscaled: int, scale: int) -> _decimal.Decimal:
    """An unscaled integer as the ``Decimal`` Arrow gives (``scale``
    fractional digits, exact)."""
    return _decimal.Decimal(int(unscaled)).scaleb(-scale, context=_EXACT)


def _leaf_dtype(stype: str):
    kind = leaf_kind(stype)
    if kind == "decimal":
        return np.int64 if decimal_ps(stype)[0] <= 18 else object
    return {"bool": bool, "double": np.float64, "str": object, "object": object}.get(
        kind, np.int64)


def _empty_values(stype: str, n: int) -> np.ndarray:
    dt = _leaf_dtype(stype)
    if dt is object:
        out = np.empty(n, object)
        if leaf_kind(stype) == "decimal":
            out.fill(0)
        return out
    return np.zeros(n, dt)


def spec_string(spec) -> str:
    """A spec as Arrow prints the type (``struct<x: int64, y: string>``)."""
    if isinstance(spec, str):
        return spec
    if spec[0] == "struct":
        return "struct<" + ", ".join(f"{n}: {spec_string(s)}" for n, s in spec[1]) + ">"
    if spec[0] == "list":
        return f"list<element: {spec_string(spec[1])}>"
    return f"map<{spec_string(spec[1])}, {spec_string(spec[2])}>"


class NCol:
    """A decoded (or to be written) column of ``n`` slots.

    ``kind`` is ``"leaf"`` (``values``: numpy, object for strings and
    binary, zero or None where invalid; ``stype`` the stored type),
    ``"struct"`` (``fields``: name -> NCol over the same slots), ``"list"``
    (``offsets``: int64 ``(n + 1,)``, ``element``: NCol over the elements)
    or ``"map"`` (as a list, ``element`` a struct whose first field is the
    key and whose second is the value). ``valid`` is the slot's validity.
    ``unsupported`` names what the codec lacks where a leaf could not be
    decoded (its values are then unavailable, its validity is exact).

    Indexing with an integer array, a boolean mask or a slice gives the
    NCol of those slots, so a table takes and slices a nested column as it
    does a numpy lane."""

    __slots__ = ("kind", "valid", "values", "stype", "fields", "offsets", "element",
                 "unsupported")

    def __init__(self, kind, valid, values=None, stype=None, fields=None, offsets=None,
                 element=None, unsupported=None):
        self.kind, self.valid, self.values, self.stype = kind, valid, values, stype
        self.fields, self.offsets, self.element = fields, offsets, element
        self.unsupported = unsupported

    def __len__(self) -> int:
        return len(self.valid)

    def field(self, name: str) -> Optional["NCol"]:
        return self.fields.get(name) if self.kind == "struct" else None

    def __getitem__(self, key) -> "NCol":
        if isinstance(key, slice):
            return self.take(np.arange(len(self))[key])
        idx = np.asarray(key)
        if idx.dtype == bool:
            idx = np.flatnonzero(idx)
        return self.take(idx)

    def take(self, idx) -> "NCol":
        """The slots ``idx`` (in that order, repeats allowed)."""
        idx = np.asarray(idx, np.int64)
        valid = self.valid[idx]
        if self.kind == "leaf":
            vals = None if self.values is None else self.values[idx]
            return NCol("leaf", valid, values=vals, stype=self.stype,
                        unsupported=self.unsupported)
        if self.kind == "struct":
            return NCol("struct", valid, fields={k: c.take(idx) for k, c in self.fields.items()})
        lo, hi = self.offsets[idx], self.offsets[idx + 1]
        counts = hi - lo
        offsets = np.zeros(len(idx) + 1, np.int64)
        np.cumsum(counts, out=offsets[1:])
        elems = np.repeat(lo - offsets[:-1], counts) + np.arange(offsets[-1], dtype=np.int64)
        return NCol(self.kind, valid, offsets=offsets, element=self.element.take(elems))

    def to_py(self, rows=None, typed: bool = False) -> List[Any]:
        """Python values of the slots (all, or ``rows``): None where
        invalid, a dict for a struct, a list for a list. A map is a dict
        (the first of equal keys kept, as ``pyarrow``'s map lookup), dates
        and timestamps epoch days and µs, decimals unscaled; ``typed``
        gives what ``pyarrow``'s ``to_pylist`` gives instead: a map as its
        list of ``(key, value)`` pairs, ``date``, ``datetime`` and
        ``Decimal``."""
        idx = np.arange(len(self)) if rows is None else np.asarray(rows, np.int64)
        ok = self.valid[idx]
        if self.kind == "leaf":
            if self.unsupported:
                if ok.any():
                    raise NotImplementedError(
                        f"Parquet column {self.unsupported[0]!r}: {self.unsupported[1]} is not "
                        "supported by the port's Parquet codec")
                return [None] * len(idx)
            vals = self.values[idx].tolist()
            if typed:
                vals = [_typed_leaf(self.stype, v) if k else None
                        for v, k in zip(vals, ok.tolist())]
            return [v if k else None for v, k in zip(vals, ok.tolist())]
        if self.kind == "struct":
            cols = {k: c.to_py(idx, typed) for k, c in self.fields.items()}
            names = list(cols)
            return [({k: cols[k][i] for k in names} if ok[i] else None)
                    for i in range(len(idx))]
        lo, hi = self.offsets[idx], self.offsets[idx + 1]
        counts = hi - lo
        starts = np.zeros(len(idx) + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        flat_rows = np.repeat(lo - starts[:-1], counts) + np.arange(starts[-1], dtype=np.int64)
        flat = self.element.to_py(flat_rows, typed)
        out: List[Any] = []
        keys = list(self.element.fields) if self.kind == "map" else None
        for i, k in enumerate(ok.tolist()):
            part = flat[starts[i]:starts[i + 1]]
            if not k:
                out.append(None)
            elif self.kind == "list":
                out.append(part)
            elif typed:
                out.append([(kv[keys[0]], kv[keys[1]]) for kv in part])
            else:
                d: Dict[Any, Any] = {}
                for kv in part:
                    d.setdefault(kv[keys[0]], kv[keys[1]])
                out.append(d)
        return out


def _typed_leaf(stype: str, v):
    ps = decimal_ps(stype)
    if ps is not None:
        return to_decimal(v, ps[1])
    if stype == "date32":
        return _EPOCH_DAY + _dt.timedelta(days=int(v))
    if stype.startswith("timestamp"):
        return _EPOCH_TS + _dt.timedelta(microseconds=int(v))
    return v


def concat(cols: Sequence[NCol]) -> NCol:
    """The slots of ``cols`` one after another (one spec)."""
    first = cols[0]
    valid = np.concatenate([c.valid for c in cols])
    if first.kind == "leaf":
        parts = [c.values for c in cols]
        if any(p.dtype == object for p in parts):
            parts = [p.astype(object) for p in parts]
        return NCol("leaf", valid, values=np.concatenate(parts), stype=first.stype,
                    unsupported=next((c.unsupported for c in cols if c.unsupported), None))
    if first.kind == "struct":
        return NCol("struct", valid, fields={k: concat([c.fields[k] for c in cols])
                                             for k in first.fields})
    base = np.cumsum([0] + [int(c.offsets[-1]) for c in cols[:-1]])
    offsets = np.concatenate([[0]] + [c.offsets[1:] + b for c, b in zip(cols, base)])
    return NCol(first.kind, valid, offsets=offsets.astype(np.int64),
                element=concat([c.element for c in cols]))


def ncol_nulls(spec, n: int) -> NCol:
    """``n`` NULL slots of ``spec``."""
    valid = np.zeros(n, bool)
    if isinstance(spec, str):
        return NCol("leaf", valid, values=_empty_values(spec, n), stype=spec)
    if spec[0] == "struct":
        return NCol("struct", valid, fields={name: ncol_nulls(s, n) for name, s in spec[1]})
    element = (ncol_nulls(spec[1], 0) if spec[0] == "list" else
               NCol("struct", np.zeros(0, bool), fields={"key": ncol_nulls(spec[1], 0),
                                                         "value": ncol_nulls(spec[2], 0)}))
    return NCol(spec[0], valid, offsets=np.zeros(n + 1, np.int64), element=element)


def reshape(col: NCol, src, dst) -> Optional[NCol]:
    """``col`` (of spec ``src``) as spec ``dst`` where ``dst`` differs only
    by struct fields that ``col`` lacks, at any depth: those read NULL, and
    the fields take ``dst``'s names and order (matched case-insensitively),
    as Arrow's cast of a struct to a wider struct does on a write and on a
    read of a file older than an evolved schema. None where ``dst`` drops
    a field or changes a leaf type."""
    if src == dst:
        return col
    if isinstance(src, str) or isinstance(dst, str) or src[0] != dst[0]:
        return None
    if src[0] == "struct":
        have = {name.lower(): (name, s) for name, s in src[1]}
        if len(have) != len(src[1]) or not set(have) <= {n.lower() for n, _ in dst[1]}:
            return None
        fields = {}
        for name, s in dst[1]:
            hit = have.get(name.lower())
            sub = ncol_nulls(s, len(col)) if hit is None else reshape(col.fields[hit[0]],
                                                                      hit[1], s)
            if sub is None:
                return None
            fields[name] = sub
        return NCol("struct", col.valid, fields=fields)
    if src[0] == "list":
        element = reshape(col.element, src[1], dst[1])
    else:
        (kname, key), (vname, value) = col.element.fields.items()
        k, v = reshape(key, src[1], dst[1]), reshape(value, src[2], dst[2])
        element = (None if k is None or v is None else
                   NCol("struct", col.element.valid, fields={kname: k, vname: v}))
    if element is None:
        return None
    return NCol(src[0], col.valid, offsets=col.offsets, element=element)


def _leaf_from_py(spec: str, values: Sequence[Any], valid: np.ndarray) -> np.ndarray:
    n = len(values)
    kind = leaf_kind(spec)
    if kind == "decimal":
        scale = decimal_ps(spec)[1]
        ints = [0 if v is None else _unscaled(v, scale) for v in values]
        return np.array(ints, _leaf_dtype(spec)) if n else _empty_values(spec, 0)
    if kind in ("str", "object"):
        arr = np.empty(n, object)
        arr[:] = list(values)
        return arr
    if kind in ("date", "ts"):
        values = [_epoch(v) for v in values]
    np_dt = {"bool": bool, "double": np.float64}.get(kind, np.int64)
    return np.fromiter((0 if v is None else v for v in values), np_dt, n)


def _epoch(v):
    if isinstance(v, _dt.datetime):
        if v.tzinfo is not None:
            v = v.astimezone(_dt.timezone.utc).replace(tzinfo=None)
        return (v - _EPOCH_TS) // _dt.timedelta(microseconds=1)
    if isinstance(v, _dt.date):
        return (v - _EPOCH_DAY).days
    return v


def _unscaled(v, scale: int) -> int:
    """An int or a ``Decimal`` as an unscaled integer at ``scale`` (a
    ``Decimal`` with more fractional digits truncates toward zero, as
    Arrow's unsafe rescale does). A float raises, as Arrow's conversion
    does: its digits past the 16th are not the value's."""
    if isinstance(v, bool) or not isinstance(v, (int, _decimal.Decimal)):
        raise TypeError(f"int or Decimal object expected, got {type(v).__name__}")
    if isinstance(v, int):
        return v * 10 ** scale if scale >= 0 else v // 10 ** -scale
    d = v.scaleb(scale, context=_EXACT)
    return int(d.to_integral_value(rounding=_decimal.ROUND_DOWN, context=_EXACT))


def ncol_from_py(spec, values: Sequence[Any]) -> NCol:
    """An NCol of ``spec`` from Python values (None, dicts for structs,
    dicts or lists of pairs for maps, lists for lists; dates, datetimes or
    epoch days and µs; for a decimal leaf ``Decimal``s or ints (whole
    numbers), cut to its scale toward zero)."""
    n = len(values)
    valid = np.fromiter((v is not None for v in values), bool, n)
    if isinstance(spec, str):
        return NCol("leaf", valid, values=_leaf_from_py(spec, values, valid), stype=spec)
    kind = spec[0]
    if kind == "struct":
        return NCol("struct", valid, fields={
            name: ncol_from_py(cspec, [None if v is None else v.get(name) for v in values])
            for name, cspec in spec[1]})
    items: List[Any] = []
    offs = np.zeros(n + 1, np.int64)
    for i, v in enumerate(values):
        if v is not None:
            items.extend(v.items() if kind == "map" and isinstance(v, dict) else v)
        offs[i + 1] = len(items)
    if kind == "list":
        return NCol("list", valid, offsets=offs, element=ncol_from_py(spec[1], items))
    kv = NCol("struct", np.ones(len(items), bool), fields={
        "key": ncol_from_py(spec[1], [k for k, _ in items]),
        "value": ncol_from_py(spec[2], [x for _, x in items])})
    return NCol("map", valid, offsets=offs, element=kv)


def embed(col: NCol, rows: np.ndarray, n: int) -> NCol:
    """``col`` (``len(rows)`` slots) placed at the ascending ``rows`` of
    ``n`` slots, null elsewhere."""
    valid = np.zeros(n, bool)
    valid[rows] = col.valid
    if col.kind == "leaf":
        vals = np.empty(n, object) if col.values.dtype == object else np.zeros(n, col.values.dtype)
        vals[rows] = col.values
        return NCol("leaf", valid, values=vals, stype=col.stype)
    if col.kind == "struct":
        return NCol("struct", valid, fields={k: embed(c, rows, n) for k, c in col.fields.items()})
    counts = np.zeros(n, np.int64)
    counts[rows] = np.diff(col.offsets)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return NCol(col.kind, valid, offsets=offsets, element=col.element)

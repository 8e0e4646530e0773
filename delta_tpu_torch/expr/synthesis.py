"""Predicate pushdown synthesis — sound min/max rewrites for arithmetic,
string, and temporal predicates over the stats environment (the port's own
copy of ``delta_tpu.expr.synthesis``; the shape helpers and the rewrite
rules are the same, so both packages rewrite a conjunct identically).

``ops/pruning.skipping_predicate`` handles the directly min/max-evaluable
shapes (``col op literal``, IN, null tests, StartsWith); everything else
used to rewrite to UNKNOWN, so ``price * qty > 1000`` or
``substr(id, 1, 4) = 'us-w'`` paid full scans even on perfectly laid-out
tables — and the workload journal proved it (``neverPruned`` fingerprints
with reason "shape"). Following "Optimal Predicate Pushdown Synthesis"
(PAPERS.md), this module synthesizes *can-match* over-approximations for
three families:

* **arithmetic** — interval arithmetic over per-column ``[min.c, max.c]``
  bounds for Add/Sub/Mul/Div/Mod/Neg. Single-column chains invert exactly
  (``price * 2 + 10 >= L`` → ``price >= (L-10)/2``), so the rewrite stays a
  plain lane comparison the resident device planner lowers to ranges and
  serves from HBM. Multi-column trees expand to endpoint-candidate
  comparisons: ``UB(price·qty) > L`` ≡ *any* of the four endpoint products
  ``> L`` (interval multiplication; a negative factor flips the interval
  implicitly because all four endpoint combinations participate). The
  candidates evaluate in float64 (int64 products can overflow the host's
  wrapping kernels; float64 overflow saturates monotonically) against an
  OUTWARD-relaxed literal, so rounding can only KEEP extra files, never
  drop a match. Division by an expression whose interval may contain zero
  is UNKNOWN; ``x % c`` bounds to ``[-|c|, |c|]`` (covers both Python int
  and fmod sign conventions); arithmetic with a NULL literal can never
  match and rewrites to FALSE.
* **string** — prefix-preserving ops: ``substr(c, 1, k) op lit`` (prefix
  truncation is monotone non-strict in code-point order, so
  ``substr_k(min.c) <= substr_k(x) <= substr_k(max.c)``), ``LIKE``
  patterns via their longest literal prefix (→ the StartsWith rule), and
  wildcard-free LIKE → Eq. Inherits the file tier's truncated-bounds
  conservatism: stats lanes the engine cannot trust (binary / absent)
  evaluate NULL and keep.
* **conditional / abs / col-vs-col** — ``abs(x) op v`` decomposes exactly
  into its two signed comparisons (Or for the upper tests, And for the
  lower); ``coalesce``/``CASE WHEN`` compare via the disjunction of their
  branch values' can-matches (conditions ignored — over-approximate, never
  unsound); ``a < b`` between two data columns excludes when
  ``min.a >= max.b`` — gated to integer/decimal/temporal lanes because
  float lanes are NaN-blind and string bounds may be truncated (the same
  conservatism as the NOT flip).
* **temporal / cast** — monotone shapes only: numeric widening casts
  (identity up to float64 rounding, covered by the relaxation),
  integer-truncation casts (``|x - trunc(x)| < 1`` → bounds padded by one
  unit), ``year(c)`` and ``to_date(ts)`` (truncations, monotone
  non-strict), and ``date_add/date_sub(c, n)`` (shift inverted exactly at
  synthesis time). Narrowing or non-monotone shapes — ``month``/``day``/
  ``hour``, string→numeric casts (string order is not numeric order) —
  stay UNKNOWN.

Soundness contract (the same Kleene story both pruning tiers share): a
rewrite may evaluate to False only when NO row of the file/row-group can
satisfy the original predicate; any unknowable input — missing stats, a
NULL branch, a failed type gate, an arithmetic error — yields NULL = keep.
Every rule needs the column's declared type (``types`` maps lowercased
names to schema DataTypes): without it, string columns could leak into
arithmetic (Python would happily concatenate ``min.a + min.b``) or a
string→long cast could be mistaken for monotone. ``types=None`` disables
synthesis entirely. The property harness in ``tests/test_synthesis.py``
drives seeded random predicates over random tables asserting a synthesized
prune never drops a file or row group containing a matching row.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, FrozenSet, List, Optional, Tuple

from delta_tpu_torch.expr import ir
from delta_tpu_torch.schema.types import (
    ByteType,
    DataType,
    DateType,
    DecimalType,
    DoubleType,
    FloatType,
    IntegerType,
    LongType,
    ShortType,
    StringType,
    TimestampType,
)

__all__ = ["synthesize", "shape", "can_exclude", "classify_family",
           "schema_types", "UNKNOWN"]

UNKNOWN = ir.Literal(None)

_NUM_TYPES = (ByteType, ShortType, IntegerType, LongType, FloatType,
              DoubleType, DecimalType)
_TEMPORAL_TYPES = (DateType, TimestampType)

#: Relative literal relaxation covering float64 rounding of synthesized
#: arithmetic chains (a few ulps per op; 1e-9 over-covers by ~1e6x — the
#: cost is keeping a boundary file pruning could have dropped, never the
#: reverse).
_REL_EPS = 1e-9

#: Candidate-set size cap for the interval expansion — a deeper Mul nest
#: would square it; past the cap the rewrite is UNKNOWN (keep).
_MAX_CANDS = 8

_Base = Callable[[ir.Expression], ir.Expression]


def schema_types(metadata) -> Dict[str, DataType]:
    """Lowercased column name → declared DataType, the type gate every
    synthesis rule needs (see module docstring)."""
    return {f.name.lower(): f.data_type for f in metadata.schema.fields}


# ---------------------------------------------------------------------------
# Shared shape/fingerprint helpers
# ---------------------------------------------------------------------------


def shape(expr: ir.Expression) -> str:
    """Normalized op shape of an IR expression: class names lowered, column
    names kept (lowercased), literals abstracted to ``?`` — so ``v = 5`` and
    ``v = 9`` share the fingerprint ``eq(v,?)`` while ``price * qty > 1000``
    keeps its arithmetic structure (``gt(mul(price,qty),?)``). Named
    functions render as their FUNCTION name (``substr(id,?,?)``), not the
    ``Func`` class — which function it is decides whether the shape is
    synthesizable, and the advisor's stale-history recognizer matches on
    these tokens. (Pre-r12 journal entries carry the old ``func(...)``
    rendering; the recognizer accepts both.)"""
    if isinstance(expr, ir.Column):
        return expr.name.lower()
    if isinstance(expr, ir.Literal):
        return "?"
    name = (expr.name if isinstance(expr, ir.Func)
            else type(expr).__name__.lower())
    kids = ",".join(shape(c) for c in expr.children)
    return f"{name}({kids})"


def can_exclude(rewritten: ir.Expression) -> bool:
    """Can a skipping rewrite ever evaluate to False — i.e. actually exclude
    a file/row group? ``skipping_predicate`` returns ``Literal(None)``
    (= keep) for unsupported shapes, but And/Or recurse, so an unsupported
    disjunction comes back as ``Or(NULL, NULL)``, not a bare NULL root.
    Three-valued logic: an OR excludes only when BOTH branches can, an AND
    through either; a constant leaf never depends on stats."""
    if isinstance(rewritten, ir.Literal):
        # Literal(False) CAN exclude (e.g. `col = NULL` matches nothing);
        # NULL / TRUE leaves never do
        return rewritten.value is False
    if isinstance(rewritten, ir.And):
        return can_exclude(rewritten.left) or can_exclude(rewritten.right)
    if isinstance(rewritten, ir.Or):
        return can_exclude(rewritten.left) and can_exclude(rewritten.right)
    return True


_FAMILY_STRING = ("substr", "substring")
_FAMILY_TEMPORAL = ("year", "to_date", "date_add", "date_sub")
_FAMILY_ARITH_FUNCS = ("abs",)
_CMP_CLASSES = (ir.Eq, ir.Ne, ir.Lt, ir.Le, ir.Gt, ir.Ge)


def classify_family(expr: ir.Expression) -> str:
    """Coarse rewrite-family label for attribution (``ScanReport.
    rewritesFired`` / the advisor's mining): string > arithmetic >
    conditional > cast > colcol > not > other, by the ops present anywhere
    in the conjunct."""
    has_string = has_arith = has_cond = has_cast = has_colcol = False
    has_not = False
    for e in expr.walk():
        if isinstance(e, (ir.Like, ir.StartsWith)) or (
                isinstance(e, ir.Func) and e.name in _FAMILY_STRING):
            has_string = True
        elif isinstance(e, (ir.Add, ir.Sub, ir.Mul, ir.Div, ir.Mod, ir.Neg)) \
                or (isinstance(e, ir.Func) and e.name in _FAMILY_ARITH_FUNCS):
            has_arith = True
        elif isinstance(e, (ir.Coalesce, ir.CaseWhen)):
            has_cond = True
        elif isinstance(e, ir.Cast) or (
                isinstance(e, ir.Func) and e.name in _FAMILY_TEMPORAL):
            has_cast = True
        elif isinstance(e, _CMP_CLASSES) and isinstance(e.left, ir.Column) \
                and isinstance(e.right, ir.Column):
            has_colcol = True
        elif isinstance(e, ir.Not):
            has_not = True
    if has_string:
        return "string"
    if has_arith:
        return "arithmetic"
    if has_cond:
        return "conditional"
    if has_cast:
        return "cast"
    if has_colcol:
        return "colcol"
    if has_not:
        return "not"
    return "other"


# ---------------------------------------------------------------------------
# Internal control flow
# ---------------------------------------------------------------------------


class _Unknown(Exception):
    """No sound rewrite for this shape — caller keeps (UNKNOWN)."""


class _Never(Exception):
    """The predicate can never be True (NULL operand, division by a zero
    literal) — caller may rewrite to FALSE (exclude everything)."""


def _as_num(v: Any) -> Any:
    """Literal value as a Python number; bools/strings/None are not
    arithmetic operands here."""
    if v is None:
        raise _Never
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise _Unknown
    return v


def _relaxed(v: float, direction: int) -> float:
    """Move a comparison literal OUTWARD (direction -1 = down, +1 = up) by
    the float-rounding slack, so an inexact candidate chain can only keep
    extra files. Non-finite bounds pass through (inf - inf is a trap)."""
    try:
        f = float(v)
    except OverflowError:
        return math.inf if v > 0 else -math.inf
    if not math.isfinite(f):
        return f
    return f + direction * max(abs(f), 1.0) * _REL_EPS


def _fold(e: ir.Expression) -> ir.Expression:
    """Fold a negated numeric literal (the parser's unary minus) into a
    plain literal so the exact inversion path sees it as a constant."""
    if isinstance(e, ir.Neg) and isinstance(e.child, ir.Literal):
        v = e.child.value
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return ir.Literal(-v)
    return e


def _or_all(parts: List[ir.Expression]) -> ir.Expression:
    out = parts[0]
    for p in parts[1:]:
        out = ir.Or(out, p)
    return out


def _min(c: str) -> ir.Expression:
    return ir.Column(f"min.{c}")


def _max(c: str) -> ir.Expression:
    return ir.Column(f"max.{c}")


# ---------------------------------------------------------------------------
# Single-column inversion (exact; resident/device-lowerable output)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class _Bounds:
    """The inverted constraint ``col ∈ (lo, hi)`` accumulated while peeling
    a monotone chain; None = unbounded on that side. ``exact`` drops when a
    transform can round (then the emitted literals relax outward)."""

    lo: Optional[Any] = None
    hi: Optional[Any] = None
    lo_strict: bool = False
    hi_strict: bool = False
    exact: bool = True

    @staticmethod
    def from_cmp(t, v) -> "_Bounds":
        if t is ir.Gt:
            return _Bounds(lo=v, lo_strict=True)
        if t is ir.Ge:
            return _Bounds(lo=v)
        if t is ir.Lt:
            return _Bounds(hi=v, hi_strict=True)
        if t is ir.Le:
            return _Bounds(hi=v)
        if t is ir.Eq:
            return _Bounds(lo=v, hi=v)
        raise _Unknown

    def negate(self) -> "_Bounds":
        """x → -x: bounds swap and negate (exact)."""
        return _Bounds(
            lo=None if self.hi is None else -self.hi,
            hi=None if self.lo is None else -self.lo,
            lo_strict=self.hi_strict, hi_strict=self.lo_strict,
            exact=self.exact)

    def shift(self, d) -> "_Bounds":
        """x → x + d was peeled off: bounds shift by d."""
        exact = self.exact and isinstance(d, int)

        def add(v):
            if v is None:
                return None
            if not (isinstance(v, int) and isinstance(d, int)):
                nonlocal exact
                exact = False
            return v + d

        return replace(self, lo=add(self.lo), hi=add(self.hi), exact=exact)

    def scale_down(self, c) -> "_Bounds":
        """x → x * c was peeled off (c ≠ 0): bounds divide by c, order
        flipping for negative c."""
        b = self.negate().scale_down(-c) if c < 0 else self
        if c < 0:
            return b
        exact = b.exact

        def div(v):
            nonlocal exact
            if v is None:
                return None
            if isinstance(v, int) and isinstance(c, int) and v % c == 0:
                return v // c
            exact = False
            try:
                return v / c
            except OverflowError:
                raise _Unknown
        return replace(b, lo=div(b.lo), hi=div(b.hi), exact=exact)

    def scale_up(self, c) -> "_Bounds":
        """x → x / c was peeled off (c ≠ 0): bounds multiply by c. Never
        exact — the original evaluates FLOAT division of the row value, so
        its rounding must be covered by the relaxation either way."""
        b = self.negate().scale_up(-c) if c < 0 else self
        if c < 0:
            return b

        def mul(v):
            return None if v is None else v * c
        return replace(b, lo=mul(b.lo), hi=mul(b.hi), exact=False)

    def pad_unit(self) -> "_Bounds":
        """x → trunc(x) was peeled off: ``|x - trunc(x)| < 1`` widens both
        bounds by one unit (strictness drops — already a relaxation)."""
        return _Bounds(
            lo=None if self.lo is None else self.lo - 1,
            hi=None if self.hi is None else self.hi + 1,
            exact=self.exact)


def _emit_bounds(col: ir.Column, b: _Bounds, base: _Base) -> ir.Expression:
    """Lower the inverted constraint to base lane comparisons. Exact bounds
    keep their strictness (and int-ness: the resident range lowering stays
    exact); inexact ones relax outward and drop to non-strict."""
    if (b.exact and b.lo is not None and b.hi is not None
            and b.lo == b.hi and not b.lo_strict and not b.hi_strict):
        return base(ir.Eq(col, ir.Literal(b.lo)))
    parts: List[ir.Expression] = []
    if b.lo is not None:
        if b.exact:
            op = ir.Gt if b.lo_strict else ir.Ge
            parts.append(base(op(col, ir.Literal(b.lo))))
        else:
            parts.append(base(ir.Ge(col, ir.Literal(_relaxed(b.lo, -1)))))
    if b.hi is not None:
        if b.exact:
            op = ir.Lt if b.hi_strict else ir.Le
            parts.append(base(op(col, ir.Literal(b.hi))))
        else:
            parts.append(base(ir.Le(col, ir.Literal(_relaxed(b.hi, +1)))))
    if not parts:
        raise _Unknown
    out = parts[0]
    for p in parts[1:]:
        out = ir.And(out, p)
    return out


_WIDENING_CASTS = ("float", "double", "decimal")
_TRUNC_CASTS = ("byte", "short", "integer", "long")


def _invert_chain(e: ir.Expression, b: _Bounds,
                  pcols: FrozenSet[str], types: Dict[str, DataType],
                  base: _Base) -> ir.Expression:
    """Peel a single-column monotone chain, transforming the bound at each
    step; raises _Unknown on multi-column shapes (interval path takes over)
    and _Never when no row can match."""
    while True:
        if isinstance(e, ir.Column):
            if e.name.lower() in pcols:
                raise _Unknown  # partition columns have no stats lanes
            if not isinstance(types.get(e.name.lower()), _NUM_TYPES):
                raise _Unknown
            return _emit_bounds(e, b, base)
        if isinstance(e, ir.Neg):
            b, e = b.negate(), e.child
            continue
        if isinstance(e, (ir.Add, ir.Sub, ir.Mul, ir.Div)):
            l, r = _fold(e.left), _fold(e.right)
            lit = r if isinstance(r, ir.Literal) else (
                l if isinstance(l, ir.Literal) else None)
            if lit is None:
                raise _Unknown  # two expression operands: interval path
            other = l if lit is r else r
            c = _as_num(lit.value)
            if isinstance(e, ir.Add):
                b = b.shift(-c)
            elif isinstance(e, ir.Sub):
                # x - c cmp B ⇒ x cmp B + c; c - x cmp B ⇒ -x cmp B - c
                b = b.shift(c) if lit is r else b.shift(-c).negate()
            elif isinstance(e, ir.Mul):
                if c == 0:
                    # 0 * x ≡ 0 for every non-null row: constant verdict
                    raise _Unknown if _zero_satisfies(b) else _Never
                b = b.scale_down(c)
            else:  # Div
                if lit is l:
                    raise _Unknown  # c / x: sign of x unknowable statically
                if c == 0:
                    raise _Never  # x / 0 is NULL: never matches
                b = b.scale_up(c)
            e = other
            continue
        if isinstance(e, ir.Cast):
            name = (e.data_type.name
                    if not isinstance(e.data_type, DecimalType) else "decimal")
            # the chain must bottom out in a NUMERIC column (checked at the
            # Column leaf) for any of these to be monotone
            if name in _TRUNC_CASTS:
                b = b.pad_unit()
            elif name in _WIDENING_CASTS:
                b = replace(b, exact=False)  # float64 rounding
            else:
                raise _Unknown
            e = e.child
            continue
        raise _Unknown


def _zero_satisfies(b: _Bounds) -> bool:
    if b.lo is not None and (0 < b.lo or (0 == b.lo and b.lo_strict)):
        return False
    if b.hi is not None and (0 > b.hi or (0 == b.hi and b.hi_strict)):
        return False
    return True


# ---------------------------------------------------------------------------
# Multi-column interval expansion (float64 candidates; host + device evaluators)
# ---------------------------------------------------------------------------


def _cast_f64(e: ir.Expression) -> ir.Expression:
    return ir.Cast(e, DoubleType())


def _interval(e: ir.Expression, pcols: FrozenSet[str],
              types: Dict[str, DataType]
              ) -> Tuple[List[ir.Expression], List[ir.Expression]]:
    """(lo_candidates, hi_candidates) over stats lanes such that for every
    non-null row value v of ``e``: min(lo) <= v <= max(hi), and every
    candidate's value lies within [min(lo), max(hi)] (the invariant interval
    composition needs). Candidates evaluate in float64."""
    if isinstance(e, ir.Literal):
        v = _as_num(e.value)
        try:
            lit = ir.Literal(float(v))
        except OverflowError:
            raise _Unknown
        return [lit], [lit]
    if isinstance(e, ir.Column):
        if e.name.lower() in pcols:
            raise _Unknown
        if not isinstance(types.get(e.name.lower()), _NUM_TYPES):
            raise _Unknown
        return [_cast_f64(_min(e.name))], [_cast_f64(_max(e.name))]
    if isinstance(e, ir.Neg):
        lo, hi = _interval(e.child, pcols, types)
        return [ir.Neg(h) for h in hi], [ir.Neg(l) for l in lo]
    if isinstance(e, ir.Add):
        alo, ahi = _interval(e.left, pcols, types)
        blo, bhi = _interval(e.right, pcols, types)
        if len(alo) * len(blo) > _MAX_CANDS or len(ahi) * len(bhi) > _MAX_CANDS:
            raise _Unknown
        return ([ir.Add(x, y) for x in alo for y in blo],
                [ir.Add(x, y) for x in ahi for y in bhi])
    if isinstance(e, ir.Sub):
        alo, ahi = _interval(e.left, pcols, types)
        blo, bhi = _interval(e.right, pcols, types)
        if len(alo) * len(bhi) > _MAX_CANDS or len(ahi) * len(blo) > _MAX_CANDS:
            raise _Unknown
        return ([ir.Sub(x, y) for x in alo for y in bhi],
                [ir.Sub(x, y) for x in ahi for y in blo])
    if isinstance(e, ir.Mul):
        alo, ahi = _interval(e.left, pcols, types)
        blo, bhi = _interval(e.right, pcols, types)
        a_m = _members(alo, ahi)
        b_m = _members(blo, bhi)
        if len(a_m) * len(b_m) > _MAX_CANDS:
            raise _Unknown
        prods = [ir.Mul(x, y) for x in a_m for y in b_m]
        # the four (or more) endpoint products: the interval's lo is their
        # min and hi their max — one candidate set serves both sides, and a
        # negative factor's flip falls out of taking all combinations
        return prods, list(prods)
    if isinstance(e, ir.Div):
        divisor = _fold(e.right)
        if not isinstance(divisor, ir.Literal):
            raise _Unknown  # divisor interval may cross zero: UNKNOWN
        c = _as_num(divisor.value)
        if c == 0:
            raise _Never
        lo, hi = _interval(e.left, pcols, types)
        lit = ir.Literal(float(c))
        if c < 0:
            lo, hi = hi, lo
        return ([ir.Div(x, lit) for x in lo], [ir.Div(x, lit) for x in hi])
    if isinstance(e, ir.Mod):
        divisor = _fold(e.right)
        if not isinstance(divisor, ir.Literal):
            raise _Unknown
        c = _as_num(divisor.value)
        if c == 0:
            raise _Never
        # int %: result in [0, |c|) or (-|c|, 0] by divisor sign; float
        # fmod: sign follows the DIVIDEND — [-|c|, |c|] covers every
        # combination the engine's Mod can produce. Gate the dividend like
        # any operand (types/partition checks) even though its bounds drop.
        _interval(e.left, pcols, types)
        return [ir.Literal(-abs(float(c)))], [ir.Literal(abs(float(c)))]
    if isinstance(e, ir.Cast):
        name = (e.data_type.name
                if not isinstance(e.data_type, DecimalType) else "decimal")
        lo, hi = _interval(e.child, pcols, types)
        if name in _TRUNC_CASTS:
            one = ir.Literal(1.0)
            return ([ir.Sub(x, one) for x in lo], [ir.Add(x, one) for x in hi])
        if name in _WIDENING_CASTS:
            return lo, hi  # float64 rounding is inside the relaxation
        raise _Unknown
    if isinstance(e, ir.Func) and e.name == "abs" and len(e.children) == 1:
        lo, hi = _interval(e.children[0], pcols, types)
        m = _members(lo, hi)
        if len(m) + 1 > _MAX_CANDS:
            raise _Unknown
        wrapped = [ir.Func("abs", [x]) for x in m]
        # the child interval may span zero, where |v| bottoms out at 0 even
        # though every |endpoint| is large — the 0 lower candidate is what
        # keeps the composed interval sound. The endpoint achieving the
        # child's min (resp. max) is a member, so max(|members|) covers the
        # true upper bound.
        return [ir.Literal(0.0)] + wrapped, wrapped
    raise _Unknown


def _members(lo: List[ir.Expression], hi: List[ir.Expression]) -> List[ir.Expression]:
    out: List[ir.Expression] = []
    seen = set()
    for x in lo + hi:
        if x not in seen:
            seen.add(x)
            out.append(x)
    return out


def _cand_side(cands: List[ir.Expression], cmp_cls,
               lit: ir.Literal) -> Any:
    """One Or-side of the interval comparison, with constant candidates
    (Mod bounds, folded literals) resolved statically: returns True (the
    side is trivially satisfied — no exclusion possible through it), False
    (no candidate can satisfy it — the side excludes everything), or the
    Or expression over the non-constant candidates."""
    branches: List[ir.Expression] = []
    for c in cands:
        if isinstance(c, ir.Literal) and isinstance(c.value, float):
            ok = (c.value >= lit.value if cmp_cls is ir.Ge
                  else c.value <= lit.value)
            if ok:
                return True
            continue
        branches.append(cmp_cls(c, lit))
    if not branches:
        return False
    return _or_all(branches)


def _interval_cmp(t, expr_side: ir.Expression, lit_value: Any,
                  pcols: FrozenSet[str],
                  types: Dict[str, DataType]) -> ir.Expression:
    v = _as_num(lit_value)
    lo, hi = _interval(expr_side, pcols, types)
    lo_lit = ir.Literal(_relaxed(v, +1))   # LB <= v+eps tests
    hi_lit = ir.Literal(_relaxed(v, -1))   # UB >= v-eps tests
    if t in (ir.Gt, ir.Ge):
        # can-match: UB >= v (strictness absorbed by the relaxation); UB is
        # max(hi) so "any candidate >= v-eps"
        side = _cand_side(hi, ir.Ge, hi_lit)
    elif t in (ir.Lt, ir.Le):
        side = _cand_side(lo, ir.Le, lo_lit)
    elif t is ir.Eq:
        a = _cand_side(lo, ir.Le, lo_lit)
        b = _cand_side(hi, ir.Ge, hi_lit)
        if a is False or b is False:
            raise _Never
        if a is True:
            side = b
        elif b is True:
            side = a
        else:
            side = ir.And(a, b)
    else:
        raise _Unknown
    if side is True:
        raise _Unknown  # trivially satisfiable: nothing to exclude on
    if side is False:
        raise _Never
    return side


# ---------------------------------------------------------------------------
# Branch combinators + abs / conditional / col-vs-col rules
# ---------------------------------------------------------------------------


def _or_branches(thunks: List[Callable[[], ir.Expression]]) -> ir.Expression:
    """can-match of a disjunction of can-matches. A _Never branch is False
    and drops out; _Unknown propagates (one might-match branch makes the
    whole OR unbounded — nothing stats can exclude); every branch impossible
    → _Never."""
    parts: List[ir.Expression] = []
    for th in thunks:
        try:
            parts.append(th())
        except _Never:
            continue
    if not parts:
        raise _Never
    return _or_all(parts)


def _and_branches(thunks: List[Callable[[], ir.Expression]]) -> ir.Expression:
    """can-match conjunction: And(UNKNOWN, X) over-approximates soundly to
    X alone, a _Never branch propagates (the conjunction is impossible),
    all-UNKNOWN → _Unknown."""
    parts: List[ir.Expression] = []
    for th in thunks:
        try:
            parts.append(th())
        except _Unknown:
            continue
    if not parts:
        raise _Unknown
    out = parts[0]
    for p in parts[1:]:
        out = ir.And(out, p)
    return out


def _synth_abs(t, child: ir.Expression, lit: ir.Literal,
               pcols: FrozenSet[str], types: Dict[str, DataType],
               base: _Base) -> ir.Expression:
    """Exact logical decomposition of ``abs(x) op v``: the upper tests split
    into ``x > v OR x < -v``, the lower into ``x < v AND x > -v``, each side
    re-synthesized recursively — strictly stronger than the interval path
    for the lower/equality shapes, where abs's 0 lower candidate makes the
    interval trivially satisfiable."""
    v = _as_num(lit.value)

    def sub(cmp_cls, bound):
        return lambda: _synthesize(cmp_cls(child, ir.Literal(bound)),
                                   pcols, types, base)

    if t in (ir.Gt, ir.Ge):
        if v < 0 or (t is ir.Ge and v == 0):
            raise _Unknown  # trivially true for every non-null row
        return _or_branches([sub(t, v), sub(_CMP_FLIP[t], -v)])
    if t in (ir.Lt, ir.Le):
        if v < 0 or (t is ir.Lt and v == 0):
            raise _Never  # |x| below a non-positive bound: impossible
        return _and_branches([sub(t, v), sub(_CMP_FLIP[t], -v)])
    if t is ir.Eq:
        if v < 0:
            raise _Never
        if v == 0:
            return _synthesize(ir.Eq(child, ir.Literal(v)), pcols, types, base)
        return _or_branches([sub(ir.Eq, v), sub(ir.Eq, -v)])
    raise _Unknown


def _synth_branches(t, e: ir.Expression, lit: ir.Literal,
                    pcols: FrozenSet[str], types: Dict[str, DataType],
                    base: _Base) -> ir.Expression:
    """can-match for ``coalesce(...) op lit`` / ``CASE WHEN ... op lit``: a
    row's value is always one of the branch values (CaseWhen conditions and
    coalesce nullness ignored — a sound over-approximation), so the OR of
    per-branch can-matches covers every row. A literal branch resolves
    statically: satisfying → some row may take it and match (_Unknown — no
    stats lane can rule it out); NULL or non-satisfying → drops out."""
    if isinstance(e, ir.Coalesce):
        vals = list(e.children)
    else:  # CaseWhen children: (c1, v1, ..., default)
        vals = [e.children[2 * i + 1] for i in range(e.n_branches)]
        vals.append(e.children[-1])
    thunks: List[Callable[[], ir.Expression]] = []
    for b in vals:
        b = _fold(b)
        if isinstance(b, ir.Literal):
            if b.value is None:
                continue  # comparison against NULL can't match
            try:
                ok = t(b, lit).eval({})
            except Exception:  # noqa: BLE001 — incomparable literal pair
                raise _Unknown from None
            if ok is True:
                raise _Unknown
            continue
        thunks.append(lambda bb=b: _synthesize(t(bb, lit), pcols, types, base))
    if not thunks:
        raise _Never
    return _or_branches(thunks)


#: Col-vs-col comparisons trust BOTH lanes' min/max to bound actual row
#: values — the same hazard the NOT flip gates: float lanes are blind to
#: NaN rows, and string lanes may carry truncated bounds whose max
#: under-reports. Integer-family + decimal + (same-type) temporal only.
_COLCOL_SAFE_NUM = (ByteType, ShortType, IntegerType, LongType, DecimalType)


def _synth_colcol(t, l: ir.Column, r: ir.Column,
                  pcols: FrozenSet[str],
                  types: Dict[str, DataType]) -> ir.Expression:
    """``a < b`` can match only when ``min.a < max.b`` (some pair of row
    values can land in order), ``a = b`` only when the two stat intervals
    intersect. NULL/absent lanes evaluate NULL = keep (Kleene)."""
    la, ra = l.name.lower(), r.name.lower()
    if la in pcols or ra in pcols:
        raise _Unknown  # partition columns have no stats lanes
    ta, tb = types.get(la), types.get(ra)
    ok = ((isinstance(ta, _COLCOL_SAFE_NUM) and isinstance(tb, _COLCOL_SAFE_NUM))
          or (isinstance(ta, DateType) and isinstance(tb, DateType))
          or (isinstance(ta, TimestampType) and isinstance(tb, TimestampType)))
    if not ok:
        raise _Unknown
    if la == ra:
        if t in (ir.Lt, ir.Gt):
            raise _Never  # a < a matches no row
        raise _Unknown  # a <= a / a = a: true for every non-null row
    if t is ir.Lt:
        return ir.Lt(_min(l.name), _max(r.name))
    if t is ir.Le:
        return ir.Le(_min(l.name), _max(r.name))
    if t is ir.Gt:
        return ir.Gt(_max(l.name), _min(r.name))
    if t is ir.Ge:
        return ir.Ge(_max(l.name), _min(r.name))
    if t is ir.Eq:
        return ir.And(ir.Le(_min(l.name), _max(r.name)),
                      ir.Ge(_max(l.name), _min(r.name)))
    raise _Unknown


# ---------------------------------------------------------------------------
# String + temporal monotone wraps
# ---------------------------------------------------------------------------


def _wrap_cmp(t, wrap: Callable[[ir.Expression], ir.Expression],
              col: str, lit: ir.Literal) -> ir.Expression:
    """can-match for ``w(col) op lit`` with w monotone NON-STRICT:
    ``w(min.c) <= w(x) <= w(max.c)``, so an upper test needs only the max
    lane and a lower test only the min lane; strictness survives (if
    ``w(max) <= lit`` definitely, no row has ``w(x) > lit``)."""
    if t is ir.Eq:
        return ir.And(ir.Le(wrap(_min(col)), lit), ir.Ge(wrap(_max(col)), lit))
    if t in (ir.Gt, ir.Ge):
        return t(wrap(_max(col)), lit)
    if t in (ir.Lt, ir.Le):
        return t(wrap(_min(col)), lit)
    raise _Unknown


def _synth_substr(t, f: ir.Func, lit: ir.Literal,
                  types: Dict[str, DataType],
                  pcols: FrozenSet[str], base: _Base) -> ir.Expression:
    args = f.children
    if not (args and isinstance(args[0], ir.Column)):
        raise _Unknown
    col = args[0]
    if col.name.lower() in pcols:
        raise _Unknown
    if not isinstance(types.get(col.name.lower()), StringType):
        raise _Unknown
    if lit.value is None:
        raise _Never
    if not isinstance(lit.value, str):
        raise _Unknown
    pos = args[1] if len(args) > 1 else None
    if not (isinstance(pos, ir.Literal) and isinstance(pos.value, int)
            and not isinstance(pos.value, bool) and pos.value in (0, 1)):
        raise _Unknown  # only position-1 prefixes are monotone
    if len(args) == 2:
        # substr(c, 1) is the identity: the base rules take it whole
        return base(t(col, lit))
    k = args[2]
    if not (isinstance(k, ir.Literal) and isinstance(k.value, int)
            and not isinstance(k.value, bool) and k.value >= 0):
        raise _Unknown

    def wrap(x: ir.Expression) -> ir.Expression:
        return ir.Func("substr", [x, ir.Literal(1), ir.Literal(k.value)])

    return _wrap_cmp(t, wrap, col.name, lit)


def _synth_temporal(t, f: ir.Func, lit: ir.Literal,
                    types: Dict[str, DataType],
                    pcols: FrozenSet[str], base: _Base) -> ir.Expression:
    args = f.children
    if not (args and isinstance(args[0], ir.Column)):
        raise _Unknown
    col = args[0]
    if col.name.lower() in pcols:
        raise _Unknown
    dt = types.get(col.name.lower())
    if not isinstance(dt, _TEMPORAL_TYPES):
        raise _Unknown
    if lit.value is None:
        raise _Never
    if f.name == "year" and len(args) == 1:
        if isinstance(lit.value, bool) or not isinstance(lit.value, int):
            raise _Unknown

        def wrap(x: ir.Expression) -> ir.Expression:
            # date stats arrive as ISO strings (file tier) or date/datetime
            # objects (footer tier); Cast(DateType) normalizes both to
            # epoch days, which _epoch_day_field takes
            return ir.Func("year", [ir.Cast(x, DateType())])

        return _wrap_cmp(t, wrap, col.name, lit)
    if f.name == "to_date" and len(args) == 1:
        if not isinstance(lit.value, str):
            raise _Unknown
        if isinstance(dt, DateType):
            # identity on a date column — the base col-op-lit rules apply
            return base(t(col, lit))

        def wrap(x: ir.Expression) -> ir.Expression:
            # engine timestamp stats are fixed-width ISO strings, whose
            # prefix-10 parse is monotone; footer stats arrive as datetime
            # objects (_to_date truncates) — both land on dates
            return ir.Func("to_date", [x])

        return _wrap_cmp(t, wrap, col.name, lit)
    if f.name in ("date_add", "date_sub") and len(args) == 2:
        n = args[1]
        if not (isinstance(n, ir.Literal) and isinstance(n.value, int)
                and not isinstance(n.value, bool)):
            raise _Unknown
        lit_date = ir.Func.FUNCS["to_date"](lit.value)
        if lit_date is None:
            raise _Unknown
        sign = -1 if f.name == "date_add" else 1
        shifted = ir.Func.FUNCS["date_add"](lit_date, sign * n.value)
        shifted_lit = ir.Literal(shifted.isoformat())
        if isinstance(dt, DateType):
            # strict monotone shift over DATE values: invert exactly onto
            # the raw column; an ISO string literal compares correctly
            # against string or date-valued stats through _coerce_pair
            return base(t(col, shifted_lit))
        # TimestampType: _date_add TRUNCATES the datetime to a date first
        # (ir._as_date), so the composite is day-truncating, NOT strict
        # monotone — an exact inversion onto the raw timestamp would prune
        # files whose rows fall later inside the matching day. Use the
        # same monotone non-strict wrap as to_date, with the shifted bound.

        def wrap(x: ir.Expression) -> ir.Expression:
            return ir.Func("to_date", [x])

        return _wrap_cmp(t, wrap, col.name, shifted_lit)
    raise _Unknown


def _synth_like(e: ir.Like, types: Dict[str, DataType],
                pcols: FrozenSet[str], base: _Base) -> ir.Expression:
    if not (isinstance(e.left, ir.Column) and isinstance(e.right, ir.Literal)):
        raise _Unknown
    col, pat = e.left, e.right.value
    if col.name.lower() in pcols:
        raise _Unknown
    if not isinstance(types.get(col.name.lower()), StringType):
        raise _Unknown
    if pat is None:
        raise _Never
    if not isinstance(pat, str):
        raise _Unknown
    wild = [i for i, ch in enumerate(pat) if ch in "%_"]
    if not wild:
        return base(ir.Eq(col, ir.Literal(pat)))
    prefix = pat[: wild[0]]
    if not prefix:
        raise _Unknown
    # every match carries the literal prefix: the StartsWith rule is a
    # sound (weaker) can-match for the whole pattern
    return base(ir.StartsWith(col, ir.Literal(prefix)))


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


_CMP_FLIP = {ir.Lt: ir.Gt, ir.Le: ir.Ge, ir.Gt: ir.Lt, ir.Ge: ir.Le,
             ir.Eq: ir.Eq}


def synthesize(e: ir.Expression, partition_cols: FrozenSet[str],
               types: Dict[str, DataType], base: _Base) -> ir.Expression:
    """Sound can-match rewrite for a predicate leaf the base skipping rules
    return UNKNOWN for; ``Literal(None)`` (keep) when no rule applies.
    ``base`` is the plain-shape rewriter (``ops.pruning.skipping_predicate``
    without synthesis) the inversion/prefix rules delegate to."""
    try:
        return _synthesize(e, partition_cols, types, base)
    except _Never:
        return ir.Literal(False)
    except _Unknown:
        return UNKNOWN
    except Exception:  # noqa: BLE001 — synthesis must never fail a scan
        return UNKNOWN


def _synthesize(e: ir.Expression, pcols: FrozenSet[str],
                types: Dict[str, DataType], base: _Base) -> ir.Expression:
    t = type(e)
    if t is ir.Like:
        return _synth_like(e, types, pcols, base)
    if t is ir.In:
        branches: List[ir.Expression] = []
        for o in e.options:
            if not isinstance(o, ir.Literal):
                raise _Unknown
            if o.value is None:
                continue  # a NULL option can never make the IN true
            branches.append(_synthesize(ir.Eq(e.value, o), pcols, types, base))
        if not branches:
            raise _Never
        return _or_all(branches)
    if t in _CMP_FLIP:
        l, r = _fold(e.left), _fold(e.right)
        if isinstance(l, ir.Literal) and not isinstance(r, ir.Literal):
            t = _CMP_FLIP[t]
            l, r = r, l
        if isinstance(l, ir.Column) and isinstance(r, ir.Column):
            return _synth_colcol(t, l, r, pcols, types)
        if not isinstance(r, ir.Literal) or isinstance(l, ir.Literal):
            raise _Unknown
        if isinstance(l, ir.Func) and l.name in _FAMILY_STRING:
            return _synth_substr(t, l, r, types, pcols, base)
        if isinstance(l, ir.Func) and l.name in _FAMILY_TEMPORAL:
            return _synth_temporal(t, l, r, types, pcols, base)
        if isinstance(l, ir.Func) and l.name == "abs" and len(l.children) == 1:
            try:
                return _synth_abs(t, l.children[0], r, pcols, types, base)
            except _Unknown:
                pass  # the interval path below is abs-aware
        if isinstance(l, (ir.Coalesce, ir.CaseWhen)):
            return _synth_branches(t, l, r, pcols, types, base)
        v = _as_num(r.value)
        try:
            return _invert_chain(l, _Bounds.from_cmp(t, v), pcols, types, base)
        except _Unknown:
            pass
        return _interval_cmp(t, l, v, pcols, types)
    raise _Unknown

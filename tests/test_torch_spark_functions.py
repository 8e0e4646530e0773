"""Functions where the port gives Spark's answer and ``delta_tpu`` does not:
integer ``%`` (Java's remainder, the sign of the dividend), ``round`` and
the double to DECIMAL cast (half up), ``trim`` (the space character only),
and ``upper``/``lower`` of characters whose case changes their length.

Each case pins the port's answer through every path that computes it (the
row evaluator, the vectorized evaluator, a read under
``deviceResidual.mode`` off and force with one file a value, so the
skipping bounds see each value, and an UPDATE), and records the JAX
package's answer beside it, so that no later change moves the port onto
the reference's answer unnoticed."""
import datetime as dt
from decimal import Decimal

import numpy as np
import pytest

import delta_tpu
import delta_tpu_torch
from delta_tpu.expr.parser import parse_expression as jax_parse
from delta_tpu_torch.expr import vectorized
from delta_tpu_torch.expr.parser import parse_expression as torch_parse
from tests.torch_port_tables import Pkg, both_confs, reset_caches


@pytest.fixture(autouse=True)
def _fresh():
    reset_caches()
    yield
    reset_caches()


def one_file_a_value(path, name, spec):
    """A table written by ``delta_tpu``, one file for each value."""
    P = Pkg("jax")
    typ, values = spec if isinstance(spec, tuple) else (None, spec)
    for v in values:
        P.write(path, {name: (typ, [v]) if typ else [v]})
    return path


def reads(path, pred, col):
    """The filter's rows of ``col`` in each package and residual mode."""
    out = {}
    for mode in ("off", "force"):
        with both_confs(**{"delta.tpu.read.deviceResidual.mode": mode}):
            delta_tpu_torch.DeltaLog.clear_cache()
            got = delta_tpu_torch.DeltaTable.for_path(path, device="cpu").to_table(filters=[pred])
            out[("torch", mode)] = sorted(r[col] for r in got.to_pylist())
            delta_tpu.DeltaLog.clear_cache()
            got = delta_tpu.DeltaTable.for_path(path).to_arrow(filters=[pred])
            out[("jax", mode)] = sorted(r[col] for r in got.to_pylist())
    return out


def updated(tmp_path, name, spec, assignment):
    """The column after ``update({name: assignment})`` in each package's
    copy of one table."""
    out = {}
    for pkg in ("jax", "torch"):
        path = one_file_a_value(str(tmp_path / f"u_{pkg}"), name, spec)
        if pkg == "jax":
            delta_tpu.DeltaTable.for_path(path).update({name: assignment})
        else:
            delta_tpu_torch.DeltaTable.for_path(path, device="cpu").update({name: assignment})
        delta_tpu.DeltaLog.clear_cache()
        out[pkg] = sorted(r[name] for r in delta_tpu.DeltaTable.for_path(path).to_arrow().to_pylist())
    return out


def row_and_vector(expr, rows):
    """The port's row evaluator and vectorized evaluator on ``rows``, and the
    JAX package's row evaluator."""
    e = torch_parse(expr)
    table = vectorized.table_from_rows(rows)
    return ([e.eval(r) for r in rows], vectorized.evaluate(e, table).values.tolist(),
            [jax_parse(expr).eval(r) for r in rows])


# -- integer % -------------------------------------------------------------------------


def test_integer_remainder_takes_the_sign_of_the_dividend(tmp_path):
    ids = [-5, -4, 3, 7]
    path = one_file_a_value(str(tmp_path / "t"), "id", ids)
    got = reads(path, "id % 3 = -2", "id")
    assert got[("torch", "off")] == got[("torch", "force")] == [-5]
    assert got[("jax", "off")] == []  # the reference's floor modulo: -5 % 3 = 1
    # the sign follows the dividend; a negative divisor changes nothing
    got = reads(path, "id % -3 = 1", "id")
    assert got[("torch", "off")] == got[("torch", "force")] == [7]
    row, vec, jax_row = row_and_vector("id % 3", [{"id": v} for v in ids])
    assert row == vec == [-2, -1, 0, 1]
    assert jax_row == [1, 2, 0, 1]
    assert updated(tmp_path, "id", ids, "id % 3") == {"torch": [-2, -1, 0, 1],
                                                      "jax": [0, 1, 1, 2]}


def test_remainder_skipping_bounds_keep_every_file(tmp_path):
    """The skipping bound of ``x % c`` covers (-|c|, |c|): with one file a
    value, no file whose row matches is dropped, as a full scan shows."""
    ids = [-7, -6, -5, -1, 0, 1, 5, 6, 7]
    path = one_file_a_value(str(tmp_path / "t"), "id", ids)
    from delta_tpu_torch.expr.parser import parse_predicate
    from delta_tpu_torch.ops import pruning

    for pred in ("id % 4 = -3", "id % 4 < -2", "id % -4 >= 1", "id % 4 = 1"):
        want = sorted(v for v in ids if eval_java(pred, v))
        snap = delta_tpu_torch.DeltaLog.for_table(path, device="cpu").update()
        kept = pruning.files_for_scan(snap, [parse_predicate(pred)]).files
        assert len(kept) >= len(want)
        assert reads(path, pred, "id")[("torch", "force")] == want


def eval_java(pred, v):
    lhs, op, rhs = pred.replace("id % ", "").split(" ")
    c = int(lhs)
    m = abs(v) % abs(c)
    r = m if v >= 0 else -m
    return {"=": r == int(rhs), "<": r < int(rhs), ">=": r >= int(rhs)}[op]


def test_double_remainder_keeps_fmod(tmp_path):
    path = one_file_a_value(str(tmp_path / "t"), "d", [-5.5, 5.5])
    got = reads(path, "d % 2 = -1.5", "d")
    assert got[("torch", "off")] == got[("torch", "force")] == got[("jax", "off")] == [-5.5]


# -- round and the cast to DECIMAL ----------------------------------------------------


def test_round_rounds_half_up(tmp_path):
    ds = [2.5, -2.5, 0.5]
    path = one_file_a_value(str(tmp_path / "t"), "d", ds)
    got = reads(path, "round(d) = 3", "d")
    assert got[("torch", "off")] == got[("torch", "force")] == [2.5]
    assert got[("jax", "off")] == []
    row, vec, jax_row = row_and_vector("round(d)", [{"d": v} for v in ds])
    assert row == vec == [3.0, -3.0, 1.0]
    assert jax_row == [2.0, -2.0, 0.0]
    assert updated(tmp_path, "d", ds, "round(d)") == {"torch": [-3.0, 1.0, 3.0],
                                                      "jax": [-2.0, 0.0, 2.0]}
    # at its shortest decimal form, as BigDecimal(double) takes it
    assert torch_parse("round(2.675, 2)").eval({}) == 2.68
    assert jax_parse("round(2.675, 2)").eval({}) == 2.67


def test_cast_of_a_double_to_decimal_rounds_half_up(tmp_path):
    ds = [2.5, -2.5, 0.5]
    path = one_file_a_value(str(tmp_path / "t"), "d", ds)
    got = reads(path, "CAST(d AS DECIMAL(3,0)) = -3", "d")
    assert got[("torch", "off")] == got[("torch", "force")] == [-2.5]
    assert got[("jax", "off")] == []
    table = vectorized.table_from_rows([{"d": v} for v in ds + [2.675, -1.005]])
    cast = vectorized.evaluate(torch_parse("CAST(d AS DECIMAL(5,2))"), table)
    assert [int(v) for v in cast.values] == [250, -250, 50, 268, -101]


def test_round_of_a_decimal_rounds_half_up(tmp_path):
    spec = ("decimal(3,1)", [Decimal("2.5"), Decimal("-2.5"), Decimal("0.4")])
    path = one_file_a_value(str(tmp_path / "t"), "x", spec)
    got = reads(path, "round(x) = -3", "x")
    assert got[("torch", "off")] == got[("torch", "force")] == [Decimal("-2.5")]
    assert got[("jax", "off")] == []
    row = [torch_parse("round(x)").eval({"x": v}) for v in spec[1]]
    assert row == [Decimal("3"), Decimal("-3"), Decimal("0")]


# -- trim --------------------------------------------------------------------------


def test_trim_strips_only_the_space_character(tmp_path):
    path = one_file_a_value(str(tmp_path / "t"), "s", ["\tab\n", "  ab  ", "ab"])
    got = reads(path, "trim(s) = 'ab'", "s")
    assert got[("torch", "off")] == got[("torch", "force")] == ["  ab  ", "ab"]
    assert got[("jax", "off")] == ["\tab\n", "  ab  ", "ab"]
    row, vec, jax_row = row_and_vector("trim(s)", [{"s": "\tab\n"}, {"s": " a b "}])
    assert row == vec == ["\tab\n", "a b"]
    assert jax_row == ["ab", "a b"]


# -- upper and lower of characters whose case changes their length ----------------------


def test_upper_and_lower_follow_java(tmp_path):
    """``upper('ß')`` is 'SS' and ``lower('İ')`` 'i̇' in the port (Java's, so
    Spark's); Arrow's ``utf8_upper``/``utf8_lower`` map a character to one
    character."""
    for expr, want_port, want_jax in (("upper(s)", ["SS", "İ"], ["ẞ", "İ"]),
                                      ("lower(s)", ["ß", "i̇"], ["ß", "i"])):
        got = updated(tmp_path / expr[:5], "s", ["ß", "İ"], expr)
        assert got == {"torch": sorted(want_port), "jax": sorted(want_jax)}


def test_date_and_bround_free_paths_are_unchanged():
    """What the three repairs leave alone: a date's day functions and a
    whole-number round of an integer."""
    row, vec, jax_row = row_and_vector("round(id, -1)", [{"id": 25}, {"id": -25}, {"id": 24}])
    assert row == vec == [30, -30, 20]
    assert jax_row == [20, -20, 20]
    d = dt.date(2024, 2, 29)
    assert torch_parse("day(d)").eval({"d": d}) == jax_parse("day(d)").eval({"d": d}) == 29
    assert np.isnan(torch_parse("round(d)").eval({"d": float("nan")}))

"""The port's device evaluator (``delta_tpu_torch.expr.device_eval``: the
lowering to the K15 program and its plain PyTorch version) held against
``delta_tpu.expr.jaxeval.compile_expr`` on the CPU, under x64.

The same seeded numpy columns (NaN, ±inf, -0.0, int32 and int64 extremes,
negative timestamps, NULLs in every column) go through both; values and
validity must agree on every lane, invalid lanes included.

Tolerance: exact (bits of integers and bools; floats equal by value, NaN
equal to NaN), except ``exp``/``log``/``pow``/``sqrt``, which may differ
from XLA's CPU versions by at most 1 ulp, and where XLA's CPU ``exp``
flushes a subnormal result to zero (the port keeps the subnormal).
"""
import os
import re

import numpy as np
import pytest

from delta_tpu.expr import jaxeval
from delta_tpu.expr.parser import parse_expression as jax_parse
from delta_tpu.utils.jaxcompat import enable_x64
from delta_tpu_torch.expr import device_eval
from delta_tpu_torch.expr.parser import parse_expression as torch_parse
from delta_tpu_torch.ops import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 64
_TRANSCENDENTAL = ("exp", "log", "pow", "sqrt")


def _columns():
    rng = np.random.RandomState(0)
    cols = {
        "a": rng.randint(-10, 10, N).astype(np.int64),
        "b": np.concatenate([[np.nan, np.inf, -np.inf, -0.0, 0.0, 1e300, -1e300, 3e9, -3e9,
                              9.3e18, -9.3e18, 2.5, -2.5], rng.randn(N - 13) * 1e3]),
        "i": np.concatenate([[2**31 - 1, -2**31, 0, -1],
                             rng.randint(-2**31, 2**31 - 1, N - 4)]).astype(np.int32),
        "g": np.concatenate([[np.nan, 3e9, -3e9, np.inf], rng.randn(N - 4) * 100]
                            ).astype(np.float32),
        "flag": rng.rand(N) > 0.5,
        # epoch-µs timestamps, before 1970 included
        "t": np.concatenate([[-1.0, -3_600_000_001.0, -0.0, 86_399_999_999.0, -1e-300],
                             rng.randn(N - 5) * 1e12]),
        "big": np.concatenate([[2**63 - 1, -2**63], rng.randint(-2**62, 2**62, N - 2)]
                              ).astype(np.int64),
    }
    masks = {k: rng.rand(N) > 0.2 for k in cols}
    return cols, masks


COLS, MASKS = _columns()


def _jax(sql):
    with enable_x64():
        out = jaxeval.compile_expr(jax_parse(sql))(jaxeval.columns_from_numpy(COLS, MASKS))
        return np.asarray(out.values), np.asarray(out.valid)


def _port(sql):
    out = device_eval.compile_expr(torch_parse(sql))(device_eval.columns_from_numpy(COLS, MASKS))
    return out.values.numpy(), out.valid.numpy()


def _ulps(x, y):
    ints = np.int64 if x.dtype == np.float64 else np.int32
    return np.abs(x.view(ints).astype(np.float64) - y.view(ints).astype(np.float64))


def _assert_same(sql):
    jv, jok = _jax(sql)
    tv, tok = _port(sql)
    assert tv.dtype == jv.dtype, (sql, tv.dtype, jv.dtype)
    assert tv.shape == jv.shape, sql
    assert np.array_equal(tok, jok), sql
    if jv.dtype.kind == "f":
        same = (jv == tv) | (np.isnan(jv) & np.isnan(tv))
        if not same.all():
            assert any(f in sql for f in _TRANSCENDENTAL), (sql, jv[~same], tv[~same])
            flushed = (jv == 0) & (np.abs(tv) < np.finfo(jv.dtype).tiny)
            assert (_ulps(jv, tv)[~same & ~flushed] <= 1).all(), sql
    else:
        assert np.array_equal(tv, jv), sql


# tests/test_expr_eval.py's NUMERIC_PREDICATES and
# tests/test_expr_functions.py's JAX_EXPRS, then the port's corpus
CORPUS = [
    "a > 2", "a >= 2 AND b < 20", "NOT (a = 2)", "a IS NULL", "a IN (1, 4, 5)", "a + 1 > 3",
    "b / 2 > 1", "a * 2 = 8", "b IS NULL OR b > 0", "a > 1 AND (b > 0 OR flag)",
    "a = 1 AND a = 2",
    "pow(b, 2)", "exp(b)", "log(b)", "sqrt(a)", "date_add(a, 7)", "date_sub(a, 3)",
    "datediff(a, big)", "minute(t)", "second(t)",
    "i * i", "- i", "abs(big)", "big * big", "big + i", "b + g", "big + g", "i + b",
    "CAST(a AS DOUBLE)", "CAST(b AS BOOLEAN)", "NOT b", "floor(b)", "ceil(g)", "floor(a)",
    "sqrt(b)", "log(g)", "pow(a, b)", "exp(g)",
    "hour(t)", "hour(i)", "minute(i)", "second(a)", "hour(g)", "hour(flag)",
    "date_sub(b, i)", "date_add(flag, a)", "date_sub(i, big)", "datediff(a, b)",
    "coalesce(a, b)", "coalesce(NULL, a, 5)", "coalesce(g, big)",
    "CASE WHEN a > 3 THEN 1 WHEN a > 1 THEN 2 ELSE 3 END", "CASE WHEN flag THEN b ELSE g END",
    "CASE WHEN a > 0 THEN NULL END",
    "a <=> b", "a <=> NULL", "NULL + 1", "1 + 2", "5 / 0", "a / 0", "b / a",
    "TRUE AND NULL", "NULL OR a > 1", "NOT NULL", "a > NULL", "a + 1.5 > b",
    "g > 1e40", "big = 4611686018427387904.0", "CAST(NULL AS INT)", "hour(NULL)",
    "flag + flag", "flag * flag", "flag + 1", "abs(flag)", "abs(g)", "- b",
    "(a > 1) = (b > 1)", "i <=> g", "big IN (i, NULL)", "b IN (a, g)",
]


@pytest.mark.parametrize("sql", CORPUS)
def test_compile_expr_matches_jax(sql):
    _assert_same(sql)


@pytest.mark.parametrize("sql,dtype", [
    ("big + g", np.float32),   # int64 with float32 is float32 on JAX's lattice
    ("i + b", np.float64),
    ("flag + i", np.int32),
    ("coalesce(big, NULL)", np.float32),  # NULL is a float32 literal
    ("2147483648 + i", np.int64),  # a literal beyond int32 is int64
    ("CASE WHEN flag THEN i ELSE g END", np.float32),
])
def test_dtype_promotion_follows_the_x64_lattice(sql, dtype):
    _assert_same(sql)
    assert _port(sql)[0].dtype == dtype


@pytest.mark.parametrize("sql", ["2147483647 + 1", "i + 1", "i * 3", "- i", "abs(i)",
                                 "9223372036854775807 + 1", "big * 3", "- big",
                                 "3000000000 * 4"])
def test_integer_arithmetic_wraps_at_the_result_width(sql):
    _assert_same(sql)


@pytest.mark.parametrize("sql", ["CAST(b AS INT)", "CAST(b AS BIGINT)", "CAST(g AS INT)",
                                 "CAST(g AS BIGINT)", "CAST(big AS INT)", "CAST(t AS SHORT)"])
def test_float_to_int_casts_saturate_and_nan_is_zero(sql):
    _assert_same(sql)
    if "b AS BIGINT" in sql:
        v = _port(sql)[0]
        assert v[:3].tolist() == [0, 2**63 - 1, -2**63]  # nan, inf, -inf


@pytest.mark.parametrize("sql", ["hour(t)", "minute(t)", "second(t)", "hour(big)",
                                 "minute(- t)"])
def test_time_fields_floor_negative_timestamps(sql):
    _assert_same(sql)


@pytest.mark.parametrize("sql", ["a IN (b, 3, NULL)", "a IN (b, 3)", "a IN (b, g)",
                                 "(a IN (1, 2)) IN (flag, (a IN (b, NULL)))", "NULL IN (1, 2)",
                                 "1 IN (a, 2)"])
def test_in_reduces_option_validity_over_all_rows(sql):
    _assert_same(sql)
    program = device_eval.compile_expr(torch_parse(sql)).program(
        device_eval.columns_from_numpy(COLS, MASKS))
    assert program.passes == (2 if sql.startswith("(a IN") else 1)


@pytest.mark.parametrize("sql", [
    "s LIKE 'ap%'", "lpad(s, 3)", "a % 2 = 0", "CAST(a AS STRING) = '4'", "flag - flag",
    "- flag", "datediff(flag, flag)", "nope > 1", "substr(s, 1, 2) = 'ab'",
    "99999999999999999999 > a", "CAST(a AS DATE)", "year(a)", "'x' = 'x'",
])
def test_declines_what_jax_cannot_trace(sql):
    """Each raises in the JAX package's trace too; the port declines at
    lowering, so the host evaluator takes it."""
    with pytest.raises(Exception):
        _jax(sql)
    with pytest.raises(device_eval.NotDeviceCompilable):
        _port(sql)


@pytest.mark.parametrize("sql", ["exp(b)", "log(b)", "pow(b, 0.5)", "sqrt(b)", "exp(a)"])
def test_transcendentals_within_one_ulp(sql):
    _assert_same(sql)


def test_scalar_program_is_zero_dimensional():
    out = device_eval.compile_expr(torch_parse("1 + 2 > 2"))({})
    assert out.values.dim() == 0 and bool(out.values) and bool(out.valid)
    p = device_eval.compile_expr(torch_parse("NULL"))
    assert p({}).valid.item() is False


def test_registers_are_reused():
    sql = " AND ".join(f"(a + {k} > b)" for k in range(60))
    program = device_eval.compile_expr(torch_parse(sql)).program(
        device_eval.columns_from_numpy(COLS, MASKS))
    assert program.instrs.shape[0] > 200 and program.n_regs <= 8
    _assert_same(sql)


def test_plain_version_launches_nothing_on_the_cpu():
    before = dict(native.launches)
    _port("a > 2 AND b < 1")
    assert native.launches == before


def test_opcode_and_dtype_tables_match_the_kernel_source():
    src = open(os.path.join(REPO, "delta_tpu_torch", "csrc", "expr_eval.cu")).read()
    ops = re.search(r"enum Op \{(.*?)\};", src, re.S).group(1)
    names = [x.split("=")[0].strip() for x in ops.replace("\n", " ").split(",")]
    assert tuple(names) == device_eval.OPS
    dts = re.search(r"enum Dt \{(.*?)\};", src, re.S).group(1)
    assert [x.split("=")[0].strip() for x in dts.split(",")] == \
        ["BOOL", "I32", "I64", "F32", "F64"]
    assert f"kMaxRegs = {device_eval.MAX_REGS}" in src

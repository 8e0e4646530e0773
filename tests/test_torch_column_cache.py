"""The port's residual lowering and column cache (``expr/device_eval.
compile_residual``, ``ops/column_cache``) against ``delta_tpu``'s on the CPU:

* ``compile_residual`` plans equal to JAX's (the rewritten expression's
  SQL, the lane refs, the string-literal bindings) on the cases of
  ``tests/test_column_cache.py:421-496``, and the same gates;
* K14's plain version (``residual_mask_plain``) equal to JAX's jitted
  ``_mask_kernel`` on the same pow2-padded lanes of every lane dtype, with
  string codes bound per file; an ``IN`` whose option is a column is the
  one shape where the two differ (the reference's fault), and there the
  port equals the host evaluator;
* the calendar opcodes over +-10^6 days and timestamps before 1970;
* the cache's epochs, LRU eviction and register race
  (``tests/test_column_cache.py:322-370``).

Exact throughout.
"""
import datetime as dt

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from delta_tpu.expr import jaxeval
from delta_tpu.expr.parser import parse_predicate as jax_parse
from delta_tpu.ops import column_cache as jax_cc
from delta_tpu.schema import types as JT
from delta_tpu.utils.jaxcompat import enable_x64
from delta_tpu_torch.expr import device_eval, ir
from delta_tpu_torch.expr.device_eval import DeviceColumn, NotDeviceCompilable
from delta_tpu_torch.expr.parser import parse_predicate
from delta_tpu_torch.expr.vectorized import HostColumn, HostTable, boolean_mask
from delta_tpu_torch.ops import column_cache
from delta_tpu_torch.ops.column_cache import ColumnCache, ResidentColumn
from delta_tpu_torch.schema import types as TT
from delta_tpu_torch.utils import telemetry
from delta_tpu_torch.utils.config import conf


@pytest.fixture(autouse=True)
def _fresh_cache():
    ColumnCache.reset()
    yield
    ColumnCache.reset()


def _types(m):
    return {"a": m.IntegerType(), "s": m.StringType(), "d": m.DateType(),
            "ts": m.TimestampType(), "x": m.DoubleType(), "m": m.DecimalType(10, 2),
            "b": m.BooleanType(), "l": m.LongType()}


def _plans(q, parts=()):
    j = jaxeval.compile_residual(jax_parse(q), _types(JT), parts)
    t = device_eval.compile_residual(parse_predicate(q), _types(TT), parts)
    return j, t


# -- compile_residual ----------------------------------------------------------------


@pytest.mark.parametrize("q", [
    "s = 'foo' AND s != 'bar'",
    "d >= '2024-01-01'",
    "ts < '2024-06-01 12:00:00'",
    "ts >= '2024-03-05'",
    "year(d) = 2024 AND month(ts) = 1",
    "day(ts) = 3 OR year(to_date(ts)) < 1970",
    "to_date(ts) = '2024-01-15'",
    "hour(ts) >= 12",
    "s IN ('a', NULL, 'b')",
    "s <=> 'g' OR s IS NULL",
    "a IN (x, 3)",
    "NOT (a IN (x))",
    "x BETWEEN 0.2 AND 0.4",
    "'q' = s",
    "d IN ('2024-01-01', NULL)",
    "a > 5 AND b",
    "a > 5",
])
def test_residual_plans_match_jax(q):
    j, t = _plans(q)
    assert t.expr.sql() == j.expr.sql()
    assert t.refs == j.refs and t.part_refs == j.part_refs
    assert t.str_binds == j.str_binds


@pytest.mark.parametrize("bad", [
    "s < 'm'",                 # string ordering has no code semantics
    "upper(s) = 'A'",          # string function
    "m > 5",                   # decimal stays on host
    "d = ts",                  # mixed temporal compare
    "a = 'five'",              # string literal vs numeric lane
    "s IN ('a', x)",           # string IN over a non-literal option
])
def test_residual_gates_raise(bad):
    with pytest.raises(jaxeval.NotDeviceCompilable):
        jaxeval.compile_residual(jax_parse(bad), _types(JT), ())
    with pytest.raises(NotDeviceCompilable):
        device_eval.compile_residual(parse_predicate(bad), _types(TT), ())


def test_residual_string_partition_column_gated():
    with pytest.raises(NotDeviceCompilable):
        device_eval.compile_residual(parse_predicate("pc = 'x'"), {"pc": TT.StringType()},
                                     ("pc",))
    j, t = _plans("a > 5 AND l = 3", parts=("l",))
    assert t.part_refs == j.part_refs == frozenset({"l"})
    assert t.expr.sql() == j.expr.sql()


def test_residual_plan_is_a_stable_cache_key():
    p1 = device_eval.compile_residual(parse_predicate("a > 5"), _types(TT), ())
    p2 = device_eval.compile_residual(parse_predicate("a > 5"), _types(TT), ())
    assert hash(p1.expr) == hash(p2.expr)
    dts = (("a", torch.int64),)
    assert column_cache._mask_program(p1.expr, dts, ()) is \
        column_cache._mask_program(p2.expr, dts, ())


# -- K14's plain version against JAX's _mask_kernel ---------------------------------


N_ROWS = 300  # padded to 512: a pad of 212 invalid rows


def _lanes(seed=3):
    """Decoded lanes of every dtype (values, valid), as ``_lane_from_column``
    gives them: int32 string codes (-1 at NULL), int32 epoch days, int64
    epoch µs, int64, float64, bool; NULLs in every lane, dates and
    timestamps on both sides of 1970 and far from it."""
    rng = np.random.RandomState(seed)
    n = N_ROWS
    words = np.array(["alpha", "beta", "gamma", "delta"], object)
    s_valid = rng.rand(n) > 0.1
    s_vals = words[rng.randint(0, 4, n)]
    codes, valid, mapping = column_cache._lane_from_column(
        HostColumn("str", np.where(s_valid, s_vals, None), s_valid))
    lanes = {"s": (codes, valid)}
    d = rng.randint(-1_000_000, 1_000_000, n).astype(np.int32)
    d[:4] = [-1, 0, 59, -719_162]
    lanes["d"] = (d, rng.rand(n) > 0.1)
    ts = rng.randint(-10**15, 10**15, n).astype(np.int64)
    ts[:3] = [-1, -86_400_000_000, -86_400_000_001]
    lanes["ts"] = (ts, rng.rand(n) > 0.1)
    lanes["a"] = (rng.randint(-50, 50, n).astype(np.int64), rng.rand(n) > 0.1)
    lanes["l"] = (rng.randint(-50, 50, n).astype(np.int64), rng.rand(n) > 0.1)
    x = rng.randn(n)
    x[5] = np.nan
    lanes["x"] = (x, rng.rand(n) > 0.1)
    lanes["b"] = (rng.rand(n) > 0.5, rng.rand(n) > 0.1)
    return lanes, mapping


def _pad(values, valid, cap=512):
    pv = np.zeros(cap, values.dtype)
    pv[:len(values)] = values
    pm = np.zeros(cap, bool)
    pm[:len(valid)] = valid
    return pv, pm


def _jax_mask(plan, lanes, mapping):
    with enable_x64():
        env = {c: jaxeval.DeviceColumn(jnp.asarray(_pad(*lanes[c])[0]),
                                       jnp.asarray(_pad(*lanes[c])[1])) for c in plan.refs}
        for ph, _col, value in plan.str_binds:
            env[ph] = jax_cc._scalar_column(int(mapping.get(value, jaxeval.STR_CODE_ABSENT)))
        return np.asarray(jax_cc._mask_kernel(plan.expr)(env))[:N_ROWS]


def _port_mask(plan, lanes, mapping):
    env = {c: DeviceColumn(torch.from_numpy(_pad(*lanes[c])[0]),
                           torch.from_numpy(_pad(*lanes[c])[1])) for c in plan.refs}
    dtypes = tuple(sorted((c, e.values.dtype) for c, e in env.items()))
    scalar_types = tuple((ph, device_eval.I64) for ph, _c, _v in plan.str_binds)
    program = column_cache._mask_program(plan.expr, dtypes, scalar_types)
    scalars = {}
    for ph, _col, value in plan.str_binds:
        _t, bits, ok = column_cache._scalar_column(
            int(mapping.get(value, device_eval.STR_CODE_ABSENT)))
        scalars[ph] = (bits, ok)
    before = dict(column_cache.native.launches)
    got = column_cache.residual_mask(program, env, N_ROWS, scalars).numpy()
    assert column_cache.native.launches == before  # the plain version never counts
    return got


MASK_CASES = [
    "s = 'alpha'",
    "s != 'beta'",
    "s <=> 'gamma'",
    "s IN ('alpha', 'delta')",
    "s IN ('nosuch', NULL)",
    "s = 'nosuch' OR a > 10",
    "s IS NULL",
    "d >= '2024-01-01'",
    "d < '1969-12-31'",
    "year(d) = 2024 OR month(d) = 2",
    "year(d) < 0 AND day(d) > 15",
    "ts < '1969-12-31 23:00:00'",
    "month(ts) = 12 AND year(ts) > 2000",
    "to_date(ts) = '1969-12-31'",
    "day(to_date(ts)) = 1",
    "hour(ts) >= 12",
    "a > 5 AND x < 0.5",
    "a * 2 + l > 10",
    "x BETWEEN -0.2 AND 0.4",
    "x / a > 0.01",
    "NOT b OR a = 3",
    "b",
    "a IN (1, 2, 3, NULL)",
    "COALESCE(a, l) > 0",
    "CASE WHEN a > 0 THEN x ELSE l END > 0.5",
    "abs(a) <= 3",
    "NOT (a IN (5, 7))",
]


@pytest.mark.parametrize("q", MASK_CASES)
def test_k14_plain_matches_jax_mask_kernel(q):
    lanes, mapping = _lanes()
    j, t = _plans(q)
    want = _jax_mask(j, lanes, mapping)
    assert np.array_equal(_port_mask(t, lanes, mapping), want)


def _host_mask(q, lanes, mapping):
    """The host evaluator's Kleene-TRUE mask over the same rows."""
    inv = {v: k for k, v in mapping.items()}
    refs = set(ir.references(parse_predicate(q)))
    cols = {}
    for c, (v, ok) in lanes.items():
        if c not in refs:
            continue
        if c == "s":
            cols[c] = HostColumn("str", np.array([inv.get(int(x)) for x in v], object), ok)
        elif c == "d":
            cols[c] = HostColumn("date", v.astype(np.int64), ok)
        elif c == "ts":
            cols[c] = HostColumn("ts", v, ok)
        elif c == "x":
            cols[c] = HostColumn("double", v, ok)
        elif c == "b":
            cols[c] = HostColumn("bool", v, ok)
        else:
            cols[c] = HostColumn("int", v, ok)
    return boolean_mask(parse_predicate(q), HostTable(cols, N_ROWS))


@pytest.mark.parametrize("q", ["NOT (a IN (l))", "a IN (l, 3)", "NOT (a IN (l, NULL))",
                               "x IN (a, 0.5)"])
def test_k14_in_over_a_column_option_matches_the_host(q):
    """Where an option is a column, JAX reduces its validity over every row
    of the padded lane (so a NULL anywhere, the pad included, makes every
    not-found row NULL); the port takes it per row, as the host does."""
    lanes, mapping = _lanes()
    j, t = _plans(q)
    got = _port_mask(t, lanes, mapping)
    assert np.array_equal(got, _host_mask(q, lanes, mapping))
    if q.startswith("NOT (a IN (l))"):
        assert not _jax_mask(j, lanes, mapping).any() and got.any()


def test_k14_plain_matches_the_host_on_every_mask_case():
    lanes, mapping = _lanes(seed=11)
    for q in MASK_CASES:
        if "to_date" in q or "hour" in q or "ts" in q or "CASE" in q or "/" in q:
            continue  # the host's row-level fallbacks for these shapes differ in type only
        t = device_eval.compile_residual(parse_predicate(q), _types(TT), ())
        assert np.array_equal(_port_mask(t, lanes, mapping), _host_mask(q, lanes, mapping)), q


# -- the calendar opcodes ----------------------------------------------------------


def _calendar(days, ts):
    """(year, month, day) of epoch days and of the days of epoch µs, by the
    port's plain program."""
    out = {}
    for name in ("year", "month", "day"):
        for col, vals in (("d", days), ("ts", ts)):
            plan = device_eval.compile_residual(parse_predicate(f"{name}({col}) >= -99999"),
                                                _types(TT), ())
            prog = device_eval.lower(plan.expr.children[0], {col: torch.from_numpy(vals).dtype},
                                     row_in=True)
            env = {col: DeviceColumn(torch.from_numpy(vals), torch.ones(len(vals), dtype=bool))}
            out[(name, col)] = device_eval.expr_eval_plain(prog, env).values.numpy()
    return out


def test_calendar_matches_python_and_jax_over_a_million_days():
    days = np.concatenate([np.arange(-1_000_000, 1_000_001, 997),
                           [-719_162, -1, 0, 1, 59, 60, 19_723, 20_514, 2_932_896,
                            (dt.date(2000, 2, 29) - dt.date(1970, 1, 1)).days,
                            (dt.date(2100, 3, 1) - dt.date(1970, 1, 1)).days,
                            (dt.date(1900, 2, 28) - dt.date(1970, 1, 1)).days]]).astype(np.int32)
    ts = days.astype(np.int64) * 86_400_000_000 + 86_399_999_999  # the day's last µs
    ts[::3] -= 86_400_000_000 * 2 + 1  # crosses a day boundary backwards
    got = _calendar(days, ts)
    # Python's calendar where it reaches (years 1..9999)
    for i, v in enumerate(days.tolist()):
        if -719_162 <= v <= 2_932_896:
            e = dt.date(1970, 1, 1) + dt.timedelta(days=v)
            assert (got[("year", "d")][i], got[("month", "d")][i], got[("day", "d")][i]) == \
                (e.year, e.month, e.day)
    ts_days = np.floor_divide(ts, 86_400_000_000)
    for i, v in enumerate(ts_days.tolist()):
        if -719_162 <= v <= 2_932_896:
            e = dt.date(1970, 1, 1) + dt.timedelta(days=v)
            assert got[("day", "ts")][i] == e.day and got[("year", "ts")][i] == e.year
    # JAX's lowering everywhere, before year 1 included
    with enable_x64():
        for name in ("year", "month", "day"):
            for col, vals in (("d", days), ("ts", ts)):
                plan = jaxeval.compile_residual(jax_parse(f"{name}({col}) >= -99999"),
                                                _types(JT), ())
                fn = jaxeval.compile_expr(plan.expr.children[0])
                env = {col: jaxeval.DeviceColumn(jnp.asarray(vals), jnp.ones(len(vals), bool))}
                assert np.array_equal(np.asarray(fn(env).values), got[(name, col)]), (name, col)


def test_ts_days_floors_before_1970():
    ts = np.array([-1, -86_400_000_000, -86_400_000_001, 0, 86_399_999_999], np.int64)
    plan = device_eval.compile_residual(parse_predicate("to_date(ts) = '1970-01-01'"), _types(TT), ())
    prog = device_eval.lower(plan.expr.left, {"ts": torch.int64}, row_in=True)
    env = {"ts": DeviceColumn(torch.from_numpy(ts), torch.ones(5, dtype=bool))}
    assert device_eval.expr_eval_plain(prog, env).values.tolist() == [-1, -1, -2, 0, 0]


# -- the cache ---------------------------------------------------------------------


def _entry(lp, path, n=8, epoch=0):
    return ResidentColumn(lp, path, "c", np.arange(n, dtype=np.int64), np.ones(n, bool), None,
                          epoch=epoch, device="cpu")


def test_register_refused_when_epoch_moved():
    cache = ColumnCache.instance()
    lp = "/tbl/_delta_log"
    e = _entry(lp, "part-0.parquet", epoch=cache.epoch(lp))
    cache.bump_epoch(lp)
    assert cache.register(e) is False
    assert cache.get(lp, "part-0.parquet", "c") is None
    # a stale entry slipped in is dropped by the get-side guard
    e2 = _entry(lp, "part-1.parquet", epoch=0)
    with cache._lock:
        cache._entries[(lp, "part-1.parquet", "c")] = e2
    assert cache.get(lp, "part-1.parquet", "c") is None
    assert not e2.is_resident


def test_bump_epoch_drops_the_tables_lanes_and_counts():
    cache = ColumnCache.instance()
    lp, other = "/tbl/_delta_log", "/other/_delta_log"
    for i in range(3):
        cache.register(_entry(lp, f"p{i}"))
    cache.register(_entry(other, "q"))
    c0 = telemetry.counters().get("columnCache.invalidations", 0)
    cache.bump_epoch(lp)
    assert cache.epoch(lp) == 1 and cache.epoch(other) == 0
    assert telemetry.counters()["columnCache.invalidations"] == c0 + 3
    assert cache.get(lp, "p0", "c") is None and cache.get(other, "q", "c") is not None


def test_lru_eviction_under_max_bytes():
    cache = ColumnCache.instance()
    lp = "/tbl/_delta_log"
    entries = [_entry(lp, f"part-{i}.parquet", n=4096) for i in range(4)]
    one = entries[0].nbytes
    c0 = dict(telemetry.counters())
    with conf.set_temporarily(**{"delta.tpu.columnCache.maxBytes": one * 2}):
        for e in entries:
            cache.register(e)
    assert cache.resident_bytes() <= one * 2
    assert not entries[0].is_resident and not entries[1].is_resident
    assert entries[3].is_resident
    assert telemetry.counters().get("columnCache.evictions", 0) > \
        c0.get("columnCache.evictions", 0)


def test_lru_eviction_under_max_entries_keeps_the_recently_used():
    cache = ColumnCache.instance()
    lp = "/tbl/_delta_log"
    entries = [_entry(lp, f"part-{i}.parquet") for i in range(4)]
    with conf.set_temporarily(**{"delta.tpu.columnCache.maxEntries": 2}):
        cache.register(entries[0])
        cache.register(entries[1])
        assert cache.get(lp, "part-0.parquet", "c") is entries[0]  # now the newest
        cache.register(entries[2])
    assert entries[0].is_resident and not entries[1].is_resident and entries[2].is_resident


def test_resident_lanes_pad_to_a_power_of_two():
    e = _entry("/t/_delta_log", "f", n=300)
    assert e.n == 300 and e.values.shape == (512,) and e.valid[300:].sum() == 0
    assert _entry("/t/_delta_log", "g", n=3).values.shape == (64,)
    assert e.nbytes == 512 * 8 + 512

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
* K14's batched entry (``residual_masks``: one launch a query on the card,
  its plain version here) equal to JAX's ``_mask_kernel`` file by file over
  files of unequal sizes (0 and 1 rows included), each binding its own
  string codes, over more files than one parameter block holds, and over
  IN lists too long for the launch's parameters (the staged tables); the
  blocks the card's launch takes, packed on the host; and
  ``device_residual_masks`` equal to JAX's per-file masks on bench config
  12's seven queries and on a 200-option IN, which stays on the device;
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
    "d = ts",                  # mixed temporal compare (the host leg answers it)
    "d < ts",
    "ts >= d",
    "d <=> ts",
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


def _lanes(seed=3, n=N_ROWS, words=("alpha", "beta", "gamma", "delta")):
    """Decoded lanes of every dtype (values, valid), as ``_lane_from_column``
    gives them: int32 string codes (-1 at NULL), int32 epoch days, int64
    epoch µs, int64, float64, bool; NULLs in every lane, dates and
    timestamps on both sides of 1970 and far from it. ``n`` >= 5."""
    rng = np.random.RandomState(seed)
    words = np.array(words, object)
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


def _jax_mask(plan, lanes, mapping, n=N_ROWS, cap=512):
    with enable_x64():
        env = {c: jaxeval.DeviceColumn(jnp.asarray(_pad(*lanes[c], cap)[0]),
                                       jnp.asarray(_pad(*lanes[c], cap)[1])) for c in plan.refs}
        for ph, _col, value in plan.str_binds:
            env[ph] = jax_cc._scalar_column(int(mapping.get(value, jaxeval.STR_CODE_ABSENT)))
        return np.asarray(jax_cc._mask_kernel(plan.expr)(env))[:n]


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


# -- K14's batched launch (residual_masks) against JAX's _mask_kernel, file by file ----


def _port_program(t, lanes_list, maps):
    """The port's program for plan ``t`` over files' lanes, its per-file
    scalars and envs (lanes padded to a power of two, floor 64)."""
    envs = []
    for lanes in lanes_list:
        n = len(next(iter(lanes.values()))[0])
        cap = max(64, 1 << max(n - 1, 0).bit_length())
        envs.append({c: DeviceColumn(torch.from_numpy(_pad(*lanes[c], cap)[0]),
                                     torch.from_numpy(_pad(*lanes[c], cap)[1]))
                     for c in t.refs})
    dtypes = tuple(sorted((c, e.values.dtype) for c, e in envs[0].items()))
    scalar_types = tuple((ph, device_eval.I64) for ph, _c, _v in t.str_binds)
    program = column_cache._mask_program(t.expr, dtypes, scalar_types)
    scal = []
    for mapping in maps:
        scal.append({ph: column_cache._scalar_column(
            int(mapping.get(v, device_eval.STR_CODE_ABSENT)))[1:] for ph, _c, v in t.str_binds})
    return program, envs, scal


def _batched_against_jax(q, files):
    """``residual_masks`` over ``files`` ([(lanes, mapping, rows)]) against
    JAX's ``_mask_kernel`` file by file; the bytes between files are False."""
    j, t = _plans(q)
    program, envs, scal = _port_program(t, [f[0] for f in files], [f[1] for f in files])
    ns = [f[2] for f in files]
    before = dict(column_cache.native.launches)
    mask, offs = column_cache.residual_masks(program, envs, ns, scal)
    assert column_cache.native.launches == before  # the plain version never counts
    assert (offs, mask.numel()) == column_cache.mask_offsets(ns)
    got = mask.numpy()
    for (lanes, mapping, n), off, env in zip(files, offs, envs):
        want = _jax_mask(j, lanes, mapping, n, env[next(iter(t.refs))].values.shape[0])
        assert np.array_equal(got[off:off + n], want), (q, n)
        assert not got[off + n:off + (n + 15) // 16 * 16].any()
    return program


BATCH_CASES = ["s = 'alpha'", "s IN ('alpha', 'delta')", "s = 'nosuch' OR a > 10",
               "year(d) = 2024 OR month(d) = 2", "month(ts) = 12 AND year(ts) > 2000",
               "a * 2 + l > 10", "x / a > 0.01", "CASE WHEN a > 0 THEN x ELSE l END > 0.5"]


@pytest.mark.parametrize("q", BATCH_CASES)
def test_residual_masks_of_unequal_files_match_jax(q):
    """Files of 0, 1, 300, 777 and 1000 rows (no multiple of a tile), each
    with its own dictionary, in one batched call."""
    files = []
    for i, (n_lane, n) in enumerate([(64, 0), (64, 1), (300, 300), (777, 777), (1000, 1000)]):
        lanes, mapping = _lanes(seed=20 + i, n=n_lane)
        files.append((lanes, mapping, n))
    _batched_against_jax(q, files)


def test_residual_masks_bind_each_files_string_codes():
    """``cat = 'eu-c'`` over files whose dictionaries differ (the words
    first seen in another order, one file without 'eu-c'): each file's
    literal binds its own code."""
    orders = [("us-w", "eu-c", "ap-s"), ("eu-c", "ap-s", "us-w"), ("ap-s", "us-w", "eu-c"),
              ("us-w", "ap-s", "sa-e")]
    files, truth = [], []
    for i, words in enumerate(orders):
        rng = np.random.RandomState(i)
        vals = np.array(words, object)[np.r_[0, 1, 2, rng.randint(0, 3, 197)]]
        ok = rng.rand(200) > 0.1
        ok[:3] = True
        codes, valid, mapping = column_cache._lane_from_column(
            HostColumn("str", np.where(ok, vals, None), ok))
        files.append(({"s": (codes, valid)}, mapping, 200))
        truth.append((vals == "eu-c") & ok)
    codes = [f[1].get("eu-c") for f in files]
    assert len(set(codes)) == 4  # three codes, and one file without the word (None)
    _batched_against_jax("s = 'eu-c'", files)
    _j, t = _plans("s = 'eu-c'")
    program, envs, scal = _port_program(t, [f[0] for f in files], [f[1] for f in files])
    mask, offs = column_cache.residual_masks(program, envs, [200] * 4, scal)
    for off, want in zip(offs, truth):
        assert np.array_equal(mask.numpy()[off:off + 200], want)


def test_residual_masks_over_more_files_than_one_parameter_block():
    """70 files: more than one parameter block holds (64), so two launches
    on the card; on the CPU the plain version walks the same blocks."""
    files = []
    for i in range(70):
        lanes, mapping = _lanes(seed=100 + i, n=40 + i)
        files.append((lanes, mapping, 40 + i))
    program = _batched_against_jax("s = 'gamma' AND a > 0", files)
    assert column_cache._launch_groups(program, 70) == [(0, 64), (64, 70)]


#: past the launch's parameters: 200 int options (more literals than they
#: hold), 200 strings (200 scalars a file), and 40 strings (3 blocks of the
#: launch's parameters for 8 files, 1 of the staged tables)
LONG_IN = ["a IN (%s)" % ", ".join(str(v) for v in range(-199, 201, 2)),
           "NOT (s IN ('gamma', %s))" % ", ".join(f"'w{i}'" for i in range(199)),
           "s IN ('beta', %s) OR a > 40" % ", ".join(f"'w{i}'" for i in range(39))]


@pytest.mark.parametrize("q", LONG_IN)
def test_residual_masks_past_the_launch_parameters_match_jax(q):
    """Long IN lists take K14's staged tables, one block over 8 files
    (each with its own dictionary), and match JAX's ``_mask_kernel`` file
    by file."""
    files = []
    for i, n in enumerate([0, 1, 300, 777, 1000, 1000, 999, 1000]):
        lanes, mapping = _lanes(seed=40 + i, n=1000, words=("alpha", "w7", "gamma", "w150"))
        files.append((lanes, mapping, n))
    program = _batched_against_jax(q, files)
    assert column_cache._k14_layout(program, 8) is column_cache._K14_GLOBAL
    assert column_cache._launch_groups(program, 8) == [(0, 8)]
    # the launch's parameters would take the short programs in more blocks
    if column_cache._fits_k14(program, column_cache._K14_PARAMS):
        assert len(column_cache._groups(program, 8, column_cache._K14_PARAMS)) == 3


def test_k14_staged_blocks():
    """The staged tables (``MaskGlobal``) of a 200-string IN over 70 files:
    20 files a block (4,096 scalars), int16 scalar slots, each file's codes
    in its own row of the scalar table."""
    q = "NOT (s IN ('gamma', %s))" % ", ".join(f"'w{i}'" for i in range(199))
    files = []
    for i in range(70):
        lanes, mapping = _lanes(seed=300 + i, n=64, words=("w3", "gamma", "alpha", "w198"))
        files.append((lanes, mapping, 64 - i % 7))
    _j, t = _plans(q)
    program, envs, scal = _port_program(t, [f[0] for f in files], [f[1] for f in files])
    ns = [f[2] for f in files]
    offs, _ = column_cache.mask_offsets(ns)
    ptrs = [p for env in envs for c in program.columns
            for p in (env[c].values.data_ptr(), env[c].valid.data_ptr())]
    layout = column_cache._k14_layout(program, 70)
    assert layout is column_cache._K14_GLOBAL
    raw = column_cache._param_blocks(program, ptrs, ns, scal, offs, layout)
    assert len(raw) == 4 and all(len(b) == 101696 for b in raw)
    names = sorted(program.scalar_slots)
    assert len(names) == 200 and len(program.lits) > 128
    for blk, lo in zip((np.frombuffer(bytes(b), layout)[0] for b in raw), (0, 20, 40, 60)):
        hi = min(lo + 20, 70)
        assert blk["hdr"][column_cache._H_FILES] == hi - lo
        assert blk["hdr"][column_cache._H_SCAL] == 200
        for k, name in enumerate(names):
            assert blk["lit_scal"][program.scalar_slots[name]] == k
        fscal = blk["fscal"][:200 * (hi - lo)].reshape(hi - lo, 200)
        for i in range(lo, hi):
            assert fscal[i - lo].tolist() == [scal[i][name][0] for name in names]
        assert blk["ins"][:len(program.instrs)].tolist() == program.instrs.tolist()
    _batched_against_jax(q, files[:10])


@pytest.mark.parametrize("kind", ["ints", "strings"])
def test_device_residual_masks_keep_a_long_in_list_on_the_device(tmp_path, kind):
    """A scan whose residual is an IN of 200 options stays on the device
    (``scan.device.fallback`` does not move, ``scan.device.engaged`` does)
    and returns the JAX package's per-file masks."""
    import pyarrow as pa

    import chip_smoke
    import delta_tpu_torch
    from delta_tpu.commands.write import WriteIntoDelta as JaxWrite
    from delta_tpu.log.deltalog import DeltaLog as JaxDeltaLog
    from delta_tpu.utils.config import conf as jax_conf

    n = 4000
    data = chip_smoke.config12_data(n)
    path = str(tmp_path / "long_in")
    tbl = pa.table({"id": data["id"], "price": data["price"], "qty": data["qty"],
                    "cat": pa.array(data["cat"].tolist(), pa.string()),
                    "ts": pa.array(data["ts"], pa.timestamp("us"))})
    with jax_conf.set_temporarily(**{"delta.tpu.write.targetFileRows": n // 4}):
        JaxWrite(JaxDeltaLog.for_table(path), "append", tbl).run()
    if kind == "ints":
        q = "price IN (%s)" % ", ".join(str(v) for v in range(0, 4000, 20))
        want_rows = int(np.isin(data["price"], np.arange(0, 4000, 20)).sum())
    else:
        words = ["eu-c", "ap-s"] + [f"x{i}" for i in range(198)]
        q = "cat IN (%s)" % ", ".join(f"'{w}'" for w in words)
        want_rows = int(np.isin(data["cat"], words).sum())
    jax_cc.ColumnCache.reset()
    jsnap = JaxDeltaLog.for_table(path).update()
    tsnap = delta_tpu_torch.DeltaLog.for_table(path, device="cpu").update()
    force = {"delta.tpu.read.deviceResidual.mode": "force"}
    with jax_conf.set_temporarily(**force):
        want = jax_cc.device_residual_masks(jsnap, jsnap.all_files, jax_parse(q))
    c0 = telemetry.counters("scan.device")
    with conf.set_temporarily(**force):
        got = column_cache.device_residual_masks(tsnap, tsnap.all_files, parse_predicate(q))
    c1 = telemetry.counters("scan.device")
    assert c1.get("scan.device.fallback", 0) == c0.get("scan.device.fallback", 0)
    assert c1.get("scan.device.engaged", 0) == c0.get("scan.device.engaged", 0) + 1
    assert want is not None and got is not None and sorted(got) == sorted(want)
    for f, m in want.items():
        assert np.array_equal(got[f], m), f
    assert sum(int(m.sum()) for m in got.values()) == want_rows > 0
    jax_cc.ColumnCache.reset()


def test_k14_parameter_blocks():
    """The parameter blocks the card's launch takes (``csrc/residual_mask.cu``'s
    MaskParams), packed on the host: the file table of each block, the
    per-file string codes, and the instructions computed once a tile."""
    files = []
    for i in range(70):
        n = [0, 1, 300][i % 3] if i < 6 else 500 + i
        lanes, mapping = _lanes(seed=200 + i, n=max(n, 64))
        files.append((lanes, mapping, n))
    _j, t = _plans("s = 'beta' AND a * 2 > 3 + 4")
    program, envs, scal = _port_program(t, [f[0] for f in files], [f[1] for f in files])
    ns = [f[2] for f in files]
    offs, _ = column_cache.mask_offsets(ns)
    ptrs = [p for env in envs for c in program.columns
            for p in (env[c].values.data_ptr(), env[c].valid.data_ptr())]
    assert column_cache._k14_layout(program, 70) is column_cache._K14_PARAMS
    raw = column_cache._param_blocks(program, ptrs, ns, scal, offs, column_cache._K14_PARAMS)
    assert len(raw) == 2 and all(len(b) == 14016 for b in raw)
    blocks = [np.frombuffer(bytes(b), column_cache._K14_PARAMS)[0] for b in raw]
    hdr = blocks[0]["hdr"]
    tile = int(hdr[column_cache._H_TILE])
    assert tile == column_cache._tile_rows(program) and tile in (256, 512, 1024, 2048)
    for blk, (lo, hi) in zip(blocks, [(0, 64), (64, 70)]):
        k = hi - lo
        assert blk["hdr"][column_cache._H_FILES] == k
        tiles = np.cumsum([(n + tile - 1) // tile for n in ns[lo:hi]])
        assert np.array_equal(blk["tile_end"][:k], tiles)
        assert blk["hdr"][column_cache._H_TILES] == tiles[-1]
        assert np.array_equal(blk["rows"][:k], ns[lo:hi])
        assert np.array_equal(blk["out_off"][:k], offs[lo:hi])
        cols = program.columns
        want_ptrs = [p for env in envs[lo:hi] for c in cols
                     for p in (env[c].values.data_ptr(), env[c].valid.data_ptr())]
        assert blk["ptr"][:len(want_ptrs)].tolist() == want_ptrs
        [slot] = program.scalar_slots.values()
        assert blk["lit_scal"][slot] == 0 and (blk["lit_scal"] >= 0).sum() == 1
        assert blk["fscal"][:k].tolist() == [s_[t.str_binds[0][0]][0] for s_ in scal[lo:hi]]
    ins = program.instrs
    usrc = blocks[0]["usrc"][:len(ins)]
    ops = [device_eval.OPS[o] for o in ins[:, 0]]
    assert all(usrc[pc, 0] == 1 for pc, op in enumerate(ops) if op == "LIT")
    assert all(usrc[pc, 0] == 0 for pc, op in enumerate(ops) if op == "COL")
    # 3 + 4 (and the literals' widening casts) are computed from literals
    # only, once a tile; a * 2 is not
    uniform = [op for op, u in zip(ops, usrc[:, 0]) if u == 1 and op != "LIT"]
    assert "ADD" in uniform and set(uniform) == {"ADD", "CAST"}
    mul = ops.index("MUL")
    assert usrc[mul, 0] == 0 and usrc[mul, 1] == -1  # a * 2: a per row, 2 from its slot
    assert ops[usrc[mul, 2]] in ("LIT", "CAST") and usrc[usrc[mul, 2], 0] == 1
    assert blocks[0]["hdr"][column_cache._H_ROOT_SLOT] == -1


def test_device_residual_masks_match_jax_on_config12(tmp_path):
    """``device_residual_masks`` (one batched call a query, one download)
    against the JAX package's per-file masks on bench config 12's seven
    queries at 8,000 rows in 8 files: one table, written by the JAX
    package, read by both."""
    import pyarrow as pa

    import chip_smoke
    import delta_tpu_torch
    from delta_tpu.commands.write import WriteIntoDelta as JaxWrite
    from delta_tpu.log.deltalog import DeltaLog as JaxDeltaLog
    from delta_tpu.utils.config import conf as jax_conf

    n = 8000
    data = chip_smoke.config12_data(n)
    path = str(tmp_path / "c12")
    tbl = pa.table({"id": data["id"], "price": data["price"], "qty": data["qty"],
                    "cat": pa.array(data["cat"].tolist(), pa.string()),
                    "ts": pa.array(data["ts"], pa.timestamp("us"))})
    with jax_conf.set_temporarily(**{"delta.tpu.write.targetFileRows": n // 8}):
        JaxWrite(JaxDeltaLog.for_table(path), "append", tbl).run()
    jax_cc.ColumnCache.reset()
    jsnap = JaxDeltaLog.for_table(path).update()
    tsnap = delta_tpu_torch.DeltaLog.for_table(path, device="cpu").update()
    assert len(tsnap.all_files) == 8
    force = {"delta.tpu.read.deviceResidual.mode": "force"}
    for name, q, mask in chip_smoke.config12_queries(n)(data):
        with jax_conf.set_temporarily(**force):
            want = jax_cc.device_residual_masks(jsnap, jsnap.all_files, jax_parse(q))
        with conf.set_temporarily(**force):
            got = column_cache.device_residual_masks(tsnap, tsnap.all_files,
                                                     parse_predicate(q))
        assert want is not None and got is not None and sorted(got) == sorted(want), name
        for f, m in want.items():
            assert np.array_equal(got[f], m), (name, f)
        assert sum(int(m.sum()) for m in got.values()) == int(mask.sum()), name
    jax_cc.ColumnCache.reset()


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

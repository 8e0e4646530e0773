"""The port's parser, row evaluator, partition pruning, predicate synthesis,
host prune and device prune (``delta_tpu_torch.expr``, ``ops/pruning``)
held against ``delta_tpu`` on the CPU, on the reference's own cases
(``tests/test_expr.py``, ``tests/test_synthesis.py``, ``tests/test_ops.py``)
and on seeded random predicates and tables.

Tolerance: exact equality everywhere — parse trees by ``sql()``, row
values, rewrites by ``sql()``, keep masks and file lists file for file,
every DataSize.
"""
import datetime as dt
import json

import numpy as np
import pytest

from delta_tpu.expr import ir as jir
from delta_tpu.expr import partition as jpart
from delta_tpu.expr.parser import parse_expression as jax_parse
from delta_tpu.log.deltalog import DeltaLog as JaxDeltaLog
from delta_tpu.ops import pruning as jprune
from delta_tpu.ops import state_export as jexport
from delta_tpu.ops.state_cache import DeviceStateCache as JaxCache
from delta_tpu.protocol.actions import AddFile as JaxAddFile
from delta_tpu.protocol.actions import Metadata as JaxMetadata
from delta_tpu.protocol.actions import Protocol as JaxProtocol
from delta_tpu.schema.char_varchar import replace_char_varchar_with_string
from delta_tpu.schema.types import CharType, LongType, StringType, StructType
from delta_tpu_torch import DeltaLog as TorchDeltaLog
from delta_tpu_torch.expr import ir as tir
from delta_tpu_torch.expr import partition as tpart
from delta_tpu_torch.expr import vectorized
from delta_tpu_torch.expr.parser import parse_expression as torch_parse
from delta_tpu_torch.ops import native
from delta_tpu_torch.ops import pruning as tprune
from delta_tpu_torch.ops import state_export as texport
from delta_tpu_torch.ops.state_cache import DeviceStateCache as TorchCache
from delta_tpu_torch.protocol.actions import action_from_json
from delta_tpu_torch.schema.types import parse_data_type
from tests import test_ops, test_synthesis
from tests.test_torch_scan import _assert_scans_equal
from tests.torch_port_tables import commit, write_table


@pytest.fixture(autouse=True)
def _fresh_caches():
    JaxCache.reset()
    TorchCache.reset()
    TorchDeltaLog.clear_cache()
    yield
    JaxCache.reset()
    TorchCache.reset()
    TorchDeltaLog.clear_cache()


def to_port(e):
    """The same expression tree, node for node, in the port's IR."""
    cls = getattr(tir, type(e).__name__)
    out = object.__new__(cls)
    out.__dict__.update(e.__dict__)
    out.children = tuple(to_port(c) for c in e.children)
    if isinstance(e, (jir.Literal, jir.Cast)):
        out.data_type = parse_data_type(e.data_type.json_value())
    return out


def port_file(f):
    return action_from_json(f.json())


def port_meta(m):
    return action_from_json(m.json())


# -- the parser and the row evaluator (tests/test_expr.py) ---------------------

EXPRESSIONS = [
    "1 + 2", "2 * 3 + 4", "2 + 3 * 4", "(2 + 3) * 4", "'it''s'", "TRUE", "NULL", "1.5e2", "-3",
    "1 < 2", "1 >= 2", "'a' = 'a'", "'a' != 'b'", "1 <> 2", "NULL = 1", "NULL AND FALSE",
    "NULL AND TRUE", "NULL OR TRUE", "NULL OR FALSE", "NOT NULL", "NULL <=> NULL", "1 <=> NULL",
    "3 IN (1, 2, 3)", "4 IN (1, 2, 3)", "4 NOT IN (1, 2, 3)", "NULL IN (1, 2)",
    "5 IN (1, NULL)", "5 BETWEEN 1 AND 10", "'abc' LIKE 'a%'", "'abc' LIKE 'a_c'",
    "'abc' NOT LIKE 'b%'", "NULL IS NULL", "1 IS NOT NULL", "CAST('12' AS INT)",
    "CAST(1 AS STRING)", "CAST('abc' AS INT)", "CAST('true' AS BOOLEAN)", "1 / 0", "1 % 0",
    "CASE WHEN 1 < 2 THEN 'a' ELSE 'b' END", "CASE WHEN 1 > 2 THEN 'a' END", "abs(-3)",
    "upper('ab')", "length('abc')", "concat('a', 'b')", "substring('hello', 2, 3)",
    "year(CAST('2021-03-05' AS DATE))", "7 % 3 * 2 - -1", "- - 4", "+ 5",
    "coalesce(NULL, 2, 3)", "startswith('abc', 'ab')", "CAST(2.5 AS DECIMAL(10, 2))",
    "date_add(to_date('2021-01-30'), 3)", "round(2.5)", "pow(2, 10)", "sqrt(-1)",
    "hour(7200000000)", "lpad('a', 3, '*')", "CAST(7 AS BIGINT) * 2",
]


#: expressions whose value is Spark's in the port and differs in delta_tpu:
#: (the port's value, delta_tpu's), tests/test_torch_spark_functions.py
SPARK_VALUES = {"round(2.5)": (3.0, 2.0)}


@pytest.mark.parametrize("sql", EXPRESSIONS)
def test_parse_tree_and_row_value_match_jax(sql):
    j, t = jax_parse(sql), torch_parse(sql)
    assert t.sql() == j.sql() and type(t).__name__ == type(j).__name__
    if sql in SPARK_VALUES:
        assert (t.eval({}), j.eval({})) == SPARK_VALUES[sql]
    else:
        assert t.eval({}) == j.eval({})


def test_columns_backticks_and_dotted_paths():
    row = {"id": 5, "name": "x", "weird col": 1}
    for sql in ["id > 3", "ID > 3", "name = 'x'", "`weird col` = 1"]:
        assert torch_parse(sql).eval(row) == jax_parse(sql).eval(row) is True
    e = torch_parse("a.b = 1")
    assert isinstance(e.left, tir.Column) and e.left.name == "a.b"


@pytest.mark.parametrize("bad", ["1 +", "nosuchfunc(1)", "a = 1 extra", "missing = 1",
                                 "CAST(a AS )", "CASE WHEN a THEN 1"])
def test_errors_raise_in_both(bad):
    from delta_tpu.utils.errors import DeltaAnalysisError as JaxError
    from delta_tpu_torch.utils.errors import DeltaAnalysisError as TorchError

    with pytest.raises(JaxError):
        jax_parse(bad).eval({"a": 1})
    with pytest.raises(TorchError):
        torch_parse(bad).eval({"a": 1})


def test_sql_roundtrip():
    for s in ["((a > 1) AND (b = 'x'))", "(a IN (1, 2))", "(a IS NULL)",
              "(abs((c1 - 5.5)) < 2)", "CASE WHEN (a > 1) THEN 2 ELSE 3 END"]:
        assert torch_parse(torch_parse(s).sql()) == torch_parse(s)
        assert torch_parse(s).sql() == jax_parse(s).sql()


# -- partition pruning ---------------------------------------------------------

@pytest.mark.parametrize("pred", ["part = 1", "part IS NULL", "part = 3", "date = 'a'",
                                  "part + 1 > 2", "d >= '2021-01-02'", "d = '2021-01-01'",
                                  "date LIKE 'a%' OR part = 3", "NOT (part = 1)"])
def test_partition_matches_match_jax(pred):
    from delta_tpu.schema.types import DateType as JDate

    schema = (StructType().add("id", LongType()).add("date", StringType())
              .add("part", LongType()).add("d", JDate()))
    jm = JaxMetadata(schema_string=schema.to_json(), partition_columns=["part", "date", "d"])
    tm = port_meta(jm)
    files = [JaxAddFile(f"f{i}", pv, 1, 1, True) for i, pv in enumerate([
        {"part": "1", "date": "a", "d": "2021-01-01"}, {"part": None, "date": "b", "d": ""},
        {"part": "3", "date": "", "d": "2021-01-05"}, {"part": "x", "date": "ab", "d": "bad"}])]
    for f in files:
        assert tpart.typed_partition_row(port_file(f), tm.partition_schema) == \
            jpart.typed_partition_row(f, jm.partition_schema)
        assert tpart.matches(torch_parse(pred), port_file(f), tm.partition_schema) == \
            jpart.matches(jax_parse(pred), f, jm.partition_schema)


def test_pad_char_literals_matches_jax():
    from delta_tpu.schema.char_varchar import pad_char_literals as jpad
    from delta_tpu_torch.schema.char_varchar import pad_char_literals as tpad

    schema = replace_char_varchar_with_string(
        StructType().add("c", CharType(5)).add("v", StringType()))
    jm = JaxMetadata(schema_string=schema.to_json())
    for sql in ["c = 'ab'", "'ab' < c", "c IN ('a', 'abcdefg')", "c = 'abcdefgh'",
                "v = 'ab'", "c LIKE 'a%'"]:
        assert tpad(torch_parse(sql), port_meta(jm)).sql() == jpad(jax_parse(sql), jm).sql()


# -- skipping rewrites and the two prunes, over the synthesis families --------

FAMILIES = {
    "arithmetic": test_synthesis._gen_arith,
    "string": test_synthesis._gen_string,
    "temporal": test_synthesis._gen_temporal,
    "conditional": test_synthesis._gen_conditional,
    "colcol": test_synthesis._gen_colcol,
    "compound": test_synthesis._gen_compound,
}
META = test_synthesis.META
TYPES = test_synthesis.TYPES


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_skipping_rewrites_and_prunes_match_jax(family):
    """Seeded random predicates per synthesis family over random files:
    the rewrite, its conjunct attribution, the host prune's keep mask and
    the device prune's keep mask (or its absence) all equal the JAX
    package's."""
    rng = np.random.default_rng(abs(hash(family)) % (2**32))
    tmeta = port_meta(META)
    n_device = 0
    for _ in range(28):
        files = [test_synthesis._addfile(i, test_synthesis._gen_rows(rng)) for i in range(4)]
        tfiles = [port_file(f) for f in files]
        jpred = FAMILIES[family](rng)
        tpred = to_port(jpred)
        assert tpred.sql() == jpred.sql()
        jrw = jprune.conjunct_rewrites([jpred], frozenset(), TYPES)
        trw = tprune.conjunct_rewrites([tpred], frozenset(), tprune.schema_types(tmeta))
        assert [(r.rewritten.sql(), r.attempted, r.synthesized, r.family) for r in trw] == \
            [(r.rewritten.sql(), r.attempted, r.synthesized, r.family) for r in jrw]
        jrew = jir.and_all([r.rewritten for r in jrw])
        trew = tir.and_all([r.rewritten for r in trw])
        jkeep = jprune._prune_host(files, META, jrew)
        tkeep = tprune._prune_host(tfiles, tmeta, trew)
        assert np.array_equal(tkeep, jkeep), (jpred.sql(), jrew.sql())
        jdev = jprune._prune_device(jexport.files_to_arrays(files, META), jrew)
        tdev = tprune._prune_device(texport.files_to_arrays(tfiles, tmeta), trew, "cpu")
        assert (tdev is None) == (jdev is None), jrew.sql()
        if jdev is not None:
            n_device += 1
            assert np.array_equal(tdev, jdev), jrew.sql()
    if family == "arithmetic":
        assert n_device >= 8


#: tests/test_synthesis.py's edge matrix and unit shapes
EDGE_PREDICATES = [
    "a * b > 10", "a / b > 2", "a / 0 > 2", "f * 2 > 100", "substr(s, 1, 4) = 'us-w'",
    "date_add(ts, 5) = '2021-06-06'", "a % 7 >= 100", "a % 7 < 3", "s * 2 > 5",
    "cast(s as long) > 5", "not a < 5", "not a >= 5", "not a != 5", "not a = 5",
    "not (a < 5 and b < 5)", "not f < 3000", "a * 2 + 10 >= 1000", "a * -2 >= 10",
    "100 - a < 40", "cast(f as long) = 10", "abs(a) < 10", "abs(a) > 100", "abs(a) < 0",
    "abs(a) <= -3", "abs(a) = -1", "abs(a) >= 0", "abs(a) * 2 > 100", "coalesce(a, 0) > 10",
    "coalesce(a, 100) > 10", "coalesce(a, b) > 10", "a < b", "a >= b", "a = b", "a < a",
    "a <= a", "f < a", "a < f", "d < ts", "year(d) = 2021", "to_date(ts) = '2021-02-01'",
    "s like 'écl%'", "substr(s, 1, 2) = 'éc'", "startswith(s, 'us')", "a + NULL > 1",
]
EDGE_ENVS = [
    {"numRecords": 5, "nullCount.a": 5, "nullCount.b": 0, "min.b": 1, "max.b": 2},
    {"numRecords": 3, "nullCount.s": 0, "min.s": "aa", "max.s": "bz", "min.f": -5.0,
     "max.f": 60.0},
    {"numRecords": 2, "nullCount.a": 0, "min.a": 50, "max.a": 99, "min.b": 0, "max.b": 1},
    {"numRecords": 2, "nullCount.a": 0, "min.a": -500, "max.a": 5, "min.d": "2021-01-01",
     "max.d": "2021-12-31", "min.ts": "2021-01-31T10:00:00.000Z",
     "max.ts": "2021-02-03T00:00:00.000Z"},
]


class _Env(dict):
    """Missing stats resolve to NULL, case-insensitively (the row-group
    tier's stats env)."""

    def __contains__(self, key):
        return True

    def __getitem__(self, key):
        return super().get(key.lower() if isinstance(key, str) else key)


@pytest.mark.parametrize("sql", EDGE_PREDICATES)
def test_synthesis_edge_rewrites_match_jax(sql):
    """The rewrite of each edge shape, and its row verdict over stats envs,
    equal the JAX package's."""
    from delta_tpu.exec.rowgroups import _StatsEnv

    jrw = jprune.skipping_predicate(jax_parse(sql), frozenset(), TYPES)
    trw = tprune.skipping_predicate(torch_parse(sql), frozenset(),
                                    tprune.schema_types(port_meta(META)))
    assert trw.sql() == jrw.sql()
    for env in EDGE_ENVS:
        jenv = _StatsEnv()
        for k, v in env.items():
            jenv[k.lower()] = v
        try:
            want = jrw.eval(jenv)
        except Exception as e:  # noqa: BLE001 — the error class must match too
            want = type(e).__name__
        try:
            got = trw.eval(_Env({k.lower(): v for k, v in env.items()}))
        except Exception as e:  # noqa: BLE001
            got = type(e).__name__
        assert got == want, (sql, env)


@pytest.mark.parametrize("sql", test_synthesis.E2E_PREDICATES + [
    "price * 2 + 10 >= 7000", "abs(price - 2000) < 10", "qty IS NULL OR price * 2 > 7000",
    "not (price < 3900)", "price != 5", "price > 5.5", "- price >= -50",
    "coalesce(qty, 0) > 6", "CASE WHEN qty > 3 THEN price ELSE 0 END > 3990",
    "hour(ts) = 3", "sym = 'us-w000001'", "sym IN ('eu-c002000', 'zz')"])
def test_synthesis_e2e_predicates_prune_alike(sql):
    """tests/test_synthesis.py's end-to-end predicates, over AddFiles with
    the synth table's schema: host and device keep masks equal JAX's."""
    from delta_tpu.schema.types import DoubleType, TimestampType

    schema = (StructType().add("id", LongType()).add("price", LongType())
              .add("qty", LongType()).add("sym", StringType()).add("ts", TimestampType())
              .add("f", DoubleType()))
    jm = JaxMetadata(schema_string=schema.to_json())
    tm = port_meta(jm)
    files = []
    for i in range(8):
        lo, hi = i * 500, i * 500 + 499
        stats = {"numRecords": 500,
                 "minValues": {"id": lo, "price": lo, "qty": 1, "sym": f"us-w{lo:06d}",
                               "ts": f"2021-01-{1 + i:02d}T00:00:00.000Z", "f": -1.5},
                 "maxValues": {"id": hi, "price": hi, "qty": 7, "sym": f"us-w{hi:06d}",
                               "ts": f"2021-01-{1 + i:02d}T23:00:00.000Z", "f": 2.5},
                 "nullCount": {"id": 0, "price": 0, "qty": i % 3, "sym": 0, "ts": 0, "f": 0}}
        files.append(JaxAddFile(path=f"p{i}", partition_values={}, size=10, modification_time=0,
                                data_change=True, stats=json.dumps(stats)))
    tfiles = [port_file(f) for f in files]
    jrw = jir.and_all([r.rewritten for r in jprune.conjunct_rewrites(
        [jax_parse(sql)], frozenset(), test_synthesis.synthesis.schema_types(jm))])
    trw = tir.and_all([r.rewritten for r in tprune.conjunct_rewrites(
        [torch_parse(sql)], frozenset(), tprune.schema_types(tm))])
    assert trw.sql() == jrw.sql()
    assert np.array_equal(tprune._prune_host(tfiles, tm, trw),
                          jprune._prune_host(files, jm, jrw)), sql
    jdev = jprune._prune_device(jexport.files_to_arrays(files, jm), jrw)
    tdev = tprune._prune_device(texport.files_to_arrays(tfiles, tm), trw, "cpu")
    assert (tdev is None) == (jdev is None)
    if jdev is not None:
        assert np.array_equal(tdev, jdev), sql


# -- the host table is typed as from_pylist types it ---------------------------


@pytest.mark.parametrize("values,kind", [
    ([1, 2.5, None], "double"), ([None, None], "null"), ([1, None, 3], "int"),
    (["a", None], "str"), ([True, False], "bool"), ([dt.date(2020, 1, 1), None], "date"),
    ([dt.datetime(2020, 1, 1, 5)], "ts"), ([dt.date(2020, 1, 1), dt.datetime(2020, 1, 2)], "date"),
    ([1.5, True], "double"), ([{"x": 1}, None], "object"),
])
def test_host_table_types_like_from_pylist(values, kind):
    import pyarrow as pa

    t = vectorized.table_from_rows([{"c": v} for v in values])
    assert t.column("c").kind == kind
    assert t.rows() == [{"c": v} for v in
                        pa.Table.from_pylist([{"c": v} for v in values]).column("c").to_pylist()]


@pytest.mark.parametrize("values", [["a", 1], [1, "a"], [True, 1], [1, True], [2**63],
                                    [1.5, 2**70], [dt.datetime(2020, 1, 1), dt.date(2020, 1, 1)],
                                    [{"x": 1}, 3], [True, 1.5]])
def test_host_table_raises_where_from_pylist_raises(values):
    import pyarrow as pa

    with pytest.raises(Exception):
        pa.Table.from_pylist([{"c": v} for v in values])
    with pytest.raises(vectorized.StatsTypeError):
        vectorized.table_from_rows([{"c": v} for v in values])


def test_mixed_string_and_int_stats_fail_the_scan_in_both(tmp_path):
    """A string stat mixed with an int one raises while the host table is
    built, outside the prune's error handling: the scan fails in both."""
    path = str(tmp_path / "t")
    schema = StructType().add("c", LongType())
    files = [JaxAddFile(path=f"f{i}", partition_values={}, size=1, modification_time=0,
                        data_change=True, stats=json.dumps(
                            {"numRecords": 1, "minValues": {"c": v}, "maxValues": {"c": v},
                             "nullCount": {"c": 0}}))
             for i, v in enumerate([1, "x", 3])]
    commit(path, 0, [JaxProtocol(1, 2), JaxMetadata(schema_string=schema.to_json())])
    commit(path, 1, files)
    jsnap = JaxDeltaLog.for_table(path).update()
    tsnap = TorchDeltaLog.for_table(path, device="cpu").update()
    with pytest.raises(Exception):
        jprune.files_for_scan(jsnap, [jax_parse("c IS NULL OR c > 2")])
    with pytest.raises(vectorized.StatsTypeError):
        tprune.files_for_scan(tsnap, [torch_parse("c IS NULL OR c > 2")])


# -- files_for_scan on a real log, the device leg (>= 4096 files) --------------

#: queries the resident planner declines (a strict float bound, a null
#: count, a multi-column interval, ...): they take the normal leg
DECLINED = [
    ["c0 IS NULL OR c1 * 2 > 19000"], ["c1 > 5.0"], ["NOT (c0 <= 4000000)"],
    ["c0 * c1 > 1e10"], ["coalesce(c0, 0) > 4190000"],
    ["CASE WHEN c0 > 5 THEN c1 ELSE 0 END > 9990"], ["c0 IN (5, 777777) OR c1 IS NULL"],
    ["c0 <= 20000 OR c1 > 9990"], ["c0 != 5 AND c1 < 9000.25"],
    ["c1 IS NOT NULL AND c1 <= 50"],
]
#: queries whose rewrite lowers exactly (synthesized, or UNKNOWN = keep all)
SERVED = [["c0 != 5"], ["abs(c1 - 5000.0) < 10"], ["c0 + 1 >= 5"], ["c0 >= -5"],
          ["cast(c1 as long) = 100"], ["c0 % 7 = 3"], ["hour(c1) = 3"]]


def _declined(path, queries):
    snap = TorchDeltaLog.for_table(path, device="cpu").update()
    for q in queries:
        filters = [torch_parse(s) for s in q]
        parts = [c for f in filters for c in tir.split_conjuncts(f)
                 if tpart.is_partition_predicate(c, snap.metadata.partition_columns)]
        data = [c for f in filters for c in tir.split_conjuncts(f) if c not in parts]
        assert tprune._resident_scan(snap, parts, data) is None, q


def test_device_leg_matches_jax_unpartitioned(tmp_path):
    path = str(tmp_path / "t")
    write_table(path, n_files=4200)
    _declined(path, DECLINED)
    before = dict(native.launches)
    _assert_scans_equal(path, DECLINED + SERVED)
    assert native.launches == before  # the CPU runs the plain versions


def test_device_leg_matches_jax_partitioned(tmp_path):
    path = str(tmp_path / "t")
    write_table(path, n_files=4200, partitioned=True)
    queries = [["day >= '2021-01-20' AND c1 > 9000.5"], ["day LIKE '2021-01-1%'"],
               ["day = '2021-01-05' OR c0 > 4000000"], ["bucket + 1 > 3 OR c1 < 5.0"],
               ["bucket IS NULL", "c1 > 7.5"], ["day = '2021-01-05'", "c1 > 100.5"]]
    _declined(path, DECLINED[:5] + queries)
    _assert_scans_equal(path, DECLINED[:5] + SERVED[:3] + queries)


def test_char_column_scans_match_jax(tmp_path):
    """char(n) literals pad on read (the refusal of the first slice is gone)."""
    path = str(tmp_path / "t")
    schema = replace_char_varchar_with_string(
        StructType().add("id", LongType()).add("code", CharType(4)))
    commit(path, 0, [JaxProtocol(1, 2), JaxMetadata(schema_string=schema.to_json())])
    rng = np.random.RandomState(5)
    adds = []
    for i in range(4100):
        c = f"{chr(97 + i % 26)}{chr(97 + (i // 26) % 26)}  "
        st = {"numRecords": 3, "minValues": {"id": i * 10, "code": c},
              "maxValues": {"id": i * 10 + int(rng.randint(1, 20)), "code": c},
              "nullCount": {"id": 0, "code": int(i % 11 == 0)}}
        adds.append(JaxAddFile(path=f"p{i:05d}", partition_values={}, size=i,
                               modification_time=0, data_change=True, stats=json.dumps(st)))
    commit(path, 1, adds)
    _assert_scans_equal(path, [["code = 'ab'"], ["code >= 'zz'"], ["code IN ('ab', 'cd')"],
                               ["id != 50"], ["id >= 100 AND id <= 400"], ["code IS NULL"],
                               ["id * 2 > 81000"]])


def test_exact_synthesized_rewrite_is_served_resident(tmp_path):
    """tests/test_synthesis.py:620: a synthesized numeric rewrite that
    lowers exactly to ranges is served by the resident planner."""
    path = str(tmp_path / "t")
    write_table(path, n_files=500)
    snap = TorchDeltaLog.for_table(path, device="cpu").update()
    for q in ["c0 * 2 + 10 >= 7000000", "c0 - 100 <= 4000000", "- c0 >= -50000"]:
        rw = tprune.conjunct_rewrites([torch_parse(q)], frozenset(),
                                      tprune.schema_types(snap.metadata))
        assert rw[0].synthesized
        assert tprune._resident_scan(snap, [], [torch_parse(q)]) is not None, q
    _assert_scans_equal(path, [["c0 * 2 + 10 >= 7000000"], ["c0 - 100 <= 4000000"]])


# -- tests/test_ops.py's pruning cases, through bare snapshots -----------------


class _Snap:
    version = 7

    def __init__(self, files, metadata):
        self.all_files = files
        self.metadata = metadata


def _both(files, sql_or_expr):
    jfiles = list(files)
    tfiles = [port_file(f) for f in jfiles]
    jm = test_ops._meta()
    if isinstance(sql_or_expr, str):
        jf, tf = jax_parse(sql_or_expr), torch_parse(sql_or_expr)
    else:
        jf, tf = sql_or_expr, to_port(sql_or_expr)
    js = jprune.files_for_scan(_Snap(jfiles, jm), [jf])
    ts = tprune.files_for_scan(_Snap(tfiles, port_meta(jm)), [tf])
    assert [f.path for f in ts.files] == [f.path for f in js.files]
    assert (ts.total, ts.partition, ts.scanned) == (
        tprune.DataSize(**vars(js.total)), tprune.DataSize(**vars(js.partition)),
        tprune.DataSize(**vars(js.scanned)))
    return [f.path for f in ts.files]


@pytest.mark.parametrize("sql", ["part = 'us'", "id = 150", "price >= 25.0", "id < 100",
                                 "part = 'eu' AND id <= 250", "id IN (5, 305)", "name IS NULL",
                                 "name IS NOT NULL", "name LIKE '%x%'", "name > 'zz'",
                                 "id > 2147483648", "id >= 2147483647", "part = 'us' OR id > 350",
                                 "name LIKE 'a%'", "substr(name, 1, 1) = 'z'", "price * 2 > 50"])
def test_ops_pruning_cases_match_jax(sql):
    _both(test_ops.FILES, sql)


def test_ops_edge_files_match_jax():
    no_stats = JaxAddFile(path="f5", partition_values={"part": "eu"}, size=10,
                          modification_time=0, data_change=True)
    null_part = JaxAddFile(path="fnull", partition_values={"part": None}, size=1,
                           modification_time=0, data_change=True)
    assert _both(test_ops.FILES + [no_stats], "id = 150") == ["f2", "f5"]
    assert _both(test_ops.FILES + [null_part], "part = 'us'") == ["f1", "f2"]
    f = test_ops._file("fx", "us", 0, 9, 1.0, 2.0)
    st = json.loads(f.stats)
    st["minValues"]["name"] = st["maxValues"]["name"] = "ap\U0001F600"
    fx = JaxAddFile(path="fx", partition_values={"part": "us"}, size=1000,
                    modification_time=0, data_change=True, stats=json.dumps(st))
    assert _both([fx], jir.StartsWith(jir.Column("name"), jir.Literal("ap"))) == ["fx"]
    assert _both([fx], jir.StartsWith(jir.Column("name"), jir.Literal("zz"))) == []
    big = dict(json.loads(test_ops.FILES[0].stats))
    big["minValues"] = dict(big["minValues"], id=2**53)
    big["maxValues"] = dict(big["maxValues"], id=2**53 + 1)
    fbig = JaxAddFile(path="fbig", partition_values={"part": "us"}, size=1,
                      modification_time=0, data_change=True, stats=json.dumps(big))
    assert _both([fbig], f"id > {2**53}") == ["fbig"]


def test_prefix_upper_bound_surrogates():
    assert tprune._prefix_upper_bound("퟿") == ""
    assert tprune._prefix_upper_bound("a") == "b"
    assert tprune._prefix_upper_bound("a\U0010FFFF") == "b"
    assert tprune._prefix_upper_bound("\U0010FFFF") is None

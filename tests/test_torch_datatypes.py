"""DECIMAL and nested (struct, list, map) data columns in the port, held
against ``delta_tpu`` on the CPU.

The decimal and nested cases of ``tests/test_datatypes.py`` (``ALL_TYPES``
round trip, checkpoint, schema JSON, stats, DML on a decimal, the nested
struct MERGE), the decimal cases of ``tests/test_schema_utils.py``,
``tests/test_expr_eval.py`` and ``tests/test_column_cache.py`` run through
both packages. Besides: files written by each package read by the other;
the four physical forms of a DECIMAL (INT32, INT64, FIXED_LEN_BYTE_ARRAY,
BYTE_ARRAY) at precisions 7 to 38 with their extreme values; filters and
UPDATE arithmetic over decimals against literals and columns of each type;
nested NULL against empty against NULL inside, through a deletion-vector
DELETE, a MERGE and OPTIMIZE.

Tolerance: exact everywhere (``Decimal`` values, rows, stats, Parquet rows).
Inputs come from a numpy seed.
"""
import datetime
import decimal
import io
import os
import struct
import tempfile

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from delta_tpu.api.tables import DeltaTable as JaxTable
from delta_tpu.exec import parquet as jpq
from delta_tpu.expr import jaxeval
from delta_tpu.expr import vectorized as jvec
from delta_tpu.expr.parser import parse_expression as jax_parse_expression
from delta_tpu.expr.parser import parse_predicate as jax_parse
from delta_tpu.log.deltalog import DeltaLog as JaxDeltaLog
from delta_tpu.schema import schema_utils as jsu
from delta_tpu.schema import types as JT
from delta_tpu.utils.errors import SchemaMismatchError as JaxSchemaMismatch
from delta_tpu_torch import DeltaLog as TorchDeltaLog
from delta_tpu_torch.exec import encodings as enc
from delta_tpu_torch.exec import parquet as tpq
from delta_tpu_torch.exec import rowgroups as trg
from delta_tpu_torch.exec import thrift
from delta_tpu_torch.expr import device_eval
from delta_tpu_torch.expr import vectorized as tvec
from delta_tpu_torch.expr.parser import parse_expression as torch_parse_expression
from delta_tpu_torch.expr.parser import parse_predicate as torch_parse
from delta_tpu_torch.schema import schema_utils as tsu
from delta_tpu_torch.schema import types as TT
from delta_tpu_torch.utils.errors import SchemaMismatchError as TorchSchemaMismatch
from tests.torch_dml_tables import (
    DV_PROPS, assert_same_end_state, copies, create, metrics, observe, rows, table,
)
from tests.torch_port_tables import Pkg, both_confs, sorted_rows

D = decimal.Decimal
EXACT = decimal.Context(prec=80)
JAX, TORCH = Pkg("jax"), Pkg("torch")

ALL_TYPES = pa.table({
    "b": pa.array([True, False, None]),
    "i8": pa.array([1, -2, None], pa.int8()),
    "i16": pa.array([300, -300, None], pa.int16()),
    "i32": pa.array([70_000, -70_000, None], pa.int32()),
    "i64": pa.array([2**40, -(2**40), None], pa.int64()),
    "f32": pa.array([1.5, -2.5, None], pa.float32()),
    "f64": pa.array([1e300, -1e-300, None], pa.float64()),
    "s": pa.array(["héllo", "", None]),
    "bin": pa.array([b"\x00\xff", b"", None], pa.binary()),
    "d": pa.array([datetime.date(2024, 2, 29), datetime.date(1970, 1, 1), None]),
    "ts": pa.array([datetime.datetime(2024, 5, 1, 12, 30, 45, 123456),
                    datetime.datetime(1970, 1, 1), None], pa.timestamp("us")),
    "dec": pa.array([D("123.45"), D("-0.01"), None], pa.decimal128(10, 2)),
    "arr": pa.array([[1, 2], [], None], pa.list_(pa.int64())),
    "m": pa.array([{"k": 1}, {}, None], pa.map_(pa.string(), pa.int64())),
    "st": pa.array([{"x": 1, "y": "a"}, {"x": None, "y": None}, None],
                   pa.struct([("x", pa.int64()), ("y", pa.string())])),
})
ST = ("struct", (("x", "int64"), ("y", "string")))
ARR = ("list", "int64")
MAP = ("map", "string", "int64")


@pytest.fixture(autouse=True)
def _fresh_logs():
    JaxDeltaLog.clear_cache()
    TorchDeltaLog.clear_cache()
    yield
    JaxDeltaLog.clear_cache()
    TorchDeltaLog.clear_cache()


def host(t: pa.Table) -> tvec.HostTable:
    """A pyarrow table as the port's HostTable, through a pyarrow-written
    file and the port's reader."""
    fd, path = tempfile.mkstemp(suffix=".parquet")
    os.close(fd)
    try:
        pq.write_table(t, path)
        return tpq.read_parquet_file(path, device="cpu")
    finally:
        os.remove(path)


def port_write(path, data: tvec.HostTable, mode="append", **kw):
    from delta_tpu_torch.commands.write import WriteIntoDelta as TorchWrite

    TorchWrite(TorchDeltaLog.for_table(path, device="cpu"), mode, data, **kw).run()


# -- tests/test_datatypes.py, through both packages ---------------------------------


def test_all_types_round_trip_across_packages(tmp_path):
    """Each package reads the table the other wrote to ``pyarrow``'s rows
    of ``ALL_TYPES`` (a map as its list of pairs, a decimal exact)."""
    want = ALL_TYPES.to_pylist()
    jpath, tpath = str(tmp_path / "jax"), str(tmp_path / "torch")
    JaxTable.create(jpath, data=ALL_TYPES)
    port_write(tpath, host(ALL_TYPES))
    for path in (jpath, tpath):
        JaxDeltaLog.clear_cache()
        TorchDeltaLog.clear_cache()
        assert JaxTable.for_path(path).to_arrow().to_pylist() == want, path
        got = table("torch", path).to_table().to_pylist()
        assert got == want, path
        assert type(got[0]["dec"]) is D and str(got[1]["dec"]) == "-0.01"
    # the two files' columns read by pyarrow: the same types and values
    for path in (jpath, tpath):
        [f] = JaxDeltaLog.for_table(path).update().all_files
        t = pq.read_table(f"{path}/{f.path}")
        assert t.schema.field("dec").type == pa.decimal128(10, 2)
        assert t.to_pylist() == want


def test_all_types_survive_each_packages_checkpoint(tmp_path):
    src = str(tmp_path / "src")
    create(src, ALL_TYPES, configuration={"delta.checkpoint.writeStatsAsStruct": "true"})
    paths = copies(src, tmp_path)
    TorchDeltaLog.for_table(paths["torch"], device="cpu").checkpoint()
    JaxDeltaLog.for_table(paths["jax"]).checkpoint()
    by_add = {name: [r["add"] for r in pq.read_table(
        f"{path}/_delta_log/00000000000000000000.checkpoint.parquet").to_pylist() if r["add"]]
        for name, path in paths.items()}
    assert by_add["torch"] == by_add["jax"]
    [add] = by_add["torch"]
    assert add["stats_parsed"]["nullCount"]["dec"] == 1
    assert add["stats_parsed"]["minValues"]["dec"] is None
    assert add["stats_parsed"]["minValues"]["arr"] is None
    for path in paths.values():
        JaxDeltaLog.clear_cache()
        TorchDeltaLog.clear_cache()
        assert rows("torch", path) == rows("jax", path) == sorted_rows(ALL_TYPES.to_pylist())


def test_schema_json_round_trips_every_type(tmp_path):
    path = str(tmp_path / "t")
    JaxTable.create(path, data=ALL_TYPES)
    jax_schema = JaxDeltaLog.for_table(path).update().metadata.schema_string
    port = tsu.schema_from_table(host(ALL_TYPES))
    assert port.to_json() == jax_schema
    names = {f.name: f.data_type.simple_string() for f in port.fields}
    assert names == {f.name: f.data_type.simple_string()
                     for f in JT.schema_from_json(jax_schema).fields}
    assert names["dec"] == "decimal(10,2)" and names["arr"].startswith("array")
    assert names["st"].startswith("struct") and names["m"].startswith("map")
    for f in port.fields:  # and back: the declared type's stored type maps to it
        _, stype = tsu.stored_type_for(f.data_type)
        assert tsu._delta_type_of(stype) == f.data_type, f.name


def test_stats_min_max_for_orderable_types():
    """``nullCount`` only for the decimal and nested columns, bounds for the
    rest, equal to the JAX package's stats."""
    t = host(ALL_TYPES)
    assert tpq.collect_stats(t) == jpq.collect_stats(ALL_TYPES)
    s = tpq.collect_stats(t)
    assert "dec" not in s["minValues"] and s["nullCount"]["dec"] == 1
    assert {k: s["nullCount"][k] for k in ("arr", "m", "st")} == {"arr": 1, "m": 1, "st": 1}


def test_v2_checkpoint_with_decimal_column(tmp_path):
    src = str(tmp_path / "src")
    create(src, pa.table({"dec": pa.array([D("1.10")], pa.decimal128(10, 2))}),
           configuration={"delta.checkpoint.writeStatsAsStruct": "true"})
    paths = copies(src, tmp_path)
    TorchDeltaLog.for_table(paths["torch"], device="cpu").checkpoint()
    JaxDeltaLog.for_table(paths["jax"]).checkpoint()
    for path in paths.values():
        JaxDeltaLog.clear_cache()
        TorchDeltaLog.clear_cache()
        assert rows("torch", path) == rows("jax", path) == [{"dec": D("1.10")}]


@pytest.mark.parametrize("dv", [False, True])
def test_dml_on_decimal_and_timestamp(tmp_path, dv):
    def build(src):
        create(src, pa.table({
            "id": pa.array([1, 2], pa.int64()),
            "dec": pa.array([D("1.10"), D("2.20")], pa.decimal128(10, 2)),
            "ts": pa.array([datetime.datetime(2024, 1, 1), datetime.datetime(2024, 6, 1)],
                           pa.timestamp("us"))}), DV_PROPS if dv else None)

    src = str(tmp_path / "src")
    build(src)
    paths = copies(src, tmp_path)
    out = {n: observe(lambda: table(n, paths[n]).delete("ts < '2024-03-01'")) for n in paths}
    assert metrics(out["torch"]) == metrics(out["jax"])
    got = assert_same_end_state(paths)
    assert [(r["id"], r["dec"]) for r in got] == [(2, D("2.20"))]


def test_nested_struct_merge_values(tmp_path):
    out = {}
    for pkg in (JAX, TORCH):
        path = str(tmp_path / pkg.name)
        log = pkg.write(path, {"id": [1, 2], "s": (ST, [{"x": 1, "y": "a"},
                                                          {"x": 2, "y": "b"}])})
        pkg.merge(log, {"id": [2, 3], "s": (ST, [{"x": 20, "y": "B"}, {"x": 30, "y": "C"}])},
                  "t.id = s.id", [("update",)], [("insert",)],
                  source_alias="s", target_alias="t")
        out[pkg.name] = path
    for path in out.values():
        for pkg in ("jax", "torch"):
            got = sorted(rows(pkg, path), key=lambda r: r["id"])
            assert [r["s"] for r in got] == [{"x": 1, "y": "a"}, {"x": 20, "y": "B"},
                                             {"x": 30, "y": "C"}]


# -- tests/test_schema_utils.py, tests/test_expr_eval.py, tests/test_column_cache.py -----


@pytest.mark.parametrize("cur,new,msg", [
    ((10, 2), (12, 2), "precision 10 and 12"),
    ((10, 2), (10, 4), "scale 2 and 4"),
    ((10, 2), (12, 4), "precision 10 and 12"),
])
def test_decimal_mismatch_errors(cur, new, msg):
    got = {}
    for mod, T, err in ((jsu, JT, JaxSchemaMismatch), (tsu, TT, TorchSchemaMismatch)):
        s = lambda ps: T.StructType().add("d", T.DecimalType(*ps))
        with pytest.raises(err, match=msg) as e:
            mod.merge_schemas(s(cur), s(new))
        got[mod] = str(e.value)
    assert got[tsu] == got[jsu]


def _both_eval(expr: str, t: pa.Table, predicate=False):
    """``expr`` over ``t`` in both evaluators: (JAX values, port values)."""
    jp, tp = (jax_parse, torch_parse) if predicate else (jax_parse_expression,
                                                         torch_parse_expression)
    want = jvec.evaluate(jp(expr), t)
    got = tvec.evaluate(tp(expr), host(t))
    return want.to_pylist(), tvec._to_python(got), want.type, got


def test_vectorized_round_parity_on_decimals():
    """The port's ``round`` of a decimal is Spark's, half up, where Arrow's
    (the JAX package's) is half to even: the type, NULLs and every value
    away from a tie agree; at a tie each package keeps its own rule."""
    x = [D("1.25"), D("2.50"), None, D("-0.50"), D("2.67"), D("0.15"), D("-2.50")]
    t = pa.table({"x": pa.array(x, pa.decimal128(7, 2))})
    for e, digits in (("round(x, 2)", 2), ("round(x, 1)", 1), ("round(x)", 0),
                      ("round(x, 0)", 0)):
        want, got, _, _ = _both_eval(e, t)
        assert [type(v) for v in got] == [type(v) for v in want], e
        unit = D(1).scaleb(-digits)
        for v, j, g in zip(x, want, got):
            if v is None:
                assert j is g is None
                continue
            assert g == v.quantize(unit, decimal.ROUND_HALF_UP), (e, v)
            assert j == v.quantize(unit, decimal.ROUND_HALF_EVEN), (e, v)


@pytest.mark.parametrize("bad", ["m > 5", "m = 1.5", "m IS NULL OR m < 0"])
def test_residual_decimal_stays_on_host(bad):
    jt = {"a": JT.IntegerType(), "m": JT.DecimalType(10, 2)}
    tt = {"a": TT.IntegerType(), "m": TT.DecimalType(10, 2)}
    with pytest.raises(jaxeval.NotDeviceCompilable):
        jaxeval.compile_residual(jax_parse(bad), jt, ())
    with pytest.raises(device_eval.NotDeviceCompilable):
        device_eval.compile_residual(torch_parse(bad), tt, ())


# -- the evaluator: Arrow's decimal semantics -------------------------------------------


def _dec_table(seed=0, n=40):
    rng = np.random.RandomState(seed)
    price = [None if k % 9 == 4 else D(int(v)).scaleb(-2)
             for k, v in enumerate(rng.randint(-10**7 + 1, 10**7, n))]
    price[:4] = [D("45.50"), D("45.49"), D("-0.01"), D("99999.99")]
    return pa.table({
        "price": pa.array(price, pa.decimal128(7, 2)),
        "disc": pa.array([D(int(v)).scaleb(-3) for v in rng.randint(-10**6, 10**6, n)],
                         pa.decimal128(10, 3)),
        "big": pa.array([D(int(v) * 10**25 + 7).scaleb(-4, context=EXACT)
                         for v in rng.randint(-10**9, 10**9, n)], pa.decimal128(38, 4)),
        "q": pa.array([None if k % 7 == 1 else int(v) for k, v in
                       enumerate(rng.randint(-100, 100, n))], pa.int64()),
        "q32": pa.array(rng.randint(-100, 100, n).astype(np.int32)),
        "f": pa.array(rng.randn(n) * 100),
        "s": pa.array([f"{v:.2f}" for v in rng.randn(n)]),
    })


EXPRS = [
    "price > 45.5", "price >= 45.5", "price = 45.5", "price < 45", "price > 45",
    "price <= q", "price = disc", "price > disc", "price < f", "big > 5", "big = big",
    "price = '45.50'", "price * q", "price + q", "price - q32", "price * q32", "price + disc",
    "price * disc", "price - disc", "price / q", "price / disc", "disc / q32", "q / price",
    "price * 1.5", "price + f", "price / 2.0", "-price", "abs(price)", "floor(price)",
    "ceil(disc)", "price * price * price", "big * big", "big + big", "big + 1",
    "CAST(price AS DOUBLE)", "CAST(price AS FLOAT)", "CAST(price AS BIGINT)",
    "CAST(price AS INT)", "CAST(price AS STRING)", "CAST(disc AS DECIMAL(7,2))",
    "CAST(price AS DECIMAL(12,4))", "CAST(q AS DECIMAL(21,2))", "CAST(q AS DECIMAL(7,2))",
    "CAST(f AS DECIMAL(9,2))", "coalesce(price, q)", "coalesce(price, disc)",
    "price IN (1, 2, 45)", "price IN (45.5, 1)", "price IS NULL", "price IS NOT NULL",
    "price <=> disc", "NOT (price > 0)", "price > 0 AND q > 0",
    "disc IN (0.001, -1, 2)", "big IN (5, 0)", "CAST(big AS DOUBLE)", "CAST(big AS BIGINT)",
    "CAST(big AS STRING)", "CAST(disc AS SMALLINT)", "big > 5.5", "big * 1.5",
]


@pytest.mark.parametrize("expr", EXPRS)
def test_decimal_expressions_match_arrow(expr):
    """Each result equals the JAX package's (Arrow's kernels, or its row
    fallback where Arrow raises): the values exactly, and a decimal's
    type."""
    t = _dec_table()
    want, got, wtype, gcol = _both_eval(expr, t)
    assert got == want, expr
    if pa.types.is_decimal(wtype):
        assert gcol.type == str(wtype), expr


# -- the Parquet codec: the four physical forms -----------------------------------------


def _extremes(p, s, n=50, seed=3):
    rng = np.random.RandomState(seed + p)
    top = 10 ** p - 1
    ints = [top, -top, 0, 1, -1] + [int(x) for x in rng.randint(-2**62, 2**62, n)]
    ints = [((v % (2 * top + 1)) - top) for v in ints[5:]]
    vals = [D(v).scaleb(-s, context=EXACT) for v in [top, -top, 0, 1, -1] + ints]
    return [None if k % 11 == 6 else v for k, v in enumerate(vals)]


@pytest.mark.parametrize("p,s", [(7, 2), (10, 3), (15, 0), (18, 6), (30, 10), (38, 4),
                                 (38, 0)])
@pytest.mark.parametrize("as_int", [False, True])
@pytest.mark.parametrize("dictionary", [False, True])
def test_decimal_physical_forms_read_like_pyarrow(tmp_path, p, s, as_int, dictionary):
    """FIXED_LEN_BYTE_ARRAY (``pyarrow``'s default) and INT32/INT64
    (``store_decimal_as_integer``), PLAIN and dictionary pages, several row
    groups: the port reads ``pyarrow``'s values, and its footer bounds."""
    vals = _extremes(p, s)
    t = pa.table({"x": pa.array(vals, pa.decimal128(p, s)), "k": list(range(len(vals)))})
    path = str(tmp_path / "d.parquet")
    pq.write_table(t, path, store_decimal_as_integer=as_int, use_dictionary=dictionary,
                   row_group_size=20)
    meta = pq.ParquetFile(path).metadata
    ptype = meta.row_group(0).column(0).physical_type
    assert ptype == ("FIXED_LEN_BYTE_ARRAY" if not as_int or p > 18 else
                     "INT32" if p <= 9 else "INT64")
    got = tpq.read_parquet_file(path, device="cpu")
    assert got.to_pylist() == t.to_pylist()
    assert got.columns["x"].type == f"decimal128({p}, {s})"
    assert got.columns["x"].values.dtype == (object if p > 18 else np.int64)
    tmeta = tpq.read_metadata(path)
    for rg in range(meta.num_row_groups):
        st = meta.row_group(rg).column(0).statistics
        mine = tpq.chunk_statistics(tmeta, rg, 0)
        assert mine[0] == st.null_count
        assert mine[1] == (st.min, st.max)


def _byte_array_decimal_file(path, values, p, s):
    """A file whose DECIMAL column is stored as BYTE_ARRAY (minimal
    big-endian two's complement a value), as some writers store it."""
    valid = np.array([v is not None for v in values])
    unscaled = [int(v.scaleb(s, context=EXACT)) for v in values if v is not None]
    raw = [u.to_bytes(max(1, (u.bit_length() + 8) // 8), "big", signed=True) for u in unscaled]
    levels = enc.encode_hybrid_bits(valid)
    body = struct.pack("<I", len(levels)) + levels + enc.encode_plain(enc.BYTE_ARRAY, raw)
    header = thrift.PageHeader(
        type=0, uncompressed_page_size=len(body), compressed_page_size=len(body),
        data_page_header=thrift.DataPageHeader(num_values=len(values), encoding=enc.PLAIN,
                                               definition_level_encoding=enc.RLE,
                                               repetition_level_encoding=enc.RLE)).write()
    out = bytearray(b"PAR1")
    offset = len(out)
    out += header + body
    md = thrift.ColumnMetaData(type=enc.BYTE_ARRAY, encodings=[enc.PLAIN, enc.RLE],
                               path_in_schema=["x"], codec=0, num_values=len(values),
                               total_uncompressed_size=len(header) + len(body),
                               total_compressed_size=len(header) + len(body),
                               data_page_offset=offset)
    schema = [thrift.SchemaElement(name="schema", num_children=1),
              thrift.SchemaElement(type=enc.BYTE_ARRAY, repetition_type=1, name="x",
                                   converted_type=5, scale=s, precision=p)]
    meta = thrift.FileMetaData(version=1, schema=schema, num_rows=len(values), row_groups=[
        thrift.RowGroup(columns=[thrift.ColumnChunk(file_offset=offset, meta_data=md)],
                        total_byte_size=len(body), num_rows=len(values))])
    footer = meta.write()
    out += footer + struct.pack("<I", len(footer)) + b"PAR1"
    with open(path, "wb") as f:
        f.write(out)


@pytest.mark.parametrize("p,s", [(7, 2), (18, 3), (38, 0), (38, 10)])
def test_byte_array_decimal_reads_like_pyarrow(tmp_path, p, s):
    vals = _extremes(p, s, n=20)
    path = str(tmp_path / "b.parquet")
    _byte_array_decimal_file(path, vals, p, s)
    want = pq.read_table(path)
    assert want.column("x").to_pylist() == vals  # the legacy converted type
    assert tpq.read_parquet_file(path, device="cpu").to_pylist() == want.to_pylist()


@pytest.mark.parametrize("p,s", [(7, 2), (10, 2), (15, 5), (18, 0), (30, 10), (38, 4)])
def test_port_decimal_files_read_by_pyarrow(tmp_path, p, s):
    """The port's writer: FIXED_LEN_BYTE_ARRAY of ``pyarrow``'s width, the
    footer's bounds in signed order, row groups cut as configured."""
    vals = _extremes(p, s)
    t = pa.table({"x": pa.array(vals, pa.decimal128(p, s))})
    path = str(tmp_path / "w.parquet")
    with TORCH.conf.set_temporarily(**{"delta.tpu.write.rowGroupRows": 16}):
        tpq.write_parquet_file(host(t), path, device="cpu")
    assert pq.read_table(path).to_pylist() == t.to_pylist()
    meta = pq.ParquetFile(path).metadata
    ref = io.BytesIO()
    pq.write_table(t, ref, row_group_size=16)
    ref_meta = pq.ParquetFile(pa.BufferReader(ref.getvalue())).metadata
    assert meta.num_row_groups == ref_meta.num_row_groups == 4
    for rg in range(meta.num_row_groups):
        a, b = meta.row_group(rg).column(0), ref_meta.row_group(rg).column(0)
        assert a.physical_type == b.physical_type == "FIXED_LEN_BYTE_ARRAY"
        assert (a.statistics.min, a.statistics.max, a.statistics.null_count) == \
            (b.statistics.min, b.statistics.max, b.statistics.null_count)
    assert pq.ParquetFile(path).schema_arrow.field("x").type == pa.decimal128(p, s)


def test_nested_columns_split_at_record_boundaries(tmp_path):
    """A nested column's chunks cut at the flat columns' row boundaries."""
    rng = np.random.RandomState(5)
    n = 100
    arr = [None if k % 13 == 0 else [int(x) for x in rng.randint(0, 9, rng.randint(0, 6))]
           for k in range(n)]
    m = [None if k % 11 == 0 else {f"k{j}": j * k for j in range(rng.randint(0, 4))}
         for k in range(n)]
    st = [None if k % 7 == 0 else {"x": None if k % 5 == 0 else k, "y": f"v{k}"}
          for k in range(n)]
    t = pa.table({"id": list(range(n)), "arr": pa.array(arr, pa.list_(pa.int64())),
                  "m": pa.array(m, pa.map_(pa.string(), pa.int64())),
                  "st": pa.array(st, pa.struct([("x", pa.int64()), ("y", pa.string())]))})
    path = str(tmp_path / "n.parquet")
    with TORCH.conf.set_temporarily(**{"delta.tpu.write.rowGroupRows": 17}):
        tpq.write_parquet_file(host(t), path, device="cpu")
    f = pq.ParquetFile(path)
    assert f.metadata.num_row_groups == 6
    assert all(f.metadata.row_group(i).num_rows == min(17, n - 17 * i) for i in range(6))
    assert pq.read_table(path).to_pylist() == t.to_pylist()
    got = tpq.read_parquet_file(path, row_groups=[4, 1], device="cpu")
    assert got.to_pylist() == [t.slice(68, 17).to_pylist() + t.slice(17, 17).to_pylist()][0]


# -- the table path: filters, UPDATE arithmetic, overflow -------------------------------


def _money(src, dv=False, n=60, seed=2):
    rng = np.random.RandomState(seed)
    create(src, pa.table({
        "id": pa.array(np.arange(n), pa.int64()),
        "qty": pa.array(rng.randint(1, 100, n), pa.int64()),
        "price": pa.array([D(int(v)).scaleb(-2) for v in rng.randint(0, 10000, n)],
                          pa.decimal128(7, 2)),
        "paid": pa.array([None if k % 10 == 3 else D(int(v)).scaleb(-2)
                          for k, v in enumerate(rng.randint(0, 9000, n))], pa.decimal128(7, 2)),
        "wide": pa.array([D(int(v) * 10**20) for v in rng.randint(-10**6, 10**6, n)],
                         pa.decimal128(38, 2)),
    }), DV_PROPS if dv else None)
    from delta_tpu.commands.write import WriteIntoDelta

    WriteIntoDelta(JaxDeltaLog.for_table(src), "append", pa.table({
        "id": pa.array([n, n + 1], pa.int64()), "qty": pa.array([5, None], pa.int64()),
        "price": pa.array([D("45.50"), D("99999.99")], pa.decimal128(7, 2)),
        "paid": pa.array([D("45.00"), D("45.01")], pa.decimal128(7, 2)),
        "wide": pa.array([D(10**36 - 1), D(-(10**36) + 1)], pa.decimal128(38, 2))})).run()


FILTERS = ["paid > 45.00", "paid > 45", "paid >= 45.0", "paid = 45", "price < qty",
           "price * qty > 1000", "paid IS NULL", "price IN (45, 1)", "wide > 0",
           "wide < -1000000000000000000", "CAST(price AS DOUBLE) > 50.5",
           "price / qty > 2", "paid > 45.00 AND id > 10", "paid + 0.5 > 50"]


@pytest.mark.parametrize("pred", FILTERS)
def test_filters_over_decimals_match_jax(tmp_path, pred):
    src = str(tmp_path / "src")
    _money(src)
    assert rows("torch", src, filters=[pred]) == rows("jax", src, filters=[pred])
    for mode in ("off", "force"):
        with both_confs(**{"delta.tpu.read.deviceResidual.mode": mode}):
            assert rows("torch", src, filters=[pred]) == rows("jax", src, filters=[pred])


def test_a_literal_past_int64_fails_in_both(tmp_path):
    """Neither package types an integer literal past int64 (Arrow has no
    scalar for it, and its row fallback makes none either)."""
    src = str(tmp_path / "src")
    _money(src)
    pred = "wide < -100000000000000000000"
    assert observe(lambda: rows("jax", src, filters=[pred])) == "OverflowError"
    assert observe(lambda: rows("torch", src, filters=[pred])) == "StatsTypeError"


UPDATES = [
    ({"paid": "price * qty"}, "qty < 50"),      # decimal(27,2) cast into (7,2): overflow kept
    ({"paid": "price + 1"}, None),
    ({"paid": "price * 1.5"}, "id % 2 = 0"),   # a double cast into (7,2), half to even
    ({"paid": "price / qty"}, None),           # a scale cut: truncated toward zero
    ({"paid": "-paid"}, "paid > 45.00"),
    ({"price": "coalesce(paid, price)"}, None),
    ({"wide": "wide * 10"}, None),
    ({"wide": "price"}, "id < 5"),
    ({"paid": "qty"}, None),                   # int64 into (7,2): the mismatch error
    ({"paid": "CAST(qty AS DECIMAL(21,2))"}, None),
]


@pytest.mark.parametrize("dv", [False, True])
@pytest.mark.parametrize("case", range(len(UPDATES)))
def test_update_arithmetic_over_decimals(tmp_path, case, dv):
    src = str(tmp_path / "src")
    _money(src, dv=dv)
    paths = copies(src, tmp_path)
    sets, where = UPDATES[case]
    out = {n: observe(lambda: table(n, paths[n]).update(sets, where)) for n in paths}
    if isinstance(out["jax"], str):
        assert out["torch"] == out["jax"] == "DeltaAnalysisError"
        return
    assert metrics(out["torch"]) == metrics(out["jax"])
    if "1.5" not in sets.get("paid", ""):
        assert_same_end_state(paths)
        return
    # a double cast into decimal(7,2): the port rounds the double's shortest
    # form half up (Spark's cast), the JAX package its binary value half to
    # even; each package reads both copies alike, and the copies differ only
    # at ties, by one cent, where the port's is Spark's
    for name in paths:
        assert rows("torch", paths[name]) == rows("jax", paths[name])
    ties = 0
    for j, t in zip(*(sorted(rows("jax", paths[n]), key=lambda r: r["id"]) for n in
                      ("jax", "torch"))):
        if j == t:
            continue
        assert {k for k in j if j[k] != t[k]} == {"paid"}
        exact = D(repr(float(j["price"]) * 1.5))
        assert exact.as_tuple().exponent == -3 and exact.as_tuple().digits[-1] == 5
        assert t["paid"] == exact.quantize(D("0.01"), decimal.ROUND_HALF_UP)
        ties += 1
    assert ties > 0


def test_update_overflow_keeps_the_low_bytes(tmp_path):
    """``price * qty`` past ``decimal(7, 2)``: Arrow's unsafe cast keeps the
    value, the Parquet writer its low 4 bytes; both packages write, and
    read, the same wrapped values."""
    src = str(tmp_path / "src")
    create(src, pa.table({"id": pa.array([1, 2, 3], pa.int64()),
                          "qty": pa.array([1, 100, 10**6], pa.int64()),
                          "price": pa.array([D("99999.99")] * 3, pa.decimal128(7, 2))}))
    paths = copies(src, tmp_path)
    for n in paths:
        table(n, paths[n]).update({"price": "price * qty"})
    got = assert_same_end_state(paths)
    unscaled = [9999999 * q for q in (1, 100, 10**6)]
    wrapped = [((u + 2**31) % 2**32) - 2**31 for u in unscaled]
    assert [r["price"] for r in got] == [D(w).scaleb(-2) for w in wrapped]


# -- MERGE, DELETE and OPTIMIZE over nested NULL, empty and NULL inside --------------------


def _nested_rows(n, seed):
    rng = np.random.RandomState(seed)
    out = {"id": list(range(n)), "st": [], "arr": [], "m": [], "dec": []}
    for k in range(n):
        out["st"].append([None, {"x": None, "y": None}, {"x": k, "y": None},
                          {"x": k, "y": f"y{k}"}][k % 4])
        out["arr"].append([None, [], [None], [k, None, 2 * k]][(k // 2) % 4])
        out["m"].append([None, [], [("a", None)], [("a", k), ("b", -k)]][(k // 3) % 4])
        out["dec"].append(None if k % 5 == 2 else D(int(rng.randint(-10**6, 10**6))).scaleb(-2))
    return out


def _nested_table(rows_):
    return {"id": rows_["id"], "st": (ST, rows_["st"]), "arr": (ARR, rows_["arr"]),
            "m": (MAP, rows_["m"]), "dec": ("decimal(9,2)", rows_["dec"])}


def test_nested_null_empty_and_null_inside_through_dml(tmp_path):
    """One table a package, the same steps: a deletion-vector DELETE, a
    MERGE with star clauses, OPTIMIZE; after each, both packages read both
    tables to the same rows."""
    src = str(tmp_path / "src")
    create(src, JAX.table(_nested_table(_nested_rows(40, 1))), DV_PROPS)
    paths = copies(src, tmp_path)

    def check():
        want = rows("jax", paths["jax"])
        for n in paths:
            for reader in ("jax", "torch"):
                assert rows(reader, paths[n]) == want, (n, reader)
        return want

    for n in paths:
        table(n, paths[n]).delete("id % 10 = 0")
    assert len(check()) == 36
    src = _nested_rows(12, 2)
    src["id"] = [k * 3 for k in range(12)]
    for pkg in (JAX, TORCH):
        log = pkg.log(paths[pkg.name])
        pkg.merge(log, _nested_table(src), "t.id = s.id", [("update",)], [("insert",)],
                  source_alias="s", target_alias="t")
    got = check()
    assert len(got) == 38  # 10 of the 12 source ids matched, 2 (deleted above) inserted
    by_id = {r["id"]: r for r in got}
    assert by_id[3]["st"] == {"x": None, "y": None} and by_id[1]["st"] == {"x": None,
                                                                              "y": None}
    assert by_id[0]["arr"] is None and by_id[2]["arr"] == []
    for n in paths:
        table(n, paths[n]).optimize().execute_compaction()
    assert check() == got


def test_merge_keyed_on_a_decimal_takes_the_host_join(tmp_path):
    """A decimal key joins on the host (the router's reason names it);
    keys of two decimal types raise in both packages, as Arrow's join
    refuses them."""
    out = {}
    for pkg in (JAX, TORCH):
        path = str(tmp_path / pkg.name)
        log = pkg.write(path, {"k": ("decimal(7,2)", [D("1.50"), D("2.00"), None]),
                               "v": [1, 2, 3]})
        with both_confs(**{"delta.tpu.merge.devicePath.mode": "force"}):
            cmd = pkg.merge(log, {"k": ("decimal(7,2)", [D("2.00"), D("1.51"), None]),
                                  "v": [20, 15, 0]}, "t.k = s.k", [("update",)], [("insert",)],
                            source_alias="s", target_alias="t")
        out[pkg.name] = path
        # even forced to the device, the key has no lane: the host join
        assert cmd._join_path == "host" and cmd._router["reason"] == "upload-declined"
        with pytest.raises(ValueError, match="join field keys"):
            pkg.merge(log, {"k": ("decimal(10,3)", [D("2.000")]), "v": [1]}, "t.k = s.k",
                      [("update",)], [], source_alias="s", target_alias="t")
    for path in out.values():
        assert rows("torch", path) == rows("jax", path)
    got = rows("jax", out["torch"])
    assert len(got) == 5 and {"k": D("2.00"), "v": 20} in got


def test_nested_partition_column_is_refused(tmp_path):
    from delta_tpu_torch.commands.write import WriteIntoDelta as TorchWrite

    data = TORCH.table({"p": (ARR, [[1], [2]]), "x": [1, 2]})
    with pytest.raises(TypeError, match="Sorting not supported"):
        TorchWrite(TorchDeltaLog.for_table(str(tmp_path / "t"), device="cpu"), "append",
                   data, partition_columns=["p"]).run()


@pytest.mark.parametrize("typ,value,part_dir", [
    ("decimal(7,2)", D("1.50"), "p=1.50"), ("decimal(7,2)", D("-0.01"), "p=-0.01"),
    ("decimal(10,7)", D("1E-7"), "p=1E-7"), ("decimal(10,7)", D("1.5"), "p=1.5000000")])
def test_decimal_partition_values_as_jax_writes_them(tmp_path, typ, value, part_dir):
    out = {}
    for pkg in (JAX, TORCH):
        path = str(tmp_path / pkg.name)
        pkg.write(path, {"p": (typ, [value, None]), "x": [1, 2]},
                  partition_columns=["p"])
        out[pkg.name] = sorted(d for d in os.listdir(path) if d.startswith("p="))
    assert out["torch"] == out["jax"] == sorted([part_dir, "p=__HIVE_DEFAULT_PARTITION__"])
    # the JAX package cannot read such a table back; the port reads both
    want = sorted_rows([{"p": value, "x": 1}, {"p": None, "x": 2}])
    for path in (str(tmp_path / "jax"), str(tmp_path / "torch")):
        assert observe(lambda: rows("jax", path)) == "ArrowTypeError"
        assert rows("torch", path) == want


@pytest.mark.parametrize("typ,values", [
    ("decimal(18,2)", [D("1234567890123456.78"), D("-9999999999999999.99"), D("0.01")]),
    ("decimal(38,10)", [D("1234567890123456789012345678.0123456789"),
                        D("-9999999999999999999999999999.9999999999"), D("1E-10")])])
def test_decimal_partition_values_keep_every_digit(tmp_path, typ, values):
    """Partition values of full precision: the port writes the directories
    the JAX package writes, reads the values back exactly, and a
    copy-on-write UPDATE rewrites every file into the same directories with
    the same ``partitionValues`` strings."""
    dirs = {}
    for pkg in (JAX, TORCH):
        path = str(tmp_path / pkg.name)
        pkg.write(path, {"p": (typ, values), "x": [1, 2, 3]}, partition_columns=["p"])
        dirs[pkg.name] = sorted(d for d in os.listdir(path) if d.startswith("p="))
    assert dirs["torch"] == dirs["jax"] == sorted(f"p={v}" for v in values)
    path = str(tmp_path / "torch")
    assert rows("torch", path) == sorted_rows([{"p": v, "x": k + 1} for k, v in enumerate(values)])
    before = {a.path for a in TorchDeltaLog.for_table(path, device="cpu").update().all_files}
    table("torch", path).update({"x": "x + 10"})
    snap = TorchDeltaLog.for_table(path, device="cpu").update()
    assert not {a.path for a in snap.all_files} & before
    assert sorted(a.partition_values["p"] for a in snap.all_files) == sorted(map(str, values))
    assert sorted(a.path.split("/")[0] for a in snap.all_files) == dirs["torch"]
    assert sorted(d for d in os.listdir(path) if d.startswith("p=")) == dirs["torch"]
    assert rows("torch", path) == sorted_rows(
        [{"p": v, "x": k + 11} for k, v in enumerate(values)])


def test_row_group_plans_on_a_decimal_predicate(tmp_path):
    """The footer planner over decimal bounds: the port's plan equals the
    JAX package's on one file."""
    from delta_tpu.exec import rowgroups as jrg

    vals = [D(k).scaleb(-2) for k in range(0, 10000, 7)]
    t = pa.table({"x": pa.array(vals, pa.decimal128(9, 2)), "k": list(range(len(vals)))})
    path = str(tmp_path / "rg.parquet")
    pq.write_table(t, path, row_group_size=100)
    for pred in ("x > 45.5", "x < 3", "x = 20.02", "x >= 99.99", "k < 10 AND x > 50"):
        j = jrg.plan_row_groups(pq.ParquetFile(path).metadata, jax_parse(pred))
        tp = trg.plan_row_groups(tpq.read_metadata(path), torch_parse(pred))
        assert tp.keep == j.keep, pred


# -- the write, MERGE assignments, RESTORE and history over the new types ---------------


@pytest.mark.parametrize("data,error", [
    ({"id": [3], "dec": ("decimal(12,2)", [D("1.00")])}, "SchemaMismatchError"),
    ({"id": [3], "dec": ("decimal(10,4)", [D("1.0000")])}, "SchemaMismatchError"),
    ({"id": [3], "st": (("struct", (("x", "int64"), ("z", "string"))), [{"x": 1, "z": "q"}])},
     "SchemaMismatchError"),
    ({"id": [3], "arr": (("list", "string"), [["a"]])}, "SchemaMismatchError"),
    ({"id": [3, 4], "dec": ("decimal(10,2)", [D("9.99"), None]),
      "arr": (ARR, [[7], None])}, None),
])
@pytest.mark.parametrize("mode", ["append", "overwrite"])
def test_write_of_the_new_types_matches_jax(tmp_path, data, error, mode):
    """Append and overwrite: a decimal of another precision or scale, or a
    nested type of other fields, is refused in both packages; a batch of
    the table's types lands with equal rows and stats."""
    src = str(tmp_path / "src")
    create(src, JAX.table({"id": [1, 2], "dec": ("decimal(10,2)", [D("1.50"), None]),
                           "arr": (ARR, [[1, None], []]),
                           "st": (ST, [{"x": 1, "y": "a"}, None])}))
    paths = copies(src, tmp_path)
    out = {pkg.name: observe(lambda: pkg.write(paths[pkg.name], data, mode=mode))
           for pkg in (JAX, TORCH)}
    if error:
        assert out["jax"] == out["torch"] == error
        return
    assert_same_end_state(paths)
    stats = {}
    for name, path in paths.items():
        snap = JaxDeltaLog.for_table(path).update()
        stats[name] = sorted(f.stats for f in snap.all_files)
    assert stats["torch"] == stats["jax"]


MERGE_SETS = [
    ({"dec": "s.dec3"}, False),           # decimal(10,3) into (10,2): the scale cut truncates
    ({"dec": "s.dec3 * 2"}, False),
    ({"dec": "t.dec + s.dec3"}, False),
    ({"dec": "s.q * 1.5"}, False),         # a double into the decimal, half to even
    ({"dec": "s.q"}, True),               # int64 into (10,2): Arrow refuses the cast
    ({"st": "s.st"}, False),
    ({"arr": "s.arr"}, False),
]


@pytest.mark.parametrize("case", range(len(MERGE_SETS)))
def test_merge_assignments_over_the_new_types(tmp_path, case):
    sets, error = MERGE_SETS[case]
    target = {"id": [1, 2, 3], "dec": ("decimal(10,2)", [D("1.50"), None, D("-2.25")]),
              "arr": (ARR, [[1], None, []]), "st": (ST, [None, {"x": 2, "y": None}, None])}
    source = {"id": [2, 3, 9], "dec3": ("decimal(10,3)", [D("1.005"), D("-1.999"), None]),
              "q": [3, 5, -7], "arr": (ARR, [[], None, [4, None]]),
              "st": (ST, [{"x": None, "y": "b"}, None, {"x": 9, "y": "z"}])}
    out = {}
    for pkg in (JAX, TORCH):
        path = str(tmp_path / pkg.name)
        log = pkg.write(path, target)
        out[pkg.name] = (path, observe(lambda: pkg.merge(
            log, source, "t.id = s.id", [("update", None, sets)], [],
            source_alias="s", target_alias="t") and "ok"))
    if error:  # both a ValueError: Arrow's ArrowInvalid, the port's CastError
        assert (out["jax"][1], out["torch"][1]) == ("ArrowInvalid", "CastError")
        return
    assert out["torch"][1] == out["jax"][1] == "ok"
    for path, _ in out.values():
        assert rows("torch", path) == rows("jax", path)
    assert rows("jax", out["torch"][0]) == rows("jax", out["jax"][0])


def test_restore_and_history_over_the_new_types(tmp_path):
    src = str(tmp_path / "src")
    create(src, JAX.table(_nested_table(_nested_rows(12, 4))), DV_PROPS)
    paths = copies(src, tmp_path)
    for n in paths:
        table(n, paths[n]).delete("id < 4")
        table(n, paths[n]).update({"dec": "dec * 2"}, "id > 8")
    for n in paths:
        assert rows(n, paths[n], version=0) == rows("jax", src)
        table(n, paths[n]).restore_to_version(1)
    got = assert_same_end_state(paths)
    assert len(got) == 8
    ops = {n: [h["operation"] for h in table(n, paths[n]).history()] for n in paths}
    assert ops["torch"] == ops["jax"] == ["RESTORE", "UPDATE", "DELETE", "CREATE TABLE AS SELECT"]

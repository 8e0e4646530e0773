"""The port's filtered read path (``DeltaTable.to_table``: row-group skipping,
late materialization, the device residual) against ``delta_tpu``'s host
path on the CPU.

It replays the cases of ``tests/test_rowgroups.py`` (the predicate matrix
over a table of 8 row groups, the counters, late materialization, deletion
vectors, schema evolution, the planner's unit cases) and the identity cases
of ``tests/test_column_cache.py`` (``:88-183``) on tables written by each
package, and holds the port's rows to ``delta_tpu``'s
``deviceResidual.mode=off`` rows, under the port's residual modes ``off``
and ``force``. Exact throughout (NaN equal to NaN).
"""
import datetime as dt
import math
import os
import shutil

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import delta_tpu_torch
from delta_tpu.api.tables import DeltaTable as JaxTable
from delta_tpu.commands.delete import DeleteCommand as JaxDelete
from delta_tpu.commands.write import WriteIntoDelta as JaxWrite
from delta_tpu.exec import rowgroups as jax_rowgroups
from delta_tpu.expr.parser import parse_predicate as jax_parse
from delta_tpu.log.deltalog import DeltaLog as JaxDeltaLog
from delta_tpu.ops.column_cache import ColumnCache as JaxColumnCache
from delta_tpu.utils.config import conf as jax_conf
from delta_tpu_torch.api.tables import DeltaTable
from delta_tpu_torch.commands.write import WriteIntoDelta as TorchWrite
from delta_tpu_torch.exec import rowgroups
from delta_tpu_torch.exec.scan import read_files_as_table
from delta_tpu_torch.expr.parser import parse_predicate
from delta_tpu_torch.expr.vectorized import HostColumn
from delta_tpu_torch.obs.scan_report import last_scan_report
from delta_tpu_torch.ops.column_cache import ColumnCache
from delta_tpu_torch.utils import telemetry
from delta_tpu_torch.utils.config import conf

N = 4000
RG = 500  # rows per row group: 8 groups per single-file write
OFF = {"delta.tpu.read.deviceResidual.mode": "off"}
FORCE = {"delta.tpu.read.deviceResidual.mode": "force"}
_EPOCH = dt.datetime(1970, 1, 1)


@pytest.fixture(autouse=True)
def _fresh():
    ColumnCache.reset()
    delta_tpu_torch.DeltaLog.clear_cache()
    yield
    ColumnCache.reset()
    delta_tpu_torch.DeltaLog.clear_cache()


# -- both packages' tables from one numpy spec --------------------------------------


def _arrow(kind, values, valid):
    vals = [v if ok else None for v, ok in zip(values.tolist(), valid)]
    if kind == "date":
        return pa.array([None if v is None else dt.date(1970, 1, 1) + dt.timedelta(days=v)
                         for v in vals], pa.date32())
    if kind in ("ts", "tsutc"):
        return pa.array([None if v is None else _EPOCH + dt.timedelta(microseconds=v)
                         for v in vals],
                        pa.timestamp("us", tz="UTC" if kind == "tsutc" else None))
    t = {"int": pa.int64(), "int32": pa.int32(), "double": pa.float64(), "str": pa.string(),
         "bool": pa.bool_()}[kind]
    return pa.array(vals, t)


def _host(kind, values, valid):
    if kind == "int32":
        return HostColumn("int", values.astype(np.int64), valid, "int32")
    if kind == "str":
        return HostColumn("str", np.array([v if ok else None for v, ok in
                                           zip(values.tolist(), valid)], object), valid)
    if kind == "tsutc":
        return HostColumn("ts", np.where(valid, values, 0).astype(np.int64), valid,
                          "timestamp[us, tz=UTC]")
    np_dt = {"int": np.int64, "double": np.float64, "date": np.int64, "ts": np.int64,
             "bool": bool}[kind]
    return HostColumn(kind, np.where(valid, values, 0).astype(np_dt), valid)


def write(pkg, path, spec, rg_rows=None, **kw):
    """Append the table ``spec`` ({name: (kind, values, valid)}) with
    ``pkg``'s own writer; returns that package's log."""
    key = {"delta.tpu.write.rowGroupRows": rg_rows} if rg_rows else {}
    if pkg == "jax":
        log = JaxDeltaLog.for_table(path)
        with jax_conf.set_temporarily(**key):
            JaxWrite(log, "append", pa.table({c: _arrow(*v) for c, v in spec.items()}),
                     **kw).run()
        return log
    log = delta_tpu_torch.DeltaLog.for_table(path, device="cpu")
    with conf.set_temporarily(**key):
        TorchWrite(log, "append", {c: _host(*v) for c, v in spec.items()}, **kw).run()
    return log


def _norm(v):
    if isinstance(v, float) and math.isnan(v):
        return "nan"
    return v


def rows_of(table):
    rows = [{k: _norm(v) for k, v in r.items()} for r in table.to_pylist()]
    return sorted(rows, key=lambda r: [repr(v) for v in r.values()])


def jax_rows(path, pred=None, columns=None):
    JaxDeltaLog.clear_cache()
    with jax_conf.set_temporarily(**OFF):
        return rows_of(JaxTable.for_path(path).to_arrow(
            filters=[pred] if pred else [], columns=columns))


def port_rows(path, pred=None, columns=None, mode="force", **extra):
    with conf.set_temporarily(**{"delta.tpu.read.deviceResidual.mode": mode}, **extra):
        return rows_of(DeltaTable.for_path(path, device="cpu").to_table(
            filters=[pred] if pred else [], columns=columns))


# -- tests/test_rowgroups.py ---------------------------------------------------------


def _rg_spec(n=N):
    """Mixed types with NULLs, NaN, sub-ms timestamps and strings
    (``test_rowgroups._table``)."""
    rng = np.random.RandomState(7)
    ids = np.arange(n, dtype=np.int64)
    f = rng.randn(n)
    f[rng.rand(n) < 0.05] = np.nan
    base = int((dt.datetime(2021, 1, 1) - _EPOCH).total_seconds()) * 1_000_000
    ones = np.ones(n, bool)
    return {
        "id": ("int", ids, ones),
        "v": ("int", ids % 100, ids % 17 != 0),
        "f": ("double", f, ones),
        "name": ("str", np.array(["k%04d" % (i % 500) for i in range(n)], object), ones),
        "ts": ("ts", base + ids * 1_000_000 + ids % 1000, ones),
    }


@pytest.fixture(scope="module", params=["jax", "torch"])
def rg_table(request, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("rg") / request.param)
    write(request.param, path, _rg_spec(), rg_rows=RG)
    return path


PREDICATES = [
    "id < 200",
    "id >= 3700",
    "id >= 900 AND id < 1100",
    "id = 1234",
    "id IN (10, 2500, 3999)",
    "id < 100 OR id >= 3900",
    "v IS NULL AND id < 600",
    "v IS NOT NULL AND id < 600",
    "f > 2.5",
    "name = 'k0007'",
    "name >= 'k0490'",
    "ts < '2021-01-01 00:05:00'",
    "ts >= '2021-01-01 00:55:00.000500'",
    "id < 0",
    "id % 7 = 3 AND id < 900",
]


@pytest.mark.parametrize("mode", ["off", "force"])
@pytest.mark.parametrize("pred", PREDICATES)
def test_skipping_result_identical(rg_table, pred, mode):
    want = jax_rows(rg_table, pred)
    assert port_rows(rg_table, pred, mode=mode) == want
    assert port_rows(rg_table, pred, mode=mode,
                     **{"delta.tpu.read.rowGroupSkipping": False}) == want


def test_selective_scan_prunes_and_counts(rg_table):
    telemetry.clear_counters()
    assert len(port_rows(rg_table, "id < 200", mode="off")) == 200
    c = telemetry.counters()
    assert c.get("scan.rowgroups.total", 0) == N // RG
    assert c.get("scan.rowgroups.pruned", 0) == N // RG - 1
    assert c.get("scan.bytes.skipped", 0) > 0


def test_skipping_off_decodes_everything(rg_table):
    telemetry.clear_counters()
    port_rows(rg_table, "id < 200", mode="off", **{"delta.tpu.read.rowGroupSkipping": False})
    c = telemetry.counters()
    assert "scan.rowgroups.total" not in c and "scan.rowgroups.pruned" not in c


def test_late_materialization_skips_mask_empty_groups(rg_table):
    telemetry.clear_counters()
    got = port_rows(rg_table, "id % 7919 = 600", mode="off")
    c = telemetry.counters()
    assert c.get("scan.rowgroups.pruned", 0) == 0  # stats keep everything
    assert c.get("scan.rowgroups.lateSkipped", 0) == N // RG - 1
    assert got == jax_rows(rg_table, "id % 7919 = 600")


@pytest.fixture
def dv_table(tmp_path):
    """The rg table with deletion vectors written by ``delta_tpu``'s DELETE
    (two deletes into one file, as ``test_dv_delete_with_pruning_keeps_
    physical_positions``)."""
    path = str(tmp_path / "dv")
    log = write("jax", path, _rg_spec(), rg_rows=RG,
                configuration={"delta.tpu.enableDeletionVectors": "true"})
    JaxDelete(log, "id >= 3900").run()
    JaxDelete(log, "id < 50").run()
    JaxDelete(log, "id >= 100 AND id < 150").run()
    return path


@pytest.mark.parametrize("pred", [None, "id < 300", "id >= 3800", "v = 10 AND id > 3000",
                                  "name = 'k0120'"])
@pytest.mark.parametrize("mode", ["off", "force"])
def test_scan_of_dv_file_with_pruning(dv_table, pred, mode):
    got = port_rows(dv_table, pred, mode=mode)
    assert got == jax_rows(dv_table, pred)
    assert not any(r["id"] >= 3900 or r["id"] < 50 or 100 <= r["id"] < 150 for r in got)


def test_dv_positions_stay_physical_under_pruning(dv_table):
    log = delta_tpu_torch.DeltaLog.for_table(dv_table, device="cpu")
    snap = log.update()
    t = read_files_as_table(log.data_path, snap.all_files, snap.metadata, columns=["id"],
                            position_column="pos", predicate=parse_predicate("id >= 3000"),
                            device="cpu")
    ids = t.column("id").values
    assert np.array_equal(t.column("pos").values, ids)  # one file: position == id
    assert 3000 in ids.tolist() and 3950 not in ids.tolist() and 120 not in ids.tolist()


@pytest.mark.parametrize("mode", ["off", "force"])
def test_evolved_file_missing_predicate_column(tmp_path, mode):
    path = str(tmp_path / "evolved")
    ones = np.ones(2000, bool)
    write("jax", path, {"id": ("int", np.arange(2000), ones)}, rg_rows=RG)
    write("jax", path, {"id": ("int", np.arange(2000, 4000), ones),
                        "extra": ("int", np.arange(2000), ones)}, rg_rows=RG, merge_schema=True)
    for pred in ["extra < 100", "extra < 100 OR id < 10", "extra IS NULL"]:
        assert port_rows(path, pred, mode=mode) == jax_rows(path, pred)


def test_predicate_column_outside_projection(rg_table):
    log = delta_tpu_torch.DeltaLog.for_table(rg_table, device="cpu")
    snap = log.update()
    out = read_files_as_table(log.data_path, snap.all_files, snap.metadata,
                              columns=["id", "name"],
                              predicate=parse_predicate("id >= 0 AND v = 50"), device="cpu")
    # rows are not filtered by the decode, and no group late-skips on the
    # all-NULL mask a missing predicate column would give
    assert out.num_rows == N


def _plans(tmp_path, table, rg_rows, preds):
    p = str(tmp_path / "f.parquet")
    pq.write_table(table, p, row_group_size=rg_rows)
    jm, tm = pq.read_metadata(p), rowgroups.read_footer(p)
    return [(rowgroups.plan_row_groups(tm, parse_predicate(q)).keep,
             jax_rowgroups.plan_row_groups(jm, jax_parse(q)).keep) for q in preds]


def test_planner_unit_cases_match_jax(tmp_path):
    base = dt.datetime(2021, 6, 1)
    cases = [
        (pa.table({"f": pa.array([np.nan] * 10 + [5.0] * 10, pa.float64())}), ["f > 100.0"]),
        (pa.table({"v": pa.array([None] * 10 + list(range(10)), pa.int64())}),
         ["v IS NULL", "v IS NOT NULL"]),
        (pa.table({"ts": pa.array([base + dt.timedelta(minutes=i) for i in range(20)],
                                  pa.timestamp("us"))}), ["ts >= '2021-06-01 00:15:00'"]),
        (pa.table({"ts": pa.array([base + dt.timedelta(minutes=i) for i in range(20)],
                                  pa.timestamp("us", tz="UTC"))}), ["ts >= '2021-06-01 00:15:00'"]),
        (pa.table({"s": pa.array(["k%03d" % i for i in range(40)]),
                   "d": pa.array([dt.date(2020, 1, 1) + dt.timedelta(days=i) for i in range(40)]),
                   "b": pa.array([i % 2 == 0 for i in range(40)]),
                   "i8": pa.array(list(range(40)), pa.int8()),
                   "x": pa.array(np.arange(40, dtype=np.float32))}),
         ["s = 'k015'", "s >= 'k030'", "d < '2020-01-05'", "i8 > 35", "x < 3.5", "b = true"]),
    ]
    for table, preds in cases:
        for got, want in _plans(tmp_path, table, 10, preds):
            assert got == want
    assert rowgroups.plan_row_groups(rowgroups.read_footer(str(tmp_path / "f.parquet")),
                                     parse_predicate("i8 > 35")).keep == [3]


def test_row_groups_for_positions(tmp_path):
    p = str(tmp_path / "pos.parquet")
    pq.write_table(pa.table({"v": pa.array(range(40), pa.int64())}), p, row_group_size=10)
    meta = rowgroups.read_footer(p)
    assert rowgroups.row_groups_for_positions(meta, [0, 35]) == {0, 3}
    assert rowgroups.row_groups_for_positions(meta, [11, 12]) == {1}
    assert rowgroups.row_groups_for_positions(meta, []) == frozenset()
    assert list(rowgroups.row_group_offsets(meta)) == [0, 10, 20, 30, 40]


def test_port_writer_honours_row_group_rows(tmp_path):
    path = str(tmp_path / "t")
    write("torch", path, {"id": ("int", np.arange(1000), np.ones(1000, bool))}, rg_rows=300)
    snap = delta_tpu_torch.DeltaLog.for_table(path, device="cpu").update()
    meta = rowgroups.read_footer(f"{path}/{snap.all_files[0].path}")
    assert [rg.num_rows for rg in meta.row_groups] == [300, 300, 300, 100]
    assert pq.ParquetFile(f"{path}/{snap.all_files[0].path}").metadata.num_row_groups == 4


# -- tests/test_column_cache.py:88-183 ---------------------------------------------


def _cc_spec(i, n=400, seed=7, rng=None):
    rng = rng or np.random.RandomState(seed)
    cats = rng.choice(["alpha", "beta", "gamma", "-"], n)
    ones = np.ones(n, bool)
    return {
        "id": ("int", np.arange(i * n, (i + 1) * n), ones),
        "cat": ("str", cats.astype(object), cats != "-"),
        "x": ("double", rng.rand(n), ones),
        "d": ("date", (dt.date(2024, 1, 1) - dt.date(1970, 1, 1)).days
              + rng.randint(0, 400, n), ones),
        "ts": ("ts", (int((dt.datetime(2024, 1, 1) - _EPOCH).total_seconds())
                      + rng.randint(0, 86400 * 30, n)) * 1_000_000, ones),
        "p": ("int32", np.full(n, i % 2), ones),
    }


@pytest.fixture(scope="module", params=["jax", "torch"])
def cc_table(request, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cc") / request.param)
    rng = np.random.RandomState(7)
    for i in range(3):
        write(request.param, path, _cc_spec(i, rng=rng), rg_rows=100)
    return path


IDENTITY_PREDS = [
    "cat = 'alpha' AND x > 0.5",
    "cat != 'beta'",
    "cat <=> 'gamma'",
    "cat IN ('beta', 'gamma')",
    "cat IN ('nosuchvalue')",
    "cat IS NULL",
    "cat IS NOT NULL AND id < 300",
    "d >= '2024-06-01'",
    "ts < '2024-01-15 12:30:00'",
    "year(d) = 2024 AND month(ts) = 1",
    "to_date(ts) = '2024-01-15'",
    "hour(ts) >= 12",
    "id > 900 OR cat = 'missingvalue'",
    "x BETWEEN 0.2 AND 0.4",
    "NOT (id IN (p, 7))",
    "cat IN ('alpha', NULL)",
]


@pytest.mark.parametrize("pred", IDENTITY_PREDS)
def test_device_scan_identity(cc_table, pred):
    want = jax_rows(cc_table, pred)
    assert port_rows(cc_table, pred, mode="force") == want
    assert port_rows(cc_table, pred, mode="off") == want


def test_device_scan_engages_and_counts(cc_table):
    c0 = telemetry.counters()
    port_rows(cc_table, "cat = 'alpha'")
    c1 = telemetry.counters()
    assert c1.get("scan.device.engaged", 0) == c0.get("scan.device.engaged", 0) + 1
    assert c1.get("columnCache.misses", 0) > c0.get("columnCache.misses", 0)
    port_rows(cc_table, "cat = 'alpha'")  # warm: the same lanes serve
    c2 = telemetry.counters()
    assert c2.get("columnCache.hits", 0) > c1.get("columnCache.hits", 0)
    assert c2.get("columnCache.misses", 0) == c1.get("columnCache.misses", 0)
    assert ColumnCache.instance().resident_bytes() > 0


def test_device_scan_report_attribution(cc_table):
    port_rows(cc_table, "cat = 'alpha'")
    rep = last_scan_report()
    assert rep is not None and rep.device_residual == "device"
    assert rep.bytes_device_survivor > 0 and rep.files_scanned == 3
    port_rows(cc_table, "cat = 'alpha'", mode="off")
    assert last_scan_report().device_residual is None


def test_device_scan_inflates_a_batch_not_a_file(cc_table, monkeypatch):
    """The device residual's lanes (cold) and its survivors' groups inflate
    their SNAPPY pages in one batch each over all three files, not one a
    file; warm, the lanes need none."""
    from delta_tpu_torch.exec import snappy

    calls = []
    real = snappy.decompress_pages

    def counting(bodies, sizes, device="cuda", labels=None):
        calls.append(len(bodies))
        return real(bodies, sizes, device, labels)

    monkeypatch.setattr(snappy, "decompress_pages", counting)
    ColumnCache.reset()
    want = jax_rows(cc_table, "cat = 'alpha' AND x > 0.25")
    assert port_rows(cc_table, "cat = 'alpha' AND x > 0.25") == want
    assert last_scan_report().files_scanned == 3
    assert len(calls) == 2 and all(calls)
    calls.clear()
    assert port_rows(cc_table, "cat = 'alpha' AND x > 0.25") == want
    assert len(calls) == 1


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_device_mask_skips_all_false_row_groups(tmp_path, pkg):
    path = str(tmp_path / pkg)
    write(pkg, path, {"id": ("int", np.arange(0, 600, 2), np.ones(300, bool)),
                      "v": ("double", np.ones(300), np.ones(300, bool))}, rg_rows=100)
    c0 = telemetry.counters()
    assert port_rows(path, "id = 51") == [] == jax_rows(path, "id = 51")
    c1 = telemetry.counters()
    assert c1.get("scan.rowgroups.deviceSkipped", 0) > c0.get("scan.rowgroups.deviceSkipped", 0)
    assert c1.get("scan.bytes.deviceSkipped", 0) > c0.get("scan.bytes.deviceSkipped", 0)


def test_identity_with_deletion_vectors(tmp_path):
    path = str(tmp_path / "dv")
    rng = np.random.RandomState(7)
    for i in range(3):
        write("jax", path, _cc_spec(i, rng=rng), rg_rows=100,
              configuration={"delta.tpu.enableDeletionVectors": "true"})
    with jax_conf.set_temporarily(**{"delta.tpu.deletionVectors.enabled": True}):
        JaxDelete(JaxDeltaLog.for_table(path), "id % 7 = 0").run()
    got = port_rows(path, "cat = 'alpha' AND x > 0.3")
    assert got == jax_rows(path, "cat = 'alpha' AND x > 0.3")
    assert got and not any(r["id"] % 7 == 0 for r in got)


def test_identity_after_schema_evolution(tmp_path):
    """Files that predate a column bind an all-invalid lane."""
    from delta_tpu.commands.alter import add_columns
    from delta_tpu.schema.types import StringType, StructField

    path = str(tmp_path / "evo")
    ones = np.ones(100, bool)
    log = write("jax", path, {"id": ("int", np.arange(100), ones),
                              "v": ("double", np.ones(100), ones)})
    add_columns(log, [StructField("tag", StringType())])
    write("jax", path, {"id": ("int", np.arange(100, 200), ones),
                        "v": ("double", np.ones(100), ones),
                        "tag": ("str", np.array(["new"] * 100, object), ones)})
    for pred in ["tag = 'new'", "tag IS NULL", "tag != 'new' OR id < 20"]:
        assert port_rows(path, pred) == jax_rows(path, pred), pred


def test_mode_off_never_engages(cc_table):
    c0 = telemetry.counters("scan.device")
    port_rows(cc_table, "cat = 'alpha'", mode="off")
    assert telemetry.counters("scan.device") == c0
    assert ColumnCache.instance().resident_bytes() == 0


def test_host_fallback_on_uncompilable_residual(cc_table):
    c0 = telemetry.counters("scan.device")
    pred = "upper(cat) = 'ALPHA'"
    assert port_rows(cc_table, pred) == jax_rows(cc_table, pred)
    c1 = telemetry.counters("scan.device")
    assert c1.get("scan.device.fallback", 0) == c0.get("scan.device.fallback", 0) + 1
    assert c1.get("scan.device.engaged", 0) == c0.get("scan.device.engaged", 0)


def test_a_failing_kernel_raises_out_of_the_scan(cc_table, monkeypatch):
    """No quiet fallback: where the JAX package turns any device error into
    the host path, the port raises."""
    from delta_tpu_torch.ops import column_cache

    def boom(*a, **k):
        raise RuntimeError("kernel failed")

    monkeypatch.setattr(column_cache, "residual_masks", boom)  # the read path's one launch
    with pytest.raises(RuntimeError, match="kernel failed"):
        port_rows(cc_table, "cat = 'alpha'")


def test_partitioned_tables_are_not_ported(tmp_path):
    """A partitioned table, once refused by the port's reader, reads as the
    reference reads it, under both residual modes (the partition value a
    per-file scalar of K14's program on the device leg)."""
    path = str(tmp_path / "part")
    write("jax", path, _cc_spec(0), partition_columns=["p"])
    for pred in ("cat = 'alpha'", "p = 1 OR x < 0.2", "p = 0 AND cat = 'beta'"):
        want = jax_rows(path, pred)
        for mode in ("off", "force"):
            assert port_rows(path, pred, mode=mode) == want, (pred, mode)


# -- the reference's fault: an IN whose option is a column -------------------------


def _in_table(tmp_path, b_values, b_valid):
    path = str(tmp_path / "in")
    ones = np.ones(4, bool)
    write("jax", path, {"a": ("int", np.array([1, 2, 3, 4]), ones),
                        "b": ("int", np.array(b_values), np.array(b_valid))})
    return path


def test_not_in_column_option_matches_host_path(tmp_path):
    """``NOT (a IN (b))`` over a=[1,2,3,4], b=[1,5,3,7]: the host path
    returns a=[2,4]; ``delta_tpu``'s device residual returns no row (it
    reduces the option's validity over the padded lane, whose pad is
    invalid). The port returns the host path's rows under its device
    mode."""
    path = _in_table(tmp_path, [1, 5, 3, 7], [True] * 4)
    pred = "NOT (a IN (b))"
    want = jax_rows(path, pred, columns=None)
    assert [r["a"] for r in sorted(want, key=lambda r: r["a"])] == [2, 4]
    c0 = telemetry.counters("scan.device")
    got = port_rows(path, pred)
    assert telemetry.counters("scan.device").get("scan.device.engaged", 0) == \
        c0.get("scan.device.engaged", 0) + 1
    assert sorted(r["a"] for r in got) == [2, 4]
    # the reference's device residual, recorded
    JaxColumnCache.reset()
    JaxDeltaLog.clear_cache()
    with jax_conf.set_temporarily(**FORCE):
        forced = JaxTable.for_path(path).to_arrow(filters=[pred])
    assert forced.num_rows == 0
    JaxColumnCache.reset()


def test_in_column_option_with_a_null_matches_host_path(tmp_path):
    """b=[1,NULL,3,7]: the host path returns a=[4] for ``NOT (a IN (b))``.
    Reducing the option's validity over the real rows alone would still
    make row 4 NULL; the port takes it per row."""
    path = _in_table(tmp_path, [1, 0, 3, 7], [True, False, True, True])
    for pred in ["NOT (a IN (b))", "a IN (b)", "a IN (b, 2)", "NOT (a IN (b, 9))"]:
        assert port_rows(path, pred, columns=None) == jax_rows(path, pred), pred
    assert [r["a"] for r in port_rows(path, "NOT (a IN (b))")] == [4]


def test_port_written_table_read_by_both(tmp_path):
    path = str(tmp_path / "t")
    write("torch", path, _rg_spec(), rg_rows=RG)
    for pred in ["id < 700 AND name >= 'k0100'", "ts >= '2021-01-01 00:30:00'"]:
        assert port_rows(path, pred) == jax_rows(path, pred)
    shutil.rmtree(path)


# -- a column the port cannot decode blocks only the reads that need it ---------------


def _nested_table(tmp_path):
    path = str(tmp_path / "nested")
    JaxWrite(JaxDeltaLog.for_table(path), "append", pa.table({
        "id": pa.array([1, 2, 3], pa.int64()),
        "st": pa.array([{"a": 1}, {"a": 2}, None], pa.struct([("a", pa.int64())])),
        "ls": pa.array([[1], [2, 3], None], pa.list_(pa.int64()))})).run()
    return path


def _decimal_table(tmp_path):
    import decimal

    path = str(tmp_path / "dec")
    JaxWrite(JaxDeltaLog.for_table(path), "append", pa.table({
        "id": pa.array([1, 2, 3], pa.int64()),
        "amt": pa.array([decimal.Decimal(v) for v in ("1.50", "2.25", "3.00")],
                        pa.decimal128(10, 2)),
        "tag": ["a", "b", "c"]})).run()
    return path


@pytest.mark.parametrize("filters,columns", [(["id = 1"], ["id"]), ([], ["id"]),
                                             (["id >= 2"], None)])
def test_struct_and_list_columns_left_out_of_the_read(tmp_path, filters, columns):
    path = _nested_table(tmp_path)
    want = JaxTable.for_path(path).to_arrow(filters=filters, columns=columns)
    if columns is None:  # the projection takes every column: st and ls are read
        assert want.num_rows == 2 and "st" in want.column_names
    for mode in ("off", "force", "auto"):
        got = port_rows(path, filters[0] if filters else None, columns=columns, mode=mode)
        assert got == rows_of(want), mode


@pytest.mark.parametrize("filters,columns", [(["id > 1"], ["id"]), ([], ["id", "tag"]),
                                             (["tag = 'b'"], ["id"])])
def test_decimal_column_left_out_of_the_read(tmp_path, filters, columns):
    path = _decimal_table(tmp_path)
    want = JaxTable.for_path(path).to_arrow(filters=filters, columns=columns)
    assert want.num_rows > 0
    for mode in ("off", "force"):
        got = port_rows(path, filters[0] if filters else None, columns=columns, mode=mode)
        assert got == rows_of(want), mode


@pytest.mark.parametrize("filters,columns", [([], None), (["amt > 2"], ["id"]),
                                             ([], ["amt"])])
def test_reading_a_decimal_column_is_not_ported(tmp_path, filters, columns):
    """Once a refusal, now the feature: the decimal column reads (and
    filters, on the host) to the JAX package's rows."""
    path = _decimal_table(tmp_path)
    want = JaxTable.for_path(path).to_arrow(filters=filters, columns=columns)
    assert want.num_rows > 0
    for mode in ("off", "force"):
        got = port_rows(path, filters[0] if filters else None, columns=columns, mode=mode)
        assert got == rows_of(want), mode


def test_row_groups_prune_beside_an_unsupported_column(tmp_path):
    """Several row groups: the footer planner types only the predicate's
    columns, so the decimal column's statistics are never decoded."""
    import decimal

    path = str(tmp_path / "rg")
    n = 2000
    JaxWrite(JaxDeltaLog.for_table(path), "append", pa.table({
        "id": np.arange(n, dtype=np.int64),
        "amt": pa.array([decimal.Decimal(i) / 4 for i in range(n)], pa.decimal128(10, 2))}),
        ).run()
    files = [f for f in os.listdir(path) if f.endswith(".parquet")]
    pq.write_table(pq.read_table(f"{path}/{files[0]}"), f"{path}/{files[0]}",
                   row_group_size=250)
    c0 = telemetry.counters("scan.rowgroups")
    got = port_rows(path, "id < 100", columns=["id"], mode="off")
    assert sorted(r["id"] for r in got) == list(range(100))
    pruned = telemetry.counters("scan.rowgroups").get("scan.rowgroups.pruned", 0)
    assert pruned - c0.get("scan.rowgroups.pruned", 0) == 7


# -- queue C: a date column against a timestamp column ------------------------------

_D = (dt.date(2024, 1, 5) - dt.date(1970, 1, 1)).days
_T = int((dt.datetime(2024, 1, 5) - _EPOCH).total_seconds()) * 1_000_000

#: the comparison -> the ids the reference keeps (Arrow casts the date to midnight)
DATE_TS_PREDS = {"d = ts": [0], "d < ts": [1, 3], "d <= ts": [0, 1, 3], "d > ts": [2],
                 "d <=> ts": [0], "d >= ts": [0, 2], "d != ts": [1, 2, 3]}


@pytest.fixture(scope="module", params=[(w, k) for w in ("jax", "torch")
                                        for k in ("ts", "tsutc")], ids=str)
def date_ts_table(request, tmp_path_factory):
    """(0, 2024-01-05, 2024-01-05 00:00:00), (1, 2024-01-05, ...00.000001),
    (2, 2024-01-06, 2024-01-05), (3, 2024-01-04, 2024-01-05), with a naive
    or a UTC timestamp column, written by either package."""
    writer, ts_kind = request.param
    path = str(tmp_path_factory.mktemp("dts") / f"{writer}-{ts_kind}")
    ones = np.ones(4, bool)
    write(writer, path, {"id": ("int", np.arange(4), ones),
                         "d": ("date", np.array([_D, _D, _D + 1, _D - 1]), ones),
                         ts_kind: ("tsutc" if ts_kind == "tsutc" else "ts",
                                   np.array([_T, _T + 1, _T, _T]), ones)})
    return path, ts_kind


@pytest.mark.parametrize("pred", sorted(DATE_TS_PREDS))
def test_date_against_timestamp_filter_matches_jax(date_ts_table, pred):
    path, ts_col = date_ts_table
    pred = pred.replace("ts", ts_col)
    want = jax_rows(path, pred)
    assert [r["id"] for r in want] == DATE_TS_PREDS[pred.replace(ts_col, "ts")]
    assert port_rows(path, pred, mode="off") == want
    assert port_rows(path, pred, mode="force") == want


def test_date_against_timestamp_on_the_cc_table(cc_table):
    """The residual declines the mixed compare (as ``jaxeval`` does): the
    host leg answers under ``force`` too."""
    want = jax_rows(cc_table, "d < ts")
    assert len(want) == 49
    c0 = telemetry.counters("scan.device")
    assert port_rows(cc_table, "d < ts", mode="force") == want
    assert telemetry.counters("scan.device").get("scan.device.fallback", 0) \
        == c0.get("scan.device.fallback", 0) + 1
    assert port_rows(cc_table, "d < ts", mode="off") == want
    assert port_rows(cc_table, "d < ts AND cat = 'alpha'") == \
        jax_rows(cc_table, "d < ts AND cat = 'alpha'")


# -- queue C: the reference's answers the port does not copy ------------------------


@pytest.fixture(scope="module")
def pin_table(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pin") / "t")
    write("jax", path, {"id": ("int", np.arange(4), np.ones(4, bool)),
                        "dbl": ("double", np.array([0.0, -0.0, 4.5, np.nan]), np.ones(4, bool))})
    return path


def _values(rows, col):
    return [r[col] for r in rows]


def _jax_rows_in(path, pred, mode):
    JaxDeltaLog.clear_cache()
    with jax_conf.set_temporarily(**{"delta.tpu.read.deviceResidual.mode": mode}):
        return rows_of(JaxTable.for_path(path).to_arrow(filters=[pred]))


#: pred -> (the port's ids in both modes = Spark's, the reference's off, its force)
FRACTIONAL_IN = {"id IN (2.5)": ([], [2], []),
                 "id IN (1, 2.5)": ([1], [1, 2], [1]),
                 "NOT (id IN (2.5))": ([0, 1, 2, 3], [0, 1, 3], [0, 1, 3]),
                 "id = 2.5": ([], [], [])}


@pytest.mark.parametrize("pred", sorted(FRACTIONAL_IN))
def test_fractional_literal_in_an_integer_in_keeps_spark_answer(pin_table, pred):
    """The reference's host kernel casts the IN's options to the column's
    type (2.5 -> 2); Spark widens the column, and so does the port."""
    port, ref_off, ref_force = FRACTIONAL_IN[pred]
    for mode in ("off", "force"):
        assert _values(port_rows(pin_table, pred, mode=mode), "id") == port
    assert _values(_jax_rows_in(pin_table, pred, "off"), "id") == ref_off
    assert _values(_jax_rows_in(pin_table, pred, "force"), "id") == ref_force


#: pred -> (the port's dbl values in both modes, the reference's off, its force)
NEG_ZERO_IN = {"dbl IN (0.0, 4.5)": ([0.0, -0.0, 4.5], [0.0, 4.5], [0.0, 4.5]),
               "NOT (dbl IN (0.0))": ([4.5, "nan"], [-0.0, 4.5, "nan"], [4.5, "nan"]),
               "dbl = 0.0": ([0.0, -0.0], [0.0, -0.0], [0.0, -0.0])}


@pytest.mark.parametrize("pred", sorted(NEG_ZERO_IN))
def test_negative_zero_in_an_in_keeps_spark_answer(pin_table, pred):
    """-0.0 equals 0.0 in an IN as in ``=`` (Spark); the reference's
    ``pc.is_in`` tells them apart."""
    port, ref_off, ref_force = NEG_ZERO_IN[pred]
    sign = lambda vs: [(v, math.copysign(1, v)) if isinstance(v, float) else v for v in vs]
    for mode in ("off", "force"):
        assert sign(_values(port_rows(pin_table, pred, mode=mode), "dbl")) == sign(port)
    assert sign(_values(_jax_rows_in(pin_table, pred, "off"), "dbl")) == sign(ref_off)
    assert sign(_values(_jax_rows_in(pin_table, pred, "force"), "dbl")) == sign(ref_force)


# -- the footer LRU (tests/test_rowgroups.py:336-363) -------------------------------


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_footer_cache_invalidation_on_rewrite(tmp_path, pkg):
    """Both packages' footer caches: a hit returns the same parsed object; a
    file rewritten in place (another size and mtime) is parsed again."""
    cache = (jax_rowgroups if pkg == "jax" else rowgroups).FooterCache()
    p = str(tmp_path / "c.parquet")
    pq.write_table(pa.table({"v": pa.array(range(100), pa.int64())}), p)
    m1 = cache.get(p)
    assert cache.get(p) is m1
    pq.write_table(pa.table({"v": pa.array(range(7), pa.int64())}), p)
    os.utime(p, ns=(1, 1))
    m2 = cache.get(p)
    assert m2 is not m1 and m2.num_rows == 7


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_footer_cache_bounded_and_disabled(tmp_path, pkg):
    cache = (jax_rowgroups if pkg == "jax" else rowgroups).FooterCache()
    settings = jax_conf if pkg == "jax" else conf
    paths = []
    for i in range(5):
        p = str(tmp_path / f"f{i}.parquet")
        pq.write_table(pa.table({"v": pa.array([i], pa.int64())}), p)
        paths.append(p)
    with settings.set_temporarily(**{"delta.tpu.read.footerCacheEntries": 3}):
        for p in paths:
            cache.get(p)
        assert len(cache) == 3
    with settings.set_temporarily(**{"delta.tpu.read.footerCacheEntries": 0}):
        before = len(cache)
        assert cache.get(paths[0]).num_rows == 1 and len(cache) == before


def test_a_scan_reads_each_footer_once_while_it_is_cached(tmp_path):
    """A second scan of a table parses no footer: every file's is a hit."""
    path = str(tmp_path / "t")
    for i in range(4):
        write("torch", path, _cc_spec(i), partition_columns=["p"])
    rowgroups.FooterCache.reset()
    port_rows(path, "x > 0.5", mode="off")
    telemetry.clear_counters()
    assert port_rows(path, "x > 0.5", mode="off") == jax_rows(path, "x > 0.5")
    c = telemetry.counters()
    assert c.get("footerCache.hits", 0) == 4 and "footerCache.misses" not in c


# -- date arithmetic at the calendar's ends ------------------------------------------

_DATE_ROWS = {
    "id": [1, 2, 3, 4, 5, 6],
    "d": pa.array([dt.date(9999, 12, 31), dt.date(1, 1, 1), dt.date(2020, 2, 29), None,
                   dt.date(1970, 1, 1), dt.date(9999, 12, 30)], pa.date32()),
    "e": pa.array([dt.date(1, 1, 1), None, dt.date(2020, 3, 1), dt.date(2000, 1, 1),
                   dt.date(9999, 12, 31), dt.date(9999, 12, 31)], pa.date32()),
    "n": pa.array([1, 1, None, 5, -1, 2], pa.int64()),
    "v": [10, 20, 30, 40, 50, 60],
}
_DATE_PREDS = [
    "date_add(d, 1) > d", "date_sub(d, 1) < d", "date_add(d, n) >= d", "date_sub(d, n) <= d",
    "datediff(date_add(d, 1), d) = 1", "datediff(d, date_sub(d, 1)) = 1",
    "date_add(d, 1) IS NULL", "datediff(d, e) > 0", "datediff(e, d) < 0",
    "date_add(d, n) > e", "date_sub(e, 1) = d", "date_add(d, 3000000000) IS NULL",
]


@pytest.mark.parametrize("op", ["filter_off", "filter_force", "delete", "update"])
@pytest.mark.parametrize("pred", _DATE_PREDS)
def test_date_arithmetic_past_the_calendar_ends_matches_jax(tmp_path, op, pred):
    """``date_add``/``date_sub``/``datediff`` at 9999-12-31 + 1 and
    0001-01-01 - 1, with NULL operands and an int64 count, as a filter
    (the residual off, and forced in both packages: a count past int32
    takes the row semantics, which raise on a date the forced residual
    keeps), a DELETE and an UPDATE's condition: the port's rows, metrics
    and errors equal the JAX package's (Arrow's int32 day arithmetic,
    unchecked)."""
    from tests.torch_dml_tables import (
        assert_same_end_state, copies, create, metrics, observe, rows, table,
    )

    src = create(str(tmp_path / "src"), dict(_DATE_ROWS))
    if op.startswith("filter"):
        mode = {"filter_off": OFF, "filter_force": FORCE}[op]
        with jax_conf.set_temporarily(**mode), conf.set_temporarily(**mode):
            want = observe(lambda: rows("jax", src, filters=[pred]))
            got = observe(lambda: rows("torch", src, filters=[pred]))
        assert got == want
        return
    paths = copies(src, tmp_path)
    seen = {}
    for name in ("jax", "torch"):
        t = table(name, paths[name])
        run = ((lambda: t.delete(pred)) if op == "delete"
               else (lambda: t.update({"v": "v + 1"}, pred)))
        seen[name] = observe(lambda: metrics(run()))
    assert seen["torch"] == seen["jax"]
    assert_same_end_state(paths)

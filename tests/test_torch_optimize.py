"""The port's OPTIMIZE and Z-order key (``commands/optimize``, ``ops/zorder``)
against ``delta_tpu``'s on the CPU:

* ``morton_order`` permutations equal to JAX's for k = 1..8 (ties, NULLs
  through ``np_col`` of the integer, date and timestamp kinds, strings,
  floats with NaN and -0.0, bit 63 set, n = 1 and 2), with the device
  sorts' plain versions (the ranks of integer columns, the key's order)
  against numpy's stable argsort;
* OPTIMIZE end states equal to ``delta_tpu``'s on the cases of
  ``tests/test_dml.py:363-520``: each package optimizes its own copy of one
  table ``delta_tpu`` wrote, and the new files' rows, in order, and the
  file counts must match, partitioned tables included;
* a table the port optimized reads back through ``delta_tpu``;
* no stale lane or slab after an OPTIMIZE (``tests/test_column_cache.py:
  244``): both device caches' epochs move and the next scan and MERGE see
  the rewritten files.

Exact throughout.
"""
import random
import shutil

import numpy as np
import pyarrow as pa
import pytest
import torch

import delta_tpu_torch
from delta_tpu.commands.optimize import OptimizeCommand as JaxOptimize
from delta_tpu.commands.optimize import np_col as jax_np_col
from delta_tpu.exec.scan import read_files_as_table as jax_read
from delta_tpu.exec.scan import scan_files as jax_scan_files
from delta_tpu.log.deltalog import DeltaLog as JaxDeltaLog
from delta_tpu.ops.zorder import morton_order as jax_morton
from delta_tpu_torch.api.tables import DeltaTable
from delta_tpu_torch.commands.optimize import OptimizeCommand, np_col
from delta_tpu_torch.exec.scan import read_files_as_table, scan_files
from delta_tpu_torch.expr.vectorized import HostColumn, HostTable
from delta_tpu_torch.ops import zorder
from delta_tpu_torch.ops.column_cache import ColumnCache
from delta_tpu_torch.ops.key_cache import KeyCache
from delta_tpu_torch.utils.config import conf
from delta_tpu_torch.utils.errors import OptimizeBudgetExceeded
from tests.torch_kernel_cases import reference_key_order, reference_rank, zsort_case
from tests.torch_port_tables import Pkg, reset_caches, sorted_rows


@pytest.fixture(autouse=True)
def _fresh():
    reset_caches()
    ColumnCache.reset()
    yield
    reset_caches()
    ColumnCache.reset()


# -- morton_order ------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 6])
def test_morton_order_matches_jax(k):
    rng = np.random.RandomState(k)
    cols = [rng.randint(0, 40, 5000) for _ in range(k)]  # many ties
    if k >= 2:
        cols[1] = rng.randn(5000)
        cols[1][::17] = np.nan
    if k >= 3:
        cols[2] = np.array(["k%03d" % v for v in rng.randint(0, 300, 5000)], object)
    got = zorder.morton_order(cols, device="cpu")
    assert np.array_equal(got, jax_morton(cols))


def test_interleave_keeps_bit_63_and_drops_past_64():
    ranks = torch.tensor([[65535, 0, 1], [65535, 65535, 0], [65535, 0, 0], [65535, 0, 0],
                          [65535, 0, 0]], dtype=torch.int32)
    key = zorder.interleave(ranks[:4])
    assert key[0].item() == -1  # all 64 bits set: bit 63 included
    key5 = zorder.interleave(ranks)
    assert key5[0].item() == -1  # 16 x 5 = 80 bits, the 16 past 63 dropped
    assert key5[1].item() == sum(1 << (b * 5 + 1) for b in range(13))
    assert key5[2].item() == 1
    order = zorder.morton_order([np.array([0, 65535, 3]), np.array([0, 65535, 3]),
                                 np.array([0, 65535, 3]), np.array([0, 65535, 3])],
                                device="cpu")
    assert order.tolist() == [0, 2, 1]  # the unsigned order: bit 63 sorts last


_INT_DTYPES = [np.int8, np.int16, np.int32, np.int64, np.uint8, np.uint16, np.uint32]


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 6, 7, 8])
def test_morton_order_of_integer_columns_matches_jax(k):
    """Integer columns of every width take the device rank (its plain
    version here) and the key's sort: equal to JAX's host argsorts."""
    rng = np.random.RandomState(40 + k)
    cols = []
    for c in range(k):
        dt = np.dtype(_INT_DTYPES[(c + k) % len(_INT_DTYPES)])
        lo, hi = (np.iinfo(dt).min, np.iinfo(dt).max) if c % 2 else (0, 30)  # ties
        cols.append(rng.randint(lo, int(hi) + 1, 3000, dtype=np.int64).astype(dt))
    got = zorder.morton_order(cols, device="cpu")
    assert got.dtype == np.int64
    assert np.array_equal(got, jax_morton(cols))


@pytest.mark.parametrize("case", ["ties", "all-equal", "n1", "n2", "n2-equal", "extremes"])
def test_morton_order_edge_shapes_match_jax(case):
    i64 = np.iinfo(np.int64)
    cols = {
        "ties": [np.repeat(np.arange(5), 200), np.tile(np.arange(4), 250)],
        "all-equal": [np.full(700, 9), np.full(700, -3.5)],
        "n1": [np.array([7]), np.array([2.0])],
        "n2": [np.array([7, -7]), np.array([1, 1])],
        "n2-equal": [np.array([4, 4])],
        "extremes": [np.array([i64.max, i64.min, 0, -1, i64.max, i64.min], np.int64)] * 3,
    }[case]
    assert np.array_equal(zorder.morton_order(cols, device="cpu"), jax_morton(cols))


@pytest.mark.parametrize("kind", ["int64", "int8", "int32", "date", "ts"])
def test_morton_order_null_heavy_kinds_match_jax(kind):
    """NULL-heavy integer, int8, int32, date and timestamp columns through
    both packages' ``np_col`` (NULLs take the column's minimum): the port
    ranks them as integers, JAX argsorts its numpy (dates and timestamps as
    datetime64); the orders are equal."""
    import datetime as dt

    rng = np.random.RandomState(7)
    n = 4000
    valid = rng.rand(n) < 0.15
    raw = rng.randint(-5000, 5000, n)
    if kind == "int8":
        raw = raw % 200 - 100
    np_dt = {"int64": np.int64, "int8": np.int8, "int32": np.int32, "date": np.int64,
             "ts": np.int64}[kind]
    vals = raw.astype(np_dt)
    if kind == "ts":
        vals = vals * 1_000_003
    pa_type = {"int64": pa.int64(), "int8": pa.int8(), "int32": pa.int32(),
               "date": pa.date32(), "ts": pa.timestamp("us")}[kind]
    if kind == "date":
        py = [dt.date(1970, 1, 1) + dt.timedelta(days=int(v)) for v in vals]
    elif kind == "ts":
        py = [dt.datetime(1970, 1, 1) + dt.timedelta(microseconds=int(v)) for v in vals]
    else:
        py = vals.tolist()
    second = rng.randint(0, 50, n)
    pa_t = pa.table({"c": pa.array([v if ok else None for v, ok in zip(py, valid)], pa_type),
                     "d": pa.array(second.tolist(), pa.int64())})
    host_kind = {"date": "date", "ts": "ts"}.get(kind, "int")
    host = HostTable({"c": HostColumn(host_kind, vals, valid),
                      "d": HostColumn("int", second, np.ones(n, bool))}, n)
    t = [np_col(host, c) for c in ("c", "d")]
    assert t[0].dtype.kind == "i"  # the integer kinds go to the device rank
    assert np.array_equal(zorder.morton_order(t, device="cpu"),
                          jax_morton([jax_np_col(pa_t, c) for c in ("c", "d")]))


def test_morton_order_ranks_integers_on_the_device_and_floats_on_the_host(monkeypatch):
    """Integer columns never reach the host rank; a double column with NaN
    and -0.0 does (its order is numpy's), and the result is JAX's."""
    rng = np.random.RandomState(2)
    f = rng.randn(2000)
    f[::13] = np.nan
    f[::7] = -0.0
    f[1::7] = 0.0
    ints = rng.randint(0, 100, 2000)
    host_ranked = []
    real = zorder.rank_u16

    def spy(values):
        host_ranked.append(values.dtype)
        return real(values)

    monkeypatch.setattr(zorder, "rank_u16", spy)
    got = zorder.morton_order([f, ints, ints.astype(np.int32)], device="cpu")
    assert host_ranked == [np.dtype(np.float64)]
    assert np.array_equal(got, jax_morton([f, ints, ints.astype(np.int32)]))


@pytest.mark.parametrize("case", ["equal", "sorted", "reversed", "narrow", "one", "two"])
def test_rank_and_key_order_plain_match_numpy(case):
    """The device sorts' plain versions against numpy's stable argsort: the
    key's unsigned order and a column's signed rank."""
    key = zsort_case(case)
    t = torch.from_numpy(key)
    assert np.array_equal(zorder.key_order(t).numpy(), reference_key_order(key))
    assert np.array_equal(zorder.rank_column(t).numpy(), reference_rank(key))
    assert np.array_equal(zorder.rank_column(t).numpy(), zorder.rank_u16(key).astype(np.int32))
    out = torch.full((len(key),), -1, dtype=torch.int32)
    assert zorder.rank_column(t, out=out) is out and np.array_equal(out.numpy(),
                                                                    reference_rank(key))
    with pytest.raises(TypeError):
        zorder.key_order(t.to(torch.int32))
    with pytest.raises(ValueError):
        zorder.rank_column(t, out=torch.empty(len(key) + 1, dtype=torch.int32))


def test_optimize_reports_its_phases(tmp_path):
    """The Z-order rewrite's wall split (read, zorder, take, write) lands in
    ``phase_ms``."""
    path = str(tmp_path / "t")
    rng = np.random.RandomState(1)
    delta_tpu_torch.WriteIntoDelta(
        delta_tpu_torch.DeltaLog.for_table(path, device="cpu"), "append",
        HostTable({"a": HostColumn("int", rng.randint(0, 99, 500), np.ones(500, bool)),
                   "b": HostColumn("double", rng.rand(500), np.ones(500, bool))}, 500)).run()
    cmd = OptimizeCommand(delta_tpu_torch.DeltaLog.for_table(path, device="cpu"),
                          z_order_by=["a", "b"], target_rows=100)
    cmd.run()
    assert set(cmd.phase_ms) == {"read", "zorder", "take", "write"}
    assert all(v >= 0 for v in cmd.phase_ms.values())


def _table(cols):
    """A port HostTable and a pyarrow table from the same lists."""
    pa_t = pa.table(cols)
    host = {}
    for name, vals in cols.items():
        valid = np.array([v is not None for v in vals])
        if isinstance(next((v for v in vals if v is not None), 0), str):
            host[name] = HostColumn("str", np.array(vals, object), valid)
        elif any(isinstance(v, float) for v in vals):
            host[name] = HostColumn("double", np.array([v if v is not None else 0.0
                                                        for v in vals]), valid)
        else:
            host[name] = HostColumn("int", np.array([v or 0 for v in vals], np.int64), valid)
    return pa_t, HostTable(host, len(next(iter(cols.values()))))


@pytest.mark.parametrize("cols", [
    {"x": [3, None, 1, 2], "y": [1, 2, None, 4]},
    {"s": [None, "b", "a", None, "c"], "f": [float("nan"), 2.0, None, 1.0, -3.0]},
    {"n": [None, None, None]},
])
def test_np_col_and_order_match_jax(cols):
    pa_t, host = _table(cols)
    names = list(cols)
    j = [jax_np_col(pa_t, c) for c in names]
    t = [np_col(host, c) for c in names]
    assert np.array_equal(zorder.morton_order(t, device="cpu"), jax_morton(j))
    for a, b in zip(j, t):
        assert [repr(v) for v in a.tolist()] == [repr(v) for v in b.tolist()]


# -- OPTIMIZE end states -----------------------------------------------------------


def _files_rows(jax, path):
    """Each live file's rows in order, the files sorted by their rows."""
    if jax:
        log = JaxDeltaLog.for_table(path)
        snap = log.update()
        per = [jax_read(log.data_path, [f], snap.metadata).to_pylist() for f in snap.all_files]
    else:
        log = delta_tpu_torch.DeltaLog.for_table(path, device="cpu")
        snap = log.update()
        per = [read_files_as_table(log.data_path, [f], snap.metadata,
                                   device="cpu").to_pylist()
               for f in snap.all_files]
    return sorted(per, key=repr)


def _both_optimize(tmp_path, writes, **kw):
    """``delta_tpu`` writes the table; each package optimizes its own copy
    with ``kw``. Returns (jax observation, port observation)."""
    src = str(tmp_path / "src")
    P = Pkg("jax")
    for cols, wkw in writes:
        P.write(src, cols, **wkw)
    out = []
    for name in ("jax", "torch"):
        path = str(tmp_path / name)
        shutil.copytree(src, path)
        try:
            if name == "jax":
                cmd = JaxOptimize(JaxDeltaLog.for_table(path), **kw)
            else:
                cmd = OptimizeCommand(delta_tpu_torch.DeltaLog.for_table(path, device="cpu"),
                                      **kw)
            cmd.run()
            metrics = {k: v for k, v in cmd.metrics.items()
                       if k in ("numRemovedFiles", "numAddedFiles")}
            out.append((metrics, _files_rows(name == "jax", path)))
        except Exception as e:  # the class is the observation
            out.append(type(e).__name__)
    return out


def test_optimize_compacts_small_files(tmp_path):
    j, t = _both_optimize(tmp_path, [({"id": [i]}, {}) for i in range(5)])
    assert t == j and t[0]["numRemovedFiles"] == 5 and len(t[1]) == 1
    log = delta_tpu_torch.DeltaLog.for_table(str(tmp_path / "torch"), device="cpu")
    last = log.update()
    from delta_tpu_torch.protocol.actions import actions_from_lines
    lines = open(f"{log.log_path}/{last.version:020d}.json").read().splitlines()
    acts = [a for a in actions_from_lines(lines) if hasattr(a, "data_change")]
    assert acts and all(a.data_change is False for a in acts)


def test_zorder_improves_skipping(tmp_path):
    rng = random.Random(0)
    xs = [rng.randrange(100) for _ in range(4000)]
    ys = [rng.randrange(100) for _ in range(4000)]
    j, t = _both_optimize(tmp_path, [({"x": xs, "y": ys}, {})],
                          z_order_by=["x", "y"], target_rows=500)
    assert t == j and len(t[1]) == 8
    snap = delta_tpu_torch.DeltaLog.for_table(str(tmp_path / "torch"), device="cpu").update()
    scan = scan_files(snap, ["x = 7 AND y = 93"])
    assert scan.scanned.files <= 2
    got = DeltaTable.for_path(str(tmp_path / "torch"), device="cpu").to_table(
        filters=["x = 7 AND y = 93"])
    assert got.num_rows == sum(1 for x, y in zip(xs, ys) if x == 7 and y == 93)


def test_zorder_with_nulls(tmp_path):
    j, t = _both_optimize(tmp_path, [({"x": [3, None, 1, 2], "y": [1, 2, None, 4]}, {})],
                          z_order_by=["x", "y"], target_rows=2)
    assert t == j and len(t[1]) == 2


def test_zorder_all_null_column(tmp_path):
    j, t = _both_optimize(tmp_path, [({"id": [1, 2], "s": ("string", [None, None])}, {})],
                          z_order_by=["s", "id"], target_rows=1)
    assert t == j and len(t[1]) == 2


def test_zorder_over_several_files_and_types(tmp_path):
    rng = np.random.RandomState(5)
    writes = [({"a": rng.randint(0, 1000, 300).tolist(), "b": rng.rand(300).tolist(),
                "c": ["s%02d" % v for v in rng.randint(0, 40, 300)]}, {}) for _ in range(3)]
    j, t = _both_optimize(tmp_path, writes, z_order_by=["c", "a", "b"], target_rows=128)
    assert t == j and len(t[1]) == 8


def test_zorder_rejects_partition_column(tmp_path):
    j, t = _both_optimize(tmp_path, [({"id": [1], "c": ["a"]}, {"partition_columns": ["c"]})],
                          z_order_by=["c"])
    assert j == t == "DeltaAnalysisError"
    j, t = _both_optimize(tmp_path / "b", [({"id": [1]}, {})], z_order_by=["nope"])
    assert j == t == "DeltaAnalysisError"


def test_partitioned_optimize_is_not_ported(tmp_path):
    """Partitioned OPTIMIZE, once refused by the port, now matches the
    reference: a partition predicate compacts only its partition; NULL
    partition values bin together; Z-order inside the selected
    partitions."""
    writes = [({"id": [i, i + 10], "c": ["a", "b"]}, {"partition_columns": ["c"]})
              for i in range(3)]
    j, t = _both_optimize(tmp_path, writes, predicate="c = 'a'")
    assert t == j and t[0] == {"numRemovedFiles": 3, "numAddedFiles": 1} and len(t[1]) == 4
    writes = [({"id": [1], "p": ("string", [None])}, {"partition_columns": ["p"]}),
              ({"id": [2], "p": ("string", [None])}, {})]
    j, t = _both_optimize(tmp_path / "b", writes)
    assert t == j and t[0] == {"numRemovedFiles": 2, "numAddedFiles": 1}
    writes = [({"x": [5, 1, 3, 2], "y": [0, 9, 4, 4], "c": ["a", "a", "b", "b"]},
               {"partition_columns": ["c"]}) for _ in range(2)]
    j, t = _both_optimize(tmp_path / "z", writes, predicate="c = 'b'", z_order_by=["x", "y"],
                          target_rows=2)
    assert t == j and t[0] == {"numRemovedFiles": 2, "numAddedFiles": 2}


def test_purge_materializes_deletion_vectors(tmp_path):
    from delta_tpu.commands.delete import DeleteCommand as JaxDelete

    src = str(tmp_path / "src")
    P = Pkg("jax")
    P.write(src, {"id": list(range(100)), "v": [float(i) for i in range(100)]},
            configuration={"delta.tpu.enableDeletionVectors": "true"})
    JaxDelete(JaxDeltaLog.for_table(src), "id % 3 = 0").run()
    for name in ("jax", "torch"):
        shutil.copytree(src, str(tmp_path / name))
    JaxOptimize(JaxDeltaLog.for_table(str(tmp_path / "jax")), purge=True).run()
    DeltaTable.for_path(str(tmp_path / "torch"), device="cpu").optimize().execute_purge()
    assert _files_rows(False, str(tmp_path / "torch")) == _files_rows(True, str(tmp_path / "jax"))
    snap = delta_tpu_torch.DeltaLog.for_table(str(tmp_path / "torch"), device="cpu").update()
    assert all(f.deletion_vector is None for f in snap.all_files)


def test_budget_and_unported_options(tmp_path):
    path = str(tmp_path / "t")
    P = Pkg("torch")
    for i in range(3):
        log = P.write(path, {"id": [i]})
    with pytest.raises(OptimizeBudgetExceeded):
        OptimizeCommand(log, max_rewrite_bytes=10).run()
    assert len(log.update().all_files) == 3  # nothing rewritten
    for kw in ({"workers": 2}, {"distribute": True}, {"on_failure": "quarantine"}):
        with pytest.raises(NotImplementedError):
            OptimizeCommand(log, **kw)


# -- the port's OPTIMIZE read back by delta_tpu -----------------------------------


def test_port_optimized_table_reads_back_in_delta_tpu(tmp_path):
    path = str(tmp_path / "t")
    P = Pkg("torch")
    rng = np.random.RandomState(2)
    for _ in range(4):
        P.write(path, {"k": rng.randint(0, 500, 250).tolist(), "v": rng.rand(250).tolist(),
                       "s": ["t%d" % v for v in rng.randint(0, 9, 250)]})
    before = sorted_rows(Pkg("jax").scan(JaxDeltaLog.for_table(path)).to_pylist())
    with conf.set_temporarily(**{"delta.tpu.write.rowGroupRows": 64}):
        metrics = DeltaTable.for_path(path, device="cpu").optimize().execute_z_order_by(
            "k", "s", target_rows=300)
    assert metrics["numRemovedFiles"] == 4 and metrics["numAddedFiles"] == 4
    JaxDeltaLog.clear_cache()
    jlog = JaxDeltaLog.for_table(path)
    assert sorted_rows(Pkg("jax").scan(jlog).to_pylist()) == before
    snap = jlog.update()
    assert len(snap.all_files) == 4
    pruned = jax_scan_files(snap, ["k = 17 AND s = 't3'"])
    assert pruned.scanned.files <= 2


# -- no stale lane or slab after an OPTIMIZE ---------------------------------------


def test_optimize_bumps_both_epochs_and_serves_no_stale_lane(tmp_path):
    path = str(tmp_path / "t")
    P = Pkg("torch")
    for i in range(3):
        log = P.write(path, {"id": list(range(i * 100, (i + 1) * 100)),
                             "cat": ["old" if j % 2 else "new" for j in range(100)]})
    lanes, slabs = ColumnCache.instance(), KeyCache.instance()
    with conf.set_temporarily(**{"delta.tpu.read.deviceResidual.mode": "force"}):
        assert DeltaTable.for_path(path, device="cpu").to_table(
            filters=["cat = 'old'"]).num_rows == 150
    assert lanes.resident_bytes() > 0
    e_lanes, e_slabs = lanes.epoch(log.log_path), slabs.epoch(log.log_path)
    OptimizeCommand(log, z_order_by=["cat", "id"], target_rows=120).run()
    assert lanes.epoch(log.log_path) == e_lanes + 1
    assert slabs.epoch(log.log_path) == e_slabs + 1
    assert lanes.resident_bytes() == 0
    with conf.set_temporarily(**{"delta.tpu.read.deviceResidual.mode": "force"}):
        got = DeltaTable.for_path(path, device="cpu").to_table(filters=["cat = 'old'"],
                                                               columns=["id"])
    assert sorted(got.column("id").values.tolist()) == [j for j in range(300) if j % 100 % 2]
    # a MERGE after the rewrite: the slab rebuilds over the new files
    with conf.set_temporarily(**{"delta.tpu.merge.devicePath.mode": "force"}):
        P.merge(log, {"id": [1, 2, 999], "cat": ["x", "y", "z"]}, "t.id = s.id",
                [("update",)], [("insert",)], source_alias="s", target_alias="t")
    rows = {r["id"]: r["cat"] for r in P.rows(log)}
    assert len(rows) == 301 and rows[1] == "x" and rows[2] == "y" and rows[999] == "z"


def test_optimize_with_nothing_to_do_keeps_the_epochs(tmp_path):
    path = str(tmp_path / "t")
    log = Pkg("torch").write(path, {"id": [1, 2]})
    e = ColumnCache.instance().epoch(log.log_path)
    OptimizeCommand(log).run()  # one file: nothing to compact
    assert ColumnCache.instance().epoch(log.log_path) == e

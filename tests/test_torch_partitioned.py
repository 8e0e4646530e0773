"""Partitioned tables through the port (writer, reader, device residual,
DELETE, UPDATE, MERGE, OPTIMIZE, VACUUM, the commit's conflict check and
the resident plan's partition lanes) against ``delta_tpu`` on the CPU.

Each case replays the inputs of a partitioned case of the reference's own
tests (``tests/test_write_read.py``, ``test_datatypes.py``,
``test_rowgroups.py``, ``test_dml.py``, ``test_column_cache.py``,
``test_state_cache.py``, ``test_vacuum_scenarios.py``, ``test_txn.py``):
each package writes the same data into a table of its own and runs the
case there. The two tables must then agree exactly:

* rows: each package reads both tables; a package reading one table in
  both packages gives the same rows in the same order (file order, then
  row order inside a file), and all four reads agree as sorted rows;
* layout: each live file's relative directory, ``partitionValues``,
  stats and deletion-vector flag (file names hold a random uuid);
* commits: each version's operation, ``operationParameters`` and
  operation metrics (without times and byte counts: the two packages'
  Snappy compressors give files of other sizes).

Tolerance: exact everywhere, NaN equal to NaN.
"""
import datetime as dt
import json
import os
import shutil
import urllib.parse

import numpy as np
import pyarrow.parquet as pq
import pytest

import delta_tpu
import delta_tpu_torch
from delta_tpu.api.tables import DeltaTable as JaxTable
from delta_tpu.commands import operations as jax_ops
from delta_tpu.commands.delete import DeleteCommand as JaxDelete
from delta_tpu.commands.optimize import OptimizeCommand as JaxOptimize
from delta_tpu.commands.update import UpdateCommand as JaxUpdate
from delta_tpu.commands.vacuum import VacuumCommand as JaxVacuum
from delta_tpu.exec.scan import plan_scans as jax_plan_scans
from delta_tpu.exec.scan import scan_files as jax_scan_files
from delta_tpu.ops.column_cache import ColumnCache as JaxColumnCache
from delta_tpu.ops.state_cache import DeviceStateCache as JaxStateCache
from delta_tpu.utils.config import conf as jax_conf
from delta_tpu_torch.api.tables import DeltaTable as TorchTable
from delta_tpu_torch.commands import operations as torch_ops
from delta_tpu_torch.commands.write import coerce_to_table
from delta_tpu_torch.commands.delete import DeleteCommand as TorchDelete
from delta_tpu_torch.commands.optimize import OptimizeCommand as TorchOptimize
from delta_tpu_torch.commands.update import UpdateCommand as TorchUpdate
from delta_tpu_torch.commands.vacuum import VacuumCommand as TorchVacuum
from delta_tpu_torch.exec import write as write_exec
from delta_tpu_torch.exec.scan import scan_files as torch_scan_files
from delta_tpu_torch.expr import device_eval, ir
from delta_tpu_torch.expr.parser import parse_expression, parse_predicate
from delta_tpu_torch.expr.partition import split_partition_and_data_predicates
from delta_tpu_torch.ops import column_cache, pruning, state_cache
from delta_tpu_torch.ops.column_cache import ColumnCache
from delta_tpu_torch.ops.state_cache import DeviceStateCache as TorchStateCache
from delta_tpu_torch.schema.types import IntegerType, StringType
from delta_tpu_torch.utils import telemetry
from delta_tpu_torch.utils.config import conf as torch_conf
from tests.torch_port_tables import Pkg, both_confs, observe, reset_caches

PKGS = ("jax", "torch")
OFF = {"delta.tpu.read.deviceResidual.mode": "off"}
FORCE = {"delta.tpu.read.deviceResidual.mode": "force"}
DV_PROPS = {"delta.tpu.enableDeletionVectors": "true"}
HOUR = 3600 * 1000
WEEK = 7 * 24 * HOUR


@pytest.fixture(autouse=True)
def _fresh():
    reset_caches()
    ColumnCache.reset()
    JaxColumnCache.reset()
    TorchStateCache.reset()
    JaxStateCache.reset()
    delta_tpu.DeltaLog.clear_cache()
    yield
    reset_caches()
    ColumnCache.reset()
    JaxColumnCache.reset()
    TorchStateCache.reset()
    JaxStateCache.reset()
    delta_tpu.DeltaLog.clear_cache()


# -- the vocabulary -----------------------------------------------------------------


def paths_of(tmp_path):
    return {name: str(tmp_path / name) for name in PKGS}


def write_both(paths, cols, mode="append", **kw):
    """The same write through each package into its own table; each
    outcome (the version, or the exception's class name)."""
    return {name: observe(lambda: Pkg(name).write(paths[name], cols, mode, **kw)
                          .update().version)
            for name in PKGS}


def handle(name, path):
    if name == "jax":
        return JaxTable.for_path(path)
    return TorchTable.for_path(path, device="cpu")


def read(name, path, filters=(), columns=None):
    """The table's rows as package ``name`` reads them, in its order."""
    t = handle(name, path)
    got = (t.to_arrow(filters=list(filters), columns=columns) if name == "jax"
           else t.to_table(filters=list(filters), columns=columns))
    return got.to_pylist()


def _norm(rows):
    return [{k: ("NaN" if isinstance(v, float) and v != v else v) for k, v in r.items()}
            for r in rows]


def _sorted(rows):
    return sorted(_norm(rows), key=lambda r: [(v is None, repr(v)) for v in r.values()])


def layout(path):
    """Each live file's (directory, partitionValues, stats, has a DV)."""
    snap = delta_tpu.DeltaLog.for_table(path).update()
    return sorted((os.path.dirname(urllib.parse.unquote(f.path)),
                   json.dumps(f.partition_values, sort_keys=True),
                   json.dumps(json.loads(f.stats), sort_keys=True) if f.stats else None,
                   f.deletion_vector is not None)
                  for f in snap.all_files)


def commits(path):
    """Each commit's operation, its parameters and its metrics (times and
    byte counts left out)."""
    out = []
    log_dir = os.path.join(path, "_delta_log")
    for name in sorted(n for n in os.listdir(log_dir) if n.endswith(".json")):
        for line in open(os.path.join(log_dir, name)):
            ci = json.loads(line).get("commitInfo")
            if ci:
                m = {k: v for k, v in (ci.get("operationMetrics") or {}).items()
                     if not k.endswith("TimeMs") and "Bytes" not in k}
                out.append((ci["operation"], ci.get("operationParameters"), m))
    return out


def assert_parity(paths, filters=(), columns=None):
    """Rows, layout and commits of the two tables agree (see the module
    docstring); returns the sorted rows."""
    for path in paths.values():
        one = [read(name, path, filters, columns) for name in PKGS]
        assert _norm(one[0]) == _norm(one[1]), path  # same table: same order
    want = _sorted(read("jax", paths["jax"], filters, columns))
    assert _sorted(read("torch", paths["torch"], filters, columns)) == want
    assert layout(paths["torch"]) == layout(paths["jax"])
    assert commits(paths["torch"]) == commits(paths["jax"])
    return want


def clear_logs():
    delta_tpu.DeltaLog.clear_cache()
    delta_tpu_torch.DeltaLog.clear_cache()


# -- the writer's partition strings (write_exec) ------------------------------------


@pytest.mark.parametrize("value", [None, "", "a", "a/b c=d", "x%y#z", "\x01\x7f", "é=ü",
                                   "{x}[y]^'q'\"r\"", "t\tn\nr\r"])
def test_escape_and_path_match_jax(value):
    from delta_tpu.exec import write as jax_write

    assert write_exec.escape_partition_value(value) == jax_write.escape_partition_value(value)
    esc = write_exec.escape_partition_value(value)
    assert write_exec.unescape_partition_value(esc) == jax_write.unescape_partition_value(esc)
    pv = {"a": value, "b": "1"}
    assert (write_exec.partition_path(pv, ["a", "b"])
            == jax_write.partition_path(pv, ["a", "b"]))


def test_split_partition_and_data_predicates_matches_jax():
    from delta_tpu.expr.partition import (
        split_partition_and_data_predicates as jax_split,
    )

    for pred in ("p = 1 AND x > 2", "p = 1 OR x > 2", "P >= 3 AND q < 2 AND x IS NULL",
                 "TRUE", "x = 1"):
        got = split_partition_and_data_predicates(pred, ["p", "q"])
        want = jax_split(pred, ["p", "q"])
        assert [[e.sql() for e in part] for part in got] == \
            [[e.sql() for e in part] for part in want]


# -- tests/test_write_read.py --------------------------------------------------------


def test_partitioned_write_layout_and_pruning(tmp_path):
    """``test_write_read.py:62``."""
    paths = paths_of(tmp_path)
    write_both(paths, {"id": [1, 2, 3, 4], "country": ["us", "us", "fr", "fr"]},
               partition_columns=["country"])
    assert_parity(paths)
    for name in PKGS:
        snap = Pkg(name).log(paths[name]).update()
        files = snap.all_files
        assert len(files) == 2 and all(f.path.startswith("country=") for f in files)
        raw = pq.ParquetFile(os.path.join(paths[name], urllib.parse.unquote(files[0].path)))
        assert "country" not in raw.read().column_names
    snap = delta_tpu_torch.DeltaLog.for_table(paths["torch"], device="cpu").update()
    assert len(torch_scan_files(snap, ["country = 'us'"]).files) == 1
    for filters, want in ((["country = 'us'"], [1, 2]), (["country = 'fr' AND id > 3"], [4])):
        got = assert_parity(paths, filters)
        assert sorted(r["id"] for r in got) == want


def test_replace_where(tmp_path):
    """``test_write_read.py:136``: a replaceWhere overwrite, data outside
    the predicate and a data-column predicate refused as in the reference."""
    paths = paths_of(tmp_path)
    write_both(paths, {"id": [1, 2, 3, 4], "country": ["us", "us", "fr", "fr"]},
               partition_columns=["country"])
    out = write_both(paths, {"id": [20, 21], "country": ["us", "us"]}, mode="overwrite",
                     replace_where="country = 'us'")
    assert out == {"jax": 1, "torch": 1}
    got = assert_parity(paths)
    assert sorted(r["id"] for r in got) == [3, 4, 20, 21]
    for data, pred in (({"id": [9], "country": ["de"]}, "country = 'us'"),
                       ({"id": [9], "country": ["us"]}, "id > 0")):
        clear_logs()
        out = write_both(paths, data, mode="overwrite", replace_where=pred)
        assert out["torch"] == out["jax"] == "DeltaAnalysisError"
    clear_logs()
    assert write_both(paths, {"id": [5]}, mode="append", replace_where="country = 'us'") == \
        {"jax": "DeltaAnalysisError", "torch": "DeltaAnalysisError"}
    assert assert_parity(paths) == got


def test_null_partition_value_roundtrip(tmp_path):
    """``test_write_read.py:193``."""
    paths = paths_of(tmp_path)
    write_both(paths, {"id": [1, 2], "p": ["a", None]}, partition_columns=["p"])
    got = assert_parity(paths)
    assert {r["id"]: r["p"] for r in got} == {1: "a", 2: None}
    for name in PKGS:
        snap = Pkg(name).log(paths[name]).update()
        assert any("__HIVE_DEFAULT_PARTITION__" in f.path for f in snap.all_files)
    assert_parity(paths, ["p IS NULL"])


def test_special_chars_in_partition_values(tmp_path):
    """``test_write_read.py:209``, with more of the characters Hive
    escapes."""
    paths = paths_of(tmp_path)
    values = ["a/b c=d", "x%25y", "q#?*", "é:ü"]
    write_both(paths, {"id": [1, 2, 3, 4], "p": values}, partition_columns=["p"])
    assert_parity(paths)
    for i, v in enumerate(values):
        pred = "p = '" + v.replace("'", "''") + "'"
        got = assert_parity(paths, [pred])
        assert [r["id"] for r in got] == [i + 1]
    dirs = {name: sorted(d for d in os.listdir(paths[name]) if d.startswith("p="))
            for name in PKGS}
    assert dirs["torch"] == dirs["jax"] and "p=a%2Fb%20c%3Dd" in dirs["torch"]


def test_partition_only_projection(tmp_path):
    """``test_write_read.py:252``: no stored column decodes; the row count
    carries."""
    paths = paths_of(tmp_path)
    write_both(paths, {"id": [1, 2, 2], "c": ["a", "b", "b"]}, partition_columns=["c"])
    got = assert_parity(paths, columns=["c"])
    assert sorted(r["c"] for r in got) == ["a", "b", "b"]
    assert assert_parity(paths, ["id > 1"], columns=["c"]) == [{"c": "b"}, {"c": "b"}]


def test_nan_partition_value_not_lost(tmp_path):
    """``test_write_read.py:259``: NaN groups as one partition, ``p=nan``."""
    paths = paths_of(tmp_path)
    write_both(paths, {"id": [1, 2, 3, 4, 5], "p": [1.5, float("nan"), None, float("nan"), 1.5]},
               partition_columns=["p"])
    got = assert_parity(paths)
    assert sorted(r["id"] for r in got) == [1, 2, 3, 4, 5]
    for name in PKGS:
        dirs = sorted(d for d in os.listdir(paths[name]) if d.startswith("p="))
        assert dirs == ["p=1.5", "p=__HIVE_DEFAULT_PARTITION__", "p=nan"]


@pytest.mark.parametrize("mode", ["off", "force"])
def test_numeric_partition_with_data_predicate(tmp_path, mode):
    """``test_write_read.py:267``: the device residual binds the partition
    value per file (never a dictionary code)."""
    paths = paths_of(tmp_path)
    write_both(paths, {"id": [1, 2, 3, 4], "year": [2020, 2020, 2021, 2021]},
               partition_columns=["year"])
    settings = {"delta.tpu.read.deviceResidual.mode": mode}
    with both_confs(**settings):
        c0 = telemetry.counters("scan.device").get("scan.device.engaged", 0)
        got = assert_parity(paths, ["year = 2021 OR id > 100"])
        engaged = telemetry.counters("scan.device").get("scan.device.engaged", 0) - c0
    assert sorted(r["id"] for r in got) == [3, 4]
    assert (engaged > 0) == (mode == "force")


def test_many_partitions_write(tmp_path):
    """``test_write_read.py:289``, split at ``targetFileRows`` inside each
    partition as well."""
    paths = paths_of(tmp_path)
    n = 500
    with both_confs(**{"delta.tpu.write.targetFileRows": 7}):
        write_both(paths, {"id": list(range(n)), "p": [str(i % 50) for i in range(n)]},
                   partition_columns=["p"])
    got = assert_parity(paths)
    assert sorted(r["id"] for r in got) == list(range(n))
    for name in PKGS:
        assert len(Pkg(name).log(paths[name]).update().all_files) == 100


def test_multi_column_partition_order_and_row_order(tmp_path):
    """Two partition columns with NULLs, NaN and -0.0: the groups, their
    order and the rows inside each file are the reference's (a stable sort,
    NULLs and then NaN last)."""
    rng = np.random.RandomState(5)
    n = 400
    a = [None if r < 0.1 else ["x", "y", "z"][int(r * 10) % 3] for r in rng.rand(n)]
    b = [None if r < 0.1 else (float("nan") if r > 0.9 else [0.0, -0.0, 2.5][int(r * 10) % 3])
         for r in rng.rand(n)]
    paths = paths_of(tmp_path)
    write_both(paths, {"id": list(range(n)), "a": a, "b": b, "v": rng.rand(n).tolist()},
               partition_columns=["a", "b"])
    assert_parity(paths)
    for name in PKGS:
        snap = Pkg(name).log(paths[name]).update()
        first = {os.path.dirname(urllib.parse.unquote(f.path)): f for f in snap.all_files}
        assert "a=x/b=0.0" in first and "a=__HIVE_DEFAULT_PARTITION__/b=nan" in first


# -- tests/test_datatypes.py:130 ----------------------------------------------------


TYPED = [
    ("string", ["x y"], "p=x%20y", "p = 'x y'"),
    ("int64", [7], "p=7", "p = 7"),
    ("int32", [-3], "p=-3", "p = -3"),
    ("date", [dt.date(2024, 5, 1)], "p=2024-05-01", "p = '2024-05-01'"),
    ("bool", [True], "p=true", "p = true"),
    ("float64", [1.0], "p=1.0", "p = 1.0"),
    ("timestamp", [dt.datetime(2020, 1, 1)], "p=2020-01-01%2000%3A00%3A00",
     "p = '2020-01-01 00:00:00'"),
    ("timestamp", [dt.datetime(2020, 1, 1, 0, 0, 0, 999)],
     "p=2020-01-01%2000%3A00%3A00.000999",
     "p > '2020-01-01 00:00:00'"),
]


@pytest.mark.parametrize("case", range(len(TYPED)))
def test_partition_values_per_type(tmp_path, case):
    typ, values, part_dir, pred = TYPED[case]
    paths = paths_of(tmp_path)
    write_both(paths, {"p": (typ, values), "x": [1]}, partition_columns=["p"])
    got = assert_parity(paths)
    assert [r["p"] for r in got] == values
    for name in PKGS:
        assert [d for d in os.listdir(paths[name]) if d.startswith("p=")] == [part_dir]
    for mode in ("off", "force"):
        with both_confs(**{"delta.tpu.read.deviceResidual.mode": mode}):
            assert len(assert_parity(paths, [pred])) == 1
            assert len(assert_parity(paths, [pred + " AND x >= 1"])) == 1


# -- tests/test_rowgroups.py:479 -----------------------------------------------------


@pytest.mark.parametrize("skipping", [False, True])
def test_partitioned_mixed_or_predicate(tmp_path, skipping):
    """The row-group tier gets each file's typed partition row."""
    paths = paths_of(tmp_path)
    with both_confs(**{"delta.tpu.write.rowGroupRows": 100}):
        write_both(paths, {"id": list(range(2000)),
                           "p": ["a" if i < 1000 else "b" for i in range(2000)]},
                   partition_columns=["p"])
    with both_confs(**{"delta.tpu.read.rowGroupSkipping": skipping}):
        for pred in ("p = 'a' OR id >= 1900", "p = 'b' AND id < 1010", "id < 5 OR p = 'zz'"):
            for mode in (OFF, FORCE):
                with both_confs(**mode):
                    got = assert_parity(paths, [pred])
            if pred.startswith("p = 'a'"):
                assert sorted(r["id"] for r in got) == list(range(1000)) + list(range(1900, 2000))


# -- tests/test_dml.py ----------------------------------------------------------------


def _dml_table(paths, dv=False, **kw):
    cols = {"id": [1, 2, 3, 4], "c": ["a", "a", "b", "b"]}
    write_both(paths, cols, partition_columns=["c"],
               configuration=DV_PROPS if dv else None, **kw)


def _run(paths, fn):
    """``fn(name, log)`` on each package's table; the metrics (without
    times) or the exception's class name."""
    out = {}
    for name in PKGS:
        log = Pkg(name).log(paths[name])
        res = observe(lambda: fn(name, log))
        out[name] = ({k: v for k, v in res.items() if not k.endswith("TimeMs")}
                     if isinstance(res, dict) else res)
    return out


def _delete(cond):
    def run(name, log):
        cmd = (JaxDelete if name == "jax" else TorchDelete)(log, cond)
        cmd.run()
        return cmd.metrics
    return run


def _update(sets, cond):
    def run(name, log):
        cmd = (JaxUpdate if name == "jax" else TorchUpdate)(log, sets, cond)
        cmd.run()
        return cmd.metrics
    return run


def test_delete_partition_only_metadata(tmp_path):
    """``test_dml.py:44``."""
    paths = paths_of(tmp_path)
    _dml_table(paths)
    out = _run(paths, _delete("c = 'a'"))
    assert out["torch"] == out["jax"]
    assert out["torch"]["numDeletedRows"] == -1 and out["torch"]["numAddedFiles"] == 0
    got = assert_parity(paths)
    assert sorted(r["id"] for r in got) == [3, 4]


@pytest.mark.parametrize("dv", [False, True])
@pytest.mark.parametrize("cond", ["id > 1", "c = 'b' AND id > 3", "c = 'a' OR id = 4"])
def test_delete_data_predicate(tmp_path, dv, cond):
    """Case 3 on a partitioned table: the survivors or the deletion vector
    stay in each file's partition."""
    paths = paths_of(tmp_path)
    _dml_table(paths, dv=dv)
    out = _run(paths, _delete(cond))
    assert out["torch"] == out["jax"] and out["torch"]["numDeletedRows"] > 0
    assert_parity(paths)


def test_update_partition_column_moves_rows(tmp_path):
    """``test_dml.py:135``."""
    paths = paths_of(tmp_path)
    write_both(paths, {"id": [1, 2], "c": ["a", "a"]}, partition_columns=["c"])
    out = _run(paths, _update({"c": "'b'"}, "id = 2"))
    assert out["torch"] == out["jax"]
    assert [r["id"] for r in assert_parity(paths, ["c = 'b'"])] == [2]
    assert_parity(paths)


@pytest.mark.parametrize("dv", [False, True])
@pytest.mark.parametrize("sets,cond", [({"id": "id + 10"}, "c = 'a'"),
                                       ({"c": "'z'", "id": "id * 2"}, "id >= 2"),
                                       ({"c": "NULL"}, "id = 3")])
def test_update_partitioned(tmp_path, dv, sets, cond):
    paths = paths_of(tmp_path)
    _dml_table(paths, dv=dv)
    out = _run(paths, _update(sets, cond))
    assert out["torch"] == out["jax"] and out["torch"]["numUpdatedRows"] > 0
    assert_parity(paths)


def _merge(source, cond, matched, not_matched):
    def run(name, log):
        P = Pkg(name)
        cmd = P.merge(log, source, cond, matched, not_matched, source_alias="s",
                      target_alias="t")
        return cmd.metrics
    return run


@pytest.mark.parametrize("device", ["off", "force"])
def test_merge_partitioned_target(tmp_path, device):
    """``test_dml.py:329``, through the host join and the key slab."""
    paths = paths_of(tmp_path)
    _dml_table(paths)
    with both_confs(**{"delta.tpu.merge.devicePath.mode": device}):
        out = _run(paths, _merge({"id": [2, 9], "c": ["a", "b"]}, "t.id = s.id",
                                 [("delete",)], [("insert",)]))
    assert out["torch"] == out["jax"]
    got = assert_parity(paths)
    assert sorted(r["id"] for r in got) == [1, 3, 4, 9]
    assert sorted(r["id"] for r in assert_parity(paths, ["c = 'b'"])) == [3, 4, 9]


@pytest.mark.parametrize("dv", [False, True])
@pytest.mark.parametrize("device", ["off", "force"])
def test_merge_upsert_into_partitioned_target(tmp_path, dv, device):
    """Updates stay in their partitions or move (the partition column
    assigned); inserts land in new and existing partitions."""
    paths = paths_of(tmp_path)
    rng = np.random.RandomState(3)
    n = 300
    write_both(paths, {"id": list(range(n)), "d": [int(v) for v in rng.randint(0, 6, n)],
                       "v": rng.rand(n).tolist()},
               partition_columns=["d"], configuration=DV_PROPS if dv else None)
    src = {"id": list(range(250, 350)), "d": [int(v) for v in rng.randint(4, 9, 100)],
           "v": rng.rand(100).tolist()}
    with both_confs(**{"delta.tpu.merge.devicePath.mode": device}):
        out = _run(paths, _merge(src, "t.id = s.id", [("update",)], [("insert",)]))
    assert out["torch"] == out["jax"]
    assert out["torch"]["numTargetRowsUpdated"] == 50
    assert len(assert_parity(paths)) == 350
    with both_confs(**{"delta.tpu.merge.devicePath.mode": device}):
        out = _run(paths, _merge({"id": [1, 2, 500], "d": [0, 0, 0], "v": [0.0, 0.0, 0.0]},
                                 "t.id = s.id AND t.d = s.d", [("update", None, {"v": "s.v + 1"})],
                                 [("insert",)]))
    assert out["torch"] == out["jax"]
    assert_parity(paths)


def test_merge_join_on_partition_column_takes_host_route(tmp_path):
    """The key slab has no lane for a partition column (no file stores it):
    both packages' MERGE falls back to the host join."""
    paths = paths_of(tmp_path)
    _dml_table(paths)
    with both_confs(**{"delta.tpu.merge.devicePath.mode": "force"}):
        out = _run(paths, _merge({"c": ["a", "z"], "id": [7, 8]}, "t.c = s.c",
                                 [("delete",)], [("insert",)]))
    assert out["torch"] == out["jax"]
    assert_parity(paths)


def _optimize(**kw):
    def run(name, log):
        cmd = (JaxOptimize if name == "jax" else TorchOptimize)(log, **kw)
        cmd.run()
        return {k: v for k, v in cmd.metrics.items()
                if k in ("numRemovedFiles", "numAddedFiles")}
    return run


def test_optimize_partition_scoped(tmp_path):
    """``test_dml.py:384``."""
    paths = paths_of(tmp_path)
    for i in range(3):
        write_both(paths, {"id": [i, i + 10], "c": ["a", "b"]}, partition_columns=["c"])
    out = _run(paths, _optimize(predicate="c = 'a'"))
    assert out["torch"] == out["jax"] == {"numRemovedFiles": 3, "numAddedFiles": 1}
    assert_parity(paths)
    for name in PKGS:
        files = Pkg(name).log(paths[name]).update().all_files
        assert sorted(f.partition_values["c"] for f in files) == ["a", "b", "b", "b"]
    out = _run(paths, _optimize(predicate="id > 1"))
    assert out["torch"] == out["jax"] == "DeltaAnalysisError"


def test_zorder_rejects_partition_column(tmp_path):
    """``test_dml.py:423``."""
    paths = paths_of(tmp_path)
    write_both(paths, {"id": [1], "c": ["a"]}, partition_columns=["c"])
    out = _run(paths, _optimize(z_order_by=["c"]))
    assert out["torch"] == out["jax"] == "DeltaAnalysisError"


@pytest.mark.parametrize("writer", PKGS)
def test_zorder_inside_partitions(tmp_path, writer):
    """Z-order inside the partitions a predicate selects, on copies of one
    table (written by each package in turn): the Morton order breaks ties
    by the rows' read order, which follows the files' names."""
    rng = np.random.RandomState(9)
    n = 2000
    src = str(tmp_path / "src")
    for part in range(2):
        Pkg(writer).write(src, {"x": rng.randint(0, 100, n).tolist(),
                                "y": rng.randint(0, 100, n).tolist(),
                                "d": [int(v) for v in rng.randint(0, 3, n)]},
                          partition_columns=["d"])
    paths = paths_of(tmp_path)
    for path in paths.values():
        shutil.copytree(src, path)
    out = _run(paths, _optimize(predicate="d >= 1", z_order_by=["x", "y"], target_rows=250))
    assert out["torch"] == out["jax"]
    assert_parity(paths)
    assert_parity(paths, ["d = 2 AND x = 7 AND y < 50"])


def test_optimize_null_partition_values(tmp_path):
    """``test_dml.py:495``."""
    paths = paths_of(tmp_path)
    write_both(paths, {"id": [1], "p": ("string", [None])}, partition_columns=["p"])
    for i, p in ((2, None), (3, "x"), (4, "x")):
        write_both(paths, {"id": [i], "p": ("string", [p])})
    out = _run(paths, _optimize())
    assert out["torch"] == out["jax"] == {"numRemovedFiles": 4, "numAddedFiles": 2}
    assert sorted(r["id"] for r in assert_parity(paths)) == [1, 2, 3, 4]


# -- each package reads the other's table, and runs DML on it -------------------------


def test_each_package_runs_dml_on_the_others_table(tmp_path):
    """A table ``delta_tpu`` wrote, a DELETE and an UPDATE by the port on it,
    then ``delta_tpu`` on what the port wrote, and the reverse: the end
    states agree."""
    src = paths_of(tmp_path / "src")
    write_both(src, {"id": list(range(20)), "c": [["a", "b", None][i % 3] for i in range(20)],
                     "v": [float(i) for i in range(20)]}, partition_columns=["c"])
    assert_parity(src)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    shutil.copytree(src["jax"], a)   # written by delta_tpu, changed by the port
    shutil.copytree(src["torch"], b)  # written by the port, changed by delta_tpu
    TorchDelete(delta_tpu_torch.DeltaLog.for_table(a, device="cpu"), "v > 15").run()
    JaxDelete(delta_tpu.DeltaLog.for_table(b), "v > 15").run()
    TorchUpdate(delta_tpu_torch.DeltaLog.for_table(a, device="cpu"), {"c": "'b'"}, "id < 3").run()
    JaxUpdate(delta_tpu.DeltaLog.for_table(b), {"c": "'b'"}, "id < 3").run()
    got = assert_parity({"jax": b, "torch": a})
    assert len(got) == 16 and {r["id"] for r in got if r["c"] == "b"} >= {0, 1, 2}


# -- tests/test_column_cache.py --------------------------------------------------------


def _cc_table(paths, n=400, files=3):
    rng = np.random.RandomState(7)
    for i in range(files):
        cols = {
            "id": list(range(i * n, (i + 1) * n)),
            "cat": [None if v == "-" else v for v in
                    rng.choice(["alpha", "beta", "gamma", "-"], n).tolist()],
            "x": rng.rand(n).tolist(),
            "d": ("date", [dt.date(2024, 1, 1) + dt.timedelta(days=int(v))
                           for v in rng.randint(0, 400, n)]),
            "p": ("int32", [i % 2] * n),
        }
        write_both(paths, cols, partition_columns=["p"])


@pytest.mark.parametrize("pred", ["p = 0 AND cat = 'alpha'", "p = 1 OR x < 0.1",
                                  "p + id > 500 AND d > '2024-06-01'"])
def test_identity_with_typed_partition_column(tmp_path, pred):
    """``test_column_cache.py:145``: the device residual (K14's plain
    version, the partition value a per-file scalar) equals the host path."""
    paths = paths_of(tmp_path)
    _cc_table(paths)
    with both_confs(**OFF):
        host = assert_parity(paths, [pred])
    with both_confs(**FORCE):
        dev = assert_parity(paths, [pred])
    assert host == dev and host


def test_residual_with_null_and_typed_partitions_in_one_read(tmp_path):
    """NULL and non-NULL partition values of every lane dtype in one read:
    a NULL binds as the column's own dtype with valid=False, so one program
    and one launch serve every file."""
    paths = paths_of(tmp_path)
    spec = [("i", "int64", [5, None, -2]), ("f", "float64", [1.5, None, float("nan")]),
            ("b", "bool", [True, None, False]),
            ("d", "date", [dt.date(2020, 1, 1), None, dt.date(1969, 12, 31)]),
            ("t", "timestamp", [dt.datetime(2020, 1, 1, 1), None, dt.datetime(1960, 1, 1)])]
    for k in range(3):
        cols = {"id": list(range(k * 10, k * 10 + 10)), "x": [float(j) for j in range(10)]}
        for name, typ, vals in spec:
            cols[name] = (typ, [vals[k]] * 10)
        write_both(paths, cols, partition_columns=[s[0] for s in spec])
    preds = ["i = 5 OR x > 8", "i IS NULL AND x < 3", "f > 1.0 OR id = 25", "NOT b AND x >= 0",
             "d >= '2020-01-01' OR x = 0", "t < '2000-01-01' AND x > 4",
             "coalesce(i, 100) > 50 AND x > 1", "coalesce(i, x) > 4", "i + x > 6",
             "coalesce(f, 2.5) > 2 OR x = 9"]
    launches = []
    real = column_cache.residual_masks

    def counting(program, envs, ns, scalars):
        launches.append(len(envs))
        return real(program, envs, ns, scalars)

    snap = delta_tpu_torch.DeltaLog.for_table(paths["torch"], device="cpu").update()
    column_cache.residual_masks = counting
    try:
        for pred in preds:
            with both_confs(**OFF):
                host = assert_parity(paths, [pred])
            del launches[:]
            with both_confs(**FORCE):
                dev = assert_parity(paths, [pred])
            assert dev == host, pred
            # one launch a read, over every file the partition filter keeps
            files = len(torch_scan_files(snap, [pred]).files)
            assert launches == [files] * 3, (pred, launches)
    finally:
        column_cache.residual_masks = real


def test_residual_string_partition_column_stays_on_the_host(tmp_path):
    """``test_column_cache.py:462``: a string partition column in the
    residual does not lower (both packages), so the scan takes the host
    path and counts a fallback."""
    with pytest.raises(device_eval.NotDeviceCompilable):
        device_eval.compile_residual(parse_predicate("pc = 'x' OR v > 1"),
                                     {"pc": StringType(), "v": IntegerType()}, ("pc",))
    paths = paths_of(tmp_path)
    write_both(paths, {"v": [1, 2, 3], "pc": ["x", "y", "x"]}, partition_columns=["pc"])
    c0 = telemetry.counters("scan.device").get("scan.device.fallback", 0)
    with both_confs(**FORCE):
        got = assert_parity(paths, ["pc = 'x' OR v > 2"])
    assert sorted(r["v"] for r in got) == [1, 3]
    assert telemetry.counters("scan.device").get("scan.device.fallback", 0) > c0


def test_a_failing_kernel_raises_out_of_a_partitioned_scan(tmp_path, monkeypatch):
    paths = paths_of(tmp_path)
    write_both(paths, {"id": [1, 2, 3], "y": [1, 1, 2]}, partition_columns=["y"])

    def boom(*a, **k):
        raise RuntimeError("kernel failed")

    monkeypatch.setattr(column_cache, "residual_masks", boom)
    with torch_conf.set_temporarily(**FORCE):
        with pytest.raises(RuntimeError, match="kernel failed"):
            read("torch", paths["torch"], ["y = 2 OR id > 2"])


# -- tests/test_state_cache.py:232-452 ----------------------------------------------


def _part_table(paths, days=("2021-01-01", "2021-01-02", "2021-01-03"), with_null=False):
    lo = 0
    for i, d in enumerate(days):
        write_both(paths, {"day": [d] * 8, "year": ("int32", [2020 + i] * 8),
                           "a": list(range(lo, lo + 8))}, partition_columns=["day", "year"])
        lo += 8
    if with_null:
        write_both(paths, {"day": ("string", [None] * 4), "year": ("int32", [None] * 4),
                           "a": list(range(lo, lo + 4))}, partition_columns=["day", "year"])


def _oracle(path, q):
    """``delta_tpu``'s exact pruner with every resident path off."""
    snap = delta_tpu.DeltaLog.for_table(path).update()
    with jax_conf.set_temporarily(**{"delta.tpu.stateCache.serveScans": False,
                                     "delta.tpu.stateCache.enabled": False}):
        return sorted(f.path for f in jax_scan_files(snap, q).files)


def _port_plans(path, queries):
    """The port's resident plans (device and host legs) of each query, as
    sorted paths; None where the query does not lower to one range box."""
    snap = delta_tpu_torch.DeltaLog.for_table(path, device="cpu").update()
    entry = TorchStateCache.instance().get(snap)
    pcols = frozenset(c.lower() for c in snap.metadata.partition_columns)
    out = []
    for q in queries:
        rw = pruning.conjunct_rewrites([parse_expression(x) for x in q], pcols,
                                       pruning.schema_types(snap.metadata))
        terms = state_cache.extract_range_union(
            ir.and_all([r.rewritten for r in rw]), entry.columns, entry.part_info,
            str_lanes=entry.str_lanes)
        if not terms:
            out.append(None)
            continue
        legs = [entry.plan_ranges(terms, k=entry.num_rows, use_device=d) for d in (True, False)]
        got = [sorted({entry.paths[r] for p in leg for r in p.rows}) for leg in legs]
        assert got[0] == got[1], q
        out.append(got[0])
    return entry, out


def test_partitioned_table_builds_entry(tmp_path):
    paths = paths_of(tmp_path)
    for p, lo in (("b", 0), ("a", 100), ("c", 200)):
        write_both(paths, {"p": [p] * 10, "a": ("int32", list(range(lo, lo + 10)))},
                   partition_columns=["p"])
    for path in paths.values():
        entry = TorchStateCache.instance().get(
            delta_tpu_torch.DeltaLog.for_table(path, device="cpu").update())
        jentry = JaxStateCache.instance().get(delta_tpu.DeltaLog.for_table(path).update())
        assert entry.part_info["p"].values == jentry.part_info["p"].values == ["a", "b", "c"]
        assert entry.part_info["p"].sorted and entry.part_info["p"].parsed is None
        assert "a" in entry.columns
    assert_parity(paths)


QUERIES = [["day = '2021-01-02'"], ["year = 2021"], ["year >= 2021"],
           ["year > 2020 AND year <= 2022"], ["day >= '2021-01-02'"], ["day < '2021-01-02'"],
           ["day = '2021-01-02' AND a >= 10"], ["year = 1999"], ["day = 'zzz'"],
           ["a >= 12 AND a <= 20"], ["year >= 1900"]]


def test_partitioned_plan_parity_with_host_pruner(tmp_path):
    """``test_state_cache.py:274`` and ``:305``: the resident plan over the
    partition lanes (NULL partitions pruned by every bounded predicate)
    equals the exact pruner of both packages, on both tables."""
    paths = paths_of(tmp_path)
    _part_table(paths, with_null=True)
    for path in paths.values():
        _entry, plans = _port_plans(path, QUERIES)
        snap = delta_tpu_torch.DeltaLog.for_table(path, device="cpu").update()
        jsnap = delta_tpu.DeltaLog.for_table(path).update()
        for mode in ("off", "force"):
            with jax_conf.set_temporarily(**{"delta.tpu.stateCache.devicePlan.mode": mode}):
                jplans = jax_plan_scans(jsnap, QUERIES, k=64)
            for q, got, jp in zip(QUERIES, plans, jplans):
                want = _oracle(path, q)
                assert got == want and sorted(jp.paths) == want, (q, mode)
        for q in QUERIES:
            port = sorted(f.path for f in torch_scan_files(snap, q).files)
            assert port == _oracle(path, q), q
        null_files = {f.path for f in snap.all_files
                      if (f.partition_values or {}).get("year") is None}
        assert null_files and not null_files & set(plans[-1])


def test_all_null_partition_column_builds_and_advances(tmp_path):
    """``test_state_cache.py:321``."""
    paths = paths_of(tmp_path)
    write_both(paths, {"p": ("string", [None] * 8), "a": list(range(8))},
               partition_columns=["p"])
    for path in paths.values():
        log = delta_tpu_torch.DeltaLog.for_table(path, device="cpu")
        entry = TorchStateCache.instance().get(log.update())
        assert entry is not None and entry.part_info["p"].values == []
    write_both(paths, {"p": ("string", [None] * 4), "a": list(range(100, 104))})
    for path in paths.values():
        log = delta_tpu_torch.DeltaLog.for_table(path, device="cpu")
        snap = log.update()
        entry = TorchStateCache.instance().get(snap)
        assert entry.part_info["p"].values == []
        _e, plans = _port_plans(path, [["a >= 0"], ["p = 'x'"]])
        assert len(plans[0]) == 2 and plans[1] == []
    assert_parity(paths)


def test_partitioned_tail_advance_extends_dictionary(tmp_path):
    """``test_state_cache.py:347``: an in-order new day keeps the lane
    sorted (ranges lower); an out-of-order one clears it (equality still
    lowers, a range does not); the entry advances in place throughout."""
    paths = paths_of(tmp_path)
    _part_table(paths)
    entries = {path: TorchStateCache.instance().get(
        delta_tpu_torch.DeltaLog.for_table(path, device="cpu").update())
        for path in paths.values()}
    for day, year, lo, is_sorted in (("2021-01-04", 2023, 100, True),
                                     ("2020-12-31", 2019, 200, False)):
        write_both(paths, {"day": [day] * 4, "year": ("int32", [year] * 4),
                           "a": list(range(lo, lo + 4))})
        for path in paths.values():
            entry, plans = _port_plans(path, [[f"day = '{day}'"], ["day >= '2021-01-03'"]])
            assert entry is entries[path]
            assert entry.part_info["day"].sorted == is_sorted
            assert entry.part_info["day"].values[-1] == day
            assert plans[0] == _oracle(path, [f"day = '{day}'"])
            if is_sorted:
                assert plans[1] == _oracle(path, ["day >= '2021-01-03'"])
            else:
                assert plans[1] is None
    assert_parity(paths)


def test_partition_in_list_plans_exactly(tmp_path):
    """``test_state_cache.py:423``."""
    paths = paths_of(tmp_path)
    _part_table(paths, days=("d1", "d2", "d3", "d4"))
    queries = [["day IN ('d1', 'd3')"], ["day IN ('d2', 'd3', 'd4')"], ["day IN ('zz')"]]
    for path in paths.values():
        snap = delta_tpu_torch.DeltaLog.for_table(path, device="cpu").update()
        for q in queries:
            assert sorted(f.path for f in torch_scan_files(snap, q).files) == _oracle(path, q)
    assert_parity(paths, ["day IN ('d1', 'd3')"])


# -- tests/test_vacuum_scenarios.py:127 ----------------------------------------------


class _Clock:
    def __init__(self):
        import time

        self.now = int(time.time() * 1000)

    def __call__(self):
        return self.now


def test_empty_partition_dirs_removed(tmp_path):
    paths = paths_of(tmp_path)
    clocks = {}
    for name in PKGS:
        clocks[name] = _Clock()
        log = (delta_tpu.DeltaLog.for_table(paths[name], clock=clocks[name]) if name == "jax"
               else delta_tpu_torch.DeltaLog.for_table(paths[name], device="cpu"))
        if name == "torch":
            log.clock = clocks[name]
    write_both(paths, {"part": ["a", "a", "b"], "x": [1, 2, 3]}, partition_columns=["part"])
    out = _run(paths, _delete("part = 'a'"))
    assert out["torch"] == out["jax"]
    res = {}
    for name in PKGS:
        clocks[name].now += 2 * WEEK
        log = Pkg(name).log(paths[name])
        res[name] = (JaxVacuum if name == "jax" else TorchVacuum)(log).run()
    assert res["torch"].files_deleted == res["jax"].files_deleted == 1
    assert res["torch"].dirs_deleted == res["jax"].dirs_deleted >= 1
    for path in paths.values():
        assert not os.path.exists(os.path.join(path, "part=a"))
        assert os.path.exists(os.path.join(path, "part=b"))
    assert_parity(paths)


# -- tests/test_txn.py:156, 167 ------------------------------------------------------


def _txn_table(paths):
    write_both(paths, {"x": [1], "part": ["x"]}, partition_columns=["part"])


def _commit_in(name, path, read_part, write_part):
    """A transaction that reads ``part = read_part`` and appends one row to
    ``write_part``, through the package's own writer."""
    log = Pkg(name).log(path)
    txn = log.start_transaction()
    txn.filter_files([f"part = '{read_part}'"])
    wx = delta_tpu.exec.write.write_files if name == "jax" else write_exec.write_files
    data = Pkg(name).table({"x": [9], "part": [write_part]})
    if name == "torch":
        data = coerce_to_table(data)
    adds = wx(log.data_path, data, txn.metadata,
              **({"device": "cpu"} if name == "torch" else {}))
    ops = jax_ops if name == "jax" else torch_ops
    return txn, adds, ops


@pytest.mark.parametrize("other", ["y", "x"])
def test_partitions_and_conflicts(tmp_path, other):
    """A blind append to another partition does not conflict with a
    transaction that read ``part = 'x'``; one to the same partition raises
    ``ConcurrentAppendException``, in both packages."""
    import delta_tpu.exec.write  # noqa: F401  (the JAX writer, by module path)

    paths = paths_of(tmp_path)
    _txn_table(paths)
    out = {}
    for name in PKGS:
        a, a_adds, ops = _commit_in(name, paths[name], "x", "x")
        b, b_adds, _ = _commit_in(name, paths[name], other, other)
        b.commit(b_adds, ops.Write("Append"))
        out[name] = observe(lambda: a.commit(a_adds, ops.Write("Append")))
    assert out["torch"] == out["jax"] == (2 if other == "y" else "ConcurrentAppendException")
    assert _sorted(read("jax", paths["torch"])) == _sorted(read("torch", paths["jax"]))
    assert layout(paths["torch"]) == layout(paths["jax"])


# -- checkpoints of a partitioned table -----------------------------------------------


def test_checkpoint_of_a_partitioned_table(tmp_path):
    """The port's checkpoint of a table it wrote carries
    ``partitionValues_parsed``, and both packages read it back."""
    paths = paths_of(tmp_path)
    write_both(paths, {"id": [1, 2, 3], "d": ("date", [dt.date(2020, 1, i) for i in (1, 1, 2)]),
                       "n": [7, None, 7]}, partition_columns=["d", "n"])
    delta_tpu_torch.DeltaLog.for_table(paths["torch"], device="cpu").checkpoint()
    delta_tpu.DeltaLog.for_table(paths["jax"]).checkpoint()
    clear_logs()
    for path in paths.values():
        ckpt = [n for n in os.listdir(os.path.join(path, "_delta_log"))
                if n.endswith(".checkpoint.parquet")]
        names = pq.ParquetFile(os.path.join(path, "_delta_log", ckpt[0])).schema_arrow
        add_type = names.field("add").type
        assert "partitionValues_parsed" in [add_type.field(i).name
                                            for i in range(add_type.num_fields)]
    assert_parity(paths)
    assert_parity(paths, ["d = '2020-01-02' OR n IS NULL"])

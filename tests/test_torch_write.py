"""The port's writer (``delta_tpu_torch.commands.write.WriteIntoDelta`` over
``exec/write``) against ``delta_tpu``'s on the CPU: the same data, made
from a numpy seed, written through each package into a table of its own,
in append, overwrite, error and ignore modes, split at
``delta.tpu.write.targetFileRows``. Each case gives the same versions, the
same number of files, each file's stats equal (file names differ), the
same ``commitInfo`` (timestamps and ids aside), and the same rows, read
back by each package from both tables. Exact throughout."""
import json
import os

import numpy as np
import pyarrow as pa
import pytest

import delta_tpu
import delta_tpu_torch
from delta_tpu.commands.write import WriteIntoDelta as JaxWrite
from delta_tpu.exec.scan import scan_to_table as jax_scan
from delta_tpu.utils.config import conf as jax_conf
from delta_tpu_torch.commands.write import WriteIntoDelta
from delta_tpu_torch.exec.scan import scan_to_table
from delta_tpu_torch.utils.config import conf


def data(seed, n):
    """One batch: int64 with NULLs, float64 with NaN, int32, bool, string
    with NULLs, as numpy (masked arrays for NULLs) and as Arrow."""
    rng = np.random.RandomState(seed)
    ids = rng.permutation(n * 3)[:n].astype(np.int64)
    null_v = rng.rand(n) < 0.1
    v = rng.rand(n) * 100
    v[rng.rand(n) < 0.02] = np.nan
    q = rng.randint(-1000, 1000, n).astype(np.int32)
    flag = rng.rand(n) > 0.5
    words = np.array([f"w{i}" for i in rng.randint(0, 50, n)], object)
    null_s = rng.rand(n) < 0.05
    np_cols = {"id": ids, "v": np.ma.masked_array(v, null_v), "q": q, "flag": flag,
               "s": np.ma.masked_array(words, null_s)}
    pa_cols = {"id": pa.array(ids), "v": pa.array(v, mask=null_v), "q": pa.array(q),
               "flag": pa.array(flag), "s": pa.array(words.tolist(), mask=null_s)}
    return np_cols, pa.table(pa_cols)


def both_write(tmp_path, steps, file_rows=None):
    """Run ``steps`` [(mode, seed, n, configuration)] through both writers;
    returns the two paths and each step's outcome per package."""
    a, b = str(tmp_path / "torch"), str(tmp_path / "jax")
    got, want = [], []
    settings = {} if file_rows is None else {"delta.tpu.write.targetFileRows": file_rows}
    with conf.set_temporarily(**settings), jax_conf.set_temporarily(**settings):
        for mode, seed, n, cfg in steps:
            np_cols, pa_tab = data(seed, n)
            for out, run in ((got, lambda: WriteIntoDelta(
                    delta_tpu_torch.DeltaLog.for_table(a, device="cpu"), mode, np_cols,
                    configuration=cfg).run()),
                    (want, lambda: JaxWrite(delta_tpu.DeltaLog.for_table(b), mode, pa_tab,
                                            configuration=cfg).run())):
                try:
                    out.append(run())
                except Exception as e:  # the class is the observation
                    out.append(type(e).__name__)
    return a, b, got, want


def commits(path):
    """Each commit's actions: commitInfo without its volatile fields, the
    metadata without its id, each add and remove without path, size and
    times (the files differ in name and encoding)."""
    out = []
    log_dir = os.path.join(path, "_delta_log")
    for name in sorted(n for n in os.listdir(log_dir) if n.endswith(".json")):
        rows = []
        for line in open(os.path.join(log_dir, name)):
            obj = json.loads(line)
            ci = obj.get("commitInfo")
            if ci:
                for k in ("timestamp", "txnId", "engineInfo"):
                    ci.pop(k, None)
                ci.get("operationMetrics", {}).pop("numOutputBytes", None)
            obj.get("metaData", {}).pop("id", None)
            for kind in ("add", "remove"):
                for k in ("path", "size", "modificationTime", "deletionTimestamp"):
                    obj.get(kind, {}).pop(k, None)
                if kind in obj and "stats" in obj[kind]:
                    obj[kind]["stats"] = json.loads(obj[kind]["stats"])
            rows.append(obj)
        out.append(rows)
    return out


def rows_torch(path):
    t = scan_to_table(delta_tpu_torch.DeltaLog.for_table(path, device="cpu").update())
    return sorted((tuple(r.items()) for r in t.to_pylist()), key=repr)


def rows_jax(path):
    t = jax_scan(delta_tpu.DeltaLog.for_table(path).update())
    return sorted((tuple(r.items()) for r in t.to_pylist()), key=repr)


def same_rows(x, y):
    """Rows equal, NaN equal to NaN."""
    def norm(rows):
        return [tuple((k, "nan" if isinstance(v, float) and v != v else v) for k, v in r)
                for r in rows]
    return norm(x) == norm(y)


@pytest.fixture(autouse=True)
def _fresh_logs():
    delta_tpu_torch.DeltaLog.clear_cache()
    yield
    delta_tpu_torch.DeltaLog.clear_cache()


CASES = {
    "append": [("append", 1, 500, None), ("append", 2, 300, None)],
    "overwrite": [("append", 1, 500, None), ("overwrite", 3, 200, None)],
    "create_with_properties": [("append", 4, 100,
                                {"delta.tpu.enableDeletionVectors": "true",
                                 "delta.dataSkippingNumIndexedCols": "2"})],
    "error_and_ignore": [("error", 5, 50, None), ("error", 6, 50, None),
                         ("ignore", 7, 50, None), ("errorifexists", 8, 50, None)],
    "empty": [("append", 9, 0, None), ("append", 10, 20, None)],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_write_matches_jax(case, tmp_path):
    a, b, got, want = both_write(tmp_path, CASES[case])
    assert got == want
    assert commits(a) == commits(b)
    # cross-read: each package reads both tables, all four equal
    mine = rows_torch(a)
    assert same_rows(mine, rows_torch(b))
    assert same_rows(mine, rows_jax(a))
    assert same_rows(mine, rows_jax(b))


@pytest.mark.parametrize("file_rows", [100, 128, 1000])
def test_target_file_rows_split(tmp_path, file_rows):
    a, b, got, want = both_write(tmp_path, [("append", 11, 1000, None)], file_rows=file_rows)
    assert got == want == [0]
    ca, cb = commits(a), commits(b)
    assert ca == cb
    n_files = sum("add" in r for r in ca[0])
    assert n_files == -(-1000 // file_rows)
    assert same_rows(rows_torch(a), rows_jax(b))


def test_write_refuses_what_is_not_ported(tmp_path):
    """``merge_schema`` and ``overwrite_schema`` run on the first write as a
    plain create (tests/test_torch_schema_evolution.py and
    test_torch_constraints.py hold them against ``delta_tpu``; the port
    refused them before, the name is kept); ``partition_columns`` and
    ``replace_where`` run as in ``delta_tpu`` (a replaceWhere on a data
    column is refused by both)."""
    for i, kw in enumerate(({"merge_schema": True}, {"overwrite_schema": True})):
        log = delta_tpu_torch.DeltaLog.for_table(str(tmp_path / f"t{i}"), device="cpu")
        WriteIntoDelta(log, "overwrite", {"id": np.arange(3)}, **kw).run()
        assert sorted(r["id"] for r in scan_to_table(log.update()).to_pylist()) == [0, 1, 2]
    a, b = str(tmp_path / "torch"), str(tmp_path / "jax")
    steps = [("append", {"id": [1, 2, 3], "c": ["x", "y", "y"]}, {"partition_columns": ["c"]}),
             ("overwrite", {"id": [7], "c": ["y"]}, {"replace_where": "id > 1"}),
             ("overwrite", {"id": [7], "c": ["y"]}, {"replace_where": "c = 'y'"})]
    for mode, cols, kw in steps:
        outs = []
        for run in (lambda: WriteIntoDelta(delta_tpu_torch.DeltaLog.for_table(a, device="cpu"),
                                           mode, cols, **kw).run(),
                    lambda: JaxWrite(delta_tpu.DeltaLog.for_table(b), mode, pa.table(cols),
                                     **kw).run()):
            try:
                outs.append(run())
            except Exception as e:  # the class is the observation
                outs.append(type(e).__name__)
        assert outs[0] == outs[1]
    assert commits(a) == commits(b)
    assert rows_torch(a) == rows_jax(a) == rows_jax(b) == [(("id", 1), ("c", "x")),
                                                           (("id", 7), ("c", "y"))]


def test_append_of_a_mismatched_schema_fails_as_jax(tmp_path):
    a, b, got, want = both_write(tmp_path, [("append", 12, 10, None)])
    np_cols, pa_tab = data(13, 10)
    np_cols["extra"] = np.arange(10)
    pa_tab = pa_tab.append_column("extra", pa.array(np.arange(10)))
    errs = []
    for run in (lambda: WriteIntoDelta(delta_tpu_torch.DeltaLog.for_table(a, device="cpu"),
                                       "append", np_cols).run(),
                lambda: JaxWrite(delta_tpu.DeltaLog.for_table(b), "append", pa_tab).run()):
        with pytest.raises(Exception) as ei:
            run()
        errs.append(type(ei.value).__name__)
    assert errs[0] == errs[1] == "SchemaMismatchError"

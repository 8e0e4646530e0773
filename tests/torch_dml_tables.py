"""Helpers of the DML, RESTORE, VACUUM and time-travel parity tests
(tests/test_torch_dml.py, test_torch_restore_vacuum.py,
test_torch_time_travel.py).

``delta_tpu`` writes one table; each package then runs the case on its own
copy (``shutil.copytree`` keeps the files' names and modification times),
and :func:`assert_same_end_state` holds the two copies to equal rows (each
package reading both copies), equal add/remove counts in their last
commits and equal deletion-vector cardinalities.
"""
import json
import os
import shutil

import pyarrow as pa

import delta_tpu
import delta_tpu_torch
from delta_tpu.api.tables import DeltaTable as JaxTable
from delta_tpu.protocol import filenames
from delta_tpu_torch.api.tables import DeltaTable as TorchTable
from tests.torch_port_tables import sorted_rows

PKGS = ("jax", "torch")
DV_PROPS = {"delta.tpu.enableDeletionVectors": "true"}


def create(path, data, configuration=None, partition_columns=()):
    """The source table, written by ``delta_tpu`` (a CTAS at version 0)."""
    if isinstance(data, dict):
        data = pa.table(data)
    JaxTable.create(path, data=data, configuration=configuration,
                    partition_columns=partition_columns)
    return path


def append(path, data):
    from delta_tpu.commands.write import WriteIntoDelta

    if isinstance(data, dict):
        data = pa.table(data)
    WriteIntoDelta(delta_tpu.DeltaLog.for_table(path), "append", data).run()


def copies(src, root):
    """One copy of ``src`` a package: {"jax": path, "torch": path}."""
    out = {}
    for name in PKGS:
        out[name] = os.path.join(str(root), name)
        shutil.copytree(src, out[name])
    return out


def table(name, path):
    """The package's ``DeltaTable`` handle (the port's on the CPU)."""
    if name == "jax":
        return JaxTable.for_path(path)
    return TorchTable.for_path(path, device="cpu")


def log(name, path):
    if name == "jax":
        return delta_tpu.DeltaLog.for_table(path)
    return delta_tpu_torch.DeltaLog.for_table(path, device="cpu")


def rows(name, path, **kw):
    """Sorted Python rows of the table read by package ``name`` (``kw``:
    ``version=`` / ``timestamp=`` / ``filters=``)."""
    t = table(name, path)
    got = t.to_arrow(**kw) if name == "jax" else t.to_table(**kw)
    return sorted_rows(got.to_pylist())


def observe(fn):
    """The call's value, or its exception's class name."""
    try:
        return fn()
    except Exception as e:  # the class is the observation
        return type(e).__name__


def last_commit_counts(path):
    """(adds, removes) of the table's latest commit file."""
    jlog = delta_tpu.DeltaLog.for_table(path)
    v = jlog.update().version
    with open(f"{jlog.log_path}/{filenames.delta_file(v)}") as f:
        kinds = [next(iter(json.loads(line))) for line in f if line.strip()]
    return kinds.count("add"), kinds.count("remove")


def dv_cardinalities(name, path):
    """{file path: deletion-vector cardinality} of the live files that
    carry one, as the package's own snapshot reads them."""
    snap = log(name, path).update()
    return {f.path: f.deletion_vector["cardinality"] for f in snap.all_files
            if f.deletion_vector is not None}


def metrics(m):
    """Operation metrics without the wall times."""
    return {k: v for k, v in m.items() if not k.endswith("TimeMs")}


def assert_same_end_state(paths):
    """Both copies' end states agree: rows (each package reads both copies),
    the last commit's add/remove counts and the deletion-vector
    cardinalities."""
    want = rows("jax", paths["jax"])
    assert rows("jax", paths["torch"]) == want
    assert rows("torch", paths["torch"]) == want
    assert rows("torch", paths["jax"]) == want
    assert last_commit_counts(paths["torch"]) == last_commit_counts(paths["jax"])
    # a file both copies hold is one the source had (new files take fresh
    # names): its vector must agree; every vector's cardinality must too
    jc, tc = dv_cardinalities("jax", paths["jax"]), dv_cardinalities("torch", paths["torch"])
    assert sorted(tc.values()) == sorted(jc.values())
    assert {p: tc[p] for p in tc if p in jc} == {p: jc[p] for p in jc if p in tc}
    return want

"""The port's SHALLOW CLONE against ``delta_tpu``'s on the CPU: the 13
cases of ``tests/test_clone.py``, each run by both packages in directories
of their own (``tests/torch_api_tables.both``): the clone's and the
source's rows (each package reading both), versions, files (their
partition values, stats, deletion-vector cardinalities and whether the
path is absolute), metadata, protocol and commits, the files on disk, and
every error's class and message must be exactly equal.

Also here: the clone's files are absolute paths into the source, a clone's
VACUUM deletes nothing of the source's, a DELETE on the clone leaves the
source's rows and files as they were, and a deletion vector read on the
clone opens the source's sidecar file.
"""
import os
import time
from types import SimpleNamespace

import pytest

from tests.torch_api_tables import both, observe, state


def make(p, root, name="src", **kw):
    return p.create(os.path.join(root, name),
                    data=p.table({"id": ("int64", [1, 2, 3]), "v": ["a", "b", "c"]}), **kw)


def parquet_in(path):
    return sorted(f for f in os.listdir(path) if f.endswith(".parquet"))


def _clone_reads_source_data_without_copying(p, root):
    src = make(p, root)
    clone = src.clone(os.path.join(root, "c"))
    return (p.read(clone), parquet_in(os.path.join(root, "c")),
            clone.history()[0]["operation"], state(os.path.join(root, "c")))


def _clone_gets_fresh_table_id(p, root):
    src = make(p, root)
    clone = src.clone(os.path.join(root, "c"))
    return clone.delta_log.update().metadata.id != src.delta_log.update().metadata.id


def _writes_to_clone_do_not_touch_source(p, root):
    src = make(p, root)
    before = sorted(os.listdir(os.path.join(root, "src")))
    clone = src.clone(os.path.join(root, "c"))
    p.write(os.path.join(root, "c"), {"id": ("int64", [99]), "v": ["z"]})
    clone.delete("id = 1")
    return (p.read(clone), p.read(src), len(parquet_in(os.path.join(root, "c"))),
            sorted(os.listdir(os.path.join(root, "src"))) == before,
            state(os.path.join(root, "c")), state(os.path.join(root, "src")))


def _writes_to_source_do_not_affect_clone(p, root):
    src = make(p, root)
    clone = src.clone(os.path.join(root, "c"))
    p.write(os.path.join(root, "src"), {"id": ("int64", [50]), "v": ["s"]})
    return p.read(clone), state(os.path.join(root, "c"))


def _clone_at_version(p, root):
    src = make(p, root)
    p.write(os.path.join(root, "src"), {"id": ("int64", [4]), "v": ["d"]})
    clone = src.clone(os.path.join(root, "c"), version=0)
    latest = src.clone(os.path.join(root, "c2"))
    v0_ms = int(os.path.getmtime(os.path.join(root, "src", "_delta_log", "%020d.json" % 0))
                * 1000)
    at_ts = src.clone(os.path.join(root, "c3"), timestamp=v0_ms)
    return (p.read(clone), p.read(latest), p.read(at_ts), state(os.path.join(root, "c")),
            state(os.path.join(root, "c2")), state(os.path.join(root, "c3")))


def _clone_into_existing_table_rejected(p, root):
    src = make(p, root)
    make(p, root, name="other")
    return src.clone(os.path.join(root, "other"))


def _clone_version_and_timestamp_rejected(p, root):
    src = make(p, root)
    return src.clone(os.path.join(root, "c"), version=0, timestamp="2024-01-01")


def _clone_carries_dv_state(p, root):
    src = make(p, root, configuration={"delta.tpu.enableDeletionVectors": "true"})
    src.delete("id = 2")
    clone = src.clone(os.path.join(root, "c"))
    pr = clone.delta_log.update().protocol
    return (p.read(clone), (pr.min_reader_version, pr.min_writer_version),
            state(os.path.join(root, "c")))


def _clone_carries_schema_and_properties(p, root):
    src = p.create(os.path.join(root, "src"),
                   data=p.table({"part": ["x", "y"], "n": ("int64", [1, 2])}),
                   partition_columns=["part"],
                   configuration={"delta.appendOnly": "false", "custom.tag": "hello"})
    clone = src.clone(os.path.join(root, "c"))
    meta = clone.delta_log.update().metadata
    return (meta.partition_columns, meta.configuration.get("custom.tag"),
            p.read(clone, filters=["part = 'x'"]), state(os.path.join(root, "c")))


def _clone_vacuum_does_not_touch_source_files(p, root):
    src = make(p, root)
    clone_path = os.path.join(root, "c")
    now = [int(time.time() * 1000)]
    src.clone(clone_path)
    before = sorted(os.listdir(os.path.join(root, "src")))
    if p.jax:
        import delta_tpu

        delta_tpu.DeltaLog.clear_cache()
        delta_tpu.DeltaLog.for_table(clone_path, clock=lambda: now[0])
    clone = p.for_path(clone_path)
    if not p.jax:
        clone.delta_log.clock = lambda: now[0]
    now[0] += 14 * 24 * 3_600_000
    r = clone.vacuum()
    return (r.files_deleted, p.read(src), p.read(clone),
            sorted(os.listdir(os.path.join(root, "src"))) == before)


def _clone_carries_source_protocol_beyond_config(p, root):
    src = make(p, root, configuration={"delta.tpu.enableDeletionVectors": "true"})
    src.delete("id = 2")
    p.alter.unset_table_properties(src.delta_log, ["delta.tpu.enableDeletionVectors"])
    sp = src.delta_log.update().protocol
    clone = src.clone(os.path.join(root, "c"))
    cp = clone.delta_log.update().protocol
    return ((sp.min_reader_version, sp.min_writer_version),
            (cp.min_reader_version, cp.min_writer_version), cp.reader_features,
            p.read(clone), state(os.path.join(root, "c")))


def _clone_into_existing_rejected_by_outer_check(p, root):
    src = make(p, root)
    make(p, root, name="raced")
    return p.clone_mod.CloneCommand(src.delta_log, os.path.join(root, "raced")).run()


def _clone_race_window_rejected_in_txn(p, root):
    src = make(p, root)
    target = os.path.join(root, "raced")
    make(p, root, name="raced")  # the racing creator already committed
    target_log = p.log(target)
    real_update = target_log.update
    lied = []

    def update_lying_once(*a, **kw):
        if not lied:
            lied.append(1)
            return SimpleNamespace(version=-1)  # the pre-check sees no table
        return real_update(*a, **kw)

    target_log.update = update_lying_once
    try:
        err = observe(lambda: p.clone_mod.CloneCommand(src.delta_log, target).run())
    finally:
        del target_log.update
    return err, p.log(target).update().version


CASES = [
    _clone_reads_source_data_without_copying, _clone_gets_fresh_table_id,
    _writes_to_clone_do_not_touch_source, _writes_to_source_do_not_affect_clone,
    _clone_at_version, _clone_into_existing_table_rejected,
    _clone_version_and_timestamp_rejected, _clone_carries_dv_state,
    _clone_carries_schema_and_properties, _clone_vacuum_does_not_touch_source_files,
    _clone_carries_source_protocol_beyond_config, _clone_into_existing_rejected_by_outer_check,
    _clone_race_window_rejected_in_txn,
]

RAISES = {
    "_clone_into_existing_table_rejected": "DeltaAnalysisError",
    "_clone_version_and_timestamp_rejected": "DeltaAnalysisError",
    "_clone_into_existing_rejected_by_outer_check": "DeltaAnalysisError",
}


@pytest.mark.parametrize("case", CASES, ids=[c.__name__.lstrip("_") for c in CASES])
def test_clone_matches_jax(tmp_path, case):
    got = both(tmp_path, case)
    want = RAISES.get(case.__name__)
    if want is None:
        assert not (isinstance(got, tuple) and got[:1] == ("raises",)), got
    else:
        assert got[:2] == ("raises", want), got


def test_clone_paths_are_absolute_and_dv_reads_the_source_sidecar(tmp_path, monkeypatch):
    """The port's clone: every file an absolute path into the source, a
    deletion vector's sidecar the source's file; a DELETE, an append and an
    overwrite on the clone, then its VACUUM, leave the source's files and
    rows as they were."""
    from delta_tpu_torch.protocol import deletion_vectors
    from tests.torch_api_tables import P, fresh

    fresh()
    monkeypatch.setattr(deletion_vectors, "INLINE_THRESHOLD_BYTES", 0)  # sidecar files
    p = P("torch")
    root = str(tmp_path)
    src = p.create(os.path.join(root, "src"),
                   data=p.table({"id": ("int64", list(range(200))),
                                 "v": [str(i) for i in range(200)]}),
                   configuration={"delta.tpu.enableDeletionVectors": "true"})
    src.delete("id % 3 = 0")
    src_files = sorted(os.listdir(os.path.join(root, "src")))
    assert any(f.startswith("deletion_vector_") for f in src_files)
    clone = src.clone(os.path.join(root, "c"))
    snap = clone.delta_log.update()
    src_root = os.path.abspath(os.path.join(root, "src"))
    assert all(os.path.isabs(f.path) and f.path.startswith(src_root) for f in snap.all_files)
    dvs = [f.deletion_vector for f in snap.all_files if f.deletion_vector]
    assert dvs and all(d["storageType"] == "u" and d["pathOrInlineDv"].startswith(src_root)
                       for d in dvs)
    want = [i for i in range(200) if i % 3]
    assert sorted(r["id"] for r in clone.to_table(columns=["id"]).to_pylist()) == want
    clone.delete("id < 50")
    clone.write(p.table({"id": ("int64", [1000]), "v": ["x"]}))
    clone.write(p.table({"id": ("int64", [2000]), "v": ["y"]}), mode="overwrite")
    clone.delta_log.clock = lambda: int(time.time() * 1000) + 30 * 24 * 3_600_000
    assert clone.vacuum().files_deleted >= 2  # the clone's own file and sidecar
    assert sorted(os.listdir(os.path.join(root, "src"))) == src_files
    assert sorted(r["id"] for r in src.to_table(columns=["id"]).to_pylist()) == want
    assert [r["id"] for r in clone.to_table(columns=["id"]).to_pylist()] == [2000]
    fresh()

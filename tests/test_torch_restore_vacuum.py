"""The port's RESTORE and VACUUM against ``delta_tpu``'s on the CPU.

The cases replay ``tests/test_restore.py`` (not its SQL statements: the SQL
front end is not ported), ``tests/test_vacuum_scenarios.py``, the vacuum
case of ``tests/test_deletion_vectors.py`` and the RESTORE case of
``tests/test_history_metrics.py``'s shape. ``delta_tpu`` writes each table
and each package runs the case on its own copy: rows (each package reads
both copies), metrics without wall times, the add/remove counts, the
deletion-vector cardinalities, and for VACUUM its result and the files
left on disk must agree. A deletion-vector sidecar takes a fresh name in
each copy, so sidecar names compare as a count.

Also here: a port MERGE after a port RESTORE, including the one that
revives a deleted key, serves no stale slab; and a port DELETE without a
predicate or RESTORE racing a concurrent append raises
``ConcurrentAppendException`` as the JAX package's does (the whole-table
read set).
"""
import os
import time

import pytest

import delta_tpu
from delta_tpu.protocol import deletion_vectors as jax_dv
from delta_tpu.protocol.actions import AddFile, CommitInfo
from delta_tpu.txn import transaction as jax_txn
from delta_tpu_torch.ops.column_cache import ColumnCache
from delta_tpu_torch.ops.key_cache import KeyCache
from delta_tpu_torch.ops.state_cache import DeviceStateCache
from delta_tpu_torch.protocol import deletion_vectors as torch_dv
from delta_tpu_torch.txn import transaction as torch_txn
from tests.torch_dml_tables import (
    DV_PROPS, PKGS, append, assert_same_end_state, copies, create, log, metrics, observe, rows,
    table,
)
from tests.torch_port_tables import Pkg, both_confs, commit, reset_caches

HOUR = 3_600_000
WEEK = 7 * 24 * HOUR


@pytest.fixture(autouse=True)
def _fresh():
    reset_caches()
    ColumnCache.reset()
    DeviceStateCache.reset()
    yield
    reset_caches()
    ColumnCache.reset()
    DeviceStateCache.reset()


def _make(src, **kw):
    create(src, {"id": [1, 2], "v": ["a", "b"]}, **kw)


def _append(path, ids):
    append(path, {"id": ids, "v": [f"x{i}" for i in ids]})


def _both(tmp_path, build, op):
    src = str(tmp_path / "src")
    build(src)
    paths = copies(src, tmp_path)
    return paths, {name: observe(lambda: op(name, paths[name])) for name in PKGS}


def _jax_append(name, path, ids):
    """An append by ``delta_tpu`` to one package's copy (the same writer
    for both copies, so the two logs stay alike)."""
    _append(path, ids)


# -- RESTORE: tests/test_restore.py ------------------------------------------------


def _restore_undoes_appends(name, p):
    _jax_append(name, p, [10])
    _jax_append(name, p, [20])
    t = table(name, p)
    m = t.restore_to_version(0)
    return m, t.version, t.history()[0]["operation"]


def _restore_undoes_delete(name, p):
    t = table(name, p)
    t.delete("id = 1")
    return t.restore_to_version(0)


def _restore_forward_again(name, p):
    _jax_append(name, p, [10])
    t = table(name, p)
    return t.restore_to_version(0), t.restore_to_version(1)


def _restore_dv_state(name, p):
    t = table(name, p)
    t.delete("id = 1")
    counts = [len(rows(name, p))]
    m0 = t.restore_to_version(0)
    counts.append(len(rows(name, p)))
    m1 = t.restore_to_version(1)
    counts.append(len(rows(name, p)))
    return m0, m1, counts


def _restore_missing_version(name, p):
    return table(name, p).restore_to_version(99)


def _restore_two_selectors(name, p):
    if name == "jax":
        from delta_tpu.commands.restore import RestoreCommand
    else:
        from delta_tpu_torch.commands.restore import RestoreCommand
    return [observe(lambda: RestoreCommand(log(name, p))),
            observe(lambda: RestoreCommand(log(name, p), version=0, timestamp="2024-01-01"))]


def _restore_noop(name, p):
    return table(name, p).restore_to_version(0)


def _restore_malformed_timestamp(name, p):
    t = table(name, p)
    return [observe(lambda: t.restore_to_timestamp("not-a-time")),
            observe(lambda: rows(name, p, timestamp="also/not/a/time")), t.version]


RESTORE_CASES = {
    "undoes_appends": (_make, _restore_undoes_appends),
    "undoes_delete": (_make, _restore_undoes_delete),
    "undoes_dv_delete": (lambda s: _make(s, configuration=DV_PROPS), _restore_undoes_delete),
    "forward_again": (_make, _restore_forward_again),
    "dv_state": (lambda s: _make(s, configuration=DV_PROPS), _restore_dv_state),
    "missing_version_rejected": (_make, _restore_missing_version),
    "requires_exactly_one_selector": (_make, _restore_two_selectors),
    "noop_when_already_there": (_make, _restore_noop),
    "malformed_timestamp_clean_error": (_make, _restore_malformed_timestamp),
}


def _strip_times(v):
    if isinstance(v, dict):
        return metrics(v)
    if isinstance(v, (list, tuple)):
        return type(v)(_strip_times(x) for x in v)
    return v


@pytest.mark.parametrize("case", sorted(RESTORE_CASES))
def test_restore_matches_jax(tmp_path, case):
    build, op = RESTORE_CASES[case]
    paths, out = _both(tmp_path, build, op)
    assert _strip_times(out["torch"]) == _strip_times(out["jax"])
    assert_same_end_state(paths)


def test_restore_restores_schema(tmp_path):
    from delta_tpu.commands.alter import add_columns
    from delta_tpu.schema.types import LongType, StructField

    def build(src):
        _make(src)
        add_columns(delta_tpu.DeltaLog.for_table(src), [StructField("extra", LongType())])

    paths, out = _both(tmp_path, build, lambda name, p: (
        "extra" in table(name, p).schema().field_names, table(name, p).restore_to_version(0),
        table(name, p).schema().field_names))
    assert _strip_times(out["torch"]) == _strip_times(out["jax"])
    assert out["torch"][0] and "extra" not in out["torch"][2]
    assert_same_end_state(paths)


def test_restore_by_timestamp(tmp_path):
    from delta_tpu.protocol import filenames

    base = 1_700_000_000_000

    def build(src):
        _make(src)
        _append(src, [10])
        for v in (0, 1):
            p = f"{src}/_delta_log/{filenames.delta_file(v)}"
            os.utime(p, ((base + v * HOUR) / 1000,) * 2)

    paths, out = _both(tmp_path, build,
                       lambda name, p: table(name, p).restore_to_timestamp(base + HOUR // 2))
    assert _strip_times(out["torch"]) == _strip_times(out["jax"])
    got = assert_same_end_state(paths)
    assert sorted(r["id"] for r in got) == [1, 2]
    # the ISO form resolves through the same rule
    import datetime as dt

    iso = dt.datetime.fromtimestamp((base + HOUR + 60_000) / 1000,
                                    dt.timezone.utc).strftime("%Y-%m-%d %H:%M:%S")
    paths2, out2 = _both(tmp_path / "iso", build,
                         lambda name, p: table(name, p).restore_to_timestamp(iso))
    assert _strip_times(out2["torch"]) == _strip_times(out2["jax"])
    assert_same_end_state(paths2)


class ManualClock:
    """Starts at the real now (action timestamps are wall-clock) and only
    advances."""

    def __init__(self):
        self.now = int(time.time() * 1000)

    def __call__(self):
        return self.now

    def advance(self, ms):
        self.now += ms


def _clocked(name, path, clock):
    """The package's table handle whose log reads ``clock``."""
    if name == "jax":
        delta_tpu.DeltaLog.clear_cache()
        delta_tpu.DeltaLog.for_table(path, clock=clock)
    else:
        log(name, path).clock = clock
    return table(name, path)


def test_restore_past_vacuum_fails_cleanly(tmp_path):
    def op(name, p):
        clock = ManualClock()
        t = _clocked(name, p, clock)
        t.delete()  # v1 removes the file
        clock.advance(14 * 24 * HOUR)
        t.vacuum()
        err = observe(lambda: t.restore_to_version(0))
        return err, t.version

    paths, out = _both(tmp_path, _make, op)
    assert out["torch"] == out["jax"] == ("DeltaIllegalStateError", 1)


def test_restore_with_missing_dv_sidecar_fails_cleanly(tmp_path, monkeypatch):
    import glob

    monkeypatch.setattr(jax_dv, "INLINE_THRESHOLD_BYTES", -1)  # force sidecars
    monkeypatch.setattr(torch_dv, "INLINE_THRESHOLD_BYTES", -1)

    def build(src):
        create(src, {"id": list(range(100)), "v": [f"a{i}" for i in range(100)]}, DV_PROPS)

    def op(name, p):
        t = table(name, p)
        t.delete("id < 10")  # v1: a DV sidecar on the file
        dv = [f for f in log(name, p).update().all_files if f.deletion_vector]
        assert dv and dv[0].deletion_vector["storageType"] == "u"
        t.optimize().execute_purge()  # v2: rewrites, drops the DV reference
        for side in glob.glob(os.path.join(p, "deletion_vector*")):
            os.remove(side)  # the sidecar is gone, the data file is not
        try:
            t.restore_to_version(1)
        except Exception as e:  # the class and the message are the observation
            return type(e).__name__, "deletion-vector" in str(e), t.version
        return None

    paths, out = _both(tmp_path, build, op)
    assert out["torch"] == out["jax"] == ("DeltaIllegalStateError", True, 2)


# -- a MERGE after RESTORE: no stale slab, a revived key updates --------------------


def test_merge_after_restore_serves_no_stale_slab(tmp_path):
    """MERGE (the slab built), a DV DELETE of keys 5 and 7, MERGE (the slab
    advanced: 5 and 7 dead), RESTORE to before the DELETE (their DV shrinks
    and they live again), then a MERGE whose source holds 5 and 7: they
    must update, not insert. The slab's advance only kills rows, so only
    the epoch bump keeps the last MERGE exact."""
    src = str(tmp_path / "src")
    create(src, {"id": list(range(100)), "v": [f"v{i}" for i in range(100)]}, DV_PROPS)
    append(src, {"id": list(range(100, 150)), "v": ["w"] * 50})
    paths = copies(src, tmp_path)
    routes = {}
    for name in PKGS:
        P = Pkg(name)
        lg = P.log(paths[name])

        def merge(source):
            with both_confs(**{"delta.tpu.merge.devicePath.mode": "force"}):
                return P.merge(lg, source, "t.id = s.id", [("update",)], [("insert",)],
                               source_alias="s", target_alias="t")

        merge({"id": [1, 500], "v": ["m1", "m500"]})
        before = lg.update().version
        t = table(name, paths[name])
        t.delete("id = 5 OR id = 7")
        merge({"id": [2, 501], "v": ["m2", "m501"]})
        if name == "torch":
            e = (KeyCache.instance().epoch(lg.log_path), ColumnCache.instance().epoch(lg.log_path))
        m = t.restore_to_version(before)
        assert m["numRestoredFiles"] == 1 and m["numRemovedFiles"] == 1
        if name == "torch":
            assert (KeyCache.instance().epoch(lg.log_path),
                    ColumnCache.instance().epoch(lg.log_path)) == (e[0] + 1, e[1] + 1)
        cmd = merge({"id": [5, 7, 502], "v": ["r5", "r7", "m502"]})
        routes[name] = (cmd._join_path, metrics(cmd.metrics))
    assert routes["torch"] == routes["jax"]
    assert routes["torch"][0] == "device-cold"
    assert routes["torch"][1]["numTargetRowsUpdated"] == 2
    got = assert_same_end_state(paths)
    assert [r["v"] for r in got if r["id"] in (5, 7)] == ["r5", "r7"]


# -- the whole-table read set ------------------------------------------------------


def _racing_commit(monkeypatch, module, path):
    """Before the command's commit, a blind append lands at the next
    version of ``path``."""
    orig = module.OptimisticTransaction.commit
    fired = []

    def commit(self, actions, op, *a, **k):
        if not fired:
            fired.append(True)
            commit_file(path, self.read_version + 1)
        return orig(self, actions, op, *a, **k)

    monkeypatch.setattr(module.OptimisticTransaction, "commit", commit)
    return fired


def commit_file(path, version):
    commit(path, version, [CommitInfo(operation="WRITE", is_blind_append=True),
                           AddFile(path="concurrent.parquet", partition_values={}, size=1,
                                   modification_time=0, data_change=True)])


@pytest.mark.parametrize("command", ["delete_all", "restore"])
def test_whole_table_read_set_conflicts_with_a_concurrent_append(tmp_path, monkeypatch,
                                                                  command):
    def build(src):
        _make(src, configuration={"delta.isolationLevel": "Serializable"})
        _append(src, [10])

    src = str(tmp_path / "src")
    build(src)
    paths = copies(src, tmp_path)
    out = {}
    for name, module in (("jax", jax_txn), ("torch", torch_txn)):
        with monkeypatch.context() as mp:
            fired = _racing_commit(mp, module, paths[name])
            t = table(name, paths[name])
            run = t.delete if command == "delete_all" else (lambda: t.restore_to_version(0))
            out[name] = observe(run)
            assert fired
    assert out["torch"] == out["jax"] == "ConcurrentAppendException"
    # RESTORE records no read predicate of its own: without the whole-table
    # read set the port's RESTORE would commit over the append
    if command == "restore":
        again = copies(src, tmp_path / "again")["torch"]
        with monkeypatch.context() as mp:
            _racing_commit(mp, torch_txn, again)
            mp.setattr(torch_txn.OptimisticTransaction, "read_whole_table", lambda self: None)
            assert isinstance(table("torch", again).restore_to_version(0), dict)


# -- VACUUM: tests/test_vacuum_scenarios.py ------------------------------------------


def _norm(paths):
    """Relative paths with deletion-vector sidecar names collapsed."""
    return sorted("deletion_vector_*" if os.path.basename(p).startswith("deletion_vector_")
                  else p for p in paths)


def _on_disk(root):
    out = []
    for d, dirs, files in os.walk(root):
        rel = os.path.relpath(d, root)
        if rel.split(os.sep)[0] == "_delta_log":
            continue
        out.extend(os.path.normpath(os.path.join(rel, f)) for f in files)
    return _norm(out)


def _result(r):
    return (r.files_deleted, r.dirs_deleted, r.dry_run, r.retention_ms,
            _norm(r.deleted_paths))


def _live_never_deleted(name, p, clock):
    clock.advance(52 * WEEK)
    return _result(_clocked(name, p, clock).vacuum())


def _removed_kept_then_deleted(name, p, clock):
    t = _clocked(name, p, clock)
    t.delete()
    clock.advance(2 * HOUR)
    first = _result(t.vacuum())
    clock.advance(2 * WEEK)
    return first, _result(t.vacuum())


def _dry_run(name, p, clock):
    t = _clocked(name, p, clock)
    t.delete()
    clock.advance(2 * WEEK)
    return _result(t.vacuum(dry_run=True))


def _junk(name, p, clock):
    with open(os.path.join(p, "junk.parquet"), "wb") as f:
        f.write(b"zz")
    t = _clocked(name, p, clock)
    first = _result(t.vacuum())
    clock.advance(2 * WEEK)
    return first, _result(t.vacuum())


def _hidden(name, p, clock):
    hidden = os.path.join(p, "_internal", "x.bin")
    os.makedirs(os.path.dirname(hidden))
    with open(hidden, "wb") as f:
        f.write(b"zz")
    os.utime(hidden, (0, 0))
    clock.advance(2 * WEEK)
    return _result(_clocked(name, p, clock).vacuum()), os.path.exists(hidden)


def _empty_partition_dirs(name, p, clock):
    t = _clocked(name, p, clock)
    t.delete("part = 'a'")
    clock.advance(2 * WEEK)
    r = t.vacuum()
    return (_result(r), os.path.exists(os.path.join(p, "part=a")),
            os.path.exists(os.path.join(p, "part=b")))


def _short_retention(name, p, clock):
    t = _clocked(name, p, clock)
    return observe(lambda: t.vacuum(retention_hours=1)), _result(
        t.vacuum(retention_hours=1, retention_check_enabled=False))


def _short_retention_conf(name, p, clock):
    t = _clocked(name, p, clock)
    with both_confs(**{"delta.tpu.retentionDurationCheck.enabled": False}):
        return _result(t.vacuum(retention_hours=0))


def _breaks_time_travel(name, p, clock):
    t = _clocked(name, p, clock)
    v0 = t.version
    t.delete()
    clock.advance(2 * WEEK)
    t.vacuum()
    return observe(lambda: rows(name, p, version=v0))


def _result_shape(name, p, clock):
    r = _clocked(name, p, clock).vacuum(dry_run=True)
    return r.path == p, r.retention_ms, r.dry_run


def _three_rows(src, partitioned=False):
    create(src, {"part": ["a", "a", "b"], "x": [1, 2, 3]},
           partition_columns=["part"] if partitioned else ())


VACUUM_CASES = {
    "live_files_never_deleted": (_three_rows, _live_never_deleted),
    "removed_file_kept_within_retention_deleted_after": (_three_rows,
                                                         _removed_kept_then_deleted),
    "dry_run_reports_without_deleting": (_three_rows, _dry_run),
    "untracked_junk_deleted_after_retention": (_three_rows, _junk),
    "hidden_dirs_untouched": (_three_rows, _hidden),
    "empty_partition_dirs_removed": (lambda s: _three_rows(s, True), _empty_partition_dirs),
    "retention_shorter_than_tombstone_retention_rejected": (_three_rows, _short_retention),
    "retention_check_off_by_conf": (_three_rows, _short_retention_conf),
    "custom_tombstone_retention_property": (
        lambda s: create(s, {"x": [1]},
                         {"delta.deletedFileRetentionDuration": "interval 1 hour"}),
        lambda name, p, clock: (_clocked(name, p, clock).delete(), clock.advance(2 * HOUR),
                                _result(_clocked(name, p, clock).vacuum()))[2]),
    "vacuum_breaks_time_travel_to_removed_files": (_three_rows, _breaks_time_travel),
    "vacuum_metrics_and_result_shape": (_three_rows, _result_shape),
}


@pytest.mark.parametrize("case", sorted(VACUUM_CASES))
def test_vacuum_matches_jax(tmp_path, case):
    build, op = VACUUM_CASES[case]
    paths, out = _both(tmp_path, build, lambda name, p: op(name, p, ManualClock()))
    assert out["torch"] == out["jax"]
    assert _on_disk(paths["torch"]) == _on_disk(paths["jax"])


@pytest.mark.parametrize("case", ["keeps_live_dv_sidecar", "expired_dv_sidecar_deleted"])
def test_vacuum_dv_sidecars_match_jax(tmp_path, monkeypatch, case):
    """``test_vacuum_keeps_live_dv_sidecar`` and
    ``test_expired_dv_sidecar_deleted_with_its_file``: a live vector's
    sidecar stays past any retention; a tombstoned file's goes with it."""
    monkeypatch.setattr(jax_dv, "INLINE_THRESHOLD_BYTES", 0)
    monkeypatch.setattr(torch_dv, "INLINE_THRESHOLD_BYTES", 0)
    n = 60_000 if case == "keeps_live_dv_sidecar" else 100

    def build(src):
        create(src, {"x": list(range(n))}, DV_PROPS)

    def op(name, p):
        clock = ManualClock()
        t = _clocked(name, p, clock)
        if case == "keeps_live_dv_sidecar":
            t.delete("x % 2 = 1")
            r = t.vacuum(retention_hours=0, retention_check_enabled=False)
            return _result(r), len(rows(name, p)), _on_disk(p)
        t.delete("x % 2 = 0")
        clock.advance(2 * WEEK)
        first = _result(t.vacuum())
        t.delete()
        clock.advance(2 * WEEK)
        return first, _result(t.vacuum()), _on_disk(p)

    paths, out = _both(tmp_path, build, op)
    assert out["torch"] == out["jax"]
    assert "deletion_vector_*" in out["torch"][2] if case == "keeps_live_dv_sidecar" \
        else "deletion_vector_*" not in out["torch"][2]


def test_vacuum_lists_exactly_the_unreferenced_files(tmp_path):
    """After DV DELETEs, an UPDATE, a rewrite and a RESTORE, the dry run
    lists exactly the files an independent walk finds that no live AddFile
    and no live sidecar references; the real run deletes those and the end
    state still reads the same."""
    src = str(tmp_path / "src")
    create(src, {"id": list(range(200)), "v": [f"v{i}" for i in range(200)]}, DV_PROPS)
    append(src, {"id": list(range(200, 260)), "v": ["w"] * 60})
    t = table("torch", src)
    t.delete("id < 20")
    t.update({"v": "'u'"}, "id >= 250")
    with both_confs(**{"delta.tpu.deletionVectors.enabled": False}):
        t.delete("id = 100")
    v = t.version
    t.delete("id >= 240")
    t.restore_to_version(v)
    want_rows = rows("torch", src)
    snap = log("torch", src).update()
    import urllib.parse

    referenced = {urllib.parse.unquote(f.path) for f in snap.all_files}
    referenced |= {f.deletion_vector["pathOrInlineDv"] for f in snap.all_files
                   if f.deletion_vector and f.deletion_vector["storageType"] == "u"}
    walked = set()
    for d, _dirs, files in os.walk(src):
        rel = os.path.relpath(d, src)
        if rel.split(os.sep)[0].startswith("_"):
            continue
        walked |= {os.path.normpath(os.path.join(rel, f)) for f in files}
    expected = sorted(walked - referenced)
    assert expected
    dry = t.vacuum(retention_hours=0, dry_run=True, retention_check_enabled=False)
    assert dry.deleted_paths == expected
    real = t.vacuum(retention_hours=0, retention_check_enabled=False)
    assert real.deleted_paths == expected
    assert all(not os.path.exists(os.path.join(src, p)) for p in expected)
    reset_caches()
    assert rows("torch", src) == rows("jax", src) == want_rows

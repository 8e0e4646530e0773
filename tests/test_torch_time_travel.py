"""The port's time travel and history against ``delta_tpu``'s on the CPU.

The cases replay ``tests/test_time_travel.py``: version reads, timestamp ->
version resolution with monotonized commit timestamps, the out-of-range
errors, reproducibility after the log's head is cleaned up, history with
its limit, and ``to_table(version=, timestamp=)``. Both packages read one
table ``delta_tpu`` wrote. Also: ``describe_detail``'s row, a read below
the resident scan state's version (the state cache's "older" verdict: the
plan runs on the host and is never served the newer lanes), and the
INT64_MIN-free parts of the read path after DML.
"""
import datetime as dt
import os
import time

import numpy as np
import pytest

import delta_tpu
import delta_tpu_torch
from delta_tpu.protocol import filenames
from delta_tpu.protocol.actions import AddFile, Protocol
from delta_tpu.utils.timeparse import timestamp_option_to_ms as jax_ts
from delta_tpu_torch.commands.describe import describe_detail
from delta_tpu_torch.ops.column_cache import ColumnCache
from delta_tpu_torch.ops.state_cache import DeviceStateCache
from delta_tpu_torch.utils.timeparse import timestamp_option_to_ms as torch_ts
from tests.conftest import commit_manually, init_metadata
from tests.torch_dml_tables import (
    DV_PROPS, PKGS, append, copies, create, log, observe, rows, table,
)
from tests.torch_port_tables import both_confs, reset_caches

HOUR_MS = 3_600_000


@pytest.fixture(autouse=True)
def _fresh():
    reset_caches()
    ColumnCache.reset()
    DeviceStateCache.reset()
    yield
    reset_caches()
    ColumnCache.reset()
    DeviceStateCache.reset()


def _add(path):
    return AddFile(path, {}, 1, 0, True)


def _set_commit_time(path, version, ts_ms):
    p = f"{path}/_delta_log/{filenames.delta_file(version)}"
    os.utime(p, (ts_ms / 1000, ts_ms / 1000))


def bootstrap(path, n_commits=5, base_ts=10 * HOUR_MS):
    """n commits of one AddFile each, one hour apart (``bootstrap``)."""
    jlog = delta_tpu.DeltaLog.for_table(path)
    commit_manually(jlog, 0, [Protocol(1, 2), init_metadata(), _add("f-0")])
    for v in range(1, n_commits):
        commit_manually(jlog, v, [_add(f"f-{v}")])
    for v in range(n_commits):
        _set_commit_time(path, v, base_ts + v * HOUR_MS)
    return path


def _both(fn):
    return {name: observe(lambda: fn(name)) for name in PKGS}


def _same(fn):
    got = _both(fn)
    assert got["torch"] == got["jax"], got
    return got["torch"]


# -- version and timestamp resolution ---------------------------------------------------


def test_snapshot_at_each_version_and_out_of_range(tmp_path):
    path = bootstrap(str(tmp_path / "t"))
    assert _same(lambda n: [len(log(n, path).get_snapshot_at(v).all_files)
                            for v in range(5)]) == [1, 2, 3, 4, 5]
    assert _same(lambda n: log(n, path).get_snapshot_at(-3)) == "VersionNotFoundError"
    assert _same(lambda n: log(n, path).get_snapshot_at(99)) == "VersionNotFoundError"


def test_version_travel_is_stable_under_new_commits(tmp_path):
    path = bootstrap(str(tmp_path / "t"))
    old = {n: log(n, path).get_snapshot_at(2) for n in PKGS}
    commit_manually(delta_tpu.DeltaLog.for_table(path), 5, [_add("f-5")])
    assert _same(lambda n: (len(old[n].all_files), log(n, path).update().version,
                            len(log(n, path).get_snapshot_at(2).all_files))) == (3, 5, 3)


@pytest.mark.parametrize("ts, kw", [
    (12 * HOUR_MS, {}),                                   # exactly on v2
    (12 * HOUR_MS + 1, {}),                               # between: the earlier
    (13 * HOUR_MS - 1, {}),
    (HOUR_MS, {}),                                        # before the earliest
    (HOUR_MS, {"can_return_earliest_commit": True}),
    (110 * HOUR_MS, {}),                                  # after the latest
    (110 * HOUR_MS, {"can_return_last_commit": True}),
    (12 * HOUR_MS, {"must_be_recreatable": False}),
])
def test_active_commit_at_time_matches_jax(tmp_path, ts, kw):
    path = bootstrap(str(tmp_path / "t"))
    _same(lambda n: log(n, path).history.get_active_commit_at_time(ts, **kw).version)


def test_regressing_mtimes_are_monotonized(tmp_path):
    path = bootstrap(str(tmp_path / "t"))
    _set_commit_time(path, 3, 10 * HOUR_MS + HOUR_MS // 2)
    got = _same(lambda n: [(c.version, c.timestamp)
                           for c in log(n, path).history.get_commits(0, 4)])
    ts = [t for _, t in got]
    assert ts == sorted(ts) and got[3][1] > got[2][1]
    _set_commit_time(path, 3, 10 * HOUR_MS)
    _same(lambda n: log(n, path).history.get_active_commit_at_time(
        10 * HOUR_MS + 2 * HOUR_MS + 60_000).version)
    _same(lambda n: [(c.version, c.timestamp)
                     for c in log(n, path).history.get_commits(1, 3)])


def _cleaned_head(path):
    """10 commits, a checkpoint at 6, versions 0-3 deleted
    (``checkpointed_log_with_cleaned_head``)."""
    now = int(time.time() * 1000)
    bootstrap(path, n_commits=10, base_ts=now - 10 * HOUR_MS)
    jlog = delta_tpu.DeltaLog.for_table(path)
    jlog.update()
    jlog.checkpoint(jlog.get_snapshot_at(6))
    for v in range(4):
        os.remove(f"{path}/_delta_log/{filenames.delta_file(v)}")
    delta_tpu.DeltaLog.clear_cache()
    reset_caches()
    return path


def test_reproducibility_after_cleanup(tmp_path):
    path = _cleaned_head(str(tmp_path / "t"))
    assert _same(lambda n: log(n, path).history.get_earliest_reproducible_commit()) == 6
    assert _same(lambda n: log(n, path).history.get_earliest_delta_file()) == 4
    assert _same(lambda n: log(n, path).history.check_version_exists(2)) == \
        "VersionNotFoundError"
    assert _same(lambda n: log(n, path).history.check_version_exists(7)) is None
    assert _same(lambda n: (log(n, path).get_snapshot_at(7).version,
                            len(log(n, path).get_snapshot_at(7).all_files))) == (7, 8)
    assert _same(lambda n: [h.version for h in log(n, path).history.get_history()]) == \
        [9, 8, 7, 6, 5, 4]
    # below the earliest reproducible commit the port's get_snapshot_at
    # names the range left; the reference raises VersionNotFoundError where
    # no delta is left and its contiguity error where a tail is (version 5)
    assert observe(lambda: log("jax", path).get_snapshot_at(2)) == "VersionNotFoundError"
    assert observe(lambda: log("jax", path).get_snapshot_at(5)) == "DeltaIllegalStateError"
    for v in (2, 5):
        with pytest.raises(delta_tpu_torch.log.deltalog.VersionNotFoundError) as err:
            log("torch", path).get_snapshot_at(v)
        assert (err.value.earliest, err.value.latest) == (6, 9)


def test_history_full_and_limited(tmp_path):
    path = bootstrap(str(tmp_path / "t"), n_commits=5)
    assert _same(lambda n: [h.version for h in log(n, path).history.get_history()]) == \
        [4, 3, 2, 1, 0]
    assert _same(lambda n: [h.version for h in log(n, path).history.get_history(limit=2)]) \
        == [4, 3]


def test_timestamp_option_parsing_forms():
    base = 1_714_564_800_000  # 2024-05-01T12:00:00Z
    for v in (base, str(base), "2024-05-01 12:00:00", "2024-05-01T12:00:00Z",
              "2024-05-01T14:00:00+02:00", 1.5e12, "-5"):
        assert torch_ts(v) == jax_ts(v)
    for bad in ("not-a-time", True):
        assert observe(lambda: torch_ts(bad)) == observe(lambda: jax_ts(bad)) == \
            "DeltaAnalysisError"


# -- the table API ------------------------------------------------------------------


def _api_table(path):
    """CTAS + two appends (``api_table``)."""
    create(path, {"id": [1, 2], "value": ["a", "b"]})
    for i in range(2):
        append(path, {"id": [10 + i], "value": [f"v{i}"]})
    return path


def test_to_table_version_and_timestamp_as_of(tmp_path):
    path = _api_table(str(tmp_path / "t"))
    assert _same(lambda n: table(n, path).version) == 2
    for v in (0, 1, None):
        _same(lambda n: rows(n, path, version=v))
    for v in range(3):
        _set_commit_time(path, v, (10 + v) * HOUR_MS)
    reset_caches()
    assert len(_same(lambda n: rows(n, path, timestamp=11 * HOUR_MS + 1))) == 3
    base = dt.datetime(2024, 5, 1, tzinfo=dt.timezone.utc)
    for v in range(3):
        _set_commit_time(path, v, int(base.timestamp() * 1000) + v * HOUR_MS)
    reset_caches()
    assert len(_same(lambda n: rows(n, path, timestamp="2024-05-01 01:30:00"))) == 3
    assert _same(lambda n: rows(n, path, version=1, timestamp=10 * HOUR_MS)) == \
        "DeltaAnalysisError"
    assert _same(lambda n: rows(n, path, version=7)) == "VersionNotFoundError"


def test_time_travel_sees_old_schema(tmp_path):
    from delta_tpu.commands.alter import add_columns
    from delta_tpu.schema.types import LongType, StructField

    path = _api_table(str(tmp_path / "t"))
    add_columns(delta_tpu.DeltaLog.for_table(path), [StructField("extra", LongType())])
    old = _same(lambda n: rows(n, path, version=2))
    new = _same(lambda n: rows(n, path))
    assert "extra" not in old[0] and "extra" in new[0]


def test_time_travel_before_a_dv_delete(tmp_path):
    """``test_time_travel_before_dv_delete``: each package deletes on its
    copy, then reads the version before it."""
    src = str(tmp_path / "src")
    create(src, {"id": list(range(100)), "value": [f"v{i}" for i in range(100)]}, DV_PROPS)
    paths = copies(src, tmp_path)
    for n in PKGS:
        table(n, paths[n]).delete("id < 30")
    got = {n: (len(rows(n, paths[n], version=0)), len(rows(n, paths[n]))) for n in PKGS}
    assert got["torch"] == got["jax"] == (100, 70)


def test_history_and_detail_rows(tmp_path):
    path = _api_table(str(tmp_path / "t"))
    keep = ("version", "operation", "operationParameters", "readVersion", "isolationLevel",
            "isBlindAppend")
    _same(lambda n: [{k: h.get(k) for k in keep} for h in table(n, path).history()])
    jd = table("jax", path).detail()
    td = table("torch", path).detail()
    assert td == {k: jd[k] for k in td}
    assert set(td) == {"format", "id", "name", "description", "location", "createdAt",
                       "lastModified", "partitionColumns", "numFiles", "sizeInBytes",
                       "properties", "minReaderVersion", "minWriterVersion"}
    assert describe_detail(log("torch", path))["numFiles"] == 3


# -- a read below the resident state's version --------------------------------------


def test_time_travel_below_the_resident_entry_plans_on_the_host(tmp_path):
    """The resident entry sits at the latest version; a read of an older
    version takes the state cache's "older" verdict (no entry served, the
    entry left at its version) and its files equal the reference's."""
    src = str(tmp_path / "src")
    create(src, {"id": list(range(0, 50)), "value": ["a"] * 50})
    for k in range(1, 5):
        append(src, {"id": list(range(k * 50, (k + 1) * 50)), "value": ["b"] * 50})
    paths = copies(src, tmp_path)
    for n in PKGS:
        t = table(n, paths[n])
        t.delete("id >= 100 AND id <= 149")  # removes a whole file
        t.update({"value": "'c'"}, "id >= 200")  # rewrites the last
    filters = ["id >= 120 AND id <= 130"]
    cache = DeviceStateCache.instance()
    with both_confs(**{"delta.tpu.stateCache.devicePlan.mode": "force"}):
        latest = rows("torch", paths["torch"], filters=filters)
        tlog = log("torch", paths["torch"])
        entry = cache.get(tlog.update())
        assert entry is not None and entry.version == 6
        for v in range(7):
            old = tlog.get_snapshot_at(v)
            assert cache._lookup((tlog.log_path, str(tlog.device)), old)[1] == (
                "older" if v < 6 else "hit")
            got = rows("torch", paths["torch"], filters=filters, version=v)
            assert got == rows("jax", paths["jax"], filters=filters, version=v), v
            assert cache.get(tlog.update()) is entry and entry.version == 6
    assert latest == [] and len(rows("torch", paths["torch"], filters=filters,
                                     version=4)) == 11
    # the timestamp form of the same read
    for v in range(7):
        _set_commit_time(paths["torch"], v, (10 + v) * HOUR_MS)
    reset_caches()
    got = rows("torch", paths["torch"], filters=filters, timestamp=14 * HOUR_MS + 5)
    assert got == rows("jax", paths["jax"], filters=filters, version=4)
    assert np.all([r["id"] >= 120 for r in got])

"""The port's checkpoints (``delta_tpu_torch.log.checkpoints`` and the
checkpoint-reading log: ``log/columnar``, ``log/snapshot_management``,
``log/snapshot``, ``log/deltalog``, ``log/cleanup``, ``ops/state_export``)
held against ``delta_tpu`` on the CPU.

The cases of ``tests/test_checkpoints.py``, ``tests/test_struct_stats.py``
and the checkpoint cases of ``tests/test_format_compat.py`` run through both
packages; each package reads the checkpoints the other wrote, with equal
actions and snapshots; a log cleaned up behind a checkpoint and a log with
a corrupt checkpoint open to the same snapshot in both; the decoded
segment (ids, sizes, stats, partition maps, the ``stats_parsed`` lanes,
other actions) and ``state_export``'s lanes equal the JAX package's; the
resident scan state and the key slab serve tails across a checkpoint as
the JAX package's do.

Tolerance: exact equality (actions, Parquet rows, masks, int64 columns,
float64 lanes bit for bit, NaN for NaN).
"""
import datetime
import json
import os
import shutil

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from delta_tpu.api.tables import DeltaTable as JaxTable
from delta_tpu.log import checkpoints as jck
from delta_tpu.log.deltalog import DeltaLog as JaxDeltaLog
from delta_tpu.ops import key_cache as jkc
from delta_tpu.ops import state_cache as jsc
from delta_tpu.ops.state_export import arrays_from_columns as jax_arrays
from delta_tpu.protocol import actions as JA
from delta_tpu.storage.logstore import LocalLogStore as JaxStore
from delta_tpu.utils.config import conf as jax_conf
from delta_tpu_torch import DeltaLog as TorchDeltaLog
from delta_tpu_torch.expr import ir as tir
from delta_tpu_torch.log import checkpoints as tck
from delta_tpu_torch.log.columnar import decode_segment as torch_decode
from delta_tpu_torch.ops import key_cache as tkc
from delta_tpu_torch.ops import state_cache as tsc
from delta_tpu_torch.ops.state_export import arrays_from_columns as torch_arrays
from delta_tpu_torch.protocol import actions as TA
from delta_tpu_torch.protocol import filenames
from delta_tpu_torch.storage.logstore import LocalLogStore as TorchStore
from delta_tpu_torch.utils.config import conf as torch_conf
from tests.torch_port_tables import write_table, write_tail

PKGS = {"jax": (jck, JA, JaxStore), "torch": (tck, TA, TorchStore)}


def _cpu(mod):
    """The port's checkpoint codec on the CPU (its plain versions)."""
    return {"device": "cpu"} if mod is tck else {}


@pytest.fixture(autouse=True)
def _fresh_caches():
    for c in (jsc.DeviceStateCache, tsc.DeviceStateCache, jkc.KeyCache, tkc.KeyCache):
        c.reset()
    JaxDeltaLog.clear_cache()
    TorchDeltaLog.clear_cache()
    yield
    JaxDeltaLog.clear_cache()
    TorchDeltaLog.clear_cache()


def _open(pkg, path, clock=None):
    if pkg == "jax":
        log = JaxDeltaLog.for_table(path, clock=clock)
    else:
        log = TorchDeltaLog.for_table(path, device="cpu")
        if clock is not None:
            log.clock = clock
    return log


def state_actions(A):
    return [
        A.Protocol(1, 2),
        A.Metadata(id="m1", schema_string='{"type":"struct","fields":[]}'),
        A.SetTransaction("app", 3, 5),
        A.AddFile("f1", {"p": "1"}, 10, 100, False, stats='{"numRecords":2}'),
        A.AddFile("f2", {"p": None}, 20, 200, False),
        A.RemoveFile("f0", deletion_timestamp=50, data_change=False,
                     extended_file_metadata=True, partition_values={"p": "0"}, size=5),
    ]


def _dicts(actions):
    return [(type(a).__name__, a.to_dict()) for a in actions]


def _rows(path):
    """A checkpoint file's rows as ``pyarrow`` reads them, in a canonical
    order."""
    def key(r):
        for k in ("protocol", "metaData", "txn", "remove", "add"):
            if r.get(k) is not None:
                inner = r[k]
                return (k, str(inner.get("path") or inner.get("appId") or ""))
        return ("", "")

    return sorted(pq.read_table(path).to_pylist(), key=key)


# -- tests/test_checkpoints.py, through both packages -----------------------------


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("parts", [None, 3])
def test_roundtrip_read_by_both(tmp_path, writer, parts):
    """Single- and multi-part checkpoints written by either package read
    back equal in both (``test_single_part_roundtrip``,
    ``test_multipart_roundtrip``)."""
    log = str(tmp_path / "_delta_log")
    mod, A, Store = PKGS[writer]
    md = mod.write_checkpoint(Store(), log, 10, state_actions(A), parts=parts, **_cpu(mod))
    assert (md.version, md.size, md.parts) == (10, 6, parts)
    paths = (mod.CheckpointInstance(10, parts).paths(log))
    assert all(os.path.exists(p) for p in paths)
    got = {name: _dicts(m.read_checkpoint_actions(S(), paths, **_cpu(m)))
           for name, (m, _, S) in PKGS.items()}
    assert got["jax"] == got["torch"]
    assert sorted(t for t, _ in got["torch"]) == sorted(type(a).__name__
                                                        for a in state_actions(A))
    adds = {d["path"]: d for t, d in got["torch"] if t == "AddFile"}
    assert adds["f1"]["partitionValues"] == {"p": "1"} and adds["f1"]["stats"] == \
        '{"numRecords":2}'
    assert adds["f2"]["partitionValues"] == {"p": None}


def test_both_writers_write_the_same_rows(tmp_path):
    a, b = str(tmp_path / "a" / "_delta_log"), str(tmp_path / "b" / "_delta_log")
    jck.write_checkpoint(JaxStore(), a, 4, state_actions(JA))
    tck.write_checkpoint(TorchStore(), b, 4, state_actions(TA), device="cpu")
    name = filenames.checkpoint_file_single(4)
    assert _rows(f"{a}/{name}") == _rows(f"{b}/{name}")
    assert open(f"{a}/_last_checkpoint").read() == open(f"{b}/_last_checkpoint").read()


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_last_checkpoint_roundtrip_and_corruption(tmp_path, pkg):
    mod, _, Store = PKGS[pkg]
    log = str(tmp_path / "_delta_log")
    assert mod.read_last_checkpoint(Store(), log) is None
    mod.write_last_checkpoint(Store(), log, mod.CheckpointMetaData(5, 100, None))
    got = mod.read_last_checkpoint(Store(), log)
    assert (got.version, got.size, got.parts) == (5, 100, None)
    other = PKGS["jax" if pkg == "torch" else "torch"]
    back = other[0].read_last_checkpoint(other[2](), log)
    assert (back.version, back.size, back.parts) == (5, 100, None)
    with open(f"{log}/_last_checkpoint", "w") as f:
        f.write("{not-json")
    assert mod.read_last_checkpoint(Store(), log) is None


def test_latest_complete_checkpoint_matches():
    for insts, upper in (([(2, None), (5, 2), (5, 2), (7, 3), (7, 3)], None),
                         ([(2, None), (5, 2), (5, 2), (7, 3), (7, 3)], 4), ([], None),
                         ([(3, None), (3, 2), (3, 2)], None)):
        got = [m.latest_complete_checkpoint([m.CheckpointInstance(*i) for i in insts], upper)
               for m in (jck, tck)]
        assert [None if g is None else (g.version, g.parts) for g in got][0] == \
            [None if g is None else (g.version, g.parts) for g in got][1]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_find_last_complete_checkpoint_before(tmp_path, writer):
    log = str(tmp_path / "_delta_log")
    mod, A, Store = PKGS[writer]
    mod.write_checkpoint(Store(), log, 10, state_actions(A), **_cpu(mod))
    mod.write_checkpoint(Store(), log, 20, state_actions(A), parts=2, **_cpu(mod))
    for m, S in ((jck, JaxStore), (tck, TorchStore)):
        found = [m.find_last_complete_checkpoint_before(S(), log, v) for v in (15, 25, 10)]
        assert [None if f is None else (f.version, f.parts) for f in found] == \
            [(10, None), (20, 2), None]


def _jax_table(path, data, **kw):
    return JaxTable.create(path, data=data, **kw)


def _checkpoint_both(tmp_path, make):
    """The same table in two copies, checkpointed by each package; returns
    (jax checkpoint file, torch checkpoint file, jax md, torch md)."""
    src = str(tmp_path / "src")
    make(src)
    out = {}
    for pkg in ("jax", "torch"):
        dst = str(tmp_path / pkg)
        shutil.copytree(src, dst)
        md = _open(pkg, dst).checkpoint()
        out[pkg] = (f"{dst}/_delta_log/{filenames.checkpoint_file_single(md.version)}", md)
    return out


def test_v2_checkpoint_struct_columns(tmp_path):
    out = _checkpoint_both(tmp_path, lambda p: _jax_table(
        p, pa.table({"part": pa.array(["a", "a", "b"]), "x": pa.array([1, 2, 30], pa.int64())}),
        partition_columns=["part"],
        configuration={"delta.checkpoint.writeStatsAsStruct": "true"}))
    rows = _rows(out["torch"][0])
    assert rows == _rows(out["jax"][0])
    adds = [r["add"] for r in rows if r["add"] is not None]
    by_part = {r["partitionValues_parsed"]["part"]: r for r in adds}
    assert by_part["b"]["stats_parsed"]["minValues"]["x"] == 30
    assert by_part["a"]["stats_parsed"]["numRecords"] == 2


@pytest.mark.parametrize("struct", [None, "true", "false", "session-off"])
def test_default_and_opt_out_of_v2_columns(tmp_path, struct):
    """The engine default writes ``stats_parsed``; the table property set
    to false, or the session conf off, leaves the V2 columns out
    (``test_default_checkpoint_has_v2_stats_struct``,
    ``test_table_property_opts_out_of_v2_columns``)."""
    cfg = {} if struct in (None, "session-off") else {
        "delta.checkpoint.writeStatsAsStruct": struct}
    kv = {"delta.tpu.checkpoint.writeStatsAsStruct": False} if struct == "session-off" else {}
    with jax_conf.set_temporarily(**kv), torch_conf.set_temporarily(**kv):
        out = _checkpoint_both(tmp_path, lambda p: _jax_table(
            p, pa.table({"x": pa.array([1], pa.int64())}), configuration=cfg))
    names = {}
    for pkg, (f, _) in out.items():
        t = pq.read_table(f).schema.field("add").type
        names[pkg] = [t.field(i).name for i in range(t.num_fields)]
    assert names["jax"] == names["torch"]
    assert ("stats_parsed" in names["torch"]) == (struct in (None, "true"))
    assert _rows(out["jax"][0]) == _rows(out["torch"][0])


def test_v2_checkpoint_typed_and_nested_stats(tmp_path):
    out = _checkpoint_both(tmp_path, lambda p: _jax_table(p, pa.table({
        "d": pa.array([datetime.date(2024, 1, 2), datetime.date(2024, 3, 4)]),
        "ts": pa.array([datetime.datetime(2024, 1, 2, 3, 4, 5),
                        datetime.datetime(2024, 6, 7, 8, 9, 10)], pa.timestamp("us")),
        "s": pa.array([{"a": 1, "b": None}, {"a": 2, "b": "x"}],
                      pa.struct([("a", pa.int64()), ("b", pa.string())])),
    }), configuration={"delta.checkpoint.writeStatsAsStruct": "true"}))
    rows = _rows(out["torch"][0])
    assert rows == _rows(out["jax"][0])
    [add] = [r["add"] for r in rows if r["add"]]
    assert add["stats_parsed"]["minValues"]["d"] == datetime.date(2024, 1, 2)
    assert add["stats_parsed"]["maxValues"]["ts"].year == 2024


def test_string_stats_with_iso_date_literals_round_trip_verbatim(tmp_path):
    out = _checkpoint_both(tmp_path, lambda p: _jax_table(p, pa.table({
        "s": pa.array(["2021-01-01", "2021-01-05"], pa.string()),
        "x": pa.array([1, 2], pa.int64())})))
    rows = _rows(out["torch"][0])
    assert rows == _rows(out["jax"][0])
    [add] = [r["add"] for r in rows if r["add"]]
    assert add["stats_parsed"]["minValues"]["s"] == "2021-01-01"


def test_decimal_struct_stats_raise_naming_the_type(tmp_path):
    """Once a refusal, now the feature: a DECIMAL stats leaf under
    ``writeStatsAsStruct`` checkpoints in both packages to equal Parquet
    rows, and each package reads either package's checkpoint to the same
    snapshot (files, schema and rows)."""
    import decimal

    from tests.torch_dml_tables import rows as table_rows

    out = _checkpoint_both(tmp_path, lambda p: _jax_table(p, pa.table(
        {"m": pa.array([decimal.Decimal("1.50")], pa.decimal128(5, 2))}),
        configuration={"delta.checkpoint.writeStatsAsStruct": "true"}))
    assert _rows(out["torch"][0]) == _rows(out["jax"][0])
    [add] = [r["add"] for r in _rows(out["torch"][0]) if r["add"]]
    assert add["stats_parsed"]["minValues"]["m"] is None
    assert add["stats_parsed"]["nullCount"]["m"] == 0
    for copy in ("jax", "torch"):
        path = str(tmp_path / copy)
        JaxDeltaLog.clear_cache()
        TorchDeltaLog.clear_cache()
        snaps = {pkg: _open(pkg, path).update() for pkg in ("jax", "torch")}
        assert ({(f.path, f.size, f.stats) for f in snaps["torch"].all_files}
                == {(f.path, f.size, f.stats) for f in snaps["jax"].all_files})
        assert snaps["torch"].metadata.schema_string == snaps["jax"].metadata.schema_string
        assert (table_rows("torch", path) == table_rows("jax", path)
                == [{"m": decimal.Decimal("1.50")}])


# -- tests/test_format_compat.py's checkpoint cases --------------------------------


def _format_table(path):
    from delta_tpu.commands.write import WriteIntoDelta

    t = _jax_table(path, pa.table({"id": pa.array([1, 2], pa.int64()),
                                   "value": pa.array(["a", "b"])}))
    WriteIntoDelta(t.delta_log, "append", pa.table({"id": pa.array([3], pa.int64()),
                                                    "value": pa.array(["c"])})).run()
    t.delete("id = 1")


def test_format_compat_checkpoint_columns_pointer_and_names(tmp_path):
    """The build of ``test_format_compat``: the port's checkpoint has the
    JAX package's columns and nesting, the same ``_last_checkpoint`` shape
    and the same file names; its rows equal the JAX package's."""
    out = _checkpoint_both(tmp_path, _format_table)
    schemas = {k: pq.read_table(f).schema for k, (f, _) in out.items()}
    assert schemas["jax"].names == schemas["torch"].names
    for col in ("txn", "add", "remove", "metaData", "protocol"):
        t = {k: s.field(col).type for k, s in schemas.items()}
        assert [t["jax"].field(i).name for i in range(t["jax"].num_fields)] == \
            [t["torch"].field(i).name for i in range(t["torch"].num_fields)], col
    assert _rows(out["jax"][0]) == _rows(out["torch"][0])
    lasts = {k: json.loads(open(os.path.join(os.path.dirname(f), "_last_checkpoint")).read())
             for k, (f, _) in out.items()}
    assert lasts["jax"] == lasts["torch"]
    assert sorted(os.listdir(os.path.dirname(out["jax"][0]))) == \
        sorted(os.listdir(os.path.dirname(out["torch"][0])))


# -- each package reads the other's checkpoints -----------------------------------


def _snapshot_view(snap):
    files = sorted(json.dumps(a.to_dict(), sort_keys=True) for a in snap.all_files)
    return (snap.version, snap.segment.checkpoint_version, files,
            snap.metadata.to_dict(), snap.protocol.to_dict(), snap.num_of_files,
            snap.size_in_bytes)


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("partitioned", [False, True])
def test_each_reads_the_others_checkpoint(tmp_path, writer, partitioned):
    path = str(tmp_path / "t")
    state = write_table(path, n_files=300, partitioned=partitioned)
    _open(writer, path).checkpoint()
    write_tail(path, state, n_commits=2)
    JaxDeltaLog.clear_cache()
    TorchDeltaLog.clear_cache()
    views = [_snapshot_view(_open(p, path).update()) for p in ("jax", "torch")]
    assert views[0] == views[1] and views[0][1] == 3
    # time travel to the checkpoint's own version and before it
    assert _snapshot_view(_open("jax", path).get_snapshot_at(3)) == \
        _snapshot_view(_open("torch", path).get_snapshot_at(3))
    assert _snapshot_view(_open("jax", path).get_snapshot_at(1))[2] == \
        _snapshot_view(_open("torch", path).get_snapshot_at(1))[2]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_multipart_checkpoint_opens_in_both(tmp_path, writer):
    path = str(tmp_path / "t")
    write_table(path, n_files=120, partitioned=True)
    kv = {"delta.tpu.checkpointPartSize": 50}
    with jax_conf.set_temporarily(**kv), torch_conf.set_temporarily(**kv):
        md = _open(writer, path).checkpoint()
    assert md.parts == 3
    JaxDeltaLog.clear_cache()
    TorchDeltaLog.clear_cache()
    views = [_snapshot_view(_open(p, path).update()) for p in ("jax", "torch")]
    assert views[0] == views[1]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_materialize_in_any_row_order_matches_one_row_at_a_time(tmp_path, writer):
    """The segment's actions come out of a multi-part checkpoint (adds and
    tombstones) and its JSON tail the same whether rows convert a batch at
    a time, in any order, or one at a time; and the snapshot's files equal
    the JAX package's."""
    path = str(tmp_path / "t")
    state = write_table(path, n_files=120, partitioned=True)
    write_tail(path, state, n_commits=2)
    kv = {"delta.tpu.checkpointPartSize": 50}
    with jax_conf.set_temporarily(**kv), torch_conf.set_temporarily(**kv):
        _open(writer, path).checkpoint()
    write_tail(path, state, n_commits=2)
    JaxDeltaLog.clear_cache()
    TorchDeltaLog.clear_cache()
    snap = _open("torch", path).update()
    cols = snap._columnar
    assert len(cols.ckpt_batches) > 1 and any(line is not None for line in cols.lines)
    rows = np.random.RandomState(4).permutation(cols.num_rows)
    got = cols.materialize(rows)
    assert got == [cols.materialize(np.array([r]))[0] for r in rows]
    assert {type(a).__name__ for a in got} == {"AddFile", "RemoveFile"}
    assert _snapshot_view(snap) == _snapshot_view(_open("jax", path).update())


def _log_with_checkpoints(path, commits=12):
    """A JAX-written table whose log has ``commits`` commits after the
    first, a checkpoint at 5 and at 10 (``delta.checkpointInterval`` 5)."""
    t = _jax_table(path, pa.table({"id": pa.array([0], pa.int64())}),
                   configuration={"delta.checkpointInterval": "5"})
    from delta_tpu.commands.write import WriteIntoDelta

    for i in range(1, commits + 1):
        WriteIntoDelta(t.delta_log, "append", pa.table({"id": pa.array([i], pa.int64())})).run()
    return t


@pytest.mark.parametrize("cleaner", ["jax", "torch"])
def test_log_cleaned_up_behind_a_checkpoint_opens_in_both(tmp_path, cleaner):
    path = str(tmp_path / "t")
    _log_with_checkpoints(path)
    JaxDeltaLog.clear_cache()
    later = lambda: int(datetime.datetime.now().timestamp() * 1000) + 40 * 86_400_000
    log = _open(cleaner, path, clock=later)
    log.checkpoint()
    names = sorted(os.listdir(os.path.join(path, "_delta_log")))
    assert filenames.delta_file(0) not in names and filenames.delta_file(12) in names
    assert filenames.checkpoint_file_single(12) in names
    JaxDeltaLog.clear_cache()
    TorchDeltaLog.clear_cache()
    views = [_snapshot_view(_open(p, path).update()) for p in ("jax", "torch")]
    assert views[0] == views[1] and views[0][0] == 12
    errs = []
    for p in ("jax", "torch"):
        try:
            _open(p, path).get_snapshot_at(3)
            errs.append(None)
        except Exception as e:  # the class is the observation
            errs.append(type(e).__name__)
    assert errs[0] == errs[1] and errs[0] is not None


def test_cleanup_respects_retention_and_the_property(tmp_path):
    """Within the retention nothing goes; with ``enableExpiredLogCleanup``
    false nothing goes either; both packages leave the same listing."""
    for pkg in ("jax", "torch"):
        path = str(tmp_path / pkg)
        _log_with_checkpoints(path)
        JaxDeltaLog.clear_cache()
        _open(pkg, path).checkpoint()
    assert sorted(os.listdir(str(tmp_path / "jax" / "_delta_log"))) == \
        sorted(os.listdir(str(tmp_path / "torch" / "_delta_log")))
    assert filenames.delta_file(0) in os.listdir(str(tmp_path / "torch" / "_delta_log"))


def test_corrupt_checkpoint_falls_back_to_the_same_segment(tmp_path):
    path = str(tmp_path / "t")
    _log_with_checkpoints(path)
    with open(os.path.join(path, "_delta_log", filenames.checkpoint_file_single(10)),
              "wb") as f:
        f.write(b"PAR1 not a parquet file PAR1")
    JaxDeltaLog.clear_cache()
    snaps = [_open(p, path).update() for p in ("jax", "torch")]
    views = [_snapshot_view(s) for s in snaps]
    assert views[0] == views[1] and views[0][1] == 5
    assert snaps[1].delta_log.corrupt_checkpoints == {10}


@pytest.mark.parametrize("bad", ["garbage", "missing"])
def test_bad_last_checkpoint_falls_back_to_listing(tmp_path, bad):
    path = str(tmp_path / "t")
    _log_with_checkpoints(path)
    p = os.path.join(path, "_delta_log", "_last_checkpoint")
    if bad == "garbage":
        open(p, "w").write("{garbage")
    else:
        json.dump({"version": 99, "size": 1}, open(p, "w"))
    JaxDeltaLog.clear_cache()
    views = [_snapshot_view(_open(pk, path).update()) for pk in ("jax", "torch")]
    assert views[0] == views[1] and views[0][1] == 10


# -- the decoded segment and the lanes ---------------------------------------------


def _segments(path):
    jsnap = _open("jax", path).update()
    ck = [f.path for f in jsnap.segment.checkpoint_files]
    de = [f.path for f in jsnap.segment.deltas]
    from delta_tpu.log.columnar import decode_segment as jax_decode

    return jsnap, jax_decode(jsnap.store, ck, de), torch_decode(TorchStore(), ck, de, device="cpu")


def _assert_same_segment(a, b):
    assert a.path_dict.to_pylist() == b.path_dict
    for f in ("path_id", "is_add", "size", "modification_time", "deletion_timestamp"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert (a.stats.to_pylist() if a.stats is not None else [None] * a.num_rows) == b.stats
    assert _dicts(a.other_actions) == _dicts(b.other_actions)
    rows = np.arange(a.num_rows)
    assert _dicts(a.materialize(rows)) == _dicts(b.materialize(rows))
    sp = a.stats_parsed
    if sp is None:
        assert b.stats_parsed is None
        return
    import pyarrow.compute as pc

    sp = sp.combine_chunks()
    assert np.array_equal(np.asarray(sp.is_valid()), b.stats_parsed.valid)
    for name, (vals, ok, _) in b.stats_parsed.lanes.items():
        col = sp
        for part in name.split("."):
            col = pc.struct_field(col, part)
        want_ok = np.asarray(col.is_valid())
        assert np.array_equal(want_ok, ok), name
        want = col.cast(pa.int64()) if pa.types.is_timestamp(col.type) or \
            pa.types.is_date(col.type) else col
        want = np.asarray(want.to_numpy(zero_copy_only=False))
        assert np.array_equal(want[want_ok], vals[ok]), name


@pytest.mark.parametrize("partitioned", [False, True])
@pytest.mark.parametrize("struct", [True, False])
def test_segment_columns_and_lanes_equal_jax(tmp_path, partitioned, struct):
    path = str(tmp_path / "t")
    state = write_table(path, n_files=400, partitioned=partitioned)
    with jax_conf.set_temporarily(**{"delta.tpu.checkpoint.writeStatsAsStruct": struct}):
        _open("jax", path).checkpoint()
    write_tail(path, state, n_commits=2)
    jsnap, a, b = _segments(path)
    _assert_same_segment(a, b)
    assert (b.stats_parsed is not None) == struct
    tsnap = _open("torch", path).update()
    ja = jax_arrays(jsnap._columnar, jsnap._alive_mask, jsnap.metadata)
    ta = torch_arrays(tsnap._columnar, tsnap._alive_mask, tsnap.metadata)
    assert ja.paths == ta.paths and np.array_equal(ja.size, ta.size)
    for c in ja.stats_min:
        assert np.array_equal(ja.stats_min[c], ta.stats_min[c], equal_nan=True), c
        assert np.array_equal(ja.stats_max[c], ta.stats_max[c], equal_nan=True), c
    for c, codes in ja.partition_codes.items():
        assert np.array_equal(codes, ta.partition_codes[c])
        assert list(ja.partition_dicts[c]) == ta.partition_dicts[c]


def test_typed_stats_lanes_from_a_port_checkpoint(tmp_path):
    """Dates, timestamps, strings (the prefix lane), int32 and float32 leaves
    written by the port's checkpoint give the JAX package's lanes."""
    path = str(tmp_path / "t")
    _jax_table(path, pa.table({
        "d": pa.array([datetime.date(1969, 12, 30), datetime.date(2024, 3, 4)]),
        "ts": pa.array([datetime.datetime(1960, 1, 2, 3, 4, 5, 123456),
                        datetime.datetime(2024, 6, 7, 8, 9, 10)], pa.timestamp("us")),
        "s": pa.array(["abcdefgh", "zz"]),
        "i": pa.array([-7, 1 << 30], pa.int32()),
        "f": pa.array([1.5, -2.25], pa.float32()),
    }))
    _open("torch", path).checkpoint()
    JaxDeltaLog.clear_cache()
    jsnap = _open("jax", path).update()
    tsnap = _open("torch", path).update()
    assert tsnap.segment.checkpoint_version == 0 and tsnap._columnar.stats_parsed is not None
    kw = dict(stats_columns=["d", "ts", "i", "f"], string_prefix_cols=["s"])
    ja = jax_arrays(jsnap._columnar, jsnap._alive_mask, jsnap.metadata, **kw)
    ta = torch_arrays(tsnap._columnar, tsnap._alive_mask, tsnap.metadata, **kw)
    for c in ("d", "ts", "i", "f", "s"):
        assert np.array_equal(ja.stats_min[c], ta.stats_min[c], equal_nan=True), c
        assert np.array_equal(ja.stats_max[c], ta.stats_max[c], equal_nan=True), c


def test_backward_compat_checkpoint_without_struct_and_mixed_tail(tmp_path):
    """A checkpoint without ``stats_parsed`` reads its lanes from the JSON
    stats; a struct checkpoint plus a JSON tail reads the tail's lanes from
    JSON only (``test_backward_compat_checkpoint_without_struct_column``,
    ``test_mixed_segment_struct_checkpoint_plus_json_tail``)."""
    for struct in (False, True):
        path = str(tmp_path / f"t{struct}")
        state = write_table(path, n_files=200)
        with torch_conf.set_temporarily(**{"delta.tpu.checkpoint.writeStatsAsStruct": struct}):
            _open("torch", path).checkpoint()
        write_tail(path, state, n_commits=1)
        TorchDeltaLog.clear_cache()
        JaxDeltaLog.clear_cache()
        jsnap, a, b = _segments(path)
        _assert_same_segment(a, b)
        tsnap = _open("torch", path).update()
        ja = jax_arrays(jsnap._columnar, jsnap._alive_mask, jsnap.metadata)
        ta = torch_arrays(tsnap._columnar, tsnap._alive_mask, tsnap.metadata)
        for c in ja.stats_min:
            assert np.array_equal(ja.stats_min[c], ta.stats_min[c], equal_nan=True)


# -- the resident state and the key slab across a checkpoint -----------------------


def _verdict(prev, entry):
    if prev is None:
        return "build"
    if entry is prev:
        return "tail" if entry.version != getattr(prev, "_seen_version", None) else "hit"
    return "rebuild"


def test_resident_state_serves_tails_across_a_checkpoint(tmp_path):
    """A checkpoint lands between two versions the resident scan state has
    seen (each package checkpoints its own copy): the next tail applies in
    place in both, with lanes equal to a fresh build, and the plans equal."""
    from tests.test_torch_state_cache import _assert_same_state

    jpath, tpath = str(tmp_path / "jax"), str(tmp_path / "torch")
    states = {p: write_table(p, n_files=600) for p in (jpath, tpath)}
    je0 = jsc.DeviceStateCache.instance().get(_open("jax", jpath).update())
    te0 = tsc.DeviceStateCache.instance().get(_open("torch", tpath).update())
    _open("jax", jpath).checkpoint()
    _open("torch", tpath).checkpoint()
    for path in (jpath, tpath):
        write_tail(path, states[path], n_commits=2)
    je = jsc.DeviceStateCache.instance().get(_open("jax", jpath).update())
    te = tsc.DeviceStateCache.instance().get(_open("torch", tpath).update())
    verdicts = [("tail" if e is e0 else "rebuild") for e, e0 in ((je, je0), (te, te0))]
    assert verdicts[0] == verdicts[1] == "tail"
    _assert_same_state(je, te)
    tsc.DeviceStateCache.reset()
    TorchDeltaLog.clear_cache()
    fresh = tsc.DeviceStateCache.instance().get(_open("torch", tpath).update())
    assert te.version == fresh.version

    def live(e):  # path -> the live row's lanes: no stale lane after the checkpoint
        return {e.paths[r]: (e.h_lo[:, r].tobytes(), e.h_hi[:, r].tobytes(), int(e.h_size[r]))
                for r in np.nonzero(e.h_alive)[0]}

    assert live(te) == live(fresh)


def test_key_slab_serves_tails_across_a_checkpoint(tmp_path):
    """The key slab advances through a tail after a checkpoint landed, as
    the JAX package's does, and probes to the same pairs."""
    from delta_tpu.commands.write import WriteIntoDelta
    from delta_tpu.expr import ir as jir
    from tests.test_torch_key_cache import _probe_both

    path = str(tmp_path / "t")
    log = JaxDeltaLog.for_table(path)
    rng = np.random.RandomState(5)
    for i in range(3):
        keys = np.arange(i * 50, (i + 1) * 50, dtype=np.int64)
        WriteIntoDelta(log, "append", pa.table({"k": keys, "v": rng.rand(50)})).run()

    def entries():
        return (jkc.KeyCache.instance().get(_open("jax", path).update(), "sig", ["k"],
                                            [jir.Column("k")]),
                tkc.KeyCache.instance().get(_open("torch", path).update(), "sig", ["k"],
                                            [tir.Column("k")]))

    je0, te0 = entries()
    _open("torch", path).checkpoint()
    WriteIntoDelta(log, "append", pa.table({"k": np.arange(150, 170, dtype=np.int64),
                                            "v": rng.rand(20)})).run()
    je, te = entries()
    assert (je is je0) == (te is te0) and te is te0
    assert je.version == te.version == 3
    _probe_both(je, te, np.arange(0, 200, 3))

"""The port's change data feed (``delta_tpu_torch.exec.cdf``, the CDC blocks of
DELETE, UPDATE and MERGE, ``DeltaTable.table_changes``) against
``delta_tpu``'s on the CPU: every table case of ``tests/test_cdf.py``, on a
copy-on-write table and on one with deletion vectors. Each case runs once a
package in its own directory (``tests/torch_api_tables.both``); the
observation holds the table's state (rows read by both packages, files,
protocol, every commit's actions with their ``cdc`` lines), the change feed
as both packages read it (``tests/torch_write_tables.changes``) and every
error's class and message, all exactly equal. The streaming CDF source's
cases are in tests/test_torch_streaming.py."""
import os

import pytest

from tests.torch_api_tables import both, observe
from tests.torch_write_tables import CDF, DV, W, cdc_files, changes, state

LAYOUTS = {"cow": {}, "dv": DV}


def make(p, root, layout, n=10, cdf=True, **extra):
    path = os.path.join(root, "t")
    props = dict(CDF if cdf else {}, **LAYOUTS[layout], **extra)
    t = p.create(path, data=p.table({"id": list(range(n)), "value": [f"v{i}" for i in range(n)]}),
                 configuration=props or None)
    return path, t


def _create_reconstructs_inserts(p, root, layout):
    path, _ = make(p, root, layout, n=3)
    return changes(path, 0), cdc_files(path)


def _delete_captures_deleted_rows(p, root, layout):
    path, t = make(p, root, layout)
    m = t.delete("id < 3")
    return m["numDeletedRows"], changes(path, 1), cdc_files(path), state(path)


def _update_captures_pre_and_postimage(p, root, layout):
    path, t = make(p, root, layout)
    t.update({"value": "'X'"}, "id = 4")
    return changes(path, 1), cdc_files(path), state(path)


def _merge_captures_all_change_kinds(p, root, layout):
    path, t = make(p, root, layout)
    src = p.table({"id": [2, 3, 100], "value": ["U2", "DEL", "N100"]})
    (t.alias("t").merge(src, "t.id = s.id", source_alias="s")
     .when_matched_update_all("s.value != 'DEL'")
     .when_matched_delete("s.value = 'DEL'")
     .when_not_matched_insert_all().execute())
    return changes(path, 1), cdc_files(path), state(path)


def _merge_skips_files_with_no_fired_clause(p, root, layout):
    path, t = make(p, root, layout, n=5)
    t.write(p.table({"id": list(range(1000, 1005)), "value": [f"w{i}" for i in range(5)]}))
    before = {f.path for f in t.delta_log.update().all_files}
    (t.alias("t").merge(p.table({"id": [2, 1000], "value": ["U2", "NOOP"]}), "t.id = s.id",
                        source_alias="s")
     .when_matched_update_all("s.value != 'NOOP'").execute())
    kept = len(before & {f.path for f in t.delta_log.update().all_files})
    return kept, changes(path, 2), state(path)


def _merge_duplicate_delete_emits_one_row(p, root, layout):
    """A single unconditional DELETE may match a target row twice: the feed
    has one delete row for it."""
    path, t = make(p, root, layout, n=4)
    (t.alias("t").merge(p.table({"id": [1, 1, 2]}), "t.id = s.id", source_alias="s")
     .when_matched_delete().execute())
    return changes(path, 1), state(path)


def _append_reconstructed_without_cdc_files(p, root, layout):
    path, t = make(p, root, layout, n=2)
    t.write(p.table({"id": [10], "value": ["new"]}))
    return changes(path, 1), cdc_files(path)


def _whole_table_delete_reconstructed_from_removes(p, root, layout):
    path, t = make(p, root, layout, n=4)
    t.delete()
    return changes(path, 1), cdc_files(path)


def _partition_delete_reconstructed_from_removes(p, root, layout):
    path = os.path.join(root, "t")
    t = p.create(path, data=p.table({"id": [1, 2, 3], "part": ["a", "b", "a"]}),
                 partition_columns=["part"], configuration=dict(CDF, **LAYOUTS[layout]))
    t.delete("part = 'a'")
    return changes(path, 1), cdc_files(path), state(path)


def _partitioned_dml_and_merge_capture(p, root, layout):
    """On a partitioned table the change rows carry the partition columns,
    and an UPDATE that moves rows across partitions records both images."""
    path = os.path.join(root, "t")
    t = p.create(path, data=p.table({"id": list(range(8)), "part": ["a", "b"] * 4,
                                     "v": [float(i) for i in range(8)]}),
                 partition_columns=["part"], configuration=dict(CDF, **LAYOUTS[layout]))
    t.delete("v > 5.5")
    t.update({"part": "'c'", "v": "v + 0.5"}, "id = 1")
    (t.alias("t").merge(p.table({"id": [2, 30], "part": ["b", "d"], "v": [9.0, 3.0]}),
                        "t.id = s.id", source_alias="s")
     .when_matched_update_all().when_not_matched_insert_all().execute())
    return changes(path, 1), cdc_files(path), state(path)


def _delete_without_cdf_reconstructs(p, root, layout):
    path, t = make(p, root, layout, cdf=False)
    t.delete("id < 4")
    t.delete("id = 7")
    return changes(path, 1, 1), changes(path, 2, 2), cdc_files(path), state(path)


def _update_without_cdf_reconstructs(p, root, layout):
    path, t = make(p, root, layout, cdf=False)
    t.update({"value": "'Z'"}, "id >= 8")
    return changes(path, 1), cdc_files(path)


def _version_range_selection(p, root, layout):
    path, t = make(p, root, layout, n=2)
    t.delete("id = 0")
    t.update({"value": "'u'"}, "id = 1")
    return changes(path, 1, 1), changes(path, 1, 2), changes(path, 2)


def _range_errors(p, root, layout):
    path, t = make(p, root, layout)
    return (observe(lambda: t.table_changes(5, 2)), observe(lambda: t.table_changes(100)),
            changes(path, 0, 0)[:2])


def _cleaned_start_version_is_data_loss(p, root, layout):
    path, t = make(p, root, layout, n=2)
    t.delete("id = 0")
    t.delete("id = 1")
    t.delta_log.checkpoint()
    for v in (0, 1):
        os.remove(os.path.join(path, "_delta_log", f"{v:020d}.json"))
    t2 = p.for_path(path)
    return observe(lambda: t2.table_changes(0)), len(changes(path, 2))


def _cdc_write_blocked_without_property(p, root, layout):
    path, t = make(p, root, layout, cdf=False)
    actions = __import__(f"{'delta_tpu' if p.jax else 'delta_tpu_torch'}.protocol.actions",
                         fromlist=["AddCDCFile"])
    ops = __import__(f"{'delta_tpu' if p.jax else 'delta_tpu_torch'}.commands.operations",
                     fromlist=["Write"])
    cdc = actions.AddCDCFile(path="_change_data/x.parquet", partition_values={}, size=1)
    return observe(lambda: t.delta_log.with_new_transaction(
        lambda txn: txn.commit([cdc], ops.Write(mode="Append")))), state(path)


def _cdc_files_do_not_affect_table_state(p, root, layout):
    path, t = make(p, root, layout)
    t.delete("id < 5")
    t.update({"value": "'q'"}, "id = 9")
    names = sorted(os.listdir(os.path.join(path, "_change_data")))
    return len(names), [f.path.startswith("_change_data") for f in
                        t.delta_log.update().all_files], state(path)


def _enable_feed_later_upgrades_the_protocol(p, root, layout):
    path, t = make(p, root, layout, cdf=False)
    before = t.delta_log.update().protocol.min_writer_version
    p.alter.set_table_properties(t.delta_log, CDF)
    t.update({"value": "'y'"}, "id = 1")
    return before, changes(path, 2), state(path)


def _vacuum_keeps_change_data(p, root, layout):
    """VACUUM at the default retention keeps every CDC file of the retained
    commits: the feed reads the same afterwards. With no retention a dry run
    lists them with the unreferenced data files in both packages (a CDC file
    is kept for the retention period, as a removed data file is)."""
    path, t = make(p, root, layout)
    t.update({"value": "'w'"}, "id < 3")
    t.delete("id = 9")
    before = changes(path, 1)
    cdc = sorted(os.listdir(os.path.join(path, "_change_data")))
    t.vacuum()
    kept = (before == changes(path, 1),
            cdc == sorted(os.listdir(os.path.join(path, "_change_data"))))
    dry = t.vacuum(retention_hours=0, dry_run=True, retention_check_enabled=False)
    listed = sum("_change_data" in x for x in dry.deleted_paths)
    return kept, len(cdc), listed, state(path)


CASES = [
    _create_reconstructs_inserts, _delete_captures_deleted_rows,
    _update_captures_pre_and_postimage, _merge_captures_all_change_kinds,
    _merge_skips_files_with_no_fired_clause, _merge_duplicate_delete_emits_one_row,
    _append_reconstructed_without_cdc_files, _whole_table_delete_reconstructed_from_removes,
    _partition_delete_reconstructed_from_removes, _partitioned_dml_and_merge_capture,
    _delete_without_cdf_reconstructs,
    _update_without_cdf_reconstructs, _version_range_selection, _range_errors,
    _cleaned_start_version_is_data_loss, _cdc_write_blocked_without_property,
    _cdc_files_do_not_affect_table_state, _enable_feed_later_upgrades_the_protocol,
    _vacuum_keeps_change_data,
]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("case", CASES, ids=[c.__name__.lstrip("_") for c in CASES])
def test_cdf_matches_jax(tmp_path, case, layout):
    got = both(tmp_path, lambda p, root: case(W(p.name), root, layout))
    assert not (isinstance(got, tuple) and got[:1] == ("raises",)), got


def test_cdf_protocol_and_change_rows(tmp_path):
    """The log actions the feed adds: writer version 4, one ``cdc`` line in
    each DML commit with a data predicate, none in a blind append."""
    got = both(tmp_path, lambda p, root: _merge_captures_all_change_kinds(W(p.name), root, "cow"))
    rows, cdc, st = got
    assert st["protocol"][:2] == (1, 4)
    assert cdc == [0, 1]
    assert sorted(r["_change_type"] for r in rows) == [
        "delete", "insert", "update_postimage", "update_preimage"]


# -- one table across both packages -------------------------------------------------------


def _write_semantics_table(p, path, layout):
    """A table with the change data feed, a CHECK constraint, a generated
    column and a char column, and two batches of rows."""
    T = p.types
    schema = (T.StructType().add("id", T.LongType()).add("q", T.LongType())
              .add("price", T.DoubleType()).add("code", T.CharType(3))
              .add_field(p.gen("ext", "DoubleType", "q * price")))
    t = p.create(path, schema, configuration=dict(CDF, **LAYOUTS[layout],
                                                  **{"delta.constraints.qpos": "q > 0"}))
    t.write(p.table({"id": list(range(8)), "q": [1 + i % 3 for i in range(8)],
                     "price": [1.5 * i for i in range(8)], "code": ["a", "bb", "ccc", None] * 2}))
    t.write(p.table({"id": [20, 21], "q": [4, 5], "price": [2.0, 3.0], "code": ["x", "yy"]}))
    return t


def _run_commands(p, path):
    t = p.for_path(path)
    with p.conf.set_temporarily(**{"delta.tpu.schema.autoMerge.enabled": True}):
        (t.alias("t").merge(p.table({"id": [1, 2, 30], "q": [7, 8, 9], "price": [1.0, 2.0, 3.0],
                                     "code": ["m", "n", "o"], "note": ["u", "u", "i"]}),
                            "t.id = s.id", source_alias="s")
         .when_matched_update_all().when_not_matched_insert_all().execute())
    t.update({"q": "q + 1", "code": "'zz'"}, "price > 5")
    t.delete("id % 2 = 1 AND q < 3")
    bad = observe(lambda: t.write(p.table({"id": [99], "q": [0], "price": [1.0]})))[:2]
    return bad, 3  # the MERGE's version: the schema the streams start from


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_table_written_by_one_package_and_changed_by_both(tmp_path, writer, layout):
    """One package writes the table; each package runs the same MERGE (with
    autoMerge and a star clause), UPDATE, DELETE and a batch that breaks the
    constraint on its own copy. Both copies' states, change feeds and
    streams of each, read by both packages, are equal: a ``StreamingQuery``
    from the table's snapshot into a new table (one file a trigger; its end
    state is the table's), and a ``DeltaCDFSource`` from the MERGE's
    version (a stream from an older version fails on the evolved schema in
    both packages)."""
    import shutil

    from tests.torch_api_tables import fresh

    src = str(tmp_path / "src")
    fresh()
    _write_semantics_table(W(writer), src, layout)
    out = {}
    for name in ("jax", "torch"):
        fresh()
        path = str(tmp_path / name)
        shutil.copytree(src, path)
        p = W(name)
        bad, merge_version = _run_commands(p, path)
        old = observe(lambda: list(p.source.DeltaCDFSource(p.log(path), starting_version=0)
                                   ._changes_from(0, -1)))[:2]
        dst = str(tmp_path / f"{name}_stream")
        q = p.query.StreamingQuery(p.source.DeltaSource(p.log(path), max_files_per_trigger=1),
                                   p.sink.DeltaSink(p.log(dst), query_id="copy"),
                                   str(tmp_path / f"{name}_ckpt"))
        runs = q.process_all_available()
        cdf = p.source.DeltaCDFSource(p.log(path), starting_version=merge_version)
        cur, streamed = None, []
        while True:
            end = cdf.latest_offset(cur if cur is not None else cdf.initial_offset())
            if end is None:
                break
            streamed += [(r["id"], r["_change_type"], r["_commit_version"])
                         for r in cdf.get_batch(cur, end).to_pylist()]
            cur = end
        st = state(path)
        out[name] = (bad, old, st, changes(path, 0), runs, state(dst)["rows"], sorted(streamed))
    assert out["torch"] == out["jax"]
    bad, old, st, feed, _, stream_rows, streamed = out["jax"]
    assert bad == ("raises", "InvariantViolationError")
    assert old == ("raises", "DeltaIllegalStateError")
    assert st["protocol"][1] in (4, 7) and "note" in st["schema"]
    assert stream_rows == st["rows"]
    assert streamed == sorted((r["id"], r["_change_type"], r["_commit_version"]) for r in feed
                              if r["_commit_version"] >= merge_version)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_cdf_merge_takes_the_device_routes(tmp_path, layout):
    """With the feed on, a MERGE under ``devicePath.mode=force`` keeps the
    card's routes (cold, then resident over the advanced slab): its change
    rows come from the pairs the key slab hands back, not from a second
    host join, and equal the JAX package's."""
    from tests.torch_port_tables import Pkg, both_confs, metrics, reset_caches

    out = {}
    for name in ("jax", "torch"):
        reset_caches()
        P = Pkg(name)
        path = str(tmp_path / name)
        P.write(path, {"id": list(range(20)), "v": [i * 10 for i in range(20)]},
                configuration=dict(CDF, **LAYOUTS[layout]))
        log = P.log(path)
        routes = []
        with both_confs(**{"delta.tpu.merge.devicePath.mode": "force"}):
            for src in ({"id": [3, 5, 40], "v": [-3, -5, 400]},
                        {"id": [5, 7, 41], "v": [-50, -7, 410]}):
                cmd = P.merge(log, src, "t.id = s.id", [("update",)], [("insert",)],
                              source_alias="s", target_alias="t")
                routes.append((cmd._join_path, metrics(cmd)))
        out[name] = (routes, changes(path, 1), P.rows(log))
    reset_caches()
    assert out["torch"][1:] == out["jax"][1:]
    assert [m for _, m in out["torch"][0]] == [m for _, m in out["jax"][0]]
    assert [r for r, _ in out["torch"][0]] == ["device-cold", "resident"]

"""The port's DELETE and UPDATE against ``delta_tpu``'s on the CPU.

The cases replay the inputs of ``tests/test_dml.py`` (DELETE and UPDATE),
the DML cases of ``tests/test_deletion_vectors.py`` and the DELETE/UPDATE
cases of ``tests/test_history_metrics.py``. ``delta_tpu`` writes each
table, each package runs the command on its own copy, and the two end
states must agree: rows sorted and equal exactly (each package reads both
copies), the operation metrics without wall times, the last commit's
add/remove counts and the deletion-vector cardinalities
(``tests/torch_dml_tables.assert_same_end_state``).

Change-data-feed and generated-column cases run in both packages with the
same end state and change rows; the partitioned DELETE and UPDATE cases match the
reference (tests/test_torch_partitioned.py holds the rest of the
partitioned cases). After each port
command a port MERGE serves no stale key slab or scan lane: the DV
commands advance the resident slab, the rewrites rebuild it. A kernel
failure inside DELETE, UPDATE or the MERGE after them propagates.
"""
import os

import pytest

from delta_tpu.schema.generated import generated_field
from delta_tpu.schema.types import LongType, StringType, StructType
from delta_tpu_torch.ops import column_cache, key_cache, state_cache
from delta_tpu_torch.ops.column_cache import ColumnCache
from delta_tpu_torch.ops.key_cache import KeyCache
from delta_tpu_torch.ops.state_cache import DeviceStateCache
from tests.torch_dml_tables import (
    DV_PROPS, PKGS, append, assert_same_end_state, copies, create, last_commit_counts, log,
    metrics, observe, rows, table,
)
from tests.torch_port_tables import Pkg, both_confs, reset_caches


@pytest.fixture(autouse=True)
def _fresh():
    reset_caches()
    ColumnCache.reset()
    DeviceStateCache.reset()
    yield
    reset_caches()
    ColumnCache.reset()
    DeviceStateCache.reset()


def _ids(n, start=0):
    return {"id": list(range(start, start + n)), "value": [f"v{i}" for i in range(start,
                                                                                 start + n)]}


def _run_both(tmp_path, build, op, settings=None):
    """``build(src)`` writes the source; ``op(handle)`` runs the command on
    each package's copy. Returns (paths, {pkg: op's value or exception
    class name})."""
    src = str(tmp_path / "src")
    build(src)
    paths = copies(src, tmp_path)
    out = {}
    for name in PKGS:
        with both_confs(**(settings or {})):
            out[name] = observe(lambda: op(table(name, paths[name])))
    return paths, out


# -- DELETE and UPDATE cases of tests/test_dml.py and test_deletion_vectors.py ---------


def _two_files(src):
    create(src, {"id": [1, 2]})
    append(src, {"id": [100, 200]})


CASES = {
    # tests/test_dml.py
    "delete_whole_table": (lambda s: create(s, {"id": [1, 2, 3]}), lambda t: t.delete()),
    "delete_data_predicate_rewrites": (lambda s: create(s, {"id": [1, 2, 3, 4, 5]}),
                                       lambda t: t.delete("id > 3")),
    "delete_no_matches_no_op": (lambda s: create(s, {"id": [1, 2]}),
                                lambda t: t.delete("id > 100")),
    "delete_whole_file_no_rewrite": (_two_files, lambda t: t.delete("id >= 100")),
    "delete_null_predicate_rows_kept": (lambda s: create(s, {"id": [1, None, 3]}),
                                        lambda t: t.delete("id > 0")),
    "update_unconditional": (lambda s: create(s, {"id": [1, 2], "v": [10, 20]}),
                             lambda t: t.update({"v": "v + 1"})),
    "update_with_condition": (lambda s: create(s, {"id": [1, 2, 3], "v": [10, 20, 30]}),
                              lambda t: t.update({"v": "0"}, "id = 2")),
    "update_multiple_columns_and_expressions": (
        lambda s: create(s, {"id": [1, 2], "v": [10, 20], "name": ["a", "b"]}),
        lambda t: t.update({"v": "v * 2", "name": "upper(name)"}, "id = 1")),
    "update_unknown_column_fails": (lambda s: create(s, {"id": [1]}),
                                    lambda t: t.update({"nope": "1"})),
    # tests/test_deletion_vectors.py
    "dv_delete_marks_rows_without_rewriting": (lambda s: create(s, _ids(100), DV_PROPS),
                                               lambda t: t.delete("id < 10")),
    "delete_without_dv_property_rewrites": (lambda s: create(s, _ids(100)),
                                            lambda t: t.delete("id < 10")),
    "dv_delete_all_rows_collapses_to_remove": (lambda s: create(s, _ids(100), DV_PROPS),
                                               lambda t: t.delete("id >= 0")),
    "dv_whole_table_delete_still_metadata_only": (lambda s: create(s, _ids(100), DV_PROPS),
                                                  lambda t: t.delete()),
    "dv_update_writes_only_changed_rows": (lambda s: create(s, _ids(100), DV_PROPS),
                                           lambda t: t.update({"value": "'changed'"}, "id < 5")),
    "dv_update_parity_with_rewrite_path": (lambda s: create(s, _ids(100), DV_PROPS),
                                           lambda t: t.update({"value": "'x'"}, "id % 10 = 3")),
    "rw_update_parity_with_rewrite_path": (lambda s: create(s, _ids(100)),
                                           lambda t: t.update({"value": "'x'"}, "id % 10 = 3")),
    # tests/test_history_metrics.py
    "history_delete_metrics_rewrite_path": (lambda s: create(s, _ids(10)),
                                            lambda t: t.delete("id < 3")),
    "history_update_metrics": (lambda s: create(s, _ids(10)),
                               lambda t: t.update({"value": "'u'"}, "id >= 8")),
    # the unsafe cast of an assigned value (Arrow's cast(safe=False)): a
    # double assigned to an int64 column truncates toward zero, an int64
    # assigned to an int32 column wraps
    "update_casts_double_to_long": (lambda s: create(s, {"id": [1, 2, 3], "v": [10, 20, 30]}),
                                    lambda t: t.update({"v": "v * 1.5 - 40"}, "id > 1")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_delete_and_update_match_jax(tmp_path, case):
    build, op = CASES[case]
    paths, out = _run_both(tmp_path, build, op)
    if isinstance(out["jax"], str):
        assert out["torch"] == out["jax"]  # both raise the same error class
        return
    assert metrics(out["torch"]) == metrics(out["jax"])
    assert_same_end_state(paths)


@pytest.mark.parametrize("dv", [True, False])
def test_update_wraps_into_a_narrow_integer_column(tmp_path, dv):
    import pyarrow as pa

    def build(s):
        create(s, pa.table({"id": pa.array([1, 2, 3], pa.int64()),
                            "n": pa.array([1, 2, 3], pa.int32())}),
               DV_PROPS if dv else None)

    paths, out = _run_both(tmp_path, build,
                           lambda t: t.update({"n": "id + 2147483647"}, "id >= 2"))
    assert metrics(out["torch"]) == metrics(out["jax"])
    got = assert_same_end_state(paths)
    assert [r["n"] for r in got] == [1, -2147483647, -2147483646]


def test_update_of_a_type_the_port_cannot_cast_raises_the_mismatch(tmp_path):
    src = str(tmp_path / "src")
    create(src, {"id": [1, 2], "v": [10, 20]})
    t = table("torch", src)
    with pytest.raises(Exception) as err:
        t.update({"v": "'abc'"}, "id = 1")
    assert type(err.value).__name__ == "DeltaAnalysisError"
    assert "incompatible type" in str(err.value)
    assert t.version == 0


def test_second_delete_unions_the_dv(tmp_path):
    """``test_second_delete_unions_dv``: the re-add reads the old sidecar and
    unions it (cardinality 20); a delete that kills every live row of a DV
    file removes it (``test_delete_then_full_delete_via_dv_union``)."""
    for seq, n_live in ((("id < 10", "id >= 90"), 80), (("id < 50", "id >= 50"), 0)):
        root = tmp_path / str(n_live)
        paths, _ = _run_both(root, lambda s: create(s, _ids(100), DV_PROPS),
                             lambda t: [t.delete(c) for c in seq])
        got = assert_same_end_state(paths)
        assert len(got) == n_live
        cards = [f.deletion_vector["cardinality"] for f in log("torch", paths["torch"])
                 .update().all_files]
        assert cards == ([20] if n_live else [])


def test_dv_survives_each_packages_checkpoint(tmp_path):
    """``test_dv_survives_checkpoint``: each package checkpoints its copy
    after the DV delete, and each reads both copies fresh."""
    paths, _ = _run_both(tmp_path, lambda s: create(s, _ids(100), DV_PROPS),
                         lambda t: (t.delete("id < 25"), t.delta_log.checkpoint()))
    reset_caches()
    got = assert_same_end_state(paths)
    assert len(got) == 75


def test_history_rows_match_jax(tmp_path):
    """``test_history_entry_shape``, ``test_metrics_only_whitelisted_keys``,
    ``test_history_metrics_survive_reload`` and the metricsEnabled gate:
    each history row's operation, parameters and metrics (wall times
    aside)."""
    def op(t):
        t.delete("id = 0")
        t.update({"value": "'u'"}, "id >= 8")
        with both_confs(**{"delta.tpu.history.metricsEnabled": False}):
            t.delete("id < 3")
        t.delete("id < 5")

    paths, _ = _run_both(tmp_path, lambda s: create(s, _ids(10)), op)
    reset_caches()
    got = {}
    for name in PKGS:
        got[name] = [(h["version"], h["operation"], h["operationParameters"],
                      metrics(h.get("operationMetrics") or {}))
                     for h in table(name, paths[name]).history()]
    assert got["torch"] == got["jax"]
    assert [g[1] for g in got["torch"]] == ["DELETE", "DELETE", "UPDATE", "DELETE",
                                            "CREATE TABLE AS SELECT"]
    assert not got["torch"][1][3]  # the gated commit carries no metrics
    limited = table("torch", paths["torch"]).history(limit=2)
    assert [h["version"] for h in limited] == [4, 3]


# -- partitioned tables, and what the port refuses ---------------------------------


def test_delete_partition_only_matches_jax_on_a_partitioned_table(tmp_path):
    """``test_delete_partition_only_metadata``: case 2 reads no data, on the
    partitioned table ``delta_tpu`` wrote; each package reads both copies
    to equal rows."""
    paths, out = _run_both(
        tmp_path, lambda s: create(s, {"id": [1, 2, 3, 4], "c": ["a", "a", "b", "b"]},
                                   partition_columns=["c"]),
        lambda t: t.delete("c = 'a'"))
    assert metrics(out["torch"]) == metrics(out["jax"])
    assert out["torch"]["numDeletedRows"] == -1 and out["torch"]["numAddedFiles"] == 0
    got = assert_same_end_state(paths)
    assert sorted(r["id"] for r in got) == [3, 4]


@pytest.mark.parametrize("op", ["delete_data", "update", "update_partition_column"])
def test_partitioned_data_commands_raise_not_implemented(tmp_path, op):
    """A data predicate or an UPDATE on a partitioned table (the partitioned
    DELETE and ``test_update_partition_column_moves_rows``): the port reads
    and writes partitioned tables, so each matches the reference, with the
    rows of an assigned partition column moved to their new directory."""
    run = {"delete_data": lambda t: t.delete("id > 1"),
           "update": lambda t: t.update({"id": "id + 1"}, "id = 2"),
           "update_partition_column": lambda t: t.update({"c": "'b'"}, "id = 2")}[op]
    paths, out = _run_both(
        tmp_path, lambda s: create(s, {"id": [1, 2], "c": ["a", "a"]}, partition_columns=["c"]),
        run)
    assert not isinstance(out["jax"], str)
    assert metrics(out["torch"]) == metrics(out["jax"])
    assert log("torch", paths["torch"]).update().version == 1
    got = assert_same_end_state(paths)
    if op == "update_partition_column":
        assert [r["id"] for r in rows("torch", paths["jax"], filters=["c = 'b'"])] == [2]
        assert os.path.isdir(os.path.join(paths["torch"], "c=b"))
    assert len(got) == (1 if op == "delete_data" else 2)


@pytest.mark.parametrize("op", ["delete", "update"])
def test_change_data_feed_table_raises_not_implemented(tmp_path, op):
    """A table with the change data feed: each package runs the DELETE or
    UPDATE on its copy with the same metrics, end state and change rows
    (both packages read each copy's feed), and writes one ``cdc`` action.
    (The port refused such a table before the feed was ported; the name is
    kept.)"""
    from tests.torch_write_tables import changes

    run = {"delete": lambda t: t.delete("id > 1"),
           "update": lambda t: t.update({"id": "id + 1"}, "id = 2")}[op]
    paths, out = _run_both(
        tmp_path, lambda s: create(s, {"id": [1, 2, 3]}, {"delta.enableChangeDataFeed": "true"}),
        run)
    assert not isinstance(out["jax"], str) and not isinstance(out["torch"], str)
    assert metrics(out["torch"]) == metrics(out["jax"])
    assert_same_end_state(paths)
    assert changes(paths["torch"], 1) == changes(paths["jax"], 1)
    assert {r["_change_type"] for r in changes(paths["torch"], 1)} == (
        {"delete"} if op == "delete" else {"update_preimage", "update_postimage"})
    # a whole-table DELETE writes no change data: both run it
    paths2, out2 = _run_both(
        tmp_path / "all",
        lambda s: create(s, {"id": [1, 2, 3]}, {"delta.enableChangeDataFeed": "true"}),
        lambda t: t.delete())
    assert metrics(out2["torch"]) == metrics(out2["jax"])
    assert_same_end_state(paths2)


def test_generated_column_update_raises_not_implemented(tmp_path):
    """``test_update_recomputes_generated``: each package's UPDATE of a base
    column recomputes the generated column, with the same end state. (The
    port refused the table before generated columns were ported; the name is
    kept.)"""
    from delta_tpu.api.tables import DeltaTable as JaxTable

    schema = (StructType().add("id", LongType()).add("name", StringType())
              .add_field(generated_field("id2", LongType(), "id * 2")))
    src = str(tmp_path / "src")
    JaxTable.create(src, schema)
    append(src, {"id": [1, 2], "name": ["a", "b"]})
    paths = copies(src, tmp_path)
    out = {name: observe(lambda: table(name, paths[name]).update({"id": "id + 10"}, "id = 1"))
           for name in PKGS}
    assert metrics(out["torch"]) == metrics(out["jax"])
    got = assert_same_end_state(paths)
    assert sorted((r["id"], r["id2"]) for r in got) == [(2, 4), (11, 22)]


# -- a port MERGE after each port command serves no stale slab or lane --------------


UP, INS = ("update",), ("insert",)


def _merge(name, path, source):
    P = Pkg(name)
    with both_confs(**{"delta.tpu.merge.devicePath.mode": "force"}):
        cmd = P.merge(P.log(path), source, "t.id = s.id", [UP], [INS], source_alias="s",
                      target_alias="t")
    return cmd


@pytest.mark.parametrize("command", ["dv_delete", "dv_update", "rw_delete", "rw_update",
                                     "dv_update_key"])
def test_merge_after_each_command_serves_no_stale_slab_or_lane(tmp_path, command):
    """MERGE (cold slab), the command, then MERGE again: the DV commands
    advance the resident slab (the old rows killed, UPDATE's new rows
    appended, the key column itself moved), the rewrites bump both epochs
    and rebuild it. The end state equals the JAX package's."""
    dv = command.startswith("dv")
    run = {"dv_delete": lambda t: t.delete("id % 3 = 0"),
           "rw_delete": lambda t: t.delete("id % 3 = 0"),
           "dv_update": lambda t: t.update({"value": "'u'"}, "id < 40"),
           "rw_update": lambda t: t.update({"value": "'u'"}, "id < 40"),
           "dv_update_key": lambda t: t.update({"id": "id + 1000"}, "id >= 90")}[command]
    src = str(tmp_path / "src")
    create(src, _ids(100), DV_PROPS if dv else None)
    append(src, _ids(50, start=100))
    paths = copies(src, tmp_path)
    first = {"id": [1, 2, 500], "value": ["m1", "m2", "m500"]}
    after = {"id": [3, 4, 5, 93, 1093, 120, 700], "value": ["a", "b", "c", "d", "e", "f", "g"]}
    routes = {}
    for name in PKGS:
        _merge(name, paths[name], first)
        t = table(name, paths[name])
        if name == "torch":
            lanes, slabs = ColumnCache.instance(), KeyCache.instance()
            with both_confs(**{"delta.tpu.read.deviceResidual.mode": "force"}):
                assert t.to_table(filters=["value = 'v7'"]).num_rows == 1
            e_lanes, e_slabs = lanes.epoch(t.delta_log.log_path), slabs.epoch(t.delta_log.log_path)
        run(t)
        if name == "torch":
            bumped = 0 if dv else 1
            assert lanes.epoch(t.delta_log.log_path) == e_lanes + bumped
            assert slabs.epoch(t.delta_log.log_path) == e_slabs + bumped
            with both_confs(**{"delta.tpu.read.deviceResidual.mode": "force"}):
                got = rows("torch", paths["torch"], filters=["value = 'v7'"])
            # the JAX package's copy ran the same command just before
            assert got == rows("jax", paths["jax"], filters=["value = 'v7'"])
        routes[name] = _merge(name, paths[name], after)._join_path
    assert routes["torch"] == ("resident" if dv else "device-cold")
    assert routes["torch"] == routes["jax"]
    assert_same_end_state(paths)


# -- no kernel failure becomes a quiet host path ----------------------------------------


def _raise(*args, **kwargs):
    raise RuntimeError("injected kernel failure")


@pytest.mark.parametrize("kernel", ["k1", "k15"])
@pytest.mark.parametrize("command", ["delete", "update"])
def test_planning_kernel_failure_propagates_out_of_dml(tmp_path, monkeypatch, command, kernel):
    """The kernels of DELETE's and UPDATE's ``files_for_scan``: K1 on the
    resident lanes (an exact predicate under ``devicePlan.mode=force``),
    K15 where the planner declines a strict one. A raising kernel fails
    the command and nothing commits."""
    from delta_tpu_torch.expr import device_eval
    from delta_tpu_torch.ops import pruning

    src = str(tmp_path / "src")
    create(src, _ids(100), DV_PROPS)
    t = table("torch", src)
    if kernel == "k1":
        monkeypatch.setattr(state_cache, "block_cull", _raise)
        cond = "id <= 9"
    else:
        monkeypatch.setattr(pruning, "DEVICE_PRUNING_MIN_FILES", 1)
        monkeypatch.setattr(device_eval, "expr_eval", _raise)
        cond = "id < 10"
    with both_confs(**{"delta.tpu.stateCache.devicePlan.mode": "force"}):
        with pytest.raises(RuntimeError, match="injected"):
            if command == "delete":
                t.delete(cond)
            else:
                t.update({"value": "'x'"}, cond)
    assert t.version == 0


@pytest.mark.parametrize("wrapper", ["slab_advance", "slab_probe"])
def test_kernel_failure_in_the_merge_after_a_dv_delete_propagates(tmp_path, monkeypatch,
                                                                   wrapper):
    src = str(tmp_path / "src")
    create(src, _ids(100), DV_PROPS)
    _merge("torch", src, {"id": [1, 500], "value": ["a", "b"]})
    t = table("torch", src)
    t.delete("id < 10")
    monkeypatch.setattr(key_cache, wrapper, _raise)
    with pytest.raises(RuntimeError, match="injected"):
        _merge("torch", src, {"id": [20, 600], "value": ["c", "d"]})
    assert t.version == 2


def test_residual_failure_propagates_out_of_a_time_travel_read(tmp_path, monkeypatch):
    src = str(tmp_path / "src")
    create(src, _ids(100))
    t = table("torch", src)
    t.delete("id < 10")
    monkeypatch.setattr(column_cache, "residual_masks", _raise)
    with both_confs(**{"delta.tpu.read.deviceResidual.mode": "force"}):
        with pytest.raises(RuntimeError, match="injected"):
            t.to_table(filters=["value = 'v3'"], version=0)


def test_dml_commit_counts_match_on_a_multi_file_table(tmp_path):
    """Several files, a predicate that touches some, skips others through the
    stats and kills one whole: DV and rewrite paths."""
    for dv in (True, False):
        def build(s):
            create(s, _ids(30), DV_PROPS if dv else None)
            for k in range(1, 4):
                append(s, _ids(30, start=k * 100))

        paths, out = _run_both(tmp_path / str(dv), build,
                               lambda t: t.delete("id >= 310 OR id < 5 OR id = 105"))
        assert metrics(out["torch"]) == metrics(out["jax"])
        assert out["torch"]["numRemovedFiles"] == 3
        assert last_commit_counts(paths["torch"]) == last_commit_counts(paths["jax"])
        assert_same_end_state(paths)

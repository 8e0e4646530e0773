"""The port's ``DeltaTable`` API against ``delta_tpu``'s on the CPU: the
non-SQL, non-constraint cases of ``tests/test_api.py`` (for_path and
is_delta_table, create-write-read, DELETE/UPDATE, the fluent MERGE builder,
time travel, OPTIMIZE, the protocol upgrade, ALTER's properties and
columns, plan_queries and its refusal of a flat filter list), each run by
both packages in directories of their own (``tests/torch_api_tables.both``):
rows, versions, files, metadata, protocol, commits, metrics and every
error's class and message must be exactly equal.

Also here: the ``path@v`` / ``path@yyyyMMddHHmmssSSS`` handles (reads at the
pinned version, each of the nine mutating calls refused), and
``plan_queries`` on a 3,000-file table against ``delta_tpu``'s plans, on one
device and on an 8-entry CPU mesh (the JAX package's 8-device test mesh),
with the per-query fallbacks and their counters.
"""
import datetime as dt
import os

import pytest

from delta_tpu_torch.utils import telemetry as torch_tel
from tests.torch_api_tables import P, both, fresh, observe, state
from tests.torch_port_tables import both_confs, point_queries, write_table

ID_V = (("id", "LongType"), ("v", "LongType"))


def make_table(p, path, data=None):
    t = p.create(path, p.schema(*ID_V))
    if data:
        t.write(p.table(data))
    return t


def _for_path_and_is_delta_table(p, root):
    path = os.path.join(root, "t")
    before = (observe(lambda: p.for_path(path)), p.is_delta_table(path))
    make_table(p, path)
    return before, p.is_delta_table(path), p.for_path(path).version


def _create_write_read_roundtrip(p, root):
    path = os.path.join(root, "t")
    t = make_table(p, path, {"id": [1, 2], "v": [10, 20]})
    return (p.read(t, filters=["v > 15"]), [f.name for f in t.schema().fields],
            t.write(p.table({"id": [3], "v": [30]}), mode="append"), state(path))


def _delete_update_via_api(p, root):
    path = os.path.join(root, "t")
    t = make_table(p, path, {"id": [1, 2, 3], "v": [1, 2, 3]})
    u = t.update({"v": "v * 10"}, condition="id = 2")
    m = t.delete("id = 3")
    return strip_times(u), strip_times(m), p.read(t), state(path)


def strip_times(m):
    return {k: v for k, v in m.items() if not k.endswith("TimeMs")}


def _merge_builder_fluent(p, root):
    path = os.path.join(root, "t")
    t = make_table(p, path, {"id": [1, 2], "v": [1, 2]}).alias("t")
    metrics = (t.merge(p.table({"id": [2, 3], "v": [20, 30]}), "t.id = s.id", source_alias="s")
               .when_matched_update(set={"v": "s.v"})
               .when_not_matched_insert_all()
               .execute())
    return strip_times(metrics), p.read(t), state(path)


def _merge_builder_every_clause_in_order(p, root):
    path = os.path.join(root, "t")
    t = make_table(p, path, {"id": [1, 2, 3, 4], "v": [1, 2, 3, 4]}).alias("t")
    src = p.table({"id": [1, 2, 3, 5, 6], "v": [10, 20, 30, 50, 60]})
    metrics = (t.merge(src, "t.id = s.id", source_alias="s")
               .when_matched_delete("s.v = 10")
               .when_matched_update({"v": "s.v + 1"}, "s.v = 20")
               .when_matched_update_all()
               .when_not_matched_insert({"id": "s.id", "v": "s.v * 2"}, "s.id = 5")
               .when_not_matched_insert_all()
               .execute())
    bad = observe(lambda: t.merge(src, "t.id = s.id", source_alias="s")
                  .when_matched_update_all().when_matched_delete().execute())
    return strip_times(metrics), p.read(t), bad, state(path)


def _time_travel_via_api(p, root):
    path = os.path.join(root, "t")
    t = make_table(p, path, {"id": [1], "v": [1]})
    t.write(p.table({"id": [2], "v": [2]}))
    return (p.read(t, version=1), p.read(t, version=2), p.read(t, version=0),
            observe(lambda: p.read(t, version=9)))


def _optimize_builder(p, root):
    path = os.path.join(root, "t")
    t = make_table(p, path)
    for i in range(3):
        t.write(p.table({"id": [i], "v": [i]}))
    m = t.optimize().execute_compaction()
    return m["numRemovedFiles"], m["numAddedFiles"], state(path)


def _upgrade_protocol(p, root):
    path = os.path.join(root, "t")
    t = make_table(p, path)
    t.upgrade_table_protocol(1, 3)
    v = t.delta_log.update().version
    t.upgrade_table_protocol(1, 2)  # already there: no commit
    return (v, t.delta_log.update().version, observe(lambda: t.upgrade_table_protocol(2, 1)),
            state(path))


def _alter_properties(p, root):
    path = os.path.join(root, "t")
    t = make_table(p, path)
    p.alter.set_table_properties(t.delta_log, {"delta.appendOnly": "true"})
    set_ = t.detail()["properties"]
    missing = observe(lambda: p.alter.unset_table_properties(t.delta_log, ["nope"]))
    p.alter.unset_table_properties(t.delta_log, ["nope"], if_exists=True)
    p.alter.unset_table_properties(t.delta_log, ["DELTA.APPENDONLY"])
    return set_, missing, t.detail()["properties"], state(path)


def _alter_append_only_enforced(p, root):
    path = os.path.join(root, "t")
    t = make_table(p, path, {"id": [1], "v": [1]})
    p.alter.set_table_properties(t.delta_log, {"delta.appendOnly": "true"})
    err = observe(lambda: t.delete("id = 1"))
    t.write(p.table({"id": [2], "v": [2]}))
    return err[:2], p.read(t), state(path)


def _alter_add_columns(p, root):
    path = os.path.join(root, "t")
    t = make_table(p, path, {"id": [1], "v": [1]})
    p.alter.add_columns(t.delta_log, [p.types.StructField("extra", p.types.StringType())])
    return ([f.name for f in t.schema().fields], p.read(t),
            observe(lambda: p.alter.add_columns(
                t.delta_log, [p.types.StructField("id", p.types.StringType())])),
            observe(lambda: p.alter.add_columns(
                t.delta_log, [p.types.StructField("x", p.types.StringType(), False)])),
            state(path))


def _alter_add_columns_first_and_after(p, root):
    path = os.path.join(root, "t")
    t = make_table(p, path, {"id": [1], "v": [1]})
    S = p.types.StructField
    p.alter.add_columns(t.delta_log, [S("front", p.types.StringType())],
                        positions={"front": "first"})
    p.alter.add_columns(t.delta_log, [S("mid", p.types.StringType())],
                        positions={"mid": ("after", "id")})
    bad = observe(lambda: p.alter.add_columns(t.delta_log, [S("z", p.types.StringType())],
                                              positions={"z": ("after", "nope")}))
    worse = observe(lambda: p.alter.add_columns(t.delta_log, [S("z", p.types.StringType())],
                                                positions={"z": "last"}))
    return [f.name for f in t.schema().fields], p.read(t), bad, worse, state(path)


def _alter_add_nested_column(p, root):
    path = os.path.join(root, "t")
    T = p.types
    t = p.create(path, p.schema(("id", "IntegerType"), ("s", p.schema(("x", "IntegerType")))))
    p.alter.add_columns(t.delta_log, [T.StructField("s.y", T.StringType())])
    first = [f.name for f in t.schema()["s"].data_type.fields]
    p.alter.add_columns(t.delta_log, [T.StructField("s.z", T.StringType())],
                        positions={"s.z": "first"})
    not_struct = observe(lambda: p.alter.add_columns(
        t.delta_log, [T.StructField("id.q", T.StringType())]))
    return first, [f.name for f in t.schema()["s"].data_type.fields], not_struct, state(path)


def _alter_change_nested_column_comment(p, root):
    path = os.path.join(root, "t")
    t = p.create(path, p.schema(("s", p.schema(("x", "IntegerType"))), ("id", "IntegerType")))
    p.alter.change_column(t.delta_log, "s.x", new_type=p.types.LongType(), comment="widened")
    x = t.schema()["s"].data_type["x"]
    return (x.data_type.simple_string(), x.metadata["comment"],
            observe(lambda: p.alter.change_column(t.delta_log, "s.nope", comment="c")),
            observe(lambda: p.alter.change_column(t.delta_log, "id", nullable=False)),
            state(path))


def _alter_change_column_position_move(p, root):
    path = os.path.join(root, "t")
    t = make_table(p, path, {"id": [1], "v": [2]})
    p.alter.change_column(t.delta_log, "v", position="first")
    first = [f.name for f in t.schema().fields]
    p.alter.change_column(t.delta_log, "v", position=("after", "id"))
    return first, [f.name for f in t.schema().fields], p.read(t), state(path)


def _alter_change_column_move_sole_column_is_noop(p, root):
    path = os.path.join(root, "t")
    t = p.create(path, p.schema(("only", "IntegerType")))
    p.alter.change_column(t.delta_log, "only", position="first")
    return [f.name for f in t.schema().fields], state(path)


def _alter_add_column_inside_array_element(p, root):
    path = os.path.join(root, "t")
    T = p.types
    t = p.create(path, p.schema(("id", "IntegerType"),
                                ("arr", T.ArrayType(p.schema(("x", "IntegerType"))))))
    p.alter.add_columns(t.delta_log, [T.StructField("arr.element.y", T.StringType())])
    hint = observe(lambda: p.alter.add_columns(t.delta_log,
                                               [T.StructField("arr.z", T.StringType())]))
    return [f.name for f in t.schema()["arr"].data_type.element_type.fields], hint, state(path)


def _alter_change_column_widen(p, root):
    path = os.path.join(root, "t")
    t = p.create(path, p.schema(("id", "IntegerType")))
    t.write(p.table({"id": ("int32", [1])}))
    p.alter.change_column(t.delta_log, "id", new_type=p.types.LongType())
    narrowed = observe(lambda: p.alter.change_column(t.delta_log, "id",
                                                     new_type=p.types.IntegerType()))
    t.write(p.table({"id": [2**40]}))
    return t.schema()["id"].data_type.simple_string(), narrowed, p.read(t), state(path)


def _plan_queries_batch(p, root):
    path = os.path.join(root, "t")
    for i in range(4):
        p.write(path, {"id": list(range(i * 10, (i + 1) * 10))})
    plans = p.for_path(path).plan_queries([["id = 5"], ["id >= 20 AND id <= 39"], [],
                                           ["id = 5 OR id = 35"], ["id % 2 = 0"]], k=2)
    return [(pl.count, pl.overflow, len(pl.paths)) for pl in plans]


def _plan_queries_rejects_flat_filter_list(p, root):
    path = os.path.join(root, "t")
    p.write(path, {"id": list(range(5))})
    return p.for_path(path).plan_queries(["id = 5"])


def _path_time_travel_handles(p, root):
    path = os.path.join(root, "t")
    t = make_table(p, path, {"id": [1], "v": [1]})
    t.write(p.table({"id": [2], "v": [2]}))
    v1_ms = int(os.path.getmtime(os.path.join(path, "_delta_log", "%020d.json" % 1)) * 1000)
    stamp = dt.datetime.fromtimestamp(v1_ms / 1000, dt.timezone.utc).strftime(
        "%Y%m%d%H%M%S%f")[:17]  # version 1's commit time, a UTC wall clock to the ms
    at1 = p.for_path(path + "@v1")
    pinned_ts = p.for_path(path + "@" + stamp)
    literal = os.path.join(root, "lit@v0")
    make_table(p, literal, {"id": [7], "v": [7]})  # a directory named like a handle wins
    return (p.read(at1), at1.version, p.read(at1, version=2), p.read(pinned_ts),
            p.read(at1.alias("a")), p.read(p.for_path(literal)),
            observe(lambda: p.for_path(path + "@v9").version),
            observe(lambda: p.for_path(os.path.join(root, "none@v1"))))


CASES = [
    _for_path_and_is_delta_table, _create_write_read_roundtrip, _delete_update_via_api,
    _merge_builder_fluent, _merge_builder_every_clause_in_order, _time_travel_via_api,
    _optimize_builder, _upgrade_protocol, _alter_properties, _alter_append_only_enforced,
    _alter_add_columns, _alter_add_columns_first_and_after, _alter_add_nested_column,
    _alter_change_nested_column_comment, _alter_change_column_position_move,
    _alter_change_column_move_sole_column_is_noop, _alter_add_column_inside_array_element,
    _alter_change_column_widen, _plan_queries_batch, _plan_queries_rejects_flat_filter_list,
    _path_time_travel_handles,
]

RAISES = {"_plan_queries_rejects_flat_filter_list": "DeltaIllegalArgumentError"}


@pytest.mark.parametrize("case", CASES, ids=[c.__name__.lstrip("_") for c in CASES])
def test_api_matches_jax(tmp_path, case):
    got = both(tmp_path, case)
    want = RAISES.get(case.__name__)
    if want is None:
        assert not (isinstance(got, tuple) and got[:1] == ("raises",)), got
    else:
        assert got[:2] == ("raises", want), got


# -- pinned handles ---------------------------------------------------------------------

MUTATING = {
    "write": lambda p, t: t.write(p.table({"id": [9], "v": [9]})),
    "delete": lambda p, t: t.delete("id = 1"),
    "update": lambda p, t: t.update({"v": "v + 1"}),
    "merge": lambda p, t: t.merge(p.table({"id": [1], "v": [5]}), "id = id"),
    "vacuum": lambda p, t: t.vacuum(),
    "restore_to_version": lambda p, t: t.restore_to_version(0),
    "restore_to_timestamp": lambda p, t: t.restore_to_timestamp("2024-01-01"),
    "optimize": lambda p, t: t.optimize(),
    "upgrade_table_protocol": lambda p, t: t.upgrade_table_protocol(1, 3),
}


@pytest.mark.parametrize("call", sorted(MUTATING))
def test_pinned_handle_refuses_mutation(tmp_path, call):
    def case(p, root):
        path = os.path.join(root, "t")
        make_table(p, path, {"id": [1], "v": [1]})
        pinned = p.for_path(path + "@v1")
        err = observe(lambda: MUTATING[call](p, pinned))
        return err, state(path)

    got = both(tmp_path, case)
    assert got[0][:2] == ("raises", "DeltaAnalysisError")
    assert "time-travelled table handle" in got[0][2] and got[1]["version"] == 1


# -- plan_queries on a resident table -----------------------------------------------------


def _plans(p, path, queries, k):
    return [(pl.paths, pl.count, pl.overflow, pl.via)
            for pl in p.for_path(path).plan_queries(queries, k=k)]


@pytest.mark.parametrize("layout", ["one_device", "mesh8"])
def test_plan_queries_match_jax_plans(tmp_path, layout, monkeypatch):
    """A 3,000-file table's 64 point queries, an OR, a range, a verdict, a
    query that does not lower (IS NULL), an empty one and two filters: one
    plan_ranges call for the batch, each plan equal to the JAX package's
    (paths in order, count, overflow, route)."""
    import contextlib

    from delta_tpu_torch.ops.state_cache import ResidentState
    from delta_tpu_torch.parallel import mesh

    path = str(tmp_path / "t")
    st = write_table(path, n_files=3000)
    queries = [[q] for q in point_queries(st, 64)]
    queries += [["c0 < 9000 OR c0 > 4190000"], ["c0 >= 100 AND c0 <= 50000"],
                ["c0 % 3 = 1"], ["c0 IS NULL"], [], ["c0 = 5", "c1 > 2.5"]]
    keys = {"delta.tpu.stateCache.devicePlan.mode": "force"}
    if layout == "mesh8":
        keys["delta.tpu.distributed.plan.mode"] = "force"
        placed = mesh.using_devices(["cpu"] * 8)
    else:
        keys["delta.tpu.distributed.plan.enabled"] = False
        placed = contextlib.nullcontext()
    calls = []
    real = ResidentState.plan_ranges

    def counted(self, ranges, *a, **kw):
        calls.append(len(ranges))
        return real(self, ranges, *a, **kw)

    fresh()
    with both_confs(**keys), placed:
        want = _plans(P("jax"), path, queries, 16)
        torch_tel.clear_counters()
        monkeypatch.setattr(ResidentState, "plan_ranges", counted)
        got = _plans(P("torch"), path, queries, 16)
    fresh()
    assert got == want
    assert len(calls) == 1  # one plan for the whole batch
    assert {pl[3] for pl in got[:64]} == ({"device-sharded"} if layout == "mesh8"
                                          else {"device"})
    assert torch_tel.counters("stateCache.plan") == {
        "stateCache.plan.resident": 68, "stateCache.plan.fallback.lowering": 1}
    assert any(pl[2] for pl in got)  # some query overflows k


def test_plan_queries_fall_back_where_the_entry_moved_on(tmp_path, monkeypatch):
    """A batch whose resident entry advanced past the snapshot
    (``plan_ranges`` gives None) and a snapshot older than the entry both
    plan query by query through files_for_scan, as the JAX package's."""
    from delta_tpu.ops.state_cache import ResidentState as JaxResident
    from delta_tpu_torch.ops.state_cache import ResidentState

    path = str(tmp_path / "t")
    st = write_table(path, n_files=500)
    queries = [[q] for q in point_queries(st, 8)]
    fresh()
    torch_tel.clear_counters()
    with monkeypatch.context() as m:
        m.setattr(JaxResident, "plan_ranges", lambda self, *a, **kw: None)
        m.setattr(ResidentState, "plan_ranges", lambda self, *a, **kw: None)
        want = _plans(P("jax"), path, queries, 4)
        got = _plans(P("torch"), path, queries, 4)
    assert got == want and {g[3] for g in got} == {"scan"}
    assert torch_tel.counters("stateCache.plan") == {"stateCache.plan.fallback.version": 8}
    # a snapshot older than the entry: no entry, every query falls back
    fresh()
    P("torch").for_path(path).plan_queries(queries)  # the entry at the latest version
    P("jax").for_path(path).plan_queries(queries)
    torch_tel.clear_counters()
    got = _plans(P("torch"), path + "@v1", queries, 4)
    assert got == _plans(P("jax"), path + "@v1", queries, 4)
    assert torch_tel.counters("stateCache.plan") == {"stateCache.plan.fallback.noentry": 8}
    fresh()

"""The port's MERGE (``delta_tpu_torch.commands.merge``) against
``delta_tpu``'s on the CPU: every case of ``tests/test_merge_matrix.py``,
under both executors (the device routes forced, ``devicePath.mode=force``,
and the host join, ``off``). Each case builds the same target and source
in both packages, each with its own writer, runs the same MERGE and
compares the sorted end-state rows, ``cmd.metrics`` without the
``*TimeMs`` keys, ``cmd._join_path`` and, for the error cases, the
exception class. Schema evolution and generated columns run as parity
cases too (tests/test_torch_schema_evolution.py and
test_torch_generated.py hold the rest of them). Exact throughout."""
import datetime as dt
import math

import numpy as np
import pytest

from tests.torch_port_tables import Pkg, both_confs, metrics, observe, reset_caches

ALIAS = dict(source_alias="s", target_alias="t")
UP = ("update",)
INS = ("insert",)
DEL = ("delete",)


@pytest.fixture(autouse=True)
def _fresh():
    reset_caches()
    yield
    reset_caches()


@pytest.fixture(params=["device", "host"])
def executor(request):
    mode = "force" if request.param == "device" else "off"
    with both_confs(**{"delta.tpu.merge.devicePath.mode": mode}):
        yield request.param


def run_case(P, path, target, steps):
    """Write ``target``, run each (source, cond, matched, not_matched) merge;
    the observations: per merge (metrics, route) or the error class, then
    the end-state rows."""
    log = P.write(path, target)
    out = []
    for source, cond, matched, not_matched in steps:
        src = source(P, log) if callable(source) else source
        cmd = observe(lambda: P.merge(log, src, cond, matched, not_matched, **ALIAS))
        out.append(cmd if isinstance(cmd, str) else (metrics(cmd), cmd._join_path))
    out.append(P.rows(log))
    return out


def assert_same(tmp_path, target, steps):
    got = run_case(Pkg("torch"), str(tmp_path / "torch"), target, steps)
    want = run_case(Pkg("jax"), str(tmp_path / "jax"), target, steps)
    assert got == want
    return got


T_IDV = {"id": [1, 2, 3], "v": [10, 20, 30]}

#: name -> (target, [(source, condition, matched clauses, not-matched clauses)])
CASES = {
    "update_only": (T_IDV, [({"id": [2, 4], "v": [99, 99]}, "t.id = s.id", [UP], [])]),
    "insert_only": ({"id": [1, 2], "v": [10, 20]},
                    [({"id": [2, 3], "v": [0, 30]}, "t.id = s.id", [], [INS])]),
    "delete_only": (T_IDV, [({"id": [1, 3]}, "t.id = s.id", [DEL], [])]),
    "upsert_update_and_insert": ({"id": [1, 2], "v": [10, 20]},
                                 [({"id": [2, 3], "v": [21, 31]}, "t.id = s.id", [UP], [INS])]),
    "update_delete_insert_three_clauses": (
        T_IDV, [({"id": [1, 2, 4], "v": [-1, 99, 40]}, "t.id = s.id",
                 [("delete", "s.v < 0"), UP], [INS])]),
    "empty_source_is_noop": ({"id": [1], "v": [10]},
                             [({"id": ("int64", []), "v": ("int64", [])}, "t.id = s.id",
                               [UP], [INS])]),
    "empty_target_inserts_all": ({"id": ("int64", []), "v": ("int64", [])},
                                 [({"id": [1, 2], "v": [10, 20]}, "t.id = s.id", [UP], [INS])]),
    "matched_condition_references_both_sides": (
        {"id": [1, 2], "v": [10, 20]},
        [({"id": [1, 2], "v": [5, 50]}, "t.id = s.id", [("update", "s.v > t.v")], [])]),
    "matched_clause_order_first_wins": (
        {"id": [1, 2], "v": [10, 20]},
        [({"id": [1, 2], "v": [100, 200]}, "t.id = s.id",
          [("update", "t.v = 10", {"v": "s.v + 1"}), ("update", None, {"v": "s.v + 2"})], [])]),
    "conditional_insert": ({"id": [1], "v": [10]},
                           [({"id": [2, 3], "v": [20, 30]}, "t.id = s.id", [],
                             [("insert", "s.v > 25")])]),
    "update_expression_uses_both_sides": (
        {"id": [1, 2], "v": [10, 20]},
        [({"id": [1, 2], "v": [1, 2]}, "t.id = s.id", [("update", None, {"v": "t.v + s.v"})],
          [])]),
    "null_source_keys_insert_not_update": (
        {"id": [1, 2], "v": [10, 20]},
        [({"id": [1, None], "v": [100, 999]}, "t.id = s.id", [UP], [INS])]),
    "null_target_keys_never_match": (
        {"id": [None, 2], "v": [0, 20]},
        [({"id": [2, 3], "v": [21, 31]}, "t.id = s.id", [UP], [INS])]),
    "null_never_matches_null": ({"id": ("int64", [None]), "v": [0]},
                                [({"id": ("int64", [None]), "v": [99]}, "t.id = s.id",
                                  [UP], [INS])]),
    "star_with_reordered_source_columns": (
        {"id": [1], "v": [10], "w": [5]},
        [({"w": [50], "v": [100], "id": [1]}, "t.id = s.id", [UP], [INS])]),
    "star_missing_source_column_errors_without_evolution": (
        {"id": [1], "v": [10], "w": [5]},
        [({"id": [1], "v": [100]}, "t.id = s.id", [UP], [])]),
    "star_extra_source_column_ignored_without_evolution": (
        {"id": [1], "v": [10]},
        [({"id": [1, 2], "v": [100, 200], "extra": [7, 8]}, "t.id = s.id", [UP], [INS])]),
    "explicit_assignments_ignore_extra_source_columns": (
        {"id": [1], "v": [10]},
        [({"id": [1, 2], "v": [100, 200], "extra": [7, 8]}, "t.id = s.id",
          [("update", None, {"v": "s.v"})],
          [("insert", None, {"id": "s.id", "v": "s.extra"})])]),
    "case_insensitive_column_resolution": (
        {"id": [1, 2], "Value": [10, 20]},
        [({"ID": [2, 3], "VALUE": [21, 31]}, "t.id = s.ID", [UP], [INS])]),
    "evolution_off_is_default_schema_unchanged": (
        {"id": [1], "v": [10]},
        [({"id": [1], "v": [100], "extra": [1]}, "t.id = s.id", [UP], [])]),
    "self_merge_dedupe_pattern": (
        {"id": [1, 2], "v": [10, 20]},
        [(lambda P, log: P.scan(log), "t.id = s.id", [UP], [INS])]),
    "multi_match_update_errors": ({"id": [1], "v": [10]},
                                  [({"id": [1, 1], "v": [1, 2]}, "t.id = s.id", [UP], [])]),
    "multi_match_single_unconditional_delete_ok": (
        {"id": [1, 2], "v": [10, 20]}, [({"id": [1, 1], "v": [0, 0]}, "t.id = s.id", [DEL], [])]),
    "multi_match_insert_only_is_duplicate_insensitive": (
        {"id": [1], "v": [10]}, [({"id": [1, 1, 2], "v": [0, 0, 20]}, "t.id = s.id", [], [INS])]),
    "key_expression_on_source_side": ({"id": [5, 6], "v": [10, 20]},
                                      [({"id": [4], "v": [99]}, "t.id = s.id + 1", [UP], [])]),
    "unknown_qualifier_errors": ({"id": [1], "v": [10]},
                                 [({"id": [1], "v": [2]}, "x.id = s.id", [UP], [])]),
    "composite_key_with_nulls": (
        {"a": [1, 1, None], "b": [1, 2, 3], "v": [10, 20, 30]},
        [({"a": [1, None], "b": [2, 3], "v": [99, 98]}, "t.a = s.a AND t.b = s.b", [UP], [INS])]),
    "matched_only_merge_never_inserts": ({"id": [1], "v": [10]},
                                         [({"id": [1, 9], "v": [11, 90]}, "t.id = s.id", [UP],
                                           [])]),
    "insert_only_merge_never_updates": ({"id": [1], "v": [10]},
                                        [({"id": [1, 9], "v": [11, 90]}, "t.id = s.id", [],
                                          [INS])]),
    "non_equi_merge_small": (
        {"k": list(range(100)), "v": [0.0] * 100},
        [({"lo": [10, 50], "hi": [13, 52], "nv": [1.0, 2.0]}, "t.k >= s.lo AND t.k < s.hi",
          [("update", None, {"v": "s.nv"})], [])]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_merge_matrix_matches_jax(case, tmp_path, executor):
    target, steps = CASES[case]
    got = assert_same(tmp_path, target, steps)
    if case.endswith("_errors"):
        assert isinstance(got[0], str)


def test_clause_validation_matches_jax(tmp_path):
    """Only the last clause of a group may omit its condition; invalid
    clause kinds and duplicate SET columns are refused at construction."""
    bad = [([UP, DEL], []), ([INS], []), ([], [UP]),
           ([("update", None, {"v": "s.v", "V": "s.v"})], [])]
    for matched, not_matched in bad:
        errs = []
        for P in (Pkg("torch"), Pkg("jax")):
            log = P.write(str(tmp_path / P.name / str(len(errs))), {"id": [1], "v": [10]})
            errs.append(observe(lambda: P.command(log, {"id": [1], "v": [1]}, "t.id = s.id",
                                                  matched, not_matched, **ALIAS)))
        assert errs[0] == errs[1] == "DeltaAnalysisError"


def test_non_equi_merge_beyond_pair_budget(tmp_path, executor):
    """test_merge_matrix's 60M-pair case cut to 3M candidate pairs through
    tiles of 200,000 (the budget), against the per-row oracle."""
    n, m = 3_000, 1_000
    lo = np.arange(m, dtype=np.int64) * 3
    source = {"lo": lo.tolist(), "hi": (lo + 2).tolist(),
              "nv": (np.arange(m, dtype=np.float64) + 1).tolist()}
    steps = [(source, "t.k >= s.lo AND t.k < s.hi", [("update", None, {"v": "s.nv"})], [])]
    with both_confs(**{"delta.tpu.merge.nonEquiPairBudget": "200000"}):
        got = assert_same(tmp_path, {"k": list(range(n)), "v": [0.0] * n}, steps)
    d = {r["k"]: r["v"] for r in got[-1]}
    for k in range(0, n, 7):
        i, r = divmod(k, 3)
        assert d[k] == (float(i + 1) if r < 2 and i < m else 0.0)


def test_evolution_requires_star_clause(tmp_path, executor):
    """Explicit assignments never migrate the schema, even with the conf
    on: both packages merge and keep the schema."""
    steps = [({"id": [1], "v": [100], "extra": [1]}, "t.id = s.id",
              [("update", None, {"v": "s.v"})], [])]
    with both_confs(**{"delta.tpu.schema.autoMerge.enabled": True}):
        assert_same(tmp_path, {"id": [1], "v": [10]}, steps)


@pytest.mark.parametrize("matched,not_matched", [([UP], [INS]), ([UP], []), ([], [INS])])
def test_schema_evolution_is_not_ported(tmp_path, executor, matched, not_matched):
    """test_merge_matrix's evolution cases (a star clause with autoMerge
    on): both packages evolve the schema to take ``extra`` and give the same
    rows, metrics and route. (The port refused these before schema
    evolution was ported; the name is kept.)"""
    steps = [({"id": [2, 3], "v": [21, 31], "extra": ["a", "b"]}, "t.id = s.id", matched,
              not_matched)]
    with both_confs(**{"delta.tpu.schema.autoMerge.enabled": True}):
        got = assert_same(tmp_path, {"id": [1, 2], "v": [10, 20]}, steps)
    assert all("extra" in r for r in got[-1])


def test_generated_columns_are_not_ported(tmp_path, executor):
    """test_evolution_cannot_retype_generated_column's table (a generated
    column, written by delta_tpu), copied once a package: a MERGE that
    provides the generated column's right value merges in both, one that
    would retype it under autoMerge fails in both with the same class.
    (The port refused the table before generated columns were ported; the
    name is kept.)"""
    import shutil

    from delta_tpu.api.tables import DeltaTable
    from delta_tpu.schema.generated import generated_field
    from delta_tpu.schema.types import LongType, StructType

    path = str(tmp_path / "gen")
    schema = StructType().add("id", LongType()).add_field(
        generated_field("twice", LongType(), "id + id"))
    DeltaTable.create(path, schema).write({"id": [1]})
    out = {}
    for name in ("jax", "torch"):
        copy = str(tmp_path / name)
        shutil.copytree(path, copy)
        P = Pkg(name)
        log = P.log(copy)
        cmd = P.merge(log, {"id": [1, 2], "twice": [2, 4]}, "t.id = s.id", [UP], [INS], **ALIAS)
        with both_confs(**{"delta.tpu.schema.autoMerge.enabled": True}):
            retype = observe(lambda: P.merge(log, {"id": [2], "twice": [4.5]}, "t.id = s.id",
                                             [UP], [INS], **ALIAS))
        out[name] = (metrics(cmd), cmd._join_path, retype, P.rows(log))
    assert out["torch"] == out["jax"]
    assert out["jax"][2] == "DeltaAnalysisError"
    assert out["jax"][3] == [{"id": 1, "twice": 2}, {"id": 2, "twice": 4}]


# -- queue C: a date against a timestamp in a clause condition -----------------------

_DAY = dt.date(2024, 1, 5)
_MIDNIGHT = dt.datetime(2024, 1, 5)


@pytest.mark.parametrize("ts_type", ["timestamp", "timestamp_utc"])
@pytest.mark.parametrize("cond", ["t.d < t.ts", "t.d = t.ts", "t.d >= s.ts"])
def test_date_against_timestamp_clause_condition_matches_jax(tmp_path, executor, ts_type,
                                                             cond):
    """The clause conditions go through the row filter's compare: a date
    against a timestamp compares the date at midnight, as Arrow does."""
    target = {"id": [0, 1, 2, 3],
              "d": ("date", [_DAY, _DAY, _DAY + dt.timedelta(days=1),
                             _DAY - dt.timedelta(days=1)]),
              "ts": (ts_type, [_MIDNIGHT, _MIDNIGHT + dt.timedelta(microseconds=1),
                               _MIDNIGHT, _MIDNIGHT]),
              "v": [0, 0, 0, 0]}
    source = {"id": [0, 1, 2, 3, 4], "v": [9, 9, 9, 9, 9],
              "ts": (ts_type, [_MIDNIGHT] * 5)}
    steps = [(source, "t.id = s.id", [("update", cond, {"v": "s.v"})],
              [("insert", None, {"id": "s.id", "v": "s.v"})])]
    got = assert_same(tmp_path, target, steps)
    updated = {"t.d < t.ts": [1, 3], "t.d = t.ts": [0], "t.d >= s.ts": [0, 1, 2]}[cond]
    assert sorted(r["id"] for r in got[-1] if r["v"] == 9 and r["id"] < 4) == updated


# -- queue C: the reference's answers the port does not copy ------------------------


def test_fractional_literal_in_a_clause_condition_keeps_spark_answer(tmp_path, executor):
    """``t.id IN (1, 2.5)``: Spark (and the port) update id 1; the
    reference truncates 2.5 to 2 and updates ids 1 and 2."""
    steps = [({"id": [0, 1, 2, 3], "v": [9, 9, 9, 9]}, "t.id = s.id",
              [("update", "t.id IN (1, 2.5)")], [])]
    target = {"id": [0, 1, 2, 3], "v": [0, 0, 0, 0]}
    port = run_case(Pkg("torch"), str(tmp_path / "torch"), target, steps)
    ref = run_case(Pkg("jax"), str(tmp_path / "jax"), target, steps)
    assert [r["id"] for r in port[-1] if r["v"] == 9] == [1]
    assert port[0][0]["numTargetRowsUpdated"] == 1
    assert [r["id"] for r in ref[-1] if r["v"] == 9] == [1, 2]
    assert ref[0][0]["numTargetRowsUpdated"] == 2


def test_negative_zero_join_key_keeps_spark_answer(tmp_path, executor):
    """-0.0 joins 0.0 (Spark normalizes -0.0 in join keys): the port updates
    the 0.0 row; the reference's Arrow hash join compares bits and inserts
    a fourth row."""
    target = {"k": [0.0, 1.5, 2.0], "v": [1, 2, 3]}
    steps = [({"k": [-0.0, 2.0], "v": [10, 30]}, "t.k = s.k", [UP], [INS])]
    port = run_case(Pkg("torch"), str(tmp_path / "torch"), target, steps)
    ref = run_case(Pkg("jax"), str(tmp_path / "jax"), target, steps)
    signed = lambda rows: [(math.copysign(1, r["k"]), r["k"], r["v"]) for r in rows]
    assert signed(port[-1]) == [(-1, -0.0, 10), (1, 1.5, 2), (1, 2.0, 30)]
    assert (port[0][0]["numTargetRowsUpdated"], port[0][0]["numTargetRowsInserted"]) == (2, 0)
    assert signed(ref[-1]) == [(-1, -0.0, 10), (1, 0.0, 1), (1, 1.5, 2), (1, 2.0, 30)]
    assert (ref[0][0]["numTargetRowsUpdated"], ref[0][0]["numTargetRowsInserted"]) == (1, 1)

"""The port's generated columns (``delta_tpu_torch.schema.generated``: compute
on write, the check of provided values, the recompute in UPDATE and MERGE,
validation, writer version 4) against ``delta_tpu``'s on the CPU: every case
of ``tests/test_generated.py``, each run once a package in its own directory
(``tests/torch_api_tables.both``). The observation is the table's state
(rows read by both packages, metadata, protocol, commits), the reads and
scans the reference case makes, and every error's class and message,
exactly equal."""
import datetime as dt
import os

import pytest

from tests.torch_api_tables import both, observe
from tests.torch_write_tables import DV, W, state


def gen_schema(p):
    T = p.types
    return (T.StructType().add("id", T.LongType()).add("name", T.StringType())
            .add_field(p.gen("id2", "LongType", "id * 2"))
            .add_field(p.gen("uname", "StringType", "upper(name)")))


def gtable(p, root, **kw):
    path = os.path.join(root, "t")
    return path, p.create(path, gen_schema(p), **kw)


def merge(p, log, src, cond, matched, not_matched):
    m = __import__(f"{'delta_tpu' if p.jax else 'delta_tpu_torch'}.commands.merge",
                   fromlist=["MergeClause"])
    return m.MergeIntoCommand(log, p.table(src), cond, matched and [m.MergeClause(*matched)],
                              not_matched and [m.MergeClause(*not_matched)],
                              source_alias="s", target_alias="t").run()


def _missing_generated_columns_computed(p, root):
    path, t = gtable(p, root)
    t.write({"id": [1, 2], "name": ["a", "b"]})
    return state(path)


def _provided_matching_values_accepted(p, root):
    path, t = gtable(p, root)
    t.write({"id": [3], "name": ["c"], "id2": [6], "uname": ["C"]})
    return state(path)


def _provided_mismatching_values_rejected(p, root):
    path, t = gtable(p, root)
    return [observe(lambda: t.write({"id": [3], "name": ["c"], "id2": [7]})), state(path)]


def _null_inputs_propagate(p, root):
    path, t = gtable(p, root)
    t.write({"id": [5], "name": [None]})
    return state(path)


def _validation_rules(p, root):
    T = p.types

    def check(*fields):
        st = T.StructType().add("id", T.LongType())
        for f in fields:
            st = st.add_field(f)
        # class and message; an unknown function's message names each
        # package's own function table after its first sentence
        got = observe(lambda: p.generated.validate_generated_columns(st))
        return got and got[:2] + (got[2].split(". See ")[0],)

    return [check(p.gen("r", "LongType", "rand(id)")),
            check(p.gen("g", "LongType", "nope + 1")),
            check(p.gen("g1", "LongType", "id + 1"), p.gen("g2", "LongType", "g1 + 1")),
            check(p.gen("g", "LongType", "g + 1")),
            check(p.gen("g", "LongType", "id + 1"))]


def _create_table_validates(p, root):
    path = os.path.join(root, "t")
    T = p.types
    schema = T.StructType().add("id", T.LongType()).add_field(p.gen("g", "LongType", "nope + 1"))
    return [observe(lambda: p.create(path, schema)), os.path.exists(os.path.join(path, "_delta_log"))
            and sorted(os.listdir(os.path.join(path, "_delta_log")))]


def _update_recomputes_generated(p, root):
    path, t = gtable(p, root)
    t.write({"id": [1, 2], "name": ["a", "b"]})
    t.update({"id": "id + 10"}, "name = 'a'")
    return state(path)


def _update_assigning_the_generated_column(p, root):
    path, t = gtable(p, root)
    t.write({"id": [1, 2], "name": ["a", "b"]})
    bad = observe(lambda: t.update({"id2": "id2 + 1"}, "id = 1"))
    t.update({"id2": "id * 2", "name": "'z'"}, "id = 1")
    return bad, state(path)


def _merge_update_recomputes_and_insert_computes(p, root):
    path, t = gtable(p, root)
    t.write({"id": [1, 2], "name": ["a", "b"]})
    merge(p, t.delta_log, {"k": [2, 5], "nm": ["bb", "e"]}, "t.id = s.k",
          ("update", None, {"name": "s.nm"}), ("insert", None, {"id": "s.k", "name": "s.nm"}))
    return state(path)


def _write_omitting_referenced_nullable_base_column(p, root):
    path, t = gtable(p, root)
    t.write({"id": [7]})
    return state(path)


def _generated_partition_column(p, root):
    path = os.path.join(root, "t")
    T = p.types
    schema = T.StructType().add("id", T.LongType()).add_field(p.gen("bucket", "LongType", "id % 3"))
    t = p.create(path, schema, partition_columns=["bucket"])
    t.write({"id": [0, 1, 2, 3, 4, 5]})
    return p.read(t, filters=["bucket = 1"]), state(path)


def _delete_on_generated_table_keeps_values(p, root):
    path, t = gtable(p, root)
    t.write({"id": [1, 2, 3], "name": ["a", "b", "c"]})
    t.delete("id2 = 4")
    return state(path)


def _generated_with_dv_table(p, root):
    path = os.path.join(root, "t")
    T = p.types
    t = p.create(path, T.StructType().add("id", T.LongType())
                 .add_field(p.gen("id2", "LongType", "id * 2")), configuration=DV)
    t.write({"id": [1, 2, 3]})
    t.update({"id": "id + 10"}, "id = 2")
    return state(path)


def _merge_star_with_generated_uses_full_decode(p, root):
    path, t = gtable(p, root, configuration=DV)
    t.write({"id": [1, 2], "name": ["a", "b"]})
    (t.alias("t").merge(p.table({"id": [1, 9], "name": ["A", "n"]}), "t.id = s.id",
                        source_alias="s")
     .when_matched_update_all().when_not_matched_insert_all().execute())
    return state(path)


def _alter_add_generated_column_nulls_old_rows_computes_new(p, root):
    path, t = gtable(p, root)
    t.write({"id": [1], "name": ["a"]})
    p.alter.add_columns(t.delta_log, [p.gen("id3", "LongType", "id * 3")])
    before = p.read(t)
    t.write({"id": [2], "name": ["b"]})
    return before, state(path)


def _generated_column_in_constraint(p, root):
    path, t = gtable(p, root)
    t.write({"id": [1, 2], "name": ["a", "b"]})
    p.alter.add_constraint(t.delta_log, "small", "id2 < 100")
    t.write({"id": [5], "name": ["e"]})
    return [observe(lambda: t.write({"id": [500], "name": ["big"]})), state(path)]


def _timestamp_date_generation(p, root):
    path = os.path.join(root, "t")
    T = p.types
    t = p.create(path, T.StructType().add("ts", T.TimestampType())
                 .add_field(p.gen("d", "DateType", "cast(ts as date)")))
    t.write(p.table({"ts": ("timestamp", [dt.datetime(2024, 5, 1, 12, 30),
                                          dt.datetime(2024, 5, 2, 1, 0)])}))
    return state(path)


def _type_mismatch_of_the_expression(p, root):
    path = os.path.join(root, "t")
    T = p.types
    t = p.create(path, T.StructType().add("x", T.DoubleType())
                 .add_field(p.gen("n", "LongType", "x * 2")))
    ok = t.write({"x": [1.5]})  # 3.0 fits a long
    return ok, [observe(lambda: t.write({"x": [1.25]}))[:2]], state(path)


CASES = [
    _missing_generated_columns_computed, _provided_matching_values_accepted,
    _provided_mismatching_values_rejected, _null_inputs_propagate, _validation_rules,
    _create_table_validates, _update_recomputes_generated, _update_assigning_the_generated_column,
    _merge_update_recomputes_and_insert_computes,
    _write_omitting_referenced_nullable_base_column, _generated_partition_column,
    _delete_on_generated_table_keeps_values, _generated_with_dv_table,
    _merge_star_with_generated_uses_full_decode,
    _alter_add_generated_column_nulls_old_rows_computes_new, _generated_column_in_constraint,
    _timestamp_date_generation, _type_mismatch_of_the_expression,
]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__.lstrip("_") for c in CASES])
def test_generated_columns_match_jax(tmp_path, case):
    got = both(tmp_path, lambda p, root: case(W(p.name), root))
    assert not (isinstance(got, tuple) and got[:1] == ("raises",)), got


def test_generated_column_sets_writer_version_4(tmp_path):
    got = both(tmp_path, lambda p, root: state(gtable(W(p.name), root)[0])["protocol"])
    assert got[:2] == (1, 4)

"""The port's CHECK and NOT NULL constraints (``delta_tpu_torch.schema.
constraints``, ALTER's ``add_constraint``/``drop_constraint``) and the
write-time schema enforcement against ``delta_tpu``'s on the CPU: the
constraint cases of ``tests/test_alter_commands.py`` and every case of
``tests/test_schema_enforcement.py`` and the char/varchar write cases of
``tests/test_datatypes.py``, each run once a package in its own
directory (``tests/torch_api_tables.both``). The observation is the table's
state (rows read by both packages, metadata, protocol: writer version 3 for
a CHECK constraint, every commit's actions) and each error's class and
message, exactly equal."""
import os

import pytest

from tests.torch_api_tables import both, observe
from tests.torch_write_tables import W, state

ID_VALUE = {"id": [1, 2], "value": ["a", "b"]}
NESTED = ("struct", (("x", "int64"), ("y", "string")))


def base(p, root, data=None, **kw):
    path = os.path.join(root, "t")
    return path, p.create(path, data=p.table(data or ID_VALUE), **kw)


def append(p, t, data, **kw):
    return p.write_mod.WriteIntoDelta(t.delta_log, "append", p.table(data), **kw).run()


def overwrite(p, t, data, **kw):
    return p.write_mod.WriteIntoDelta(t.delta_log, "overwrite", p.table(data), **kw).run()


# -- tests/test_alter_commands.py: the constraint cases ------------------------------


def _add_constraint_validates_existing_rows(p, root):
    path, t = base(p, root)
    bad = observe(lambda: p.alter.add_constraint(t.delta_log, "pos", "id > 1"))
    p.alter.add_constraint(t.delta_log, "pos", "id > 0")
    return bad, state(path)


def _constraint_enforced_on_future_writes(p, root):
    path, t = base(p, root)
    p.alter.add_constraint(t.delta_log, "pos", "id > 0")
    err = observe(lambda: append(p, t, {"id": [-5], "value": ["z"]}))
    append(p, t, {"id": [7], "value": ["ok"]})
    return err, state(path)


def _duplicate_constraint_name_rejected(p, root):
    path, t = base(p, root)
    p.alter.add_constraint(t.delta_log, "c1", "id > 0")
    return [observe(lambda: p.alter.add_constraint(t.delta_log, "C1", "id > -1")), state(path)]


def _drop_constraint_lifts_enforcement(p, root):
    path, t = base(p, root)
    p.alter.add_constraint(t.delta_log, "pos", "id > 0")
    p.alter.drop_constraint(t.delta_log, "pos", if_exists=False)
    append(p, t, {"id": [-5], "value": ["z"]})
    return state(path)


def _drop_missing_constraint(p, root):
    path, t = base(p, root)
    err = observe(lambda: p.alter.drop_constraint(t.delta_log, "ghost", if_exists=False))
    p.alter.drop_constraint(t.delta_log, "ghost", if_exists=True)
    return err, state(path)


def _constraint_in_create_and_null_verdict(p, root):
    """A CHECK from the table properties; a NULL verdict violates it."""
    path, t = base(p, root, configuration={"delta.constraints.small": "id < 100"})
    errs = [observe(lambda: append(p, t, {"id": [None], "value": ["n"]})),
            observe(lambda: append(p, t, {"id": [1, 500], "value": ["x", "y"]}))]
    return errs, state(path)


def _constraint_on_update_and_merge(p, root):
    path, t = base(p, root)
    p.alter.add_constraint(t.delta_log, "pos", "id > 0")
    errs = [observe(lambda: t.update({"id": "id - 5"}, "id = 1")),
            observe(lambda: t.alias("t").merge(p.table({"id": [2, 3], "value": ["u", "n"]}),
                                               "t.id = s.id", source_alias="s")
                    .when_matched_update({"id": "s.id - 9"})
                    .when_not_matched_insert_all().execute())]
    t.update({"id": "id + 5"}, "id = 1")
    return errs, state(path)


def _invariant_from_field_metadata(p, root):
    path = os.path.join(root, "t")
    inv = '{"expression": {"expression": "id > 0"}}'
    T = p.types
    schema = T.StructType([T.StructField("id", T.LongType(), True, {"delta.invariants": inv})])
    t = p.create(path, schema)
    return [observe(lambda: append(p, t, {"id": [0]})), state(path)]


# -- tests/test_schema_enforcement.py ----------------------------------------------


def _missing_column_null_filled(p, root):
    path, t = base(p, root)
    append(p, t, {"id": [3]})
    return state(path)


def _extra_column_rejected_with_name_in_error(p, root):
    path, t = base(p, root)
    return [observe(lambda: append(p, t, {"id": [3], "surprise": [1.0]})), state(path)]


def _extra_column_added_with_merge_schema(p, root):
    path, t = base(p, root)
    append(p, t, {"id": [3], "surprise": [1.5]}, merge_schema=True)
    return [f.name for f in t.schema().fields], state(path)


def _reordered_columns_normalized(p, root):
    path, t = base(p, root)
    append(p, t, {"value": ["z"], "id": [9]})
    return state(path)


def _empty_batch_still_schema_checked(p, root):
    path, t = base(p, root)
    return [observe(lambda: append(p, t, {"nope": ("int64", [])}))]


def _case_insensitive_column_match(p, root):
    path, t = base(p, root)
    append(p, t, {"ID": [5], "VALUE": ["c"]})
    return state(path)


def _case_differing_duplicates_rejected(p, root):
    path, t = base(p, root)
    return [observe(lambda: append(p, t, {"id": [1], "ID": [2], "value": ["x"]}))[:2]]


def _narrower_int_upcast_on_write(p, root):
    path, t = base(p, root)
    append(p, t, {"id": ("int32", [7]), "value": ["w"]})
    return state(path)


def _incompatible_type_rejected(p, root):
    path, t = base(p, root)
    return [observe(lambda: append(p, t, {"id": ["not-a-number"], "value": ["x"]}))]


def _float_to_long_lossy_rejected(p, root):
    path, t = base(p, root)
    return [observe(lambda: append(p, t, {"id": [1.5], "value": ["x"]}))]


def _merge_schema_cannot_widen_existing_column(p, root):
    path, t = base(p, root, {"id": ("int32", [1])})
    return [observe(lambda: append(p, t, {"id": [2 ** 40]}, merge_schema=True)), state(path)]


def _alter_widen_then_append_long(p, root):
    path, t = base(p, root, {"id": ("int32", [1])})
    p.alter.change_column(t.delta_log, "id", new_type=p.types.LongType())
    append(p, t, {"id": [2 ** 40]})
    return state(path)


def _merge_schema_conflicting_types_rejected(p, root):
    path, t = base(p, root)
    return [observe(lambda: append(p, t, {"id": [1], "value": [3.14]}, merge_schema=True))[:2]]


def _overwrite_keeps_schema_checks(p, root):
    path, t = base(p, root)
    return [observe(lambda: overwrite(p, t, {"other": [1]}))]


def _overwrite_schema_replaces_schema(p, root):
    path, t = base(p, root)
    overwrite(p, t, {"other": [1]}, overwrite_schema=True)
    return [f.name for f in t.schema().fields], state(path)


def _overwrite_schema_requires_overwrite_mode(p, root):
    path, t = base(p, root)
    return [observe(lambda: append(p, t, {"other": [1]}, overwrite_schema=True))]


def _nested_missing_inner_field_null_filled(p, root):
    path, t = base(p, root, {"id": [1], "s": (NESTED, [{"x": 1, "y": "a"}])})
    append(p, t, {"id": [2], "s": (("struct", (("x", "int64"),)), [{"x": 5}])})
    return state(path)


def _nested_extra_inner_field(p, root):
    path, t = base(p, root, {"id": [1], "s": (NESTED, [{"x": 1, "y": "a"}])})
    wide = (("struct", (("x", "int64"), ("y", "string"), ("z", "float64"))),
            [{"x": 5, "y": "b", "z": 1.0}])
    err = observe(lambda: append(p, t, {"id": [2], "s": wide}))[:2]
    append(p, t, {"id": [2], "s": wide}, merge_schema=True)
    return err, state(path)


def _not_null_constraint_on_missing_column(p, root):
    path = os.path.join(root, "t")
    t = p.create(path, p.types.StructType().add("id", p.types.LongType(), nullable=False)
                 .add("value", p.types.StringType()))
    return [observe(lambda: append(p, t, {"value": ["x"]})), state(path)]


def _not_null_constraint_with_nulls_in_batch(p, root):
    path = os.path.join(root, "t")
    t = p.create(path, p.types.StructType().add("id", p.types.LongType(), nullable=False)
                 .add("value", p.types.StringType()))
    return [observe(lambda: append(p, t, {"id": [1, None], "value": ["x", "y"]})), state(path)]


def _partition_column_cannot_be_dropped_by_batch(p, root):
    path, t = base(p, root, {"id": [1], "part": ["p1"]}, partition_columns=["part"])
    append(p, t, {"id": [2]})
    return state(path)


def _nested_case_duplicates_rejected(p, root):
    path, t = base(p, root, {"id": [1], "s": (NESTED, [{"x": 1, "y": "a"}])})
    dup = (("struct", (("x", "int64"), ("X", "int64"), ("y", "string"))),
           [{"x": 10, "X": 20, "y": "b"}])
    return [observe(lambda: append(p, t, {"id": [2], "s": dup}))[:2]]


def _duplicates_with_generated_columns_clean_error(p, root):
    path = os.path.join(root, "t")
    t = p.create(path, p.types.StructType().add("id", p.types.LongType())
                 .add_field(p.gen("twice", "LongType", "id * 2")))
    return [observe(lambda: append(p, t, {"id": [1], "ID": [2]}))[:2]]


# -- tests/test_datatypes.py: the char/varchar write cases --------------------------------


def _char_table(p, root, c=4, v=3):
    path = os.path.join(root, "t")
    T = p.types
    return path, p.create(path, T.StructType().add("id", T.LongType()).add("c", T.CharType(c))
                          .add("v", T.VarcharType(v)))


def _char_pads_and_varchar_rejects(p, root):
    path, t = _char_table(p, root)
    append(p, t, {"id": [1, 2], "c": ["ab", None], "v": ["xyz", "ab"]})
    errs = [observe(lambda: append(p, t, {"id": [3], "v": ["toolong"], "c": ["a"]})),
            observe(lambda: append(p, t, {"id": [4], "v": ["ok"], "c": ["abcde"]}))]
    return errs, state(path)


def _varchar_overlength_trailing_spaces_truncate_to_bound(p, root):
    path, t = _char_table(p, root, v=4)
    append(p, t, {"id": [1, 2, 3], "v": ["ab   ", "cdef ", "in"]})
    return state(path)


def _char_read_side_padding_and_dml(p, root):
    path, t = _char_table(p, root, c=5)
    append(p, t, {"id": [1, 2, 3], "c": ["ab", "cd", None]})
    reads = [p.read(t, filters=[f]) for f in ("c = 'ab'", "c >= 'cd'", "c IN ('ab', 'cd')")]
    t.update({"id": "id + 10"}, "c = 'ab'")
    t.delete("c = 'cd'")
    (t.alias("t").merge(p.table({"id": [11, 40], "c": ["zz", "new"], "v": ["a", "b"]}),
                        "t.id = s.id", source_alias="s")
     .when_matched_update_all().when_not_matched_insert_all().execute())
    return reads, state(path)


def _char_varchar_trailing_spaces_trim_before_error(p, root):
    path, t = _char_table(p, root, c=3, v=3)
    append(p, t, {"id": [1], "c": ["ab    "], "v": ["xyz   "]})
    return state(path)


CASES = [
    _char_pads_and_varchar_rejects, _varchar_overlength_trailing_spaces_truncate_to_bound,
    _char_read_side_padding_and_dml, _char_varchar_trailing_spaces_trim_before_error,
    _add_constraint_validates_existing_rows, _constraint_enforced_on_future_writes,
    _duplicate_constraint_name_rejected, _drop_constraint_lifts_enforcement,
    _drop_missing_constraint, _constraint_in_create_and_null_verdict,
    _constraint_on_update_and_merge, _invariant_from_field_metadata,
    _missing_column_null_filled, _extra_column_rejected_with_name_in_error,
    _extra_column_added_with_merge_schema, _reordered_columns_normalized,
    _empty_batch_still_schema_checked, _case_insensitive_column_match,
    _case_differing_duplicates_rejected, _narrower_int_upcast_on_write,
    _incompatible_type_rejected, _float_to_long_lossy_rejected,
    _merge_schema_cannot_widen_existing_column, _alter_widen_then_append_long,
    _merge_schema_conflicting_types_rejected, _overwrite_keeps_schema_checks,
    _overwrite_schema_replaces_schema, _overwrite_schema_requires_overwrite_mode,
    _nested_missing_inner_field_null_filled, _nested_extra_inner_field,
    _not_null_constraint_on_missing_column, _not_null_constraint_with_nulls_in_batch,
    _partition_column_cannot_be_dropped_by_batch, _nested_case_duplicates_rejected,
    _duplicates_with_generated_columns_clean_error,
]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__.lstrip("_") for c in CASES])
def test_constraints_and_enforcement_match_jax(tmp_path, case):
    got = both(tmp_path, lambda p, root: case(W(p.name), root))
    assert not (isinstance(got, tuple) and got[:1] == ("raises",)), got


def test_check_constraint_sets_writer_version_3(tmp_path):
    def case(p, root):
        path, t = base(p, root)
        p.alter.add_constraint(t.delta_log, "pos", "id > 0")
        return state(path)["protocol"]

    assert both(tmp_path, lambda p, root: case(W(p.name), root))[:2] == (1, 3)

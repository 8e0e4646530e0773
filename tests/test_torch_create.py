"""The port's CREATE / REPLACE / CTAS and name catalog against
``delta_tpu``'s on the CPU: the 23 cases of ``tests/test_create.py`` (and
two more: field metadata and char/varchar declarations committed from the
caller's schema; a partitioned empty CREATE, then writes), each
run by both packages in directories of their own (``tests/torch_api_tables
.both``). The rows (each package reading both tables), versions, files'
partition values and stats, metadata, protocol, commits' operations and
metrics, and every error's class and message must be exactly equal.
"""
import json
import os
import socket
import threading
import time
import unittest.mock

import pytest

from tests.torch_api_tables import both, observe, state

SCHEMA = (("id", "LongType"), ("v", "StringType"))


def _create_empty_table(p, root):
    path = os.path.join(root, "t")
    t = p.create(path, p.schema(*SCHEMA), configuration={"delta.appendOnly": "false"})
    snap = t.delta_log.update()
    return (state(path), snap.metadata.schema.to_json(), len(snap.all_files),
            t.delta_log.history.get_history()[0].operation)


def _create_existing_errors(p, root):
    path = os.path.join(root, "t")
    p.create(path, p.schema(*SCHEMA))
    return p.create(path, p.schema(*SCHEMA))


def _create_if_not_exists_noop_when_matching(p, root):
    path = os.path.join(root, "t")
    p.create(path, p.schema(*SCHEMA))
    t = p.create(path, p.schema(*SCHEMA), mode="create_if_not_exists")
    return t.delta_log.snapshot.version, state(path)


def _create_if_not_exists_schema_mismatch_errors(p, root):
    path = os.path.join(root, "t")
    p.create(path, p.schema(*SCHEMA))
    return p.create(path, p.schema(("x", "IntegerType")), mode="create_if_not_exists")


def _create_if_not_exists_partitioning_mismatch_errors(p, root):
    path = os.path.join(root, "t")
    p.create(path, p.schema(*SCHEMA), partition_columns=["v"])
    return p.create(path, p.schema(*SCHEMA), partition_columns=["id"],
                    mode="create_if_not_exists")


def _ctas_one_commit(p, root):
    path = os.path.join(root, "t")
    t = p.create(path, data=p.table({"id": [1, 2], "v": ["a", "b"]}))
    return (state(path), p.read(t, columns=["id"]),
            t.delta_log.history.get_history()[0].operation)


def _replace_requires_existing(p, root):
    return p.replace(os.path.join(root, "t"), p.schema(*SCHEMA))


def _create_or_replace_fresh(p, root):
    path = os.path.join(root, "t")
    t = p.replace(path, p.schema(*SCHEMA), or_create=True)
    return t.delta_log.snapshot.version, state(path)


def _replace_swaps_schema_and_drops_files_atomically(p, root):
    path = os.path.join(root, "t")
    p.create(path, data=p.table({"id": [1, 2], "v": ["a", "b"]}))
    t2 = p.replace(path, p.schema(("x", "LongType")), data=p.table({"x": [10]}))
    snap = t2.delta_log.update()
    return (state(path), snap.metadata.schema.field_names, len(snap.tombstones),
            t2.delta_log.history.get_history()[0].operation)


def _replace_keeps_table_id(p, root):
    path = os.path.join(root, "t")
    t = p.create(path, p.schema(*SCHEMA))
    tid = t.delta_log.update().metadata.id
    p.replace(path, p.schema(("x", "LongType")))
    return p.log(path).update().metadata.id == tid, state(path)


def _create_requires_schema_or_data(p, root):
    return p.create_mod.CreateDeltaTableCommand(p.log(os.path.join(root, "t"))).run()


def _create_partitioned_ctas(p, root):
    path = os.path.join(root, "t")
    t = p.create(path, data=p.table({"id": [1, 2, 3], "p": ["a", "a", "b"]}),
                 partition_columns=["p"])
    return state(path), p.read(t, filters=["p = 'a'"])


def _create_keeps_field_metadata_and_char_types(p, root):
    path = os.path.join(root, "t")
    T = p.types
    schema = T.StructType([T.StructField("id", T.LongType(), False, {"comment": "the key"}),
                           T.StructField("code", T.VarcharType(4)),
                           T.StructField("c", T.CharType(2))])
    t = p.create(path, schema)
    return [(f.name, f.data_type.simple_string(), f.nullable, f.metadata)
            for f in t.schema().fields], state(path)


def _create_partitioned_then_write(p, root):
    path = os.path.join(root, "t")
    t = p.create(path, p.schema(("id", "LongType"), ("p", "StringType")),
                 partition_columns=["p"])
    t.write(p.table({"id": [1, 2, 3], "p": ["a", "b", "a"]}))
    wrong = observe(lambda: t.write(p.table({"id": [4], "p": ["c"]}),
                                    partition_columns=["id"]))
    return p.read(t, filters=["p = 'a'"]), wrong, state(path)


# -- the name catalog -----------------------------------------------------------------


def _catalog_create_load_drop(p, root):
    cat = p.catalog.Catalog()
    path = os.path.join(root, "sales")
    p.catalog_create(cat, "db1.sales", path, data=p.table({"id": [1, 2]}))
    seen = [cat.table_exists("db1.sales"), cat.table_exists("DB1.SALES")]
    rows = p.read(p.load_table(cat, "db1.sales"))
    listed = cat.list_tables("db1")
    cat.drop_table("db1.sales")
    return (seen, rows, listed, cat.table_exists("db1.sales"), p.is_delta_table(path),
            state(path))


def _catalog_duplicate_name_errors(p, root):
    cat = p.catalog.Catalog()
    p.catalog_create(cat, "t", os.path.join(root, "a"), p.schema(*SCHEMA))
    return p.catalog_create(cat, "t", os.path.join(root, "b"), p.schema(*SCHEMA))


def _catalog_losing_creator_fails_before_writing_data(p, root):
    cat = p.catalog.Catalog()
    p.catalog_create(cat, "t", os.path.join(root, "a"), p.schema(*SCHEMA))
    loser = os.path.join(root, "b")
    err = observe(lambda: p.catalog_create(cat, "t", loser, p.schema(*SCHEMA)))
    return err, os.path.exists(loser), cat.table_path("t")


def _catalog_failed_create_rolls_back_claim(p, root):
    cat = p.catalog.Catalog()
    err = observe(lambda: p.catalog_create(cat, "bad", os.path.join(root, "bad"),
                                           schema=None, data=None))
    before = cat.table_exists("bad")
    p.catalog_create(cat, "bad", os.path.join(root, "ok"), p.schema(*SCHEMA))
    return err, before, cat.table_exists("bad"), cat.table_path("bad")


def _catalog_persistence(p, root):
    store = os.path.join(root, "catalog.json")
    cat = p.catalog.Catalog(store)
    p.catalog_create(cat, "t", os.path.join(root, "t"), p.schema(*SCHEMA))
    cat2 = p.catalog.Catalog(store)
    with open(store) as f:
        persisted = json.load(f)
    return cat2.table_exists("t"), cat2.table_path("t"), persisted


def _for_name_and_path_identifier(p, root):
    store = os.path.join(root, "cat.json")
    path = os.path.join(root, "people")
    with p.conf.set_temporarily(**{"delta.tpu.catalog.path": store}):
        p.catalog.reset_default_catalog()
        try:
            p.catalog_create(p.catalog.default_catalog(), "people", path,
                             data=p.table({"id": [7]}))
            return (p.read(p.for_name("people")), p.read(p.for_name(f"delta.`{path}`")),
                    observe(lambda: p.for_name("nobody")),
                    observe(lambda: p.for_name("a.b.c")))
        finally:
            p.catalog.reset_default_catalog()


def _register_external_table(p, root):
    path = os.path.join(root, "ext")
    p.create(path, data=p.table({"id": [9]}))
    cat = p.catalog.Catalog()
    cat.register("ext", path)
    return p.read(p.load_table(cat, "ext")), observe(lambda: cat.register("ext", path))


def _catalog_live_inflight_create_blocks_concurrent(p, root):
    cat = p.catalog.Catalog(os.path.join(root, "cat.json"))
    gate, release = threading.Event(), threading.Event()
    errors_b = []
    orig_create = p.DeltaTable.create.__func__

    def slow_create(cls, *a, **kw):
        gate.set()
        release.wait(timeout=10)
        return orig_create(cls, *a, **kw)

    a_path, b_path = os.path.join(root, "a"), os.path.join(root, "b")

    def creator_a():
        with unittest.mock.patch.object(p.DeltaTable, "create", classmethod(slow_create)):
            p.catalog_create(cat, "t", a_path, p.schema(*SCHEMA))

    ta = threading.Thread(target=creator_a)
    ta.start()
    assert gate.wait(timeout=10)
    try:
        p.catalog_create(cat, "t", b_path, p.schema(*SCHEMA))
    except p.errors.DeltaAnalysisError as e:
        errors_b.append(str(e))
    release.set()
    ta.join(timeout=10)
    return (errors_b, os.path.exists(b_path), cat.table_path("t"), p.is_delta_table(a_path))


def _claims_store(root, claim):
    store = os.path.join(root, "cat.json")
    with open(store, "w") as f:
        json.dump({"tables": {}, "claims": {"default.t": claim}}, f)
    return store


def _catalog_crashed_claim_is_reclaimable(p, root):
    store = _claims_store(root, {"path": os.path.join(root, "ghost"), "pid": 2**22 + 12345,
                                 "host": socket.gethostname(), "ts_ms": 0})
    cat = p.catalog.Catalog(store)
    p.catalog_create(cat, "t", os.path.join(root, "real"), p.schema(*SCHEMA))
    return cat.table_path("t")


def _catalog_register_refuses_live_claim(p, root):
    store = _claims_store(root, {"path": os.path.join(root, "x"), "pid": os.getpid(),
                                 "host": socket.gethostname(),
                                 "ts_ms": int(time.time() * 1000)})
    return p.catalog.Catalog(store).register("t", os.path.join(root, "y"))


def _catalog_same_host_claim_expires(p, root):
    store = _claims_store(root, {"path": os.path.join(root, "x"), "pid": 1,
                                 "host": socket.gethostname(), "ts_ms": 0})
    cat = p.catalog.Catalog(store)
    with p.conf.set_temporarily(**{"delta.tpu.catalog.claimTimeoutMs": 1}):
        p.catalog_create(cat, "t", os.path.join(root, "real"), p.schema(*SCHEMA))
    return cat.table_path("t")


CASES = [
    _create_empty_table, _create_existing_errors, _create_if_not_exists_noop_when_matching,
    _create_if_not_exists_schema_mismatch_errors,
    _create_if_not_exists_partitioning_mismatch_errors, _ctas_one_commit,
    _replace_requires_existing, _create_or_replace_fresh,
    _replace_swaps_schema_and_drops_files_atomically, _replace_keeps_table_id,
    _create_requires_schema_or_data, _create_partitioned_ctas,
    _create_keeps_field_metadata_and_char_types, _create_partitioned_then_write,
    _catalog_create_load_drop,
    _catalog_duplicate_name_errors, _catalog_losing_creator_fails_before_writing_data,
    _catalog_failed_create_rolls_back_claim, _catalog_persistence,
    _for_name_and_path_identifier, _register_external_table,
    _catalog_live_inflight_create_blocks_concurrent, _catalog_crashed_claim_is_reclaimable,
    _catalog_register_refuses_live_claim, _catalog_same_host_claim_expires,
]

#: what each case must observe in both packages: an error's class, or None
RAISES = {
    "_create_existing_errors": "DeltaAnalysisError",
    "_create_if_not_exists_schema_mismatch_errors": "DeltaAnalysisError",
    "_create_if_not_exists_partitioning_mismatch_errors": "DeltaAnalysisError",
    "_replace_requires_existing": "DeltaAnalysisError",
    "_create_requires_schema_or_data": "DeltaAnalysisError",
    "_catalog_duplicate_name_errors": "DeltaAnalysisError",
    "_catalog_register_refuses_live_claim": "DeltaAnalysisError",
}


@pytest.mark.parametrize("case", CASES, ids=[c.__name__.lstrip("_") for c in CASES])
def test_create_matches_jax(tmp_path, case):
    got = both(tmp_path, case)
    want = RAISES.get(case.__name__)
    if want is None:
        assert not (isinstance(got, tuple) and got[:1] == ("raises",)), got
    else:
        assert got[:2] == ("raises", want), got

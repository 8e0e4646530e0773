"""The port's schema evolution against ``delta_tpu``'s on the CPU.

* Every scenario of ``tests/test_schema_scenarios.py`` through both
  packages' ``schema_utils``: duplicate detection at every depth, column
  positions, ``merge_schemas``' upcast matrix, name normalization and read
  compatibility. Each gives the same schema JSON, position or error class.
* The evolution cases of ``tests/test_merge_matrix.py`` (MERGE with
  ``delta.tpu.schema.autoMerge.enabled`` and a star clause), under the
  device routes (``devicePath.mode=force``) and the host join (``off``):
  the same end-state rows, schema, metrics and route.
* ``mergeSchema`` and ``overwriteSchema`` writes and an evolving MERGE into
  a table with the change data feed and a generated column, run once a
  package in its own directory (``tests/torch_api_tables.both``): table
  state and change feed as both packages read them.

Exact throughout."""
import os

import pytest

from tests.torch_api_tables import both, observe
from tests.torch_port_tables import Pkg, both_confs, metrics, reset_caches
from tests.torch_write_tables import CDF, DV, W, changes, state


@pytest.fixture(autouse=True)
def _fresh():
    reset_caches()
    yield
    reset_caches()


# -- tests/test_schema_scenarios.py ------------------------------------------------


def _schema_modules(name):
    if name == "jax":
        from delta_tpu.schema import schema_utils as su
        from delta_tpu.schema import types as T
    else:
        from delta_tpu_torch.schema import schema_utils as su
        from delta_tpu_torch.schema import types as T
    return su, T


def S(T, *fields):
    return T.StructType([T.StructField(n, t) for n, t in fields])


def _observe_schema(fn):
    try:
        out = fn()
    except Exception as e:  # the class is the observation
        return ("raises", type(e).__name__)
    if hasattr(out, "to_json"):
        return out.to_json()
    return out


def _dup_cases(su, T):
    I, L, St = T.IntegerType(), T.LongType(), T.StringType()
    shapes = [
        S(T, ("a", I), ("b", St), ("a", L)),
        S(T, ("abc", I), ("ABC", L)),
        S(T, ("top", S(T, ("x", I), ("X", L)))),
        S(T, ("l1", S(T, ("l2", S(T, ("d", I), ("D", L)))))),
        S(T, ("top", T.ArrayType(T.ArrayType(S(T, ("d", I), ("d", L)))))),
        S(T, ("top", T.ArrayType(S(T, ("e", I), ("E", L))))),
        S(T, ("top", T.MapType(St, S(T, ("v", I), ("V", L))))),
        S(T, ("top", T.MapType(S(T, ("k", I), ("K", L)), St))),
        S(T, ("a", I), ("s", S(T, ("a", L)))),
        S(T, ("s1", S(T, ("x", I))), ("s2", S(T, ("x", L)))),
        S(T, ("a.b", I), ("a", S(T, ("b", L)))),
        S(T, ("a.b", I), ("a.b", L)),
    ]
    return [_observe_schema(lambda: su.check_column_name_duplication(s, "in test"))
            for s in shapes]


def _position_cases(su, T):
    I, L = T.IntegerType(), T.LongType()
    nested = S(T, ("a", S(T, ("b", S(T, ("c", I), ("d", L))))))
    arr = S(T, ("arr", T.ArrayType(S(T, ("x", I), ("y", L)))))
    m = S(T, ("m", T.MapType(S(T, ("k", I)), S(T, ("v", L)))))
    flat = S(T, ("a", I), ("c", I))
    inner = S(T, ("s", S(T, ("x", I))))
    grown = su.add_column(inner, T.StructField("y", L), [0, 1])
    return [_observe_schema(lambda: su.find_column_position(["a", "b", "d"], nested)),
            _observe_schema(lambda: su.find_column_position(["arr", "element", "y"], arr)),
            _observe_schema(lambda: su.find_column_position(["m", "key", "k"], m)),
            _observe_schema(lambda: su.find_column_position(["m", "value", "v"], m)),
            _observe_schema(lambda: su.find_column_position(
                ["a", "zz"], S(T, ("a", S(T, ("b", I)))))),
            _observe_schema(lambda: su.add_column(flat, T.StructField("b", L), [1])),
            grown.to_json(), _observe_schema(lambda: su.drop_column_at(grown, [0, 1])[0])]


def _merge_cases(su, T):
    B, Sh, I, L = T.ByteType(), T.ShortType(), T.IntegerType(), T.LongType()
    D, St = T.DoubleType(), T.StringType()
    out = []
    for frm, to in ((B, Sh), (B, I), (Sh, I)):
        out.append(_observe_schema(lambda: su.merge_schemas(S(T, ("c", frm)), S(T, ("c", to)))))
        out.append(_observe_schema(lambda: su.merge_schemas(S(T, ("c", to)), S(T, ("c", frm)))))
    for frm in (B, Sh, I):
        out.append(_observe_schema(lambda: su.merge_schemas(S(T, ("c", frm)), S(T, ("c", L)))))
        out.append(_observe_schema(lambda: su.merge_schemas(
            S(T, ("c", frm)), S(T, ("c", L)), allow_implicit_conversions=True)))
    out.append(_observe_schema(lambda: su.merge_schemas(S(T, ("c", T.NullType())), S(T, ("c", D)))))
    out.append(_observe_schema(lambda: su.merge_schemas(S(T, ("c", D)), S(T, ("c", T.NullType())))))
    cur = T.StructType([T.StructField("c", I, False, {"k": "v"})])
    new = T.StructType([T.StructField("c", I, True, {"other": "x"})])
    out.append(_observe_schema(lambda: su.merge_schemas(cur, new)))
    out.append(_observe_schema(lambda: su.merge_schemas(S(T, ("a", I), ("b", L)), S(T, ("a", I)))))
    out.append(_observe_schema(lambda: su.merge_schemas(
        S(T, ("s", S(T, ("x", I)))), S(T, ("s", S(T, ("x", I), ("y", L))), ("z", St)))))
    out.append(_observe_schema(lambda: su.merge_schemas(S(T, ("Col", I)), S(T, ("COL", I)))))
    out.append(_observe_schema(lambda: su.merge_schemas(S(T, ("s", S(T, ("x", I)))),
                                                        S(T, ("s", S(T, ("x", St)))))))
    out.append(_observe_schema(lambda: su.merge_schemas(
        S(T, ("g", L)), S(T, ("g", D)), allow_implicit_conversions=True,
        fixed_type_columns=["G"])))
    return out


def _normalize_and_read_cases(su, T):
    I, L = T.IntegerType(), T.LongType()
    return [
        su.normalize_column_names(S(T, ("aa", I), ("bb", L)), S(T, ("BB", L), ("AA", I))),
        su.normalize_column_names(S(T, ("a.b", I)), S(T, ("A.B", I))),
        su.is_read_compatible(S(T, ("c", I)), S(T, ("c", L))),
        su.is_read_compatible(S(T, ("x", I), ("y", L)), S(T, ("y", L), ("x", I))),
        su.is_read_compatible(S(T, ("s", S(T, ("x", I)))), S(T, ("s", S(T, ("x", I), ("y", L))))),
        su.is_read_compatible(T.StructType([T.StructField("c", I, True)]),
                              T.StructType([T.StructField("c", I, False)])),
        su.is_read_compatible(S(T, ("c", I), ("d", I)), S(T, ("c", I))),
    ]


SCENARIOS = [_dup_cases, _position_cases, _merge_cases, _normalize_and_read_cases]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=[s.__name__.strip("_") for s in SCENARIOS])
def test_schema_utils_scenarios_match_jax(scenario):
    got = scenario(*_schema_modules("torch"))
    want = scenario(*_schema_modules("jax"))
    assert got == want


# -- tests/test_merge_matrix.py: the evolution cases ---------------------------------

ALIAS = dict(source_alias="s", target_alias="t")
UP, INS = ("update",), ("insert",)


@pytest.fixture(params=["device", "host"])
def executor(request):
    mode = "force" if request.param == "device" else "off"
    with both_confs(**{"delta.tpu.merge.devicePath.mode": mode}):
        yield request.param


def _evolve_case(P, path, target, source, matched, not_matched, auto=True):
    log = P.write(path, target)
    with both_confs(**{"delta.tpu.schema.autoMerge.enabled": auto}):
        try:
            cmd = P.merge(log, source, "t.id = s.id", matched, not_matched, **ALIAS)
            out = (metrics(cmd), cmd._join_path)
        except Exception as e:  # the class is the observation
            out = type(e).__name__
    return out, [f.name for f in log.update().metadata.schema.fields], P.rows(log)


EVOLUTION = {
    "insert_all_adds_new_column": ({"id": [1, 2], "v": [10, 20]},
                                   {"id": [2, 3], "v": [21, 31], "extra": ["a", "b"]},
                                   [UP], [INS], True),
    "update_all_adds_new_column": ({"id": [1, 2], "v": [10, 20]},
                                   {"id": [2], "v": [99], "flag": [True]}, [UP], [], True),
    "insert_only_adds_new_column": ({"id": [1, 2], "v": [10, 20]},
                                    {"id": [2, 3], "v": [21, 31], "extra": ["a", "b"]},
                                    [], [INS], True),
    "requires_star_clause": ({"id": [1], "v": [10]}, {"id": [1], "v": [100], "extra": [1]},
                             [("update", None, {"v": "s.v"})], [], True),
    "off_is_default_schema_unchanged": ({"id": [1], "v": [10]},
                                        {"id": [1], "v": [100], "extra": [1]}, [UP], [], False),
    "preserves_target_column_order_and_case": ({"id": [1], "Val": [10]},
                                               {"val": [99], "id": [1], "z": [0]},
                                               [UP], [INS], True),
    "widens_int_to_long": ({"id": [1, 2], "v": ("int32", [10, 20])},
                           {"id": [2, 3], "v": [2 ** 40, 5]}, [UP], [INS], True),
    "source_missing_target_column": ({"id": [1, 2], "v": [10, 20], "w": ["x", "y"]},
                                     {"id": [2, 3], "v": [21, 31]}, [UP], [INS], True),
}


@pytest.mark.parametrize("name", sorted(EVOLUTION))
def test_merge_evolution_matches_jax(tmp_path, executor, name):
    target, source, matched, not_matched, auto = EVOLUTION[name]
    got = _evolve_case(Pkg("torch"), str(tmp_path / "torch"), target, source, matched,
                       not_matched, auto)
    want = _evolve_case(Pkg("jax"), str(tmp_path / "jax"), target, source, matched,
                        not_matched, auto)
    assert got == want


# -- writes with evolution, and MERGE evolution with the feed and a generated column ----


def _merge_schema_write_then_overwrite_schema(p, root):
    path = os.path.join(root, "t")
    t = p.create(path, data=p.table({"id": [1, 2], "v": ["a", "b"]}), configuration=CDF)
    t.write(p.table({"id": [3], "v": ["c"], "n": [1.5]}), merge_schema=True)
    t.write(p.table({"id": [4], "n": [2.5]}), merge_schema=True)
    wrong = observe(lambda: t.write(p.table({"id": [5], "v": [7.0]}), merge_schema=True))[:2]
    t.write(p.table({"k": ["z"]}), mode="overwrite", overwrite_schema=True)
    return wrong, changes(path, 0), state(path)


def _evolving_cdf_merge_with_generated_column(p, root, layout):
    path = os.path.join(root, "t")
    T = p.types
    schema = (T.StructType().add("id", T.LongType()).add("q", T.LongType())
              .add_field(p.gen("g", "LongType", "q * 10")))
    t = p.create(path, schema, configuration=dict(CDF, **layout))
    t.write({"id": [1, 2, 3], "q": [1, 2, 3]})
    with p.conf.set_temporarily(**{"delta.tpu.schema.autoMerge.enabled": True}):
        (t.alias("t").merge(p.table({"id": [2, 3, 9], "q": [20, 30, 90], "tag": ["u", "u", "i"]}),
                            "t.id = s.id", source_alias="s")
         .when_matched_update_all("s.q != 30").when_matched_delete()
         .when_not_matched_insert_all().execute())
        retype = observe(lambda: t.alias("t").merge(
            p.table({"id": [1], "q": [1], "g": [4.5]}), "t.id = s.id", source_alias="s")
            .when_matched_update_all().execute())[:2]
    t.update({"q": "q + 1"}, "tag = 'i'")
    t.delete("id = 1")
    return retype, changes(path, 0), state(path)


def test_write_schema_evolution_matches_jax(tmp_path):
    got = both(tmp_path, lambda p, root: _merge_schema_write_then_overwrite_schema(W(p.name), root))
    assert not (isinstance(got, tuple) and got[:1] == ("raises",)), got


@pytest.mark.parametrize("layout", ["cow", "dv"])
def test_evolving_cdf_merge_with_generated_column_matches_jax(tmp_path, executor, layout):
    conf = {"cow": {}, "dv": DV}[layout]
    got = both(tmp_path, lambda p, root: _evolving_cdf_merge_with_generated_column(
        W(p.name), root, conf))
    assert not (isinstance(got, tuple) and got[:1] == ("raises",)), got
    retype, rows, st = got
    assert retype == ("raises", "DeltaAnalysisError")
    assert st["protocol"][1] in (4, 7)
    assert "tag" in st["schema"]

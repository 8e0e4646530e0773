"""The port's MERGE device routes against ``delta_tpu``'s on the CPU (the
kernels through their plain versions):

* every case of ``tests/test_merge_device_matrix.py``, both ``fused``
  variants: ``cold`` (the slab pipeline builds and registers inline) and
  ``hit`` (the key lane is built first, the merge probes it resident). Each
  case runs in both packages, each on its own seeded table: the same merge
  forced onto the device on one copy and pinned to the host on another.
  The port's observations (routes, metrics without ``*TimeMs``, sorted
  rows of both copies, error classes) equal ``delta_tpu``'s;
* the cross-read: each package reads the table the other wrote and merged
  (deletion vectors included), with the same rows and live-file stats;
* bench config 2's shape at 100,000 target and 10,000 source rows through
  the four routes of ``chip_smoke.py``'s MERGE phase (M0 host, M1
  device-cold, M2 resident, M3 device-upload), each end state equal to a
  numpy reference upsert and to ``delta_tpu``'s;
* no error of a kernel or of the uploader turns into the host join: with a
  kernel wrapper patched to raise, ``run()`` raises; a failed post-commit
  warmup is stored in ``KeyCache.last_build_error``.
"""
import json
import os
import shutil

import numpy as np
import pytest

import delta_tpu_torch
from delta_tpu.ops.key_cache import KeyCache as JaxKeyCache
from delta_tpu_torch.commands.merge import MergeIntoCommand as TorchMerge
from delta_tpu_torch.expr import ir
from delta_tpu_torch.ops import join_kernel, key_cache
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


@pytest.fixture(params=["cold", "hit"])
def fused(request):
    return request.param


def seed_table(P, path, composite=False, with_null_target=False, files=3):
    """test_merge_device_matrix's `_seed_table`: 3 files of 40 rows, keys
    -40..79, payload `v` (RandomState(11)) and `tag`."""
    rng = np.random.RandomState(11)
    per = 40
    log = None
    for i in range(files):
        lo = -40 + i * per
        keys = list(range(lo, lo + per))
        if with_null_target and i == 1:
            keys[3] = None
        cols = {"k": ("int64", keys), "v": rng.rand(per).tolist(),
                "tag": [f"r{j}" if j is not None else f"r{lo + 3}" for j in keys]}
        if composite:
            cols["k2"] = [((j if j is not None else lo + 3) % 7) for j in keys]
        log = P.write(path, cols)
    return log


def run(P, log, source, cond, matched, not_matched, mode):
    with both_confs(**{"delta.tpu.merge.devicePath.mode": mode,
                       "delta.tpu.deletionVectors.enabled": True,
                       "delta.tpu.merge.keyCache.enabled": mode != "off"}):
        return P.merge(log, source, cond, matched, not_matched, **ALIAS)


def prebuild(P, log, cond, source_cols):
    """The table's resident key lane under the merge's own key signature."""
    probe = P.command(log, {c: ("int64", []) for c in source_cols}, cond, [UP], [INS], **ALIAS)
    target_cols = [f.name for f in log.update().metadata.schema.fields]
    resolved = probe._resolve(probe.condition, target_cols, source_cols)
    equi, _ = probe._split_equi_keys(resolved)
    t_exprs = [t for t, _ in equi]
    refs = {r.lower() for t in t_exprs for r in _references(P, t)}
    key_cols = [c for c in target_cols if c.lower() in refs]
    e = P.key_cache().instance().get(log.update(), type(probe)._key_signature(t_exprs),
                                     key_cols, t_exprs)
    assert e is not None


def _references(P, e):
    if P.jax:
        from delta_tpu.expr import ir
    else:
        from delta_tpu_torch.expr import ir
    return ir.references(e)


def identity_case(P, root, fused, source, cond, matched, not_matched, **seed):
    a, b = os.path.join(root, "a"), os.path.join(root, "b")
    log_a = seed_table(P, a, **seed)
    shutil.copytree(a, b)
    log_b = P.log(b)
    if fused == "hit":
        prebuild(P, log_a, cond, list(source))
    cmd_a = observe(lambda: run(P, log_a, source, cond, matched, not_matched, "force"))
    cmd_b = observe(lambda: run(P, log_b, source, cond, matched, not_matched, "off"))
    out = []
    for cmd in (cmd_a, cmd_b):
        out.append(cmd if isinstance(cmd, str) else
                   (metrics(cmd), cmd._join_path, cmd._device_join is not None))
    return out + [P.rows(log_a), P.rows(log_b)]


def assert_same(tmp_path, fn, *args, **kw):
    got = fn(Pkg("torch"), str(tmp_path / "torch"), *args, **kw)
    want = fn(Pkg("jax"), str(tmp_path / "jax"), *args, **kw)
    assert got == want
    return got


def upsert_source():
    rng = np.random.RandomState(3)
    keys = list(range(-10, 20, 3)) + list(range(500, 520))
    return {"k": keys, "v": rng.rand(len(keys)).tolist(),
            "tag": [f"s{i}" for i in range(len(keys))]}


def test_matched_and_not_matched_upsert(tmp_path, fused):
    got = assert_same(tmp_path, identity_case, fused, upsert_source(), "t.k = s.k", [UP], [INS])
    assert got[0][1] == ("resident" if fused == "hit" else "device-cold")
    assert got[0][0]["numTargetRowsUpdated"] == 10 and got[0][0]["numTargetRowsInserted"] == 20
    assert got[2] == got[3]


def test_matched_only_with_clause_conditions(tmp_path, fused):
    got = assert_same(tmp_path, identity_case, fused, upsert_source(), "t.k = s.k",
                      [("update", "s.v >= 0.5"), DEL], [])
    assert got[2] == got[3]


def test_insert_only_duplicate_sources(tmp_path, fused):
    src = {"k": [5, 5, 700, 700, 701, -3], "v": np.linspace(0, 1, 6).tolist(),
           "tag": [f"d{i}" for i in range(6)]}
    got = assert_same(tmp_path, identity_case, fused, src, "t.k = s.k", [], [INS])
    assert got[0][0]["numTargetRowsInserted"] == 3


def test_null_source_and_target_keys_sentinel(tmp_path, fused):
    src = {"k": [7, None, None, 900], "v": [0.1, 0.2, 0.3, 0.4], "tag": ["n0", "n1", "n2", "n3"]}
    got = assert_same(tmp_path, identity_case, fused, src, "t.k = s.k", [UP], [INS],
                      with_null_target=True)
    assert got[0][0]["numTargetRowsUpdated"] == 1 and got[0][0]["numTargetRowsInserted"] == 3


def test_composite_packed_keys(tmp_path, fused):
    src = {"k": [-5, 2, 9, 9, 333], "k2": [(-5) % 7, 2 % 7, 9 % 7, 6, 1],
           "v": np.linspace(0, 1, 5).tolist(), "tag": [f"c{i}" for i in range(5)]}
    got = assert_same(tmp_path, identity_case, fused, src, "t.k = s.k AND t.k2 = s.k2",
                      [UP], [INS], composite=True)
    assert got[0][0]["numTargetRowsUpdated"] == 3 and got[0][0]["numTargetRowsInserted"] == 2


def multi_match_case(P, root, fused):
    src = {"k": [4, 4], "v": [1.0, 2.0], "tag": ["m0", "m1"]}
    a, b = os.path.join(root, "a"), os.path.join(root, "b")
    log_a = seed_table(P, a)
    shutil.copytree(a, b)
    log_b = P.log(b)
    if fused == "hit":
        prebuild(P, log_a, "t.k = s.k", list(src))
    out = [observe(lambda: run(P, log_a, src, "t.k = s.k", [UP], [INS], "force")),
           observe(lambda: run(P, log_b, src, "t.k = s.k", [UP], [INS], "off"))]
    # a single unconditional DELETE legally multi-matches on both
    for log, mode in ((log_a, "force"), (log_b, "off")):
        cmd = run(P, log, src, "t.k = s.k", [DEL], [], mode)
        out.append((metrics(cmd), cmd._join_path))
    return out + [P.rows(log_a), P.rows(log_b)]


def test_multi_match_error_parity(tmp_path, fused):
    got = assert_same(tmp_path, multi_match_case, fused)
    assert got[0] == got[1] == "DeltaUnsupportedOperationError"
    assert got[2][0]["numTargetRowsDeleted"] == got[3][0]["numTargetRowsDeleted"] == 1


def second_round_case(P, root, fused):
    a, b = os.path.join(root, "a"), os.path.join(root, "b")
    log_a = seed_table(P, a)
    shutil.copytree(a, b)
    log_b = P.log(b)
    if fused == "hit":
        prebuild(P, log_a, "t.k = s.k", ["k", "v", "tag"])
    src1 = upsert_source()
    run(P, log_a, src1, "t.k = s.k", [UP], [INS], "force")
    run(P, log_b, src1, "t.k = s.k", [UP], [INS], "off")
    if fused == "cold":
        P.key_cache().reset()  # round 2 cold-builds over DV'd files
    src2 = {"k": [-10, 2, 505, 999], "v": [9.0, 8.0, 7.0, 6.0], "tag": ["z0", "z1", "z2", "z3"]}
    cmd_a = run(P, log_a, src2, "t.k = s.k", [UP], [INS], "force")
    cmd_b = run(P, log_b, src2, "t.k = s.k", [UP], [INS], "off")
    return [(metrics(cmd_a), cmd_a._join_path), (metrics(cmd_b), cmd_b._join_path),
            P.rows(log_a), P.rows(log_b)]


def test_second_round_over_deletion_vectors(tmp_path, fused):
    got = assert_same(tmp_path, second_round_case, fused)
    assert got[0][0]["numTargetRowsUpdated"] == 3 and got[0][0]["numTargetRowsInserted"] == 1
    assert got[2] == got[3]


def post_optimize_case(P, root, fused):
    """OPTIMIZE between merges (delta_tpu's OptimizeCommand writes the
    compaction into both packages' tables; the port has no OPTIMIZE, so it
    bumps its key cache's epoch itself, as its OPTIMIZE will): the next
    forced merge rebuilds and stays equal to the host."""
    from delta_tpu import DeltaLog as JaxDeltaLog
    from delta_tpu.commands.optimize import OptimizeCommand

    a, b = os.path.join(root, "a"), os.path.join(root, "b")
    log_a = seed_table(P, a)
    shutil.copytree(a, b)
    log_b = P.log(b)
    prebuild(P, log_a, "t.k = s.k", ["k", "v", "tag"])
    for path in (a, b):
        OptimizeCommand(JaxDeltaLog.for_table(path), min_file_size=1 << 30).run()
    if not P.jax:
        P.key_cache().instance().bump_epoch(log_a.log_path)
    dropped = not P.key_cache().instance()._entries
    if fused == "hit":
        prebuild(P, log_a, "t.k = s.k", ["k", "v", "tag"])
    src = upsert_source()
    cmd_a = run(P, log_a, src, "t.k = s.k", [UP], [INS], "force")
    cmd_b = run(P, log_b, src, "t.k = s.k", [UP], [INS], "off")
    return [dropped, (metrics(cmd_a), cmd_a._join_path), (metrics(cmd_b), cmd_b._join_path),
            P.rows(log_a), P.rows(log_b)]


def test_post_optimize_merge_parity(tmp_path, fused):
    got = assert_same(tmp_path, post_optimize_case, fused)
    assert got[0] is True and got[3] == got[4]


# -- the cross-read ------------------------------------------------------------------


def live_stats(path):
    """The live files' stats (sorted; paths differ), replayed from the JSON
    commits."""
    live = {}
    log_dir = os.path.join(path, "_delta_log")
    for name in sorted(n for n in os.listdir(log_dir) if n.endswith(".json")):
        for line in open(os.path.join(log_dir, name)):
            obj = json.loads(line)
            if "add" in obj:
                live[obj["add"]["path"]] = json.loads(obj["add"]["stats"])
            elif "remove" in obj:
                live.pop(obj["remove"]["path"], None)
    return sorted(json.dumps(s, sort_keys=True) for s in live.values())


def test_cross_read_both_ways(tmp_path):
    """Each package writes a DV-enabled table and upserts into it twice;
    each reads both tables: the same rows and the same live-file stats."""
    paths = {}
    for P in (Pkg("torch"), Pkg("jax")):
        path = str(tmp_path / P.name)
        log = seed_table(P, path)
        with both_confs(**{"delta.tpu.merge.devicePath.mode": "force"}):
            if P.jax:
                from delta_tpu.commands.alter import set_table_properties
            else:
                from delta_tpu_torch.commands.alter import set_table_properties
            set_table_properties(log, {"delta.tpu.enableDeletionVectors": "true"})
            P.merge(log, upsert_source(), "t.k = s.k", [UP], [INS], **ALIAS)
            P.merge(log, {"k": [-40, 0, 900], "v": [1.0, 2.0, 3.0], "tag": ["x", "y", "z"]},
                    "t.k = s.k", [UP], [INS], **ALIAS)
        paths[P.name] = path
    reset_caches()
    rows = {(reader, writer): Pkg(reader).rows(Pkg(reader).log(path))
            for reader in ("torch", "jax") for writer, path in paths.items()}
    assert len({json.dumps(r, sort_keys=True) for r in rows.values()}) == 1
    assert live_stats(paths["torch"]) == live_stats(paths["jax"])


# -- bench config 2's shape, cut to 100,000 target rows ----------------------------


N_TARGET, N_SOURCE, FILE_ROWS = 100_000, 10_000, 40_000
COLS = ("ss_item_sk", "ss_customer_sk", "ss_sold_date_sk", "ss_store_sk", "ss_quantity",
        "ss_sales_price", "ss_ext_discount_amt", "ss_net_paid")


def store_sales(n, rng):
    """bench.py's `_store_sales` draws."""
    return {
        "ss_item_sk": rng.permutation(n * 2)[:n].astype(np.int64),
        "ss_customer_sk": rng.randint(0, 1_000_000, n).astype(np.int64),
        "ss_sold_date_sk": rng.randint(2450000, 2452000, n).astype(np.int64),
        "ss_store_sk": rng.randint(0, 500, n).astype(np.int64),
        "ss_quantity": rng.randint(1, 100, n).astype(np.int64),
        "ss_sales_price": rng.rand(n).astype(np.float64) * 100,
        "ss_ext_discount_amt": rng.rand(n).astype(np.float64) * 10,
        "ss_net_paid": rng.rand(n).astype(np.float64) * 90,
    }


def upsert_sources(target_keys):
    """M1's (and M0's) source as bench.py:205-214 draws it, then M2's and
    M3's: half live keys, half fresh keys above every key so far."""
    rng = np.random.RandomState(7)
    rng.permutation(N_TARGET * 2)  # the target's draws, replayed
    out = []
    live = set(target_keys.tolist())
    top = N_TARGET * 2
    for i, seed in enumerate((11, 12, 13)):
        if i == 0:
            existing = target_keys[np.random.RandomState(5).choice(N_TARGET, N_SOURCE // 2,
                                                                   replace=False)]
        else:
            pool = np.array(sorted(live), np.int64)
            existing = pool[np.random.RandomState(seed).choice(len(pool), N_SOURCE // 2,
                                                               replace=False)]
        fresh = np.arange(top, top + N_SOURCE - N_SOURCE // 2, dtype=np.int64)
        top += N_SOURCE
        keys = np.concatenate([existing, fresh])
        np.random.RandomState(seed + 100).shuffle(keys)
        src = store_sales(N_SOURCE, np.random.RandomState(seed))
        src["ss_item_sk"] = keys
        live |= set(fresh.tolist())
        out.append(src)
    return out


def reference_upsert(state, src):
    """Matched keys take the source row, fresh keys append."""
    pos = {k: i for i, k in enumerate(state["ss_item_sk"].tolist())}
    hit = np.array([k in pos for k in src["ss_item_sk"].tolist()])
    rows = np.array([pos[k] for k in src["ss_item_sk"][hit].tolist()], np.int64)
    out = {c: state[c].copy() for c in COLS}
    for c in COLS:
        out[c][rows] = src[c][hit]
        out[c] = np.concatenate([out[c], src[c][~hit]])
    order = np.argsort(out["ss_item_sk"], kind="stable")
    return {c: out[c][order] for c in COLS}


def config2_routes(P, root, target, sources):
    """M0-M3 of chip_smoke.py's MERGE phase at 100k rows; returns per merge
    (route, metrics) and each end state as sorted columns."""
    path = os.path.join(root, "c2")
    with both_confs(**{"delta.tpu.write.targetFileRows": FILE_ROWS}):
        log = P.write(path, {c: (("float64" if target[c].dtype == np.float64 else "int64"),
                                 target[c].tolist()) for c in COLS})
        if P.jax:
            from delta_tpu.commands.alter import set_table_properties
        else:
            from delta_tpu_torch.commands.alter import set_table_properties
        set_table_properties(log, {"delta.tpu.enableDeletionVectors": "true"})
        shutil.copytree(path, path + "-copy")
        log0 = P.log(path + "-copy")

        def src_of(s):
            return {c: (("float64" if s[c].dtype == np.float64 else "int64"), s[c].tolist())
                    for c in COLS}

        out = []
        steps = [(log0, sources[0], {"delta.tpu.merge.devicePath.mode": "off"}),
                 (log, sources[0], {"delta.tpu.merge.devicePath.mode": "force"}),
                 (log, sources[1], {"delta.tpu.merge.devicePath.mode": "force"}),
                 (log, sources[2], {"delta.tpu.merge.devicePath.mode": "force",
                                    "delta.tpu.deletionVectors.enabled": False})]
        for lg, s, settings in steps:
            with both_confs(**settings):
                cmd = P.merge(lg, src_of(s), "t.ss_item_sk = s.ss_item_sk", [UP], [INS], **ALIAS)
            t = P.scan(lg)
            cols = {c: np.asarray(t.column(c).to_pylist() if P.jax else t.column(c).values)
                    for c in COLS}
            order = np.argsort(cols["ss_item_sk"], kind="stable")
            out.append((cmd._join_path, metrics(cmd), cmd._router.get("reason"),
                        {c: v[order] for c, v in cols.items()}))
    return out


def test_config2_shape_through_every_route(tmp_path):
    target = store_sales(N_TARGET, np.random.RandomState(7))
    sources = upsert_sources(target["ss_item_sk"])
    got = config2_routes(Pkg("torch"), str(tmp_path / "torch"), target, sources)
    want = config2_routes(Pkg("jax"), str(tmp_path / "jax"), target, sources)
    assert [g[0] for g in got] == ["host", "device-cold", "resident", "device-upload"]
    state = {c: target[c] for c in COLS}
    refs = [reference_upsert(state, sources[0])]
    for s in sources[:3]:
        state = reference_upsert(state, s)
        refs.append(state)
    for i, ((route, m, reason, end), (w_route, w_m, _, w_end)) in enumerate(zip(got, want)):
        assert (route, m) == (w_route, w_m), f"M{i}"
        assert reason is None, f"M{i}: {reason}"
        assert m["numTargetRowsUpdated"] == m["numTargetRowsInserted"] == N_SOURCE // 2
        ref = refs[i]
        for c in COLS:
            assert np.array_equal(end[c], ref[c]), f"M{i} column {c}"
            assert np.array_equal(end[c], w_end[c]), f"M{i} column {c} vs delta_tpu"
    assert all(np.array_equal(got[0][3][c], got[1][3][c]) for c in COLS)  # M0 == M1


# -- no kernel error becomes the host join -------------------------------------------


def _raise(*args, **kwargs):
    raise RuntimeError("injected kernel failure")


def _small_table(path, dv):
    P = Pkg("torch")
    log = P.write(path, {"k": list(range(100)), "v": [0.5] * 100})
    if dv:
        from delta_tpu_torch.commands.alter import set_table_properties

        set_table_properties(log, {"delta.tpu.enableDeletionVectors": "true"})
    return P, log


@pytest.mark.parametrize("wrapper", ["slab_probe", "slab_sort", "pair_compact",
                                     "slab_advance"])
def test_device_route_errors_propagate(tmp_path, monkeypatch, wrapper):
    """A raising key-slab kernel (K8-K11) fails the MERGE: no host join."""
    P, log = _small_table(str(tmp_path / "t"), dv=True)
    monkeypatch.setattr(key_cache, wrapper, _raise)
    with both_confs(**{"delta.tpu.merge.devicePath.mode": "force"}):
        with pytest.raises(RuntimeError, match="injected"):
            P.merge(log, {"k": [1, 200], "v": [1.0, 2.0]}, "t.k = s.k", [UP], [INS], **ALIAS)
    assert log.update().version == 1  # nothing committed


def test_upload_join_error_propagates(tmp_path, monkeypatch):
    """A raising K12 fails the copy-on-write MERGE over DV files."""
    P, log = _small_table(str(tmp_path / "t"), dv=True)
    with both_confs(**{"delta.tpu.merge.devicePath.mode": "force"}):
        P.merge(log, {"k": [1, 200], "v": [1.0, 2.0]}, "t.k = s.k", [UP], [INS], **ALIAS)
        monkeypatch.setattr(join_kernel, "join_probe", _raise)
        with both_confs(**{"delta.tpu.deletionVectors.enabled": False}):
            with pytest.raises(RuntimeError, match="injected"):
                P.merge(log, {"k": [2, 300], "v": [1.0, 2.0]}, "t.k = s.k", [UP], [INS],
                        **ALIAS)


def test_warmup_error_is_stored(tmp_path, monkeypatch):
    """The post-commit warmup runs off the committing thread; its error is
    kept on the KeyCache, not swallowed."""
    P, log = _small_table(str(tmp_path / "t"), dv=True)
    cache = key_cache.KeyCache.instance()
    with both_confs(**{"delta.tpu.merge.devicePath.mode": "force",
                       "delta.tpu.merge.residentKeys.minRows": 0}):
        # a refused registration leaves the warmup to build the lane
        monkeypatch.setattr(key_cache.KeyCache, "register", lambda self, e: False)
        P.merge(log, {"k": [1, 200], "v": [1.0, 2.0]}, "t.k = s.k", [UP], [INS], **ALIAS)
        assert cache.wait_warmups(60)
        assert cache.last_build_error is None
        sig = TorchMerge._key_signature([ir.Column("k")])
        assert cache.peek(log.log_path, sig, device="cpu") is not None
        get = key_cache.KeyCache.get

        def failing_build(self, snapshot, signature, key_cols, exprs, build_if_missing=True):
            if build_if_missing:
                raise RuntimeError("injected build failure")
            return get(self, snapshot, signature, key_cols, exprs, build_if_missing=False)

        monkeypatch.setattr(key_cache.KeyCache, "get", failing_build)
        key_cache.KeyCache.reset()
        cache = key_cache.KeyCache.instance()
        P.merge(log, {"k": [2, 300], "v": [1.0, 2.0]}, "t.k = s.k", [UP], [INS], **ALIAS)
        assert cache.wait_warmups(60)
    assert isinstance(cache.last_build_error, RuntimeError)


def test_the_jax_key_cache_is_untouched(tmp_path):
    """The port's merges never fill delta_tpu's key cache."""
    P, log = _small_table(str(tmp_path / "t"), dv=True)
    with both_confs(**{"delta.tpu.merge.devicePath.mode": "force"}):
        P.merge(log, {"k": [1, 200], "v": [1.0, 2.0]}, "t.k = s.k", [UP], [INS], **ALIAS)
    assert not JaxKeyCache.instance()._entries
    assert delta_tpu_torch.DeltaLog.for_table(log.data_path, device="cpu") is log

"""The port's resident MERGE key slab (``delta_tpu_torch.ops.key_cache``)
held against ``delta_tpu.ops.key_cache`` on the CPU.

Tables are written by ``delta_tpu`` (``WriteIntoDelta``, deletion-vector
deletes through ``DeleteCommand``) and read by both packages; the port reads
the data files with its own Parquet codec. Every probe's ``PhysicalProbe``
must equal the JAX package's field for field (flags, multi-match, slab
layout, pairs), with zero tolerance: these are integer pairs and flags.
Where the JAX probe's candidate windows overflow (it then falls back to the
host join), the port is held to the JAX host join (``join_kernel._host_join``).
The merge-level cases of ``tests/test_key_cache.py`` wait for the MERGE
command's slice.
"""
import threading

import numpy as np
import pyarrow as pa
import pytest
import torch

from delta_tpu import DeltaLog as JaxDeltaLog
from delta_tpu.commands.write import WriteIntoDelta
from delta_tpu.expr import ir as jir
from delta_tpu.expr.vectorized import evaluate as jax_evaluate
from delta_tpu.ops import key_cache as jkc
from delta_tpu.ops.join_kernel import _host_join
from delta_tpu.utils.config import conf
from delta_tpu_torch import DeltaLog as TorchDeltaLog
from delta_tpu_torch.exec.parquet import read_parquet_file
from delta_tpu_torch.expr import ir as tir
from delta_tpu_torch.expr.vectorized import HostColumn, HostTable
from delta_tpu_torch.expr.vectorized import evaluate as torch_evaluate
from delta_tpu_torch.ops import key_cache as tkc
from tests.torch_kernel_cases import (
    ADVANCE_CASES, CASE_NAMES, COMPACT_CASES, advance_case, compact_case, probe_case,
    reference_compact, reference_probe,
)

SIG = "test-k"


@pytest.fixture(autouse=True)
def _fresh_caches():
    jkc.KeyCache.reset()
    tkc.KeyCache.reset()
    TorchDeltaLog.clear_cache()
    yield
    jkc.KeyCache.reset()
    tkc.KeyCache.reset()
    TorchDeltaLog.clear_cache()


def _mk_table(path, lo=0, hi=200, files=4):
    log = JaxDeltaLog.for_table(path)
    per = (hi - lo) // files
    rng = np.random.RandomState(5)
    for i in range(files):
        keys = np.arange(lo + i * per, lo + (i + 1) * per, dtype=np.int64)
        WriteIntoDelta(log, "append", pa.table({"k": keys, "v": rng.rand(per)})).run()
    return log


def _entries(path, key_cols=("k",), sig=SIG):
    """(JAX entry, port entry) at the table's current version."""
    jexprs = [jir.Column(c) for c in key_cols]
    texprs = [tir.Column(c) for c in key_cols]
    je = jkc.KeyCache.instance().get(JaxDeltaLog.for_table(path).update(), sig,
                                     list(key_cols), jexprs)
    te = tkc.KeyCache.instance().get(TorchDeltaLog.for_table(path, device="cpu").update(), sig,
                                     list(key_cols), texprs)
    return je, te


def _slab():
    return (jkc.ResidentJoinKeys("log", "mid", 0, "sig", ["k"]),
            tkc.ResidentJoinKeys("log", "mid", 0, "sig", ["k"], device="cpu"))


def _same(a, b):
    assert np.array_equal(a.s_matched, b.s_matched)
    assert a.s_matched.dtype == b.s_matched.dtype == bool
    assert a.any_multi == b.any_multi
    assert a.slabs == b.slabs
    assert a.num_rows == b.num_rows
    if a.t_pairs is None:
        assert b.t_pairs is None
        return
    for x, y in zip(a.t_pairs, b.t_pairs):
        assert np.array_equal(x, y) and x.dtype == y.dtype
    assert np.array_equal(a.t_bits, b.t_bits)
    for path, (_, rows) in a.slabs.items():
        pa_, pb = a.pairs_for_file(path, None, rows), b.pairs_for_file(path, None, rows)
        assert all(np.array_equal(x, y) for x, y in zip(pa_, pb))
        assert np.array_equal(a.bits_for_file(path, None, rows), b.bits_for_file(path, None, rows))
        if rows > 2:  # a DV-filtered decode that dropped the first row
            pos = np.arange(1, rows)
            assert str(a.pairs_for_file(path, pos, rows - 1)) == str(b.pairs_for_file(path, pos,
                                                                                    rows - 1))


def _probe_both(je, te, s, ok=None, **kw):
    s = np.asarray(s, np.int64)
    ok = np.ones(len(s), bool) if ok is None else np.asarray(ok, bool)
    a = je.probe_async(s, ok, **kw).result()
    b = te.probe_async(s, ok, **kw).result()
    _same(a, b)
    return b


def _probe_vs_host_join(je, te, s, ok):
    """The JAX probe where it answers; the JAX host join where it overflows."""
    try:
        a = je.probe_async(s, ok).result()
    except jkc.DeltaProbeOverflow:
        a = None
    b = te.probe_async(s, ok).result()
    if a is not None:
        _same(a, b)
        return "probe"
    n = je.num_rows
    ref = _host_join(je.h_keys[:n], je.h_valid[:n], s, ok)
    phys = np.flatnonzero(ref.t_first_s >= 0)
    assert np.array_equal(b.s_matched, ref.s_matched)
    assert b.any_multi == ref.any_multi
    assert np.array_equal(b.t_pairs[0], phys)
    assert np.array_equal(b.t_pairs[1], ref.t_first_s[phys])
    return "host join"


# -- entry lifecycle --------------------------------------------------------------


@pytest.mark.parametrize("keys,ok", [
    ([5, 150, 500], None),
    ([5, 0], [True, False]),  # a null source key never matches
    ([5, 5, 7, 199, 200, -1], None),  # a repeated matched key: any_multi
    ([], []),
])
def test_build_and_probe_matches_jax(tmp_table, keys, ok):
    _mk_table(tmp_table)
    je, te = _entries(tmp_table)
    assert te.num_rows == je.num_rows == 200 and te.capacity == je.capacity
    assert te.slabs == je.slabs
    assert np.array_equal(te.h_keys, je.h_keys) and np.array_equal(te.h_valid, je.h_valid)
    _probe_both(je, te, keys, ok)
    _probe_both(je, te, keys, ok, insert_only=True)


def test_null_target_keys_never_match(tmp_table):
    log = JaxDeltaLog.for_table(tmp_table)
    WriteIntoDelta(log, "append", pa.table({
        "k": pa.array([1, None, 3, None, 5], pa.int64()), "v": np.zeros(5)})).run()
    je, te = _entries(tmp_table)
    assert np.array_equal(te.h_valid, je.h_valid) and not te.h_valid[1]
    _probe_both(je, te, [0, 1, 3, 5], [True, True, True, True])


def test_tail_advance_append_and_remove(tmp_table):
    from delta_tpu.commands.delete import DeleteCommand

    log = _mk_table(tmp_table)
    je, te = _entries(tmp_table)
    te.ensure_resident()
    WriteIntoDelta(log, "append", pa.table({
        "k": np.arange(500, 550, dtype=np.int64), "v": np.zeros(50)})).run()
    DeleteCommand(log, "k < 50").run()  # a whole file: removed, no DV
    je2, te2 = _entries(tmp_table)
    assert je2 is je and te2 is te and te2.version == je2.version == log.update().version
    assert te2.slabs == je2.slabs and te2._dead == je2._dead
    _probe_both(je2, te2, [10, 60, 510, 549, 600])


def test_dv_deleted_rows_do_not_match(tmp_table):
    from delta_tpu.commands.alter import set_table_properties
    from delta_tpu.commands.delete import DeleteCommand

    log = _mk_table(tmp_table)
    set_table_properties(log, {"delta.tpu.enableDeletionVectors": "true"})
    je, te = _entries(tmp_table)
    te.ensure_resident()
    _probe_both(je, te, [42, 43])
    with conf.set_temporarily(**{"delta.tpu.deletionVectors.enabled": True}):
        DeleteCommand(log, "k = 42 OR k = 120").run()
    je2, te2 = _entries(tmp_table)
    assert je2 is je and te2 is te
    assert te2.dv_tags == je2.dv_tags and any(t is not None for t in te2.dv_tags.values())
    res = _probe_both(je2, te2, [42, 43, 120])
    assert res.s_matched.tolist() == [False, True, False]


def test_dv_shrink_revives_rows(tmp_table):
    _mk_table(tmp_table, files=1)
    je, te = _entries(tmp_table)
    path = next(iter(te.slabs))
    te.ensure_resident()
    je.ensure_resident()
    for pos in ([3, 7], [], [7, 9], []):
        pos = np.asarray(pos, np.int64)
        assert je._set_dv(path, pos) and te._set_dv(path, pos)
        _probe_both(je, te, [3, 7, 9])


@pytest.mark.parametrize("seed", [7, 8, 9])
def test_probe_sorted_kernel_fuzz_parity(seed):
    """A slab of random keys with dense duplicates and DV masks, against the
    JAX probe (or its host join where the JAX windows overflow): sparse,
    dense, miss-only and window-overflowing sources."""
    rng = np.random.RandomState(seed)
    n = 20000
    keys = rng.randint(0, 15000, n).astype(np.int64)
    je, te = _slab()
    half = n // 2
    for e in (je, te):
        e._append_file("f1", keys[:half], np.ones(half, bool))
        e._append_file("f2", keys[half:], np.ones(n - half, bool))
    dv_pos = rng.choice(n - half, 500, replace=False).astype(np.int64)
    assert je._set_dv("f2", dv_pos) and te._set_dv("f2", dv_pos)
    paths = []
    for s_keys, s_ok in [
        (np.arange(100, 200, dtype=np.int64), np.ones(100, bool)),
        (rng.randint(0, 15000, 3000).astype(np.int64), rng.rand(3000) > 0.1),
        (np.arange(100000, 100050, dtype=np.int64), np.ones(50, bool)),
        (rng.randint(-50000, 60000, 50000).astype(np.int64), rng.rand(50000) > 0.05),
    ]:
        paths.append(_probe_vs_host_join(je, te, s_keys, s_ok))
    assert paths[:3] == ["probe"] * 3


def test_probe_overflowing_band_equals_host_join():
    """Sparse slab keys with a dense band of misses between them: every JAX
    window holds more candidates than its tiers (overflow -> host join);
    the port's search has no windows and answers the same pairs."""
    rng = np.random.RandomState(3)
    je, te = _slab()
    keys = np.arange(20000, dtype=np.int64) * 100
    for e in (je, te):
        e._append_file("f", keys, np.ones(len(keys), bool))
    s = rng.randint(0, 2_000_000, 60000).astype(np.int64)
    s[:100] = keys[rng.choice(len(keys), 100)]
    assert _probe_vs_host_join(je, te, s, np.ones(len(s), bool)) == "host join"


def test_probe_many_above_max_misses_no_overflow():
    je, te = _slab()
    n = 20000
    for e in (je, te):
        e._append_file("f", np.arange(n, dtype=np.int64) * 2, np.ones(n, bool))
    s = np.concatenate([np.arange(50000, 60000, dtype=np.int64), np.array([10, 20], np.int64)])
    res = _probe_both(je, te, s)
    assert res.s_matched[-2:].tolist() == [True, True] and not res.s_matched[:-2].any()


def test_probe_after_kill_and_append_resorts():
    je, te = _slab()
    for e in (je, te):
        e._append_file("a", np.array([10, 20, 30], np.int64), np.ones(3, bool))
        e.ensure_resident()
    _probe_both(je, te, [20])
    assert not te._sort_stale
    for e in (je, te):
        e._kill_file("a")
    assert not te._sort_stale
    _probe_both(je, te, [20])
    for e in (je, te):
        e._append_file("b", np.array([40, 20], np.int64), np.ones(2, bool))
    assert te._sort_stale
    res = _probe_both(je, te, [20, 10, 40])
    assert res.s_matched.tolist() == [True, False, True] and not te._sort_stale


def test_set_dv_out_of_range_positions_signal_rebuild(tmp_table):
    _mk_table(tmp_table, files=1)
    je, te = _entries(tmp_table)
    path = next(iter(te.slabs))
    for e in (je, te):
        assert e._set_dv(path, np.array([0, e.num_rows + 5], np.int64)) is False
        assert e._set_dv(path, np.array([0], np.int64)) is True
        assert e._set_dv("no-such-file", np.array([0], np.int64)) is False


def test_failed_advance_poisons_version(tmp_table, monkeypatch):
    log = _mk_table(tmp_table, files=2)
    je, te = _entries(tmp_table)
    v0 = te.version
    WriteIntoDelta(log, "append", pa.table({
        "k": np.arange(500, 520, dtype=np.int64), "v": np.zeros(20)})).run()
    jsnap = log.update()
    tsnap = TorchDeltaLog.for_table(tmp_table, device="cpu").update()
    monkeypatch.setattr(jkc, "_file_keys", lambda *a, **k: None)
    # the port reads an advance's new files' keys in one batch
    monkeypatch.setattr(tkc, "_files_keys", lambda *a, **k: None)
    assert jkc.KeyCache.instance()._advance(je, jsnap, ["k"], [jir.Column("k")]) is False
    assert tkc.KeyCache.instance()._advance(te, tsnap, ["k"], [tir.Column("k")]) is False
    assert te.version == je.version and te.version not in (v0, tsnap.version)
    assert te.probe_async(np.array([5]), np.array([True]), expected_version=v0) is None

    def boom(*a, **k):
        raise ValueError("corrupt")

    monkeypatch.undo()
    je2, te2 = _entries(tmp_table)  # rebuilt at the new version
    assert te2 is not te and te2.version == je2.version == tsnap.version
    WriteIntoDelta(log, "append", pa.table({
        "k": np.arange(600, 610, dtype=np.int64), "v": np.zeros(10)})).run()
    tsnap2 = TorchDeltaLog.for_table(tmp_table, device="cpu").update()
    monkeypatch.setattr(tkc, "_files_keys", boom)
    with pytest.raises(ValueError):
        tkc.KeyCache.instance()._advance(te2, tsnap2, ["k"], [tir.Column("k")])
    assert te2.version not in (tsnap.version, tsnap2.version)
    assert te2.probe_async(np.array([5]), np.array([True]),
                           expected_version=tsnap.version) is None


def test_metadata_change_invalidates(tmp_table):
    from delta_tpu.commands.alter import set_table_properties

    log = _mk_table(tmp_table)
    je, te = _entries(tmp_table)
    set_table_properties(log, {"delta.appendOnly": "false"})
    je2, te2 = _entries(tmp_table)
    assert je2 is not je and te2 is not te
    assert te2.version == je2.version == log.update().version
    _probe_both(je2, te2, [5, 199, 200])


def _pack_both(cols, exprs):
    jtab = pa.table(cols)
    ttab = HostTable({k: HostColumn("int", np.nan_to_num(np.asarray(
        pa.array(v).fill_null(0)), nan=0).astype(np.int64),
        ~np.asarray(pa.array(v).is_null())) for k, v in cols.items()}, len(jtab))
    a = jkc._pack_lanes(jtab, [jir.Column(c) for c in exprs], jax_evaluate)
    b = tkc._pack_lanes(ttab, [tir.Column(c) for c in exprs], torch_evaluate)
    return a, b


@pytest.mark.parametrize("cols,exprs,packs", [
    ({"a": pa.array([1, 2, None], pa.int64()), "b": pa.array([10, -3, 5], pa.int64())},
     ["a", "b"], True),
    ({"a": pa.array([1, 2**31, 3], pa.int64()), "b": pa.array([1, 2, 3], pa.int64())},
     ["a", "b"], False),  # a component beyond int32: no packed lane
    ({"a": pa.array([7, None, -9], pa.int64())}, ["a"], True),
    ({"a": pa.array([1, 2], pa.int64()), "b": pa.array([1, 2], pa.int64()),
      "c": pa.array([1, 2], pa.int64())}, ["a", "b", "c"], False),
])
def test_composite_pack_parity(cols, exprs, packs):
    a, b = _pack_both(cols, exprs)
    assert (a is not None) == (b is not None) == packs
    if packs:
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def test_pack_lanes_declines_non_integer_lanes(tmp_table):
    t = HostTable({"d": HostColumn("double", np.array([1.5]), np.array([True]))}, 1)
    assert tkc._pack_lanes(t, [tir.Column("d")], torch_evaluate) is None
    assert tkc._pack_lanes(t, [tir.Column("missing")], torch_evaluate) is None


def test_composite_slab_matches_jax(tmp_table):
    log = JaxDeltaLog.for_table(tmp_table)
    rng = np.random.RandomState(2)
    for _ in range(3):
        WriteIntoDelta(log, "append", pa.table({
            "a": rng.randint(0, 20, 300).astype(np.int64),
            "b": pa.array(rng.randint(-5, 5, 300).astype(np.int64),
                          mask=rng.rand(300) < 0.05)})).run()
    je, te = _entries(tmp_table, key_cols=("a", "b"), sig="ab")
    assert np.array_equal(te.h_keys, je.h_keys) and np.array_equal(te.h_valid, je.h_valid)
    s = (rng.randint(0, 25, 400).astype(np.int64) << 32) | (
        rng.randint(-6, 6, 400).astype(np.int64) & 0xFFFFFFFF)
    res = _probe_both(je, te, s, rng.rand(400) > 0.1)
    assert res.any_multi


def test_probe_absent_key_sharing_lo_with_member(tmp_table):
    log = JaxDeltaLog.for_table(tmp_table)
    WriteIntoDelta(log, "append", pa.table({
        "k": np.array([100, 200, 300], np.int64), "v": np.zeros(3)})).run()
    je, te = _entries(tmp_table)
    res = _probe_both(je, te, [99, 100, 199, 200, 299, 300, 150, 250])
    assert res.s_matched.tolist() == [False, True, False, True, False, True, False, False]


def test_batched_advance_append_plus_dv_same_file(tmp_table):
    from delta_tpu.commands.alter import set_table_properties
    from delta_tpu.commands.delete import DeleteCommand

    log = _mk_table(tmp_table, files=1)
    set_table_properties(log, {"delta.tpu.enableDeletionVectors": "true"})
    je, te = _entries(tmp_table)
    je.ensure_resident()
    te.ensure_resident()
    WriteIntoDelta(log, "append", pa.table({
        "k": np.arange(1000, 1050, dtype=np.int64), "v": np.zeros(50)})).run()
    with conf.set_temporarily(**{"delta.tpu.deletionVectors.enabled": True}):
        DeleteCommand(log, "k = 1010").run()
    je2, te2 = _entries(tmp_table)
    assert je2 is je and te2 is te and te2.is_resident
    res = _probe_both(je2, te2, [1010, 1011])
    assert res.s_matched.tolist() == [False, True]


def test_lru_eviction_matches_jax(tmp_path, monkeypatch):
    """Past maxEntries both caches drop the same least-recently-used tables;
    past maxBytes both drop the same device copies."""
    paths = []
    for i in range(tkc.MAX_ENTRIES + 2):
        p = str(tmp_path / f"t{i}")
        _mk_table(p, files=1)
        paths.append(p)
    for p in paths:
        _entries(p)
    _entries(paths[0])  # touch the oldest: the next ones are now LRU
    jkeys = {k[0] for k in jkc.KeyCache.instance()._entries}
    tkeys = {k[0] for k in tkc.KeyCache.instance()._entries}
    assert jkeys == tkeys and len(tkeys) == tkc.MAX_ENTRIES
    assert JaxDeltaLog.for_table(paths[0]).log_path in tkeys

    budget = 2 * 1024 * 26  # two entries of the smallest capacity
    monkeypatch.setattr(tkc, "MAX_DEVICE_BYTES", budget)
    with conf.set_temporarily(**{"delta.tpu.keyCache.maxBytes": budget}):
        for p in paths:
            for e in _entries(p):
                assert e.device_bytes == 1024 * 26
                e.ensure_resident()
        jkc.KeyCache.instance()._evict(keep=None)
        tkc.KeyCache.instance()._evict(keep=None)
    jres = {k[0] for k, e in jkc.KeyCache.instance()._entries.items() if e.is_resident}
    tres = {k[0] for k, e in tkc.KeyCache.instance()._entries.items() if e.is_resident}
    assert jres == tres and len(tres) == 2


def test_epoch_bump_drops_entry(tmp_table):
    log = _mk_table(tmp_table)
    je, te = _entries(tmp_table)
    v0 = te.version
    jc, tc = jkc.KeyCache.instance(), tkc.KeyCache.instance()
    jc.bump_epoch(log.log_path)
    tc.bump_epoch(log.log_path)
    assert tc.epoch(log.log_path) == jc.epoch(log.log_path) == 1
    assert jc.peek(log.log_path, SIG) is None and tc.peek(log.log_path, SIG, "cpu") is None
    assert te.probe_async(np.array([5]), np.array([True]), expected_version=v0) is None
    je2, te2 = _entries(tmp_table)
    assert te2 is not te and je2 is not je
    _probe_both(je2, te2, [5, 500])


def test_probe_pinned_at_version_survives_an_advance(tmp_table, monkeypatch):
    """A probe launched at version v answers v's question while an advance to
    v+1 kills its matches: every update binds new tensors, none changes the
    ones the probe pinned (the JAX package's immutable arrays)."""
    from delta_tpu.commands.delete import DeleteCommand

    log = _mk_table(tmp_table)
    je, te = _entries(tmp_table)
    te.ensure_resident()
    want = je.probe_async(np.array([5, 60, 150]), np.ones(3, bool)).result()
    started, advanced = threading.Event(), threading.Event()
    real = tkc.slab_probe

    def held(*args):
        started.set()
        assert advanced.wait(30)
        return real(*args)

    monkeypatch.setattr(tkc, "slab_probe", held)
    pending = te.probe_async(np.array([5, 60, 150]), np.ones(3, bool), expected_version=te.version)
    assert started.wait(30)
    DeleteCommand(log, "k < 100").run()
    _, te2 = _entries(tmp_table)
    assert te2 is te and te.version == log.update().version
    advanced.set()
    _same(want, pending.result())
    monkeypatch.setattr(tkc, "slab_probe", real)
    now = te.probe_async(np.array([5, 60, 150]), np.ones(3, bool)).result()
    assert now.s_matched.tolist() == [False, False, True]


def test_file_keys_none_where_jax_is_none_and_codec_errors_propagate(tmp_table):
    """The port's ``_files_keys`` (one file a list) against the JAX
    package's ``_file_keys``: None for a missing file or column, the same
    lane for a ZSTD file, and BROTLI's ``NotImplementedError`` through."""
    from delta_tpu.protocol.actions import AddFile

    log = _mk_table(tmp_table, files=1)
    add = log.update().all_files[0]
    data = log.data_path
    for missing in (AddFile(path="gone.parquet", size=1, modification_time=0,
                            data_change=True), add):
        cols = ["k"] if missing is not add else ["nope"]
        assert jkc._file_keys(data, missing, cols, [jir.Column(cols[0])]) is None
        assert tkc._files_keys(data, [missing], cols, [tir.Column(cols[0])], "cpu") is None
    # ZSTD pages decode since the port's own decoder; BROTLI is still a
    # codec the port does not cover, and its error propagates
    written = {add.path}
    new = []
    for codec in ("zstd", "brotli"):
        with conf.set_temporarily(**{"delta.tpu.write.compression": codec}):
            WriteIntoDelta(log, "append", pa.table({
                "k": np.arange(7, dtype=np.int64), "v": np.zeros(7)})).run()
        [a] = [a for a in log.update().all_files if a.path not in written]
        written.add(a.path)
        new.append(a)
    zadd, badd = new
    want = jkc._file_keys(data, zadd, ["k"], [jir.Column("k")])
    got = tkc._files_keys(data, [zadd], ["k"], [tir.Column("k")], "cpu")
    assert want is not None and got is not None and list(got) == [zadd.path]
    assert all(np.array_equal(a, b) for a, b in zip(got[zadd.path], want))
    # two files in one batch: each file's lane as the JAX package's
    both = tkc._files_keys(data, [add, zadd], ["k"], [tir.Column("k")], "cpu")
    for a in (add, zadd):
        ref = jkc._file_keys(data, a, ["k"], [jir.Column("k")])
        assert all(np.array_equal(x, y) for x, y in zip(both[a.path], ref))
    assert jkc._file_keys(data, badd, ["k"], [jir.Column("k")]) is not None
    with pytest.raises(NotImplementedError, match="BROTLI"):
        tkc._files_keys(data, [badd], ["k"], [tir.Column("k")], "cpu")


def _jax_pairs_in_physical_order(t, first, perm, out_cap):
    """The JAX package's K10 followed by its probe finalize's stable argsort
    by physical row (``delta_tpu/ops/key_cache.py:908-912``), laid out as
    the port's K10 returns it: (2, out_cap) int32, zeros past the count."""
    from delta_tpu.utils.jaxcompat import enable_x64

    with enable_x64():
        pairs = np.asarray(jkc._pair_compact_kernel()(t, first, perm, out_cap))
    k = min(int(t.sum()), out_cap)
    order = np.argsort(pairs[0, :k].astype(np.int64), kind="stable")
    out = np.zeros_like(pairs)
    out[:, :k] = pairs[:, :k][:, order]
    return out


def test_kernels_plain_versions_agree_with_the_jax_kernels():
    """K8-K11's plain versions (the CPU path) against the JAX kernels on the
    same inputs, where the outputs are defined alike: the sort (keys and
    sorted validity; ties may order differently, the JAX sort is not
    stable), the probe's flags, count and matched rows' first source, the
    compaction (the JAX kernel followed by its finalize's reorder into
    physical order, which the port's K10 does itself) and the six
    updates."""
    from delta_tpu.utils.jaxcompat import enable_x64

    rng = np.random.RandomState(4)
    cap, n = 8192, 6000
    keys = rng.randint(-3000, 3000, cap).astype(np.int64)
    valid = rng.rand(cap) > 0.2
    with enable_x64():
        jsk, jperm, jinv, jsv = (np.array(x) for x in jkc._sort_kernel()(keys, valid, n))
        sk, perm, inv, sv = (x.numpy() for x in tkc.slab_sort_plain(
            torch.from_numpy(keys), torch.from_numpy(valid), n))
        assert np.array_equal(sk, jsk)
        assert np.array_equal(np.sort(perm[:n]), np.sort(jperm[:n]))
        assert np.array_equal(inv[perm], np.arange(cap)) and np.array_equal(sv, valid[perm] & (perm < n))
        s = np.concatenate([rng.randint(-4000, 4000, 1000), [(1 << 31) - 2] * 24]).astype(np.int32)
        jhead, jt, jfirst = (np.array(x) for x in jkc._probe_sorted_kernel()(
            jsk, jsv, np.int32(n), s))
        head, t, first = (x.numpy() for x in tkc.slab_probe_plain(
            torch.from_numpy(jsk), torch.from_numpy(jsv), n, torch.from_numpy(s)))
        assert np.array_equal(head, jhead) and np.array_equal(t, jt)
        assert np.array_equal(first[t], jfirst[t])
        out_cap = 2048
        assert int(jt.sum()) <= out_cap
        jpairs = _jax_pairs_in_physical_order(jt, jfirst, jperm, out_cap)
        pairs = tkc.pair_compact_plain(torch.from_numpy(jt), torch.from_numpy(jfirst),
                                       torch.from_numpy(jperm), out_cap).numpy()
        assert np.array_equal(pairs, jpairs)
        upd = jkc._update_kernels()
        rows = np.full(64, cap, np.int32)
        rows[:40] = rng.choice(cap, 40, replace=False)
        tv, tr = torch.from_numpy(valid), torch.from_numpy(rows)
        assert np.array_equal(tkc.slab_kill(tv, tr).numpy(), np.asarray(upd["kill"](valid, rows)))
        assert np.array_equal(tkc.slab_revive(tv, tr).numpy(),
                              np.asarray(upd["revive"](valid, rows)))
        assert np.array_equal(tkc.slab_map_rows(torch.from_numpy(jinv), tr).numpy(),
                              np.asarray(upd["map_rows"](jinv, rows)))
        nk = rng.randint(-100, 100, 64).astype(np.int32)
        nv = rng.rand(64) > 0.5
        jk, jv = upd["append"](keys, valid, rows, nk, nv)
        k2, v2 = tkc.slab_append(torch.from_numpy(keys), tv, tr, torch.from_numpy(nk),
                                 torch.from_numpy(nv))
        assert np.array_equal(k2.numpy(), np.asarray(jk)) and np.array_equal(v2.numpy(),
                                                                              np.asarray(jv))
        for start in (0, 100, cap - 10):
            jk, jv = upd["slice_append"](keys, valid, np.int32(start), nk, nv)
            k2, v2 = tkc.slab_slice_append(torch.from_numpy(keys), tv, start,
                                           torch.from_numpy(nk), torch.from_numpy(nv))
            assert np.array_equal(k2.numpy(), np.asarray(jk))
            assert np.array_equal(v2.numpy(), np.asarray(jv))
        k32 = keys.astype(np.int32)
        assert np.array_equal(tkc.slab_widen(torch.from_numpy(k32)).numpy(),
                              np.asarray(upd["widen"](k32)))


def test_updates_never_change_their_input():
    v = torch.zeros(128, dtype=torch.bool)
    k = torch.arange(128, dtype=torch.int64)
    r = torch.tensor([1, 2, 128, -1], dtype=torch.int32)
    nk = torch.tensor([9, 9, 9, 9], dtype=torch.int32)
    nv = torch.ones(4, dtype=torch.bool)
    out = tkc.slab_revive(v, r)
    assert not v.any() and out.sum() == 3  # -1 wraps to 127, 128 drops
    k2, v2 = tkc.slab_append(k, v, r, nk, nv)
    assert torch.equal(k, torch.arange(128)) and int(k2[127]) == 9
    k3, _ = tkc.slab_slice_append(k, v, 126, nk, nv)  # clamps to 124
    assert torch.equal(k, torch.arange(128)) and k3[124:].tolist() == [9, 9, 9, 9]


def test_read_parquet_of_a_written_table_equals_pyarrow(tmp_table):
    """The key lane the cold build reads through the port's codec equals the
    one pyarrow reads (the files are the JAX writer's)."""
    import pyarrow.parquet as pq

    log = _mk_table(tmp_table, files=2)
    for add in log.update().all_files:
        p = f"{log.data_path}/{add.path}"
        t = read_parquet_file(p, ["k"], device="cpu")
        assert np.array_equal(t.column("k").values, pq.read_table(p).column("k").to_numpy())


# -- K9 at its hard shapes (tests/torch_kernel_cases.py) -------------------------------


@pytest.mark.parametrize("name", CASE_NAMES)
def test_slab_probe_plain_matches_jax_at_hard_shapes(name):
    """K9's plain version (the CPU path, and the kernel's oracle on the
    card) against a numpy oracle of the contract and against the JAX
    kernel: an int32 source against keys beyond int32, the empty-slot keys
    of both tables, runs of thousands of equal keys, duplicate sources,
    valid pad rows holding source keys, m = 8, n = 0, n = cap and the
    sentinel-padded source."""
    from delta_tpu.utils.jaxcompat import enable_x64

    sk, sv, n, s = probe_case(name)
    want = reference_probe(sk, sv, n, s)
    got = tkc.slab_probe_plain(torch.from_numpy(sk), torch.from_numpy(sv), n, torch.from_numpy(s))
    assert all(np.array_equal(g.numpy(), w) for g, w in zip(got, want))
    with enable_x64():
        jhead, jt, jfirst = (np.array(x) for x in jkc._probe_sorted_kernel()(
            sk, sv, np.int32(n), s))
    assert jhead[1] == 0  # no overflow: the JAX kernel answers these shapes itself
    assert np.array_equal(jhead, want[0]) and np.array_equal(jt, want[1])
    assert np.array_equal(jfirst[jt], want[2][jt])


# -- K10 at its hard shapes (tests/torch_kernel_cases.py) ------------------------------


@pytest.mark.parametrize("case", COMPACT_CASES)
def test_pair_compact_plain_matches_the_jax_kernel_and_reorder(case):
    """K10's plain version (the CPU path, and the kernel's oracle on the
    card) against a numpy oracle of its contract and against the JAX
    package's K10 followed by its finalize's stable argsort: no match,
    every row, ``out_cap`` equal to the count, matches only past the first
    emit tile and at the last live row, a band of neighbours in both
    orders, pad rows. Where ``out_cap`` is below the count (``short``) the
    port keeps the first pairs in PHYSICAL order and the JAX kernel the
    first in sorted order (a deliberate difference; no caller passes such
    an ``out_cap``)."""
    t, first, perm, out_cap = compact_case(case)
    want = reference_compact(t, first, perm, out_cap)
    got = tkc.pair_compact(torch.from_numpy(t), torch.from_numpy(first), torch.from_numpy(perm),
                           out_cap).numpy()
    assert np.array_equal(got, want)
    jax_order = _jax_pairs_in_physical_order(t, first, perm, out_cap)
    if case == "short":
        idx = np.flatnonzero(t)[:out_cap]  # the JAX kernel's drop: sorted order
        assert np.array_equal(np.sort(jax_order[0]), np.sort(perm[idx]))
        assert not np.array_equal(jax_order, want)
    else:
        assert np.array_equal(jax_order, want)


@pytest.mark.parametrize("case", COMPACT_CASES)
def test_fetch_pairs_lays_out_the_pairs_and_the_count(case):
    """The probe's download (CPU path): the first mc pairs in physical
    order at ``[:mc]`` and ``[mc:2 mc]``, the kernel's count last; a count
    that disagrees with the head's raises."""
    t, first, perm, _ = compact_case(case)
    mc = int(t.sum())
    want = reference_compact(t, first, perm, max(mc, 1))
    args = (torch.from_numpy(t), torch.from_numpy(first), torch.from_numpy(perm))
    host = tkc.fetch_pairs(*args, mc).numpy()
    assert host.dtype == np.int32 and host.shape == (2 * mc + 1,)
    assert np.array_equal(host[:mc], want[0, :mc]) and np.array_equal(host[mc:2 * mc],
                                                                       want[1, :mc])
    assert host[2 * mc] == mc
    with pytest.raises(RuntimeError, match="counted"):
        tkc.fetch_pairs(*args, mc + 1)


@pytest.mark.parametrize("name", CASE_NAMES)
def test_physical_probe_pairs_match_jax_at_hard_shapes(name):
    """A probe through both entries over K9's hard shapes, the slab's rows
    in a shuffled physical order over three files: ``t_pairs`` (physical
    rows ascending, by K10 on the port's side and by the host argsort on
    the JAX side), ``t_bits`` and ``pairs_for_file`` agree."""
    sk, sv, n, s = probe_case(name)
    rng = np.random.RandomState(5)
    phys = rng.permutation(n)
    keys, valid = sk[:n][phys], sv[:n][phys]
    je, te = _slab()
    cuts = [0, n // 3, 2 * n // 3, n]
    for e in (je, te):
        for i in range(3):
            e._append_file(f"f{i}", keys[cuts[i]:cuts[i + 1]], valid[cuts[i]:cuts[i + 1]])
    src = s.astype(np.int64)
    ok = np.ones(len(src), bool)
    pa, pb = je.probe_async(src, ok), te.probe_async(src, ok)
    assert (pa is None) == (pb is None)
    if pa is not None:
        _same(pa.result(), pb.result())


# -- K11's slab advance -------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("case", ADVANCE_CASES)
def test_slab_advance_plain_matches_the_jax_update_kernels(seed, wide, case):
    """One advance through ``slab_advance`` (its plain version on the CPU),
    in place and with every lane written anew, against the JAX package's
    ``_update_kernels`` composed as its tail advance composes them: the
    slice (``slice_append``), the row list (``append`` when keyed, else
    ``kill`` and ``revive``), the runs (``kill`` / ``revive``) and, with the
    sorted view live, ``map_rows`` and the flips of the sorted validity."""
    import jax.numpy as jnp

    from delta_tpu.utils.jaxcompat import enable_x64

    rng = np.random.RandomState(seed)
    cap = 4096
    keys = rng.randint(-(1 << 40), 1 << 40, cap).astype(np.int64)
    valid, sv = rng.rand(cap) > 0.3, rng.rand(cap) > 0.5
    inv = rng.permutation(cap).astype(np.int32)
    parts = advance_case(rng, cap, 200, case, wide)
    buf, lay = tkc.pack_advance(**parts)
    assert lay.keys_i32 == (not wide or case == "mirror")
    kdt = np.int32 if lay.keys_i32 else np.int64
    mirror = case == "mirror"
    upd = jkc._update_kernels()
    with enable_x64():
        k, v, s = jnp.asarray(keys), jnp.asarray(valid), jnp.asarray(sv)
        if "slice_keys" in parts:
            k, v = upd["slice_append"](k, v, np.int32(parts["start"]),
                                       parts["slice_keys"].astype(kdt), parts["slice_valid"])
        rows, rv = parts["rows"], parts["rows_valid"]
        run_rows = np.concatenate([np.arange(o, o + n) for o, n in parts["runs"]])
        run_v = np.repeat(parts["run_valid"], parts["runs"][:, 1])
        if "rows_keys" in parts:
            k, v = upd["append"](k, v, rows, parts["rows_keys"].astype(kdt), rv)
            flips = [(run_rows, run_v)]
        else:
            flips = [(rows, rv), (run_rows, run_v)]
        for r, val in flips:
            for value in (False, True):
                pick = np.where(val == value, r, cap).astype(np.int32)
                v = upd["revive" if value else "kill"](v, pick)
                if mirror:
                    s = upd["revive" if value else "kill"](s, upd["map_rows"](inv, pick))
        want = [np.asarray(x) for x in (k, v, s)]
    for copy in ((), ("keys", "valid", "sorted_valid")):
        tk, tv, ts = (torch.from_numpy(x.copy()) for x in (keys, valid, sv))
        got = tkc.slab_advance(tk, tv, torch.from_numpy(buf), lay, ts if mirror else None,
                               torch.from_numpy(inv) if mirror else None, copy=copy)
        assert np.array_equal(got[0].numpy(), want[0]) and np.array_equal(got[1].numpy(), want[1])
        if mirror:
            assert np.array_equal(got[2].numpy(), want[2])
        inputs = (tk, tv) + ((ts,) if mirror else ())
        # new lanes under copy (keys are not written in the mirror case), the
        # inputs then as they were
        assert all((g is t) == (not copy or (mirror and i == 0))
                   for i, (g, t) in enumerate(zip(got, inputs)))
        if copy:
            assert np.array_equal(tk.numpy(), keys) and np.array_equal(tv.numpy(), valid)
            assert np.array_equal(ts.numpy(), sv)


def test_slab_advance_refuses_a_mirror_with_key_changes():
    cap = 64
    buf, lay = tkc.pack_advance(start=3, slice_keys=[1, 2], slice_valid=[True, True])
    k, v = torch.zeros(cap, dtype=torch.int64), torch.zeros(cap, dtype=torch.bool)
    with pytest.raises(ValueError, match="sorted view"):
        tkc.slab_advance(k, v, torch.from_numpy(buf), lay, torch.zeros(cap, dtype=torch.bool),
                         torch.arange(cap, dtype=torch.int32))
    with pytest.raises(ValueError, match="match its rows"):
        tkc.pack_advance(rows=[1, 2], rows_valid=[True])


def _random_batch(rng, live, sizes, step):
    """One batch of mutations, the same on every entry: appended files, a
    removed file, a deletion vector set on a file appended in the same batch
    and then shrunk (scatter, kill and revive on the same rows), and one
    grown and shrunk on an older file. A shrink keeps a subset of the
    vector before it: the JAX package's flush kills before it revives, so a
    row revived and then killed in one batch would end valid there (a tail
    advance sets a file's vector once)."""
    ops = []
    for i in range(rng.randint(1, 3)):
        n = int(rng.randint(20, 300))
        keys = rng.randint(-(1 << 31), 1 << 31, n).astype(np.int64)
        if step % 3 == 2:
            keys[:3] = [1 << 40, -(1 << 40), 7]  # past int32: shipped as int64
        ok = rng.rand(n) > 0.05
        ops.append(("append", f"f{step}-{i}", np.where(ok, keys, 0), ok))
        sizes[ops[-1][1]] = n
    if len(live) > 2 and rng.rand() < 0.6:
        ops.append(("kill", live[rng.randint(len(live))]))
    for path in (ops[0][1], live[rng.randint(len(live))]):
        rows = sizes[path]
        grown = rng.choice(rows, int(rows * 0.3), replace=False)
        ops.append(("dv", path, np.sort(grown)))
        ops.append(("dv", path, np.sort(grown[:int(rows * 0.1)])))
    return ops


def _apply(entry, ops):
    with entry.device_batch():
        for op in ops:
            if op[0] == "append":
                entry._append_file(op[1], op[2], op[3])
            elif op[0] == "kill":
                entry._kill_file(op[1])
            elif op[1] in entry.slabs:
                assert entry._set_dv(op[1], op[2])


def _jax_scatter(je, row_idx, keys, valid):
    """The JAX entry's scatter of appended rows through its ``append``
    kernel, the rows padded with cap: the package's own non-contiguous
    path reuses its row count's name as a loop variable
    (``delta_tpu/ops/key_cache.py:748``) and raises there, so the test
    composes that path's kernel itself."""
    import jax.numpy as jnp

    from delta_tpu.utils.jaxcompat import enable_x64

    a = tkc._next_pow2(max(len(keys), 1), floor=64)
    rows = np.full(a, je.capacity, np.int32)
    rows[:len(keys)] = row_idx
    nk, nv = np.zeros(a, np.int64), np.zeros(a, bool)
    nk[:len(keys)], nv[:len(keys)] = keys, valid
    je._sort_stale = True
    for name in ("sorted_keys", "perm", "inv_perm", "sorted_valid"):
        je._dev.pop(name, None)
    with enable_x64():
        je._dev["keys"], je._dev["valid"] = jkc._update_kernels()["append"](
            je._dev["keys"], je._dev["valid"], jnp.asarray(rows), jnp.asarray(nk),
            jnp.asarray(nv))


def _lanes_hold(te, je):
    """The port's device lanes equal its mirrors, and file by file (the two
    entries may append a tail's files in another order) the JAX entry's
    lanes; rows of no live file are invalid in both."""
    n = te.num_rows
    assert te.slabs == je.slabs or te.slabs.keys() == je.slabs.keys()
    assert te.is_resident == je.is_resident
    if not te.is_resident:
        return
    d = te._dev
    tk, tv = d["keys"].numpy(), d["valid"].numpy()
    jk, jv = np.asarray(je._dev["keys"]), np.asarray(je._dev["valid"])
    assert np.array_equal(tk[:n], te.h_keys) and np.array_equal(tv[:n], te.h_valid)
    assert not tv[n:].any() and not jv[je.num_rows:].any()
    for e, v in ((te, tv), (je, jv)):
        live = np.zeros(e.num_rows, bool)
        for off, rows in e.slabs.values():
            live[off:off + rows] = True
        assert not v[:e.num_rows][~live].any()
    for path, (off, rows) in te.slabs.items():
        joff, jrows = je.slabs[path]
        assert rows == jrows
        assert np.array_equal(tk[off:off + rows], jk[joff:joff + rows])
        assert np.array_equal(tv[off:off + rows], jv[joff:joff + rows])
    if not te._sort_stale and "sorted_valid" in d:
        pm = d["perm"].long()
        assert torch.equal(d["sorted_valid"], d["valid"][pm] & (pm < n))


def _probe_by_file(je, te, s):
    """Both probes of ``s`` agree per source row and, file by file, on the
    matched pairs (in each file's own rows)."""
    s = np.asarray(s, np.int64)
    a = je.probe_async(s, np.ones(len(s), bool)).result()
    b = te.probe_async(s, np.ones(len(s), bool)).result()
    assert np.array_equal(a.s_matched, b.s_matched) and a.any_multi == b.any_multi
    for path, (_, rows) in b.slabs.items():
        pa_, pb = a.pairs_for_file(path, None, rows), b.pairs_for_file(path, None, rows)
        assert all(np.array_equal(x, y) for x, y in zip(pa_, pb))


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_flush_advance_matches_the_jax_entry(seed):
    """Random batches through the mutators of both entries: after each
    advance (one ``slab_advance`` on the port's side, the JAX package's
    scatter, kill and revive updates on its side) the port's lanes equal its
    mirrors and the JAX entry's lanes, its sorted view stays consistent
    where it is live, and the probes agree."""
    rng = np.random.RandomState(seed)
    je, te = _slab()
    je._dev_scatter_rows = lambda *a: _jax_scatter(je, *a)
    sizes, live = {}, []
    for i in range(3):
        n = 500 + 100 * i
        keys = rng.randint(-5000, 5000, n).astype(np.int64)
        for e in (je, te):
            e._append_file(f"base{i}", keys, np.ones(n, bool))
        sizes[f"base{i}"] = n
        live.append(f"base{i}")
    for e in (je, te):
        e.ensure_resident()
        e._ensure_sorted()
    before = tkc.native.launches["slab_advance"]
    for step in range(6):
        ops = _random_batch(rng, live, sizes, step)
        for op in ops:
            if op[0] == "append":
                live.append(op[1])
            elif op[0] == "kill":
                live.remove(op[1])
        for e in (je, te):
            _apply(e, ops)
        _lanes_hold(te, je)
        for e in (je, te):  # the probe re-sorts a stale view, as a MERGE would
            e.ensure_resident()
        s = np.concatenate([te.h_keys[rng.randint(0, te.num_rows, 50)], rng.randint(-9000, 9000, 50)])
        _probe_both(je, te, s)
    assert tkc.native.launches["slab_advance"] == before  # the plain version counts nothing


def test_a_row_revived_then_killed_in_one_batch_ends_killed():
    """Each touched row goes to the card once, with its final validity from
    the mirror: two vectors set on one file in one batch, the second
    deleting rows the first revived, leave them invalid, as the same two
    vectors in two batches leave the JAX entry."""
    je, te = _slab()
    keys = np.arange(100, dtype=np.int64)
    for e in (je, te):
        e._append_file("f", keys, np.ones(100, bool))
        e.ensure_resident()
        e._ensure_sorted()
        assert e._set_dv("f", np.arange(10))
    with te.device_batch():
        assert te._set_dv("f", np.arange(5, 10))  # revives rows 0-4
        assert te._set_dv("f", np.arange(3))  # kills rows 0-2 again
    for dv in (np.arange(5, 10), np.arange(3)):
        with je.device_batch():
            assert je._set_dv("f", dv)
    _lanes_hold(te, je)
    assert te._dev["valid"][:5].tolist() == [False, False, False, True, True]
    _probe_both(je, te, [0, 3, 7, 12])


def test_advance_writes_in_place_unless_a_probe_holds_the_lanes(tmp_table, monkeypatch):
    """No probe in flight: an advance keeps every lane tensor (the same
    storage). A probe in flight: the advance binds a new sorted validity,
    writes keys and validity in place (no probe reads them), the pinned
    probe answers its own version, and its pin is gone once it has."""
    from delta_tpu.commands.delete import DeleteCommand

    log = _mk_table(tmp_table, files=5)
    je, te = _entries(tmp_table)
    te.ensure_resident()
    te._ensure_sorted()
    ptrs = {k: t.data_ptr() for k, t in te._dev.items()}
    path = sorted(te.slabs)[0]
    off, rows = te.slabs[path]
    assert te._dev["sorted_valid"].sum() == te._dev["valid"].sum() == te.num_rows
    with te.device_batch():
        te._kill_file(path)
    assert {k: t.data_ptr() for k, t in te._dev.items()} == ptrs and te._pins == 0
    assert not te._dev["valid"][off:off + rows].any()
    assert te._dev["sorted_valid"].sum() == te._dev["valid"].sum() == te.num_rows - rows

    log2 = _mk_table(tmp_table + "2", files=5)
    je, te = _entries(tmp_table + "2")
    te.ensure_resident()
    want = je.probe_async(np.array([5, 60, 150]), np.ones(3, bool)).result()
    started, advanced = threading.Event(), threading.Event()
    real = tkc.slab_probe

    def held(*args):
        started.set()
        assert advanced.wait(30)
        return real(*args)

    monkeypatch.setattr(tkc, "slab_probe", held)
    pending = te.probe_async(np.array([5, 60, 150]), np.ones(3, bool))
    assert started.wait(30) and te._pins == 1
    ptrs = {k: t.data_ptr() for k, t in te._dev.items()}
    DeleteCommand(log2, "k < 80").run()
    _, te2 = _entries(tmp_table + "2")
    assert te2 is te
    now = {k: t.data_ptr() for k, t in te._dev.items()}
    assert now["sorted_valid"] != ptrs["sorted_valid"]
    assert all(now[k] == ptrs[k] for k in ("keys", "valid", "sorted_keys", "perm", "inv_perm"))
    advanced.set()
    _same(want, pending.result())
    assert te._pins == 0
    monkeypatch.setattr(tkc, "slab_probe", real)
    je2, _ = _entries(tmp_table + "2")
    _probe_both(je2, te, [5, 60, 150])
    ptrs = {k: t.data_ptr() for k, t in te._dev.items()}
    DeleteCommand(log2, "k >= 160").run()  # the whole last file: a run
    _, te3 = _entries(tmp_table + "2")
    assert te3 is te and {k: t.data_ptr() for k, t in te._dev.items()} == ptrs


@pytest.mark.parametrize("dv", [False, True])
def test_lanes_follow_a_delete_merge_and_dv_sequence(tmp_table, dv, monkeypatch):
    """After each commit of a DELETE / MERGE / deletion-vector sequence the
    advanced entry's device lanes equal its host mirrors and the JAX
    entry's lanes, and the probes agree. (A JAX command that rewrites files
    drops the JAX cache's entries; here that entry is kept, so both advance
    over the same tails.)"""
    from delta_tpu.commands.alter import set_table_properties
    from delta_tpu.commands.delete import DeleteCommand
    from delta_tpu.commands.merge import MergeClause, MergeIntoCommand

    monkeypatch.setattr(jkc.KeyCache, "bump_epoch", lambda self, log_path: None)
    log = _mk_table(tmp_table, files=4)
    if dv:
        set_table_properties(log, {"delta.tpu.enableDeletionVectors": "true"})
    je, te = _entries(tmp_table)
    je._dev_scatter_rows = lambda *a: _jax_scatter(je, *a)
    je.ensure_resident()
    te.ensure_resident()
    te._ensure_sorted()
    rng = np.random.RandomState(9)

    def merge():
        src = pa.table({"k": np.arange(180, 260, 3, dtype=np.int64),
                        "v": rng.rand(len(range(180, 260, 3)))})
        MergeIntoCommand(log, src, "t.k = s.k",
                         [MergeClause("update", assignments={"v": "s.v"})],
                         [MergeClause("insert")], source_alias="s", target_alias="t").run()

    steps = [lambda: DeleteCommand(log, "k = 42 OR k = 120").run(),
             merge,
             lambda: DeleteCommand(log, "k < 50").run(),
             lambda: WriteIntoDelta(log, "append", pa.table({
                 "k": np.arange(900, 960, dtype=np.int64), "v": np.zeros(60)})).run(),
             lambda: DeleteCommand(log, "k > 930 AND k < 940").run()]
    with conf.set_temporarily(**{"delta.tpu.deletionVectors.enabled": dv,
                                 "delta.tpu.merge.devicePath.mode": "off"}):
        for step in steps:
            step()
            je2, te2 = _entries(tmp_table)
            assert je2 is je and te2 is te and te.version == je.version
            _lanes_hold(te, je)
            _probe_by_file(je, te, [42, 43, 120, 181, 184, 900, 935, 959, 2000])

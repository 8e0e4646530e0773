"""The port's CUDA kernels on the card, each against its plain PyTorch
version, and the scan path on the card against the same path on the CPU.

Every test here is marked ``gpu`` and skips inside the test when no CUDA
device is visible. The file imports torch, numpy and ``delta_tpu_torch``
only (no JAX, no pyarrow), so it also runs where the JAX package cannot be
imported:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerance: exact equality (bits, packed bytes, f32 lanes bit for bit, file
lists, key-slab flags and pairs).
"""
import json

import numpy as np
import pytest
import torch

from delta_tpu_torch import DeltaLog
from delta_tpu_torch.expr.parser import parse_expression
from delta_tpu_torch.ops import key_cache, native, pruning, replay_kernel, state_cache
from delta_tpu_torch.protocol import filenames
from delta_tpu_torch.protocol.actions import AddFile, Metadata, Protocol, RemoveFile
from delta_tpu_torch.schema.types import DoubleType, IntegerType, LongType, StringType, StructType

# tests/, on the path as chip_smoke is: numpy only
from torch_kernel_cases import (
    ADVANCE_CASES, CASE_NAMES, CODEC_FAULTS, COMBINE_KS, COMBINE_NS, COMPACT_CASES, TAIL_CASES,
    ZSORT_CASES,
    WINNER_CASES, advance_case, combine_case, combine_rows, compact_case, probe_case,
    reference_combine, reference_compact, reference_key_order, reference_rank,
    reference_winner, tail_case, winner_case, zsort_case,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU build")
    return torch.device("cuda")


def _same(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a.cpu(), b.cpu())


def _cull_inputs(rng, c, cap, m, case):
    mins = (rng.rand(c, cap) * 100).astype(np.float32)
    maxs = mins + (rng.rand(c, cap) * 3).astype(np.float32)
    mins[:, rng.rand(cap) < 0.05] = np.nan
    maxs[:, rng.rand(cap) < 0.05] = np.nan
    mins[0, 7], maxs[0, 7] = np.inf, -np.inf  # a null partition value's lanes
    alive = rng.rand(cap) > 0.2
    lo = (rng.rand(m, c) * 100).astype(np.float32)
    hi = lo + (rng.rand(m, c) * 0.5).astype(np.float32)
    lo[rng.rand(m, c) < 0.2] = np.nan
    hi[rng.rand(m, c) < 0.2] = np.nan
    if case == "nan_rows":  # whole queries with no bound: they keep every live file
        lo[::3], hi[::3] = np.nan, np.nan
    elif case == "inf_bounds":
        lo[::2, 0], hi[1::2, 0] = -np.inf, np.inf
        lo[::3, -1], hi[1::3, -1] = np.inf, -np.inf
    elif case == "ties":  # equal bounds across queries, and a file's own bounds
        lo[:, 0], hi[:, 0] = lo[0, 0], hi[0, 0]
        lo[::2, -1], hi[1::2, -1] = mins[-1, 100], maxs[-1, 100]
    elif case == "sorted":  # clustered lanes: a warp's box drops most queries
        mins[:] = np.sort(rng.rand(c, cap) * 100, axis=1)
        maxs[:] = mins + np.float32(0.01)
        mins[:, ::50] = np.nan
    elif case == "inf_lanes":  # files with infinite stats, in both orders
        mins[:, rng.rand(cap) < 0.05] = -np.inf
        maxs[:, rng.rand(cap) < 0.05] = np.inf
        mins[0, ::97], maxs[0, ::97] = np.inf, -np.inf
    return mins, maxs, alive, lo, hi


@pytest.mark.parametrize("c,cap,m,case", [
    (1, 1024, 1, "random"), (4, 1 << 20, 256, "random"), (5, 8192, 37, "random"),
    (40, 8192, 33, "random"),
    (4, 8192, 1, "random"), (4, 8192, 2, "random"), (4, 8192, 31, "random"),
    (4, 1 << 16, 33, "random"), (4, 8192, 64, "random"), (4, 1 << 16, 257, "random"),
    (4, 8192, 40, "nan_rows"), (4, 8192, 1, "nan_rows"), (3, 8192, 70, "inf_bounds"),
    (3, 8192, 70, "ties"), (4, 8192, 20, "inf_lanes"),
    (4, 9216, 5, "random"), (100, 8192, 200, "random"), (3, 8192, 600, "nan_rows"),
    (4, 1 << 16, 300, "sorted"), (4, 1 << 16, 1, "sorted")])
def test_block_cull_kernel_matches_plain(cuda, c, cap, m, case):
    rng = np.random.RandomState(cap + m + c)
    ts = [torch.from_numpy(a).to(cuda) for a in _cull_inputs(rng, c, cap, m, case)]
    before = native.launches["block_cull"]
    got = state_cache.block_cull(*ts)
    torch.cuda.synchronize()
    assert native.launches["block_cull"] == before + 1
    assert _same(got, state_cache.block_cull_plain(*ts))


def test_scatter_kernels_match_plain(cuda):
    rng = np.random.RandomState(9)
    cap = 1 << 20
    rows = np.full(1024, cap, np.int32)
    rows[:700] = rng.choice(cap, 700, replace=False)
    rows[700:705] = [-1, -cap, -cap - 1, cap + 3, 1 << 30]  # XLA wrap / drop
    r = torch.from_numpy(rows).to(cuda)
    a = torch.from_numpy(rng.rand(cap) > 0.5).to(cuda)
    b = a.clone()
    state_cache.scatter_bool(a, r, False)
    state_cache.scatter_bool_plain(b, r, False)
    m = torch.from_numpy(rng.rand(4, cap).astype(np.float32)).to(cuda)
    n = m.clone()
    v = torch.from_numpy(rng.rand(4, 1024).astype(np.float32)).to(cuda)
    v[:, ::5] = float("nan")
    state_cache.scatter_cols(m, r, v)
    state_cache.scatter_cols_plain(n, r, v)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and _same(m, n)


@pytest.mark.parametrize("c", [1, 4])
@pytest.mark.parametrize("case", TAIL_CASES)
def test_tail_apply_kernel_matches_plain(cuda, c, case):
    """The fused tail apply (K3 with K2 on its launch) in one launch on the
    buffer ``_apply_tail_device`` uploads, against the four plain calls."""
    alive, mins, maxs, dead, start, k, lo, hi = tail_case(c, case, cap=1 << 20)
    on = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
    got = [on(x) for x in (alive, mins, maxs)]
    ref = [x.clone() for x in got]
    buf = on(np.concatenate([dead, lo.view(np.int32).ravel(), hi.view(np.int32).ravel()]))
    vals = buf[len(dead):].view(torch.float32).view(2, c, k)
    before = native.launches["tail_apply"]
    state_cache.tail_apply(*got, buf[:len(dead)], start, k, vals[0], vals[1])
    torch.cuda.synchronize()
    assert native.launches["tail_apply"] == before + 1
    state_cache.tail_apply_plain(*ref, on(dead), start, k, on(lo), on(hi))
    assert torch.equal(got[0], ref[0]) and _same(got[1], ref[1]) and _same(got[2], ref[2])


def test_tail_on_the_card_is_one_upload_and_one_launch(cuda, tmp_path):
    rng = np.random.RandomState(6)
    path = str(tmp_path / "t")
    _table(path, 3000, False, rng)
    log = DeltaLog.for_table(path, device=cuda)
    entry = state_cache.DeviceStateCache.instance().get(log.update())
    entry.ensure_resident()
    _tail(path, 2, 3000, False, rng)
    snap = log.update()
    before = dict(native.launches)
    assert state_cache.DeviceStateCache.instance().get(snap) is entry
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in native.launches.items() if v != before[k]}
    assert moved == {"tail_apply": 1}
    lanes = {k: v.clone() for k, v in entry._dev.items()}
    entry.drop_device()
    entry.ensure_resident()
    assert all(_same(lanes[k], entry._dev[k]) for k in ("alive", "mins", "maxs"))


@pytest.mark.parametrize("n,num_paths", [(8, 3), (1 << 20, 100_000), (1 << 24, 1 << 21)])
def test_winner_bits_kernel_matches_plain(cuda, n, num_paths):
    rng = np.random.RandomState(1)
    pid = rng.randint(0, num_paths, n).astype(np.int32)
    pid[rng.rand(n) < 0.1] = -1
    p = torch.from_numpy(pid).to(cuda)
    got = replay_kernel.winner_bits(p, num_paths)
    torch.cuda.synchronize()
    assert torch.equal(got, replay_kernel.winner_bits_plain(p, num_paths))


def test_winner_bits_kernel_rejects_out_of_range_ids(cuda):
    # the card's call does not synchronise: the error word rides after the
    # mask, and winner_mask_device, which downloads both, raises
    with pytest.raises(ValueError):
        replay_kernel.winner_mask_device(np.arange(8, dtype=np.int32), 7, device=cuda)
    # the table and the flag are clean again: the next call is exact
    pid, num_paths = winner_case("random", 1 << 12)
    got = replay_kernel.winner_mask_device(pid, num_paths, device=cuda)
    assert np.array_equal(np.packbits(got), reference_winner(pid))


@pytest.mark.parametrize("n", [8, 1 << 20])
@pytest.mark.parametrize("case", WINNER_CASES)
def test_winner_bits_cases(cuda, case, n):
    pid, num_paths = winner_case(case, n)
    p = torch.from_numpy(pid).to(cuda)
    ref = reference_winner(pid)
    for _ in range(2):  # twice on one table: the first call left it clean
        got = replay_kernel.winner_bits(p, num_paths)
        assert np.array_equal(got.cpu().numpy(), ref)
    assert torch.equal(got, replay_kernel.winner_bits_plain(p, num_paths))


def test_winner_bits_big_and_unaligned(cuda):
    pid, num_paths = winner_case("zipf", 1 << 24)
    p = torch.from_numpy(pid).to(cuda)
    assert np.array_equal(replay_kernel.winner_bits(p, num_paths).cpu().numpy(),
                          reference_winner(pid))
    # a base off a 16-byte boundary takes the scalar loads; n not a
    # multiple of 32 leaves a tail of bytes past the last full word
    buf = torch.from_numpy(np.concatenate([[0], pid[:1000]]).astype(np.int32)).to(cuda)
    got = replay_kernel.winner_bits(buf[1:], num_paths)
    assert np.array_equal(got.cpu().numpy(), reference_winner(pid[:1000]))
    # a smaller num_paths on the grown table, then an out-of-range id
    pid2, np2 = winner_case("num-paths-1", 1 << 16)
    assert np.array_equal(np.packbits(replay_kernel.winner_mask_device(pid2, np2, device=cuda)),
                          reference_winner(pid2))
    with pytest.raises(ValueError):
        replay_kernel.winner_mask_device(np.array([0, 1, 5, -1]), 5, device=cuda)
    assert np.array_equal(np.packbits(replay_kernel.winner_mask_device(pid2, np2, device=cuda)),
                          reference_winner(pid2))


def _write(path, version, actions):
    DeltaLog.for_table(path, device="cpu").store.write(
        f"{path}/_delta_log/{filenames.delta_file(version)}", [a.json() for a in actions])


def _table(path, n, partitioned, rng):
    schema = StructType().add("c0", LongType()).add("c1", DoubleType())
    pcols = []
    if partitioned:
        schema = schema.add("day", StringType()).add("bucket", IntegerType())
        pcols = ["day", "bucket"]
    _write(path, 0, [Protocol(1, 2), Metadata(schema_string=schema.to_json(),
                                              partition_columns=pcols)])
    c0 = np.sort(rng.randint(0, 1 << 22, n))
    c1 = np.sort(rng.rand(n) * 1e4)
    adds = []
    for i in range(n):
        st = json.dumps({"numRecords": 3, "minValues": {"c0": int(c0[i]), "c1": float(c1[i])},
                         "maxValues": {"c0": int(c0[i]) + 300, "c1": float(c1[i]) + 2},
                         "nullCount": {"c0": 0, "c1": 0}})
        pv = ({"day": f"2021-01-{1 + i * 28 // n:02d}",
               "bucket": None if i % 53 == 0 else str(i % 7)} if partitioned else {})
        adds.append(AddFile(path=f"part-{i:06d}.parquet", size=100 + i,
                            partition_values=pv, stats=st))
    _write(path, 1, adds)
    return c0, c1


def _tail(path, version, n, partitioned, rng):
    acts = [RemoveFile(path=f"part-{i:06d}.parquet", deletion_timestamp=version)
            for i in rng.choice(n, 30, replace=False)]
    for j in range(60):
        c0 = int(rng.randint(0, 1 << 22))
        pv = {"day": "2021-02-01", "bucket": str(j % 9)} if partitioned else {}
        st = json.dumps({"numRecords": 3, "minValues": {"c0": c0, "c1": 1.0},
                         "maxValues": {"c0": c0 + 300, "c1": 9999.0},
                         "nullCount": {"c0": 0, "c1": 0}})
        acts.append(AddFile(path=f"tail-{version}-{j}.parquet", size=j,
                            partition_values=pv, stats=st))
    _write(path, version, acts)


@pytest.mark.parametrize("partitioned", [False, True])
def test_scans_on_the_card_match_the_cpu(cuda, tmp_path, partitioned):
    rng = np.random.RandomState(4)
    path = str(tmp_path / "t")
    n = 5000
    c0, _ = _table(path, n, partitioned, rng)
    queries = [f"c0 >= {int(c0[i])} AND c0 <= {int(c0[i]) + 500}" for i in range(0, n, 250)]
    queries += ["c1 <= 100.0", "c0 IN (5, 70000)", "c0 <= 100 OR c0 >= 4000000"]
    if partitioned:
        queries += ["day = '2021-01-05'", "bucket >= 4", "day = '2021-01-09' AND c0 >= 100"]
    # the card's plan pinned to the block cull: under auto the router may
    # price the host plan cheaper, and the lanes would not be on the card
    from delta_tpu_torch.utils.config import conf

    with conf.set_temporarily(**{"delta.tpu.stateCache.devicePlan.mode": "force"}):
        for version in (1, 2, 3):
            if version > 1:
                _tail(path, version, n, partitioned, rng)
            on_card = DeltaLog.for_table(path, device=cuda).update()
            on_cpu = DeltaLog.for_table(path, device="cpu").update()
            for q in queries:
                a = pruning.files_for_scan(on_card, [parse_expression(q)])
                b = pruning.files_for_scan(on_cpu, [parse_expression(q)])
                assert [f.json() for f in a.files] == [f.json() for f in b.files], q
                assert (a.total, a.partition, a.scanned) == (b.total, b.partition, b.scanned), q
    entry = state_cache.DeviceStateCache.instance().get(on_card)
    assert entry._dev["mins"].is_cuda


# -- K15 and K5 (the second slice) ---------------------------------------------


def _k15_matches_plain(program, env, sql):
    import chip_smoke
    from delta_tpu_torch.expr import device_eval

    got = device_eval.expr_eval(program, env)
    torch.cuda.synchronize()
    ref = device_eval.expr_eval_plain(program, env)
    assert got.values.dtype == ref.values.dtype and got.values.shape == ref.values.shape, sql
    assert torch.equal(got.valid, ref.valid), sql
    if got.values.is_floating_point():
        lanes, ulps = chip_smoke.ulp_diff(got.values, ref.values)
        assert lanes == 0 or (any(f in sql for f in chip_smoke._TRANSCENDENTAL)
                              and ulps <= 1), sql
    else:
        assert torch.equal(got.values, ref.values), sql


@pytest.mark.parametrize("n", [4096, 5001, 14])
def test_expr_eval_kernel_matches_plain(cuda, n):
    """chip_smoke.py's corpus (every opcode K15 runs, 0-d programs among
    them) at 4096 rows, at a row count that is no multiple of any tile and
    at 14 rows: bit for bit, except exp / log / pow / sqrt, within 1 ulp;
    one launch a call."""
    import chip_smoke
    from delta_tpu_torch.expr import device_eval

    env = chip_smoke.k15_columns(n, 5, cuda)
    before = native.launches["expr_eval"]
    ops = set()
    for sql in chip_smoke.K15_CORPUS:
        program = device_eval.compile_expr(parse_expression(sql)).program(env)
        ops.update(program.opcodes())
        _k15_matches_plain(program, env, sql)
    assert native.launches["expr_eval"] == before + len(chip_smoke.K15_CORPUS)
    assert ops == set(device_eval.OPS) - set(device_eval.RESIDUAL_OPS)


def test_expr_eval_kernel_edge_cases(cuda):
    """K15 on K14's tile body at its edges: one row; an IN whose column
    option is half NULL, and one whose only NULL option row is the last (the
    reduction over every row must be final before any row reads it); a
    program past the launch's parameters (the staged tables); lanes that
    are views at an offset (their starts off a 16-byte boundary)."""
    import chip_smoke
    from delta_tpu_torch.expr import device_eval
    from delta_tpu_torch.ops import column_cache

    rng = np.random.RandomState(9)
    one = device_eval.columns_from_numpy({"a": np.array([3], np.int64), "b": np.array([2.5])},
                                         {"b": np.array([False])}, device=cuda)
    for sql in ("a + 1", "a IN (b, 3)", "b IN (a, NULL)", "1 + 2 > 2", "coalesce(b, a)"):
        _k15_matches_plain(device_eval.compile_expr(parse_expression(sql)).program(one), one,
                           sql)
    n = 1_005_000
    env = chip_smoke.k15_columns(n, 3, cuda)
    half = dict(env, b=device_eval.DeviceColumn(env["b"].values, torch.from_numpy(
        rng.rand(n) > 0.5).to(cuda)))
    last = np.ones(n, bool)
    last[-1] = False
    tail = dict(env, a=device_eval.DeviceColumn(env["a"].values, torch.from_numpy(last).to(cuda)),
                g=device_eval.DeviceColumn(env["g"].values, torch.ones(n, dtype=torch.bool,
                                                                      device=cuda)))
    for e, sql in ((half, "a IN (b, 3, NULL)"), (half, "a IN (b, 3)"), (tail, "b IN (a, g)"),
                   (tail, "NOT (b IN (a, g))"), (env, "(a IN (1, 2)) IN (flag, (a IN (b, NULL)))"),
                   (env, "a IN (%s)" % ", ".join(map(str, range(-100, 100)))),
                   (env, "b IN (%s)" % ", ".join(f"{v}.5" for v in range(200)))):
        program = device_eval.compile_expr(parse_expression(sql)).program(e)
        _k15_matches_plain(program, e, sql)
    big = device_eval.compile_expr(parse_expression("a IN (%s)" % ", ".join(
        map(str, range(200))))).program(env)
    layout, _ = device_eval._k15_blocks(big, [env["a"]], n)
    assert layout is column_cache._K14_GLOBAL
    # lanes at an offset: values 8 B (one row in), 4 B and 1 B off, validity 3 B off
    m = 4099
    base = chip_smoke.k15_columns(m + 8, 4, cuda)
    views = {k: device_eval.DeviceColumn(c.values[1:m + 1], c.valid[3:m + 3])
             for k, c in base.items()}
    assert views["a"].values.data_ptr() % 16 and views["a"].valid.data_ptr() % 16
    for sql in ("a > 2 AND (b < 20 OR flag)", "i * i", "g * g - g", "a IN (b, 3, NULL)",
                "CASE WHEN flag THEN b ELSE g END", "hour(t)", "big + i"):
        program = device_eval.compile_expr(parse_expression(sql)).program(views)
        _k15_matches_plain(program, views, sql)


@pytest.mark.parametrize("n,num_paths", [(8, 3), (4096, 1000), (1 << 20, 1 << 18)])
def test_replay_kernel_matches_plain(cuda, n, num_paths):
    rng = np.random.RandomState(n)
    pid = rng.randint(0, num_paths, n).astype(np.int32)
    pid[rng.rand(n) < 0.05] = -1
    cols = [torch.from_numpy(x).to(cuda) for x in (
        pid, rng.permutation(n).astype(np.int64) * 5, rng.rand(n) > 0.3,
        rng.randint(0, 2**62, n).astype(np.int64), rng.randint(0, 100, n).astype(np.int64))]
    for cutoff in (0, 50):
        got = replay_kernel.replay(*cols, num_paths, cutoff)
        torch.cuda.synchronize()
        ref = replay_kernel.replay_plain(*cols, num_paths, cutoff)
        assert all(torch.equal(g, r) for g, r in zip(got, ref))


def test_replay_sums_do_not_hold_the_winner_table(cuda):
    """K5's sums come back in a buffer of their own: a caller that keeps
    them does not keep the kernel's winner table (8 B a path) alive."""
    n, num_paths = 4096, 1 << 20
    p = torch.arange(n, dtype=torch.int32, device=cuda)
    z = torch.zeros(n, dtype=torch.int64, device=cuda)
    sums = replay_kernel.replay(p, z + p, torch.ones(n, dtype=torch.bool, device=cuda), z, z,
                                num_paths)[2]
    assert sums.tolist() == [n, 0, 0]
    assert sums.untyped_storage().nbytes() == 3 * 8


def test_replay_kernel_rejects_out_of_range_ids(cuda):
    p = torch.arange(8, dtype=torch.int32, device=cuda)
    z = torch.zeros(8, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        replay_kernel.replay(p, z, torch.ones(8, dtype=torch.bool, device=cuda), z, z, 7)


def test_normal_leg_on_the_card_matches_the_cpu(cuda, tmp_path):
    """Queries the resident planner declines, over 4200 files: the card's
    K15 prune and the CPU's plain prune return the same files."""
    rng = np.random.RandomState(8)
    path = str(tmp_path / "t")
    _table(path, 4200, False, rng)
    on_card = DeltaLog.for_table(path, device=cuda).update()
    on_cpu = DeltaLog.for_table(path, device="cpu").update()
    before = native.launches["expr_eval"]
    for q in ["c1 > 5000.5", "c0 * c1 > 1e10", "c0 IS NULL OR c1 * 2 > 19000",
              "c0 != 5 AND c1 < 100.25", "abs(c1 - 300.5) < 2 OR c0 > 4000000.5"]:
        a = pruning.files_for_scan(on_card, [parse_expression(q)])
        b = pruning.files_for_scan(on_cpu, [parse_expression(q)])
        assert [f.json() for f in a.files] == [f.json() for f in b.files], q
    assert native.launches["expr_eval"] > before


# -- K8-K11 and the MERGE key slab (the third slice) ---------------------------------


def _equal_all(got, ref):
    return all(torch.equal(g, r) for g, r in zip(got, ref))


def _sort_lanes(rng, n, cap, kind):
    """Key lanes for K8: ``mixed`` is full-range keys, dense duplicates and
    the int64 extremes (every byte varies), then the same masked to 16 bits;
    the others name the one lane they make."""
    keys = rng.randint(-(1 << 62), 1 << 62, cap).astype(np.int64)
    if kind == "mixed":
        keys[: n // 3] = rng.randint(-20, 20, n // 3)
        keys[:2] = [(1 << 63) - 1, -(1 << 63)]
        return [keys, keys & 0xFFFF]
    if kind == "wide":  # 44 varying bits: a 6-byte span, the uint64 words
        return [rng.randint(0, 1 << 44, cap).astype(np.int64)]
    if kind == "cross":  # bits 12..27 over a fixed high part: bytes 1-3
        base = np.int64(0x5A5A_0000_0000_0000 - (1 << 62))
        return [base + (rng.randint(0, 1 << 16, cap).astype(np.int64) << 12)]
    if kind == "equal":  # no byte varies: no pass
        keys[:n] = -123456789
        return [keys]
    if kind == "dups":  # four keys over many rows: stability
        return [rng.randint(0, 4, cap).astype(np.int64) * (1 << 33)]
    raise ValueError(kind)


@pytest.mark.parametrize("n,cap,kind", [
    (0, 1024, "mixed"), (1, 1024, "mixed"), (5000, 8192, "mixed"), (1 << 20, 1 << 21, "mixed"),
    (100_000, 1 << 17, "wide"), (100_000, 1 << 17, "cross"), (5000, 8192, "equal"),
    (1 << 16, 1 << 16, "mixed"), (1 << 16, 1 << 16, "cross"), (4095, 8192, "mixed"),
    (4097, 8192, "mixed"), (4097, 8192, "cross"), (300_000, 1 << 19, "dups"),
    (1 << 20, 1 << 20, "dups")])
def test_slab_sort_kernel_matches_plain(cuda, n, cap, kind):
    rng = np.random.RandomState(n + 1)
    lanes = _sort_lanes(rng, n, cap, kind)
    v = torch.from_numpy(rng.rand(cap) > 0.3).to(cuda)
    for keys in lanes:
        lane = torch.from_numpy(keys).to(cuda)
        before = native.launches["slab_sort"]
        got = key_cache.slab_sort(lane, v, n)
        torch.cuda.synchronize()
        assert native.launches["slab_sort"] == before + 1
        assert _equal_all(got, key_cache.slab_sort_plain(lane, v, n))


@pytest.mark.parametrize("n,m,dtype", [(5000, 8, torch.int64), (5000, 4096, torch.int32),
                                       (1 << 20, 1 << 18, torch.int64)])
def test_slab_probe_and_pair_compact_kernels_match_plain(cuda, n, m, dtype):
    rng = np.random.RandomState(m)
    cap = 1 << (n - 1).bit_length()
    keys = rng.randint(0, n // 2, cap).astype(np.int64)  # dense duplicates
    keys[:3] = [(1 << 31) - 2, (1 << 31) - 1, 0]
    k, v = torch.from_numpy(keys).to(cuda), torch.from_numpy(rng.rand(cap) > 0.2).to(cuda)
    sk, perm, _, sv = key_cache.slab_sort_plain(k, v, n)
    s = np.concatenate([keys[rng.randint(0, n, m // 2)], rng.randint(-n, 2 * n, m - m // 2)])
    s[-1] = (1 << 31) - 2  # the int32 sentinel, a real slab key here
    s = torch.from_numpy(s).to(dtype).to(cuda)
    got = key_cache.slab_probe(sk, sv, n, s)
    torch.cuda.synchronize()
    ref = key_cache.slab_probe_plain(sk, sv, n, s)
    assert _equal_all(got, ref)
    t_match, s_first = ref[1], ref[2]
    for tm in (torch.zeros_like(t_match), t_match, torch.ones_like(t_match)):
        out_cap = state_cache._next_pow2(int(tm.sum()), floor=64)
        got = key_cache.pair_compact(tm, s_first, perm, out_cap)
        torch.cuda.synchronize()
        assert torch.equal(got, key_cache.pair_compact_plain(tm, s_first, perm, out_cap))


@pytest.mark.parametrize("scale", [1, 64])
@pytest.mark.parametrize("case", COMPACT_CASES)
def test_pair_compact_kernel_at_hard_shapes(cuda, case, scale):
    """K10 (a physical bitmap, then one compaction over it in physical
    order) against its plain version and the numpy oracle at
    tests/torch_kernel_cases.py's shapes, up to 4,480,000 rows: with and
    without the head's count, and as the probe downloads it
    (``fetch_pairs``: the first mc pairs and the count, pinned)."""
    t_np, first_np, perm_np, out_cap = compact_case(case, scale)
    t, first, perm = (torch.from_numpy(x).to(cuda) for x in (t_np, first_np, perm_np))
    want = torch.from_numpy(reference_compact(t_np, first_np, perm_np, out_cap)).to(cuda)
    mc = int(t_np.sum())
    before = native.launches["pair_compact"]
    got = key_cache.pair_compact(t, first, perm, out_cap)
    torch.cuda.synchronize()
    assert native.launches["pair_compact"] == before + 1
    assert torch.equal(got, want)
    assert torch.equal(key_cache.pair_compact_plain(t, first, perm, out_cap), want)
    if mc <= out_cap:
        assert torch.equal(key_cache.pair_compact(t, first, perm, out_cap, mc=mc), want)
        host = key_cache.fetch_pairs(t, first, perm, mc)
        assert host.is_pinned() and int(host[2 * mc]) == mc
        full = reference_compact(t_np, first_np, perm_np, max(mc, 1))
        assert np.array_equal(host[:mc].numpy(), full[0, :mc])
        assert np.array_equal(host[mc:2 * mc].numpy(), full[1, :mc])
        with pytest.raises(RuntimeError, match="counted"):
            key_cache.fetch_pairs(t, first, perm, max(mc - 1, 0) if mc else 1)


@pytest.mark.parametrize("scale", [1, 64])
@pytest.mark.parametrize("name", CASE_NAMES)
def test_slab_probe_kernel_at_hard_shapes(cuda, name, scale):
    """K9 (the source's hash table, one pass over the slab) against its plain
    version at tests/torch_kernel_cases.py's shapes, up to 2^20 rows."""
    sk, sv, n, s = (torch.from_numpy(x).to(cuda) if isinstance(x, np.ndarray) else x
                    for x in probe_case(name, scale))
    before = native.launches["slab_probe"]
    got = key_cache.slab_probe(sk, sv, n, s)
    torch.cuda.synchronize()
    assert native.launches["slab_probe"] == before + 1
    assert _equal_all(got, key_cache.slab_probe_plain(sk, sv, n, s))


def test_slab_update_kernels_match_plain(cuda):
    rng = np.random.RandomState(6)
    cap = 1 << 16
    lane = torch.from_numpy(rng.rand(cap) > 0.5).to(cuda)
    keys = torch.from_numpy(rng.randint(-(1 << 40), 1 << 40, cap)).to(cuda)
    inv = torch.from_numpy(rng.permutation(cap).astype(np.int32)).to(cuda)
    rows_np = np.full(1024, cap, np.int32)
    rows_np[:900] = rng.choice(cap, 900, replace=False)
    rows_np[900:903] = [-1, -cap, cap + 5]
    rows = torch.from_numpy(rows_np).to(cuda)
    lane0, keys0 = lane.clone(), keys.clone()
    assert torch.equal(key_cache.slab_kill(lane, rows), key_cache.slab_flip_plain(lane, rows, False))
    assert torch.equal(key_cache.slab_revive(lane, rows), key_cache.slab_flip_plain(lane, rows, True))
    assert torch.equal(key_cache.slab_map_rows(inv, rows), key_cache.slab_map_rows_plain(inv, rows))
    for dt in (torch.int32, torch.int64):
        nk = torch.from_numpy(rng.randint(-(1 << 31), (1 << 31) - 1, 1024)).to(dt).to(cuda)
        nv = torch.from_numpy(rng.rand(1024) > 0.5).to(cuda)
        assert _equal_all(key_cache.slab_append(keys, lane, rows, nk, nv),
                          key_cache.slab_append_plain(keys, lane, rows, nk, nv))
        for start in (0, 777, cap - 1024, cap):
            assert _equal_all(key_cache.slab_slice_append(keys, lane, start, nk, nv),
                              key_cache.slab_slice_append_plain(keys, lane, start, nk, nv))
    k32 = keys.to(torch.int32)
    assert torch.equal(key_cache.slab_widen(k32), key_cache.slab_widen_plain(k32))
    torch.cuda.synchronize()
    assert torch.equal(lane, lane0) and torch.equal(keys, keys0)  # inputs never change


@pytest.mark.parametrize("d", [64, 4096, 1 << 20])
@pytest.mark.parametrize("case", ADVANCE_CASES)
@pytest.mark.parametrize("copy", [(), ("keys", "valid", "sorted_valid")])
def test_slab_advance_kernel_matches_plain(cuda, d, case, copy):
    """One slab advance (a slice, a row list with pads and negative rows,
    runs; keys shipped as int32, or int64 at d = 4096; the sorted view
    mirrored in the ``mirror`` case) in one launch, in place and into new
    lanes, against its plain version on the CPU."""
    rng = np.random.RandomState(d + len(case))
    cap = 1 << 23 if d > 4096 else 1 << 16
    parts = advance_case(rng, cap, d, case, wide=d == 4096)
    buf, lay = key_cache.pack_advance(**parts)
    host = [torch.from_numpy(x) for x in (rng.randint(-(1 << 40), 1 << 40, cap),
                                          rng.rand(cap) > 0.3, rng.rand(cap) > 0.5,
                                          rng.permutation(cap).astype(np.int32))]
    k, v, sv, inv = (x.to(cuda) for x in host)
    mirror = case == "mirror"
    before = native.launches["slab_advance"]
    got = key_cache.slab_advance(k, v, torch.from_numpy(buf).to(cuda), lay,
                                 sv if mirror else None, inv if mirror else None, copy=copy)
    torch.cuda.synchronize()
    assert native.launches["slab_advance"] == before + 1
    ref = key_cache.slab_advance_plain(*(x.clone() for x in host[:2]), torch.from_numpy(buf),
                                       lay, host[2].clone() if mirror else None,
                                       host[3] if mirror else None)
    for g, r in zip(got, ref):
        assert (g is None) == (r is None) and (g is None or torch.equal(g.cpu(), r))
    ins = (k, v, sv) if mirror else (k, v)
    assert all(torch.equal(t.cpu(), h) for t, h in zip(ins, host)) or not copy
    # the lanes written are new under copy; keys are not written in the mirror case
    assert all((g is t) == (not copy or (mirror and i == 0))
               for i, (g, t) in enumerate(zip(got, ins)))


def test_advances_on_the_card_match_the_cpu(cuda):
    """Batches of overlapping updates through the entry's mutators (a file
    appended, deletion vectors set twice on it and on an older file, one
    reviving what the other deletes, a file removed), on the card and on the
    CPU: one slab_advance a batch, the lanes equal (and equal to the
    mirrors), in place when no probe holds the lanes and into a new sorted
    validity when one does."""
    rng = np.random.RandomState(21)
    entries = [key_cache.ResidentJoinKeys("log", "m", 0, "k", ["k"], device=d)
               for d in (cuda, "cpu")]
    for e in entries:
        e.capacity = 1 << 18  # room for every append: no regrow drops the lanes
    sizes = {}
    for i in range(4):
        n = 30_000 + 1000 * i
        keys = rng.randint(-(1 << 31), 1 << 31, n).astype(np.int64)
        for e in entries:
            e._append_file(f"b{i}", keys, np.ones(n, bool))
        sizes[f"b{i}"] = n
    for e in entries:
        e.ensure_resident()
        e._ensure_sorted()
    live = list(sizes)
    for step in range(8):
        ops = []
        if step % 2:
            n = int(rng.randint(100, 5000))
            ok = rng.rand(n) > 0.05
            keys = rng.randint(-(1 << 31), 1 << 31, n) * (1 if step % 4 == 1 else 1 << 12)
            ops.append(("append", f"f{step}", np.where(ok, keys, 0).astype(np.int64), ok))
            sizes[f"f{step}"] = n
        if step % 3 == 2 and len(live) > 2:
            ops.append(("kill", live.pop(int(rng.randint(len(live))))))
        for path in ([ops[0][1]] if ops and ops[0][0] == "append" else []) + [live[0]]:
            for _ in range(2):  # the second vector may revive or delete rows the first did
                ops.append(("dv", path, np.sort(rng.choice(sizes[path], sizes[path] // 7,
                                                           replace=False))))
        live += [op[1] for op in ops if op[0] == "append"]
        g, c = entries
        pinned = step in (2, 6)
        if pinned:
            g._pins += 1  # as a probe in flight holds the lanes
        ptrs = {name: t.data_ptr() for name, t in g._dev.items()}
        sorted_live = not g._sort_stale
        before = native.launches["slab_advance"]
        for e in entries:
            with e.device_batch():
                for op in ops:
                    if op[0] == "append":
                        e._append_file(op[1], op[2], op[3])
                    elif op[0] == "kill":
                        e._kill_file(op[1])
                    else:
                        assert e._set_dv(op[1], op[2])
        torch.cuda.synchronize()
        assert native.launches["slab_advance"] == before + 1
        if pinned:
            g._pins -= 1
        n = g.num_rows
        assert np.array_equal(g.h_valid, c.h_valid)
        for name in ("keys", "valid"):
            assert torch.equal(g._dev[name].cpu(), c._dev[name])
            assert g._dev[name].data_ptr() == ptrs[name]
        assert torch.equal(g._dev["valid"][:n].cpu(), torch.from_numpy(g.h_valid))
        if sorted_live and not ops[0][0] == "append":
            moved = g._dev["sorted_valid"].data_ptr() != ptrs["sorted_valid"]
            assert moved == pinned
            assert torch.equal(g._dev["sorted_valid"].cpu(), c._dev["sorted_valid"])
        for e in entries:
            e._ensure_sorted()


def _slab_table(path, rng):
    """Two data files through the port's writer, committed with DVs enabled."""
    from delta_tpu_torch.exec.parquet import collect_stats, write_parquet_file
    from delta_tpu_torch.expr.vectorized import HostColumn, HostTable

    def data_file(name, keys):
        n = len(keys)
        t = HostTable({"k": HostColumn("int", keys, rng.rand(n) > 0.02),
                       "v": HostColumn("double", rng.rand(n), np.ones(n, bool))}, n)
        size, mtime = write_parquet_file(t, f"{path}/{name}")
        return AddFile(path=name, size=size, modification_time=mtime,
                       stats=json.dumps(collect_stats(t)))

    schema = StructType().add("k", LongType()).add("v", DoubleType())
    adds = [data_file("a.parquet", rng.permutation(60_000)[:30_000].astype(np.int64)),
            data_file("b.parquet", rng.randint(0, 60_000, 20_000).astype(np.int64))]
    _write(path, 0, [Protocol(3, 7, ("deletionVectors",), ("deletionVectors",)),
                     Metadata(schema_string=schema.to_json(),
                              configuration={"delta.tpu.enableDeletionVectors": "true"}),
                     *adds])
    return adds, data_file


def test_key_slab_on_the_card_matches_the_cpu(cuda, tmp_path):
    """Build, advance (DV growth and shrink, an append, a removal) and probe
    a key slab on the card and on the CPU: every PhysicalProbe equal."""
    from delta_tpu_torch.expr import ir
    from delta_tpu_torch.protocol.deletion_vectors import write_deletion_vector

    rng = np.random.RandomState(12)
    path = str(tmp_path / "t")
    adds, data_file = _slab_table(path, rng)
    a = adds[0]

    def readd(rows):
        dv = write_deletion_vector(rows, path).to_dict()
        return AddFile(path=a.path, size=a.size, modification_time=a.modification_time,
                       stats=a.stats, deletion_vector=dv)

    tails = [[readd(rng.choice(30_000, 3000, replace=False))],
             [readd(np.arange(0, 30_000, 97))],
             [data_file("c.parquet", np.arange(60_000, 70_000, dtype=np.int64))],
             [RemoveFile(path="b.parquet", deletion_timestamp=4)]]
    s = rng.randint(0, 75_000, 40_000).astype(np.int64)
    ok = rng.rand(len(s)) > 0.05
    key_cache.KeyCache.reset()
    for version in range(len(tails) + 1):
        if version:
            _write(path, version, tails[version - 1])
        probes = []
        for dev in (cuda, "cpu"):
            snap = DeltaLog.for_table(path, device=dev).update()
            e = key_cache.KeyCache.instance().get(snap, "k", ["k"], [ir.Column("k")])
            assert e.version == version and e.device == torch.device(dev)
            probes.append(e.probe_async(s, ok, expected_version=version).result())
        g, c = probes
        assert np.array_equal(g.s_matched, c.s_matched) and g.any_multi == c.any_multi
        assert g.slabs == c.slabs and g.num_rows == c.num_rows
        assert all(np.array_equal(x, y) for x, y in zip(g.t_pairs, c.t_pairs))
    assert key_cache.KeyCache.instance().peek(f"{path}/_delta_log", "k", cuda)._dev["keys"].is_cuda


@pytest.mark.parametrize("dtype,cap_t,n,cap_s,m,shape", [
    (np.int32, 1 << 20, 1_000_000, 1 << 17, 100_000, "half"),
    (np.int64, 1 << 20, 1_000_000, 1 << 17, 100_000, "low"),
    (np.int32, 1 << 16, 60_000, 1 << 12, 4000, "dups"),
    (np.int64, 1 << 16, 1 << 16, 1 << 12, 4096, "all"),
    (np.int32, 1 << 16, 60_000, 1 << 12, 4000, "none"),
    (np.int32, 1024, 1000, 8, 1, "half"),
])
def test_join_probe_kernel_matches_plain(cuda, dtype, cap_t, n, cap_s, m, shape):
    """K12 on padded inputs as inner_join_async builds them: both key types,
    sentinels at the top or the bottom of the range, duplicate runs, no
    match, all matched, one source key."""
    from delta_tpu_torch.ops import join_kernel

    rng = np.random.RandomState(cap_t + m)
    info = np.iinfo(dtype)
    if shape == "dups":
        t, s = rng.randint(-300, 300, n), rng.randint(-400, 400, m)
    elif shape == "none":
        t, s = rng.randint(0, 1 << 24, n) * 2, rng.randint(0, 1 << 24, m) * 2 + 1
    elif shape == "all":
        s = rng.randint(-(1 << 30), 1 << 30, m)
        t = s[rng.randint(0, m, n)]
    else:
        t = rng.randint(info.min + 2, info.max - 2, n, dtype=np.int64)
        s = np.concatenate([t[rng.randint(0, n, m - m // 2)],
                            rng.randint(info.min + 2, info.max - 2, m // 2, dtype=np.int64)])
    t_fill, s_fill = (info.min, info.min + 1) if shape == "low" else (info.max, info.max - 1)
    t_in, s_in = np.full(cap_t, t_fill, dtype), np.full(cap_s, s_fill, dtype)
    t_in[:n], s_in[:m] = t, s
    tt, ss = torch.from_numpy(t_in).to(cuda), torch.from_numpy(s_in).to(cuda)
    before = native.launches["join_probe"]
    got = join_kernel.join_probe(tt, ss)
    torch.cuda.synchronize()
    assert native.launches["join_probe"] == before + 1
    assert _equal_all(got, join_kernel.join_probe_plain(tt, ss))


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("shape", ["marker", "dups", "none", "all", "low"])
def test_join_probe_hash_cases_match_plain_and_k13(cuda, dtype, shape):
    """K12 and K13 (8 slabs of one card) on chip_smoke's join traffics,
    among them keys equal to the hash table's empty-slot key (the type's
    minimum) and the type's maximum on both sides: each against its plain
    version and against each other, exactly."""
    import chip_smoke
    from delta_tpu_torch.ops import join_kernel

    rng = np.random.RandomState(5)
    t_in, s_in = chip_smoke.k12_inputs(rng, dtype, 1 << 17, 120_000, 1 << 13, 8000, shape)
    tt, ss = torch.from_numpy(t_in).to(cuda), torch.from_numpy(s_in).to(cuda)
    k12 = join_kernel.join_probe(tt, ss)
    before = native.launches["sharded_join_probe"]
    combines = native.launches["shard_combine"]
    k13 = join_kernel.sharded_join_probe(list(tt.view(8, -1)), list(ss.view(8, -1)))
    torch.cuda.synchronize()
    assert native.launches["sharded_join_probe"] == before + 1
    # one device holds every shard: K13's launch packs its hits, no combine
    assert native.launches["shard_combine"] == combines
    assert _equal_all(k12, join_kernel.join_probe_plain(tt, ss))
    assert _equal_all(k13, join_kernel.sharded_join_probe_plain(list(tt.view(8, -1)), ss))
    assert _equal_all(k12, k13)


def test_int64_key_equal_to_the_empty_slot_marker(cuda):
    """INT64_MIN stores as an empty slot: it keeps its count and hit flag
    apart, and matches, counts and flags like any key."""
    from delta_tpu_torch.ops import join_kernel

    lo = np.iinfo(np.int64).min
    s = np.array([lo, 5, lo, 7, 9, 9, 1, 2], np.int64)
    t = np.array([lo, 3, 5, 9, 100, lo, 0, 1] + [4] * 8, np.int64)
    tt, ss = torch.from_numpy(t).to(cuda), torch.from_numpy(s).to(cuda)
    got = join_kernel.join_probe(tt, ss)
    assert _equal_all(got, join_kernel.join_probe_plain(tt, ss))
    assert np.unpackbits(got[0].cpu().numpy())[:8].tolist() == [1, 0, 1, 1, 0, 1, 0, 1]
    assert np.unpackbits(got[1].cpu().numpy()).tolist() == [1, 1, 1, 0, 1, 1, 1, 0]
    assert bool(got[2][0])  # INT64_MIN and 9 are in the source twice
    only_marker = join_kernel.join_probe(tt[:8].clone(), torch.full_like(ss, lo))
    assert _equal_all(only_marker, join_kernel.join_probe_plain(tt[:8].clone(),
                                                                torch.full_like(ss, lo)))


def test_merge_routes_on_the_card_match_the_reference(cuda, tmp_path):
    """A small bench-config-2-shaped MERGE through each route on the card
    (host, device-cold, resident, device-upload), each end state equal to a
    numpy reference upsert."""
    merge_routes(cuda, tmp_path)


def merge_routes(dev, tmp_path):
    import shutil

    from delta_tpu_torch import MergeClause, MergeIntoCommand, WriteIntoDelta
    from delta_tpu_torch.commands.alter import set_table_properties
    from delta_tpu_torch.exec.scan import scan_to_table
    from delta_tpu_torch.ops.key_cache import KeyCache
    from delta_tpu_torch.utils.config import conf

    rng = np.random.RandomState(7)
    n, m = 50_000, 5_000
    target = {"k": rng.permutation(n * 2)[:n].astype(np.int64), "v": rng.rand(n),
              "q": rng.randint(0, 100, n).astype(np.int64)}

    def upsert(state, src):
        keys = state["k"]
        pos = np.minimum(np.searchsorted(keys, src["k"]), len(keys) - 1)
        hit = keys[pos] == src["k"]
        out = {}
        for c in state:
            col = state[c].copy()
            col[pos[hit]] = src[c][hit]
            out[c] = np.concatenate([col, src[c][~hit]])
        order = np.argsort(out["k"], kind="stable")
        return {c: v[order] for c, v in out.items()}

    # the states after M1 (= M0's), M2 and M3, and the sources that make them
    states = [{c: v[np.argsort(target["k"], kind="stable")] for c, v in target.items()}]
    sources = []
    for i in range(3):
        live = states[-1]["k"]
        fresh = np.arange(n * 2 + i * m, n * 2 + i * m + m // 2, dtype=np.int64)
        keys = np.concatenate([live[rng.choice(len(live), m // 2, replace=False)], fresh])
        rng.shuffle(keys)
        sources.append({"k": keys, "v": rng.rand(m), "q": rng.randint(0, 100, m)})
        states.append(upsert(states[-1], sources[-1]))
    DeltaLog.clear_cache()
    KeyCache.reset()
    with conf.set_temporarily(**{"delta.tpu.write.targetFileRows": 20_000}):
        path = str(tmp_path / "t")
        log = DeltaLog.for_table(path, device=dev)
        WriteIntoDelta(log, "append", target).run()
        set_table_properties(log, {"delta.tpu.enableDeletionVectors": "true"})
        shutil.copytree(path, path + "-copy")
        copy = DeltaLog.for_table(path + "-copy", device=dev)
        merges = [(copy, "off", True, "host", 0), (log, "force", True, "device-cold", 0),
                  (log, "force", True, "resident", 1), (log, "force", False, "device-upload", 2)]
        for lg, mode, dv, route, k in merges:
            with conf.set_temporarily(**{"delta.tpu.merge.devicePath.mode": mode,
                                         "delta.tpu.deletionVectors.enabled": dv}):
                cmd = MergeIntoCommand(lg, sources[k], "t.k = s.k", [MergeClause("update")],
                                       [MergeClause("insert")], source_alias="s",
                                       target_alias="t")
                cmd.run()
            assert cmd._join_path == route and not cmd._router.get("reason"), route
            t = scan_to_table(lg.update())
            order = np.argsort(t.column("k").values, kind="stable")
            for c, want in states[k + 1].items():
                assert np.array_equal(t.column(c).values[order], want), (route, c)
    assert KeyCache.instance().last_build_error is None


# -- K14 and K16 (the fifth slice) ---------------------------------------------------


@pytest.mark.parametrize("n,cap", [(4096 - 17, 4096), ((1 << 20) - 4321, 1 << 20)])
def test_residual_mask_kernel_matches_plain(cuda, n, cap):
    """chip_smoke.py's K14 corpus over padded lanes of every dtype: exact."""
    import chip_smoke
    from delta_tpu_torch.ops import column_cache

    env, mapping = chip_smoke.k14_lanes(n, cap, 7, cuda)
    before = native.launches["residual_mask"]
    for sql in chip_smoke.K14_CORPUS:
        program, scalars = chip_smoke.k14_program(sql, env, mapping)
        got = column_cache.residual_mask(program, env, n, scalars)
        torch.cuda.synchronize()
        assert torch.equal(got, column_cache.residual_mask_plain(program, env, n, scalars)), sql
    assert native.launches["residual_mask"] == before + len(chip_smoke.K14_CORPUS)


def test_residual_masks_batched_launch_matches_plain(cuda):
    """K14's one launch over files of unequal sizes (0, 1, 77, 4097,
    250,000, a padded 2^20 lane and 70 more: two parameter blocks), each
    with its own string dictionary, over chip_smoke.py's corpus: the whole
    mask exact against the plain version, the bytes between files
    included, one launch a block (the long IN lists of the corpus take the
    staged tables, 20 files a block where a file has 200 scalars)."""
    import chip_smoke
    from delta_tpu_torch.ops import column_cache

    files = chip_smoke.k14_files(cuda)
    envs, ns = [f[0] for f in files], [f[2] for f in files]
    for sql in chip_smoke.K14_CORPUS:
        program, _ = chip_smoke.k14_program(sql, envs[0], files[0][1])
        scal = [chip_smoke.k14_program(sql, env, mapping)[1] for env, mapping, _ in files]
        staged = column_cache._k14_layout(program, len(files)) is column_cache._K14_GLOBAL
        before = native.launches["residual_mask"]
        got, offs = column_cache.residual_masks(program, envs, ns, scal)
        torch.cuda.synchronize()
        want = 4 if staged and program.scalar_slots else 2
        assert native.launches["residual_mask"] - before == len(
            column_cache._launch_groups(program, len(files))) == want, sql
        ref, ref_offs = column_cache.residual_masks_plain(program, envs, ns, scal)
        assert offs == ref_offs and torch.equal(got, ref), sql


@pytest.mark.parametrize("sql", ["a IN (%s)" % ", ".join(str(v) for v in range(200)),
                                 "s IN ('alpha', %s)" % ", ".join(f"'w{i}'" for i in range(199)),
                                 "s IN ('beta', %s)" % ", ".join(f"'w{i}'" for i in range(39))])
def test_residual_masks_past_the_launch_parameters_match_plain(cuda, sql):
    """An IN of 200 options (more literals than the launch's parameters
    hold), of 200 strings (200 scalars a file), and of 40 strings (whose
    scalars would split 8 files into 3 blocks of the launch's parameters):
    K14's staged tables, one launch over 8 files of 250,000 rows, exact
    against the plain version."""
    import chip_smoke
    from delta_tpu_torch.ops import column_cache

    files = [chip_smoke.k14_lanes(250_000, 1 << 18, 300 + i, cuda) for i in range(8)]
    envs, ns = [f[0] for f in files], [250_000] * 8
    program, _ = chip_smoke.k14_program(sql, envs[0], files[0][1])
    scal = [chip_smoke.k14_program(sql, env, mapping)[1] for env, mapping in files]
    assert column_cache._k14_layout(program, 8) is column_cache._K14_GLOBAL
    before = native.launches["residual_mask"]
    got, offs = column_cache.residual_masks(program, envs, ns, scal)
    torch.cuda.synchronize()
    assert native.launches["residual_mask"] - before == 1
    ref, ref_offs = column_cache.residual_masks_plain(program, envs, ns, scal)
    assert offs == ref_offs and torch.equal(got, ref) and got.any()


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 6])
def test_morton_kernel_matches_plain(cuda, k):
    import chip_smoke
    from delta_tpu_torch.ops import zorder

    ranks = chip_smoke.k16_ranks(k, (1 << 16) + 3, 1, cuda)
    before = native.launches["morton"]
    got = zorder.interleave(ranks)
    torch.cuda.synchronize()
    assert torch.equal(got, zorder.interleave_plain(ranks))
    assert native.launches["morton"] == before + 1


def test_read_path_and_optimize_on_the_card_match_the_cpu(cuda, tmp_path):
    """Bench config 12's queries at 64,000 rows and a Z-order OPTIMIZE of
    the same table, on the card and on the CPU: the same rows, the same
    files."""
    import shutil

    import chip_smoke
    from delta_tpu_torch import DeltaTable, WriteIntoDelta
    from delta_tpu_torch.commands.optimize import OptimizeCommand
    from delta_tpu_torch.exec.scan import read_files_as_table
    from delta_tpu_torch.expr.vectorized import HostColumn, HostTable
    from delta_tpu_torch.ops.column_cache import ColumnCache
    from delta_tpu_torch.utils.config import conf

    n = 64_000
    data = chip_smoke.config12_data(n)
    cols = {c: HostColumn({"cat": "str", "ts": "ts"}.get(c, "int"), v, np.ones(n, bool))
            for c, v in data.items()}
    path = str(tmp_path / "t")
    with conf.set_temporarily(**{"delta.tpu.write.targetFileRows": n // 8,
                                 "delta.tpu.write.rowGroupRows": n // 64}):
        WriteIntoDelta(DeltaLog.for_table(path, device="cpu"), "append",
                       HostTable(cols, n)).run()
    shutil.copytree(path, path + "-cpu")
    ColumnCache.reset()
    before = native.launches["residual_mask"]
    with conf.set_temporarily(**{"delta.tpu.read.deviceResidual.mode": "force"}):
        for _name, q, mask in chip_smoke.config12_queries(n)(data):
            got = DeltaTable.for_path(path, device=cuda).to_table(filters=[q])
            ref = DeltaTable.for_path(path + "-cpu", device="cpu").to_table(filters=[q])
            assert got.num_rows == ref.num_rows == int(mask.sum()), q
            assert np.array_equal(np.sort(got.column("id").values), data["id"][mask]), q
    assert native.launches["residual_mask"] > before
    from delta_tpu_torch.utils import telemetry

    c0 = telemetry.counters("columnCache")
    with conf.set_temporarily(**{"delta.tpu.read.deviceResidual.mode": "force"}):
        DeltaTable.for_path(path, device=cuda).to_table(filters=["cat = 'eu-c'"])
    c1 = telemetry.counters("columnCache")
    assert c1.get("columnCache.hits", 0) > c0.get("columnCache.hits", 0)  # warm: resident
    assert c1.get("columnCache.misses", 0) == c0.get("columnCache.misses", 0)
    before = native.launches["morton"]
    for p, dev in ((path, cuda), (path + "-cpu", "cpu")):
        OptimizeCommand(DeltaLog.for_table(p, device=dev), z_order_by=["price", "cat"],
                        target_rows=10_000).run()
    assert native.launches["morton"] == before + 1
    files = []
    for p in (path, path + "-cpu"):
        log = DeltaLog.for_table(p, device="cpu")
        snap = log.update()
        files.append(sorted((read_files_as_table(log.data_path, [f], snap.metadata)
                             .column("id").values.tolist() for f in snap.all_files)))
    assert files[0] == files[1] and len(files[0]) == 7


# -- K17 and the auto router (the sixth slice) -----------------------------------------


@pytest.mark.parametrize("n", [8, 1 << 20, 1000003])
def test_link_probe_kernel_matches_plain(cuda, n):
    from delta_tpu_torch.parallel import link

    vals = np.random.RandomState(n).randint(-2**31, 2**31 - 1, n).astype(np.int32)
    a = torch.from_numpy(vals).to(cuda)
    before = native.launches["link_probe"]
    got = link.link_probe(a)
    torch.cuda.synchronize()
    assert native.launches["link_probe"] == before + 1
    assert torch.equal(got, a + 1)


def test_probed_profile_on_the_card(cuda):
    """One probe per device: K17 first (one launch), then finite, positive
    rates and latency; the CPU's profile is a separate entry."""
    from delta_tpu_torch.parallel import link

    link.reset()
    before = native.launches["link_probe"]
    p = link.profile(cuda)
    assert native.launches["link_probe"] == before + 1
    assert p.probed
    assert np.isfinite([p.up_mbps, p.down_mbps, p.latency_s]).all()
    assert min(p.up_mbps, p.down_mbps, p.latency_s) > 0
    assert link.profile(cuda) is p and native.launches["link_probe"] == before + 1
    assert link.profile("cpu") is not p


def test_auto_merge_and_read_on_the_card_match_the_cpu(cuda, tmp_path):
    """One MERGE and one filtered read under auto, on the card and on the
    CPU, over copies of one table: the same rows, each decision the one its
    printed prices imply."""
    import shutil

    from delta_tpu_torch import DeltaTable, MergeClause, MergeIntoCommand, WriteIntoDelta
    from delta_tpu_torch.obs import router_audit, scan_report
    from delta_tpu_torch.exec.scan import scan_to_table
    from delta_tpu_torch.utils.config import conf

    rng = np.random.RandomState(3)
    n, m = 200_000, 20_000
    target = {"k": rng.permutation(n).astype(np.int64), "v": rng.rand(n)}
    keys = np.concatenate([rng.choice(n, m // 2, replace=False), np.arange(n, n + m // 2)])
    source = {"k": keys.astype(np.int64), "v": rng.rand(m)}
    path = str(tmp_path / "t")
    with conf.set_temporarily(**{"delta.tpu.write.targetFileRows": n // 4}):
        WriteIntoDelta(DeltaLog.for_table(path, device="cpu"), "append", target).run()
    shutil.copytree(path, path + "-cpu")
    rows = []
    with conf.set_temporarily(**{"delta.tpu.merge.devicePath.mode": "auto",
                                 "delta.tpu.read.deviceResidual.mode": "auto"}):
        for p, dev in ((path, cuda), (path + "-cpu", "cpu")):
            cmd = MergeIntoCommand(DeltaLog.for_table(p, device=dev), source, "t.k = s.k",
                                   [MergeClause("update")], [MergeClause("insert")],
                                   source_alias="s", target_alias="t")
            cmd.run()
            r = cmd._router
            assert cmd._join_path == ("host" if r["deviceEstS"] > r["hostEstS"]
                                      else "device-cold"), r
            t = scan_to_table(DeltaLog.for_table(p, device=dev).update())
            order = np.argsort(t.column("k").values, kind="stable")
            router_audit.clear_audits()
            got = DeltaTable.for_path(p, device=dev).to_table(filters=["v > 0.5 AND k < 150000"])
            [a] = [x for x in router_audit.recent_audits() if x["op"] == "scan.residual"]
            assert scan_report.last_scan_report().device_residual == a["decision"]
            rows.append(([t.column(c).values[order] for c in ("k", "v")],
                         np.sort(got.column("k").values)))
    (card_state, card_read), (cpu_state, cpu_read) = rows
    assert all(np.array_equal(a, b) for a, b in zip(card_state, cpu_state))
    assert np.array_equal(card_read, cpu_read) and len(card_read) > 0


# -- the state mesh: K6, K7, K13 and the combine kernel, one card named 8 times -------


@pytest.fixture
def mesh8(cuda):
    from delta_tpu_torch.parallel import mesh

    with mesh.using_devices([cuda] * 8) as m:
        yield m


@pytest.mark.parametrize("op", ["sum", "or"])
@pytest.mark.parametrize("n,k", [(1, 1), (8, 13), (8, (1 << 20) + 5)])
def test_shard_combine_kernel_matches_plain(cuda, op, n, k):
    from delta_tpu_torch.parallel import mesh

    rng = np.random.RandomState(n * 7 + k)
    if op == "sum":
        rows = torch.from_numpy(rng.randint(-2**62, 2**62, (n, k)).astype(np.int64))
    else:
        rows = torch.from_numpy(((rng.rand(n, k) < 0.1) * rng.randint(1, 255, (n, k)))
                                .astype(np.uint8))
    before = native.launches["shard_combine"]
    got = mesh.shard_combine(rows.to(cuda), op)
    torch.cuda.synchronize()
    assert native.launches["shard_combine"] == before + 1
    assert torch.equal(got.cpu(), mesh.shard_combine_plain(rows, op))


@pytest.mark.parametrize("n", [4096, 1 << 20])
def test_sharded_replay_kernel_matches_plain_and_k5(cuda, mesh8, n):
    from delta_tpu_torch.ops.state_export import ReplayArrays

    rng = np.random.RandomState(n)
    num_paths = max(n // 6, 1)
    arr = ReplayArrays(paths=[f"p{i}" for i in range(num_paths)],
                       path_id=rng.randint(0, num_paths, n).astype(np.int32),
                       seq=rng.permutation(n).astype(np.int64) * 5 + 3,
                       is_add=rng.rand(n) > 0.3,
                       size=rng.randint(0, 2**62, n).astype(np.int64),
                       deletion_timestamp=rng.randint(0, 100, n).astype(np.int64))
    stacked, _, _ = replay_kernel._bucket_by_path(arr, 8)
    slabs = [tuple(torch.from_numpy(np.ascontiguousarray(c[i])).to(cuda) for c in stacked)
             for i in range(8)]
    before = native.launches["sharded_replay"]
    got = replay_kernel.sharded_replay(slabs, num_paths, 50)
    torch.cuda.synchronize()
    assert native.launches["sharded_replay"] == before + 1  # one launch a distinct device
    ref = replay_kernel.sharded_replay_plain(slabs, num_paths, 50)
    assert all(torch.equal(a, b) for a, b in zip(got[0] + got[1], ref[0] + ref[1]))
    assert torch.equal(got[2], ref[2])
    sharded = replay_kernel.replay_sharded(arr, mesh8, min_retention_ts=50)
    one = replay_kernel.replay_alive_mask(arr, min_retention_ts=50, device=cuda)
    assert np.array_equal(sharded.alive, one.alive)
    assert np.array_equal(sharded.tombstone, one.tombstone) and sharded.stats == one.stats


def _stream_arrays(name, shards):
    from delta_tpu_torch.ops.state_export import ReplayArrays
    from torch_replay_streams import replay_stream  # tests/, on the path as chip_smoke is

    return ReplayArrays(**replay_stream(name, shards))


def _padded_cols(arr, dev):
    cap = replay_kernel._next_pow2(arr.num_rows, floor=8)
    return [torch.from_numpy(replay_kernel._pad(np.asarray(a, dt), cap, fill)).to(dev)
            for a, dt, fill in ((arr.path_id, np.int32, -1), (arr.seq, np.int64, 0),
                                (arr.is_add, bool, False), (arr.size, np.int64, 0),
                                (arr.deletion_timestamp, np.int64, 0))]


@pytest.mark.parametrize("shards", [2, 4, 8])
@pytest.mark.parametrize("stream", ["all-pad-shard", "hot-path", "seq-extremes", "no-paths",
                                    "wrapping-sizes"])
def test_replay_kernels_on_edge_streams(cuda, stream, shards):
    """K5 and K6 (one launch over the shards of one card) against their
    plain versions, and replay_sharded over [cuda] * shards against
    replay_alive_mask, on the streams of tests/torch_replay_streams.py."""
    from delta_tpu_torch.parallel import mesh

    arr = _stream_arrays(stream, shards)
    num_paths = len(arr.paths)
    cols = _padded_cols(arr, cuda)
    for cutoff in (0, 1000):
        got = replay_kernel.replay(*cols, num_paths, cutoff)
        ref = replay_kernel.replay_plain(*cols, num_paths, cutoff)
        assert all(torch.equal(g, r) for g, r in zip(got, ref)), cutoff
    stacked, _, _ = replay_kernel._bucket_by_path(arr, shards)
    big = [torch.from_numpy(c).to(cuda) for c in stacked]
    slabs = [tuple(c[i] for c in big) for i in range(shards)]
    before = native.launches["sharded_replay"]
    got = replay_kernel.sharded_replay(slabs, num_paths, 1000)
    assert native.launches["sharded_replay"] == before + 1
    ref = replay_kernel.sharded_replay_plain(slabs, num_paths, 1000)
    assert all(torch.equal(a, b) for a, b in zip(got[0] + got[1], ref[0] + ref[1]))
    assert torch.equal(got[2], ref[2])
    with mesh.using_devices([cuda] * shards) as m:
        sharded = replay_kernel.replay_sharded(arr, m, min_retention_ts=1000)
    one = replay_kernel.replay_alive_mask(arr, min_retention_ts=1000, device=cuda)
    assert np.array_equal(sharded.alive, one.alive)
    assert np.array_equal(sharded.tombstone, one.tombstone) and sharded.stats == one.stats


@pytest.mark.parametrize("stream", ["hot-path", "seq-extremes", "wrapping-sizes"])
def test_k6_with_one_shard_is_k5(cuda, stream):
    arr = _stream_arrays(stream, 1)
    cols = _padded_cols(arr, cuda)
    k5 = replay_kernel.replay(*cols, len(arr.paths), 1000)
    k6 = replay_kernel.sharded_replay([tuple(cols)], len(arr.paths), 1000)
    assert torch.equal(k6[0][0], k5[0]) and torch.equal(k6[1][0], k5[1])
    assert torch.equal(k6[2], k5[2])


def test_sharded_replay_kernel_rejects_out_of_range_ids(cuda):
    p = torch.arange(8, dtype=torch.int32, device=cuda)
    z = torch.zeros(8, dtype=torch.int64, device=cuda)
    a = torch.ones(8, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        replay_kernel.sharded_replay([(p[:4], z[:4], a[:4], z[:4], z[:4]), (p[4:], z[4:], a[4:],
                                                                          z[4:], z[4:])], 7)


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_sharded_block_cull_kernel_matches_plain_and_k1(cuda, shards):
    rng = np.random.RandomState(shards)
    c, cap, m = 4, 1 << 16, 70
    mins = (rng.rand(c, cap) * 100).astype(np.float32)
    maxs = mins + (rng.rand(c, cap) * 3).astype(np.float32)
    mins[:, rng.rand(cap) < 0.05] = np.nan
    maxs[:, rng.rand(cap) < 0.05] = np.nan
    mins[0, 7], maxs[0, 7] = np.inf, -np.inf
    alive = rng.rand(cap) > 0.2
    lo = (rng.rand(m, c) * 100).astype(np.float32)
    hi = lo + (rng.rand(m, c) * 0.5).astype(np.float32)
    lo[rng.rand(m, c) < 0.2] = np.nan
    hi[rng.rand(m, c) < 0.2] = np.nan
    t = [torch.from_numpy(a).to(cuda) for a in (mins, maxs, alive)]
    per = cap // shards
    sh = [(t[0][:, i * per:(i + 1) * per].contiguous(), t[1][:, i * per:(i + 1) * per].contiguous(),
           t[2][i * per:(i + 1) * per].contiguous()) for i in range(shards)]
    lo_t, hi_t = torch.from_numpy(lo), torch.from_numpy(hi)
    before = native.launches["sharded_block_cull"]
    got = state_cache.sharded_block_cull(sh, lo_t, hi_t)
    torch.cuda.synchronize()
    assert native.launches["sharded_block_cull"] == before + 1  # one a distinct device
    assert torch.equal(got.cpu(), state_cache.sharded_block_cull_plain(
        [tuple(x.cpu() for x in s) for s in sh], lo_t, hi_t))
    k1 = state_cache.block_cull(*t, lo_t.to(cuda), hi_t.to(cuda))
    assert np.array_equal(np.unpackbits(k1.cpu().numpy(), axis=1, count=cap // 1024),
                          got.cpu().numpy())


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_sharded_join_probe_kernel_matches_plain_and_k12(cuda, dtype):
    rng = np.random.RandomState(3)
    fill_t, fill_s = torch.iinfo(dtype).max, torch.iinfo(dtype).max - 1
    t = np.full(1 << 18, fill_t, np.int64)
    t[:200_000] = rng.randint(-5000, 5000, 200_000)
    s = np.full(1 << 14, fill_s, np.int64)
    s[:12_000] = np.repeat(rng.randint(-6000, 6000, 3000), 4)
    s[2048 - 3:2048 + 3] = 17  # a run across the first piece boundary
    tt, st = torch.from_numpy(t).to(dtype).to(cuda), torch.from_numpy(s).to(dtype).to(cuda)
    before = native.launches["sharded_join_probe"]
    from delta_tpu_torch.ops import join_kernel

    got = join_kernel.sharded_join_probe(list(tt.view(8, -1)), list(st.view(8, -1)))
    torch.cuda.synchronize()
    assert native.launches["sharded_join_probe"] == before + 1  # one a distinct device
    ref = join_kernel.sharded_join_probe_plain([x.cpu() for x in tt.view(8, -1)], st.cpu())
    k12 = join_kernel.join_probe(tt, st)
    for g, r, k in zip(got, ref, k12):
        assert torch.equal(g.cpu(), r) and torch.equal(g, k)


def test_sharded_paths_on_the_card_match_the_cpu(cuda, mesh8):
    """The sharded plan, the upload join over the mesh and the multichip run
    on one card named 8 times, against the same calls on the CPU."""
    from delta_tpu_torch.multichip import dryrun_multichip
    from delta_tpu_torch.ops import join_kernel
    from delta_tpu_torch.parallel import mesh
    from delta_tpu_torch.utils.config import conf

    rng = np.random.RandomState(9)
    n = 20_000
    lo = np.sort(rng.rand(2, n) * 100.0, axis=0)
    lanes = {"min": lo, "max": lo + rng.rand(2, n) * 5, "size": np.ones(n, np.int64)}
    ranges = [state_cache.RangeSet(np.array([v, np.nan]), np.array([v + 1, np.nan]))
              for v in rng.rand(40) * 100]
    entry = state_cache.ResidentState("mem://g", "m", 0, ["a", "b"],
                                      [f"p{i}" for i in range(n)], lanes, cuda)
    before = native.launches["sharded_block_cull"]
    with conf.set_temporarily(**{"delta.tpu.distributed.plan.mode": "force",
                                 "delta.tpu.stateCache.devicePlan.mode": "force"}):
        plans = entry.plan_ranges(ranges, k=n)
    assert entry.resident_shards == 8 and native.launches["sharded_block_cull"] == before + 1
    host = entry.plan_ranges(ranges, k=n, use_device=False)
    assert all(p.via == "device-sharded" and np.array_equal(p.rows, h.rows)
               for p, h in zip(plans, host))
    t = rng.randint(0, 50_000, 300_000).astype(np.int64)
    s = rng.randint(0, 60_000, 30_000).astype(np.int64)
    t_ok, s_ok = rng.rand(len(t)) > 0.05, rng.rand(len(s)) > 0.05
    before = native.launches["sharded_join_probe"]
    got = join_kernel.inner_join(t, t_ok, s, s_ok, mesh=mesh.state_mesh(device=cuda),
                                 device=cuda)
    assert native.launches["sharded_join_probe"] == before + 1  # one a distinct device
    want = join_kernel.inner_join(t, t_ok, s, s_ok, device="cpu")
    assert np.array_equal(got.t_first_s, want.t_first_s)
    assert np.array_equal(got.s_matched, want.s_matched) and got.any_multi == want.any_multi
    report = dryrun_multichip(8, device=cuda)
    assert report["plan_shards"] == 8 and report["n_alive"] > 0


# -- the combine, batched and folded, and the Z-order sorts (the fourteenth slice) ------


@pytest.mark.parametrize("k", COMBINE_KS)
@pytest.mark.parametrize("n", COMBINE_NS)
def test_shard_combine_batch_matches_plain(cuda, n, k):
    """Both ops at (n, k) in ONE launch, on rows that start on a 16-byte
    boundary and on rows whose base is off it (offset 3), against the
    plain version and numpy; a third set is refused."""
    from delta_tpu_torch.parallel import mesh

    for offset in (0, 3):
        sets, refs = [], []
        for op in ("sum", "or"):
            buf = combine_case(op, n, k, offset, seed=11)
            sets.append((combine_rows(torch.from_numpy(buf).to(cuda), n, k, offset), op))
            refs.append(reference_combine(combine_rows(buf, n, k, offset), op))
        before = native.launches["shard_combine"]
        got = mesh.shard_combine_many(sets)
        torch.cuda.synchronize()
        assert native.launches["shard_combine"] - before == (0 if k == 0 else 1)
        for g, r, (x, op) in zip(got, refs, sets):
            assert np.array_equal(g.cpu().numpy(), r), (op, n, k, offset)
            assert torch.equal(g.cpu(), mesh.shard_combine_plain(x.cpu(), op))
    with pytest.raises(ValueError):
        mesh.shard_combine_many(sets + sets[:1])


def test_psum_many_on_one_card_mesh_is_one_launch(cuda, mesh8):
    """psum_many of K13's sets across devices (each device's packed source
    hits and its multi flag): one combine launch, equal to the single
    psums, to numpy and to the packing of the hits' OR; K6's sums alone."""
    from delta_tpu_torch.parallel import mesh

    rng = np.random.RandomState(3)
    flags = (rng.rand(8, 1 << 12) < 0.1).astype(np.uint8)
    hits = [torch.from_numpy(np.packbits(f)).to(cuda) for f in flags]
    multi = [torch.from_numpy(np.array([i == 5], np.uint8)).to(cuda) for i in range(8)]
    sums = [torch.from_numpy(rng.randint(-2**62, 2**62, 4).astype(np.int64)).to(cuda)
            for _ in range(8)]
    pairs = [(hits, "or"), (multi, "or")]
    before = native.launches["shard_combine"]
    got = mesh.psum_many(pairs)
    torch.cuda.synchronize()
    assert native.launches["shard_combine"] - before == 1
    assert np.array_equal(got[0].cpu().numpy(), np.packbits(flags.any(axis=0)))
    for g, (parts, op) in zip(got + [mesh.psum(sums, "sum")], pairs + [(sums, "sum")]):
        assert torch.equal(g, mesh.psum(parts, op))
        assert np.array_equal(g.cpu().numpy(),
                              reference_combine(torch.stack(parts).cpu().numpy(), op))


def test_sharded_replay_on_one_card_launches_no_combine(cuda, mesh8):
    """K6 with every slab on one card sums its slabs into one row in its launch:
    no combine, sums equal to the plain version's and to K5's."""
    import chip_smoke

    stream = chip_smoke.k6_stream(1 << 16, 5)
    slabs, _, _ = chip_smoke.k6_slabs(stream, cuda)
    num_paths = len(stream.paths)
    before = dict(native.launches)
    got = replay_kernel.sharded_replay(slabs, num_paths, 1000)
    torch.cuda.synchronize()
    assert native.launches["sharded_replay"] - before["sharded_replay"] == 1
    assert native.launches["shard_combine"] == before["shard_combine"]
    ref = replay_kernel.sharded_replay_plain(slabs, num_paths, 1000)
    assert torch.equal(got[2], ref[2])
    assert all(torch.equal(a, b) for a, b in zip(got[0] + got[1], ref[0] + ref[1]))


@pytest.mark.parametrize("n", [1, 3, (1 << 16) + 3])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 6, 7, 8, 9, 65])
def test_morton_table_kernel_matches_plain(cuda, k, n):
    """The table-driven K16 past 8 bits a column (k >= 8: the high byte's
    shift reaches 64) and past 64 columns (k = 65: c >= 64), on tails of n
    not a multiple of 4 (columns off a 16-byte boundary)."""
    from delta_tpu_torch.ops import zorder

    rng = np.random.RandomState(k * 7 + n)
    r = rng.randint(0, 1 << 16, (k, n)).astype(np.int32)
    r[:, 0] = 65535
    ranks = torch.from_numpy(r).to(cuda)
    before = native.launches["morton"]
    got = zorder.interleave(ranks)
    torch.cuda.synchronize()
    assert native.launches["morton"] == before + 1
    assert torch.equal(got, zorder.interleave_plain(ranks))


@pytest.mark.parametrize("case", ZSORT_CASES)
def test_key_order_and_rank_match_numpy(cuda, case):
    """The key's stable unsigned order and a column's stable rank on the
    card against numpy's stable argsort (all equal: the sort runs no pass
    and the sink writes the identity)."""
    from delta_tpu_torch.ops import zorder

    key = zsort_case(case)
    dkey = torch.from_numpy(key).to(cuda)
    before = dict(native.launches)
    perm = zorder.key_order(dkey)
    ranks = zorder.rank_column(dkey)
    torch.cuda.synchronize()
    assert native.launches["morton_sort"] - before["morton_sort"] == 1
    assert native.launches["morton_rank"] - before["morton_rank"] == 1
    assert perm.dtype == torch.int32 and ranks.dtype == torch.int32
    assert np.array_equal(perm.cpu().numpy(), reference_key_order(key))
    assert np.array_equal(ranks.cpu().numpy(), reference_rank(key))
    assert torch.equal(perm.cpu(), zorder.key_order_plain(dkey.cpu()))
    small = np.clip(key, -(1 << 31), (1 << 31) - 1).astype(np.int32)  # an int32 column
    got32 = zorder.rank_column(torch.from_numpy(small).to(cuda))
    assert np.array_equal(got32.cpu().numpy(), reference_rank(small))


def test_morton_order_on_the_card_runs_no_host_sort(cuda, monkeypatch):
    """morton_order of integer columns on the card: the ranks and the key's
    sort on the card (no host argsort), equal to numpy's order; a double
    column keeps the host rank."""
    import chip_smoke
    from delta_tpu_torch.ops import zorder

    data = chip_smoke.store_sales(200_000, np.random.RandomState(5))
    cols = [data["ss_item_sk"], data["ss_sold_date_sk"].astype(np.int32)]
    want = chip_smoke.reference_morton(cols)
    real_argsort = np.argsort

    def no_host_sort(*a, **kw):
        raise AssertionError("morton_order sorted on the host")

    monkeypatch.setattr(np, "argsort", no_host_sort)
    before = dict(native.launches)
    got = zorder.morton_order(cols, device=cuda)
    monkeypatch.setattr(np, "argsort", real_argsort)
    assert native.launches["morton_rank"] - before["morton_rank"] == 2
    assert native.launches["morton_sort"] - before["morton_sort"] == 1
    assert np.array_equal(got, want)
    floats = [data["ss_sales_price"], data["ss_item_sk"]]
    floats[0][::97] = np.nan
    floats[0][::89] = -0.0
    before = dict(native.launches)
    got = zorder.morton_order(floats, device=cuda)
    assert native.launches["morton_rank"] - before["morton_rank"] == 1
    assert np.array_equal(got, chip_smoke.reference_morton(floats))


# -- DELETE, UPDATE and RESTORE before a MERGE (the sixteenth slice) -------------------


def dml_then_merge(dev, root):
    """A DV DELETE (its candidates through K1 under ``devicePlan.mode=force``),
    a MERGE that advances the resident slab over it, a DV UPDATE that moves
    keys, a second MERGE, then a RESTORE to before the DELETE and a MERGE
    that rebuilds the slab. Returns each step's launch counts, routes and
    metrics, and the end state's columns sorted by key."""
    import os

    from delta_tpu_torch import DeltaTable, MergeClause, MergeIntoCommand, WriteIntoDelta
    from delta_tpu_torch.commands.alter import set_table_properties
    from delta_tpu_torch.ops.key_cache import KeyCache
    from delta_tpu_torch.utils.config import conf

    rng = np.random.RandomState(11)
    n = 40_000
    target = {"k": rng.permutation(n * 2)[:n].astype(np.int64), "v": rng.rand(n),
              "q": rng.randint(0, 100, n).astype(np.int64)}
    DeltaLog.clear_cache()
    KeyCache.reset()
    path = os.path.join(str(root), dev.type)
    settings = {"delta.tpu.write.targetFileRows": 10_000,
                "delta.tpu.merge.devicePath.mode": "force",
                "delta.tpu.stateCache.devicePlan.mode": "force"}
    steps = []
    with conf.set_temporarily(**settings):
        log = DeltaLog.for_table(path, device=dev)
        WriteIntoDelta(log, "append", target).run()
        set_table_properties(log, {"delta.tpu.enableDeletionVectors": "true"})
        t = DeltaTable.for_path(path, device=dev)

        def merge(keys):
            src = {"k": keys.astype(np.int64), "v": rng.rand(len(keys)),
                   "q": rng.randint(0, 100, len(keys)).astype(np.int64)}
            cmd = MergeIntoCommand(log, src, "t.k = s.k", [MergeClause("update")],
                                   [MergeClause("insert")], source_alias="s", target_alias="t")
            cmd.run()
            return cmd._join_path, {k: v for k, v in cmd.metrics.items()
                                    if not k.endswith("TimeMs")}

        def step(name, fn):
            native.reset_launches()
            out = fn()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            steps.append((name, {k: v for k, v in native.launches.items() if v}, out))

        step("merge0", lambda: merge(target["k"][:500]))
        before = t.version
        step("delete", lambda: {k: v for k, v in t.delete("q >= 90").items()
                                if not k.endswith("TimeMs")})
        step("merge1", lambda: merge(np.concatenate([target["k"][500:1500],
                                                      np.arange(n * 2, n * 2 + 200)])))
        step("update", lambda: {k: v for k, v in t.update(
            {"k": "k + 1000000"}, "q < 5").items() if not k.endswith("TimeMs")})
        step("merge2", lambda: merge(np.concatenate([target["k"][:300] + 1_000_000,
                                                      target["k"][2000:2300]])))
        step("restore", lambda: t.restore_to_version(before)["numRestoredFiles"])
        step("merge3", lambda: merge(target["k"][3000:3400]))
        end = t.to_table()
    order = np.argsort(end.column("k").values, kind="stable")
    return steps, {c: end.column(c).values[order] for c in ("k", "v", "q")}


def test_dml_then_merge_on_the_card_matches_the_cpu(cuda, tmp_path):
    """The DML slice on the card: the DV DELETE launches K1, the MERGEs
    after the DV commands take the resident route, advancing the slab
    (``slab_advance``; at most one K8, the re-sort appended keys need), the
    MERGE after RESTORE rebuilds it (K8); routes, metrics and the end state
    equal the same run on the CPU, whose plain versions count nothing."""
    got, got_end = dml_then_merge(cuda, tmp_path)
    want, want_end = dml_then_merge(torch.device("cpu"), tmp_path)
    assert [(n, out) for n, _, out in got] == [(n, out) for n, _, out in want]
    launches = {n: c for n, c, _ in got}
    assert launches["delete"].get("block_cull", 0) >= 1
    for name in ("merge1", "merge2"):
        assert launches[name].get("slab_advance", 0) >= 1, name
        assert launches[name].get("slab_sort", 0) <= 1, name
    assert launches["merge3"].get("slab_sort", 0) >= 1
    assert [out[0] for n, _, out in got if n.startswith("merge")] == [
        "device-cold", "resident", "resident", "device-cold"]
    for c in ("k", "v", "q"):
        assert np.array_equal(got_end[c], want_end[c]), c


# -- partitioned tables (the seventeenth slice) ---------------------------------------


def _typed_partition_table(path):
    """Three files, each with its own value (one NULL) of an int, a double,
    a bool, a date and a timestamp partition column, written on the CPU."""
    from delta_tpu_torch import WriteIntoDelta
    from delta_tpu_torch.expr.vectorized import HostColumn, HostTable

    per_file = {"i": ("int", [5, 0, -2]), "f": ("double", [1.5, 0.0, float("nan")]),
                "b": ("bool", [True, False, False]), "d": ("date", [18262, 0, -1]),
                "t": ("ts", [1577840400000000, 0, -315619200000000])}
    log = DeltaLog.for_table(path, device="cpu")
    n = 1000
    for k in range(3):
        cols = {"id": HostColumn("int", np.arange(k * n, (k + 1) * n, dtype=np.int64),
                                 np.ones(n, bool)),
                "x": HostColumn("double", np.random.RandomState(k).rand(n), np.ones(n, bool))}
        for name, (kind, vals) in per_file.items():
            dt = {"int": np.int64, "double": np.float64, "bool": bool}.get(kind, np.int64)
            cols[name] = HostColumn(kind, np.full(n, vals[k], dt), np.full(n, k != 1))
        WriteIntoDelta(log, "append", HostTable(cols, n), partition_columns=list(per_file)).run()


PARTITION_PREDICATES = ["i = 5 OR x > 0.9", "i IS NULL AND x < 0.3", "f > 1.0 OR id = 2500",
                        "NOT b AND x >= 0.5", "d >= '2020-01-01' OR x < 0.01",
                        "t < '2000-01-01' AND x > 0.4", "coalesce(i, 100) > 50 AND x > 0.1"]


def test_residual_mask_with_partition_scalars_matches_plain(cuda, tmp_path):
    """A read mixing NULL and non-NULL partitions of every lane dtype: K14
    runs once over the three files, each file's partition values bound as
    its scalars, and its mask equals the plain version's bit for bit; the
    rows equal the same read on the CPU."""
    import shutil

    from delta_tpu_torch import DeltaTable
    from delta_tpu_torch.ops import column_cache
    from delta_tpu_torch.ops.column_cache import ColumnCache
    from delta_tpu_torch.utils.config import conf

    path = str(tmp_path / "t")
    _typed_partition_table(path)
    shutil.copytree(path, path + "-cpu")
    real = column_cache.residual_masks
    seen = []

    def checking(program, envs, ns, scalars):
        got, offs = real(program, envs, ns, scalars)
        ref, ref_offs = column_cache.residual_masks_plain(program, envs, ns, scalars)
        torch.cuda.synchronize()
        seen.append((len(envs), len(program.scalar_slots),
                     offs == ref_offs and torch.equal(got.cpu(), ref.cpu())))
        return got, offs

    ColumnCache.reset()
    column_cache.residual_masks = checking
    try:
        with conf.set_temporarily(**{"delta.tpu.read.deviceResidual.mode": "force"}):
            for pred in PARTITION_PREDICATES:
                del seen[:]
                before = native.launches["residual_mask"]
                got = DeltaTable.for_path(path, device=cuda).to_table(filters=[pred])
                assert seen and all(ok for _n, _s, ok in seen), pred
                assert native.launches["residual_mask"] > before, pred
                ref = DeltaTable.for_path(path + "-cpu", device="cpu").to_table(filters=[pred])
                assert sorted(got.column("id").values.tolist()) == \
                    sorted(ref.column("id").values.tolist()), pred
    finally:
        column_cache.residual_masks = real


def test_partitioned_write_read_merge_on_the_card_match_the_cpu(cuda, tmp_path):
    """store_sales partitioned by date (40,000 rows, 50 partitions, deletion
    vectors on) through the writer, a read with the device residual, a
    MERGE on the key slab, a DV DELETE and an UPDATE of the partition
    column, on the card and on the CPU: the same rows and the same
    partition directories."""
    import os
    import urllib.parse

    import chip_smoke
    from delta_tpu_torch import DeltaTable, MergeClause, MergeIntoCommand, WriteIntoDelta
    from delta_tpu_torch.commands.alter import set_table_properties
    from delta_tpu_torch.ops.column_cache import ColumnCache
    from delta_tpu_torch.utils.config import conf

    n = 40_000
    target = chip_smoke.store_sales(n, np.random.RandomState(7))
    target["ss_sold_date_sk"] = 2450000 + target["ss_sold_date_sk"] % 50
    src = chip_smoke.store_sales(4_000, np.random.RandomState(8))
    src["ss_item_sk"][:2000] = target["ss_item_sk"][:2000]
    src["ss_item_sk"][2000:] += 10 * n
    src["ss_sold_date_sk"] = 2450000 + src["ss_sold_date_sk"] % 60
    out = {}
    key_cache.KeyCache.reset()
    ColumnCache.reset()
    for name, dev in (("card", cuda), ("cpu", "cpu")):
        path = str(tmp_path / name)
        log = DeltaLog.for_table(path, device=dev)
        WriteIntoDelta(log, "append", dict(target), partition_columns=["ss_sold_date_sk"]).run()
        set_table_properties(log, {"delta.tpu.enableDeletionVectors": "true"})
        table = DeltaTable.for_path(path, device=dev)
        settings = {"delta.tpu.read.deviceResidual.mode": "force",
                    "delta.tpu.merge.devicePath.mode": "force",
                    "delta.tpu.stateCache.devicePlan.mode": "force"}
        with conf.set_temporarily(**settings):
            read = table.to_table(filters=["ss_sold_date_sk = 2450007 OR ss_quantity > 97"])
            cmd = MergeIntoCommand(log, dict(src), "t.ss_item_sk = s.ss_item_sk",
                                   [MergeClause("update")], [MergeClause("insert")],
                                   source_alias="s", target_alias="t")
            cmd.run()
            table.delete("ss_quantity >= 96")
            table.update({"ss_sold_date_sk": "ss_sold_date_sk + 1"}, "ss_store_sk < 20")
            end = table.to_table()
        dirs = sorted(os.path.dirname(urllib.parse.unquote(f.path))
                      for f in log.update().all_files)
        out[name] = (chip_smoke.state_of(read), chip_smoke.state_of(end), cmd.metrics, dirs,
                     cmd._join_path)
    for a, b in zip(out["card"][:2], out["cpu"][:2]):
        assert all(np.array_equal(a[c], b[c]) for c in chip_smoke.STORE_SALES)
    assert {k: v for k, v in out["card"][2].items() if not k.endswith("TimeMs")} == \
        {k: v for k, v in out["cpu"][2].items() if not k.endswith("TimeMs")}
    assert out["card"][3] == out["cpu"][3] and out["card"][4] == out["cpu"][4] == "device-cold"


def test_decimal_store_sales_read_and_merge_on_the_card_match_the_cpu(cuda, tmp_path):
    """store_sales with its money columns decimal(7,2) (40,000 rows in 4
    files, deletion vectors on): a read with the residual on the card (K14)
    that returns the decimal columns, a read whose residual names a decimal
    (the host), a MERGE on the key slab setting the decimals (K8-K10) and a
    DV UPDATE of a decimal by decimal arithmetic, on the card and on the
    CPU: the same unscaled values and metrics."""
    import chip_smoke
    from delta_tpu_torch import DeltaTable, MergeClause, MergeIntoCommand, WriteIntoDelta
    from delta_tpu_torch.commands.alter import set_table_properties
    from delta_tpu_torch.ops.column_cache import ColumnCache
    from delta_tpu_torch.utils.config import conf

    n = 40_000
    target = chip_smoke.typed_store_sales(n, np.random.RandomState(7))
    src = chip_smoke.typed_store_sales(4_000, np.random.RandomState(8))
    src["ss_item_sk"][:2000] = target["ss_item_sk"][:2000]
    src["ss_item_sk"][2000:] += 10 * n
    out = {}
    key_cache.KeyCache.reset()
    ColumnCache.reset()
    for name, dev in (("card", cuda), ("cpu", "cpu")):
        path = str(tmp_path / name)
        log = DeltaLog.for_table(path, device=dev)
        with conf.set_temporarily(**{"delta.tpu.write.targetFileRows": 10_000}):
            WriteIntoDelta(log, "append", chip_smoke.decimal_table(target)).run()
        set_table_properties(log, {"delta.tpu.enableDeletionVectors": "true"})
        table = DeltaTable.for_path(path, device=dev)
        settings = {"delta.tpu.read.deviceResidual.mode": "force",
                    "delta.tpu.merge.devicePath.mode": "force",
                    "delta.tpu.stateCache.devicePlan.mode": "force"}
        with conf.set_temporarily(**settings):
            before = native.launches["residual_mask"]
            read = table.to_table(filters=["ss_quantity > 50"])
            k14 = native.launches["residual_mask"] - before
            host = table.to_table(filters=["ss_net_paid > 45.00"])
            cmd = MergeIntoCommand(log, chip_smoke.decimal_table(src),
                                   "t.ss_item_sk = s.ss_item_sk", [MergeClause("update")],
                                   [MergeClause("insert")], source_alias="s", target_alias="t")
            cmd.run()
            m = table.update({"ss_net_paid": "ss_sales_price * ss_quantity"}, "ss_store_sk < 50")
            end = table.to_table()
        assert all(end.column(c).type == chip_smoke.DEC_TYPE for c in chip_smoke.DEC_MONEY)
        out[name] = (chip_smoke.state_of(read), chip_smoke.state_of(host),
                     chip_smoke.state_of(end), cmd.metrics, m, cmd._join_path, k14)
    for a, b in zip(out["card"][:3], out["cpu"][:3]):
        assert all(np.array_equal(a[c], b[c]) for c in chip_smoke.STORE_SALES)
    for i in (3, 4):
        assert {k: v for k, v in out["card"][i].items() if not k.endswith("TimeMs")} == \
            {k: v for k, v in out["cpu"][i].items() if not k.endswith("TimeMs")}
    assert out["card"][5] == out["cpu"][5] == "device-cold"
    assert out["card"][6] >= 1
    want = chip_smoke.take_state(target, target["ss_net_paid"] > 4500)
    assert all(np.array_equal(out["card"][1][c], want[c]) for c in chip_smoke.STORE_SALES)


def test_nested_merge_on_the_card_matches_the_cpu(cuda, tmp_path):
    """A table of struct, list and map columns (20,000 rows): a MERGE with
    update * / insert * on the key slab (K8-K10), a DV DELETE and OPTIMIZE,
    on the card and on the CPU: the same rows as the Python reference."""
    import chip_smoke
    from delta_tpu_torch import DeltaTable, MergeClause, MergeIntoCommand, WriteIntoDelta
    from delta_tpu_torch.commands.alter import set_table_properties
    from delta_tpu_torch.commands.optimize import OptimizeCommand
    from delta_tpu_torch.ops.column_cache import ColumnCache
    from delta_tpu_torch.utils.config import conf

    n = 20_000
    target, ref = chip_smoke.nested_columns(np.arange(n), 51)
    ids = np.concatenate([np.arange(0, n, 7), np.arange(n, n + 1000)])
    src, src_ref = chip_smoke.nested_columns(ids, 53)
    ref.update(src_ref)
    ref = {k: v for k, v in ref.items() if k % 10}
    key_cache.KeyCache.reset()
    ColumnCache.reset()
    for name, dev in (("card", cuda), ("cpu", "cpu")):
        path = str(tmp_path / name)
        log = DeltaLog.for_table(path, device=dev)
        with conf.set_temporarily(**{"delta.tpu.write.targetFileRows": 5_000}):
            WriteIntoDelta(log, "append", target).run()
        set_table_properties(log, {"delta.tpu.enableDeletionVectors": "true"})
        with conf.set_temporarily(**{"delta.tpu.merge.devicePath.mode": "force",
                                     "delta.tpu.stateCache.devicePlan.mode": "force"}):
            cmd = MergeIntoCommand(log, src, "t.id = s.id", [MergeClause("update")],
                                   [MergeClause("insert")], source_alias="s", target_alias="t")
            cmd.run()
            DeltaTable.for_path(path, device=dev).delete("id % 10 = 0")
            OptimizeCommand(log, None).run()
        assert cmd._join_path == "device-cold"
        got = DeltaTable.for_path(path, device=dev).to_table().to_pylist()
        assert len(got) == len(ref) and all(row == ref[row["id"]] for row in got), name


# -- the page codec: snappy_compress and snappy_decompress -----------------------------


def _codec_pages():
    from torch_kernel_cases import codec_pages

    return codec_pages(big=True)


def test_snappy_compress_decodes_through_the_plain_decoder(cuda):
    """The kernel's Snappy of every page decodes through the plain decoder
    to the page, and its bytes are within 1.03x of the plain compressor's,
    on every page and on the batch."""
    from delta_tpu_torch.exec import snappy
    from delta_tpu_torch.ops import page_codec

    pages = _codec_pages()
    before = native.launches["snappy_compress"]
    got = page_codec.compress([p for _, p in pages], cuda)
    assert native.launches["snappy_compress"] == before + 1
    plain = [len(snappy.compress(p)) for _, p in pages]
    for (name, p), z, n in zip(pages, got, plain):
        assert snappy.decompress(z) == p, name
        assert len(z) <= 1.03 * n, (name, len(z), n)
    ratio = sum(map(len, got)) / sum(plain)
    print(f"snappy_compress: {sum(map(len, got))} bytes, the plain compressor {sum(plain)}: "
          f"{ratio:.4f}x")
    assert ratio <= 1.03


def test_snappy_decompress_matches_the_plain_decoder(cuda):
    """The plain compressor's Snappy and the kernel's own decode through
    the kernel, in one batch each, byte for byte as the plain decoder
    decodes them."""
    from delta_tpu_torch.exec import snappy
    from delta_tpu_torch.ops import page_codec

    pages = _codec_pages()
    raw = [p for _, p in pages]
    sizes = [len(p) for p in raw]
    for z in ([snappy.compress(p) for p in raw], page_codec.compress(raw, cuda)):
        before = native.launches["snappy_decompress"]
        got = page_codec.decompress(z, sizes, cuda, [n for n, _ in pages])
        assert native.launches["snappy_decompress"] == before + 1
        assert got == [snappy.decompress(x) for x in z] == raw


def test_snappy_batches_past_the_staging_cap_go_in_chunks(cuda, monkeypatch):
    """With ``STAGING_CAP`` at 1 MiB the codec batch goes in chunks, a
    launch set each, to the same bytes as one launch; the 8 MiB page stages
    alone in buffers it frees, and the kept pinned buffers stay within the
    cap."""
    from delta_tpu_torch.exec import snappy
    from delta_tpu_torch.ops import page_codec

    pages = _codec_pages()
    raw = [p for _, p in pages]
    sizes = [len(p) for p in raw]
    whole = page_codec.compress(raw, cuda)
    monkeypatch.setattr(page_codec, "STAGING_CAP", 1 << 20)
    monkeypatch.setattr(page_codec, "_pinned", {})
    c_need = [-(-n // snappy.FRAGMENT) * (page_codec.FRAG_CAP + 16) for n in sizes]
    d_need = [max(len(z), n) + 36 for z, n in zip(whole, sizes)]
    before = dict(native.launches)
    got = page_codec.compress(raw, cuda)
    back = page_codec.decompress(whole, sizes, cuda, [n for n, _ in pages])
    assert native.launches["snappy_compress"] - before["snappy_compress"] == len(
        [g for g in page_codec._chunks(c_need) if sum(sizes[g.start:g.stop])])
    assert native.launches["snappy_decompress"] - before["snappy_decompress"] == len(
        page_codec._chunks(d_need)) > 1
    assert got == whole and back == raw
    assert all(b.numel() <= 1 << 20 for b in page_codec._pinned.values())


@pytest.mark.parametrize("case", ["truncated", "offset-0", "before-page", "preamble", "overflow"])
def test_snappy_decompress_rejects_a_malformed_page(cuda, case):
    """A malformed body raises ``SnappyError`` naming its label, alone and
    among good pages, and writes nothing past its slot."""
    import chip_smoke
    from delta_tpu_torch.exec import snappy
    from delta_tpu_torch.ops import page_codec
    from torch_kernel_cases import codec_malformed

    bad = [b for b in codec_malformed() if b[0] == case]
    name, body, size = bad[0]
    good = [b"hello world " * 50, bytes(1000)]
    z = [snappy.compress(g) for g in good]
    with pytest.raises(snappy.SnappyError, match="file.parquet: column 'x'"):
        page_codec.decompress([z[0], body, z[1]], [len(good[0]), size, len(good[1])], cuda,
                              ["a", "file.parquet: column 'x'", "b"])
    chip_smoke.codec_guard_check(cuda, bad, z, good)


def test_snappy_decompress_reads_streams_the_port_never_writes(cuda):
    """``tests/torch_kernel_cases.py``'s streams (copy-1, -2 and -4 tags,
    copy-4 offsets past 64 KiB in a 2 MiB page, overlapping copies of every
    offset 1-63 at lengths 4-64, literals of 1-4 length bytes and one over
    64 KiB, one long run) decode through the kernel in one launch, byte for
    byte, as the plain decoder decodes them."""
    from delta_tpu_torch.exec import snappy
    from delta_tpu_torch.ops import page_codec
    from torch_kernel_cases import codec_streams

    streams = codec_streams()
    before = native.launches["snappy_decompress"]
    got = page_codec.decompress([b for _, b, _ in streams], [len(w) for _, _, w in streams],
                                cuda, [n for n, _, _ in streams])
    assert native.launches["snappy_decompress"] == before + 1
    for (name, body, want), g in zip(streams, got):
        assert g == want == snappy.decompress(body), name


@pytest.mark.parametrize("case", CODEC_FAULTS)
def test_snappy_decompress_stops_a_page_at_a_fault_past_its_33rd_element(cuda, case):
    """A fault after a page's 33rd element (in its first input chunk, or
    thousands of elements in) raises ``SnappyError`` naming the page among
    good pages, sets its own error word and no other, and nothing is written
    past any slot, the elements queued after the fault included."""
    import chip_smoke
    from delta_tpu_torch.exec import snappy
    from delta_tpu_torch.ops import page_codec
    from torch_kernel_cases import codec_faults

    name, body, size, word = [f for f in codec_faults() if f[0] == case][0]
    good = [b"hello world " * 50, bytes(1000)]
    z = [snappy.compress(g) for g in good]
    with pytest.raises(snappy.SnappyError, match="file.parquet: column 'x'"):
        page_codec.decompress([z[0], body, z[1]], [len(good[0]), size, len(good[1])], cuda,
                              ["a", "file.parquet: column 'x'", "b"])
    chip_smoke.codec_guard_check(cuda, [(name, body, size)], z, good, [word])


def test_parquet_write_and_read_on_the_card_match_the_cpu(cuda, tmp_path):
    """A table written on the card is the file the CPU writes but for the
    compressors' bytes: the same codecs and encodings, and each package's
    device reads the other's file to the same rows."""
    from delta_tpu_torch.exec import parquet as pqx
    from delta_tpu_torch.expr.vectorized import HostColumn, HostTable

    rng = np.random.RandomState(5)
    n = 300_000
    t = HostTable({
        "i": HostColumn("int", rng.randint(0, 1000, n).astype(np.int64), rng.rand(n) > 0.1),
        "r": HostColumn("int", rng.randint(-2**62, 2**62, n).astype(np.int64), np.ones(n, bool)),
        "f": HostColumn("double", rng.rand(n), np.ones(n, bool)),
        "s": HostColumn("str", np.array([f"v{x}" for x in rng.randint(0, 50, n)], object),
                        np.ones(n, bool)),
    }, n)
    paths = {d: str(tmp_path / f"{d}.parquet") for d in ("cpu", "cuda")}
    for d, p in paths.items():
        pqx.write_parquet_file(t, p, device=d)
    metas = {d: pqx.read_metadata(p) for d, p in paths.items()}
    chunks = {d: [(c.meta_data.codec, sorted(set(c.meta_data.encodings)))
                  for rg in m.row_groups for c in rg.columns] for d, m in metas.items()}
    assert chunks["cpu"] == chunks["cuda"]
    for d in ("cpu", "cuda"):
        for p in paths.values():
            got = pqx.read_parquet_file(p, device=d)
            for c in t.column_names:
                v = t.columns[c].valid
                assert np.array_equal(got.columns[c].valid, v)
                assert np.array_equal(got.columns[c].values[v], t.columns[c].values[v])


# -- the table API (the twenty-first slice) -------------------------------------------


def _api_table(path, device, n_files=40, rows=2000):
    """A CTAS of ``n_files`` files through the API (the writer's page codec
    on ``device``), then appends: ``id`` keys spread over the files."""
    from delta_tpu_torch import DeltaTable

    rng = np.random.RandomState(21)
    per = rows // n_files
    t = None
    for f in range(n_files):
        ids = np.arange(f * per, (f + 1) * per, dtype=np.int64)
        data = {"id": ids, "v": rng.randint(0, 1000, per).astype(np.int64),
                "s": np.array([f"k{i % 97}" for i in ids], object)}
        if t is None:
            t = DeltaTable.create(path, data=data, device=device,
                                  configuration={"delta.tpu.enableDeletionVectors": "true"})
        else:
            t.write(data)
    return t


def test_plan_queries_on_the_card_match_the_cpu(cuda, tmp_path):
    """plan_queries of a batch on the card: one K1 launch, every plan equal
    (paths, count, overflow) to the same batch planned on the CPU."""
    from delta_tpu_torch import DeltaTable
    from delta_tpu_torch.utils.config import conf

    path = str(tmp_path / "t")
    _api_table(path, torch.device("cpu"))
    queries = [[f"id >= {i * 37} AND id <= {i * 37 + 60}"] for i in range(50)]
    queries += [["id < 100 OR id > 1900"], ["s = 'k3'"], [], ["v % 2 = 0"]]
    want = [(p.paths, p.count, p.overflow)
            for p in DeltaTable.for_path(path, device="cpu").plan_queries(queries, k=8)]
    state_cache.DeviceStateCache.reset()
    with conf.set_temporarily(**{"delta.tpu.stateCache.devicePlan.mode": "force"}):
        t = DeltaTable.for_path(path, device=cuda)
        t.plan_queries(queries[:1])  # the residency
        native.reset_launches()
        got = t.plan_queries(queries, k=8)
        launches = dict(native.launches)
    assert [(p.paths, p.count, p.overflow) for p in got] == want
    assert launches.get("block_cull", 0) == 1
    assert {p.via for p in got[:50]} == {"device"}


def test_merge_builder_on_the_card_matches_merge_into_command(cuda, tmp_path):
    """The fluent builder's MERGE on the card equals MergeIntoCommand run
    directly on a copy of the same table: metrics and end state."""
    import shutil

    from delta_tpu_torch import DeltaTable, MergeClause, MergeIntoCommand

    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    _api_table(a, cuda)
    shutil.copytree(a, b)
    rng = np.random.RandomState(5)
    keys = np.concatenate([rng.choice(2000, 300, replace=False),
                           np.arange(5000, 5200)]).astype(np.int64)
    src = {"id": keys, "v": rng.randint(0, 1000, len(keys)).astype(np.int64),
           "s": np.array([f"n{i}" for i in keys], object)}
    DeltaLog.clear_cache()
    m1 = (DeltaTable.for_path(a, device=cuda).alias("t")
          .merge(src, "t.id = s.id", source_alias="s")
          .when_matched_update_all().when_not_matched_insert_all().execute())
    cmd = MergeIntoCommand(DeltaLog.for_table(b, device=cuda), src, "t.id = s.id",
                           [MergeClause("update")], [MergeClause("insert")],
                           source_alias="s", target_alias="t")
    cmd.run()
    drop = lambda m: {k: v for k, v in m.items() if not k.endswith("TimeMs")}  # noqa: E731
    assert drop(m1) == drop(cmd.metrics)
    assert m1["numTargetRowsUpdated"] == 300 and m1["numTargetRowsInserted"] == 200

    def rows(p):
        got = DeltaTable.for_path(p, device=cuda).to_table().to_pylist()
        return sorted((r["id"], r["v"], r["s"]) for r in got)

    assert rows(a) == rows(b)


def test_ctas_and_convert_on_the_card_match_the_cpu(cuda, tmp_path):
    """A CTAS written on the card and a CONVERT of Parquet files written on
    the card read back equal to the same built on the CPU (rows, stats)."""
    import os

    from delta_tpu_torch import DeltaTable
    from delta_tpu_torch.commands.write import coerce_to_table
    from delta_tpu_torch.exec.parquet import write_parquet_file
    from delta_tpu_torch.schema.types import StructField

    def build(root, device):
        t = _api_table(os.path.join(root, "ctas"), device, n_files=4)
        conv = os.path.join(root, "conv")
        for day in range(4):
            os.makedirs(os.path.join(conv, f"d={day}"))
            ids = np.arange(day * 500, (day + 1) * 500, dtype=np.int64)
            write_parquet_file(coerce_to_table({"id": ids, "x": ids * 0.5}),
                               os.path.join(conv, f"d={day}", "part-0.parquet"), device=device)
        c = DeltaTable.convert_to_delta(conv, StructType([StructField("d", IntegerType())]),
                                        device=device)
        stats = sorted(f.stats or "" for f in c.delta_log.update().all_files)
        return (sorted(tuple(r.values()) for r in t.to_table().to_pylist()),
                sorted(tuple(r.values()) for r in c.to_table(filters=["id > 1700"]).to_pylist()),
                stats)

    assert build(str(tmp_path / "gpu"), cuda) == build(str(tmp_path / "cpu"), "cpu")


# -- write semantics on the card ----------------------------------------------------------


def _cdf_merge_run(device, root):
    """A small CDF MERGE with schema evolution and a generated column, on one
    device: the table's rows, the CDC file's rows and the change feed."""
    import glob
    import os

    from delta_tpu_torch import DeltaTable
    from delta_tpu_torch.exec.parquet import read_parquet_files
    from delta_tpu_torch.schema.generated import generated_field
    from delta_tpu_torch.utils.config import conf

    path = os.path.join(root, "t")
    schema = (StructType().add("id", LongType()).add("q", LongType())
              .add_field(generated_field("g", LongType(), "q * 3")))
    t = DeltaTable.create(path, schema, device=device, configuration={
        "delta.enableChangeDataFeed": "true", "delta.tpu.enableDeletionVectors": "true",
        "delta.constraints.qpos": "q > 0"})
    rng = np.random.RandomState(11)
    n = 5000
    t.write({"id": np.arange(n, dtype=np.int64), "q": rng.randint(1, 100, n).astype(np.int64)})
    src_ids = np.concatenate([rng.choice(n, 300, replace=False), np.arange(n, n + 200)])
    source = {"id": src_ids.astype(np.int64),
              "q": rng.randint(1, 100, len(src_ids)).astype(np.int64),
              "tag": np.array([f"t{i % 7}" for i in range(len(src_ids))], object)}
    with conf.set_temporarily(**{"delta.tpu.schema.autoMerge.enabled": True,
                                 "delta.tpu.merge.devicePath.mode": "force"}):
        (t.alias("t").merge(source, "t.id = s.id", source_alias="s")
         .when_matched_update_all().when_not_matched_insert_all().execute())
    cdc = sorted(glob.glob(os.path.join(path, "_change_data", "*.parquet")))
    def ordered(rows):  # NULLs in the new column: sort on the values' reprs
        return sorted((tuple(r.values()) for r in rows), key=repr)

    cdc_rows = ordered(r for f in read_parquet_files(cdc, device=device) for r in f.to_pylist())
    feed = [{k: v for k, v in r.items() if k != "_commit_timestamp"}
            for r in t.table_changes(1).to_pylist()]
    return ordered(t.to_table().to_pylist()), cdc_rows, ordered(feed)


def test_cdf_merge_with_evolution_on_the_card_matches_the_cpu(cuda, tmp_path):
    """Its table, its CDC rows and its ``table_changes`` on ``cuda`` equal
    the same run on the CPU, the key slab kernels (K8-K11) and the page
    codec launched on the card."""
    before = dict(native.launches)
    got = _cdf_merge_run("cuda", str(tmp_path / "cuda"))
    launched = {k for k, v in native.launches.items() if v > before.get(k, 0)}
    want = _cdf_merge_run("cpu", str(tmp_path / "cpu"))
    assert got == want
    assert len(got[1]) == 300 * 2 + 200
    assert launched & {"snappy_compress", "slab_sort", "slab_probe"}

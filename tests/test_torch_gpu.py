"""The port's CUDA kernels on the card, each against its plain PyTorch
version, and the scan path on the card against the same path on the CPU.

Every test here is marked ``gpu`` and skips inside the test when no CUDA
device is visible. The file imports torch, numpy and ``delta_tpu_torch``
only (no JAX, no pyarrow), so it also runs where the JAX package cannot be
imported:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerance: exact equality (bits, packed bytes, f32 lanes bit for bit, file
lists).
"""
import json

import numpy as np
import pytest
import torch

from delta_tpu_torch import DeltaLog
from delta_tpu_torch.expr.parser import parse_expression
from delta_tpu_torch.ops import native, pruning, replay_kernel, state_cache
from delta_tpu_torch.protocol import filenames
from delta_tpu_torch.protocol.actions import AddFile, Metadata, Protocol, RemoveFile
from delta_tpu_torch.schema.types import DoubleType, IntegerType, LongType, StringType, StructType

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


@pytest.mark.parametrize("c,cap,m", [(1, 1024, 1), (4, 1 << 20, 256), (5, 8192, 37),
                                     (40, 8192, 33)])
def test_block_cull_kernel_matches_plain(cuda, c, cap, m):
    rng = np.random.RandomState(cap + m + c)
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
    ts = [torch.from_numpy(a).to(cuda) for a in (mins, maxs, alive, lo, hi)]
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
    p = torch.arange(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        replay_kernel.winner_bits(p, 7)


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


def test_expr_eval_kernel_matches_plain(cuda):
    """chip_smoke.py's corpus at 4096 rows: bit for bit, except exp / log /
    pow / sqrt, within 1 ulp."""
    import chip_smoke
    from delta_tpu_torch.expr import device_eval

    env = chip_smoke.k15_columns(4096, 5, cuda)
    before = native.launches["expr_eval"]
    for sql in chip_smoke.K15_CORPUS:
        program = device_eval.compile_expr(parse_expression(sql)).program(env)
        got = device_eval.expr_eval(program, env)
        torch.cuda.synchronize()
        ref = device_eval.expr_eval_plain(program, env)
        assert torch.equal(got.valid, ref.valid), sql
        if got.values.is_floating_point():
            lanes, ulps = chip_smoke.ulp_diff(got.values, ref.values)
            assert lanes == 0 or (any(f in sql for f in chip_smoke._TRANSCENDENTAL)
                                  and ulps <= 1), sql
        else:
            assert torch.equal(got.values, ref.values), sql
    assert native.launches["expr_eval"] == before + len(chip_smoke.K15_CORPUS)


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

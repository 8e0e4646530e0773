"""The port's log decode and winner kernel (``delta_tpu_torch.log.columnar``,
``delta_tpu_torch.ops.replay_kernel``) held against ``delta_tpu`` on the CPU.

Tolerance: exact equality (packed bytes, boolean masks, integer columns and
counts are integer results of the same definitions).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from delta_tpu.log.columnar import decode_segment as jax_decode
from delta_tpu.log.deltalog import DeltaLog as JaxDeltaLog
from delta_tpu.ops import replay_kernel as jrk
from delta_tpu_torch import DeltaLog as TorchDeltaLog
from delta_tpu_torch.log.columnar import decode_segment as torch_decode
from delta_tpu_torch.ops import replay_kernel as trk
from delta_tpu_torch.protocol import filenames
from delta_tpu_torch.storage.logstore import LocalLogStore
from tests.torch_port_tables import write_table, write_tail


@pytest.fixture(autouse=True)
def _fresh_caches():
    TorchDeltaLog.clear_cache()
    yield
    TorchDeltaLog.clear_cache()


def _path_ids(rng, n, num_paths, pad):
    pid = rng.randint(0, num_paths, n).astype(np.int32)
    if pad:
        pid[rng.rand(n) < 0.1] = -1  # padding rows never win
    return pid


@pytest.mark.parametrize("n,num_paths", [(8, 3), (64, 64), (1000, 37), (4096, 5000)])
@pytest.mark.parametrize("pad", [False, True])
def test_winner_bits_plain_matches_jax(n, num_paths, pad):
    rng = np.random.RandomState(n + num_paths)
    cap = trk._next_pow2(n, floor=8)
    pid = np.full(cap, -1, np.int32)
    pid[:n] = _path_ids(rng, n, num_paths, pad)
    ref = np.asarray(jrk._winner_bits_kernel(jnp.asarray(pid)))
    got = trk.winner_bits(torch.from_numpy(pid), num_paths)
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize("n", [1, 9, 777, 5000])
def test_winner_mask_device_matches_jax(n):
    rng = np.random.RandomState(n)
    num_paths = max(n // 3, 1)
    pid = _path_ids(rng, n, num_paths, pad=False)
    got = trk.winner_mask_device(pid, num_paths, device="cpu")
    assert np.array_equal(got, jrk.winner_mask_device(pid))


def test_winner_bits_rejects_out_of_range_ids():
    pid = torch.tensor([0, 1, 2, 3, 4, 5, 6, 7], dtype=torch.int32)
    with pytest.raises(ValueError):
        trk.winner_bits(pid, 7)


def _segment_pair(path):
    jsnap = JaxDeltaLog.for_table(path).update()
    tsnap = TorchDeltaLog.for_table(path, device="cpu").update()
    deltas = [f.path for f in jsnap.segment.deltas]
    return (jax_decode(jsnap.store, [], deltas), torch_decode(tsnap.delta_log.store, [], deltas),
            jsnap, tsnap)


@pytest.mark.parametrize("partitioned", [False, True])
def test_decode_segment_matches_jax(tmp_path, partitioned):
    path = str(tmp_path / "t")
    state = write_table(path, n_files=600, partitioned=partitioned)
    # decoded before the tail: the port's update() then extends this state
    # with the tail commits instead of decoding the whole segment again
    TorchDeltaLog.for_table(path, device="cpu").update()._columnar
    write_tail(path, state, n_commits=2)
    jc, tc, jsnap, tsnap = _segment_pair(path)
    for cols in (tc, tsnap._columnar):  # fresh decode, extended decode
        assert cols.path_dict == jc.path_dict.to_pylist()
        for name in ("path_id", "is_add", "size", "modification_time",
                     "deletion_timestamp"):
            assert np.array_equal(getattr(cols, name), getattr(jc, name)), name
        assert cols.stats == jc.stats.to_pylist()
        assert ([a.json() for a in cols.other_actions]
                == [a.json() for a in jc.other_actions])
        assert np.array_equal(cols.winner_mask(), jc.winner_mask())
    assert tsnap._columnar.lines == tc.lines
    assert tsnap._columnar.partition_values == tc.partition_values
    assert tsnap.metadata.json() == jsnap.metadata.json()
    assert tsnap.protocol.json() == jsnap.protocol.json()
    assert tsnap.num_of_files == jsnap.num_of_files
    assert tsnap.size_in_bytes == jsnap.size_in_bytes
    assert [a.json() for a in tsnap.all_files] == [a.json() for a in jsnap.all_files]


def test_replay_columns_matches_jax(tmp_path):
    path = str(tmp_path / "t")
    state = write_table(path, n_files=900)
    write_tail(path, state, n_commits=3)
    jc, tc, _, _ = _segment_pair(path)
    tombstones = []
    for retention in (0, 4, 10):  # tails delete at timestamps 4, 5 and 6
        ref = jrk.replay_columns(jc, min_retention_ts=retention, device=True)
        got = trk.replay_columns(tc, min_retention_ts=retention, device="cpu")
        assert np.array_equal(got.alive, ref.alive)
        assert np.array_equal(got.tombstone, ref.tombstone)
        assert int(got.stats.num_files) == int(ref.stats.num_files)
        assert int(got.stats.total_size) == int(ref.stats.total_size)
        assert int(got.stats.num_tombstones) == int(ref.stats.num_tombstones)
        tombstones.append(int(got.stats.num_tombstones))
    assert tombstones[0] > tombstones[1] > tombstones[2] == 0


# -- the cases of tests/test_columnar.py ----------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 7])
def test_random_logs_decode_like_jax(tmp_path, seed):
    """Random logs of tests/test_columnar.py: unicode paths, "./"
    canonicalization, partition values, tags, metadata/protocol/txn
    evolution, commitInfo noise (with '"txn"' inside strings) and stray empty
    lines decode to the same columns, state and materialized files."""
    import random

    from tests.test_columnar import _write_log

    log_path, store, _ = _write_log(tmp_path, random.Random(seed), 30, n_paths=40)
    deltas = [f"{log_path}/{filenames.delta_file(v)}" for v in range(30)]
    jc = jax_decode(store, [], deltas)
    tc = torch_decode(LocalLogStore(), [], deltas)
    assert tc.path_dict == jc.path_dict.to_pylist()
    for name in ("path_id", "is_add", "size", "modification_time", "deletion_timestamp"):
        assert np.array_equal(getattr(tc, name), getattr(jc, name)), name
    assert tc.stats == jc.stats.to_pylist()
    assert [a.json() for a in tc.other_actions] == [a.json() for a in jc.other_actions]
    for cutoff in (0, 3000, 100_000):
        ja, jt = jc.replay(min_retention_ts=cutoff)
        ta, tt = tc.replay(min_retention_ts=cutoff)
        assert np.array_equal(ta, ja) and np.array_equal(tt, jt), cutoff
    assert ([a.json() for a in tc.materialize(ta)] == [a.json() for a in jc.materialize(ja)])
    assert ([a.json() for a in tc.materialize(tt)] == [a.json() for a in jc.materialize(jt)])
    rows = np.nonzero(ta)[0]
    assert tc.partition_strings(rows, ["p"])["p"] == (
        jc.partition_strings(rows, ["p"])["p"].to_pylist())


# -- K5: replay_alive_mask (the cases of tests/test_ops.py) ---------------------


def _k5_pair(versioned):
    from delta_tpu.ops import state_export as jexport
    from delta_tpu_torch.ops import state_export as texport
    from delta_tpu_torch.protocol.actions import action_from_json

    jarr = jexport.actions_to_arrays(versioned)
    tarr = texport.actions_to_arrays(
        [(v, [action_from_json(a.json()) for a in acts]) for v, acts in versioned])
    assert tarr.paths == jarr.paths
    for name in ("path_id", "seq", "is_add", "size", "deletion_timestamp"):
        assert np.array_equal(getattr(tarr, name), getattr(jarr, name)), name
    return jarr, tarr


def _assert_replay_equal(jarr, tarr, retention):
    ref = jrk.replay_alive_mask(jarr, min_retention_ts=retention)
    got = trk.replay_alive_mask(tarr, min_retention_ts=retention, device="cpu")
    assert np.array_equal(got.alive, np.asarray(ref.alive))
    assert np.array_equal(got.tombstone, np.asarray(ref.tombstone))
    assert int(got.stats.num_files) == int(ref.stats.num_files)
    assert int(got.stats.total_size) == int(ref.stats.total_size)
    assert int(got.stats.num_tombstones) == int(ref.stats.num_tombstones)
    return got


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 5])
def test_replay_alive_mask_matches_jax(seed):
    """tests/test_ops.py's random streams (adds and removes of 25 paths over
    40 commits), at retention cutoffs on both sides of the removes."""
    from tests.test_ops import _random_stream

    jarr, tarr = _k5_pair(_random_stream(seed))
    for retention in (0, 10_000, 25_000, 10**9):
        _assert_replay_equal(jarr, tarr, retention)


def test_replay_alive_mask_tombstone_retention():
    from delta_tpu.protocol.actions import AddFile, RemoveFile

    versioned = [
        (0, [AddFile(path="a", partition_values={}, size=1, modification_time=0,
                     data_change=True)]),
        (1, [RemoveFile(path="a", deletion_timestamp=500, data_change=True)]),
        (2, [AddFile(path="b", partition_values={}, size=2, modification_time=0,
                     data_change=True)]),
    ]
    jarr, tarr = _k5_pair(versioned)
    assert int(_assert_replay_equal(jarr, tarr, 100).stats.num_tombstones) == 1
    assert int(_assert_replay_equal(jarr, tarr, 1000).stats.num_tombstones) == 0


@pytest.mark.parametrize("n", [1, 7, 8, 9, 1000, 4097])
def test_replay_alive_mask_pads_and_wraps_like_jax(n):
    """Streams padded to a power of two, re-added paths, removes on both
    sides of the cutoff, and sizes whose int64 sum wraps."""
    from delta_tpu.ops.state_export import ReplayArrays as JaxArrays
    from delta_tpu_torch.ops.state_export import ReplayArrays as TorchArrays

    rng = np.random.RandomState(n)
    num_paths = max(n // 3, 1)
    cols = dict(paths=[f"p{i}" for i in range(num_paths)],
                path_id=rng.randint(0, num_paths, n).astype(np.int32),
                seq=rng.permutation(n).astype(np.int64) * 3 + 11,
                is_add=rng.rand(n) > 0.35,
                size=rng.randint(2**60, 2**62, n).astype(np.int64),
                deletion_timestamp=rng.randint(0, 1000, n).astype(np.int64))
    jarr, tarr = JaxArrays(**cols), TorchArrays(**cols)
    for retention in (0, 500):
        _assert_replay_equal(jarr, tarr, retention)


def test_replay_rejects_out_of_range_ids():
    pid = torch.tensor([0, 1, 2, 3, 4, 5, 6, 7], dtype=torch.int32)
    z = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(ValueError):
        trk.replay(pid, z, torch.ones(8, dtype=torch.bool), z, z, 7)
    with pytest.raises(TypeError):
        trk.replay(pid.long(), z, torch.ones(8, dtype=torch.bool), z, z, 8)

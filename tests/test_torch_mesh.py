"""The port's state mesh (``delta_tpu_torch.parallel.mesh``), its sharded
replay (K6) and sharded join probe (K13), the host partitioner and the
multichip run, held against ``delta_tpu`` on the CPU.

The JAX package runs its ``shard_map`` kernels on the 8-device CPU mesh
that ``tests/conftest.py`` forces; the port runs on an 8-entry ``cpu`` mesh
(``mesh.using_devices``), where every wrapper takes its kernel's plain
version. Tolerance everywhere: exact equality (masks, counts, sums, packed
bits, row indices and assignments are integer results of the same
definitions).
"""
import jax
import numpy as np
import pytest
import torch

from delta_tpu.ops import join_kernel as jax_jk
from delta_tpu.ops import replay_kernel as jrk
from delta_tpu.ops.state_export import ReplayArrays as JaxArrays
from delta_tpu.parallel import distributed as jax_dist
from delta_tpu.parallel import mesh as jax_mesh
from delta_tpu.utils.jaxcompat import enable_x64
from delta_tpu_torch.ops import join_kernel as jk
from delta_tpu_torch.ops import native
from delta_tpu_torch.ops import replay_kernel as trk
from delta_tpu_torch.ops.state_export import ReplayArrays as TorchArrays
from delta_tpu_torch.parallel import distributed, mesh
from tests.torch_kernel_cases import COMBINE_KS, combine_case, combine_rows, reference_combine

CPU8 = ["cpu"] * 8


@pytest.fixture
def cpu_mesh():
    with mesh.using_devices(CPU8) as m:
        yield m


def _jax_mesh():
    m = jax_mesh.state_mesh()
    assert jax_mesh.shard_count(m) == 8  # tests/conftest.py's forced host devices
    return m


# -- the mesh ------------------------------------------------------------------------


def test_default_mesh_and_using_devices():
    cpu = torch.device("cpu")
    assert mesh.default_devices("cpu") == [cpu]
    assert mesh.state_mesh(device="cpu") == [cpu]
    with mesh.using_devices(CPU8) as m:
        assert m == [cpu] * 8 and mesh.default_devices("cpu") == m
        assert mesh.shard_count(mesh.state_mesh(device="cpu")) == 8
        assert mesh.state_mesh(4, device="cpu") == [cpu] * 4
        with mesh.using_devices(["cpu"]):
            assert mesh.default_devices("cpu") == [cpu]
        assert len(mesh.default_devices("cpu")) == 8
    assert mesh.default_devices("cpu") == [cpu]
    with pytest.raises(ValueError):
        with mesh.using_devices([]):
            pass
    assert mesh.STATE_AXIS == jax_mesh.STATE_AXIS


@pytest.mark.parametrize("n,m", [(0, 8), (1, 8), (8, 8), (9, 8), (1000, 7), (5, 1)])
def test_pad_to_multiple_matches_jax(n, m):
    assert mesh.pad_to_multiple(n, m) == jax_mesh.pad_to_multiple(n, m)


def test_all_gather_keeps_shard_order():
    parts = [torch.arange(i * 10, i * 10 + 4) for i in range(5)]
    got = mesh.all_gather(parts, torch.device("cpu"))
    assert got.tolist() == [v for p in parts for v in p.tolist()]
    cols = [torch.full((3, 2), i, dtype=torch.uint8) for i in range(4)]
    got = mesh.all_gather(cols, torch.device("cpu"), axis=1)
    assert got.shape == (3, 8) and got[0].tolist() == [0, 0, 1, 1, 2, 2, 3, 3]


@pytest.mark.parametrize("n,k", [(1, 1), (8, 13), (3, 64), (8, 1 << 12)])
def test_shard_combine_plain_matches_numpy(n, k):
    rng = np.random.RandomState(n * k)
    rows = rng.randint(-2**62, 2**62, (n, k)).astype(np.int64)
    got = mesh.shard_combine(torch.from_numpy(rows), "sum")
    assert np.array_equal(got.numpy(), rows.sum(axis=0))  # wraps like int64
    flags = (rng.rand(n, k) < 0.1).astype(np.uint8) * rng.randint(1, 255, (n, k)).astype(
        np.uint8)
    assert np.array_equal(mesh.shard_combine(torch.from_numpy(flags), "or").numpy(),
                          np.bitwise_or.reduce(flags, axis=0))
    # the OR of packed rows is the packing of the OR (K13's source hits)
    packed = np.packbits(flags != 0, axis=1)
    assert np.array_equal(mesh.shard_combine(torch.from_numpy(packed), "or").numpy(),
                          np.packbits(flags.any(axis=0)))
    # psum gathers per-shard parts first
    parts = [torch.from_numpy(r) for r in rows]
    assert np.array_equal(mesh.psum(parts, "sum").numpy(), rows.sum(axis=0))


def test_shard_combine_refuses_bad_inputs():
    with pytest.raises(ValueError):
        mesh.shard_combine(torch.zeros((2, 3), dtype=torch.int64), "max")
    with pytest.raises(TypeError):
        mesh.shard_combine(torch.zeros((2, 3), dtype=torch.int32), "sum")
    with pytest.raises(TypeError):
        mesh.shard_combine(torch.zeros(3, dtype=torch.uint8), "or")
    with pytest.raises(TypeError):
        mesh.shard_combine(torch.zeros((0, 3), dtype=torch.uint8), "or")
    with pytest.raises(ValueError):  # the hits come packed: no packing op
        mesh.shard_combine(torch.zeros((2, 3), dtype=torch.uint8), "or_pack")


@pytest.mark.parametrize("n,k", [(1, 1), (3, 17), (8, 13), (33, 1 << 12)])
def test_psum_many_matches_single_psums_and_numpy(n, k, cpu_mesh):
    """The batched psum's plain version: one gather a pair, both ops
    together, equal to each op's own psum and to numpy."""
    pairs, want = [], []
    for op in ("sum", "or"):
        rows = combine_rows(combine_case(op, n, k, 0, seed=3), n, k)
        pairs.append(([torch.from_numpy(r) for r in rows], op))
        want.append(reference_combine(rows, op))
    got = mesh.psum_many(pairs)
    for g, w, (parts, op) in zip(got, want, pairs):
        assert np.array_equal(g.numpy(), w)
        assert torch.equal(g, mesh.psum(parts, op))


@pytest.mark.parametrize("k", COMBINE_KS)
@pytest.mark.parametrize("offset", [0, 3])
def test_shard_combine_many_on_row_slices(k, offset):
    """A launch's two sets, contiguous rows at an offset into a larger
    buffer: each equal to numpy and to the single call."""
    sets, want = [], []
    for i, op in enumerate(("sum", "or")):
        buf = combine_case(op, 3, k, offset, seed=i)
        sets.append((combine_rows(torch.from_numpy(buf), 3, k, offset), op))
        want.append(reference_combine(combine_rows(buf, 3, k, offset), op))
    got = mesh.shard_combine_many(sets)
    assert len(got) == 2
    for g, w, (x, op) in zip(got, want, sets):
        assert np.array_equal(g.numpy(), w)
        assert torch.equal(g, mesh.shard_combine(x, op))


def test_shard_combine_many_refuses_mixed_devices_and_bad_rows():
    with pytest.raises(ValueError):
        mesh.shard_combine_many([(torch.zeros((2, 3), dtype=torch.int64), "sum"),
                                 (torch.zeros((2, 3), dtype=torch.uint8, device="meta"), "or")])
    with pytest.raises(TypeError):
        mesh.shard_combine_many([(torch.zeros((2, 3), dtype=torch.int64), "or")])
    with pytest.raises(ValueError):
        mesh.psum_many([([torch.zeros(3, dtype=torch.int64)], "sum"),
                        ([torch.zeros(3, dtype=torch.uint8, device="meta")], "or")])
    with pytest.raises(ValueError):  # one launch takes two sets
        mesh.shard_combine_many([(torch.zeros((2, 3), dtype=torch.int64), "sum")] * 3)
    with pytest.raises(ValueError):  # a slice of wider rows
        mesh.shard_combine_many([(torch.zeros((2, 8), dtype=torch.uint8)[:, 2:5], "or")])


@pytest.mark.parametrize("case,dtype", [("link", np.int32), ("zipf", np.int32),
                                        ("runs_across_shards", np.int64)])
def test_psum_many_reduces_like_jax_sharded_join(case, dtype):
    """Each shard's packed source hits and multi flag, reduced by one
    psum_many (bytewise ORs), equal to the psums inside JAX's
    `_sharded_kernel` on its 8-device CPU mesh."""
    t_in, s_in = _sharded_inputs(case, dtype)
    with enable_x64():
        kernel = jax_jk._sharded_kernel(jax, _jax_mesh(), jax_mesh.STATE_AXIS)
        want = [np.asarray(x) for x in kernel(t_in.reshape(8, -1), s_in.reshape(8, -1))]
    s_full = torch.from_numpy(s_in)
    s_sorted = torch.sort(s_full).values
    hits, multis = [], []
    for t in torch.from_numpy(t_in).reshape(8, -1):
        hits.append(torch.from_numpy(np.packbits(torch.isin(s_full, t).numpy())))
        count = (torch.searchsorted(s_sorted, t, right=True)
                 - torch.searchsorted(s_sorted, t))
        multis.append((count > 1).any().reshape(1).to(torch.uint8))
    s_bits, multi = mesh.psum_many([(hits, "or"), (multis, "or")])
    assert np.array_equal(s_bits.numpy(), want[1])
    assert bool(multi[0]) == bool(want[2])


@pytest.mark.parametrize("shards", [1, 8])
def test_psum_many_of_shard_sums_matches_jax_replay(shards):
    """Each shard's replay sums (files, bytes, tombstones) reduced by
    psum_many on the 8-entry CPU mesh, against JAX's sharded replay."""
    jarr, tarr = _zipf_pair(20_000, 500, 17)
    with mesh.using_devices(["cpu"] * shards):
        stacked, _, _ = trk._bucket_by_path(tarr, shards)
        slabs = [tuple(torch.from_numpy(np.ascontiguousarray(c[i])) for c in stacked)
                 for i in range(shards)]
        best = trk._best_plain(torch.cat([c[0] for c in slabs]), torch.cat([c[1] for c in slabs]),
                               len(tarr.paths))
        parts = [trk._masks_plain(c, best, 100)[2] for c in slabs]
        (sums,) = mesh.psum_many([(parts, "sum")])
    with enable_x64():
        want = jrk.replay_sharded(jarr, _jax_mesh(), min_retention_ts=100)
    assert sums.tolist() == [int(want.stats.num_files), int(want.stats.total_size),
                             int(want.stats.num_tombstones)]


# -- K6: the sharded replay ------------------------------------------------------------


def _pair_from_versioned(versioned):
    from delta_tpu.ops import state_export as jexport
    from delta_tpu_torch.ops import state_export as texport
    from delta_tpu_torch.protocol.actions import action_from_json

    jarr = jexport.actions_to_arrays(versioned)
    tarr = texport.actions_to_arrays(
        [(v, [action_from_json(a.json()) for a in acts]) for v, acts in versioned])
    assert tarr.paths == jarr.paths
    return jarr, tarr


def _million_stream():
    """tests/test_ops.py:296's stream: 1M actions over 120,000 paths."""
    n, n_paths = 1_000_000, 120_000
    rng = np.random.RandomState(13)
    path_id = rng.randint(0, n_paths, n).astype(np.int32)
    version = np.sort(rng.randint(0, 50_000, n).astype(np.int64))
    pos = np.arange(n, dtype=np.int64) % (1 << 20)
    is_add = rng.rand(n) < 0.8
    cols = dict(paths=[], path_id=path_id, seq=(version << 31) | pos, is_add=is_add,
                size=rng.randint(1, 1 << 20, n).astype(np.int64),
                deletion_timestamp=np.where(is_add, 0, 1 + version).astype(np.int64))
    return JaxArrays(**cols), TorchArrays(**cols)


def _zipf_pair(n_actions, n_paths, seed):
    """__graft_entry__.py's skew-stage stream, built in both packages."""
    from delta_tpu.protocol.actions import AddFile, RemoveFile
    from delta_tpu_torch.multichip import zipf_stream

    zrng = np.random.RandomState(seed)
    probs = 1.0 / np.arange(1, n_paths + 1, dtype=np.float64)
    probs /= probs.sum()
    pids = zrng.choice(n_paths, n_actions, p=probs)
    adds = zrng.rand(n_actions) < 0.7
    versioned = []
    for v in range(0, n_actions, 1000):
        acts = []
        for i in range(v, min(v + 1000, n_actions)):
            p = f"part-{pids[i]:06d}.parquet"
            acts.append(AddFile(path=p, partition_values={}, size=int(i % 977 + 1),
                                modification_time=v, data_change=True) if adds[i]
                        else RemoveFile(path=p, deletion_timestamp=v + 1, data_change=True))
        versioned.append((v // 1000, acts))
    jarr, tarr = _pair_from_versioned(versioned)
    mine = zipf_stream(n_actions, n_paths, seed)
    for name in ("path_id", "seq", "is_add", "size", "deletion_timestamp"):
        assert np.array_equal(getattr(mine, name), getattr(tarr, name)), name
    return jarr, tarr


def _stream_case(name):
    from tests.test_ops import _random_stream

    if name.startswith("seed"):
        return _pair_from_versioned(_random_stream(int(name[4:]), n_versions=60, n_paths=50))
    if name == "1m":
        return _million_stream()
    if name == "zipf-100k":
        return _zipf_pair(100_000, 1_000, 11 + 1_000)
    if name == "empty-shards":
        return _zipf_pair(512, 2, 11 + 2)
    raise KeyError(name)


STREAMS = ["seed0", "seed5", "1m", "zipf-100k", "empty-shards"]


@pytest.mark.parametrize("case", STREAMS)
def test_mix64_and_bucket_by_path_match_jax(case):
    jarr, tarr = _stream_case(case)
    assert np.array_equal(trk._mix64(tarr.path_id), jrk._mix64(jarr.path_id))
    assert trk._mix64(tarr.path_id).dtype == np.uint64
    for shards in (1, 3, 8):
        (jcols, jorder, jdest), (tcols, torder, tdest) = (
            jrk._bucket_by_path(jarr, shards), trk._bucket_by_path(tarr, shards))
        assert np.array_equal(torder, jorder) and np.array_equal(tdest, jdest)
        for a, b in zip(tcols, jcols):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("case", STREAMS)
def test_replay_sharded_matches_jax(case, cpu_mesh):
    jarr, tarr = _stream_case(case)
    with enable_x64():
        ref = jrk.replay_sharded(jarr, _jax_mesh(), min_retention_ts=0)
    got = trk.replay_sharded(tarr, mesh.state_mesh(device="cpu"), min_retention_ts=0)
    assert np.array_equal(got.alive, np.asarray(ref.alive))
    assert np.array_equal(got.tombstone, np.asarray(ref.tombstone))
    for f in ("num_files", "total_size", "num_tombstones"):
        assert int(getattr(got.stats, f)) == int(getattr(ref.stats, f)), f
    # and equal to one card's replay (K5) of the same stream
    one = trk.replay_alive_mask(tarr, device="cpu") if tarr.paths else None
    if one is not None:
        assert np.array_equal(one.alive, got.alive) and one.stats == got.stats


@pytest.mark.parametrize("retention", [0, 10_000, 10**9])
def test_replay_sharded_retention_matches_jax(retention, cpu_mesh):
    jarr, tarr = _stream_case("seed5")
    with enable_x64():
        ref = jrk.replay_sharded(jarr, _jax_mesh(), min_retention_ts=retention)
    got = trk.replay_sharded(tarr, mesh.state_mesh(device="cpu"), min_retention_ts=retention)
    assert np.array_equal(got.tombstone, np.asarray(ref.tombstone))
    assert int(got.stats.num_tombstones) == int(ref.stats.num_tombstones)


def test_sharded_replay_plain_equals_k5_per_shard():
    """K6's plain version over stacked slabs is K5's plain version shard by
    shard, the sums added; an all-pad (empty) shard adds zeros."""
    _, tarr = _stream_case("empty-shards")
    stacked, _, _ = trk._bucket_by_path(tarr, 8)
    slabs = [tuple(torch.from_numpy(np.ascontiguousarray(c[i])) for c in stacked)
             for i in range(8)]
    assert any(int((s[0] >= 0).sum()) == 0 for s in slabs)  # an empty shard
    before = native.launches["sharded_replay"]
    alive, tomb, sums = trk.sharded_replay(slabs, len(tarr.paths), 0)
    assert native.launches["sharded_replay"] == before  # plain versions count nothing
    total = torch.zeros(3, dtype=torch.int64)
    for i, s in enumerate(slabs):
        a, t, su = trk.replay(*s, len(tarr.paths), 0)
        assert torch.equal(a, alive[i]) and torch.equal(t, tomb[i])
        total += su
    assert torch.equal(total, sums)


@pytest.mark.parametrize("shards", [2, 4, 8])
@pytest.mark.parametrize("stream", ["all-pad-shard", "hot-path", "seq-extremes", "no-paths",
                                    "wrapping-sizes"])
def test_device_grouped_k6_matches_jax_and_k5(stream, shards):
    """K6's plain version as the kernel runs it (one winner table for all the
    shards of a device: here every shard is on the one CPU) against
    ``delta_tpu``'s ``replay_sharded`` on a mesh of as many CPU devices, and
    against one device's replay (K5), on the edge streams of
    tests/torch_replay_streams.py."""
    from tests.torch_replay_streams import replay_stream

    cols = replay_stream(stream, shards)
    jarr, tarr = JaxArrays(**cols), TorchArrays(**cols)
    with enable_x64():
        ref = jrk.replay_sharded(jarr, jax_mesh.state_mesh(shards), min_retention_ts=1000)
    with mesh.using_devices(CPU8[:shards]) as m:
        got = trk.replay_sharded(tarr, m, min_retention_ts=1000)
    one = trk.replay_alive_mask(tarr, min_retention_ts=1000, device="cpu")
    for res in (got, one):
        assert np.array_equal(res.alive, np.asarray(ref.alive))
        assert np.array_equal(res.tombstone, np.asarray(ref.tombstone))
        for f in ("num_files", "total_size", "num_tombstones"):
            assert int(getattr(res.stats, f)) == int(getattr(ref.stats, f)), f
    # the grouped plain version is the per-shard one (each path on one shard)
    stacked, _, _ = trk._bucket_by_path(tarr, shards)
    slabs = [tuple(torch.from_numpy(np.ascontiguousarray(c[i])) for c in stacked)
             for i in range(shards)]
    alive, tomb, sums = trk.sharded_replay_plain(slabs, len(tarr.paths), 1000)
    per = [trk.replay_plain(*s, len(tarr.paths), 1000) for s in slabs]
    assert all(torch.equal(a, p[0]) and torch.equal(t, p[1]) for a, t, p in zip(alive, tomb, per))
    assert torch.equal(sums, torch.stack([p[2] for p in per]).sum(dim=0))


def test_sharded_replay_refuses_bad_inputs():
    pid = torch.tensor([0, 1, 2, 3, 4, 5, 6, 7], dtype=torch.int32)
    z = torch.zeros(8, dtype=torch.int64)
    add = torch.ones(8, dtype=torch.bool)
    with pytest.raises(ValueError):
        trk.sharded_replay([(pid, z, add, z, z)], 7, 0)
    with pytest.raises(TypeError):
        trk.sharded_replay([(pid.long(), z, add, z, z)], 8, 0)
    with pytest.raises(ValueError):
        trk.sharded_replay([], 8, 0)
    with pytest.raises(ValueError):  # a bad id on a later shard
        trk.sharded_replay([(pid[:4], z[:4], add[:4], z[:4], z[:4]),
                            (pid[4:], z[4:], add[4:], z[4:], z[4:])], 7, 0)


# -- K13: the sharded join probe -----------------------------------------------------


def _join_cases():
    from tests.test_torch_join_kernel import CASES

    out = {k: v for k, v in CASES.items()}

    def zipf():
        cap = 1 << 16
        rng = np.random.RandomState(1)
        probs = 1.0 / np.arange(1, cap * 2 + 1, dtype=np.float64)
        probs /= probs.sum()
        s = rng.choice(cap * 2, cap // 8, p=probs).astype(np.int64)
        s[0] = s[-1] = 5
        return np.arange(cap, dtype=np.int64), np.ones(cap, bool), s, np.ones(len(s), bool)

    def runs_across_shards():
        """Source runs of one key that straddle the pieces' boundaries (8
        pieces of 8 rows at 64 rows), and target duplicates across slabs."""
        s = np.repeat(np.arange(8, dtype=np.int64) * 3, 8)  # 64 rows
        s = np.roll(s, 4)  # each run now crosses a piece boundary
        t = np.concatenate([np.arange(0, 30, dtype=np.int64), np.full(20, 9, np.int64)])
        return t, np.ones(len(t), bool), s, np.ones(len(s), bool)

    out["zipf"] = zipf
    out["runs_across_shards"] = runs_across_shards
    return out


JOIN_CASES = _join_cases()


def _same(a, b):
    assert np.array_equal(a.t_first_s, b.t_first_s)
    assert np.array_equal(a.s_matched, b.s_matched)
    assert a.any_multi == b.any_multi


@pytest.mark.parametrize("case", sorted(JOIN_CASES))
def test_inner_join_on_mesh_matches_jax(case, cpu_mesh, monkeypatch):
    t, t_ok, s, s_ok = JOIN_CASES[case]()
    calls = {"k12": 0, "k13": 0}
    k12, k13 = jk.join_probe, jk.sharded_join_probe

    def count(key, fn):
        def wrapped(*a):
            calls[key] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(jk, "join_probe", count("k12", k12))
    monkeypatch.setattr(jk, "sharded_join_probe", count("k13", k13))
    got = jk.inner_join(t, t_ok, s, s_ok, mesh=mesh.state_mesh(device="cpu"), device="cpu")
    with enable_x64():
        want = jax_jk.inner_join(t, t_ok, s, s_ok, mesh=_jax_mesh())
    _same(got, want)
    _same(got, jk.inner_join(t, t_ok, s, s_ok, device="cpu"))  # one card, K12
    if case != "no_room":  # no sentinel room: the host join, both packages
        assert calls == {"k12": 1, "k13": 1}


def _sharded_inputs(case, dtype, p=8):
    """The padded, split kernel inputs inner_join_async builds over p shards."""
    t, t_ok, s, s_ok = JOIN_CASES[case]()
    t_enc, s_enc, t_fill, s_fill = jax_jk._sentinel_encode(
        np.where(t_ok, t, 0).astype(dtype), t_ok, np.where(s_ok, s, 0).astype(dtype), s_ok,
        dtype)
    cap_t = jax_jk._bucket((len(t) + p - 1) // p) * p
    cap_s = jax_jk._bucket((len(s) + p - 1) // p) * p
    return jax_jk._pad(t_enc, cap_t, t_fill), jax_jk._pad(s_enc, cap_s, s_fill)


@pytest.mark.parametrize("case,dtype", [("link", np.int32), ("nulls", np.int64),
                                        ("wide", np.int64), ("runs_across_shards", np.int32),
                                        ("zipf", np.int32)])
def test_sharded_join_probe_matches_sharded_kernel(case, dtype):
    """K13's plain version and its wrapper against JAX's `_sharded_kernel`
    on the same padded inputs, and against K12 on the whole lanes."""
    t_in, s_in = _sharded_inputs(case, dtype)
    with enable_x64():
        kernel = jax_jk._sharded_kernel(jax, _jax_mesh(), jax_mesh.STATE_AXIS)
        want = [np.asarray(x) for x in kernel(t_in.reshape(8, -1), s_in.reshape(8, -1))]
    t_slabs = list(torch.from_numpy(t_in).reshape(8, -1))
    s_parts = list(torch.from_numpy(s_in).reshape(8, -1))
    got = jk.sharded_join_probe(t_slabs, s_parts)
    assert np.array_equal(got[0].numpy(), want[0].reshape(-1))
    assert np.array_equal(got[1].numpy(), want[1])
    assert bool(got[2][0]) == bool(want[2])
    k12 = jk.join_probe(torch.from_numpy(t_in), torch.from_numpy(s_in))
    assert all(torch.equal(a, b) for a, b in zip(got, k12))


def test_sharded_join_probe_refuses_bad_inputs():
    t = [torch.zeros(8, dtype=torch.int32)] * 2
    with pytest.raises(ValueError):
        jk.sharded_join_probe(t, [torch.zeros(8, dtype=torch.int32)])
    with pytest.raises(TypeError):
        jk.sharded_join_probe(t, [torch.zeros(8, dtype=torch.int64)] * 2)
    with pytest.raises(ValueError):
        jk.sharded_join_probe([torch.zeros(12, dtype=torch.int32)] * 2,
                              [torch.zeros(8, dtype=torch.int32)] * 2)


def test_one_entry_mesh_takes_k12(monkeypatch):
    """A mesh of one entry runs the single-card kernel, as the JAX package
    does (join_kernel.py:309)."""
    called = []
    monkeypatch.setattr(jk, "sharded_join_probe", lambda *a: called.append(a))
    t, t_ok, s, s_ok = JOIN_CASES["link"]()
    got = jk.inner_join(t, t_ok, s, s_ok, mesh=[torch.device("cpu")], device="cpu")
    _same(got, jk.inner_join(t, t_ok, s, s_ok, device="cpu"))
    assert called == []


# -- the host partitioner ----------------------------------------------------------------


LPT_CASES = [([5, 3, 3, 2, 2, 1, 1, 1], 3), ([5, 3, 3, 2, 2, 1, 1, 1], 1), ([], 4),
             ([0, None, 7, 7, 7], 2), ([1_000_000 // (i + 1) + 1 for i in range(10_000)], 8)]


@pytest.mark.parametrize("sizes,count", LPT_CASES)
def test_lpt_assign_matches_jax(sizes, count):
    got = distributed.lpt_assign(sizes, count)
    assert got == jax_dist.lpt_assign(sizes, count)
    assert distributed.lpt_loads(sizes, got) == jax_dist.lpt_loads(sizes, got)
    assert distributed.bytes_skew(sizes, got) == jax_dist.bytes_skew(sizes, got)


@pytest.mark.parametrize("n,index,count,sized", [(10, 1, 3, False), (10, 0, 1, False),
                                                 (35, 1, 2, False), (100, 3, 8, True),
                                                 (7, 0, 2, True)])
def test_host_shard_indices_match_jax(n, index, count, sized):
    sizes = [1_000 // (i + 1) + 1 for i in range(n)] if sized else None
    got = distributed.host_shard_indices(n, index, count, sizes=sizes)
    assert got == jax_dist.host_shard_indices(n, index, count, sizes=sizes)
    items = [f"f{i}" for i in range(n)]
    assert distributed.host_partition(items, index, count, sizes=sizes) == \
        jax_dist.host_partition(items, index, count, sizes=sizes)


def test_host_partition_refusals_and_one_process():
    assert distributed.host_shard_indices(10, 1, 3) == [1, 4, 7]
    with pytest.raises(ValueError):
        distributed.host_shard_indices(10, 0, 2, sizes=[1, 2, 3])
    with pytest.raises(ValueError):
        distributed.host_shard_indices(10, 0)
    assert distributed.process_info() == (0, 1)
    assert distributed.host_shard_indices(5) == [0, 1, 2, 3, 4]
    assert distributed.initialize() == (0, 1)
    with pytest.raises(NotImplementedError):
        distributed.initialize("localhost:1234", 2, 0)


# -- the multichip run ------------------------------------------------------------------


def test_dryrun_multichip_on_cpu_mesh_matches_jax_stages(cpu_mesh):
    """The port's dryrun_multichip(8) on the 8-entry CPU mesh passes its
    stages, and each stage's result equals the JAX function it mirrors on
    the JAX package's 8-device mesh."""
    import __graft_entry__ as graft
    from delta_tpu.ops.state_cache import ResidentState as JaxResident
    from delta_tpu.ops.state_cache import extract_ranges as jax_extract
    from delta_tpu.ops import pruning as jax_pruning
    from delta_tpu.expr.parser import parse_expression as jax_parse
    from delta_tpu_torch.multichip import _zipf_source, dryrun_multichip, example_stream

    report = dryrun_multichip(8, device="cpu")
    assert report["plan_shards"] == 8 and report["n_devices"] == 8
    # stage 1: the example stream and its sharded replay
    jarr = graft._example_stream(n_paths=64, n_versions=10, per_commit=16)
    tarr = example_stream(n_paths=64, n_versions=10, per_commit=16)
    for name in ("path_id", "seq", "is_add", "size", "deletion_timestamp"):
        assert np.array_equal(getattr(tarr, name), getattr(jarr, name)), name
    with enable_x64():
        ref = jrk.replay_sharded(jarr, _jax_mesh())
    assert report["n_alive"] == int(ref.stats.num_files)
    assert report["n_actions"] == jarr.num_rows
    # stage 2: the kept count of size > 1000 over the live files
    assert report["kept"] == int((np.asarray(jarr.size)[np.asarray(ref.alive)] > 1000).sum())
    # stage 3: the zipf join through JAX's sharded kernel
    cap = 1 << 20
    t_keys, s_keys = np.arange(cap, dtype=np.int64), _zipf_source(cap, 8)
    with enable_x64():
        want = jax_jk.inner_join(t_keys, np.ones(cap, bool), s_keys, np.ones(len(s_keys), bool),
                                 mesh=_jax_mesh())
    assert report["join_matched"] == int(want.t_matched.sum()) and want.any_multi
    # stage 4: the host partition
    assert report["host_partition"] == {h: len(jax_dist.host_shard_indices(35, h, 2))
                                        for h in range(2)}
    # stage 6: the JAX package's sharded plan on the same lanes is the host's
    prng = np.random.RandomState(6)
    plo = prng.rand(2, 6000) * 1000.0
    phi = plo + prng.rand(2, 6000) * 50.0
    js = JaxResident("multichip://plan", "mid", 0, ["a", "b"], [f"f{i}" for i in range(6000)],
                     {"min": plo, "max": phi, "size": np.ones(6000, np.int64)})
    from delta_tpu.utils.config import conf as jconf

    q = [jax_extract(jax_pruning.skipping_predicate(jax_parse("a >= 37 AND a <= 77"),
                                                    frozenset()), ["a", "b"])]
    with jconf.set_temporarily(**{"delta.tpu.distributed.plan.mode": "force",
                                  "delta.tpu.stateCache.devicePlan.mode": "force"}):
        plans = js.plan_ranges(q, k=6000, use_device=True)
    assert js.resident_shards == 8 and plans[0].via == "device-sharded"

"""The port's resident scan state (``delta_tpu_torch.ops.state_cache``) held
against ``delta_tpu.ops.state_cache`` on the CPU.

Tolerance everywhere: exact equality. Packed block bits, scattered lanes,
plan rows and f32 lanes are produced by the same arithmetic (the same
outward rounding, the same comparisons), so nothing may differ by a bit;
NaN lanes compare equal through their bit patterns.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from delta_tpu.log.deltalog import DeltaLog as JaxDeltaLog
from delta_tpu.ops import state_cache as jsc
from delta_tpu_torch import DeltaLog as TorchDeltaLog
from delta_tpu_torch.ops import state_cache as tsc
from tests.torch_port_tables import commit, write_ops_table, write_table, write_tail


@pytest.fixture(autouse=True)
def _fresh_caches():
    jsc.DeviceStateCache.reset()
    tsc.DeviceStateCache.reset()
    TorchDeltaLog.clear_cache()
    yield
    jsc.DeviceStateCache.reset()
    tsc.DeviceStateCache.reset()
    TorchDeltaLog.clear_cache()


def _bits_equal(a: np.ndarray, b: np.ndarray) -> bool:
    """Exact equality of float arrays, NaN included (bit patterns)."""
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    view = np.uint32 if a.dtype == np.float32 else np.uint64
    return np.array_equal(a.view(view), b.view(view))


def _lanes(rng, c, cap, n_live):
    mins = (rng.rand(c, cap) * 100).astype(np.float32)
    maxs = mins + (rng.rand(c, cap) * 3).astype(np.float32)
    mins[:, rng.rand(cap) < 0.05] = np.nan  # missing stats on the file side
    maxs[:, rng.rand(cap) < 0.05] = np.nan
    alive = np.zeros(cap, bool)
    alive[:n_live] = rng.rand(n_live) > 0.2  # dead rows, and pads past n_live
    return mins, maxs, alive


def _bounds(rng, m, m_pad, c):
    lo = np.full((m_pad, c), np.nan, np.float32)  # pad rows: NaN = no bound
    hi = np.full((m_pad, c), np.nan, np.float32)
    lo[:m] = (rng.rand(m, c) * 100).astype(np.float32)
    hi[:m] = lo[:m] + (rng.rand(m, c) * 0.5).astype(np.float32)
    lo[:m][rng.rand(m, c) < 0.2] = np.nan  # unbounded sides
    hi[:m][rng.rand(m, c) < 0.2] = np.nan
    return lo, hi


# -- K1: the block cull ------------------------------------------------------


@pytest.mark.parametrize("m,m_pad", [(1, 1), (8, 8), (37, 64)])
@pytest.mark.parametrize("cap", [1024, 8192])
@pytest.mark.parametrize("c", [1, 4, 5])
def test_block_cull_plain_matches_jax(c, cap, m, m_pad):
    rng = np.random.RandomState(c * 1000 + cap + m)
    mins, maxs, alive = _lanes(rng, c, cap, cap - 100)
    lo, hi = _bounds(rng, m, m_pad, c)
    ref = np.asarray(jsc._block_kernel(jnp.asarray(mins), jnp.asarray(maxs),
                                       jnp.asarray(alive), jnp.asarray(lo),
                                       jnp.asarray(hi), jsc.BLOCK))
    got = tsc.block_cull(*(torch.from_numpy(a) for a in (mins, maxs, alive, lo, hi)))
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), ref)
    assert ref.any()  # the case exercises kept blocks, not only empty maps


def test_block_cull_rejects_bad_shapes():
    z = torch.zeros((2, 1000), dtype=torch.float32)  # cap not a multiple of 1024
    with pytest.raises(ValueError):
        tsc.block_cull(z, z, torch.zeros(1000, dtype=torch.bool),
                       torch.zeros((1, 2)), torch.zeros((1, 2)))


# -- K1's rank search (csrc/block_cull.cu), modelled on the CPU -----------------


def _rank_tables(lo, hi, q=64):
    """A model of ``tables_kernel``: per (64-query tile, column), lo sorted
    ascending (NaN -> -inf) with prefix masks, hi sorted ascending (NaN ->
    +inf) with suffix masks; absent queries of a partial tile sort last as
    +inf and carry no bit. Masks as Python ints."""
    m, c = lo.shape
    tables = []
    for t0 in range(0, m, q):
        row = []
        for col in range(c):
            nq = min(q, m - t0)
            lv = np.full(q, np.inf, np.float32)
            hv = np.full(q, np.inf, np.float32)
            lv[:nq] = np.where(np.isnan(lo[t0:t0 + nq, col]), -np.inf, lo[t0:t0 + nq, col])
            hv[:nq] = np.where(np.isnan(hi[t0:t0 + nq, col]), np.inf, hi[t0:t0 + nq, col])
            lo_order = np.argsort(lv, kind="stable")
            hi_order = np.argsort(hv, kind="stable")
            bit = [1 << int(i) if i < nq else 0 for i in range(q)]
            pref = [0]
            for i in lo_order:
                pref.append(pref[-1] | bit[i])
            suf = [0]
            for i in hi_order[::-1]:
                suf.append(suf[-1] | bit[i])
            row.append((lv[lo_order], pref, hv[hi_order], suf[::-1]))
        tables.append(row)
    return tables


def _rank_cull(mins, maxs, alive, lo, hi, q=64):
    """K1 through the rank tables and a torch search: {q : max >= lo_q} is
    ``lo_pref[#{lo <= max}]``, {q : min <= hi_q} is ``hi_suf[#{hi < min}]``."""
    m, c = lo.shape
    cap = alive.shape[0]
    keep = np.zeros((m, cap), bool)
    mn = np.where(np.isnan(mins), -np.inf, mins).astype(np.float32)
    mx = np.where(np.isnan(maxs), np.inf, maxs).astype(np.float32)
    for t, row in enumerate(_rank_tables(lo, hi, q)):
        nq = min(q, m - t * q)
        masks = np.full(cap, (1 << nq) - 1, object) * alive.astype(object)
        for col, (lv, pref, hv, suf) in enumerate(row):
            le = torch.searchsorted(torch.from_numpy(lv), torch.from_numpy(mx[col]), right=True)
            lt = torch.searchsorted(torch.from_numpy(hv), torch.from_numpy(mn[col]))
            masks &= np.array(pref, object)[le.numpy()] & np.array(suf, object)[lt.numpy()]
        for b in range(nq):
            keep[t * q + b] = (masks >> b) & 1 == 1
    blocks = keep.reshape(m, cap // tsc.BLOCK, tsc.BLOCK).any(axis=2)
    return np.packbits(blocks, axis=1)


@pytest.mark.parametrize("case", ["random", "nan_rows", "inf_bounds", "ties"])
@pytest.mark.parametrize("m", [1, 2, 31, 33, 64, 257])
def test_rank_search_equals_block_cull_plain(m, case):
    """The method of the CUDA kernel (rank tables of the batch, two searches a
    file and column) gives the plain version's bits exactly: NaN rows, +-inf
    bounds, equal bounds across queries (ties in the search), the inverted
    +inf/-inf lanes of a null partition value, -0.0 against +0.0."""
    rng = np.random.RandomState(m * 7 + len(case))
    c, cap = 3, 4096
    mins, maxs, alive = _lanes(rng, c, cap, cap - 100)
    mins[0, :40], maxs[0, :40] = np.inf, -np.inf  # null partition lanes
    mins[1, 40:60], maxs[1, 40:60] = -np.inf, np.inf
    mins[2, 60:70], maxs[2, 60:70] = -0.0, 0.0
    lo, hi = _bounds(rng, m, m, c)
    if case == "nan_rows":
        lo[::3], hi[::3] = np.nan, np.nan
    elif case == "inf_bounds":
        lo[::2, 0], hi[1::2, 1] = -np.inf, np.inf
        lo[::3, 2], hi[::3, 2] = np.inf, -np.inf
    elif case == "ties":
        lo[:, 0], hi[:, 0] = lo[0, 0], hi[0, 0]  # one value for every query
        lo[::2, 1] = mins[1, 100]  # a file's own bounds, exactly
        hi[1::2, 1] = maxs[1, 100]
        lo[:, 2], hi[:, 2] = 0.0, -0.0
    got = _rank_cull(mins, maxs, alive, lo, hi)
    ref = tsc.block_cull_plain(*(torch.from_numpy(a) for a in (mins, maxs, alive, lo, hi)))
    assert np.array_equal(got, ref.numpy())
    assert ref.numpy().any()


# -- outward f32 rounding ------------------------------------------------------


def test_f32_rounding_matches_jax():
    rng = np.random.RandomState(5)
    xs = np.concatenate([
        rng.randn(500) * 10.0 ** rng.randint(-40, 40, 500),
        [0.1, -0.1, 1e300, -1e300, 1.0, np.nan, np.inf, -np.inf, 2.0**24 + 1,
         1e-45, -1e-45, 5e-324],
    ])
    assert _bits_equal(tsc._f32_down(xs), jsc._f32_down(xs))
    assert _bits_equal(tsc._f32_up(xs), jsc._f32_up(xs))


# -- K2/K3: the tail scatters -------------------------------------------------


@pytest.mark.parametrize("d", [8, 64, 1024])
def test_scatter_bool_plain_matches_jax(d):
    rng = np.random.RandomState(d)
    cap = 8192
    a = rng.rand(cap) > 0.5
    rows = np.full(d, cap, np.int32)  # pad = cap: dropped
    k = d - 3
    rows[:k] = rng.choice(cap, k, replace=False)
    rows[k] = cap + 5  # beyond the pad: dropped too
    for value in (False, True):
        ref = np.asarray(jsc._scatter_bool(jnp.asarray(a), jnp.asarray(rows), value))
        got = tsc.scatter_bool(torch.from_numpy(a.copy()), torch.from_numpy(rows), value)
        assert np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize("n", [8, 128, 1024])
def test_scatter_cols_plain_matches_jax(n):
    rng = np.random.RandomState(n + 1)
    c, cap = 5, 8192
    a = rng.rand(c, cap).astype(np.float32)
    rows = np.full(n, cap, np.int32)
    k = n - 2
    rows[:k] = np.arange(cap - 2 * k, cap - k, dtype=np.int32)  # a fresh range
    vals = rng.rand(c, n).astype(np.float32)
    vals[:, ::3] = np.nan
    ref = np.asarray(jsc._scatter_cols(jnp.asarray(a), jnp.asarray(rows), jnp.asarray(vals)))
    got = tsc.scatter_cols(torch.from_numpy(a.copy()), torch.from_numpy(rows),
                           torch.from_numpy(vals))
    assert _bits_equal(got.numpy(), ref)


def test_scatter_negative_index_wraps_as_xla():
    a = np.zeros(16, bool)
    rows = np.array([-1, -16, -17, 16], np.int32)
    ref = np.asarray(jsc._scatter_bool(jnp.asarray(a), jnp.asarray(rows), True))
    got = tsc.scatter_bool(torch.from_numpy(a.copy()), torch.from_numpy(rows), True)
    assert np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize("c", [1, 4])
@pytest.mark.parametrize("case", ["fresh", "wrap", "past-cap", "overlap"])
def test_tail_apply_plain_matches_jax_sequence(c, case):
    """The tail apply's plain version (the CPU path and the fused kernel's
    oracle) against the JAX package's sequence: ``_scatter_bool`` False on
    the dead rows, True on the added rows, then ``_scatter_cols`` on both
    lanes, the added rows padded with ``cap`` and the bounds with NaN
    (tests/torch_kernel_cases.py)."""
    from tests.torch_kernel_cases import tail_case

    alive, mins, maxs, dead, start, k, lo, hi = tail_case(c, case)
    cap = alive.shape[0]
    a = 1 << (k - 1).bit_length()
    rows = np.full(a, cap, np.int32)
    rows[:k] = np.arange(start, start + k, dtype=np.int32)
    pad = lambda v: np.concatenate([v, np.full((c, a - k), np.nan, np.float32)], axis=1)
    ja = jsc._scatter_bool(jnp.asarray(alive), jnp.asarray(dead), False)
    ja = jsc._scatter_bool(ja, jnp.asarray(rows), True)
    jmin = jsc._scatter_cols(jnp.asarray(mins), jnp.asarray(rows), jnp.asarray(pad(lo)))
    jmax = jsc._scatter_cols(jnp.asarray(maxs), jnp.asarray(rows), jnp.asarray(pad(hi)))
    t = [torch.from_numpy(x.copy()) for x in (alive, mins, maxs)]
    tsc.tail_apply(*t, torch.from_numpy(dead), start, k, torch.from_numpy(lo),
                   torch.from_numpy(hi))
    assert np.array_equal(t[0].numpy(), np.asarray(ja))
    assert _bits_equal(t[1].numpy(), np.asarray(jmin)) and _bits_equal(t[2].numpy(),
                                                                      np.asarray(jmax))
    if case == "overlap":
        assert t[0].numpy()[start:start + k].all()


def test_tail_apply_uploads_once(tmp_path, monkeypatch):
    """``_apply_tail_device`` uploads one buffer and calls the tail apply
    once a tail (K3 with K2 on its launch)."""
    path = str(tmp_path / "t")
    state = write_table(path, n_files=1800)
    _, te = _entries(path)
    te.ensure_resident()
    calls, uploads = [], []
    real_apply, real_upload = tsc.tail_apply, tsc._upload
    monkeypatch.setattr(tsc, "tail_apply", lambda *a: calls.append(a) or real_apply(*a))
    monkeypatch.setattr(tsc, "_upload", lambda *a: uploads.append(a) or real_upload(*a))
    for _ in range(2):
        write_tail(path, state, n_commits=1)
        assert _entries(path)[1] is te
    assert len(calls) == 2 and len(uploads) == 2


def test_kernel_library_name_follows_source_and_flags(monkeypatch):
    from delta_tpu_torch.ops import native

    before = native._target("tail_scatter")
    assert native._target("tail_scatter") == before
    monkeypatch.setattr(native, "_FLAGS", native._FLAGS + ["--use_fast_math"])
    assert native._target("tail_scatter") != before


# -- resident entries built from one table --------------------------------------


def _entries(path):
    jsnap = JaxDeltaLog.for_table(path).update()
    tsnap = TorchDeltaLog.for_table(path, device="cpu").update()
    je = jsc.DeviceStateCache.instance().get(jsnap)
    te = tsc.DeviceStateCache.instance().get(tsnap)
    assert je is not None and te is not None
    return je, te


def _assert_same_state(je, te):
    assert te.columns == je.columns
    assert te.paths == je.paths
    assert te.num_rows == je.num_rows and te.capacity == je.capacity
    assert np.array_equal(te.h_alive, je.h_alive)
    assert np.array_equal(te.h_size, je.h_size)
    assert _bits_equal(te.h_lo, je.h_lo) and _bits_equal(te.h_hi, je.h_hi)
    assert sorted(te.part_info) == sorted(je.part_info)
    for c, jp in je.part_info.items():
        tp = te.part_info[c]
        assert tp.values == jp.values and tp.sorted == jp.sorted
        assert (tp.parsed is None) == (jp.parsed is None)
        if jp.parsed is not None:
            assert np.array_equal(tp.parsed, jp.parsed)
    assert te.str_lanes == je.str_lanes


def _ranges(rng, entry, m):
    """Random boxes over the entry's lanes, some columns unbounded."""
    out = []
    n = entry.num_rows
    for _ in range(m):
        lo = np.full(len(entry.columns), np.nan)
        hi = np.full(len(entry.columns), np.nan)
        for c in range(len(entry.columns)):
            if rng.rand() < 0.5:
                continue
            i = rng.randint(n)
            v = entry.h_lo[c, i]
            if np.isfinite(v):
                lo[c], hi[c] = v, v + abs(v) * 0.001 + 1
        out.append(jsc.RangeSet(lo, hi))
    return out


@pytest.mark.parametrize("partitioned", [False, True])
def test_built_entry_matches_jax(tmp_path, partitioned):
    write_table(str(tmp_path / "t"), n_files=2500, partitioned=partitioned)
    je, te = _entries(str(tmp_path / "t"))
    _assert_same_state(je, te)


@pytest.mark.parametrize("use_device", [True, False])
def test_plan_ranges_matches_jax(tmp_path, use_device):
    """Both packages plan the same ranges over the same state: the port's
    entry is carried across from the JAX entry's numpy mirrors."""
    path = str(tmp_path / "t")
    write_table(path, n_files=3000, partitioned=True)
    je = jsc.DeviceStateCache.instance().get(JaxDeltaLog.for_table(path).update())
    te = tsc.resident_from_numpy(
        columns=je.columns, paths=je.paths, h_lo=je.h_lo, h_hi=je.h_hi,
        h_size=je.h_size, h_alive=je.h_alive, device="cpu",
        part_info={c: {"values": p.values, "parsed": p.parsed, "sorted": p.sorted,
                       "dt": None if p.dt is None else p.dt.name}
                   for c, p in je.part_info.items()},
        str_lanes=je.str_lanes, version=je.version)
    rng = np.random.RandomState(11)
    jr = _ranges(rng, je, 37)
    jr[3] = jsc.RangeSet(jr[3].lo, jr[3].hi, verdict="empty")
    jr[5] = jsc.RangeSet(jr[5].lo, jr[5].hi, verdict="all")
    tr = [tsc.RangeSet(r.lo.copy(), r.hi.copy(), verdict=r.verdict) for r in jr]
    from delta_tpu.utils.config import conf as jconf

    with jconf.set_temporarily(**{"delta.tpu.stateCache.devicePlan.mode": "force"}):
        jp = je.plan_ranges(jr, k=500, use_device=use_device)
    tp = te.plan_ranges(tr, k=500, use_device=use_device)
    assert len(jp) == len(tp) == 37
    for a, b in zip(jp, tp):
        assert b.count == a.count and b.overflow == a.overflow
        assert np.array_equal(b.rows, a.rows)
    assert sum(p.count for p in tp) > 0


def test_plan_device_equals_host_on_port(tmp_path):
    path = str(tmp_path / "t")
    write_table(path, n_files=3000)
    _, te = _entries(path)
    rs = _ranges(np.random.RandomState(2), te, 20)
    dev = te.plan_ranges(rs, k=10_000, use_device=True)
    host = te.plan_ranges(rs, k=10_000, use_device=False)
    for d, h in zip(dev, host):
        assert np.array_equal(d.rows, h.rows) and d.via == "device"


@pytest.mark.parametrize("m", [1, 3, 8, 256])
def test_unpadded_plan_matches_jax_kernel_and_host(tmp_path, m):
    """The port launches the cull with the batch's own M (no NaN pad rows):
    its bits are the JAX kernel's rows for the padded batch, and its plans
    the host's and the JAX package's."""
    path = str(tmp_path / "t")
    write_table(path, n_files=3000)
    je, te = _entries(path)
    rs = _ranges(np.random.RandomState(m), te, m)
    lo = np.stack([r.lo for r in rs])
    hi = np.stack([r.hi for r in rs])
    lo_t, hi_t = tsc.plan_bounds(lo, hi)
    assert lo_t.shape == hi_t.shape == (m, len(te.columns)) and lo_t.dtype == np.float32
    mb = tsc._next_pow2(m, floor=8)
    lo_j = np.full((mb, lo.shape[1]), np.nan, np.float32)
    hi_j = np.full((mb, hi.shape[1]), np.nan, np.float32)
    lo_j[:m], hi_j[:m] = jsc._f32_down(lo), jsc._f32_up(hi)
    lanes = [te._pad2(tsc._f32_down(te.h_lo)), te._pad2(tsc._f32_up(te.h_hi))]
    alive = np.zeros(te.capacity, bool)
    alive[: te.num_rows] = te.h_alive[: te.num_rows]
    ref = np.asarray(jsc._block_kernel(jnp.asarray(lanes[0]), jnp.asarray(lanes[1]),
                                       jnp.asarray(alive), jnp.asarray(lo_j),
                                       jnp.asarray(hi_j), jsc.BLOCK))[:m]
    got = tsc.block_cull(*(torch.from_numpy(a) for a in (*lanes, alive, lo_t, hi_t)))
    assert np.array_equal(got.numpy(), ref) and ref.any()
    dev = te.plan_ranges(rs, k=10_000, use_device=True)
    host = te.plan_ranges(rs, k=10_000, use_device=False)
    jr = [jsc.RangeSet(r.lo.copy(), r.hi.copy()) for r in rs]
    from delta_tpu.utils.config import conf as jconf

    with jconf.set_temporarily(**{"delta.tpu.stateCache.devicePlan.mode": "force"}):
        jp = je.plan_ranges(jr, k=10_000, use_device=True)
    assert len(dev) == len(host) == len(jp) == m
    for d, h, j in zip(dev, host, jp):
        assert np.array_equal(d.rows, h.rows) and np.array_equal(d.rows, j.rows)
        assert d.count == h.count == j.count and d.via == "device"


@pytest.mark.parametrize("partitioned", [False, True])
def test_tail_apply_matches_jax(tmp_path, partitioned):
    """After commit tails (adds, removes, a re-add, new partition values in
    and out of order) both entries advance incrementally to equal state,
    and the port's device lanes equal a fresh upload of its mirrors."""
    path = str(tmp_path / "t")
    state = write_table(path, n_files=1800, partitioned=partitioned)
    je0, te0 = _entries(path)
    te0.ensure_resident()
    write_tail(path, state, n_commits=3)
    je, te = _entries(path)
    assert je is je0 and te is te0, "tails must apply incrementally"
    _assert_same_state(je, te)
    lanes = dict(te._dev)
    te.drop_device()
    te.ensure_resident()
    for k in ("mins", "maxs"):
        assert _bits_equal(lanes[k].numpy(), te._dev[k].numpy())
    assert torch.equal(lanes["alive"], te._dev["alive"])


def test_tail_apply_across_a_capacity_bucket_matches_jax(tmp_path):
    """Tails that fill the capacity bucket (2048 rows) and then cross it:
    the ones that fit apply in place, the crossing one rebuilds, and the
    state and lanes equal the JAX package's and a fresh upload."""
    path = str(tmp_path / "t")
    state = write_table(path, n_files=1950)
    _, te0 = _entries(path)
    te0.ensure_resident()
    cap = te0.capacity
    write_tail(path, state, n_commits=1, adds=60, removes=10)
    je, te = _entries(path)
    assert te is te0 and te.capacity == cap and te.num_rows > 2000
    _assert_same_state(je, te)
    write_tail(path, state, n_commits=2, adds=60, removes=10)
    je, te = _entries(path)
    assert te.num_rows > cap or te.capacity > cap
    _assert_same_state(je, te)
    lanes = {k: v.clone() for k, v in te._dev.items()} if te._dev else None
    te.drop_device()
    te.ensure_resident()
    if lanes is not None:
        for k in ("mins", "maxs"):
            assert _bits_equal(lanes[k].numpy(), te._dev[k].numpy())
        assert torch.equal(lanes["alive"], te._dev["alive"])


def test_older_snapshot_not_served(tmp_path):
    path = str(tmp_path / "t")
    write_table(path, n_files=100)
    log = TorchDeltaLog.for_table(path, device="cpu")
    assert tsc.DeviceStateCache.instance().get(log.update()) is not None
    assert tsc.DeviceStateCache.instance().get(log.get_snapshot_at(1)) is None


def test_entry_with_string_null_partition_and_wide_ints_matches_jax(tmp_path):
    """tests/test_ops.py's files: a string stats column (6-byte prefix
    lanes), a null partition value (inverted lane), a file without stats
    (NaN lanes) and int stats beyond 2^53 (missing)."""
    write_ops_table(str(tmp_path / "t"))
    je, te = _entries(str(tmp_path / "t"))
    assert te.str_lanes == frozenset({"name"})
    _assert_same_state(je, te)


def test_all_null_partition_column_matches_jax(tmp_path):
    from delta_tpu.protocol.actions import AddFile, Metadata, Protocol
    from delta_tpu.schema.types import IntegerType, LongType, StructType

    path = str(tmp_path / "t")
    schema = StructType().add("year", IntegerType()).add("a", LongType())
    commit(path, 0, [Protocol(1, 2), Metadata(schema_string=schema.to_json(),
                                              partition_columns=["year"])])
    stats = '{"numRecords":1,"minValues":{"a":%d},"maxValues":{"a":%d}}'
    commit(path, 1, [AddFile(path=f"f{i}", partition_values={"year": None},
                             size=i, stats=stats % (i, i + 5)) for i in range(8)])
    je0, te0 = _entries(path)
    _assert_same_state(je0, te0)
    commit(path, 2, [AddFile(path="g", partition_values={"year": "2020"}, size=1,
                             stats=stats % (3, 4))])
    je, te = _entries(path)
    assert je is je0 and te is te0
    _assert_same_state(je, te)


def test_f32_boundary_keeps_file(tmp_path):
    """2^24 + 1 has no float32: the outward rounding must keep the file on
    the card's lanes, and the fine pass must keep it exactly."""
    from delta_tpu.protocol.actions import AddFile, Metadata, Protocol
    from delta_tpu.schema.types import LongType, StructType

    path = str(tmp_path / "t")
    v = 2**24 + 1
    commit(path, 0, [Protocol(1, 2), Metadata(
        schema_string=StructType().add("a", LongType()).to_json())])
    commit(path, 1, [AddFile(path="f", size=1,
                             stats='{"minValues":{"a":%d},"maxValues":{"a":%d}}' % (v, v))])
    _, te = _entries(path)
    box = tsc.RangeSet(np.array([float(v)]), np.array([float(v)]))
    for use_device in (True, False):
        assert te.plan_ranges([box], k=4, use_device=use_device)[0].count == 1
    miss = tsc.RangeSet(np.array([float(v + 1)]), np.array([float(v + 1)]))
    assert te.plan_ranges([miss], k=4)[0].count == 0

"""The port's sharded scan plan (K7 over the state mesh) and its MERGE
upload join over the mesh (K13), held against ``delta_tpu`` on the CPU.

The JAX package runs on the 8-device CPU mesh ``tests/conftest.py``
forces; the port on an 8-entry ``cpu`` mesh (``mesh.using_devices``), its
kernels through their plain versions. Plans (rows, counts, ``via``), the
``dist.plan.sharded`` counter, the priced ``auto`` decision with its
sharded price, MERGE end states and metrics are compared exactly; prices to
1e-12 relative.
"""
import os

import numpy as np
import pytest
import torch

from delta_tpu.obs import router_audit as jax_audit
from delta_tpu.ops import state_cache as jsc
from delta_tpu.parallel import link as jax_link
from delta_tpu.utils import telemetry as jax_tel
from delta_tpu_torch.obs import router_audit
from delta_tpu_torch.ops import join_kernel
from delta_tpu_torch.ops import state_cache as tsc
from delta_tpu_torch.parallel import link, mesh
from delta_tpu_torch.utils import telemetry
from tests.torch_port_tables import (
    Pkg, both_confs, both_links_on_mesh, install_reference_constants, reset_caches,
    reset_links,
)

FORCE = {"delta.tpu.distributed.plan.mode": "force",
         "delta.tpu.stateCache.devicePlan.mode": "force"}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    install_reference_constants(monkeypatch)
    reset_links()
    reset_caches()
    jsc.DeviceStateCache.reset()
    tsc.DeviceStateCache.reset()
    yield
    for m in (link, jax_link):
        m.clear_calibrated()
    reset_links()
    reset_caches()


def _pair(n=5000, seed=7, cols=("a", "b")):
    """tests/test_distributed.py's `_entry` in both packages."""
    rng = np.random.RandomState(seed)
    lo = np.sort(rng.rand(len(cols), n) * 100.0, axis=0)
    hi = lo + rng.rand(len(cols), n) * 10.0
    lanes = {"min": lo, "max": hi, "size": np.ones(n, np.int64)}
    paths = [f"p{i}" for i in range(n)]
    je = jsc.ResidentState("mem://t", "mid", 0, list(cols), paths, dict(lanes))
    te = tsc.ResidentState("mem://t", "mid", 0, list(cols), paths, dict(lanes),
                           torch.device("cpu"))
    return je, te


def _ranges(exprs, cols=("a", "b")):
    from delta_tpu.expr.parser import parse_expression as jparse
    from delta_tpu.ops import pruning as jpruning
    from delta_tpu_torch.expr.parser import parse_expression as tparse
    from delta_tpu_torch.ops import pruning as tpruning

    jr = [jsc.extract_ranges(jpruning.skipping_predicate(jparse(e), frozenset()), list(cols))
          for e in exprs]
    tr = [tsc.extract_ranges(tpruning.skipping_predicate(tparse(e), frozenset()), list(cols))
          for e in exprs]
    assert all(r is not None for r in jr + tr)
    return jr, tr


EXPRS = ["a >= 10 AND a <= 30", "b <= 20", "a = 50", "a >= 99 AND b <= 1", "b >= 1000"]


def _same_plans(jp, tp):
    assert len(jp) == len(tp)
    for a, b in zip(jp, tp):
        assert b.count == a.count and b.overflow == a.overflow and b.via == a.via
        assert np.array_equal(b.rows, a.rows)


# -- the sharded plan (tests/test_distributed.py:168 and :213) -------------------------


def test_sharded_plan_identity_on_8_shards():
    je, te = _pair()
    jr, tr = _ranges(EXPRS)
    host = te.plan_ranges(tr, k=10_000, use_device=False)
    jb, tb = jax_tel.counters("dist"), telemetry.counters("dist")
    with mesh.using_devices(["cpu"] * 8), both_confs(**FORCE):
        jp = je.plan_ranges(jr, k=10_000, use_device=True)
        tp = te.plan_ranges(tr, k=10_000, use_device=True)
    assert je.resident_shards == te.resident_shards == 8
    _same_plans(jp, tp)
    for h, d in zip(host, tp):
        assert np.array_equal(d.rows, h.rows) and d.count == h.count
        assert d.via in ("device-sharded", "verdict")
    assert any(d.via == "device-sharded" for d in tp)
    ja, ta = jax_tel.counters("dist"), telemetry.counters("dist")
    assert ta.get("dist.plan.sharded", 0) - tb.get("dist.plan.sharded", 0) == \
        ja.get("dist.plan.sharded", 0) - jb.get("dist.plan.sharded", 0) == 1


@pytest.mark.parametrize("n,seed,m", [(9000, 3, 40), (20_000, 4, 97), (70_000, 5, 12)])
def test_sharded_plan_matches_jax_and_one_card(n, seed, m):
    """Random boxes over wider entries: the sharded plan equals the JAX
    package's sharded plan, the port's single-card plan and its host plan;
    the residency then serves the next batch sharded without re-placing."""
    je, te = _pair(n, seed)
    rng = np.random.RandomState(seed)
    exprs = []
    for _ in range(m):
        c = "ab"[rng.randint(2)]
        lo = rng.rand() * 100
        exprs.append(f"{c} >= {lo:.4f} AND {c} <= {lo + rng.rand() * 5:.4f}")
    jr, tr = _ranges(exprs)
    with mesh.using_devices(["cpu"] * 8), both_confs(**FORCE):
        jp = je.plan_ranges(jr, k=n, use_device=True)
        tp = te.plan_ranges(tr, k=n, use_device=True)
        assert te.resident_shards == je.resident_shards
        _same_plans(jp, tp)
        _same_plans(je.plan_ranges(jr, k=7, use_device=True),
                    te.plan_ranges(tr, k=7, use_device=True))
    one = tsc.ResidentState("mem://t", "mid", 0, te.columns, te.paths,
                            {"min": te.h_lo, "max": te.h_hi, "size": te.h_size},
                            torch.device("cpu"))
    single = one.plan_ranges(tr, k=n, use_device=True)
    host = te.plan_ranges(tr, k=n, use_device=False)
    for s, h, d in zip(single, host, tp):
        assert np.array_equal(d.rows, s.rows) and np.array_equal(d.rows, h.rows)
        assert s.via == "device" and one.resident_shards == 1


def test_small_capacity_is_not_shardable():
    with mesh.using_devices(["cpu"] * 8):
        je, te = _pair(n=6)
        assert te._feasible_shards() == je._feasible_shards() == 1
        with both_confs(**{"delta.tpu.distributed.plan.enabled": False}):
            je, te = _pair()
            assert te._feasible_shards() == je._feasible_shards() == 1
        with both_confs(**{"delta.tpu.distributed.plan.mode": "off"}):
            assert te._feasible_shards() == je._feasible_shards() == 1
        je, te = _pair()
        assert te._feasible_shards() == je._feasible_shards() == 8
    # the port's default CPU mesh is the CPU once
    assert te._feasible_shards() == 1


@pytest.mark.parametrize("shards", [2, 4])
def test_mesh_size_bounds_the_shards(shards):
    _, te = _pair(n=9000)
    with mesh.using_devices(["cpu"] * shards):
        assert te._feasible_shards() == shards
        with both_confs(**FORCE):
            te.plan_ranges(_ranges(EXPRS)[1], k=100, use_device=True)
        assert te.resident_shards == shards
        assert len(te._dev) == shards
        assert all(sh["mins"].shape == (2, te.capacity // shards) for sh in te._dev)


def test_tail_apply_drops_the_sharded_residency():
    je, te = _pair()
    jr, tr = _ranges(EXPRS)
    with mesh.using_devices(["cpu"] * 8), both_confs(**FORCE):
        je.plan_ranges(jr, k=100, use_device=True)
        te.plan_ranges(tr, k=100, use_device=True)
        add = (["new-0"], np.array([[55.0], [5.0]]), np.array([[56.0], [6.0]]),
               np.array([1], np.int64))
        assert je.apply_tail(1, ["p3", "p4"], add) and te.apply_tail(1, ["p3", "p4"], add)
        assert not je.is_resident and not te.is_resident
        assert te.resident_shards == je.resident_shards == 1
        _same_plans(je.plan_ranges(jr, k=100, use_device=True),
                    te.plan_ranges(tr, k=100, use_device=True))
        assert te.resident_shards == 8


def test_sharded_block_cull_plain_matches_jax():
    """K7's plain version against JAX's `_sharded_block_kernel` on the same
    lanes (NaN lanes, dead rows, NaN bounds), and equal to K1's unpacked."""
    rng = np.random.RandomState(1)
    c, cap, m = 3, 16 * 1024, 24
    mins = (rng.rand(c, cap) * 100).astype(np.float32)
    maxs = mins + (rng.rand(c, cap) * 0.5).astype(np.float32)
    mins[:, rng.rand(cap) < 0.02] = np.nan
    maxs[:, rng.rand(cap) < 0.02] = np.nan
    alive = rng.rand(cap) > 0.1
    alive[-3000:] = False
    lo = (rng.rand(m, c) * 100).astype(np.float32)
    hi = lo + np.float32(0.05)
    lo[rng.rand(m, c) < 0.3] = np.nan
    hi[rng.rand(m, c) < 0.3] = np.nan
    import jax.numpy as jnp

    want = np.asarray(jsc._sharded_block_kernel(jnp.asarray(mins), jnp.asarray(maxs),
                                                jnp.asarray(alive), jnp.asarray(lo),
                                                jnp.asarray(hi), jsc.BLOCK, 8))
    per = cap // 8
    shards = [(torch.from_numpy(np.ascontiguousarray(mins[:, i * per:(i + 1) * per])),
               torch.from_numpy(np.ascontiguousarray(maxs[:, i * per:(i + 1) * per])),
               torch.from_numpy(alive[i * per:(i + 1) * per])) for i in range(8)]
    got = tsc.sharded_block_cull(shards, torch.from_numpy(lo), torch.from_numpy(hi))
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)
    k1 = tsc.block_cull(torch.from_numpy(mins), torch.from_numpy(maxs), torch.from_numpy(alive),
                        torch.from_numpy(lo), torch.from_numpy(hi))
    assert np.array_equal(np.unpackbits(k1.numpy(), axis=1, count=cap // 1024), got.numpy())
    with pytest.raises(ValueError):  # a slice of partial blocks
        tsc.sharded_block_cull([(s[0][:, :1000], s[1][:, :1000], s[2][:1000]) for s in shards],
                               torch.from_numpy(lo), torch.from_numpy(hi))


@pytest.mark.parametrize("m", [0, 1, 70, 300])
def test_sharded_block_cull_one_launch_layout_matches_jax(m):
    """K7 as one launch a device over an 8-entry CPU mesh: every slice on
    the lead device, so each slice's blocks land at its columns of the one
    (M, blocks) map the wrapper returns (the plain arithmetic fills it on
    the CPU), equal to JAX's ``_sharded_block_kernel`` over its 8-device
    mesh and to the plain version's gathered per-shard maps, for batches of
    no query, one, one partial tile and several tiles."""
    import jax.numpy as jnp

    rng = np.random.RandomState(m + 3)
    c, cap = 4, 32 * 1024
    mins = (rng.rand(c, cap) * 100).astype(np.float32)
    maxs = mins + (rng.rand(c, cap) * 2).astype(np.float32)
    mins[:, rng.rand(cap) < 0.03] = np.nan
    maxs[0, 5], mins[0, 5] = -np.inf, np.inf
    alive = rng.rand(cap) > 0.2
    lo = (rng.rand(m, c) * 100).astype(np.float32)
    hi = lo + np.float32(0.3)
    lo[rng.rand(m, c) < 0.25] = np.nan
    want = np.asarray(jsc._sharded_block_kernel(jnp.asarray(mins), jnp.asarray(maxs),
                                                jnp.asarray(alive), jnp.asarray(lo),
                                                jnp.asarray(hi), jsc.BLOCK, 8))
    per = cap // 8
    shards = [tuple(torch.from_numpy(np.ascontiguousarray(a[..., i * per:(i + 1) * per]))
                    for a in (mins, maxs, alive)) for i in range(8)]
    with mesh.using_devices(["cpu"] * 8):
        got = tsc.sharded_block_cull(shards, torch.from_numpy(lo), torch.from_numpy(hi))
    assert got.shape == (m, cap // 1024) and got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), want.reshape(m, cap // 1024))
    assert torch.equal(got, tsc.sharded_block_cull_plain(shards, torch.from_numpy(lo),
                                                         torch.from_numpy(hi)))


# -- the priced auto decision with its sharded price -----------------------------------


def _close(a, b):
    if a is None or b is None:
        return a is b
    return abs(a - b) <= 1e-12 * max(abs(a), abs(b), 1e-300)


@pytest.mark.parametrize("n,m,calibrate", [(5000, 5, False), (40_000, 300, False),
                                           (20_000, 16, True)])
def test_auto_route_prices_the_mesh_like_jax(n, m, calibrate):
    """`_price_plan`'s 6-tuple, the route, `via` and the audit's decision
    and predictions (``device-sharded`` included) are the JAX package's.
    Calibrated per-cell constants make the mesh the cheapest route in the
    last case."""
    je, te = _pair(n)
    rng = np.random.RandomState(n)
    exprs = [f"a >= {v:.3f} AND a <= {v + 2:.3f}" for v in rng.rand(m) * 100]
    jr, tr = _ranges(exprs)
    if calibrate:
        for L in (link, jax_link):
            L.set_calibrated("DEVICE_PRUNE_S_PER_CELL", 1e-6)
            L.set_calibrated("HOST_PRUNE_S_PER_CELL", 1e-3)
    with both_links_on_mesh(1000.0, 1000.0):
        jprice, tprice = je._price_plan(m), te._price_plan(m)
        assert all(_close(a, b) for a, b in zip(jprice, tprice)), (jprice, tprice)
        assert tprice[5] == jprice[5] == 8
        assert te._route_plan(m)[0] == je._route_plan(m)[0]
        jp = je.plan_ranges(jr, k=n)
        tp = te.plan_ranges(tr, k=n)
    _same_plans(jp, tp)
    assert te.resident_shards == je.resident_shards
    ja, ta = jax_audit.last_audit(), router_audit.last_audit()
    # (``miss`` compares predictions with a measured wall time: not compared)
    assert ta.decision == ja.decision
    assert sorted(ta.predicted_ms) == sorted(ja.predicted_ms)
    assert "device-sharded" in ta.predicted_ms
    for k, v in ja.predicted_ms.items():
        assert _close(ta.predicted_ms[k], v), k
    if calibrate:
        assert tp[0].via == "device-sharded"


def test_estimate_device_s_with_shards_matches_jax():
    with both_links_on_mesh(6.0, 4.0):
        for shards in (1, 2, 8):
            for ub, db, rows in ((0, 0, 0), (1 << 20, 1 << 17, 3_000_000), (7, 1, 12_345)):
                a = link.estimate_device_s(ub, db, rows, shards=shards, device="cpu")
                b = jax_link.estimate_device_s(ub, db, rows, shards=shards)
                assert all(_close(getattr(a, f), getattr(b, f))
                           for f in ("device_s", "up_s", "down_s", "kernel_s"))


# -- MERGE's upload join over the mesh -------------------------------------------------


@pytest.fixture
def k13_calls(monkeypatch):
    """Counts of the port's K12 and K13 wrapper calls (the plain versions
    count no launches)."""
    calls = {"k12": 0, "k13": 0}
    k12, k13 = join_kernel.join_probe, join_kernel.sharded_join_probe

    def count(key, fn):
        def wrapped(*a):
            calls[key] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(join_kernel, "join_probe", count("k12", k12))
    monkeypatch.setattr(join_kernel, "sharded_join_probe", count("k13", k13))
    return calls


def test_config2_routes_on_the_mesh(tmp_path, k13_calls):
    """tests/test_torch_merge_device.py's four routes at bench config 2's
    shape with the port's 8-entry mesh installed: M3's upload join runs K13
    (and no K12), as the JAX package's does on its 8 devices; every end
    state and metric equals the JAX package's and the reference upsert."""
    from tests.test_torch_merge_device import (
        COLS, N_TARGET, config2_routes, reference_upsert, store_sales, upsert_sources,
    )

    target = store_sales(N_TARGET, np.random.RandomState(7))
    sources = upsert_sources(target["ss_item_sk"])
    with mesh.using_devices(["cpu"] * 8):
        got = config2_routes(Pkg("torch"), str(tmp_path / "torch"), target, sources)
    want = config2_routes(Pkg("jax"), str(tmp_path / "jax"), target, sources)
    assert [g[0] for g in got] == ["host", "device-cold", "resident", "device-upload"]
    assert k13_calls == {"k12": 0, "k13": 1}
    state = {c: target[c] for c in COLS}
    refs = [reference_upsert(state, sources[0])]
    for s in sources[:3]:
        state = reference_upsert(state, s)
        refs.append(state)
    for i, ((route, m, reason, end), (w_route, w_m, _, w_end)) in enumerate(zip(got, want)):
        assert (route, m) == (w_route, w_m), f"M{i}"
        assert reason is None, f"M{i}: {reason}"
        for c in COLS:
            assert np.array_equal(end[c], refs[i][c]), f"M{i} column {c}"
            assert np.array_equal(end[c], w_end[c]), f"M{i} column {c} vs delta_tpu"


def _upload_case(P, root, src2):
    """A DV merge, then a copy-on-write merge over the DV'd files (the
    upload route); returns each merge's route, metrics and the rows."""
    from tests.torch_port_tables import metrics

    log = P.write(os.path.join(root, "t"), {"k": ("int64", list(range(100))),
                                            "v": [0.5] * 100})
    if P.jax:
        from delta_tpu.commands.alter import set_table_properties
    else:
        from delta_tpu_torch.commands.alter import set_table_properties
    set_table_properties(log, {"delta.tpu.enableDeletionVectors": "true"})
    out = []
    with both_confs(**{"delta.tpu.merge.devicePath.mode": "force"}):
        cmd = P.merge(log, {"k": ("int64", [1, 200]), "v": [1.0, 2.0]}, "t.k = s.k",
                      [("update",)], [("insert",)], source_alias="s", target_alias="t")
        out.append((cmd._join_path, metrics(cmd)))
        with both_confs(**{"delta.tpu.deletionVectors.enabled": False}):
            cmd = P.merge(log, src2, "t.k = s.k", [("update",)], [("insert",)],
                          source_alias="s", target_alias="t")
            out.append((cmd._join_path, metrics(cmd)))
    return out + [P.rows(log)]


@pytest.mark.parametrize("src2", [
    {"k": ("int64", [2, 300]), "v": [1.0, 2.0]},
    # a key twice in the source: both packages raise the multi-match error
    {"k": ("int64", [5, 5, 700, None, 42, 99, 100, -1]), "v": [float(i) for i in range(8)]},
    {"k": ("int64", [7, None, 700, 42, 99, 100, -1]), "v": [float(i) for i in range(7)]},
    {"k": ("int64", list(range(-50, 250, 3))), "v": [0.25] * 100},
])
def test_upload_route_on_the_mesh_matches_jax(tmp_path, src2, k13_calls):
    from tests.torch_port_tables import observe

    with mesh.using_devices(["cpu"] * 8):
        got = observe(lambda: _upload_case(Pkg("torch"), str(tmp_path / "torch"), src2))
    want = observe(lambda: _upload_case(Pkg("jax"), str(tmp_path / "jax"), src2))
    assert got == want
    if not isinstance(got, str):
        assert got[1][0] == "device-upload"
    assert k13_calls["k13"] == 1 and k13_calls["k12"] == 0


def test_upload_join_error_on_the_mesh_propagates(tmp_path, monkeypatch):
    """A raising K13 fails the MERGE: no host join, nothing committed
    (where the JAX package's join would fall back quietly)."""
    P = Pkg("torch")

    def _raise(*a, **kw):
        raise RuntimeError("injected kernel failure")

    with mesh.using_devices(["cpu"] * 8):
        log = P.write(str(tmp_path / "t"), {"k": list(range(100)), "v": [0.5] * 100})
        from delta_tpu_torch.commands.alter import set_table_properties

        set_table_properties(log, {"delta.tpu.enableDeletionVectors": "true"})
        with both_confs(**{"delta.tpu.merge.devicePath.mode": "force"}):
            P.merge(log, {"k": [1, 200], "v": [1.0, 2.0]}, "t.k = s.k", [("update",)],
                    [("insert",)], source_alias="s", target_alias="t")
            version = log.update().version
            monkeypatch.setattr(join_kernel, "sharded_join_probe", _raise)
            with both_confs(**{"delta.tpu.deletionVectors.enabled": False}):
                with pytest.raises(RuntimeError, match="injected"):
                    P.merge(log, {"k": [2, 300], "v": [1.0, 2.0]}, "t.k = s.k",
                            [("update",)], [("insert",)], source_alias="s", target_alias="t")
    assert log.update().version == version


def test_prefer_mesh_cold_estimate_matches_jax(tmp_path):
    """With ``devicePath.preferMesh`` the cold estimate prices the mesh's
    upload join (``estimate_device_s(..., shards=8)``) in both packages."""
    from tests.torch_port_tables import metrics

    def case(P, root):
        log = P.write(os.path.join(root, "t"), {"k": ("int64", list(range(3000))),
                                                "v": [0.5] * 3000})
        with both_confs(**{"delta.tpu.merge.devicePath.mode": "auto",
                           "delta.tpu.merge.devicePath.preferMesh": True}):
            cmd = P.merge(log, {"k": ("int64", [1, 5000]), "v": [1.0, 2.0]}, "t.k = s.k",
                          [("update",)], [("insert",)], source_alias="s", target_alias="t")
        return cmd._router.get("deviceEstS"), cmd._router.get("hostEstS"), metrics(cmd)

    with both_links_on_mesh(6.0, 4.0):
        got = case(Pkg("torch"), str(tmp_path / "torch"))
        want = case(Pkg("jax"), str(tmp_path / "jax"))
    assert got == want and got[0] is not None


# -- K13's plain version against JAX's `_sharded_kernel` on the hash traffics -----------


@pytest.mark.parametrize("kind", ["dups", "miss", "hit", "extremes"])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_sharded_join_probe_matches_sharded_kernel_on_hash_traffic(kind, dtype):
    """K13 over the 8-entry CPU mesh (its wrapper takes the plain version)
    against JAX's 8-device kernel on the same padded inputs, and against
    K12 on the 1-entry mesh, exactly."""
    import jax

    from delta_tpu.ops import join_kernel as jax_jk
    from delta_tpu.parallel import mesh as jax_mesh
    from delta_tpu.utils.jaxcompat import enable_x64
    from tests.test_torch_join_kernel import _traffic

    t_in, s_in = _traffic(kind, dtype)
    m = jax_mesh.state_mesh()
    assert jax_mesh.shard_count(m) == 8
    with enable_x64():
        kernel = jax_jk._sharded_kernel(jax, m, jax_mesh.STATE_AXIS)
        want = [np.asarray(x) for x in kernel(t_in.reshape(8, -1), s_in.reshape(8, -1))]
    with mesh.using_devices(["cpu"] * 8) as cpu8:
        devs = [torch.device(d) for d in cpu8]
        got = join_kernel.sharded_join_probe(
            [torch.from_numpy(x).to(d) for x, d in zip(t_in.reshape(8, -1), devs)],
            [torch.from_numpy(x).to(d) for x, d in zip(s_in.reshape(8, -1), devs)])
    assert np.array_equal(got[0].numpy(), want[0].reshape(-1))
    assert np.array_equal(got[1].numpy(), want[1])
    assert bool(got[2][0]) == bool(want[2])
    k12 = join_kernel.join_probe(torch.from_numpy(t_in), torch.from_numpy(s_in))
    assert all(torch.equal(a, b) for a, b in zip(got, k12))

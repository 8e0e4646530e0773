"""The port's link cost model (``delta_tpu_torch/parallel/link.py``) against
``delta_tpu.parallel.link`` on the CPU:

* K17's plain version (``a + 1`` over int32) against the JAX package's
  ``jax.jit(lambda a: a + 1)``, wrap-around included;
* ``LinkProfile``, ``estimate_device_s`` and every cost function against the
  reference's to 1e-12 relative, over a seeded grid of profiles (0.0001,
  6/4, 10,000 and 50,000 MB/s, three latencies) and sizes, under the same
  constants (the JAX package's, installed in the port);
* ``set_calibrated`` refusing unknown and non-positive values;
* the replays of ``tests/test_link.py``'s single-card cases through both
  packages, with equal decisions and results: the conf override, the
  upload join's budget on a slow and a fast link, an ``auto`` MERGE
  declined on a slow link, ``_rows_from_stats`` and the join without
  sentinel room.

Every table is written by ``delta_tpu`` and read by both packages (or
copied), so the file sizes and stats the router prices from are the same.
"""
import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from delta_tpu import DeltaLog as JaxDeltaLog
from delta_tpu.commands.merge import _rows_from_stats as jax_rows_from_stats
from delta_tpu.commands.write import WriteIntoDelta as JaxWrite
from delta_tpu.ops import join_kernel as jax_join
from delta_tpu.parallel import link as jax_link
from delta_tpu.utils.config import conf as jax_conf
from delta_tpu_torch import DeltaLog
from delta_tpu_torch.commands.merge import _rows_from_stats
from delta_tpu_torch.ops import join_kernel, native
from delta_tpu_torch.parallel import link
from delta_tpu_torch.utils.config import conf
from tests.torch_port_tables import (
    LINK_CONSTANTS, Pkg, both_links, install_reference_constants, metrics, reset_caches,
    reset_links,
)

REL = 1e-12


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    install_reference_constants(monkeypatch)
    reset_links()
    reset_caches()
    yield
    reset_links()
    reset_caches()


def close(a, b):
    return abs(a - b) <= REL * max(abs(a), abs(b), 1e-300)


# -- K17 --------------------------------------------------------------------------


@pytest.mark.parametrize("n", [8, 1000, 1 << 16])
def test_link_probe_plain_matches_jax(n):
    vals = np.random.RandomState(n).randint(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    vals[0], vals[-1] = np.iinfo(np.int32).max, np.iinfo(np.int32).min  # wraps, as XLA's
    want = np.asarray(jax.jit(lambda a: a + 1)(jnp.asarray(vals)))
    got = link.link_probe_plain(torch.from_numpy(vals))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    # the wrapper takes the plain version for a tensor on the CPU, counting nothing
    before = native.launches["link_probe"]
    assert np.array_equal(link.link_probe(torch.from_numpy(vals)).numpy(), want)
    assert native.launches["link_probe"] == before


def test_probe_on_the_cpu_runs_k17_and_floors():
    """The CPU's probe runs K17's plain version, moves nothing over a link
    and reports the floors: a rate of 1 TB/s and a latency of at least 1 us;
    its profile is cached per device."""
    p = link.profile("cpu")
    assert p.probed and p.up_mbps == p.down_mbps == 1e6
    assert p.latency_s >= 1e-6
    assert link.profile("cpu") is p and link.profile(torch.device("cpu")) is p


def test_cuda_profile_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError):
        link.profile("cuda")


# -- LinkProfile, estimate_device_s and the cost functions -------------------------

PROFILES = [(0.0001, 0.0001, 0.005), (6.0, 4.0, 0.005), (10_000.0, 10_000.0, 1e-4),
            (50_000.0, 50_000.0, 3e-5), (24_000.0, 9_500.0, 2.5e-5)]


def _grid(seed=0, count=12):
    rng = np.random.RandomState(seed)
    sizes = [0, 1, 7, 1 << 20, 10_000_000, 123_456_789]
    out = []
    for _ in range(count):
        out.append(tuple(int(rng.choice(sizes)) if rng.rand() < 0.3
                         else int(rng.randint(0, 1 << 27)) for _ in range(3)))
    return out


@pytest.mark.parametrize("up,down,lat", PROFILES)
def test_link_profile_matches_jax(up, down, lat):
    a = link.LinkProfile(up, down, lat, True)
    b = jax_link.LinkProfile(up, down, lat, True)
    for nbytes in (0, 1, 4096, 1 << 25, 10**10):
        assert close(a.upload_s(nbytes), b.upload_s(nbytes))
        assert close(a.download_s(nbytes), b.download_s(nbytes))


@pytest.mark.parametrize("up,down", [(p[0], p[1]) for p in PROFILES])
def test_estimate_device_s_matches_jax(up, down):
    with both_links(up, down):
        for ub, db, rows in _grid(1):
            a = link.estimate_device_s(ub, db, rows, device="cpu")
            b = jax_link.estimate_device_s(ub, db, rows)
            for f in ("device_s", "up_s", "down_s", "kernel_s"):
                assert close(getattr(a, f), getattr(b, f)), (f, ub, db, rows)


COST_FUNCTIONS = {
    "resident_probe_device_s": lambda L, n, m, k, p: L.resident_probe_device_s(n, m, p),
    "cold_merge_device_s": lambda L, n, m, k, p: L.cold_merge_device_s(n, m, p),
    "host_residual_filter_s": lambda L, n, m, k, p: L.host_residual_filter_s(n, k % 9 + 1),
    "device_residual_mask_s": lambda L, n, m, k, p: L.device_residual_mask_s(n, m, k % 9 + 1, p),
    "sharded_plan_device_s": lambda L, n, m, k, p: L.sharded_plan_device_s(n, k % 16, p),
}


@pytest.mark.parametrize("fn", sorted(COST_FUNCTIONS))
@pytest.mark.parametrize("up,down,lat", PROFILES)
def test_cost_functions_match_jax(fn, up, down, lat):
    f = COST_FUNCTIONS[fn]
    pt = link.LinkProfile(up, down, lat, False)
    pj = jax_link.LinkProfile(up, down, lat, False)
    for n, m, k in _grid(hash((fn, up)) % 1000):
        assert close(f(link, n, m, k, pt), f(jax_link, n, m, k, pj)), (fn, n, m, k)


def test_constants_and_calibratable_names():
    """The port prices with the reference's names; the multi-host
    executor's constant and cost function are left out, and no port default
    is a TPU-fit value."""
    for name in LINK_CONSTANTS:
        assert hasattr(link, name)
    assert link.CALIBRATABLE == jax_link.CALIBRATABLE - {"DIST_ITEM_S"}
    for name in ("sharded_plan_device_s", "SHARD_DISPATCH_S", "SHARD_GATHER_S_PER_SHARD"):
        assert hasattr(link, name)
    for name in ("dist_execute_s", "DIST_ITEM_S"):
        assert not hasattr(link, name)


def test_port_defaults_are_not_the_tpu_values():
    import importlib

    fresh = importlib.reload(link)  # the module's own values, not the fixture's
    try:
        same = [n for n in LINK_CONSTANTS if getattr(fresh, n) == getattr(jax_link, n)]
        assert same == []
    finally:
        importlib.reload(link)


@pytest.mark.parametrize("name,value", [("NOT_A_CONSTANT", 1.0), ("DIST_ITEM_S", 1.0),
                                        ("HOST_JOIN_S_PER_ROW", 0.0),
                                        ("HOST_JOIN_S_PER_ROW", -1e-9),
                                        ("KERNEL_S_PER_ROW", float("nan"))])
def test_set_calibrated_rejects_like_jax(name, value):
    with pytest.raises(ValueError):
        link.set_calibrated(name, value)
    if name != "DIST_ITEM_S":  # calibratable in the JAX package (its executor)
        with pytest.raises(ValueError):
            jax_link.set_calibrated(name, value)
    assert link.calibrated_constants() == {}


def test_set_calibrated_overrides_and_clears():
    link.set_calibrated("HOST_JOIN_S_PER_ROW", 3e-7)
    jax_link.set_calibrated("HOST_JOIN_S_PER_ROW", 3e-7)
    assert link.constant("HOST_JOIN_S_PER_ROW") == jax_link.constant("HOST_JOIN_S_PER_ROW") == 3e-7
    assert link.calibrated_constants() == {"HOST_JOIN_S_PER_ROW": 3e-7}
    link.clear_calibrated()
    jax_link.clear_calibrated()
    assert link.constant("HOST_JOIN_S_PER_ROW") == jax_link.HOST_JOIN_S_PER_ROW


# -- the replays of tests/test_link.py ----------------------------------------------


def test_profile_conf_override_skips_probe():
    with both_links(6.0, 4.0):
        p = link.profile("cpu")
        q = jax_link.profile()
    assert not p.probed and not q.probed
    assert (p.up_mbps, p.down_mbps, p.latency_s) == (q.up_mbps, q.down_mbps, q.latency_s)
    assert 9.9 < p.upload_s(60_000_000) < 10.2
    assert p.upload_s(60_000_000) == q.upload_s(60_000_000)


def _budget_keys():
    rng = np.random.RandomState(0)
    t = rng.randint(0, 1000, 50_000).astype(np.int64)
    s = rng.randint(500, 1500, 5_000).astype(np.int64)
    return t, np.ones(len(t), bool), s, np.ones(len(s), bool)


def test_budget_declines_on_slow_link():
    t, ok_t, s, ok_s = _budget_keys()
    with both_links(6.0, 4.0):
        budget = (len(t) + len(s)) * link.HOST_JOIN_S_PER_ROW
        assert budget == (len(t) + len(s)) * jax_link.HOST_JOIN_S_PER_ROW
        assert jax_join.inner_join_async(t, ok_t, s, ok_s, budget_s=budget) is None
        assert join_kernel.inner_join_async(t, ok_t, s, ok_s, device="cpu",
                                            budget_s=budget) is None


def test_budget_accepts_on_fast_link():
    t, ok_t, s, ok_s = _budget_keys()
    with both_links(50_000.0, 50_000.0):
        a = join_kernel.inner_join_async(t, ok_t, s, ok_s, device="cpu", budget_s=10.0)
        b = jax_join.inner_join_async(t, ok_t, s, ok_s, budget_s=10.0)
        assert a is not None and b is not None
        ra, rb = a.result(), b.result()
    assert (ra.t_matched == np.isin(t, s)).all() and (ra.s_matched == np.isin(s, t)).all()
    assert np.array_equal(ra.t_first_s, rb.t_first_s)
    assert np.array_equal(ra.s_matched, rb.s_matched) and ra.any_multi == rb.any_multi


@pytest.mark.parametrize("up,down", [(p[0], p[1]) for p in PROFILES])
def test_budget_decisions_match_jax_over_the_sweep(up, down):
    """The upload join's budget decision, single card in both, over the
    profile sweep and int32 / int64 keys."""
    rng = np.random.RandomState(int(up) % 97)
    for n, m, wide in ((50_000, 5_000, False), (3_000, 40_000, True), (1 << 18, 1 << 12, False)):
        hi = 1 << 40 if wide else 1 << 20
        t = rng.randint(0, hi, n).astype(np.int64)
        s = rng.randint(0, hi, m).astype(np.int64)
        ok_t, ok_s = rng.rand(n) > 0.01, np.ones(m, bool)
        with both_links(up, down):
            for budget in (1e-4, 1e-2, 1.0, (n + m) * link.HOST_JOIN_S_PER_ROW):
                a = join_kernel.inner_join_async(t, ok_t, s, ok_s, device="cpu", budget_s=budget)
                b = jax_join.inner_join_async(t, ok_t, s, ok_s, budget_s=budget)
                assert (a is None) == (b is None), (n, m, budget)
                if a is not None:
                    ra, rb = a.result(), b.result()
                    assert np.array_equal(ra.t_first_s, rb.t_first_s)


def test_merge_auto_mode_declines_and_stays_correct(tmp_path):
    a, b = str(tmp_path / "jax"), str(tmp_path / "torch")
    JaxWrite(JaxDeltaLog.for_table(a), "append", pa.table({
        "id": np.arange(1000, dtype=np.int64), "v": np.zeros(1000, np.int64)})).run()
    shutil.copytree(a, b, copy_function=os.link)
    src = {"id": ("int64", list(range(500, 1500))), "v": ("int64", [1] * 1000)}
    out = []
    for P, path in ((Pkg("jax"), a), (Pkg("torch"), b)):
        with both_links(6.0, 4.0, **{"delta.tpu.merge.devicePath.mode": "auto"}):
            cmd = P.merge(P.log(path), src, "t.id = s.id", [("update",)], [("insert",)],
                          source_alias="s", target_alias="t")
        assert cmd._device_join is None  # the host join
        out.append((metrics(cmd), cmd._join_path, dict(cmd._router), P.rows(P.log(path))))
    assert out[0] == out[1]
    assert out[1][0]["numTargetRowsUpdated"] == 500
    assert out[1][0]["numTargetRowsInserted"] == 500
    assert out[1][2]["reason"] == "cold-estimate"


def test_rows_from_stats_reads_numrecords(tmp_path):
    path = str(tmp_path / "stats")
    JaxWrite(JaxDeltaLog.for_table(path), "append",
             pa.table({"id": np.arange(100, dtype=np.int64)})).run()
    files = DeltaLog.for_table(path, device="cpu").update().all_files
    jfiles = JaxDeltaLog.for_table(path).update().all_files
    assert _rows_from_stats(files) == jax_rows_from_stats(jfiles) == 100
    assert _rows_from_stats([dataclasses.replace(f, stats=None) for f in files]) is None
    assert jax_rows_from_stats([dataclasses.replace(f, stats=None) for f in jfiles]) is None


def test_host_join_fallback_when_no_sentinel_room():
    info = np.iinfo(np.int64)
    t = np.array([info.min, info.min + 1, 5, info.max - 1, info.max], np.int64)
    t_ok = np.ones(5, bool)
    s = np.array([info.min, 5, 7, info.max], np.int64)
    s_ok = np.array([True, True, False, True])
    res = join_kernel.inner_join_async(t, t_ok, s, s_ok, device="cpu").result()
    ref = jax_join.inner_join_async(t, t_ok, s, s_ok).result()
    assert list(res.t_matched) == list(ref.t_matched) == [True, False, True, False, True]
    assert list(res.s_matched) == list(ref.s_matched) == [True, True, False, True]
    assert res.any_multi is ref.any_multi is False
    with both_links(6.0, 4.0):
        assert join_kernel.inner_join_async(t, t_ok, s, s_ok, device="cpu",
                                            budget_s=100.0) is None
        assert jax_join.inner_join_async(t, t_ok, s, s_ok, budget_s=100.0) is None


def test_profile_is_cached_until_reset():
    """As in the JAX package, the first profile stands until ``reset``: a
    conf change alone does not re-price."""
    with both_links(6.0, 4.0):
        p = link.profile("cpu")
    with both_links(50_000.0, 50_000.0):
        assert link.profile("cpu") is p
        link.reset()
        assert link.profile("cpu").up_mbps == 50_000.0
    assert jax_conf.get("delta.tpu.link.uploadMBps") is None
    assert conf.get("delta.tpu.link.uploadMBps") is None

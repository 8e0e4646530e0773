"""The port's router audit (``obs/router_audit``), EWMA calibrator
(``obs/calibration``) and the ``auto`` router's decisions against
``delta_tpu``'s on the CPU.

* the single-card cases of ``tests/test_router_audit.py:83-307`` through
  both packages: the record and miss logic, the ring bound, the host- and
  device-forced merge audits, the ``scan.plan`` audit, the calibrator's
  EWMA, its refusal of bad samples, the flush throttle, calibration off,
  and the calibration file round-tripping across a fresh ``DeltaLog``;
* each package reads the calibration file the other wrote;
* the ``auto`` routing matrix: the three priced sites — the scan plan, the
  MERGE join (cold, resident and the upload join's budget) and the
  residual filter — under one profile sweep on one table that
  ``delta_tpu`` wrote (each package merges its own hard-linked copy), with
  equal decisions, ``deviceEstS`` / ``hostEstS``, predictions and end
  states, and the replay of
  ``tests/test_column_cache.py::test_auto_mode_declines_on_slow_link_and_audits``.

The JAX package's constants are installed in the port first, and the same
profile is injected in both confs (``delta.tpu.link.uploadMBps`` /
``downloadMBps``); the JAX package is held to one card's pricing
(``delta.tpu.distributed.plan.enabled=false``: its test mesh has 8 CPU
devices). Calibration state goes under ``tmp_path`` only.
"""
import json
import os
import shutil

import numpy as np
import pyarrow as pa
import pytest

from delta_tpu import DeltaLog as JaxDeltaLog
from delta_tpu.commands.write import WriteIntoDelta as JaxWrite
from delta_tpu.expr.parser import parse_expression as jax_parse
from delta_tpu.obs import calibration as jax_cal
from delta_tpu.obs import router_audit as jax_audit
from delta_tpu.ops import column_cache as jax_cc
from delta_tpu.ops import pruning as jax_pruning
from delta_tpu.ops import state_cache as jax_sc
from delta_tpu.parallel import link as jax_link
from delta_tpu.utils import telemetry as jax_tel
from delta_tpu_torch import DeltaLog, DeltaTable
from delta_tpu_torch.expr.parser import parse_expression
from delta_tpu_torch.obs import calibration, router_audit
from delta_tpu_torch.obs.scan_report import last_scan_report
from delta_tpu_torch.ops import column_cache, pruning, state_cache
from delta_tpu_torch.parallel import link
from delta_tpu_torch.utils import telemetry
from delta_tpu_torch.utils.config import conf
from tests.torch_port_tables import (
    Pkg, both_confs, both_links, install_reference_constants, metrics, reset_caches,
    reset_links, write_table,
)

ALIAS = dict(source_alias="s", target_alias="t")
UP, INS = ("update",), ("insert",)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    def fresh():
        telemetry.reset_all()
        jax_tel.reset_all()
        reset_links()
        reset_caches()
        column_cache.ColumnCache.reset()
        jax_cc.ColumnCache.reset()
        state_cache.DeviceStateCache.reset()
        jax_sc.DeviceStateCache.reset()
        JaxDeltaLog.clear_cache()

    install_reference_constants(monkeypatch)
    fresh()
    yield
    fresh()


def _audit(rec):
    """An audit record without its timestamp."""
    return {k: v for k, v in rec.items() if k != "timestamp"}


def _seed(path, files=2, per=50):
    """tests/test_router_audit.py's ``_seed``, written by ``delta_tpu``."""
    log = JaxDeltaLog.for_table(path)
    rng = np.random.RandomState(5)
    for i in range(files):
        keys = np.arange(i * per, (i + 1) * per, dtype=np.int64)
        JaxWrite(log, "append", pa.table({"k": pa.array(keys),
                                          "v": pa.array(rng.rand(per))})).run()


def _source(n=30, hit_lo=10):
    rng = np.random.RandomState(9)
    keys = np.concatenate([np.arange(hit_lo, hit_lo + n // 2, dtype=np.int64),
                           np.arange(10_000, 10_000 + n - n // 2, dtype=np.int64)])
    return {"k": ("int64", keys.tolist()), "v": ("float64", rng.rand(len(keys)).tolist())}


def _copies(root, files=2, per=50):
    """One ``delta_tpu``-written table and a hard-linked copy per package."""
    base = os.path.join(root, "base")
    _seed(base, files, per)
    out = {}
    for name in ("jax", "torch"):
        out[name] = os.path.join(root, name)
        shutil.copytree(base, out[name], copy_function=os.link)
    return out


def _merge(P, path, mode, source=None, **kv):
    with both_confs(**{"delta.tpu.merge.devicePath.mode": mode,
                       "delta.tpu.deletionVectors.enabled": True,
                       "delta.tpu.merge.keyCache.enabled": mode != "off"}, **kv):
        return P.merge(P.log(path), source or _source(), "t.k = s.k", [UP], [INS], **ALIAS)


def _merge_audits(P):
    mod = jax_audit if P.jax else router_audit
    return [r for r in mod.recent_audits() if r["op"] == "merge.join"]


# -- the ledger's unit behaviour ----------------------------------------------------


def test_record_audit_miss_logic_and_stats():
    for mod, tel in ((router_audit, telemetry), (jax_audit, jax_tel)):
        a = mod.record_audit("merge.join", "/t", "host", {"host": 0.010, "device": 0.002},
                             0.005, units={"targetRows": 10})
        assert a is not None and a.miss  # device predicted 2 ms, host ran 5 ms
        b = mod.record_audit("merge.join", "/t", "host", {"host": 0.010, "device": 0.050},
                             0.005)
        assert not b.miss
        assert mod.audit_stats() == {"audits": 2, "misses": 1, "missRate": 0.5}
        assert tel.gauges("router.missRate")[("router.missRate", ())] == 0.5
        assert tel.counters("router.audits") == {"router.audits": 2}
        assert tel.counters("router.misses") == {"router.misses": 1}
        assert sum(v.count for v in tel.histograms("router.predicted_ms").values()) == 2
        assert sum(v.count for v in tel.histograms("router.actual_ms").values()) == 2
        json.dumps(mod.recent_audits())
    assert [_audit(r) for r in router_audit.recent_audits()] == \
        [_audit(r) for r in jax_audit.recent_audits()]
    assert [e.data["miss"] for e in telemetry.recent_events("delta.router.audit")] == \
        [True, False]


def test_record_audit_no_alternative_never_misses():
    for mod in (router_audit, jax_audit):
        a = mod.record_audit("merge.join", "/t", "host", {"host": 0.001}, 99.0)
        assert a is not None and not a.miss


def test_audit_ring_bounded_by_conf():
    with both_confs(**{"delta.tpu.router.auditKeep": 4}):
        for mod in (router_audit, jax_audit):
            for i in range(10):
                mod.record_audit("merge.join", "/t", "host", {"host": 1.0}, 0.5, seq=i)
    for mod in (router_audit, jax_audit):
        recent = mod.recent_audits(limit=100)
        assert [r["extra"]["seq"] for r in recent] == [6, 7, 8, 9]
        assert mod.audit_stats()["audits"] == 10


def test_telemetry_blackout_records_nothing():
    with both_confs(**{"delta.tpu.telemetry.enabled": False}):
        assert router_audit.record_audit("merge.join", "/t", "host", {"host": 1.0}, 0.5) is None
        assert jax_audit.record_audit("merge.join", "/t", "host", {"host": 1.0}, 0.5) is None
        telemetry.record_event("x", {})
    assert router_audit.recent_audits() == [] and telemetry.recent_events() == []


# -- merge audits on both pinned routes ---------------------------------------------


@pytest.mark.parametrize("mode", ["off", "force"])
def test_pinned_merge_produces_populated_audit(tmp_path, mode):
    paths = _copies(str(tmp_path))
    out = []
    for P in (Pkg("jax"), Pkg("torch")):
        cmd = _merge(P, paths[P.name], mode)
        [rec] = _merge_audits(P)
        assert rec["decision"] == cmd._join_path
        assert rec["predictedMs"]["host"] > 0 and rec["actualMs"] > 0
        assert "join_ms" in rec["extra"]["phases"]
        if mode == "force":
            assert cmd._device_join is not None
            assert rec["predictedMs"][cmd._join_path] > 0
        out.append((cmd._join_path, metrics(cmd), sorted(rec["predictedMs"]), rec["units"],
                    P.rows(P.log(paths[P.name]))))
    assert out[0] == out[1]
    assert out[0][3] == {"targetRows": 100, "sourceRows": 30, "slabRows": 100}


def test_pinned_merge_predictions_match_jax(tmp_path):
    """Under one injected profile the audit's predictions are the same
    numbers in both packages."""
    paths = _copies(str(tmp_path))
    recs = []
    with both_links(100.0, 80.0):
        for P in (Pkg("jax"), Pkg("torch")):
            _merge(P, paths[P.name], "force")
            [rec] = _merge_audits(P)
            recs.append(rec)
    assert recs[0]["predictedMs"] == recs[1]["predictedMs"]
    assert recs[0]["decision"] == recs[1]["decision"] == "device-cold"


def test_scan_plan_batch_produces_audit(tmp_path):
    path = str(tmp_path / "t")
    _seed(path, files=3)
    jsnap = JaxDeltaLog.for_table(path).update()
    tsnap = DeltaLog.for_table(path, device="cpu").update()
    q = "k >= 0 AND k <= 10"
    with both_links(100, 100):
        a = pruning.files_for_scan(tsnap, [parse_expression(q)])
        b = jax_pruning.files_for_scan(jsnap, [jax_parse(q)])
    assert [f.path for f in a.files] == [f.path for f in b.files] and a.files
    [tr] = [r for r in router_audit.recent_audits() if r["op"] == "scan.plan"]
    [jr] = [r for r in jax_audit.recent_audits() if r["op"] == "scan.plan"]
    assert tr["decision"] in ("device", "host-resident")
    assert set(tr["predictedMs"]) == {"device", "host-resident"}
    assert tr["units"]["cells"] > 0
    assert (tr["decision"], tr["predictedMs"], tr["units"]) == \
        (jr["decision"], jr["predictedMs"], jr["units"])
    # a pinned mode makes no priced decision: no audit
    reset_links()
    with both_confs(**{"delta.tpu.stateCache.devicePlan.mode": "off"}):
        pruning.files_for_scan(tsnap, [parse_expression(q)])
    assert [r for r in router_audit.recent_audits() if r["op"] == "scan.plan"] == []


# -- calibration -------------------------------------------------------------------


def _cal_conf(path, **kv):
    return both_confs(**{"delta.tpu.router.calibration.enabled": True,
                         "delta.tpu.router.calibration.statePath": path, **kv})


def test_calibrator_ewma_converges_from_synthetic_samples(tmp_path):
    default = link.HOST_JOIN_S_PER_ROW
    rate = default * 10
    states = []
    for cal, lk, name in ((calibration, link, "t"), (jax_cal, jax_link, "j")):
        with _cal_conf(str(tmp_path / f"{name}.json"),
                       **{"delta.tpu.router.calibration.alpha": 0.5,
                          "delta.tpu.router.calibration.minSamples": 3}):
            for _ in range(2):
                cal.ingest([("HOST_JOIN_S_PER_ROW", 1_000_000, rate * 1_000_000)])
            assert lk.calibrated_constants() == {}
            assert lk.constant("HOST_JOIN_S_PER_ROW") == default
            for _ in range(8):
                cal.ingest([("HOST_JOIN_S_PER_ROW", 1_000_000, rate * 1_000_000)])
            got = lk.constant("HOST_JOIN_S_PER_ROW")
            assert got == pytest.approx(rate, rel=0.01)
            cal.reset()
            assert lk.constant("HOST_JOIN_S_PER_ROW") == default
            state = cal.apply_state()
            assert state["HOST_JOIN_S_PER_ROW"]["samples"] == 10
            states.append(state)
    assert states[0] == states[1]
    assert telemetry.counters("router.calibration.updates") == \
        {"router.calibration.updates": 10}
    g = telemetry.gauges("router.calibration")
    assert g[("router.calibration", (("constant", "HOST_JOIN_S_PER_ROW"),))] == \
        link.constant("HOST_JOIN_S_PER_ROW")


def test_calibrator_rejects_garbage_samples(tmp_path):
    with _cal_conf(str(tmp_path / "c.json")):
        for cal in (calibration, jax_cal):
            assert cal.ingest([("NOT_A_CONSTANT", 10, 1.0)]) is None
            assert cal.ingest([("HOST_JOIN_S_PER_ROW", 0, 1.0)]) is None
            assert cal.ingest([("HOST_JOIN_S_PER_ROW", 10, -1.0)]) is None
            assert cal.ingest([("DIST_ITEM_S" if cal is calibration else "X", 1, 1.0)]) \
                is None
    assert link.calibrated_constants() == {} == jax_link.calibrated_constants()


def test_calibration_hot_path_flush_is_throttled(tmp_path):
    key = "HOST_PRUNE_S_PER_CELL"
    for cal, name in ((calibration, "t"), (jax_cal, "j")):
        f = str(tmp_path / f"hot-{name}.json")
        with _cal_conf(f, **{"delta.tpu.router.calibration.flushIntervalMs": 60_000}):
            cal.ingest([(key, 100, 1.0)], flush=False)
            assert cal.load_state(f)[key]["samples"] == 1
            for _ in range(5):
                cal.ingest([(key, 100, 1.0)], flush=False)
            assert cal.load_state(f)[key]["samples"] == 1
            assert cal.current_state()[key]["samples"] == 6
            cal.ingest([(key, 100, 1.0)])
            assert cal.load_state(f)[key]["samples"] == 7
            cal.ingest([(key, 100, 1.0)], flush=False)
            assert cal.load_state(f)[key]["samples"] == 7
            cal.apply_state()
            assert cal.load_state(f)[key]["samples"] == 8


def test_calibration_disabled_is_inert(tmp_path):
    state_file = tmp_path / "never.json"
    with both_confs(**{"delta.tpu.router.calibration.statePath": str(state_file)}):
        assert calibration.ingest([("HOST_JOIN_S_PER_ROW", 100, 1.0)]) is None
        assert calibration.apply_state() == {}
    with _cal_conf(str(state_file), **{"delta.tpu.telemetry.enabled": False}):
        assert calibration.ingest([("HOST_JOIN_S_PER_ROW", 100, 1.0)]) is None
    assert not state_file.exists()
    assert link.calibrated_constants() == {}


def test_host_merge_calibrates_and_round_trips_across_fresh_deltalog(tmp_path):
    paths = _copies(str(tmp_path))
    default = link.HOST_JOIN_S_PER_ROW
    P = Pkg("torch")
    with both_confs(**{"delta.tpu.router.calibration.enabled": True,
                       "delta.tpu.router.calibration.minSamples": 1}):
        _merge(P, paths["torch"], "off")
        moved = link.calibrated_constants()
        assert "HOST_JOIN_S_PER_ROW" in moved and moved["HOST_JOIN_S_PER_ROW"] != default
        log = P.log(paths["torch"])
        state_file = calibration.state_path(log.log_path)
        assert state_file == os.path.join(log.log_path, ".router_calibration.json")
        persisted = calibration.load_state(state_file)
        assert persisted["HOST_JOIN_S_PER_ROW"]["value"] == pytest.approx(
            moved["HOST_JOIN_S_PER_ROW"])
        calibration.reset()
        DeltaLog.clear_cache()
        assert link.calibrated_constants() == {}
        _merge(P, paths["torch"], "off", source=_source(20))
        assert "HOST_JOIN_S_PER_ROW" in link.calibrated_constants()
        # the JAX package resumes from the port's file on a table of its own
        jax_cal.reset()
        assert "HOST_JOIN_S_PER_ROW" in jax_cal.apply_state(log.log_path)
        assert jax_link.constant("HOST_JOIN_S_PER_ROW") == pytest.approx(
            calibration.load_state(state_file)["HOST_JOIN_S_PER_ROW"]["value"])


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_each_package_reads_the_file_the_other_wrote(tmp_path, writer):
    f = str(tmp_path / "cal.json")
    samples = [("HOST_JOIN_S_PER_ROW", 1000, 3e-4), ("DEVICE_PRUNE_S_PER_CELL", 10**9, 0.02),
               ("RESIDENT_PROBE_S_PER_ROW", 11_000_000, 0.05)]
    w, r = (calibration, jax_cal) if writer == "torch" else (jax_cal, calibration)
    wl, rl = (link, jax_link) if writer == "torch" else (jax_link, link)
    with _cal_conf(f, **{"delta.tpu.router.calibration.minSamples": 1}):
        for _ in range(3):
            w.ingest(samples)
        written = w.current_state()
        assert r.load_state(f) == written
        state = r.apply_state()
        assert state == written
        assert rl.calibrated_constants() == wl.calibrated_constants()
    raw = json.load(open(f))
    assert raw["version"] == 1 and set(raw["constants"]) == {s[0] for s in samples}


# -- the auto routing matrix ------------------------------------------------------

SWEEP = [(0.0001, 0.0001), (6.0, 4.0), (300.0, 200.0), (10_000.0, 10_000.0),
         (50_000.0, 50_000.0)]
#: the host constants' scale: 1, and 10^4 (a host that slow makes the device
#: win at these small tables; installed in both packages as calibrated
#: overrides, which every cost function reads through ``constant``)
HOST_CONSTANTS = ("HOST_JOIN_S_PER_ROW", "HOST_KEY_DECODE_S_PER_ROW", "HOST_PRUNE_S_PER_CELL",
                  "HOST_RESIDUAL_S_PER_CELL")


@pytest.fixture(params=[1.0, 1e4], ids=["host1x", "host10000x"])
def host_scale(request):
    if request.param != 1.0:
        for name in HOST_CONSTANTS:
            link.set_calibrated(name, getattr(jax_link, name) * request.param)
            jax_link.set_calibrated(name, getattr(jax_link, name) * request.param)
    return request.param


@pytest.mark.parametrize("up,down", SWEEP)
def test_plan_routing_matches_jax(tmp_path, up, down, host_scale):
    path = str(tmp_path / "t")
    write_table(path, n_files=3000)
    jsnap = JaxDeltaLog.for_table(path).update()
    tsnap = DeltaLog.for_table(path, device="cpu").update()
    je = jax_sc.DeviceStateCache.instance().get(jsnap)
    te = state_cache.DeviceStateCache.instance().get(tsnap)
    rng = np.random.RandomState(3)
    ranges = []
    for _ in range(40):
        lo = np.full(len(je.columns), np.nan)
        hi = np.full(len(je.columns), np.nan)
        i = rng.randint(je.num_rows)
        lo[0], hi[0] = je.h_lo[0, i], je.h_lo[0, i] + 500
        ranges.append((lo, hi))
    with both_links(up, down):
        for cold in (True, False):
            jp = je.plan_ranges([jax_sc.RangeSet(lo, hi) for lo, hi in ranges], k=100)
            tp = te.plan_ranges([state_cache.RangeSet(lo, hi) for lo, hi in ranges], k=100)
            assert [p.via for p in tp] == [p.via for p in jp]
            assert all(np.array_equal(a.rows, b.rows) and a.count == b.count
                       for a, b in zip(tp, jp))
            [tr] = [r for r in router_audit.recent_audits() if r["op"] == "scan.plan"]
            [jr] = [r for r in jax_audit.recent_audits() if r["op"] == "scan.plan"]
            assert tr["predictedMs"] == jr["predictedMs"] and tr["units"] == jr["units"]
            assert te._price_plan(40)[:4] == pytest.approx(je._price_plan(40)[:4], rel=1e-12)
            assert te._price_plan(40)[4:] == je._price_plan(40)[4:] == (None, 1)
            if up < 1 and host_scale == 1:
                assert tp[0].via == "host-resident"
            if up >= 10_000 and host_scale > 1:
                assert tp[0].via == "device"
            router_audit.clear_audits()
            jax_audit.clear_audits()
            te.ensure_resident()
            je.ensure_resident()


def _decisions(cmd):
    return (cmd._join_path, cmd._device_join is not None,
            {k: v for k, v in cmd._router.items() if k in ("deviceEstS", "hostEstS", "reason",
                                                           "cacheHit")})


@pytest.mark.parametrize("up,down", SWEEP)
def test_merge_routing_matches_jax(tmp_path, up, down, host_scale):
    """Cold, then resident (the slab built first), under one profile: the
    same routes, prices, reasons, metrics and end states."""
    out = {}
    with both_links(up, down):
        for P in (Pkg("jax"), Pkg("torch")):
            root = str(tmp_path / P.name)
            _seed(root + "-base", files=3, per=400)
            shutil.copytree(root + "-base", root, copy_function=os.link)
            steps = []
            cmd = _merge(P, root, "auto")  # cold: no slab yet
            steps.append((_decisions(cmd), metrics(cmd)))
            # the resident site: a slab built under the merge's signature
            # (the post-commit warmup skips tables below residentKeys.minRows)
            log = P.log(root)
            target_cols = [f.name for f in log.update().metadata.schema.fields]
            probe = P.command(log, {"k": ("int64", []), "v": ("float64", [])}, "t.k = s.k",
                              [UP], [INS], **ALIAS)
            resolved = probe._resolve(probe.condition, target_cols, ["k", "v"])
            equi, _ = probe._split_equi_keys(resolved)
            t_exprs = [t for t, _ in equi]
            assert P.key_cache().instance().get(
                log.update(), type(probe)._key_signature(t_exprs), ["k"], t_exprs) is not None
            cmd = _merge(P, root, "auto", source=_source(40, hit_lo=100))
            steps.append((_decisions(cmd), metrics(cmd)))
            steps.append(P.rows(P.log(root)))
            out[P.name] = steps
    assert out["torch"] == out["jax"]
    (cold, _), (res, _), _rows = out["torch"]
    assert "deviceEstS" in cold[2] and res[2].get("cacheHit") is True
    # the sweep's ends take each side
    if up < 1:
        assert (cold[0], res[0]) == ("host", "host")
        assert (cold[2]["reason"], res[2]["reason"]) == ("cold-estimate", "resident-estimate")
    if up >= 10_000 and host_scale > 1:
        assert (cold[0], res[0]) == ("device-cold", "resident")


@pytest.mark.parametrize("up,down", SWEEP)
def test_residual_routing_matches_jax(tmp_path, up, down, host_scale):
    """Each query cold, then warm (lanes made resident by a forced scan):
    the same decision and predictions, the report saying the decision, and
    the same rows as the host path."""
    path = str(tmp_path / "t")
    log = JaxDeltaLog.for_table(path)
    rng = np.random.RandomState(7)
    for i in range(3):
        n = 4000
        JaxWrite(log, "append", pa.table({
            "id": np.arange(i * n, (i + 1) * n, dtype=np.int64),
            "cat": pa.array(rng.choice(["alpha", "beta", "gamma"], n).tolist()),
            "x": rng.rand(n)})).run()
    from delta_tpu.api.tables import DeltaTable as JaxTable

    queries = ["cat = 'alpha'", "x > 0.5 AND id < 7000", "id * 2 + 1 > 9000"]
    seen = set()
    for warm in (False, True):
        if warm:
            with both_confs(**{"delta.tpu.read.deviceResidual.mode": "force"}):
                for q in queries:
                    DeltaTable.for_path(path, device="cpu").to_table(filters=[q])
                    JaxTable.for_path(path).to_arrow(filters=[q])
        for q in queries:
            router_audit.clear_audits()
            jax_audit.clear_audits()
            with both_links(up, down, **{"delta.tpu.read.deviceResidual.mode": "auto"}):
                got = DeltaTable.for_path(path, device="cpu").to_table(filters=[q])
                JaxDeltaLog.clear_cache()
                want = JaxTable.for_path(path).to_arrow(filters=[q])
            [tr] = [r for r in router_audit.recent_audits() if r["op"] == "scan.residual"]
            [jr] = [r for r in jax_audit.recent_audits() if r["op"] == "scan.residual"]
            assert tr["decision"] == jr["decision"], (q, warm)
            seen.add((warm, tr["decision"]))
            assert tr["predictedMs"] == jr["predictedMs"], (q, warm)
            assert last_scan_report().device_residual == tr["decision"]
            assert sorted(got.column("id").values.tolist()) == \
                sorted(want.column("id").to_pylist())
    if up >= 10_000 and host_scale > 1:
        # the scaled host key decode prices the cold lanes out; resident
        # lanes skip it and engage
        assert seen == {(False, "host"), (True, "device")}
    if up < 1:
        assert {d for _, d in seen} == {"host"}


def test_auto_mode_declines_on_slow_link_and_audits(tmp_path):
    """tests/test_column_cache.py's case through both packages."""
    path = str(tmp_path / "t")
    rng = np.random.RandomState(7)
    n = 400
    JaxWrite(JaxDeltaLog.for_table(path), "append", pa.table({
        "id": np.arange(n, dtype=np.int64),
        "cat": pa.array(rng.choice(["alpha", "beta", "gamma", None], n).tolist()),
        "x": rng.rand(n)})).run()
    from delta_tpu.api.tables import DeltaTable as JaxTable

    c0, j0 = dict(telemetry.counters()), dict(jax_tel.counters())
    with both_links(0.0001, 0.0001, **{"delta.tpu.read.deviceResidual.mode": "auto"}):
        got = DeltaTable.for_path(path, device="cpu").to_table(filters=["cat = 'alpha'"])
        want = JaxTable.for_path(path).to_arrow(filters=["cat = 'alpha'"])
    for tel, before in ((telemetry, c0), (jax_tel, j0)):
        c1 = tel.counters()
        assert c1.get("scan.device.declined", 0) == before.get("scan.device.declined", 0) + 1
        assert c1.get("scan.device.engaged", 0) == before.get("scan.device.engaged", 0)
    for mod in (router_audit, jax_audit):
        last = mod.last_audit()
        assert last is not None and last.op == "scan.residual" and last.decision == "host"
    assert router_audit.last_audit().predicted_ms == jax_audit.last_audit().predicted_ms
    assert last_scan_report().device_residual == "host"
    assert got.num_rows == want.num_rows > 0
    assert column_cache.ColumnCache.instance().resident_bytes() == 0

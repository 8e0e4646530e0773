"""Integer stats bounds beyond 2^53 in the port's lanes against ``delta_tpu``'s.

A float64 lane holds integers exactly up to 2^53, and -2^63. Both packages
drop any other integer bound beyond 2^53 (a missing bound keeps the file).
The JAX package's Arrow lanes keep -2^63 (``np.abs`` of INT64_MIN
overflows to a negative), on the JSON path and on the typed
``stats_parsed`` path alike; its per-file path (``files_to_arrays``, which
takes Python's ``abs``) drops it. The port gives the same lanes on each
path, so a file whose column is all INT64_MIN prunes the same way whether
its stats come from JSON commits or from a checkpoint.

The table: one file with ``x`` all at the bound, one with ``x`` in [1, 7],
JSON commits only, then after a checkpoint written by either package.
"""
import numpy as np
import pyarrow as pa
import pytest

import delta_tpu
import delta_tpu_torch
from delta_tpu.expr.parser import parse_predicate as jax_parse
from delta_tpu.ops import pruning as jax_pruning
from delta_tpu.ops import state_export as jax_export
from delta_tpu_torch.expr.parser import parse_predicate as torch_parse
from delta_tpu_torch.ops import pruning as torch_pruning
from delta_tpu_torch.ops import state_export as torch_export
from delta_tpu_torch.ops.state_cache import DeviceStateCache
from tests.torch_dml_tables import append, create
from tests.torch_port_tables import both_confs, reset_caches

I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1
BOUNDS = [I64_MIN, I64_MIN + 1, -(1 << 53) - 1, -(1 << 53), (1 << 53) + 1, I64_MAX]
QUERIES = ["x = 5", "x < 0", "x >= 0", "x > 100", "x <= -100", "x >= 1 AND x <= 7"]


@pytest.fixture(autouse=True)
def _fresh():
    reset_caches()
    DeviceStateCache.reset()
    yield
    reset_caches()
    DeviceStateCache.reset()


def _table(path, bound, checkpoint):
    create(path, pa.table({"x": pa.array([bound] * 3, pa.int64())}))
    append(path, pa.table({"x": pa.array([1, 7], pa.int64())}))
    if checkpoint == "jax":
        delta_tpu.DeltaLog.for_table(path).checkpoint()
    elif checkpoint == "torch":
        delta_tpu_torch.DeltaLog.for_table(path, device="cpu").checkpoint()
    delta_tpu.DeltaLog.clear_cache()
    reset_caches()
    return (delta_tpu.DeltaLog.for_table(path).update(),
            delta_tpu_torch.DeltaLog.for_table(path, device="cpu").update())


def _by_path(arr, lanes):
    order = np.argsort(np.asarray(arr.paths, object))
    return {k: v[order] for k, v in lanes.items()}


@pytest.mark.parametrize("checkpoint", [None, "jax", "torch"])
@pytest.mark.parametrize("bound", BOUNDS)
def test_lanes_match_jax(tmp_path, bound, checkpoint):
    js, ts = _table(str(tmp_path / "t"), bound, checkpoint)
    assert (ts.segment.checkpoint_version is not None) == (checkpoint is not None)
    ja = jax_export.arrays_from_columns(js._columnar, js._alive_mask, js.metadata)
    ta = torch_export.arrays_from_columns(ts._columnar, ts._alive_mask, ts.metadata)
    jf = jax_export.files_to_arrays(js.all_files, js.metadata)
    tf = torch_export.files_to_arrays(ts.all_files, ts.metadata)
    for j, t in ((ja, ta), (jf, tf)):
        for lanes in ("stats_min", "stats_max"):
            want, got = _by_path(j, getattr(j, lanes)), _by_path(t, getattr(t, lanes))
            assert np.array_equal(got["x"], want["x"], equal_nan=True), (lanes, got, want)
    kept = bound == I64_MIN or abs(bound) <= 1 << 53
    assert (sorted(ta.stats_min["x"])[0] == bound) == kept


@pytest.mark.parametrize("leg", ["force", "off"])
@pytest.mark.parametrize("checkpoint", [None, "jax", "torch"])
@pytest.mark.parametrize("bound", BOUNDS)
def test_files_for_scan_matches_jax(tmp_path, bound, checkpoint, leg):
    """``files_for_scan`` over the resident lanes: K1 under
    ``devicePlan.mode=force``, the float64 mirrors under ``off``."""
    js, ts = _table(str(tmp_path / "t"), bound, checkpoint)
    got, want = [], []
    with both_confs(**{"delta.tpu.stateCache.devicePlan.mode": leg}):
        for q in QUERIES + [f"x = {bound}"]:
            want.append(sorted(f.path for f in jax_pruning.files_for_scan(
                js, [jax_parse(q)]).files))
            got.append(sorted(f.path for f in torch_pruning.files_for_scan(
                ts, [torch_parse(q)]).files))
    assert got == want
    if bound == I64_MIN:
        assert len(got[0]) == 1  # queue C's case: the all-INT64_MIN file prunes


@pytest.mark.parametrize("leg", ["host", "k15"])
@pytest.mark.parametrize("bound", BOUNDS)
def test_the_normal_leg_matches_jax(tmp_path, monkeypatch, bound, leg):
    """The leg a declined predicate takes, ``prune_files`` over every
    AddFile: the host evaluator, or the skipping interpreter K15 over the
    per-file lanes (``files_to_arrays``, where both packages drop -2^63)."""
    js, ts = _table(str(tmp_path / "t"), bound, None)
    min_files = 1 if leg == "k15" else 1 << 20
    monkeypatch.setattr(torch_pruning, "DEVICE_PRUNING_MIN_FILES", min_files)
    got, want = [], []
    with both_confs(**{"delta.tpu.device.pruning.minFiles": min_files}):
        for q in QUERIES + [f"x = {bound}"]:
            want.append(sorted(f.path for f in jax_pruning.prune_files(
                js.all_files, js.metadata, [jax_parse(q)])))
            got.append(sorted(f.path for f in torch_pruning.prune_files(
                ts.all_files, ts.metadata, [torch_parse(q)], device="cpu")))
    assert got == want

"""The sharded table-state pipeline over a state mesh: the port's counterpart
of ``__graft_entry__.dryrun_multichip`` (``__graft_entry__.py:67``).

    from delta_tpu_torch.multichip import dryrun_multichip
    from delta_tpu_torch.parallel import mesh

    with mesh.using_devices(["cuda:0"] * 8):   # eight shards on one card
        report = dryrun_multichip(8)

:func:`dryrun_multichip` runs the stages of the JAX package's, each with
its assertions, over the first ``n_devices`` entries of the default mesh
(``parallel/mesh.default_devices(device)``):

1. the sharded replay (K6) of the example action stream;
2. the skip step ``size > 1000`` over the live files' sizes: the K15
   interpreter on each shard's slice, then the kept counts reduced on the
   lead device by the combine kernel;
3. the MERGE join probe through ``inner_join_async(mesh=)`` (K13) at 2^20
   target keys against a zipf-skewed source whose first and last keys are
   both 5, so the multi-match flag must fire;
4. the host partition (``parallel/distributed.host_shard_indices``) tiling
   a work list;
5. the sharded replay (K6) of the ``zipf-100k`` and ``empty-shards``
   streams against a host oracle;
6. the sharded plan (K7) at 6000 files, one card's plan and the sharded
   one each equal to the host plan, with their walls.

The reference's stage 7, OPTIMIZE on 4 workers of the distributed
executor, waits for the multi-host slice (the executor is not ported), so
the returned dict has no ``optimize_workers``, ``optimize_wall_s`` or
``per_shard_busy_s``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

__all__ = ["dryrun_multichip", "example_stream", "zipf_stream"]


def example_stream(n_paths: int = 64, n_versions: int = 12, per_commit: int = 8):
    """``__graft_entry__._example_stream``: a random add/remove stream."""
    from delta_tpu_torch.ops import state_export
    from delta_tpu_torch.protocol.actions import AddFile, RemoveFile

    rng = np.random.RandomState(0)
    versioned = []
    for v in range(n_versions):
        actions = []
        for _ in range(per_commit):
            p = f"part-{rng.randint(n_paths):05d}.parquet"
            if rng.rand() < 0.8:
                actions.append(AddFile(path=p, partition_values={},
                                       size=int(rng.randint(1, 1 << 20)),
                                       modification_time=v, data_change=True))
            else:
                actions.append(RemoveFile(path=p, deletion_timestamp=v * 1000,
                                          data_change=True))
        versioned.append((v, actions))
    return state_export.actions_to_arrays(versioned)


def zipf_stream(n_actions: int, n_paths: int, seed: int):
    """The skew stages' stream (``__graft_entry__.py:205-227``): zipf paths,
    70% adds, commits of 1000 actions."""
    from delta_tpu_torch.ops import state_export
    from delta_tpu_torch.protocol.actions import AddFile, RemoveFile

    zrng = np.random.RandomState(seed)
    ranks = np.arange(1, n_paths + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    pids = zrng.choice(n_paths, n_actions, p=probs)
    adds = zrng.rand(n_actions) < 0.7
    per_commit = 1000
    versioned = []
    for v in range(0, n_actions, per_commit):
        actions = []
        for i in range(v, min(v + per_commit, n_actions)):
            p = f"part-{pids[i]:06d}.parquet"
            if adds[i]:
                actions.append(AddFile(path=p, partition_values={}, size=int(i % 977 + 1),
                                       modification_time=v, data_change=True))
            else:
                actions.append(RemoveFile(path=p, deletion_timestamp=v + 1, data_change=True))
        versioned.append((v // per_commit, actions))
    return state_export.actions_to_arrays(versioned)


def _zipf_source(cap: int, n_devices: int) -> np.ndarray:
    rng = np.random.RandomState(1)
    zranks = np.arange(1, cap * 2 + 1, dtype=np.float64)
    zprobs = 1.0 / zranks
    zprobs /= zprobs.sum()
    s_keys = rng.choice(cap * 2, max(cap // 8, 3 * n_devices), p=zprobs).astype(np.int64)
    # one duplicated key in the target's range: the multi flag must fire
    s_keys[0] = 5
    s_keys[-1] = 5
    return s_keys


def _skip_step(mesh, sizes: np.ndarray, valid: np.ndarray) -> int:
    """``size > 1000`` through K15 on each shard's slice, the kept counts
    reduced on the lead device."""
    from delta_tpu_torch.expr.device_eval import DeviceColumn, compile_expr
    from delta_tpu_torch.expr.parser import parse_predicate
    from delta_tpu_torch.parallel import mesh as mesh_mod

    pred_fn = compile_expr(parse_predicate("size > 1000"))
    per = len(sizes) // len(mesh)

    def launch(i, dev):
        sz = DeviceColumn.of(sizes[i * per:(i + 1) * per], device=dev)
        ok = torch.from_numpy(valid[i * per:(i + 1) * per]).to(dev)
        col = pred_fn({"size": DeviceColumn(sz.values, ok)})
        return torch.count_nonzero(col.values & col.valid & ok).reshape(1).to(torch.int64)

    counts = mesh_mod.run_shards(mesh, launch)
    return int(mesh_mod.psum(counts, "sum").cpu()[0])


def _require(cond, what) -> None:
    """The stages' assertions; they raise under ``python -O`` too."""
    if not cond:
        raise AssertionError(what)


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Run the sharded table-state pipeline over ``n_devices`` mesh entries
    (see the module docstring); raises on any failed assertion. Returns the
    reference's report keys, less those of the OPTIMIZE stage."""
    from delta_tpu_torch.expr.parser import parse_expression
    from delta_tpu_torch.ops import join_kernel, pruning, replay_kernel
    from delta_tpu_torch.ops.state_cache import ResidentState, extract_ranges
    from delta_tpu_torch.parallel.distributed import host_shard_indices
    from delta_tpu_torch.parallel.mesh import state_mesh, using_devices
    from delta_tpu_torch.utils.config import conf

    mesh = state_mesh(n_devices, device=device)
    if len(mesh) < n_devices:
        raise RuntimeError(f"need {n_devices} mesh entries, have {len(mesh)}")

    # stage 1: the sharded replay (K6)
    arrays = example_stream(n_paths=8 * n_devices, n_versions=10, per_commit=2 * n_devices)
    result = replay_kernel.replay_sharded(arrays, mesh, min_retention_ts=0)
    n_alive = int(result.stats.num_files)
    _require(n_alive > 0, "no live file after the replay")

    # stage 2: the skip step over the live files' sizes, sharded (K15)
    cap = ((n_alive + n_devices - 1) // n_devices) * n_devices
    sizes = np.zeros(cap, np.int32)
    alive_sizes = np.asarray(arrays.size)[result.alive]
    sizes[: len(alive_sizes)] = alive_sizes
    valid = np.zeros(cap, bool)
    valid[: len(alive_sizes)] = True
    kept = _skip_step(mesh, sizes, valid)
    _require(0 <= kept <= n_alive, f"kept {kept} of {n_alive}")
    _require(kept == int(((sizes > 1000) & valid).sum()), "sharded skip step != host count")

    # stage 3: the MERGE join probe over the mesh (K13), zipf source
    cap = max(1 << 20, 16 * n_devices)
    t_keys = np.arange(cap, dtype=np.int64)
    s_keys = _zipf_source(cap, n_devices)
    t_join = time.perf_counter()
    res = join_kernel.inner_join_async(t_keys, np.ones(cap, bool), s_keys,
                                       np.ones(len(s_keys), bool), mesh=mesh,
                                       device=device).result()
    join_s = time.perf_counter() - t_join
    t_matched = res.t_matched
    _require(np.array_equal(t_matched, np.isin(t_keys, s_keys)),
             "sharded join probe mismatch")
    _require(np.array_equal(res.s_matched, np.isin(s_keys, t_keys)), "reverse probe mismatch")
    _require(bool(res.any_multi), "the multi-match reduction failed to fire")

    # stage 4: the host partition tiles the work list
    n_hosts = max(n_devices // 4, 2)
    work = [f"file-{i:03d}" for i in range(4 * n_devices + 3)]
    assignment = {h: host_shard_indices(len(work), h, n_hosts) for h in range(n_hosts)}
    flat = sorted(i for idx in assignment.values() for i in idx)
    _require(flat == list(range(len(work))), "host partitions must tile the work")
    per_host = {h: len(ix) for h, ix in assignment.items()}
    _require(max(per_host.values()) - min(per_host.values()) <= 1, f"uneven: {per_host}")

    # stage 5: skewed replays (K6) against the host oracle
    for label, n_actions, n_paths in (("zipf-100k", 100_000, 1_000),
                                      ("empty-shards", 512, max(n_devices // 4, 1))):
        arr = zipf_stream(n_actions, n_paths, seed=11 + n_paths)
        sharded = replay_kernel.replay_sharded(arr, mesh, min_retention_ts=0)
        last = np.full(len(arr.paths), -1, np.int64)
        last[np.asarray(arr.path_id)] = np.arange(arr.num_rows)
        oracle = np.zeros(arr.num_rows, bool)
        oracle[last[last >= 0]] = True
        oracle &= np.asarray(arr.is_add)
        _require(np.array_equal(sharded.alive, oracle), f"skew parity failed: {label}")
        _require(int(sharded.stats.num_files) == int(oracle.sum()), label)

    # stage 6: the sharded plan (K7), identity with the host planner
    n_files = 6000  # capacity 8192: the lanes split into whole 1024-file blocks
    prng = np.random.RandomState(6)
    plo = prng.rand(2, n_files) * 1000.0
    phi = plo + prng.rand(2, n_files) * 50.0
    pstate = ResidentState("multichip://plan", "mid", 0, ["a", "b"],
                           [f"f{i}" for i in range(n_files)],
                           {"min": plo, "max": phi, "size": np.ones(n_files, np.int64)},
                           torch.device(mesh[0]))
    qranges = []
    for i in range(64):
        c = "ab"[i % 2]
        a0 = (i * 37) % 950
        qranges.append(extract_ranges(pruning.skipping_predicate(
            parse_expression(f"{c} >= {a0} AND {c} <= {a0 + 40}"), frozenset()), ["a", "b"]))
    host_plans = pstate.plan_ranges(qranges, k=n_files, use_device=False)

    def plan_leg(enabled):
        pstate.drop_device()  # the residency decides the shards: re-place
        with conf.set_temporarily(**{"delta.tpu.distributed.plan.enabled": enabled,
                                     "delta.tpu.distributed.plan.mode": "force",
                                     "delta.tpu.stateCache.devicePlan.mode": "force"}):
            plans = pstate.plan_ranges(qranges, k=n_files, use_device=True)
            shards = pstate.resident_shards
            t0 = time.perf_counter()
            for _ in range(3):
                plans = pstate.plan_ranges(qranges, k=n_files, use_device=True)
            wall = (time.perf_counter() - t0) / 3
        for hp, dp in zip(host_plans, plans):
            _require(list(dp.rows) == list(hp.rows), "sharded plan != host")
        return wall, shards

    with using_devices(mesh):  # the residency takes its shards from the default mesh
        plan_single_s, one_shard = plan_leg(False)
        plan_sharded_s, plan_shards = plan_leg(True)
    _require(one_shard == 1, f"one card's leg on {one_shard} shards")
    _require(plan_shards >= min(n_devices, 2), f"the plan on {plan_shards} shards")
    plan_eff = plan_single_s / max(plan_sharded_s * plan_shards, 1e-12)
    return {
        "dryrun": False,
        "n_devices": n_devices,
        "n_actions": arrays.num_rows,
        "n_alive": n_alive,
        "kept": kept,
        "join_keys": cap,
        "join_matched": int(t_matched.sum()),
        "join_s": round(join_s, 3),
        "plan_shards": plan_shards,
        "plan_single_ms": round(plan_single_s * 1e3, 2),
        "plan_sharded_ms": round(plan_sharded_s * 1e3, 2),
        "plan_efficiency": round(plan_eff, 4),
        "host_partition": per_host,
    }


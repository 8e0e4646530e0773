#!/usr/bin/env python3
"""Time the PyTorch port's block cull (K1), slab sort (K8), upload join
(K12), sharded join (K13) and residual mask (K14) on one card, on seeded
inputs, for the ``delta_tpu_torch`` package under ``--root`` (default: this
checkout).

    python3 tools/kernel_ab.py [--root DIR] [--only k1,k8,k12,k13,k14,k15,l2]

Run it on two checkouts in one call on one card (A, B, B, A) to compare two
versions of the kernels. Each line printed is one JSON object: the kernel,
its inputs, the device time of one call (CUDA events around back-to-back
calls, as ``chip_smoke.py`` times every kernel; where the call can be
captured, also replayed from a CUDA graph, which leaves out the host's
Python and launch overhead), the device time per call of each CUDA kernel
it launches (``torch.profiler``) and the card's name. The timing helpers
are ``chip_smoke.py``'s. Exits non-zero without a CUDA device.

Inputs (seed 13), K1 on 2^20 files with 4 float32 stat lanes (1,000,000
live, 2% of them dead) and 256 point-range queries bounding the first two
columns, in three layouts of the lanes:

* ``clustered``: bench config 6's shape, each column sorted along the file
  axis and each file a narrow range, so a warp's files form a narrow box;
* ``shuffled``: the same files in a random order: each file still narrow,
  but a warp's box spans the whole domain, so every query is compared with
  every file's column 0, and few queries keep any block;
* ``random``: ``chip_smoke.k7_lanes`` (random narrow files, 2% NaN lanes,
  30% NaN bounds), where most queries keep most blocks;

each at M=256, at one query (M=1) and at one query with 7 NaN rows (M=8,
the query axis padded as the JAX package pads it). K8 on bench config 2's
slab (10,301,000 keys drawn as ``_store_sales``'s ``ss_item_sk`` in a
capacity of 10,485,760). K12 on M3's shape (11,000,000 int32 target keys
padded to 12,582,912, 1,000,000 source keys padded to 2^20) and K13 on M4's
(12,500,000 target keys padded to 16,777,216 in 8 slabs of one card, the
same source), each in four traffics: ``half`` (half the source present,
some twice), ``dups`` (one source key 100,000 times, in 1% of the
targets), ``miss`` (no target key in the source) and ``hit`` (every target
key in the source). K14 on bench config 12's arith query over its 8 files
(250,000 rows each, ``price`` and ``qty`` int64 lanes padded to 2^18),
and ``price IN`` 200 values over the same files (past the launch's
parameters): the query's masks (one launch over the files where the package
has ``column_cache.residual_masks``, else one launch a file), the per-file
call, and the masks' download. K15 (the expression interpreter, which
shares the residual mask's header) on ``K15_PROGRAMS`` over
``chip_smoke.k15_columns`` at 1,005,000 rows. ``l2`` times a random gather of 16,777,216
int64 from a 16 MB table (one L2 sector a read): the rate the join's
probes are held to.
"""
import argparse
import importlib.util
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def k1_workloads(torch, dev, state_cache, chip_smoke):
    """(name, mins, maxs, alive, lo, hi) on the card; lo/hi (256, 4) f32."""
    rng = np.random.RandomState(13)
    n_files, c, live = 1 << 20, 4, 1_000_000
    base = np.sort(rng.rand(c, n_files) * 1e6, axis=1)
    width = 1e6 / live * 8
    mins = state_cache._f32_down(base).astype(np.float32)
    maxs = state_cache._f32_up(base + width).astype(np.float32)
    alive = np.zeros(n_files, bool)
    alive[:live] = rng.rand(live) > 0.02
    pick = rng.randint(0, live, 256)
    lo = np.full((256, c), np.nan, np.float32)
    hi = np.full((256, c), np.nan, np.float32)
    lo[:, :2] = state_cache._f32_down(base[:2, pick].T)
    hi[:, :2] = state_cache._f32_up(base[:2, pick].T + width)
    perm = np.concatenate([rng.permutation(live), np.arange(live, n_files)])
    on = lambda *a: [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in a]
    return [("clustered", *on(mins, maxs, alive, lo, hi)),
            ("shuffled", *on(mins[:, perm], maxs[:, perm], alive[perm], lo, hi)),
            ("random", *chip_smoke.k7_lanes(dev))]


#: K15 programs over ``chip_smoke.k15_columns``: Kleene logic, int and
#: float arithmetic, an IN, a CASE, a transcendental
K15_PROGRAMS = ["a > 2 AND (b < 20 OR flag)", "g * g - g", "a IN (b, 3, NULL)",
                "CASE WHEN flag THEN b ELSE g END", "exp(b)", "big * big"]


def join_traffic(rng, cap_t, n, cap_s, m, traffic):
    """Padded int32 join inputs as ``inner_join_async`` builds them (the
    target's sentinel at the top of the range, the source's one below)."""
    hi = 1 << 30
    if traffic == "half":
        t = rng.randint(0, hi, n)
        s = np.concatenate([t[rng.randint(0, n, m - m // 2)], rng.randint(0, hi, m // 2)])
    elif traffic == "dups":
        t = rng.randint(0, hi, n)
        s = np.concatenate([np.full(100_000, 12345), t[rng.randint(0, n, (m - 100_000) // 2)],
                            rng.randint(0, hi, m - 100_000 - (m - 100_000) // 2)])
        t[rng.rand(n) < 0.01] = 12345
    elif traffic == "miss":
        t = rng.randint(0, hi // 2, n) * 2
        s = rng.randint(0, hi // 2, m) * 2 + 1
    else:  # hit
        s = rng.randint(0, hi, m)
        t = s[rng.randint(0, m, n)]
    s = s[rng.permutation(m)]
    t_in = np.full(cap_t, np.iinfo(np.int32).max, np.int32)
    t_in[:n] = t
    s_in = np.full(cap_s, np.iinfo(np.int32).max - 1, np.int32)
    s_in[:m] = s
    return t_in, s_in


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--only", default="k1,k8,k12,k13,k14,k15,l2")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    only = set(args.only.split(","))
    sys.path.insert(0, root)  # the package under --root
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device is visible", file=sys.stderr)
        return 2
    # this checkout's chip_smoke, whatever --root holds
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    cuda_ms, graph_ms, kernel_breakdown = (chip_smoke.cuda_ms, chip_smoke.graph_ms,
                                           chip_smoke.kernel_breakdown)
    from delta_tpu_torch.ops import column_cache, join_kernel, key_cache, native, state_cache

    card = torch.cuda.get_device_name(0)
    dev = torch.device("cuda")
    native.build_all()
    # the residual and join redesign brought the batched K14 entry; its calls
    # can be captured in a CUDA graph, the earlier ones (a blocking upload, a
    # host read-back inside the sort) cannot
    capturable = hasattr(column_cache, "residual_masks")

    def emit(kernel, **fields):
        print(json.dumps({"root": root, "kernel": kernel, "card": card, **fields}), flush=True)

    def launched(fn):
        before = dict(native.launches)
        fn()
        return {k: v - before[k] for k, v in native.launches.items() if v != before[k]}

    def host_us(fn, reps=50):
        """Host time to issue one call (no synchronisation inside)."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / reps * 1e6

    if "k1" in only:
        for name, mins, maxs, alive, lo, hi in k1_workloads(torch, dev, state_cache, chip_smoke):
            nan_rows = torch.full((7, lo.shape[1]), float("nan"), device=dev)
            for m, lt, ht in ((256, lo, hi), (1, lo[:1], hi[:1]),
                              (8, torch.cat([lo[:1], nan_rows]), torch.cat([hi[:1], nan_rows]))):
                a = (mins, maxs, alive, lt.contiguous(), ht.contiguous())
                got = state_cache.block_cull(*a)
                if not torch.equal(got, state_cache.block_cull_plain(*a)):
                    raise SystemExit(f"kernel_ab: block_cull != its plain version ({name}, M={m})")
                b, _ = chip_smoke.bound(chip_smoke.cull_bytes(*a, got.numel()))
                emit("block_cull", lanes=name, M=m, bound_ms=b,
                     ms=cuda_ms(lambda: state_cache.block_cull(*a), 200),
                     graph_ms=graph_ms(lambda: state_cache.block_cull(*a), 50),
                     breakdown_us=kernel_breakdown(lambda: state_cache.block_cull(*a)))

    rng = np.random.RandomState(13)
    if "k8" in only:
        n, cap = 10_301_000, 10_485_760
        keys = np.full(cap, 0, np.int64)
        keys[:n] = rng.permutation(2 * n)[:n]
        k = torch.from_numpy(keys).to(dev)
        v = torch.from_numpy(rng.rand(cap) > 0.01).to(dev)
        got = key_cache.slab_sort(k, v, n)
        if not all(torch.equal(a, b) for a, b in zip(got, key_cache.slab_sort_plain(k, v, n))):
            raise SystemExit("kernel_ab: slab_sort != its plain version")
        enc = torch.where(torch.arange(cap, device=dev) < n, k, torch.full_like(k, (1 << 63) - 1))
        emit("slab_sort", shape=f"cap={cap} n={n}",
             ms=cuda_ms(lambda: key_cache.slab_sort(k, v, n), 20),
             library_ms=cuda_ms(lambda: torch.sort(enc, stable=True), 20),
             breakdown_us=kernel_breakdown(lambda: key_cache.slab_sort(k, v, n)))
        del k, v, enc, got

    joins = [("join_probe", 12_582_912, 11_000_000, 1), ("sharded_join_probe", 16_777_216,
                                                         12_500_000, 8)]
    for kernel, cap_t, n, shards in joins:
        if ("k12" if shards == 1 else "k13") not in only:
            continue
        for traffic in ("half", "dups", "miss", "hit"):
            t_np, s_np = join_traffic(np.random.RandomState(13), cap_t, n, 1 << 20, 1_000_000,
                                      traffic)
            t, s = torch.from_numpy(t_np).to(dev), torch.from_numpy(s_np).to(dev)
            if shards == 1:
                fn = lambda: join_kernel.join_probe(t, s)
                ref = join_kernel.join_probe_plain(t, s)
            else:
                t_sl, s_pc = list(t.view(shards, -1)), list(s.view(shards, -1))
                fn = lambda: join_kernel.sharded_join_probe(t_sl, s_pc)
                ref = join_kernel.sharded_join_probe_plain(t_sl, s)
            got = fn()
            if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                raise SystemExit(f"kernel_ab: {kernel} != its plain version ({traffic})")
            sorted_s = torch.sort(s).values
            b, _ = chip_smoke.bound(4 * (cap_t + (1 << 20)) + cap_t // 8 + (1 << 17) + 1)
            row = dict(shape=f"cap_t={cap_t} cap_s=2^20 int32 over {shards} slab(s)",
                       traffic=traffic, bound_ms=b, launches=launched(fn),
                       ms=cuda_ms(fn, 20),
                       library_ms=cuda_ms(lambda: torch.searchsorted(sorted_s, t), 20),
                       breakdown_us=kernel_breakdown(fn))
            if capturable:
                row["graph_ms"] = graph_ms(fn, 10)
            emit(kernel, **row)
            del t, s, sorted_s, got, ref
            torch.cuda.empty_cache()

    if "k14" in only:
        from delta_tpu_torch.expr.device_eval import DeviceColumn
        from delta_tpu_torch.schema.types import LongType

        files, rows, cap = 8, 250_000, 1 << 18
        data = chip_smoke.config12_data(files * rows)
        envs = []
        for f in range(files):
            env = {}
            for c in ("price", "qty"):
                pv = np.zeros(cap, np.int64)
                pv[:rows] = data[c][f * rows:(f + 1) * rows]
                ok = np.zeros(cap, bool)
                ok[:rows] = True
                env[c] = DeviceColumn(torch.from_numpy(pv).to(dev), torch.from_numpy(ok).to(dev))
            envs.append(env)
        # config 12's arith query, and an IN of 200 options (past the
        # launch's parameters: the staged tables where the package has them)
        for sql in (f"price * 2 + qty > {int(1.8 * files * rows)}",
                    "price IN (%s)" % ", ".join(str(v) for v in range(0, 2_000_000, 10_000))):
            program, scalars = chip_smoke.k14_program(sql, envs[0], {}, {"price": LongType(),
                                                                         "qty": LongType()})
            ns = [rows] * files
            refs = [column_cache.residual_mask_plain(program, e, rows, scalars) for e in envs]
            staged = capturable and (column_cache._k14_layout(program, files)
                                     is not column_cache._K14_PARAMS)
            if capturable:
                query = lambda: column_cache.residual_masks(program, envs, ns, [scalars] * files)
                buf, offs = query()
                got = [buf[o:o + rows] for o in offs]
                host = torch.empty(buf.shape, dtype=torch.bool, pin_memory=True)
                download = lambda: host.copy_(buf, non_blocking=True)
            else:
                query = lambda: [column_cache.residual_mask(program, e, rows, scalars)
                                 for e in envs]
                got = query()
                download = lambda: [m.cpu() for m in got]
            if not all(torch.equal(g, r) for g, r in zip(got, refs)):
                raise SystemExit(f"kernel_ab: residual_mask != its plain version: {sql}")
            per_file = lambda: column_cache.residual_mask(program, envs[0], rows, scalars)
            n_cols = len(program.columns)
            b, _ = chip_smoke.bound(files * rows * (n_cols * (8 + 1) + 1))
            row = dict(shape=f"{files} files x {rows} rows, cap={cap}, {len(program.instrs)} "
                             f"instructions over {n_cols} int64 lanes ({sql[:60]})",
                       bound_ms=b, launches=launched(query), staged=staged,
                       ms=cuda_ms(query, 50), host_us=host_us(query),
                       breakdown_us=kernel_breakdown(query),
                       per_file_ms=cuda_ms(per_file, 100), per_file_host_us=host_us(per_file),
                       per_file_breakdown_us=kernel_breakdown(per_file),
                       download_ms=cuda_ms(download, 20))
            if capturable and not staged:
                # a staged block's pinned copy is made per call: not capturable
                row["graph_ms"] = graph_ms(query, 20)
                row["per_file_graph_ms"] = graph_ms(per_file, 20)
            emit("residual_mask", **row)

    if "k15" in only:
        from delta_tpu_torch.expr import device_eval
        from delta_tpu_torch.expr.parser import parse_expression

        env = chip_smoke.k15_columns(1_005_000, 3, dev)
        for sql in K15_PROGRAMS:
            program = device_eval.compile_expr(parse_expression(sql)).program(env)
            fn = lambda: device_eval.expr_eval(program, env)
            emit("expr_eval", shape=f"n=1005000 {len(program.instrs)} instructions ({sql})",
                 ms=cuda_ms(fn, 50), breakdown_us=kernel_breakdown(fn))

    if "l2" in only:
        table = torch.randint(0, 1 << 62, (1 << 21,), dtype=torch.int64, device=dev)
        idx = torch.randint(0, 1 << 21, (16_777_216,), dtype=torch.int64, device=dev)
        ms = cuda_ms(lambda: torch.take(table, idx), 20)
        emit("l2_gather", shape="16,777,216 random int64 reads from a 16 MB table", ms=ms,
             sectors_per_s=16_777_216 / (ms / 1e3))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time the PyTorch port's block cull (K1), slab sort (K8) and upload join
(K12) on one card, on seeded inputs, for the ``delta_tpu_torch`` package
under ``--root`` (default: this checkout).

    python3 tools/kernel_ab.py [--root DIR]

Run it on two checkouts in one call on one card (A, B, B, A) to compare two
versions of the kernels. Each line printed is one JSON object: the kernel,
its inputs, the device time of one call (CUDA events around back-to-back
calls, as ``chip_smoke.py`` times every kernel; for K1 also replayed from a
CUDA graph, which leaves out the host's Python and launch overhead), the
device time per call of each CUDA kernel it launches (``torch.profiler``)
and the card's name. The timing helpers are ``chip_smoke.py``'s. Exits
non-zero without a CUDA device.

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
capacity of 10,485,760); K12 on M3's shape (11,000,000 int32 target keys
padded to 12,582,912, 1,000,000 source keys padded to 2^20, half present).
"""
import argparse
import importlib.util
import json
import os
import sys

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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
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
    from delta_tpu_torch.ops import join_kernel, key_cache, native, state_cache

    card = torch.cuda.get_device_name(0)
    dev = torch.device("cuda")
    native.build_all()

    def emit(kernel, **fields):
        print(json.dumps({"root": root, "kernel": kernel, "card": card, **fields}), flush=True)

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

    cap_t, cap_s = 12_582_912, 1 << 20
    t_np = np.full(cap_t, np.iinfo(np.int32).max, np.int32)
    t_np[:11_000_000] = rng.randint(0, 1 << 30, 11_000_000)
    s_np = np.full(cap_s, np.iinfo(np.int32).max - 1, np.int32)
    s_np[:1_000_000] = np.concatenate([t_np[rng.randint(0, 11_000_000, 500_000)],
                                       rng.randint(0, 1 << 30, 500_000)])
    t, s = torch.from_numpy(t_np).to(dev), torch.from_numpy(s_np).to(dev)
    got = join_kernel.join_probe(t, s)
    if not all(torch.equal(a, b) for a, b in zip(got, join_kernel.join_probe_plain(t, s))):
        raise SystemExit("kernel_ab: join_probe != its plain version")
    emit("join_probe", shape=f"cap_t={cap_t} cap_s={cap_s} int32",
         ms=cuda_ms(lambda: join_kernel.join_probe(t, s), 20))
    return 0


if __name__ == "__main__":
    sys.exit(main())

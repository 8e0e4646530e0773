#!/usr/bin/env python3
"""Time the PyTorch port's block cull (K1), tail scatters (K2, and the tail
apply with K3), winner bits (K4), replay (K5), sharded replay (K6), sharded
block cull (K7), slab sort (K8), slab probe (K9), pair compaction (K10), slab
updates and advances (K11), upload join (K12), sharded join (K13), residual
mask (K14), expression interpreter (K15), Morton interleave (K16) with
``morton_order``'s sorts, link probe (K17) and cross-shard combine on one
card, and the page codec (``snappy_compress``, ``snappy_decompress``), on
seeded inputs, for the ``delta_tpu_torch`` package under ``--root``
(default: this checkout).

    python3 tools/kernel_ab.py [--root DIR]
        [--only k1,k2,k3,k4,k5,k6,k7,k8,k9,k10,k11,k12,k13,k14,k15,k16,k17,combine,codec,l2]

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

each at M=256, at one query (M=1) and at one query with 7 NaN rows (M=8, the
query axis padded as the JAX package pads it), with the host time of a call
(``host_us``); K7 on the same three layouts at M=256 cut into config 6's 8
shards of one card (``chip_smoke.k7_shards``): a plan's eager call (three
readings), host, graph and profiler time and launches. K8 on bench config 2's slab
(10,301,000 keys drawn as ``_store_sales``'s ``ss_item_sk`` in a capacity of
10,485,760). K9 on bench config 2's probe (``k9_traffic``: the 10,301,000-row
slab and 1,000,000 int32 source keys, half of them present, padded to 2^20
with ``probe_async``'s sentinel, as ``chip_smoke.py`` probes it
(``config2``), with the fresh keys above the slab's range (``spread``),
with a key that runs 100,000 rows (``dups``) and with one key at 2^40
(``outlier``)):
eager, graph, profiler kernels, the bound ``chip_smoke.py`` counts and
``torch.searchsorted`` (the lookup half). K3 with K2 as the tail apply
runs them at config 6's tail (500 dead rows padded to 512, 1,000 appended
rows padded to 1,024, C=4 in 2^20): the launches on uploaded inputs
(eager, graph, profiler), the uploads of the prepared arrays and the
launches (``upload_launch_ms``: four pageable copies before the redesign,
one pinned one after), the whole call (``_apply_tail_device``, which also
rounds the float64 bounds to float32 on the host), and the four library
calls it replaces
(two ``index_fill_``, two ``index_copy_``); and K3's own call on one lane
(``scatter_cols``) beside ``index_copy_``. K12 on M3's shape (11,000,000 int32 target keys padded to
12,582,912, 1,000,000 source keys padded to 2^20) and K13 on M4's
(12,500,000 target keys padded to 16,777,216 in 8 slabs of one card, the
same source), each in four traffics: ``half`` (half the source present, some
twice), ``dups`` (one source key 100,000 times, in 1% of the targets),
``miss`` (no target key in the source) and ``hit`` (every target key in the
source). K14 on bench config 12's arith query over its 8 files (250,000 rows
each, ``price`` and ``qty`` int64 lanes padded to 2^18), and ``price IN``
200 values over the same files (past the launch's parameters): the query's
masks (one launch over the files where the package has
``column_cache.residual_masks``, else one launch a file), the per-file call,
and the masks' download. K15 (the expression interpreter, which shares the
residual mask's header) on ``K15_PROGRAMS`` over ``chip_smoke.k15_columns``
at 1,005,000 rows, an IN whose column option is half NULL, the normal
leg's declined program (``k15_normal_leg``) and, without timing, an IN
whose option column is NULL in its last row only (the rows whose validity
differs from the plain version's). K10 (``k10``) at ``k9_traffic``'s
``config2`` and ``spread`` probes with the probe's host side
(``k10_finalize``). K5 and K6 on four action streams (``replay_streams``):
``log``, bench config 6's stream as ``chip_smoke.py``'s log holds it
(1,000,000 adds in 10 commits, then 10 tails of 500 removes and 1,000 adds:
1,015,000 actions over 1,010,000 paths, cutoff 15); ``hot``, 2^20 actions of
which 100,000 are one path's; ``adds``, 2^20 adds over 262,144 paths;
``empty``, ``chip_smoke.k6_stream`` (2^20 zipf-skewed actions, one of 8
shards empty). K5 takes the stream padded as ``replay_alive_mask`` pads it,
K6 its 8 slabs as ``replay_sharded`` cuts them on one card; each row has the
eager call, the launches without the call's download replayed from a CUDA
graph (where the package has them apart), the profiler's kernels, the bound
of the bytes this data needs (``chip_smoke.replay_bytes``), the winner-table
half's library call (``fill_`` and
``scatter_reduce_`` amax) and the host wall of the entry point that runs it
(``replay_alive_mask``, ``replay_sharded``), upload to unscattered masks,
the median of 5. K2 (``scatter_bool``) at a tail's 500 dead files in 2^20
times the launch path every wrapper shares (``native.call``): eager, host
and graph time. K11 (``k11_rows``) on bench config 2's slab as phase 6 of
``chip_smoke.py`` holds it: each single update at the shape that phase
gives it, beside its library call out of place and in place, then phase
6's four advances a-d as the entry issues them (its flush replayed over the
updates its mutators queued; in place, and, where the package pins, with a
probe's pin held), with the launches, eager, host, graph (the launches on
uploaded inputs) and profiler time, the bound (``chip_smoke.advance_bytes``)
and the same updates as library calls out of place and in place. K17
(``k17_rows``) at the link probe's 8 int32: the wrapper and ``torch.add(a,
1)`` in turns, and the host time of each and of a bare ``native.call``. ``l2`` times a random gather of 16,777,216 int64 from a 16
MB table (one L2 sector a read): the rate the join's probes are held to.
``codec`` (``codec_ab_rows``) times both page codec kernels at
``chip_smoke.codec_rows``' shapes (one 1 MiB page and eight, cut from
store_sales columns' PLAIN and BYTE_STREAM_SPLIT bytes) and at a small
file's (eight pages of 2,000 rows, 16,000 bytes each, as
``tools/codec_bench.py``): the wrapper's whole call (three readings), the
launch alone eager and replayed from a CUDA graph on buffers already on the
card, the profiler's kernels, the bound of the bytes in and out, the plain
version's time (``exec/snappy``) and, for ``snappy_compress``, its bytes
beside the plain compressor's.
"""
import argparse
import importlib.util
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the ``log`` stream's commits of adds before its tails (config 6's JSON
#: layout, as ``chip_smoke.py`` laid it out before its checkpoint)
LOG_COMMITS = 10


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


def replay_streams(chip_smoke, state_export):
    """The K5/K6 streams: name -> (ReplayArrays, retention cutoff)."""
    rng = np.random.RandomState(13)
    # config 6's log: v1-v10 of 100,000 adds, then tails v11-v20, each 500
    # removes of live files before 1,000 new adds (seq = version << 31 | pos)
    n_files, per = chip_smoke.N_FILES, chip_smoke.N_FILES // LOG_COMMITS
    adds, rem = chip_smoke.TAIL_ADDS, chip_smoke.TAIL_REMOVES
    pid = [np.arange(n_files, dtype=np.int32)]
    seq = [(np.repeat(np.arange(1, LOG_COMMITS + 1), per).astype(np.int64) << 31)
           | np.tile(np.arange(per, dtype=np.int64), LOG_COMMITS)]
    is_add, size, dts = [np.ones(n_files, bool)], [np.full(n_files, 1 << 20)], [np.zeros(n_files)]
    live = list(range(n_files))
    for t in range(chip_smoke.N_TAILS):
        v = LOG_COMMITS + 1 + t
        gone = rng.choice(len(live), rem, replace=False)
        new_ids = np.arange(n_files + t * adds, n_files + (t + 1) * adds, dtype=np.int32)
        pid.append(np.concatenate([np.asarray(live, np.int32)[gone], new_ids]))
        for j in sorted(gone, reverse=True):
            live[j] = live[-1]
            live.pop()
        live.extend(new_ids.tolist())
        seq.append((np.int64(v) << 31) | np.arange(rem + adds, dtype=np.int64))
        is_add.append(np.arange(rem + adds) >= rem)
        size.append(np.where(is_add[-1], 1 << 16, 0))
        dts.append(np.where(is_add[-1], 0, v))
    cat = lambda xs, dt: np.concatenate(xs).astype(dt)
    n_paths = n_files + chip_smoke.N_TAILS * adds
    log = state_export.ReplayArrays(
        paths=[f"p{i}" for i in range(n_paths)], path_id=cat(pid, np.int32),
        seq=cat(seq, np.int64), is_add=cat(is_add, bool), size=cat(size, np.int64),
        deletion_timestamp=cat(dts, np.int64))

    def synthetic(pid, add):
        n = len(pid)
        return state_export.ReplayArrays(
            paths=[f"p{i}" for i in range(int(pid.max()) + 1)], path_id=pid.astype(np.int32),
            seq=(np.arange(n, dtype=np.int64) << 8) + 7, is_add=add,
            size=rng.randint(0, 2**62, n).astype(np.int64),
            deletion_timestamp=rng.randint(0, 2000, n).astype(np.int64))

    n = 1 << 20
    hot = rng.randint(0, n // 4, n)
    hot[rng.choice(n, 100_000, replace=False)] = 0
    return {"log": (log, LOG_COMMITS + 5),
            "hot": (synthetic(hot, rng.rand(n) > 0.3), 1000),
            "adds": (synthetic(rng.randint(0, n // 4, n), np.ones(n, bool)), 1000),
            "empty": (chip_smoke.k6_stream(n, 31), 1000)}


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


def k9_traffic(torch, dev, key_cache, traffic, with_perm=False):
    """(sorted keys, sorted validity, n, padded int32 source) on the card,
    and the sort's permutation after them with ``with_perm``.
    ``config2``: bench config 2's slab as ``chip_smoke.py``'s probe sees it
    after the advances (10,000,000 keys drawn from [0, 20,000,000), the
    appended 300,000-row file's keys from 20,000,000 and the 1,000-row
    file's from 40,000,000; 1% of rows invalid) and the bench's source,
    half live keys and half fresh keys from 20,000,000 on; ``spread``: the
    same slab with 301,000 re-appended keys and the fresh source keys above
    the slab's range; ``dups``: ``spread`` with key 12,345 in 100,000 rows,
    some valid and some not; ``outlier``: ``spread`` with one row's key at
    2^40, so the source keys crowd the low end of the slab's range."""
    rng = np.random.RandomState(13)
    n, cap, m = 10_301_000, 10_485_760, 1_000_000
    keys = np.zeros(cap, np.int64)
    keys[:10_000_000] = rng.permutation(20_000_000)[:10_000_000]
    if traffic == "config2":
        keys[10_000_000:10_300_000] = np.arange(20_000_000, 20_300_000)
        keys[10_300_000:n] = np.arange(40_000_000, 40_001_000)
    else:
        keys[10_000_000:n] = keys[rng.choice(10_000_000, n - 10_000_000, replace=False)]
    valid = rng.rand(cap) > 0.01
    if traffic == "dups":
        keys[rng.choice(n, 100_000, replace=False)] = 12_345
    if traffic == "outlier":
        keys[n - 1] = 1 << 40
    s = np.concatenate([keys[rng.randint(0, 10_000_000, m // 2)], 20_000_000 + np.arange(m - m // 2)])
    if traffic == "dups":
        s[:1000] = 12_345
    s_in = np.full(1 << 20, np.iinfo(np.int32).max - 1, np.int32)
    s_in[:m] = s[rng.permutation(m)]
    k, v = torch.from_numpy(keys).to(dev), torch.from_numpy(valid).to(dev)
    sk, perm, _, sv = key_cache.slab_sort_plain(k, v, n)
    out = (sk, sv, n, torch.from_numpy(s_in).to(dev))
    return out + (perm,) if with_perm else out


def k10_call(key_cache, t_match, s_first, perm, out_cap, mc):
    """K10's launch as the probe makes it: with the head's matched count
    where the package's ``pair_compact`` takes it (it then zeroes only the
    slots past the count), else the four-argument call."""
    if hasattr(key_cache, "fetch_pairs"):
        return lambda: key_cache.pair_compact(t_match, s_first, perm, out_cap, mc=mc)
    return lambda: key_cache.pair_compact(t_match, s_first, perm, out_cap)


def k10_finalize(torch, key_cache, t_match, s_first, perm, out_cap, mc):
    """The probe's pairs from K10's launch to the physical-order arrays its
    finalize hands ``PhysicalProbe`` (``probe_async``): the host wall of
    the launch with the download, of the int64 casts and of the order step
    (the stable argsort where the package still sorts on the host, else
    nothing), the median of 5, in ms."""
    parts = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if hasattr(key_cache, "fetch_pairs"):
            host = key_cache.fetch_pairs(t_match, s_first, perm, mc).numpy()
            t1 = time.perf_counter()
            phys, srows = host[:mc].astype(np.int64), host[mc:2 * mc].astype(np.int64)
            t2 = t3 = time.perf_counter()
        else:
            pairs = key_cache.pair_compact(t_match, s_first, perm, out_cap).cpu().numpy()
            t1 = time.perf_counter()
            phys, srows = pairs[0, :mc].astype(np.int64), pairs[1, :mc].astype(np.int64)
            t2 = time.perf_counter()
            order = np.argsort(phys, kind="stable")
            phys, srows = phys[order], srows[order]
            t3 = time.perf_counter()
        parts.append((t1 - t0, t2 - t1, t3 - t2, t3 - t0))
    if not (np.all(np.diff(phys) > 0) and len(phys) == mc == len(srows)):
        raise SystemExit("kernel_ab: the probe's pairs are not in physical order")
    med = np.median(np.asarray(parts), axis=0) * 1e3
    return dict(zip(("launch_download_ms", "cast_ms", "order_ms", "total_ms"),
                    (float(x) for x in med)))


def k15_normal_leg(torch, dev, pruning, state_export):
    """``chip_smoke.py``'s declined normal-leg program (``c0 * c1 >
    1.0e18`` rewritten for skipping) over config 6's stats lanes at
    1,005,000 files: (sql, program, env)."""
    from delta_tpu_torch.expr import ir
    from delta_tpu_torch.expr.parser import parse_expression
    from delta_tpu_torch.schema.types import DoubleType, LongType

    rng = np.random.RandomState(13)
    n, sql = 1_005_000, "c0 * c1 > 1.0e18"
    types = {f"c{c}": DoubleType() if c % 2 else LongType() for c in range(4)}
    lo = {c: np.floor(rng.rand(n) * 1e6) for c in types}
    arrays = state_export.FileStateArrays(
        paths=[""] * n, size=np.full(n, 1 << 20, np.int64), partition_codes={},
        partition_dicts={}, stats_min=lo, stats_max={c: v + 1000 for c, v in lo.items()},
        modification_time=np.zeros(n, np.int64), num_records=np.full(n, 10_000, np.int64),
        stats_null_count={c: np.zeros(n, np.int64) for c in types})
    rw = ir.and_all([r.rewritten for r in pruning.conjunct_rewrites(
        [parse_expression(sql)], frozenset(), types)])
    program = pruning._compiled_skipping(rw).program_for(arrays.lane_dtypes())
    return sql, program, arrays.device_env(dev, names=program.columns)


def k11_rows(torch, dev, key_cache, chip_smoke, emit, cuda_ms, graph_ms, host_us,
             kernel_breakdown, launched):
    """K11 at bench config 2's slab as ``chip_smoke.py``'s phase 6 holds it
    (10,000,000 keys in files of 4,000,000, 4,000,000 and 2,000,000 rows,
    cap 10,485,760, the sorted view live): each single update at the
    shapes phase 6 gives it, then the four advances a-d as the entry
    issues them (``_flush_batch`` over the updates its mutators queued)."""
    cap, n = 10_485_760, 10_000_000
    rng = np.random.RandomState(31)
    keys = np.random.RandomState(13).randint(0, 20_000_000, n).astype(np.int64)
    entry = key_cache.ResidentJoinKeys("kernel_ab", "m", 0, "k11", ["ss_item_sk"], device=dev)
    off = 0
    for i, rows in enumerate((4_000_000, 4_000_000, 2_000_000)):
        entry._append_file(f"f{i}", keys[off:off + rows], np.ones(rows, bool))
        off += rows
    if entry.capacity != cap:
        raise SystemExit(f"kernel_ab: slab capacity {entry.capacity}, not {cap}")
    entry.ensure_resident()
    entry._ensure_sorted()
    dv10 = np.sort(rng.choice(4_000_000, 10_000, replace=False))
    dv5 = np.sort(dv10[rng.choice(10_000, 5_000, replace=False)])
    lanes = entry._dev

    def padded(rows, d):
        r = np.full(d, cap, np.int32)
        r[:len(rows)] = rows
        return torch.from_numpy(r).to(dev)

    def single(name, fn, plain, library, library_inplace, shape):
        got, ref = fn(), plain()
        got, ref = (got, ref) if isinstance(got, tuple) else ((got,), (ref,))
        if not all(torch.equal(g, r) for g, r in zip(got, ref)):
            raise SystemExit(f"kernel_ab: {name} != its plain version")
        emit(name, shape=shape, launches=launched(fn), ms=cuda_ms(fn, 50),
             host_us=host_us(fn, 50), graph_ms=graph_ms(fn, 20),
             breakdown_us=kernel_breakdown(fn), library_ms=cuda_ms(library, 50),
             library_inplace_ms=cuda_ms(library_inplace, 50))

    valid, kl, inv = lanes["valid"], lanes["keys"], lanes["inv_perm"]
    vv, kk = valid.clone(), kl.clone()  # the in-place library calls' lanes
    for name, fn, rows_np, value in (("slab_kill", key_cache.slab_kill, dv10, False),
                                     ("slab_revive", key_cache.slab_revive, dv5, True)):
        d = 1 << max(6, (len(rows_np) - 1).bit_length())
        rows = padded(rows_np, d)
        kept = rows[rows < cap].long()
        single(name, lambda: fn(valid, rows),
               lambda: key_cache.slab_flip_plain(valid, rows, value),
               lambda: valid.index_fill(0, kept, value), lambda: vv.index_fill_(0, kept, value),
               f"cap={cap} d={d} ({len(rows_np)} rows)")
    rows = padded(dv10, 16_384)
    kept = rows[rows < cap].long()
    mapped = torch.empty(len(kept), dtype=torch.int32, device=dev)
    single("slab_map_rows", lambda: key_cache.slab_map_rows(inv, rows),
           lambda: key_cache.slab_map_rows_plain(inv, rows), lambda: torch.take(inv, kept),
           lambda: torch.index_select(inv, 0, kept, out=mapped), f"cap={cap} d=16384")
    a, a_rows = 1 << 19, 300_000
    rows = padded(np.arange(n, n + a_rows), a)
    nk_np = np.zeros(a, np.int32)
    nk_np[:a_rows] = np.arange(2 * n, 2 * n + a_rows)
    nk, nv = torch.from_numpy(nk_np).to(dev), torch.from_numpy(np.arange(a) < a_rows).to(dev)
    kept = rows[rows < cap].long()
    knk, knv = nk[:len(kept)].long(), nv[:len(kept)]
    single("slab_append", lambda: key_cache.slab_append(kl, valid, rows, nk, nv),
           lambda: key_cache.slab_append_plain(kl, valid, rows, nk, nv),
           lambda: (torch.index_copy(kl, 0, kept, knk), torch.index_copy(valid, 0, kept, knv)),
           lambda: (kk.index_copy_(0, kept, knk), vv.index_copy_(0, kept, knv)),
           f"cap={cap} a={a} ({a_rows} rows, {len(kept)} inside cap)")
    k32 = kl.to(torch.int32)
    wide = torch.empty(cap, dtype=torch.int64, device=dev)
    single("slab_widen", lambda: key_cache.slab_widen(k32),
           lambda: key_cache.slab_widen_plain(k32), lambda: k32.to(torch.int64),
           lambda: wide.copy_(k32), f"cap={cap}")
    start, sk, sv = n - 1000, nk[:1024].contiguous(), torch.ones(1024, dtype=torch.bool,
                                                                  device=dev)
    sk64 = sk.long()

    def slice_library():
        k, v = kl.clone(), valid.clone()
        k[start:start + 1024].copy_(sk64)
        v[start:start + 1024].copy_(sv)
        return k, v

    single("slab_slice_append", lambda: key_cache.slab_slice_append(kl, valid, start, sk, sv),
           lambda: key_cache.slab_slice_append_plain(kl, valid, start, sk, sv), slice_library,
           lambda: (kk[start:start + 1024].copy_(sk64), vv[start:start + 1024].copy_(sv)),
           f"cap={cap} a=1024 start={start}")
    del vv, kk, k32, wide, nk, nv, kept, knk, knv, mapped
    torch.cuda.empty_cache()

    # the advances: the mutators queue their updates once (their flush held
    # back), then the entry's flush replays them: the same device work each
    # time, in place or into new lanes as the package does it
    def capture(mutate):
        entry._flush_batch = lambda: None
        try:
            with entry.device_batch():
                mutate()
            pending = entry._pending
        finally:
            del entry._flush_batch
            entry._pending = None
        return pending

    def replay(pending):
        def run():
            entry._pending = {k: list(v) for k, v in pending.items()}
            entry._flush_batch()
        return run

    def mirrors_hold():
        d = entry._dev
        m = entry.num_rows
        ok = (torch.equal(d["keys"][:m].cpu(), torch.from_numpy(entry.h_keys))
              and torch.equal(d["valid"][:m].cpu(), torch.from_numpy(entry.h_valid)))
        if not entry._sort_stale and "sorted_valid" in d:
            pm = d["perm"].long()
            ok = ok and torch.equal(d["sorted_valid"], d["valid"][pm] & (pm < m))
        return ok

    c_keys = np.arange(2 * n, 2 * n + 300_000)
    d_keys = np.arange(4 * n, 4 * n + 1000)
    steps = (
        ("a", "DV of 10,000 rows in f0", lambda: entry._set_dv("f0", dv10),
         dict(rows=10_000, mirror_rows=10_000)),
        ("b", "DV shrunk to 5,000", lambda: entry._set_dv("f0", dv5),
         dict(rows=5_000, mirror_rows=5_000)),
        ("c", "300,000-row file + the removal of f2 (2,000,000 rows)",
         lambda: (entry._kill_file("f2"), entry._append_file("c", c_keys, np.ones(300_000, bool))),
         dict(slice_rows=300_000, key_bytes=4, run_rows=2_000_000)),
        ("d", "1,000-row file",
         lambda: entry._append_file("d", d_keys, np.ones(1000, bool)),
         dict(slice_rows=1000, key_bytes=4)),
    )
    for label, what, mutate, counts in steps:
        entry._ensure_sorted()  # the re-probe before each advance re-sorts a stale view
        run = replay(capture(mutate))
        sorted_live = not entry._sort_stale
        row = dict(advance=label, shape=f"cap={cap}: {what}", sorted_live=sorted_live,
                   launches=launched(run))
        torch.cuda.synchronize()
        if not mirrors_hold():
            raise SystemExit(f"kernel_ab: advance {label}: the lanes differ from the mirrors")
        row.update(ms=[cuda_ms(run, 20) for _ in range(3)], host_us=host_us(run, 20),
                   breakdown_us=kernel_breakdown(run, calls=10),
                   bound_ms=chip_smoke.bound(chip_smoke.advance_bytes(**counts))[0])
        if hasattr(entry, "_pins"):  # a probe holds the lanes: new lanes
            entry._pins += 1
            row.update(pinned_ms=[cuda_ms(run, 20) for _ in range(3)],
                       pinned_launches=launched(run),
                       pinned_bound_ms=chip_smoke.bound(chip_smoke.advance_bytes(
                           **counts, copied=cap if sorted_live else 0))[0])
            entry._pins -= 1
            torch.cuda.synchronize()
            if not mirrors_hold():
                raise SystemExit(f"kernel_ab: pinned advance {label}: lanes differ from mirrors")
        # the launches alone, the uploads served from tensors made once
        uploads, real = [], entry._upload
        entry._upload = lambda x: (uploads.append(real(x)), uploads[-1])[1]
        run()
        torch.cuda.synchronize()

        def launch_only():
            it = iter(uploads)
            entry._upload = lambda x: next(it)
            run()

        row["graph_ms"] = graph_ms(launch_only, 10)
        del entry._upload
        row.update(library_advance(torch, entry, label, dv10, dv5, cuda_ms))
        emit("slab_advance", **row)
    del entry, lanes, valid, kl, inv


def library_advance(torch, entry, label, dv10, dv5, cuda_ms):
    """One advance's updates as PyTorch calls on lanes of the slab's shape,
    out of place (a new lane for each update, as the JAX package binds) and
    in place (``index_fill_``, ``index_copy_``, slice ``copy_`` /
    ``fill_``), the indices and values already on the card."""
    d = entry._dev
    dev, cap = d["keys"].device, d["keys"].shape[0]
    valid, keys = d["valid"].clone(), d["keys"].clone()
    sv, inv = torch.zeros(cap, dtype=torch.bool, device=dev), d.get("inv_perm")
    if inv is None:
        inv = torch.arange(cap, dtype=torch.int32, device=dev)
    if label in ("a", "b"):
        rows = torch.from_numpy(dv10 if label == "a" else dv5).to(dev)
        value = label == "b"

        def out():
            return (valid.index_fill(0, rows, value),
                    sv.index_fill(0, torch.take(inv, rows).long(), value))

        def inp():
            valid.index_fill_(0, rows, value)
            sv.index_fill_(0, torch.take(inv, rows).long(), value)
    else:
        s, a = (10_000_000, 300_000) if label == "c" else (10_300_000, 1000)
        nk = torch.arange(s, s + a, dtype=torch.int64, device=dev)
        nv = torch.ones(a, dtype=torch.bool, device=dev)
        rows = torch.arange(s, s + a, dtype=torch.int64, device=dev)
        dead = torch.arange(8_000_000, 10_000_000, dtype=torch.int64, device=dev)

        def out():
            k2, v2 = torch.index_copy(keys, 0, rows, nk), torch.index_copy(valid, 0, rows, nv)
            return v2.index_fill(0, dead, False) if label == "c" else (k2, v2)

        def inp():
            keys[s:s + a].copy_(nk)
            valid[s:s + a].copy_(nv)
            if label == "c":
                valid[8_000_000:10_000_000].fill_(False)

    return {"library_ms": cuda_ms(out, 20), "library_inplace_ms": cuda_ms(inp, 20)}


def k17_rows(torch, dev, native, emit, cuda_ms, graph_ms, host_us, kernel_breakdown,
             launched):
    """K17 at the link probe's 8 int32 against ``torch.add(a, 1)``, five
    readings of each in turns, and the host time of the wrapper, of
    ``torch.add`` and of a bare ``native.call`` of the kernel (its output
    allocated once)."""
    from delta_tpu_torch.parallel import link

    a = torch.arange(8, dtype=torch.int32, device=dev)
    out = torch.empty_like(a)
    if not torch.equal(link.link_probe(a), a + 1):
        raise SystemExit("kernel_ab: link_probe != a + 1")
    wrapper = lambda: link.link_probe(a)
    library = lambda: torch.add(a, 1)
    bare = lambda: native.call("link_probe", dev, a.data_ptr(), 8, out.data_ptr())
    ms, lib = [], []
    for _ in range(5):
        ms.append(cuda_ms(wrapper, 200))
        lib.append(cuda_ms(library, 200))
    emit("link_probe", shape="n=8 int32 (the probe's warm-up)", launches=launched(wrapper),
         ms=ms, library_ms=lib, graph_ms=graph_ms(wrapper, 50),
         host_us=[host_us(wrapper, 500) for _ in range(3)],
         library_host_us=[host_us(library, 500) for _ in range(3)],
         call_host_us=[host_us(bare, 500) for _ in range(3)], call_ms=cuda_ms(bare, 200),
         breakdown_us=kernel_breakdown(wrapper))


def combine_rows(torch, dev, emit, t, chip_smoke):
    """The cross-shard combine at the mesh path's shapes and at eight
    cards'; K13's reduction over eight cards as the package runs it: the
    devices' unpacked hits packed by the combine (``or_pack``) and their
    multi bytes in two launches where the package has that op, else their
    packed hits and multi bytes ORed in one launch."""
    from delta_tpu_torch.ops import state_cache
    from delta_tpu_torch.parallel import mesh

    rng = np.random.RandomState(41)

    def rows_of(op, n, k):
        if op == "sum":
            return torch.from_numpy(rng.randint(-2**62, 2**62, (n, k)).astype(np.int64)).to(dev)
        return torch.from_numpy(((rng.rand(n, k) < 0.05)
                                 * rng.randint(1, 255, (n, k))).astype(np.uint8)).to(dev)

    def timed(kernel, fn, b, **fields):
        emit(kernel, bound_ms=b, launches=t["launched"](fn),
             ms=[t["cuda_ms"](fn, 100) for _ in range(3)], host_us=t["host_us"](fn, 100),
             graph_ms=t["graph_ms"](fn, 50), breakdown_us=t["kernel_breakdown"](fn), **fields)

    for op, n, k in [("sum", 8, 4), ("sum", 8, 1), ("or", 1, 1), ("sum", 8, 1 << 20)]:
        x = rows_of(op, n, k)
        fn = lambda x=x, op=op: mesh.shard_combine(x, op)
        if not torch.equal(fn(), mesh.shard_combine_plain(x, op)):
            raise SystemExit(f"kernel_ab: shard_combine {op} != its plain version ({n}, {k})")
        b, _ = chip_smoke.bound(x.numel() * x.element_size() + k * x.element_size())
        library = ((lambda x=x: x.sum(dim=0)) if op == "sum"
                   else (lambda x=x: torch.any(x, dim=0)))
        timed("shard_combine", fn, b, op=op, shape=f"({n}, {k}) {x.dtype}",
              library_ms=t["cuda_ms"](library, 100))
    # K13 over eight cards: cap_s = 2^20 source rows
    cap_s = 1 << 20
    hits = torch.from_numpy((rng.rand(8, cap_s) < 0.05).astype(np.uint8)).to(dev)
    multi = torch.from_numpy(np.array([[i == 5] for i in range(8)], np.uint8)).to(dev)
    want = state_cache._packbits(hits.any(dim=0))
    if "or_pack" in mesh.COMBINE_OPS:
        hit_rows, hit_op = hits, "or_pack"
        pair = lambda: (mesh.shard_combine(hits, "or_pack"), mesh.shard_combine(multi, "or"))
    else:
        hit_rows, hit_op = state_cache._packbits(hits), "or"
        pair = lambda: mesh.shard_combine_many([(hit_rows, "or"), (multi, "or")])
    one = lambda: mesh.shard_combine(hit_rows, hit_op)
    got = pair()
    if not (torch.equal(one(), want) and torch.equal(got[0], want)
            and got[1].tolist() == [1]):
        raise SystemExit("kernel_ab: K13's combine != the packing of the hits' OR")
    b, _ = chip_smoke.bound(hit_rows.numel() + cap_s // 8)
    timed("k13_hits_combine", one, b, op=hit_op, shape=f"{hit_op} of {tuple(hit_rows.shape)} u8")
    b, _ = chip_smoke.bound(hit_rows.numel() + cap_s // 8 + 8 + 1)
    timed("k13_combine", pair, b,
          shape=f"{hit_op} of {tuple(hit_rows.shape)} u8 + or of (8, 1) u8")


def k16_rows(torch, dev, emit, t, chip_smoke):
    """K16 at k = 1..6 and at config 3's ranks; ``morton_order``'s wall on
    config 3's two columns, split into its steps."""
    from delta_tpu_torch.ops import zorder

    n = 4_000_000
    data = chip_smoke.store_sales(n, np.random.RandomState(5))
    cols = [data["ss_item_sk"], data["ss_sold_date_sk"]]
    config3 = torch.from_numpy(np.stack([zorder.rank_u16(c) for c in cols]).astype(np.int32))
    for k in range(1, 8):
        ranks = chip_smoke.k16_ranks(k, n, 16, dev) if k < 7 else config3.to(dev)
        fn = lambda ranks=ranks: zorder.interleave(ranks)
        key = fn()
        if not torch.equal(key, zorder.interleave_plain(ranks)):
            raise SystemExit(f"kernel_ab: morton != its plain version (k={k})")
        flipped = key ^ torch.iinfo(torch.int64).min
        b, _ = chip_smoke.bound(4 * ranks.numel() + 8 * n)
        emit("morton", shape=(f"k={k} n={n} (k16_ranks)" if k < 7
                              else f"k=2 n={n} (config 3's ranks)"),
             bound_ms=b, launches=t["launched"](fn), ms=[t["cuda_ms"](fn, 50) for _ in range(3)],
             host_us=t["host_us"](fn, 50), graph_ms=t["graph_ms"](fn, 20),
             breakdown_us=t["kernel_breakdown"](fn),
             library_ms=t["cuda_ms"](lambda: torch.sort(flipped, stable=True), 10))
        del ranks, key, flipped

    def split():
        """One morton_order on config 3's columns, each step timed after a
        synchronisation: (the permutation, ms by step)."""
        if hasattr(zorder, "key_order"):  # the sorts on the card
            return chip_smoke.morton_steps(cols, dev)
        # the host ranks and the host argsort of the downloaded key
        out = {}
        torch.cuda.synchronize()
        clock = [time.perf_counter()]

        def lap(name):
            torch.cuda.synchronize()
            clock.append(time.perf_counter())
            out[name] = (clock[-1] - clock[-2]) * 1e3

        ranks = np.stack([zorder.rank_u16(c) for c in cols]).astype(np.int32)
        lap("ranks")
        dranks = torch.from_numpy(ranks).to(dev)
        lap("upload")
        key = zorder.interleave(dranks)
        lap("interleave")
        host_key = key.cpu().numpy()
        lap("download")
        perm = np.argsort(host_key.view(np.uint64), kind="stable")
        lap("sort")
        out["total"] = (clock[-1] - clock[0]) * 1e3
        return perm, out

    perm, _ = split()
    walls = [split()[1] for _ in range(5)]
    walls.sort(key=lambda w: w["total"])
    emit("morton_order", shape=f"k=2 n={n} (config 3's ss_item_sk, ss_sold_date_sk)",
         split_ms=walls[2], totals_ms=[w["total"] for w in walls],
         perm_head=[int(i) for i in perm[:4]])
    emit("optimize", **optimize_wall(torch, dev, chip_smoke, data))


def optimize_wall(torch, dev, chip_smoke, data):
    """Bench config 3's OPTIMIZE ZORDER BY as ``chip_smoke.run_zorder``
    runs it (4M rows appended in 8 commits, files of 500,000 rows): its
    wall, twice on fresh copies, with ``phase_ms`` where the command has
    it."""
    import shutil
    import tempfile

    from delta_tpu_torch import DeltaLog, WriteIntoDelta
    from delta_tpu_torch.commands.optimize import OptimizeCommand

    n = len(data["ss_item_sk"])
    step = n // 8
    out = {"shape": f"n={n} ZORDER BY (ss_item_sk, ss_sold_date_sk)", "wall_s": [],
           "phase_ms": []}
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="kernel_ab_", dir=os.path.join(HERE, "build")) as d:
        src = os.path.join(d, "src")
        log = DeltaLog.for_table(src, device=dev)
        for i in range(8):
            WriteIntoDelta(log, "append",
                           {c: v[i * step:(i + 1) * step] for c, v in data.items()}).run()
        for r in range(2):
            path = os.path.join(d, f"run{r}")
            shutil.copytree(src, path)
            DeltaLog.clear_cache()
            cmd = OptimizeCommand(DeltaLog.for_table(path, device=dev),
                                  z_order_by=["ss_item_sk", "ss_sold_date_sk"], target_rows=step)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cmd.run()
            torch.cuda.synchronize()
            out["wall_s"].append(time.perf_counter() - t0)
            out["phase_ms"].append(dict(getattr(cmd, "phase_ms", {})))
    return out


def k4_rows(torch, dev, emit, t, chip_smoke, state_export):
    """K4 at n = 2^20 on four streams: the log stream's path ids padded to
    2^20 (the main path's), phase 3's random ids, phase 3's zipf-skewed K6
    ids (``chip_smoke.k6_stream``) and one path on every row. Eager (three
    readings), host, graph, profiler, ``scatter_reduce_`` amax (the scatter
    half alone) and ``winner_mask_device``'s whole call (upload, kernel,
    download: the median of 20 host walls). Where the package has the
    self-cleaning entry (``replay_kernel._winner_launch``), the graph
    replays the wrapper itself (it does not synchronise); before it, the
    launch without the wrapper's read of the error word."""
    from delta_tpu_torch.ops import native, replay_kernel

    log, _ = replay_streams(chip_smoke, state_export)["log"]
    rng = np.random.RandomState(13)
    n = 1 << 20
    pid_log = np.full(n, -1, np.int32)
    pid_log[:log.num_rows] = log.path_id
    pid_rand = rng.randint(0, n // 10, n).astype(np.int32)
    pid_rand[-(n // 64):] = -1
    pid_zipf = chip_smoke.k6_stream(n, 31).path_id.astype(np.int32)
    redesigned = hasattr(replay_kernel, "_winner_launch")
    for name, pid_np, num_paths in (("log", pid_log, len(log.paths)),
                                    ("random", pid_rand, n // 10),
                                    ("zipf", pid_zipf, n // 4),
                                    ("one_path", np.zeros(n, np.int32), 1)):
        pid = torch.from_numpy(pid_np).to(dev)
        valid = pid >= 0
        pid64, idx = pid[valid].long(), torch.arange(n, device=dev)[valid]
        last64 = torch.empty(num_paths, dtype=torch.int64, device=dev)
        library_ms = t["cuda_ms"](lambda: last64.fill_(-1).scatter_reduce_(
            0, pid64, idx, "amax"), 50)
        b, _ = chip_smoke.bound(4 * n + n // 8)
        fn = lambda pid=pid, num_paths=num_paths: replay_kernel.winner_bits(pid, num_paths)
        if not torch.equal(fn(), replay_kernel.winner_bits_plain(pid, num_paths)):
            raise SystemExit(f"kernel_ab: winner_bits != its plain version ({name})")
        if redesigned:
            launch = fn
        else:
            out = torch.empty(n // 8, dtype=torch.uint8, device=dev)
            last = torch.empty(num_paths, dtype=torch.int32, device=dev)
            err = torch.empty(1, dtype=torch.int32, device=dev)
            # the launch alone, without the wrapper's read of the error word
            launch = lambda pid=pid, num_paths=num_paths, out=out, last=last, err=err: (
                native.call("winner_bits", dev, pid.data_ptr(), n, last.data_ptr(),
                            num_paths, err.data_ptr(), out.data_ptr()))
        walls = []
        for _ in range(21):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mask = replay_kernel.winner_mask_device(pid_np, num_paths, device=dev)
            walls.append((time.perf_counter() - t0) * 1e3)
        if not np.array_equal(mask, np.unpackbits(
                replay_kernel.winner_bits_plain(pid, num_paths).cpu().numpy()).astype(bool)):
            raise SystemExit(f"kernel_ab: winner_mask_device != the plain mask ({name})")
        emit("winner_bits", stream=name, shape=f"n={n} num_paths={num_paths}",
             bound_ms=b, launches=t["launched"](fn),
             ms=[t["cuda_ms"](fn, 50) for _ in range(3)],
             host_us=t["host_us"](fn, 50), graph_ms=t["graph_ms"](launch, 20),
             breakdown_us=t["kernel_breakdown"](fn), library_ms=library_ms,
             mask_device_ms=sorted(walls[1:])[10])
        del pid, pid64, idx, last64
        torch.cuda.empty_cache()


def codec_ab_rows(torch, dev, emit, t, chip_smoke):
    """Both page codec kernels of the package under ``--root`` at the
    writer's shapes (see the module's docstring)."""
    from delta_tpu_torch.exec import snappy
    from delta_tpu_torch.ops import page_codec

    cases = chip_smoke.kernel_cases()
    plain, bss = cases._store_sales_bytes(1 << 20)
    mix = b"".join(b for _, b in plain + bss)
    small_plain, small_bss = cases._store_sales_bytes(2000)
    shapes = {"1 MiB": [mix[:1 << 20]],
              "8 x 1 MiB": [mix[i << 20:(i + 1) << 20] for i in range(8)],
              "8 x 16,000 B": [b for _, b in small_plain + small_bss]}
    for shape, pages in shapes.items():
        sizes = [len(p) for p in pages]
        z = page_codec.compress(pages, dev)
        t0 = time.perf_counter()
        zp = [snappy.compress(p) for p in pages]
        plain_c = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        back = [snappy.decompress(x) for x in z]
        plain_d = (time.perf_counter() - t0) * 1e3
        if back != pages or page_codec.decompress(z, sizes, dev) != pages:
            raise SystemExit(f"kernel_ab: the codec's {shape} batch does not round-trip")
        n_in, n_z = sum(sizes), sum(map(len, z))
        compress_launch, decompress_launch, src, out, err = chip_smoke.codec_launches(
            pages, z, dev)
        b, _ = chip_smoke.bound(n_in + n_z)
        for name, call, launch, plain_ms, extra in (
                ("snappy_compress", lambda: page_codec.compress(pages, dev), compress_launch,
                 plain_c, {"bytes_out": n_z, "plain_bytes_out": sum(map(len, zp)),
                           "ratio_to_plain": n_z / sum(map(len, zp))}),
                ("snappy_decompress", lambda: page_codec.decompress(z, sizes, dev),
                 decompress_launch, plain_d, {})):
            emit(name, shape=shape, pages=len(pages), bytes_in=n_in if name == "snappy_compress"
                 else n_z, launches=t["launched"](call),
                 ms=[t["cuda_ms"](call, 3, warm=1) for _ in range(3)],
                 launch_ms=t["cuda_ms"](launch, 5, warm=1), graph_ms=t["graph_ms"](launch, 5),
                 breakdown_us=t["kernel_breakdown"](launch, calls=5), bound_ms=b,
                 plain_ms=plain_ms, **extra)
        if not torch.equal(out, src) or bool(err.any()):
            raise SystemExit(f"kernel_ab: the timed decompress launch of {shape} is wrong")
        del compress_launch, decompress_launch, src, out, err
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--only", default="k1,k2,k3,k4,k5,k6,k7,k8,k9,k10,k11,k12,k13,k14,k15,k16,"
                                      "k17,combine,codec,l2")
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
    from delta_tpu_torch.ops import (column_cache, join_kernel, key_cache, native, replay_kernel,
                                     state_cache, state_export)

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
                     host_us=host_us(lambda: state_cache.block_cull(*a), 200),
                     graph_ms=graph_ms(lambda: state_cache.block_cull(*a), 50),
                     breakdown_us=kernel_breakdown(lambda: state_cache.block_cull(*a)))

    if "k7" in only:
        # K7 over config 6's 8 shards of one card, on K1's three layouts
        for name, mins, maxs, alive, lo, hi in k1_workloads(torch, dev, state_cache, chip_smoke):
            shards = chip_smoke.k7_shards(mins, maxs, alive, chip_smoke.MESH_SHARDS)
            fn = lambda: state_cache.sharded_block_cull(shards, lo, hi)
            got = fn()
            if not torch.equal(got, state_cache.sharded_block_cull_plain(shards, lo, hi)):
                raise SystemExit(f"kernel_ab: sharded_block_cull != its plain version ({name})")
            b, _ = chip_smoke.bound(chip_smoke.cull_bytes(mins, maxs, alive, lo, hi, got.numel()))
            emit("sharded_block_cull", lanes=name, M=lo.shape[0], shards=len(shards), bound_ms=b,
                 launches=launched(fn), ms=[cuda_ms(fn, 50) for _ in range(3)],
                 host_us=host_us(fn, 50), graph_ms=graph_ms(fn, 20),
                 breakdown_us=kernel_breakdown(fn))
            del shards, got
        torch.cuda.empty_cache()

    if only & {"k5", "k6"}:
        rk = replay_kernel
        # the redesign split the launches from the call's download
        split = hasattr(rk, "_sharded_launch")
        for name, (arr, cutoff) in replay_streams(chip_smoke, state_export).items():
            num_paths = len(arr.paths)
            pid64 = torch.from_numpy(arr.path_id).to(dev).long()
            seq_all = torch.from_numpy(arr.seq).to(dev)
            best = torch.empty(num_paths, dtype=torch.int64, device=dev)
            library = lambda: best.fill_(-(1 << 63)).scatter_reduce_(0, pid64, seq_all, "amax")
            cap = rk._next_pow2(arr.num_rows, floor=8)
            cols = [torch.from_numpy(rk._pad(np.asarray(a, dt), cap, fill)).to(dev)
                    for a, dt, fill in ((arr.path_id, np.int32, -1), (arr.seq, np.int64, 0),
                                        (arr.is_add, bool, False), (arr.size, np.int64, 0),
                                        (arr.deletion_timestamp, np.int64, 0))]
            stacked, _, _ = rk._bucket_by_path(arr, chip_smoke.MESH_SHARDS)
            big = [torch.from_numpy(c).to(dev) for c in stacked]
            slabs = [tuple(c[i] for c in big) for i in range(chip_smoke.MESH_SHARDS)]
            rows = [int((s[0] >= 0).sum()) for s in slabs]
            runs = []
            if "k5" in only:
                runs.append(("replay", lambda: rk.replay(*cols, num_paths, cutoff),
                             lambda: rk.replay_plain(*cols, num_paths, cutoff),
                             split and (lambda: rk._launch("replay", [cols], num_paths, cutoff)),
                             [cols], f"n={cap} ({arr.num_rows} actions) num_paths={num_paths}"))
            if "k6" in only:
                runs.append(("sharded_replay",
                             lambda: rk.sharded_replay(slabs, num_paths, cutoff),
                             lambda: rk.sharded_replay_plain(slabs, num_paths, cutoff),
                             split and (lambda: rk._sharded_launch(slabs, num_paths, cutoff)),
                             slabs,
                             f"{chip_smoke.MESH_SHARDS} shards x cap={slabs[0][0].shape[0]} "
                             f"(rows {rows}) num_paths={num_paths}"))
            # the entry points' host wall, upload to download (the median of 5)
            entry = {"replay": lambda: rk.replay_alive_mask(arr, cutoff, device=dev),
                     "sharded_replay": lambda: rk.replay_sharded(
                         arr, [dev] * chip_smoke.MESH_SHARDS, cutoff)}
            for kernel, fn, plain, launch_only, inputs, shape in runs:
                got, ref = fn(), plain()
                flat = lambda r: (list(r[0]) + list(r[1]) + [r[2]] if isinstance(r[0], list)
                                  else list(r))
                if not all(torch.equal(a, b) for a, b in zip(flat(got), flat(ref))):
                    raise SystemExit(f"kernel_ab: {kernel} != its plain version ({name})")
                b, _ = chip_smoke.bound(chip_smoke.replay_bytes(inputs, num_paths))
                row = dict(stream=name, shape=shape, bound_ms=b, launches=launched(fn),
                           ms=cuda_ms(fn, 50), host_us=host_us(fn, 20),
                           library_ms=cuda_ms(library, 50), breakdown_us=kernel_breakdown(fn))
                if launch_only:
                    row["graph_ms"] = graph_ms(launch_only, 20)
                walls = []
                for _ in range(5):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    entry[kernel]()
                    walls.append((time.perf_counter() - t0) * 1e3)
                row["entry_wall_ms"] = sorted(walls)[2]
                emit(kernel, **row)
            del cols, big, slabs, best, pid64, seq_all
            torch.cuda.empty_cache()

    rng = np.random.RandomState(13)
    if "k2" in only:
        # K2 alone on the launch path every wrapper shares (``native.call``),
        # at a tail's 500 dead files
        cap, d = 1 << 20, 512
        r = np.random.RandomState(5)
        lane = torch.from_numpy(r.rand(cap) > 0.02).to(dev)
        rows_np = np.full(d, cap, np.int32)
        rows_np[:500] = np.sort(r.choice(cap, 500, replace=False))
        rows = torch.from_numpy(rows_np).to(dev)
        fn = lambda: state_cache.scatter_bool(lane, rows, False)
        got, ref = fn().clone(), state_cache.scatter_bool_plain(lane.clone(), rows, False)
        if not torch.equal(got, ref):
            raise SystemExit("kernel_ab: scatter_bool != its plain version")
        emit("scatter_bool", shape=f"cap={cap} d={d} (500 rows)", launches=launched(fn),
             ms=cuda_ms(fn, 200), host_us=host_us(fn, 200), graph_ms=graph_ms(fn, 50),
             breakdown_us=kernel_breakdown(fn))
        del lane, rows, got, ref

    timers = dict(cuda_ms=cuda_ms, graph_ms=graph_ms, host_us=host_us,
                  kernel_breakdown=kernel_breakdown, launched=launched)
    if "k11" in only:
        k11_rows(torch, dev, key_cache, chip_smoke, emit, **timers)
        torch.cuda.empty_cache()
    if "k17" in only:
        k17_rows(torch, dev, native, emit, **timers)

    if "k3" in only:
        import types

        cap, c, d, k, start = 1 << 20, 4, 512, 1000, 1_000_000
        r = np.random.RandomState(5)
        dead_rows = np.sort(r.choice(start, 500, replace=False)).astype(np.int64)
        add_lo = r.rand(c, k) * 1e6
        add_hi = add_lo + r.rand(c, k)
        lanes = {"alive": torch.from_numpy(r.rand(cap) > 0.02).to(dev),
                 "mins": torch.from_numpy(r.rand(c, cap).astype(np.float32)).to(dev)}
        lanes["maxs"] = lanes["mins"] + 1
        base = {name: t.clone() for name, t in lanes.items()}
        h = np.zeros((c, 1))
        entry = types.SimpleNamespace(_dev=lanes, device=dev, capacity=cap, h_lo=h, h_hi=h)
        call = lambda: state_cache.ResidentState._apply_tail_device(entry, dead_rows, start, k,
                                                                      add_lo, add_hi)
        before = launched(call)
        # the same tail on uploaded inputs: the launches alone
        dead = np.full(d, cap, np.int32)
        dead[:500] = dead_rows
        a = 1024
        rows = np.full(a, cap, np.int32)
        rows[:k] = np.arange(start, start + k)
        lo32 = np.full((c, a), np.nan, np.float32)
        hi32 = np.full((c, a), np.nan, np.float32)
        lo32[:, :k] = state_cache._f32_down(add_lo)
        hi32[:, :k] = state_cache._f32_up(add_hi)
        on = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        dead_t, rows_t, lo_t, hi_t = on(dead), on(rows), on(lo32), on(hi32)
        if hasattr(state_cache, "tail_apply"):
            lo_k, hi_k = lo_t[:, :k].contiguous(), hi_t[:, :k].contiguous()
            launch = lambda: state_cache.tail_apply(lanes["alive"], lanes["mins"], lanes["maxs"],
                                                    dead_t, start, k, lo_k, hi_k)
            packed = np.concatenate([dead, lo32[:, :k].view(np.int32).ravel(),
                                     hi32[:, :k].view(np.int32).ravel()])

            def upload_launch():
                buf = state_cache._upload(packed, dev)
                v = buf[d:].view(torch.float32).view(2, c, k)
                state_cache.tail_apply(lanes["alive"], lanes["mins"], lanes["maxs"], buf[:d],
                                       start, k, v[0], v[1])
        else:
            def launch():
                state_cache.scatter_bool(lanes["alive"], dead_t, False)
                state_cache.scatter_bool(lanes["alive"], rows_t, True)
                state_cache.scatter_cols(lanes["mins"], rows_t, lo_t)
                state_cache.scatter_cols(lanes["maxs"], rows_t, hi_t)

            def upload_launch():
                r = torch.from_numpy(rows).to(dev)
                state_cache.scatter_bool(lanes["alive"], torch.from_numpy(dead).to(dev), False)
                state_cache.scatter_bool(lanes["alive"], r, True)
                state_cache.scatter_cols(lanes["mins"], r, torch.from_numpy(lo32).to(dev))
                state_cache.scatter_cols(lanes["maxs"], r, torch.from_numpy(hi32).to(dev))
        got = {name: t.clone() for name, t in lanes.items()}
        ref = {name: t.clone() for name, t in base.items()}
        state_cache.scatter_bool_plain(ref["alive"], dead_t, False)
        state_cache.scatter_bool_plain(ref["alive"], rows_t, True)
        state_cache.scatter_cols_plain(ref["mins"], rows_t, lo_t)
        state_cache.scatter_cols_plain(ref["maxs"], rows_t, hi_t)
        for name in lanes:
            lanes[name].copy_(base[name])
        launch()
        if not all(chip_smoke.bitwise_equal(got[x], ref[x]) and
                   chip_smoke.bitwise_equal(lanes[x], ref[x]) for x in lanes):
            raise SystemExit("kernel_ab: the tail apply != the plain sequence")
        keep_dead, keep_rows = dead_t[:500].long(), rows_t[:k].long()
        lo_v, hi_v = lo_t[:, :k].contiguous(), hi_t[:, :k].contiguous()

        def library():
            lanes["alive"].index_fill_(0, keep_dead, False)
            lanes["alive"].index_fill_(0, keep_rows, True)
            lanes["mins"].index_copy_(1, keep_rows, lo_v)
            lanes["maxs"].index_copy_(1, keep_rows, hi_v)

        b, _ = chip_smoke.bound(500 * 4 + 500 + k + 2 * c * k * 4 * 2)
        emit("tail_apply", shape=f"C={c} cap={cap} d={d} (500 dead rows), a=1024 ({k} rows)",
             launches=launched(launch), call_launches=before, bound_ms=b,
             ms=cuda_ms(launch, 200), host_us=host_us(launch, 200),
             graph_ms=graph_ms(launch, 50), breakdown_us=kernel_breakdown(launch),
             upload_launch_ms=cuda_ms(upload_launch, 200),
             upload_launch_host_us=host_us(upload_launch, 200),
             call_ms=cuda_ms(call, 200), call_host_us=host_us(call, 200),
             library_ms=cuda_ms(library, 200))
        one = lambda: state_cache.scatter_cols(lanes["mins"], rows_t, lo_t)
        emit("scatter_cols", shape=f"C={c} cap={cap} a=1024 ({k} rows), one lane",
             launches=launched(one), ms=cuda_ms(one, 200), graph_ms=graph_ms(one, 50),
             library_ms=cuda_ms(lambda: lanes["mins"].index_copy_(1, keep_rows, lo_v), 200))
        del lanes, base, got, ref

    if "k9" in only:
        for traffic in ("config2", "spread", "dups", "outlier"):
            sk, sv, n, s = k9_traffic(torch, dev, key_cache, traffic)
            cap, cap_s = sk.shape[0], s.shape[0]
            fn = lambda: key_cache.slab_probe(sk, sv, n, s)
            got, ref = fn(), key_cache.slab_probe_plain(sk, sv, n, s)
            if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                raise SystemExit(f"kernel_ab: slab_probe != its plain version ({traffic})")
            mc = int(ref[1].sum())
            real, s64 = sk[:n], s.to(torch.int64)
            b, _ = chip_smoke.bound(5 * cap + 6 + cap_s // 8 + 4 * cap_s + 8 * cap_s + mc)
            emit("slab_probe", traffic=traffic,
                 shape=f"cap={cap} n={n} m={cap_s} int32, {mc} matched", bound_ms=b,
                 launches=launched(fn), ms=cuda_ms(fn, 20), host_us=host_us(fn, 20),
                 graph_ms=graph_ms(fn, 10), breakdown_us=kernel_breakdown(fn),
                 library_ms=cuda_ms(lambda: torch.searchsorted(real, s64), 20))
            del sk, sv, s, got, ref, real, s64
            torch.cuda.empty_cache()

    if "k10" in only:
        for traffic in ("config2", "spread"):
            sk, sv, n, s, perm = k9_traffic(torch, dev, key_cache, traffic, with_perm=True)
            _, t_match, s_first = key_cache.slab_probe(sk, sv, n, s)
            del sk, sv, s
            cap, mc = t_match.shape[0], int(t_match.sum())
            out_cap = state_cache._next_pow2(mc, floor=64)
            fn = k10_call(key_cache, t_match, s_first, perm, out_cap, mc)
            got = fn()
            if not torch.equal(got, key_cache.pair_compact_plain(t_match, s_first, perm,
                                                                 out_cap)):
                raise SystemExit(f"kernel_ab: pair_compact != its plain version ({traffic})")

            def library():
                idx = torch.nonzero(t_match).reshape(-1)
                return torch.index_select(perm, 0, idx), torch.index_select(s_first, 0, idx)

            b, _ = chip_smoke.bound(cap + 8 * mc + 8 * out_cap)
            emit("pair_compact", traffic=traffic, shape=f"cap={cap} n={n}, {mc} matched, "
                 f"out_cap={out_cap}", bound_ms=b, launches=launched(fn),
                 ms=[cuda_ms(fn, 20) for _ in range(3)], host_us=host_us(fn, 20),
                 graph_ms=graph_ms(fn, 10), breakdown_us=kernel_breakdown(fn),
                 library_ms=cuda_ms(library, 20),
                 finalize=k10_finalize(torch, key_cache, t_match, s_first, perm, out_cap, mc))
            del t_match, s_first, perm, got
            torch.cuda.empty_cache()

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
        from delta_tpu_torch.ops import pruning

        # the redesign runs K15 on K14's body with its tables in the launch's
        # parameters or staged; before it, every call uploaded its program
        # from pageable memory, which a CUDA graph cannot capture
        k15_capturable = hasattr(device_eval, "_k15_blocks")
        env = chip_smoke.k15_columns(1_005_000, 3, dev)
        # the NULL-heavy FLAGALL: an IN whose column option is half NULL
        half = dict(env, b=device_eval.DeviceColumn(env["b"].values, torch.from_numpy(
            np.random.RandomState(7).rand(1_005_000) > 0.5).to(dev)))
        runs = [(sql, device_eval.compile_expr(parse_expression(sql)).program(env), env, "")
                for sql in K15_PROGRAMS]
        sql = "a IN (b, 3, NULL)"
        runs.append((sql, device_eval.compile_expr(parse_expression(sql)).program(half), half,
                     ", b 50% NULL"))
        sql, program, leg = k15_normal_leg(torch, dev, pruning, state_export)
        runs.append((sql, program, leg, ", the normal leg's declined program"))
        for sql, program, e, note in runs:
            fn = lambda: device_eval.expr_eval(program, e)
            got, ref = fn(), device_eval.expr_eval_plain(program, e)
            same = (chip_smoke.ulp_diff(got.values, ref.values)[1] <= 1  # exp: 1 ulp
                    if got.values.is_floating_point() else torch.equal(got.values, ref.values))
            if not (same and torch.equal(got.valid, ref.valid)):
                raise SystemExit(f"kernel_ab: expr_eval != its plain version ({sql})")
            n = got.values.numel()
            lanes = [e[c] for c in program.columns]
            b, _ = chip_smoke.bound(sum(c.values.element_size() + 1 for c in lanes) * n
                                    + (got.values.element_size() + 1) * n)
            row = dict(shape=f"n={n} {len(program.instrs)} instructions over {len(lanes)} "
                             f"lanes ({sql}{note})", bound_ms=b, launches=launched(fn),
                       ms=[cuda_ms(fn, 50) for _ in range(3)], host_us=host_us(fn),
                       breakdown_us=kernel_breakdown(fn))
            row["graph_ms"] = graph_ms(fn, 20) if k15_capturable else None
            emit("expr_eval", **row)
        # an IN whose option column is NULL in the last row only: every row
        # where the value is in no option is NULL; the rows whose validity
        # differs from the plain version's, three calls
        last = np.ones(1_005_000, bool)
        last[-1] = False
        tail = dict(env, a=device_eval.DeviceColumn(env["a"].values, torch.from_numpy(last).to(dev)),
                    g=device_eval.DeviceColumn(env["g"].values, torch.ones_like(env["g"].valid)))
        sql = "b IN (a, g)"
        program = device_eval.compile_expr(parse_expression(sql)).program(tail)
        ref = device_eval.expr_eval_plain(program, tail)
        emit("expr_eval", shape=f"n=1005000 ({sql}, a NULL in the last row only)",
             valid_rows_differing=[int((device_eval.expr_eval(program, tail).valid != ref.valid)
                                       .sum()) for _ in range(3)])

    if "combine" in only:
        combine_rows(torch, dev, emit, timers, chip_smoke)
    if "k16" in only:
        k16_rows(torch, dev, emit, timers, chip_smoke)
    if "k4" in only:
        k4_rows(torch, dev, emit, timers, chip_smoke, state_export)
    if "codec" in only:
        codec_ab_rows(torch, dev, emit, timers, chip_smoke)

    if "l2" in only:
        table = torch.randint(0, 1 << 62, (1 << 21,), dtype=torch.int64, device=dev)
        idx = torch.randint(0, 1 << 21, (16_777_216,), dtype=torch.int64, device=dev)
        ms = cuda_ms(lambda: torch.take(table, idx), 20)
        emit("l2_gather", shape="16,777,216 random int64 reads from a 16 MB table", ms=ms,
             sectors_per_s=16_777_216 / (ms / 1e3))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch port (``delta_tpu_torch``) once on one NVIDIA card.

    python3 chip_smoke.py

Phases, each reported on its own line:

1. the device: ``torch.cuda.get_device_name(0)``, the device count, and the
   card's name and power limit from ``nvidia-smi``;
2. build: compile every CUDA kernel from ``delta_tpu_torch/csrc`` (one nvcc
   per source, in parallel) and load it;
3. kernels: each kernel against its plain PyTorch version on the card, with
   EXACT equality — the block cull at C=4, cap=2^20, M=256 (NaN lanes on
   both sides, dead rows), the tail scatters at cap=2^20 with 8..1024 rows
   (pads included), the winner bits at n=2^20 and 2^24, the expression
   interpreter (K15) at 2^20 rows over a corpus of programs that covers
   every opcode and dtype (NaN and ±inf lanes, timestamps before 1970,
   int32 overflow, saturating casts, an IN with a NULL in a column option),
   bit for bit except exp/log/pow/sqrt, where the lanes that differ are
   counted and must be within 1 ulp, and the replay (K5) at n=2^20 (pads,
   removes on both sides of the retention cutoff, re-added paths);
4. the scan-planning path at full size, with every launch counter set to 0
   just before and read just after: a 1M-file table laid out as the hot-plan
   benchmark's
   config 6 (``bench.py:915-1000``, seed 13: 4 stats columns, well
   clustered) written as JSON commits through the port's LogStore (v0 =
   protocol + metadata, then 10 commits of 100k adds); ``DeltaLog`` on the
   card; ``files_for_scan`` for 256 point-range predicates; the same 256 as
   one batched plan; 10 tail commits (1k adds + 500 removes each), each
   applied incrementally and re-planned; ``replay_columns`` on the card.
   Every plan is checked against the float64 host evaluation over the
   mirrors, which does not use the block cull;
5. the normal leg and the tombstone replay on the same table, with the
   counters set to 0 again: three queries the resident planner declines
   (each checked to be declined), planned by ``files_for_scan`` through the
   K15 interpreter on the card and checked file for file against the host
   prune (``_prune_host``, numpy); one query that synthesis makes exact,
   served by the resident planner; ``replay_alive_mask`` over the log's
   whole action stream, whose alive set must be the snapshot's live files
   and whose tombstones the host replay's;
6. per kernel: time on the card (CUDA events, warmed, many launches) at the
   main path's shapes and inputs, the plain version's time, the least time
   the card could take (bytes over 3.35 TB/s or compares over 33.5e12/s,
   whichever is larger) and, where one PyTorch call computes the
   same function, that call's time; one JSON line lists them;
7. last line: ``{"ok": true, "device": {...}}``.

``--kernels-only`` stops after phase 3 (a quick check of a kernel change);
it prints no result line.

It exits non-zero, and prints no result line, when there is no CUDA device,
when a kernel does not build, launch or agree, or when any check fails.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from delta_tpu_torch import DeltaLog
from delta_tpu_torch.expr import device_eval, ir
from delta_tpu_torch.expr.parser import parse_expression
from delta_tpu_torch.ops import native, pruning, replay_kernel, state_cache, state_export
from delta_tpu_torch.protocol import filenames
from delta_tpu_torch.protocol.actions import (
    AddFile, Metadata, Protocol, RemoveFile, actions_from_lines,
)
from delta_tpu_torch.schema.types import DoubleType, LongType, StructType

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# H100 SXM fp32 outside the tensor cores is 67e12 FLOP/s counting an FMA as
# two operations; a compare is one instruction per lane per cycle, half that
COMPARES_PER_S = 67e12 / 2
N_FILES = 1_000_000
N_COMMITS = 10
N_QUERIES = 256
N_TAILS = 10
TAIL_ADDS, TAIL_REMOVES = 1000, 500
SEED = 13


class SmokeFailure(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def say(*parts):
    print(*parts, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, warm=3):
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bitwise_equal(a, b):
    """Exact equality, NaN included, through the bit patterns."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def max_abs_err(a, b):
    if a.is_floating_point():
        both_nan = torch.isnan(a) & torch.isnan(b)
        d = torch.where(both_nan, torch.zeros_like(a), (a - b).abs())
        return float(torch.nan_to_num(d, nan=float("inf")).max())
    return float((a.to(torch.int64) - b.to(torch.int64)).abs().max())


# -- phase 3: each kernel against its plain version ----------------------------


def synthetic_checks(dev):
    rng = np.random.RandomState(1)
    c, cap, m = 4, 1 << 20, 256
    mins = (rng.rand(c, cap) * 100).astype(np.float32)
    maxs = mins + (rng.rand(c, cap) * 0.5).astype(np.float32)
    mins[:, rng.rand(cap) < 0.02] = np.nan
    maxs[:, rng.rand(cap) < 0.02] = np.nan
    alive = rng.rand(cap) > 0.1
    alive[-5000:] = False  # the capacity pad
    lo = (rng.rand(m, c) * 100).astype(np.float32)
    hi = lo + np.float32(0.05)
    lo[rng.rand(m, c) < 0.3] = np.nan
    hi[rng.rand(m, c) < 0.3] = np.nan
    ts = [torch.from_numpy(a).to(dev) for a in (mins, maxs, alive, lo, hi)]
    got = state_cache.block_cull(*ts)
    torch.cuda.synchronize()
    check(bitwise_equal(got, state_cache.block_cull_plain(*ts)), "block_cull != plain")
    say(f"kernels: block_cull C={c} cap={cap} M={m} exact, {int(got.ne(0).sum())} nonzero bytes")

    for d in (8, 64, 512, 1024):
        rows = np.full(d, cap, np.int32)
        k = d - d // 8
        rows[:k] = rng.choice(cap, k, replace=False)
        r = torch.from_numpy(rows).to(dev)
        a = torch.from_numpy(rng.rand(cap) > 0.5).to(dev)
        b = a.clone()
        state_cache.scatter_bool(a, r, False)
        state_cache.scatter_bool_plain(b, r, False)
        x = torch.from_numpy(mins).to(dev)
        y = x.clone()
        v = torch.from_numpy(rng.rand(c, d).astype(np.float32)).to(dev)
        state_cache.scatter_cols(x, r, v)
        state_cache.scatter_cols_plain(y, r, v)
        torch.cuda.synchronize()
        check(torch.equal(a, b), f"scatter_bool != plain at d={d}")
        check(bitwise_equal(x, y), f"scatter_cols != plain at a={d}")
    say("kernels: scatter_bool, scatter_cols cap=2^20 d=a=8..1024 exact")

    for n in (1 << 20, 1 << 24):
        num_paths = n // 10
        pid = rng.randint(0, num_paths, n).astype(np.int32)
        pid[-(n // 64):] = -1  # pads
        p = torch.from_numpy(pid).to(dev)
        got = replay_kernel.winner_bits(p, num_paths)
        torch.cuda.synchronize()
        check(torch.equal(got, replay_kernel.winner_bits_plain(p, num_paths)),
              f"winner_bits != plain at n={n}")
    say("kernels: winner_bits n=2^20, 2^24 exact")
    k15_checks(dev)
    k5_checks(dev)


#: the K15 corpus: every opcode and register dtype, NaN and ±inf lanes,
#: timestamps before 1970, int32 and int64 overflow, saturating casts, IN
#: with a NULL in a column option, scalars, Kleene logic
K15_CORPUS = [
    "a > 2 AND (b < 20 OR flag)", "NOT (a = 2) OR a IS NULL", "a IN (1, 4, 5)",
    "a >= i OR b <= g", "big != i",
    "a IN (b, 3, NULL)", "(a IN (1, 2)) IN (flag, (a IN (b, NULL)))", "big IN (i, NULL)",
    "a + 1 > 3", "b / 2 > 1", "b / a", "a / 0", "a * 2 = 8", "b IS NOT NULL AND b > 0",
    "i + 1", "i * i", "- i", "abs(i)", "big * big", "big + i", "- big", "abs(big)",
    "2147483647 + 1", "9223372036854775807 + 1", "b + g", "big + g", "i + b", "g * g - g",
    "CAST(b AS INT)", "CAST(b AS BIGINT)", "CAST(g AS INT)", "CAST(g AS BIGINT)",
    "CAST(big AS INT)", "CAST(b AS BOOLEAN)", "CAST(a AS DOUBLE)", "CAST(i AS FLOAT) > g",
    "NOT b", "flag + flag", "flag * flag", "flag + 1", "abs(flag)", "abs(g)", "- b",
    "floor(b)", "ceil(g)", "floor(a)", "ceil(b)", "floor(g)",
    "exp(b)", "sqrt(b)", "log(b)", "pow(b, 2)", "pow(a, b)", "sqrt(a)", "log(g)", "exp(g)",
    "hour(t)", "minute(t)", "second(t)", "hour(i)", "minute(i)", "second(a)", "hour(g)",
    "hour(flag)", "date_add(a, 7)", "date_sub(b, i)", "date_add(flag, a)",
    "date_sub(i, big)", "datediff(a, b)", "datediff(i, big)",
    "coalesce(a, b)", "coalesce(NULL, a, 5)", "coalesce(g, big)",
    "CASE WHEN a > 3 THEN 1 WHEN a > 1 THEN 2 ELSE 3 END",
    "CASE WHEN flag THEN b ELSE g END", "CASE WHEN a > 0 THEN NULL END",
    "a <=> b", "a <=> NULL", "NULL + 1", "1 + 2 > 2", "TRUE AND NULL", "NULL OR a > 1",
    "NOT NULL", "a > NULL", "g > 1e40", "(a > 1) = (b > 1)", "i <=> g", "b IN (a, g)",
]
_TRANSCENDENTAL = ("exp(", "log(", "pow(", "sqrt(")


def k15_columns(n, seed, dev):
    """Columns of every dtype the interpreter reads, with the edge lanes
    first: NaN, ±inf, -0.0, int32 / int64 extremes, negative timestamps."""
    rng = np.random.RandomState(seed)
    edges = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 1e300, -1e300, 3e9, -3e9, 9.3e18,
                      -9.3e18, 2.5, -2.5, -1e-300])
    cols = {
        "a": rng.randint(-10, 10, n).astype(np.int64),
        "b": np.concatenate([edges, rng.randn(n - len(edges)) * 1e3]),
        "i": np.concatenate([[2**31 - 1, -2**31, 0, -1],
                             rng.randint(-2**31, 2**31 - 1, n - 4)]).astype(np.int32),
        "g": np.concatenate([[np.nan, 3e9, -3e9, np.inf], rng.randn(n - 4) * 100]
                            ).astype(np.float32),
        "flag": rng.rand(n) > 0.5,
        "t": np.concatenate([[-1.0, -3_600_000_001.0, -0.0, 86_399_999_999.0],
                             rng.randn(n - 4) * 1e12]),
        "big": np.concatenate([[2**63 - 1, -2**63], rng.randint(-2**62, 2**62, n - 2)]
                              ).astype(np.int64),
    }
    masks = {k: rng.rand(n) > 0.1 for k in cols}
    return device_eval.columns_from_numpy(cols, masks, device=dev)


def ulp_diff(a, b):
    """Lanes where two float tensors differ (NaN equal to NaN), and the
    largest difference in units of the last place among them."""
    ints = torch.int64 if a.dtype == torch.float64 else torch.int32
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    if bool(same.all()):
        return 0, 0
    d = (a.view(ints).to(torch.float64) - b.view(ints).to(torch.float64)).abs()
    return int((~same).sum()), int(d[~same].max())


def k15_checks(dev):
    n = 1 << 20
    env = k15_columns(n, 3, dev)
    seen_ops, seen_dts, diffs, faults = set(), set(), [], []
    for sql in K15_CORPUS:
        program = device_eval.compile_expr(parse_expression(sql)).program(env)
        seen_ops.update(program.opcodes())
        seen_dts.update(program.instrs[:, 1].tolist())
        got = device_eval.expr_eval(program, env)
        torch.cuda.synchronize()
        ref = device_eval.expr_eval_plain(program, env)
        if got.values.dtype != ref.values.dtype or got.values.shape != ref.values.shape:
            faults.append(f"{sql}: dtype or shape differs from plain")
            continue
        if not torch.equal(got.valid, ref.valid):
            faults.append(f"{sql}: validity differs from plain")
        if got.values.is_floating_point():
            lanes, ulps = ulp_diff(got.values, ref.values)
            if lanes:
                diffs.append(f"{sql}: {lanes} lanes <= {ulps} ulp")
                if not (any(f in sql for f in _TRANSCENDENTAL) and ulps <= 1):
                    bad = ((got.values != ref.values)
                           & ~(torch.isnan(got.values) & torch.isnan(ref.values)))
                    at = torch.nonzero(bad.reshape(-1))[:3].reshape(-1).tolist()
                    sample = [(i, {k: c.values.reshape(-1)[i].item() for k, c in env.items()
                                   if k in program.columns},
                               got.values.reshape(-1)[i].item(), ref.values.reshape(-1)[i].item())
                              for i in at]
                    faults.append(f"{sql}: {lanes} lanes differ by up to {ulps} ulp, e.g. "
                                  f"(row, inputs, kernel, plain) {sample}")
        elif not torch.equal(got.values, ref.values):
            faults.append(f"{sql}: values differ from plain")
    for f in faults:
        say(f"kernels: K15 FAULT {f}")
    check(not faults, f"K15 differs from its plain version on {len(faults)} programs")
    missing = set(device_eval.OPS) - seen_ops
    check(not missing, f"K15 corpus misses opcodes {sorted(missing)}")
    check(seen_dts >= set(range(5)), "K15 corpus misses a dtype")
    say(f"kernels: expr_eval n=2^20 x {len(K15_CORPUS)} programs, all {len(device_eval.OPS)} "
        f"opcodes, 5 dtypes: bit-exact except transcendentals "
        f"{diffs if diffs else '(none differ)'}")


def k5_checks(dev):
    n = 1 << 20
    rng = np.random.RandomState(11)
    num_paths = n // 4  # most paths re-added or removed several times
    pid = rng.randint(0, num_paths, n).astype(np.int32)
    pid[-(n // 50):] = -1  # the pad
    seq = (rng.permutation(n).astype(np.int64) << 8) + 7
    is_add = rng.rand(n) > 0.3
    size = rng.randint(0, 2**62, n).astype(np.int64)  # the int64 sum wraps
    dts = rng.randint(0, 2000, n).astype(np.int64)
    cols = [torch.from_numpy(x).to(dev) for x in (pid, seq, is_add, size, dts)]
    for cutoff in (0, 1000):
        got = replay_kernel.replay(*cols, num_paths, cutoff)
        torch.cuda.synchronize()
        ref = replay_kernel.replay_plain(*cols, num_paths, cutoff)
        for g, r, what in zip(got, ref, ("alive", "tombstone", "sums")):
            check(torch.equal(g, r), f"K5 {what} != plain at cutoff {cutoff}")
    say(f"kernels: replay n=2^20 num_paths={num_paths} cutoffs 0, 1000 exact "
        f"(sums {ref[2].tolist()})")


# -- phase 4: the slice at full size -------------------------------------------


def write_config6_table(path):
    """The hot-plan benchmark's config 6 table (bench.py:915-1000, seed 13):
    N_FILES files, 4 indexed stats columns (c0/c2 long, c1/c3 double), each
    file covering a narrow range per column, as JSON commits."""
    log_path = os.path.join(path, "_delta_log")
    from delta_tpu_torch.storage.logstore import LocalLogStore

    store = LocalLogStore()
    rng = np.random.RandomState(SEED)
    schema = StructType()
    for c in range(4):
        schema = schema.add(f"c{c}", DoubleType() if c % 2 else LongType())
    store.write(f"{log_path}/{filenames.delta_file(0)}",
                [Protocol(1, 2).json(), Metadata(schema_string=schema.to_json()).json()])
    base = {f"c{c}": np.sort(rng.rand(N_FILES) * 1e6) if c % 2 else
            np.sort(rng.randint(0, 1 << 40, N_FILES).astype(np.int64))
            for c in range(4)}
    width = {f"c{c}": 1e6 / N_FILES * 8 if c % 2 else max((1 << 40) // N_FILES * 8, 1)
             for c in range(4)}
    per = N_FILES // N_COMMITS
    nulls = {c: 0 for c in base}
    for v in range(N_COMMITS):
        lines = []
        for i in range(v * per, (v + 1) * per):
            mins = {c: (float(x[i]) if c in ("c1", "c3") else int(x[i])) for c, x in base.items()}
            maxs = {c: (float(x[i] + width[c]) if c in ("c1", "c3") else int(x[i] + width[c]))
                    for c, x in base.items()}
            stats = json.dumps({"numRecords": 10000, "minValues": mins,
                                "maxValues": maxs, "nullCount": nulls})
            lines.append(AddFile(path=f"part-{i:07d}.parquet", size=1 << 20,
                                 modification_time=0, data_change=False,
                                 stats=stats).json())
        store.write(f"{log_path}/{filenames.delta_file(v + 1)}", lines)
    queries = []
    for _ in range(N_QUERIES):
        i = rng.randint(N_FILES)
        lo0 = int(base["c0"][i])
        lo1 = float(base["c1"][i])
        queries.append(f"c0 >= {lo0} AND c0 <= {lo0 + int(width['c0'])} "
                       f"AND c1 >= {lo1:.6f} AND c1 <= {lo1 + width['c1']:.6f}")
    return store, queries


def write_tail_commit(store, log_path, version, rng, live):
    """TAIL_ADDS fresh files (narrow random ranges) + TAIL_REMOVES removes of
    live files."""
    gone = rng.choice(len(live), TAIL_REMOVES, replace=False)
    acts = [RemoveFile(path=live[j], deletion_timestamp=version, data_change=True).json()
            for j in gone]
    for j in sorted(gone, reverse=True):
        live[j] = live[-1]
        live.pop()
    for k in range(TAIL_ADDS):
        c0 = int(rng.randint(0, 1 << 40))
        c1 = float(rng.rand() * 1e6)
        st = json.dumps({"numRecords": 100,
                         "minValues": {"c0": c0, "c1": c1, "c2": c0, "c3": c1},
                         "maxValues": {"c0": c0 + (1 << 23), "c1": c1 + 8.0,
                                       "c2": c0 + (1 << 23), "c3": c1 + 8.0},
                         "nullCount": {"c0": 0, "c1": 0, "c2": 0, "c3": 0}})
        p = f"tail-{version:03d}-{k:04d}.parquet"
        acts.append(AddFile(path=p, size=1 << 16, modification_time=version,
                            data_change=True, stats=st).json())
        live.append(p)
    store.write(f"{log_path}/{filenames.delta_file(version)}", acts)


def lower(entry, snapshot, q):
    """The range box ``files_for_scan`` plans for predicate ``q``."""
    rw = pruning.conjunct_rewrites([parse_expression(q)], frozenset(),
                                   pruning.schema_types(snapshot.metadata))
    terms = state_cache.extract_range_union(
        ir.and_all([r.rewritten for r in rw]), entry.columns,
        entry.part_info, str_lanes=entry.str_lanes)
    check(terms is not None and len(terms) == 1 and terms[0].exact, f"not one exact box: {q}")
    return terms[0]


def check_batch(entry, ranges, label):
    """The batched device plan (block cull + fine pass) equals the float64
    host evaluation on the mirrors, row for row; returns the batch's ms."""
    k = entry.num_rows
    host = entry.plan_ranges(ranges, k=k, use_device=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev = entry.plan_ranges(ranges, k=k)
    plan_ms = (time.perf_counter() - t0) * 1e3
    for i, (d, h) in enumerate(zip(dev, host)):
        check(d.via == "device", f"{label}: query {i} not planned on the card")
        check(np.array_equal(d.rows, h.rows), f"{label}: query {i} differs from the host plan")
    return plan_ms, host


def run_slice(dev, workdir):
    path = os.path.join(workdir, "config6")
    t0 = time.perf_counter()
    store, queries = write_config6_table(path)
    say(f"slice: wrote {N_FILES} files in {N_COMMITS} JSON commits in "
        f"{time.perf_counter() - t0:.3f} s")

    native.reset_launches()  # -- the main path starts here
    DeltaLog.clear_cache()
    state_cache.DeviceStateCache.reset()
    log = DeltaLog.for_table(path, device=dev)
    check(log.device == dev, "DeltaLog is not on the card")
    t0 = time.perf_counter()
    snap = log.update()
    check(snap.num_of_files == N_FILES, f"snapshot has {snap.num_of_files} files")
    decode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    entry = state_cache.DeviceStateCache.instance().get(snap)
    check(entry is not None, "no resident entry")
    entry.ensure_resident()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    say(f"slice: decode {decode_s:.3f} s, resident build {build_s:.3f} s "
        f"(capacity {entry.capacity}, {len(entry.columns)} lanes)")

    ranges = [lower(entry, snap, q) for q in queries]
    host = entry.plan_ranges(ranges, k=entry.num_rows, use_device=False)
    scans, scan_ms = [], []
    for q in queries:
        t0 = time.perf_counter()
        scans.append(pruning.files_for_scan(snap, [parse_expression(q)]))
        scan_ms.append((time.perf_counter() - t0) * 1e3)
    for q, s, h in zip(queries, scans, host):
        check([f.path for f in s.files] == sorted(entry.paths[r] for r in h.rows),
              f"files_for_scan differs from the host plan: {q}")
        check(s.total.files == N_FILES, "total DataSize")
    n_kept = sum(len(s.files) for s in scans)
    p50, p99 = np.percentile(scan_ms, [50, 99])
    say(f"slice: files_for_scan x{N_QUERIES}: first {scan_ms[0]:.3f} ms, then p50 {p50:.3f} "
        f"p99 {p99:.3f} max {max(scan_ms[1:]):.3f} ms; {n_kept} files kept, all equal "
        "the host plan")
    plan_ms = [check_batch(entry, ranges, "batch")[0] for _ in range(3)]
    say(f"slice: batched plan of {N_QUERIES} queries: {plan_ms} ms (equal to the host plan)")

    rng = np.random.RandomState(SEED + 1)
    live = list(entry.paths)
    tail_ms, tail_plan_ms = [], []
    for t in range(N_TAILS):
        v = N_COMMITS + 1 + t
        write_tail_commit(store, log.log_path, v, rng, live)
        snap = log.update()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e = state_cache.DeviceStateCache.instance().get(snap)
        torch.cuda.synchronize()
        tail_ms.append((time.perf_counter() - t0) * 1e3)
        check(e is entry and e.version == v, "tail was not applied incrementally")
        ranges = [lower(entry, snap, q) for q in queries]
        ms, host = check_batch(entry, ranges, f"tail {t}")
        tail_plan_ms.append(ms)
        for q, h in list(zip(queries, host))[:: 32]:
            s = pruning.files_for_scan(snap, [parse_expression(q)])
            check([f.path for f in s.files] == sorted(entry.paths[r] for r in h.rows),
                  f"files_for_scan after tail {t} differs: {q}")
    n_live = N_FILES + N_TAILS * (TAIL_ADDS - TAIL_REMOVES)
    check(snap.num_of_files == n_live == int(entry.h_alive.sum()), "live file count after tails")
    say(f"slice: {N_TAILS} tails applied in place: tail-apply ms {[round(x, 3) for x in tail_ms]}, "
        f"re-plan ms {[round(x, 3) for x in tail_plan_ms]} (all equal to the host plan)")

    cols = snap._columnar
    t0 = time.perf_counter()
    rep = replay_kernel.replay_columns(cols, device=dev)
    replay_ms = (time.perf_counter() - t0) * 1e3
    alive, tomb = cols.replay()
    check(np.array_equal(rep.alive, alive) and np.array_equal(rep.tombstone, tomb),
          "replay_columns on the card differs from the host winner")
    check(int(rep.stats.num_files) == n_live, "replay file count")
    say(f"slice: replay_columns over {cols.num_rows} rows in {replay_ms:.3f} ms "
        f"(equal to the host winner)")

    launches = dict(native.launches)  # -- the main path ends here
    say(f"slice: launches on the scan-planning path {launches}")
    for name in ("block_cull", "scatter_bool", "scatter_cols", "winner_bits"):
        check(launches[name] > 0, f"kernel {name} was not launched on the scan-planning path")
    return {"entry": entry, "ranges": ranges, "cols": cols, "launches": launches,
            "log": log, "snap": snap, "store": store, "n_live": n_live}


# -- phase 5: the normal leg and the tombstone replay ----------------------------


def fallback_queries():
    """Three queries the resident planner declines on config 6 (a strict
    float bound, a multi-column interval, a null count) and one that
    synthesis makes exact."""
    declined = ["c0 != 123456789 AND c1 > 999000.5", "c0 * c1 > 1.0e18",
                "c2 IS NULL OR c3 * 2 > 1999000.5"]
    exact = "c0 * 2 + 10 >= 2198000000010"
    return declined, exact


def log_actions(store, log_path, version):
    return [(v, actions_from_lines(store.read(f"{log_path}/{filenames.delta_file(v)}")))
            for v in range(version + 1)]


def run_fallback(dev, ctx):
    snap, log, store = ctx["snap"], ctx["log"], ctx["store"]
    declined, exact = fallback_queries()
    meta = snap.metadata
    t0 = time.perf_counter()
    files = snap.all_files  # materialized once per snapshot, as the leg needs
    all_files_s = time.perf_counter() - t0

    native.reset_launches()  # -- the normal leg's path starts here
    scan_ms, kept = [], []
    for q in declined:
        filters = [parse_expression(q)]
        check(pruning._resident_scan(snap, [], filters) is None,
              f"the resident planner served {q!r}; it should decline")
        before = native.launches["expr_eval"]
        t0 = time.perf_counter()
        s = pruning.files_for_scan(snap, filters)
        scan_ms.append((time.perf_counter() - t0) * 1e3)
        check(native.launches["expr_eval"] > before, f"{q!r} did not launch K15")
        kept.append(s)
    s_exact = pruning.files_for_scan(snap, [parse_expression(exact)])
    check(native.launches["block_cull"] > 0, f"{exact!r} was not served by the resident planner")
    t0 = time.perf_counter()
    stream = state_export.actions_to_arrays(log_actions(store, log.log_path, snap.version))
    stream_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rep = replay_kernel.replay_alive_mask(stream, min_retention_ts=N_COMMITS + 5, device=dev)
    replay_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(native.launches)  # -- the normal leg's path ends here
    say(f"normal leg: launches {launches}")
    for name in ("expr_eval", "replay", "block_cull"):
        check(launches[name] > 0, f"kernel {name} was not launched on the normal leg")

    # each declined query against the host prune over the same files
    for q, s in zip(declined, kept):
        rw = ir.and_all([r.rewritten for r in pruning.conjunct_rewrites(
            [parse_expression(q)], frozenset(), pruning.schema_types(meta))])
        t0 = time.perf_counter()
        host = pruning._prune_host(files, meta, rw)
        host_s = time.perf_counter() - t0
        want = [f.path for f, k in zip(files, host) if k]
        check([f.path for f in s.files] == want, f"{q!r}: the card's files differ from the host prune")
        check(s.total.files == ctx["n_live"], f"{q!r}: total DataSize")
        say(f"normal leg: {q!r}: {len(want)} of {len(files)} files, equal to the host prune "
            f"({host_s:.3f} s on the host)")
    host_exact = ctx["entry"].plan_ranges(
        [lower(ctx["entry"], snap, exact)], k=ctx["entry"].num_rows, use_device=False)[0]
    check([f.path for f in s_exact.files] == sorted(ctx["entry"].paths[r] for r in host_exact.rows),
          f"{exact!r}: the resident plan differs from the host plan")
    say(f"normal leg: {exact!r} served resident, {len(s_exact.files)} files, equal to the host "
        "plan")

    # the replay against the snapshot and the host replay
    live = {stream.paths[stream.path_id[i]] for i in np.nonzero(rep.alive)[0]}
    check(live == {f.path for f in files}, "replay_alive_mask: alive set != the snapshot's files")
    _, tomb = snap._columnar.replay(min_retention_ts=N_COMMITS + 5)
    check(int(rep.stats.num_tombstones) == int(tomb.sum()) > 0,
          f"replay_alive_mask: {int(rep.stats.num_tombstones)} tombstones, host {int(tomb.sum())}")
    check(int(rep.stats.num_files) == len(files), "replay_alive_mask: file count")
    check(int(rep.stats.total_size) == snap.size_in_bytes, "replay_alive_mask: total size")
    say(f"normal leg: replay_alive_mask over {stream.num_rows} actions in {replay_ms:.3f} ms "
        f"({stream_s:.3f} s to parse the log): {int(rep.stats.num_files)} live files, "
        f"{int(rep.stats.num_tombstones)} tombstones, equal to the snapshot and host replay")
    p50 = float(np.percentile(scan_ms, 50))
    say(f"normal leg: files_for_scan ms {[round(x, 3) for x in scan_ms]} (p50 {p50:.3f}); "
        f"all_files {all_files_s:.3f} s once")
    ctx.update(fallback_launches=launches, stream=stream, files=files, declined=declined,
               fallback_p50_ms=p50)


# -- phase 5: times and bounds at the main path's shapes -----------------------


def cull_ops(mins, maxs, alive, lo, hi):
    """Compares the block cull needs on these inputs: 2 per (query, live
    file, column) up to the first column that drops the file."""
    total = 0
    for q0 in range(0, lo.shape[0], 32):
        l, h = lo[q0:q0 + 32], hi[q0:q0 + 32]
        keep = alive[None, :].expand(l.shape[0], -1).clone()
        for c in range(mins.shape[0]):
            total += int(keep.sum())
            mn, mx = mins[c][None, :], maxs[c][None, :]
            keep &= torch.isnan(mx) | torch.isnan(l[:, c:c + 1]) | (mx >= l[:, c:c + 1])
            keep &= torch.isnan(mn) | torch.isnan(h[:, c:c + 1]) | (mn <= h[:, c:c + 1])
    return 2 * total


def bound(nbytes, compares=0):
    b, o = nbytes / HBM_BYTES_PER_S * 1e3, compares / COMPARES_PER_S * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def measure(dev, entry, ranges, cols, launches):
    out = []
    d = entry._dev
    m = len(ranges)
    lo = torch.from_numpy(state_cache._f32_down(np.stack([r.lo for r in ranges]))).to(dev)
    hi = torch.from_numpy(state_cache._f32_up(np.stack([r.hi for r in ranges]))).to(dev)
    args = (d["mins"], d["maxs"], d["alive"], lo, hi)
    got = state_cache.block_cull(*args)
    ref = state_cache.block_cull_plain(*args)
    check(bitwise_equal(got, ref), "block_cull != plain on the main path's lanes")
    c, cap = d["mins"].shape
    nbytes = 2 * c * cap * 4 + cap + 2 * m * c * 4 + got.numel()
    b, by = bound(nbytes, cull_ops(*args))
    out.append({
        "name": "block_cull", "route": "cuda", "source": "delta_tpu_torch/csrc/block_cull.cu",
        "replaces": "delta_tpu/ops/state_cache.py:986", "launches": launches["block_cull"],
        "max_abs_err": max_abs_err(got, ref),
        "ms": cuda_ms(lambda: state_cache.block_cull(*args), 50),
        "plain_ms": cuda_ms(lambda: state_cache.block_cull_plain(*args), 5),
        "bound_ms": b, "bound_by": by, "library_ms": None,
        "shape": f"C={c} cap={cap} M={m}"})

    # the tail shapes: 500 dead rows (d = 512), 1000 appended rows (a = 1024)
    rng = np.random.RandomState(5)
    rows_np = np.full(1024, cap, np.int32)
    rows_np[:1000] = np.arange(entry.num_rows - 1000, entry.num_rows, dtype=np.int32)
    dead_np = np.full(512, cap, np.int32)
    dead_np[:500] = rng.choice(entry.num_rows, 500, replace=False)
    rows, dead = torch.from_numpy(rows_np).to(dev), torch.from_numpy(dead_np).to(dev)
    alive = d["alive"].clone()
    a, b2 = alive.clone(), alive.clone()
    state_cache.scatter_bool(a, dead, False)
    state_cache.scatter_bool_plain(b2, dead, False)
    check(torch.equal(a, b2), "scatter_bool != plain at the tail shape")
    keep = dead[dead < cap].long()
    b, by = bound(512 * 4 + 500)
    out.append({
        "name": "scatter_bool", "route": "cuda", "source": "delta_tpu_torch/csrc/tail_scatter.cu",
        "replaces": "delta_tpu/ops/state_cache.py:959", "launches": launches["scatter_bool"],
        "max_abs_err": max_abs_err(a, b2),
        "ms": cuda_ms(lambda: state_cache.scatter_bool(a, dead, False), 200),
        "plain_ms": cuda_ms(lambda: state_cache.scatter_bool_plain(b2, dead, False), 50),
        "bound_ms": b, "bound_by": by,
        "library_ms": cuda_ms(lambda: alive.index_fill_(0, keep, False), 200),
        "shape": f"cap={cap} d=512 (500 rows + pads)"})

    vals = torch.from_numpy(rng.rand(c, 1024).astype(np.float32)).to(dev)
    x, y = d["mins"].clone(), d["mins"].clone()
    state_cache.scatter_cols(x, rows, vals)
    state_cache.scatter_cols_plain(y, rows, vals)
    check(bitwise_equal(x, y), "scatter_cols != plain at the tail shape")
    z = d["mins"].clone()
    kept_rows = rows[rows < cap].long()
    kept_vals = vals[:, :1000].contiguous()
    b, by = bound(1024 * 4 + c * 1024 * 4 + c * 1000 * 4)
    out.append({
        "name": "scatter_cols", "route": "cuda", "source": "delta_tpu_torch/csrc/tail_scatter.cu",
        "replaces": "delta_tpu/ops/state_cache.py:970", "launches": launches["scatter_cols"],
        "max_abs_err": max_abs_err(x, y),
        "ms": cuda_ms(lambda: state_cache.scatter_cols(x, rows, vals), 200),
        "plain_ms": cuda_ms(lambda: state_cache.scatter_cols_plain(y, rows, vals), 50),
        "bound_ms": b, "bound_by": by,
        "library_ms": cuda_ms(lambda: z.index_copy_(1, kept_rows, kept_vals), 200),
        "shape": f"C={c} cap={cap} a=1024 (1000 rows + pads)"})

    n = replay_kernel._next_pow2(cols.num_rows, floor=8)
    pid_np = np.full(n, -1, np.int32)
    pid_np[: cols.num_rows] = cols.path_id
    pid = torch.from_numpy(pid_np).to(dev)
    got = replay_kernel.winner_bits(pid, cols.num_paths)
    ref = replay_kernel.winner_bits_plain(pid, cols.num_paths)
    check(torch.equal(got, ref), "winner_bits != plain on the main path's stream")
    valid = pid >= 0
    pid64, idx = pid[valid].long(), torch.arange(n, device=dev)[valid]
    last = torch.empty(cols.num_paths, dtype=torch.int64, device=dev)
    b, by = bound(n * 4 + n // 8)
    out.append({
        "name": "winner_bits", "route": "cuda", "source": "delta_tpu_torch/csrc/winner_bits.cu",
        "replaces": "delta_tpu/ops/replay_kernel.py:115", "launches": launches["winner_bits"],
        "max_abs_err": max_abs_err(got, ref),
        "ms": cuda_ms(lambda: replay_kernel.winner_bits(pid, cols.num_paths), 50),
        "plain_ms": cuda_ms(lambda: replay_kernel.winner_bits_plain(pid, cols.num_paths), 10),
        "bound_ms": b, "bound_by": by,
        "library_ms": cuda_ms(lambda: last.fill_(-1).scatter_reduce_(0, pid64, idx, "amax"), 50),
        "shape": f"n={n} ({cols.num_rows} rows) num_paths={cols.num_paths}"})
    return out


def measure_normal_leg(dev, ctx):
    """K15 on the multi-column declined query's program over the live files' lanes,
    and K5 over the log's action stream: time, plain time, bound."""
    out = []
    meta, files = ctx["snap"].metadata, ctx["files"]
    q = ctx["declined"][1]
    rw = ir.and_all([r.rewritten for r in pruning.conjunct_rewrites(
        [parse_expression(q)], frozenset(), pruning.schema_types(meta))])
    t0 = time.perf_counter()
    arrays = state_export.files_to_arrays(files, meta)
    f2a_s = time.perf_counter() - t0
    program = pruning._compiled_skipping(rw).program_for(arrays.lane_dtypes())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    env = arrays.device_env(dev, names=program.columns)
    torch.cuda.synchronize()
    upload_ms = (time.perf_counter() - t0) * 1e3
    got = device_eval.expr_eval(program, env)
    ref = device_eval.expr_eval_plain(program, env)
    check(torch.equal(got.values, ref.values) and torch.equal(got.valid, ref.valid),
          "expr_eval != plain on the normal leg's lanes")
    n = arrays.num_files
    lane_bytes = sum(c.values.element_size() + 1 for c in env.values()) * n
    nbytes = lane_bytes + (got.values.element_size() + 1) * n
    b, by = bound(nbytes)
    out.append({
        "name": "expr_eval", "route": "cuda", "source": "delta_tpu_torch/csrc/expr_eval.cu",
        "replaces": "delta_tpu/expr/jaxeval.py:149", "launches": ctx["fallback_launches"]["expr_eval"],
        "max_abs_err": max_abs_err(got.values, ref.values),
        "ms": cuda_ms(lambda: device_eval.expr_eval(program, env), 50),
        "plain_ms": cuda_ms(lambda: device_eval.expr_eval_plain(program, env), 5),
        "bound_ms": b, "bound_by": by, "library_ms": None,
        "shape": f"n={n} {program.instrs.shape[0]} instructions over {len(env)} lanes ({q!r}); "
                 f"files_to_arrays {f2a_s:.3f} s, lane upload {upload_ms:.3f} ms"})

    stream = ctx["stream"]
    cap = replay_kernel._next_pow2(stream.num_rows, floor=8)
    cols = [torch.from_numpy(replay_kernel._pad(np.asarray(a, dt), cap, fill)).to(dev)
            for a, dt, fill in ((stream.path_id, np.int32, -1), (stream.seq, np.int64, 0),
                                (stream.is_add, bool, False), (stream.size, np.int64, 0),
                                (stream.deletion_timestamp, np.int64, 0))]
    num_paths, cutoff = len(stream.paths), N_COMMITS + 5
    got = replay_kernel.replay(*cols, num_paths, cutoff)
    ref = replay_kernel.replay_plain(*cols, num_paths, cutoff)
    check(all(torch.equal(g, r) for g, r in zip(got, ref)), "replay != plain on the log's stream")
    valid = cols[0] >= 0
    pid64, seq = cols[0][valid].long(), cols[1][valid]
    best = torch.empty(num_paths, dtype=torch.int64, device=dev)
    b, by = bound(cap * (4 + 8 + 1 + 8 + 8) + 2 * cap + 3 * 8)
    out.append({
        "name": "replay", "route": "cuda", "source": "delta_tpu_torch/csrc/replay.cu",
        "replaces": "delta_tpu/ops/replay_kernel.py:56", "launches": ctx["fallback_launches"]["replay"],
        "max_abs_err": max(max_abs_err(g, r) for g, r in zip(got, ref)),
        "ms": cuda_ms(lambda: replay_kernel.replay(*cols, num_paths, cutoff), 50),
        "plain_ms": cuda_ms(lambda: replay_kernel.replay_plain(*cols, num_paths, cutoff), 10),
        "bound_ms": b, "bound_by": by,
        "library_ms": cuda_ms(lambda: best.fill_(-(1 << 63)).scatter_reduce_(
            0, pid64, seq, "amax"), 50),
        "shape": f"n={cap} ({stream.num_rows} actions) num_paths={num_paths}"})
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = card_line()
    say(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | {card} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    say(f"build: {native.build_all():.3f} s")
    synthetic_checks(dev)
    if "--kernels-only" in sys.argv[1:]:
        return 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        ctx = run_slice(dev, workdir)
        run_fallback(dev, ctx)
        kernels = measure(dev, ctx["entry"], ctx["ranges"], ctx["cols"], ctx["launches"])
        kernels += measure_normal_leg(dev, ctx)
    for k in kernels:
        say(f"time: {k['name']} {k['shape']}: {k['ms']:.6f} ms (plain {k['plain_ms']:.6f}, "
            f"bound {k['bound_ms']:.6f} by {k['bound_by']}, library {k['library_ms']})")
    say(json.dumps({"kernels": [{key: v for key, v in k.items() if key != "shape"}
                                for k in kernels]}))
    say(card)
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                          "kind": torch.cuda.get_device_name(0),
                                          "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

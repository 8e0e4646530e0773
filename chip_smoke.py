#!/usr/bin/env python3
"""Drive the PyTorch port (``delta_tpu_torch``) once on one NVIDIA card.

    python3 chip_smoke.py

Phases, each reported on its own line:

1. the device: ``torch.cuda.get_device_name(0)``, the device count, and the
   card's name and power limit from ``nvidia-smi``;
2. build: compile every CUDA kernel from ``delta_tpu_torch/csrc`` (one nvcc
   per source, in parallel) and load it;
3. kernels: each kernel against its plain PyTorch version on the card, with
   EXACT equality — the block cull at C=4, cap=2^20, M=256, 1 and 257
   (NaN lanes on both sides, dead rows), the tail scatters at cap=2^20
   with 8..1024 rows (pads included) and the tail apply (K3 with K2 on its
   launch) at C=1 and 4 on ``tests/torch_kernel_cases.py``'s tails (wrapped
   and dropped rows, a range past cap, dead rows inside the added range),
   the winner bits (K4) at n = 8, 2^20 and 2^24 on
   ``tests/torch_kernel_cases.py``'s streams (config 5's and 6's shapes,
   random ids, one path on every row, zipf ids, num_paths = 1, all pads, no
   pad), twice in a row on one table (the first call must leave it valid),
   off a 16-byte boundary, and an out-of-range id, which
   ``winner_mask_device`` must raise, the expression
   interpreter (K15) at 2^20 rows over a corpus of programs that covers
   every opcode and dtype (NaN and ±inf lanes, timestamps before 1970,
   int32 overflow, saturating casts, an IN with a NULL in a column option),
   bit for bit except exp/log/pow/sqrt, where the lanes that differ are
   counted and must be within 1 ulp, the replay (K5) at n=2^20 (pads,
   removes on both sides of the retention cutoff, re-added paths), the
   MERGE key slab's kernels: the radix sort (K8) and the hash probe (K9)
   at n=2^20 and at cap=10,485,760 (duplicates, negatives, int64.max keys,
   pads, invalid rows, sentinels, absent keys, a dense band, source sizes 1
   and 2^20) and on ``tests/torch_kernel_cases.py``'s hard shapes at cap
   16,384 and 2^20 (an int32 source against keys beyond int32, both
   tables' empty-slot keys, runs of thousands of equal keys, duplicate
   sources, valid pad rows, m = 8, n = 0, n = cap, the sentinel-padded
   source), the pair compaction (K10) on empty, partial and full matches
   and at tests/torch_kernel_cases.py's hard shapes,
   the six slab updates (K11) with pads out of range, and the slab advance
   (K11's one launch an advance) on ``tests/torch_kernel_cases.py``'s
   advances at d = 64, 16,384 and 2^20 (a slice, a row list with pads and
   negative rows, runs; int32 and int64 keys; the sorted view mirrored), in
   place and into new lanes (the inputs then unchanged); and the upload
   join (K12), int32 and int64, at cap_t=12,582,912 and cap_s=2^20
   (sentinels at both ends of the range, duplicate runs on both sides, no
   match, all matched, one source key, the type's minimum: the hash
   table's empty-slot key); the residual mask (K14) over lanes of every
   dtype padded to 2^20 (1,044,255 real rows): string codes with present,
   absent and NULL literals, dates and timestamps before 1970 and +-10^6
   days away, the calendar opcodes, INs whose option is a column; and its
   batched launch over 76 files of 0 to 2^20 rows, each with its own
   dictionary, in two parameter blocks; the Morton interleave (K16) at
   2^22 rows for k = 1..6 (ties, ranks 0 and 65,535), and the Z-order
   sorts: the key's unsigned order and an integer column's rank (int64 and
   int32) on k = 6's key and on ``tests/torch_kernel_cases.py``'s sort
   cases (all equal, sorted, reversed, n = 1, 2 and 2^22 + 5), also against
   numpy's stable argsort; the link probe's warm-up (K17) at 8 and 2^20
   int32; the page codec (``snappy_compress``, ``snappy_decompress``) on
   one batch of ``tests/torch_kernel_cases.py``'s pages (0 B, 1 B, 64 KiB
   - 1, 64 KiB, 64 KiB + 1, literal-length edges, repeats, random bytes,
   store_sales columns' PLAIN and BYTE_STREAM_SPLIT pages, 1 MiB, 8 MiB):
   the kernel's Snappy decodes through the plain decoder, the plain
   compressor's through the kernel, byte for byte, the kernel's bytes
   within 1.03x of the plain compressor's on every page and on the batch,
   streams the port's compressor never writes (copy-4 offsets past 64 KiB,
   overlapping copies of every offset 1-63, literals of 1-4 length bytes,
   one long run) decode exactly, and malformed bodies (faults after a page's
   33rd element among them) raise ``SnappyError``, set their error words and
   write nothing outside their slots; and the state
   mesh's kernels over 8 shards of the one card: the
   combine kernel (sum, OR, OR + pack, at eight cards' shapes and small
   ones, and the mesh path's four sets with the eight-card shapes in one
   launch, every other set a slice off a 16-byte boundary), the sharded
   replay (K6) at n=2^20
   (zipf-skewed paths, one empty shard) also against K5, the sharded block
   cull (K7) on K1's lanes over 2, 4 and 8 shards also against K1
   unpacked, and the sharded join probe (K13), int32 and int64, at
   cap_t=16,777,216 and cap_s=2^20 (sentinels, duplicate runs, runs of
   equal keys across the shard boundaries) also against K12;
4. the scan-planning path at full size, with every launch counter set to 0
   just before and read just after (phases 4 and 5 pin
   ``stateCache.devicePlan.mode=force``, phase 9 ``deviceResidual.mode=
   force``: they count the kernels of a route, and under ``auto`` the router
   may price the host side cheaper): a 1M-file table laid out as the hot-plan
   benchmark's
   config 6 (``bench.py:915-1000``, seed 13: 4 stats columns, well
   clustered) in the bench's layout (``bench.py:959-985``): v0's JSON
   commit holds protocol + metadata, and the checkpoint at version 0,
   written by the port's ``write_checkpoint``, holds them and the 1M adds
   (its bytes, write and decode times printed; every chunk's codec and
   encodings read back with the port's thrift and held to the checkpoint
   policy: SNAPPY, a dictionary on every non-boolean leaf); ``DeltaLog`` on the card (the
   segment the checkpoint, its typed ``stats_parsed`` lanes the resident
   build's); ``files_for_scan`` for 256 point-range predicates; the same 256 as
   one batched plan; 10 tail commits (1k adds + 500 removes each), each
   applied incrementally in one upload and one launch (``tail_apply``: K3
   with K2 on its launch) and re-planned; ``replay_columns`` on the card.
   Every plan is checked against the float64 host evaluation over the
   mirrors, which does not use the block cull;
5. the normal leg and the tombstone replay on the same table, with the
   counters set to 0 again: one query the resident planner declines, the
   disjunction of three shapes it cannot plan (a strict float bound beside
   ``!=``, a multi-column interval, a null count; checked to be declined),
   planned by ``files_for_scan`` through the
   K15 interpreter on the card and checked file for file against the host
   prune (``_prune_host``, numpy); one query that synthesis makes exact,
   served by the resident planner; ``replay_alive_mask`` over the log's
   whole action stream (the checkpoint's actions, then the tails), whose
   alive set must be the snapshot's live files and whose tombstones the host
   replay's; then bench config 5 (``bench.py:815-908``: seed 7, 10,000
   versions of 20 actions over 50,000 path names, the checkpoint at version
   5,000, written through the port's LogStore and ``write_checkpoint``), the
   counters set to 0 again: ``decode_segment`` of the checkpoint and its
   tail and ``replay_columns`` with K4 on the card, three times; the live
   file count equal to the sequential host replay's (``bench.py:858-872``),
   the winner mask to the host winner; ``decode_ms``, ``device_winner_ms``,
   ``host_winner_ms`` and the host replay's ms on one JSON line;
6. the MERGE key slab on bench config 2 (``bench.py:165-260``), with the
   counters set to 0 again: the 10M-row ``_store_sales`` target written
   through the port's Parquet writer (files of at most 4M rows, stats from
   ``collect_stats``, committed as v0 with deletion vectors enabled; the
   first file's chunks held to the writer's policy: BYTE_STREAM_SPLIT and
   SNAPPY on the floats, SNAPPY on the integers the probe says pay); a cold
   ``KeyCache.get`` on the card, its parts timed; probes of the bench's 1M
   source keys (p50/p99 of 7, one insert-only), each held pair for pair
   against a numpy reference join and ``pairs_for_file`` file by file;
   four tail commits (a DV of 10,000 rows, the DV shrunk to 5,000, a
   300,000-row file with a removal, a 1,000-row file), each advanced
   incrementally in one pinned upload and one ``slab_advance`` launch (no
   single K11 update on the path) and re-probed; a probe on the composite key
   ``(ss_customer_sk, ss_store_sk)``;
7. the MERGE command on bench config 2, with the counters set to 0 again:
   the 10M-row target written through ``WriteIntoDelta`` (files of at most
   4M rows), deletion vectors enabled with ``set_table_properties``, a
   hard-linked copy as ``bench.py:216-224`` makes; then four upserts of 1M
   source rows (half live keys, half fresh), update * and insert * on
   ``t.ss_item_sk = s.ss_item_sk``: M0 on the copy with the host join, M1
   the same source on the table through the cold slab pipeline (K8-K11),
   M2 a new source through the resident slab after its advance over M1's
   commit, M3 a third with deletion vectors off — copy-on-write over the
   files M1 and M2 gave deletion vectors — through the upload join K12.
   Each merge must take its route, launch its kernels, fall back nowhere,
   update and insert 500,000 rows each, and leave an end state (read back
   with ``scan_to_table``) equal, all 8 columns exactly, to a numpy
   reference upsert; M0's end state must equal M1's. Each merge's wall time
   and ``phase_ms`` are printed, and K12's time beside M3's;
8. the filtered read path on bench config 12 (``bench.py:579-722``), with
   the counters set to 0 again: 2,000,000 rows (``id``, ``price``
   scattered, ``qty``, an 8-value ``cat``, ``ts``) written through
   ``WriteIntoDelta`` in files of 250,000 rows and row groups of 31,250;
   the 7 queries of ``bench.py:630-638`` through
   ``DeltaTable.to_table`` in three legs: ``deviceResidual.mode=off``,
   cold ``force`` after ``ColumnCache.reset()``, warm ``force``. Every
   query's rows and ``id`` sum must equal a numpy filter of the generated
   arrays in every leg; the warm leg must hit the cache, miss nothing,
   engage 7 times and report ``device_residual == "device"`` for every
   query. Each leg's total and per-query wall time is printed;
9. OPTIMIZE ZORDER BY on bench config 3 (``bench.py:392-437``), with the
   counters set to 0 again: 4,000,000 ``_store_sales`` rows appended in 8
   commits, the point query ``ss_item_sk = k AND ss_sold_date_sk = d``
   through ``DeltaTable.to_table`` (timed), ``OptimizeCommand(z_order_by=
   ["ss_item_sk", "ss_sold_date_sk"], target_rows=500_000)`` (timed), the
   query again: the same rows before and after, equal to numpy, fewer files
   scanned after, each new file's rows in the order of a numpy Morton
   reference, both device caches' epochs moved, and the Z-order on the card
   (two ranks, one interleave, one key sort: no host argsort); OPTIMIZE's
   wall split (read, ranks, interleave, sort, download, take, write) is
   printed;
10. the link-priced ``auto`` router, with the counters set to 0 again: the
   link profile probed once (K17 first), then three ``auto`` legs. Config
   6: the 256-query plan under ``devicePlan.mode=auto`` on phase 4's
   resident entry, beside ``force`` and ``off`` (``bench.py:1030-1036``),
   its plans equal to both and its ``via`` the decision ``_price_plan``'s
   numbers imply. Config 2: a 1M-row upsert under ``devicePath.mode=auto``
   on a fresh hard-linked copy of phase 7's table with a new source
   (``bench.py:265-269``), then a resident one after the slab is warm
   (``bench.py:336-339``), each end state equal to the numpy reference
   upsert and each route the one ``cmd._router``'s ``deviceEstS`` /
   ``hostEstS`` imply. Config 12: the 7 queries under
   ``deviceResidual.mode=auto``, cold after ``ColumnCache.reset()`` and
   warm, each equal to numpy, each report's ``device_residual`` its audit's
   decision. The router's audits (predicted, actual, miss) are printed, not
   gated. One JSON line gives the link profile and one the cost constants
   measured at the main path's shapes (after phases 6-8 and in this one:
   the host join and key decode from M0's ``phase_ms``, the cold build's
   upload + K8, phase 6's probes, K12, config 12's host filter and warm
   device pass, config 6's host and device plans);
11. per kernel: time on the card (CUDA events, warmed, many launches; the
   block cull's, the tail apply's, K5's, K6's, K9's, K12's, K13's and K14's
   also replayed from a CUDA graph, ``graph_ms`` (K5's and K6's without the
   call's download of the sums), and K1's, the tail apply's, K5's, K6's,
   K8's, K9's, K12's, K13's and K14's split by the
   kernels they launch, ``breakdown_us``, left out where the profiler's
   trace lost kernel records; K12's and K13's hash probes in L2
   sectors at an L2 rate measured in the run) at
   the main path's shapes and inputs (K1 at config 6's 256-query batch
   and at one query as ``files_for_scan`` launches it, K2 and K3 alone and
   the tail apply at config 6's tail (its ``call_ms`` with the upload), K9
   at phase 6's slab and source, K11's single updates at phase 6's shapes
   and its advance at advance a's (in place, ``pinned_ms`` into a new sorted
   validity, ``upload_launch_ms`` with its pinned upload, graph, profiler,
   the library calls of the same updates out of place and in place summed
   beside it), K12 at M3's own
   padded inputs, K14 over the arith query's 8 config-12 files in its one
   launch and on one file (its phase-3 checks also run the staged tables
   of two 200-option IN lists), K16 at
   config 3's OPTIMIZE ranks (with ``graph_ms``, ``breakdown_us`` and
   ``morton_order``'s wall split by step), the rank of its ``ss_item_sk``
   and the key's sort (beside ``torch.sort(stable=True)``), K17 at the
   probe's 8 int32, each held
   against its plain version there), the plain version's
   time, the least time the card could take (the bytes its inputs and
   outputs need over 3.35 TB/s: no kernel here does enough operations a
   byte for them to bound it; K1 and K7 by the bytes their data needs,
   the advance by the bytes its rows need, ``advance_bytes``)
   and, where one PyTorch
   call computes the same function, that call's time; one JSON line lists
   them;
12. the state mesh, with the counters set to 0 again, under
   ``mesh.using_devices([cuda:0] * 8)``: bench config 6's 256-query plan
   under ``distributed.plan.mode=force`` (``resident_shards == 8``, every
   result ``device-sharded``, equal to one card's plans and the host's);
   ``replay_sharded`` of the log's action stream, equal to K5's masks and sums
   (K6 one launch a replay: 4 on the phase's path, each writing its
   shards' sums into one row; K7 one launch a plan); M4, a fifth bench
   config 2 upsert of 1M new rows through the upload join on a hard-linked
   copy of phase 10's table (deletion vectors off over its
   deletion-vectored files, as M3), which must launch K13 once (one
   distinct device, its source hits packed in its launch) and no K12 and
   end in the reference upsert's state; ``multichip.dryrun_multichip(8)``;
   the combine launched exactly ``MESH_COMBINES`` times (one:
   ``multichip``'s count); then the two shard constants measured
   on the one card (one JSON line) and the plan under ``auto`` priced with
   them, its route the one its prices imply. Where there are several cards,
   the plan, the replay and the dryrun run again over all of them. K6, K7,
   K13 and the combine kernel are then timed at the phase's shapes (rows of
   the kernels line);
13. DELETE, UPDATE, RESTORE, VACUUM and time travel on bench config 2,
   with the counters set to 0 again: a hard-linked copy of phase 7's
   table in M3's end state (deletion vectors on), its numpy reference
   carried along. Step 0 upserts 10,000 rows (the cold slab, K8); step 1
   DELETEs ``ss_quantity >= 96`` on the deletion-vector path (K1 plans its
   candidates; every touched file re-added with a vector, no data file
   written, ``numDeletedRows`` numpy's count); step 2 UPDATEs
   ``ss_net_paid + 1.0`` and ``ss_item_sk + 30000000`` where
   ``ss_store_sk < 25`` (moving MERGE keys); step 3 MERGEs a 1M-row source
   (half live keys, some moved, half fresh) through the resident slab,
   advanced over steps 1-2 by ``slab_advance`` (the same entry, no cold
   rebuild; the appended keys are re-sorted once); step 4 DELETEs
   ``ss_item_sk >= 30000000``, which keeps exactly the files whose own max
   ``ss_item_sk`` holds a moved key (K1); step 5 UPDATEs ``ss_quantity * 2``
   where ``ss_customer_sk < 10000`` copy-on-write (both caches' epochs
   move) and MERGEs again (the slab rebuilt: K8 once); step 6 reads the
   version before step 1 and the timestamp of step 2's commit while the
   resident entry sits at the latest version (the "older" verdict, a host
   plan); step 7 RESTOREs the version before step 1 (the restored and
   removed counts the two snapshots imply, both epochs moved) and MERGEs a
   source holding keys step 1 deleted; step 8 VACUUMs with no retention
   (the dry run lists exactly what an ``os.walk`` finds unreferenced by a
   live file or sidecar, the real run deletes those) and a RESTORE to a
   version whose files are gone raises before any commit. Each step's end
   state, read with ``scan_to_table``, equals numpy's on all 8 columns;
   each command's wall time, ``scanTimeMs`` / ``rewriteTimeMs`` and
   launches are printed beside the card's name and power limit, and the
   phase's launches join the kernels line's;
14. partitioned tables, with the counters set to 0 again. 14a, bench
   config 6p (``bench_hot_plan(partitioned=True)``, seed 13): 1M files in
   732 ``day`` partitions, the port's checkpoint at version 0 (with
   ``partitionValues_parsed``), the resident entry with its value-sorted
   day dictionary, 256 plans under ``devicePlan.mode=force`` (every 4th
   ``day = d AND c0 >= lo``, every 4th offset by 2 a 4-day range, the rest
   stats ranges) equal to the host's float64 plan and to numpy, then three
   one-file tails on the same entry, the third with a new day (the card's
   day lane holds its code), each re-planned and checked. 14b,
   store_sales(PART_ROWS) written through ``WriteIntoDelta(...,
   partition_columns=["ss_sold_date_sk"])`` (2,000 partitions, deletion
   vectors on): two reads with the residual on the card (K14; the second
   binds each file's date as a per-file scalar), a cold and a resident
   1M-row MERGE, a partition-only DELETE that reads no file, a DV DELETE
   (K1) and a resident MERGE (K11's advance), an UPDATE of the partition
   column that moves rows across partitions, a replaceWhere overwrite,
   OPTIMIZE ZORDER BY inside 100 partitions (K16) with a point read before
   and after, and VACUUM, which removes the partition directories that no
   live file holds; the end state after steps 5 and 8 (each read checks
   the steps since the last) equals numpy's on all 8 columns, and K14's
   launch with the partition scalar equals its plain version;
15. DECIMAL and nested data columns, with the counters set to 0 again.
   15a, store_sales(DEC_ROWS) in TPC-DS's own types (the generator's
   draws, ``ss_sales_price``, ``ss_ext_discount_amt`` and ``ss_net_paid``
   decimal(7,2): the unscaled values floor(rand * 10000), floor(rand *
   1000) and floor(rand * 9000)), deletion vectors on: the write (stats
   ``nullCount`` only for the decimals), a plan on the date (K1), a read
   with the residual on the card (K14) returning the decimals, a read
   whose residual names a decimal (the host, ``scan.device.fallback``), a
   cold 1M-row MERGE (K8-K10), a DV UPDATE ``ss_net_paid = ss_sales_price
   * ss_quantity`` (K15 plans its candidates), a DV DELETE (K1), a resident
   MERGE (K11), OPTIMIZE ZORDER BY (K16), a checkpoint with
   ``writeStatsAsStruct`` read back by a fresh log, a read of version 1;
   each end state equal to numpy over the unscaled integers. 15b,
   NESTED_ROWS rows of ``id`` and the struct, list and map shapes of
   tests/test_datatypes.py (NULL, empty and NULL inside): the write, a
   MERGE with update * / insert * (K8-K10), a DV DELETE of ``id % 10 =
   0``, OPTIMIZE, the end state equal to a Python reference row for row.
   Each phase's wall seconds are printed before the kernels line, and after
   each phase the page codec's device ms in it (``ops/page_codec.device_ms``,
   CUDA events around each launch); the page
   codec's launches on every phase's path (each phase's counts set to 0
   just before it) are summed, each kernel must have launched, and both
   are timed on a 1 MiB page and eight (8 MiB) of store_sales bytes: the
   whole call, the launch alone eager and replayed from a CUDA graph,
   beside the plain versions and the bound of their bytes in and out
   (``codec_rows``; no PyTorch call compresses Snappy);
16. the table API (``DeltaTable``), with the counters set to 0 again.
   16a, inside phases 4-5's ``devicePlan.mode=force`` block on their live
   1M-file residency: config 6's 256 queries as filter lists through
   ``plan_queries(k=256)``: one K1 launch for the batch, 256 bumps of
   ``stateCache.plan.resident``, every plan on the card and equal, path for
   path with its count and overflow, to ``entry.plan_ranges`` and to the
   host's ``files_for_scan``. 16b, bench config 2 through the API, cut to
   API_ROWS (phase 17 runs it at full width): ``DeltaTable.create(...,
   data=store_sales(API_ROWS), configuration={deletion vectors})`` in one
   commit at version 0, read back, then the API_SOURCE-row upsert through
   ``alias("t").merge(...).when_matched_update_all()
   .when_not_matched_insert_all().execute()`` under
   ``merge.devicePath.mode=force`` (K8-K10; half updated, half inserted),
   its end state equal to ``reference_upsert`` on all 8 columns. 16c, on
   that table: ``upgrade_table_protocol`` (a no-op at the table's protocol;
   a downgrade refused), a read of ``path@v0`` equal to the CTAS and a
   DELETE on it refused, shallow clones at version 0 and at the latest
   version (each read equal to the source at that version, no data file
   copied), a DV DELETE and a VACUUM on the clone that leave the source's
   files and rows as they were, ``generate()`` listing exactly the live
   files and, with ``delta.compatibility.symlinkFormatManifest.enabled``,
   the next DELETE's commit rewriting it, a ``create`` by name through a
   catalog in the work directory read back by ``for_name``. 16d,
   CONVERT_FILES Parquet files of store_sales written by the port's writer
   in ``ss_sold_date_sk=`` directories, converted with a partition schema
   and footer stats (``convert.stats.fromFooter`` for every file), a
   filtered read with the residual on the card (K14) equal to numpy's that
   scans fewer files, and a read the footer stats prune to no file;
17. the write semantics, with the counters set to 0 again: bench config
   2's store_sales (10M rows, seed 7) created through ``DeltaTable.create``
   with ``delta.enableChangeDataFeed``, deletion vectors, the CHECK
   constraint ``ss_quantity > 0`` and the generated column
   ``ss_ext_sales_price`` (``ss_quantity * ss_sales_price``), then written.
   (a) the 1M-row upsert (half updates, half inserts) through the MERGE
   builder with ``delta.tpu.schema.autoMerge.enabled`` and star clauses, its
   source carrying ``ss_promo_sk``: the schema evolves, K8-K11 run, the CDC
   file goes through the page codec; (b) a DV DELETE and an UPDATE with
   data predicates, K15 planning their candidates; (c) a MERGE whose source
   breaks the constraint raises ``InvariantViolationError`` and commits
   nothing; (d) ``table_changes`` from (a)'s version: each (version, change
   type) block (500,000 each of ``update_preimage``, ``update_postimage`` and
   ``insert``, then the DELETE's and the UPDATE's rows) equal to numpy's on
   every column, each ``_commit_timestamp`` its commit's; (e) a
   ``StreamingQuery`` from the table's snapshot into a second table, one
   file a trigger, whose end state is the table's, and a ``DeltaCDFSource``
   from (a)'s version whose rows are (d)'s. Each step's wall seconds and
   launches are printed beside the card's name and power limit, and the
   phase's launches join the kernels line's;
18. last line: ``{"ok": true, "device": {...}}``.

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

from delta_tpu_torch import DeltaLog, DeltaTable, MergeClause, MergeIntoCommand, WriteIntoDelta
from delta_tpu_torch.exec.scan import scan_to_table
from delta_tpu_torch.expr import device_eval, ir
from delta_tpu_torch.expr.parser import parse_expression, parse_predicate
from delta_tpu_torch.exec.parquet import collect_stats, read_parquet_file, write_parquet_file
from delta_tpu_torch.expr.vectorized import HostColumn, HostTable, evaluate, stored_type
from delta_tpu_torch.ops import (
    column_cache, join_kernel, key_cache, native, pruning, replay_kernel, state_cache,
    state_export, zorder,
)
from delta_tpu_torch.obs import router_audit
from delta_tpu_torch.parallel import link, mesh
from delta_tpu_torch.utils.config import conf
from delta_tpu_torch.protocol import filenames
from delta_tpu_torch.protocol.actions import (
    AddFile, Metadata, Protocol, RemoveFile,
)
from delta_tpu_torch.protocol.deletion_vectors import write_deletion_vector
from delta_tpu_torch.schema.types import (
    BooleanType, DateType, DoubleType, LongType, StringType, StructType, TimestampType,
)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
N_FILES = 1_000_000
N_QUERIES = 256
N_TAILS = 10
TOMB_CUTOFF = N_TAILS // 2  # tails v1-v10 remove at their version: v6-v10 are retained
TAIL_ADDS, TAIL_REMOVES = 1000, 500
SEED = 13
# bench config 2 (bench.py:165-260): the MERGE upsert's target and source
MERGE_ROWS, MERGE_SOURCE = 10_000_000, 1_000_000
MERGE_FILE_ROWS = 4_000_000  # delta.tpu.write.targetFileRows
MERGE_PROBES = 7
MERGE_DV_ROWS, MERGE_APPEND_ROWS, MERGE_SMALL_ROWS = 10_000, 300_000, 1_000
I64_MAX = (1 << 63) - 1
#: the key slab's path (phase 6): K8-K10, K11's advance and widen
SLAB_KERNELS = ("slab_sort", "slab_probe", "pair_compact", "slab_advance", "slab_widen")
#: K11's single updates: checked in phase 3, launched on no path
K11_UPDATES = ("slab_kill", "slab_revive", "slab_append", "slab_map_rows", "slab_slice_append")


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


def graph_ms(fn, reps):
    """Device time of one call of ``fn``, replayed from a CUDA graph that
    holds ``reps`` calls: the host's Python and launch overhead left out."""
    graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(reps):
                fn()
    torch.cuda.current_stream().wait_stream(side)
    return cuda_ms(graph.replay, 10) / reps


def kernel_breakdown(fn, calls=20):
    """Device time per call of each CUDA kernel ``fn`` launches (the
    profiler's CUPTI trace), in microseconds, by kernel name; empty where
    there is no card. A trace switched on just before the calls misses the
    kernels of its first milliseconds (a process's later traces more than
    its first), so ``calls`` calls run in a warm-up cycle before the
    recorded ones. Every call launches the same kernels, so each one's
    records in the trace are a multiple of ``calls``; where they are not
    (the trace lost records), None, and a line says how many it holds."""
    from torch.profiler import ProfilerActivity, profile, schedule

    if not torch.cuda.is_available():
        return {}
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _cycle in range(2):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            prof.step()
    out, records = {}, {}
    for e in prof.key_averages():
        if e.device_time_total > 0 and not e.key.startswith("cuda"):
            name = e.key.replace("(anonymous namespace)::", "").replace("void ", "")
            name = name.split("(")[0][:90] if "<" not in name else name.split(">(")[0][:90] + ">"
            out[name] = round(out.get(name, 0.0) + e.device_time_total / calls, 3)
            records[name] = records.get(name, 0) + e.count
    lost = {k: n for k, n in records.items() if n % calls}
    if lost:
        say(f"profiler: {calls} calls left {lost} records of {sorted(lost)} in the trace "
            f"(times {out}): a partial trace, not used")
        return None
    return out


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
    for q in (m, 1, 257):  # the batch, one query (files_for_scan), two sweeps
        lo_q, hi_q = (ts[3][:q], ts[4][:q]) if q <= m else (ts[3].repeat(2, 1)[:q],
                                                            ts[4].repeat(2, 1)[:q])
        args = (*ts[:3], lo_q.contiguous(), hi_q.contiguous())
        got = state_cache.block_cull(*args)
        torch.cuda.synchronize()
        check(bitwise_equal(got, state_cache.block_cull_plain(*args)),
              f"block_cull != plain at M={q}")
    say(f"kernels: block_cull C={c} cap={cap} M={m}, 1, 257 exact")

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
    tail_checks(dev)

    k4_checks(dev)
    k15_checks(dev)
    k5_checks(dev)
    slab_checks(dev)
    k12_checks(dev)
    k14_checks(dev)
    k16_checks(dev)
    k17_checks(dev)
    codec_checks(dev)
    mesh_checks(dev)


def kernel_cases():
    """tests/torch_kernel_cases.py (numpy only): the K9 and tail shapes the
    GPU tests hold too."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import torch_kernel_cases

    return torch_kernel_cases


def tail_checks(dev):
    """The tail apply (K3 with K2 on its launch) against its plain version,
    on one uploaded buffer as ``_apply_tail_device`` makes it."""
    cases = kernel_cases()
    for c in (1, 4):
        for case in cases.TAIL_CASES:
            alive, mins, maxs, dead, start, k, lo, hi = cases.tail_case(c, case, cap=1 << 20)
            on = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            got = [on(x) for x in (alive, mins, maxs)]
            ref = [x.clone() for x in got]
            buf = on(np.concatenate([dead, lo.view(np.int32).ravel(), hi.view(np.int32).ravel()]))
            vals = buf[len(dead):].view(torch.float32).view(2, c, k)
            state_cache.tail_apply(*got, buf[:len(dead)], start, k, vals[0], vals[1])
            state_cache.tail_apply_plain(*ref, on(dead), start, k, on(lo), on(hi))
            torch.cuda.synchronize()
            check(all(bitwise_equal(g, r) for g, r in zip(got, ref)),
                  f"tail_apply != plain at C={c} ({case})")
    say(f"kernels: tail_apply C=1, 4 cap=2^20 d=512 (wrapped and dropped rows), "
        f"{', '.join(cases.TAIL_CASES)}: exact")


def k4_checks(dev):
    """K4 on ``tests/torch_kernel_cases.py``'s streams (config 5's and 6's
    shapes, random, one path everywhere, zipf, num_paths = 1, all pads, no
    pad) at n = 8, 2^20 and 2^24, twice in a row on one
    table (the first call must leave it clean), on a base off a 16-byte
    boundary, and an out-of-range id, which ``winner_mask_device`` must
    raise, after which the table is clean again."""
    cases = kernel_cases()
    WINNER_CASES, winner_case, reference_winner = (cases.WINNER_CASES, cases.winner_case,
                                                   cases.reference_winner)
    for n in (8, 1 << 20, 1 << 24):
        for case in WINNER_CASES:
            pid, num_paths = winner_case(case, n)
            p = torch.from_numpy(pid).to(dev)
            ref = replay_kernel.winner_bits_plain(p, num_paths)
            for rep in range(2):
                got = replay_kernel.winner_bits(p, num_paths)
                check(torch.equal(got, ref), f"winner_bits != plain: {case} n={n} call {rep}")
            del p, ref
    pid, num_paths = winner_case("zipf", 1 << 20)
    buf = torch.from_numpy(np.concatenate([[0], pid[:1000]]).astype(np.int32)).to(dev)
    check(torch.equal(replay_kernel.winner_bits(buf[1:], num_paths),
                      replay_kernel.winner_bits_plain(buf[1:], num_paths)),
          "winner_bits != plain off a 16-byte boundary")
    try:
        replay_kernel.winner_mask_device(np.array([0, 3, 9, -1], np.int32), 9, device=dev)
        raise SmokeFailure("winner_mask_device took an id >= num_paths")
    except ValueError:
        pass
    got = replay_kernel.winner_mask_device(pid, num_paths, device=dev)
    check(np.array_equal(np.packbits(got), reference_winner(pid)),
          "winner_mask_device after an out-of-range id")
    say(f"kernels: winner_bits n=8, 2^20, 2^24 x {WINNER_CASES}, "
        "twice a table, a base off 16 bytes: exact; an out-of-range id raised")


def k17_checks(dev):
    """K17 (the link probe's warm-up) against ``a + 1`` at the probe's 8
    elements and at 2^20 (int32.min included, int32.max - 1 the largest)."""
    for n in (8, 1 << 20):
        vals = np.random.RandomState(n).randint(-2**31, 2**31 - 1, n).astype(np.int32)
        vals[0] = -2**31
        a = torch.from_numpy(vals).to(dev)
        got = link.link_probe(a)
        torch.cuda.synchronize()
        check(torch.equal(got, link.link_probe_plain(a)), f"link_probe != plain at n={n}")
    say("kernels: link_probe (K17) n=8, 2^20 exact")


# -- phase 3, the page codec: snappy_compress and snappy_decompress ----------------------

#: the JAX package's host work the codec kernels stand in for (Arrow's C++
#: compresses in pq.write_table and decompresses in pq.read_table)
CODEC_REPLACES = {"snappy_compress": "delta_tpu/exec/parquet.py:182",
                  "snappy_decompress": "delta_tpu/exec/parquet.py:203"}
CODEC_KERNELS = tuple(CODEC_REPLACES)


#: the most bytes the kernel's Snappy may take, over the plain compressor's
#: on a page and on a batch (the writer's probe runs on the kernel's bytes)
CODEC_BYTES_RATIO = 1.03


def codec_checks(dev):
    """The page codec on ``tests/torch_kernel_cases.py``'s batch (0 B, 1 B,
    64 KiB - 1, 64 KiB, 64 KiB + 1, literal-length edges, repeats, random
    bytes, store_sales columns' PLAIN and BYTE_STREAM_SPLIT pages of a row
    group, 1 MiB, 8 MiB) in one launch each: the kernel's Snappy decodes
    through the plain decoder to the input, the plain compressor's through
    the kernel, and the kernel's own through the kernel, byte for byte; the
    kernel's bytes within ``CODEC_BYTES_RATIO`` of the plain compressor's on
    every page and on the batch; the streams the port's compressor never
    writes (``codec_streams``: copy-1, -2 and -4 tags, copy-4 offsets past
    64 KiB in a 2 MiB page, overlapping copies of every offset 1-63, literals
    of 1-4 length bytes, one long run) decode through the kernel in one
    launch; the malformed bodies and the faults after a page's 33rd element
    (``codec_faults``) raise ``SnappyError``, one at a time and in a batch
    with good pages, set their error words and write nothing outside their
    slots."""
    from delta_tpu_torch.exec import snappy
    from delta_tpu_torch.ops import page_codec

    kc = kernel_cases()
    pages = kc.codec_pages(big=True)
    names, raw = [n for n, _ in pages], [p for _, p in pages]
    sizes = [len(p) for p in raw]
    z_dev = page_codec.compress(raw, dev)
    z_plain = [snappy.compress(p) for p in raw]
    for name, p, z in zip(names, raw, z_dev):
        check(snappy.decompress(z) == p, f"snappy_compress: page {name} does not decode "
              "through the plain decoder to its input")
    for what, z in (("the plain compressor's", z_plain), ("its own", z_dev)):
        back = page_codec.decompress(z, sizes, dev)
        for name, p, b in zip(names, raw, back):
            check(b == p, f"snappy_decompress: {what} page {name} does not decode to its input")
    ratio = sum(map(len, z_dev)) / sum(map(len, z_plain))
    worst = max((len(a) / max(len(b), 1), n) for a, b, n in zip(z_dev, z_plain, names))
    check(ratio <= CODEC_BYTES_RATIO and worst[0] <= CODEC_BYTES_RATIO,
          f"snappy_compress: {ratio:.4f}x the plain compressor's bytes, page {worst[1]} "
          f"{worst[0]:.4f}x (at most {CODEC_BYTES_RATIO})")
    streams = kc.codec_streams()
    got = page_codec.decompress([b for _, b, _ in streams], [len(w) for _, _, w in streams],
                                dev, [n for n, _, _ in streams])
    for (name, _, want), g in zip(streams, got):
        check(g == want, f"snappy_decompress: the stream {name} does not decode to its bytes")
    faults = kc.codec_faults()
    bad = kc.codec_malformed() + [(n, b, size) for n, b, size, _ in faults]
    for name, body, size in bad:
        try:
            page_codec.decompress([body], [size], dev)
        except snappy.SnappyError:
            continue
        check(False, f"snappy_decompress: the malformed body {name} decoded")
    words = [None] * (len(bad) - len(faults)) + [w for _, _, _, w in faults]
    codec_guard_check(dev, bad, z_dev[:4], raw[:4], words)
    say(f"kernels: snappy_compress, snappy_decompress on {len(raw)} pages "
        f"({sum(sizes)} bytes) exact both ways; the kernel's bytes {ratio:.4f}x the plain "
        f"compressor's (worst page {worst[1]} {worst[0]:.4f}x); {len(streams)} streams the "
        f"port never writes exact; {len(bad)} malformed bodies raise, set their error words "
        "and stay in their slots")


def codec_guard_check(dev, bad, good, want, words=None):
    """``decompress_launch`` over the malformed bodies and good ones, each
    slot followed by 64 guard bytes that no page owns: every malformed page
    sets its error word (``words[i]`` where given and not None), every good
    page decodes, and no guard byte changes."""
    from delta_tpu_torch.ops import page_codec

    bodies = [b for _, b, _ in bad] + list(good)
    sizes = [s for _, _, s in bad] + [len(w) for w in want]
    guard = 64
    table = np.zeros((len(bodies), 4), np.int64)
    at_in = at_out = 0
    for i, (b, s) in enumerate(zip(bodies, sizes)):
        table[i] = (at_in, len(b), at_out, s)
        at_in += len(b)
        at_out += s + guard
    src = torch.from_numpy(np.frombuffer(b"".join(bodies), np.uint8).copy()).to(dev)
    out = torch.full((at_out,), 0xAB, dtype=torch.uint8, device=dev)
    err = torch.zeros(len(bodies), dtype=torch.int32, device=dev)
    page_codec.decompress_launch(src, torch.from_numpy(table).to(dev), out, err)
    torch.cuda.synchronize()
    got, errs = out.cpu().numpy(), err.cpu().numpy()
    for i, (b, s) in enumerate(zip(bodies, sizes)):
        o = int(table[i, 2])
        check(bool((got[o + s:o + s + guard] == 0xAB).all()),
              f"snappy_decompress: page {i} wrote past its slot")
        if i < len(bad):
            check(errs[i] != 0, f"snappy_decompress: malformed body {bad[i][0]} set no error")
            if words is not None and words[i] is not None:
                check(errs[i] == words[i], f"snappy_decompress: malformed body {bad[i][0]} "
                      f"set error {errs[i]}, not {words[i]}")
        else:
            check(errs[i] == 0 and got[o:o + s].tobytes() == want[i - len(bad)],
                  f"snappy_decompress: good page {i} beside malformed ones: error {errs[i]}")


def footer_policy(path, checkpoint=False):
    """Read a file's footer with the port's thrift and hold every chunk's
    codec and encodings to the writer's policy: a checkpoint SNAPPY on
    every leaf, a dictionary on all but booleans; a data file a dictionary
    on top-level strings, BYTE_STREAM_SPLIT on floats (both SNAPPY), and
    elsewhere PLAIN, SNAPPY where the plain probe of the column's first
    64 KiB says it pays. Returns {leaf: (codec, encodings)}."""
    from delta_tpu_torch.exec import encodings as enc, parquet as pqx

    meta = pqx.read_metadata(path)
    probed = [".".join(c.meta_data.path_in_schema) for c in meta.row_groups[0].columns
              if len(c.meta_data.path_in_schema) == 1
              and c.meta_data.type not in (enc.BYTE_ARRAY, enc.FLOAT, enc.DOUBLE)]
    table = None if checkpoint else read_parquet_file(path, probed, device=torch.device("cuda"))
    seen = {}
    for rg in meta.row_groups:
        for ch in rg.columns:
            md = ch.meta_data
            leaf = ".".join(md.path_in_schema)
            got = (pqx._CODEC_NAMES[md.codec],
                   tuple(sorted(enc.ENCODING_NAMES[e] for e in set(md.encodings))))
            if checkpoint:
                want = ("SNAPPY", ("PLAIN", "RLE") if md.type == enc.BOOLEAN
                        else ("PLAIN", "RLE", "RLE_DICTIONARY"))
            elif len(md.path_in_schema) == 1 and md.type == enc.BYTE_ARRAY:
                want = ("SNAPPY", ("PLAIN", "RLE", "RLE_DICTIONARY"))
            elif len(md.path_in_schema) == 1 and md.type in (enc.FLOAT, enc.DOUBLE):
                want = ("SNAPPY", ("BYTE_STREAM_SPLIT", "RLE"))
            elif len(md.path_in_schema) > 1:
                want = ("UNCOMPRESSED", ("PLAIN", "RLE"))
            else:
                col = table.columns[leaf]
                ok = pqx._compresses_well([pqx._probe_sample(col, stored_type(col))],
                                          torch.device("cpu"))[0]
                want = ("SNAPPY" if ok else "UNCOMPRESSED", ("PLAIN", "RLE"))
            check(got == want, f"{path}: chunk {leaf} is {got}, the policy's is {want}")
            seen[leaf] = got
    return seen


def codec_launches(pages, z, dev):
    """Both codec kernels' launches alone, on buffers already on the card:
    ``snappy_compress`` over ``pages`` and ``snappy_decompress`` over their
    Snappy bodies ``z``. Returns the two launches, the pages on the card,
    and the decompressor's output and error words."""
    from delta_tpu_torch.ops import page_codec

    sizes = [len(p) for p in pages]
    table, _ = page_codec.fragment_table(sizes)
    src = torch.from_numpy(np.frombuffer(b"".join(pages), np.uint8).copy()).to(dev)
    frags = torch.from_numpy(table).to(dev)
    scratch = torch.empty(len(table) * page_codec.FRAG_CAP, dtype=torch.uint8, device=dev)
    fsizes = torch.empty(len(table), dtype=torch.int32, device=dev)
    ptab = np.zeros((len(z), 4), np.int64)
    ptab[:, 1], ptab[:, 3] = [len(x) for x in z], sizes
    ptab[:, 0] = np.cumsum(ptab[:, 1]) - ptab[:, 1]
    ptab[:, 2] = np.cumsum(ptab[:, 3]) - ptab[:, 3]
    zsrc = torch.from_numpy(np.frombuffer(b"".join(z), np.uint8).copy()).to(dev)
    pt = torch.from_numpy(ptab).to(dev)
    out = torch.empty(sum(sizes), dtype=torch.uint8, device=dev)
    err = torch.empty(len(z), dtype=torch.int32, device=dev)
    return (lambda: page_codec.compress_launch(src, frags, scratch, fsizes),
            lambda: page_codec.decompress_launch(zsrc, pt, out, err), src, out, err)


def codec_rows(dev, launches):
    """Both codec kernels at the writer's shapes: a 1 MiB page and a batch
    of eight (8 MiB) cut from store_sales columns' PLAIN and
    BYTE_STREAM_SPLIT bytes. ``ms`` is the wrapper's whole call (pinned
    upload, the launch, the download, the host's stitch) timed by CUDA
    events, ``graph_ms`` the launch alone replayed from a CUDA graph on
    buffers already on the card; the bound is the bytes in and out at 3.35
    TB/s."""
    from delta_tpu_torch.exec import snappy
    from delta_tpu_torch.ops import page_codec

    plain, bss = kernel_cases()._store_sales_bytes(1 << 20)
    mix = b"".join(b for _, b in plain + bss)
    batches = {"1mib": [mix[:1 << 20]],
               "8mib": [mix[i << 20:(i + 1) << 20] for i in range(8)]}
    rows = {k: {} for k in CODEC_KERNELS}
    for label, pages in batches.items():
        sizes = [len(p) for p in pages]
        z = page_codec.compress(pages, dev)
        t0 = time.perf_counter()
        zp = [snappy.compress(p) for p in pages]
        plain_c = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        plain_back = [snappy.decompress(x) for x in z]
        plain_d = (time.perf_counter() - t0) * 1e3
        back = page_codec.decompress(z, sizes, dev)
        check(back == pages and plain_back == pages,
              f"codec rows: the {label} batch does not round-trip")
        n_in, n_z = sum(sizes), sum(map(len, z))
        check(n_z <= CODEC_BYTES_RATIO * sum(map(len, zp)),
              f"codec rows: the {label} batch's Snappy is {n_z / sum(map(len, zp)):.4f}x the "
              f"plain compressor's bytes (at most {CODEC_BYTES_RATIO})")
        compress_launch, decompress_launch, src, out, err = codec_launches(pages, z, dev)
        for name, call, launch, plain_ms in (
                ("snappy_compress", lambda: page_codec.compress(pages, dev), compress_launch,
                 plain_c),
                ("snappy_decompress", lambda: page_codec.decompress(z, sizes, dev),
                 decompress_launch, plain_d)):
            rows[name][label] = {"ms": cuda_ms(call, 3, warm=1),
                                 "launch_ms": cuda_ms(launch, 3, warm=1),
                                 "graph_ms": graph_ms(launch, 3), "plain_ms": plain_ms,
                                 "bytes_in": n_in if name == "snappy_compress" else n_z,
                                 "bytes_out": n_z if name == "snappy_compress" else n_in}
        check(torch.equal(out, src) and not bool(err.any()),
              f"codec rows: the timed decompress launch of {label} is wrong")
        say(f"codec: {label} batch of {len(pages)} pages, {n_in} bytes -> {n_z} snappy "
            f"({n_z / n_in:.4f}); plain compressor {sum(map(len, zp))} bytes; "
            f"{json.dumps({k: v[label] for k, v in rows.items()})}")
    out_rows = []
    for name in CODEC_KERNELS:
        r = rows[name]["8mib"]
        b, by = bound(r["bytes_in"] + r["bytes_out"])
        out_rows.append({
            "name": name, "route": "cuda", "source": "delta_tpu_torch/csrc/page_codec.cu",
            "replaces": CODEC_REPLACES[name], "launches": launches.get(name, 0),
            "max_abs_err": 0.0, "ms": r["ms"], "graph_ms": r["graph_ms"],
            "launch_ms": r["launch_ms"], "ms_1mib": rows[name]["1mib"]["ms"],
            "graph_ms_1mib": rows[name]["1mib"]["graph_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": b, "bound_by": by, "library_ms": None,
            "shape": "8 pages of 1 MiB (store_sales PLAIN and BYTE_STREAM_SPLIT bytes)"})
    return out_rows


# -- phase 3, the mesh: K6, K7, K13 and the combine kernel ---------------------------

MESH_SHARDS = 8
MESH_COMBINES = 1  # combine launches on phase 12's path (9 before K6 and K13 folded)
K13_CAP_T = 16_777_216  # _bucket(ceil(12.5M / 8)) * 8: phase 12's upload join


def k6_stream(n, seed):
    """An action stream of n rows for the sharded replay: zipf-skewed paths
    (a few hot paths carry much of the history, so one shard is heavy),
    none of which hashes to the last shard (an empty, all-pad shard),
    removes on both sides of the cutoff, sizes whose int64 sum wraps."""
    rng = np.random.RandomState(seed)
    ids = np.arange(n // 4, dtype=np.int64)
    ids = ids[(replay_kernel._mix64(ids) % np.uint64(MESH_SHARDS)) != MESH_SHARDS - 1]
    probs = 1.0 / np.arange(1, len(ids) + 1, dtype=np.float64)
    probs /= probs.sum()
    pid = ids[rng.choice(len(ids), n, p=probs)].astype(np.int32)
    return state_export.ReplayArrays(
        paths=[f"p{i}" for i in range(n // 4)], path_id=pid,
        seq=(rng.permutation(n).astype(np.int64) << 8) + 7, is_add=rng.rand(n) > 0.3,
        size=rng.randint(0, 2**62, n).astype(np.int64),
        deletion_timestamp=rng.randint(0, 2000, n).astype(np.int64))


def k6_slabs(stream, dev, shards=MESH_SHARDS):
    stacked, order, dest = replay_kernel._bucket_by_path(stream, shards)
    slabs = [tuple(torch.from_numpy(np.ascontiguousarray(c[i])).to(dev) for c in stacked)
             for i in range(shards)]
    return slabs, order, dest


def k6_checks(dev):
    """K6 at n = 2^20 over 8 shards (skewed, one shard empty) against its
    plain version, and against K5 on the whole stream."""
    n = 1 << 20
    stream = k6_stream(n, 31)
    slabs, order, dest = k6_slabs(stream, dev)
    check(any(int((s[0] >= 0).sum()) == 0 for s in slabs), "K6 check: no empty shard")
    num_paths = len(stream.paths)
    cols = [torch.from_numpy(np.asarray(a)).to(dev) for a in (
        stream.path_id, stream.seq, stream.is_add, stream.size, stream.deletion_timestamp)]
    for cutoff in (0, 1000):
        got = replay_kernel.sharded_replay(slabs, num_paths, cutoff)
        torch.cuda.synchronize()
        ref = replay_kernel.sharded_replay_plain(slabs, num_paths, cutoff)
        check(all(torch.equal(g, r) for g, r in zip(got[0], ref[0]))
              and all(torch.equal(g, r) for g, r in zip(got[1], ref[1]))
              and torch.equal(got[2], ref[2]), f"K6 != plain at cutoff {cutoff}")
        k5 = replay_kernel.replay(*cols, num_paths, cutoff)
        alive = np.zeros(n, bool)
        alive[order] = torch.cat(got[0]).cpu().numpy()[dest]
        tomb = np.zeros(n, bool)
        tomb[order] = torch.cat(got[1]).cpu().numpy()[dest]
        check(np.array_equal(alive, k5[0].cpu().numpy())
              and np.array_equal(tomb, k5[1].cpu().numpy())
              and torch.equal(got[2], k5[2]), f"K6 != K5 at cutoff {cutoff}")
        one = replay_kernel.sharded_replay([tuple(cols)], num_paths, cutoff)
        check(torch.equal(one[0][0], k5[0]) and torch.equal(one[1][0], k5[1])
              and torch.equal(one[2], k5[2]), f"K6 with one shard != K5 at cutoff {cutoff}")
    rows = [int((s[0] >= 0).sum()) for s in slabs]
    say(f"kernels: sharded_replay (K6) n=2^20 over {MESH_SHARDS} shards (rows a shard {rows}, "
        f"cap {slabs[0][0].shape[0]}) cutoffs 0, 1000 exact against its plain version and K5, "
        "and with one shard against K5 "
        f"(sums {got[2].tolist()})")


def k7_lanes(dev, seed=1):
    """synthetic_checks' K1 lanes: C=4, cap=2^20, M=256, NaN lanes and
    bounds, dead rows, the capacity pad."""
    rng = np.random.RandomState(seed)
    c, cap, m = 4, 1 << 20, 256
    mins = (rng.rand(c, cap) * 100).astype(np.float32)
    maxs = mins + (rng.rand(c, cap) * 0.5).astype(np.float32)
    mins[:, rng.rand(cap) < 0.02] = np.nan
    maxs[:, rng.rand(cap) < 0.02] = np.nan
    alive = rng.rand(cap) > 0.1
    alive[-5000:] = False
    lo = (rng.rand(m, c) * 100).astype(np.float32)
    hi = lo + np.float32(0.05)
    lo[rng.rand(m, c) < 0.3] = np.nan
    hi[rng.rand(m, c) < 0.3] = np.nan
    return [torch.from_numpy(a).to(dev) for a in (mins, maxs, alive, lo, hi)]


def k7_shards(mins, maxs, alive, shards):
    per = alive.shape[0] // shards
    return [(mins[:, i * per:(i + 1) * per].contiguous(),
             maxs[:, i * per:(i + 1) * per].contiguous(),
             alive[i * per:(i + 1) * per].contiguous()) for i in range(shards)]


def k7_checks(dev):
    mins, maxs, alive, lo, hi = k7_lanes(dev)
    k1 = state_cache.block_cull(mins, maxs, alive, lo, hi)
    k1_blocks = torch.from_numpy(np.unpackbits(k1.cpu().numpy(), axis=1,
                                               count=alive.shape[0] // 1024)).to(dev)
    for shards in (2, 4, 8):
        sh = k7_shards(mins, maxs, alive, shards)
        got = state_cache.sharded_block_cull(sh, lo, hi)
        torch.cuda.synchronize()
        check(torch.equal(got, state_cache.sharded_block_cull_plain(sh, lo, hi)),
              f"K7 != plain over {shards} shards")
        check(torch.equal(got, k1_blocks), f"K7 != K1 unpacked over {shards} shards")
    say("kernels: sharded_block_cull (K7) C=4 cap=2^20 M=256 over 2, 4, 8 shards exact against "
        f"its plain version and K1 ({int(k1_blocks.sum())} live blocks)")


def k13_inputs(rng, dt, shape):
    """K13's padded inputs at phase 12's capacities (cap_t = 16,777,216,
    cap_s = 2^20 over 8 shards): k12_inputs' shapes, or ``runs``: runs of
    equal source keys straddling the source pieces' boundaries."""
    n, m = 12_500_000, 1_000_000
    if shape != "runs":
        return k12_inputs(rng, dt, K13_CAP_T, n, 1 << 20, m, shape)
    info = np.iinfo(dt)
    piece = (1 << 20) // MESH_SHARDS
    s = np.full(1 << 20, info.max - 1, dt)
    s[:m] = np.repeat(rng.randint(-(1 << 29), 1 << 29, m // 64), 64)[:m]
    s[piece - 32:piece + 32] = 77  # one run across the first boundary
    t = np.full(K13_CAP_T, info.max, dt)
    t[:n] = rng.randint(-(1 << 29), 1 << 29, n)
    t[K13_CAP_T // MESH_SHARDS - 3:K13_CAP_T // MESH_SHARDS + 3] = 77  # and across slabs
    return t, s


def k13_checks(dev):
    rng = np.random.RandomState(37)
    for dt, shape in ((np.int32, "half"), (np.int64, "half"), (np.int64, "low"),
                      (np.int32, "runs"), (np.int64, "dups"), (np.int32, "marker"),
                      (np.int64, "marker")):
        t_in, s_in = k13_inputs(rng, dt, shape)
        t, s = torch.from_numpy(t_in).to(dev), torch.from_numpy(s_in).to(dev)
        t_sl, s_pc = list(t.view(MESH_SHARDS, -1)), list(s.view(MESH_SHARDS, -1))
        got = join_kernel.sharded_join_probe(t_sl, s_pc)
        torch.cuda.synchronize()
        check(equal_all(got, join_kernel.sharded_join_probe_plain(t_sl, s)),
              f"K13 != plain: {np.dtype(dt).name} {shape}")
        check(equal_all(got, join_kernel.join_probe(t, s)),
              f"K13 != K12: {np.dtype(dt).name} {shape}")
        del t, s, t_sl, s_pc, got
    torch.cuda.empty_cache()
    say(f"kernels: sharded_join_probe (K13) int32 and int64, cap_t={K13_CAP_T} cap_s=2^20 over "
        f"{MESH_SHARDS} shards (sentinels at both ends, duplicate runs, runs of equal keys "
        "across the shard boundaries, the empty-slot key) exact against its plain version "
        "and K12")


#: the combine's shapes: the mesh path's with every shard on one card (K6's
#: sums per call and multichip's count before and after K6's fold) and
#: eight cards' (K13's packed source hits of cap_s = 2^20 rows, the sums of
#: 2^20 columns, a ragged width)
COMBINE_SHAPES = ((8, 4), (8, 1), (1, 1), (1, 5), (3, 64), (33, 17),
                  (MESH_SHARDS, 1 << 17), (MESH_SHARDS, 1 << 20), (MESH_SHARDS, (1 << 20) + 3))
#: sets of one launch: K13's across eight cards (its packed hits, its multi
#: bytes), and both ops at a ragged width whose rows start off a 16-byte
#: boundary
COMBINE_BATCHES = (((("or", MESH_SHARDS, 1 << 17), 0), (("or", MESH_SHARDS, 1), 0)),
                   ((("sum", 3, (1 << 17) + 5), 3), (("or", 3, (1 << 17) + 5), 3)),
                   ((("sum", 33, 9), 1), (("or", 33, 9), 1)))


def combine_checks(dev):
    """Each op alone at every shape of COMBINE_SHAPES, then each batch of
    COMBINE_BATCHES in one launch, against the plain version."""
    cases = kernel_cases()
    for i, (n, k) in enumerate(COMBINE_SHAPES):
        for op in mesh.COMBINE_OPS:
            x = torch.from_numpy(cases.combine_rows(cases.combine_case(op, n, k, 0, seed=i),
                                                    n, k)).to(dev)
            got = mesh.shard_combine(x, op)
            torch.cuda.synchronize()
            check(torch.equal(got, mesh.shard_combine_plain(x, op)),
                  f"shard_combine {op} != plain at ({n}, {k})")
    for i, batch in enumerate(COMBINE_BATCHES):
        sets = []
        for (op, n, k), offset in batch:
            buf = torch.from_numpy(cases.combine_case(op, n, k, offset, seed=40 + i)).to(dev)
            sets.append((cases.combine_rows(buf, n, k, offset), op))
        before = native.launches["shard_combine"]
        got = mesh.shard_combine_many(sets)
        torch.cuda.synchronize()
        check(native.launches["shard_combine"] - before == 1,
              f"shard_combine_many of {len(sets)} sets: "
              f"{native.launches['shard_combine'] - before} launches, not 1")
        for g, (x, op) in zip(got, sets):
            check(torch.equal(g, mesh.shard_combine_plain(x, op)),
                  f"shard_combine_many: {op} of {tuple(x.shape)} != plain")
    shapes = ", ".join(f"({n}, {k})" for n, k in COMBINE_SHAPES)
    batches = "; ".join(" + ".join(f"{op} ({n}, {k}) at offset {o}" for (op, n, k), o in b)
                        for b in COMBINE_BATCHES)
    say(f"kernels: shard_combine sum and or each at {shapes} exact; in one launch each: "
        f"{batches} exact")


def mesh_checks(dev):
    combine_checks(dev)
    k6_checks(dev)
    k7_checks(dev)
    k13_checks(dev)


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
    k15_ops = set(device_eval.OPS) - set(device_eval.RESIDUAL_OPS)
    missing = k15_ops - seen_ops
    check(not missing, f"K15 corpus misses opcodes {sorted(missing)}")
    check(seen_dts >= set(range(5)), "K15 corpus misses a dtype")
    say(f"kernels: expr_eval n=2^20 x {len(K15_CORPUS)} programs, all {len(k15_ops)} "
        f"opcodes, 5 dtypes: bit-exact except transcendentals "
        f"{diffs if diffs else '(none differ)'}")
    k15_edge_checks(dev, env)


def k15_edge_checks(dev, env):
    """K15 on K14's tile body at its edges, bit for bit: INs whose column
    option is half NULL or NULL in the last row only (the reduction over
    every row final before any row reads it), a nested IN, programs past the
    launch's parameters (the staged tables), one row, lanes that are views
    at an offset (their starts off a 16-byte boundary), 5,001 rows."""
    rng = np.random.RandomState(9)
    n = env["a"].values.shape[0]
    last = np.ones(n, bool)
    last[-1] = False
    half = dict(env, b=device_eval.DeviceColumn(env["b"].values, torch.from_numpy(
        rng.rand(n) > 0.5).to(dev)))
    tail = dict(env, a=device_eval.DeviceColumn(env["a"].values, torch.from_numpy(last).to(dev)),
                g=device_eval.DeviceColumn(env["g"].values,
                                           torch.ones(n, dtype=torch.bool, device=dev)))
    one = device_eval.columns_from_numpy({"a": np.array([3], np.int64), "b": np.array([2.5])},
                                         {"b": np.array([False])}, device=dev)
    base = k15_columns(5009, 4, dev)
    views = {k: device_eval.DeviceColumn(c.values[1:5002], c.valid[3:5004])
             for k, c in base.items()}
    long_in = "a IN (%s)" % ", ".join(map(str, range(-100, 100)))
    cases = [(half, "a IN (b, 3, NULL)"), (half, "a IN (b, 3)"), (tail, "b IN (a, g)"),
             (tail, "NOT (b IN (a, g))"), (env, "(a IN (1, 2)) IN (flag, (a IN (b, NULL)))"),
             (env, long_in), (env, "b IN (%s)" % ", ".join(f"{v}.5" for v in range(200))),
             (one, "a IN (b, 3)"), (one, "b IN (a, NULL)"), (one, "coalesce(b, a)")]
    cases += [(views, q) for q in ("a > 2 AND (b < 20 OR flag)", "i * i", "g * g - g",
                                   "a IN (b, 3, NULL)", "hour(t)", "big + i")]
    staged = 0
    for e, q in cases:
        program = device_eval.compile_expr(parse_expression(q)).program(e)
        cols = [e[c] for c in program.columns]
        layout, _ = device_eval._k15_blocks(program, cols, cols[0].values.shape[0])
        staged += layout is column_cache._K14_GLOBAL
        got = device_eval.expr_eval(program, e)
        torch.cuda.synchronize()
        ref = device_eval.expr_eval_plain(program, e)
        same = (ulp_diff(got.values, ref.values)[0] == 0 if got.values.is_floating_point()
                else torch.equal(got.values, ref.values))
        check(same and torch.equal(got.valid, ref.valid),
              f"K15 != plain on {q!r} ({len(program.instrs)} instructions)")
    check(staged >= 2, "no K15 edge program took the staged tables")
    say(f"kernels: expr_eval edges (half-NULL and last-row-NULL IN options, nested IN, "
        f"{staged} programs in the staged tables, one row, lanes at an offset): exact")


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


def equal_all(got, ref):
    return all(torch.equal(g, r) for g, r in zip(got, ref))


def slab_keys(rng, n, cap):
    """A key lane: duplicates, negatives, int64.max keys, full-range keys, and
    garbage in the pad rows [n, cap)."""
    keys = rng.randint(-(1 << 62), 1 << 62, cap).astype(np.int64)
    keys[: n // 4] = rng.randint(-500, 500, n // 4)  # dense duplicates
    keys[n // 4: n // 2] = rng.randint(0, 1 << 25, n // 2 - n // 4)
    keys[rng.choice(n, min(n, 64), replace=False)] = I64_MAX
    keys[rng.choice(n, min(n, 64), replace=False)] = -I64_MAX - 1
    return keys


def slab_checks(dev):
    """K8-K11 against their plain versions on the card, exactly."""
    rng = np.random.RandomState(23)
    for n, cap in ((1 << 20, 1 << 20), (10_000_000, 10_485_760), (0, 1024), (1, 1024)):
        k = torch.from_numpy(slab_keys(rng, max(n, 1), cap) if n else np.zeros(cap, np.int64))
        k, v = k.to(dev), torch.from_numpy(rng.rand(cap) > 0.1).to(dev)
        for keys in (k, k & ((1 << 25) - 1)):  # all 8 digit passes, then 4
            got = key_cache.slab_sort(keys, v, n)
            torch.cuda.synchronize()
            check(equal_all(got, key_cache.slab_sort_plain(keys, v, n)),
                  f"slab_sort != plain at n={n} cap={cap}")
    say("kernels: slab_sort n=2^20 cap=2^20, n=10,000,000 cap=10,485,760, n=0, 1: exact")

    for n, cap in ((1 << 20, 1 << 20), (10_000_000, 10_485_760)):
        keys = slab_keys(rng, n, cap)
        keys[n // 2: n // 2 + 300_000] = np.arange(300_000) + (1 << 40)  # the dense band
        k, v = torch.from_numpy(keys).to(dev), torch.from_numpy(rng.rand(cap) > 0.1).to(dev)
        sk, perm, _, sv = key_cache.slab_sort_plain(k, v, n)
        for m in (1, 1 << 20):
            src = np.concatenate([
                keys[rng.randint(0, n, m)],  # present, duplicated in the source
                rng.randint(-(1 << 62), 1 << 62, m),  # absent
                np.arange(1 << 40, (1 << 40) + m),  # the band: all present
                [I64_MAX, I64_MAX - 1, -I64_MAX],  # a real int64.max, sentinels
            ])
            src = src[rng.permutation(len(src))][: max(m, 8)]
            cap_s = key_cache._bucket(len(src))
            s_in = np.full(cap_s, I64_MAX - 1, np.int64)
            s_in[: len(src)] = src
            s = torch.from_numpy(s_in).to(dev)
            got = key_cache.slab_probe(sk, sv, n, s)
            torch.cuda.synchronize()
            ref = key_cache.slab_probe_plain(sk, sv, n, s)
            check(equal_all(got, ref), f"slab_probe != plain at n={n} m={m}")
            t_match, s_first = ref[1], ref[2]
            mc = int(t_match.sum())
            for tm in (torch.zeros_like(t_match), t_match, torch.ones_like(t_match)):
                out_cap = state_cache._next_pow2(int(tm.sum()), floor=64)
                got = key_cache.pair_compact(tm, s_first, perm, out_cap)
                torch.cuda.synchronize()
                check(torch.equal(got, key_cache.pair_compact_plain(tm, s_first, perm, out_cap)),
                      f"pair_compact != plain at n={n} m={m}")
        s32 = torch.from_numpy(np.concatenate([keys[:4096] & 0xFFFFF, [2**31 - 2] * 8]
                                              ).astype(np.int32)).to(dev)
        sk32, _, _, sv32 = key_cache.slab_sort_plain(k & 0xFFFFF, v, n)
        check(equal_all(key_cache.slab_probe(sk32, sv32, n, s32),
                        key_cache.slab_probe_plain(sk32, sv32, n, s32)),
              f"slab_probe != plain with an int32 source at n={n}")
    cases = kernel_cases()
    for scale in (1, 64):
        for name in cases.CASE_NAMES:
            sk, sv, n, s = (torch.from_numpy(x).to(dev) if isinstance(x, np.ndarray) else x
                            for x in cases.probe_case(name, scale))
            got = key_cache.slab_probe(sk, sv, n, s)
            torch.cuda.synchronize()
            check(equal_all(got, key_cache.slab_probe_plain(sk, sv, n, s)),
                  f"slab_probe != plain on {name} x{scale}")
    say(f"kernels: slab_probe on {', '.join(cases.CASE_NAMES)} at cap 16,384 and 2^20: exact")
    for scale in (1, 64):
        for name in cases.COMPACT_CASES:
            t_np, first_np, perm_np, out_cap = cases.compact_case(name, scale)
            t, first, perm = (torch.from_numpy(x).to(dev) for x in (t_np, first_np, perm_np))
            want = torch.from_numpy(cases.reference_compact(t_np, first_np, perm_np,
                                                            out_cap)).to(dev)
            mc = int(t_np.sum())
            got = key_cache.pair_compact(t, first, perm, out_cap)
            torch.cuda.synchronize()
            check(torch.equal(got, want) and torch.equal(
                key_cache.pair_compact_plain(t, first, perm, out_cap), want),
                f"pair_compact != plain on {name} x{scale}")
            if mc <= out_cap:
                got = key_cache.pair_compact(t, first, perm, out_cap, mc=mc)
                host = key_cache.fetch_pairs(t, first, perm, mc)
                check(torch.equal(got, want) and torch.equal(host[:mc], want[0, :mc].cpu())
                      and torch.equal(host[mc:2 * mc], want[1, :mc].cpu()),
                      f"pair_compact with the head's count != plain on {name} x{scale}")
    say(f"kernels: pair_compact on {', '.join(cases.COMPACT_CASES)} at 70,000 and 4,480,000 "
        "rows, with and without the head's count and as the probe downloads it: exact")
    say(f"kernels: slab_probe n=2^20 and 10,000,000, m=1 and 2^20 (int64), 4104 (int32): exact "
        f"({mc} matched rows in the last); pair_compact empty, partial, full: exact")

    cap = 10_485_760
    lane = torch.from_numpy(rng.rand(cap) > 0.5).to(dev)
    keys = torch.from_numpy(rng.randint(-(1 << 40), 1 << 40, cap)).to(dev)
    inv = torch.from_numpy(rng.permutation(cap).astype(np.int32)).to(dev)
    for d in (64, 16384, 1 << 20):
        rows_np = np.full(d, cap, np.int32)
        k = d - d // 8
        rows_np[:k] = rng.choice(cap, k, replace=False)
        rows_np[k] = -3  # XLA wraps a negative index
        rows = torch.from_numpy(rows_np).to(dev)
        for fn, value in ((key_cache.slab_kill, False), (key_cache.slab_revive, True)):
            got = fn(lane, rows)
            torch.cuda.synchronize()
            check(torch.equal(got, key_cache.slab_flip_plain(lane, rows, value)),
                  f"{fn.__name__} != plain at d={d}")
        check(torch.equal(key_cache.slab_map_rows(inv, rows),
                          key_cache.slab_map_rows_plain(inv, rows)), f"slab_map_rows at d={d}")
        for dt in (np.int32, np.int64):
            nk = torch.from_numpy(rng.randint(-(1 << 31), (1 << 31) - 1, d).astype(dt)).to(dev)
            nv = torch.from_numpy(rng.rand(d) > 0.5).to(dev)
            check(equal_all(key_cache.slab_append(keys, lane, rows, nk, nv),
                            key_cache.slab_append_plain(keys, lane, rows, nk, nv)),
                  f"slab_append != plain at a={d}")
            for start in (0, cap - d - 5, cap):  # the last clamps
                check(equal_all(key_cache.slab_slice_append(keys, lane, start, nk, nv),
                                key_cache.slab_slice_append_plain(keys, lane, start, nk, nv)),
                      f"slab_slice_append != plain at a={d} start={start}")
    k32 = torch.from_numpy(rng.randint(-(1 << 31), (1 << 31) - 1, cap).astype(np.int32)).to(dev)
    check(torch.equal(key_cache.slab_widen(k32), key_cache.slab_widen_plain(k32)), "slab_widen")
    torch.cuda.synchronize()
    say("kernels: slab kill/revive/map_rows d=64..2^20, append/slice_append a=64..2^20 "
        "(int32 and int64 keys, pads out of range), widen cap=10,485,760: exact")
    sv = torch.from_numpy(rng.rand(cap) > 0.5).to(dev)
    for d in (64, 16384, 1 << 20):
        for case in cases.ADVANCE_CASES:
            parts = cases.advance_case(rng, cap, d, case, wide=d == 16384)
            buf, lay = key_cache.pack_advance(**parts)
            b = torch.from_numpy(buf).to(dev)
            mirror = case == "mirror"
            ref = key_cache.slab_advance_plain(keys.clone(), lane.clone(), b, lay,
                                               sv.clone() if mirror else None,
                                               inv if mirror else None)
            for copy in ((), ("keys", "valid", "sorted_valid")):
                ins = (keys.clone(), lane.clone(), sv.clone())
                got = key_cache.slab_advance(ins[0], ins[1], b, lay, ins[2] if mirror else None,
                                             inv if mirror else None, copy=copy)
                torch.cuda.synchronize()
                check(all((g is None and r is None) or torch.equal(g, r)
                          for g, r in zip(got, ref)),
                      f"slab_advance != plain at d={d} ({case}, copy {copy})")
                check(not copy or all(torch.equal(t, u) for t, u in zip(ins, (keys, lane, sv))),
                      f"slab_advance changed its input lanes at d={d} ({case})")
    say("kernels: slab_advance d=64, 16,384, 2^20 (a slice, a row list with pads and negative "
        "rows, runs; int32 and int64 keys; the sorted view mirrored), in place and into new "
        "lanes: exact")


#: bench config 2's upload join shapes: cap_t = _bucket(~11M live rows), cap_s
#: = _bucket(1M source rows)
K12_CAP_T, K12_CAP_S = 12_582_912, 1 << 20


def k12_inputs(rng, dt, cap_t, n, cap_s, m, shape):
    """Padded K12 inputs as ``inner_join_async`` builds them: n target and m
    source keys, then per-side sentinel pads (the top of the range, or the
    bottom for ``shape == "low"``)."""
    info = np.iinfo(dt)
    lo_k, hi_k = (info.min + 2, info.max - 2) if dt == np.int64 else (-(1 << 30), 1 << 30)
    if shape == "dups":  # long duplicate runs on both sides
        t = rng.randint(-500, 500, n)
        s = rng.randint(-700, 700, m)
    elif shape == "none":  # disjoint
        t = rng.randint(0, 1 << 24, n) * 2
        s = rng.randint(0, 1 << 24, m) * 2 + 1
    elif shape == "all":  # every key on both sides matches
        s = rng.randint(lo_k, hi_k, m)
        t = s[rng.randint(0, m, n)]
    elif shape == "marker":  # the hash table's empty-slot key (the type's minimum) and the
        # range's ends on both sides, between narrow keys
        s = rng.randint(-1000, 1000, m).astype(np.int64)
        s[::37] = info.min
        s[5::101] = info.max
        t = rng.randint(-1200, 1200, n).astype(np.int64)
        t[::53] = info.min
        t[7::97] = info.max - 1
        t[11::89] = info.min + 1
    else:  # half the source present (some twice), half fresh; wide keys
        t = rng.randint(lo_k, hi_k, n)
        s = np.concatenate([t[rng.randint(0, n, m - m // 2)], rng.randint(lo_k, hi_k, m // 2)])
        s = s[rng.permutation(m)]
    if shape == "low":
        t_fill, s_fill = info.min, info.min + 1
    else:
        t_fill, s_fill = info.max, info.max - 1
    t_in = np.full(cap_t, t_fill, dt)
    t_in[:n] = t
    s_in = np.full(cap_s, s_fill, dt)
    s_in[:m] = s
    return t_in, s_in


def k12_checks(dev):
    """K12 (the upload join) against its plain version on the card, exactly."""
    rng = np.random.RandomState(29)
    cases = [(np.int32, K12_CAP_T, 11_000_000, K12_CAP_S, 1_000_000, "half"),
             (np.int64, K12_CAP_T, 11_000_000, K12_CAP_S, 1_000_000, "half"),
             (np.int64, K12_CAP_T, 11_000_000, K12_CAP_S, 1_000_000, "low"),
             (np.int32, 1 << 20, 1 << 20, 1 << 16, 60_000, "dups"),
             (np.int64, 1 << 20, 1_000_000, 1 << 16, 60_000, "dups"),
             (np.int32, 1 << 20, 1_000_000, 1 << 16, 65_536, "none"),
             (np.int64, 1 << 20, 1 << 20, 1 << 16, 65_536, "all"),
             (np.int32, 1024, 1000, 8, 1, "half"),
             (np.int64, 64, 64, 8, 1, "all"),
             (np.int32, 1 << 20, 1_000_000, 1 << 16, 60_000, "marker"),
             (np.int64, K12_CAP_T, 11_000_000, K12_CAP_S, 1_000_000, "marker")]
    for dt, cap_t, n, cap_s, m, shape in cases:
        t_in, s_in = k12_inputs(rng, dt, cap_t, n, cap_s, m, shape)
        t, s = torch.from_numpy(t_in).to(dev), torch.from_numpy(s_in).to(dev)
        got = join_kernel.join_probe(t, s)
        torch.cuda.synchronize()
        ref = join_kernel.join_probe_plain(t, s)
        check(equal_all(got, ref), f"join_probe != plain: {np.dtype(dt).name} cap_t={cap_t} "
              f"cap_s={cap_s} m={m} {shape}")
    say("kernels: join_probe (K12) int32 and int64, cap_t=12,582,912 cap_s=2^20, sentinels at "
        "both ends, duplicate runs on both sides, no match, all matched, m=1, the type's "
        "minimum (the hash table's empty-slot key) and maximum on both sides: exact")


# -- K14: the residual mask -----------------------------------------------------------

#: the declared types of the K14 lanes (the residual lowering's input)
K14_TYPES = {"s": StringType(), "d": DateType(), "ts": TimestampType(), "a": LongType(),
             "l": LongType(), "x": DoubleType(), "b": BooleanType()}
#: the K14 corpus: every lane dtype, string codes (present, absent, NULL
#: options), dates and timestamps before 1970 and +-10^6 days away, the
#: calendar opcodes, Kleene logic, and INs whose option is a column
K14_CORPUS = [
    "s = 'alpha'", "s != 'beta'", "s <=> 'gamma'", "s IN ('alpha', 'delta')",
    "s IN ('nosuch', NULL)", "s = 'nosuch' OR a > 10", "s IS NULL",
    "d >= '2024-01-01'", "d < '1969-12-31'", "year(d) = 2024 OR month(d) = 2",
    "year(d) < 0 AND day(d) > 15", "year(d) > 3000", "ts < '1969-12-31 23:00:00'",
    "month(ts) = 12 AND year(ts) > 2000", "to_date(ts) = '1969-12-31'",
    "day(to_date(ts)) = 1", "hour(ts) >= 12", "year(ts) < 1000",
    "a > 5 AND x < 0.5", "a * 2 + l > 10", "x BETWEEN -0.2 AND 0.4", "x / a > 0.01",
    "NOT b OR a = 3", "b", "a IN (1, 2, 3, NULL)", "COALESCE(a, l) > 0",
    "CASE WHEN a > 0 THEN x ELSE l END > 0.5", "abs(a) <= 3", "NOT (a IN (5, 7))",
    "NOT (a IN (l))", "a IN (l, 3)", "NOT (a IN (l, NULL))", "x IN (a, 0.5)",
    # past the launch's parameters (more than 128 literals, and 200 per-file
    # scalars a file): K14's staged tables
    "a IN (%s)" % ", ".join(str(v) for v in range(-199, 201, 2)),
    "NOT (s IN ('gamma', %s))" % ", ".join(f"'w{i}'" for i in range(199)),
]


def k14_lanes(n, cap, seed, dev):
    """Lanes of every dtype, ``n`` real rows padded to ``cap`` as the column
    cache pads them (pad rows invalid): the env and the string dictionary."""
    rng = np.random.RandomState(seed)
    words = np.array(["alpha", "beta", "gamma", "delta"], object)
    s_ok = rng.rand(n) > 0.1
    codes, _, mapping = column_cache._lane_from_column(
        HostColumn("str", np.where(s_ok, words[rng.randint(0, 4, n)], None), s_ok))
    d = rng.randint(-1_000_000, 1_000_001, n).astype(np.int32)
    d[:5] = [-1, 0, 59, -719_162, -1_000_000]
    ts = rng.randint(-86_400_000_000 * 1_000_000, 86_400_000_000 * 1_000_000, n)
    ts[:3] = [-1, -86_400_000_000, -86_400_000_001]
    x = rng.randn(n)
    x[::97] = np.nan
    lanes = {"s": codes, "d": d, "ts": ts.astype(np.int64),
             "a": rng.randint(-50, 50, n).astype(np.int64),
             "l": rng.randint(-50, 50, n).astype(np.int64), "x": x, "b": rng.rand(n) > 0.5}
    env = {}
    for c, v in lanes.items():
        pv = np.zeros(cap, v.dtype)
        pv[:n] = v
        ok = np.zeros(cap, bool)
        ok[:n] = s_ok if c == "s" else rng.rand(n) > 0.1
        env[c] = device_eval.DeviceColumn(torch.from_numpy(pv).to(dev), torch.from_numpy(ok).to(dev))
    return env, mapping


def k14_program(sql, env, mapping, types=K14_TYPES):
    """The residual program of ``sql`` over ``env``'s lanes and its per-file
    scalars (each string literal's code in ``mapping``)."""
    plan = device_eval.compile_residual(parse_predicate(sql), types, ())
    dtypes = tuple(sorted((c, env[c].values.dtype) for c in plan.refs))
    scalar_types = tuple((ph, device_eval.I64) for ph, _c, _v in plan.str_binds)
    program = column_cache._mask_program(plan.expr, dtypes, scalar_types)
    scalars = {ph: (int(mapping.get(v, device_eval.STR_CODE_ABSENT)), True)
               for ph, _c, v in plan.str_binds}
    return program, scalars


def k14_files(dev):
    """Files for K14's batched launch: (env, dictionary, rows) of unequal
    sizes (0, 1, 77, 4097: no multiple of a tile, a 250,000-row file as
    config 12's, a padded 2^20 lane) and 70 files of 1,000 rows, more than
    one parameter block holds; each file's string dictionary its own."""
    shapes = [(64, 64, 0), (64, 64, 1), (77, 128, 77), (4097, 8192, 4097),
              (250_000, 1 << 18, 250_000), ((1 << 20) - 4321, 1 << 20, (1 << 20) - 4321)]
    shapes += [(1000, 1024, 1000)] * 70
    out = []
    for i, (n_lane, cap, n) in enumerate(shapes):
        env, mapping = k14_lanes(n_lane, cap, 100 + i, dev)
        out.append((env, mapping, n))
    return out


def k14_checks(dev):
    files = k14_files(dev)
    envs, ns = [f[0] for f in files], [f[2] for f in files]
    staged = 0
    for sql in K14_CORPUS:
        program, _ = k14_program(sql, envs[0], files[0][1])
        staged += column_cache._k14_layout(program, len(files)) is column_cache._K14_GLOBAL
        scal = [k14_program(sql, env, mapping)[1] for env, mapping, _ in files]
        before = native.launches["residual_mask"]
        got, offs = column_cache.residual_masks(program, envs, ns, scal)
        torch.cuda.synchronize()
        launched = native.launches["residual_mask"] - before
        ref, ref_offs = column_cache.residual_masks_plain(program, envs, ns, scal)
        check(offs == ref_offs and torch.equal(got, ref), f"residual_masks != plain: {sql}")
        want = len(column_cache._launch_groups(program, len(files)))
        check(launched == want, f"residual_masks launched {launched} times, not {want}: {sql}")
    check(staged >= 2, f"only {staged} programs took K14's staged tables")
    say(f"kernels: residual_masks over {len(files)} files (rows 0, 1, 77, 4097, 250,000, "
        f"2^20 - 4321 and 70 x 1,000, each with its own dictionary) exact over "
        f"{len(K14_CORPUS)} programs ({staged} in staged tables), the bytes between files "
        f"included")
    n, cap = (1 << 20) - 4321, 1 << 20  # a padded lane
    env, mapping = k14_lanes(n, cap, 14, dev)
    kept, seen_ops = [], set()
    for sql in K14_CORPUS:
        program, scalars = k14_program(sql, env, mapping)
        seen_ops.update(program.opcodes())
        got = column_cache.residual_mask(program, env, n, scalars)
        torch.cuda.synchronize()
        ref = column_cache.residual_mask_plain(program, env, n, scalars)
        check(torch.equal(got, ref), f"residual_mask != plain: {sql}")
        kept.append(int(got.sum()))
    missing = set(device_eval.RESIDUAL_OPS) - seen_ops
    check(not missing, f"K14 corpus misses opcodes {sorted(missing)}")
    say(f"kernels: residual_mask n={n} cap={cap} exact over {len(K14_CORPUS)} programs "
        f"(rows kept from {min(kept)} to {max(kept)})")


# -- K16: the Morton interleave -------------------------------------------------------


def k16_ranks(k, n, seed, dev):
    rng = np.random.RandomState(seed + k)
    r = rng.randint(0, 1 << 16, (k, n)).astype(np.int32)
    r[:, : n // 4] = rng.randint(0, 8, (k, n // 4))  # ties
    r[:, 0], r[:, 1] = 0, 65535
    return torch.from_numpy(r).to(dev)


def k16_checks(dev):
    """K16 at k = 1..6; the key's sort and an integer column's rank on the
    Z-order sort cases, against their plain versions and numpy."""
    n = 1 << 22
    for k in range(1, 7):
        ranks = k16_ranks(k, n, 16, dev)
        got = zorder.interleave(ranks)
        torch.cuda.synchronize()
        check(torch.equal(got, zorder.interleave_plain(ranks)), f"morton != plain at k={k}")
        key = got
    # the k=6 key (bit 63 set in many) sorted; its low bits ranked as a column
    check(torch.equal(zorder.key_order(key), zorder.key_order_plain(key)),
          "morton_sort != plain at k=6")
    col = key >> 40
    check(torch.equal(zorder.rank_column(col), zorder.rank_column_plain(col)),
          "morton_rank != plain at k=6's key")
    cases = kernel_cases()
    for case in cases.ZSORT_CASES:
        vals = cases.zsort_case(case)
        t = torch.from_numpy(vals).to(dev)
        perm, ranks = zorder.key_order(t), zorder.rank_column(t)
        torch.cuda.synchronize()
        check(np.array_equal(perm.cpu().numpy(), cases.reference_key_order(vals))
              and torch.equal(perm, zorder.key_order_plain(t)),
              f"morton_sort != numpy's stable argsort on {case}")
        check(np.array_equal(ranks.cpu().numpy(), cases.reference_rank(vals))
              and torch.equal(ranks, zorder.rank_column_plain(t)),
              f"morton_rank != rank_u16 on {case}")
        small = torch.clamp(t, -(1 << 31), (1 << 31) - 1).to(torch.int32)
        check(torch.equal(zorder.rank_column(small), zorder.rank_column_plain(small)),
              f"morton_rank of int32 != plain on {case}")
    say(f"kernels: morton n=2^22 k=1..6 exact (ties, ranks 0 and 65535); morton_sort and "
        f"morton_rank (int64 and int32) on k=6's key and on {', '.join(cases.ZSORT_CASES)} "
        "exact against their plain versions and numpy's stable argsort")


# -- phase 4: the slice at full size -------------------------------------------


def write_config6_table(path, partitioned=False, n_files=None):
    """The hot-plan benchmark's config 6 table (bench.py:915-1000, seed 13):
    ``n_files`` files, 4 indexed stats columns (c0/c2 long, c1/c3 double), each
    file covering a narrow range per column, laid out as the bench lays it
    out (``bench.py:959-985``): version 0's JSON commit holds the protocol
    and the metadata, and the checkpoint at version 0, written by the port's
    ``write_checkpoint``, holds them and the ``n_files`` adds. ``partitioned``
    is config 6p (``bench_hot_plan(partitioned=True)``): a ``day`` STRING
    partition column over C6P_DAYS days from 2020-01-01, file i in day
    ``i * C6P_DAYS // n_files``, and every other query on ``day`` (an
    equality with a c0 bound, or a 4-day range). Returns the store, the
    queries and the checkpoint's write seconds. ``n_files`` is N_FILES unless
    given."""
    n_files = N_FILES if n_files is None else n_files
    log_path = os.path.join(path, "_delta_log")
    from delta_tpu_torch.log import checkpoints
    from delta_tpu_torch.storage.logstore import LocalLogStore

    store = LocalLogStore()
    rng = np.random.RandomState(SEED)
    schema = StructType()
    for c in range(4):
        schema = schema.add(f"c{c}", DoubleType() if c % 2 else LongType())
    days = c6p_days() if partitioned else []
    if partitioned:
        schema = schema.add("day", StringType())
    proto = Protocol(1, 2)
    meta = Metadata(schema_string=schema.to_json(),
                    partition_columns=["day"] if partitioned else [])
    store.write(f"{log_path}/{filenames.delta_file(0)}", [proto.json(), meta.json()])
    base = {f"c{c}": np.sort(rng.rand(n_files) * 1e6) if c % 2 else
            np.sort(rng.randint(0, 1 << 40, n_files).astype(np.int64))
            for c in range(4)}
    width = {f"c{c}": 1e6 / n_files * 8 if c % 2 else max((1 << 40) // n_files * 8, 1)
             for c in range(4)}
    # each file's stats JSON, as json.dumps writes it (floats by repr),
    # formatted from Python lists: the table is set-up, not the path
    lo = [base[c].tolist() for c in ("c0", "c1", "c2", "c3")]
    hi = [(base[c] + width[c]).tolist() for c in ("c0", "c1", "c2", "c3")]
    form = ('{"numRecords": 10000, "minValues": {"c0": %d, "c1": %r, "c2": %d, "c3": %r}, '
            '"maxValues": {"c0": %d, "c1": %r, "c2": %d, "c3": %r}, '
            '"nullCount": {"c0": 0, "c1": 0, "c2": 0, "c3": 0}}')
    adds = []
    for i in range(n_files):
        stats = form % (lo[0][i], lo[1][i], lo[2][i], lo[3][i], hi[0][i], hi[1][i], hi[2][i],
                        hi[3][i])
        pv = {"day": days[i * len(days) // n_files]} if partitioned else {}
        adds.append(AddFile(path=f"part-{i:07d}.parquet", size=1 << 20,
                            modification_time=0, data_change=False, stats=stats,
                            partition_values=pv))
    t0 = time.perf_counter()
    checkpoints.write_checkpoint(store, log_path, 0, [proto, meta] + adds)
    write_s = time.perf_counter() - t0
    queries = []
    for k in range(N_QUERIES):
        i = rng.randint(n_files)
        lo0 = int(base["c0"][i])
        lo1 = float(base["c1"][i])
        if partitioned and k % 2 == 0:  # bench.py:1001-1011
            d = i * len(days) // n_files
            if k % 4 == 0:
                queries.append(f"day = '{days[d]}' AND c0 >= {lo0}")
            else:
                queries.append(f"day >= '{days[d]}' AND day <= '{days[min(d + 3, len(days) - 1)]}'")
        else:
            queries.append(f"c0 >= {lo0} AND c0 <= {lo0 + int(width['c0'])} "
                           f"AND c1 >= {lo1:.6f} AND c1 <= {lo1 + width['c1']:.6f}")
    if partitioned:
        return store, queries, write_s, {"base": base, "width": width, "days": days}
    return store, queries, write_s


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
    pcols = frozenset(c.lower() for c in snapshot.metadata.partition_columns)
    rw = pruning.conjunct_rewrites([parse_expression(q)], pcols,
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
    store, queries, write_s = write_config6_table(path)
    parts = config6_checkpoint(store, os.path.join(path, "_delta_log"))
    policy = [footer_policy(p, checkpoint=True) for p in parts]
    say(f"slice: wrote {N_FILES} files as the checkpoint at version 0 ({len(parts)} parts, "
        f"{sum(os.path.getsize(p) for p in parts)} bytes) in {write_s:.3f} s "
        f"(the table in {time.perf_counter() - t0:.3f} s); every chunk of every part as the "
        f"policy says: {len(policy[0])} leaves, {sorted(set(policy[0].values()))}")

    native.reset_launches()  # -- the main path starts here
    DeltaLog.clear_cache()
    state_cache.DeviceStateCache.reset()
    log = DeltaLog.for_table(path, device=dev)
    check(log.device == dev, "DeltaLog is not on the card")
    t0 = time.perf_counter()
    snap = log.update()
    check(snap.num_of_files == N_FILES, f"snapshot has {snap.num_of_files} files")
    decode_s = time.perf_counter() - t0
    check(snap.segment.checkpoint_version == 0 and snap._columnar.stats_parsed is not None,
          "the snapshot did not decode the checkpoint's typed stats")
    say(f"slice: decode of the checkpoint {decode_s:.3f} s (PERF.md section 5 has the decode "
        "of the same table as JSON commits, on another host: no A/B)")
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
        v = 1 + t
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
    for name in ("block_cull", "tail_apply", "winner_bits"):
        check(launches[name] > 0, f"kernel {name} was not launched on the scan-planning path")
    check(launches["tail_apply"] == N_TAILS and launches["scatter_bool"] == 0
          and launches["scatter_cols"] == 0, "a tail must apply in one launch (K3 with K2)")
    return {"entry": entry, "ranges": ranges, "cols": cols, "launches": launches,
            "queries": queries, "log": log, "snap": snap, "store": store, "n_live": n_live}


# -- phase 5: the normal leg and the tombstone replay ----------------------------


def fallback_queries():
    """The query the resident planner declines on config 6, one disjunction
    of the three shapes it cannot plan (a strict float bound beside ``!=``,
    a multi-column interval, a null count), and one that synthesis makes
    exact."""
    declined = ["(c0 != 123456789 AND c1 > 999000.5) OR c0 * c1 > 1.0e18 "
                "OR c2 IS NULL OR c3 * 2 > 1999000.5"]
    exact = "c0 * 2 + 10 >= 2198000000010"
    return declined, exact


def config6_checkpoint(store, log_path):
    """The paths of config 6's checkpoint at version 0 (its parts: a
    million and two actions take two at the default part size, as in the
    JAX package), from ``_last_checkpoint``."""
    from delta_tpu_torch.log import checkpoints

    md = checkpoints.read_last_checkpoint(store, log_path)
    check(md is not None and md.version == 0, "config 6: no checkpoint at version 0")
    return checkpoints.CheckpointInstance(md.version, md.parts).paths(log_path)


def config6_stream(store, log_path, version):
    """Config 6's whole action stream (the checkpoint at version 0's rows,
    then each commit's up to ``version``) as the replay's arrays, decoded by
    ``decode_segment``: its row order is the replay order, so a row's seq is
    its index."""
    from delta_tpu_torch.log.columnar import decode_segment

    cols = decode_segment(store, config6_checkpoint(store, log_path),
                          [f"{log_path}/{filenames.delta_file(v)}"
                           for v in range(1, version + 1)])
    return state_export.ReplayArrays(
        paths=cols.path_dict, path_id=cols.path_id,
        seq=np.arange(cols.num_rows, dtype=np.int64), is_add=cols.is_add, size=cols.size,
        deletion_timestamp=cols.deletion_timestamp)


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
    stream = config6_stream(store, log.log_path, snap.version)
    stream_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rep = replay_kernel.replay_alive_mask(stream, min_retention_ts=TOMB_CUTOFF, device=dev)
    replay_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(native.launches)  # -- the normal leg's path ends here
    say(f"normal leg: launches {launches}")
    for name in ("expr_eval", "replay", "block_cull"):
        check(launches[name] > 0, f"kernel {name} was not launched on the normal leg")

    # each declined query against the host prune over the same files
    # (``pruning._prune_host``: the host evaluator over ``stats_table``, the
    # table built once for the declined queries)
    from delta_tpu_torch.expr.vectorized import to_keep_mask

    t0 = time.perf_counter()
    table = state_export.stats_table(files, meta)
    say(f"normal leg: the host prune's stats table of {len(files)} files in "
        f"{time.perf_counter() - t0:.3f} s")
    for q, s in zip(declined, kept):
        rw = ir.and_all([r.rewritten for r in pruning.conjunct_rewrites(
            [parse_expression(q)], frozenset(), pruning.schema_types(meta))])
        t0 = time.perf_counter()
        host = to_keep_mask(evaluate(rw, table))
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
    _, tomb = snap._columnar.replay(min_retention_ts=TOMB_CUTOFF)
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


# -- phase 5b: bench config 5, a checkpointed log's replay ------------------------

# bench config 5 (bench.py:815-908): 10,000 versions of 20 actions over 50,000
# path names, the checkpoint at version 5,000
C5_VERSIONS, C5_PER_COMMIT, C5_PATHS, C5_SEED = 10_000, 20, 50_000, 7


def write_config5_log(log_path, n_versions=C5_VERSIONS, per_commit=C5_PER_COMMIT,
                      n_paths=C5_PATHS, seed=C5_SEED, device="cuda"):
    """Bench config 5's log through the port's LogStore: each version's
    commit of ``per_commit`` actions (85% adds of a fresh file name of one
    of ``n_paths`` parts, else removes), and at version ``n_versions // 2``
    the port's ``write_checkpoint`` of the live files (``bench.py:827-853``),
    its pages compressed on ``device``. Returns (store, checkpoint paths,
    delta paths after it, live files)."""
    from delta_tpu_torch.log import checkpoints
    from delta_tpu_torch.storage.logstore import LocalLogStore

    store = LocalLogStore()
    rng = np.random.RandomState(seed)
    ckpt_v = n_versions // 2
    active = {}
    for v in range(n_versions):
        lines = []
        for _ in range(per_commit):
            p = f"part-{rng.randint(n_paths):05d}-{v}.parquet"
            if rng.rand() < 0.85:
                sz = int(rng.randint(1, 1 << 24))
                lines.append(json.dumps({"add": {
                    "path": p, "partitionValues": {}, "size": sz,
                    "modificationTime": v, "dataChange": True}}))
                active[p] = sz
            else:
                lines.append(json.dumps({"remove": {
                    "path": p, "deletionTimestamp": v * 1000, "dataChange": True}}))
                active.pop(p, None)
        store.write(f"{log_path}/{filenames.delta_file(v)}", lines)
        if v == ckpt_v:
            checkpoints.write_checkpoint(store, log_path, v, [
                AddFile(path=p, size=s_, modification_time=0, data_change=False)
                for p, s_ in active.items()], device=device)
    ckpt_paths = [f"{log_path}/{filenames.checkpoint_file_single(ckpt_v)}"]
    deltas = [f"{log_path}/{filenames.delta_file(v)}" for v in range(ckpt_v + 1, n_versions)]
    return store, ckpt_paths, deltas, active


def host_replay(store, ckpt_paths, deltas, device="cuda"):
    """The sequential object replay of ``bench.py:858-872``: the checkpoint's
    actions, then each commit line by line; the live file count."""
    from delta_tpu_torch.log import checkpoints
    from delta_tpu_torch.protocol.actions import action_from_json

    state = {}
    for a in checkpoints.read_checkpoint_actions(store, ckpt_paths, device=device):
        if isinstance(a, AddFile):
            state[a.path] = a.size
    for p in deltas:
        for line in store.read(p):
            a = action_from_json(line)
            if isinstance(a, AddFile):
                state[a.path] = a.size
            elif isinstance(a, RemoveFile):
                state.pop(a.path, None)
    return len(state)


def run_config5(dev, workdir):
    """Bench config 5 on the card: the log written through the port's
    LogStore and ``write_checkpoint``, then (the counters set to 0 just
    before) ``decode_segment`` of the checkpoint and its 4,999-commit tail
    and ``replay_columns`` with K4 on the card, three times; the live count
    against the sequential host replay, the winner mask against the host
    winner."""
    from delta_tpu_torch.log.columnar import decode_segment

    log_path = os.path.join(workdir, "config5", "_delta_log")
    t0 = time.perf_counter()
    store, ckpt_paths, deltas, active = write_config5_log(log_path)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_n = host_replay(store, ckpt_paths, deltas)
    host_ms = (time.perf_counter() - t0) * 1e3
    check(host_n == len(active), f"config 5: host replay {host_n} != {len(active)} live files")

    native.reset_launches()  # -- the config 5 path starts here
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        cols = decode_segment(store, ckpt_paths, deltas)
        t1 = time.perf_counter()
        r = replay_kernel.replay_columns(cols, min_retention_ts=0, device=dev)
        t2 = time.perf_counter()
        runs.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3))
        check(int(r.stats.num_files) == host_n,
              f"config 5: {int(r.stats.num_files)} live files on the card, host {host_n}")
    launches = dict(native.launches)  # -- the config 5 path ends here
    check(launches["winner_bits"] == 3, f"config 5: winner_bits launched {launches}")
    t0 = time.perf_counter()
    host_alive, host_tomb = cols.replay(0)
    host_winner_ms = (time.perf_counter() - t0) * 1e3
    check(np.array_equal(r.alive, host_alive) and np.array_equal(r.tombstone, host_tomb),
          "config 5: the card's winner mask differs from the host winner")
    dev_mask = replay_kernel.winner_mask_device(cols.path_id, cols.num_paths, device=dev)
    check(np.array_equal(dev_mask, cols.winner_mask()), "config 5: winner_mask_device != host")
    decode_ms, winner_ms = min(runs)
    say(f"config 5: {C5_VERSIONS} versions of {C5_PER_COMMIT} actions over {C5_PATHS} paths, "
        f"the checkpoint at {C5_VERSIONS // 2} ({len(ckpt_paths)} part), written in "
        f"{write_s:.3f} s; {cols.num_rows} rows, {cols.num_paths} paths, {host_n} live files "
        "on the card and in the host replay, the winner mask equal to the host winner")
    say(json.dumps({"config5": {"decode_ms": decode_ms, "device_winner_ms": winner_ms,
                                "host_winner_ms": host_winner_ms, "host_replay_ms": host_ms,
                                "runs_ms": runs, "launches": launches}}))
    return {"cols": cols, "launches": launches}


# -- phase 6: the MERGE key slab on bench config 2 -------------------------------


def store_sales(n, rng):
    """bench.py:168 `_store_sales`, as numpy columns (same draws)."""
    return {
        "ss_item_sk": rng.permutation(n * 2)[:n].astype(np.int64),
        "ss_customer_sk": rng.randint(0, 1_000_000, n).astype(np.int64),
        "ss_sold_date_sk": rng.randint(2450000, 2452000, n).astype(np.int64),
        "ss_store_sk": rng.randint(0, 500, n).astype(np.int64),
        "ss_quantity": rng.randint(1, 100, n).astype(np.int64),
        "ss_sales_price": rng.rand(n).astype(np.float64) * 100,
        "ss_ext_discount_amt": rng.rand(n).astype(np.float64) * 10,
        "ss_net_paid": rng.rand(n).astype(np.float64) * 90,
    }


def host_table(cols):
    n = len(next(iter(cols.values())))
    kinds = {np.dtype(np.int64): "int", np.dtype(np.float64): "double"}
    return HostTable({k: HostColumn(kinds[v.dtype], v, np.ones(n, bool)) for k, v in cols.items()},
                     n)


def write_data_file(path, name, cols):
    """One data file through the port's writer; its AddFile with stats."""
    size, mtime = write_parquet_file(host_table(cols), os.path.join(path, name))
    stats = json.dumps(collect_stats(host_table(cols)))
    return AddFile(path=name, size=size, modification_time=mtime, data_change=True, stats=stats)


def write_config2_table(path, store):
    """bench_merge_upsert's target (bench.py:192-203): 10M store_sales rows
    from RandomState(7), files of at most 4M rows, committed as v0 with
    deletion vectors enabled; and its source (:205-214)."""
    rng = np.random.RandomState(7)
    cols = store_sales(MERGE_ROWS, rng)
    schema = StructType()
    for k, v in cols.items():
        schema = schema.add(k, LongType() if v.dtype == np.int64 else DoubleType())
    files, adds = {}, []
    for i, lo in enumerate(range(0, MERGE_ROWS, MERGE_FILE_ROWS)):
        part = {k: v[lo:lo + MERGE_FILE_ROWS] for k, v in cols.items()}
        name = f"part-{i:05d}-c2.parquet"
        adds.append(write_data_file(path, name, part))
        files[name] = part
    store.write(f"{path}/_delta_log/{filenames.delta_file(0)}", [
        Protocol(3, 7, ("deletionVectors",), ("deletionVectors",)).json(),
        Metadata(schema_string=schema.to_json(),
                 configuration={"delta.tpu.enableDeletionVectors": "true"}).json(),
        *[a.json() for a in adds]])
    existing = cols["ss_item_sk"][rng.choice(MERGE_ROWS, MERGE_SOURCE // 2, replace=False)]
    fresh = np.arange(MERGE_ROWS * 2, MERGE_ROWS * 2 + (MERGE_SOURCE - MERGE_SOURCE // 2),
                      dtype=np.int64)
    src_keys = np.concatenate([existing, fresh])
    rng.shuffle(src_keys)
    source = store_sales(MERGE_SOURCE, np.random.RandomState(11))
    source["ss_item_sk"] = src_keys
    return files, {a.path: a for a in adds}, source


def reference_join(live, packed, s_keys, s_ok):
    """The numpy reference: per live file, (local rows, first source row) of
    every valid row whose key a valid source row has; the source's matched
    flags and multi-match flag. ``packed(path)`` gives a file's key lane."""
    vidx = np.flatnonzero(s_ok)
    uniq, first, counts = np.unique(s_keys[vidx], return_index=True, return_counts=True)
    pairs, member = {}, np.zeros(len(uniq), bool)
    for path, (_, dv) in live.items():
        k = packed(path)
        valid = np.ones(len(k), bool)
        valid[dv] = False
        pos = np.minimum(np.searchsorted(uniq, k), len(uniq) - 1)
        hit = valid & (uniq[pos] == k)
        pairs[path] = (np.flatnonzero(hit), vidx[first[pos[hit]]])
        member[pos[hit]] = True
    s_matched = np.zeros(len(s_keys), bool)
    pos = np.minimum(np.searchsorted(uniq, s_keys), len(uniq) - 1)
    s_matched[vidx] = member[pos[vidx]]
    multi = bool((member & (counts > 1)).any())
    return pairs, s_matched, multi


def check_probe(entry, live, packed, s_keys, s_ok, label, insert_only=False):
    """One probe through ``probe_async`` against the reference join: flags,
    multi, every pair, and ``pairs_for_file`` file by file. Returns (probe
    ms, the probe)."""
    t0 = time.perf_counter()
    probe = entry.probe_async(s_keys, s_ok, expected_version=entry.version,
                              insert_only=insert_only).result()
    ms = (time.perf_counter() - t0) * 1e3
    pairs, s_matched, multi = reference_join(live, packed, s_keys, s_ok)
    check(np.array_equal(probe.s_matched, s_matched), f"{label}: s_matched differs")
    check(probe.any_multi == multi, f"{label}: any_multi {probe.any_multi}, reference {multi}")
    if insert_only:
        check(probe.t_pairs is None, f"{label}: an insert-only probe fetched pairs")
        return ms, probe
    check(set(probe.slabs) == set(live), f"{label}: the slab's files differ from the live set")
    phys = []
    for path, (want_rows, want_src) in pairs.items():
        off, rows = probe.slabs[path]
        got = probe.pairs_for_file(path, None, rows)
        check(got is not None and np.array_equal(got[0], want_rows)
              and np.array_equal(got[1], want_src), f"{label}: pairs differ in {path}")
        phys.append((off, want_rows + off, want_src))
    want_phys = np.concatenate([p for _, p, _ in sorted(phys, key=lambda t: t[0])])
    want_src = np.concatenate([s for _, _, s in sorted(phys, key=lambda t: t[0])])
    check(np.array_equal(probe.t_pairs[0], want_phys)
          and np.array_equal(probe.t_pairs[1], want_src), f"{label}: t_pairs differ")
    return ms, probe


def run_merge(dev, workdir):
    """Bench config 2's resident key slab, cold build to advances, on the card."""
    from delta_tpu_torch.storage.logstore import LocalLogStore

    path = os.path.join(workdir, "config2")
    store = LocalLogStore()
    t0 = time.perf_counter()
    files, adds, source = write_config2_table(path, store)
    nbytes = sum(os.path.getsize(os.path.join(path, p)) for p in files)
    say(f"merge: wrote {MERGE_ROWS} rows x 8 columns as {len(files)} files in "
        f"{time.perf_counter() - t0:.3f} s, {nbytes} bytes; the first file's chunks "
        f"{footer_policy(os.path.join(path, next(iter(files))))}, the writer's policy")
    live = {p: (cols, np.empty(0, np.int64)) for p, cols in files.items()}
    item = lambda p: live[p][0]["ss_item_sk"]  # noqa: E731
    s_keys = source["ss_item_sk"]
    s_ok = np.ones(MERGE_SOURCE, bool)
    exprs = [ir.Column("ss_item_sk")]

    native.reset_launches()  # -- the MERGE key slab's path starts here
    DeltaLog.clear_cache()
    key_cache.KeyCache.reset()
    log = DeltaLog.for_table(path, device=dev)
    cache = key_cache.KeyCache.instance()
    t0 = time.perf_counter()
    snap = log.update()
    t_get = time.perf_counter()
    entry = cache.get(snap, "item", ["ss_item_sk"], exprs)
    t_up = time.perf_counter()
    check(entry is not None and entry.num_rows == MERGE_ROWS, "cold build")
    entry.ensure_resident()
    torch.cuda.synchronize()
    t_sort = time.perf_counter()
    entry._ensure_sorted()
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    check(MERGE_ROWS != 10_000_000 or entry.capacity == 10_485_760,
          f"slab capacity {entry.capacity}")
    # the host decode alone, again, for the breakdown of get()
    t1 = time.perf_counter()
    tabs = [read_parquet_file(os.path.join(path, p), ["ss_item_sk"]) for p in files]
    decode_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    for tab in tabs:
        key_cache._pack_lanes(tab, exprs, evaluate)
    pack_s = time.perf_counter() - t1
    cold = {"snapshot_s": t_get - t0, "get_s": t_up - t_get, "decode_s": decode_s,
            "pack_s": pack_s, "upload_widen_ms": (t_sort - t_up) * 1e3,
            "sort_ms": (t_end - t_sort) * 1e3, "total_s": t_end - t0}
    say(f"merge: cold build {cold['total_s']:.3f} s: snapshot {cold['snapshot_s']:.3f} s, "
        f"KeyCache.get {cold['get_s']:.3f} s (of which decode {decode_s:.3f} s, pack "
        f"{pack_s:.3f} s, measured again alone), upload int32 + widen "
        f"{cold['upload_widen_ms']:.3f} ms, K8 sort {cold['sort_ms']:.3f} ms "
        f"(cap {entry.capacity}, {entry.num_rows} rows)")

    probe_ms = []
    for i in range(MERGE_PROBES):
        ms, probe = check_probe(entry, live, item, s_keys, s_ok, f"probe {i}")
        probe_ms.append(ms)
    check(int(probe.s_matched.sum()) == MERGE_SOURCE // 2 and len(probe.t_pairs[0])
          == MERGE_SOURCE // 2 and not probe.any_multi, "cold probe: half the source matches, "
          "no multi")
    ins_ms, _ = check_probe(entry, live, item, s_keys, s_ok, "insert-only", insert_only=True)
    p50, p99 = np.percentile(probe_ms, [50, 99])
    say(f"merge: probe x{MERGE_PROBES} ms {[round(x, 3) for x in probe_ms]} (p50 {p50:.3f}, "
        f"p99 {p99:.3f}), insert-only {ins_ms:.3f} ms; {MERGE_SOURCE // 2} matched, all equal to "
        "the reference join")

    # the tail commits
    names = list(files)
    f0, f2 = names[0], names[-1]
    rng = np.random.RandomState(31)
    dv10 = np.sort(rng.choice(MERGE_FILE_ROWS, MERGE_DV_ROWS, replace=False))
    dv5 = np.sort(dv10[rng.choice(MERGE_DV_ROWS, MERGE_DV_ROWS // 2, replace=False)])
    new_c = store_sales(MERGE_APPEND_ROWS, np.random.RandomState(41))
    new_c["ss_item_sk"] = np.arange(MERGE_ROWS * 2, MERGE_ROWS * 2 + MERGE_APPEND_ROWS)
    new_d = store_sales(MERGE_SMALL_ROWS, np.random.RandomState(43))
    new_d["ss_item_sk"] = np.arange(MERGE_ROWS * 4, MERGE_ROWS * 4 + MERGE_SMALL_ROWS)

    def readd(dv_rows):
        desc = write_deletion_vector(dv_rows, path)
        a = adds[f0]
        return AddFile(path=a.path, size=a.size, modification_time=a.modification_time,
                       data_change=True, stats=a.stats, deletion_vector=desc.to_dict())

    steps = [
        (f"a: DV of {len(dv10)} rows", lambda: [readd(dv10)], {f0: dv10}),
        (f"b: DV shrunk to {len(dv5)}", lambda: [readd(dv5)], {f0: dv5}),
        (f"c: {MERGE_APPEND_ROWS}-row file + a removal",
         lambda: [RemoveFile(path=f2, deletion_timestamp=3, data_change=True),
                  write_data_file(path, "part-00003-c2.parquet", new_c)],
         {"part-00003-c2.parquet": None}),
        (f"d: {MERGE_SMALL_ROWS}-row file", lambda: [write_data_file(path, "part-00004-c2.parquet", new_d)],
         {"part-00004-c2.parquet": None}),
    ]
    advance_ms, reprobe_ms = [], []
    for v, (label, actions, change) in enumerate(steps, start=1):
        store.write(f"{path}/_delta_log/{filenames.delta_file(v)}", [a.json() for a in actions()])
        for p, dv in change.items():
            if dv is None:
                files[p] = new_c if p.startswith("part-00003") else new_d
                live[p] = (files[p], np.empty(0, np.int64))
            else:
                live[p] = (files[p], dv)
        if v == 3:
            live.pop(f2)
        before = dict(native.launches)
        snap = log.update()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e = cache.get(snap, "item", ["ss_item_sk"], exprs)
        torch.cuda.synchronize()
        advance_ms.append((time.perf_counter() - t0) * 1e3)
        check(e is entry and e.version == v, f"advance {label}: not applied incrementally")
        n_adv = native.launches["slab_advance"] - before["slab_advance"]
        check(n_adv == 1, f"advance {label}: slab_advance launched {n_adv} times, not once")
        check(all(native.launches[k] == before[k] for k in K11_UPDATES),
              f"advance {label}: a single K11 update was launched")
        ms, probe = check_probe(entry, live, item, s_keys, s_ok, f"after {label}")
        reprobe_ms.append(ms)
        say(f"merge: advance {label}: {advance_ms[-1]:.3f} ms, re-probe {ms:.3f} ms, "
            f"{len(probe.t_pairs[0])} pairs, equal to the reference join")

    # the composite key (ss_customer_sk, ss_store_sk): both fit int32
    c_exprs = [ir.Column("ss_customer_sk"), ir.Column("ss_store_sk")]
    t0 = time.perf_counter()
    ce = cache.get(snap, "customer-store", ["ss_customer_sk", "ss_store_sk"], c_exprs)
    check(ce is not None and ce is not entry
          and ce.num_rows == sum(len(cols["ss_item_sk"]) for cols, _ in live.values()),
          "composite build")
    composite_build_s = time.perf_counter() - t0
    src_tab = host_table(source)
    c_keys, c_ok = key_cache._pack_lanes(src_tab, c_exprs, evaluate)
    check(np.array_equal(c_keys, (source["ss_customer_sk"] << 32) | source["ss_store_sk"]),
          "composite source packing")
    pack = lambda p: (live[p][0]["ss_customer_sk"] << 32) | live[p][0]["ss_store_sk"]  # noqa
    c_ms, c_probe = check_probe(ce, live, pack, c_keys, c_ok, "composite")
    # at full size ~1000 source keys repeat and ~2% of keys are in the target
    check(MERGE_ROWS != 10_000_000 or c_probe.any_multi,
          "composite probe: any_multi must be true")
    launches = dict(native.launches)  # -- the MERGE key slab's path ends here
    say(f"merge: composite (ss_customer_sk, ss_store_sk): build {composite_build_s:.3f} s, "
        f"probe {c_ms:.3f} ms, {len(c_probe.t_pairs[0])} pairs, any_multi {c_probe.any_multi}, "
        "equal to the reference join")
    say(f"merge: launches on the key slab's path {launches}")
    for name in SLAB_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched on the key slab's path")
    check(launches["slab_advance"] == len(steps) and not any(launches[k] for k in K11_UPDATES),
          f"the key slab's path: {launches['slab_advance']} slab_advance launches for "
          f"{len(steps)} advances, single updates {[launches[k] for k in K11_UPDATES]}")
    return {"entry": entry, "source": s_keys, "launches": launches, "cold": cold,
            "probe_p50_ms": float(p50), "probe_p99_ms": float(p99),
            "advance_ms": advance_ms, "dv10": dv10, "dv5": dv5, "off": entry.slabs[f0][0]}


# -- phase 7: the MERGE command on bench config 2 --------------------------------

STORE_SALES = ("ss_item_sk", "ss_customer_sk", "ss_sold_date_sk", "ss_store_sk", "ss_quantity",
               "ss_sales_price", "ss_ext_discount_amt", "ss_net_paid")
K11 = ("slab_advance", "slab_widen")
#: the merges of the phase: (name, table, session settings, the route it must
#: take, the kernels it must launch; a tuple is "one of these": K11's launches
#: depend on the layout, e.g. the advance over M1's commit regrows the 10M-row
#: slab past its capacity, and the re-upload widens)
MERGES = (
    ("M0", "copy", {"delta.tpu.merge.devicePath.mode": "off"}, "host", ()),
    ("M1", "table", {"delta.tpu.merge.devicePath.mode": "force"}, "device-cold",
     ("slab_sort", "slab_probe", "pair_compact", K11)),
    ("M2", "table", {"delta.tpu.merge.devicePath.mode": "force"}, "resident",
     ("slab_probe", "pair_compact", K11)),
    ("M3", "table", {"delta.tpu.merge.devicePath.mode": "force",
                     "delta.tpu.deletionVectors.enabled": False}, "device-upload",
     ("join_probe",)),
)


def bench_source(target_keys, rng, n=MERGE_SOURCE):
    """The bench's upsert source of ``n`` rows (bench.py:205-214; 1M at
    full width): half live keys drawn from ``rng`` (RandomState(7) past the
    target's draws), half fresh keys above every key, payload
    RandomState(11)."""
    existing = target_keys[rng.choice(len(target_keys), n // 2, replace=False)]
    top = len(target_keys) * 2
    fresh = np.arange(top, top + n - n // 2, dtype=np.int64)
    keys = np.concatenate([existing, fresh])
    rng.shuffle(keys)
    return dict(store_sales(n, np.random.RandomState(11)), ss_item_sk=keys)


def merge_sources(target_keys):
    """The phase's three sources, 1M rows each: M1's (and M0's) is the
    bench's (``bench_source``); M2's and M3's are half live keys and half
    fresh keys above every key so far, payload and draws RandomState(12)
    and (13)."""
    rng = np.random.RandomState(7)
    store_sales(MERGE_ROWS, rng)  # the target's draws
    sources = [bench_source(target_keys, rng)]
    top = MERGE_ROWS * 2
    fresh = np.arange(top, top + MERGE_SOURCE - MERGE_SOURCE // 2, dtype=np.int64)
    live = np.union1d(target_keys, fresh)
    for seed in (12, 13):
        top += MERGE_SOURCE
        r = np.random.RandomState(seed)
        existing = live[r.choice(len(live), MERGE_SOURCE // 2, replace=False)]
        fresh = np.arange(top, top + MERGE_SOURCE - MERGE_SOURCE // 2, dtype=np.int64)
        keys = np.concatenate([existing, fresh])
        r.shuffle(keys)
        sources.append(dict(store_sales(MERGE_SOURCE, r), ss_item_sk=keys))
        live = np.union1d(live, fresh)
    return sources


def reference_upsert(state, src):
    """The numpy reference, independent of the port: ``state`` sorted by
    ss_item_sk; a source row whose key is in the state replaces that row,
    the others append. Returns the new state, sorted by ss_item_sk."""
    keys = state["ss_item_sk"]
    pos = np.minimum(np.searchsorted(keys, src["ss_item_sk"]), len(keys) - 1)
    hit = keys[pos] == src["ss_item_sk"]
    out = {}
    for c in STORE_SALES:
        col = state[c].copy()
        col[pos[hit]] = src[c][hit]
        out[c] = np.concatenate([col, src[c][~hit]])
    return by_key(out)


def by_key(cols):
    """``cols`` (numpy columns of one length) reordered as numpy's stable
    argsort of ss_item_sk orders them. The harness's own bookkeeping, no
    code of the port: already sorted columns come back as they are, and
    otherwise torch sorts the keys (``stable=True``) and gathers the
    numeric columns on the card when there is one (seconds a 10M-row state
    on the host, milliseconds there)."""
    keys = cols["ss_item_sk"]
    if len(keys) < 2 or bool((keys[1:] >= keys[:-1]).all()):
        return dict(cols)
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    order = torch.sort(torch.from_numpy(np.ascontiguousarray(keys)).to(dev), stable=True).indices
    host_order = None
    out = {}
    for c, v in cols.items():
        if v.dtype == object:
            if host_order is None:
                host_order = order.cpu().numpy()
            out[c] = v[host_order]
        else:
            out[c] = torch.from_numpy(np.ascontiguousarray(v)).to(dev)[order].cpu().numpy()
    return out


def end_state(log):
    """The table's live rows, read back through the port's scan, sorted by
    ss_item_sk."""
    return state_of(scan_to_table(log.update()))


def run_merge_command(dev, workdir):
    """M0-M3: bench config 2's MERGE through the port's entry points, each
    route checked against the numpy reference upsert."""
    import shutil

    from delta_tpu_torch.commands.alter import set_table_properties
    from delta_tpu_torch.utils.config import conf

    target = store_sales(MERGE_ROWS, np.random.RandomState(7))
    sources = merge_sources(target["ss_item_sk"])
    path = os.path.join(workdir, "config2-merge")
    DeltaLog.clear_cache()
    key_cache.KeyCache.reset()
    captured = {}
    real_join_probe = join_kernel.join_probe

    def capturing_join_probe(t, s):  # keeps M3's padded K12 inputs
        captured["args"] = (t.clone(), s.clone())
        return real_join_probe(t, s)

    with conf.set_temporarily(**{"delta.tpu.write.targetFileRows": MERGE_FILE_ROWS}):
        t0 = time.perf_counter()
        log = DeltaLog.for_table(path, device=dev)
        WriteIntoDelta(log, "append", target).run()
        set_table_properties(log, {"delta.tpu.enableDeletionVectors": "true"})
        write_s = time.perf_counter() - t0
        shutil.copytree(path, path + "-copy", copy_function=os.link)  # as bench.py:216-224
        logs = {"table": log, "copy": DeltaLog.for_table(path + "-copy", device=dev)}
        say(f"merge command: wrote the {MERGE_ROWS}-row target through WriteIntoDelta in "
            f"{write_s:.3f} s ({len(log.update().all_files)} files), deletion vectors on")
        refs = [reference_upsert(by_key({c: target[c] for c in STORE_SALES}), sources[0])]
        for src in sources[1:]:
            refs.append(reference_upsert(refs[-1], src))
        ends, out = {}, []
        native.reset_launches()  # -- the MERGE command's path starts here
        join_kernel.join_probe = capturing_join_probe
        try:
            for i, (name, table, settings, route, kernels) in enumerate(MERGES):
                src = sources[max(i - 1, 0)]
                before = dict(native.launches)
                with conf.set_temporarily(**settings):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    cmd = MergeIntoCommand(
                        logs[table], src, "t.ss_item_sk = s.ss_item_sk",
                        [MergeClause("update")], [MergeClause("insert")],
                        source_alias="s", target_alias="t")
                    cmd.run()
                    torch.cuda.synchronize()
                    wall_s = time.perf_counter() - t0
                check(key_cache.KeyCache.instance().wait_warmups(600), f"{name}: warmup hangs")
                delta = {k: native.launches[k] - before[k] for k in native.launches
                         if native.launches[k] != before[k]}
                check(cmd._join_path == route, f"{name}: route {cmd._join_path}, not {route}")
                check(not cmd._router.get("reason"), f"{name}: fell back: {cmd._router}")
                check(key_cache.KeyCache.instance().last_build_error is None,
                      f"{name}: key-lane build error {key_cache.KeyCache.instance().last_build_error!r}")
                for k in kernels:
                    group = k if isinstance(k, tuple) else (k,)
                    check(any(delta.get(g, 0) > 0 for g in group),
                          f"{name}: none of {group} was launched")
                check(cmd.metrics["numTargetRowsUpdated"] == MERGE_SOURCE // 2
                      and cmd.metrics["numTargetRowsInserted"] == MERGE_SOURCE - MERGE_SOURCE // 2,
                      f"{name}: metrics {cmd.metrics}")
                want = refs[max(i - 1, 0)]
                got = end_state(logs[table])
                for c in STORE_SALES:
                    check(np.array_equal(got[c], want[c]),
                          f"{name}: end-state column {c} differs from the reference upsert")
                ends[name] = got
                if name == "M1":
                    check(all(np.array_equal(ends["M0"][c], got[c]) for c in STORE_SALES),
                          "M0's end state differs from M1's")
                phases = {k: round(v, 3) for k, v in cmd.phase_ms.items()}
                out.append({"name": name, "route": cmd._join_path, "wall_s": wall_s,
                            "phase_ms": phases, "launches": delta,
                            "rows": len(got["ss_item_sk"])})
                say(f"merge command: {name} {cmd._join_path} {wall_s:.3f} s wall, phase_ms "
                    f"{phases}, launches {delta}; {cmd.metrics['numTargetRowsUpdated']} updated, "
                    f"{cmd.metrics['numTargetRowsInserted']} inserted; end state of "
                    f"{len(got['ss_item_sk'])} rows x 8 columns equal to the reference upsert")
        finally:
            join_kernel.join_probe = real_join_probe
        launches = dict(native.launches)  # -- the MERGE command's path ends here
    say(f"merge command: launches on the MERGE command's path {launches}")
    for k in ("slab_sort", "slab_probe", "pair_compact", "join_probe"):
        check(launches[k] > 0, f"kernel {k} was not launched on the MERGE command's path")
    check(any(launches[k] > 0 for k in K11), "no K11 launch on the MERGE command's path")
    check("args" in captured, "M3 did not reach K12")
    return {"merges": out, "launches": launches, "k12_args": captured["args"], "path": path,
            "state": refs[-1]}


def measure_join_probe(dev, cctx):
    """K12 at M3's own padded inputs: held against its plain version, timed
    with both and with torch.searchsorted (the lookup half) as the yardstick."""
    t, s = cctx["k12_args"]
    got, ref = join_kernel.join_probe(t, s), join_kernel.join_probe_plain(t, s)
    torch.cuda.synchronize()
    check(equal_all(got, ref), "join_probe != plain on M3's inputs")
    cap_t, cap_s = t.shape[0], s.shape[0]
    sorted_s = torch.sort(s).values
    b, by = bound(t.element_size() * (cap_t + cap_s) + cap_t // 8 + cap_s // 8 + 1)
    fn = lambda: join_kernel.join_probe(t, s)
    ms = cuda_ms(fn, 20)
    m3 = cctx["merges"][-1]
    say(f"merge command: {m3['name']} {m3['route']}: K12 {ms:.6f} ms of its join_ms "
        f"{m3['phase_ms']['join_ms']} and wall {m3['wall_s']:.3f} s")
    return [dict({"name": "join_probe", "route": "cuda",
                  "source": "delta_tpu_torch/csrc/join_probe.cu",
                  "replaces": "delta_tpu/ops/join_kernel.py:127",
                  "launches": cctx["launches"]["join_probe"],
                  "max_abs_err": max(max_abs_err(g, r) for g, r in zip(got, ref)),
                  "ms": ms, "plain_ms": cuda_ms(lambda: join_kernel.join_probe_plain(t, s), 5),
                  "bound_ms": b, "bound_by": by,
                  "library_ms": cuda_ms(lambda: torch.searchsorted(sorted_s, t), 20),
                  "graph_ms": graph_ms(fn, 10), "breakdown_us": kernel_breakdown(fn),
                  "shape": f"cap_t={cap_t} cap_s={cap_s} {t.dtype} (M3)"},
                 **probe_sectors(dev, cap_t, cap_s))]


# -- phase 8: the filtered read path on bench config 12 ------------------------------

SCAN_ROWS = 2_000_000  # bench.py:604 _rows(2_000_000)


def config12_data(n):
    """bench.py:604-622: ``id``, ``price`` scattered over the whole range,
    ``qty``, an 8-value ``cat`` and ``ts`` (four years from 2020-01-01 UTC,
    scattered)."""
    ids = np.arange(n, dtype=np.int64)
    scattered = (ids * 982_451_653) % n  # a prime above n: a permutation
    cats = np.array(["us-w", "us-e", "eu-c", "eu-w", "ap-s", "ap-n", "sa-e", "af-s"], object)
    rng = np.random.RandomState(23)
    base_us = 1_577_836_800_000_000
    span_us = 4 * 365 * 86_400_000_000
    return {"id": ids, "price": scattered, "qty": rng.randint(1, 9, n).astype(np.int64),
            "cat": cats[ids % len(cats)], "ts": base_us + scattered * (span_us // n)}


def config12_queries(n):
    """bench.py:630-638, each with its numpy reference mask."""
    return lambda d: [
        ("string_eq", "cat = 'eu-c'", d["cat"] == "eu-c"),
        ("string_in", "cat in ('us-w', 'ap-s', 'af-s')",
         np.isin(d["cat"], ["us-w", "ap-s", "af-s"])),
        ("num_scatter", f"price >= {int(0.9 * n)}", d["price"] >= int(0.9 * n)),
        ("arith", f"price * 2 + qty > {int(1.8 * n)}", d["price"] * 2 + d["qty"] > int(1.8 * n)),
        ("conj", "cat = 'us-w' and qty >= 6", (d["cat"] == "us-w") & (d["qty"] >= 6)),
        ("temporal_year", "year(ts) = 2021",
         d["ts"].astype("datetime64[us]").astype("datetime64[Y]").astype(np.int64) == 51),
        ("low_sel", f"price < {max(n // 100, 1)}", d["price"] < max(n // 100, 1)),
    ]


def run_device_scan(dev, workdir):
    """Bench config 12 through ``DeltaTable.to_table``: three legs (host,
    cold device, warm device) of the 7-query residual suite, each query's
    rows and ``id`` sum held against a numpy filter of the generated data."""
    from delta_tpu_torch import DeltaTable
    from delta_tpu_torch.obs import scan_report
    from delta_tpu_torch.utils import telemetry
    from delta_tpu_torch.utils.config import conf

    n = SCAN_ROWS
    data = config12_data(n)
    queries = config12_queries(n)(data)
    path = os.path.join(workdir, "config12")
    DeltaLog.clear_cache()
    column_cache.ColumnCache.reset()
    table = HostTable({
        "id": HostColumn("int", data["id"], np.ones(n, bool)),
        "price": HostColumn("int", data["price"], np.ones(n, bool)),
        "qty": HostColumn("int", data["qty"], np.ones(n, bool)),
        "cat": HostColumn("str", data["cat"], np.ones(n, bool)),
        "ts": HostColumn("ts", data["ts"], np.ones(n, bool))}, n)
    t0 = time.perf_counter()
    with conf.set_temporarily(**{"delta.tpu.write.targetFileRows": max(n // 8, 1000),
                                 "delta.tpu.write.rowGroupRows": max(n // 64, 500)}):
        WriteIntoDelta(DeltaLog.for_table(path, device=dev), "append", table).run()
    tab = DeltaTable.for_path(path, device=dev)
    files = tab.delta_log.update().all_files
    say(f"device scan: wrote {n} rows in {time.perf_counter() - t0:.3f} s "
        f"({len(files)} files of {n // len(files)} rows, row groups of {max(n // 64, 500)})")
    with conf.set_temporarily(**{"delta.tpu.read.deviceResidual.mode": "off"}):
        tab.to_table(filters=[queries[0][1]])  # warm the footers' page cache for every leg

    def leg(mode):
        out = {}
        c0 = telemetry.counters()
        torch.cuda.synchronize()
        t_leg = time.perf_counter()
        with conf.set_temporarily(**{"delta.tpu.read.deviceResidual.mode": mode}):
            for name, q, mask in queries:
                t1 = time.perf_counter()
                result = tab.to_table(filters=[q])
                wall = time.perf_counter() - t1
                rep = scan_report.last_scan_report()
                ids = result.column("id").values
                check(result.num_rows == int(mask.sum())
                      and int(ids.sum()) == int(data["id"][mask].sum()),
                      f"config 12 {mode} {name}: {result.num_rows} rows, id sum {int(ids.sum())}; "
                      f"numpy {int(mask.sum())}, {int(data['id'][mask].sum())}")
                out[name] = {"rows": result.num_rows, "wall_ms": wall * 1e3,
                             "device_residual": rep.device_residual,
                             "bytes_device_survivor": rep.bytes_device_survivor,
                             "row_groups_device_skipped": rep.row_groups_device_skipped}
        total = time.perf_counter() - t_leg
        c1 = telemetry.counters()
        counters = {k: c1.get(k, 0) - c0.get(k, 0) for k in c1 if c1.get(k, 0) != c0.get(k, 0)}
        return {"total_s": total, "queries": out, "counters": counters}

    native.reset_launches()  # -- the read path starts here
    host = leg("off")
    column_cache.ColumnCache.reset()  # the cold leg starts from an empty cache
    cold = leg("force")
    warm = leg("force")
    launches = dict(native.launches)  # -- the read path ends here
    for tag, lg in (("host", host), ("cold", cold), ("warm", warm)):
        per = ", ".join(f"{k} {v['wall_ms']:.1f}" for k, v in lg["queries"].items())
        say(f"device scan: {tag} leg {lg['total_s']:.3f} s ({per} ms); counters "
            f"{ {k: v for k, v in sorted(lg['counters'].items()) if k.startswith(('scan.device', 'columnCache', 'scan.rowgroups'))} }")
    check(cold["counters"].get("columnCache.misses", 0) > 0, "the cold leg decoded no lane")
    check(warm["counters"].get("columnCache.hits", 0) > 0, "the warm leg hit no lane")
    check(warm["counters"].get("columnCache.misses", 0) == 0, "the warm leg missed a lane")
    check(warm["counters"].get("scan.device.engaged", 0) == len(queries),
          f"the warm leg engaged {warm['counters'].get('scan.device.engaged', 0)} times")
    check(all(q["device_residual"] == "device" for q in warm["queries"].values()),
          "a warm query's report is not 'device'")
    check(all(q["device_residual"] is None for q in host["queries"].values()),
          "a host query's report says 'device'")
    check(launches["residual_mask"] > 0, "residual_mask was not launched on the read path")
    say(f"device scan: launches on the read path {launches}; every query's rows and id sum "
        f"equal numpy in all three legs")
    check(launches["residual_mask"] == 2 * len(queries),
          f"residual_mask launched {launches['residual_mask']} times on the read path, not once "
          f"a query of the two device legs ({2 * len(queries)})")
    # K14's measured input: the warm arith query's program over its files' lanes
    cache = column_cache.ColumnCache.instance()
    log_path = tab.delta_log.log_path
    lanes = [{c: cache.get(log_path, f.path, c) for c in ("price", "qty")} for f in files]
    return {"legs": {"host": host, "cold": cold, "warm": warm}, "launches": launches,
            "lanes": lanes, "query": queries[3][1], "types": {"price": LongType(),
                                                             "qty": LongType()},
            "path": path, "data": data, "queries": queries}


def measure_residual_mask(dev, sctx):
    """K14 as the read path launches it: the arith query's one launch over
    config 12's 8 files (their resident lanes), held against its plain
    version and timed eager, from a CUDA graph and per kernel; the per-file
    call beside it; the masks' download to pinned memory on a line of its
    own (the path's cost, not the kernel's)."""
    files = sctx["lanes"]
    envs = [{c: device_eval.DeviceColumn(e.values, e.valid) for c, e in f.items()} for f in files]
    ns = [f["price"].n for f in files]
    program, scalars = k14_program(sctx["query"], envs[0], {}, sctx["types"])
    scal = [scalars] * len(files)
    query = lambda: column_cache.residual_masks(program, envs, ns, scal)
    (got, offs), (ref, _) = query(), column_cache.residual_masks_plain(program, envs, ns, scal)
    torch.cuda.synchronize()
    check(torch.equal(got, ref), "residual_masks != plain on config 12's lanes")
    one = lambda: column_cache.residual_mask(program, envs[0], ns[0], scalars)
    nbytes = sum(sum(e.values.element_size() * n + n for e in f.values()) + n
                 for f, n in zip(files, ns))
    b, by = bound(nbytes)
    host = torch.empty(got.shape, dtype=torch.bool, pin_memory=True)
    down_ms = cuda_ms(lambda: host.copy_(got, non_blocking=True), 20)
    say(f"device scan: the arith query's {len(files)} masks ({got.numel()} B) come down to pinned "
        f"memory in {down_ms:.6f} ms ({got.numel() / down_ms / 1e6:.3f} GB/s)")
    breakdown, graph = kernel_breakdown(query), graph_ms(query, 20)
    if breakdown:
        say(f"device scan: K14's profiled kernel time {sum(breakdown.values()):.3f} us a query, "
            f"its graph time {graph * 1e3:.3f} us")
    row = {"name": "residual_mask", "route": "cuda",
           "source": "delta_tpu_torch/csrc/residual_mask.cu",
           "replaces": "delta_tpu/ops/column_cache.py:312",
           "launches": sctx["launches"]["residual_mask"],
           "max_abs_err": max_abs_err(got, ref),
           "ms": cuda_ms(query, 50),
           "plain_ms": cuda_ms(lambda: column_cache.residual_masks_plain(program, envs, ns,
                                                                         scal), 5),
           "bound_ms": b, "bound_by": by, "library_ms": None, "graph_ms": graph,
           "per_file_ms": cuda_ms(one, 50), "per_file_graph_ms": graph_ms(one, 20),
           "shape": f"{len(files)} files x {ns[0]} rows (cap {files[0]['price'].values.shape[0]}"
                    f"), {len(program.instrs)} instructions over 2 int64 lanes "
                    f"({sctx['query']}): one launch a query"}
    if breakdown is not None:  # a partial trace is left out
        row["breakdown_us"] = breakdown
    return [row]


# -- phase 9: OPTIMIZE ZORDER BY and the point query on bench config 3 --------------

ZORDER_ROWS = 4_000_000  # bench.py:399 _rows(4_000_000)


def reference_morton(cols):
    """The numpy Morton order the JAX package computes: rank_u16, the
    interleave with bits at 64 or past dropped, an unsigned stable argsort
    (delta_tpu/ops/zorder.py:24-62, copied)."""
    k = len(cols)
    key = np.zeros(len(cols[0]), np.uint64)
    for c, v in enumerate(cols):
        order = np.argsort(v, kind="stable")
        ranks = np.empty(len(v), np.int64)
        ranks[order] = np.arange(len(v))
        r = ((ranks * 65535) // max(len(v) - 1, 1)).astype(np.uint64)
        for b in range(16):
            if b * k + c < 64:
                key |= ((r >> np.uint64(b)) & np.uint64(1)) << np.uint64(b * k + c)
    return np.argsort(key, kind="stable")


def run_zorder(dev, workdir):
    """Bench config 3 through the port's entry points: 4M store_sales rows
    appended in 8 chunks, the point query, OPTIMIZE ZORDER BY (ss_item_sk,
    ss_sold_date_sk) with files of 500,000 rows, the point query again."""
    from delta_tpu_torch import DeltaTable
    from delta_tpu_torch.commands.optimize import OptimizeCommand
    from delta_tpu_torch.exec.scan import scan_files

    n = ZORDER_ROWS
    data = store_sales(n, np.random.RandomState(5))
    path = os.path.join(workdir, "config3")
    DeltaLog.clear_cache()
    key_cache.KeyCache.reset()
    column_cache.ColumnCache.reset()
    step = n // 8
    log = DeltaLog.for_table(path, device=dev)
    t0 = time.perf_counter()
    for i in range(8):
        WriteIntoDelta(log, "append", {c: v[i * step:(i + 1) * step] for c, v in data.items()}).run()
    say(f"zorder: appended {n} rows in 8 commits in {time.perf_counter() - t0:.3f} s")
    chunk_of = {}
    for v in range(8):
        for line in open(os.path.join(log.log_path, f"{v:020d}.json")):
            obj = json.loads(line)
            if "add" in obj:
                chunk_of[obj["add"]["path"]] = v
    key = int(data["ss_item_sk"][12345])
    date = int(data["ss_sold_date_sk"][12345])
    pred = f"ss_item_sk = {key} AND ss_sold_date_sk = {date}"
    want = np.flatnonzero((data["ss_item_sk"] == key) & (data["ss_sold_date_sk"] == date))

    def point_query():
        DeltaLog.clear_cache()
        t = DeltaTable.for_path(path, device=dev)
        scan = scan_files(t.delta_log.update(), [pred])
        out = t.to_table(filters=[pred])
        torch.cuda.synchronize()
        return len(scan.files), out

    def rows_equal(out):
        got = np.sort(out.column("ss_customer_sk").values)
        return out.num_rows == len(want) and np.array_equal(
            got, np.sort(data["ss_customer_sk"][want]))

    native.reset_launches()  # -- the Z-order path starts here
    point_query()
    t0 = time.perf_counter()
    pre_files, pre = point_query()
    pre_s = time.perf_counter() - t0
    check(rows_equal(pre), f"the point query before OPTIMIZE returned {pre.num_rows} rows")
    snap = log.update()
    order_in = [chunk_of[f.path] for f in snap.all_files]
    epochs = (key_cache.KeyCache.instance().epoch(log.log_path),
              column_cache.ColumnCache.instance().epoch(log.log_path))
    t0 = time.perf_counter()
    cmd = OptimizeCommand(log, z_order_by=["ss_item_sk", "ss_sold_date_sk"], target_rows=step)
    version = cmd.run()
    torch.cuda.synchronize()
    opt_s = time.perf_counter() - t0
    point_query()
    t0 = time.perf_counter()
    post_files, post = point_query()
    post_s = time.perf_counter() - t0
    launches = dict(native.launches)  # -- the Z-order path ends here
    check(rows_equal(post), f"the point query after OPTIMIZE returned {post.num_rows} rows")
    check(post_files < pre_files, f"files scanned {pre_files} -> {post_files}: no fall")
    check(key_cache.KeyCache.instance().epoch(log.log_path) > epochs[0]
          and column_cache.ColumnCache.instance().epoch(log.log_path) > epochs[1],
          "OPTIMIZE did not bump both device caches' epochs")
    # config 3's two int64 columns: two ranks, one interleave, one sort
    for name, want in (("morton", 1), ("morton_rank", 2), ("morton_sort", 1)):
        check(launches[name] == want,
              f"{name} launched {launches[name]} times on the Z-order path, not {want}")
    check(launches["residual_mask"] > 0, "residual_mask was not launched by the point query")
    # the new files' rows, in order, against the numpy Morton reference
    src = {c: np.concatenate([v[i * step:(i + 1) * step] for i in order_in])
           for c, v in data.items()}
    perm = reference_morton([src["ss_item_sk"], src["ss_sold_date_sk"]])
    adds = [json.loads(line)["add"] for line in
            open(os.path.join(log.log_path, f"{version:020d}.json")) if '"add"' in line]
    check(len(adds) == 8, f"OPTIMIZE wrote {len(adds)} files, not 8")
    for i, a in enumerate(adds):
        t = read_parquet_file(os.path.join(path, a["path"]), ["ss_item_sk", "ss_sold_date_sk",
                                                              "ss_net_paid"])
        rows = perm[i * step:(i + 1) * step]
        for c in ("ss_item_sk", "ss_sold_date_sk", "ss_net_paid"):
            check(np.array_equal(t.column(c).values, src[c][rows]),
                  f"OPTIMIZE file {i}: column {c} is not in the numpy Morton order")
    say(f"zorder: point query {pre_s * 1e3:.1f} ms over {pre_files} files before OPTIMIZE, "
        f"{post_s * 1e3:.1f} ms over {post_files} files after; {post.num_rows} rows both times, "
        f"equal to numpy")
    say(f"zorder: OPTIMIZE ZORDER BY (ss_item_sk, ss_sold_date_sk) {opt_s:.3f} s "
        f"({cmd.metrics['numRemovedFiles']} files -> {cmd.metrics['numAddedFiles']}); every "
        f"new file's rows in the numpy Morton order; both caches' epochs moved; launches "
        f"{launches}")
    split = {k: round(v, 3) for k, v in cmd.phase_ms.items()}
    say("zorder: OPTIMIZE split, wall ms: " + json.dumps(split) + " (the zorder step's own "
        "split, by morton_order's steps, is measure_morton's line)")
    ranks = np.stack([zorder.rank_u16(src["ss_item_sk"]),
                      zorder.rank_u16(src["ss_sold_date_sk"])]).astype(np.int32)
    return {"launches": launches, "ranks": torch.from_numpy(ranks).to(dev),
            "cols": [src["ss_item_sk"], src["ss_sold_date_sk"]], "perm": perm,
            "pre_ms": pre_s * 1e3, "post_ms": post_s * 1e3, "optimize_s": opt_s,
            "phase_ms": split, "files": (pre_files, post_files)}


def morton_steps(cols, dev):
    """``zorder.morton_order``'s steps on ``cols``, the device synchronised
    after each: (the permutation, wall ms of ``ranks``, ``interleave``,
    ``sort``, ``download`` and ``total``). The steps are morton_order's own
    calls; the timing lives here, so the command carries none."""
    out = {}
    torch.cuda.synchronize()
    clock = [time.perf_counter()]

    def lap(name):
        torch.cuda.synchronize()
        clock.append(time.perf_counter())
        out[name] = (clock[-1] - clock[-2]) * 1e3

    ranks = torch.empty((len(cols), len(cols[0])), dtype=torch.int32, device=dev)
    for c, values in enumerate(cols):
        up = zorder._device_rankable(values)
        if up is not None:
            zorder.rank_column(torch.from_numpy(np.ascontiguousarray(values, up)).to(dev),
                               out=ranks[c])
        else:
            ranks[c].copy_(torch.from_numpy(zorder.rank_u16(values).astype(np.int32)))
    lap("ranks")
    key = zorder.interleave(ranks)
    lap("interleave")
    perm = zorder.key_order(key)
    lap("sort")
    perm = perm.cpu().numpy().astype(np.int64)
    lap("download")
    out["total"] = (clock[-1] - clock[0]) * 1e3
    return perm, out


def measure_morton(dev, zctx):
    """K16 at config 3's OPTIMIZE input (k=2, n=4M), the rank of its
    ss_item_sk column and the key's sort, each held against its plain
    version and timed; ``morton_order``'s wall on the two columns split by
    step (the median of 3)."""
    ranks = zctx["ranks"]
    k, n = ranks.shape
    got, ref = zorder.interleave(ranks), zorder.interleave_plain(ranks)
    torch.cuda.synchronize()
    check(torch.equal(got, ref), "morton != plain at config 3's ranks")
    key, flipped = got, got ^ torch.iinfo(torch.int64).min
    check(np.array_equal(zorder.morton_order(zctx["cols"], device=dev), zctx["perm"]),
          "morton_order != the numpy Morton order")
    splits = []
    for _ in range(3):
        perm, t = morton_steps(zctx["cols"], dev)
        check(np.array_equal(perm, zctx["perm"]), "morton_order's steps != the numpy Morton order")
        splits.append(t)
    split = sorted(splits, key=lambda t: t["total"])[1]
    say("zorder: morton_order on config 3's two columns, wall ms by step (median of 3): "
        + json.dumps({k2: round(v, 3) for k2, v in split.items()}))
    fn = lambda: zorder.interleave(ranks)
    b, by = bound(4 * k * n + 8 * n)
    rows = [{"name": "morton", "route": "cuda", "source": "delta_tpu_torch/csrc/morton.cu",
             "replaces": "delta_tpu/ops/zorder.py:34", "launches": zctx["launches"]["morton"],
             "max_abs_err": max_abs_err(got, ref),
             "ms": cuda_ms(fn, 50),
             "plain_ms": cuda_ms(lambda: zorder.interleave_plain(ranks), 5),
             "bound_ms": b, "bound_by": by, "library_ms": None,
             "graph_ms": graph_ms(fn, 20), "breakdown_us": kernel_breakdown(fn),
             "morton_order_split_ms": split,
             "shape": f"k={k} n={n} (config 3's OPTIMIZE)"}]
    # the rank of config 3's ss_item_sk (int64) and the key's sort: each
    # reads the sort's diff back to the host, so no CUDA graph holds them
    col = torch.from_numpy(np.ascontiguousarray(zctx["cols"][0])).to(dev)
    for name, kfn, plain, lib, nbytes, replaces, shape in (
            ("morton_rank", lambda: zorder.rank_column(col),
             lambda: zorder.rank_column_plain(col), lambda: torch.sort(col, stable=True),
             12 * n, "delta_tpu/ops/zorder.py:27 (rank_u16's argsort)",
             f"n={n} int64 (config 3's ss_item_sk)"),
            ("morton_sort", lambda: zorder.key_order(key), lambda: zorder.key_order_plain(key),
             lambda: torch.sort(flipped, stable=True), 12 * n,
             "delta_tpu/ops/zorder.py:62 (the key's argsort)",
             f"n={n} (config 3's k=2 key)")):
        g, r = kfn(), plain()
        torch.cuda.synchronize()
        check(torch.equal(g, r), f"{name} != plain at config 3's shapes")
        b, by = bound(nbytes)
        rows.append({"name": name, "route": "cuda", "source": "delta_tpu_torch/csrc/morton.cu",
                     "replaces": replaces, "launches": zctx["launches"][name],
                     "max_abs_err": max_abs_err(g, r), "ms": cuda_ms(kfn, 20),
                     "plain_ms": cuda_ms(plain, 5), "bound_ms": b, "bound_by": by,
                     "library_ms": cuda_ms(lib, 20), "breakdown_us": kernel_breakdown(kfn, 10),
                     "shape": shape})
    return rows


# -- phase 10: the link-priced auto router ----------------------------------------

#: the cost constants the router prices with, measured at the main path's
#: shapes with the port's own code (filled after the phase that has the
#: shapes; the config 6 pair in the router phase itself)
CONSTS = {}


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def measure_probe_constants(dev, mctx, slab_rows):
    """RESIDENT_PROBE_S_PER_ROW from K9 + K10 at phase 6's shapes (CUDA
    events, per slab + source row); RESIDENT_PAIR_S_PER_ROW and
    RESIDENT_PROBE_FIXED_S from the wall time of a probe and its pair
    mapping (``pairs_for_file`` per file, as the MERGE's finalize does) at
    the bench's 1M source keys and at one key, the link terms of the cost
    model taken out with this run's profile."""
    entry, s_keys = mctx["entry"], mctx["source"]
    n, m = entry.num_rows, len(s_keys)
    k_ms = {r["name"]: r["ms"] for r in slab_rows}
    rps = (k_ms["slab_probe"] + k_ms["pair_compact"]) / 1e3 / (n + m)

    def probe(keys):
        ok = np.ones(len(keys), bool)
        res = entry.probe_async(keys, ok, expected_version=entry.version).result()
        for path, (_off, rows) in res.slabs.items():
            res.pairs_for_file(path, None, rows)
        return len(res.t_pairs[0])

    probe(s_keys)
    big = sorted(timed(lambda: probe(s_keys)) for _ in range(3))[1]
    small = sorted(timed(lambda: probe(s_keys[:1])) for _ in range(3))[1]
    p = link.profile(dev)

    def link_s(mm, pairs):
        return (p.upload_s(mm * 4) + p.download_s(mm // 8 + 6) + p.download_s(pairs * 8)
                + 3 * p.latency_s)

    (big_s, big_pairs), (small_s, small_pairs) = big, small
    pair = (big_s - small_s - (link_s(m, big_pairs) - link_s(1, small_pairs))
            - (m - 1) * rps) / max(big_pairs - small_pairs, 1)
    fixed = small_s - link_s(1, small_pairs) - (n + 1) * rps - small_pairs * pair
    CONSTS.update(RESIDENT_PROBE_S_PER_ROW=rps, RESIDENT_PAIR_S_PER_ROW=pair,
                  RESIDENT_PROBE_FIXED_S=fixed)
    c = mctx["cold"]
    # the cold build's upload + K8, less the transfer the model charges apart
    CONSTS["DEVICE_SORT_S_PER_ROW"] = ((c["upload_widen_ms"] + c["sort_ms"]) / 1e3
                                       - p.upload_s(n * 4)) / n
    say(f"router: probe walls {big_s * 1e3:.3f} ms ({big_pairs} pairs, m={m}) and "
        f"{small_s * 1e3:.3f} ms (m=1) over the {n}-row slab; cold build upload + widen "
        f"{c['upload_widen_ms']:.3f} ms + K8 {c['sort_ms']:.3f} ms")


def measure_join_constants(cctx, k12_rows):
    """HOST_JOIN_S_PER_ROW and HOST_KEY_DECODE_S_PER_ROW from M0's
    ``phase_ms`` (the host join over target + source rows; the decode of
    the key projection, which is all a star upsert with deletion vectors
    reads); KERNEL_S_PER_ROW from K12 at M3's padded inputs."""
    m0 = cctx["merges"][0]
    check(m0["route"] == "host", "M0 is not the host route")
    ph = m0["phase_ms"]
    CONSTS["HOST_JOIN_S_PER_ROW"] = ph["join_ms"] / 1e3 / (MERGE_ROWS + MERGE_SOURCE)
    CONSTS["HOST_KEY_DECODE_S_PER_ROW"] = ph["decode_ms"] / 1e3 / MERGE_ROWS
    t, s_ = cctx["k12_args"]
    CONSTS["KERNEL_S_PER_ROW"] = k12_rows[0]["ms"] / 1e3 / (t.shape[0] + s_.shape[0])


def measure_residual_constants(dev, sctx):
    """HOST_RESIDUAL_S_PER_CELL: the host filter (``boolean_mask``) of each
    config 12 query over its decoded predicate columns; DEVICE_RESIDUAL_S_
    PER_CELL: the warm device pass (``device_residual_masks``: K14 a query,
    the mask downloads), each per (row x predicate column)."""
    from delta_tpu_torch.exec.scan import read_files_as_table, scan_files
    from delta_tpu_torch.expr.vectorized import boolean_mask

    log = DeltaLog.for_table(sctx["path"], device=dev)
    snap = log.update()
    host_s = dev_s = host_cells = dev_cells = 0
    for _name, q, _mask in sctx["queries"]:
        scan = scan_files(snap, [q])
        pred = ir.and_all(scan.partition_filters + scan.data_filters)
        refs = {r.lower() for r in ir.references(pred)}
        cols = [f.name for f in snap.metadata.schema.fields if f.name.lower() in refs]
        tab = read_files_as_table(log.data_path, scan.files, snap.metadata, columns=cols)
        t, _ = min((timed(lambda: boolean_mask(pred, tab)) for _ in range(2)),
                   key=lambda x: x[0])
        host_s += t
        host_cells += tab.num_rows * len(cols)
        with conf.set_temporarily(**{"delta.tpu.read.deviceResidual.mode": "force"}):
            column_cache.device_residual_masks(snap, scan.files, pred)
            t, masks = min((timed(lambda: column_cache.device_residual_masks(
                snap, scan.files, pred)) for _ in range(2)), key=lambda x: x[0])
        dev_s += t
        dev_cells += sum(len(mk) for mk in masks.values()) * len(cols)
    CONSTS["HOST_RESIDUAL_S_PER_CELL"] = host_s / host_cells
    CONSTS["DEVICE_RESIDUAL_S_PER_CELL"] = dev_s / dev_cells


def auto_sources(state, seeds):
    """Upserts for the auto legs, 1M rows each: half live keys of the
    reference state, half fresh keys above every key so far."""
    live = state["ss_item_sk"]
    top = int(live.max()) + 1
    out = []
    for seed in seeds:
        r = np.random.RandomState(seed)
        existing = live[r.choice(len(live), MERGE_SOURCE // 2, replace=False)]
        fresh = np.arange(top, top + MERGE_SOURCE - MERGE_SOURCE // 2, dtype=np.int64)
        keys = np.concatenate([existing, fresh])
        r.shuffle(keys)
        out.append(dict(store_sales(MERGE_SOURCE, r), ss_item_sk=keys))
        live = np.union1d(live, fresh)
        top += MERGE_SOURCE
    return out


def implied(est, device_route, host_route):
    """The route ``deviceEstS`` / ``hostEstS`` imply (both rounded to ms:
    a tie admits either)."""
    d, h = est.get("deviceEstS"), est.get("hostEstS")
    check(d is not None and h is not None, f"no priced estimate in {est}")
    if d == h:
        return (device_route, host_route)
    return (host_route,) if d > h else (device_route,)


def run_router(dev, c6, c2, c12, workdir):
    """Bench configs 6, 2 and 12 under ``auto``: every decision priced with
    this run's link profile and the port's constants, checked against the
    decision the printed prices imply, every result against its oracle."""
    import shutil

    from delta_tpu_torch import DeltaTable
    from delta_tpu_torch.obs import scan_report

    native.reset_launches()  # -- the router's path starts here
    link.reset()
    router_audit.clear_audits()
    t_probe, p = timed(lambda: link.profile(dev))
    check(p.probed and np.isfinite([p.up_mbps, p.down_mbps, p.latency_s]).all()
          and min(p.up_mbps, p.down_mbps, p.latency_s) > 0, f"link profile {p}")
    say(json.dumps({"link": {"up_mbps": p.up_mbps, "down_mbps": p.down_mbps,
                             "latency_s": p.latency_s, "probed": p.probed,
                             "probe_bytes": link._PROBE_BYTES, "probe_s": t_probe}}))

    # config 6: the 256-query plan on the resident entry, as bench.py:1030-1036
    entry, ranges = c6["entry"], c6["ranges"]
    k = entry.num_rows

    def plan(mode):
        with conf.set_temporarily(**{"delta.tpu.stateCache.devicePlan.mode": mode}):
            return timed(lambda: entry.plan_ranges(ranges, k=k))

    plan("force")
    force_s, force_plans = min((plan("force") for _ in range(3)), key=lambda x: x[0])
    off_s, off_plans = min((plan("off") for _ in range(2)), key=lambda x: x[0])
    router_audit.clear_audits()
    auto_runs = [plan("auto") for _ in range(2)]
    auto_s, auto_plans = min(auto_runs, key=lambda x: x[0])
    m = sum(r.verdict is None for r in ranges)
    device_s, host_s, cells, fixed_s, sharded_s, _ = entry._price_plan(m)
    check(sharded_s is None, "config 6 auto: a one-card mesh priced a sharded plan")
    want_via = "device" if device_s < host_s else "host-resident"
    for _, plans in auto_runs:
        for i, (a, f, o) in enumerate(zip(plans, force_plans, off_plans)):
            check(a.via == want_via, f"config 6 auto: query {i} via {a.via}, priced {want_via}")
            check(np.array_equal(a.rows, f.rows) and np.array_equal(a.rows, o.rows),
                  f"config 6 auto: query {i} differs from force or the host plan")
    audits = [a for a in router_audit.recent_audits() if a["op"] == "scan.plan"]
    check(len(audits) == 2 and all(a["decision"] == want_via for a in audits),
          f"config 6 auto: audits {audits}")
    CONSTS["HOST_PRUNE_S_PER_CELL"] = off_s / cells
    CONSTS["DEVICE_PRUNE_S_PER_CELL"] = (force_s - fixed_s) / cells
    a = audits[-1]
    say(f"router: config 6 plan of {len(ranges)} queries over {k} files: force "
        f"{force_s * 1e3:.3f} ms, off {off_s * 1e3:.3f} ms, auto {auto_s * 1e3:.3f} ms via "
        f"{want_via} (priced device {device_s * 1e3:.3f} ms, host {host_s * 1e3:.3f} ms); "
        f"audit predicted {a['predictedMs']} actual {a['actualMs']} miss {a['miss']}; plans "
        "equal force's and the host's")

    # config 2: a cold auto upsert on a fresh hard-linked copy of phase 7's
    # table (bench.py:265-269), then a resident one after a warm slab
    # (bench.py:336-339)
    path = c2["path"] + "-auto"
    shutil.copytree(c2["path"], path, copy_function=os.link)
    log = DeltaLog.for_table(path, device=dev)
    srcs = auto_sources(c2["state"], (14, 15))
    state = c2["state"]
    legs2 = []
    for leg, src, routes in (("cold", srcs[0], ("device-cold", "host")),
                             ("resident", srcs[1], ("resident", "host"))):
        state = reference_upsert(state, src)
        router_audit.clear_audits()
        cmd = MergeIntoCommand(log, src, "t.ss_item_sk = s.ss_item_sk", [MergeClause("update")],
                               [MergeClause("insert")], source_alias="s", target_alias="t")
        with conf.set_temporarily(**{"delta.tpu.merge.devicePath.mode": "auto"}):
            run_s, _ = timed(cmd.run)
        check(key_cache.KeyCache.instance().wait_warmups(600), f"auto {leg}: warmup hangs")
        check(key_cache.KeyCache.instance().last_build_error is None,
              f"auto {leg}: key-lane build error")
        want = implied(cmd._router, *routes)
        check(cmd._join_path in want, f"auto {leg}: route {cmd._join_path}, the prices in "
              f"{cmd._router} imply {want}")
        if leg == "resident":
            check(cmd._router.get("cacheHit") is True, f"auto resident: no slab hit {cmd._router}")
        check(cmd.metrics["numTargetRowsUpdated"] == MERGE_SOURCE // 2
              and cmd.metrics["numTargetRowsInserted"] == MERGE_SOURCE - MERGE_SOURCE // 2,
              f"auto {leg}: metrics {cmd.metrics}")
        got = end_state(log)
        for c in STORE_SALES:
            check(np.array_equal(got[c], state[c]),
                  f"auto {leg}: end-state column {c} differs from the reference upsert")
        [a] = [x for x in router_audit.recent_audits() if x["op"] == "merge.join"]
        phases = {kk: round(v, 3) for kk, v in cmd.phase_ms.items()}
        legs2.append({"leg": leg, "route": cmd._join_path, "wall_s": run_s})
        say(f"router: config 2 auto {leg}: {cmd._join_path} {run_s:.3f} s wall, router "
            f"{cmd._router}, phase_ms {phases}; audit predicted {a['predictedMs']} actual "
            f"{a['actualMs']} miss {a['miss']}; end state of {len(got['ss_item_sk'])} rows x 8 "
            "columns equal to the reference upsert")

    # config 12: the 7 queries under auto, cold after ColumnCache.reset(), then warm
    tab = DeltaTable.for_path(c12["path"], device=dev)
    data = c12["data"]
    column_cache.ColumnCache.reset()
    legs12 = {}
    for leg in ("cold", "warm"):
        per = []
        t_leg = time.perf_counter()
        for name, q, mask in c12["queries"]:
            router_audit.clear_audits()
            with conf.set_temporarily(**{"delta.tpu.read.deviceResidual.mode": "auto"}):
                wall, result = timed(lambda: tab.to_table(filters=[q]))
            rep = scan_report.last_scan_report()
            ids = result.column("id").values
            check(result.num_rows == int(mask.sum())
                  and int(ids.sum()) == int(data["id"][mask].sum()),
                  f"config 12 auto {leg} {name}: {result.num_rows} rows, id sum {int(ids.sum())}")
            [a] = [x for x in router_audit.recent_audits() if x["op"] == "scan.residual"]
            check(rep.device_residual == a["decision"],
                  f"config 12 auto {leg} {name}: report {rep.device_residual}, audit "
                  f"{a['decision']}")
            per.append(f"{name} {a['decision']} {wall * 1e3:.1f} ms (predicted "
                       f"{a['predictedMs']}, actual {a['actualMs']}, miss {a['miss']})")
        legs12[leg] = time.perf_counter() - t_leg
        say(f"router: config 12 auto {leg} leg {legs12[leg]:.3f} s: " + "; ".join(per))
    launches = dict(native.launches)  # -- the router's path ends here
    say(f"router: launches on the router's path {launches}")
    check(launches["link_probe"] == 1, f"link_probe launched {launches['link_probe']} times, "
          "not once per profile miss")
    say(json.dumps({"constants": CONSTS}))
    return {"launches": launches, "c2": {"path": path, "state": state}}


def measure_link_probe(dev, rctx):
    """K17 at the probe's 8 int32, held against its plain version; ``a + 1``
    is also the library call."""
    a = torch.arange(8, dtype=torch.int32, device=dev)
    got, ref = link.link_probe(a), link.link_probe_plain(a)
    torch.cuda.synchronize()
    check(torch.equal(got, ref), "link_probe != plain at the probe's shape")
    b, by = bound(8 * 4 * 2)
    return [{"name": "link_probe", "route": "cuda", "source": "delta_tpu_torch/csrc/link_probe.cu",
             "replaces": "delta_tpu/parallel/link.py:315",
             "launches": rctx["launches"]["link_probe"], "max_abs_err": max_abs_err(got, ref),
             "ms": cuda_ms(lambda: link.link_probe(a), 200),
             "plain_ms": cuda_ms(lambda: link.link_probe_plain(a), 200),
             "bound_ms": b, "bound_by": by,
             "library_ms": cuda_ms(lambda: torch.add(a, 1), 200),
             "shape": "n=8 int32 (the probe's warm-up)"}]


# -- phase 11: times and bounds at the main path's shapes -----------------------


def cull_bytes(mins, maxs, alive, lo, hi, out_bytes):
    """Bytes the block cull needs on these inputs: alive, then a column's
    (min, max) of each live file some query still keeps after the columns
    before it (a file every query has dropped needs no more lanes), the
    bounds in, the bit map out."""
    need = torch.zeros_like(mins, dtype=torch.bool)
    for q0 in range(0, lo.shape[0], 32):
        l, h = lo[q0:q0 + 32], hi[q0:q0 + 32]
        keep = alive[None, :].expand(l.shape[0], -1).clone()
        for c in range(mins.shape[0]):
            need[c] |= keep.any(dim=0)
            mn, mx = mins[c][None, :], maxs[c][None, :]
            keep &= torch.isnan(mx) | torch.isnan(l[:, c:c + 1]) | (mx >= l[:, c:c + 1])
            keep &= torch.isnan(mn) | torch.isnan(h[:, c:c + 1]) | (mn <= h[:, c:c + 1])
    return alive.shape[0] + 8 * int(need.sum()) + 2 * lo.numel() * 4 + out_bytes


def replay_bytes(slabs, num_paths):
    """Bytes the replay (K5 on one slab, K6 on a device's slabs) needs on
    these inputs: every row's path id, the seq and is_add of every row that
    is no pad, one 8-byte field of each winning row (its size where it adds,
    its deletion time where it removes: a row that loses needs neither), both
    masks of every row out, and the three sums."""
    pid = torch.cat([c[0] for c in slabs])
    seq = torch.cat([c[1] for c in slabs])
    valid = pid >= 0
    p, q = pid[valid].long(), seq[valid]
    best = torch.full((max(num_paths, 1),), -(1 << 63), dtype=torch.int64, device=pid.device)
    best.scatter_reduce_(0, p, q, "amax")
    winners = int((best[p] == q).sum())
    return (4 + 2) * pid.numel() + (8 + 1) * p.numel() + 8 * winners + 3 * 8


_L2 = {}


def probe_sectors(dev, cap_t, cap_s):
    """The join's hash probes in L2 sectors (at least one a target key, and
    one a source row in the build and again in the source pass) and what
    they take at the L2 rate measured here: a random gather of 2^24 int64
    from a 16 MB table, one 32-byte sector a read (``torch.take``, timed
    once a run)."""
    if "rate" not in _L2:
        table = torch.randint(0, 1 << 62, (1 << 21,), dtype=torch.int64, device=dev)
        idx = torch.randint(0, 1 << 21, (1 << 24,), dtype=torch.int64, device=dev)
        _L2["rate"] = (1 << 24) / (cuda_ms(lambda: torch.take(table, idx), 20) / 1e3)
    sectors = cap_t + 2 * cap_s
    return {"l2_sectors": sectors, "l2_sectors_per_s": _L2["rate"],
            "l2_ms": sectors / _L2["rate"] * 1e3}


def bound(nbytes):
    """The least ms the card could take to move ``nbytes``, and what bounds
    it."""
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def advance_bytes(rows=0, slice_rows=0, key_bytes=0, run_rows=0, mirror_rows=0, copied=0):
    """The bytes one slab advance (``key_cache.slab_advance``) must move:
    each input read once and each output written once. A row of the row
    list: its 4-byte index and validity byte uploaded, its validity byte
    written; a row of the slice: its key as uploaded (``key_bytes``) and its
    validity byte, the 8-byte key and the validity byte written; a row of a
    run: its validity byte written; a row mirrored into the sorted view: 4
    bytes of ``inv_perm`` read and its sorted validity byte written; a lane
    copied because a probe holds it: ``copied`` bytes read and written."""
    return (6 * rows + (key_bytes + 10) * slice_rows + run_rows + 5 * mirror_rows
            + 2 * copied)


def k1_row(name, d, ranges, launches, reps):
    """K1 on the resident lanes with the bounds ``_plan_device`` launches
    for ``ranges`` (``state_cache.plan_bounds``). ``ms`` is the eager call
    (CUDA events), as every row's; ``graph_ms`` the same call replayed from
    a CUDA graph (no host Python or launch overhead), ``breakdown_us`` the
    profiler's device time per kernel. The bound is the bytes this data
    needs (``cull_bytes``): on these lanes the box test leaves few compares."""
    lo_np, hi_np = state_cache.plan_bounds(np.stack([r.lo for r in ranges]),
                                           np.stack([r.hi for r in ranges]))
    lo, hi = torch.from_numpy(lo_np).to(d["mins"].device), torch.from_numpy(hi_np).to(
        d["mins"].device)
    args = (d["mins"], d["maxs"], d["alive"], lo, hi)
    got = state_cache.block_cull(*args)
    ref = state_cache.block_cull_plain(*args)
    check(bitwise_equal(got, ref), f"block_cull != plain on the main path's lanes ({name})")
    c, cap = d["mins"].shape
    m = lo.shape[0]
    b, by = bound(cull_bytes(*args, got.numel()))
    return {
        "name": name, "route": "cuda", "source": "delta_tpu_torch/csrc/block_cull.cu",
        "replaces": "delta_tpu/ops/state_cache.py:986", "launches": launches["block_cull"],
        "max_abs_err": max_abs_err(got, ref),
        "ms": cuda_ms(lambda: state_cache.block_cull(*args), reps),
        "plain_ms": cuda_ms(lambda: state_cache.block_cull_plain(*args), 5),
        "bound_ms": b, "bound_by": by, "library_ms": None,
        "graph_ms": graph_ms(lambda: state_cache.block_cull(*args), 50),
        "breakdown_us": kernel_breakdown(lambda: state_cache.block_cull(*args)),
        "shape": f"C={c} cap={cap} M={m} ({len(ranges)} queries)"}


def tail_row(dev, d, dead_np, start, k, lo, launches):
    """The tail apply (K3 with K2 on its launch) at config 6's tail: 500 dead
    rows padded to 512 and ``k`` rows appended at ``start``, on clones of the
    resident lanes. ``ms`` is the launch on the uploaded buffer; ``call_ms``
    the upload from pinned memory and the launch, as ``_apply_tail_device``
    makes them; no one torch call does all four scatters
    (``library_parts_ms``: two ``index_fill_`` and two ``index_copy_``)."""
    c = d["mins"].shape[0]
    hi = lo + 1
    packed = np.concatenate([dead_np, lo.cpu().numpy().view(np.int32).ravel(),
                             hi.cpu().numpy().view(np.int32).ravel()])
    buf = state_cache._upload(packed, dev)
    nd = len(dead_np)
    vals = buf[nd:].view(torch.float32).view(2, c, k)
    got = [d[x].clone() for x in ("alive", "mins", "maxs")]
    ref = [x.clone() for x in got]
    fn = lambda: state_cache.tail_apply(*got, buf[:nd], start, k, vals[0], vals[1])
    fn()
    plain = lambda: state_cache.tail_apply_plain(*ref, buf[:nd], start, k, vals[0], vals[1])
    plain()
    check(all(bitwise_equal(g, r) for g, r in zip(got, ref)), "tail_apply != plain at the tail")

    def call():
        b = state_cache._upload(packed, dev)
        v = b[nd:].view(torch.float32).view(2, c, k)
        state_cache.tail_apply(*got, b[:nd], start, k, v[0], v[1])

    keep = buf[:nd][buf[:nd] < d["alive"].shape[0]].long()
    rows = torch.arange(start, start + k, device=dev)
    lo_v, hi_v = vals[0].contiguous(), vals[1].contiguous()
    lib = [x.clone() for x in got]

    def library():
        lib[0].index_fill_(0, keep, False)
        lib[0].index_fill_(0, rows, True)
        lib[1].index_copy_(1, rows, lo_v)
        lib[2].index_copy_(1, rows, hi_v)

    b, by = bound(nd * 4 + int((dead_np < d["alive"].shape[0]).sum()) + k + 2 * (c * k * 4) * 2)
    return {
        "name": "tail_apply", "route": "cuda", "source": "delta_tpu_torch/csrc/tail_scatter.cu",
        "replaces": "delta_tpu/ops/state_cache.py:970", "launches": launches["tail_apply"],
        "max_abs_err": max(max_abs_err(g, r) for g, r in zip(got, ref)),
        "ms": cuda_ms(fn, 200), "plain_ms": cuda_ms(plain, 50), "bound_ms": b, "bound_by": by,
        "library_ms": None, "library_parts_ms": cuda_ms(library, 200),
        "call_ms": cuda_ms(call, 200), "graph_ms": graph_ms(fn, 50),
        "breakdown_us": kernel_breakdown(fn),
        "shape": f"C={c} cap={d['alive'].shape[0]} d={nd} (500 dead rows), k={k} added rows"}


def measure(dev, entry, ranges, cols, launches):
    d = entry._dev
    # the batched plan (M=256), then one query as files_for_scan launches it
    out = [k1_row("block_cull", d, ranges, launches, 50),
           k1_row("block_cull_single_query", d, ranges[:1], launches, 200)]
    c, cap = d["mins"].shape

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
        "replaces": "delta_tpu/ops/state_cache.py:959",
        "launches": launches["tail_apply"] + launches["scatter_bool"],
        "launched_as": "tail_apply (one launch a tail applies the dead rows)",
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
        "replaces": "delta_tpu/ops/state_cache.py:970",
        "launches": launches["tail_apply"] + launches["scatter_cols"],
        "launched_as": "tail_apply (one launch a tail writes both lanes)",
        "max_abs_err": max_abs_err(x, y),
        "ms": cuda_ms(lambda: state_cache.scatter_cols(x, rows, vals), 200),
        "plain_ms": cuda_ms(lambda: state_cache.scatter_cols_plain(y, rows, vals), 50),
        "bound_ms": b, "bound_by": by,
        "library_ms": cuda_ms(lambda: z.index_copy_(1, kept_rows, kept_vals), 200),
        "shape": f"C={c} cap={cap} a=1024 (1000 rows + pads), one lane"})
    out.append(tail_row(dev, d, dead_np, entry.num_rows - 1000, 1000, vals[:, :1000], launches))

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
    """K15 on the declined query's program over the live files' lanes, and
    K5 over the log's action stream: time, plain time, bound."""
    out = []
    meta, files = ctx["snap"].metadata, ctx["files"]
    q = ctx["declined"][0]
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
    fn = lambda: device_eval.expr_eval(program, env)
    out.append({
        "name": "expr_eval", "route": "cuda", "source": "delta_tpu_torch/csrc/residual_mask.cu",
        "replaces": "delta_tpu/expr/jaxeval.py:149", "launches": ctx["fallback_launches"]["expr_eval"],
        "max_abs_err": max_abs_err(got.values, ref.values),
        "ms": cuda_ms(fn, 50),
        "plain_ms": cuda_ms(lambda: device_eval.expr_eval_plain(program, env), 5),
        "bound_ms": b, "bound_by": by, "library_ms": None,
        "graph_ms": graph_ms(fn, 20), "breakdown_us": kernel_breakdown(fn),
        "shape": f"n={n} {program.instrs.shape[0]} instructions over {len(env)} lanes ({q!r}); "
                 f"files_to_arrays {f2a_s:.3f} s, lane upload {upload_ms:.3f} ms"})

    stream = ctx["stream"]
    cap = replay_kernel._next_pow2(stream.num_rows, floor=8)
    cols = [torch.from_numpy(replay_kernel._pad(np.asarray(a, dt), cap, fill)).to(dev)
            for a, dt, fill in ((stream.path_id, np.int32, -1), (stream.seq, np.int64, 0),
                                (stream.is_add, bool, False), (stream.size, np.int64, 0),
                                (stream.deletion_timestamp, np.int64, 0))]
    num_paths, cutoff = len(stream.paths), TOMB_CUTOFF
    got = replay_kernel.replay(*cols, num_paths, cutoff)
    ref = replay_kernel.replay_plain(*cols, num_paths, cutoff)
    check(all(torch.equal(g, r) for g, r in zip(got, ref)), "replay != plain on the log's stream")
    valid = cols[0] >= 0
    pid64, seq = cols[0][valid].long(), cols[1][valid]
    best = torch.empty(num_paths, dtype=torch.int64, device=dev)
    b, by = bound(replay_bytes([cols], num_paths))
    fn = lambda: replay_kernel.replay(*cols, num_paths, cutoff)
    out.append({
        "name": "replay", "route": "cuda", "source": "delta_tpu_torch/csrc/replay.cu",
        "replaces": "delta_tpu/ops/replay_kernel.py:56", "launches": ctx["fallback_launches"]["replay"],
        "max_abs_err": max(max_abs_err(g, r) for g, r in zip(got, ref)),
        "ms": cuda_ms(fn, 50),
        "plain_ms": cuda_ms(lambda: replay_kernel.replay_plain(*cols, num_paths, cutoff), 10),
        "bound_ms": b, "bound_by": by,
        "library_ms": cuda_ms(lambda: best.fill_(-(1 << 63)).scatter_reduce_(
            0, pid64, seq, "amax"), 50),
        # the launch without the call's download of its sums (a CUDA graph
        # cannot hold a synchronisation)
        "graph_ms": graph_ms(lambda: replay_kernel._launch("replay", [cols], num_paths, cutoff),
                             20),
        "breakdown_us": kernel_breakdown(fn),
        "shape": f"n={cap} ({stream.num_rows} actions) num_paths={num_paths}"})
    return out


def slab_row(name, src, launches, got, ref, ms, plain_ms, nbytes, library_ms, shape):
    b, by = bound(nbytes)
    return {"name": name, "route": "cuda", "source": f"delta_tpu_torch/csrc/{src}",
            "replaces": {"slab_sort.cu": "delta_tpu/ops/key_cache.py:166",
                         "slab_probe.cu": "delta_tpu/ops/key_cache.py:206",
                         "pair_compact.cu": "delta_tpu/ops/key_cache.py:353",
                         "slab_update.cu": "delta_tpu/ops/key_cache.py:379"}[src],
            "launches": launches[name],
            "max_abs_err": max(max_abs_err(g, r) for g, r in zip(got, ref)),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
            "library_ms": library_ms, "shape": shape}


def measure_slab(dev, mctx):
    """K8-K11 at the MERGE path's shapes: the slab after the advances, the
    bench source, the advances' row counts."""
    out, launches = [], mctx["launches"]
    e = mctx["entry"]
    keys, valid, n = e._dev["keys"], e._dev["valid"], e.num_rows
    cap = keys.shape[0]
    args = (keys, valid, n)
    got, ref = key_cache.slab_sort(*args), key_cache.slab_sort_plain(*args)
    check(equal_all(got, ref), "slab_sort != plain on the slab")
    enc = torch.where(torch.arange(cap, device=dev) < n, keys, torch.full_like(keys, I64_MAX))
    out.append(slab_row("slab_sort", "slab_sort.cu", launches, got, ref,
                        cuda_ms(lambda: key_cache.slab_sort(*args), 20),
                        cuda_ms(lambda: key_cache.slab_sort_plain(*args), 5), 26 * cap,
                        cuda_ms(lambda: torch.sort(enc, stable=True), 20),
                        f"cap={cap} n={n}"))
    out[-1]["breakdown_us"] = kernel_breakdown(lambda: key_cache.slab_sort(*args))
    sk, perm, inv, sv = got

    s_keys = mctx["source"]
    m = len(s_keys)
    cap_s = key_cache._bucket(m)
    s_in = np.full(cap_s, np.iinfo(np.int32).max - 1, np.int32)
    s_in[:m] = s_keys
    s = torch.from_numpy(s_in).to(dev)
    got, ref = key_cache.slab_probe(sk, sv, n, s), key_cache.slab_probe_plain(sk, sv, n, s)
    check(equal_all(got, ref), "slab_probe != plain on the slab")
    t_match, s_first = got[1], got[2]
    mc = int(t_match.sum())
    s64, real = s.to(torch.int64), sk[:n]
    out.append(slab_row("slab_probe", "slab_probe.cu", launches, got, ref,
                        cuda_ms(lambda: key_cache.slab_probe(sk, sv, n, s), 20),
                        cuda_ms(lambda: key_cache.slab_probe_plain(sk, sv, n, s), 5),
                        5 * cap + 6 + cap_s // 8 + 4 * cap_s + 8 * cap_s + mc,
                        cuda_ms(lambda: torch.searchsorted(real, s64), 20),
                        f"cap={cap} n={n} m={cap_s} ({m} source rows, int32), {mc} matched"))
    out[-1]["graph_ms"] = graph_ms(lambda: key_cache.slab_probe(sk, sv, n, s), 10)
    out[-1]["breakdown_us"] = kernel_breakdown(lambda: key_cache.slab_probe(sk, sv, n, s))

    out_cap = state_cache._next_pow2(mc, floor=64)
    compact = lambda: key_cache.pair_compact(t_match, s_first, perm, out_cap, mc=mc)
    got = compact()
    ref = key_cache.pair_compact_plain(t_match, s_first, perm, out_cap)
    check(torch.equal(got, ref), "pair_compact != plain on the probe's rows")

    def library_compact():
        idx = torch.nonzero(t_match).reshape(-1)
        return torch.index_select(perm, 0, idx), torch.index_select(s_first, 0, idx)

    # the host side of the probe's pairs as probe_async takes them: K10
    # with the pinned download of the first mc pairs and the count, then
    # the finalize's casts; K10 puts them in physical order, so the order
    # step the finalize used to take (a stable argsort) is nothing
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = key_cache.fetch_pairs(t_match, s_first, perm, mc).numpy()
    fetch_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    phys, srows = host[:mc].astype(np.int64), host[mc:2 * mc].astype(np.int64)
    cast_ms = (time.perf_counter() - t0) * 1e3
    check(np.array_equal(phys, ref[0, :mc].cpu().numpy()) and
          np.array_equal(srows, ref[1, :mc].cpu().numpy()) and bool(np.all(np.diff(phys) > 0)),
          "the probe's downloaded pairs are not the plain version's, in physical order")

    out.append(slab_row("pair_compact", "pair_compact.cu", launches, [got], [ref],
                        cuda_ms(compact, 20),
                        cuda_ms(lambda: key_cache.pair_compact_plain(t_match, s_first, perm,
                                                                     out_cap), 5),
                        cap + 8 * mc + 8 * out_cap, cuda_ms(library_compact, 20),
                        f"cap={cap} {mc} pairs out_cap={out_cap}; host: launch and pinned "
                        f"download {fetch_ms:.3f} ms, casts {cast_ms:.3f} ms, order 0 ms "
                        "(no argsort)"))
    out[-1]["graph_ms"] = graph_ms(compact, 10)
    out[-1]["breakdown_us"] = kernel_breakdown(compact)

    def padded(rows, d):
        r = np.full(d, cap, np.int32)
        r[:len(rows)] = rows
        return torch.from_numpy(r).to(dev)

    off = mctx["off"]
    for name, fn, plain, rows_np, value in (
            ("slab_kill", key_cache.slab_kill, key_cache.slab_flip_plain, mctx["dv10"], False),
            ("slab_revive", key_cache.slab_revive, key_cache.slab_flip_plain, mctx["dv5"], True)):
        d = state_cache._next_pow2(len(rows_np), floor=64)
        rows = padded(rows_np + off, d)
        got, ref = fn(valid, rows), plain(valid, rows, value)
        check(torch.equal(got, ref), f"{name} != plain on the slab")
        kept = rows[rows < cap].long()
        out.append(slab_row(name, "slab_update.cu", launches, [got], [ref],
                            cuda_ms(lambda: fn(valid, rows), 50),
                            cuda_ms(lambda: plain(valid, rows, value), 20), 2 * cap + 4 * d,
                            cuda_ms(lambda: valid.index_fill(0, kept, value), 50),
                            f"cap={cap} d={d} ({len(rows_np)} rows)"))
    d = state_cache._next_pow2(len(mctx["dv10"]), floor=64)
    rows = padded(mctx["dv10"] + off, d)
    got, ref = key_cache.slab_map_rows(inv, rows), key_cache.slab_map_rows_plain(inv, rows)
    check(torch.equal(got, ref), "slab_map_rows != plain on the slab")
    kept = rows[rows < cap].long()
    out.append(slab_row("slab_map_rows", "slab_update.cu", launches, [got], [ref],
                        cuda_ms(lambda: key_cache.slab_map_rows(inv, rows), 50),
                        cuda_ms(lambda: key_cache.slab_map_rows_plain(inv, rows), 20), 12 * d,
                        cuda_ms(lambda: torch.take(inv, kept), 50), f"cap={cap} d={d}"))

    a_rows = MERGE_APPEND_ROWS
    a = state_cache._next_pow2(a_rows, floor=64)
    rows = padded(np.arange(MERGE_ROWS, MERGE_ROWS + a_rows, dtype=np.int32), a)
    nk_np = np.zeros(a, np.int32)
    nk_np[:a_rows] = np.arange(MERGE_ROWS * 2, MERGE_ROWS * 2 + a_rows)
    nk, nv = torch.from_numpy(nk_np).to(dev), torch.from_numpy(np.arange(a) < a_rows).to(dev)
    got = key_cache.slab_append(keys, valid, rows, nk, nv)
    ref = key_cache.slab_append_plain(keys, valid, rows, nk, nv)
    check(equal_all(got, ref), "slab_append != plain at the advance's shape")
    kept, nk64 = rows[rows < cap].long(), nk[:a_rows].long()
    kept_nk, kept_nv = nk64[: len(kept)], nv[: len(kept)]
    # K11 writes new lanes (a probe in flight keeps the ones it pinned): the
    # library's out-of-place index_copy computes the same function
    out.append(slab_row("slab_append", "slab_update.cu", launches, got, ref,
                        cuda_ms(lambda: key_cache.slab_append(keys, valid, rows, nk, nv), 20),
                        cuda_ms(lambda: key_cache.slab_append_plain(keys, valid, rows, nk, nv),
                                10), 18 * cap + 9 * a,
                        cuda_ms(lambda: (torch.index_copy(keys, 0, kept, kept_nk),
                                         torch.index_copy(valid, 0, kept, kept_nv)), 50),
                        f"cap={cap} a={a} ({a_rows} rows, {len(kept)} inside cap)"))

    k32 = keys.to(torch.int32)
    got, ref = key_cache.slab_widen(k32), key_cache.slab_widen_plain(k32)
    check(torch.equal(got, ref), "slab_widen != plain on the slab")
    out.append(slab_row("slab_widen", "slab_update.cu", launches, [got], [ref],
                        cuda_ms(lambda: key_cache.slab_widen(k32), 50),
                        cuda_ms(lambda: key_cache.slab_widen_plain(k32), 50), 12 * cap,
                        cuda_ms(lambda: k32.to(torch.int64), 50), f"cap={cap}"))

    a = state_cache._next_pow2(MERGE_SMALL_ROWS, floor=64)
    start = e.num_rows - MERGE_SMALL_ROWS
    nk, nv = nk[:a].contiguous(), torch.ones(a, dtype=torch.bool, device=dev)
    got = key_cache.slab_slice_append(keys, valid, start, nk, nv)
    ref = key_cache.slab_slice_append_plain(keys, valid, start, nk, nv)
    check(equal_all(got, ref), "slab_slice_append != plain at the advance's shape")
    nk64 = nk.long()

    def library_slice():
        k, v = keys.clone(), valid.clone()
        k[start:start + a].copy_(nk64)
        v[start:start + a].copy_(nv)
        return k, v

    out.append(slab_row("slab_slice_append", "slab_update.cu", launches, got, ref,
                        cuda_ms(lambda: key_cache.slab_slice_append(keys, valid, start, nk, nv),
                                50),
                        cuda_ms(lambda: key_cache.slab_slice_append_plain(keys, valid, start,
                                                                          nk, nv), 20),
                        18 * cap + 5 * a, cuda_ms(library_slice, 50),
                        f"cap={cap} a={a} start={start}"))
    out.append(advance_row(dev, mctx, keys, valid, sv, inv))
    return out


def advance_row(dev, mctx, keys, valid, sv, inv):
    """K11's advance at phase 6's advance a (the deletion vector of 10,000
    rows, the sorted view mirrored) on copies of the slab's lanes: in place,
    into a new sorted validity (a probe in flight), with its pinned upload,
    and replayed from a CUDA graph; no one torch call computes it, so the
    in-place and out-of-place library calls of the same updates are summed
    beside it."""
    rows_np = mctx["dv10"] + mctx["off"]
    buf, lay = key_cache.pack_advance(rows=rows_np, rows_valid=np.zeros(len(rows_np), bool))
    b = torch.from_numpy(buf).to(dev)
    k, v, s = keys.clone(), valid.clone(), sv.clone()
    fn = lambda: key_cache.slab_advance(k, v, b, lay, s, inv)  # noqa: E731
    got = fn()
    ref = key_cache.slab_advance_plain(keys.clone(), valid.clone(), b, lay, sv.clone(), inv)
    torch.cuda.synchronize()
    check(all(torch.equal(g, r) for g, r in zip(got, ref)), "slab_advance != plain on the slab")
    kept = torch.from_numpy(rows_np).to(dev)
    v2, s2 = v.clone(), s.clone()

    def library(inplace):
        spos = torch.take(inv, kept).long()
        if inplace:
            v2.index_fill_(0, kept, False)
            s2.index_fill_(0, spos, False)
        else:
            return v.index_fill(0, kept, False), s.index_fill(0, spos, False)

    row = slab_row("slab_advance", "slab_update.cu", mctx["launches"], got, ref,
                   cuda_ms(fn, 50),
                   cuda_ms(lambda: key_cache.slab_advance_plain(k, v, b, lay, s, inv), 20),
                   advance_bytes(rows=len(rows_np), mirror_rows=len(rows_np)), None,
                   f"cap={keys.shape[0]} advance a: {len(rows_np)} rows, sorted view mirrored")
    row.update(
        pinned_ms=cuda_ms(lambda: key_cache.slab_advance(k, v, b, lay, s, inv,
                                                         copy=("sorted_valid",)), 50),
        pinned_bound_ms=bound(advance_bytes(rows=len(rows_np), mirror_rows=len(rows_np),
                                            copied=keys.shape[0]))[0],
        upload_launch_ms=cuda_ms(lambda: key_cache.slab_advance(
            k, v, state_cache._upload(buf, dev), lay, s, inv), 50),
        graph_ms=graph_ms(fn, 20), breakdown_us=kernel_breakdown(fn),
        library_out_of_place_ms=cuda_ms(lambda: library(False), 50),
        library_inplace_ms=cuda_ms(lambda: library(True), 50),
        advance_walls_ms=mctx["advance_ms"])
    return row


# -- phase 12: the state mesh ----------------------------------------------------------


def mesh_merge(dev, c2a, workdir):
    """The fifth MERGE: bench config 2's upload route with the 8-entry mesh
    installed, on a fresh hard-linked copy of phase 10's table (M3's table
    after the two auto upserts, whose deletion vectors make a copy-on-write
    merge take the upload join, as M3's did), with a new 1M-row source."""
    import shutil

    path = c2a["path"] + "-mesh"
    shutil.copytree(c2a["path"], path, copy_function=os.link)
    log = DeltaLog.for_table(path, device=dev)
    [src] = auto_sources(c2a["state"], (16,))
    want = reference_upsert(c2a["state"], src)
    captured = {}
    real = join_kernel.sharded_join_probe

    def capturing(t_slabs, s_parts):  # keeps the merge's K13 inputs
        captured["args"] = ([t.clone() for t in t_slabs], [x.clone() for x in s_parts])
        return real(t_slabs, s_parts)

    before = dict(native.launches)
    join_kernel.sharded_join_probe = capturing
    try:
        with conf.set_temporarily(**{"delta.tpu.merge.devicePath.mode": "force",
                                     "delta.tpu.deletionVectors.enabled": False}):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cmd = MergeIntoCommand(log, src, "t.ss_item_sk = s.ss_item_sk",
                                   [MergeClause("update")], [MergeClause("insert")],
                                   source_alias="s", target_alias="t")
            cmd.run()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
    finally:
        join_kernel.sharded_join_probe = real
    delta = {k: native.launches[k] - before[k] for k in native.launches
             if native.launches[k] != before[k]}
    check(cmd._join_path == "device-upload", f"M4: route {cmd._join_path}, not device-upload")
    check(not cmd._router.get("reason"), f"M4: fell back: {cmd._router}")
    check(delta.get("sharded_join_probe", 0) == 1 and "join_probe" not in delta,
          f"M4: launches {delta}: K13 once (one distinct device) and no K12 expected")
    check(cmd.metrics["numTargetRowsUpdated"] == MERGE_SOURCE // 2
          and cmd.metrics["numTargetRowsInserted"] == MERGE_SOURCE - MERGE_SOURCE // 2,
          f"M4: metrics {cmd.metrics}")
    got = end_state(log)
    for c in STORE_SALES:
        check(np.array_equal(got[c], want[c]),
              f"M4: end-state column {c} differs from the reference upsert")
    phases = {k: round(v, 3) for k, v in cmd.phase_ms.items()}
    return {"args": captured["args"], "wall_s": wall_s, "phase_ms": phases, "launches": delta,
            "rows": len(got["ss_item_sk"])}


def mesh_plan_leg(entry, ranges, settings):
    """The 256-query plan on a fresh residency under ``settings``: best of
    three after a first (cold) call."""
    entry.drop_device()
    k = entry.num_rows
    with conf.set_temporarily(**settings):
        cold_s, _ = timed(lambda: entry.plan_ranges(ranges, k=k))
        wall_s, plans = min((timed(lambda: entry.plan_ranges(ranges, k=k)) for _ in range(3)),
                            key=lambda x: x[0])
    return cold_s, wall_s, plans


def measure_shard_constants(dev, shards, lo, hi):
    """SHARD_GATHER_S_PER_SHARD: the gather of config 6's 8 block maps into
    the lead device's map (CUDA events), per shard: what K7 pays where the
    shards span cards. SHARD_DISPATCH_S: the host wall of one synchronized
    sharded cull at the smallest plan that splits over 8 shards (8 queries,
    one 1024-file block a shard), best of 20. On one card K7 is one launch
    that writes the gathered map itself, so no gather is inside that
    wall."""
    out = state_cache.sharded_block_cull(shards, lo, hi)
    w = out.shape[1] // len(shards)
    parts = [out[:, i * w:(i + 1) * w].contiguous() for i in range(len(shards))]
    gather_ms = cuda_ms(lambda: mesh.all_gather(parts, dev, axis=1), 50)
    rng = np.random.RandomState(43)
    small = k7_shards(*[torch.from_numpy(a).to(dev) for a in (
        (rng.rand(4, 8 * 1024) * 100).astype(np.float32),
        (rng.rand(4, 8 * 1024) * 100 + 100).astype(np.float32),
        np.ones(8 * 1024, bool))], len(shards))
    s_lo = torch.from_numpy((rng.rand(8, 4) * 100).astype(np.float32))
    s_hi = s_lo + 1
    walls = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state_cache.sharded_block_cull(small, s_lo, s_hi)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    gather_s = gather_ms / 1e3 / len(shards)
    dispatch_s = min(walls)
    check(gather_s > 0 and dispatch_s > 0, f"shard constants {gather_s}, {dispatch_s}")
    return {"SHARD_DISPATCH_S": dispatch_s, "SHARD_GATHER_S_PER_SHARD": gather_s,
            "gather_ms_8_shards": gather_ms, "small_cull_wall_s": min(walls),
}


def auto_leg(entry, ranges, host_plans, leg):
    """The 256-query plan under ``devicePlan.mode=auto`` on the mesh, its
    route the one ``_price_plan``'s prices imply (a resident entry keeps its
    shards), its rows the host's."""
    router_audit.clear_audits()
    m = sum(r.verdict is None for r in ranges)
    with conf.set_temporarily(**{"delta.tpu.stateCache.devicePlan.mode": "auto"}):
        device_s, host_s, _, _, sh_s, shards = entry._price_plan(m)
        best = min(device_s, sh_s) if sh_s is not None else device_s
        if entry.is_resident:
            sharded = entry.resident_shards > 1
        else:
            sharded = sh_s is not None and sh_s < device_s
        want_via = ("host-resident" if best >= host_s
                    else "device-sharded" if sharded else "device")
        auto_s, auto_plans = timed(lambda: entry.plan_ranges(ranges, k=entry.num_rows))
    for i, (a, ph) in enumerate(zip(auto_plans, host_plans)):
        check(a.via in (want_via, "verdict"), f"config 6 mesh auto {leg}: query {i} via "
              f"{a.via}, priced {want_via}")
        check(np.array_equal(a.rows, ph.rows), f"config 6 mesh auto {leg}: query {i} != host")
    [a] = [x for x in router_audit.recent_audits() if x["op"] == "scan.plan"]
    say(f"mesh: config 6 auto {leg} over {shards} feasible shards: {want_via} in "
        f"{auto_s * 1e3:.3f} ms (priced device {device_s * 1e3:.3f}, sharded "
        f"{sh_s * 1e3:.3f}, host {host_s * 1e3:.3f} ms); audit predicted "
        f"{a['predictedMs']} actual {a['actualMs']} miss {a['miss']}")


def run_mesh(dev, c6, c2a, workdir):
    """Phase 12: the sharded paths at full width with one card named 8
    times, and over every card where there are several."""
    from delta_tpu_torch.multichip import dryrun_multichip

    t_phase = time.perf_counter()
    entry, ranges, stream = c6["entry"], c6["ranges"], c6["stream"]
    cutoff = TOMB_CUTOFF
    force1 = {"delta.tpu.stateCache.devicePlan.mode": "force",
              "delta.tpu.distributed.plan.enabled": False}
    force8 = {"delta.tpu.stateCache.devicePlan.mode": "force",
              "delta.tpu.distributed.plan.mode": "force"}
    # one card's plans and replay, and the host plans: what the mesh must equal
    _, single_s, single_plans = mesh_plan_leg(entry, ranges, force1)
    host_plans = entry.plan_ranges(ranges, k=entry.num_rows, use_device=False)
    k5 = replay_kernel.replay_alive_mask(stream, min_retention_ts=cutoff, device=dev)
    devices = [dev] * MESH_SHARDS
    with mesh.using_devices(devices):
        m8 = mesh.state_mesh(device=dev)
        native.reset_launches()  # -- the mesh's path starts here
        cold_s, sharded_s, plans = mesh_plan_leg(entry, ranges, force8)
        check(entry.resident_shards == MESH_SHARDS, f"resident_shards {entry.resident_shards}")
        for i, (p8, p1, ph) in enumerate(zip(plans, single_plans, host_plans)):
            check(p8.via in ("device-sharded", "verdict"), f"config 6 mesh: query {i} via {p8.via}")
            check(np.array_equal(p8.rows, p1.rows) and np.array_equal(p8.rows, ph.rows)
                  and p8.count == p1.count == ph.count,
                  f"config 6 mesh: query {i} differs from one card's or the host plan")
        k7_in = [(sh["mins"], sh["maxs"], sh["alive"]) for sh in entry._dev]
        say(f"mesh: config 6 plan of {len(ranges)} queries over {entry.num_rows} files on "
            f"{MESH_SHARDS} shards of one card: {sharded_s * 1e3:.3f} ms (cold {cold_s * 1e3:.3f}"
            f" ms) against one card's {single_s * 1e3:.3f} ms; plans equal one card's and the "
            "host's")
        t_rep, rep = timed(lambda: replay_kernel.replay_sharded(stream, m8,
                                                                min_retention_ts=cutoff))
        check(np.array_equal(rep.alive, k5.alive) and np.array_equal(rep.tombstone, k5.tombstone)
              and rep.stats == k5.stats, "replay_sharded != K5's replay_alive_mask")
        say(f"mesh: replay_sharded over {stream.num_rows} actions on {MESH_SHARDS} shards in "
            f"{t_rep * 1e3:.3f} ms: {int(rep.stats.num_files)} live files, "
            f"{int(rep.stats.num_tombstones)} tombstones, bytes {int(rep.stats.total_size)}, "
            "equal to K5's masks and sums")
        m4 = mesh_merge(dev, c2a, workdir)
        say(f"mesh: M4 device-upload on {MESH_SHARDS} shards {m4['wall_s']:.3f} s wall, "
            f"phase_ms {m4['phase_ms']} (M3's {c2a['m3']['phase_ms']}, {c2a['m3']['wall_s']:.3f}"
            f" s), launches {m4['launches']}; end state of {m4['rows']} rows x 8 columns equal "
            "to the reference upsert")
        t_dry, report = timed(lambda: dryrun_multichip(MESH_SHARDS, device=dev))
        say(f"mesh: dryrun_multichip({MESH_SHARDS}) in {t_dry:.3f} s: " + json.dumps(report))
        launches = dict(native.launches)  # -- the mesh's path ends here
        say(f"mesh: launches on the mesh's path {launches}")
        for name in ("sharded_block_cull", "sharded_replay", "sharded_join_probe",
                     "shard_combine", "expr_eval"):
            check(launches[name] > 0, f"kernel {name} was not launched on the mesh's path")
        # K6 launches once a replay on one card: this phase's and the dryrun's three
        check(launches["sharded_replay"] == 4,
              f"sharded_replay launched {launches['sharded_replay']} times for 4 replays")
        # every shard on one card: K6 and K13 reduce in their own launches;
        # the one combine is multichip's count of K15's kept rows
        check(launches["shard_combine"] == MESH_COMBINES,
              f"shard_combine launched {launches['shard_combine']} times on the mesh's path, "
              f"not {MESH_COMBINES}")

        # auto, priced with this run's shard constants
        lo = torch.from_numpy(state_cache._f32_down(np.stack([r.lo for r in ranges])))
        hi = torch.from_numpy(state_cache._f32_up(np.stack([r.hi for r in ranges])))
        consts = measure_shard_constants(dev, k7_in, lo, hi)
        say(json.dumps({"mesh_constants": consts}))
        for name in ("SHARD_DISPATCH_S", "SHARD_GATHER_S_PER_SHARD"):
            link.set_calibrated(name, consts[name])
        try:
            entry.drop_device()
            for leg in ("cold", "warm"):
                auto_leg(entry, ranges, host_plans, leg)
        finally:
            link.clear_calibrated()
    count = torch.cuda.device_count()
    if count > 1:
        cards = [torch.device("cuda", i) for i in range(count)]
        with mesh.using_devices(cards):
            _, multi_s, plans = mesh_plan_leg(entry, ranges, force8)
            check(all(np.array_equal(p.rows, q.rows) for p, q in zip(plans, host_plans)),
                  f"config 6 over {count} cards differs from the host plan")
            rep = replay_kernel.replay_sharded(stream, cards, min_retention_ts=cutoff)
            check(np.array_equal(rep.alive, k5.alive) and rep.stats == k5.stats,
                  f"replay_sharded over {count} cards != K5")
            report = dryrun_multichip(count, device=dev)
        say(f"mesh: over {count} cards: plan {multi_s * 1e3:.3f} ms on "
            f"{entry.resident_shards} shards, replay equal to K5, dryrun {json.dumps(report)}")
    entry.drop_device()
    say(f"mesh: phase 12 took {time.perf_counter() - t_phase:.3f} s")
    return {"launches": launches, "k7": k7_in, "lo": lo, "hi": hi, "m4": m4,
            "stream": stream, "cutoff": cutoff}


def measure_mesh(dev, xctx):
    """K6, K7, K13 and the combine kernel at phase 12's shapes."""
    out = []
    launches = xctx["launches"]
    # K7 at config 6's sharded lanes
    shards, lo, hi = xctx["k7"], xctx["lo"].to(dev), xctx["hi"].to(dev)
    got = state_cache.sharded_block_cull(shards, lo, hi)
    ref = state_cache.sharded_block_cull_plain(shards, lo, hi)
    torch.cuda.synchronize()
    check(torch.equal(got, ref), "sharded_block_cull != plain on config 6's lanes")
    mins = torch.cat([s[0] for s in shards], dim=1)
    maxs = torch.cat([s[1] for s in shards], dim=1)
    alive = torch.cat([s[2] for s in shards])
    c, cap = mins.shape
    m = lo.shape[0]
    b, by = bound(cull_bytes(mins, maxs, alive, lo, hi, got.numel()))
    out.append({
        "name": "sharded_block_cull", "route": "cuda", "source": "delta_tpu_torch/csrc/block_cull.cu",
        "replaces": "delta_tpu/ops/state_cache.py:1014",
        "launches": launches["sharded_block_cull"], "max_abs_err": max_abs_err(got, ref),
        "ms": cuda_ms(lambda: state_cache.sharded_block_cull(shards, lo, hi), 20),
        "plain_ms": cuda_ms(lambda: state_cache.sharded_block_cull_plain(shards, lo, hi), 3),
        "bound_ms": b, "bound_by": by, "library_ms": None,
        "shape": f"C={c} cap={cap} M={m} over {len(shards)} shards of one card (config 6)"})
    del mins, maxs, alive

    # K6 at the log's action stream over 8 shards
    stream, cutoff = xctx["stream"], xctx["cutoff"]
    slabs, _, _ = k6_slabs(stream, dev)
    pid = np.asarray(stream.path_id)
    num_paths = max(len(stream.paths), int(pid.max()) + 1)
    got = replay_kernel.sharded_replay(slabs, num_paths, cutoff)
    ref = replay_kernel.sharded_replay_plain(slabs, num_paths, cutoff)
    torch.cuda.synchronize()
    check(all(torch.equal(g, r) for g, r in zip(got[0] + got[1], ref[0] + ref[1]))
          and torch.equal(got[2], ref[2]), "sharded_replay != plain on the log's stream")
    cap_sh = slabs[0][0].shape[0]
    b, by = bound(replay_bytes(slabs, num_paths))
    whole = [torch.from_numpy(np.asarray(a)).to(dev) for a in (stream.path_id, stream.seq)]
    pid64, seq = whole[0].long(), whole[1]
    best = torch.empty(num_paths, dtype=torch.int64, device=dev)
    fn = lambda: replay_kernel.sharded_replay(slabs, num_paths, cutoff)
    out.append({
        "name": "sharded_replay", "route": "cuda", "source": "delta_tpu_torch/csrc/replay.cu",
        "replaces": "delta_tpu/ops/replay_kernel.py:206",
        "launches": launches["sharded_replay"],
        "max_abs_err": max(max_abs_err(g, r) for g, r in zip(got[0] + got[1] + [got[2]],
                                                               ref[0] + ref[1] + [ref[2]])),
        "ms": cuda_ms(fn, 20),
        "plain_ms": cuda_ms(lambda: replay_kernel.sharded_replay_plain(slabs, num_paths,
                                                                       cutoff), 5),
        "bound_ms": b, "bound_by": by,
        "library_ms": cuda_ms(lambda: best.fill_(-(1 << 63)).scatter_reduce_(
            0, pid64, seq, "amax"), 50),
        # the launch and the combine, without the call's download of the sums
        "graph_ms": graph_ms(lambda: replay_kernel._sharded_launch(slabs, num_paths, cutoff),
                             20),
        "breakdown_us": kernel_breakdown(fn),
        "shape": f"{MESH_SHARDS} shards x cap={cap_sh} ({stream.num_rows} actions) "
                 f"num_paths={num_paths}: one launch"})
    del slabs, whole, pid64, seq, best

    # K13 at M4's own inputs
    t_slabs, s_parts = xctx["m4"]["args"]
    got = join_kernel.sharded_join_probe(t_slabs, s_parts)
    s_full = torch.cat(s_parts)
    ref = join_kernel.sharded_join_probe_plain(t_slabs, s_full)
    torch.cuda.synchronize()
    check(equal_all(got, ref), "sharded_join_probe != plain on M4's inputs")
    t_full = torch.cat(t_slabs)
    check(equal_all(got, join_kernel.join_probe(t_full, s_full)),
          "sharded_join_probe != K12 on M4's inputs")
    cap_t, cap_s = t_full.shape[0], s_full.shape[0]
    b, by = bound(t_full.element_size() * (cap_t + cap_s) + cap_t // 8 + cap_s // 8 + 1)
    sorted_s = torch.sort(s_full).values
    fn = lambda: join_kernel.sharded_join_probe(t_slabs, s_parts)
    out.append(dict({
        "name": "sharded_join_probe", "route": "cuda", "source": "delta_tpu_torch/csrc/join_probe.cu",
        "replaces": "delta_tpu/ops/join_kernel.py:150",
        "launches": launches["sharded_join_probe"],
        "max_abs_err": max(max_abs_err(g, r) for g, r in zip(got, ref)),
        "ms": cuda_ms(fn, 10),
        "plain_ms": cuda_ms(lambda: join_kernel.sharded_join_probe_plain(t_slabs, s_full), 3),
        "bound_ms": b, "bound_by": by,
        "library_ms": cuda_ms(lambda: torch.searchsorted(sorted_s, t_full), 20),
        "graph_ms": graph_ms(fn, 10), "breakdown_us": kernel_breakdown(fn),
        "shape": f"cap_t={cap_t} cap_s={cap_s} {t_full.dtype} over {len(t_slabs)} shards of one "
                 "card (M4): one launch"}, **probe_sectors(dev, cap_t, cap_s)))
    del t_full, s_full, sorted_s

    # the combine at K13's reduction over eight cards: each card's packed
    # source hits (cap_s / 8 bytes) and multi byte, ORed in one launch; no
    # one PyTorch call ORs bytes across rows, so library_ms is null
    hits = (torch.rand((MESH_SHARDS, cap_s), device=dev) < 0.05).to(torch.uint8)
    packed = state_cache._packbits(hits)
    multi = (torch.arange(MESH_SHARDS, device=dev) == 5).to(torch.uint8).reshape(-1, 1)
    pair = [(packed, "or"), (multi, "or")]
    fn = lambda: mesh.shard_combine_many(pair)
    got = fn()
    ref = [mesh.shard_combine_plain(x, op) for x, op in pair]
    torch.cuda.synchronize()
    check(all(torch.equal(g, r) for g, r in zip(got, ref)),
          "shard_combine_many != plain at K13's shape")
    check(torch.equal(got[0], state_cache._packbits(hits.any(dim=0))),
          "the OR of K13's packed hits != the packing of their OR")
    b, by = bound(packed.numel() + cap_s // 8 + MESH_SHARDS + 1)
    # the one launch on the smoke's path: multichip's (8, 1) step count
    count = torch.arange(MESH_SHARDS, dtype=torch.int64, device=dev).reshape(-1, 1)
    one = lambda: mesh.shard_combine(count, "sum")
    bp, _ = bound(8 * MESH_SHARDS + 8)
    out.append({
        "name": "shard_combine", "route": "cuda", "source": "delta_tpu_torch/csrc/shard_combine.cu",
        "replaces": "delta_tpu/ops/join_kernel.py:150 (psum)",
        "launches": launches["shard_combine"],
        "max_abs_err": max(max_abs_err(g, r) for g, r in zip(got, ref)),
        "ms": cuda_ms(fn, 100),
        "plain_ms": cuda_ms(lambda: [mesh.shard_combine_plain(x, op) for x, op in pair], 20),
        "bound_ms": b, "bound_by": by, "library_ms": None,
        "graph_ms": graph_ms(fn, 50), "breakdown_us": kernel_breakdown(fn),
        "shape": f"or of ({MESH_SHARDS}, {cap_s // 8}) u8 + or of ({MESH_SHARDS}, 1) u8 in one "
                 "launch (K13's packed source hits and multi bytes over eight cards)",
        "path_launch": {"shape": f"sum of ({MESH_SHARDS}, 1) int64 (multichip's count)",
                        "ms": cuda_ms(one, 100), "graph_ms": graph_ms(one, 50),
                        "bound_ms": bp, "library_ms": cuda_ms(lambda: count.sum(dim=0), 100),
                        "breakdown_us": kernel_breakdown(one)}})
    return out


# -- phase 13: DELETE, UPDATE, RESTORE, VACUUM and time travel on bench config 2 -----

DML_MOVE = 30_000_000  # step 2 moves keys past every key the table holds
#: fresh-key bases of the phase's upserts: above every key of phase 7's end
#: state (< MERGE_ROWS * 2 + 3 * MERGE_SOURCE = 23M) and below DML_MOVE
DML_FRESH = {"prime": 24_000_000, "step3": 25_000_000, "step5": 26_000_000,
             "step7": 27_000_000}
DML_PRIME = 10_000  # step 0's upsert: it builds the key slab that steps 1-3 advance


def state_of(t):
    """A scan's rows as numpy columns sorted by ss_item_sk (no NULLs)."""
    check(all(t.column(c).valid.all() for c in STORE_SALES), "a NULL in a read")
    return by_key({c: t.column(c).values for c in STORE_SALES})


def same_state(got, want, label):
    check(len(got["ss_item_sk"]) == len(want["ss_item_sk"]),
          f"{label}: {len(got['ss_item_sk'])} rows, the reference {len(want['ss_item_sk'])}")
    for c in STORE_SALES:
        check(np.array_equal(got[c], want[c]), f"{label}: column {c} differs from numpy")


def take_state(state, keep):
    """The rows of ``state`` where ``keep``, sorted by ss_item_sk."""
    return by_key({c: v[keep] for c, v in state.items()})


def dml_source(seed, n, picks, fresh_base):
    """An upsert of ``n`` rows: the keys in ``picks`` (live keys the caller
    drew), the rest fresh from ``fresh_base``; payload from RandomState(seed)."""
    r = np.random.RandomState(seed)
    fresh = np.arange(fresh_base, fresh_base + n - len(picks), dtype=np.int64)
    keys = np.concatenate([np.asarray(picks, np.int64), fresh])
    r.shuffle(keys)
    return dict(store_sales(n, r), ss_item_sk=keys)


def data_files_on_disk(root):
    """Every file an independent walk of the table finds outside hidden
    (``_``/``.``) names, relative to the root."""
    out = set()
    for d, dirs, files in os.walk(root):
        dirs[:] = [x for x in dirs if not x.startswith(("_", "."))]
        rel = os.path.relpath(d, root)
        out |= {os.path.normpath(os.path.join(rel, f)) for f in files
                if not f.startswith(("_", "."))}
    return out


def commit_actions(log, version):
    from delta_tpu_torch.protocol.actions import actions_from_lines

    return actions_from_lines(log.store.read(f"{log.log_path}/{filenames.delta_file(version)}"))


def timed_step(name, fn, settings=None):
    """Run one command under ``settings``: (its value, wall seconds, the
    launches it made by kernel), after the key cache's warmups it started
    have ended without a build error."""
    before = dict(native.launches)
    with conf.set_temporarily(**(settings or {})):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    check(key_cache.KeyCache.instance().wait_warmups(600), f"{name}: warmup hangs")
    check(key_cache.KeyCache.instance().last_build_error is None,
          f"{name}: key-lane build error {key_cache.KeyCache.instance().last_build_error!r}")
    delta = {k: native.launches[k] - before[k] for k in native.launches
             if native.launches[k] != before[k]}
    return out, wall_s, delta


def upsert(log, name, source, keys, live, want_route, settings=None):
    """One MERGE upsert keyed on ss_item_sk (update *, insert *) on the
    card's join path, its route and its metrics checked against numpy's
    (``keys`` the source's keys, ``live`` the target's): (command, wall
    seconds, launches, phase ms)."""
    def run():
        cmd = MergeIntoCommand(log, source, "t.ss_item_sk = s.ss_item_sk",
                               [MergeClause("update")], [MergeClause("insert")],
                               source_alias="s", target_alias="t")
        cmd.run()
        return cmd

    cmd, wall_s, delta = timed_step(name, run, dict(
        {"delta.tpu.merge.devicePath.mode": "force"}, **(settings or {})))
    check(cmd._join_path == want_route, f"{name}: route {cmd._join_path}, not {want_route}")
    check(not cmd._router.get("reason"), f"{name}: fell back: {cmd._router}")
    hits = int(np.isin(keys, live).sum())
    check(cmd.metrics["numTargetRowsUpdated"] == hits
          and cmd.metrics["numTargetRowsInserted"] == len(keys) - hits,
          f"{name}: metrics {cmd.metrics}, numpy {hits} updates")
    return cmd, wall_s, delta, {k: round(v, 3) for k, v in cmd.phase_ms.items()}


def run_dml(dev, c2, workdir, card):
    """Phase 13: DELETE, UPDATE, MERGE, RESTORE, VACUUM and time travel on a
    hard-linked copy of phase 7's table (M3's end state), each step's end
    state read back with ``scan_to_table`` and equal, all 8 columns exactly,
    to numpy's same operations on the generated arrays."""
    import shutil
    import urllib.parse

    from delta_tpu_torch import DeltaTable
    from delta_tpu_torch.ops.column_cache import ColumnCache
    from delta_tpu_torch.utils.errors import DeltaIllegalStateError

    path = c2["path"] + "-dml"
    shutil.copytree(c2["path"], path, copy_function=os.link)
    key_cache.KeyCache.reset()
    torch.cuda.empty_cache()
    log = DeltaLog.for_table(path, device=dev)
    table = DeltaTable.for_path(path, device=dev)
    state = c2["state"]
    steps, states = [], {}

    def slab_entry():
        """The table's one resident key slab (the upserts' ss_item_sk lane)."""
        cache = key_cache.KeyCache.instance()
        with cache._lock:
            found = [e for k, e in cache._entries.items() if k[0] == log.log_path]
        check(len(found) <= 1, f"{len(found)} key slabs for one table")
        return found[0] if found else None

    def epochs():
        return (key_cache.KeyCache.instance().epoch(log.log_path),
                ColumnCache.instance().epoch(log.log_path))

    def merge(name, src, want_route, settings=None):
        return upsert(log, name, src, src["ss_item_sk"], state["ss_item_sk"], want_route,
                      settings)

    def record(name, wall_s, delta, detail):
        got = state_of(scan_to_table(log.update()))
        same_state(got, state, f"dml {name}")
        steps.append({"step": name, "wall_s": wall_s, "launches": delta, "version":
                      log.update().version, "rows": len(got["ss_item_sk"])})
        say(f"dml: {name} {wall_s:.3f} s wall, {detail}, launches {delta}; end state of "
            f"{len(got['ss_item_sk'])} rows x 8 columns equal to numpy | {card}")

    settings = {"delta.tpu.write.targetFileRows": MERGE_FILE_ROWS,
                "delta.tpu.stateCache.devicePlan.mode": "force"}
    with conf.set_temporarily(**settings):
        native.reset_launches()  # -- the DML phase's path starts here
        # step 0: a small upsert builds the key slab cold (K8)
        live = state["ss_item_sk"]
        r = np.random.RandomState(21)
        src = dml_source(21, DML_PRIME, live[r.choice(len(live), DML_PRIME // 2,
                                                      replace=False)], DML_FRESH["prime"])
        cmd, wall_s, delta, phases = merge("step 0 MERGE (prime)", src, "device-cold")
        state = reference_upsert(state, src)
        check(delta.get("slab_sort", 0) == 1, f"step 0: launches {delta}, one K8 expected")
        slab0 = slab_entry()
        check(slab0 is not None, "step 0: no resident key slab")
        record("step 0 MERGE (prime)", wall_s, delta, f"device-cold, phase_ms {phases}")
        pre = state
        v_pre = log.update().version
        files_before = data_files_on_disk(path)

        # step 1: DELETE on the deletion-vector path, candidates through K1
        # (``>= 96`` is ``> 95`` on an integer column, in the form the
        # resident planner lowers exactly)
        live_paths = {f.path for f in log.update().all_files}
        m, wall_s, delta = timed_step("step 1", lambda: table.delete("ss_quantity >= 96"))
        doomed = state["ss_quantity"] >= 96
        check(m["numDeletedRows"] == int(doomed.sum()),
              f"step 1: numDeletedRows {m['numDeletedRows']}, numpy {int(doomed.sum())}")
        check(delta.get("block_cull", 0) >= 1, f"step 1: launches {delta}: K1 not launched")
        acts = commit_actions(log, log.update().version)
        adds = [a for a in acts if isinstance(a, AddFile)]
        check(adds and all(a.deletion_vector is not None and a.path in live_paths for a in adds),
              "step 1: a touched file without a deletion vector, or a new data file")
        check(data_files_on_disk(path) - files_before <= {
            a.deletion_vector["pathOrInlineDv"] for a in adds
            if a.deletion_vector["storageType"] == "u"}, "step 1: a data file was written")
        check(m["numAddedFiles"] == len(adds) and m["numRemovedFiles"] == len(adds),
              f"step 1: metrics {m}")
        state = take_state(state, ~doomed)
        record("step 1 DELETE (DV)", wall_s, delta,
               f"{m['numDeletedRows']} rows, scanTimeMs {m['scanTimeMs']}, rewriteTimeMs "
               f"{m['rewriteTimeMs']}, {len(adds)} files re-added with a deletion vector")

        # step 2: UPDATE on the deletion-vector path, moving MERGE keys
        m, wall_s, delta = timed_step("step 2", lambda: table.update(
            {"ss_net_paid": "ss_net_paid + 1.0", "ss_item_sk": f"ss_item_sk + {DML_MOVE}"},
            "ss_store_sk < 25"))
        hit = state["ss_store_sk"] < 25
        check(m["numUpdatedRows"] == int(hit.sum()),
              f"step 2: numUpdatedRows {m['numUpdatedRows']}, numpy {int(hit.sum())}")
        state = {c: v.copy() for c, v in state.items()}
        state["ss_net_paid"][hit] += 1.0
        moved = state["ss_item_sk"][hit] + DML_MOVE
        state["ss_item_sk"][hit] = moved
        state = take_state(state, np.ones(len(hit), bool))
        v_step2 = log.update().version
        record("step 2 UPDATE (DV)", wall_s, delta,
               f"{m['numUpdatedRows']} rows, scanTimeMs {m['scanTimeMs']}, rewriteTimeMs "
               f"{m['rewriteTimeMs']}, {m['numAddedFiles']} files added")
        states["step2"] = state

        # step 3: MERGE through the resident slab, advanced over steps 1-2
        r = np.random.RandomState(23)
        unmoved = state["ss_item_sk"][state["ss_item_sk"] < DML_MOVE]
        n_moved = min(MERGE_SOURCE // 20, len(moved))
        picks = np.concatenate([r.choice(moved, n_moved, replace=False),
                                r.choice(unmoved, MERGE_SOURCE // 2 - n_moved, replace=False)])
        src = dml_source(23, MERGE_SOURCE, picks, DML_FRESH["step3"])
        cmd, wall_s, delta, phases = merge("step 3", src, "resident")
        # the advance over steps 1-2 is slab_advance on the slab step 0
        # built; step 2's appended keys leave its sorted view stale, so the
        # probe re-sorts it once (K8 over the device lanes, no key decode)
        check(delta.get("slab_advance", 0) >= 1 and delta.get("slab_sort", 0) <= 1,
              f"step 3: launches {delta}: slab_advance and at most the re-sort expected")
        check(slab_entry() is slab0 and slab0.version == log.update().version - 1,
              "step 3: the key slab was rebuilt, not advanced")
        state = reference_upsert(state, src)
        record("step 3 MERGE (resident)", wall_s, delta,
               f"{cmd.metrics['numTargetRowsUpdated']} updated ({n_moved} moved keys), "
               f"{cmd.metrics['numTargetRowsInserted']} inserted, phase_ms {phases}")

        # step 4: DELETE whose stats keep only the files that hold moved keys
        snap = log.update()
        holders = set()
        for f in snap.all_files:
            mx = (f.stats_dict() or {}).get("maxValues", {}).get("ss_item_sk")
            check(mx is not None, f"step 4: {f.path} has no max ss_item_sk")
            if mx >= DML_MOVE:
                holders.add(f.path)
        kept = {f.path for f in pruning.files_for_scan(
            snap, [parse_predicate(f"ss_item_sk >= {DML_MOVE}")]).files}
        check(kept == holders, f"step 4: files_for_scan kept {len(kept)} files, the stats "
              f"name {len(holders)} holders of moved keys")
        check(len(holders) < len(snap.all_files), "step 4: every file holds a moved key")
        m, wall_s, delta = timed_step("step 4", lambda: table.delete(
            f"ss_item_sk >= {DML_MOVE}"))
        doomed = state["ss_item_sk"] >= DML_MOVE
        check(m["numDeletedRows"] == int(doomed.sum()) and m["numRemovedFiles"] == len(holders),
              f"step 4: metrics {m}, numpy {int(doomed.sum())} rows in {len(holders)} files")
        check(delta.get("block_cull", 0) >= 1, f"step 4: launches {delta}: K1 not launched")
        state = take_state(state, ~doomed)
        record("step 4 DELETE (stats pruning)", wall_s, delta,
               f"{m['numDeletedRows']} rows in {len(holders)} of {len(snap.all_files)} files, "
               f"scanTimeMs {m['scanTimeMs']}, rewriteTimeMs {m['rewriteTimeMs']}")

        # step 5: UPDATE copy-on-write, then a MERGE that rebuilds the slab
        e0 = epochs()
        m, wall_s, delta = timed_step("step 5", lambda: table.update(
            {"ss_quantity": "ss_quantity * 2"}, "ss_customer_sk < 10000"),
            {"delta.tpu.deletionVectors.enabled": False})
        hit = state["ss_customer_sk"] < 10000
        check(m["numUpdatedRows"] == int(hit.sum()), f"step 5: metrics {m}")
        e1 = epochs()
        check(e1 == (e0[0] + 1, e0[1] + 1), f"step 5: epochs {e0} -> {e1}, both must move")
        v_step5 = log.update().version
        state = {c: v.copy() for c, v in state.items()}
        state["ss_quantity"][hit] *= 2
        record("step 5 UPDATE (copy-on-write)", wall_s, delta,
               f"{m['numUpdatedRows']} rows, {m['numRemovedFiles']} files rewritten into "
               f"{m['numAddedFiles']}, scanTimeMs {m['scanTimeMs']}, rewriteTimeMs "
               f"{m['rewriteTimeMs']}, epochs {e0} -> {e1}")
        r = np.random.RandomState(25)
        live = state["ss_item_sk"]
        src = dml_source(25, MERGE_SOURCE, live[r.choice(len(live), MERGE_SOURCE // 2,
                                                         replace=False)], DML_FRESH["step5"])
        cmd, wall_s, delta, phases = merge("step 5 MERGE", src, "device-cold")
        check(delta.get("slab_sort", 0) == 1, f"step 5 MERGE: launches {delta}: one K8")
        check(slab_entry() is not slab0, "step 5 MERGE: the stale slab survived the rewrite")
        state = reference_upsert(state, src)
        record("step 5 MERGE (cold rebuild)", wall_s, delta, f"phase_ms {phases}")

        # step 6: time travel while the resident entry sits at the latest version
        latest = log.update()
        pruning.files_for_scan(latest, [parse_predicate("ss_item_sk >= 0")])
        entry = state_cache.DeviceStateCache.instance().get(latest)
        check(entry is not None and entry.version == latest.version,
              "step 6: no resident entry at the latest version")
        commit_ts = int(os.stat(f"{log.log_path}/{filenames.delta_file(v_step2)}").st_mtime
                        * 1000)
        for label, kw, want in (("version", {"version": v_pre}, pre),
                                ("timestamp", {"timestamp": commit_ts}, states["step2"])):
            old = log.snapshot_for(**kw)
            verdict = state_cache.DeviceStateCache.instance()._lookup(
                (log.log_path, str(log.device)), old)[1]
            check(verdict == "older", f"step 6 {label}: verdict {verdict}, not older")
            got, wall_s, delta = timed_step(f"step 6 {label}", lambda: table.to_table(
                filters=["ss_item_sk >= 0"], **kw))
            same_state(state_of(got), want, f"dml step 6 {label}")
            check(entry.version == latest.version, f"step 6 {label}: the entry moved")
            say(f"dml: step 6 time travel by {label} {kw} to version {old.version}: "
                f"{wall_s:.3f} s wall, {got.num_rows} rows x 8 columns equal to numpy, the "
                f"resident entry left at version {entry.version}, launches {delta} | {card}")
            steps.append({"step": f"step 6 {label}", "wall_s": wall_s, "launches": delta,
                          "version": old.version, "rows": got.num_rows})

        # step 7: RESTORE to before step 1, then a MERGE of keys step 1 deleted
        cur, tgt = log.update(), log.get_snapshot_at(v_pre)
        cur_files = {f.path: f for f in cur.all_files}
        want_restored = sum(1 for p, f in ((f.path, f) for f in tgt.all_files)
                            if p not in cur_files
                            or cur_files[p].deletion_vector != f.deletion_vector)
        want_removed = len(set(cur_files) - {f.path for f in tgt.all_files})
        e0 = epochs()
        m, wall_s, delta = timed_step("step 7", lambda: table.restore_to_version(v_pre))
        check(m["numRestoredFiles"] == want_restored and m["numRemovedFiles"] == want_removed,
              f"step 7: metrics {m}, the snapshots imply {want_restored} restored and "
              f"{want_removed} removed")
        e1 = epochs()
        check(e1 == (e0[0] + 1, e0[1] + 1), f"step 7: epochs {e0} -> {e1}, both must move")
        state = pre
        record("step 7 RESTORE", wall_s, delta,
               f"to version {v_pre}: {m['numRestoredFiles']} restored, {m['numRemovedFiles']} "
               f"removed, epochs {e0} -> {e1}")
        r = np.random.RandomState(27)
        deleted = pre["ss_item_sk"][pre["ss_quantity"] >= 96]
        n_del = min(MERGE_SOURCE // 10, len(deleted))
        others = pre["ss_item_sk"][pre["ss_quantity"] < 96]
        picks = np.concatenate([r.choice(deleted, n_del, replace=False),
                                r.choice(others, MERGE_SOURCE // 2 - n_del, replace=False)])
        src = dml_source(27, MERGE_SOURCE, picks, DML_FRESH["step7"])
        cmd, wall_s, delta, phases = merge("step 7 MERGE", src, "device-cold")
        state = reference_upsert(state, src)
        record("step 7 MERGE (revived keys)", wall_s, delta,
               f"{cmd.metrics['numTargetRowsUpdated']} updated ({n_del} keys step 1 deleted), "
               f"phase_ms {phases}")

        # step 8: VACUUM with no retention
        snap = log.update()
        referenced = {urllib.parse.unquote(f.path) for f in snap.all_files}
        referenced |= {f.deletion_vector["pathOrInlineDv"] for f in snap.all_files
                       if f.deletion_vector and f.deletion_vector["storageType"] == "u"}
        expected = sorted(data_files_on_disk(path) - referenced)
        dry, wall_dry, _ = timed_step("step 8 dry run", lambda: table.vacuum(
            retention_hours=0, dry_run=True, retention_check_enabled=False))
        check(dry.deleted_paths == expected, f"step 8: the dry run lists {dry.files_deleted} "
              f"files, the walk finds {len(expected)} unreferenced")
        res, wall_s, delta = timed_step("step 8", lambda: table.vacuum(
            retention_hours=0, retention_check_enabled=False))
        check(res.deleted_paths == expected
              and not any(os.path.exists(os.path.join(path, p)) for p in expected),
              "step 8: VACUUM deleted other files than the dry run listed")
        record("step 8 VACUUM", wall_s, delta,
               f"{res.files_deleted} files deleted (dry run {wall_dry:.3f} s)")
        version = log.update().version
        try:
            table.restore_to_version(v_step5)
        except DeltaIllegalStateError:
            pass  # the refusal this step checks
        else:
            check(False, f"step 8: RESTORE to version {v_step5}, whose files are gone, ran")
        check(log.update().version == version, "step 8: the refused RESTORE committed")
        say(f"dml: step 8 RESTORE to version {v_step5} refused before any commit (its files "
            f"are gone); the log stays at version {version}")
        launches = dict(native.launches)  # -- the DML phase's path ends here
    say(f"dml: launches on the DML phase's path {launches} | {card}")
    say(json.dumps({"dml": steps}))
    return {"launches": launches, "steps": steps}


# -- phase 14: partitioned tables: bench config 6p, then a date-partitioned store_sales --

C6P_DAYS = 732  # bench.py:944-948
#: bench config 6p's 1M files cut to keep the smoke in its time limit
#: (PERF.md section 4); its 732 days and 256 queries stay
C6P_FILES = 500_000
#: the day a third tail adds: after every day of the table, so the dictionary
#: extends in order (the codes of the tail's own dictionary re-map into the
#: entry's) and day ranges keep lowering to code ranges
C6P_NEW_DAY = "2022-01-03"
#: store_sales(2_000_000): the bench's 10M rows cut to keep the smoke in its
#: time limit (PERF.md section 4); the 2,000 date partitions stay
PART_ROWS = 2_000_000
PART_COL = "ss_sold_date_sk"
PART_FRESH = {"m1": 40_000_000, "m2": 41_000_000, "m3": 42_000_000, "rw": 43_000_000}
PART_REPLACE = 50_000  # step 6's replaceWhere rows


def c6p_days():
    import datetime as dt

    day0 = dt.date(2020, 1, 1)
    return [(day0 + dt.timedelta(days=d)).isoformat() for d in range(C6P_DAYS)]


def c6p_expected(q, files):
    """Numpy's verdict of ``q`` over ``files`` (stats lanes and day index a
    file, a missing stat keeps): the indices of the files a plan must keep."""
    import re

    keep = np.ones(len(files["path"]), bool)
    with np.errstate(invalid="ignore"):
        for conj in q.split(" AND "):
            m = re.fullmatch(r"(\w+) (>=|<=|=) (.+)", conj.strip())
            col, op, lit = m.groups()
            if col == "day":
                v = files["days"].index(lit.strip("'")) if lit.strip("'") in files["days"] \
                    else -1
                d = files["day"]
                keep &= {"=": d == v, ">=": d >= v, "<=": (d <= v) & (d >= 0)}[op] & (d >= 0)
                continue
            x = float(lit) if col in ("c1", "c3") else int(lit)
            lo, hi = files[col + "_min"], files[col + "_max"]
            if op == ">=":
                keep &= ~(hi < x)
            elif op == "<=":
                keep &= ~(lo > x)
            else:
                keep &= ~(hi < x) & ~(lo > x)
    return np.flatnonzero(keep)


def c6p_tail(store, log_path, version, day, files, name):
    """One file in ``day`` (bench.py:1054-1069: stats on c0 only)."""
    st = json.dumps({"numRecords": 1, "minValues": {"c0": 1}, "maxValues": {"c0": 2},
                     "nullCount": {c: 0 for c in ("c0", "c1", "c2", "c3")}})
    add = AddFile(path=name, size=1 << 20, modification_time=version, data_change=True,
                  partition_values={"day": day}, stats=st)
    store.write(f"{log_path}/{filenames.delta_file(version)}", [add.json()])
    if day not in files["days"]:
        files["days"].append(day)
    files["path"].append(name)
    files["day"] = np.append(files["day"], files["days"].index(day))
    for c in ("c0", "c1", "c2", "c3"):
        lo, hi = (1, 2) if c == "c0" else (np.nan, np.nan)
        files[c + "_min"] = np.append(files[c + "_min"], lo)
        files[c + "_max"] = np.append(files[c + "_max"], hi)


def run_c6p(dev, workdir, card):
    """Phase 14a: bench config 6p on the card: the C6P_FILES-file checkpoint with a
    ``day`` partition column, the resident entry with its dictionary-coded
    day lane, 256 plans under ``devicePlan.mode=force`` equal to the host's
    float64 evaluation and to numpy, then three one-file tails applied to
    the same entry (the third one with a new day)."""
    path = os.path.join(workdir, "config6p")
    t0 = time.perf_counter()
    store, queries, write_s, shape = write_config6_table(path, partitioned=True,
                                                         n_files=C6P_FILES)
    log_path = os.path.join(path, "_delta_log")
    parts = config6_checkpoint(store, log_path)
    say(f"6p: wrote {C6P_FILES} files in {C6P_DAYS} days as the checkpoint at version 0 "
        f"({len(parts)} parts, {sum(os.path.getsize(p) for p in parts) / 1e6:.1f} MB) in "
        f"{write_s:.3f} s (the table in {time.perf_counter() - t0:.3f} s)")
    base, width = shape["base"], shape["width"]
    files = {"path": [f"part-{i:07d}.parquet" for i in range(C6P_FILES)],
             "days": list(shape["days"]),
             "day": (np.arange(C6P_FILES) * C6P_DAYS // C6P_FILES).astype(np.int64)}
    for c in ("c0", "c1", "c2", "c3"):
        files[c + "_min"] = base[c].astype(np.float64) if c in ("c1", "c3") else base[c]
        files[c + "_max"] = (base[c] + width[c]) if c in ("c1", "c3") else base[c] + int(width[c])

    native.reset_launches()  # -- 6p's path starts here
    DeltaLog.clear_cache()
    state_cache.DeviceStateCache.reset()
    log = DeltaLog.for_table(path, device=dev)
    t0 = time.perf_counter()
    snap = log.update()
    check(snap.num_of_files == C6P_FILES, f"6p: snapshot has {snap.num_of_files} files")
    decode_s = time.perf_counter() - t0
    cols = snap._columnar
    check(snap.segment.checkpoint_version == 0 and cols.stats_parsed is not None,
          "6p: the snapshot did not decode the checkpoint's typed stats")
    from delta_tpu_torch.exec.parquet import read_metadata

    names = {el.name for el in read_metadata(parts[0]).schema}
    check("partitionValues_parsed" in names and "stats_parsed" in names,
          "6p: the checkpoint lacks partitionValues_parsed or stats_parsed")
    t0 = time.perf_counter()
    entry = state_cache.DeviceStateCache.instance().get(snap)
    check(entry is not None and "day" in entry.part_info, "6p: no resident entry with a day lane")
    entry.ensure_resident()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    lane = entry.part_info["day"]
    check(lane.values == files["days"] and lane.sorted, "6p: the day dictionary is not the days "
          "in order")
    say(f"6p: decode {decode_s:.3f} s, resident build {build_s:.3f} s (capacity "
        f"{entry.capacity}, lanes {entry.columns}) | {card}")

    index = {p: i for i, p in enumerate(files["path"])}
    row_file = np.array([index[p] for p in entry.paths], np.int64)  # entry row -> file

    def plan_all(label, qs):
        nonlocal row_file
        if len(row_file) < len(entry.paths):  # the tails' rows
            row_file = np.append(row_file, [files["path"].index(p)
                                            for p in entry.paths[len(row_file):]])
        snap = log.update()
        ranges = [lower(entry, snap, q) for q in qs]
        ms, host = check_batch(entry, ranges, label)
        for q, h in zip(qs, host):
            check(np.array_equal(np.sort(row_file[h.rows]), c6p_expected(q, files)),
                  f"{label}: the plan of {q} differs from numpy")
        return ms, sum(h.count for h in host)

    plan_ms = []
    for _ in range(3):
        ms, kept = plan_all("6p batch", queries)
        plan_ms.append(round(ms, 3))
    say(f"6p: batched plan of {N_QUERIES} queries (128 on day): {plan_ms} ms, {kept} files kept, "
        f"equal to the host plan and to numpy | {card}")
    tails = []
    extra = [f"day = '{C6P_NEW_DAY}'", f"day >= '{files['days'][-2]}'"]
    for v, (day, name) in enumerate(((files["days"][-1], "part-new.parquet"),
                                     (files["days"][-1], "part-new2.parquet"),
                                     (C6P_NEW_DAY, "part-new3.parquet")), start=1):
        c6p_tail(store, log_path, v, day, files, name)
        snap = log.update()
        t0 = time.perf_counter()
        e = state_cache.DeviceStateCache.instance().get(snap)
        torch.cuda.synchronize()
        tail_ms = (time.perf_counter() - t0) * 1e3
        check(e is entry and e.version == v, f"6p tail {v}: not applied to the same entry")
        check(entry.part_info["day"].values == files["days"] and entry.part_info["day"].sorted,
              f"6p tail {v}: the day dictionary")
        # the day lane on the card holds the new file's code (no stale upload)
        row = entry.path_to_row[name]
        code = float(files["days"].index(day))
        lanes = entry._dev
        d_col = entry.columns.index("day")
        got = (float(lanes["mins"][d_col, row]), float(lanes["maxs"][d_col, row]))
        check(got == (code, code), f"6p tail {v}: the card's day lane {got}, not {code}")
        ms, kept = plan_all(f"6p tail {v}", queries + (extra if day == C6P_NEW_DAY else []))
        tails.append({"version": v, "tail_ms": round(tail_ms, 3), "plan_ms": round(ms, 3),
                      "kept": kept})
    launches = {k: v for k, v in native.launches.items() if v}  # -- 6p's path ends here
    say(f"6p: three tails applied to the same entry (the third adds day {C6P_NEW_DAY}: "
        f"dictionary {len(entry.part_info['day'].values)} days): {tails}; launches {launches} "
        f"| {card}")
    # one K1 launch a batch (3, then one after each tail), one tail apply a tail
    check(launches.get("block_cull", 0) == 6 and launches.get("tail_apply", 0) == 3,
          f"6p: launches {launches}")
    entry.drop_device()
    return {"launches": launches, "decode_s": decode_s, "build_s": build_s,
            "plan_ms": plan_ms, "tails": tails}


def part_sources(state, n, seed, fresh_base):
    """A 1M-row upsert: half live keys of ``state``, half fresh from
    ``fresh_base``; payload (its date spreads over the partitions) from
    RandomState(seed)."""
    r = np.random.RandomState(seed)
    live = state["ss_item_sk"]
    return dml_source(seed, n, live[r.choice(len(live), n // 2, replace=False)], fresh_base)


def run_partitioned(dev, workdir, card):
    """Phase 14b: store_sales(PART_ROWS) partitioned by ss_sold_date_sk
    (2,000 partitions) through the port's writer, deletion vectors on, then
    reads, MERGEs, DELETEs, an UPDATE that moves rows across partitions, a
    replaceWhere overwrite, OPTIMIZE ZORDER BY inside the chosen partitions
    and VACUUM; the end state after steps 5 and 8 (each read checks the
    steps since the last: the smoke's limit) equal to numpy on all 8
    columns."""
    import urllib.parse

    from delta_tpu_torch import DeltaTable
    from delta_tpu_torch.commands.alter import set_table_properties
    from delta_tpu_torch.commands.optimize import OptimizeCommand
    from delta_tpu_torch.obs.scan_report import last_scan_report
    from delta_tpu_torch.ops.column_cache import ColumnCache
    from delta_tpu_torch.utils import telemetry

    key_cache.KeyCache.reset()
    ColumnCache.reset()
    torch.cuda.empty_cache()
    path = os.path.join(workdir, "store_sales_by_date")
    target = store_sales(PART_ROWS, np.random.RandomState(7))
    state = by_key({c: target[c] for c in STORE_SALES})
    captured = {}
    real_masks = column_cache.residual_masks

    def state_check(name):
        same_state(state_of(scan_to_table(log.update())), state, f"partitioned {name}")
        return "; end state of %d rows x 8 columns equal to numpy" % len(state["ss_item_sk"])

    record, steps = _phase_steps(card, "partitioned", state_check)

    def merge(name, src, want_route):
        return upsert(log, name, src, src["ss_item_sk"], state["ss_item_sk"], want_route)

    def part_dirs():
        return {d for d in os.listdir(path) if d.startswith(PART_COL + "=")}

    # the table grows to about 15,000 live files: their parsed footers stay
    # cached across the steps (exec/rowgroups.FooterCache, ~10 KB a footer)
    settings = {"delta.tpu.stateCache.devicePlan.mode": "force",
                "delta.tpu.read.deviceResidual.mode": "force",
                "delta.tpu.read.footerCacheEntries": 32_768}
    with conf.set_temporarily(**settings):
        native.reset_launches()  # -- the partitioned phase's path starts here
        # step 0: the partitioned write, then deletion vectors on
        log = DeltaLog.for_table(path, device=dev)
        _, wall_s, delta = timed_step("step 0", lambda: WriteIntoDelta(
            log, "append", target, partition_columns=[PART_COL]).run())
        set_table_properties(log, {"delta.tpu.enableDeletionVectors": "true"})
        table = DeltaTable.for_path(path, device=dev)
        snap = log.update()
        n_parts = len(np.unique(target[PART_COL]))
        check(len(snap.all_files) == n_parts == len(part_dirs()),
              f"step 0: {len(snap.all_files)} files, {n_parts} dates, {len(part_dirs())} dirs")
        check(all(urllib.parse.unquote(f.path).startswith(
            f"{PART_COL}={f.partition_values[PART_COL]}/") for f in snap.all_files),
            "step 0: a file outside its partition directory")
        nbytes = sum(f.size for f in snap.all_files)
        record("step 0 partitioned write", wall_s, delta,
               f"{len(snap.all_files)} files in {n_parts} partitions, {nbytes / 1e6:.1f} MB",
               check_state=False)

        # step 1: two reads with the device residual
        def capturing(program, envs, ns, scalars):
            captured.setdefault("args", (program, envs, ns, scalars))
            return real_masks(program, envs, ns, scalars)

        for label, pred, want in (
                ("a", f"{PART_COL} BETWEEN 2450100 AND 2450199 AND ss_quantity > 90",
                 (state[PART_COL] >= 2450100) & (state[PART_COL] <= 2450199)
                 & (state["ss_quantity"] > 90)),
                ("b", f"{PART_COL} = 2450500 OR ss_quantity >= 99",
                 (state[PART_COL] == 2450500) | (state["ss_quantity"] >= 99))):
            column_cache.residual_masks = capturing if label == "b" else real_masks
            try:
                got, wall_s, delta = timed_step(f"step 1{label}",
                                                lambda: table.to_table(filters=[pred]))
            finally:
                column_cache.residual_masks = real_masks
            rep = last_scan_report()
            same_state(state_of(got), take_state(state, want), f"partitioned step 1{label}")
            check(rep.device_residual == "device" and delta.get("residual_mask", 0) >= 1,
                  f"step 1{label}: K14 did not run ({rep.device_residual}, {delta})")
            record(f"step 1{label} read", wall_s, delta,
                   f"{pred}: {got.num_rows} rows from {rep.files_scanned} of {rep.files_total} "
                   f"files, phase_ms {rep.phase_ms}", check_state=False)
        check("args" in captured and captured["args"][0].scalar_slots,
              "step 1b: K14 ran without the partition scalar")

        # step 2: a 1M-row upsert (cold slab), then a resident MERGE
        src = part_sources(state, MERGE_SOURCE, 31, PART_FRESH["m1"])
        cmd, wall_s, delta, phases = merge("step 2 MERGE (cold)", src, "device-cold")
        state = reference_upsert(state, src)
        record("step 2 MERGE (cold)", wall_s, delta, f"phase_ms {phases}", check_state=False)
        src = part_sources(state, MERGE_SOURCE, 32, PART_FRESH["m2"])
        cmd, wall_s, delta, phases = merge("step 2 MERGE (resident)", src, "resident")
        state = reference_upsert(state, src)
        record("step 2 MERGE (resident)", wall_s, delta, f"phase_ms {phases}",
               check_state=False)

        # step 3: a partition-only DELETE: metadata only
        emptied = {f"{PART_COL}={d}" for d in np.unique(state[PART_COL][state[PART_COL] < 2450050])}
        r0 = telemetry.counters("scan.files").get("scan.files.read", 0)
        m, wall_s, delta = timed_step("step 3", lambda: table.delete(f"{PART_COL} < 2450050"))
        check(telemetry.counters("scan.files").get("scan.files.read", 0) == r0,
              "step 3: the metadata-only DELETE read a data file")
        check(m["numDeletedRows"] == -1 and m["numAddedFiles"] == 0 and m["numRemovedFiles"] > 0,
              f"step 3: metrics {m}")
        state = take_state(state, state[PART_COL] >= 2450050)
        # its end state is read after step 5, with that step's (the smoke's limit)
        record("step 3 DELETE (partitions)", wall_s, delta,
               f"{m['numRemovedFiles']} files of {len(emptied)} partitions removed, no file read",
               check_state=False)

        # step 4: a DV DELETE through K1, then a resident MERGE (K11's advance)
        m, wall_s, delta = timed_step("step 4", lambda: table.delete("ss_quantity >= 96"))
        doomed = state["ss_quantity"] >= 96
        check(m["numDeletedRows"] == int(doomed.sum()), f"step 4: metrics {m}")
        check(delta.get("block_cull", 0) >= 1, f"step 4: launches {delta}: K1 not launched")
        state = take_state(state, ~doomed)
        record("step 4 DELETE (DV)", wall_s, delta,
               f"{m['numDeletedRows']} rows, scanTimeMs {m['scanTimeMs']}, rewriteTimeMs "
               f"{m['rewriteTimeMs']}", check_state=False)
        # a 100,000-row upsert into 100 partitions: the advance is its point,
        # and the table gains 100 files, not 2,000 (each later read pays a
        # file); it keeps step 3's partitions empty for step 8
        src = part_sources(state, MERGE_SOURCE // 10, 34, PART_FRESH["m3"])
        src[PART_COL] = 2451000 + src[PART_COL] % 100
        cmd, wall_s, delta, phases = merge("step 4 MERGE (resident)", src, "resident")
        check(delta.get("slab_advance", 0) + delta.get("slab_widen", 0) >= 1,
              f"step 4 MERGE: launches {delta}: no K11 advance")
        state = reference_upsert(state, src)
        record("step 4 MERGE (resident)", wall_s, delta, f"phase_ms {phases}",
               check_state=False)

        # step 5: an UPDATE of the partition column: rows move across partitions
        m, wall_s, delta = timed_step("step 5", lambda: table.update(
            {PART_COL: f"{PART_COL} + 1"}, "ss_store_sk < 5"))
        hit = state["ss_store_sk"] < 5
        check(m["numUpdatedRows"] == int(hit.sum()), f"step 5: metrics {m}")
        state = {c: v.copy() for c, v in state.items()}
        state[PART_COL][hit] += 1
        check(f"{PART_COL}=2452000" in part_dirs(), "step 5: no row moved past the last date")
        record("step 5 UPDATE (partition column)", wall_s, delta,
               f"{m['numUpdatedRows']} rows moved, scanTimeMs {m['scanTimeMs']}, rewriteTimeMs "
               f"{m['rewriteTimeMs']}")

        # step 6: an overwrite with replaceWhere on the last dates
        new = store_sales(PART_REPLACE, np.random.RandomState(36))
        new["ss_item_sk"] = np.arange(PART_FRESH["rw"], PART_FRESH["rw"] + PART_REPLACE,
                                      dtype=np.int64)
        new[PART_COL] = np.random.RandomState(37).randint(2451990, 2452000, PART_REPLACE)
        _, wall_s, delta = timed_step("step 6", lambda: WriteIntoDelta(
            log, "overwrite", new, replace_where=f"{PART_COL} >= 2451990").run())
        keep = state[PART_COL] < 2451990
        state = take_state({c: np.concatenate([state[c][keep], new[c]]) for c in STORE_SALES},
                           np.ones(int(keep.sum()) + PART_REPLACE, bool))
        # its end state is read after step 8, with that step's (the smoke's limit)
        record("step 6 overwrite (replaceWhere)", wall_s, delta,
               f"{PART_REPLACE} rows replace {int((~keep).sum())}", check_state=False)

        # step 7: OPTIMIZE ZORDER BY inside the chosen partitions, a point read
        # before and after
        pick = np.flatnonzero(state[PART_COL] == 2451950)[0]
        point = (f"{PART_COL} = 2451950 AND ss_customer_sk = {state['ss_customer_sk'][pick]} "
                 f"AND ss_item_sk = {state['ss_item_sk'][pick]}")
        point_want = take_state(state, (state[PART_COL] == 2451950)
                                & (state["ss_customer_sk"] == state["ss_customer_sk"][pick])
                                & (state["ss_item_sk"] == state["ss_item_sk"][pick]))
        reads = []
        for when in ("before", "after"):
            if when == "after":
                n_before = len(log.update().all_files)
                cmd = OptimizeCommand(log, f"{PART_COL} >= 2451900",
                                      z_order_by=["ss_customer_sk", "ss_item_sk"])
                _, wall_s, delta = timed_step("step 7", cmd.run)
                check(delta.get("morton", 0) >= 1, f"step 7: launches {delta}: K16 not launched")
                n_after = len(log.update().all_files)
                record("step 7 OPTIMIZE ZORDER BY", wall_s, delta,
                       f"{cmd.metrics['numRemovedFiles']} files into "
                       f"{cmd.metrics['numAddedFiles']} ({n_before} -> {n_after} live), "
                       f"phase_ms {({k: round(v, 3) for k, v in cmd.phase_ms.items()})}",
                       check_state=False)
            got, p_wall, p_delta = timed_step(f"step 7 read {when}",
                                              lambda: table.to_table(filters=[point]))
            same_state(state_of(got), point_want, f"partitioned step 7 read {when}")
            reads.append((when, round(p_wall, 4), last_scan_report().files_scanned))
        say(f"partitioned: step 7 point read (wall s, files scanned) {reads} | {card}")
        steps.append({"step": "step 7 point read", "reads": reads})

        # step 8: VACUUM with no retention: step 3's partitions are gone
        check(emptied <= part_dirs(), "step 8: step 3's directories vanished before VACUUM")
        res, wall_s, delta = timed_step("step 8", lambda: table.vacuum(
            retention_hours=0, retention_check_enabled=False))
        live_dirs = {os.path.dirname(urllib.parse.unquote(f.path)) for f in log.update().all_files}
        check(not emptied & part_dirs() and part_dirs() == live_dirs,
              "step 8: VACUUM left a partition directory that holds no live file")
        record("step 8 VACUUM", wall_s, delta,
               f"{res.files_deleted} files, {res.dirs_deleted} directories deleted")
        launches = dict(native.launches)  # -- the partitioned phase's path ends here
    say(f"partitioned: launches on the partitioned phase's path {launches} | {card}")
    for k in ("block_cull", "slab_sort", "slab_probe", "pair_compact", "residual_mask", "morton"):
        check(launches.get(k, 0) > 0, f"kernel {k} was not launched on the partitioned path")
    check(launches.get("slab_advance", 0) + launches.get("slab_widen", 0) > 0,
          "K11 was not launched on the partitioned path")
    # K14 with the partition value bound per file, against its plain version
    program, envs, ns, scalars = captured["args"]
    got, offs = column_cache.residual_masks(program, envs, ns, scalars)
    ref, ref_offs = column_cache.residual_masks_plain(program, envs, ns, scalars)
    torch.cuda.synchronize()
    check(offs == ref_offs and torch.equal(got.cpu(), ref.cpu()),
          "K14 with partition scalars differs from its plain version")
    say(f"partitioned: K14 over step 1b's first launch ({len(envs)} files, "
        f"{len(program.scalar_slots)} scalar) equal to its plain version")
    say(json.dumps({"partitioned": steps}))
    return {"launches": launches, "steps": steps}


# -- phase 15: DECIMAL and nested data columns on the card's table path -----------------

#: store_sales in TPC-DS's own column types: the money columns decimal(7,2)
DEC_TYPE = "decimal128(7, 2)"
DEC_MONEY = ("ss_sales_price", "ss_ext_discount_amt", "ss_net_paid")
#: 15a's rows: the bench's 10M cut to keep the smoke in its time limit
#: (PERF.md section 4: 4M, phase 14b's cut, took the run to 1,111 s; 1M
#: with the page codec on every read and write, to 1,267 s; 600,000 since:
#: its MERGE draws 500,000 live keys)
DEC_ROWS = 600_000
#: 15a's files (the writer's targetFileRows): 16 files, so the plan (K1)
#: and the residual (K14) have a table to cull
DEC_FILE_ROWS = 37_500
DEC_FRESH = {"m1": 50_000_000, "m2": 51_000_000}
#: 15b: a nested table's rows (1M cut as 15a's), its MERGE's source rows
#: and its files' rows (10 files)
NESTED_ROWS, NESTED_SOURCE, NESTED_FILE_ROWS = 100_000, 100_000, 10_000


def typed_store_sales(n, rng):
    """``store_sales``' draws (bench.py:168), the money columns as the
    unscaled values of decimal(7,2): floor(rand * 10000), floor(rand *
    1000) and floor(rand * 9000)."""
    cols = {
        "ss_item_sk": rng.permutation(n * 2)[:n].astype(np.int64),
        "ss_customer_sk": rng.randint(0, 1_000_000, n).astype(np.int64),
        "ss_sold_date_sk": rng.randint(2450000, 2452000, n).astype(np.int64),
        "ss_store_sk": rng.randint(0, 500, n).astype(np.int64),
        "ss_quantity": rng.randint(1, 100, n).astype(np.int64),
    }
    for c, top in zip(DEC_MONEY, (10000, 1000, 9000)):
        cols[c] = np.floor(rng.rand(n) * top).astype(np.int64)
    return cols


def decimal_table(cols):
    """numpy columns as the port's table: the money columns decimal(7,2)
    (their values unscaled), the rest int64."""
    n = len(cols["ss_item_sk"])
    ones = np.ones(n, bool)
    return HostTable({c: HostColumn("decimal", cols[c], ones, DEC_TYPE) if c in DEC_MONEY
                      else HostColumn("int", cols[c], ones) for c in STORE_SALES}, n)


def typed_source(state, n, seed, fresh_base):
    """An upsert of ``n`` rows: half live keys of ``state``, half fresh from
    ``fresh_base``; payload from RandomState(seed)."""
    r = np.random.RandomState(seed)
    live = state["ss_item_sk"]
    picks = live[r.choice(len(live), n // 2, replace=False)]
    fresh = np.arange(fresh_base, fresh_base + n - len(picks), dtype=np.int64)
    keys = np.concatenate([picks, fresh])
    r.shuffle(keys)
    return dict(typed_store_sales(n, r), ss_item_sk=keys)


def _phase_steps(card, label, state_check):
    """A phase's step recorder and its list of steps: ``record`` checks the
    end state through ``state_check(name)`` (which returns what to print)
    unless ``check_state=False``."""
    steps = []

    def record(name, wall_s, delta, detail, check_state=True):
        what = state_check(name) if check_state else ""
        steps.append({"step": name, "wall_s": round(wall_s, 3), "launches": delta,
                      "detail": detail})
        say(f"{label}: {name} {wall_s:.3f} s wall, {detail}, launches {delta}{what} | {card}")

    return record, steps


def run_decimal(dev, workdir, card):
    """Phase 15a: store_sales(DEC_ROWS) with its money columns decimal(7,2),
    deletion vectors on: the write, a plan (K1), a read with the residual on
    the card (K14) that returns the decimal columns, a read whose residual
    names a decimal (the host: ``scan.device.fallback``), a cold 1M-row
    MERGE (K8-K10), a DV UPDATE of a decimal by decimal arithmetic (K15), a
    DV DELETE (K1), a resident MERGE (K11), OPTIMIZE ZORDER BY (K16), a
    checkpoint with ``writeStatsAsStruct`` read back, and a read of version
    1; each end state equal to numpy's over the unscaled integers."""
    from delta_tpu_torch import DeltaTable
    from delta_tpu_torch.commands.alter import set_table_properties
    from delta_tpu_torch.commands.optimize import OptimizeCommand
    from delta_tpu_torch.exec.parquet import read_nested
    from delta_tpu_torch.obs.scan_report import last_scan_report
    from delta_tpu_torch.ops import pruning
    from delta_tpu_torch.ops.column_cache import ColumnCache
    from delta_tpu_torch.utils import telemetry

    key_cache.KeyCache.reset()
    ColumnCache.reset()
    torch.cuda.empty_cache()
    path = os.path.join(workdir, "store_sales_decimal")
    target = typed_store_sales(DEC_ROWS, np.random.RandomState(7))
    state = by_key({c: target[c] for c in STORE_SALES})
    original = state
    box = {}

    def state_check(name):
        t = scan_to_table(box["log"].update())
        check(all(t.column(c).type == DEC_TYPE for c in DEC_MONEY),
              f"decimal {name}: a money column read as {[t.column(c).type for c in DEC_MONEY]}")
        same_state(state_of(t), box["state"], f"decimal {name}")
        return "; end state of %d rows x 8 columns equal to numpy" % len(box["state"]["ss_item_sk"])

    record, steps = _phase_steps(card, "decimal", state_check)

    def merge(name, src, want_route):
        _, wall_s, delta, phases = upsert(log, name, decimal_table(src), src["ss_item_sk"],
                                          box["state"]["ss_item_sk"], want_route)
        return wall_s, delta, phases

    settings = {"delta.tpu.stateCache.devicePlan.mode": "force",
                "delta.tpu.read.deviceResidual.mode": "force",
                "delta.tpu.write.targetFileRows": DEC_FILE_ROWS}
    with conf.set_temporarily(**settings):
        native.reset_launches()  # -- the decimal phase's path starts here
        # step 1: the write (version 0), then deletion vectors on (version 1)
        log = box["log"] = DeltaLog.for_table(path, device=dev)
        box["state"] = state
        _, wall_s, delta = timed_step("step 1", lambda: WriteIntoDelta(
            log, "append", decimal_table(target)).run())
        set_table_properties(log, {"delta.tpu.enableDeletionVectors": "true"})
        table = DeltaTable.for_path(path, device=dev)
        snap = log.update()
        schema = {f.name: f.data_type.simple_string() for f in snap.metadata.schema.fields}
        check(all(schema[c] == "decimal(7,2)" for c in DEC_MONEY), f"step 1: schema {schema}")
        st = json.loads(snap.all_files[0].stats)
        check(all(c not in st["minValues"] and st["nullCount"][c] == 0 for c in DEC_MONEY),
              f"step 1: decimal stats {st}")
        record("step 1 write", wall_s, delta,
               f"{len(snap.all_files)} files, {sum(f.size for f in snap.all_files) / 1e6:.1f} MB; "
               "schema decimal(7,2) x3, stats nullCount only for them")

        # step 2: a plan on the date (K1)
        pred = "ss_sold_date_sk >= 2451900"
        plan, wall_s, delta = timed_step(
            "step 2", lambda: pruning.files_for_scan(log.update(), [parse_predicate(pred)]))
        check(delta.get("block_cull", 0) >= 1, f"step 2: launches {delta}: K1 not launched")
        check(len(plan.files) == len(snap.all_files), "step 2: a file pruned that holds the dates")
        record("step 2 files_for_scan", wall_s, delta, f"{pred}: {len(plan.files)} files kept",
               check_state=False)

        # step 3: the residual on the card over an integer, the decimals returned
        pred = "ss_quantity > 50"
        got, wall_s, delta = timed_step("step 3", lambda: table.to_table(filters=[pred]))
        rep = last_scan_report()
        same_state(state_of(got), take_state(state, state["ss_quantity"] > 50), "decimal step 3")
        check(rep.device_residual == "device" and delta.get("residual_mask", 0) >= 1,
              f"step 3: K14 did not run ({rep.device_residual}, {delta})")
        record("step 3 read (K14)", wall_s, delta,
               f"{pred}: {got.num_rows} rows with the decimal columns, phase_ms {rep.phase_ms}",
               check_state=False)

        # step 4: a residual on a decimal: the host, as in the JAX package
        pred = "ss_net_paid > 45.00"
        fb0 = telemetry.counters("scan.device").get("scan.device.fallback", 0)
        got, wall_s, delta = timed_step("step 4", lambda: table.to_table(filters=[pred]))
        fb = telemetry.counters("scan.device").get("scan.device.fallback", 0) - fb0
        same_state(state_of(got), take_state(state, state["ss_net_paid"] > 4500), "decimal step 4")
        check(fb >= 1 and delta.get("residual_mask", 0) == 0,
              f"step 4: the decimal residual did not stay on the host ({fb}, {delta})")
        record("step 4 read (host)", wall_s, delta,
               f"{pred}: {got.num_rows} rows, scan.device.fallback +{fb}", check_state=False)

        # step 5: a cold 1M-row upsert setting the decimal columns
        src = typed_source(state, MERGE_SOURCE, 41, DEC_FRESH["m1"])
        wall_s, delta, phases = merge("step 5 MERGE (cold)", src, "device-cold")
        state = box["state"] = reference_upsert(state, src)
        record("step 5 MERGE (cold)", wall_s, delta, f"phase_ms {phases}")

        # step 6: a DV UPDATE of a decimal by decimal arithmetic: decimal(7,2)
        # times int64 is decimal(27,2), cast back into decimal(7,2) (no value
        # here passes 7 digits: 9999 x 99); its candidate files are planned by
        # the skipping rewrite on the card (K15): the normal leg's threshold
        # (4,096 files) set to 1 for the table's few files
        m, wall_s, delta = timed_step("step 6", lambda: table.update(
            {"ss_net_paid": "ss_sales_price * ss_quantity"}, "ss_store_sk < 50"),
            {"delta.tpu.device.pruning.minFiles": 1})
        check(delta.get("expr_eval", 0) >= 1, f"step 6: launches {delta}: K15 not launched")
        hit = state["ss_store_sk"] < 50
        check(m["numUpdatedRows"] == int(hit.sum()), f"step 6: metrics {m}")
        state = {c: v.copy() for c, v in state.items()}
        state["ss_net_paid"][hit] = state["ss_sales_price"][hit] * state["ss_quantity"][hit]
        box["state"] = state
        record("step 6 UPDATE (decimal arithmetic)", wall_s, delta,
               f"{m['numUpdatedRows']} rows, scanTimeMs {m['scanTimeMs']}, rewriteTimeMs "
               f"{m['rewriteTimeMs']}")

        # step 7: a DV DELETE (K1)
        m, wall_s, delta = timed_step("step 7", lambda: table.delete("ss_quantity >= 96"))
        doomed = state["ss_quantity"] >= 96
        check(m["numDeletedRows"] == int(doomed.sum()), f"step 7: metrics {m}")
        check(delta.get("block_cull", 0) >= 1, f"step 7: launches {delta}: K1 not launched")
        state = box["state"] = take_state(state, ~doomed)
        record("step 7 DELETE (DV)", wall_s, delta,
               f"{m['numDeletedRows']} rows, scanTimeMs {m['scanTimeMs']}")

        # step 8: a resident MERGE (K11's advance over steps 6-7)
        src = typed_source(state, MERGE_SOURCE // 10, 42, DEC_FRESH["m2"])
        wall_s, delta, phases = merge("step 8 MERGE (resident)", src, "resident")
        check(delta.get("slab_advance", 0) + delta.get("slab_widen", 0) >= 1,
              f"step 8: launches {delta}: no K11 advance")
        state = box["state"] = reference_upsert(state, src)
        record("step 8 MERGE (resident)", wall_s, delta, f"phase_ms {phases}")

        # step 9: OPTIMIZE ZORDER BY (K16 and its sorts)
        cmd = OptimizeCommand(log, None, z_order_by=["ss_item_sk", "ss_store_sk"])
        _, wall_s, delta = timed_step("step 9", cmd.run)
        check(delta.get("morton", 0) >= 1, f"step 9: launches {delta}: K16 not launched")
        record("step 9 OPTIMIZE ZORDER BY", wall_s, delta,
               f"{cmd.metrics['numRemovedFiles']} files into {cmd.metrics['numAddedFiles']}, "
               f"phase_ms {({k: round(v, 3) for k, v in cmd.phase_ms.items()})}")

        # step 10: a checkpoint with struct stats, read back by a fresh log
        def checkpoint():
            set_table_properties(log, {"delta.checkpoint.writeStatsAsStruct": "true"})
            return log.checkpoint()

        md, wall_s, delta = timed_step("step 10", checkpoint)
        files = {(f.path, f.size) for f in log.update().all_files}
        DeltaLog.clear_cache()
        log = box["log"] = DeltaLog.for_table(path, device=dev)
        check({(f.path, f.size) for f in log.update().all_files} == files,
              "step 10: the checkpoint's snapshot differs")
        cp = os.path.join(path, "_delta_log", filenames.checkpoint_file_single(md.version))
        _, cols = read_nested(open(cp, "rb").read(), ["add"])
        sp = cols["add"].field("stats_parsed")
        leaf = sp.field("minValues").field("ss_net_paid")
        check(leaf.stype == DEC_TYPE and not leaf.valid.any()
              and not sp.field("nullCount").field("ss_net_paid").values.any(),
              "step 10: stats_parsed's decimal leaf")
        record("step 10 checkpoint (writeStatsAsStruct)", wall_s, delta,
               f"version {md.version}, {md.size} actions; stats_parsed decimal(7,2) leaves, "
               "read back by a fresh log")
        table = DeltaTable.for_path(path, device=dev)

        # step 11: time travel to version 1 (the write, deletion vectors on)
        got, wall_s, delta = timed_step("step 11", lambda: table.to_table(version=1))
        same_state(state_of(got), original, "decimal step 11")
        record("step 11 read version 1", wall_s, delta,
               f"{got.num_rows} rows equal to the written table", check_state=False)
        launches = dict(native.launches)  # -- the decimal phase's path ends here
    say(f"decimal: launches on the decimal phase's path {launches} | {card}")
    for k in ("block_cull", "slab_sort", "slab_probe", "pair_compact", "residual_mask",
              "expr_eval", "morton"):
        check(launches.get(k, 0) > 0, f"kernel {k} was not launched on the decimal path")
    check(launches.get("slab_advance", 0) + launches.get("slab_widen", 0) > 0,
          "K11 was not launched on the decimal path")
    say(json.dumps({"decimal": steps}))
    return {"launches": launches, "steps": steps}


def nested_columns(ids, seed):
    """``id`` and the three nested shapes of tests/test_datatypes.py:34-37
    over ``ids``, drawn from RandomState(seed) in numpy: ``st struct<x
    int64, y string>`` (5% NULL structs, 5% structs of NULLs), ``arr
    list<int64>`` of 0-8 elements (5% NULL lists, 5% empty; 5% NULL
    elements), ``m map<string, int64>`` of 0-4 entries (5% NULL maps, 5%
    empty; keys k0..k3 in order, 5% NULL values). Returns (HostTable,
    Python rows keyed by id: the reference)."""
    from delta_tpu_torch.expr.nested import NCol

    n = len(ids)
    r = np.random.RandomState(seed)
    kind = r.randint(0, 20, n)
    st_valid, st_nulls = kind != 0, kind == 1
    x = r.randint(-10**6, 10**6, n).astype(np.int64)
    x_ok = st_valid & ~st_nulls & (r.rand(n) > 0.1)
    words = np.array([f"y{k}" for k in range(1000)], object)
    y = words[r.randint(0, 1000, n)]
    y_ok = st_valid & ~st_nulls & (r.rand(n) > 0.1)
    y = np.where(y_ok, y, None)

    def listing(max_len, values):
        kind = r.randint(0, 20, n)
        count = np.where(kind <= 1, 0, r.randint(0, max_len + 1, n))
        offsets = np.zeros(n + 1, np.int64)
        np.cumsum(count, out=offsets[1:])
        total = int(offsets[-1])
        return kind != 0, count, offsets, values(total), r.rand(total) > 0.05

    a_valid, a_count, a_offs, a_vals, a_ok = listing(
        8, lambda t: r.randint(-1000, 1000, t).astype(np.int64))
    m_valid, m_count, m_offs, m_vals, m_ok = listing(
        4, lambda t: r.randint(-10**9, 10**9, t).astype(np.int64))
    m_keys = np.array([f"k{j}" for j in range(4)], object)[
        np.arange(int(m_offs[-1])) - np.repeat(m_offs[:-1], m_count)]
    leaf = lambda vals, ok, stype: NCol("leaf", ok, values=vals, stype=stype)
    st = NCol("struct", st_valid, fields={"x": leaf(np.where(x_ok, x, 0), x_ok, "int64"),
                                          "y": leaf(y, y_ok, "string")})
    arr = NCol("list", a_valid, offsets=a_offs,
               element=leaf(np.where(a_ok, a_vals, 0), a_ok, "int64"))
    m = NCol("map", m_valid, offsets=m_offs, element=NCol(
        "struct", np.ones(len(m_keys), bool), fields={
            "key": leaf(m_keys, np.ones(len(m_keys), bool), "string"),
            "value": leaf(np.where(m_ok, m_vals, 0), m_ok, "int64")}))
    table = HostTable({
        "id": HostColumn("int", np.asarray(ids, np.int64), np.ones(n, bool)),
        "st": HostColumn("nested", st, st_valid, ("struct", (("x", "int64"), ("y", "string")))),
        "arr": HostColumn("nested", arr, a_valid, ("list", "int64")),
        "m": HostColumn("nested", m, m_valid, ("map", "string", "int64"))}, n)
    # the reference, row by row in Python from the same draws
    xl, yl = x.tolist(), y.tolist()
    avl, aol, mvl, mol, mkl = (a_vals.tolist(), a_ok.tolist(), m_vals.tolist(), m_ok.tolist(),
                               m_keys.tolist())
    ref = {}
    for i, key in enumerate(np.asarray(ids).tolist()):
        s = ({"x": xl[i] if x_ok[i] else None, "y": yl[i]} if st_valid[i] else None)
        a0, a1 = int(a_offs[i]), int(a_offs[i + 1])
        a = [avl[j] if aol[j] else None for j in range(a0, a1)] if a_valid[i] else None
        m0, m1 = int(m_offs[i]), int(m_offs[i + 1])
        mm = ([(mkl[j], mvl[j] if mol[j] else None) for j in range(m0, m1)]
              if m_valid[i] else None)
        ref[key] = {"id": key, "st": s, "arr": a, "m": mm}
    return table, ref


def run_nested(dev, workdir, card):
    """Phase 15b: a table of ``id`` and struct, list and map columns
    (NESTED_ROWS rows, deletion vectors on): the write, a MERGE with update
    * / insert * keyed on ``id`` (K8-K10), a DV DELETE of ``id % 10 = 0``,
    OPTIMIZE (each step's row counts checked); then the end state read and
    compared with the Python reference row for row."""
    from delta_tpu_torch import DeltaTable
    from delta_tpu_torch.commands.alter import set_table_properties
    from delta_tpu_torch.commands.optimize import OptimizeCommand
    from delta_tpu_torch.ops.column_cache import ColumnCache

    key_cache.KeyCache.reset()
    ColumnCache.reset()
    torch.cuda.empty_cache()
    path = os.path.join(workdir, "nested")
    box = {}

    def state_check(name):
        t = scan_to_table(box["log"].update())
        ref = box["ref"]
        check(t.num_rows == len(ref), f"nested {name}: {t.num_rows} rows, the reference "
              f"{len(ref)}")
        got = t.to_pylist()
        check(all(row == ref.get(row["id"]) for row in got),
              f"nested {name}: a row differs from the Python reference")
        return f"; end state of {len(ref)} rows equal to the Python reference row for row"

    record, steps = _phase_steps(card, "nested", state_check)
    t0 = time.perf_counter()
    target, ref = nested_columns(np.arange(NESTED_ROWS), 51)
    say(f"nested: data and its Python reference built in {time.perf_counter() - t0:.1f} s")
    settings = {"delta.tpu.stateCache.devicePlan.mode": "force",
                "delta.tpu.write.targetFileRows": NESTED_FILE_ROWS}
    with conf.set_temporarily(**settings):
        native.reset_launches()  # -- the nested phase's path starts here
        log = box["log"] = DeltaLog.for_table(path, device=dev)
        box["ref"] = ref
        _, wall_s, delta = timed_step("step 1", lambda: WriteIntoDelta(log, "append", target)
                                      .run())
        set_table_properties(log, {"delta.tpu.enableDeletionVectors": "true"})
        table = DeltaTable.for_path(path, device=dev)
        snap = log.update()
        schema = {f.name: f.data_type.simple_string() for f in snap.metadata.schema.fields}
        record("step 1 write", wall_s, delta, f"{len(snap.all_files)} files, schema {schema}",
               check_state=False)

        r = np.random.RandomState(52)
        ids = np.concatenate([r.choice(NESTED_ROWS, NESTED_SOURCE // 2, replace=False),
                              np.arange(NESTED_ROWS, NESTED_ROWS + NESTED_SOURCE // 2)])
        r.shuffle(ids)
        src, src_ref = nested_columns(ids, 53)

        def run_merge():
            cmd = MergeIntoCommand(log, src, "t.id = s.id", [MergeClause("update")],
                                   [MergeClause("insert")], source_alias="s", target_alias="t")
            cmd.run()
            return cmd

        cmd, wall_s, delta = timed_step("step 2", run_merge,
                                        {"delta.tpu.merge.devicePath.mode": "force"})
        check(cmd._join_path == "device-cold" and not cmd._router.get("reason"),
              f"step 2: route {cmd._join_path} {cmd._router}")
        check(cmd.metrics["numTargetRowsUpdated"] == NESTED_SOURCE // 2
              and cmd.metrics["numTargetRowsInserted"] == NESTED_SOURCE // 2,
              f"step 2: metrics {cmd.metrics}")
        ref.update(src_ref)
        record("step 2 MERGE (update *, insert *)", wall_s, delta,
               f"phase_ms {({k: round(v, 3) for k, v in cmd.phase_ms.items()})}",
               check_state=False)

        # step 3: a DV DELETE; ``id % 10`` has no skipping rewrite, so every
        # file is a candidate and no plan kernel runs (as in the JAX package)
        m, wall_s, delta = timed_step("step 3", lambda: table.delete("id % 10 = 0"))
        gone = [k for k in ref if k % 10 == 0]
        check(m["numDeletedRows"] == len(gone), f"step 3: metrics {m}")
        for k in gone:
            del ref[k]
        record("step 3 DELETE (DV)", wall_s, delta, f"{m['numDeletedRows']} rows",
               check_state=False)

        cmd = OptimizeCommand(log, None)
        _, wall_s, delta = timed_step("step 4", cmd.run)
        check(cmd.metrics["numRemovedFiles"] > 1, f"step 4: metrics {cmd.metrics}")
        record("step 4 OPTIMIZE", wall_s, delta,
               f"{cmd.metrics['numRemovedFiles']} files into {cmd.metrics['numAddedFiles']}")
        launches = dict(native.launches)  # -- the nested phase's path ends here
    say(f"nested: launches on the nested phase's path {launches} | {card}")
    for k in ("slab_sort", "slab_probe", "pair_compact"):
        check(launches.get(k, 0) > 0, f"kernel {k} was not launched on the nested path")
    say(json.dumps({"nested": steps}))
    return {"launches": launches, "steps": steps}

# -- phase 16: the table API: plan_queries, CTAS, the MERGE builder, clone, GENERATE, convert --

API_DV = {"delta.tpu.enableDeletionVectors": "true"}
#: 16b-c's store_sales: config 2's 10M rows and 1M-row upsert cut to make room
#: for phase 17, which runs config 2 at full width through the same API (3
#: files: the DELETEs stay below K1's minFiles)
API_ROWS, API_SOURCE, API_FILE_ROWS = 4_000_000, 400_000, 1_500_000
API_DELETE = "ss_quantity >= 96"
#: 16d's Parquet directory: CONVERT_FILES files of CONVERT_FILE_ROWS
#: store_sales rows, one an ``ss_sold_date_sk=`` directory
CONVERT_FILES, CONVERT_FILE_ROWS = 64, 20_000
MANIFEST = "_symlink_format_manifest"


def run_plan_queries(dev, ctx):
    """16a: config 6's 256 queries, as filter lists, through
    ``DeltaTable.plan_queries`` on phase 4's live residency (no second
    one): one K1 launch for the batch, 256 bumps of
    ``stateCache.plan.resident``, each plan on the card and equal, path for
    path, to ``entry.plan_ranges`` and to the host's ``files_for_scan``."""
    from delta_tpu_torch.utils import telemetry

    entry, snap, queries = ctx["entry"], ctx["snap"], ctx["queries"]
    table = DeltaTable.for_path(ctx["log"].data_path, device=dev)
    check(table.delta_log is ctx["log"] and table.version == snap.version,
          "plan_queries: the handle is not on phase 4's log at its version")
    want = entry.plan_ranges(ctx["ranges"], k=N_QUERIES, expected_version=snap.version)
    counted = telemetry.counters("stateCache.plan.resident").get("stateCache.plan.resident", 0)
    native.reset_launches()  # -- 16a's path starts here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plans = table.plan_queries([[q] for q in queries], k=N_QUERIES)
    torch.cuda.synchronize()
    plan_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(native.launches)  # -- 16a's path ends here
    bumped = telemetry.counters("stateCache.plan.resident")["stateCache.plan.resident"] - counted
    check(launches["block_cull"] == 1, f"plan_queries: {launches['block_cull']} K1 launches")
    check(bumped == N_QUERIES, f"plan_queries: stateCache.plan.resident bumped by {bumped}")
    overflow = 0
    for i, (q, got, w) in enumerate(zip(queries, plans, want)):
        check(got.via == "device", f"plan_queries: query {i} planned by {got.via}")
        check(got.paths == [entry.paths[r] for r in w.rows] and got.count == w.count
              and got.overflow == w.overflow, f"plan_queries: query {i} differs from plan_ranges")
        host = [f.path for f in pruning.files_for_scan(snap, [parse_expression(q)]).files]
        check(got.count == len(host) and (sorted(got.paths) == host if not got.overflow
                                          else set(got.paths) <= set(host)),
              f"plan_queries: query {i} differs from files_for_scan: {q}")
        overflow += got.overflow
    say(f"table API: plan_queries of {N_QUERIES} queries in {plan_ms:.3f} ms (k={N_QUERIES}, "
        f"{overflow} overflowing), launches {launches}; every plan on the card and equal to "
        "plan_ranges and files_for_scan")
    return {"launches": launches, "plan_ms": plan_ms}


def manifest_lines(log):
    """The table's top-level symlink manifest, and the lines its live files
    make (``file:`` and the quoted absolute path)."""
    import urllib.parse

    with open(os.path.join(log.data_path, MANIFEST, "manifest")) as f:
        got = f.read().splitlines()
    want = sorted("file:" + urllib.parse.quote(os.path.abspath(
        os.path.join(log.data_path, urllib.parse.unquote(a.path))))
        for a in log.update().all_files)
    return got, want


def run_table_api(dev, workdir, card):
    """16b-16d: bench config 2 through the table API (API_ROWS), then
    clone, GENERATE, the catalog and CONVERT TO DELTA; each step's wall
    seconds and launches printed beside the card."""
    from delta_tpu_torch.catalog.catalog import Catalog
    from delta_tpu_torch.commands.alter import set_table_properties
    from delta_tpu_torch.commands.convert import ConvertToDeltaCommand
    from delta_tpu_torch.obs.scan_report import last_scan_report
    from delta_tpu_torch.schema.types import StructField
    from delta_tpu_torch.utils import telemetry
    from delta_tpu_torch.utils.errors import DeltaAnalysisError, ProtocolError

    t_phase = time.perf_counter()
    rng = np.random.RandomState(7)
    target = store_sales(API_ROWS, rng)
    src = bench_source(target["ss_item_sk"], rng, API_SOURCE)
    v0 = by_key({c: target[c] for c in STORE_SALES})
    want = reference_upsert(v0, src)
    path = os.path.join(workdir, "config2-api")
    DeltaLog.clear_cache()
    key_cache.KeyCache.reset()
    steps = []

    def step(name, fn, settings=None):
        out, wall_s, delta = timed_step(name, fn, settings)
        steps.append((name, wall_s, delta))
        say(f"table API: {name} {wall_s:.3f} s, launches {delta} | {card}")
        return out

    native.reset_launches()  # -- 16b-16d's path starts here
    # 16b: CTAS, then the MERGE builder's upsert
    table = step("16b CTAS", lambda: DeltaTable.create(path, data=host_table(target),
                                                       configuration=API_DV, device=dev),
                 {"delta.tpu.write.targetFileRows": API_FILE_ROWS})
    commits = sorted(f for f in os.listdir(os.path.join(path, "_delta_log"))
                     if f.endswith(".json"))
    check(table.version == 0 and commits == [filenames.delta_file(0)],
          f"CTAS: version {table.version}, commits {commits}")
    same_state(step("16b read back", lambda: state_of(table.to_table())), v0, "CTAS read back")
    metrics = step("16b MERGE builder", lambda: (
        DeltaTable.for_path(path, device=dev).alias("t")
        .merge(src, "t.ss_item_sk = s.ss_item_sk", source_alias="s")
        .when_matched_update_all().when_not_matched_insert_all().execute()),
        {"delta.tpu.merge.devicePath.mode": "force"})
    check(metrics["numTargetRowsUpdated"] == API_SOURCE // 2
          and metrics["numTargetRowsInserted"] == API_SOURCE - API_SOURCE // 2,
          f"MERGE builder: metrics {metrics}")
    merge_launches = steps[-1][2]
    for k in ("slab_sort", "slab_probe", "pair_compact"):
        check(merge_launches.get(k, 0) > 0, f"MERGE builder: {k} was not launched")
    same_state(step("16b end state", lambda: state_of(table.to_table())), want,
               "MERGE builder end state")
    latest = table.version

    # 16c: the protocol, a pinned handle, clones, GENERATE, the catalog
    step("16c upgrade_table_protocol", lambda: table.upgrade_table_protocol(3, 7))
    check(table.version == latest, "upgrading to the protocol the table has committed")
    try:
        table.upgrade_table_protocol(2, 8)
        check(False, "a protocol downgrade was not refused")
    except ProtocolError:
        pass
    pinned = DeltaTable.for_path(path + "@v0", device=dev)
    same_state(step("16c read path@v0", lambda: state_of(pinned.to_table())), v0, "path@v0")
    try:
        pinned.delete("ss_quantity > 0")
        check(False, "a DELETE on a path@v0 handle was not refused")
    except DeltaAnalysisError:
        pass
    check(table.version == latest, "the refused DELETE committed")
    source_files = data_files_on_disk(path)
    clones = {}
    for name, version, state in (("api-clone-v0", 0, v0), ("api-clone-latest", None, want)):
        cpath = os.path.join(workdir, name)
        clones[name] = step(f"16c clone {name}",
                            lambda: table.clone(cpath, version=version))
        same_state(state_of(clones[name].to_table()), state, f"clone {name}")
        check(not [f for _, _, fs in os.walk(cpath) for f in fs if f.endswith(".parquet")],
              f"clone {name} copied a data file")
    clone = clones["api-clone-latest"]
    deleted = int((want["ss_quantity"] >= 96).sum())
    m = step("16c DELETE on the clone", lambda: clone.delete(API_DELETE))
    check(m["numDeletedRows"] == deleted, f"DELETE on the clone: {m}")
    kept = np.sort(want["ss_item_sk"][want["ss_quantity"] < 96])
    check(np.array_equal(np.sort(clone.to_table(columns=["ss_item_sk"]).column(
        "ss_item_sk").values), kept), "the clone's rows after its DELETE")
    res = step("16c VACUUM of the clone",
               lambda: clone.vacuum(retention_hours=0, retention_check_enabled=False))
    check(data_files_on_disk(path) == source_files and table.version == latest,
          "the clone's DELETE or VACUUM touched the source")
    check(table.to_table(columns=["ss_item_sk"]).num_rows == len(want["ss_item_sk"]),
          "the source's rows after the clone's DELETE")
    say(f"table API: the clone's VACUUM deleted {res.files_deleted} files, none of the source's")
    step("16c generate", table.generate)
    got, live = manifest_lines(table.delta_log)
    check(got == live, "GENERATE: the manifest does not list exactly the live files")
    set_table_properties(table.delta_log,
                         {"delta.compatibility.symlinkFormatManifest.enabled": "true"})
    os.remove(os.path.join(path, MANIFEST, "manifest"))
    m = step("16c DELETE with the manifest hook", lambda: table.delete(API_DELETE))
    check(m["numDeletedRows"] == deleted, f"DELETE with the manifest hook: {m}")
    got, live = manifest_lines(table.delta_log)
    check(got == live, "the DELETE's commit did not rewrite the manifest")
    store = os.path.join(workdir, "catalog.json")
    small = {c: v[:100_000] for c, v in target.items()}
    step("16c create by name", lambda: Catalog(store).create_table(
        "tpcds.store_sales_api", os.path.join(workdir, "api-by-name"),
        data=host_table(small), device=dev))
    named = DeltaTable.for_name("tpcds.store_sales_api", catalog=Catalog(store), device=dev)
    same_state(state_of(named.to_table()), by_key(small), "for_name")

    # 16d: CONVERT TO DELTA of Parquet files the port's writer wrote
    conv = os.path.join(workdir, "api-convert")
    cols = store_sales(CONVERT_FILES * CONVERT_FILE_ROWS, np.random.RandomState(17))
    days = 2450000 + np.arange(len(cols["ss_item_sk"])) // CONVERT_FILE_ROWS
    cols["ss_sold_date_sk"] = days.astype(np.int64)

    def write_dir():
        for d in np.unique(days):
            part = {c: v[days == d] for c, v in cols.items() if c != "ss_sold_date_sk"}
            os.makedirs(os.path.join(conv, f"ss_sold_date_sk={d}"))
            write_parquet_file(host_table(part), os.path.join(
                conv, f"ss_sold_date_sk={d}", "part-00000.parquet"), device=dev)

    step("16d write the Parquet directory", write_dir)
    before = telemetry.counters("convert.stats")
    step("16d convert", lambda: ConvertToDeltaCommand(
        DeltaLog.for_table(conv, device=dev),
        StructType([StructField("ss_sold_date_sk", LongType())]), collect_stats=True).run())
    stats = {k: v - before.get(k, 0) for k, v in telemetry.counters("convert.stats").items()}
    check(stats == {"convert.stats.fromFooter": CONVERT_FILES},
          f"convert: stats {stats}, not all from the footers")
    converted = DeltaTable.for_path(conv, device=dev)
    filters = ["ss_sold_date_sk < 2450008", "ss_quantity >= 90"]
    keep = (days < 2450008) & (cols["ss_quantity"] >= 90)
    got = step("16d filtered read", lambda: converted.to_table(filters=filters),
               {"delta.tpu.read.deviceResidual.mode": "force"})
    same_state(state_of(got), take_state(cols, keep), "the converted table's filtered read")
    check(steps[-1][2].get("residual_mask", 0) > 0, "the filtered read launched no K14")
    scanned = last_scan_report().files_scanned
    check(scanned < CONVERT_FILES, f"the converted table's read scanned {scanned} files")
    none = converted.to_table(filters=["ss_store_sk > 1000"])
    check(none.num_rows == 0 and last_scan_report().files_scanned == 0,
          "the footer stats pruned no file")
    launches = dict(native.launches)  # -- 16b-16d's path ends here
    say(f"table API: convert of {CONVERT_FILES} files, stats {stats}, the filtered read "
        f"scanned {scanned} files; launches on 16b-16d's path {launches} | {card}")
    say(f"table API: 16b-16d took {time.perf_counter() - t_phase:.3f} s")
    return {"launches": launches, "steps": steps, "merge_launches": merge_launches}


# -- phase 17: write semantics on the card --------------------------------------------

#: phase 17's table: the change data feed, deletion vectors and a CHECK constraint
WS_PROPS = {"delta.enableChangeDataFeed": "true", "delta.tpu.enableDeletionVectors": "true",
            "delta.constraints.qpos": "ss_quantity > 0"}
WS_GEN, WS_GEN_SQL = "ss_ext_sales_price", "ss_quantity * ss_sales_price"
WS_NEW = "ss_promo_sk"  # the MERGE source's column the table does not have yet
WS_DELETE = "ss_quantity > 95"
WS_UPDATE_WHERE, WS_UPDATE_SET = "ss_store_sk < 5", {"ss_quantity": "ss_quantity + 1"}
WS_COLS = STORE_SALES + (WS_GEN, WS_NEW)
WS_DOUBLES = ("ss_sales_price", "ss_ext_discount_amt", "ss_net_paid")


def ws_generated(cols):
    """``cols`` with the generated column as numpy computes it."""
    return dict(cols, **{WS_GEN: cols["ss_quantity"].astype(np.float64) * cols["ss_sales_price"]})


def ws_rows(t):
    """A read or a change block as numpy columns sorted by ss_item_sk: the
    table's columns, the new column's values and its validity."""
    check(all(t.column(c).valid.all() for c in STORE_SALES + (WS_GEN,)), "a NULL in a read")
    cols = {c: t.column(c).values for c in STORE_SALES + (WS_GEN,)}
    new = t.column(WS_NEW) if WS_NEW in t.column_names else None
    n = t.num_rows
    cols[WS_NEW] = np.where(new.valid, new.values, 0).astype(np.int64) if new is not None \
        else np.zeros(n, np.int64)
    cols[WS_NEW + "?"] = np.asarray(new.valid, bool) if new is not None else np.zeros(n, bool)
    return by_key(cols)


def ws_same(got, want, label):
    check(len(got["ss_item_sk"]) == len(want["ss_item_sk"]),
          f"{label}: {len(got['ss_item_sk'])} rows, numpy {len(want['ss_item_sk'])}")
    for c in want:
        check(np.array_equal(got[c], want[c]), f"{label}: column {c} differs from numpy")


def run_write_semantics(dev, workdir, card):
    """Phase 17: bench config 2's store_sales (10M rows, seed 7) created
    through the table API with the change data feed, deletion vectors, the
    CHECK constraint ``ss_quantity > 0`` and the generated column
    ``ss_ext_sales_price`` (``ss_quantity * ss_sales_price``). (a) the 1M-row
    upsert through the MERGE builder with autoMerge and a star clause, its
    source carrying the new column ``ss_promo_sk``: the schema evolves, K8-K11
    run, the CDC file goes through the page codec; (b) a DV DELETE and an
    UPDATE with data predicates (K15 plans their candidates); (c) a source
    batch breaking the constraint raises and commits nothing; (d)
    ``table_changes`` over the versions (a)-(b) wrote, every block equal to
    numpy's; (e) a ``StreamingQuery`` from the table's snapshot into a
    second table, one file a trigger, whose end state is the table's, and a
    ``DeltaCDFSource`` from (a)'s version whose rows are (d)'s."""
    from delta_tpu_torch.exec import cdf
    from delta_tpu_torch.schema.generated import generated_field
    from delta_tpu_torch.streaming.query import StreamingQuery
    from delta_tpu_torch.streaming.sink import DeltaSink
    from delta_tpu_torch.streaming.source import DeltaCDFSource, DeltaSource
    from delta_tpu_torch.utils.errors import InvariantViolationError

    t_phase = time.perf_counter()
    key_cache.KeyCache.reset()
    DeltaLog.clear_cache()
    torch.cuda.empty_cache()
    path = os.path.join(workdir, "store_sales_cdf")
    rng = np.random.RandomState(7)
    target = store_sales(MERGE_ROWS, rng)
    src = bench_source(target["ss_item_sk"], rng)  # merge_sources' first, drawn once
    src[WS_NEW] = np.random.RandomState(17).randint(0, 2000, MERGE_SOURCE).astype(np.int64)
    state = ws_generated({c: target[c] for c in STORE_SALES})
    state[WS_NEW], state[WS_NEW + "?"] = (np.zeros(MERGE_ROWS, np.int64),
                                          np.zeros(MERGE_ROWS, bool))
    state = by_key(state)
    schema = StructType()
    for c in STORE_SALES:
        schema = schema.add(c, DoubleType() if c in WS_DOUBLES else LongType())
    schema = schema.add_field(generated_field(WS_GEN, DoubleType(), WS_GEN_SQL))
    steps = []

    def step(name, fn, settings=None, kernels=()):
        t0 = time.perf_counter()
        out, wall_s, delta = timed_step(name, fn, settings)
        steps.append((name, wall_s, delta))
        say(f"write semantics: {name} {wall_s:.3f} s ({time.perf_counter() - t0:.3f} s with "
            f"the warmups it started; the phase at {time.perf_counter() - t_phase:.1f} s), "
            f"launches {delta} | {card}")
        for k in kernels:
            names = k if isinstance(k, tuple) else (k,)
            check(any(delta.get(x, 0) > 0 for x in names), f"{name}: {k} was not launched")
        return out

    native.reset_launches()  # -- phase 17's path starts here
    table = step("create", lambda: DeltaTable.create(path, schema, configuration=WS_PROPS,
                                                     device=dev))
    step("write 10M rows", lambda: table.write(host_table(target)),
         {"delta.tpu.write.targetFileRows": MERGE_FILE_ROWS}, ("snappy_compress",))
    proto = table.delta_log.update().protocol
    check((proto.min_reader_version, proto.min_writer_version) == (3, 7),
          f"protocol {proto}: deletion vectors take (3, 7), over the feed's writer version 4")

    # (a) the evolving upsert
    v_merge = table.version + 1
    metrics = step("(a) MERGE builder, autoMerge", lambda: (
        DeltaTable.for_path(path, device=dev).alias("t")
        .merge(host_table(src), "t.ss_item_sk = s.ss_item_sk", source_alias="s")
        .when_matched_update_all().when_not_matched_insert_all().execute()),
        {"delta.tpu.merge.devicePath.mode": "force", "delta.tpu.schema.autoMerge.enabled": True},
        ("slab_sort", "slab_probe", "pair_compact", K11, "snappy_compress"))
    half = MERGE_SOURCE // 2
    check(metrics["numTargetRowsUpdated"] == half
          and metrics["numTargetRowsInserted"] == MERGE_SOURCE - half, f"(a): metrics {metrics}")
    check([f.name for f in table.schema().fields] == list(WS_COLS),
          f"(a): the schema did not evolve: {[f.name for f in table.schema().fields]}")
    keys = state["ss_item_sk"]
    pos = np.minimum(np.searchsorted(keys, src["ss_item_sk"]), len(keys) - 1)
    hit = keys[pos] == src["ss_item_sk"]
    src_full = ws_generated({c: src[c] for c in STORE_SALES})
    src_full[WS_NEW], src_full[WS_NEW + "?"] = src[WS_NEW], np.ones(MERGE_SOURCE, bool)
    blocks = {(v_merge, "update_preimage"): by_key({c: v[pos[hit]] for c, v in state.items()}),
              (v_merge, "update_postimage"): by_key({c: v[hit] for c, v in src_full.items()}),
              (v_merge, "insert"): by_key({c: v[~hit] for c, v in src_full.items()})}
    merged = {}
    for c, v in state.items():
        col = v.copy()
        col[pos[hit]] = src_full[c][hit]
        merged[c] = np.concatenate([col, src_full[c][~hit]])
    state = by_key(merged)
    check(len(blocks[(v_merge, "update_preimage")]["ss_item_sk"]) == half, "(a): numpy's hits")

    # (b) a DV DELETE and an UPDATE with data predicates, K15 on their candidates
    few_files = {"delta.tpu.device.pruning.minFiles": 1}
    gone = state["ss_quantity"] > 95
    m = step("(b) DV DELETE", lambda: table.delete(WS_DELETE), few_files, ("expr_eval",))
    check(m["numDeletedRows"] == int(gone.sum()), f"(b) DELETE: metrics {m}")
    blocks[(v_merge + 1, "delete")] = take_state(state, gone)
    state = take_state(state, ~gone)
    upd = state["ss_store_sk"] < 5
    m = step("(b) UPDATE", lambda: table.update(WS_UPDATE_SET, WS_UPDATE_WHERE), few_files,
             ("expr_eval",))
    check(m["numUpdatedRows"] == int(upd.sum()), f"(b) UPDATE: metrics {m}")
    blocks[(v_merge + 2, "update_preimage")] = take_state(state, upd)
    state = {c: v.copy() for c, v in state.items()}
    state["ss_quantity"][upd] += 1
    state = ws_generated(state)
    blocks[(v_merge + 2, "update_postimage")] = take_state(state, upd)
    latest = table.version
    check(latest == v_merge + 2, f"versions: {latest}, not {v_merge + 2}")

    # (c) a source batch that breaks the constraint commits nothing
    bad = dict(store_sales(1000, np.random.RandomState(19)),
               ss_item_sk=np.arange(90_000_000, 90_001_000, dtype=np.int64))
    bad["ss_quantity"][500] = 0
    bad[WS_NEW] = np.zeros(1000, np.int64)
    try:
        step("(c) MERGE breaking the constraint", lambda: (
            table.alias("t").merge(host_table(bad), "t.ss_item_sk = s.ss_item_sk",
                                   source_alias="s")
            .when_matched_update_all().when_not_matched_insert_all().execute()),
            {"delta.tpu.merge.devicePath.mode": "force"})
        check(False, "(c): the MERGE broke the CHECK constraint and committed")
    except InvariantViolationError as e:
        say(f"write semantics: (c) raised {type(e).__name__}: {str(e).splitlines()[0]}")
    check(DeltaLog.for_table(path, device=dev).update().version == latest,
          "(c): the refused MERGE committed")
    ws_same(step("end state", lambda: ws_rows(table.to_table())), state, "end state")

    # (d) the change feed of (a)-(b), every block against numpy's
    changes = step("(d) table_changes", lambda: table.table_changes(v_merge),
                   kernels=("snappy_decompress",))
    commits = table.delta_log.history.get_commits(v_merge)
    stamps = np.zeros(latest + 1, np.int64)
    stamps[[c.version for c in commits]] = [c.timestamp for c in commits]
    ver = changes.column(cdf.COMMIT_VERSION_COL).values
    kind = changes.column(cdf.CHANGE_TYPE_COL).values
    ts = changes.column(cdf.COMMIT_TIMESTAMP_COL).values
    check(bool((ts == stamps[ver]).all()), "(d): a _commit_timestamp is not its commit's")
    is_kind = {k: kind == k for k in set(np.unique(kind).tolist())}
    seen = sorted((int(v), k) for k, m in is_kind.items() for v in np.unique(ver[m]))
    check(seen == sorted(blocks), f"(d): blocks {seen}, numpy {sorted(blocks)}")
    for (v, k), want in blocks.items():
        ws_same(ws_rows(changes.filter((ver == v) & is_kind[k])), want, f"(d) {k} at {v}")
    counts = {f"{k}@{v}": len(b["ss_item_sk"]) for (v, k), b in sorted(blocks.items())}
    say(f"write semantics: (d) change rows {counts}, each block equal to numpy | {card}")

    # (e) a stream of the table into a second table, and the change feed's stream
    dst = os.path.join(workdir, "store_sales_cdf_copy")
    query = StreamingQuery(DeltaSource(DeltaLog.for_table(path, device=dev),
                                       max_files_per_trigger=1),
                           DeltaSink(DeltaLog.for_table(dst, device=dev), query_id="phase17"),
                           os.path.join(workdir, "store_sales_cdf_ckpt"))
    batches = step("(e) StreamingQuery", query.process_all_available,
                   kernels=("snappy_decompress", "snappy_compress"))
    n_files = len(table.delta_log.update().all_files)
    check(batches == n_files, f"(e): {batches} batches for {n_files} files, one a trigger")
    ws_same(ws_rows(DeltaTable.for_path(dst, device=dev).to_table()), state,
            "(e) the stream's end state")
    source = DeltaCDFSource(DeltaLog.for_table(path, device=dev), starting_version=v_merge)

    def drain():
        parts, cur = [], None
        while True:
            end = source.latest_offset(cur if cur is not None else source.initial_offset())
            if end is None:
                return cdf.concat_permissive(parts)
            parts.append(source.get_batch(cur, end))
            cur = end

    streamed = step("(e) DeltaCDFSource", drain, kernels=("snappy_decompress",))
    sver = streamed.column(cdf.COMMIT_VERSION_COL).values
    skind = streamed.column(cdf.CHANGE_TYPE_COL).values
    for (v, k), want in blocks.items():
        ws_same(ws_rows(streamed.filter((sver == v) & (skind == k))), want,
                f"(e) the CDF stream's {k} at {v}")
    check(streamed.num_rows == changes.num_rows, "(e): the CDF stream's rows are not (d)'s")
    launches = dict(native.launches)  # -- phase 17's path ends here
    say(f"write semantics: the stream ran {batches} batches; launches on phase 17's path "
        f"{launches} | {card}")
    say(f"write semantics: phase 17 took {time.perf_counter() - t_phase:.3f} s")
    return {"launches": launches, "steps": steps}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    from delta_tpu_torch.ops import page_codec

    laps, clock = {}, [time.perf_counter()]
    codec_ms = [dict(page_codec.device_ms)]

    def lap(name):  # each phase's wall seconds, printed before the kernels line
        now = time.perf_counter()
        laps[name] = round(now - clock[0], 1)
        clock[0] = now
        # the page codec's device ms in the phase (CUDA events around each launch)
        spent = {k: round(v - codec_ms[0][k], 3) for k, v in page_codec.device_ms.items()}
        codec_ms[0] = dict(page_codec.device_ms)
        say(f"page codec device ms in {name} ({laps[name]} s of wall): {json.dumps(spent)}")

    card = card_line()
    say(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | {card} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    say(f"build: {native.build_all():.3f} s")
    synthetic_checks(dev)
    lap("1-3 build and kernels")
    if "--kernels-only" in sys.argv[1:]:
        return 0
    # every phase reads and writes Parquet: the page codec's launches on each
    # phase's path (its counts set to 0 just before it) add up here
    codec = {k: 0 for k in CODEC_KERNELS}

    def tally(launches):
        for k in CODEC_KERNELS:
            codec[k] += launches.get(k, 0)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        # phases 4, 5 and 9 count the kernels of a pinned route: under auto
        # the router may price the host side cheaper (phase 10 drives auto)
        with conf.set_temporarily(**{"delta.tpu.stateCache.devicePlan.mode": "force"}):
            ctx = run_slice(dev, workdir)
            run_fallback(dev, ctx)
            lap("4-5 config 6")
            # 16a on phase 4's live residency, before its host state goes
            pq_ctx = run_plan_queries(dev, ctx)
            lap("16a plan_queries")
        check(ctx["launches"]["snappy_decompress"] > 0,
              "config 6's checkpoint decoded without snappy_decompress")
        tally(ctx["launches"])
        tally(ctx["fallback_launches"])
        c5 = run_config5(dev, workdir)
        tally(c5["launches"])
        lap("5b config 5")
        kernels = measure(dev, ctx["entry"], ctx["ranges"], ctx["cols"], ctx["launches"])
        for k in kernels:  # K4 runs on phase 4's path and on config 5's
            if k["name"] == "winner_bits":
                k["launches"] += c5["launches"]["winner_bits"]
        c5 = None
        kernels += measure_normal_leg(dev, ctx)
        lap("11 config 6's kernels")
        c6 = {"entry": ctx["entry"], "ranges": ctx["ranges"], "stream": ctx["stream"]}
        ctx = None  # the rest of the scan phases' host state is done with
        mctx = run_merge(dev, workdir)
        tally(mctx["launches"])
        slab_rows = measure_slab(dev, mctx)
        kernels += slab_rows
        measure_probe_constants(dev, mctx, slab_rows)
        mctx = None  # the key-slab phase's slabs are done with
        lap("6 key slab")
        key_cache.KeyCache.reset()
        torch.cuda.empty_cache()
        cctx = run_merge_command(dev, workdir)
        check(cctx["launches"]["snappy_compress"] > 0 and cctx["launches"]["snappy_decompress"] > 0,
              f"the MERGE command's path launched no page codec kernel: {cctx['launches']}")
        tally(cctx["launches"])
        k12_rows = measure_join_probe(dev, cctx)
        kernels += k12_rows
        measure_join_constants(cctx, k12_rows)
        c2 = {"path": cctx["path"], "state": cctx["state"], "m3": cctx["merges"][-1]}
        cctx = None
        lap("7 MERGE command")
        key_cache.KeyCache.reset()
        torch.cuda.empty_cache()
        sctx = run_device_scan(dev, workdir)
        tally(sctx["launches"])
        kernels += measure_residual_mask(dev, sctx)
        measure_residual_constants(dev, sctx)
        c12 = {k: sctx[k] for k in ("path", "data", "queries")}
        sctx = None
        lap("8 read path")
        with conf.set_temporarily(**{"delta.tpu.read.deviceResidual.mode": "force"}):
            zctx = run_zorder(dev, workdir)
        tally(zctx["launches"])
        kernels += measure_morton(dev, zctx)
        lap("9 OPTIMIZE")
        rctx = run_router(dev, c6, c2, c12, workdir)
        tally(rctx["launches"])
        kernels += measure_link_probe(dev, rctx)
        lap("10 router")
        key_cache.KeyCache.reset()
        torch.cuda.empty_cache()
        xctx = run_mesh(dev, c6, dict(rctx["c2"], m3=c2["m3"]), workdir)
        tally(xctx["launches"])
        kernels += measure_mesh(dev, xctx)
        xctx = None
        lap("12 mesh")
        dctx = run_dml(dev, c2, workdir, card)
        tally(dctx["launches"])
        for k in kernels:  # the DML phase's path runs K1, K8-K11 and the tail apply
            k["launches"] += dctx["launches"].get(k["name"], 0)
        dctx = c2 = None
        lap("13 DML")
        with conf.set_temporarily(**{"delta.tpu.stateCache.devicePlan.mode": "force"}):
            pctx = run_c6p(dev, workdir, card)
        state_cache.DeviceStateCache.reset()
        lap("14a config 6p")
        qctx = run_partitioned(dev, workdir, card)
        lap("14b store_sales by date")
        for k in kernels:  # phase 14: K1 and the tail apply (6p); K1, K8-K11, K14, K16
            k["launches"] += (pctx["launches"].get(k["name"], 0)
                              + qctx["launches"].get(k["name"], 0))
        tally(pctx["launches"])
        tally(qctx["launches"])
        pctx = qctx = None
        with conf.set_temporarily(**{"delta.tpu.stateCache.devicePlan.mode": "force"}):
            dectx = run_decimal(dev, workdir, card)
        lap("15a store_sales in TPC-DS types")
        nctx = run_nested(dev, workdir, card)
        lap("15b nested")
        for k in kernels:  # phase 15: K1, K8-K11, K14, K15, K16; K1, K8-K10
            k["launches"] += (dectx["launches"].get(k["name"], 0)
                              + nctx["launches"].get(k["name"], 0))
        tally(dectx["launches"])
        tally(nctx["launches"])
        dectx = nctx = None
        key_cache.KeyCache.reset()
        torch.cuda.empty_cache()
        actx = run_table_api(dev, workdir, card)
        lap("16b-d table API")
        for k in kernels:  # phase 16: K1 (16a); K1, K8-K10, K14 and the rest of 16b-d
            k["launches"] += pq_ctx["launches"].get(k["name"], 0) + actx["launches"].get(
                k["name"], 0)
        tally(pq_ctx["launches"])
        tally(actx["launches"])
        actx = pq_ctx = None
        key_cache.KeyCache.reset()
        torch.cuda.empty_cache()
        wctx = run_write_semantics(dev, workdir, card)
        lap("17 write semantics")
        for k in kernels:  # phase 17: K8-K11 (the MERGE), K15 (the DML's candidates)
            k["launches"] += wctx["launches"].get(k["name"], 0)
        tally(wctx["launches"])
        wctx = None
    say(f"page codec: launches on every phase's path {codec}")
    for k in CODEC_KERNELS:
        check(codec[k] > 0, f"kernel {k} was launched on no phase's path")
    kernels += codec_rows(dev, codec)
    lap("codec rows")
    say(f"phases (wall s): {laps}, {sum(laps.values()):.1f} s in all | {card}")
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

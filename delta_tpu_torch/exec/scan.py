"""Scan executor: AddFiles -> ``HostTable`` (the port's own copy of
``delta_tpu.exec.scan``'s ``read_files_as_table``, ``scan_files``,
``scan_to_table`` and the batched planner ``plan_scans``).

Decode each file's data columns through the port's Parquet codec
(``exec/parquet``), drop the rows its deletion vector marks, fill the
columns a file predates with NULL, materialize the partition columns from
``add.partitionValues`` (typed through ``expr/partition.typed_partition_row``:
NULL where the value is NULL or fails to cast), cast each column up to the
table's declared type, return the columns in the requested order, and
optionally attach each row's PHYSICAL position in its file. A projection of
partition columns only decodes no column and carries the row count.

A scan's read goes through three tiers, as in the JAX package: the file
tier (``ops/pruning.files_for_scan``), the row-group tier inside each file
(``exec/rowgroups``: footer statistics, then late materialization — the
predicate's columns decode first and the other columns only for row groups
with a possible match) and, where the residual lowers, the device residual
(``ops/column_cache``): per-file Kleene-TRUE row masks computed on the card
(K14), so row groups whose mask is all False never decode and the rest are
filtered to the mask. ``scan_to_table`` re-applies the residual on the host
over what survives, so every tier only changes what decodes, never what
returns.

Left out: the decode thread pool, the scan journal and the fired-rewrite
attribution.
"""
from __future__ import annotations

import datetime as _dt
import os
import time
import urllib.parse
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from delta_tpu_torch.exec import rowgroups
from delta_tpu_torch.exec.parquet import column_names, read_parquet_batch, read_parquet_file
from delta_tpu_torch.expr import ir
from delta_tpu_torch.expr.nested import ncol_from_py
from delta_tpu_torch.expr.parser import parse_predicate
from delta_tpu_torch.expr.partition import typed_partition_row
from delta_tpu_torch.expr.vectorized import (
    HostColumn, HostTable, boolean_mask, cast_column, concat_tables, filter_table, null_column,
    stored_type,
)
from delta_tpu_torch.obs import scan_report
from delta_tpu_torch.ops import pruning
from delta_tpu_torch.protocol.actions import AddFile
from delta_tpu_torch.schema import schema_utils
from delta_tpu_torch.utils import telemetry
from delta_tpu_torch.utils.config import conf

__all__ = ["read_files_as_table", "scan_files", "scan_to_table", "QueryPlan", "plan_scans"]

#: the stored bytes of consecutive whole-file reads whose pages inflate in one
#: batch (``exec/parquet.read_parquet_batch``): one launch set a group, not a file
_BATCH_BYTES = 64 << 20


def _abs_data_path(data_path: str, file_path: str) -> str:
    if "://" in file_path or os.path.isabs(file_path):
        return urllib.parse.unquote(file_path)
    return os.path.join(data_path, urllib.parse.unquote(file_path).replace("/", os.sep))


def _read_types(schema, names) -> Dict[str, tuple]:
    """(kind, stored type) of each schema field in ``names``: only the
    columns a read touches are typed, so a column type the port cannot
    decode blocks only the reads that need it."""
    out = {}
    for f in schema.fields:
        if f.name not in names:
            continue
        try:
            out[f.name] = schema_utils.stored_type_for(f.data_type)
        except NotImplementedError:
            raise NotImplementedError(
                f"reading column {f.name!r} of type {f.data_type.simple_string()} "
                "is not ported") from None
    return out


def _empty(metadata, out_names: Sequence[str]) -> HostTable:
    declared = _read_types(metadata.schema, set(out_names))
    return HostTable({f.name: null_column(0, *declared[f.name])
                      for f in metadata.schema.fields if f.name in declared}, 0)


def _constant_column(value, kind: str, stype: str, n: int) -> HostColumn:
    """A partition value (as ``typed_partition_row`` types it) repeated over
    ``n`` rows, in the column's declared type."""
    if value is None:
        return null_column(n, kind, stype)
    if kind == "date":
        v = np.full(n, (value - _dt.date(1970, 1, 1)).days, np.int64)
    elif kind == "ts":
        v = np.full(n, (value - _dt.datetime(1970, 1, 1)) // _dt.timedelta(microseconds=1),
                    np.int64)
    elif kind in ("str", "object"):
        v = np.empty(n, object)
        v.fill(value)
    elif kind == "decimal":
        return HostColumn(kind, ncol_from_py(stype, [value] * n).values, np.ones(n, bool), stype)
    else:
        v = np.full(n, value, {"bool": bool, "int": np.int64, "double": np.float64}[kind])
    return cast_column(HostColumn(kind, v, np.ones(n, bool)), kind, stype)


def _group_rows(offsets: np.ndarray, groups: Sequence[int]) -> np.ndarray:
    """The physical rows of ``groups``, in order."""
    if not groups:
        return np.empty(0, np.int64)
    return np.concatenate([np.arange(offsets[i], offsets[i + 1], dtype=np.int64)
                           for i in groups])


def read_files_as_table(data_path: str, files: Sequence[AddFile], metadata,
                        columns: Optional[Sequence[str]] = None, per_file: bool = False,
                        position_column: Optional[str] = None, predicate=None,
                        late_materialize: bool = True, file_ready=None,
                        device_masks: Optional[Dict[str, np.ndarray]] = None,
                        device="cuda"):
    """Decode AddFiles to one ``HostTable`` (or, ``per_file=True``, one per
    file in ``files`` order). Rows a file's deletion vector marks are
    dropped; ``position_column`` attaches each row's physical position
    (int64). ``file_ready(index, add, table)`` is called as each file's
    table completes; an exception from it fails the read.

    ``predicate`` turns on the row-group tier (``delta.tpu.read.
    rowGroupSkipping``): row groups whose footer statistics cannot match
    skip decode, and the survivors late-materialize around the predicate's
    columns. Rows within surviving groups are NOT filtered: callers pass a
    predicate only where they re-filter or never consume the rows outside
    it. ``device_masks`` ({add.path: bool mask over the file's physical
    rows}, from ``ops/column_cache.device_residual_masks``) switches masked
    files to the device path: groups whose mask slice is all False skip
    decode, the rest decode once and ARE filtered to the mask, so only a
    caller that re-applies the residual may pass it. Positions stay
    physical throughout: deletion vectors and masks both index physical
    rows, and compose before any filter. SNAPPY pages inflate on
    ``device`` (the table's ``DeltaLog``'s): the consecutive files that
    decode whole (one row group or no predicate, no device mask) or by
    their device mask's surviving groups share one batch for up to
    ``_BATCH_BYTES`` stored bytes of them; a file decoded by its row-group
    plan takes a batch a decode."""
    from delta_tpu_torch.protocol.deletion_vectors import (
        DeletionVectorDescriptor, read_deletion_vector,
    )

    schema = metadata.schema
    part_cols = list(metadata.partition_columns)
    part_schema = metadata.partition_schema
    pcols_lower = frozenset(c.lower() for c in part_cols)
    out_names = list(columns) if columns is not None else [f.name for f in schema.fields]
    data_cols = [c for c in out_names if c not in part_cols]
    pred_refs = (frozenset(r.lower() for r in ir.references(predicate))
                 if predicate is not None else frozenset())
    # the projection and the predicate's columns: nothing else is typed
    declared = _read_types(schema, set(out_names) | {f.name for f in schema.fields
                                                      if f.name.lower() in pred_refs})
    total_bytes = sum(f.size or 0 for f in files)
    telemetry.bump_counter("scan.files.read", len(files))
    telemetry.bump_counter("scan.bytes.read", total_bytes)
    scan_report.contribute(bytes_read=total_bytes)
    if not files:
        return [] if per_file else _empty(metadata, out_names)

    rg_skipping = conf.get_bool("delta.tpu.read.rowGroupSkipping", True)
    pred_rewrites = None
    if predicate is not None:
        from delta_tpu_torch.expr.synthesis import schema_types

        # scan-constant: the row-group planner's rewrite, computed once
        pred_rewrites = pruning.conjunct_rewrites([predicate], pcols_lower,
                                                  schema_types(metadata))
    # per file: (groups, pruned, late skipped, bytes planned away, bytes late
    # skipped, groups device skipped, bytes device skipped, survivor bytes)
    rg_stats: List[tuple] = []

    def _mask_table(t1: HostTable, const_row) -> HostTable:
        """``t1`` plus a NULL column for each predicate column the file
        predates and the file's typed partition constants: the table the
        residual filter will see, so the late verdict cannot diverge from
        it."""
        for f in schema.fields:
            if f.name.lower() in pred_refs and f.name not in t1.columns:
                kind, stype = declared[f.name]
                t1 = t1.append_column(
                    f.name, _constant_column(const_row.get(f.name) if f.name in part_cols
                                             else None, kind, stype, t1.num_rows))
        return t1

    def _decode_pruned(abs_path, meta, keep_idx, file_cols, present, need_positions,
                       const_row):
        """Decode only ``keep_idx`` (late-materializing around the predicate
        columns): (table, physical positions or None, late-skipped groups,
        late-skipped bytes)."""
        offsets = rowgroups.row_group_offsets(meta)
        late_skipped = late_bytes = 0
        pred_cols = [c for c in file_cols if c.lower() in pred_refs]
        rest_cols = [c for c in file_cols if c not in pred_cols]
        # a predicate column stored in the file but outside the projection
        # would mask as all NULL and late-skip groups that match
        refs_covered = not (pred_refs & {c.lower() for c in present}
                            - {c.lower() for c in file_cols})
        t = None
        if keep_idx and late_materialize and refs_covered and pred_cols and rest_cols:
            t1 = read_parquet_file(abs_path, pred_cols, row_groups=keep_idx, meta=meta,
                                   device=device)
            try:
                mask = boolean_mask(predicate, _mask_table(t1, const_row))
            except Exception:
                mask = None  # unevaluable here: keep every group
            if mask is not None:
                survivors, rows = [], []
                start = 0
                for i in keep_idx:
                    n_i = int(meta.row_groups[i].num_rows)
                    if mask[start:start + n_i].any():
                        survivors.append(i)
                        rows.append(np.arange(start, start + n_i))
                    else:
                        late_skipped += 1
                        rg = meta.row_groups[i]
                        late_bytes += sum(
                            int(ch.meta_data.total_uncompressed_size) for ch in rg.columns
                            if ch.meta_data.path_in_schema[0] in rest_cols)
                    start += n_i
                if late_skipped:
                    t1 = t1.take(np.concatenate(rows) if rows else np.empty(0, np.int64))
                    keep_idx = survivors
            t2 = read_parquet_file(abs_path, rest_cols, row_groups=keep_idx, meta=meta,
                                   device=device)
            cols = dict(t1.columns)
            cols.update(t2.columns)
            t = HostTable({c: cols[c] for c in file_cols}, t1.num_rows)
        if t is None:
            t = read_parquet_file(abs_path, file_cols, row_groups=keep_idx, meta=meta,
                                  device=device)
        pos = _group_rows(offsets, keep_idx) if need_positions else None
        return t, pos, late_skipped, late_bytes

    def _device_survivors(abs_path, meta, keep_idx, dev_mask):
        """The groups of ``keep_idx`` whose mask slice holds a survivor:
        (survivors, (groups skipped, bytes skipped, survivor bytes))."""
        offsets = rowgroups.row_group_offsets(meta)
        if len(dev_mask) != offsets[-1]:
            raise ValueError(f"{abs_path}: a device mask of {len(dev_mask)} rows for a "
                             f"file of {int(offsets[-1])} rows")
        survivors = []
        dev_skipped = dev_bytes = surv_bytes = 0
        for i in keep_idx:
            size = int(meta.row_groups[i].total_byte_size)
            if dev_mask[offsets[i]:offsets[i + 1]].any():
                survivors.append(i)
                surv_bytes += size
            else:
                dev_skipped += 1
                dev_bytes += size
        return survivors, (dev_skipped, dev_bytes, surv_bytes)

    def _decode_device_masked(abs_path, meta, survivors, file_cols, need_positions, dev_mask,
                              pre: Optional[HostTable]):
        """The device path's survivor fetch: the surviving groups (``pre``
        where the batch decoded them) filtered to the mask: (table,
        positions or None)."""
        offsets = rowgroups.row_group_offsets(meta)
        t = pre if pre is not None else read_parquet_file(
            abs_path, file_cols, row_groups=survivors, meta=meta, device=device)
        phys = _group_rows(offsets, survivors)
        keep = dev_mask[phys]
        t = t.filter(keep)
        pos = phys[keep] if need_positions else None
        return t, pos

    def _plan(meta, part_row):
        """The row-group tier's plan of a file: (groups kept, bytes planned
        away)."""
        if len(meta.row_groups or []) > 1:
            plan = rowgroups.plan_row_groups(meta, predicate, part_row or None,
                                             pcols_lower, rewrites=pred_rewrites)
            return plan.keep, plan.skipped_bytes
        return list(range(len(meta.row_groups or []))), 0

    def whole(add: AddFile):
        """(path, footer, columns, the row groups a batch may decode, the
        device plan): a file read with no row-group plan (a single group,
        or no predicate) and no device mask decodes whole (``None``), a
        file with a device mask its surviving groups (the plan is then
        ``(groups kept, bytes planned away, survivors, device stats)``);
        both share a batch. Other planned files decode alone (``False``)."""
        abs_path = _abs_data_path(data_path, add.path)
        meta = rowgroups.read_footer(abs_path)
        present = column_names(meta)
        n_rg = len(meta.row_groups or [])
        dev_mask = device_masks.get(add.path) if device_masks else None
        planned = (rg_skipping and predicate is not None and n_rg
                   and (n_rg > 1 or dev_mask is not None))
        cols_ = [c for c in data_cols if c in present]
        if not planned:
            return abs_path, meta, cols_, None, None
        if dev_mask is None:
            return abs_path, meta, cols_, False, None
        keep_idx, skipped_bytes = _plan(
            meta, typed_partition_row(add, part_schema) if part_cols else {})
        survivors, dstats = _device_survivors(abs_path, meta, keep_idx, dev_mask)
        return abs_path, meta, cols_, survivors, (keep_idx, skipped_bytes, survivors, dstats)

    def read_one(fidx: int, add: AddFile, meta, pre: Optional[HostTable],
                 dplan) -> HostTable:
        abs_path = _abs_data_path(data_path, add.path)
        present = column_names(meta)
        file_cols = [c for c in data_cols if c in present]
        part_row = typed_partition_row(add, part_schema) if part_cols else {}
        # the materialized constants: decimals exact, not through a float
        const_row = (typed_partition_row(add, part_schema, exact_decimals=True)
                     if part_cols else {})
        need_positions = add.deletion_vector is not None or position_column is not None
        t = positions = None
        n_rg = len(meta.row_groups or [])
        if rg_skipping and predicate is not None and n_rg:
            dev_mask = device_masks.get(add.path) if device_masks else None
            if dev_mask is not None:
                keep_idx, skipped_bytes, survivors, dstats = dplan
            else:
                keep_idx, skipped_bytes = _plan(meta, part_row)
            pruned = n_rg - len(keep_idx)
            late_capable = late_materialize and keep_idx and pred_refs and n_rg > 1
            if dev_mask is not None:
                t, positions = _decode_device_masked(
                    abs_path, meta, survivors, file_cols, need_positions, dev_mask, pre)
                rg_stats.append((n_rg, pruned, 0, skipped_bytes, 0) + dstats)
            elif pruned or late_capable:
                t, positions, late_n, late_bytes = _decode_pruned(
                    abs_path, meta, keep_idx, file_cols, present, need_positions, const_row)
                rg_stats.append((n_rg, pruned, late_n, skipped_bytes, late_bytes, 0, 0, 0))
            else:
                rg_stats.append((n_rg, 0, 0, 0, 0, 0, 0, 0))
        if t is None:
            t = pre if pre is not None else read_parquet_file(abs_path, file_cols, meta=meta,
                                                              device=device)
        if add.deletion_vector is not None:
            dv_rows = read_deletion_vector(DeletionVectorDescriptor.from_dict(add.deletion_vector),
                                           data_path).astype(np.int64)
            if positions is None:
                keep = np.ones(t.num_rows, dtype=bool)
                keep[dv_rows] = False
                positions = np.flatnonzero(keep)
            else:
                # a pruned or masked decode: positions are physical but
                # sparse, so the DV maps through membership
                keep = ~np.isin(positions, dv_rows)
                positions = positions[keep]
            t = t.filter(keep)
        elif position_column is not None and positions is None:
            positions = np.arange(t.num_rows, dtype=np.int64)
        cols = {}
        for name in out_names:
            if name not in declared:
                continue
            kind, stype = declared[name]
            col = t.columns.get(name)
            if name in part_cols:
                cols[name] = _constant_column(const_row.get(name), kind, stype, t.num_rows)
            elif col is None:
                cols[name] = null_column(t.num_rows, kind, stype)
            elif col.kind != kind or stored_type(col) != stype:
                # a file written before a type widening carries the old type
                cols[name] = cast_column(col, kind, stype)
            else:
                cols[name] = col
        if position_column is not None:
            cols[position_column] = HostColumn("int", positions.astype(np.int64),
                                               np.ones(len(positions), bool))
        t = HostTable(cols, t.num_rows)
        if file_ready is not None:
            file_ready(fidx, add, t)
        return t

    # files that decode whole, and the device-masked files' surviving
    # groups, go in groups of up to _BATCH_BYTES stored bytes, each group's
    # pages inflating in one batch; the rest a file at a time
    out: List[HostTable] = []
    i = 0
    while i < len(files):
        group, size = [], 0
        while i < len(files) and (not group or size < _BATCH_BYTES):
            abs_path, meta, cols_, rgs, dplan = whole(files[i])
            group.append((i, abs_path, meta, cols_, rgs, dplan))
            size += sum(int(rg.total_compressed_size or 0) for rg in meta.row_groups or [])
            i += 1
        batch = [g for g in group if g[4] is not False]
        pre = dict(zip([g[0] for g in batch], read_parquet_batch(
            [(p, c, rgs, m) for _, p, m, c, rgs, _ in batch], device)))
        out.extend(read_one(j, files[j], m, pre.pop(j, None), dp)
                   for j, _, m, _, _, dp in group)
    if rg_stats:
        s = np.asarray([r for r in rg_stats], np.int64).sum(axis=0)
        rg_total, rg_pruned, rg_late, planned, late_bytes, rg_dev, dev_bytes, survivor = \
            (int(v) for v in s)
        bytes_skipped = planned + late_bytes + dev_bytes
        telemetry.bump_counter("scan.rowgroups.total", rg_total)
        for name, v in (("scan.rowgroups.pruned", rg_pruned),
                        ("scan.rowgroups.lateSkipped", rg_late),
                        ("scan.rowgroups.deviceSkipped", rg_dev),
                        ("scan.bytes.skipped", bytes_skipped),
                        ("scan.bytes.deviceSkipped", dev_bytes),
                        ("scan.bytes.deviceSurvivor", survivor)):
            if v:
                telemetry.bump_counter(name, v)
        scan_report.contribute(
            row_groups_total=rg_total, row_groups_pruned=rg_pruned,
            row_groups_late_skipped=rg_late, bytes_skipped=bytes_skipped,
            bytes_skipped_planned=planned, row_groups_device_skipped=rg_dev,
            bytes_device_skipped=dev_bytes, bytes_device_survivor=survivor)
    return out if per_file else concat_tables(out)


def scan_files(snapshot, filters: Sequence[Union[str, ir.Expression]] = ()) -> pruning.DeltaScan:
    exprs = [parse_predicate(f) if isinstance(f, str) else f for f in filters]
    return pruning.files_for_scan(snapshot, exprs)


@dataclass
class QueryPlan:
    """One query's pruned file list from :func:`plan_scans`. ``overflow``
    marks a query whose match set exceeded k (``paths`` holds the first k;
    ``count`` stays exact); ``via`` is the route that planned it
    ('device', 'device-sharded', 'host-resident', 'verdict', or 'scan' for
    the per-query fallback)."""

    paths: List[str]
    count: int
    overflow: bool = False
    via: str = "scan"


def plan_scans(snapshot, queries: Sequence[Sequence[Union[str, ir.Expression]]],
               k: int = 256) -> List[QueryPlan]:
    """Plan a batch of queries (each a list of filters) against one
    snapshot. With the table's scan lanes resident (``ops/state_cache``)
    the queries that lower to range boxes are one ``plan_ranges`` call for
    the whole batch: one block cull (K1; K7 over a state mesh) and one
    download. A query that does not lower, or a batch whose entry has moved
    past the snapshot, falls back to ``files_for_scan`` query by query."""
    from delta_tpu_torch.expr.synthesis import schema_types
    from delta_tpu_torch.ops.state_cache import DeviceStateCache, extract_range_union

    parsed = [[parse_predicate(f) if isinstance(f, str) else f for f in q] for q in queries]
    out: List[Optional[QueryPlan]] = [None] * len(queries)
    entry = DeviceStateCache.instance().get(snapshot)
    range_ix, term_lists = [], []
    if entry is not None:
        pcols = frozenset(c.lower() for c in snapshot.metadata.partition_columns)
        types = schema_types(snapshot.metadata)
        for i, exprs in enumerate(parsed):
            if not exprs:
                continue
            rewritten = pruning.skipping_predicate(ir.and_all(list(exprs)), pcols, types)
            terms = extract_range_union(rewritten, entry.columns, entry.part_info,
                                        str_lanes=entry.str_lanes)
            if terms:
                range_ix.append(i)
                term_lists.append(terms)
            else:
                telemetry.bump_counter("stateCache.plan.fallback.lowering")
    else:
        telemetry.bump_counter("stateCache.plan.fallback.noentry", len(queries))
    if term_lists:
        # an OR's boxes union after the plan, so they ask for complete row
        # sets; a single-box query keeps k
        flat, flat_ks = [], []
        full_k = max(entry.num_rows, 1)
        for terms in term_lists:
            flat.extend(terms)
            flat_ks.extend([k if len(terms) == 1 else full_k] * len(terms))
        plans = entry.plan_ranges(flat, k=flat_ks, expected_version=snapshot.version)
        if plans is not None:  # None: the entry advanced past the snapshot
            telemetry.bump_counter("stateCache.plan.resident", len(term_lists))
            pos = 0
            for i, terms in zip(range_ix, term_lists):
                chunk = plans[pos:pos + len(terms)]
                pos += len(terms)
                if len(chunk) == 1:
                    rows, count = chunk[0].rows, chunk[0].count
                else:
                    rows = np.unique(np.concatenate([p.rows for p in chunk]))
                    count = len(rows)
                out[i] = QueryPlan(paths=[entry.paths[r] for r in rows[:k]], count=int(count),
                                   overflow=bool(count > k or chunk[0].overflow),
                                   via=chunk[0].via)
        else:
            telemetry.bump_counter("stateCache.plan.fallback.version", len(term_lists))
    for i, exprs in enumerate(parsed):
        if out[i] is None:
            scan = pruning.files_for_scan(snapshot, exprs)
            out[i] = QueryPlan(paths=[f.path for f in scan.files], count=len(scan.files))
    return out  # type: ignore[return-value]


def scan_to_table(snapshot, filters: Sequence[Union[str, ir.Expression]] = (),
                  columns: Optional[Sequence[str]] = None) -> HostTable:
    """The full read path: prune the files, compute the device residual
    masks where the residual lowers, decode (projection plus the filters'
    columns), apply the residual filter, project. Each call records a
    :class:`~delta_tpu_torch.obs.scan_report.ScanReport`
    (``obs.scan_report.last_scan_report()``)."""
    from delta_tpu_torch.ops import column_cache

    token = scan_report.start_report(snapshot.delta_log.data_path, snapshot.version)
    ok = False
    try:
        t0 = time.perf_counter_ns()
        scan = scan_files(snapshot, filters)
        t1 = time.perf_counter_ns()
        residual = scan.partition_filters + scan.data_filters
        pred = ir.and_all(residual) if residual else None
        read_cols = columns
        if columns is not None and residual:
            needed = set(columns)
            for e in residual:
                needed.update(ir.references(e))
            read_cols = [c for c in [f.name for f in snapshot.metadata.schema.fields]
                         if c in needed]
        device_masks = None
        if residual and scan.files:
            device_masks = column_cache.device_residual_masks(snapshot, scan.files, pred)
        table = read_files_as_table(snapshot.delta_log.data_path, scan.files, snapshot.metadata,
                                    read_cols, predicate=pred, device_masks=device_masks,
                                    device=snapshot.delta_log.device)
        t2 = time.perf_counter_ns()
        if residual and table.num_rows:
            table = filter_table(table, pred)
        if columns is not None and read_cols != list(columns):
            table = table.select([c for c in columns if c in table.columns])
        t3 = time.perf_counter_ns()
        rep = scan_report.current_report()
        rep.predicate = pred.sql() if pred is not None else None
        rep.columns = list(columns) if columns is not None else None
        rep.files_total = scan.total.files or 0
        rep.files_after_partition = scan.partition.files or 0
        rep.files_scanned = len(scan.files)
        rep.rows_out = table.num_rows
        rep.phase_ms = {"planning": (t1 - t0) // 1_000_000, "read": (t2 - t1) // 1_000_000,
                        "filter": (t3 - t2) // 1_000_000}
        ok = True
        return table
    finally:
        scan_report.finish_report(token, completed=ok)

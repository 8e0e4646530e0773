"""Scan executor: AddFiles -> ``HostTable`` (the port's own copy of
``delta_tpu.exec.scan``'s ``read_files_as_table`` and ``scan_to_table``,
unpartitioned).

Decode each file through the port's Parquet codec (``exec/parquet``), drop
the rows its deletion vector marks, fill the columns a file predates with
NULL, cast each column up to the table's declared type, and optionally
attach each row's PHYSICAL position in its file.

Left out: partitioned tables (``NotImplementedError``); row-group skipping
and late materialization — the ``predicate`` and ``late_materialize``
arguments are accepted and every row group decodes, which is
result-identical because callers re-filter or never consume the rows a
pruned group would drop; the device residual masks of the column cache.
"""
from __future__ import annotations

import os
import urllib.parse
from typing import List, Optional, Sequence, Union

import numpy as np

from delta_tpu_torch.exec.parquet import column_names, read_metadata, read_parquet_file
from delta_tpu_torch.expr import ir
from delta_tpu_torch.expr.parser import parse_predicate
from delta_tpu_torch.expr.vectorized import (
    HostColumn, HostTable, cast_column, concat_tables, filter_table, null_column, stored_type,
)
from delta_tpu_torch.ops import pruning
from delta_tpu_torch.protocol.actions import AddFile
from delta_tpu_torch.schema import schema_utils

__all__ = ["read_files_as_table", "scan_to_table"]


def _abs_data_path(data_path: str, file_path: str) -> str:
    if "://" in file_path or os.path.isabs(file_path):
        return urllib.parse.unquote(file_path)
    return os.path.join(data_path, urllib.parse.unquote(file_path).replace("/", os.sep))


def _empty(metadata, out_names: Sequence[str]) -> HostTable:
    cols = {}
    for f in metadata.schema.fields:
        if f.name in out_names:
            kind, stype = schema_utils.stored_type_for(f.data_type)
            cols[f.name] = null_column(0, kind, stype)
    return HostTable(cols, 0)


def read_files_as_table(data_path: str, files: Sequence[AddFile], metadata,
                        columns: Optional[Sequence[str]] = None, per_file: bool = False,
                        position_column: Optional[str] = None, predicate=None,
                        late_materialize: bool = True, file_ready=None):
    """Decode AddFiles to one ``HostTable`` (or, ``per_file=True``, one per
    file in ``files`` order). Rows a file's deletion vector marks are
    dropped; ``position_column`` attaches each row's physical position
    (int64). ``file_ready(index, add, table)`` is called as each file's
    table completes; an exception from it fails the read."""
    from delta_tpu_torch.protocol.deletion_vectors import (
        DeletionVectorDescriptor, read_deletion_vector,
    )

    if metadata.partition_columns:
        raise NotImplementedError("reading a partitioned table is not ported")
    schema = metadata.schema
    out_names = list(columns) if columns is not None else [f.name for f in schema.fields]
    declared = {f.name: schema_utils.stored_type_for(f.data_type) for f in schema.fields}
    if not files:
        return [] if per_file else _empty(metadata, out_names)
    out: List[HostTable] = []
    for fidx, add in enumerate(files):
        abs_path = _abs_data_path(data_path, add.path)
        present = set(column_names(read_metadata(abs_path)))
        file_cols = [c for c in out_names if c in present]
        t = read_parquet_file(abs_path, file_cols)
        n_phys = t.num_rows
        positions = None
        if add.deletion_vector is not None:
            dv_rows = read_deletion_vector(DeletionVectorDescriptor.from_dict(add.deletion_vector),
                                           data_path)
            keep = np.ones(n_phys, dtype=bool)
            keep[dv_rows.astype(np.int64)] = False
            positions = np.flatnonzero(keep)
            t = t.filter(keep)
        elif position_column is not None:
            positions = np.arange(n_phys, dtype=np.int64)
        cols = {}
        for name in out_names:
            if name not in declared:
                continue
            kind, stype = declared[name]
            col = t.columns.get(name)
            if col is None:
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
        out.append(t)
    return out if per_file else concat_tables(out)


def scan_to_table(snapshot, filters: Sequence[Union[str, ir.Expression]] = (),
                  columns: Optional[Sequence[str]] = None) -> HostTable:
    """The full read path: prune the files (``files_for_scan``), decode
    (projection plus the filters' columns), apply the residual filter,
    project: the table's live rows."""
    exprs = [parse_predicate(f) if isinstance(f, str) else f for f in filters]
    scan = pruning.files_for_scan(snapshot, exprs)
    residual = scan.partition_filters + scan.data_filters
    read_cols = columns
    if columns is not None and residual:
        needed = set(columns)
        for e in residual:
            needed.update(ir.references(e))
        read_cols = [c for c in [f.name for f in snapshot.metadata.schema.fields] if c in needed]
    table = read_files_as_table(snapshot.delta_log.data_path, scan.files, snapshot.metadata,
                                read_cols)
    if residual and table.num_rows:
        table = filter_table(table, ir.and_all(residual))
    if columns is not None and read_cols != list(columns):
        table = table.select([c for c in columns if c in table.columns])
    return table

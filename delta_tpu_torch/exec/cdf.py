"""Change data feed: per-commit row-level change capture (the port's own
copy of ``delta_tpu.exec.cdf``).

* Write side: DML on a table with ``delta.enableChangeDataFeed=true``
  stages change rows (``_change_type`` of insert, delete,
  update_preimage, update_postimage) that commit as one Parquet file under
  ``_change_data/``, logged by an ``AddCDCFile`` (``dataChange=false``, so
  it never enters the table state). The file goes through the port's
  Parquet writer, its SNAPPY pages through the page codec on the table's
  device.
* Read side: :func:`read_changes` returns the changes between two versions
  with ``_change_type``, ``_commit_version`` and ``_commit_timestamp``. A
  commit without CDC files is rebuilt from its file actions: adds with
  ``dataChange`` are inserts, removes of dropped files are deletes (read
  through the tombstone's deletion vector), and a deletion-vector re-add
  is the delete of the newly marked positions (the old and new vectors'
  difference).

Tables whose columns differ (an evolved schema) concatenate as Arrow's
``promote_options="permissive"`` does: the first-seen column order, NULLs
where a part lacks a column.
"""
from __future__ import annotations

import os
import uuid
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from delta_tpu_torch.exec import parquet as pq_exec
from delta_tpu_torch.exec.scan import read_files_as_table
from delta_tpu_torch.expr.vectorized import HostColumn, HostTable, concat_tables
from delta_tpu_torch.protocol import deletion_vectors as dv_mod
from delta_tpu_torch.protocol.actions import AddCDCFile, AddFile, RemoveFile
from delta_tpu_torch.utils import errors
from delta_tpu_torch.utils.config import DeltaConfigs

__all__ = ["CHANGE_TYPE_COL", "COMMIT_VERSION_COL", "COMMIT_TIMESTAMP_COL", "CDC_DIR",
           "cdf_enabled", "write_change_data", "read_changes", "empty_changes",
           "concat_permissive", "constant_column"]

CHANGE_TYPE_COL = "_change_type"
COMMIT_VERSION_COL = "_commit_version"
COMMIT_TIMESTAMP_COL = "_commit_timestamp"
CDC_DIR = "_change_data"
_POSITION_COL = "__cdf_pos__"


def cdf_enabled(metadata) -> bool:
    return bool(DeltaConfigs.CHANGE_DATA_FEED.from_metadata(metadata))


def constant_column(value, n: int) -> HostColumn:
    """``n`` rows of one string or int64 value: a change row's type,
    version or timestamp."""
    if isinstance(value, str):
        vals = np.empty(n, object)
        vals[:] = value
        return HostColumn("str", vals, np.ones(n, bool))
    return HostColumn("int", np.full(n, value, np.int64), np.ones(n, bool))


def concat_permissive(tables: Sequence[HostTable]) -> HostTable:
    """Row-wise concatenation over the union of the tables' columns (first
    seen order); a part without a column holds NULLs there."""
    names: Dict[str, None] = {}
    for t in tables:
        for c in t.column_names:
            names.setdefault(c, None)
    full = []
    for t in tables:
        cols = {}
        for c in names:
            cols[c] = (t.columns[c] if c in t.columns else
                       HostColumn("null", np.zeros(t.num_rows, np.int64), np.zeros(t.num_rows, bool)))
        full.append(HostTable(cols, t.num_rows))
    return concat_tables(full)


def write_change_data(data_path: str, blocks: Sequence[Tuple[str, HostTable]], metadata,
                      device="cuda") -> List[AddCDCFile]:
    """Write change blocks ``(change_type, rows)`` as one CDC Parquet file.
    Its rows hold every table column (partition columns too: a CDC file is
    self-contained) and ``_change_type``."""
    target_cols = [f.name for f in metadata.schema.fields]
    parts: List[HostTable] = []
    for change_type, rows in blocks:
        if rows is None or rows.num_rows == 0:
            continue
        t = rows.select([c for c in target_cols if c in rows.columns])
        parts.append(t.append_column(CHANGE_TYPE_COL, constant_column(change_type, t.num_rows)))
    if not parts:
        return []
    out = concat_permissive(parts)
    name = f"cdc-{uuid.uuid4()}.c000.snappy.parquet"
    size, _ = pq_exec.write_parquet_file(out, os.path.join(data_path, CDC_DIR, name),
                                         device=device)
    return [AddCDCFile(path=f"{CDC_DIR}/{name}", partition_values={}, size=size)]


def _read_file_rows(delta_log, add_like, metadata, dv_dict=None,
                    position_column: Optional[str] = None) -> HostTable:
    """A data file's rows as they were live under ``dv_dict``."""
    add = AddFile(path=add_like.path, partition_values=dict(add_like.partition_values or {}),
                  size=add_like.size or 0, deletion_vector=dv_dict)
    [t] = read_files_as_table(delta_log.data_path, [add], metadata, per_file=True,
                              position_column=position_column, device=delta_log.device)
    return t


def _dv_positions(data_path: str, dv_dict) -> np.ndarray:
    if not dv_dict:
        return np.array([], np.uint32)
    return dv_mod.read_deletion_vector(dv_mod.DeletionVectorDescriptor.from_dict(dv_dict),
                                       data_path)


def empty_changes() -> HostTable:
    return HostTable({CHANGE_TYPE_COL: HostColumn("str", np.empty(0, object), np.zeros(0, bool)),
                      COMMIT_VERSION_COL: constant_column(0, 0),
                      COMMIT_TIMESTAMP_COL: constant_column(0, 0)}, 0)


def read_changes(delta_log, starting_version: int,
                 ending_version: Optional[int] = None) -> HostTable:
    """The table's change feed for versions [starting, ending], inclusive."""
    snapshot = delta_log.update()
    if ending_version is None:
        ending_version = snapshot.version
    if starting_version > snapshot.version:
        raise errors.cdf_start_after_latest(starting_version, snapshot.version)
    if starting_version > ending_version:
        raise errors.cdf_start_after_end(starting_version, ending_version)
    # data-loss guard: skipping commits a cleanup removed would hide their
    # deletes and updates from the consumer
    earliest = delta_log.history.get_earliest_delta_file()
    if starting_version < earliest:
        raise errors.cdf_start_unavailable(starting_version, earliest)
    metadata = snapshot.metadata
    target_cols = [f.name for f in metadata.schema.fields]
    commits = {c.version: c.timestamp
               for c in delta_log.history.get_commits(starting_version, ending_version)}
    out_parts: List[HostTable] = []

    def emit(rows: HostTable, change_type: Optional[str], version: int) -> None:
        if rows.num_rows == 0:
            return
        t = rows.select([c for c in rows.column_names
                         if c in target_cols or c == CHANGE_TYPE_COL])
        if change_type is not None:
            t = t.append_column(CHANGE_TYPE_COL, constant_column(change_type, t.num_rows))
        t = t.append_column(COMMIT_VERSION_COL, constant_column(version, t.num_rows))
        t = t.append_column(COMMIT_TIMESTAMP_COL, constant_column(commits.get(version, 0), t.num_rows))
        out_parts.append(t)

    for version, actions in delta_log.get_changes(starting_version):
        if version > ending_version:
            break
        cdc_files = [a for a in actions if isinstance(a, AddCDCFile)]
        if cdc_files:
            paths = [os.path.join(delta_log.data_path, c.path.replace("/", os.sep))
                     for c in cdc_files]
            for t in pq_exec.read_parquet_files(paths, device=delta_log.device):
                emit(t, None, version)
            continue
        # rebuilt from the file actions: this commit wrote no CDC file
        adds = {a.path: a for a in actions if isinstance(a, AddFile) and a.data_change}
        removes = {a.path: a for a in actions if isinstance(a, RemoveFile) and a.data_change}
        for path, add in adds.items():
            rm = removes.get(path)
            if rm is None:
                emit(_read_file_rows(delta_log, add, metadata, add.deletion_vector),
                     "insert", version)
                continue
            # a deletion-vector re-add: the change is the newly marked rows
            newly = np.setdiff1d(_dv_positions(delta_log.data_path, add.deletion_vector),
                                 _dv_positions(delta_log.data_path, rm.deletion_vector))
            if newly.size == 0:
                continue
            t = _read_file_rows(delta_log, add, metadata, position_column=_POSITION_COL)
            emit(t.filter(np.isin(t.column(_POSITION_COL).values, newly)), "delete", version)
        for path, rm in removes.items():
            if path not in adds:
                emit(_read_file_rows(delta_log, rm, metadata, rm.deletion_vector),
                     "delete", version)
    if not out_parts:
        return empty_changes()
    return concat_permissive(out_parts)

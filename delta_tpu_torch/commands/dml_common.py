"""Shared DML machinery (the port's own copy of
``delta_tpu.commands.dml_common``): candidate selection, the candidates'
read with one row mask per file, the phase timer, the position column and
the deletion-vector marking.

A file's match mask is the predicate over its rows with NULL as False
(``expr/vectorized.boolean_mask``), as SQL's WHERE takes it."""
from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import List, Optional, Sequence

import numpy as np

from delta_tpu_torch.exec.scan import read_files_as_table
from delta_tpu_torch.expr import ir
from delta_tpu_torch.expr.vectorized import HostTable, boolean_mask
from delta_tpu_torch.ops import pruning
from delta_tpu_torch.protocol.actions import AddFile

__all__ = ["Timer", "POSITION_COL", "TouchedFile", "candidate_files", "read_candidates",
           "dv_enabled", "dv_mark_deleted", "dv_mark_from_mask", "bump_cache_epochs"]

# physical-row-position column attached to scans when deletion vectors are on
POSITION_COL = "__pos__"


class Timer:
    """Phase timer for operation metrics (scanTimeMs / rewriteTimeMs)."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def lap_ms(self) -> int:
        now = time.perf_counter()
        ms = int((now - self.t0) * 1000)
        self.t0 = now
        return ms

    def lap_ms_f(self) -> float:
        now = time.perf_counter()
        ms = (now - self.t0) * 1000.0
        self.t0 = now
        return ms

    def peek_ms(self) -> int:
        return int((time.perf_counter() - self.t0) * 1000)


def candidate_files(txn, predicate: Optional[ir.Expression]) -> List[AddFile]:
    """Files the predicate may touch; registers the read set on the txn
    (the partition conjuncts as the read predicates, stats skipping through
    ``files_for_scan``)."""
    if predicate is None:
        return txn.filter_files()
    matched = txn.filter_files(ir.split_conjuncts(predicate))
    scan = pruning.files_for_scan(txn.snapshot, [predicate])
    kept_paths = {f.path for f in scan.files}
    return [f for f in matched if f.path in kept_paths]


@dataclass
class TouchedFile:
    add: AddFile
    table: HostTable  # the file's live rows
    mask: np.ndarray  # True = the row matches the predicate


def read_candidates(data_path: str, files: Sequence[AddFile], metadata,
                    predicate: Optional[ir.Expression], with_positions: bool = False,
                    prune_row_groups: bool = False, device="cuda") -> List[TouchedFile]:
    """Read each candidate and compute its match mask.

    ``prune_row_groups=True`` pushes the predicate into the decode, so row
    groups that cannot match never decode (``exec/rowgroups``). Only the
    deletion-vector path may ask for it: it consumes only the matching
    rows, whose physical positions stay right under skipping. The rewrite
    path reads files whole, since the rows of a pruned group are exactly
    the rows it must copy forward."""
    tables = read_files_as_table(
        data_path, files, metadata, per_file=True,
        position_column=POSITION_COL if with_positions else None,
        predicate=predicate if prune_row_groups else None, device=device)
    out: List[TouchedFile] = []
    for add, t in zip(files, tables):
        mask = (np.ones(t.num_rows, bool) if predicate is None
                else boolean_mask(predicate, t))
        out.append(TouchedFile(add=add, table=t, mask=mask))
    return out


def dv_enabled(metadata) -> bool:
    from delta_tpu_torch.utils.config import DeltaConfigs, conf

    if not conf.get_bool("delta.tpu.deletionVectors.enabled", True):
        return False  # session kill switch (forces the rewrite path)
    return bool(DeltaConfigs.ENABLE_DELETION_VECTORS.from_metadata(metadata))


def dv_mark_deleted(data_path: str, add: AddFile, matched_positions):
    """Mark physical row positions deleted through a deletion vector.

    Returns ``(remove, new_add)``: a tombstone for the old entry and a
    re-add of the same path carrying the union of the old DV and
    ``matched_positions``; ``new_add`` is None when every row is gone."""
    from delta_tpu_torch.protocol import deletion_vectors as dv_mod

    matched_positions = np.asarray(matched_positions, dtype=np.uint32)
    if add.deletion_vector is not None:
        old_rows = dv_mod.read_deletion_vector(
            dv_mod.DeletionVectorDescriptor.from_dict(add.deletion_vector), data_path)
        all_rows = np.union1d(old_rows, matched_positions)
    else:
        all_rows = np.unique(matched_positions)
    live = add.num_logical_records
    if live is not None and len(all_rows) >= live:
        return add.remove(), None
    desc = dv_mod.write_deletion_vector(all_rows, data_path)
    return add.remove(), replace(add, deletion_vector=desc.to_dict(), data_change=True)


def dv_mark_from_mask(data_path: str, add: AddFile, table: HostTable, mask: np.ndarray):
    """DV-mark the rows of ``table`` (a :class:`TouchedFile` read with
    positions) that ``mask`` selects; see :func:`dv_mark_deleted`."""
    return dv_mark_deleted(data_path, add, table.column(POSITION_COL).values[mask])


def bump_cache_epochs(log_path: str) -> None:
    """After a file rewrite or rewind (OPTIMIZE, a DELETE or UPDATE that
    rewrites, RESTORE): neither the key slab (``ops/key_cache``) nor a scan
    lane (``ops/column_cache``) of the table's old files may serve a later
    MERGE or scan."""
    from delta_tpu_torch.ops.column_cache import ColumnCache
    from delta_tpu_torch.ops.key_cache import KeyCache

    KeyCache.instance().bump_epoch(log_path)
    ColumnCache.instance().bump_epoch(log_path)

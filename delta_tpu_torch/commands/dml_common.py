"""Shared DML machinery (the port's own copy of part of
``delta_tpu.commands.dml_common``): candidate selection, the phase timer,
the position column and the deletion-vector marking."""
from __future__ import annotations

import time
from dataclasses import replace
from typing import List, Optional

import numpy as np

from delta_tpu_torch.expr import ir
from delta_tpu_torch.ops import pruning
from delta_tpu_torch.protocol.actions import AddFile

__all__ = ["Timer", "POSITION_COL", "candidate_files", "dv_enabled", "dv_mark_deleted"]

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

"""DELETE: predicate-scoped removal or rewrite of files (the port's own copy
of ``delta_tpu.commands.delete``, ``DeleteCommand.scala:92-181``).

Three cases:

1. no predicate: remove every file, read no data, and record a read of
   the whole table (a concurrent append then conflicts);
2. a predicate on partition columns only: remove the files it selects,
   metadata only;
3. a data predicate: find the candidates through ``files_for_scan`` (the
   block cull K1 over the resident lanes, or the skipping interpreter K15
   where the planner declines), read them, and per touched file either
   mark the matching rows in a deletion vector (the table enables them)
   or rewrite its surviving rows.

Metrics and operation are the reference's (``numRemovedFiles``,
``numAddedFiles``, ``numDeletedRows``, ``scanTimeMs``, ``rewriteTimeMs``;
``Delete``). A rewrite bumps the epochs of the key slab
(``ops/key_cache``) and the scan column lanes (``ops/column_cache``);
removes and deletion vectors reach the slab through its incremental
advance at the next MERGE. On a partitioned table case 3's candidates
carry their partition columns and a rewrite's survivors land back in their
own partition. With the change data feed on, case 3's deleted rows go to
one CDC file as ``delete`` (``exec/cdf``); cases 1 and 2 write none (the
feed rebuilds them from the removes). Left out: the span and the journal.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

from delta_tpu_torch.commands import operations as ops
from delta_tpu_torch.commands.dml_common import (
    Timer, bump_cache_epochs, candidate_files, dv_enabled, dv_mark_from_mask, read_candidates,
)
from delta_tpu_torch.exec import cdf
from delta_tpu_torch.exec import write as write_exec
from delta_tpu_torch.expr import ir
from delta_tpu_torch.expr import partition as partition_expr
from delta_tpu_torch.expr.parser import parse_predicate
from delta_tpu_torch.expr.vectorized import HostTable
from delta_tpu_torch.protocol.actions import Action

__all__ = ["DeleteCommand"]


class DeleteCommand:
    def __init__(self, delta_log, condition: Optional[Union[str, ir.Expression]] = None):
        self.delta_log = delta_log
        self.condition = parse_predicate(condition) if isinstance(condition, str) else condition
        self.metrics: Dict[str, int] = {}

    def run(self) -> int:
        return self.delta_log.with_new_transaction(self._body)

    def _body(self, txn) -> int:
        timer = Timer()
        self._rewrote_files = False
        actions = self._perform_delete(txn, timer)
        op = ops.Delete(predicate=[self.condition.sql()] if self.condition is not None else [])
        txn.report_metrics(**self.metrics)
        version = txn.commit(actions, op)
        if self._rewrote_files:
            bump_cache_epochs(self.delta_log.log_path)
        return version

    def _perform_delete(self, txn, timer: Timer) -> List[Action]:
        metadata = txn.metadata
        if self.condition is not None:
            from delta_tpu_torch.schema.char_varchar import pad_char_literals

            self.condition = pad_char_literals(self.condition, metadata)
        pcols = metadata.partition_columns

        if self.condition is None:
            # case 1: the whole table, no data read
            removes = [f.remove() for f in txn.filter_files()]
            txn.read_whole_table()
            self.metrics.update(numRemovedFiles=len(removes), numAddedFiles=0,
                                numDeletedRows=-1, scanTimeMs=timer.lap_ms(), rewriteTimeMs=0)
            return list(removes)

        if all(partition_expr.is_partition_predicate(c, pcols)
               for c in ir.split_conjuncts(self.condition)):
            # case 2: metadata only (filter_files evaluates the partition
            # predicate exactly)
            to_remove = txn.filter_files([self.condition])
            self.metrics.update(numRemovedFiles=len(to_remove), numAddedFiles=0,
                                numDeletedRows=-1, scanTimeMs=timer.lap_ms(), rewriteTimeMs=0)
            return [f.remove() for f in to_remove]

        # case 3: scan, then DV-mark or rewrite each touched file
        use_dv = dv_enabled(metadata)
        use_cdf = cdf.cdf_enabled(metadata)
        cdf_blocks: List[Tuple[str, HostTable]] = []
        candidates = candidate_files(txn, self.condition)
        touched = read_candidates(self.delta_log.data_path, candidates, metadata,
                                  self.condition, with_positions=use_dv, prune_row_groups=use_dv,
                                  device=self.delta_log.device)
        scan_ms = timer.lap_ms()

        removes: List[Action] = []
        adds: List[Action] = []
        rewrites: List[Tuple[int, HostTable]] = []  # (position in adds, the rows to write)
        deleted_rows = 0
        for tf in touched:
            matches = int(tf.mask.sum())
            if not matches:
                continue  # file untouched
            deleted_rows += matches
            if use_cdf:
                cdf_blocks.append(("delete", tf.table.filter(tf.mask)))
            if use_dv:
                rm, re_add = dv_mark_from_mask(self.delta_log.data_path, tf.add, tf.table,
                                               tf.mask)
                removes.append(rm)
                if re_add is not None:
                    adds.append(re_add)
                continue
            removes.append(tf.add.remove())
            if matches < tf.table.num_rows:
                rewrites.append((len(adds), tf.table.filter(~tf.mask)))
                self._rewrote_files = True
        # every rewritten file's rows in one write (shared codec batches), their
        # adds in the order a write a file gives them
        written = write_exec.write_tables(self.delta_log.data_path, [t for _, t in rewrites],
                                          metadata, data_change=True,
                                          device=self.delta_log.device)
        for (at, _), new_adds in reversed(list(zip(rewrites, written))):
            adds[at:at] = new_adds
        cdc_actions: List[Action] = list(cdf.write_change_data(
            self.delta_log.data_path, cdf_blocks, metadata, device=self.delta_log.device))
        self.metrics.update(numRemovedFiles=len(removes), numAddedFiles=len(adds),
                            numDeletedRows=deleted_rows, scanTimeMs=scan_ms,
                            rewriteTimeMs=timer.lap_ms())
        return removes + adds + cdc_actions

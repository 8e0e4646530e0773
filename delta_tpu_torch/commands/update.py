"""UPDATE: conditional column rewrite (the port's own copy of
``delta_tpu.commands.update``, ``UpdateCommand.scala:45-269``).

The candidates come from ``files_for_scan`` as DELETE's do. With deletion
vectors the matched rows' old versions are marked in a vector and only
their new versions are written (untouched rows stay in place); without,
each touched file is rewritten whole, each updated column projected as
``if_else(mask, new, old)``. An assigned value takes the column's type
through the unsafe cast (``expr/vectorized.cast_column``: integers wrap,
doubles truncate toward zero); a pair of types the port cannot cast raises
``update_expression_type_mismatch``. A generated column whose base
columns an assignment names is recomputed on the updated rows
(``schema/generated.recompute_stale``). With the change data feed on, the
matched rows' old and new versions go to one CDC file as
``update_preimage`` and ``update_postimage`` (``exec/cdf``). A rewrite
bumps both device caches' epochs; a DV update reaches the key slab through
its incremental advance (the old rows killed, the new rows appended). Left
out: the span and the journal.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from delta_tpu_torch.commands import operations as ops
from delta_tpu_torch.commands.dml_common import (
    POSITION_COL, Timer, bump_cache_epochs, candidate_files, dv_enabled, dv_mark_from_mask,
    read_candidates,
)
from delta_tpu_torch.exec import cdf
from delta_tpu_torch.exec import write as write_exec
from delta_tpu_torch.expr import ir
from delta_tpu_torch.expr.parser import parse_expression, parse_predicate
from delta_tpu_torch.expr.vectorized import (
    HostTable, cast_column, evaluate, stored_type, where_column,
)
from delta_tpu_torch.protocol.actions import Action
from delta_tpu_torch.schema import generated
from delta_tpu_torch.utils import errors
from delta_tpu_torch.utils.errors import DeltaAnalysisError

__all__ = ["UpdateCommand"]


class UpdateCommand:
    def __init__(self, delta_log, set_exprs: Dict[str, Union[str, ir.Expression]],
                 condition: Optional[Union[str, ir.Expression]] = None):
        if not set_exprs:
            raise DeltaAnalysisError("UPDATE requires at least one SET assignment")
        self.delta_log = delta_log
        self.set_exprs = {col: parse_expression(e) if isinstance(e, str) else e
                          for col, e in set_exprs.items()}
        self.condition = parse_predicate(condition) if isinstance(condition, str) else condition
        self.metrics: Dict[str, int] = {}

    def run(self) -> int:
        return self.delta_log.with_new_transaction(self._body)

    def _body(self, txn) -> int:
        metadata = txn.metadata
        schema_cols = {f.name.lower() for f in metadata.schema.fields}
        for col in self.set_exprs:
            if col.lower() not in schema_cols:
                raise errors.update_column_not_found(col)

        timer = Timer()
        if self.condition is not None:
            from delta_tpu_torch.schema.char_varchar import pad_char_literals

            self.condition = pad_char_literals(self.condition, metadata)
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
        updated_rows = 0
        for tf in touched:
            n_match = int(tf.mask.sum())
            if not n_match:
                continue
            updated_rows += n_match
            if use_dv:
                # the matched rows' old versions are DV-marked; only their
                # new versions are written
                rm, re_add = dv_mark_from_mask(self.delta_log.data_path, tf.add, tf.table,
                                               tf.mask)
                removes.append(rm)
                if re_add is not None:
                    adds.append(re_add)
                matched = tf.table.filter(tf.mask)
                matched = matched.select([c for c in matched.column_names if c != POSITION_COL])
                rewritten = self._apply_updates(matched, np.ones(matched.num_rows, bool),
                                                metadata)
                if use_cdf:
                    cdf_blocks += [("update_preimage", matched), ("update_postimage", rewritten)]
            else:
                removes.append(tf.add.remove())
                rewritten = self._apply_updates(tf.table, tf.mask, metadata)
                if use_cdf:
                    cdf_blocks += [("update_preimage", tf.table.filter(tf.mask)),
                                   ("update_postimage", rewritten.filter(tf.mask))]
            rewrites.append((len(adds), rewritten))
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
                            numUpdatedRows=updated_rows, scanTimeMs=scan_ms,
                            rewriteTimeMs=timer.lap_ms())
        txn.report_metrics(**self.metrics)
        op = ops.Update(predicate=self.condition.sql() if self.condition else None)
        version = txn.commit(removes + adds + cdc_actions, op)
        if not use_dv and removes:
            bump_cache_epochs(self.delta_log.log_path)
        return version

    def _apply_updates(self, table: HostTable, mask: np.ndarray, metadata) -> HostTable:
        lower_set = {c.lower(): e for c, e in self.set_exprs.items()}
        cols = {}
        for name, old in table.columns.items():
            expr = lower_set.get(name.lower())
            if expr is None:
                cols[name] = old
                continue
            new = evaluate(expr, table)
            try:
                new = cast_column(new, old.kind, stored_type(old))
            except NotImplementedError:
                raise errors.update_expression_type_mismatch(
                    name, stored_type(new), stored_type(old)) from None
            cols[name] = where_column(mask, new, old)
        # a generated column whose base columns were assigned is recomputed,
        # not copied (a stale value fails the write's check)
        return generated.recompute_stale(HostTable(cols, table.num_rows), metadata.schema,
                                         list(self.set_exprs), mask=mask)

"""OPTIMIZE: compaction, Z-ORDER BY clustering and the deletion-vector purge
(the port's own copy of ``delta_tpu.commands.optimize``).

* compaction: bin-pack each partition's small files (below
  ``min_file_size``) into files of at most ``target_rows`` rows, written
  back into the partition's directory; a ``predicate`` on partition
  columns only selects the partitions;
* Z-ORDER BY (cols): re-sort the selected files by the Morton key
  (``ops/zorder``: on the card the integer columns' ranks, the interleave
  K16 and the key's sort; only the permutation comes back) and re-split,
  giving compact per-file min/max boxes for data skipping;
* purge (REORG TABLE ... APPLY (PURGE)): rewrite exactly the files that
  carry deletion vectors, materializing the deletes.

Each commits as a rearrange-only transaction (``dataChange=False``), so
concurrent appends do not conflict and streams ignore the rewrite. After a
commit that rewrote files the port's two device caches are invalidated for
the table: the key slab (``ops/key_cache``) and the scan column lanes
(``ops/column_cache``).

Groups run sequentially, which is the JAX package's ``workers=1`` (its
default), byte-identical to its classic loop. ``workers > 1``,
``distribute=True`` (with its leases) and ``on_failure="quarantine"`` need
the sharded executor and the lease files (``parallel/executor``,
``parallel/leases``), which are not ported yet: they raise
``NotImplementedError``.
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from delta_tpu_torch.commands import operations as ops
from delta_tpu_torch.commands.dml_common import Timer, bump_cache_epochs
from delta_tpu_torch.exec import write as write_exec
from delta_tpu_torch.exec.scan import read_files_as_table
from delta_tpu_torch.expr import ir
from delta_tpu_torch.expr import partition as partition_expr
from delta_tpu_torch.expr.parser import parse_predicate
from delta_tpu_torch.expr.vectorized import HostTable
from delta_tpu_torch.ops.zorder import morton_order
from delta_tpu_torch.protocol.actions import Action, AddFile
from delta_tpu_torch.utils import errors
from delta_tpu_torch.utils.errors import DeltaAnalysisError, OptimizeBudgetExceeded

__all__ = ["OptimizeCommand", "OptimizeBudgetExceeded", "np_col"]

DEFAULT_MIN_FILE_SIZE = 256 * 1024 * 1024  # files below this are compactable
DEFAULT_TARGET_ROWS = 1 << 22


class OptimizeCommand:
    def __init__(self, delta_log, predicate: Optional[Union[str, ir.Expression]] = None,
                 z_order_by: Sequence[str] = (), min_file_size: int = DEFAULT_MIN_FILE_SIZE,
                 target_rows: int = DEFAULT_TARGET_ROWS, purge: bool = False,
                 max_rewrite_bytes: Optional[int] = None, workers: Optional[int] = None,
                 distribute: bool = False, on_failure: str = "raise"):
        if on_failure not in ("raise", "quarantine"):
            raise ValueError(f"on_failure must be 'raise' or 'quarantine', got {on_failure!r}")
        if workers is not None and int(workers) > 1:
            raise NotImplementedError("OPTIMIZE with workers > 1 (the sharded executor) is "
                                      "not ported")
        if distribute:
            raise NotImplementedError("OPTIMIZE with distribute=True (multi-host slices and "
                                      "their leases) is not ported")
        if on_failure == "quarantine":
            raise NotImplementedError("OPTIMIZE with on_failure='quarantine' (the sharded "
                                      "executor's item policy) is not ported")
        self.delta_log = delta_log
        self.predicate = parse_predicate(predicate) if isinstance(predicate, str) else predicate
        self.z_order_by = list(z_order_by)
        self.min_file_size = min_file_size
        self.target_rows = target_rows
        # purge mode: rewrite exactly the files carrying deletion vectors;
        # size-based selection is bypassed
        self.purge = purge
        # cost cap: an over-budget job raises OptimizeBudgetExceeded before
        # any data is read or written
        self.max_rewrite_bytes = max_rewrite_bytes
        self.metrics: Dict[str, int] = {}
        # wall ms of the rewrite's steps, summed over the groups: read, the
        # Z-order (its permutation comes back to the host, so the lap holds
        # its device work), the table's take and write
        self.phase_ms: Dict[str, float] = {}

    def run(self) -> int:
        return self.delta_log.with_new_transaction(self._body)

    def _plan_groups(self, txn) -> List[Tuple[Tuple, List[AddFile]]]:
        """Metadata-only rewrite planning: the selected files per partition
        key, in deterministic key order."""
        candidates = txn.filter_files([self.predicate] if self.predicate is not None else None)
        by_partition: Dict[Tuple, List[AddFile]] = defaultdict(list)
        for f in candidates:
            by_partition[tuple(sorted((f.partition_values or {}).items()))].append(f)
        groups: List[Tuple[Tuple, List[AddFile]]] = []
        # None-safe ordering: null partition values sort first
        for key, files in sorted(by_partition.items(),
                                 key=lambda kv: [(c, v is not None, v or "") for c, v in kv[0]]):
            if self.z_order_by:
                group = files  # Z-order rewrites every selected file
            elif self.purge:
                group = [f for f in files if f.deletion_vector is not None]
                if not group:
                    continue
            else:
                group = [f for f in files if (f.size or 0) < self.min_file_size]
                if len(group) < 2:
                    continue  # nothing to compact
            groups.append((key, group))
        return groups

    def _rewrite_group(self, group: List[AddFile], metadata):
        """Read, (for Z-order) re-sort, and rewrite one group; returns
        ``(new_adds, removes)``."""
        clock = [time.perf_counter()]

        def lap(name):
            clock.append(time.perf_counter())
            self.phase_ms[name] = self.phase_ms.get(name, 0.0) + (clock[-1] - clock[-2]) * 1e3

        table = read_files_as_table(self.delta_log.data_path, group, metadata,
                                    device=self.delta_log.device)
        lap("read")
        if self.z_order_by:
            perm = morton_order([np_col(table, c) for c in self.z_order_by],
                                device=self.delta_log.device)
            lap("zorder")
            table = table.take(perm)
            lap("take")
        new_adds = write_exec.write_files(self.delta_log.data_path, table, metadata,
                                          data_change=False, target_file_rows=self.target_rows,
                                          device=self.delta_log.device)
        lap("write")
        return new_adds, [f.remove(data_change=False) for f in group]

    def _body(self, txn) -> int:
        from delta_tpu_torch.utils import telemetry

        metadata = txn.metadata
        pcols = metadata.partition_columns
        if self.predicate is not None:
            conjuncts = ir.split_conjuncts(self.predicate)
            if not all(partition_expr.is_partition_predicate(c, pcols) for c in conjuncts):
                raise DeltaAnalysisError("OPTIMIZE predicate must reference only partition "
                                         "columns")
        for c in self.z_order_by:
            names = [f.name.lower() for f in metadata.schema.fields]
            if c.lower() not in names:
                raise errors.zorder_column_not_in_schema(c)
            if c.lower() in [p.lower() for p in pcols]:
                raise errors.zorder_on_partition_column(c)

        timer = Timer()
        # plan first (metadata only), so the cost cap can abort before any IO
        groups = self._plan_groups(txn)
        if self.max_rewrite_bytes is not None:
            est = sum(f.size or 0 for _, g in groups for f in g)
            if est > self.max_rewrite_bytes:
                raise OptimizeBudgetExceeded(est, self.max_rewrite_bytes,
                                             sum(len(g) for _, g in groups))
        removes: List[Action] = []
        adds: List[Action] = []
        rewritten_bytes = 0
        for _key, group in groups:
            new_adds, new_removes = self._rewrite_group(group, metadata)
            adds.extend(new_adds)
            removes.extend(new_removes)
            rewritten_bytes += sum(f.size or 0 for f in group)
        self.metrics.update(
            numRemovedFiles=len(removes),
            numAddedFiles=len(adds),
            numRemovedBytes=rewritten_bytes,
            numAddedBytes=sum(a.size or 0 for a in adds if isinstance(a, AddFile)),
            numQuarantinedGroups=0,
            timeMs=timer.lap_ms(),
        )
        txn.report_metrics(**self.metrics)
        pred_sql = [self.predicate.sql()] if self.predicate is not None else []
        if self.purge:
            op = ops.Reorg(predicate=pred_sql)
        else:
            op = ops.Optimize(predicate=pred_sql, z_order_by=self.z_order_by or None)
        version = txn.commit(removes + adds, op)
        if removes or adds:
            bump_cache_epochs(self.delta_log.log_path)
        if removes:
            telemetry.bump_counter("maintenance.optimize.filesCompacted", len(removes))
        if adds:
            telemetry.bump_counter("maintenance.optimize.filesWritten", len(adds))
        return version


def np_col(table: HostTable, name: str) -> np.ndarray:
    """A column as numpy for ranking: NULLs take the column minimum so the
    ranking's argsort stays total (NULLs cluster with the smallest value);
    an all-NULL column contributes zeros."""
    from delta_tpu_torch.exec.parquet import _min_max

    col = table.column(name)
    valid = np.asarray(col.valid, bool)
    if not valid.any():
        return np.zeros(len(valid), np.int64)
    vals = col.values
    if col.kind == "double":
        # pyarrow's min skips NaN unless every value is NaN
        mn = _min_max(col)[0]
    else:
        mn = vals[valid].min()
    if not valid.all():
        vals = vals.copy()
        vals[~valid] = mn
    return vals

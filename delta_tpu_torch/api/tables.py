"""The user-facing table handle (the port's own copy of
``delta_tpu.api.tables``, cut to reads and OPTIMIZE).

    from delta_tpu_torch import DeltaTable

    t = DeltaTable.for_path(path)                         # device="cuda"
    rows = t.to_table(filters=["cat = 'eu-c'"], columns=["id"])
    t.optimize().execute_z_order_by("ss_item_sk", "ss_sold_date_sk")

``to_table`` is the counterpart of ``to_arrow``: it returns the port's
``HostTable`` (``expr/vectorized``), since the port carries no Arrow. Time
travel, MERGE/UPDATE/DELETE builders, vacuum, history and the catalog are
not ported here.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

from delta_tpu_torch.commands.optimize import OptimizeCommand
from delta_tpu_torch.exec.scan import scan_to_table
from delta_tpu_torch.expr import ir
from delta_tpu_torch.expr.vectorized import HostTable
from delta_tpu_torch.log.deltalog import DeltaLog
from delta_tpu_torch.utils import errors

__all__ = ["DeltaTable", "DeltaOptimizeBuilder"]


class DeltaTable:
    """Programmatic handle on a Delta table."""

    def __init__(self, delta_log: DeltaLog):
        self.delta_log = delta_log

    @classmethod
    def for_path(cls, path: str, device="cuda") -> "DeltaTable":
        log = DeltaLog.for_table(path, device=device)
        if not log.table_exists:
            raise errors.not_a_delta_table(path)
        return cls(log)

    def to_table(self, filters: Sequence[Union[str, ir.Expression]] = (),
                 columns: Optional[Sequence[str]] = None) -> HostTable:
        """Read the table's live rows through the filters, projected to
        ``columns``."""
        return scan_to_table(self.delta_log.update(), filters, columns)

    def optimize(self, predicate: Optional[str] = None) -> "DeltaOptimizeBuilder":
        return DeltaOptimizeBuilder(self, predicate)


class DeltaOptimizeBuilder:
    """``table.optimize(predicate).execute_compaction() /
    execute_z_order_by(...) / execute_purge()``."""

    def __init__(self, target: DeltaTable, predicate: Optional[str] = None):
        self._target = target
        self._predicate = predicate

    def execute_compaction(self, target_rows: Optional[int] = None) -> Dict[str, int]:
        kwargs = {"target_rows": target_rows} if target_rows else {}
        cmd = OptimizeCommand(self._target.delta_log, self._predicate, **kwargs)
        cmd.run()
        return cmd.metrics

    def execute_z_order_by(self, *columns: str,
                           target_rows: Optional[int] = None) -> Dict[str, int]:
        kwargs = {"target_rows": target_rows} if target_rows else {}
        cmd = OptimizeCommand(self._target.delta_log, self._predicate,
                              z_order_by=list(columns), **kwargs)
        cmd.run()
        return cmd.metrics

    def execute_purge(self) -> Dict[str, int]:
        """Rewrite exactly the files carrying deletion vectors, materializing
        their deletes (REORG TABLE ... APPLY (PURGE))."""
        cmd = OptimizeCommand(self._target.delta_log, self._predicate, purge=True)
        cmd.run()
        return cmd.metrics

"""The user-facing table handle (the port's own copy of
``delta_tpu.api.tables``, cut to reads with time travel, DELETE, UPDATE,
RESTORE, VACUUM, history, detail and OPTIMIZE).

    from delta_tpu_torch import DeltaTable

    t = DeltaTable.for_path(path)                         # device="cuda"
    rows = t.to_table(filters=["cat = 'eu-c'"], columns=["id"])
    old = t.to_table(version=3)                           # or timestamp=...
    t.delete("id < 10")
    t.update({"v": "v + 1"}, "id = 2")
    t.restore_to_version(3)
    t.vacuum(retention_hours=168)
    t.optimize().execute_z_order_by("ss_item_sk", "ss_sold_date_sk")

``to_table`` is the counterpart of ``to_arrow``: it returns the port's
``HostTable`` (``expr/vectorized``), since the port carries no Arrow. The
MERGE builder, create/replace, clone, generate, the protocol upgrade, the
catalog and the ``path@v`` handles are not ported here.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

from delta_tpu_torch.commands.delete import DeleteCommand
from delta_tpu_torch.commands.describe import describe_detail, describe_history
from delta_tpu_torch.commands.optimize import OptimizeCommand
from delta_tpu_torch.commands.restore import RestoreCommand
from delta_tpu_torch.commands.update import UpdateCommand
from delta_tpu_torch.commands.vacuum import VacuumCommand, VacuumResult
from delta_tpu_torch.exec.scan import scan_to_table
from delta_tpu_torch.expr import ir
from delta_tpu_torch.expr.vectorized import HostTable
from delta_tpu_torch.log.deltalog import DeltaLog
from delta_tpu_torch.schema.types import StructType
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

    # -- reads ------------------------------------------------------------

    def to_table(self, filters: Sequence[Union[str, ir.Expression]] = (),
                 columns: Optional[Sequence[str]] = None, version: Optional[int] = None,
                 timestamp: Optional[Union[str, int]] = None) -> HostTable:
        """Read the table's live rows through the filters, projected to
        ``columns``, at the latest version or the one ``version`` or
        ``timestamp`` names (``DeltaLog.snapshot_for``)."""
        return scan_to_table(self.delta_log.snapshot_for(version, timestamp), filters, columns)

    @property
    def version(self) -> int:
        return self.delta_log.update().version

    def schema(self) -> StructType:
        return self.delta_log.update().metadata.schema

    def history(self, limit: Optional[int] = None) -> List[Dict[str, Any]]:
        return describe_history(self.delta_log, limit)

    def detail(self) -> Dict[str, Any]:
        return describe_detail(self.delta_log)

    # -- DML and utilities ------------------------------------------------

    def delete(self, condition: Optional[Union[str, ir.Expression]] = None) -> Dict[str, int]:
        cmd = DeleteCommand(self.delta_log, condition)
        cmd.run()
        return cmd.metrics

    def update(self, set: Dict[str, Union[str, ir.Expression]],
               condition: Optional[Union[str, ir.Expression]] = None) -> Dict[str, int]:
        cmd = UpdateCommand(self.delta_log, set, condition)
        cmd.run()
        return cmd.metrics

    def vacuum(self, retention_hours: Optional[float] = None, dry_run: bool = False,
               retention_check_enabled: bool = True) -> VacuumResult:
        return VacuumCommand(self.delta_log, retention_hours, dry_run=dry_run,
                             retention_check_enabled=retention_check_enabled).run()

    def restore_to_version(self, version: int) -> Dict[str, int]:
        """Roll the table back to ``version`` as a new commit."""
        cmd = RestoreCommand(self.delta_log, version=version)
        cmd.run()
        return cmd.metrics

    def restore_to_timestamp(self, timestamp: Union[str, int]) -> Dict[str, int]:
        cmd = RestoreCommand(self.delta_log, timestamp=timestamp)
        cmd.run()
        return cmd.metrics

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

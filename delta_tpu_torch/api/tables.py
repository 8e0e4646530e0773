"""The user-facing table API (the port's own copy of
``delta_tpu.api.tables``): ``DeltaTable``, ``DeltaMergeBuilder`` and
``DeltaOptimizeBuilder``.

    from delta_tpu_torch import DeltaTable

    t = DeltaTable.create(path, data={"id": ids, "v": vals},   # device="cuda"
                          partition_columns=["v"])            # or schema=StructType
    t.write({"id": more_ids, "v": more_vals})                 # mode="append"
    rows = t.to_table(filters=["v = 'eu-c'"], columns=["id"])
    old = DeltaTable.for_path(path + "@v0").to_table()        # a pinned handle
    plans = t.plan_queries([["id = 7"], ["id > 10 AND id < 20"]], k=256)
    (t.alias("t").merge(source, "t.id = s.id", source_alias="s")
        .when_matched_update_all().when_not_matched_insert_all().execute())
    t.delete("id < 10")
    t.update({"v": "v || '!'"}, "id = 2")
    t.restore_to_version(3)
    t.vacuum(retention_hours=168)
    t.optimize().execute_z_order_by("id")
    t.clone(other_path, version=2)                           # a shallow clone
    t.generate()                                              # symlink manifests
    t.upgrade_table_protocol(3, 7)
    changes = t.table_changes(1)                              # the change data feed
    DeltaTable.convert_to_delta(parquet_dir, partition_schema)
    DeltaTable.for_name("db.sales")                           # catalog/catalog

``to_table`` is the counterpart of ``to_arrow``: it returns the port's
``HostTable`` (``expr/vectorized``), since the port carries no Arrow; data
goes in as a ``HostTable``, a dict of columns or a list of rows
(``commands/write.coerce_to_table``). ``doctor`` and ``advise`` are not
ported.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

from delta_tpu_torch.commands.delete import DeleteCommand
from delta_tpu_torch.commands.describe import describe_detail, describe_history
from delta_tpu_torch.commands.merge import MergeClause, MergeIntoCommand
from delta_tpu_torch.commands.optimize import OptimizeCommand
from delta_tpu_torch.commands.restore import RestoreCommand
from delta_tpu_torch.commands.update import UpdateCommand
from delta_tpu_torch.commands.vacuum import VacuumCommand, VacuumResult
from delta_tpu_torch.commands.write import WriteIntoDelta
from delta_tpu_torch.exec.scan import scan_to_table
from delta_tpu_torch.expr import ir
from delta_tpu_torch.expr.vectorized import HostTable
from delta_tpu_torch.log.deltalog import DeltaLog, extract_path_time_travel
from delta_tpu_torch.protocol.actions import Protocol
from delta_tpu_torch.schema.types import StructType
from delta_tpu_torch.utils import errors

__all__ = ["DeltaTable", "DeltaMergeBuilder", "DeltaOptimizeBuilder"]


class DeltaTable:
    """Programmatic handle on a Delta table."""

    def __init__(self, delta_log: DeltaLog, alias: Optional[str] = None,
                 default_version: Optional[int] = None, default_timestamp=None):
        self.delta_log = delta_log
        self._alias = alias
        # pinned by a `path@v123` / `path@yyyyMMddHHmmssSSS` handle: reads
        # resolve here unless the call names a version or timestamp
        self._default_version = default_version
        self._default_timestamp = default_timestamp

    # -- constructors -----------------------------------------------------

    @classmethod
    def for_path(cls, path: str, device="cuda") -> "DeltaTable":
        log = DeltaLog.for_table(path, device=device)
        if not log.table_exists:
            # `path@v123` time travel, only where the literal path is not a
            # table itself (`DeltaTimeTravelSpec.scala:137`)
            spec = extract_path_time_travel(path)
            if spec is not None:
                base, v, ts = spec
                base_log = DeltaLog.for_table(base, device=device)
                if base_log.table_exists:
                    return cls(base_log, default_version=v, default_timestamp=ts)
            raise errors.not_a_delta_table(path)
        return cls(log)

    @classmethod
    def for_name(cls, name: str, catalog=None, device="cuda") -> "DeltaTable":
        """A table by catalog name (``catalog/catalog``); a ``delta.`/path```
        identifier bypasses the catalog."""
        from delta_tpu_torch.catalog.catalog import resolve_identifier

        return cls.for_path(resolve_identifier(name, catalog), device=device)

    @classmethod
    def is_delta_table(cls, path: str, device="cuda") -> bool:
        """True where ``path`` holds a table; an unreadable path is False."""
        try:
            return DeltaLog.for_table(path, device=device).table_exists
        except Exception:
            return False

    @classmethod
    def convert_to_delta(cls, path: str, partition_schema: Optional[StructType] = None,
                         device="cuda") -> "DeltaTable":
        from delta_tpu_torch.commands.convert import ConvertToDeltaCommand

        log = DeltaLog.for_table(path, device=device)
        ConvertToDeltaCommand(log, partition_schema=partition_schema).run()
        return cls(log)

    @classmethod
    def create(cls, path: str, schema: Optional[StructType] = None,
               partition_columns: Sequence[str] = (),
               configuration: Optional[Dict[str, str]] = None, data: Any = None,
               mode: str = "create", device="cuda") -> "DeltaTable":
        """CREATE [OR REPLACE] TABLE [AS SELECT] (``commands/create``).
        ``mode`` is ``create``, ``create_if_not_exists``, ``replace`` or
        ``create_or_replace``; ``data`` makes it a CTAS."""
        from delta_tpu_torch.commands.create import CreateDeltaTableCommand

        log = DeltaLog.for_table(path, device=device)
        CreateDeltaTableCommand(log, schema=schema, mode=mode,
                                partition_columns=partition_columns,
                                configuration=configuration, data=data).run()
        return cls(log)

    @classmethod
    def replace(cls, path: str, schema: Optional[StructType] = None,
                partition_columns: Sequence[str] = (),
                configuration: Optional[Dict[str, str]] = None, data: Any = None,
                or_create: bool = False, device="cuda") -> "DeltaTable":
        """REPLACE TABLE / CREATE OR REPLACE TABLE [AS SELECT]."""
        return cls.create(path, schema, partition_columns, configuration, data,
                          mode="create_or_replace" if or_create else "replace", device=device)

    # -- reads ------------------------------------------------------------

    def alias(self, name: str) -> "DeltaTable":
        return DeltaTable(self.delta_log, alias=name, default_version=self._default_version,
                          default_timestamp=self._default_timestamp)

    def to_table(self, filters: Sequence[Union[str, ir.Expression]] = (),
                 columns: Optional[Sequence[str]] = None, version: Optional[int] = None,
                 timestamp: Optional[Union[str, int]] = None) -> HostTable:
        """Read the table's live rows through the filters, projected to
        ``columns``, at the latest version (or the handle's pinned one) or
        the one ``version`` or ``timestamp`` names."""
        return scan_to_table(self._snapshot(version, timestamp), filters, columns)

    def _snapshot(self, version: Optional[int] = None,
                  timestamp: Optional[Union[str, int]] = None):
        if version is None and timestamp is None:
            version, timestamp = self._default_version, self._default_timestamp
        return self.delta_log.snapshot_for(version, timestamp)

    def plan_queries(self, queries, k: int = 256):
        """Plan a batch of queries, each a list of filters: one
        ``exec.scan.QueryPlan`` a query (the pruned paths, an exact count).
        With the table's scan lanes resident (``ops/state_cache``) the batch
        is one block-cull launch."""
        from delta_tpu_torch.exec.scan import plan_scans

        for q in queries:
            if isinstance(q, (str, ir.Expression)):
                raise errors.DeltaIllegalArgumentError(
                    "plan_queries takes a list of QUERIES, each a list of filters — wrap "
                    f"the filter in a list: [[{q!r}]]")
        return plan_scans(self._snapshot(), queries, k=k)

    @property
    def version(self) -> int:
        return self._snapshot().version

    def schema(self) -> StructType:
        return self._snapshot().metadata.schema

    def history(self, limit: Optional[int] = None) -> List[Dict[str, Any]]:
        return describe_history(self.delta_log, limit)

    def table_changes(self, starting_version: int,
                      ending_version: Optional[int] = None) -> HostTable:
        """The change data feed between two versions, inclusive: rows with
        ``_change_type``, ``_commit_version`` and ``_commit_timestamp``
        (``exec/cdf.read_changes``). UPDATE and MERGE rows are exact with
        ``delta.enableChangeDataFeed=true``; appends and deletes are rebuilt
        from the file actions either way."""
        from delta_tpu_torch.exec import cdf as cdf_exec

        return cdf_exec.read_changes(self.delta_log, starting_version, ending_version)

    def detail(self) -> Dict[str, Any]:
        return describe_detail(self.delta_log)

    # -- writes, DML and utilities ----------------------------------------

    def _check_mutable(self, operation: str) -> None:
        """A `path@v` / `path@timestamp` handle is read-only."""
        if self._default_version is not None or self._default_timestamp is not None:
            raise errors.DeltaAnalysisError(
                f"Cannot {operation} a time-travelled table handle: the table was resolved "
                "with an embedded version/timestamp.")

    def write(self, data: Any, mode: str = "append", **options) -> int:
        self._check_mutable("write to")
        return WriteIntoDelta(self.delta_log, mode, data, **options).run()

    def delete(self, condition: Optional[Union[str, ir.Expression]] = None) -> Dict[str, int]:
        self._check_mutable("DELETE from")
        cmd = DeleteCommand(self.delta_log, condition)
        cmd.run()
        return cmd.metrics

    def update(self, set: Dict[str, Union[str, ir.Expression]],
               condition: Optional[Union[str, ir.Expression]] = None) -> Dict[str, int]:
        self._check_mutable("UPDATE")
        cmd = UpdateCommand(self.delta_log, set, condition)
        cmd.run()
        return cmd.metrics

    # updateExpr is the same entry point: expressions are SQL strings
    update_expr = update

    def merge(self, source: Any, condition: Union[str, ir.Expression],
              source_alias: Optional[str] = None) -> "DeltaMergeBuilder":
        self._check_mutable("MERGE into")
        return DeltaMergeBuilder(self, source, condition, source_alias=source_alias,
                                 target_alias=self._alias)

    def vacuum(self, retention_hours: Optional[float] = None, dry_run: bool = False,
               retention_check_enabled: bool = True) -> VacuumResult:
        self._check_mutable("VACUUM")
        return VacuumCommand(self.delta_log, retention_hours, dry_run=dry_run,
                             retention_check_enabled=retention_check_enabled).run()

    def restore_to_version(self, version: int) -> Dict[str, int]:
        """Roll the table back to ``version`` as a new commit."""
        self._check_mutable("RESTORE")
        cmd = RestoreCommand(self.delta_log, version=version)
        cmd.run()
        return cmd.metrics

    def restore_to_timestamp(self, timestamp: Union[str, int]) -> Dict[str, int]:
        self._check_mutable("RESTORE")
        cmd = RestoreCommand(self.delta_log, timestamp=timestamp)
        cmd.run()
        return cmd.metrics

    def clone(self, target_path: str, version: Optional[int] = None,
              timestamp: Optional[Union[str, int]] = None) -> "DeltaTable":
        """Shallow-clone this table (at the latest version, or the one
        ``version`` or ``timestamp`` names) into ``target_path``: the clone
        reads this table's data files in place (``commands/clone``)."""
        from delta_tpu_torch.commands.clone import CloneCommand

        CloneCommand(self.delta_log, target_path, version=version, timestamp=timestamp).run()
        return DeltaTable.for_path(target_path, device=self.delta_log.device)

    def generate(self, mode: str = "symlink_format_manifest") -> None:
        if mode != "symlink_format_manifest":
            raise errors.unsupported_generate_mode(mode)
        from delta_tpu_torch.hooks.symlink_manifest import generate_full_manifest

        generate_full_manifest(self.delta_log)

    def optimize(self, predicate: Optional[str] = None) -> "DeltaOptimizeBuilder":
        self._check_mutable("OPTIMIZE")
        return DeltaOptimizeBuilder(self, predicate)

    def upgrade_table_protocol(self, reader_version: int, writer_version: int) -> None:
        self._check_mutable("upgrade the protocol of")
        self.delta_log.upgrade_protocol(Protocol(min_reader_version=reader_version,
                                                 min_writer_version=writer_version))


class DeltaMergeBuilder:
    """The fluent MERGE builder (``DeltaMergeBuilder.scala:123-457``): clause
    order is execution order; ``execute`` runs ``MergeIntoCommand`` and
    returns its metrics."""

    def __init__(self, target: DeltaTable, source: Any, condition,
                 source_alias: Optional[str] = None, target_alias: Optional[str] = None):
        self._target = target
        self._source = source
        self._condition = condition
        self._source_alias = source_alias
        self._target_alias = target_alias
        self._matched: List[MergeClause] = []
        self._not_matched: List[MergeClause] = []

    def when_matched_update(self, set: Dict[str, Any],
                            condition: Optional[str] = None) -> "DeltaMergeBuilder":
        self._matched.append(MergeClause("update", condition, dict(set)))
        return self

    def when_matched_update_all(self, condition: Optional[str] = None) -> "DeltaMergeBuilder":
        self._matched.append(MergeClause("update", condition, None))
        return self

    def when_matched_delete(self, condition: Optional[str] = None) -> "DeltaMergeBuilder":
        self._matched.append(MergeClause("delete", condition))
        return self

    def when_not_matched_insert(self, values: Dict[str, Any],
                                condition: Optional[str] = None) -> "DeltaMergeBuilder":
        self._not_matched.append(MergeClause("insert", condition, dict(values)))
        return self

    def when_not_matched_insert_all(self,
                                    condition: Optional[str] = None) -> "DeltaMergeBuilder":
        self._not_matched.append(MergeClause("insert", condition, None))
        return self

    def execute(self) -> Dict[str, int]:
        cmd = MergeIntoCommand(self._target.delta_log, self._source, self._condition,
                               self._matched, self._not_matched,
                               source_alias=self._source_alias, target_alias=self._target_alias)
        cmd.run()
        return cmd.metrics


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

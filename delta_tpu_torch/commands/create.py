"""CREATE / REPLACE / CTAS (the port's own copy of
``delta_tpu.commands.create``, after ``CreateDeltaTableCommand.scala``).

One command for CREATE TABLE, CREATE TABLE AS SELECT, REPLACE TABLE and
CREATE OR REPLACE:

* CREATE on an existing table raises; IF NOT EXISTS is a no-op, but a
  schema, partitioning or property it names must match the table's;
* REPLACE needs an existing table (CREATE OR REPLACE does not), stages the
  new metadata and removes every live file in ONE commit, keeping the
  table id;
* CTAS writes its data's files (the port's writer, the page codec on the
  log's device) in the same commit.

The metadata is committed from the caller's ``StructType``, so its field
metadata survives; without one, a CTAS takes its schema from the data.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from delta_tpu_torch.commands import operations as ops
from delta_tpu_torch.exec import write as write_exec
from delta_tpu_torch.protocol.actions import Action, Metadata
from delta_tpu_torch.schema.types import StructType
from delta_tpu_torch.utils import errors
from delta_tpu_torch.utils.errors import DeltaAnalysisError, DeltaIllegalArgumentError

__all__ = ["CreateDeltaTableCommand"]

_MODES = ("create", "create_if_not_exists", "replace", "create_or_replace")


class CreateDeltaTableCommand:
    def __init__(self, delta_log, schema: Optional[StructType] = None, mode: str = "create",
                 partition_columns: Sequence[str] = (),
                 configuration: Optional[Dict[str, str]] = None, data: Any = None,
                 name: Optional[str] = None, description: Optional[str] = None):
        if mode not in _MODES:
            raise DeltaIllegalArgumentError(
                f"Unknown create mode {mode!r} (expected one of {_MODES})")
        if schema is None and data is None:
            raise DeltaAnalysisError("CREATE TABLE requires a schema or data (CTAS)")
        self.delta_log = delta_log
        if schema is not None:
            from delta_tpu_torch.schema.char_varchar import replace_char_varchar_with_string

            schema = replace_char_varchar_with_string(schema)
        self.schema = schema
        self.mode = mode
        self.partition_columns = list(partition_columns)
        self.configuration = dict(configuration or {})
        self.name = name
        self.description = description
        self.data = None
        if data is not None:
            from delta_tpu_torch.commands.write import coerce_to_table
            from delta_tpu_torch.schema.schema_utils import schema_from_table

            self.data = coerce_to_table(data)
            if schema is None:
                self.schema = schema_from_table(self.data)

    def _reconcile_existing(self, existing_meta) -> None:
        """CREATE against an existing table: what the caller names must agree
        with what is on disk (``verifyTableMetadata``)."""
        path = self.delta_log.data_path
        if self.schema is not None and existing_meta.schema_string is not None:
            existing = existing_meta.schema
            if existing.to_json() != self.schema.to_json():
                raise DeltaAnalysisError(
                    f"The specified schema does not match the existing schema at {path}.\n"
                    f"== Specified ==\n{self.schema.simple_string()}\n"
                    f"== Existing ==\n{existing.simple_string()}")
        if (self.partition_columns
                and list(existing_meta.partition_columns) != self.partition_columns):
            raise DeltaAnalysisError(
                f"The specified partitioning does not match the existing partitioning at "
                f"{path}: {self.partition_columns} vs {list(existing_meta.partition_columns)}")
        for k, v in self.configuration.items():
            if existing_meta.configuration.get(k) != v:
                raise DeltaAnalysisError(
                    f"The specified properties do not match the existing properties at "
                    f"{path} (key {k!r})")

    def run(self) -> int:
        log = self.delta_log
        # a fast pre-check; the deciding read is the transaction's own
        # snapshot, so a table created meanwhile is caught there
        if log.update().version >= 0:
            if self.mode == "create":
                raise errors.table_already_exists(log.data_path)
            if self.mode == "create_if_not_exists":
                self._reconcile_existing(log.snapshot.metadata)
                return log.snapshot.version
        elif self.mode == "replace":
            raise errors.replace_requires_existing_table(log.data_path)

        def body(txn) -> int:
            exists_now = txn.snapshot.version >= 0
            if exists_now and self.mode == "create":
                raise errors.table_already_exists(log.data_path)
            if exists_now and self.mode == "create_if_not_exists":
                self._reconcile_existing(txn.snapshot.metadata)
                return txn.snapshot.version
            txn.update_metadata(Metadata(
                name=self.name, description=self.description,
                schema_string=self.schema.to_json(),
                partition_columns=self.partition_columns, configuration=self.configuration))
            actions: List[Action] = []
            replacing = exists_now and self.mode in ("replace", "create_or_replace")
            if replacing:
                actions.extend(f.remove() for f in txn.filter_files())
            if self.data is not None and self.data.num_rows:
                adds = write_exec.write_files(log.data_path, self.data, txn.metadata,
                                              data_change=True, device=log.device)
                actions.extend(adds)
                txn.report_metrics(numFiles=len(adds),
                                   numOutputBytes=sum(a.size or 0 for a in adds),
                                   numOutputRows=self.data.num_rows)
            if replacing:
                op = ops.ReplaceTable(txn.metadata, or_create=self.mode == "create_or_replace",
                                      as_select=self.data is not None)
            else:
                op = ops.CreateTable(txn.metadata, as_select=self.data is not None)
            return txn.commit(actions, op)

        return log.with_new_transaction(body)

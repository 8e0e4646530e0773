"""Batch write command: append / overwrite / replaceWhere / error / ignore
(the port's own copy of ``delta_tpu.commands.write``).

Equivalent of ``commands/WriteIntoDelta.scala:46-138`` plus the implicit
metadata logic of ``schema/ImplicitMetadataOperation.scala:30-62``: the
first write creates the table with its schema from the data, its
``partition_columns`` (the writer lays the files out in Hive-style
partition directories) and the ``configuration=`` table properties; later
writes must fit the table's schema and name its partition columns, if any.
``replace_where`` turns an overwrite into an atomic replacement of the
files a partition predicate selects, after checking that every written
file lies inside it (a data-column predicate is refused, as the reference
refuses it). ``rearrange_only`` flips ``dataChange=False`` on every action.

``merge_schema`` evolves the table's schema to take the batch's new
columns and widened types (``schema_utils.merge_schemas``);
``overwrite_schema`` (overwrite mode only) replaces it with the batch's.

The data is a ``HostTable`` (``expr/vectorized``) or a dict of numpy
arrays or Python lists (:func:`coerce_to_table`); never a ``pyarrow``
table.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Any, Dict, List, Optional, Sequence, Union

from delta_tpu_torch.commands import operations as ops
from delta_tpu_torch.exec import write as write_exec
from delta_tpu_torch.expr import ir
from delta_tpu_torch.expr import partition as partition_expr
from delta_tpu_torch.expr.parser import parse_predicate
from delta_tpu_torch.expr.vectorized import HostTable, column_from_values, table_from_rows
from delta_tpu_torch.protocol.actions import Action, AddFile, Metadata
from delta_tpu_torch.schema import schema_utils
from delta_tpu_torch.schema.types import StructType
from delta_tpu_torch.utils import errors
from delta_tpu_torch.utils.errors import DeltaAnalysisError, DeltaIllegalArgumentError

__all__ = ["WriteIntoDelta", "update_metadata_on_write", "coerce_to_table"]

MODES = ("append", "overwrite", "error", "errorifexists", "ignore")


def coerce_to_table(data: Any) -> HostTable:
    """A ``HostTable``, a dict of columns (numpy arrays, masked arrays for
    NULLs, or Python lists) or a list of row dicts, as a ``HostTable``."""
    if isinstance(data, HostTable):
        return data
    if isinstance(data, dict):
        cols = {str(k): column_from_values(str(k), v) for k, v in data.items()}
        lengths = {len(c.valid) for c in cols.values()}
        if len(lengths) > 1:
            raise DeltaIllegalArgumentError(f"columns of unequal lengths {sorted(lengths)}")
        return HostTable(cols, lengths.pop() if lengths else 0)
    if isinstance(data, list):
        return table_from_rows(data)
    raise DeltaIllegalArgumentError(f"Cannot convert {type(data).__name__} to a table")


def update_metadata_on_write(txn, data_schema: StructType, partition_columns: Sequence[str],
                             configuration: Optional[Dict[str, str]] = None,
                             is_overwrite: bool = False, merge_schema: bool = False,
                             overwrite_schema: bool = False) -> None:
    """``ImplicitMetadataOperation.updateMetadata``: create the table from the
    data's schema, replace it (``overwrite_schema``), evolve it
    (``merge_schema``), or hold the data to it."""
    table_exists = txn.read_version >= 0 and txn.metadata.schema_string is not None
    if overwrite_schema and not is_overwrite:
        raise DeltaAnalysisError("overwriteSchema requires mode('overwrite')")
    if not table_exists:
        schema_utils.check_partition_columns(partition_columns, data_schema)
        txn.update_metadata(Metadata(schema_string=data_schema.to_json(),
                                     partition_columns=list(partition_columns),
                                     configuration=dict(configuration or {})))
        return
    current = txn.metadata
    if partition_columns and [c.lower() for c in partition_columns] != [
            c.lower() for c in current.partition_columns]:
        raise errors.partition_columns_mismatch(partition_columns, current.partition_columns)
    if overwrite_schema:
        txn.update_metadata(replace(
            current, schema_string=data_schema.to_json(),
            partition_columns=list(partition_columns or current.partition_columns)))
        return
    if merge_schema:
        merged = schema_utils.merge_schemas(current.schema, data_schema)
        if merged.to_json() != current.schema.to_json():
            txn.update_metadata(replace(current, schema_string=merged.to_json()))
        return
    schema_utils.enforce_write_compatibility(current.schema, data_schema)


class WriteIntoDelta:
    def __init__(self, delta_log, mode: str, data: Any, partition_columns: Sequence[str] = (),
                 replace_where: Optional[Union[str, ir.Expression]] = None,
                 merge_schema: bool = False, overwrite_schema: bool = False,
                 rearrange_only: bool = False, configuration: Optional[Dict[str, str]] = None,
                 user_metadata: Optional[str] = None):
        mode = mode.lower()
        if mode not in MODES:
            raise DeltaIllegalArgumentError(f"Unknown save mode {mode!r}")
        if replace_where is not None and mode != "overwrite":
            raise DeltaAnalysisError("replaceWhere is only supported with mode('overwrite')")
        self.delta_log = delta_log
        self.mode = mode
        self.table = coerce_to_table(data)
        self.partition_columns = list(partition_columns)
        self.replace_where = (parse_predicate(replace_where) if isinstance(replace_where, str)
                              else replace_where)
        self.merge_schema = merge_schema
        self.overwrite_schema = overwrite_schema
        self.rearrange_only = rearrange_only
        self.configuration = configuration
        self.user_metadata = user_metadata

    def run(self) -> int:
        log = self.delta_log
        if log.table_exists:
            if self.mode == "ignore":
                return log.snapshot.version
            if self.mode in ("error", "errorifexists"):
                raise errors.table_already_exists(log.data_path)

        def body(txn):
            actions = self.write(txn)
            adds = [a for a in actions if isinstance(a, AddFile)]
            txn.report_metrics(numFiles=len(adds), numOutputBytes=sum(a.size or 0 for a in adds),
                               numOutputRows=self.table.num_rows)
            op = ops.Write(mode=self.mode, partition_by=self.partition_columns or None,
                           predicate=self.replace_where.sql() if self.replace_where else None)
            return txn.commit(actions, op)

        return log.with_new_transaction(body)

    def write(self, txn) -> List[Action]:
        data_schema = schema_utils.schema_from_table(self.table)
        is_overwrite = self.mode == "overwrite"
        update_metadata_on_write(txn, data_schema,
                                 self.partition_columns or txn.metadata.partition_columns,
                                 configuration=self.configuration, is_overwrite=is_overwrite,
                                 merge_schema=self.merge_schema,
                                 overwrite_schema=self.overwrite_schema)
        adds = write_exec.write_files(self.delta_log.data_path, self.table, txn.metadata,
                                      data_change=not self.rearrange_only,
                                      device=self.delta_log.device)
        removes: List[Action] = []
        if is_overwrite:
            if self.replace_where is None:
                removes = [f.remove(data_change=not self.rearrange_only)
                           for f in txn.filter_files()]
            else:
                removes = self._replace_where_removes(txn, adds)
        return list(adds) + removes

    def _replace_where_removes(self, txn, written: List[AddFile]) -> List[Action]:
        """Check that the written files lie inside the predicate, then remove
        the files it selects (``WriteIntoDelta.scala:112-125``). Partition
        predicates only: removing a file a data predicate matched would also
        delete its rows outside the predicate."""
        pred = self.replace_where
        metadata = txn.metadata
        pcols = metadata.partition_columns
        if not all(partition_expr.is_partition_predicate(c, pcols)
                   for c in ir.split_conjuncts(pred)):
            raise errors.replace_where_needs_partition_columns(pred.sql(), pcols)
        for add in written:
            if not partition_expr.matches(pred, add, metadata.partition_schema):
                raise errors.replace_where_mismatch(pred.sql(),
                                                    f"partitions {add.partition_values}")
        return [f.remove(data_change=not self.rearrange_only)
                for f in txn.filter_files([pred])]

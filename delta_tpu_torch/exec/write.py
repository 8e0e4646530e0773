"""Transactional write path: a ``HostTable`` batch -> Parquet data files ->
AddFiles (the port's own copy of ``delta_tpu.exec.write``, unpartitioned).

Normalize the batch to the table schema (order, case, the declared types),
split it at ``delta.tpu.write.targetFileRows`` rows, write one
``part-<n>-<uuid>.c000.snappy.parquet`` file per chunk through the port's
Parquet writer (``exec/parquet.write_parquet_file``) and return AddFiles
carrying the protocol's stats over the first
``delta.dataSkippingNumIndexedCols`` columns. Files become visible only
through the commit.

Left out: partitioned tables, generated columns, CHECK constraints and the
char/varchar write semantics each raise ``NotImplementedError``.
"""
from __future__ import annotations

import os
import urllib.parse
import uuid
from typing import List, Optional

from delta_tpu_torch.exec import parquet as pq_exec
from delta_tpu_torch.expr.vectorized import HostTable, cast_column, null_column
from delta_tpu_torch.protocol.actions import AddFile, Metadata
from delta_tpu_torch.schema import schema_utils
from delta_tpu_torch.schema.types import CharType, StructType, VarcharType
from delta_tpu_torch.utils.config import DeltaConfigs, conf
from delta_tpu_torch.utils.errors import SchemaMismatchError

__all__ = ["normalize_data", "write_files"]


def _resolve(table: HostTable, name: str) -> Optional[str]:
    if name in table.columns:
        return name
    low = name.lower()
    for c in table.columns:
        if c.lower() == low:
            return c
    return None


def normalize_data(table: HostTable, schema: StructType) -> HostTable:
    """Reorder/case-normalize/cast the batch to the table schema
    (``TransactionalWrite.scala:79-115`` normalizeData)."""
    cols = {}
    for f in schema.fields:
        kind, stype = schema_utils.stored_type_for(f.data_type)
        src = _resolve(table, f.name)
        if src is None:
            cols[f.name] = null_column(table.num_rows, kind, stype)
            continue
        col = table.columns[src]
        try:
            cols[f.name] = cast_column(col, kind, stype)
        except NotImplementedError as e:
            raise SchemaMismatchError(
                f"Cannot cast column {f.name} from {col.kind} to {stype}: {e}")
    extra = [c for c in table.columns
             if all(c.lower() != f.name.lower() for f in schema.fields)]
    if extra:
        raise SchemaMismatchError(
            f"Data columns {extra} not present in table schema "
            f"{[f.name for f in schema.fields]} (enable mergeSchema to add them)")
    return HostTable(cols, table.num_rows)


def write_files(data_path: str, table: HostTable, metadata: Metadata,
                data_change: bool = True,
                target_file_rows: Optional[int] = None) -> List[AddFile]:
    """Write a batch as Parquet data files; return their AddFiles."""
    schema: StructType = metadata.schema
    if metadata.partition_columns:
        raise NotImplementedError("writing a partitioned table is not ported")
    if any("delta.generationExpression" in (f.metadata or {}) for f in schema.fields):
        raise NotImplementedError("generated columns are not ported")
    if any(isinstance(f.data_type, (CharType, VarcharType))
           or "__CHAR_VARCHAR_TYPE_STRING" in (f.metadata or {}) for f in schema.fields):
        raise NotImplementedError("char/varchar write semantics are not ported")
    if any(k.lower().startswith("delta.constraints.") for k in metadata.configuration or {}):
        raise NotImplementedError("CHECK constraints are not ported")
    schema_utils.check_column_name_duplication(schema_utils.schema_from_table(table),
                                               "in the data to save")
    table = normalize_data(table, schema)
    num_indexed = DeltaConfigs.DATA_SKIPPING_NUM_INDEXED_COLS.from_metadata(metadata)
    if target_file_rows is None:
        target_file_rows = int(conf.get("delta.tpu.write.targetFileRows", 4_000_000))
    if table.num_rows == 0:
        return []
    if target_file_rows and table.num_rows > target_file_rows:
        chunks = [table.slice(s, target_file_rows)
                  for s in range(0, table.num_rows, target_file_rows)]
    else:
        chunks = [table]
    adds = []
    for idx, chunk in enumerate(chunks):
        rel = f"part-{idx:05d}-{uuid.uuid4()}.c000.snappy.parquet"
        size, mtime = pq_exec.write_parquet_file(chunk, os.path.join(data_path, rel))
        adds.append(AddFile(
            # AddFile.path is URI-encoded per the protocol; readers unquote once
            path=urllib.parse.quote(rel, safe="/:@!$&'()*+,;=-._~"),
            partition_values={}, size=size, modification_time=mtime,
            data_change=data_change, stats=pq_exec.stats_json(chunk, num_indexed)))
    return adds

"""Transactional write path: a ``HostTable`` batch -> partitioned Parquet
data files -> AddFiles (the port's own copy of ``delta_tpu.exec.write``).

Normalize the batch to the table schema (order, case, the declared types),
split it by partition values (a stable sort by the partition columns, NULLs
and then NaNs last as Arrow's ``sort_by`` places them, and one scan for the
run boundaries), split each partition at ``delta.tpu.write.targetFileRows``
rows, write one ``<partition path>/part-<n>-<uuid>.c000.snappy.parquet``
file per chunk through the port's Parquet writer
(``exec/parquet.write_parquet_file``), holding the data columns only, and
return AddFiles carrying the protocol's stats over the first
``delta.dataSkippingNumIndexedCols`` data columns. A partition value's
string is what ``str()`` of Arrow's Python scalar gives (``true``/``false``,
``1.0``, ``nan``, a date's ISO form, ``2020-01-01 00:00:00``, a decimal's
digits with its scale kept: ``1.50``, ``1E-7``), NULL is
``__HIVE_DEFAULT_PARTITION__``, and a directory name is Hive-escaped. A
nested column cannot partition a table (Arrow sorts none). Files become
visible only through the commit.

Before the split each batch goes through the write semantics, in the JAX
package's order: generated columns computed or checked
(``schema/generated.compute_on_write``, before normalization loses which
columns were provided), normalization, the char/varchar padding and length
check (``schema/char_varchar``), then NOT NULL and CHECK constraints
(``schema/constraints``). A violation raises before any file is written.
"""
from __future__ import annotations

import datetime as _dt
import os
import urllib.parse
import uuid
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from delta_tpu_torch.exec import parquet as pq_exec
from delta_tpu_torch.expr.nested import decimal_ps, spec_string, to_decimal
from delta_tpu_torch.expr.vectorized import HostColumn, HostTable, cast_column, null_column
from delta_tpu_torch.protocol.actions import AddFile, Metadata
from delta_tpu_torch.schema import char_varchar, constraints, generated, schema_utils
from delta_tpu_torch.schema.types import StructType
from delta_tpu_torch.utils.config import DeltaConfigs, conf
from delta_tpu_torch.utils.errors import SchemaMismatchError

__all__ = ["normalize_data", "write_files", "write_tables", "escape_partition_value",
           "unescape_partition_value", "partition_path", "HIVE_DEFAULT_PARTITION"]

# Hive-style partition-path escaping (Spark's ExternalCatalogUtils): these
# characters are %-encoded in directory names
_ESCAPE = set('\\"#%\'*/:=?\x7f[]^ \t\n\x0b\x0c\r{}')
HIVE_DEFAULT_PARTITION = "__HIVE_DEFAULT_PARTITION__"
#: the values (rows x columns) of consecutive files written with one codec
#: batch (``exec/parquet.write_parquet_files``): two launch sets a group of
#: small files, not two a file
_BATCH_CELLS = 32 << 20
_EPOCH_DAY = _dt.date(1970, 1, 1)
_EPOCH_TS = _dt.datetime(1970, 1, 1)


def escape_partition_value(v: Optional[str]) -> str:
    if v is None or v == "":
        return HIVE_DEFAULT_PARTITION
    return "".join(f"%{ord(c):02X}" if c in _ESCAPE or ord(c) < 0x20 else c for c in v)


def unescape_partition_value(s: str) -> Optional[str]:
    if s == HIVE_DEFAULT_PARTITION:
        return None
    return urllib.parse.unquote(s)


def partition_path(partition_values: Dict[str, Optional[str]],
                   partition_columns: Sequence[str]) -> str:
    return "/".join(f"{c}={escape_partition_value(partition_values.get(c))}"
                    for c in partition_columns)


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


def _sort_ranks(col: HostColumn) -> np.ndarray:
    """Dense ascending ranks of a column's values, with NaN after every
    number and NULL after NaN (Arrow's ``sort_by`` order); -0.0 and 0.0
    share a rank, as they compare equal."""
    n = len(col.valid)
    valid = np.asarray(col.valid, bool)
    if col.kind == "nested":
        raise TypeError(f"Sorting not supported for type {spec_string(col.type)}")
    if col.kind == "double":
        nan = valid & np.isnan(col.values)
    else:
        nan = np.zeros(n, bool)
    real = valid & ~nan
    ranks = np.empty(n, np.int64)
    uniq, inv = (np.unique(col.values[real], return_inverse=True) if real.any()
                 else (np.empty(0), np.empty(0, np.int64)))
    ranks[real] = inv
    ranks[nan] = len(uniq)
    ranks[~valid] = len(uniq) + 1
    return ranks


def _partition_value_str(col: HostColumn, i: int) -> Optional[str]:
    """Row ``i``'s partition value as the JAX package writes it: ``str()`` of
    Arrow's Python scalar."""
    if not col.valid[i]:
        return None
    v = col.values[i]
    if col.kind == "bool":
        return "true" if v else "false"
    if col.kind == "int":
        return str(int(v))
    if col.kind == "double":
        return str(float(v))
    if col.kind == "date":
        return str(_EPOCH_DAY + _dt.timedelta(days=int(v)))
    if col.kind == "ts":
        out = str(_EPOCH_TS + _dt.timedelta(microseconds=int(v)))
        return out + "+00:00" if col.type == "timestamp[us, tz=UTC]" else out
    if col.kind == "decimal":
        return str(to_decimal(v, decimal_ps(col.type)[1]))
    return str(v)


def _split_by_partition(table: HostTable, part_cols: Sequence[str]
                        ) -> List[Tuple[Dict[str, Optional[str]], HostTable]]:
    """One stable sort by the partition columns and one scan for the run
    boundaries: NULL<->value is a boundary, NULL<->NULL and NaN<->NaN are
    not. Each group's values are its first row's."""
    n = table.num_rows
    if n == 0:
        return []
    cols = [table.column(c) for c in part_cols]
    ranks = [_sort_ranks(c) for c in cols]
    order = np.lexsort(ranks[::-1])  # stable; the first column is the major key
    change = np.zeros(n, bool)
    change[0] = True
    for r in ranks:
        rs = r[order]
        change[1:] |= rs[1:] != rs[:-1]
    starts = np.flatnonzero(change)
    bounds = np.append(starts, n)
    out = []
    for i, s in enumerate(starts):
        rows = order[s:bounds[i + 1]]
        pv = {c: _partition_value_str(col, int(rows[0])) for c, col in zip(part_cols, cols)}
        out.append((pv, table.take(rows)))
    return out


def write_files(data_path: str, table: HostTable, metadata: Metadata,
                data_change: bool = True,
                target_file_rows: Optional[int] = None, device="cuda") -> List[AddFile]:
    """Write a batch as partitioned Parquet data files; return their AddFiles.
    Each file's page codec runs on ``device`` (the table's ``DeltaLog``'s)."""
    return write_tables(data_path, [table], metadata, data_change, target_file_rows,
                        device)[0]


def write_tables(data_path: str, tables: Sequence[HostTable], metadata: Metadata,
                 data_change: bool = True, target_file_rows: Optional[int] = None,
                 device="cuda") -> List[List[AddFile]]:
    """:func:`write_files` of each table (each split into its own files, as
    one call a table would), the files of them all sharing codec batches:
    a command that rewrites many files pays two launch sets a batch, not
    two a file."""
    schema: StructType = metadata.schema
    checks = constraints.from_metadata(metadata)
    num_indexed = DeltaConfigs.DATA_SKIPPING_NUM_INDEXED_COLS.from_metadata(metadata)
    if target_file_rows is None:
        target_file_rows = int(conf.get("delta.tpu.write.targetFileRows", 4_000_000))
    part_cols = list(metadata.partition_columns)
    data_cols = [f.name for f in schema.fields if f.name not in part_cols]
    planned = []  # (table index, partition values, file data, relative path)
    for ti, table in enumerate(tables):
        schema_utils.check_column_name_duplication(schema_utils.schema_from_table(table),
                                                   "in the data to save")
        table = generated.compute_on_write(table, schema)
        table = normalize_data(table, schema)
        table = char_varchar.apply_write_semantics(table, metadata)
        constraints.enforce(checks, table)
        groups = _split_by_partition(table, part_cols) if part_cols else [({}, table)]
        for pv, part_table in groups:
            if part_table.num_rows == 0:
                continue
            if target_file_rows and part_table.num_rows > target_file_rows:
                chunks = [part_table.slice(s, target_file_rows)
                          for s in range(0, part_table.num_rows, target_file_rows)]
            else:
                chunks = [part_table]
            prefix = partition_path(pv, part_cols)
            for idx, chunk in enumerate(chunks):
                file_data = chunk.select(data_cols) if part_cols else chunk
                name = f"part-{idx:05d}-{uuid.uuid4()}.c000.snappy.parquet"
                planned.append((ti, pv, file_data, f"{prefix}/{name}" if prefix else name))
    # consecutive files of up to _BATCH_CELLS values share their codec batches
    written: List[Tuple[int, int]] = []
    at = 0
    while at < len(planned):
        end, cells = at, 0
        while end < len(planned) and (end == at or cells < _BATCH_CELLS):
            cells += planned[end][2].num_rows * max(len(planned[end][2].columns), 1)
            end += 1
        written += pq_exec.write_parquet_files(
            [(t, os.path.join(data_path, rel.replace("/", os.sep)))
             for _, _, t, rel in planned[at:end]], device=device)
        at = end
    out: List[List[AddFile]] = [[] for _ in tables]
    for (ti, pv, file_data, rel), (size, mtime) in zip(planned, written):
        out[ti].append(AddFile(
            # AddFile.path is URI-encoded per the protocol (a Hive-escaped
            # directory's '%' becomes '%25'); readers unquote once
            path=urllib.parse.quote(rel, safe="/:@!$&'()*+,;=-._~"),
            partition_values=pv, size=size, modification_time=mtime,
            data_change=data_change, stats=pq_exec.stats_json(file_data, num_indexed)))
    return out

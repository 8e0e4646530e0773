"""CONVERT TO DELTA: in-place conversion of a Parquet directory (the port's
own copy of ``delta_tpu.commands.convert``, after
``ConvertToDeltaCommand.scala:73-655``).

List every data file (hidden files and directories skipped), merge the
schemas of the files' footers into one, parse partition values from the
Hive-style directory names against the caller's partition schema (required
when the directory is partitioned), and commit one ``AddFile`` a file at
version 0. An existing table is a no-op. With ``collect_stats`` each file's
stats come from its footer where the footer has safe ones
(``exec/rowgroups.stats_from_footer``) and otherwise from a decode through
the port's reader (the page codec on the log's device); the counters
``convert.stats.fromFooter`` and ``convert.stats.fromDecode`` count each.

The JAX package merges Arrow schemas; the port merges the ``StructType`` it
reads from each footer, with the same rule: a column new to the merge is
appended, and a column that is an integer so far and a float in a later
file becomes the float. The multi-process conversion (a fragment exchange
through the store) is not ported: under more than one process
``distribute=True`` raises ``NotImplementedError``.
"""
from __future__ import annotations

import os
import urllib.parse
from typing import Dict, List, Optional, Tuple

from delta_tpu_torch.commands import operations as ops
from delta_tpu_torch.exec.write import unescape_partition_value
from delta_tpu_torch.protocol.actions import AddFile, Metadata
from delta_tpu_torch.schema.types import (
    ByteType, DoubleType, FloatType, IntegerType, LongType, ShortType, StructType,
)
from delta_tpu_torch.utils import errors, telemetry
from delta_tpu_torch.utils.errors import DeltaFileNotFoundError

__all__ = ["ConvertToDeltaCommand"]

_INTEGERS = (ByteType, ShortType, IntegerType, LongType)
_FLOATS = (FloatType, DoubleType)


def _merge_schemas(a: StructType, b: StructType) -> StructType:
    """The JAX package's ``_merge_arrow`` over Delta schemas: ``b``'s new
    columns appended; an integer column of ``a`` that ``b`` holds as a
    float takes ``b``'s type."""
    names = [f.name for f in a.fields]
    fields = {f.name: f for f in a.fields}
    for f in b.fields:
        if f.name not in fields:
            names.append(f.name)
            fields[f.name] = f
        elif fields[f.name].data_type != f.data_type:
            if (isinstance(fields[f.name].data_type, _INTEGERS)
                    and isinstance(f.data_type, _FLOATS)):
                fields[f.name] = f
    return StructType([fields[n] for n in names])


class ConvertToDeltaCommand:
    def __init__(self, delta_log, partition_schema: Optional[StructType] = None,
                 collect_stats: bool = False, distribute: bool = False):
        self.delta_log = delta_log
        self.partition_schema = partition_schema
        self.collect_stats = collect_stats
        self.distribute = distribute

    def _list_parquet_files(self) -> List[Tuple[str, int, int]]:
        """(relative path, size, mtime ms) of every data file, in sorted
        order."""
        base = self.delta_log.data_path
        out = []
        for root, dirs, files in os.walk(base):
            dirs[:] = sorted(d for d in dirs
                             if not ((d.startswith("_") or d.startswith(".")) and "=" not in d))
            for name in sorted(files):
                if name.startswith("_") or name.startswith(".") or not name.endswith(".parquet"):
                    continue
                abs_p = os.path.join(root, name)
                st = os.stat(abs_p)
                rel = os.path.relpath(abs_p, base).replace(os.sep, "/")
                out.append((rel, st.st_size, int(st.st_mtime * 1000)))
        return out

    def _partition_values(self, rel: str) -> Dict[str, Optional[str]]:
        """The ``col=value`` segments of a file's directory
        (``createDeltaActions :286``)."""
        values: Dict[str, Optional[str]] = {}
        for seg in rel.split("/")[:-1]:
            if "=" not in seg:
                raise errors.partition_path_segment_invalid(seg, rel)
            k, _, v = seg.partition("=")
            values[k] = unescape_partition_value(v)
        expected = [f.name for f in (self.partition_schema.fields
                                     if self.partition_schema else [])]
        if sorted(values) != sorted(expected):
            raise errors.partition_path_mismatch(rel, values, expected)
        return values

    def _abs(self, rel: str) -> str:
        return os.path.join(self.delta_log.data_path, rel.replace("/", os.sep))

    def run(self) -> int:
        from delta_tpu_torch.parallel.distributed import process_info

        log = self.delta_log
        if log.table_exists:
            return log.snapshot.version  # already a table: no-op
        files = self._list_parquet_files()
        if not files:
            raise DeltaFileNotFoundError(f"No parquet files found in {log.data_path} to convert")
        if self.distribute and process_info()[1] > 1:
            raise NotImplementedError(
                "CONVERT TO DELTA across processes (the fragment exchange) is not ported: "
                "ROADMAP.md queue A item 8")
        merged = None
        rows = []
        for rel, size, mtime in files:
            schema, stats = self._read_file(rel)
            merged = schema if merged is None else _merge_schemas(merged, schema)
            rows.append((rel, size, mtime, stats))
        part_fields = list(self.partition_schema.fields) if self.partition_schema else []
        full = StructType(list(merged.fields) + part_fields)
        metadata = Metadata(schema_string=full.to_json(),
                            partition_columns=[f.name for f in part_fields])
        adds = [AddFile(path=urllib.parse.quote(rel, safe="/:@!$&'()*+,;=-._~"),
                        partition_values=self._partition_values(rel), size=size,
                        modification_time=mtime, data_change=True, stats=stats)
                for rel, size, mtime, stats in rows]

        def body(txn):
            txn.update_metadata(metadata)
            return txn.commit(adds, ops.Convert(num_files=len(adds),
                                                partition_by=[f.name for f in part_fields]))

        return log.with_new_transaction(body)

    def _read_file(self, rel: str):
        """A file's schema (its footer's columns, typed as the reader types
        them: no row group decodes) and, with ``collect_stats``, its stats
        JSON."""
        import json

        from delta_tpu_torch.exec.parquet import read_parquet_file, stats_json
        from delta_tpu_torch.exec.rowgroups import read_footer, stats_from_footer
        from delta_tpu_torch.schema.schema_utils import schema_from_table

        abs_p = self._abs(rel)
        device = self.delta_log.device
        meta = read_footer(abs_p)
        schema = schema_from_table(read_parquet_file(abs_p, row_groups=[], meta=meta,
                                                     device=device))
        if not self.collect_stats:
            return schema, None
        try:
            stats = stats_from_footer(meta)
        except Exception:
            stats = None
        if stats is not None:
            telemetry.bump_counter("convert.stats.fromFooter")
            return schema, json.dumps(stats)
        telemetry.bump_counter("convert.stats.fromDecode")
        return schema, stats_json(read_parquet_file(abs_p, meta=meta, device=device))

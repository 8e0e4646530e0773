"""DESCRIBE DETAIL and DESCRIBE HISTORY (the port's own copy of
``delta_tpu.commands.describe``): one detail row (format, id, location,
times, partitioning, counts, properties, protocol) and the CommitInfo
rows, newest first, through the history manager (``log/history``). Left
out: the table-health columns of the JAX package's detail row, which read
its doctor (not ported), and the spans.
"""
from __future__ import annotations

import datetime as _dt
from typing import Any, Dict, List, Optional

__all__ = ["describe_detail", "describe_history"]


def describe_detail(delta_log) -> Dict[str, Any]:
    snapshot = delta_log.update()
    meta = snapshot.metadata
    return {
        "format": "delta",
        "id": meta.id,
        "name": meta.name,
        "description": meta.description,
        "location": delta_log.data_path,
        "createdAt": _ts(meta.created_time),
        "lastModified": _ts(snapshot.timestamp),
        "partitionColumns": list(meta.partition_columns),
        "numFiles": snapshot.num_of_files,
        "sizeInBytes": snapshot.size_in_bytes,
        "properties": dict(meta.configuration or {}),
        "minReaderVersion": snapshot.protocol.min_reader_version,
        "minWriterVersion": snapshot.protocol.min_writer_version,
    }


def describe_history(delta_log, limit: Optional[int] = None) -> List[Dict[str, Any]]:
    return [ci.to_dict() for ci in delta_log.history.get_history(limit)]


def _ts(ms: Optional[int]):
    if ms is None:
        return None
    return _dt.datetime.fromtimestamp(ms / 1000, _dt.timezone.utc)

"""Delta transaction-log actions model + JSON codec.

Byte-compatible with the Delta protocol's action schema (normative spec:
``/root/reference/PROTOCOL.md`` "Actions" section; reference implementation
``core/src/main/scala/org/apache/spark/sql/delta/actions/actions.scala``).
Each commit file is newline-delimited JSON; each line is a single-action
envelope ``{"add": {...}}`` / ``{"remove": {...}}`` / etc.

The port's own copy of ``delta_tpu.protocol.actions``: pure Python, the
host-side log kernel's vocabulary. Change-data (``cdc``) lines decode to
:class:`AddCDCFile`; the state replay skips them, as the reference's does.
"""
from __future__ import annotations

import json
import uuid
import time
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Tuple

from delta_tpu_torch.schema.types import StructType, schema_from_json

__all__ = [
    "Action",
    "Protocol",
    "SetTransaction",
    "FileAction",
    "AddFile",
    "RemoveFile",
    "AddCDCFile",
    "Format",
    "Metadata",
    "JobInfo",
    "NotebookInfo",
    "CommitInfo",
    "action_from_json",
    "action_from_dict",
    "actions_from_lines",
]

# Default protocol versions for new tables.
# Mirrors actions.scala:52-55 (readerVersion=1, writerVersion=4 in the reference).
READER_VERSION = 1
WRITER_VERSION = 4
# The table-features versions the engine reads and writes, and the features
# it supports there (the JAX package's protocol/actions.py:50-59).
SUPPORTED_READER_VERSION = 3
SUPPORTED_WRITER_VERSION = 7
DV_FEATURE_NAME = "tpu.deletionVectors"
SUPPORTED_READER_FEATURES = frozenset({DV_FEATURE_NAME})
SUPPORTED_WRITER_FEATURES = frozenset({DV_FEATURE_NAME})


def _drop_none(d: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v for k, v in d.items() if v is not None}


def _json(obj: Any) -> str:
    # Compact separators to match the reference's Jackson output (no spaces).
    return json.dumps(obj, separators=(",", ":"), ensure_ascii=False)


class Action:
    """Base class. Subclasses implement ``wrap_key`` and ``to_dict``."""

    wrap_key: str = ""

    def to_dict(self) -> Dict[str, Any]:
        raise NotImplementedError

    def wrap(self) -> Dict[str, Any]:
        return {self.wrap_key: self.to_dict()}

    def json(self) -> str:
        return _json(self.wrap())


@dataclass(frozen=True)
class Protocol(Action):
    """Protocol version gate (PROTOCOL.md "Protocol Evolution";
    actions.scala:84-193). Reader 3 / writer 7 are the table-features
    versions: they carry explicit feature-name lists, per the modern Delta
    table-features spec — reader 3 REQUIRES readerFeatures, writer 7
    REQUIRES writerFeatures."""

    min_reader_version: int = READER_VERSION
    min_writer_version: int = WRITER_VERSION
    reader_features: Optional[Tuple[str, ...]] = None
    writer_features: Optional[Tuple[str, ...]] = None

    wrap_key = "protocol"

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "minReaderVersion": self.min_reader_version,
            "minWriterVersion": self.min_writer_version,
        }
        if self.min_reader_version >= 3:
            d["readerFeatures"] = sorted(self.reader_features or ())
        if self.min_writer_version >= 7:
            d["writerFeatures"] = sorted(self.writer_features or ())
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Protocol":
        rf = d.get("readerFeatures")
        wf = d.get("writerFeatures")
        return Protocol(
            int(d["minReaderVersion"]),
            int(d["minWriterVersion"]),
            tuple(rf) if rf is not None else None,
            tuple(wf) if wf is not None else None,
        )


@dataclass(frozen=True)
class SetTransaction(Action):
    """Streaming-sink idempotency marker (PROTOCOL.md "Transaction Identifiers";
    actions.scala:199-216)."""

    app_id: str
    version: int
    last_updated: Optional[int] = None

    wrap_key = "txn"

    def to_dict(self) -> Dict[str, Any]:
        return _drop_none(
            {"appId": self.app_id, "version": self.version, "lastUpdated": self.last_updated}
        )

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "SetTransaction":
        return SetTransaction(d["appId"], int(d["version"]), d.get("lastUpdated"))


class FileAction(Action):
    path: str
    data_change: bool


@dataclass(frozen=True)
class AddFile(FileAction):
    """A data file that is logically part of the table
    (PROTOCOL.md "Add File and Remove File"; actions.scala:220-295)."""

    path: str
    partition_values: Dict[str, Optional[str]] = field(default_factory=dict)
    size: int = 0
    modification_time: int = 0
    data_change: bool = True
    stats: Optional[str] = None  # raw JSON string, parsed lazily
    tags: Optional[Dict[str, str]] = None
    # deletion-vector descriptor dict (protocol/deletion_vectors.py); rows
    # listed there are logically deleted from this file
    deletion_vector: Optional[Dict[str, Any]] = None

    wrap_key = "add"

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "path": self.path,
            "partitionValues": self.partition_values,
            "size": self.size,
            "modificationTime": self.modification_time,
            "dataChange": self.data_change,
        }
        if self.stats is not None:
            d["stats"] = self.stats
        if self.tags is not None:
            d["tags"] = self.tags
        if self.deletion_vector is not None:
            d["deletionVector"] = self.deletion_vector
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "AddFile":
        return AddFile(
            path=d["path"],
            partition_values=dict(d.get("partitionValues") or {}),
            size=int(d.get("size") or 0),
            modification_time=int(d.get("modificationTime") or 0),
            data_change=bool(d.get("dataChange", True)),
            stats=d.get("stats"),
            tags=d.get("tags"),
            deletion_vector=d.get("deletionVector"),
        )

    def remove(self, deletion_timestamp: Optional[int] = None, data_change: bool = True) -> "RemoveFile":
        """Tombstone for this file (actions.scala:245-252). Carries the
        add's deletion vector so vacuum keeps/expires the DV sidecar with
        the data file."""
        ts = deletion_timestamp if deletion_timestamp is not None else int(time.time() * 1000)
        return RemoveFile(
            path=self.path,
            deletion_timestamp=ts,
            data_change=data_change,
            extended_file_metadata=True,
            partition_values=self.partition_values,
            size=self.size,
            tags=self.tags,
            deletion_vector=self.deletion_vector,
        )

    def with_data_change(self, data_change: bool) -> "AddFile":
        return replace(self, data_change=data_change)

    def stats_dict(self) -> Optional[Dict[str, Any]]:
        if self.stats is None:
            return None
        try:
            return json.loads(self.stats)
        except (ValueError, TypeError):
            return None

    @property
    def num_logical_records(self) -> Optional[int]:
        s = self.stats_dict()
        n = s.get("numRecords") if isinstance(s, dict) else None
        # foreign writers may emit "numRecords": null — treat as absent
        return int(n) if isinstance(n, (int, float)) else None


@dataclass(frozen=True)
class RemoveFile(FileAction):
    """Tombstone (PROTOCOL.md "Add File and Remove File";
    actions.scala:307-324)."""

    path: str
    deletion_timestamp: Optional[int] = None
    data_change: bool = True
    extended_file_metadata: Optional[bool] = None
    partition_values: Optional[Dict[str, Optional[str]]] = None
    size: Optional[int] = None
    tags: Optional[Dict[str, str]] = None
    deletion_vector: Optional[Dict[str, Any]] = None

    wrap_key = "remove"

    def to_dict(self) -> Dict[str, Any]:
        return _drop_none(
            {
                "path": self.path,
                "deletionTimestamp": self.deletion_timestamp,
                "dataChange": self.data_change,
                "extendedFileMetadata": self.extended_file_metadata,
                "partitionValues": self.partition_values,
                "size": self.size,
                "tags": self.tags,
                "deletionVector": self.deletion_vector,
            }
        )

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "RemoveFile":
        return RemoveFile(
            path=d["path"],
            deletion_timestamp=d.get("deletionTimestamp"),
            data_change=bool(d.get("dataChange", True)),
            extended_file_metadata=d.get("extendedFileMetadata"),
            partition_values=d.get("partitionValues"),
            size=d.get("size"),
            tags=d.get("tags"),
            deletion_vector=d.get("deletionVector"),
        )

    @property
    def delete_timestamp(self) -> int:
        return self.deletion_timestamp or 0


@dataclass(frozen=True)
class AddCDCFile(FileAction):
    """A change-data file (PROTOCOL.md "Add CDC File"; actions.scala:328-341):
    ``dataChange`` is always false, so it never enters the table state."""

    path: str
    partition_values: Dict[str, Optional[str]] = field(default_factory=dict)
    size: int = 0
    tags: Optional[Dict[str, str]] = None

    wrap_key = "cdc"
    data_change = False

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"path": self.path, "partitionValues": self.partition_values,
                             "size": self.size, "dataChange": False}
        if self.tags is not None:
            d["tags"] = self.tags
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "AddCDCFile":
        return AddCDCFile(path=d["path"], partition_values=dict(d.get("partitionValues") or {}),
                          size=int(d.get("size") or 0), tags=d.get("tags"))


@dataclass(frozen=True)
class Format:
    provider: str = "parquet"
    options: Dict[str, str] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {"provider": self.provider, "options": self.options}

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Format":
        return Format(d.get("provider", "parquet"), dict(d.get("options") or {}))


@dataclass(frozen=True)
class Metadata(Action):
    """Table metadata (PROTOCOL.md "Change Metadata"; actions.scala:348-393)."""

    id: str = field(default_factory=lambda: str(uuid.uuid4()))
    name: Optional[str] = None
    description: Optional[str] = None
    format: Format = field(default_factory=Format)
    schema_string: Optional[str] = None
    partition_columns: List[str] = field(default_factory=list)
    configuration: Dict[str, str] = field(default_factory=dict)
    created_time: Optional[int] = None

    wrap_key = "metaData"

    def to_dict(self) -> Dict[str, Any]:
        return _drop_none(
            {
                "id": self.id,
                "name": self.name,
                "description": self.description,
                "format": self.format.to_dict(),
                "schemaString": self.schema_string,
                "partitionColumns": list(self.partition_columns),
                "configuration": self.configuration,
                "createdTime": self.created_time,
            }
        )

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Metadata":
        return Metadata(
            id=d.get("id") or str(uuid.uuid4()),
            name=d.get("name"),
            description=d.get("description"),
            format=Format.from_dict(d.get("format") or {}),
            schema_string=d.get("schemaString"),
            partition_columns=list(d.get("partitionColumns") or []),
            configuration=dict(d.get("configuration") or {}),
            created_time=d.get("createdTime"),
        )

    @property
    def schema(self) -> StructType:
        """Lazy schema parse (actions.scala:368-372)."""
        if self.schema_string is None:
            return StructType([])
        return schema_from_json(self.schema_string)

    @property
    def data_schema(self) -> StructType:
        part = set(self.partition_columns)
        return StructType([f for f in self.schema.fields if f.name not in part])

    @property
    def partition_schema(self) -> StructType:
        by_name = {f.name: f for f in self.schema.fields}
        return StructType([by_name[c] for c in self.partition_columns if c in by_name])


@dataclass(frozen=True)
class JobInfo:
    job_id: Optional[str] = None
    job_name: Optional[str] = None
    run_id: Optional[str] = None
    job_owner_id: Optional[str] = None
    trigger_type: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        return _drop_none(
            {
                "jobId": self.job_id,
                "jobName": self.job_name,
                "runId": self.run_id,
                "jobOwnerId": self.job_owner_id,
                "triggerType": self.trigger_type,
            }
        )


@dataclass(frozen=True)
class NotebookInfo:
    notebook_id: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        return _drop_none({"notebookId": self.notebook_id})


@dataclass(frozen=True)
class CommitInfo(Action):
    """Provenance record, first action of every commit
    (actions.scala:414-511). Not part of table state reconstruction."""

    version: Optional[int] = None
    timestamp: Optional[int] = None
    user_id: Optional[str] = None
    user_name: Optional[str] = None
    operation: str = ""
    operation_parameters: Dict[str, Any] = field(default_factory=dict)
    job: Optional[JobInfo] = None
    notebook: Optional[NotebookInfo] = None
    cluster_id: Optional[str] = None
    read_version: Optional[int] = None
    isolation_level: Optional[str] = None
    is_blind_append: Optional[bool] = None
    operation_metrics: Optional[Dict[str, str]] = None
    user_metadata: Optional[str] = None
    engine_info: Optional[str] = None
    # per-commit ownership token (actions.scala:489 `txnId`): lets a writer
    # whose create returned an indeterminate error re-read version N and
    # decide won/lost (txn/transaction.py ambiguous-commit reconciliation)
    txn_id: Optional[str] = None

    wrap_key = "commitInfo"

    def to_dict(self) -> Dict[str, Any]:
        return _drop_none(
            {
                "version": self.version,
                "timestamp": self.timestamp,
                "userId": self.user_id,
                "userName": self.user_name,
                "operation": self.operation,
                # operationParameters values are JSON-encoded strings, matching
                # DeltaOperations.scala jsonEncodedValues.
                "operationParameters": self.operation_parameters,
                "job": self.job.to_dict() if self.job else None,
                "notebook": self.notebook.to_dict() if self.notebook else None,
                "clusterId": self.cluster_id,
                "readVersion": self.read_version,
                "isolationLevel": self.isolation_level,
                "isBlindAppend": self.is_blind_append,
                "operationMetrics": self.operation_metrics,
                "userMetadata": self.user_metadata,
                "engineInfo": self.engine_info,
                "txnId": self.txn_id,
            }
        )

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "CommitInfo":
        job = d.get("job")
        notebook = d.get("notebook")
        return CommitInfo(
            version=d.get("version"),
            timestamp=d.get("timestamp"),
            user_id=d.get("userId"),
            user_name=d.get("userName"),
            operation=d.get("operation") or "",
            operation_parameters=dict(d.get("operationParameters") or {}),
            job=JobInfo(
                job.get("jobId"), job.get("jobName"), job.get("runId"),
                job.get("jobOwnerId"), job.get("triggerType"),
            ) if job else None,
            notebook=NotebookInfo(notebook.get("notebookId")) if notebook else None,
            cluster_id=d.get("clusterId"),
            read_version=d.get("readVersion"),
            isolation_level=d.get("isolationLevel"),
            is_blind_append=d.get("isBlindAppend"),
            operation_metrics=d.get("operationMetrics"),
            user_metadata=d.get("userMetadata"),
            engine_info=d.get("engineInfo"),
            txn_id=d.get("txnId"),
        )

    def with_version_timestamp(self, version: int, timestamp: Optional[int] = None) -> "CommitInfo":
        return replace(self, version=version,
                       timestamp=timestamp if timestamp is not None else self.timestamp)


_DECODERS = {
    "add": AddFile.from_dict,
    "remove": RemoveFile.from_dict,
    "cdc": AddCDCFile.from_dict,
    "metaData": Metadata.from_dict,
    "protocol": Protocol.from_dict,
    "txn": SetTransaction.from_dict,
    "commitInfo": CommitInfo.from_dict,
}


def action_from_json(line: str) -> Optional[Action]:
    """Decode one log line into an Action (actions.scala:57-59).
    Unknown single-action keys are ignored (forward compatibility)."""
    if not line or not line.strip():
        return None
    return action_from_dict(json.loads(line))


def action_from_dict(obj: Dict[str, Any]) -> Optional[Action]:
    """Decode one already-parsed log line (the single-action envelope)."""
    for key, decoder in _DECODERS.items():
        if key in obj and obj[key] is not None:
            return decoder(obj[key])
    return None


def actions_from_lines(lines) -> List[Action]:
    out = []
    for line in lines:
        a = action_from_json(line)
        if a is not None:
            out.append(a)
    return out

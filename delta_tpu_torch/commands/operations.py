"""Operations taxonomy — one record per user-facing operation (the port's
own copy of ``delta_tpu.commands.operations``, whole: it is data).

Reference: ``DeltaOperations.scala:35-344``. Each operation carries
JSON-encoded parameters and a whitelist of operation metrics; both feed
``CommitInfo`` and DESCRIBE HISTORY.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

__all__ = [
    "Operation",
    "Write",
    "StreamingUpdate",
    "Delete",
    "Truncate",
    "Merge",
    "Update",
    "CreateTable",
    "ReplaceTable",
    "Convert",
    "Optimize",
    "Vacuum",
    "SetTableProperties",
    "UnsetTableProperties",
    "AddColumns",
    "ChangeColumn",
    "ReplaceColumns",
    "UpgradeProtocol",
    "UpdateSchema",
    "AddConstraint",
    "DropConstraint",
    "ManualUpdate",
]


def _jenc(v: Any) -> str:
    """Parameters are JSON-encoded strings (DeltaOperations jsonEncodedValues)."""
    if isinstance(v, str):
        return v
    return json.dumps(v, separators=(",", ":"))


@dataclass(frozen=True)
class Operation:
    name: str = ""
    parameters: Dict[str, Any] = field(default_factory=dict)
    metric_whitelist: Sequence[str] = ()
    user_metadata: Optional[str] = None

    @property
    def json_encoded_values(self) -> Dict[str, str]:
        return {k: _jenc(v) for k, v in self.parameters.items() if v is not None}

    def changes_data(self) -> bool:
        return True


# Common metric whitelists (DeltaOperationMetrics, DeltaOperations.scala:344+).
WRITE_METRICS = ("numFiles", "numOutputBytes", "numOutputRows")
STREAMING_METRICS = ("numAddedFiles", "numRemovedFiles", "numOutputRows", "numOutputBytes")
DELETE_METRICS = (
    "numAddedFiles", "numRemovedFiles", "numDeletedRows", "numCopiedRows",
    "executionTimeMs", "scanTimeMs", "rewriteTimeMs",
)
DELETE_PARTITIONS_METRICS = ("numRemovedFiles",)
TRUNCATE_METRICS = ("numRemovedFiles",)
MERGE_METRICS = (
    "numSourceRows", "numTargetRowsInserted", "numTargetRowsUpdated",
    "numTargetRowsDeleted", "numTargetRowsCopied", "numOutputRows",
    "numTargetFilesAdded", "numTargetFilesRemoved", "executionTimeMs",
    "scanTimeMs", "rewriteTimeMs",
)
UPDATE_METRICS = (
    "numAddedFiles", "numRemovedFiles", "numUpdatedRows", "numCopiedRows",
    "executionTimeMs", "scanTimeMs", "rewriteTimeMs",
)
CONVERT_METRICS = ("numConvertedFiles",)
OPTIMIZE_METRICS = (
    "numAddedFiles", "numRemovedFiles", "numAddedBytes", "numRemovedBytes",
    "minFileSize", "maxFileSize", "p25FileSize", "p50FileSize", "p75FileSize",
)


def Write(mode: str, partition_by: Optional[List[str]] = None,
          predicate: Optional[str] = None, user_metadata: Optional[str] = None) -> Operation:
    return Operation(
        "WRITE",
        {"mode": mode, "partitionBy": json.dumps(partition_by, separators=(",", ":")) if partition_by is not None else None,
         "predicate": predicate},
        WRITE_METRICS, user_metadata,
    )


def StreamingUpdate(output_mode: str, query_id: str, epoch_id: int,
                    user_metadata: Optional[str] = None) -> Operation:
    return Operation(
        "STREAMING UPDATE",
        {"outputMode": output_mode, "queryId": query_id, "epochId": str(epoch_id)},
        STREAMING_METRICS, user_metadata,
    )


def Delete(predicate: Optional[List[str]] = None) -> Operation:
    return Operation("DELETE", {"predicate": json.dumps(predicate or [], separators=(",", ":"))}, DELETE_METRICS)


def Truncate() -> Operation:
    return Operation("TRUNCATE", {}, TRUNCATE_METRICS)


def Merge(predicate: Optional[str], updates: Sequence[Dict[str, Any]] = (),
          deletes: Sequence[Dict[str, Any]] = (), inserts: Sequence[Dict[str, Any]] = ()) -> Operation:
    return Operation(
        "MERGE",
        {
            "predicate": predicate,
            "matchedPredicates": json.dumps(list(updates) + list(deletes), separators=(",", ":")),
            "notMatchedPredicates": json.dumps(list(inserts), separators=(",", ":")),
        },
        MERGE_METRICS,
    )


def Update(predicate: Optional[str] = None) -> Operation:
    return Operation("UPDATE", {"predicate": predicate}, UPDATE_METRICS)


def CreateTable(metadata, is_managed: bool = False, as_select: bool = False) -> Operation:
    return Operation(
        "CREATE TABLE" + (" AS SELECT" if as_select else ""),
        {
            "isManaged": str(is_managed).lower(),
            "description": metadata.description,
            "partitionBy": json.dumps(metadata.partition_columns, separators=(",", ":")),
            "properties": json.dumps(metadata.configuration, separators=(",", ":")),
        },
        WRITE_METRICS if as_select else (),
    )


def ReplaceTable(metadata, is_managed: bool = False, or_create: bool = False,
                 as_select: bool = False) -> Operation:
    return Operation(
        ("CREATE OR " if or_create else "") + "REPLACE TABLE" + (" AS SELECT" if as_select else ""),
        {
            "isManaged": str(is_managed).lower(),
            "description": metadata.description,
            "partitionBy": json.dumps(metadata.partition_columns, separators=(",", ":")),
            "properties": json.dumps(metadata.configuration, separators=(",", ":")),
        },
        WRITE_METRICS if as_select else (),
    )


def Convert(num_files: int, partition_by: Sequence[str], source_format: str = "parquet") -> Operation:
    return Operation(
        "CONVERT",
        {"numFiles": num_files, "partitionedBy": json.dumps(list(partition_by), separators=(",", ":")),
         "sourceFormat": source_format},
        CONVERT_METRICS,
    )


def Optimize(predicate: Optional[List[str]] = None, z_order_by: Optional[List[str]] = None) -> Operation:
    op = Operation(
        "OPTIMIZE",
        {"predicate": json.dumps(predicate or [], separators=(",", ":")),
         "zOrderBy": json.dumps(z_order_by or [], separators=(",", ":"))},
        OPTIMIZE_METRICS,
    )
    return op


def Reorg(predicate: Optional[List[str]] = None) -> Operation:
    """REORG TABLE ... APPLY (PURGE) — distinct from OPTIMIZE in history so
    DV-materializing rewrites are auditable."""
    return Operation(
        "REORG",
        {"predicate": json.dumps(predicate or [], separators=(",", ":")),
         "applyPurge": True},
        OPTIMIZE_METRICS,
    )


def Vacuum(retention_hours: Optional[float] = None, retention_check_enabled: bool = True) -> Operation:
    return Operation(
        "VACUUM",
        {
            "specifiedRetentionMillis": (
                int(retention_hours * 3_600_000) if retention_hours is not None else None
            ),
            "retentionCheckEnabled": str(retention_check_enabled).lower(),
        },
        (),
    )


def SetTableProperties(properties: Dict[str, str]) -> Operation:
    return Operation("SET TBLPROPERTIES", {"properties": json.dumps(properties, separators=(",", ":"))}, ())


def UnsetTableProperties(keys: List[str], if_exists: bool) -> Operation:
    return Operation(
        "UNSET TBLPROPERTIES",
        {"properties": json.dumps(keys, separators=(",", ":")), "ifExists": str(if_exists).lower()},
        (),
    )


def AddColumns(columns: List[Dict[str, Any]]) -> Operation:
    return Operation("ADD COLUMNS", {"columns": json.dumps(columns, separators=(",", ":"))}, ())


def ChangeColumn(column_name: str, new_column: Dict[str, Any]) -> Operation:
    return Operation(
        "CHANGE COLUMN",
        {"column": json.dumps({column_name: new_column}, separators=(",", ":"))},
        (),
    )


def ReplaceColumns(columns: List[Dict[str, Any]]) -> Operation:
    return Operation("REPLACE COLUMNS", {"columns": json.dumps(columns, separators=(",", ":"))}, ())


def UpgradeProtocol(protocol) -> Operation:
    return Operation(
        "UPGRADE PROTOCOL",
        {"newProtocolVersion": json.dumps(protocol.to_dict(), separators=(",", ":"))},
        (),
    )


def UpdateSchema(old_schema, new_schema) -> Operation:
    return Operation(
        "UPDATE SCHEMA",
        {"oldSchema": old_schema.to_json(), "newSchema": new_schema.to_json()},
        (),
    )


def AddConstraint(name: str, expr: str) -> Operation:
    return Operation("ADD CONSTRAINT", {"name": name, "expr": expr}, ())


def DropConstraint(name: str, expr: Optional[str]) -> Operation:
    return Operation("DROP CONSTRAINT", {"name": name, "expr": expr}, ())


def ManualUpdate() -> Operation:
    """Test-only operation (DeltaOperations.ManualUpdate)."""
    return Operation("Manual Update", {}, ())

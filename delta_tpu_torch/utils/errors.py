"""Error classes the port raises (the port's own copy of the subset of
``delta_tpu.utils.errors`` it needs): the log's, the expression
language's (parser, row evaluator, host evaluator), the transaction's
conflict verdicts, the writer's, the commands' (MERGE, OPTIMIZE, DELETE,
UPDATE, VACUUM) and the history manager's time travel."""
from __future__ import annotations

from typing import Iterable, Optional

__all__ = [
    "replace_requires_existing_table", "unsupported_generate_mode", "column_not_in_schema",
    "invalid_table_identifier", "table_already_exists_in_catalog",
    "table_being_created_concurrently", "table_not_found_in_catalog",
    "partition_path_segment_invalid", "partition_path_mismatch", "unset_nonexistent_property",
    "parent_is_not_struct", "position_after_column_not_found", "invalid_column_position_spec",
    "add_columns_must_be_nullable", "cannot_change_column_type",
    "cannot_change_nullable_to_not_null", "add_column_anchor_not_found",
    "column_already_exists", "struct_not_found_at_position", "drop_column_index_below_zero",
    "add_column_index_below_zero", "add_column_index_too_large", "parent_not_struct",
    "replace_column_index_oob", "array_access_needs_element_step", "nested_op_only_in_struct",
    "drop_column_index_too_large", "array_access_element_path_hint",
    "map_access_needs_key_or_value", "column_path_not_nested", "column_path_not_found",
    "DeltaError", "DeltaAnalysisError", "DeltaIllegalStateError", "DeltaParseError",
    "VersionNotFoundError", "DeltaFileNotFoundError", "TimestampEarlierThanCommitRetentionError",
    "TemporallyUnstableInputError", "invalid_timestamp_format", "update_column_not_found",
    "update_expression_type_mismatch", "retention_period_too_short",
    "versions_not_contiguous", "missing_part_files", "cannot_tokenize_predicate",
    "unexpected_end_of_expression", "trailing_tokens", "unexpected_keyword",
    "bad_column_path", "unexpected_token", "expected_type_name", "parse_expected",
    "column_not_found_in_row", "column_not_found_in_table", "unsupported_function",
    "cannot_compare_types", "cannot_apply_operator", "like_requires_strings",
    "DeltaIllegalArgumentError", "CommitAttemptsExhausted", "DeltaUnsupportedOperationError",
    "SchemaMismatchError", "ProtocolError", "DeltaConcurrentModificationException", "ConcurrentWriteException",
    "MetadataChangedException", "ProtocolChangedException", "ConcurrentAppendException",
    "ConcurrentDeleteReadException", "ConcurrentDeleteDeleteException",
    "ConcurrentTransactionException", "concurrent_write_exception",
    "metadata_changed_exception", "protocol_changed_exception", "concurrent_append_exception",
    "concurrent_delete_read_exception", "concurrent_delete_delete_exception",
    "concurrent_transaction_exception", "modify_append_only_table", "invalid_protocol_version",
    "table_already_exists", "merge_conflicting_set_columns", "invalid_merge_clause",
    "merge_unresolvable_qualifier", "merge_unresolvable_column", "merge_clause_unresolvable",
    "partition_columns_mismatch", "partition_column_not_found", "duplicate_columns",
    "invalid_column_name", "not_a_delta_table", "zorder_column_not_in_schema",
    "zorder_on_partition_column", "OptimizeBudgetExceeded", "InvariantViolationError",
]


class DeltaError(Exception):
    """Base of every error the port raises on purpose."""


class DeltaAnalysisError(DeltaError):
    pass


class DeltaIllegalArgumentError(DeltaError, ValueError):
    pass


class DeltaIllegalStateError(DeltaError, RuntimeError):
    pass


class CommitAttemptsExhausted(DeltaIllegalStateError):
    """The commit retried ``delta.tpu.maxCommitAttempts`` times."""


class DeltaUnsupportedOperationError(DeltaError, NotImplementedError):
    pass


class SchemaMismatchError(DeltaAnalysisError):
    pass


class ProtocolError(DeltaError):
    pass


class DeltaParseError(DeltaAnalysisError):
    pass


class InvariantViolationError(DeltaError):
    """A row-level constraint or NOT NULL violation
    (``schema/InvariantViolationException.scala``)."""


class VersionNotFoundError(DeltaAnalysisError):
    def __init__(self, version: int, earliest: int, latest: int):
        super().__init__(
            f"Cannot time travel Delta table to version {version}. "
            f"Available versions: [{earliest}, {latest}]."
        )
        self.version = version
        self.earliest = earliest
        self.latest = latest


class DeltaFileNotFoundError(DeltaError, FileNotFoundError):
    pass


class TimestampEarlierThanCommitRetentionError(DeltaAnalysisError):
    pass


class TemporallyUnstableInputError(DeltaAnalysisError):
    """The requested timestamp is after the latest commit's."""

    def __init__(self, user_ts, commit_ts, latest_version: int):
        super().__init__(
            f"The provided timestamp ({user_ts}) is after the latest version "
            f"available to this table ({commit_ts}, version {latest_version}).")
        self.commit_ts = commit_ts
        self.latest_version = latest_version


def invalid_timestamp_format(ts, cause=None) -> DeltaAnalysisError:
    tail = f": {cause}" if cause is not None else "."
    return DeltaAnalysisError(
        f"Invalid timestamp {ts!r}. Provide epoch milliseconds or an "
        f"ISO-8601 string like '2024-05-01 12:00:00'{tail}")


def update_column_not_found(column: str) -> DeltaAnalysisError:
    return DeltaAnalysisError(
        f"Column {column!r} not found in table schema. SET clauses may only "
        "assign existing columns.")


def update_expression_type_mismatch(name: str, new_type, old_type) -> DeltaAnalysisError:
    return DeltaAnalysisError(
        f"UPDATE expression for {name} has incompatible type {new_type} "
        f"(column is {old_type})")


def retention_period_too_short(retention_hours: float,
                               configured_hours: float) -> DeltaIllegalArgumentError:
    return DeltaIllegalArgumentError(
        "Are you sure you would like to vacuum files with such a low "
        f"retention period ({retention_hours} hours)? If you have writers "
        "that are currently writing to this table, there is a risk that you "
        "may corrupt the state of your Delta table.\nIf you are certain "
        "there are no operations being performed on this table, such as "
        "insert/upsert/delete/optimize, then you may turn off this check by "
        "setting delta.tpu.retentionDurationCheck.enabled = false\nIf you "
        "are not sure, please use a value not less than "
        f"{configured_hours} hours.")


def missing_part_files(version: int, cause: Exception) -> DeltaIllegalStateError:
    return DeltaIllegalStateError(
        f"Couldn't find all part files of the checkpoint version: {version} ({cause})")


def versions_not_contiguous(versions: Iterable[int]) -> DeltaIllegalStateError:
    return DeltaIllegalStateError(
        f"Versions ({list(versions)}) are not contiguous.")


# -- the expression language's errors (parser, row evaluator, host evaluator) --


def cannot_tokenize_predicate(fragment: str) -> DeltaParseError:
    return DeltaParseError(
        f"Cannot tokenize predicate at {fragment!r}. Check for unbalanced "
        "quotes or unsupported characters.")


def unexpected_end_of_expression(source: str) -> DeltaParseError:
    return DeltaParseError(
        f"Unexpected end of expression: {source!r}. The predicate ends "
        "mid-term — a operand or closing parenthesis is missing.")


def trailing_tokens(token, source: str) -> DeltaParseError:
    return DeltaParseError(
        f"Trailing tokens at {token} in {source!r}. Combine multiple "
        "conditions with AND/OR.")


def unexpected_keyword(text: str, source: str) -> DeltaParseError:
    return DeltaParseError(f"Unexpected keyword {text} in {source!r}.")


def bad_column_path(source: str) -> DeltaParseError:
    return DeltaParseError(
        f"Bad column path after '.' in {source!r}. Nested fields are "
        "addressed as parent.child (backquote names with special characters).")


def unexpected_token(token, source: str) -> DeltaParseError:
    return DeltaParseError(f"Unexpected token {token} in {source!r}.")


def expected_type_name(token) -> DeltaParseError:
    return DeltaParseError(
        f"Expected type name, got {token}. Use a Delta type like INT, "
        "BIGINT, DOUBLE, STRING, DATE, TIMESTAMP, or DECIMAL(p, s).")


def parse_expected(what, got, source: str) -> DeltaParseError:
    return DeltaParseError(f"Expected {what} at token {got} in {source!r}")


def column_not_found_in_row(column: str, available) -> DeltaAnalysisError:
    return DeltaAnalysisError(f"Column not found: {column} in {list(available)}")


def column_not_found_in_table(column: str, available) -> DeltaAnalysisError:
    return DeltaAnalysisError(f"Column {column!r} not found among {list(available)}.")


def unsupported_function(name: str) -> DeltaAnalysisError:
    return DeltaAnalysisError(
        f"Unsupported function: {name}. See delta_tpu_torch.expr.ir.Func.FUNCS "
        "for the supported surface.")


def cannot_compare_types(left: str, right: str, sql: str) -> DeltaAnalysisError:
    return DeltaAnalysisError(f"Cannot compare {left} with {right} in {sql}")


def cannot_apply_operator(op: str, left: str, right: str, sql: str) -> DeltaAnalysisError:
    return DeltaAnalysisError(f"Cannot apply {op!r} to {left} and {right} in {sql}")


def like_requires_strings(got: str, sql: str) -> DeltaAnalysisError:
    return DeltaAnalysisError(f"LIKE requires string operands, got {got} in {sql}")


# -- the transaction's conflict verdicts (DeltaConcurrentExceptions.scala names) --


class DeltaConcurrentModificationException(DeltaError):
    """Base of the OCC conflict hierarchy."""

    def __init__(self, message: str, conflicting_commit: Optional[dict] = None):
        super().__init__(message)
        self.conflicting_commit = conflicting_commit


class ConcurrentWriteException(DeltaConcurrentModificationException):
    pass


class MetadataChangedException(DeltaConcurrentModificationException):
    pass


class ProtocolChangedException(DeltaConcurrentModificationException):
    pass


class ConcurrentAppendException(DeltaConcurrentModificationException):
    pass


class ConcurrentDeleteReadException(DeltaConcurrentModificationException):
    pass


class ConcurrentDeleteDeleteException(DeltaConcurrentModificationException):
    pass


class ConcurrentTransactionException(DeltaConcurrentModificationException):
    pass


def _concurrent_msg(base: str, commit: Optional[dict]) -> str:
    import json

    msg = base
    if commit:
        msg += f"\nConflicting commit: {json.dumps(commit, default=str)}"
    return msg + "\nRefer to https://docs.delta.io/latest/concurrency-control.html for more details."


def concurrent_write_exception(commit: Optional[dict] = None) -> ConcurrentWriteException:
    return ConcurrentWriteException(_concurrent_msg(
        "A concurrent transaction has written new data since the current "
        "transaction read the table. Please try the operation again.", commit), commit)


def metadata_changed_exception(commit: Optional[dict] = None) -> MetadataChangedException:
    return MetadataChangedException(_concurrent_msg(
        "The metadata of the Delta table has been changed by a concurrent "
        "update. Please try the operation again.", commit), commit)


def protocol_changed_exception(commit: Optional[dict] = None) -> ProtocolChangedException:
    additional = ""
    if commit and commit.get("version") == 0:
        additional = ("This happens when multiple writers are writing to an empty "
                      "directory. Creating the table ahead of time will avoid this conflict. ")
    return ProtocolChangedException(_concurrent_msg(
        "The protocol version of the Delta table has been changed by a "
        f"concurrent update. {additional}Please try the operation again.", commit), commit)


def concurrent_append_exception(partition: str, commit: Optional[dict] = None
                                ) -> ConcurrentAppendException:
    return ConcurrentAppendException(_concurrent_msg(
        f"Files were added to {partition} by a concurrent update. "
        "Please try the operation again.", commit), commit)


def concurrent_delete_read_exception(file: str, commit: Optional[dict] = None
                                     ) -> ConcurrentDeleteReadException:
    return ConcurrentDeleteReadException(_concurrent_msg(
        "This transaction attempted to read one or more files that were "
        f"deleted (for example {file}) by a concurrent update. "
        "Please try the operation again.", commit), commit)


def concurrent_delete_delete_exception(file: str, commit: Optional[dict] = None
                                       ) -> ConcurrentDeleteDeleteException:
    return ConcurrentDeleteDeleteException(_concurrent_msg(
        "This transaction attempted to delete one or more files that were "
        f"deleted (for example {file}) by a concurrent update. "
        "Please try the operation again.", commit), commit)


def concurrent_transaction_exception(commit: Optional[dict] = None,
                                     app_id: Optional[str] = None
                                     ) -> ConcurrentTransactionException:
    detail = f" (conflicting appId={app_id})" if app_id else ""
    return ConcurrentTransactionException(_concurrent_msg(
        "This error occurs when multiple streaming queries are using the "
        f"same checkpoint to write into this table{detail}. Did you run "
        "multiple instances of the same streaming query at the same time?", commit), commit)


# -- the writer's and the MERGE command's errors ----------------------------------


def modify_append_only_table() -> DeltaUnsupportedOperationError:
    return DeltaUnsupportedOperationError(
        "This table is configured to only allow appends. If you would like to "
        "permit updates or deletes, use 'ALTER TABLE <table_name> SET "
        "TBLPROPERTIES (delta.appendOnly=false)'.")


def invalid_protocol_version(client_reader: int, client_writer: int, table_reader: int,
                             table_writer: int) -> ProtocolError:
    return ProtocolError(
        f"Delta protocol version (reader={table_reader}, writer={table_writer}) is too new for "
        f"this client (supports reader={client_reader}, writer={client_writer}). "
        "Please upgrade to a newer release.")


def table_already_exists(path: str) -> DeltaAnalysisError:
    return DeltaAnalysisError(
        f"Table already exists: {path}. Use mode='overwrite' / CREATE OR "
        "REPLACE to replace it, or pick a different location.")


def merge_conflicting_set_columns(column: str) -> DeltaAnalysisError:
    return DeltaAnalysisError(
        f"There is a conflict from these SET columns: duplicate assignment to {column!r}.")


def invalid_merge_clause(kind: str, matched: bool) -> DeltaAnalysisError:
    allowed = "UPDATE or DELETE" if matched else "INSERT"
    block = "WHEN MATCHED" if matched else "WHEN NOT MATCHED"
    return DeltaAnalysisError(f"Invalid {block} clause: {kind}. Only {allowed} is allowed here.")


def merge_unresolvable_qualifier(name: str, qualifier: str, target_alias,
                                 source_alias) -> DeltaAnalysisError:
    return DeltaAnalysisError(
        f"Cannot resolve {name!r} in MERGE: qualifier {qualifier!r} matches "
        f"neither target alias {target_alias!r} nor source alias {source_alias!r}")


def merge_unresolvable_column(name: str, target_cols, source_cols) -> DeltaAnalysisError:
    return DeltaAnalysisError(
        f"Cannot resolve {name!r} in MERGE (target={list(target_cols)}, "
        f"source={list(source_cols)})")


def merge_clause_unresolvable(column: str, clause: str, source_cols) -> DeltaAnalysisError:
    return DeltaAnalysisError(
        f"cannot resolve {column} in {clause} clause given columns {list(source_cols)} "
        "(enable delta.tpu.schema.autoMerge.enabled to evolve the target schema instead)")


def partition_columns_mismatch(given, current) -> DeltaAnalysisError:
    return DeltaAnalysisError(f"Partition columns {list(given)} don't match the table's {current}")


def replace_where_mismatch(replace_where: str, detail: str) -> DeltaAnalysisError:
    return DeltaAnalysisError(f"Data written out does not match replaceWhere '{replace_where}'.\n"
                              f"Invalid data would be written to {detail}.")


def replace_where_needs_partition_columns(pred_sql: str, partition_cols) -> DeltaAnalysisError:
    return DeltaAnalysisError(f"replaceWhere {pred_sql!r} must reference only partition columns "
                              f"{partition_cols}")


def partition_column_not_found(column: str, schema_str: str) -> DeltaAnalysisError:
    return DeltaAnalysisError(f"Partition column `{column}` not found in schema {schema_str}")


def decimal_merge_mismatch(cur_precision: int, new_precision: int, cur_scale: int,
                           new_scale: int) -> SchemaMismatchError:
    """Two decimal types of another precision or scale do not merge."""
    if cur_precision != new_precision and cur_scale != new_scale:
        return SchemaMismatchError(
            f"Failed to merge decimal types with incompatible precision {cur_precision} and "
            f"{new_precision} & scale {cur_scale} and {new_scale}")
    if cur_precision != new_precision:
        return SchemaMismatchError(f"Failed to merge decimal types with incompatible precision "
                                   f"{cur_precision} and {new_precision}")
    return SchemaMismatchError(f"Failed to merge decimal types with incompatible scale "
                               f"{cur_scale} and {new_scale}")


def generated_column_type_change(name: str, data_type: str) -> DeltaAnalysisError:
    return DeltaAnalysisError(f"Column {name} is a generated column or a column used by a "
                              f"generated column; its data type {data_type} cannot be changed.")


def duplicate_columns(context: str, first: str, second: str) -> DeltaAnalysisError:
    return DeltaAnalysisError(f"Found duplicate column(s) {context}: {first}, {second}")


def invalid_column_name(name: str) -> DeltaAnalysisError:
    return DeltaAnalysisError(
        f'Attribute name "{name}" contains invalid character(s) among '
        '" ,;{}()\\n\\t=". Please use alias to rename it.')


def not_a_delta_table(identifier: str, operation: Optional[str] = None) -> DeltaAnalysisError:
    if operation:
        return DeltaAnalysisError(
            f"{identifier} is not a Delta table. {operation} is only "
            "supported for Delta tables.")
    return DeltaAnalysisError(f"{identifier} is not a Delta table.")


def zorder_column_not_in_schema(column: str) -> DeltaAnalysisError:
    return DeltaAnalysisError(f"Z-order column {column!r} not in table schema.")


def zorder_on_partition_column(column: str) -> DeltaAnalysisError:
    return DeltaAnalysisError(
        f"Cannot Z-order by partition column {column!r}: partition values "
        "are constant within a file, so they add no clustering. Z-order by "
        "data columns instead.")


class OptimizeBudgetExceeded(DeltaError):
    """The selected rewrite set exceeds ``max_rewrite_bytes``; raised before
    any data is read or written."""

    def __init__(self, est_bytes: int, cap_bytes: int, files: int):
        super().__init__(
            f"OPTIMIZE would rewrite {est_bytes} bytes across {files} "
            f"files, over the {cap_bytes}-byte budget")
        self.est_bytes = est_bytes
        self.cap_bytes = cap_bytes
        self.files = files


# -- the table API's errors: create/replace, the catalog, convert, generate,
# -- ALTER's column edits and nested positions


def replace_requires_existing_table(path: str) -> DeltaAnalysisError:
    return DeltaAnalysisError(
        f"Table not found: {path} (REPLACE requires an existing table; use "
        "CREATE OR REPLACE)")


def unsupported_generate_mode(mode: str) -> DeltaAnalysisError:
    return DeltaAnalysisError(
        f"Unsupported GENERATE mode: {mode!r}. The only supported mode is "
        "'symlink_format_manifest'.")


def invalid_table_identifier(name: str) -> DeltaAnalysisError:
    return DeltaAnalysisError(
        f"Invalid table identifier: {name!r}. Use 'table', 'db.table', or a "
        "path identifier delta.`/path/to/table`.")


def table_already_exists_in_catalog(name: str) -> DeltaAnalysisError:
    return DeltaAnalysisError(
        f"Table {name!r} already exists in catalog. Use CREATE OR REPLACE to "
        "overwrite it, or DROP TABLE first.")


def table_being_created_concurrently(name: str) -> DeltaAnalysisError:
    return DeltaAnalysisError(
        f"Table {name!r} is being created concurrently by another writer. "
        "Wait for that create to finish, or retry the operation.")


def table_not_found_in_catalog(name: str) -> DeltaAnalysisError:
    return DeltaAnalysisError(
        f"Table {name!r} not found in catalog. Check the identifier, or use "
        "a path identifier delta.`/path/to/table` for path-addressed tables.")


def partition_path_segment_invalid(segment: str, rel_path: str) -> DeltaAnalysisError:
    return DeltaAnalysisError(
        f"Expecting partition column in path segment {segment!r} of {rel_path!r}")


def partition_path_mismatch(rel_path: str, found, expected) -> DeltaAnalysisError:
    return DeltaAnalysisError(
        f"Partition columns in path {rel_path!r} ({sorted(found)}) don't "
        f"match the declared partition schema ({sorted(expected)}). "
        "CONVERT TO DELTA requires PARTITIONED BY matching the layout.")


def unset_nonexistent_property(key: str, table: str) -> DeltaAnalysisError:
    return DeltaAnalysisError(
        f"Attempted to unset non-existent property '{key}' in table {table}")


def parent_is_not_struct(parent: str) -> DeltaAnalysisError:
    return DeltaAnalysisError(f"Parent {parent} is not a struct")


def position_after_column_not_found(column: str) -> DeltaAnalysisError:
    return DeltaAnalysisError(
        f"Couldn't find column {column} to position AFTER")


def invalid_column_position_spec(spec: str) -> DeltaAnalysisError:
    return DeltaAnalysisError(
        f"Invalid column position spec {spec!r}. Use FIRST or AFTER "
        "<existing column>.")


def add_columns_must_be_nullable(name: str) -> DeltaAnalysisError:
    return DeltaAnalysisError(
        f"ADD COLUMNS requires nullable columns, {name} is NOT NULL")


def cannot_change_column_type(name: str, old: str, new: str) -> DeltaAnalysisError:
    return DeltaAnalysisError(
        f"Cannot change column {name} from {old} to {new}")


def cannot_change_nullable_to_not_null(name: str) -> DeltaAnalysisError:
    return DeltaAnalysisError(
        f"Cannot change nullable column {name} to NOT NULL")


def add_column_anchor_not_found(column: str) -> DeltaAnalysisError:
    return DeltaAnalysisError(
        f"Couldn't resolve the position to add the column {column}: the "
        "AFTER anchor column does not exist at that nesting level.")


def column_already_exists(column: str) -> DeltaAnalysisError:
    return DeltaAnalysisError(f"Column {column} already exists.")


def struct_not_found_at_position(position) -> DeltaAnalysisError:
    return DeltaAnalysisError(
        f"Struct not found at position {position}; the parent of a nested "
        "column operation must be a struct column.")


def drop_column_index_below_zero(position: int) -> DeltaAnalysisError:
    return DeltaAnalysisError(
        f"Index {position} to drop column is lower than 0")


def add_column_index_below_zero(position: int, name: str) -> DeltaAnalysisError:
    return DeltaAnalysisError(
        f"Index {position} to add column {name} is lower than 0")


def add_column_index_too_large(position: int, name: str, length: int) -> DeltaAnalysisError:
    return DeltaAnalysisError(
        f"Index {position} to add column {name} is larger than struct "
        f"length: {length}")


def parent_not_struct(name: str, found: Optional[str] = None) -> DeltaAnalysisError:
    tail = f" Found {found}" if found else ""
    return DeltaAnalysisError(
        f"Cannot add {name} because its parent is not a StructType.{tail}")


def replace_column_index_oob(position: int) -> DeltaAnalysisError:
    return DeltaAnalysisError(
        f"Index {position} to replace column is out of bounds")


def array_access_needs_element_step(verb: str) -> DeltaAnalysisError:
    return DeltaAnalysisError(
        f"Incorrectly accessing an ArrayType during {verb}: use the element "
        "step")


def nested_op_only_in_struct(verb: str, found: str) -> DeltaAnalysisError:
    return DeltaAnalysisError(
        f"Can only {verb} nested columns inside StructType. Found: {found}")


def drop_column_index_too_large(position: int, length: int) -> DeltaAnalysisError:
    return DeltaAnalysisError(
        f"Index {position} to drop column equals to or is larger than "
        f"struct length: {length}")


def array_access_element_path_hint(corrected_path: str) -> DeltaAnalysisError:
    return DeltaAnalysisError(
        "An ArrayType was found. In order to access elements of an "
        f"ArrayType, specify {corrected_path}")


def map_access_needs_key_or_value(name: str) -> DeltaAnalysisError:
    return DeltaAnalysisError(
        f"Cannot access {name} in a MapType: use key or value")


def column_path_not_nested(path: str) -> DeltaAnalysisError:
    return DeltaAnalysisError(
        f"Column path {path} descends into a non-nested type")


def column_path_not_found(path: str, schema_str: str) -> DeltaAnalysisError:
    return DeltaAnalysisError(
        f"Couldn't find column {path} in schema {schema_str}")


def column_not_in_schema(column: str, schema_cols=None) -> DeltaAnalysisError:
    detail = f" Available columns: {list(schema_cols)}." if schema_cols else ""
    return DeltaAnalysisError(f"Column {column} does not exist.{detail}")


# -- write semantics: constraints, generated and char/varchar columns, CDF ----


def not_null_invariant_violated(column: str, null_rows: Optional[int] = None
                                ) -> InvariantViolationError:
    detail = f" ({null_rows} null rows)" if null_rows else ""
    return InvariantViolationError(f"NOT NULL constraint violated for column: {column}{detail}.")


def check_constraint_violated(name: str, expr_sql: str, values: Optional[dict] = None
                              ) -> InvariantViolationError:
    lines = "".join(f"\n - {c} : {v}" for c, v in (values or {}).items())
    return InvariantViolationError(
        f"CHECK constraint {name} ({expr_sql}) violated by row with values:{lines}")


def new_check_constraint_violated(num: int, table: str, expr: str) -> DeltaAnalysisError:
    return DeltaAnalysisError(f"{num} rows in {table} violate the new CHECK constraint ({expr})")


def char_varchar_length_exceeded(column: str, declared: str, limit: int, sample
                                 ) -> InvariantViolationError:
    return InvariantViolationError(
        f"Exceeds char/varchar type length limitation: column {column} is declared "
        f"{declared} but value {sample!r} is longer than {limit} characters.")


def constraint_already_exists(name: str) -> DeltaAnalysisError:
    return DeltaAnalysisError(
        f"Constraint '{name}' already exists. DROP CONSTRAINT first to replace it.")


def constraint_does_not_exist(name: str, table: str = "") -> DeltaAnalysisError:
    where = f" in table {table}" if table else ""
    return DeltaAnalysisError(f"Constraint '{name}' does not exist{where}. Nothing to drop.")


def invalid_generation_expression(column: str, cause) -> DeltaAnalysisError:
    return DeltaAnalysisError(f"Invalid generation expression for column {column!r}: {cause}")


def generation_expr_unknown_column(column: str, ref: str) -> DeltaAnalysisError:
    return DeltaAnalysisError(
        f"Generation expression for {column!r} references unknown column {ref!r}")


def generation_expr_references_generated(column: str, ref: str) -> DeltaAnalysisError:
    return DeltaAnalysisError(
        f"Generation expression for {column!r} references generated column {ref!r}; "
        "generated columns cannot reference each other")


def generation_expr_type_mismatch(column: str, got, want, cause) -> DeltaAnalysisError:
    return DeltaAnalysisError(
        f"Generation expression for {column!r} produces type {got}, which cannot become "
        f"declared type {want}: {cause}")


def cdf_start_after_latest(start: int, latest: int) -> DeltaAnalysisError:
    return DeltaAnalysisError(
        f"CDF start version {start} is after the latest table version {latest}")


def cdf_start_after_end(start: int, end: int) -> DeltaAnalysisError:
    return DeltaAnalysisError(f"CDF start version {start} is after end version {end}")


def cdf_start_unavailable(start: int, earliest: int) -> DeltaAnalysisError:
    return DeltaAnalysisError(
        f"CDF start version {start} is no longer available (earliest retained commit is "
        f"{earliest}); the change feed for cleaned-up versions is lost")

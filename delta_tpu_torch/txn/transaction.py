"""OptimisticTransaction — snapshot-pinned read/write with OCC commit (the
port's own copy of ``delta_tpu.txn.transaction``).

A transaction pins the table snapshot at creation, records what it reads
(predicates, files, app ids), stages metadata changes, and commits by
atomically creating the next ``<v>.json`` through the log store's
put-if-absent write; on a lost race it replays the winning commits through
the conflict checker (``txn/conflicts``) and retries at the next version.

Cut to what the port's commands run: no group commit, no ambiguous-outcome
reconciliation (the local store's create either lands or raises
``FileExistsError``), no telemetry. After the commit (``_post_commit``) the
log's snapshot is updated, the version's ``.crc`` is written, every
``delta.checkpointInterval`` versions a checkpoint (a failed one leaves the
landed commit standing and logs a warning), then the registered post-commit
hooks run (the symlink manifest, ``hooks/symlink_manifest``, on a table with
``delta.compatibility.symlinkFormatManifest.enabled``; a failing hook logs a
warning). The
async and incremental checkpointer is not ported:
``delta.tpu.checkpoint.async`` set to true raises ``NotImplementedError``.
"""
from __future__ import annotations

import contextvars
import logging
import time
import uuid
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Sequence

from delta_tpu_torch.expr import ir
from delta_tpu_torch.expr import partition as part
from delta_tpu_torch.expr.parser import parse_expression
from delta_tpu_torch.protocol import filenames
from delta_tpu_torch.protocol.actions import (
    DV_FEATURE_NAME, Action, AddCDCFile, AddFile, CommitInfo, Metadata, Protocol, RemoveFile,
    actions_from_lines,
)
from delta_tpu_torch.schema import generated, schema_utils
from delta_tpu_torch.txn import conflicts as conflicts_mod
from delta_tpu_torch.txn import isolation
from delta_tpu_torch.utils import errors
from delta_tpu_torch.utils.config import DeltaConfigs, conf

__all__ = ["OptimisticTransaction", "CommitStats"]

logger = logging.getLogger(__name__)

_active_txn: "contextvars.ContextVar[Optional[OptimisticTransaction]]" = contextvars.ContextVar(
    "active_delta_torch_txn", default=None)


@dataclass
class CommitStats:
    """Per-commit numbers (``OptimisticTransaction.scala:45-71``)."""

    start_version: int = -1
    committed_version: int = -1
    attempts: int = 0
    txn_duration_ms: int = 0
    commit_duration_ms: int = 0
    num_add: int = 0
    num_remove: int = 0
    bytes_new: int = 0
    isolation_level: str = ""
    is_blind_append: bool = False
    phase_durations_ms: Dict[str, int] = field(default_factory=dict)


def _now_ms() -> int:
    return int(time.time() * 1000)


class OptimisticTransaction:
    def __init__(self, delta_log, snapshot=None):
        self.delta_log = delta_log
        self.snapshot = snapshot if snapshot is not None else delta_log.snapshot
        self.read_version: int = self.snapshot.version
        self._start_ms = _now_ms()
        # read-set tracking (OptimisticTransaction.scala:167-179)
        self.read_predicates: List[ir.Expression] = []
        self.read_files: Dict[str, AddFile] = {}
        self.read_the_whole_table: bool = False
        self.read_txn: List[str] = []
        # staged changes
        self.new_metadata: Optional[Metadata] = None
        self.new_protocol: Optional[Protocol] = None
        self._committed = False
        self.commit_isolation_level = isolation.WriteSerializable
        self.staged_removes: List[RemoveFile] = []
        self.operation_metrics: Dict[str, str] = {}
        self.user_metadata: Optional[str] = None
        self.post_commit_hooks: List = []
        self.stats = CommitStats(start_version=self.read_version)

    # -- ambient active transaction (scala:99-144) ----------------------

    @staticmethod
    def set_active(txn: "OptimisticTransaction"):
        if _active_txn.get() is not None:
            raise errors.DeltaIllegalStateError(
                "Cannot set a new txn as active when one is already active")
        return _active_txn.set(txn)

    @staticmethod
    def clear_active(token) -> None:
        _active_txn.reset(token)

    # -- current view ----------------------------------------------------

    @property
    def metadata(self) -> Metadata:
        return self.new_metadata if self.new_metadata is not None else self.snapshot.metadata

    @property
    def protocol(self) -> Protocol:
        return self.new_protocol if self.new_protocol is not None else self.snapshot.protocol

    def txn_version(self, app_id: str) -> int:
        """Latest committed version for a streaming appId; records the read."""
        self.read_txn.append(app_id)
        return self.snapshot.transaction_version(app_id)

    # -- metadata --------------------------------------------------------

    def update_metadata(self, metadata: Metadata) -> None:
        """Stage a metadata update; allowed once per txn
        (``OptimisticTransaction.scala:232-361``)."""
        if self._committed:
            raise errors.DeltaIllegalStateError("Cannot update metadata in a committed txn")
        if self.new_metadata is not None:
            raise errors.DeltaIllegalStateError(
                "Cannot change the metadata more than once in a transaction.")
        if self.read_version == -1 or self.snapshot.metadata.schema_string is None:
            metadata = replace(metadata, configuration=DeltaConfigs.merge_global_configs(
                metadata.configuration))
        if metadata.schema_string is not None:
            schema_utils.check_column_names(metadata.schema)
            schema_utils.check_partition_columns(metadata.partition_columns, metadata.schema)
            generated.validate_generated_columns(metadata.schema)
        cfg = DeltaConfigs.validate_configuration(metadata.configuration)
        metadata = replace(metadata, configuration=cfg)
        # keep table id stable across metadata updates
        if self.read_version >= 0 and self.snapshot.metadata.id:
            metadata = replace(metadata, id=self.snapshot.metadata.id)
        self.new_metadata = metadata
        self.new_protocol = self._required_protocol_upgrade(metadata)

    def _required_protocol_upgrade(self, metadata: Metadata) -> Optional[Protocol]:
        """Feature-driven minimum protocol (``actions.scala:124-159``): writer
        version 4 for generated columns or the change data feed, 3 for CHECK
        constraints, table features (3, 7) for deletion vectors."""
        required_writer = 2
        props = metadata.configuration or {}
        if (generated.has_generated_columns(metadata.schema)
                or props.get("delta.enableChangeDataFeed", "false").lower() == "true"):
            required_writer = 4
        elif any(k.lower().startswith("delta.constraints.") for k in props):
            required_writer = 3
        required_reader = 1
        feature_names: set = set()
        if props.get("delta.tpu.enableDeletionVectors", "false").lower() == "true":
            # DV-bearing files change read semantics: table features (3, 7)
            # with the engine's DV feature listed
            required_reader, required_writer = 3, 7
            feature_names.add(DV_FEATURE_NAME)
        pinned_reader = props.get("delta.minReaderVersion")
        pinned_writer = props.get("delta.minWriterVersion")
        cur = self.protocol
        new_reader = max(cur.min_reader_version, required_reader,
                         int(pinned_reader) if pinned_reader else 1)
        new_writer = max(cur.min_writer_version,
                         required_writer if required_writer > 2 else cur.min_writer_version,
                         int(pinned_writer) if pinned_writer else 1)

        def _features(versions):
            r, w = versions
            names = set(feature_names)
            names.update(cur.reader_features or ())
            names.update(cur.writer_features or ())
            rf = tuple(sorted(names)) if r >= 3 else None
            wf = tuple(sorted(names)) if w >= 7 else None
            return rf, wf

        if self.read_version == -1:
            new_writer = max(2, required_writer, int(pinned_writer) if pinned_writer else 0)
            new_reader = max(1, required_reader, int(pinned_reader) if pinned_reader else 0)
            rf, wf = _features((new_reader, new_writer))
            return Protocol(new_reader, new_writer, rf, wf)
        if (new_reader, new_writer) != (cur.min_reader_version, cur.min_writer_version):
            rf, wf = _features((new_reader, new_writer))
            return Protocol(new_reader, new_writer, rf, wf)
        if feature_names:
            rf, wf = _features((new_reader, new_writer))
            if (set(rf or ()) - set(cur.reader_features or ())
                    or set(wf or ()) - set(cur.writer_features or ())):
                return Protocol(new_reader, new_writer, rf, wf)
        return self.new_protocol

    # -- reads -----------------------------------------------------------

    def filter_files(self, predicates: Optional[Sequence] = None) -> List[AddFile]:
        """Files matching partition ``predicates``; records the read set
        (``OptimisticTransaction.scala:364-380``)."""
        exprs = [parse_expression(p) if isinstance(p, str) else p for p in (predicates or [])]
        pcols = self.metadata.partition_columns
        partition_preds = [e for e in exprs if part.is_partition_predicate(e, pcols)]
        if not exprs:
            self.read_predicates.append(ir.TRUE)
        else:
            self.read_predicates.extend(partition_preds if partition_preds else [ir.TRUE])
        matched = part.filter_files(self.snapshot.all_files, partition_preds, self.metadata)
        self.read_files.update({f.path: f for f in matched})
        return matched

    def read_whole_table(self) -> None:
        """Record a read of every file: any concurrent add conflicts
        (``OptimisticTransaction.scala:381-384``)."""
        self.read_predicates.append(ir.TRUE)
        self.read_the_whole_table = True

    # -- commit ----------------------------------------------------------

    def commit(self, actions: Sequence[Action], op) -> int:
        """Run the commit pipeline; returns the committed version
        (``OptimisticTransaction.scala:422-490``)."""
        t0 = time.perf_counter()
        actions = self._prepare_commit(list(actions))
        self.stats.phase_durations_ms["prepare"] = int((time.perf_counter() - t0) * 1000)
        if DeltaConfigs.SYMLINK_FORMAT_MANIFEST_ENABLED.from_metadata(self.metadata):
            from delta_tpu_torch.hooks.symlink_manifest import SymlinkManifestHook

            self.register_post_commit_hook(SymlinkManifestHook())
        if conf.get_bool("delta.tpu.checkpoint.async", False):
            raise NotImplementedError("delta.tpu.checkpoint.async: the async and incremental "
                                      "checkpointer is not ported")
        # isolation pick (scala:432-440)
        no_data_changed = all(not a.data_change for a in actions
                              if isinstance(a, (AddFile, RemoveFile)))
        if no_data_changed:
            self.commit_isolation_level = isolation.SnapshotIsolation
        else:
            self.commit_isolation_level = isolation.ALL_LEVELS[
                DeltaConfigs.ISOLATION_LEVEL.from_metadata(self.metadata)]
        # blind-append detection (scala:442-447)
        only_add_files = all(isinstance(a, AddFile) for a in actions
                             if isinstance(a, (AddFile, RemoveFile, AddCDCFile)))
        depends_on_files = bool(self.read_predicates) or bool(self.read_files)
        is_blind_append = only_add_files and not depends_on_files
        self.staged_removes = [a for a in actions if isinstance(a, RemoveFile)]
        commit_info = CommitInfo(
            timestamp=_now_ms(),
            operation=op.name,
            operation_parameters=op.json_encoded_values,
            read_version=self.read_version if self.read_version >= 0 else None,
            isolation_level=self.commit_isolation_level.name,
            is_blind_append=is_blind_append,
            operation_metrics=self._final_metrics(op),
            user_metadata=self.user_metadata or op.user_metadata,
            engine_info="delta-tpu-torch/0.1.0",
            txn_id=uuid.uuid4().hex,
        )
        full_actions = [commit_info] + actions
        commit_start = _now_ms()
        t1 = time.perf_counter()
        version = self._do_commit_retry(full_actions)
        self.stats.phase_durations_ms["write"] = max(
            0, int((time.perf_counter() - t1) * 1000)
            - self.stats.phase_durations_ms.get("conflictCheck", 0))
        self._committed = True
        self.stats.committed_version = version
        self.stats.commit_duration_ms = _now_ms() - commit_start
        self.stats.txn_duration_ms = _now_ms() - self._start_ms
        self.stats.isolation_level = self.commit_isolation_level.name
        self.stats.is_blind_append = is_blind_append
        self.stats.num_add = sum(isinstance(a, AddFile) for a in actions)
        self.stats.num_remove = sum(isinstance(a, RemoveFile) for a in actions)
        self.stats.bytes_new = sum(a.size for a in actions
                                   if isinstance(a, AddFile) and a.data_change)
        t2 = time.perf_counter()
        self._post_commit(version)
        self.stats.phase_durations_ms["postCommit"] = int((time.perf_counter() - t2) * 1000)
        return version

    def _post_commit(self, version: int) -> None:
        """The ``.crc``, the interval checkpoint and the hooks
        (scala:582-594, 880-915)."""
        snapshot = self.delta_log.update_after_commit(version)
        if snapshot.version == version:
            self.delta_log.write_checksum_for(snapshot)
        interval = DeltaConfigs.CHECKPOINT_INTERVAL.from_metadata(self.metadata)
        if version != 0 and version % interval == 0:
            try:
                self.delta_log.checkpoint(snapshot if snapshot.version == version
                                          else self.delta_log.get_snapshot_at(version))
            except Exception:  # noqa: BLE001 - a checkpoint must not fail the commit
                logger.warning("Post-commit checkpoint at version %s failed", version,
                               exc_info=True)
        for hook in self.post_commit_hooks:
            try:
                hook.run(self, version, snapshot)
            except Exception as e:  # noqa: BLE001 - a hook must not fail the commit
                logger.warning("Post-commit hook %s failed: %s", getattr(hook, "name", hook), e)

    def register_post_commit_hook(self, hook) -> None:
        if hook not in self.post_commit_hooks:
            self.post_commit_hooks.append(hook)

    def _prepare_commit(self, actions: List[Action]) -> List[Action]:
        """Validation + first-commit injection
        (``OptimisticTransaction.scala:496-579``)."""
        if self._committed:
            raise errors.DeltaIllegalStateError("Transaction already committed.")
        metadata_actions = [a for a in actions if isinstance(a, Metadata)]
        if self.new_metadata is not None:
            if metadata_actions:
                raise errors.DeltaIllegalStateError(
                    "Cannot change the metadata more than once in a transaction.")
            actions = [self.new_metadata] + actions
            metadata_actions = [self.new_metadata]
        if len(metadata_actions) > 1:
            raise errors.DeltaIllegalStateError(
                "Cannot change the metadata more than once in a transaction.")
        if self.new_protocol is not None:
            actions = [self.new_protocol] + actions
        if self.read_version == -1:
            if not any(isinstance(a, Metadata) for a in actions):
                raise errors.DeltaIllegalStateError(
                    "Couldn't find required Metadata action to create the table's first commit.")
            if not any(isinstance(a, Protocol) for a in actions):
                actions = [self.protocol] + actions
        current_metadata = next((a for a in actions if isinstance(a, Metadata)), self.metadata)
        if current_metadata.schema_string is None and any(isinstance(a, AddFile)
                                                          for a in actions):
            raise errors.DeltaIllegalStateError(
                "Table schema is not set. Write data to it or use CREATE TABLE to set the schema.")
        # AddFile partitioning consistency (scala:545-564)
        pcols = current_metadata.partition_columns
        for a in actions:
            if isinstance(a, AddFile) and sorted(a.partition_values.keys()) != sorted(pcols):
                raise errors.DeltaIllegalStateError(
                    f"The AddFile contains partitioning schema different from the table's "
                    f"partitioning schema: {sorted(a.partition_values)} vs {sorted(pcols)}")
        # append-only enforcement (scala:575-576); a deletion-vector re-add
        # deletes rows too
        if DeltaConfigs.IS_APPEND_ONLY.from_metadata(current_metadata):
            for a in actions:
                if isinstance(a, RemoveFile) and a.data_change:
                    raise errors.modify_append_only_table()
                if (self.read_version >= 0 and isinstance(a, AddFile) and a.data_change
                        and a.deletion_vector is not None):
                    raise errors.modify_append_only_table()
        proto = next((a for a in actions if isinstance(a, Protocol)), self.protocol)
        self.delta_log.assert_protocol_write(proto)
        # change data files only on a table with the feed on (actions.scala:151-156)
        if any(isinstance(a, AddCDCFile) for a in actions) \
                and not DeltaConfigs.CHANGE_DATA_FEED.from_metadata(current_metadata):
            raise errors.DeltaUnsupportedOperationError(
                "Cannot write change data files to a table without "
                "delta.enableChangeDataFeed=true")
        return actions

    def _do_commit_retry(self, actions: List[Action]) -> int:
        """Retry loop (``doCommitRetryIteratively``, scala:610-642)."""
        max_attempts = int(conf.get("delta.tpu.maxCommitAttempts"))
        attempt_version = self.read_version + 1
        attempts = 0
        with self.delta_log.lock:
            while True:
                attempts += 1
                self.stats.attempts = attempts
                if attempts > max_attempts:
                    raise errors.CommitAttemptsExhausted(
                        f"This commit has failed as it has been tried {attempts - 1} times "
                        "but did not succeed.")
                try:
                    self._write_commit(attempt_version, actions)
                    return attempt_version
                except FileExistsError:
                    attempt_version = self._check_and_retry(attempt_version)

    def _write_commit(self, version: int, actions: List[Action]) -> None:
        path = f"{self.delta_log.log_path}/{filenames.delta_file(version)}"
        out = []
        for a in actions:
            if isinstance(a, CommitInfo):
                a = a.with_version_timestamp(version)
            out.append(a.json())
        self.delta_log.store.write(path, out, overwrite=False)

    def _check_and_retry(self, failed_version: int) -> int:
        """Replay winning commits through the conflict checker; returns the
        next version to attempt."""
        t0 = time.perf_counter()
        next_attempt = failed_version
        while True:
            path = f"{self.delta_log.log_path}/{filenames.delta_file(next_attempt)}"
            try:
                winning = actions_from_lines(self.delta_log.store.read(path))
            except FileNotFoundError:
                break
            conflicts_mod.check_for_conflicts(self, next_attempt, winning)
            next_attempt += 1
        if next_attempt == failed_version:
            # the write failed but the file doesn't exist: storage lied about
            # mutual exclusion (scala:683-691)
            raise errors.concurrent_write_exception()
        self.stats.phase_durations_ms["conflictCheck"] = (
            self.stats.phase_durations_ms.get("conflictCheck", 0)
            + int((time.perf_counter() - t0) * 1000))
        return next_attempt

    def _final_metrics(self, op) -> Optional[Dict[str, str]]:
        if not conf.get("delta.tpu.history.metricsEnabled"):
            return None
        if not self.operation_metrics:
            return None
        whitelist = set(op.metric_whitelist)
        if not whitelist:
            return dict(self.operation_metrics)
        return {k: v for k, v in self.operation_metrics.items() if k in whitelist}

    def report_metrics(self, **metrics: Any) -> None:
        """DML metrics for ``CommitInfo.operationMetrics``."""
        for k, v in metrics.items():
            self.operation_metrics[k] = str(v)

"""OCC conflict checker (the port's own copy of ``delta_tpu.txn.conflicts``,
whole).

Reference: ``OptimisticTransaction.checkForConflicts``
(``OptimisticTransaction.scala:733-859``). After losing the race to write
``<v>.json``, replay each winning commit and decide whether this transaction's
reads/writes are still valid; if so, retry at the next version.

Conflict matrix (winning commit → our txn):
  * Protocol action               → ProtocolChangedException (always)
  * Metadata action               → MetadataChangedException (always)
  * AddFiles matching our reads   → ConcurrentAppendException
      - under Serializable: all winning adds are checked
      - under WriteSerializable: blind-append commits are exempt
      - under SnapshotIsolation: never checked
  * RemoveFile of a file we read  → ConcurrentDeleteReadException
  * RemoveFile of a file we also remove → ConcurrentDeleteDeleteException
  * SetTransaction appId we read  → ConcurrentTransactionException
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set

from delta_tpu_torch.expr import partition as part
from delta_tpu_torch.protocol.actions import (
    Action,
    AddFile,
    CommitInfo,
    Metadata,
    Protocol,
    RemoveFile,
    SetTransaction,
)
from delta_tpu_torch.txn import isolation
from delta_tpu_torch.utils import errors

__all__ = ["WinningCommitSummary", "check_for_conflicts"]


@dataclass
class WinningCommitSummary:
    version: int
    actions: List[Action]
    protocol: Optional[Protocol] = None
    metadata_updates: List[Metadata] = field(default_factory=list)
    added_files: List[AddFile] = field(default_factory=list)
    removed_files: List[RemoveFile] = field(default_factory=list)
    txns: List[SetTransaction] = field(default_factory=list)
    commit_info: Optional[CommitInfo] = None

    @staticmethod
    def of(version: int, actions: Sequence[Action]) -> "WinningCommitSummary":
        s = WinningCommitSummary(version, list(actions))
        for a in actions:
            if isinstance(a, Protocol):
                s.protocol = a
            elif isinstance(a, Metadata):
                s.metadata_updates.append(a)
            elif isinstance(a, AddFile):
                s.added_files.append(a)
            elif isinstance(a, RemoveFile):
                s.removed_files.append(a)
            elif isinstance(a, SetTransaction):
                s.txns.append(a)
            elif isinstance(a, CommitInfo):
                s.commit_info = a
        return s

    @property
    def is_blind_append(self) -> bool:
        return bool(self.commit_info and self.commit_info.is_blind_append)

    def commit_brief(self) -> Dict:
        ci = self.commit_info
        return {
            "version": self.version,
            "operation": ci.operation if ci else None,
            "timestamp": ci.timestamp if ci else None,
        }


def check_for_conflicts(txn, winning_version: int, actions: Sequence[Action]) -> None:
    """Raise a DeltaConcurrentModificationException subtype if the winning
    commit at ``winning_version`` invalidates ``txn``; return normally if the
    txn can be retried on top of it."""
    summary = WinningCommitSummary.of(winning_version, actions)
    brief = summary.commit_brief()

    # 1. Protocol changed (OptimisticTransaction.scala:763-772)
    if summary.protocol is not None:
        txn.delta_log.assert_protocol_read(summary.protocol)
        txn.delta_log.assert_protocol_write(summary.protocol)
        raise errors.protocol_changed_exception(brief)

    # 2. Metadata changed (scala:774-778)
    if summary.metadata_updates:
        raise errors.metadata_changed_exception(brief)

    # 3. Concurrent appends in regions we read (scala:795-826)
    level = txn.commit_isolation_level
    if level is isolation.Serializable:
        adds_to_check = summary.added_files
    elif level is isolation.WriteSerializable and not summary.is_blind_append:
        adds_to_check = summary.added_files
    else:
        adds_to_check = []
    if adds_to_check:
        pschema = txn.metadata.partition_schema
        conflicting: Optional[AddFile] = None
        if txn.read_the_whole_table:
            conflicting = adds_to_check[0]
        else:
            for pred in txn.read_predicates:
                for f in adds_to_check:
                    if part.matches_maybe(pred, f, pschema):
                        conflicting = f
                        break
                if conflicting:
                    break
        if conflicting is not None:
            raise errors.concurrent_append_exception(
                f"the table (for example {conflicting.path})", brief
            )

    # 4. Deleted files that we read (scala:829-839)
    read_paths: Set[str] = set(txn.read_files)
    for r in summary.removed_files:
        if r.path in read_paths or txn.read_the_whole_table:
            raise errors.concurrent_delete_read_exception(r.path, brief)

    # 5. Delete/delete overlap (scala:842-845)
    our_removed = {a.path for a in txn.staged_removes}
    for r in summary.removed_files:
        if r.path in our_removed:
            raise errors.concurrent_delete_delete_exception(r.path, brief)

    # 6. SetTransaction overlap (scala:848-852)
    read_apps = set(txn.read_txn)
    for t in summary.txns:
        if t.app_id in read_apps:
            raise errors.concurrent_transaction_exception(brief, app_id=t.app_id)

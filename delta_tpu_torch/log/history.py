"""DESCRIBE HISTORY and timestamp -> version resolution for time travel (the
port's own copy of ``delta_tpu.log.history``, ``DeltaHistoryManager.scala``).

Commit timestamps come from the commit files' modification times and can
regress (clock skew, copied files); they are monotonized by clamping each
commit's timestamp to be strictly greater than its predecessor's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from delta_tpu_torch.log.checkpoints import CheckpointInstance, latest_complete_checkpoint
from delta_tpu_torch.protocol import filenames
from delta_tpu_torch.protocol.actions import CommitInfo, actions_from_lines
from delta_tpu_torch.utils.errors import (
    DeltaFileNotFoundError, TemporallyUnstableInputError,
    TimestampEarlierThanCommitRetentionError, VersionNotFoundError,
)

__all__ = ["DeltaHistoryManager", "Commit"]


@dataclass(frozen=True)
class Commit:
    version: int
    timestamp: int  # monotonized millis


class DeltaHistoryManager:
    def __init__(self, delta_log):
        self.delta_log = delta_log

    def get_history(self, limit: Optional[int] = None) -> List[CommitInfo]:
        """Newest-first CommitInfo of each commit, version filled in; stops
        at the first version the log no longer holds."""
        latest = self.delta_log.update().version
        if latest < 0:
            return []
        start = 0 if limit is None else max(0, latest - limit + 1)
        out: List[CommitInfo] = []
        for v in range(latest, start - 1, -1):
            path = f"{self.delta_log.log_path}/{filenames.delta_file(v)}"
            try:
                actions = actions_from_lines(self.delta_log.store.read(path))
            except FileNotFoundError:
                break  # older versions cleaned up
            ci = next((a for a in actions if isinstance(a, CommitInfo)), None)
            if ci is None:
                ci = CommitInfo(version=v)
            elif ci.version is None:
                ci = ci.with_version_timestamp(v)
            out.append(ci)
        return out

    def get_commits(self, start: int = 0, end: Optional[int] = None) -> List[Commit]:
        """Commits in ``[start, end]`` with monotonized timestamps."""
        prefix = f"{self.delta_log.log_path}/{filenames.check_version_prefix(start)}"
        commits: List[Commit] = []
        try:
            statuses = list(self.delta_log.store.list_from(prefix))
        except FileNotFoundError:
            return []
        for fs in statuses:
            if filenames.is_delta_file(fs.name):
                v = filenames.delta_version(fs.name)
                if end is not None and v > end:
                    break
                commits.append(Commit(v, fs.modification_time))
        return _monotonize(commits)

    def get_active_commit_at_time(self, timestamp_ms: int, can_return_last_commit: bool = False,
                                  must_be_recreatable: bool = True,
                                  can_return_earliest_commit: bool = False) -> Commit:
        """The last commit at or before ``timestamp_ms``
        (``DeltaHistoryManager.scala:112-145``)."""
        latest_version = self.delta_log.update().version
        if latest_version < 0:
            raise DeltaFileNotFoundError(f"No commits found at {self.delta_log.log_path}")
        earliest = (self.get_earliest_reproducible_commit() if must_be_recreatable
                    else self.get_earliest_delta_file())
        commits = self.get_commits(earliest, latest_version)
        chosen: Optional[Commit] = None
        for c in commits:
            if c.timestamp <= timestamp_ms:
                chosen = c
            else:
                break
        if chosen is None:
            if can_return_earliest_commit and commits:
                return commits[0]
            if commits:
                raise TimestampEarlierThanCommitRetentionError(
                    f"The provided timestamp ({timestamp_ms}) is before the earliest "
                    f"version available ({commits[0].timestamp}, version "
                    f"{commits[0].version}).")
            raise DeltaFileNotFoundError("No commits found")
        if commits and timestamp_ms > commits[-1].timestamp and not can_return_last_commit:
            raise TemporallyUnstableInputError(timestamp_ms, commits[-1].timestamp,
                                               commits[-1].version)
        return chosen

    def get_earliest_delta_file(self) -> int:
        prefix = f"{self.delta_log.log_path}/{filenames.check_version_prefix(0)}"
        for fs in self.delta_log.store.list_from(prefix):
            if filenames.is_delta_file(fs.name):
                return filenames.delta_version(fs.name)
        raise DeltaFileNotFoundError(f"No delta files found in {self.delta_log.log_path}")

    def get_earliest_reproducible_commit(self) -> int:
        """The earliest version whose state can be rebuilt: 0 with a
        contiguous chain, else the earliest complete checkpoint from which
        the chain is contiguous."""
        prefix = f"{self.delta_log.log_path}/{filenames.check_version_prefix(0)}"
        deltas: List[int] = []
        candidates: List[CheckpointInstance] = []
        for fs in self.delta_log.store.list_from(prefix):
            if filenames.is_delta_file(fs.name):
                deltas.append(filenames.delta_version(fs.name))
            elif filenames.is_checkpoint_file(fs.name) and fs.size > 0:
                part = filenames.checkpoint_part(fs.name)
                candidates.append(CheckpointInstance(filenames.checkpoint_version(fs.name),
                                                     part[1] if part else None))
        if deltas and deltas[0] == 0 and deltas == list(range(deltas[-1] + 1)):
            return 0
        complete = sorted({c.version for c in candidates if latest_complete_checkpoint(
            [x for x in candidates if x.version == c.version])})
        for v in complete:
            following = [d for d in deltas if d > v]
            if not following or following == list(range(v + 1, following[-1] + 1)):
                return v
        raise DeltaFileNotFoundError(
            f"No recreatable commits found at {self.delta_log.log_path}")

    def check_version_exists(self, version: int, must_be_recreatable: bool = True) -> None:
        earliest = (self.get_earliest_reproducible_commit() if must_be_recreatable
                    else self.get_earliest_delta_file())
        latest = self.delta_log.update().version
        if version < earliest or version > latest:
            raise VersionNotFoundError(version, earliest, latest)


def _monotonize(commits: List[Commit]) -> List[Commit]:
    """Clamp timestamps strictly increasing
    (``DeltaHistoryManager.monotonizeCommitTimestamps``)."""
    out: List[Commit] = []
    prev = None
    for c in commits:
        ts = c.timestamp
        if prev is not None and ts <= prev:
            ts = prev + 1
        out.append(Commit(c.version, ts))
        prev = ts
    return out

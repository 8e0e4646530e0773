"""Log-segment listing (the port's own copy of
``delta_tpu.log.snapshot_management``).

A segment is the newest complete checkpoint at or below the version
(``log/checkpoints``) plus the contiguous JSON commits after it, or, with
no checkpoint, the commits from version 0. So a log whose early commits
were cleaned up behind a checkpoint opens, and time travel to a version
before the oldest checkpoint such a log keeps raises as in the JAX package.
"""
from __future__ import annotations

from typing import List, Optional

from delta_tpu_torch.log import checkpoints as ckpt_mod
from delta_tpu_torch.log.checkpoints import CheckpointInstance
from delta_tpu_torch.protocol import filenames
from delta_tpu_torch.storage.logstore import FileStatus, LocalLogStore
from delta_tpu_torch.utils.errors import DeltaIllegalStateError, versions_not_contiguous

__all__ = ["LogSegment", "list_log_files", "get_log_segment_for_version",
           "verify_delta_versions"]


class LogSegment:
    """The files that define a version: checkpoint parts, then the
    contiguous deltas after them (``SnapshotManagement.scala:394-421``)."""

    def __init__(self, log_path: str, version: int, deltas: List[FileStatus],
                 checkpoint_files: List[FileStatus] = (),
                 checkpoint_version: Optional[int] = None):
        self.log_path = log_path
        self.version = version
        self.deltas = list(deltas)
        self.checkpoint_files = list(checkpoint_files)
        self.checkpoint_version = checkpoint_version

    def __eq__(self, other) -> bool:
        return (isinstance(other, LogSegment) and self.log_path == other.log_path
                and self.version == other.version
                and [f.path for f in self.deltas] == [f.path for f in other.deltas]
                and [f.path for f in self.checkpoint_files]
                == [f.path for f in other.checkpoint_files])

    def __repr__(self) -> str:
        return (f"LogSegment(v={self.version}, ckpt={self.checkpoint_version}, "
                f"deltas={len(self.deltas)})")


def list_log_files(store: LocalLogStore, log_path: str, start_version: int) -> List[FileStatus]:
    """Delta and checkpoint files with version >= start_version."""
    prefix = f"{log_path}/{filenames.check_version_prefix(start_version)}"
    try:
        return [fs for fs in store.list_from(prefix)
                if filenames.is_delta_file(fs.name) or filenames.is_checkpoint_file(fs.name)]
    except FileNotFoundError:
        return []


def verify_delta_versions(versions: List[int], expected_start: Optional[int] = None,
                          expected_end: Optional[int] = None) -> None:
    """Contiguity check (``SnapshotManagement.scala:365-372``)."""
    if versions and versions != list(range(versions[0], versions[-1] + 1)):
        raise versions_not_contiguous(versions)
    if expected_start is not None and (not versions or versions[0] != expected_start):
        raise DeltaIllegalStateError(
            f"Did not get the first delta file version {expected_start} to compute snapshot")
    if expected_end is not None and (not versions or versions[-1] != expected_end):
        raise DeltaIllegalStateError(
            f"Did not get the last delta file version {expected_end} to compute snapshot")


def get_log_segment_for_version(
    store: LocalLogStore, log_path: str, version_to_load: Optional[int] = None,
    start_checkpoint: Optional[int] = None, excluded_checkpoints: frozenset = frozenset(),
) -> Optional[LogSegment]:
    """The segment for ``version_to_load`` (latest if None), the listing
    starting at ``start_checkpoint`` (from ``_last_checkpoint``) where given
    (``SnapshotManagement.scala:82-179``); None when the directory holds no
    commit at all. Checkpoint versions in ``excluded_checkpoints`` (known
    corrupt) are skipped."""
    if (version_to_load is not None and start_checkpoint is not None
            and start_checkpoint > version_to_load):
        start_checkpoint = None
    if excluded_checkpoints and start_checkpoint in excluded_checkpoints:
        start_checkpoint = None
    files = [f for f in list_log_files(store, log_path, start_checkpoint or 0)
             if f.size > 0 or filenames.is_delta_file(f.name)]
    if version_to_load is not None:
        files = [f for f in files if (filenames.get_file_version(f.name) or 0) <= version_to_load]
    if not files:
        if start_checkpoint:
            # the pointer names a vanished checkpoint: list from 0
            return get_log_segment_for_version(store, log_path, version_to_load, None,
                                               excluded_checkpoints)
        return None
    candidates: List[CheckpointInstance] = []
    statuses = {}
    deltas: List[FileStatus] = []
    for f in files:
        if filenames.is_checkpoint_file(f.name) and f.size > 0:
            v = filenames.checkpoint_version(f.name)
            if v in excluded_checkpoints:
                continue
            part = filenames.checkpoint_part(f.name)
            inst = CheckpointInstance(v, part[1] if part else None)
            candidates.append(inst)
            statuses.setdefault(inst, []).append(f)
        elif filenames.is_delta_file(f.name):
            deltas.append(f)
    latest = ckpt_mod.latest_complete_checkpoint(candidates, not_later_than=version_to_load)
    if latest is not None:
        ckpt_version = latest.version
        ckpt_files = sorted(statuses[latest], key=lambda s: s.name)
        after = sorted((f for f in deltas if filenames.delta_version(f.name) > ckpt_version),
                       key=lambda f: filenames.delta_version(f.name))
        versions = [filenames.delta_version(f.name) for f in after]
        if versions:
            verify_delta_versions(versions, expected_start=ckpt_version + 1)
        new_version = versions[-1] if versions else ckpt_version
        if version_to_load is not None and new_version != version_to_load:
            raise DeltaIllegalStateError(
                f"Trying to load version {version_to_load} but log only goes to {new_version}")
        return LogSegment(log_path, new_version, after, ckpt_files, ckpt_version)
    if start_checkpoint:
        # the pointer lied (its checkpoint is gone or incomplete): list from 0
        return get_log_segment_for_version(store, log_path, version_to_load, None,
                                           excluded_checkpoints)
    deltas.sort(key=lambda f: filenames.delta_version(f.name))
    versions = [filenames.delta_version(f.name) for f in deltas]
    if not versions:
        return None
    verify_delta_versions(versions, expected_start=0, expected_end=version_to_load)
    return LogSegment(log_path, versions[-1], deltas)

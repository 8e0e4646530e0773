"""Streaming sources: the initial snapshot, then the log tail under
admission control (the port's own copy of ``delta_tpu.streaming.source``,
``sources/DeltaSource.scala:57-539``).

* The first read serves the initial snapshot as indexed batches
  (``DeltaSourceSnapshot``: files sorted by modification time and path);
  then the source tails the log through ``DeltaLog.get_changes``.
* Admission control caps a micro-batch by ``maxFilesPerTrigger`` (1000 by
  default) and ``maxBytesPerTrigger``, and always admits one file.
* Hygiene: a commit that removes or rewrites data fails the stream unless
  ``ignoreDeletes`` (delete-only commits) or ``ignoreChanges`` (rewrites,
  whose files are re-emitted) is set; a schema change always fails it.
* ``startingVersion`` / ``startingTimestamp`` skip the initial snapshot.

Batches decode through ``exec/scan.read_files_as_table`` on the table's
device, so their pages inflate through the page codec as any read's.
:class:`DeltaCDFSource` serves the change data feed instead of rows.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence

from delta_tpu_torch.exec import cdf as cdf_exec
from delta_tpu_torch.exec.scan import read_files_as_table
from delta_tpu_torch.expr import ir
from delta_tpu_torch.expr.parser import parse_predicate
from delta_tpu_torch.expr.vectorized import HostTable, filter_table
from delta_tpu_torch.protocol.actions import (
    Action, AddCDCFile, AddFile, Metadata, Protocol, RemoveFile,
)
from delta_tpu_torch.schema.char_varchar import pad_char_literals
from delta_tpu_torch.streaming.offset import DeltaSourceOffset
from delta_tpu_torch.utils.errors import DeltaAnalysisError, DeltaIllegalStateError
from delta_tpu_torch.utils.timeparse import timestamp_option_to_ms

__all__ = ["IndexedFile", "AdmissionLimits", "DeltaSource", "DeltaCDFSource"]

BASE_INDEX = -1  # an offset index: before any file of its version
# an offset index: the version fully consumed (the move from the initial
# snapshot to the log tail without re-serving the version's adds)
VERSION_DONE_INDEX = 1 << 30


@dataclass(frozen=True)
class IndexedFile:
    """(version, index, add): one admissible unit (``DeltaSource.scala:57-74``)."""

    version: int
    index: int
    add: Optional[AddFile]  # None for a version sentinel
    is_last: bool = False


class AdmissionLimits:
    """The caps of one trigger (``DeltaSource.scala`` AdmissionLimits)."""

    def __init__(self, max_files: Optional[int] = 1000, max_bytes: Optional[int] = None):
        self.files_left = max_files if max_files is not None else float("inf")
        self.bytes_left = max_bytes if max_bytes is not None else float("inf")
        self._admitted_any = False

    def admit(self, add: Optional[AddFile]) -> bool:
        if add is None:
            return True
        size = add.size or 0
        # one file always passes, so the stream cannot stall
        ok = (self.files_left >= 1 and self.bytes_left >= size) or not self._admitted_any
        if ok:
            self.files_left -= 1
            self.bytes_left -= size
            self._admitted_any = True
        return ok


class DeltaSource:
    def __init__(self, delta_log, max_files_per_trigger: Optional[int] = 1000,
                 max_bytes_per_trigger: Optional[int] = None, ignore_deletes: bool = False,
                 ignore_changes: bool = False, fail_on_data_loss: bool = True,
                 exclude_regex: Optional[str] = None, starting_version=None,
                 starting_timestamp: Optional[str] = None, filters: Optional[Sequence] = None):
        self.delta_log = delta_log
        self.max_files = max_files_per_trigger
        self.max_bytes = max_bytes_per_trigger
        self.ignore_deletes = ignore_deletes
        self.ignore_changes = ignore_changes
        self.fail_on_data_loss = fail_on_data_loss
        self.exclude = re.compile(exclude_regex) if exclude_regex else None
        # a pushed-down row filter: it rides into the decode (row-group
        # skipping) and is applied exactly after it; offsets and admission
        # do not see it. The CDF source ignores it
        self.filters = [parse_predicate(f) if isinstance(f, str) else f for f in filters or []]
        if starting_version is not None and starting_timestamp is not None:
            raise DeltaAnalysisError("Cannot set both startingVersion and startingTimestamp")
        self.starting_version = starting_version
        self.starting_timestamp = starting_timestamp
        snap = delta_log.update()
        self.table_id = snap.metadata.id or ""
        self._initial_schema = snap.metadata.schema_string

    # -- file enumeration -------------------------------------------------

    def _resolve_starting_version(self) -> Optional[int]:
        if self.starting_version is not None:
            if self.starting_version == "latest":
                return self.delta_log.update().version + 1
            return int(self.starting_version)
        if self.starting_timestamp is not None:
            return self.delta_log.history.get_active_commit_at_time(
                timestamp_option_to_ms(self.starting_timestamp), can_return_last_commit=True,
                can_return_earliest_commit=True).version
        return None

    def _initial_snapshot_files(self, version: int) -> List[IndexedFile]:
        """The table's state at ``version`` as one fixed indexed sequence
        (``files/DeltaSourceSnapshot.scala``)."""
        if version < 0:
            return []
        snap = self.delta_log.get_snapshot_at(version)
        files = sorted(snap.all_files, key=lambda f: (f.modification_time or 0, f.path))
        out = [IndexedFile(version, i, f) for i, f in enumerate(files)
               if self.exclude is None or not self.exclude.search(f.path)]
        if out:
            out[-1] = IndexedFile(out[-1].version, out[-1].index, out[-1].add, is_last=True)
        return out

    def _verify_schema_and_protocol(self, version: int, actions: Sequence[Action]) -> None:
        """The schema and protocol checks every source makes (the CDF source
        waives the change and delete errors, never these)."""
        for a in actions:
            if isinstance(a, Metadata):
                if a.schema_string != self._initial_schema:
                    raise DeltaIllegalStateError(
                        f"Detected schema change at version {version}; streaming sources "
                        "don't support schema changes — restart the query")
            elif isinstance(a, Protocol):
                self.delta_log.assert_protocol_read(a)

    def _verify_hygiene(self, version: int, actions: Sequence[Action]) -> None:
        """``verifyStreamHygieneAndFilterAddFiles`` (``DeltaSource.scala:312-355``)."""
        self._verify_schema_and_protocol(version, actions)
        removes = [a for a in actions if isinstance(a, RemoveFile) and a.data_change]
        adds = [a for a in actions if isinstance(a, AddFile) and a.data_change]
        if removes and adds and not self.ignore_changes:
            raise DeltaIllegalStateError(
                f"Detected a data update at version {version} (e.g. {removes[0].path}). This "
                "is currently not supported — set ignoreChanges to re-emit updated files, or "
                "restart from a fresh checkpoint")
        if removes and not adds and not (self.ignore_deletes or self.ignore_changes):
            raise DeltaIllegalStateError(
                f"Detected deleted data (e.g. {removes[0].path}) at version {version}. This is "
                "currently not supported — set ignoreDeletes or use a snapshot-only read")

    def _changes_from(self, version: int, start_index: int) -> Iterator[IndexedFile]:
        for v, actions in self.delta_log.get_changes(version,
                                                     fail_on_data_loss=self.fail_on_data_loss):
            self._verify_hygiene(v, actions)
            adds = [a for a in actions if isinstance(a, AddFile) and a.data_change
                    and (self.exclude is None or not self.exclude.search(a.path))]
            for idx, a in enumerate(adds):
                if v == version and idx <= start_index:
                    continue  # consumed
                yield IndexedFile(v, idx, a, is_last=idx == len(adds) - 1)
            if not adds and v > version:
                # a sentinel lets the offset pass a data-less commit; the
                # start version is consumed (serving it again would make
                # latest_offset spin after, say, an OPTIMIZE)
                yield IndexedFile(v, BASE_INDEX, None, is_last=True)

    # -- offsets ----------------------------------------------------------

    def initial_offset(self) -> DeltaSourceOffset:
        sv = self._resolve_starting_version()
        if sv is not None:
            return DeltaSourceOffset(sv, BASE_INDEX, False, self.table_id)
        return DeltaSourceOffset(self.delta_log.update().version, BASE_INDEX, True, self.table_id)

    def latest_offset(self, start: DeltaSourceOffset) -> Optional[DeltaSourceOffset]:
        """The next micro-batch's end under the admission limits; None when
        there is nothing new. A batch never crosses the initial snapshot's
        end: draining it yields one empty batch that moves the offset into
        tail mode, so a recovered ``get_batch(None, end)`` re-anchors on the
        snapshot version."""
        limits = AdmissionLimits(self.max_files, self.max_bytes)
        last: Optional[IndexedFile] = None
        tail_has_data = False
        for f in self._pending(start):
            if start.is_starting_version and f.version != start.reservoir_version:
                tail_has_data = True
                break
            if not limits.admit(f.add):
                break
            last = f
        if last is None:
            if start.is_starting_version and tail_has_data:
                return DeltaSourceOffset(start.reservoir_version, VERSION_DONE_INDEX, False,
                                         self.table_id)
            return None
        is_starting = start.is_starting_version and last.version == start.reservoir_version
        return DeltaSourceOffset(last.version, last.index, is_starting, self.table_id)

    def _pending(self, start: DeltaSourceOffset) -> Iterator[IndexedFile]:
        if start.is_starting_version:
            for f in self._initial_snapshot_files(start.reservoir_version):
                if f.index > start.index:
                    yield f
            yield from self._changes_from(start.reservoir_version + 1, BASE_INDEX)
        else:
            yield from self._changes_from(start.reservoir_version, start.index)

    def _anchor(self, start: Optional[DeltaSourceOffset], end: DeltaSourceOffset
                ) -> Optional[DeltaSourceOffset]:
        """Batch 0's start (``start`` None, maybe a recovered batch) anchors
        on the planned end, never on the table's current version; None is
        the empty move into tail mode."""
        if start is not None:
            return start
        if end.is_starting_version:
            return DeltaSourceOffset(end.reservoir_version, BASE_INDEX, True, self.table_id)
        sv = self._resolve_starting_version()
        if sv is not None:
            return DeltaSourceOffset(sv, BASE_INDEX, False, self.table_id)
        return None

    def get_batch(self, start: Optional[DeltaSourceOffset], end: DeltaSourceOffset) -> HostTable:
        """The files in (start, end] decoded to one table."""
        anchor = self._anchor(start, end)
        if anchor is None:
            return self.get_batch(end, end)
        files: List[AddFile] = []
        for f in self._pending(anchor):
            if (f.version, f.index) > (end.reservoir_version, end.index):
                break
            if f.add is not None:
                files.append(f.add)
        snap = self.delta_log.update()
        pred = None
        if self.filters:
            pred = pad_char_literals(ir.and_all(list(self.filters)), snap.metadata)
        table = read_files_as_table(self.delta_log.data_path, files, snap.metadata,
                                    predicate=pred, device=self.delta_log.device)
        if pred is not None and table.num_rows:
            table = filter_table(table, pred)
        return table


class DeltaCDFSource(DeltaSource):
    """A streaming source over the change data feed: batches carry change
    rows (``_change_type``, ``_commit_version``, ``_commit_timestamp``). The
    initial snapshot is served as ``insert`` rows at its version; the tail
    is one unit a commit (``exec/cdf.read_changes``). Updates and deletes
    are what this source is for, so the row source's hygiene errors do not
    apply; a schema change or a protocol upgrade still fails it."""

    def _verify_hygiene(self, version: int, actions: Sequence[Action]) -> None:
        self._verify_schema_and_protocol(version, actions)

    def _changes_from(self, version: int, start_index: int) -> Iterator[IndexedFile]:
        # one unit a commit, index 0; its stand-in AddFile sizes it for
        # admission (maxFilesPerTrigger counts commits, maxBytesPerTrigger
        # the commit's changed bytes)
        for v, actions in self.delta_log.get_changes(version,
                                                     fail_on_data_loss=self.fail_on_data_loss):
            self._verify_hygiene(v, actions)
            if v == version and start_index >= 0:
                continue  # consumed
            changed = sum(a.size or 0 for a in actions if isinstance(a, (AddFile, AddCDCFile)))
            yield IndexedFile(v, 0, AddFile(path=f"__commit-{v}__", size=changed), is_last=True)

    def get_batch(self, start: Optional[DeltaSourceOffset], end: DeltaSourceOffset) -> HostTable:
        anchor = self._anchor(start, end)
        if anchor is None:
            return self.get_batch(end, end)
        snap = self.delta_log.update()
        parts: List[HostTable] = []
        if anchor.is_starting_version:
            files = [f.add for f in self._initial_snapshot_files(anchor.reservoir_version)
                     if f.index > anchor.index
                     and (f.version, f.index) <= (end.reservoir_version, end.index)
                     and f.add is not None]
            if files:
                t = read_files_as_table(self.delta_log.data_path, files, snap.metadata,
                                        device=self.delta_log.device)
                sv = anchor.reservoir_version
                snap_commits = self.delta_log.history.get_commits(sv, sv)
                ts = snap_commits[0].timestamp if snap_commits else 0
                t = t.append_column(cdf_exec.CHANGE_TYPE_COL, cdf_exec.constant_column("insert", t.num_rows))
                t = t.append_column(cdf_exec.COMMIT_VERSION_COL, cdf_exec.constant_column(sv, t.num_rows))
                parts.append(t.append_column(cdf_exec.COMMIT_TIMESTAMP_COL, cdf_exec.constant_column(ts, t.num_rows)))
        # the tail versions wholly inside (start, end]
        if anchor.is_starting_version or anchor.index >= 0:
            tail_first = anchor.reservoir_version + 1
        else:
            tail_first = anchor.reservoir_version
        if not end.is_starting_version and end.reservoir_version >= tail_first:
            parts.append(cdf_exec.read_changes(self.delta_log, tail_first, end.reservoir_version))
        if not parts:
            return cdf_exec.empty_changes()
        return cdf_exec.concat_permissive(parts)

"""DeltaLog: the per-table handle (the port's own copy of
``delta_tpu.log.deltalog``): the log store, snapshot updates (listing from
``_last_checkpoint``), a per-(path, device) singleton cache, time travel
by version or timestamp (``snapshot_for``, through ``log/history``), the
protocol gates, the transactions (``txn/transaction``), checkpoints
(``log/checkpoints``) with the expired-log cleanup after them
(``log/cleanup``), the ``.crc`` of a committed version
(``log/checksum``), the explicit protocol upgrade, and the ``path@v123`` /
``path@yyyyMMddHHmmssSSS`` handles (:func:`extract_path_time_travel`).

An ``update()`` that finds only new commits decodes just those and extends
the previous snapshot's columnar state (when it was decoded), where the JAX
package re-decodes the whole segment: the JSON decode is pure Python here.

``device`` is the device the table's resident scan state lives on
(``ops/state_cache``); it defaults to ``"cuda"`` and is never swapped for
the CPU behind the caller's back.
"""
from __future__ import annotations

import datetime as _dt
import logging
import re
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

import torch

from delta_tpu_torch.log import checkpoints as ckpt_mod
from delta_tpu_torch.log import checksum as crc_mod
from delta_tpu_torch.log import snapshot_management as sm
from delta_tpu_torch.log.columnar import decode_segment, extend_segment_columns
from delta_tpu_torch.log.snapshot import Snapshot
from delta_tpu_torch.protocol.actions import (
    READER_VERSION, SUPPORTED_READER_FEATURES, SUPPORTED_READER_VERSION,
    SUPPORTED_WRITER_FEATURES, SUPPORTED_WRITER_VERSION, WRITER_VERSION, Action, Protocol,
    actions_from_lines,
)
from delta_tpu_torch.protocol import filenames
from delta_tpu_torch.storage.logstore import LocalLogStore
from delta_tpu_torch.utils import errors as errors_mod
from delta_tpu_torch.utils.device import resolve
from delta_tpu_torch.utils.config import DeltaConfigs, conf
from delta_tpu_torch.utils.errors import (
    DeltaIllegalStateError, ProtocolError, VersionNotFoundError,
)

__all__ = ["DeltaLog", "extract_path_time_travel"]

logger = logging.getLogger(__name__)

# path-embedded time travel (`DeltaTimeTravelSpec.scala:137`): `/t@v123` pins
# a version, `/t@yyyyMMddHHmmssSSS` (17 digits) a timestamp
_TT_SUFFIX = re.compile(r"^(?P<base>.+)@(?:[vV](?P<ver>\d+)|(?P<ts>\d{17}))$")


def extract_path_time_travel(path: str):
    """(base_path, version, timestamp_ms) when ``path`` carries an embedded
    time-travel suffix, else None. Callers apply it only when the literal
    path is not itself a table. The timestamp's digits are a UTC wall clock,
    as in the JAX package (the reference reads them in the session's zone)."""
    m = _TT_SUFFIX.match(path.rstrip("/"))
    if not m:
        return None
    base = m.group("base")
    if m.group("ver") is not None:
        return base, int(m.group("ver")), None
    s = m.group("ts")
    try:
        d = _dt.datetime.strptime(s[:14], "%Y%m%d%H%M%S").replace(tzinfo=_dt.timezone.utc)
    except ValueError:
        return None
    return base, None, int(d.timestamp() * 1000) + int(s[14:])


class DeltaLog:
    _cache: Dict[Tuple[str, str], "DeltaLog"] = {}
    _cache_lock = threading.Lock()

    def __init__(self, data_path: str, device="cuda",
                 store: Optional[LocalLogStore] = None):
        self.data_path = data_path.rstrip("/")
        self.log_path = f"{self.data_path}/_delta_log"
        self.device: torch.device = resolve(device)
        self.store = store or LocalLogStore()
        self._snapshot: Optional[Snapshot] = None
        self._update_lock = threading.Lock()
        # serializes this process's commits to the table (txn/transaction)
        self.lock = threading.RLock()
        self.clock = lambda: int(time.time() * 1000)
        # checkpoint versions that failed to decode: listings skip them
        self._corrupt_checkpoints: frozenset = frozenset()
        self.update()

    @classmethod
    def for_table(cls, data_path: str, device="cuda",
                  store: Optional[LocalLogStore] = None) -> "DeltaLog":
        key = (data_path.rstrip("/"), str(resolve(device)))
        with cls._cache_lock:
            dl = cls._cache.get(key)
            if dl is None or (store is not None and dl.store is not store):
                dl = DeltaLog(key[0], device=key[1], store=store)
                cls._cache[key] = dl
            return dl

    @classmethod
    def clear_cache(cls) -> None:
        with cls._cache_lock:
            cls._cache.clear()

    def update(self) -> Snapshot:
        """Re-list the log and install a new Snapshot if the segment changed
        (``SnapshotManagement.scala:244-330``)."""
        with self._update_lock:
            last = ckpt_mod.read_last_checkpoint(self.store, self.log_path)
            segment = sm.get_log_segment_for_version(
                self.store, self.log_path, start_checkpoint=last.version if last else None,
                excluded_checkpoints=self._corrupt_checkpoints)
            previous = self._snapshot
            if previous is not None and segment is not None and previous.segment == segment:
                return previous
            snap = Snapshot(self, segment.version if segment else -1, segment)
            if (previous is not None and segment is not None and previous.segment is not None
                    and "_columnar" in previous.__dict__
                    and [f.path for f in previous.segment.checkpoint_files]
                    == [f.path for f in segment.checkpoint_files]):
                known = [f.path for f in previous.segment.deltas]
                if [f.path for f in segment.deltas[: len(known)]] == known:
                    # the new version only appends commits: decode just those
                    # and extend the previous state (same result as a full
                    # decode, O(tail) instead of O(table))
                    tail = decode_segment(self.store, [],
                                          [f.path for f in segment.deltas[len(known):]])
                    snap.__dict__["_columnar"] = extend_segment_columns(
                        previous._columnar, tail)
            self._snapshot = snap
            return snap

    def get_snapshot_at(self, version: int) -> Snapshot:
        """Time travel to ``version`` (``SnapshotManagement.scala:342-360``).
        A version older than the earliest reproducible commit (its deltas
        cleaned up, no checkpoint covering it) raises
        ``VersionNotFoundError`` naming the range that is left."""
        current = self._snapshot
        if current is not None and current.version == version:
            return current
        latest = self.update().version
        if version < 0 or version > latest:
            raise VersionNotFoundError(version, 0, latest)
        found = ckpt_mod.find_last_complete_checkpoint_before(self.store, self.log_path,
                                                              version + 1)
        try:
            segment = sm.get_log_segment_for_version(
                self.store, self.log_path, version,
                start_checkpoint=found.version if found is not None else None)
        except DeltaIllegalStateError:
            # a head cleaned up below a later checkpoint is a missing
            # version; any other gap in the log stays the error it is
            earliest = self.history.get_earliest_reproducible_commit()
            if version < earliest:
                raise VersionNotFoundError(version, earliest, latest) from None
            raise
        if segment is None:
            raise VersionNotFoundError(version, self.history.get_earliest_reproducible_commit(),
                                       latest)
        return Snapshot(self, segment.version, segment)

    @property
    def history(self):
        from delta_tpu_torch.log.history import DeltaHistoryManager

        return DeltaHistoryManager(self)

    def snapshot_for(self, version: Optional[int] = None, timestamp=None) -> Snapshot:
        """The one time-travel resolution of every surface that takes version
        or timestamp options (reads, RESTORE): at most one selector; a
        timestamp is epoch ms or ISO-8601 and resolves to the last commit at
        or before it; neither is the latest version."""
        if version is not None and timestamp is not None:
            raise errors_mod.DeltaAnalysisError("Cannot specify both version and timestamp")
        if version is not None:
            return self.get_snapshot_at(int(version))
        if timestamp is not None:
            from delta_tpu_torch.utils.timeparse import timestamp_option_to_ms

            commit = self.history.get_active_commit_at_time(
                timestamp_option_to_ms(timestamp), can_return_last_commit=True)
            return self.get_snapshot_at(commit.version)
        return self.update()

    @property
    def corrupt_checkpoints(self) -> frozenset:
        return self._corrupt_checkpoints

    def mark_corrupt_checkpoint(self, version: int) -> frozenset:
        """Memoize a checkpoint that failed to decode; returns the set."""
        self._corrupt_checkpoints = self._corrupt_checkpoints | {version}
        return self._corrupt_checkpoints

    # -- checkpoints, cleanup and checksums (DeltaLog.scala, Checkpoints.scala)

    def checkpoint(self, snapshot: Optional[Snapshot] = None) -> ckpt_mod.CheckpointMetaData:
        """Write a checkpoint of ``snapshot`` (default: the latest), publish
        ``_last_checkpoint`` after its parts, then clean up expired logs
        (``Checkpoints.scala:221-260``)."""
        snap = snapshot or self.update()
        if snap.version < 0:
            raise DeltaIllegalStateError("Cannot checkpoint an uninitialized table")
        md = ckpt_mod.write_checkpoint(self.store, self.log_path, snap.version,
                                       snap.checkpoint_actions(),
                                       part_size=conf.get("delta.tpu.checkpointPartSize")
                                       or 1_000_000, device=self.device)
        self.cleanup_expired_logs(snap)
        return md

    def cleanup_expired_logs(self, snapshot: Snapshot) -> None:
        from delta_tpu_torch.log.cleanup import cleanup_expired_logs

        try:
            if DeltaConfigs.ENABLE_EXPIRED_LOG_CLEANUP.from_metadata(snapshot.metadata):
                cleanup_expired_logs(self, snapshot)
        except Exception:  # noqa: BLE001 - cleanup must not fail a commit
            logger.warning("Metadata cleanup failed", exc_info=True)

    def write_checksum_for(self, snapshot: Snapshot) -> None:
        crc_mod.write_checksum(self.store, self.log_path, snapshot.version,
                               crc_mod.VersionChecksum.of_snapshot(snapshot))

    @property
    def snapshot(self) -> Snapshot:
        s = self._snapshot
        return s if s is not None else self.update()

    @property
    def table_exists(self) -> bool:
        return self.snapshot.version >= 0

    def get_changes(self, start_version: int, fail_on_data_loss: bool = False
                    ) -> Iterator[Tuple[int, List[Action]]]:
        """(version, actions) of every commit from ``start_version`` on, in
        order (``DeltaLog.getChanges``); a gap in the versions raises, and
        with ``fail_on_data_loss`` so does a first version past the start."""
        prefix = f"{self.log_path}/{filenames.check_version_prefix(start_version)}"
        try:
            statuses = list(self.store.list_from(prefix))
        except FileNotFoundError:
            statuses = []
        last_seen: Optional[int] = None
        for fs in statuses:
            if not filenames.is_delta_file(fs.name):
                continue
            v = filenames.delta_version(fs.name)
            if fail_on_data_loss and last_seen is None and v > start_version:
                raise DeltaIllegalStateError(
                    f"Events were deleted: expected version {start_version}, first available {v}")
            if last_seen is not None and v > last_seen + 1:
                raise errors_mod.versions_not_contiguous([last_seen, v])
            last_seen = v
            yield v, actions_from_lines(self.store.read(fs.path))

    # -- protocol gating (DeltaLog.scala:248-275) ------------------------

    def assert_protocol_read(self, protocol: Protocol) -> None:
        """Reader gate: legacy version 1 passes, version 3 only when every
        listed reader feature is supported."""
        if protocol is None:
            return
        v = protocol.min_reader_version
        ok = v <= READER_VERSION or (
            v == SUPPORTED_READER_VERSION and protocol.reader_features is not None
            and set(protocol.reader_features) <= SUPPORTED_READER_FEATURES)
        if not ok:
            raise errors_mod.invalid_protocol_version(
                SUPPORTED_READER_VERSION, SUPPORTED_WRITER_VERSION, v,
                protocol.min_writer_version or 0)

    def assert_protocol_write(self, protocol: Protocol) -> None:
        """Writer gate: legacy versions up to 4 pass, version 7 only when
        every listed writer feature is supported."""
        if protocol is None:
            return
        v = protocol.min_writer_version
        ok = v <= WRITER_VERSION or (
            v == SUPPORTED_WRITER_VERSION and protocol.writer_features is not None
            and set(protocol.writer_features) <= SUPPORTED_WRITER_FEATURES)
        if not ok:
            raise errors_mod.invalid_protocol_version(
                SUPPORTED_READER_VERSION, SUPPORTED_WRITER_VERSION,
                protocol.min_reader_version or 0, v)

    def upgrade_protocol(self, new_protocol: Protocol) -> None:
        """Explicit protocol upgrade (``DeltaLog.scala:198-216``): a no-op
        when the table is already there, an error on a downgrade."""
        current = self.update().protocol
        if (current.min_reader_version >= new_protocol.min_reader_version
                and current.min_writer_version >= new_protocol.min_writer_version):
            logger.info("Table already at protocol %s; skipping upgrade", current)
            return
        if (new_protocol.min_reader_version < current.min_reader_version
                or new_protocol.min_writer_version < current.min_writer_version):
            raise ProtocolError(
                f"Protocol version cannot be downgraded from {current} to {new_protocol}")
        from delta_tpu_torch.commands.operations import UpgradeProtocol

        txn = self.start_transaction()
        txn.new_protocol = new_protocol
        txn.commit([], UpgradeProtocol(new_protocol))

    # -- transactions ----------------------------------------------------

    def start_transaction(self):
        from delta_tpu_torch.txn.transaction import OptimisticTransaction

        self.update()
        return OptimisticTransaction(self)

    def with_new_transaction(self, thunk):
        """Run ``thunk(txn)`` with the active-transaction ambient set
        (``DeltaLog.scala:183-191``)."""
        from delta_tpu_torch.txn.transaction import OptimisticTransaction

        txn = self.start_transaction()
        token = OptimisticTransaction.set_active(txn)
        try:
            return thunk(txn)
        finally:
            OptimisticTransaction.clear_active(token)

    def update_after_commit(self, committed_version: int) -> Snapshot:
        snap = self.update()
        if snap.version < committed_version:
            raise DeltaIllegalStateError(
                f"The committed version is {committed_version} but the current version is "
                f"{snap.version}")
        return snap

    def __repr__(self) -> str:
        v = self._snapshot.version if self._snapshot else "?"
        return f"DeltaLog({self.data_path!r}, v={v}, device={self.device})"

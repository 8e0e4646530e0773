"""Snapshot: immutable table state at a version (the port's own copy of
``delta_tpu.log.snapshot``).

State reconstruction is columnar: the segment (checkpoint parts and JSON
commits) decodes to SoA columns (``log/columnar``), last-writer-wins is the
host winner mask — as the JAX package's production snapshots take it
(``log/snapshot.py:192-194``) — and AddFile dataclasses are materialized
only for the rows a caller touches. A checkpoint that fails to decode is
excluded and the segment recomputed from the listing, as in the JAX
package (``log/snapshot.py:118-175``).
"""
from __future__ import annotations

import logging
from dataclasses import replace as _dc_replace
from functools import cached_property
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

import numpy as np

from delta_tpu_torch.log.columnar import SegmentColumns, decode_segment
from delta_tpu_torch.log.snapshot_management import LogSegment
from delta_tpu_torch.protocol.actions import (
    Action, AddFile, Metadata, Protocol, RemoveFile, SetTransaction,
)
from delta_tpu_torch.utils.config import DeltaConfigs

if TYPE_CHECKING:
    from delta_tpu_torch.log.deltalog import DeltaLog

__all__ = ["Snapshot"]

logger = logging.getLogger(__name__)


class Snapshot:
    def __init__(self, delta_log: "DeltaLog", version: int, segment: Optional[LogSegment]):
        self.delta_log = delta_log
        self.version = version
        self.segment = segment

    @cached_property
    def _columnar(self) -> SegmentColumns:
        """The segment's columns. A checkpoint part that does not decode
        (truncated or garbage Parquet) is memoized on the DeltaLog as
        corrupt and the segment recomputed from the listing: an earlier
        complete checkpoint, or the JSON commits from version 0. A corrupt
        JSON commit surfaces."""
        segment = self.segment
        if segment is None:
            return decode_segment(self.delta_log.store, [], [])
        while True:
            try:
                return decode_segment(self.delta_log.store,
                                      [f.path for f in segment.checkpoint_files],
                                      [f.path for f in segment.deltas], self.delta_log.device)
            except Exception as e:
                if segment.checkpoint_version is None or self._checkpoint_readable(segment):
                    raise
                from delta_tpu_torch.log import snapshot_management as sm

                excluded = self.delta_log.mark_corrupt_checkpoint(segment.checkpoint_version)
                logger.warning("checkpoint at version %s failed to decode (%s: %s); "
                               "recovering from the log listing",
                               segment.checkpoint_version, type(e).__name__, e)
                retry = sm.get_log_segment_for_version(
                    self.delta_log.store, segment.log_path, version_to_load=self.version,
                    excluded_checkpoints=excluded)
                if retry is None or retry.checkpoint_version in excluded:
                    raise
                segment = self.segment = retry

    def _checkpoint_readable(self, segment: LogSegment) -> bool:
        """Does every checkpoint part decode as Parquet? A failing page codec
        kernel (``RuntimeError``) is no verdict on the file: it raises."""
        from delta_tpu_torch.exec.parquet import read_nested

        try:
            for f in segment.checkpoint_files:
                read_nested(self.delta_log.store.read_bytes(f.path), ["protocol"],
                            device=self.delta_log.device)
            return True
        except NotImplementedError:
            return False
        except RuntimeError:
            raise
        except Exception:
            return False

    @cached_property
    def _winner(self) -> np.ndarray:
        """Last-action-per-path boolean row mask over the columnar stream."""
        return self._columnar.winner_mask()

    @cached_property
    def _other_state(self) -> Tuple[Optional[Protocol], Optional[Metadata],
                                    Dict[str, SetTransaction]]:
        proto: Optional[Protocol] = None
        meta: Optional[Metadata] = None
        txns: Dict[str, SetTransaction] = {}
        for a in self._columnar.other_actions:
            if isinstance(a, Protocol):
                proto = a
            elif isinstance(a, Metadata):
                meta = a
            elif isinstance(a, SetTransaction):
                txns[a.app_id] = a
        return proto, meta, txns

    @cached_property
    def protocol(self) -> Protocol:
        p = self._other_state[0]
        return p if p is not None else Protocol()

    @cached_property
    def metadata(self) -> Metadata:
        m = self._other_state[1]
        return m if m is not None else Metadata()

    @cached_property
    def set_transactions(self) -> Dict[str, SetTransaction]:
        return dict(self._other_state[2])

    def transaction_version(self, app_id: str) -> int:
        """The latest committed version of a streaming ``appId``, -1 when
        none (``DeltaSink`` idempotency)."""
        t = self._other_state[2].get(app_id)
        return t.version if t else -1

    @cached_property
    def _alive_mask(self) -> np.ndarray:
        alive, _ = self._columnar.replay(winner=self._winner)
        return alive

    @cached_property
    def all_files(self) -> List[AddFile]:
        """Active AddFiles sorted by path (deterministic scan order)."""
        return sorted(self._columnar.materialize(self._alive_mask), key=lambda a: a.path)

    @cached_property
    def _alive_row_by_path(self) -> Dict[str, int]:
        rows = np.nonzero(self._alive_mask)[0]
        return dict(zip(self._columnar.paths_for(rows), rows.tolist()))

    def files_for_paths(self, paths: Sequence[str]) -> List[AddFile]:
        """AddFiles for exactly the given (alive) paths, sorted by path — the
        selective alternative to ``all_files`` once a resident plan knows
        which few files survive (``ops/state_cache``)."""
        by_path = self._alive_row_by_path
        rows = np.asarray(sorted(by_path[p] for p in paths), np.int64)
        return sorted(self._columnar.materialize(rows), key=lambda a: a.path)

    def min_file_retention_timestamp(self) -> int:
        return self.delta_log.clock() - DeltaConfigs.TOMBSTONE_RETENTION.from_metadata(
            self.metadata)

    @cached_property
    def tombstones(self) -> List[RemoveFile]:
        """The removes still inside the tombstone retention, in row order."""
        return self.tombstones_newer_than(self.min_file_retention_timestamp())

    def tombstones_newer_than(self, cutoff_ms: int) -> List[RemoveFile]:
        """The removes deleted after ``cutoff_ms``: VACUUM applies its own
        horizon, not the snapshot's clock reading."""
        _, tomb = self._columnar.replay(cutoff_ms, winner=self._winner)
        return list(self._columnar.materialize(tomb))

    @property
    def timestamp(self) -> int:
        """The modification time of the version's last commit file (of its
        checkpoint when no delta follows it); -1 for an empty table."""
        seg = self.segment
        if seg is None:
            return -1
        return (seg.deltas or seg.checkpoint_files)[-1].modification_time

    def checkpoint_actions(self) -> List[Action]:
        """The reconciled state, a checkpoint's content
        (``InMemoryLogReplay.scala:71-77``): protocol, metadata, txns,
        retained tombstones, live files sorted by path, ``dataChange``
        false."""
        out: List[Action] = []
        proto, meta, txns = self._other_state
        if proto is not None:
            out.append(proto)
        if meta is not None:
            out.append(meta)
        out.extend(txns.values())
        out.extend(_dc_replace(r, data_change=False) for r in self.tombstones)
        out.extend(a.with_data_change(False) for a in self.all_files)
        return out

    @property
    def num_of_files(self) -> int:
        return int(self._alive_mask.sum())

    @property
    def size_in_bytes(self) -> int:
        return int(self._columnar.size[self._alive_mask].sum())

    @property
    def num_of_metadata(self) -> int:
        return 1 if self._other_state[1] is not None else 0

    @property
    def num_of_protocol(self) -> int:
        return 1 if self._other_state[0] is not None else 0

    @property
    def num_of_set_transactions(self) -> int:
        return len(self.set_transactions)

    def __repr__(self) -> str:
        return f"Snapshot(version={self.version})"

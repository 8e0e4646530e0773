"""Snapshot: immutable table state at a version (the port's own copy of
``delta_tpu.log.snapshot``, JSON segments only).

State reconstruction is columnar: the segment decodes to SoA columns
(``log/columnar``), last-writer-wins is the host winner mask — as the JAX
package's production snapshots take it (``log/snapshot.py:192-194``) — and
AddFile dataclasses are materialized only for the rows a caller touches.
"""
from __future__ import annotations

from functools import cached_property
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

import numpy as np

from delta_tpu_torch.log.columnar import SegmentColumns, decode_segment
from delta_tpu_torch.log.snapshot_management import LogSegment
from delta_tpu_torch.protocol.actions import (
    AddFile, Metadata, Protocol, SetTransaction,
)

if TYPE_CHECKING:
    from delta_tpu_torch.log.deltalog import DeltaLog

__all__ = ["Snapshot"]


class Snapshot:
    def __init__(self, delta_log: "DeltaLog", version: int, segment: Optional[LogSegment]):
        self.delta_log = delta_log
        self.version = version
        self.segment = segment

    @cached_property
    def _columnar(self) -> SegmentColumns:
        deltas = self.segment.deltas if self.segment is not None else []
        return decode_segment(self.delta_log.store, [], [f.path for f in deltas])

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

    @property
    def num_of_files(self) -> int:
        return int(self._alive_mask.sum())

    @property
    def size_in_bytes(self) -> int:
        return int(self._columnar.size[self._alive_mask].sum())

    def __repr__(self) -> str:
        return f"Snapshot(version={self.version})"

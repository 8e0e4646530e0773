"""Streaming source offset: versioned JSON, checked against the table's id
(the port's own copy of ``delta_tpu.streaming.offset``).

As ``sources/DeltaSourceOffset.scala`` (sourceVersion 1): an offset is
``(reservoirVersion, index, isStartingVersion)``; ``index`` points into a
commit's file list (admission control can split one commit across
micro-batches) and ``isStartingVersion`` marks an offset still inside the
initial snapshot rather than the log tail.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Dict

from delta_tpu_torch.utils.errors import DeltaIllegalStateError

__all__ = ["DeltaSourceOffset", "VERSION"]

VERSION = 1


@dataclass(frozen=True, order=True)
class DeltaSourceOffset:
    reservoir_version: int
    index: int
    is_starting_version: bool
    reservoir_id: str = ""

    def json(self) -> str:
        return json.dumps({"sourceVersion": VERSION, "reservoirId": self.reservoir_id,
                           "reservoirVersion": self.reservoir_version, "index": self.index,
                           "isStartingVersion": self.is_starting_version},
                          separators=(",", ":"))

    @staticmethod
    def from_json(s: str, expected_table_id: str = "") -> "DeltaSourceOffset":
        d: Dict[str, Any] = json.loads(s)
        sv = d.get("sourceVersion")
        if sv is None or sv > VERSION:
            raise DeltaIllegalStateError(f"Unsupported Delta source offset version: {sv}")
        rid = d.get("reservoirId", "")
        if expected_table_id and rid and rid != expected_table_id:
            raise DeltaIllegalStateError(
                f"Offset belongs to table {rid}, not {expected_table_id} — "
                "delete the streaming checkpoint if the table was recreated")
        return DeltaSourceOffset(reservoir_version=int(d["reservoirVersion"]),
                                 index=int(d["index"]),
                                 is_starting_version=bool(d.get("isStartingVersion", False)),
                                 reservoir_id=rid)

"""Isolation levels (the port's own copy of ``delta_tpu.txn.isolation``;
reference: ``isolationLevels.scala:27-91``)."""
from __future__ import annotations

__all__ = ["Serializable", "WriteSerializable", "SnapshotIsolation", "ALL_LEVELS"]


class IsolationLevel:
    name = ""

    def __repr__(self):
        return self.name


class _Serializable(IsolationLevel):
    """All reads + writes totally ordered with other txns."""

    name = "Serializable"


class _WriteSerializable(IsolationLevel):
    """Default (isolationLevels.scala:75): writes are serializable, but a
    blind append by another txn is allowed to commit concurrently even if we
    would have read it — weaker for reads, stronger availability."""

    name = "WriteSerializable"


class _SnapshotIsolation(IsolationLevel):
    """Used for commits that don't change data (dataChange=False only):
    never conflicts on file contents."""

    name = "SnapshotIsolation"


Serializable = _Serializable()
WriteSerializable = _WriteSerializable()
SnapshotIsolation = _SnapshotIsolation()
ALL_LEVELS = {l.name: l for l in (Serializable, WriteSerializable, SnapshotIsolation)}


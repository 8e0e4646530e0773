"""Deletion vectors: row-level tombstones for data files (the port's own
copy of ``delta_tpu.protocol.deletion_vectors``).

A *beyond-reference* feature (the reference at 0.9 always rewrites whole
files for DML — ``commands/MergeIntoCommand.scala:456-561``,
``commands/DeleteCommand.scala:137-171``): instead of rewriting a 128MB file
to delete 1% of its rows, the engine marks those row positions in a bitmap
attached to the ``AddFile``. DML then writes only *new* rows; readers drop
marked rows at scan time.

Modeled on the modern Delta protocol's deletion-vector descriptors (storage
type, inline vs out-of-line payload, cardinality), but the bitmap encoding
is this engine's own (the real spec uses RoaringBitmapArray): zlib-compressed
deltas of sorted uint32 row positions. Tables that carry DVs are protected by
a protocol bump — (3, 7), mirroring the versions the Delta DV feature
shipped under — so the 0.9 reference refuses them cleanly instead of
silently resurrecting deleted rows.

Row positions are **physical** row indexes in the file as written (0-based),
independent of any DV already applied: a new DV for a file must be the union
of the old positions and the newly-deleted ones.
"""
from __future__ import annotations

import base64
import os
import uuid
import zlib
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np

__all__ = [
    "DeletionVectorDescriptor",
    "encode_bitmap",
    "decode_bitmap",
    "write_deletion_vector",
    "read_deletion_vector",
    "INLINE_THRESHOLD_BYTES",
]

# payloads up to this size live inline (base85 in the log JSON); larger ones
# go to a sidecar file under the table dir
INLINE_THRESHOLD_BYTES = 4096

STORAGE_INLINE = "i"
STORAGE_FILE = "u"

_MAGIC = b"DTDV1\x00"


@dataclass(frozen=True)
class DeletionVectorDescriptor:
    """The ``deletionVector`` JSON object carried on Add/RemoveFile."""

    storage_type: str  # "i" inline | "u" sidecar file
    path_or_inline_dv: str  # base85 payload | relative sidecar path
    size_in_bytes: int  # encoded payload size
    cardinality: int  # number of deleted rows

    def to_dict(self) -> Dict[str, Any]:
        return {
            "storageType": self.storage_type,
            "pathOrInlineDv": self.path_or_inline_dv,
            "sizeInBytes": self.size_in_bytes,
            "cardinality": self.cardinality,
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "DeletionVectorDescriptor":
        return DeletionVectorDescriptor(
            storage_type=d["storageType"],
            path_or_inline_dv=d["pathOrInlineDv"],
            size_in_bytes=int(d.get("sizeInBytes", 0)),
            cardinality=int(d.get("cardinality", 0)),
        )

    @property
    def sidecar_path(self) -> Optional[str]:
        return self.path_or_inline_dv if self.storage_type == STORAGE_FILE else None


def encode_bitmap(rows: np.ndarray) -> bytes:
    """Sorted unique uint32 positions -> compressed payload."""
    rows = np.unique(np.asarray(rows, dtype=np.uint32))
    # delta-encode: runs and near-adjacent deletions compress to almost
    # nothing; random scatters still shrink well under zlib
    deltas = np.diff(rows, prepend=rows[:1]).astype(np.uint32) if rows.size else rows
    if rows.size:
        deltas[0] = rows[0]
    return _MAGIC + zlib.compress(deltas.tobytes(), level=1)


def decode_bitmap(payload: bytes) -> np.ndarray:
    if not payload.startswith(_MAGIC):
        raise ValueError("Not a deletion-vector payload (bad magic)")
    deltas = np.frombuffer(zlib.decompress(payload[len(_MAGIC):]), dtype=np.uint32)
    return np.cumsum(deltas, dtype=np.uint64).astype(np.uint32)


def write_deletion_vector(
    rows: np.ndarray,
    data_path: str,
    inline_threshold: Optional[int] = None,
) -> DeletionVectorDescriptor:
    """Encode ``rows`` and store the payload inline or as a sidecar file."""
    if inline_threshold is None:
        inline_threshold = INLINE_THRESHOLD_BYTES
    rows = np.unique(np.asarray(rows, dtype=np.uint32))
    payload = encode_bitmap(rows)
    if len(payload) <= inline_threshold:
        return DeletionVectorDescriptor(
            storage_type=STORAGE_INLINE,
            path_or_inline_dv=base64.b85encode(payload).decode("ascii"),
            size_in_bytes=len(payload),
            cardinality=int(rows.size),
        )
    rel = f"deletion_vector_{uuid.uuid4()}.bin"
    abs_path = os.path.join(data_path, rel)
    tmp = abs_path + ".tmp"
    try:
        with open(tmp, "wb") as f:
            f.write(payload)
        os.replace(tmp, abs_path)
    finally:
        try:
            os.unlink(tmp)  # no-op after a successful replace
        except OSError:
            pass
    return DeletionVectorDescriptor(
        storage_type=STORAGE_FILE,
        path_or_inline_dv=rel,
        size_in_bytes=len(payload),
        cardinality=int(rows.size),
    )


def dv_sidecar_path(dv: dict, data_path: str):
    """Absolute sidecar path for a ``deletionVector`` JSON dict, or None for
    inline/absent payloads. The single resolution rule (plain join, no
    unquote — sidecar paths are stored raw) shared by the read path below
    and pre-checks like RESTORE's vacuumed-sidecar guard."""
    if not dv or dv.get("storageType") != STORAGE_FILE:
        return None
    rel = dv.get("pathOrInlineDv")
    if rel is None:
        return None  # malformed descriptor: tolerated, the read path errors
    return os.path.join(data_path, rel)


def read_deletion_vector(
    descriptor: DeletionVectorDescriptor, data_path: str
) -> np.ndarray:
    """Deleted physical row positions (sorted uint32)."""
    if descriptor.storage_type == STORAGE_INLINE:
        payload = base64.b85decode(descriptor.path_or_inline_dv)
    elif descriptor.storage_type == STORAGE_FILE:
        sidecar = dv_sidecar_path(
            {"storageType": descriptor.storage_type,
             "pathOrInlineDv": descriptor.path_or_inline_dv},
            data_path,
        )
        with open(sidecar, "rb") as f:
            payload = f.read()
    else:
        raise ValueError(f"Unknown deletion-vector storage type: {descriptor.storage_type!r}")
    return decode_bitmap(payload)

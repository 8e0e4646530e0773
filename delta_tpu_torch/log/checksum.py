"""Per-version state checksums (``<v>.crc``; the port's own copy of
``delta_tpu.log.checksum``, reference ``Checksum.scala``): written best
effort after each commit."""
from __future__ import annotations

import json
import logging
from dataclasses import dataclass
from typing import Optional

from delta_tpu_torch.protocol import filenames
from delta_tpu_torch.storage.logstore import LocalLogStore
from delta_tpu_torch.utils.config import conf

logger = logging.getLogger(__name__)

__all__ = ["VersionChecksum", "write_checksum", "read_checksum"]


@dataclass(frozen=True)
class VersionChecksum:
    table_size_bytes: int
    num_files: int
    num_metadata: int
    num_protocol: int
    num_transactions: int

    def to_json(self) -> str:
        return json.dumps({"tableSizeBytes": self.table_size_bytes, "numFiles": self.num_files,
                           "numMetadata": self.num_metadata, "numProtocol": self.num_protocol,
                           "numTransactions": self.num_transactions}, separators=(",", ":"))

    @staticmethod
    def from_json(s: str) -> "VersionChecksum":
        d = json.loads(s)
        return VersionChecksum(int(d.get("tableSizeBytes", 0)), int(d.get("numFiles", 0)),
                               int(d.get("numMetadata", 0)), int(d.get("numProtocol", 0)),
                               int(d.get("numTransactions", 0)))

    @staticmethod
    def of_snapshot(snapshot) -> "VersionChecksum":
        return VersionChecksum(snapshot.size_in_bytes, snapshot.num_of_files,
                               snapshot.num_of_metadata, snapshot.num_of_protocol,
                               snapshot.num_of_set_transactions)


def write_checksum(store: LocalLogStore, log_path: str, version: int,
                   checksum: VersionChecksum) -> None:
    """Best-effort write (``Checksum.scala:55-93``): a failure only logs."""
    if not conf.get("delta.tpu.writeChecksum.enabled"):
        return
    try:
        store.write(f"{log_path}/{filenames.checksum_file(version)}", [checksum.to_json()],
                    overwrite=True)
    except Exception:  # noqa: BLE001 - a checksum write must never fail a commit
        logger.warning("Failed to write checksum for version %s", version, exc_info=True)


def read_checksum(store: LocalLogStore, log_path: str, version: int) -> Optional[VersionChecksum]:
    try:
        return VersionChecksum.from_json(
            "".join(store.read(f"{log_path}/{filenames.checksum_file(version)}")))
    except FileNotFoundError:
        return None
    except (ValueError, KeyError):
        logger.warning("Corrupt checksum file for version %s", version)
        return None

"""VACUUM: delete the files no snapshot references (the port's own copy of
``delta_tpu.commands.vacuum``, ``VacuumCommand.scala:49-347``).

The valid set is the live files, the tombstones younger than the horizon
and the deletion-vector sidecars of both. The table directory is listed in
parallel (one task a top-level directory); hidden names (``_`` or ``.``
first) are skipped, except partition directories (an ``=`` in the name)
and the change-data directories. An unreferenced file older than the
horizon is deleted, then partition directories left empty. A retention
below the table's tombstone retention is refused unless the check is off
(the ``retention_check_enabled`` argument or
``delta.tpu.retentionDurationCheck.enabled``). It runs as one process:
``parallel/distributed.host_partition`` over one host is the whole list.
Left out: the span.
"""
from __future__ import annotations

import os
import urllib.parse
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import List, Optional, Set

from delta_tpu_torch.parallel.distributed import host_partition
from delta_tpu_torch.utils import errors, telemetry
from delta_tpu_torch.utils.config import DeltaConfigs, conf

__all__ = ["VacuumCommand", "VacuumResult"]

MS_PER_HOUR = 3600 * 1000
PARALLELISM = 8  # threads listing and deleting


@dataclass
class VacuumResult:
    path: str
    files_deleted: int
    dirs_deleted: int
    dry_run: bool
    retention_ms: int
    deleted_paths: List[str] = field(default_factory=list)


def _is_hidden(name: str) -> bool:
    return (name.startswith("_") or name.startswith(".")) and "=" not in name and not (
        name.startswith("_change_data") or name.startswith("_cdc"))


def _dv_sidecar(action) -> Optional[str]:
    dv = getattr(action, "deletion_vector", None)
    if dv and dv.get("storageType") == "u":
        return dv.get("pathOrInlineDv")
    return None


class VacuumCommand:
    def __init__(self, delta_log, retention_hours: Optional[float] = None, dry_run: bool = False,
                 retention_check_enabled: bool = True):
        self.delta_log = delta_log
        self.retention_hours = retention_hours
        self.dry_run = dry_run
        self.retention_check_enabled = retention_check_enabled

    def run(self) -> VacuumResult:
        log = self.delta_log
        snapshot = log.update()
        tombstone_retention_ms = DeltaConfigs.TOMBSTONE_RETENTION.from_metadata(snapshot.metadata)
        retention_ms = (tombstone_retention_ms if self.retention_hours is None
                        else int(self.retention_hours * MS_PER_HOUR))
        check_enabled = self.retention_check_enabled and conf.get_bool(
            "delta.tpu.retentionDurationCheck.enabled", True)
        if check_enabled and retention_ms < tombstone_retention_ms:
            raise errors.retention_period_too_short(self.retention_hours,
                                                    tombstone_retention_ms / MS_PER_HOUR)
        cutoff = log.clock() - retention_ms

        valid: Set[str] = set()
        for a in list(snapshot.all_files) + snapshot.tombstones_newer_than(cutoff):
            valid.add(urllib.parse.unquote(a.path))
            side = _dv_sidecar(a)
            if side:
                valid.add(side)

        data_path = log.data_path
        all_files: List[str] = []
        all_dirs: List[str] = []

        def walk(rel_dir: str) -> None:
            abs_dir = os.path.join(data_path, rel_dir) if rel_dir else data_path
            try:
                entries = sorted(os.scandir(abs_dir), key=lambda e: e.name)
            except FileNotFoundError:
                return
            subdirs = []
            for e in entries:
                if _is_hidden(e.name):
                    continue
                rel = f"{rel_dir}/{e.name}" if rel_dir else e.name
                if e.is_dir(follow_symlinks=False):
                    subdirs.append(rel)
                    all_dirs.append(rel)
                else:
                    all_files.append(rel)
            if rel_dir:
                for s in subdirs:
                    walk(s)
            elif subdirs:
                # the top level fans out, one task a directory
                with ThreadPoolExecutor(max_workers=PARALLELISM,
                                        thread_name_prefix="delta-vacuum-list") as pool:
                    list(pool.map(walk, subdirs))

        walk("")

        to_delete: List[str] = []
        bytes_reclaimed = 0
        for rel in all_files:
            if rel in valid:
                continue
            try:
                st = os.stat(os.path.join(data_path, rel))
            except FileNotFoundError:
                continue
            if int(st.st_mtime * 1000) < cutoff:
                to_delete.append(rel)
                bytes_reclaimed += st.st_size
        to_delete.sort()

        if self.dry_run:
            return VacuumResult(path=data_path, files_deleted=len(to_delete), dirs_deleted=0,
                                dry_run=True, retention_ms=retention_ms,
                                deleted_paths=to_delete)

        def rm(rel: str) -> None:
            try:
                os.remove(os.path.join(data_path, rel))
            except FileNotFoundError:
                pass

        mine = host_partition(to_delete)
        if mine:
            with ThreadPoolExecutor(max_workers=PARALLELISM,
                                    thread_name_prefix="delta-vacuum-delete") as pool:
                list(pool.map(rm, mine))

        # partition directories left empty, deepest first
        dirs_deleted = 0
        for rel in sorted(all_dirs, key=lambda d: -d.count("/")):
            abs_d = os.path.join(data_path, rel)
            try:
                if not os.listdir(abs_d):
                    os.rmdir(abs_d)
                    dirs_deleted += 1
            except OSError:
                pass

        telemetry.set_gauge("table.maintenance.lastVacuumTimestamp", log.clock(),
                            path=data_path)
        if to_delete:
            telemetry.bump_counter("maintenance.vacuum.filesDeleted", len(to_delete))
            telemetry.bump_counter("maintenance.vacuum.bytesReclaimed", bytes_reclaimed)
        return VacuumResult(path=data_path, files_deleted=len(to_delete),
                            dirs_deleted=dirs_deleted, dry_run=False, retention_ms=retention_ms,
                            deleted_paths=to_delete)

"""GENERATE symlink_format_manifest: Presto/Athena manifests (the port's own
copy of ``delta_tpu.hooks.symlink_manifest``).

Writes ``_symlink_format_manifest/[<partition-path>/]manifest`` files, each
listing the absolute URIs of the table's live data files in that partition
(``hooks/GenerateSymlinkManifest.scala:41-374``):

* :func:`generate_full_manifest` rewrites every partition's manifest and
  drops those of vanished partitions (the GENERATE command);
* :class:`SymlinkManifestHook`, registered by the transaction when the table
  property ``delta.compatibility.symlinkFormatManifest.enabled`` is set,
  rewrites after each commit only the partitions it touched.
"""
from __future__ import annotations

import os
import shutil
import urllib.parse
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Set

from delta_tpu_torch.exec.write import partition_path
from delta_tpu_torch.protocol import filenames
from delta_tpu_torch.protocol.actions import AddFile, RemoveFile, actions_from_lines
from delta_tpu_torch.utils.config import DeltaConfigs

__all__ = ["MANIFEST_DIR", "generate_full_manifest", "SymlinkManifestHook"]

MANIFEST_DIR = "_symlink_format_manifest"


def _partition_dir(pv: Dict[str, Optional[str]], part_cols) -> str:
    return partition_path(pv or {}, part_cols)


def _absolute(data_path: str, path: str) -> str:
    """A data file's absolute path (a shallow clone's files already are)."""
    p = urllib.parse.unquote(path)
    if os.path.isabs(p):
        return p
    return os.path.abspath(os.path.join(data_path, p.replace("/", os.sep)))


def _write_manifest(data_path: str, rel_dir: str, files: Iterable[AddFile]) -> None:
    out_dir = os.path.join(data_path, MANIFEST_DIR, rel_dir.replace("/", os.sep))
    os.makedirs(out_dir, exist_ok=True)
    lines = ["file:" + urllib.parse.quote(_absolute(data_path, f.path))
             for f in sorted(files, key=lambda a: a.path)]
    with open(os.path.join(out_dir, "manifest"), "w") as fh:
        fh.write("\n".join(lines) + ("\n" if lines else ""))


def _by_dir(snapshot, part_cols) -> Dict[str, List[AddFile]]:
    by_dir: Dict[str, List[AddFile]] = defaultdict(list)
    for f in snapshot.all_files:
        by_dir[_partition_dir(f.partition_values, part_cols)].append(f)
    return by_dir


def generate_full_manifest(delta_log) -> int:
    """Regenerate every manifest; returns the number written."""
    snapshot = delta_log.update()
    by_dir = _by_dir(snapshot, snapshot.metadata.partition_columns)
    manifest_root = os.path.join(delta_log.data_path, MANIFEST_DIR)
    if os.path.isdir(manifest_root):
        shutil.rmtree(manifest_root)
    for rel_dir, files in by_dir.items():
        _write_manifest(delta_log.data_path, rel_dir, files)
    return len(by_dir)


class SymlinkManifestHook:
    """The post-commit incremental manifest update (``:80``)."""

    name = "Generate Symlink Format Manifest"

    def __eq__(self, other) -> bool:  # one registration a transaction
        return type(other) is type(self)

    def __hash__(self) -> int:
        return hash(type(self))

    def run(self, txn, committed_version: int, snapshot) -> None:
        metadata = txn.metadata
        if not DeltaConfigs.SYMLINK_FORMAT_MANIFEST_ENABLED.from_metadata(metadata):
            return
        log = txn.delta_log
        part_cols = metadata.partition_columns
        committed = actions_from_lines(
            log.store.read(f"{log.log_path}/{filenames.delta_file(committed_version)}"))
        touched: Set[str] = {_partition_dir(a.partition_values or {}, part_cols)
                             for a in committed if isinstance(a, (AddFile, RemoveFile))}
        if not touched:
            return
        by_dir = _by_dir(snapshot, part_cols)
        for rel_dir in touched:
            files = by_dir.get(rel_dir)
            if files:
                _write_manifest(log.data_path, rel_dir, files)
            else:  # the partition vanished: drop its manifest
                gone = os.path.join(log.data_path, MANIFEST_DIR, rel_dir.replace("/", os.sep))
                if os.path.isdir(gone):
                    shutil.rmtree(gone, ignore_errors=True)

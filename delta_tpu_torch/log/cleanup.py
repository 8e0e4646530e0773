"""Metadata cleanup: delete expired commit, checkpoint and checksum files
(the port's own copy of ``delta_tpu.log.cleanup``, reference
``MetadataCleanup.scala:27-98``).

A file goes when it is older than ``delta.logRetentionDuration`` (the
cutoff truncated to the day) and a later checkpoint covers it: only a
prefix of the versions strictly below the ``_last_checkpoint`` version, so
the newest checkpoint's segment is never cut and the files' timestamps stay
monotone. Aged ``.tmp`` staging orphans go too.
"""
from __future__ import annotations

import logging
from typing import Dict, List

from delta_tpu_torch.log import checkpoints as ckpt_mod
from delta_tpu_torch.protocol import filenames
from delta_tpu_torch.utils.config import DeltaConfigs, conf

logger = logging.getLogger(__name__)

__all__ = ["cleanup_expired_logs", "sweep_tmp_orphans"]

MS_PER_DAY = 86_400_000


def sweep_tmp_orphans(delta_log, now_ms: int) -> int:
    """Delete ``.{name}.{uuid}.tmp`` staging files older than
    ``delta.tpu.cleanup.tmpOrphanTtlMs`` (a younger one may be a live
    writer's)."""
    cutoff = now_ms - int(conf.get("delta.tpu.cleanup.tmpOrphanTtlMs"))
    try:
        statuses = list(delta_log.store.list_from(f"{delta_log.log_path}/."))
    except FileNotFoundError:
        return 0
    return sum(1 for fs in statuses
               if fs.name.startswith(".") and fs.name.endswith(".tmp")
               and fs.modification_time <= cutoff and delta_log.store.delete(fs.path))


def cleanup_expired_logs(delta_log, snapshot) -> int:
    """Delete expired log files; returns how many went."""
    retention_ms = DeltaConfigs.LOG_RETENTION.from_metadata(snapshot.metadata)
    now = delta_log.clock()
    cutoff = ((now - retention_ms) // MS_PER_DAY) * MS_PER_DAY
    swept = sweep_tmp_orphans(delta_log, now)
    last = ckpt_mod.read_last_checkpoint(delta_log.store, delta_log.log_path)
    if last is None:
        return swept
    try:
        statuses = list(delta_log.store.list_from(
            f"{delta_log.log_path}/{filenames.check_version_prefix(0)}"))
    except FileNotFoundError:
        return swept
    by_version: Dict[int, List] = {}
    for fs in statuses:
        name = fs.name
        if (filenames.is_delta_file(name) or filenames.is_checkpoint_file(name)
                or filenames.is_checksum_file(name)):
            v = filenames.get_file_version(name)
            if v is not None:
                by_version.setdefault(v, []).append(fs)
    deletable: List = []
    for v in sorted(by_version):
        if v >= last.version:
            break
        files = by_version[v]
        if not all(f.modification_time <= cutoff for f in files):
            break  # stop at the first version too new: no holes
        deletable.extend(files)
    deleted = sum(1 for fs in deletable if delta_log.store.delete(fs.path))
    if deleted:
        logger.info("Deleted %d expired log files older than %d in %s", deleted, cutoff,
                    delta_log.log_path)
    return deleted + swept

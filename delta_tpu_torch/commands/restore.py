"""RESTORE TABLE: roll the table's state back to an earlier version as a new
commit (the port's own copy of ``delta_tpu.commands.restore``; modern
Delta's ``RESTORE TABLE t TO VERSION AS OF v``).

* files live at the target but not now (or now with another deletion
  vector): re-added as of the target;
* files live now but not at the target: removed;
* the target's metadata is re-committed where it differs.

The target resolves through ``DeltaLog.snapshot_for``'s rules (a version
must still be reproducible; a timestamp takes the last commit at or before
it). Every data file and deletion-vector sidecar to re-add must still
exist, else the command raises before it commits anything. The read set is
the whole table, so a concurrent append conflicts. A re-add can shrink a
deletion vector and revive rows, which the key slab's incremental advance
does not do: a commit with actions bumps both device caches' epochs.
"""
from __future__ import annotations

import os
import urllib.parse
from dataclasses import replace
from typing import Dict, Optional, Union

from delta_tpu_torch.commands import operations as ops
from delta_tpu_torch.commands.dml_common import Timer, bump_cache_epochs
from delta_tpu_torch.protocol.actions import Action
from delta_tpu_torch.protocol.deletion_vectors import dv_sidecar_path
from delta_tpu_torch.utils import errors

__all__ = ["RestoreCommand", "Restore"]


def Restore(version: Optional[int], timestamp: Optional[str]) -> ops.Operation:
    params = {}
    if version is not None:
        params["version"] = version
    if timestamp is not None:
        params["timestamp"] = timestamp
    return ops.Operation("RESTORE", params,
                         ["numRestoredFiles", "numRemovedFiles", "restoredFilesSize"])


class RestoreCommand:
    def __init__(self, delta_log, version: Optional[int] = None,
                 timestamp: Optional[Union[str, int]] = None):
        if (version is None) == (timestamp is None):
            raise errors.DeltaAnalysisError("RESTORE requires exactly one of version or timestamp")
        self.delta_log = delta_log
        self.version = version
        self.timestamp = timestamp
        self.metrics: Dict[str, int] = {}

    def _target_version(self) -> int:
        if self.version is not None:
            self.delta_log.history.check_version_exists(int(self.version))
            return int(self.version)
        from delta_tpu_torch.utils.timeparse import timestamp_option_to_ms

        return self.delta_log.history.get_active_commit_at_time(
            timestamp_option_to_ms(self.timestamp), can_return_last_commit=True).version

    def run(self) -> int:
        target_version = self._target_version()
        target = self.delta_log.get_snapshot_at(target_version)
        data_path = self.delta_log.data_path

        def missing(what: str) -> errors.DeltaIllegalStateError:
            return errors.DeltaIllegalStateError(
                f"Cannot restore to version {target_version}: {what} no longer exists "
                "(removed by VACUUM?)")

        def body(txn) -> int:
            timer = Timer()
            current = txn.snapshot
            txn.read_whole_table()
            cur_files = {f.path: f for f in current.all_files}
            tgt_files = {f.path: f for f in target.all_files}

            actions: list[Action] = []
            restored = removed = restored_size = 0
            for path, f in tgt_files.items():
                cur = cur_files.get(path)
                # the same entry (path and deletion vector) is in place
                if cur is not None and cur.deletion_vector == f.deletion_vector:
                    continue
                abs_path = os.path.join(data_path,
                                        urllib.parse.unquote(path).replace("/", os.sep))
                if not os.path.exists(abs_path):
                    raise missing(f"data file {path}")
                dv_abs = dv_sidecar_path(f.deletion_vector or {}, data_path)
                if dv_abs is not None and not os.path.exists(dv_abs):
                    raise missing(f"deletion-vector file "
                                  f"{(f.deletion_vector or {}).get('pathOrInlineDv')} "
                                  f"for data file {path}")
                actions.append(replace(f, data_change=True))
                restored += 1
                restored_size += f.size or 0
            for path, f in cur_files.items():
                if path not in tgt_files:
                    actions.append(f.remove())
                    removed += 1

            if target.metadata.to_dict() != current.metadata.to_dict():
                txn.update_metadata(target.metadata)

            self.metrics.update(numRestoredFiles=restored, numRemovedFiles=removed,
                                restoredFilesSize=restored_size,
                                executionTimeMs=timer.lap_ms())
            txn.report_metrics(**self.metrics)
            version = txn.commit(actions, Restore(
                self.version, str(self.timestamp) if self.timestamp is not None else None))
            if actions:
                bump_cache_epochs(self.delta_log.log_path)
            return version

        return self.delta_log.with_new_transaction(body)

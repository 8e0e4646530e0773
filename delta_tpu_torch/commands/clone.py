"""SHALLOW CLONE: a new table whose log references the source's data files
(the port's own copy of ``delta_tpu.commands.clone``).

The clone commits the source snapshot's Protocol and Metadata (a fresh
table id) and one ``AddFile`` a live source file with its path made
ABSOLUTE, so the clone reads the source's Parquet in place; its
deletion-vector files are made absolute the same way. Writes to the clone
make files under the clone's directory and never touch the source. VACUUM
of the clone walks only the clone's directory, so it deletes nothing of the
source's (VACUUM of the source can break a clone, as with any shallow
clone).
"""
from __future__ import annotations

import os
import urllib.parse
import uuid
from dataclasses import replace
from typing import Dict, Optional, Union

from delta_tpu_torch.commands import operations as ops
from delta_tpu_torch.protocol.actions import Metadata, Protocol
from delta_tpu_torch.utils import errors

__all__ = ["CloneCommand"]


def Clone(source_path: str, source_version: int) -> ops.Operation:
    return ops.Operation(
        "CLONE", {"source": source_path, "sourceVersion": source_version, "isShallow": True},
        ["sourceTableSize", "sourceNumOfFiles", "numClonedFiles"])


class CloneCommand:
    def __init__(self, source_log, target_path: str, version: Optional[int] = None,
                 timestamp: Optional[Union[str, int]] = None):
        self.source_log = source_log
        self.target_path = target_path
        self.version = version
        self.timestamp = timestamp
        self.metrics: Dict[str, int] = {}

    def _exists_error(self):
        return errors.DeltaAnalysisError(
            f"Cannot clone into {self.target_path}: a Delta table already exists there")

    def run(self) -> int:
        from delta_tpu_torch.log.deltalog import DeltaLog

        src = self.source_log
        snapshot = src.snapshot_for(self.version, self.timestamp)
        if snapshot.version < 0:
            raise errors.not_a_delta_table(src.data_path, "CLONE")
        target = DeltaLog.for_table(self.target_path, device=src.device)
        if target.update().version >= 0:
            raise self._exists_error()
        src_root = os.path.abspath(src.data_path)

        def absolutize(rel: str) -> str:
            if "://" in rel or os.path.isabs(rel):
                return rel
            return urllib.parse.quote(os.path.join(src_root, urllib.parse.unquote(rel)),
                                      safe="/:@!$&'()*+,;=-._~")

        def body(txn) -> int:
            if txn.read_version != -1:
                # a table appeared at the target after the pre-check: never
                # merge two tables
                raise self._exists_error()
            meta: Metadata = replace(snapshot.metadata, id=str(uuid.uuid4()))
            txn.update_metadata(meta)
            # at least the source's protocol: its configuration alone can
            # under-derive it (DV files outliving an unset DV property, an
            # explicit upgrade of the source)
            src_p = snapshot.protocol
            derived = txn.new_protocol
            reader = max(src_p.min_reader_version, derived.min_reader_version if derived else 0)
            writer = max(src_p.min_writer_version, derived.min_writer_version if derived else 0)
            feats = set(src_p.reader_features or ()) | set(src_p.writer_features or ())
            if derived is not None:
                feats |= set(derived.reader_features or ()) | set(derived.writer_features or ())
            txn.new_protocol = Protocol(reader, writer,
                                        tuple(sorted(feats)) if reader >= 3 else None,
                                        tuple(sorted(feats)) if writer >= 7 else None)
            actions = []
            total_size = 0
            for f in snapshot.all_files:
                dv = f.deletion_vector
                if dv and dv.get("storageType") == "u":
                    dv = dict(dv, pathOrInlineDv=os.path.join(src_root, dv["pathOrInlineDv"]))
                actions.append(replace(f, path=absolutize(f.path), data_change=True,
                                       deletion_vector=dv))
                total_size += f.size or 0
            self.metrics.update(sourceTableSize=total_size, sourceNumOfFiles=len(actions),
                                numClonedFiles=len(actions))
            txn.report_metrics(**self.metrics)
            return txn.commit(actions, Clone(src.data_path, snapshot.version))

        return target.with_new_transaction(body)

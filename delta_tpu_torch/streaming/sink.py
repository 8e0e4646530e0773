"""Streaming sink: exactly-once micro-batch writes (the port's own copy of
``delta_tpu.streaming.sink``).

As ``sources/DeltaSink.scala:37-113``: each ``add_batch(batch_id, data)``
commits in one transaction carrying ``SetTransaction(queryId, batchId)``;
a replayed batch (a retry, a restarted query) is found by
``txn.txn_version(queryId) >= batchId`` and skipped (``:87-91,100``).
Complete output mode removes every existing file first (``:93-98``). The
batch goes through the port's writer, so its write semantics and page
codec run as any write's.
"""
from __future__ import annotations

import time
from typing import Any, List, Sequence

from delta_tpu_torch.commands import operations as ops
from delta_tpu_torch.commands.write import coerce_to_table, update_metadata_on_write
from delta_tpu_torch.exec import write as write_exec
from delta_tpu_torch.protocol.actions import Action, SetTransaction
from delta_tpu_torch.schema import schema_utils
from delta_tpu_torch.utils import telemetry
from delta_tpu_torch.utils.errors import DeltaIllegalArgumentError

__all__ = ["DeltaSink"]


class DeltaSink:
    def __init__(self, delta_log, query_id: str, output_mode: str = "append",
                 partition_columns: Sequence[str] = (), merge_schema: bool = False):
        if output_mode not in ("append", "complete"):
            raise DeltaIllegalArgumentError(
                f"Data source delta does not support {output_mode} output mode")
        self.delta_log = delta_log
        self.query_id = query_id
        self.output_mode = output_mode
        self.partition_columns = list(partition_columns)
        self.merge_schema = merge_schema

    def add_batch(self, batch_id: int, data: Any) -> bool:
        """Write one micro-batch; False when the batch was already committed
        (the idempotent skip)."""
        table = coerce_to_table(data)

        def body(txn) -> bool:
            if txn.txn_version(self.query_id) >= batch_id:
                return False  # committed by an earlier attempt
            update_metadata_on_write(txn, schema_utils.schema_from_table(table),
                                     self.partition_columns or txn.metadata.partition_columns,
                                     is_overwrite=self.output_mode == "complete",
                                     merge_schema=self.merge_schema, overwrite_schema=False)
            actions: List[Action] = [SetTransaction(app_id=self.query_id, version=batch_id,
                                                    last_updated=int(time.time() * 1000))]
            if self.output_mode == "complete":
                txn.read_whole_table()
                actions.extend(f.remove() for f in txn.filter_files())
            actions.extend(write_exec.write_files(self.delta_log.data_path, table, txn.metadata,
                                                  data_change=True, device=self.delta_log.device))
            txn.commit(actions, ops.StreamingUpdate(output_mode=self.output_mode,
                                                    query_id=self.query_id, epoch_id=batch_id))
            return True

        committed = self.delta_log.with_new_transaction(body)
        telemetry.bump_counter("streaming.sink.batches" if committed
                               else "streaming.sink.batchesSkipped")
        return committed

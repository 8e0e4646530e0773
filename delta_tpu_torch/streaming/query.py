"""The micro-batch driver (the port's own copy of
``delta_tpu.streaming.query``): the engine loop Spark Structured Streaming
provides. A ``StreamingQuery`` keeps its offsets in a checkpoint directory,
``offsets/<batchId>`` written before the batch runs and
``commits/<batchId>`` after (Spark's write-ahead protocol), so a restarted
query reruns at most its last unfinished batch, and the sink's
``SetTransaction`` makes that rerun a no-op.
"""
from __future__ import annotations

import json
import os
import uuid
from typing import Optional

from delta_tpu_torch.streaming.offset import DeltaSourceOffset
from delta_tpu_torch.streaming.sink import DeltaSink
from delta_tpu_torch.streaming.source import DeltaSource

__all__ = ["StreamingQuery"]


class StreamingQuery:
    def __init__(self, source: DeltaSource, sink_or_fn, checkpoint_dir: str,
                 query_id: Optional[str] = None):
        self.source = source
        self.sink = sink_or_fn if isinstance(sink_or_fn, DeltaSink) else None
        self.foreach = sink_or_fn if not isinstance(sink_or_fn, DeltaSink) else None
        self.checkpoint_dir = checkpoint_dir
        os.makedirs(os.path.join(checkpoint_dir, "offsets"), exist_ok=True)
        os.makedirs(os.path.join(checkpoint_dir, "commits"), exist_ok=True)
        self.query_id = query_id or self._load_or_create_query_id()

    def _load_or_create_query_id(self) -> str:
        meta_path = os.path.join(self.checkpoint_dir, "metadata")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                return json.load(f)["id"]
        qid = str(uuid.uuid4())
        with open(meta_path, "w") as f:
            json.dump({"id": qid}, f)
        return qid

    # -- the offset log ---------------------------------------------------

    def _batch_ids(self, kind: str):
        d = os.path.join(self.checkpoint_dir, kind)
        return sorted(int(n) for n in os.listdir(d) if n.isdigit())

    def _read_offset(self, batch_id: int) -> DeltaSourceOffset:
        with open(os.path.join(self.checkpoint_dir, "offsets", str(batch_id))) as f:
            return DeltaSourceOffset.from_json(f.read(), self.source.table_id)

    def _write_offset(self, batch_id: int, off: DeltaSourceOffset) -> None:
        with open(os.path.join(self.checkpoint_dir, "offsets", str(batch_id)), "w") as f:
            f.write(off.json())

    def _mark_committed(self, batch_id: int) -> None:
        with open(os.path.join(self.checkpoint_dir, "commits", str(batch_id)), "w") as f:
            f.write("{}")

    # -- the loop ---------------------------------------------------------

    def process_all_available(self) -> int:
        """Run micro-batches until the source is drained; returns how many
        ran."""
        offsets = self._batch_ids("offsets")
        commits = set(self._batch_ids("commits"))
        ran = 0
        if offsets:
            last = offsets[-1]
            start = self._read_offset(offsets[-2]) if len(offsets) > 1 else None
            if last not in commits:
                # recover: rerun the planned but uncommitted batch
                self._run_batch(last, start, self._read_offset(last))
                ran += 1
            prev_end: Optional[DeltaSourceOffset] = self._read_offset(last)
            next_id = last + 1
        else:
            prev_end = None
            next_id = 0
        while True:
            anchor = prev_end if prev_end is not None else self.source.initial_offset()
            end = self.source.latest_offset(anchor)
            if end is None:
                return ran
            self._write_offset(next_id, end)
            self._run_batch(next_id, prev_end, end)
            prev_end = end
            next_id += 1
            ran += 1

    def _run_batch(self, batch_id: int, start: Optional[DeltaSourceOffset],
                   end: DeltaSourceOffset) -> None:
        table = self.source.get_batch(start, end)
        if self.sink is not None:
            self.sink.add_batch(batch_id, table)
        else:
            self.foreach(batch_id, table)
        self._mark_committed(batch_id)

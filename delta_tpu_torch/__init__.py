"""delta_tpu_torch: the PyTorch + CUDA port of ``delta_tpu`` for an NVIDIA H100.

A second package beside the JAX one, which stays the reference. Ported so
far: the scan-planning path (log replay into a snapshot, the table's scan
lanes resident on the card, batched block-cull planning with an exact host
fine pass, the whole of ``files_for_scan``), the tombstone replay, the
transaction and the table writer, and the MERGE command with its key slab
on the card (``ops/key_cache``) and its upload join (``ops/join_kernel``),
over a Parquet codec of the port's own (``exec/parquet``)::

    from delta_tpu_torch import DeltaLog, MergeClause, MergeIntoCommand, WriteIntoDelta
    from delta_tpu_torch.commands.alter import set_table_properties

    log = DeltaLog.for_table(path)                    # device="cuda"
    WriteIntoDelta(log, "append", target).run()       # dict of numpy arrays
    set_table_properties(log, {"delta.tpu.enableDeletionVectors": "true"})
    MergeIntoCommand(log, source, "t.k = s.k", [MergeClause("update")],
                     [MergeClause("insert")], source_alias="s", target_alias="t").run()

It imports torch, numpy and the standard library only: never ``jax``,
``pyarrow`` or ``delta_tpu``. Its CUDA kernels live in ``csrc/`` and build
at first use (``ops/native``).
"""
from delta_tpu_torch.commands.merge import MergeClause, MergeIntoCommand
from delta_tpu_torch.commands.write import WriteIntoDelta
from delta_tpu_torch.log.deltalog import DeltaLog

__all__ = ["DeltaLog", "WriteIntoDelta", "MergeIntoCommand", "MergeClause"]

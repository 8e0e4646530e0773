"""delta_tpu_torch: the PyTorch + CUDA port of ``delta_tpu`` for an NVIDIA H100.

A second package beside the JAX one, which stays the reference. Ported so
far: the scan-planning path (log replay into a snapshot, the table's scan
lanes resident on the card, batched block-cull planning with an exact host
fine pass, the whole of ``files_for_scan``), the tombstone replay, and the
MERGE key slab (``ops/key_cache``) over a Parquet codec of the port's own
(``exec/parquet``)::

    from delta_tpu_torch import DeltaLog
    from delta_tpu_torch.expr.parser import parse_expression
    from delta_tpu_torch.ops.pruning import files_for_scan

    snap = DeltaLog.for_table(path).update()          # device="cuda"
    scan = files_for_scan(snap, [parse_expression("c0 >= 5 AND c0 <= 9")])

It imports torch, numpy and the standard library only: never ``jax``,
``pyarrow`` or ``delta_tpu``. Its CUDA kernels live in ``csrc/`` and build
at first use (``ops/native``).
"""
from delta_tpu_torch.log.deltalog import DeltaLog

__all__ = ["DeltaLog"]

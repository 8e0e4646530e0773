"""delta_tpu_torch: the PyTorch + CUDA port of ``delta_tpu`` for an NVIDIA H100.

A second package beside the JAX one, which stays the reference. Ported so
far, on unpartitioned and partitioned tables alike: the scan-planning path (log replay into a snapshot, the table's scan
lanes resident on the card, batched block-cull planning with an exact host
fine pass, the whole of ``files_for_scan``), the tombstone replay, the
transaction and the table writer (Hive-style partition directories,
``replace_where``), the MERGE command with its key slab on
the card (``ops/key_cache``) and its upload join (``ops/join_kernel``), the
filtered read path with row-group skipping and the residual filter on the
card (``ops/column_cache``), time travel by version or timestamp
(``log/history``), DELETE and UPDATE (their candidates through
``files_for_scan``, deletion vectors or rewrites), RESTORE, VACUUM, and
OPTIMIZE with its Z-order key on the card (``ops/zorder``), over a Parquet
codec of the port's own (``exec/parquet``). Under each ``auto`` mode a link cost model
(``parallel/link``, probed with K17) picks the card or the host for the
scan plan, the MERGE join and the residual filter, and ``obs/router_audit``
records each decision. Over a state mesh of several entries
(``parallel/mesh``: every card, or one card named several times) the scan
plan, the replay and the MERGE upload join run sharded, one launch a shard
(K7, K6, K13), as ``multichip.dryrun_multichip`` drives them. ``DeltaTable``
(``api/tables``) carries the JAX package's table API but the change data
feed, ``doctor`` and ``advise``: create and CTAS (``commands/create``),
write, the MERGE builder, batched plans (``exec/scan.plan_scans``), shallow
clones (``commands/clone``), CONVERT TO DELTA (``commands/convert``),
symlink manifests (``hooks/symlink_manifest``), the protocol upgrade, the
name catalog (``catalog/catalog``) and the read-only ``path@v`` handles::

    from delta_tpu_torch import DeltaLog, DeltaTable, MergeClause, MergeIntoCommand
    from delta_tpu_torch import WriteIntoDelta
    from delta_tpu_torch.commands.alter import set_table_properties

    log = DeltaLog.for_table(path)                    # device="cuda"
    WriteIntoDelta(log, "append", target).run()       # dict of numpy arrays
    # partitioned: WriteIntoDelta(log, "append", target, partition_columns=["d"])
    set_table_properties(log, {"delta.tpu.enableDeletionVectors": "true"})
    MergeIntoCommand(log, source, "t.k = s.k", [MergeClause("update")],
                     [MergeClause("insert")], source_alias="s", target_alias="t").run()
    table = DeltaTable.for_path(path)
    rows = table.to_table(filters=["k > 10"])       # a HostTable
    (table.alias("t").merge(source, "t.k = s.k", source_alias="s")
        .when_matched_update_all().when_not_matched_insert_all().execute())
    plans = table.plan_queries([["k = 3"], ["k > 10 AND k < 20"]])
    table.delete("k < 5")
    table.update({"v": "v + 1"}, "k = 7")
    before = table.to_table(version=1)
    table.restore_to_version(1)
    table.vacuum()
    table.optimize().execute_z_order_by("k", "v")

It imports torch, numpy and the standard library only: never ``jax``,
``pyarrow`` or ``delta_tpu``. Its CUDA kernels live in ``csrc/`` and build
at first use (``ops/native``).
"""
from delta_tpu_torch.api.tables import DeltaTable
from delta_tpu_torch.commands.merge import MergeClause, MergeIntoCommand
from delta_tpu_torch.commands.write import WriteIntoDelta
from delta_tpu_torch.log.deltalog import DeltaLog
from delta_tpu_torch.utils.config import conf


def __getattr__(name):
    # `delta_tpu_torch.obs` (scan reports, the router audit, calibration),
    # imported on first use as in the JAX package
    if name == "obs":
        import delta_tpu_torch.obs as obs

        return obs
    raise AttributeError(f"module 'delta_tpu_torch' has no attribute {name!r}")


__all__ = ["DeltaLog", "DeltaTable", "WriteIntoDelta", "MergeIntoCommand", "MergeClause",
           "conf", "obs"]

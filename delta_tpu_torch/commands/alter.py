"""ALTER TABLE SET TBLPROPERTIES (the port's own copy of
``delta_tpu.commands.alter.set_table_properties``): one metadata-only
transaction."""
from __future__ import annotations

from dataclasses import replace
from typing import Dict

from delta_tpu_torch.commands import operations as ops

__all__ = ["set_table_properties"]


def set_table_properties(delta_log, properties: Dict[str, str]) -> int:
    def body(txn):
        meta = txn.metadata
        cfg = dict(meta.configuration or {})
        cfg.update({k: str(v) for k, v in properties.items()})
        txn.update_metadata(replace(meta, configuration=cfg))
        return txn.commit([], ops.SetTableProperties(properties))

    return delta_log.with_new_transaction(body)

"""Helpers of the write-semantics parity tests (tests/test_torch_constraints.py,
test_torch_generated.py, test_torch_schema_evolution.py, test_torch_cdf.py,
test_torch_streaming.py).

:class:`W` is :class:`tests.torch_api_tables.P` with the modules of the
write semantics: ``generated``, ``constraints``, ``char_varchar``, ``cdf``,
the ``streaming`` source, sink and query, and the ``write`` command. A case
``case(p, root)`` runs once a package through ``tests.torch_api_tables.both``;
:func:`changes` is a table's change feed as both packages read it (they
must agree), with each ``_commit_timestamp`` replaced by whether it is the
commit's own timestamp, so that runs made at other times compare equal.
"""
import os

import delta_tpu
import delta_tpu_torch
from tests.torch_api_tables import P, state  # noqa: F401  (state: re-exported)

CDF = {"delta.enableChangeDataFeed": "true"}
DV = {"delta.tpu.enableDeletionVectors": "true"}


class W(P):
    def __init__(self, name):
        super().__init__(name)
        if self.jax:
            from delta_tpu.commands import write as write_mod
            from delta_tpu.exec import cdf
            from delta_tpu.schema import char_varchar, constraints, generated
            from delta_tpu.streaming import query, sink, source
        else:
            from delta_tpu_torch.commands import write as write_mod
            from delta_tpu_torch.exec import cdf
            from delta_tpu_torch.schema import char_varchar, constraints, generated
            from delta_tpu_torch.streaming import query, sink, source
        self.write_mod, self.cdf, self.generated = write_mod, cdf, generated
        self.constraints, self.char_varchar = constraints, char_varchar
        self.source, self.sink, self.query = source, sink, query

    def gen(self, name, typ, expr, nullable=True):
        return self.generated.generated_field(name, getattr(self.types, typ)(), expr, nullable)


def _norm_changes(rows, stamps):
    out = []
    for r in rows:
        r = dict(r)
        r["_commit_timestamp"] = r["_commit_timestamp"] == stamps.get(r["_commit_version"])
        out.append(r)
    return sorted(out, key=lambda r: (r["_commit_version"], r["_change_type"],
                                      [(v is None, repr(v)) for v in r.values()]))


def changes(path, start=0, end=None):
    """The change feed of ``path`` in [start, end] as both packages read it,
    held equal; each ``_commit_timestamp`` becomes True where it is the
    commit's timestamp in the log's history."""
    jt = delta_tpu.DeltaTable.for_path(path)
    stamps = {c.version: c.timestamp for c in jt.delta_log.history.get_commits(0)}
    want = _norm_changes(jt.table_changes(start, end).to_pylist(), stamps)
    delta_tpu_torch.DeltaLog.clear_cache()
    tt = delta_tpu_torch.DeltaTable.for_path(path, device="cpu")
    got = _norm_changes(tt.table_changes(start, end).to_pylist(), stamps)
    assert got == want
    return want


def cdc_files(path):
    """Per version, the number of ``cdc`` actions in its commit."""
    out = []
    log_dir = os.path.join(path, "_delta_log")
    for name in sorted(os.listdir(log_dir)):
        if name.endswith(".json"):
            with open(os.path.join(log_dir, name)) as f:
                out.append(sum('"cdc"' in line[:8] for line in f))
    return out

"""Parquet footers for the row-group layer (the port's own copy of
``delta_tpu.exec.rowgroups``, cut to :func:`read_footer`).

The JAX package keeps a bounded LRU of ``pyarrow`` footers here, beside the
row-group pushdown planner; the port reads the footer with its own codec
(``exec/parquet.read_metadata``) and has no cache and no planner yet.
"""
from __future__ import annotations

from delta_tpu_torch.exec.parquet import read_metadata

__all__ = ["read_footer"]


def read_footer(abs_path: str):
    """The file's parsed footer (``exec.thrift.FileMetaData``: ``num_rows``,
    ``row_groups``, ``schema``)."""
    return read_metadata(abs_path)

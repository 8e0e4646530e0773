"""Row-group data skipping inside a Parquet file (the port's own copy of
``delta_tpu.exec.rowgroups``: :func:`read_footer` through the footer LRU
:class:`FooterCache`, the pushdown planner :func:`plan_row_groups`,
:func:`row_group_offsets` and :func:`row_groups_for_positions`).

The planner evaluates a scan's skipping rewrite (``ops/pruning``, the same
rewrite the file tier evaluates over AddFile stats) against each row
group's footer statistics; a group survives unless the rewrite is
definitely False. The statistics come from the port's own footer reader
(``exec/parquet.chunk_statistics``), decoded to the Python values
``pyarrow`` gives, so a plan here equals the JAX package's plan over the
same file. :func:`stats_from_footer` derives a file's protocol stats from
its footer alone (CONVERT TO DELTA). The JAX package's fired-rewrite
attribution is not ported.
"""
from __future__ import annotations

import math
import os
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, FrozenSet, List, Optional

import numpy as np

from delta_tpu_torch.exec.parquet import (
    _leaf_type, _top_level, chunk_statistics, json_stat_value, read_metadata,
)
from delta_tpu_torch.expr import ir
from delta_tpu_torch.utils import telemetry
from delta_tpu_torch.utils.config import conf

__all__ = ["read_footer", "FooterCache", "RowGroupPlan", "plan_row_groups",
           "row_group_offsets", "row_groups_for_positions", "stats_from_footer"]


class FooterCache:
    """Bounded LRU of parsed Parquet footers (``exec.thrift.FileMetaData``),
    ``delta.tpu.read.footerCacheEntries`` of them (0 turns it off).

    Entries are keyed by absolute path and checked against the file's
    current ``(size, mtime_ns)`` at every lookup, so a file rewritten in
    place is parsed again. A cached footer is only read, never changed, so
    one object serves every reader. The footer parse is Python thrift, about
    a millisecond a file: a table of thousands of small files (one a
    partition) pays it at every scan without the cache."""

    _instance: Optional["FooterCache"] = None
    _instance_lock = threading.Lock()

    def __init__(self):
        self._lock = threading.Lock()
        # abs_path -> ((size, mtime_ns), FileMetaData)
        self._entries: "OrderedDict[str, tuple]" = OrderedDict()

    @classmethod
    def instance(cls) -> "FooterCache":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = FooterCache()
            return cls._instance

    @classmethod
    def reset(cls) -> None:
        with cls._instance_lock:
            cls._instance = None

    @staticmethod
    def capacity() -> int:
        return int(conf.get("delta.tpu.read.footerCacheEntries", 1024))

    def get(self, abs_path: str):
        """The file's parsed footer; cached when the cache is on."""
        cap = self.capacity()
        if cap <= 0:
            return read_metadata(abs_path)
        st = os.stat(abs_path)
        key = (st.st_size, st.st_mtime_ns)
        with self._lock:
            hit = self._entries.get(abs_path)
            if hit is not None and hit[0] == key:
                self._entries.move_to_end(abs_path)
                telemetry.bump_counter("footerCache.hits")
                return hit[1]
        meta = read_metadata(abs_path)
        telemetry.bump_counter("footerCache.misses")
        with self._lock:
            self._entries[abs_path] = (key, meta)
            self._entries.move_to_end(abs_path)
            while len(self._entries) > cap:
                self._entries.popitem(last=False)
                telemetry.bump_counter("footerCache.evictions")
        return meta

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


def read_footer(abs_path: str):
    """The file's parsed footer (``exec.thrift.FileMetaData``: ``num_rows``,
    ``row_groups``, ``schema``), through the process's :class:`FooterCache`."""
    return FooterCache.instance().get(abs_path)


class _StatsEnv(dict):
    """Row environment for the skipping rewrite: lookups are
    case-insensitive and missing stats resolve to NULL instead of raising —
    NULL keeps the row group, which is what absent or evolved columns must
    do."""

    def __contains__(self, key: object) -> bool:  # Column.eval probes first
        return True

    def __getitem__(self, key):
        if isinstance(key, str):
            return super().get(key.lower())
        return super().get(key)


def _column_index(meta) -> Dict[str, int]:
    """Lowercased top-level leaf name -> column-chunk index. Nested leaves
    are skipped: only flat columns carry stats lanes, as at the file
    tier."""
    out: Dict[str, int] = {}
    if not meta.row_groups:
        return out
    for j, chunk in enumerate(meta.row_groups[0].columns):
        path = chunk.meta_data.path_in_schema
        if len(path) != 1:
            continue
        out[path[0].lower()] = j
    return out


def _float_leaves(meta, col_index: Dict[str, int]) -> FrozenSet[str]:
    from delta_tpu_torch.exec import encodings as enc

    chunks = meta.row_groups[0].columns if meta.row_groups else []
    return frozenset(name for name, j in col_index.items()
                     if chunks[j].meta_data.type in (enc.FLOAT, enc.DOUBLE))


def _safe_bounds(mn: Any, mx: Any, is_float: bool):
    """Drop bound pairs the planner must not trust: binary (possibly
    truncated) and NaN floats (legacy writers put NaN in min/max)."""
    if isinstance(mn, bytes) or isinstance(mx, bytes):
        return None, None
    if is_float and ((isinstance(mn, float) and math.isnan(mn))
                     or (isinstance(mx, float) and math.isnan(mx))):
        return None, None
    return mn, mx


def _rg_env(meta, i: int, col_index: Dict[str, int], float_leaves: FrozenSet[str],
            part_row: Optional[Dict[str, Any]]) -> _StatsEnv:
    env = _StatsEnv()
    env["numrecords"] = int(meta.row_groups[i].num_rows)
    for name, j in col_index.items():
        try:
            st = chunk_statistics(meta, i, j)
        except Exception:
            continue  # undecodable stats value: leave the lanes NULL (keep)
        if st is None:
            continue
        null_count, bounds = st
        if null_count is not None:
            env[f"nullcount.{name}"] = int(null_count)
        if bounds is not None:
            mn, mx = _safe_bounds(bounds[0], bounds[1], name in float_leaves)
            if mn is not None:
                env[f"min.{name}"] = mn
            if mx is not None:
                env[f"max.{name}"] = mx
    if part_row:
        for k, v in part_row.items():
            env[k.lower()] = v
    return env


@dataclass
class RowGroupPlan:
    """Surviving row groups of one file; ``skipped_bytes`` is the
    uncompressed size of the pruned groups (the decode work avoided)."""

    keep: List[int]
    total: int
    skipped_bytes: int = 0


def plan_row_groups(meta, predicate: ir.Expression,
                    part_row: Optional[Dict[str, Any]] = None,
                    partition_cols: FrozenSet[str] = frozenset(),
                    types: Optional[Dict[str, Any]] = None,
                    rewrites: Optional[List] = None) -> RowGroupPlan:
    """Evaluate ``predicate`` against each row group's footer statistics; a
    group survives unless the rewritten can-match predicate is definitely
    False. A file of one group short-circuits (the file tier already
    ruled). ``types`` (lowercased column name -> DataType) arms the
    predicate synthesis fallback; ``rewrites`` is a scan-constant
    ``conjunct_rewrites(...)`` list the caller computed once."""
    from delta_tpu_torch.ops.pruning import conjunct_rewrites, skipping_predicate

    n = len(meta.row_groups or [])
    all_groups = list(range(n))
    if n <= 1:
        return RowGroupPlan(all_groups, n)
    if rewrites is None and types is not None:
        rewrites = conjunct_rewrites([predicate], partition_cols, types)
    if rewrites is not None:
        rewritten = ir.and_all([r.rewritten for r in rewrites])
    else:
        rewritten = skipping_predicate(predicate, partition_cols)
    if isinstance(rewritten, ir.Literal) and rewritten.value is None:
        return RowGroupPlan(all_groups, n)  # nothing lowerable: keep all
    # only the predicate's columns are typed: a column the port cannot
    # decode blocks no read that leaves it out
    refs = {r.split(".", 1)[-1].lower() for r in ir.references(rewritten)}
    col_index = {k: j for k, j in _column_index(meta).items() if k in refs}
    float_leaves = _float_leaves(meta, col_index)
    keep: List[int] = []
    skipped_bytes = 0
    for i in all_groups:
        env = _rg_env(meta, i, col_index, float_leaves, part_row)
        try:
            verdict = rewritten.eval(env)
        except Exception:
            verdict = None  # uncomparable stats value vs literal: keep
        if verdict is False:
            skipped_bytes += int(meta.row_groups[i].total_byte_size)
        else:
            keep.append(i)
    return RowGroupPlan(keep, n, skipped_bytes)


def row_group_offsets(meta) -> np.ndarray:
    """Physical row offset of each row group; length ``num_row_groups + 1``
    (the last entry is the file's row count)."""
    counts = np.asarray([rg.num_rows for rg in meta.row_groups or []], dtype=np.int64)
    off = np.zeros(len(counts) + 1, dtype=np.int64)
    np.cumsum(counts, out=off[1:])
    return off


def row_groups_for_positions(meta, positions) -> FrozenSet[int]:
    """Row groups containing any of the given physical row positions."""
    off = row_group_offsets(meta)
    pos = np.asarray(positions, dtype=np.int64)
    pos = pos[(pos >= 0) & (pos < off[-1])]
    if pos.size == 0:
        return frozenset()
    return frozenset(int(i) for i in np.unique(np.searchsorted(off, pos, side="right") - 1))


def _skippable(stype: str) -> bool:
    """A stored type whose bounds become protocol stats (``collect_stats``'
    kinds: integers, floats, strings, dates, timestamps, booleans,
    decimals)."""
    return (stype in ("bool", "int8", "int16", "int32", "int64", "float32", "float64",
                      "string", "date32") or stype.startswith("timestamp")
            or stype.startswith("decimal"))


def stats_from_footer(meta, num_indexed_cols: int = 32) -> Optional[Dict[str, Any]]:
    """Protocol stats (numRecords/minValues/maxValues/nullCount) from the
    footer's row-group statistics, or None where the footer cannot stand in
    for a decode: a nested or undecodable column among the indexed ones, a
    chunk without a null count, NaN float bounds, or a chunk with values
    whose bounds the writer withheld. Bounds ``collect_stats`` would not
    emit (binary, decimal, non-finite floats) are left out, so the footer's
    stats equal the decode's wherever both exist."""
    try:
        top = _top_level(meta.schema)
    except Exception:
        return None
    names = list(top)[: num_indexed_cols if num_indexed_cols >= 0 else None]
    n_rgs = len(meta.row_groups or [])
    mins: Dict[str, Any] = {}
    maxs: Dict[str, Any] = {}
    nulls: Dict[str, Any] = {}
    for name in names:
        el, j = top[name]
        if j < 0:
            return None  # nested: the footer cannot cover this column
        try:
            stype = _leaf_type(el)[0]
        except NotImplementedError:
            return None
        is_float = stype in ("float32", "float64")
        total_null = 0
        col_mins: List[Any] = []
        col_maxs: List[Any] = []
        bounds_incomplete = False
        for i in range(n_rgs):
            try:
                st = chunk_statistics(meta, i, j)
            except Exception:
                return None
            if st is None or st[0] is None:
                return None  # not even a null count: decode
            null_count, bounds = st
            total_null += int(null_count)
            if bounds is not None:
                mn, mx = bounds
                if is_float and ((isinstance(mn, float) and math.isnan(mn))
                                 or (isinstance(mx, float) and math.isnan(mx))):
                    return None  # NaN-polluted bounds: decode
                col_mins.append(mn)
                col_maxs.append(mx)
            elif int(null_count) != int(meta.row_groups[i].num_rows):
                bounds_incomplete = True  # values without bounds: decode
        nulls[name] = total_null
        if not _skippable(stype) or total_null == int(meta.num_rows):
            continue
        if bounds_incomplete or not col_mins:
            return None
        try:
            mn_v, mx_v = min(col_mins), max(col_maxs)
        except TypeError:
            return None
        mn_j = json_stat_value(mn_v)
        mx_j = json_stat_value(mx_v, round_up=True)
        if mn_j is not None:
            mins[name] = mn_j
        if mx_j is not None:
            maxs[name] = mx_j
    return {"numRecords": int(meta.num_rows), "minValues": mins, "maxValues": maxs,
            "nullCount": nulls}

"""Columnar log-segment decode: checkpoint Parquet parts and JSON commits
-> replay-ordered SoA columns.

The port's own copy of ``delta_tpu.log.columnar``. The JAX package parses
commits with ``pyarrow.json`` and checkpoints with ``pyarrow.parquet``; the
port decodes commits with the standard library's ``json`` and numpy, one
parse per line, and checkpoint parts with its own nested Parquet reader
(``exec/parquet.read_nested``), column by column. It keeps what replay and
scan planning need as numpy columns (path ids, sizes, timestamps) plus the
per-row stats strings, partition maps, the checkpoint rows' typed
``stats_parsed`` lanes (:class:`StatsParsed`), and for lazy
materialization each JSON row's raw line or each checkpoint row's place in
its part's decoded columns.

Layout invariant (as in the JAX package): rows are in global replay order
(checkpoint parts first, in part order, then deltas ascending by version,
line order within a commit), so *row index is the replay sequence number*
and the last row of a path run wins.
"""
from __future__ import annotations

import json
from bisect import bisect_right
from dataclasses import dataclass, field, replace
from types import MappingProxyType
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from delta_tpu_torch.exec import parquet as pq
from delta_tpu_torch.expr.nested import NCol
from delta_tpu_torch.log.checkpoints import row_to_action
from delta_tpu_torch.protocol.actions import (
    Action, Metadata, Protocol, SetTransaction, action_from_dict,
)
from delta_tpu_torch.storage.logstore import LocalLogStore

__all__ = ["SegmentColumns", "StatsParsed", "decode_segment", "decode_json_commits",
           "decode_checkpoint_parts", "extend_segment_columns"]

#: the partition map of every add without partition values: one shared
#: read-only object instead of a dict per row, which a million-row segment
#: would otherwise hand to the cyclic garbage collector to traverse
_NO_PARTITIONS: Mapping[str, Optional[str]] = MappingProxyType({})


class StatsParsed:
    """A segment's ``add.stats_parsed`` as flat lanes aligned with its rows:
    ``valid`` (the struct present), and a ``(values, valid, stored type)``
    lane for ``numRecords`` and for each leaf directly under
    ``minValues``/``maxValues``/``nullCount`` (dates and timestamps as
    epoch days and µs); ``fields`` names each of those three structs'
    fields, nested structs included, as the JAX package's field sets do.
    The ``signature`` stands for the struct's type: parts whose types
    disagree disable the lanes, as the JAX package's segment does."""

    __slots__ = ("valid", "lanes", "fields")

    def __init__(self, valid, lanes, fields):
        self.valid, self.lanes, self.fields = valid, lanes, fields

    @property
    def signature(self):
        return (tuple((k, v[2]) for k, v in self.lanes.items()),
                tuple((k, tuple(v)) for k, v in self.fields.items()))

    @staticmethod
    def of(col: Optional[NCol], rows: np.ndarray) -> Optional["StatsParsed"]:
        """From a decoded ``stats_parsed`` struct column, at ``rows``."""
        if col is None or col.kind != "struct":
            return None
        lanes: Dict[str, Tuple[np.ndarray, np.ndarray, str]] = {}
        fields: Dict[str, List[str]] = {}

        def leaf(name, c):
            if c.kind == "leaf" and not c.unsupported:
                lanes[name] = (c.values[rows], c.valid[rows], c.stype)

        for top, c in col.fields.items():
            if c.kind == "struct":
                fields[top] = list(c.fields)
                for k, sub in c.fields.items():
                    leaf(f"{top}.{k}", sub)
            else:
                leaf(top, c)
        return StatsParsed(col.valid[rows], lanes, fields)

    @staticmethod
    def concat(parts) -> Optional["StatsParsed"]:
        """``[(StatsParsed or None, rows), ...]`` one after another: a part
        without the struct contributes nulls; None when no part has it or
        their types disagree."""
        have = [p for p, _ in parts if p is not None]
        if not have or len({p.signature for p in have}) != 1:
            return None
        proto = have[0]
        pieces = [p if p is not None else StatsParsed(
            np.zeros(n, bool),
            {k: (np.zeros(n, v[0].dtype), np.zeros(n, bool), v[2])
             for k, v in proto.lanes.items()}, proto.fields) for p, n in parts]
        if len(pieces) == 1:
            return pieces[0]
        return StatsParsed(
            np.concatenate([p.valid for p in pieces]),
            {k: (np.concatenate([p.lanes[k][0] for p in pieces]),
                 np.concatenate([p.lanes[k][1] for p in pieces]), v[2])
             for k, v in proto.lanes.items()}, proto.fields)


@dataclass
class SegmentColumns:
    """A log segment's file actions as replay-ordered SoA columns.

    ``path_id`` indexes ``path_dict`` (canonical paths, codes in order of
    first appearance, as ``pyarrow``'s dictionary encoding assigns them);
    ``stats`` and ``partition_values`` are per-row (None for removes and
    for adds without them) and ``lines`` keeps each row's raw log line.
    """

    path_dict: List[str]
    path_id: np.ndarray  # int32
    is_add: np.ndarray  # bool
    size: np.ndarray  # int64 (0 where absent)
    modification_time: np.ndarray  # int64 (adds; 0 elsewhere)
    deletion_timestamp: np.ndarray  # int64 (removes; 0 elsewhere)
    stats: List[Optional[str]]
    partition_values: List[Optional[Mapping[str, Optional[str]]]]
    lines: List[Optional[bytes]]  # a JSON row's line; None for a checkpoint row
    other_actions: List[Action]  # Protocol/Metadata/SetTransaction, replay order
    #: the checkpoint parts' decoded add/remove columns, for materializing
    #: their rows: (first row, the part's table row of each of its rows,
    #: add NCol, remove NCol)
    ckpt_batches: List[Tuple[int, np.ndarray, Optional[NCol], Optional[NCol]]] = \
        field(default_factory=list)
    #: ``add.stats_parsed`` aligned with the rows (null on JSON rows), or
    #: None where no checkpoint part carries it (or the parts disagree)
    stats_parsed: Optional["StatsParsed"] = None

    @property
    def num_rows(self) -> int:
        return len(self.path_id)

    @property
    def num_paths(self) -> int:
        return len(self.path_dict)

    # -- replay -----------------------------------------------------------

    def winner_mask(self) -> np.ndarray:
        """Last-action-per-path mask, host path: one vectorized scatter —
        later rows overwrite earlier ones, which *is* last-writer-wins."""
        last = np.full(self.num_paths, -1, np.int64)
        last[self.path_id] = np.arange(self.num_rows)
        mask = np.zeros(self.num_rows, bool)
        mask[last[last >= 0]] = True
        return mask

    def replay(
        self, min_retention_ts: int = 0, winner: Optional[np.ndarray] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(alive_adds, retained_tombstones) boolean row masks. Callers that
        computed a winner mask (host or device) pass it in."""
        w = self.winner_mask() if winner is None else winner
        alive = w & self.is_add
        tomb = w & ~self.is_add & (self.deletion_timestamp > min_retention_ts)
        return alive, tomb

    # -- lazy materialization --------------------------------------------

    def materialize(self, mask_or_rows) -> List[Action]:
        """AddFile/RemoveFile dataclasses for the selected rows, in row order,
        each carrying its canonical path."""
        rows = np.asarray(mask_or_rows)
        if rows.dtype == bool:
            rows = np.nonzero(rows)[0]
        rows = rows.tolist()
        out: List[Optional[Action]] = [None] * len(rows)
        offsets = [b[0] for b in self.ckpt_batches]
        # a checkpoint batch's rows convert together, one column at a time
        # (a row at a time costs a pass over the nested columns a row)
        in_batch: Dict[int, List[Tuple[int, int]]] = {}
        for j, r in enumerate(rows):
            line = self.lines[r]
            if line is not None:
                out[j] = action_from_dict(json.loads(line))
            else:
                b = bisect_right(offsets, r) - 1
                in_batch.setdefault(b, []).append((j, r - self.ckpt_batches[b][0]))
        for b, items in in_batch.items():
            _start, index, add, rem = self.ckpt_batches[b]
            t = index[np.asarray([loc for _, loc in items], np.int64)]
            is_add = (add.field("path").valid[t] if add is not None
                      else np.zeros(len(t), bool))
            for kind, col, sel in (("add", add, is_add), ("remove", rem, ~is_add)):
                if sel.any():
                    for (j, _loc), d in zip((it for it, s in zip(items, sel) if s),
                                            col.to_py(t[sel])):
                        out[j] = row_to_action(kind, d)
        for j, r in enumerate(rows):
            a, canon = out[j], self.path_dict[self.path_id[r]]
            if a.path != canon:
                out[j] = replace(a, path=canon)
        return out

    def paths_for(self, rows: np.ndarray) -> List[str]:
        """Canonical paths for the given *row* indices."""
        d = self.path_dict
        return [d[i] for i in self.path_id[np.asarray(rows, np.int64)].tolist()]

    def partition_strings(
        self, rows: np.ndarray, part_cols: Sequence[str]
    ) -> Optional[Dict[str, List[Optional[str]]]]:
        """Raw partition-value strings for the given *row* indices, one list
        per partition column (None = value absent or null). None when an add
        lacks the mandatory ``partitionValues`` map."""
        out: Dict[str, List[Optional[str]]] = {c: [] for c in part_cols}
        for r in np.asarray(rows, np.int64).tolist():
            pv = self.partition_values[r]
            if pv is None:
                if self.is_add[r]:
                    return None
                pv = {}
            for c in part_cols:
                v = pv.get(c)
                out[c].append(v if isinstance(v, str) else None)
        return out


def extend_segment_columns(base: SegmentColumns, tail: SegmentColumns) -> SegmentColumns:
    """Append ``tail``'s rows (a decoded run of newer commits) after
    ``base``'s, as ``delta_tpu.log.columnar.extend_segment_columns`` does:
    row order stays the replay order and the path dictionary is ``base``'s
    with the tail's unseen paths appended in order of first appearance, so
    the result equals a fresh :func:`decode_segment` of all the commits.
    O(tail) apart from list copies; neither input is mutated."""
    index = {p: i for i, p in enumerate(base.path_dict)}
    n_base = len(index)
    for p in tail.path_dict:
        index.setdefault(p, len(index))
    trans = np.fromiter((index[p] for p in tail.path_dict), np.int64, len(tail.path_dict))
    tail_ids = trans[tail.path_id] if tail.num_rows else np.empty(0, np.int64)
    return SegmentColumns(
        path_dict=base.path_dict + list(index)[n_base:],
        path_id=np.concatenate([base.path_id, tail_ids.astype(np.int32)]),
        is_add=np.concatenate([base.is_add, tail.is_add]),
        size=np.concatenate([base.size, tail.size]),
        modification_time=np.concatenate([base.modification_time, tail.modification_time]),
        deletion_timestamp=np.concatenate([base.deletion_timestamp, tail.deletion_timestamp]),
        stats=base.stats + tail.stats,
        partition_values=base.partition_values + tail.partition_values,
        lines=base.lines + tail.lines,
        other_actions=base.other_actions + tail.other_actions,
        ckpt_batches=base.ckpt_batches + [(b[0] + base.num_rows, *b[1:])
                                          for b in tail.ckpt_batches],
        stats_parsed=StatsParsed.concat([(base.stats_parsed, base.num_rows),
                                         (tail.stats_parsed, tail.num_rows)]),
    )


def _canonical(path: str) -> str:
    """Strip redundant leading "./" (``log/replay.canonicalize_path``)."""
    while path.startswith("./"):
        path = path[2:]
    return path


def decode_json_commits(buffers: Sequence[bytes]) -> List[bytes]:
    """Non-blank lines of newline-delimited commit JSON, in order."""
    lines: List[bytes] = []
    for b in buffers:
        for ln in b.split(b"\n"):
            ln = ln.strip(b"\r")
            if ln.strip():
                lines.append(ln)
    return lines


def _int(v) -> int:
    return int(v) if isinstance(v, (int, float)) and not isinstance(v, bool) else 0


def _strings(col: Optional[NCol], rows: np.ndarray) -> List[Optional[str]]:
    if col is None:
        return [None] * len(rows)
    vals = col.values[rows].tolist()
    return [v if ok else None for v, ok in zip(vals, col.valid[rows].tolist())]


def _ints(col: Optional[NCol], rows: np.ndarray) -> np.ndarray:
    if col is None or col.kind != "leaf":
        return np.zeros(len(rows), np.int64)
    return np.where(col.valid[rows], col.values[rows], 0).astype(np.int64)


def _partition_dicts(col: Optional[NCol], rows: np.ndarray, is_add: np.ndarray):
    """The adds' ``partitionValues`` maps at ``rows`` as dicts (the shared
    empty map where one is empty, None where absent); None for removes."""
    n = len(rows)
    if col is None or col.kind != "map":
        return [None] * n
    ok = col.valid[rows] & is_add
    lo, hi = col.offsets[rows], col.offsets[rows + 1]
    out: List[Optional[Mapping[str, Optional[str]]]] = [None] * n
    keys, vals = list(col.element.fields.values())[:2]
    for i in np.nonzero(ok)[0].tolist():
        a, b = int(lo[i]), int(hi[i])
        if a == b:
            out[i] = _NO_PARTITIONS
        else:
            k = keys.values[a:b].tolist()
            v = [x if good else None for x, good in zip(vals.values[a:b].tolist(),
                                                        vals.valid[a:b].tolist())]
            d: Dict[str, Optional[str]] = {}
            for kk, vv in zip(k, v):
                d.setdefault(kk, vv)
            out[i] = d
    return out


def decode_checkpoint_parts(store: LocalLogStore, paths: Sequence[str], device="cuda"):
    """Each checkpoint part's columns, in part order: ``(num_rows, name ->
    NCol)`` by the nested Parquet reader, each part's pages inflated in one
    batch on ``device``."""
    return [pq.read_nested(store.read_bytes(p), ["txn", "add", "remove", "metaData", "protocol"],
                           device=device, source=p)
            for p in paths]


def decode_segment(
    store: LocalLogStore,
    checkpoint_paths: Sequence[str],
    delta_paths: Sequence[str],
    device="cuda",
) -> SegmentColumns:
    """Decode a log segment (checkpoint parts, then ordered delta files) to
    :class:`SegmentColumns`; the checkpoint's pages inflate on ``device``.

    Field semantics follow the JAX package's explicit-schema Arrow parse: a
    row is a file action when ``add.path`` or ``remove.path`` is present,
    ``size`` is the add's size else the remove's, ``stats`` and
    ``modificationTime`` come from the add, ``deletionTimestamp`` from the
    remove; commitInfo and unknown lines are skipped. A checkpoint part's
    protocol, metadata and txn rows become other actions (protocol,
    metadata, txns, in that order within a part)."""
    ids: Dict[str, int] = {}
    chunks: List[Tuple[np.ndarray, ...]] = []  # path_id, is_add, size, mtime, dts
    stats: List[Optional[str]] = []
    pvs: List[Optional[Mapping[str, Optional[str]]]] = []
    file_lines: List[Optional[bytes]] = []
    other: List[Action] = []
    batches = []
    sp_parts = []
    n_rows = 0
    for n, cols in decode_checkpoint_parts(store, checkpoint_paths, device):
        for name in ("protocol", "metaData", "txn"):
            col = cols.get(name)
            if col is not None and col.valid.any():
                for d in col.to_py(np.nonzero(col.valid)[0]):
                    a = row_to_action(name, d)
                    if a is not None:
                        other.append(a)
        add, rem = cols.get("add"), cols.get("remove")
        af = add.field if add is not None else (lambda _name: None)
        rf = rem.field if rem is not None else (lambda _name: None)
        a_path, r_path = af("path"), rf("path")
        a_ok = a_path.valid if a_path is not None else np.zeros(n, bool)
        r_ok = r_path.valid if r_path is not None else np.zeros(n, bool)
        rows = np.nonzero(a_ok | r_ok)[0]
        k = len(rows)
        if not k:
            continue
        is_add = a_ok[rows]
        paths = np.where(is_add, a_path.values[rows] if a_path is not None else None,
                         r_path.values[rows] if r_path is not None else None).tolist()
        pid = np.fromiter((ids.setdefault(_canonical(p), len(ids)) for p in paths),
                          np.int32, k)
        a_size = af("size")
        size = np.where(a_size.valid[rows] if a_size is not None else False,
                        _ints(a_size, rows), _ints(rf("size"), rows))
        chunks.append((pid, is_add, size, _ints(af("modificationTime"), rows),
                       _ints(rf("deletionTimestamp"), rows)))
        stats.extend(_strings(af("stats"), rows))
        pvs.extend(_partition_dicts(af("partitionValues"), rows, is_add))
        file_lines.extend([None] * k)
        batches.append((n_rows, rows, add, rem))
        sp_parts.append((StatsParsed.of(af("stats_parsed"), rows), k))
        n_rows += k
    lines = decode_json_commits([store.read_bytes(p) for p in delta_paths])
    path_id: List[int] = []
    is_add_l: List[bool] = []
    size_l: List[int] = []
    mtime: List[int] = []
    dts: List[int] = []
    for ln in lines:
        obj = json.loads(ln)
        add = obj.get("add")
        rem = obj.get("remove")
        a_path = add.get("path") if isinstance(add, dict) else None
        r_path = rem.get("path") if isinstance(rem, dict) else None
        if a_path is None and r_path is None:
            if b'"metaData"' in ln or b'"protocol"' in ln or b'"txn"' in ln:
                a = action_from_dict(obj)
                if isinstance(a, (Protocol, Metadata, SetTransaction)):
                    other.append(a)
            continue
        path = _canonical(a_path if a_path is not None else r_path)
        path_id.append(ids.setdefault(path, len(ids)))
        file_lines.append(ln)
        if a_path is not None:
            is_add_l.append(True)
            sz = add.get("size")
            if sz is None and rem is not None:
                sz = rem.get("size")
            size_l.append(_int(sz))
            mtime.append(_int(add.get("modificationTime")))
            st = add.get("stats")
            stats.append(st if isinstance(st, str) else None)
            pv = add.get("partitionValues")
            pvs.append((pv or _NO_PARTITIONS) if isinstance(pv, dict) else None)
        else:
            is_add_l.append(False)
            size_l.append(_int(rem.get("size")))
            mtime.append(0)
            stats.append(None)
            pvs.append(None)
        dts.append(_int(rem.get("deletionTimestamp")) if isinstance(rem, dict) else 0)
    chunks.append((np.asarray(path_id, np.int32), np.asarray(is_add_l, bool),
                   np.asarray(size_l, np.int64), np.asarray(mtime, np.int64),
                   np.asarray(dts, np.int64)))
    sp_parts.append((None, len(path_id)))
    return SegmentColumns(
        path_dict=list(ids),
        path_id=np.concatenate([c[0] for c in chunks]),
        is_add=np.concatenate([c[1] for c in chunks]),
        size=np.concatenate([c[2] for c in chunks]),
        modification_time=np.concatenate([c[3] for c in chunks]),
        deletion_timestamp=np.concatenate([c[4] for c in chunks]),
        stats=stats,
        partition_values=pvs,
        lines=file_lines,
        other_actions=other,
        ckpt_batches=batches,
        stats_parsed=StatsParsed.concat(sp_parts),
    )

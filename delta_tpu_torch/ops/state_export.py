"""Table state as fixed-width numpy lanes for the device kernels.

The port's own copy of ``delta_tpu.ops.state_export``:

* :func:`arrays_from_columns` (the resident scan planner's lanes):
  AddFile metadata of a columnar segment becomes SoA numpy columns — paths
and partition strings dictionary-encoded, sizes as int64, per-file min/max
stats as float64 lanes (NaN = missing) — with the standard library's
``json`` in place of ``pyarrow.json`` and ``pyarrow.compute``.

The lanes follow the JAX package's vectorized Arrow path value for value:
integer stats beyond 2^53 become missing (a float64 lane cannot hold them
exactly), date stats become epoch days and timestamp stats epoch
microseconds (exact integer arithmetic, as Arrow's cast), string stats of
the requested columns become the 6-byte big-endian prefix lane
(:func:`string_prefix_lane_value`), and a stats string that fails to parse
makes every file's stats missing, as the JAX package's batch parse does;
* :func:`files_to_arrays` and :meth:`FileStateArrays.device_env` (the
  skipping evaluator's lanes, ``expr/device_eval``) from AddFile objects,
  value for value as the JAX package's per-file path builds them;
* :func:`stats_table` (the host prune's table, ``expr/vectorized``);
* :class:`ReplayArrays` / :func:`actions_to_arrays` (the replay kernel's
  action stream, ``ops/replay_kernel``).
"""
from __future__ import annotations

import datetime as _dt
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from delta_tpu_torch.expr.nested import decimal_ps
from delta_tpu_torch.protocol.actions import Action, AddFile, Metadata, RemoveFile
from delta_tpu_torch.schema.types import (
    ByteType, DataType, DateType, DoubleType, FloatType, IntegerType, LongType,
    ShortType, StructType, TimestampType,
)

__all__ = ["FileStateArrays", "arrays_from_columns", "string_prefix_lane_value",
           "files_to_arrays", "stats_table", "ReplayArrays", "actions_to_arrays"]

_NUMERIC = (ByteType, ShortType, IntegerType, LongType, FloatType, DoubleType,
            DateType, TimestampType)

_EPOCH = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)
_US = _dt.timedelta(microseconds=1)


_I64_MIN = -(1 << 63)


def _int_lane(v: int) -> Optional[float]:
    """An integer JSON stats value as its lane value: exact within 2^53, and
    -2^63, which a float64 holds exactly and the JAX package's Arrow lanes
    keep (its ``np.abs`` of INT64_MIN overflows to a negative); every other
    magnitude beyond 2^53 is missing."""
    return float(v) if -2**53 <= v <= 2**53 or v == _I64_MIN else None


def _stat_to_lane(v: Any, dt: DataType) -> Optional[float]:
    """One JSON stats value as a comparable float64 lane value, or None
    (missing: pruning keeps the file)."""
    if v is None or isinstance(v, bool):
        return None
    if isinstance(v, int):
        return _int_lane(v)
    try:
        if isinstance(v, str):
            if isinstance(dt, DateType):
                return float((_dt.date.fromisoformat(v[:10]) - _dt.date(1970, 1, 1)).days)
            if isinstance(dt, TimestampType):
                s = v.replace(" ", "T")
                if s.endswith("Z"):
                    s = s[:-1] + "+00:00"
                d = _dt.datetime.fromisoformat(s)
                # tz-naive stats are wall-clock UTC
                if d.tzinfo is None:
                    d = d.replace(tzinfo=_dt.timezone.utc)
                return float((d - _EPOCH) // _US)
        return float(v)
    except (ValueError, TypeError):
        return None


def _numeric_lane(dt: Optional[DataType]):
    """Converter of one JSON stats value to its float64 lane value for a
    column of type ``dt`` (None = missing)."""
    dt = dt if dt is not None else DoubleType()
    if isinstance(dt, (DateType, TimestampType)):
        return lambda v: _stat_to_lane(v, dt)

    def num(v):
        t = type(v)
        if t is float:
            return v
        if t is int:
            return _int_lane(v)
        return _stat_to_lane(v, dt)

    return num


def string_prefix_lane_value(s: str) -> float:
    """First-6-bytes big-endian integer of a string's UTF-8 form, as an
    EXACT float64 (48 bits < 2^53). Monotone non-strict w.r.t. byte order:
    s1 <= s2 implies prefix(s1) <= prefix(s2), so range pruning over
    prefix lanes keeps a superset (never drops a match)."""
    b = s.encode("utf-8")[:6]
    v = 0
    for i, byte in enumerate(b):
        v += byte << (8 * (5 - i))
    return float(v)


def _prefix_lane(v: Any) -> Optional[float]:
    return string_prefix_lane_value(v) if isinstance(v, str) else None


@dataclass
class FileStateArrays:
    """Snapshot AddFile metadata as columns; row i describes ``paths[i]``.
    The resident planner's lanes (:func:`arrays_from_columns`) leave the
    record and null counts and modification times empty; the skipping
    evaluator's (:func:`files_to_arrays`) fill them."""

    paths: List[str]
    size: np.ndarray  # int64
    partition_codes: Dict[str, np.ndarray]  # int32 codes, -1 = null
    partition_dicts: Dict[str, List[str]]  # code -> raw partition string
    stats_min: Dict[str, np.ndarray]  # float64, NaN = missing
    stats_max: Dict[str, np.ndarray]
    modification_time: Optional[np.ndarray] = None  # int64
    num_records: Optional[np.ndarray] = None  # int64, -1 = unknown
    stats_null_count: Dict[str, np.ndarray] = field(default_factory=dict)  # int64, -1 = missing

    @property
    def num_files(self) -> int:
        return len(self.paths)

    def _lanes(self) -> Dict[str, Tuple[np.ndarray, Optional[np.ndarray]]]:
        """name -> (values, valid or None), under the flat names the
        skipping rewrite emits (``min.c`` / ``max.c`` / ``nullCount.c`` /
        ``numRecords`` / ``size``; partition columns as
        ``partition_code.c`` dictionary codes, never under the column name:
        a literal compares against the value, not the code)."""
        nr = self.num_records if self.num_records is not None else \
            np.full(self.num_files, -1, np.int64)
        lanes: Dict[str, Tuple[np.ndarray, Optional[np.ndarray]]] = {
            "numRecords": (nr, nr >= 0), "size": (self.size, None)}
        for c, codes in self.partition_codes.items():
            lanes[f"partition_code.{c}"] = (codes, codes >= 0)
        for c, mn in self.stats_min.items():
            lanes[f"min.{c}"] = (mn, ~np.isnan(mn))
        for c, mx in self.stats_max.items():
            lanes[f"max.{c}"] = (mx, ~np.isnan(mx))
        for c, nc in self.stats_null_count.items():
            lanes[f"nullCount.{c}"] = (nc, nc >= 0)
        return lanes

    def lane_dtypes(self) -> Dict[str, "torch.dtype"]:
        """name -> torch dtype of every lane :meth:`device_env` binds."""
        import torch

        return {k: torch.from_numpy(v[:0]).dtype for k, (v, _) in self._lanes().items()}

    def device_env(self, device="cuda", names: Optional[Sequence[str]] = None):
        """The lanes (all, or only ``names``) as
        :class:`delta_tpu_torch.expr.device_eval.DeviceColumn`s on
        ``device``."""
        from delta_tpu_torch.expr.device_eval import DeviceColumn
        from delta_tpu_torch.utils.device import resolve

        dev = resolve(device)
        lanes = self._lanes()
        keep = lanes if names is None else {k: lanes[k] for k in names}
        return {k: DeviceColumn.of(v, ok, device=dev) for k, (v, ok) in keep.items()}


def _dictionary_encode(values: List[Optional[str]]):
    """int32 codes in order of first appearance (None -> -1) and the
    dictionary, as ``pyarrow``'s ``dictionary_encode`` assigns them."""
    ids: Dict[str, int] = {}
    codes = np.fromiter(
        (-1 if v is None else ids.setdefault(v, len(ids)) for v in values),
        np.int32, len(values))
    return codes, list(ids)


def arrays_from_columns(
    cols,
    rows_mask: np.ndarray,
    metadata: Metadata,
    stats_columns: Optional[Sequence[str]] = None,
    string_prefix_cols: Sequence[str] = (),
) -> Optional[FileStateArrays]:
    """:class:`FileStateArrays` for the selected rows of a columnar segment
    (``log/columnar.SegmentColumns``), without AddFile dataclasses. None when
    an add lacks its partition-values map."""
    rows = np.nonzero(rows_mask)[0] if rows_mask.dtype == bool else np.asarray(rows_mask)
    part_cols = list(metadata.partition_columns)
    part_codes: Dict[str, np.ndarray] = {}
    part_dicts: Dict[str, List[str]] = {}
    if part_cols:
        strings = cols.partition_strings(rows, part_cols)
        if strings is None:
            return None
        for c in part_cols:
            part_codes[c], part_dicts[c] = _dictionary_encode(strings[c])

    schema: StructType = metadata.schema
    pset = set(part_cols)
    if stats_columns is None:
        stats_columns = [f.name for f in schema.fields
                         if f.name not in pset and isinstance(f.data_type, _NUMERIC)]
    prefix_set = {c for c in string_prefix_cols if c not in pset}
    stats_columns = list(stats_columns) + [
        c for c in sorted(prefix_set) if c not in set(stats_columns)]
    col_types: Dict[str, DataType] = {f.name: f.data_type for f in schema.fields}

    n = len(rows)
    out = FileStateArrays(
        paths=cols.paths_for(rows), size=cols.size[rows].copy(),
        partition_codes=part_codes, partition_dicts=part_dicts,
        stats_min={c: np.full(n, np.nan) for c in stats_columns},
        stats_max={c: np.full(n, np.nan) for c in stats_columns},
    )
    struct_rows = _struct_stat_lanes(getattr(cols, "stats_parsed", None), rows, stats_columns,
                                     prefix_set, col_types, out.stats_min, out.stats_max)
    if struct_rows is not None and struct_rows.all():
        return out  # every row served by the typed lanes: no JSON parse
    raw = [cols.stats[r] for r in rows.tolist()]
    if struct_rows is not None:
        # the rows the struct served leave the JSON pass
        raw = [None if hit else s for s, hit in zip(raw, struct_rows.tolist())]
    idx = [i for i, s in enumerate(raw) if s is not None and s.strip()]
    if not idx:
        return out
    # one pass over the rows, keeping only numbers: no parsed dict outlives
    # its row, so a million-file build leaves nothing for the cyclic GC
    convert = [(c, _prefix_lane if c in prefix_set else _numeric_lane(col_types.get(c)))
               for c in stats_columns]
    lo_vals = {c: [] for c in stats_columns}
    hi_vals = {c: [] for c in stats_columns}
    empty: Dict[str, Any] = {}
    for i in idx:
        try:
            p = json.loads(raw[i])
        except ValueError:
            return out  # one malformed stats string: every stat missing (keeps all)
        if not isinstance(p, dict):
            return out
        mn, mx = p.get("minValues"), p.get("maxValues")
        mn = mn if isinstance(mn, dict) else empty
        mx = mx if isinstance(mx, dict) else empty
        for c, conv in convert:
            lo_vals[c].append(conv(mn.get(c)))
            hi_vals[c].append(conv(mx.get(c)))
    at = np.asarray(idx, np.int64)
    for c in stats_columns:
        out.stats_min[c][at] = np.array(lo_vals[c], dtype=np.float64)  # None -> NaN
        out.stats_max[c][at] = np.array(hi_vals[c], dtype=np.float64)
    return out


def _typed_lane(values: np.ndarray, valid: np.ndarray, stype: str, prefix: bool,
                dt: Optional[DataType]) -> Optional[np.ndarray]:
    """A typed ``stats_parsed`` leaf as a float64 lane (NaN = missing), as
    the JAX package's ``_numeric_to_lane`` / ``_temporal_to_lane`` /
    ``_string_prefix_lanes`` give it: integers beyond 2^53 missing, dates
    as epoch days, timestamps as epoch µs, strings as the 6-byte prefix
    lane where the column asks for one; None where it gives none (a
    decimal, as Arrow's decimal is neither an integer nor a float there)."""
    if stype is None or decimal_ps(stype) is not None:
        return None
    if stype in ("string",):
        if not prefix:
            if isinstance(dt, (DateType, TimestampType)):
                out = np.array([_stat_to_lane(v, dt) if ok else None
                                for v, ok in zip(values.tolist(), valid.tolist())], np.float64)
                return out
            return None
        return np.array([string_prefix_lane_value(v) if ok else np.nan
                         for v, ok in zip(values.tolist(), valid.tolist())], np.float64)
    if stype in ("bool", "binary"):
        return None
    if stype.startswith("int"):
        ints = values.astype(np.int64)
        out = ints.astype(np.float64)
        out[np.abs(ints) > 2**53] = np.nan
    else:  # floats, dates (epoch days), timestamps (epoch µs)
        out = values.astype(np.float64)
    out[~valid] = np.nan
    return out


def _struct_stat_lanes(sp, rows, stats_columns, prefix_set, col_types, smin, smax):
    """Fill the min/max lanes from a segment's typed ``stats_parsed``
    (``log/columnar.StatsParsed``) at ``rows``, as the JAX package's
    ``_struct_stat_lanes`` does; the bool mask of the rows it served, or
    None where it cannot serve this request (no struct, none present, or a
    requested column missing from its min or max fields: then the JSON pass
    computes every lane, so no column is half served)."""
    if sp is None:
        return None
    minf, maxf = set(sp.fields.get("minValues", ())), set(sp.fields.get("maxValues", ()))
    if not set(stats_columns) <= (minf & maxf):
        return None
    served = sp.valid[rows]
    if not served.any():
        return None
    idx = np.nonzero(served)[0]
    at = rows[idx]
    for name, dest in (("minValues", smin), ("maxValues", smax)):
        for c in stats_columns:
            lane = sp.lanes.get(f"{name}.{c}")
            if lane is None:
                continue
            got = _typed_lane(lane[0][at], lane[1][at], lane[2], c in prefix_set,
                              col_types.get(c))
            if got is not None:
                dest[c][idx] = got
    return served


# -- the skipping evaluator's lanes, from AddFile objects ----------------------


def _file_stat_to_lane(v: Any, dt: DataType) -> Optional[float]:
    """One JSON stats value as a float64 lane value, as the JAX package's
    per-file path (``files_to_arrays``) converts it: integers beyond 2^53
    are missing, -2^63 included (that path takes Python's ``abs``, which
    does not overflow, unlike the Arrow lanes of :func:`_int_lane`), ISO
    dates become epoch days and timestamps epoch microseconds through
    ``datetime.timestamp()``."""
    if v is None:
        return None
    if isinstance(v, int) and abs(v) > 2**53:
        return None
    try:
        if isinstance(dt, DateType) and isinstance(v, str):
            return float((_dt.date.fromisoformat(v[:10]) - _dt.date(1970, 1, 1)).days)
        if isinstance(dt, TimestampType) and isinstance(v, str):
            s = v.replace(" ", "T")
            if s.endswith("Z"):
                s = s[:-1] + "+00:00"
            d = _dt.datetime.fromisoformat(s)
            if d.tzinfo is None:
                d = d.replace(tzinfo=_dt.timezone.utc)
            return float(d.timestamp() * 1e6)
        return float(v)
    except (ValueError, TypeError):
        return None


def files_to_arrays(files: Sequence[AddFile], metadata: Metadata,
                    stats_columns: Optional[Sequence[str]] = None) -> FileStateArrays:
    """Columnarize AddFiles. ``stats_columns`` defaults to every numeric
    non-partition column of the schema."""
    schema: StructType = metadata.schema
    part_cols = list(metadata.partition_columns)
    if stats_columns is None:
        stats_columns = [f.name for f in schema.fields
                         if f.name not in part_cols and isinstance(f.data_type, _NUMERIC)]
    col_types: Dict[str, DataType] = {f.name: f.data_type for f in schema.fields}

    n = len(files)
    paths = [f.path for f in files]
    size = np.fromiter((f.size or 0 for f in files), np.int64, n)
    mtime = np.fromiter((f.modification_time or 0 for f in files), np.int64, n)

    part_codes: Dict[str, np.ndarray] = {}
    part_dicts: Dict[str, List[str]] = {}
    for c in part_cols:
        part_codes[c], part_dicts[c] = _dictionary_encode(
            [(f.partition_values or {}).get(c) for f in files])

    num_records = np.full(n, -1, np.int64)
    smin = {c: np.full(n, np.nan) for c in stats_columns}
    smax = {c: np.full(n, np.nan) for c in stats_columns}
    snull = {c: np.full(n, -1, np.int64) for c in stats_columns}
    for i, f in enumerate(files):
        st = f.stats_dict()
        if not st:
            continue
        nr = st.get("numRecords")
        if nr is not None:
            num_records[i] = int(nr)
        mins = st.get("minValues") or {}
        maxs = st.get("maxValues") or {}
        nulls = st.get("nullCount") or {}
        for c in stats_columns:
            dt = col_types.get(c, DoubleType())
            v = _file_stat_to_lane(mins.get(c), dt)
            if v is not None:
                smin[c][i] = v
            v = _file_stat_to_lane(maxs.get(c), dt)
            if v is not None:
                smax[c][i] = v
            if nulls.get(c) is not None:
                snull[c][i] = int(nulls[c])
    return FileStateArrays(
        paths=paths, size=size, partition_codes=part_codes, partition_dicts=part_dicts,
        stats_min=smin, stats_max=smax, modification_time=mtime,
        num_records=num_records, stats_null_count=snull)


def stats_table(files: Sequence[AddFile], metadata: Metadata,
                stats_columns: Optional[Sequence[str]] = None):
    """Host view of per-file stats for the host prune (every column,
    strings included), with the typed partition values bound so mixed
    partition/data predicates evaluate the partition leg exactly. Typed as
    ``pyarrow.Table.from_pylist`` types the same rows (``expr/vectorized``);
    raises where it raises."""
    from delta_tpu_torch.expr.partition import typed_partition_row
    from delta_tpu_torch.expr.vectorized import table_from_rows

    schema: StructType = metadata.schema
    part_cols = set(metadata.partition_columns)
    part_schema = metadata.partition_schema
    if stats_columns is None:
        stats_columns = [f.name for f in schema.fields if f.name not in part_cols]
    rows: List[Dict[str, Any]] = []
    for f in files:
        st = f.stats_dict() or {}
        row: Dict[str, Any] = {"numRecords": st.get("numRecords")}
        mins = st.get("minValues") or {}
        maxs = st.get("maxValues") or {}
        nulls = st.get("nullCount") or {}
        for c in stats_columns:
            row[f"min.{c}"] = mins.get(c)
            row[f"max.{c}"] = maxs.get(c)
            row[f"nullCount.{c}"] = nulls.get(c)
        row.update(typed_partition_row(f, part_schema))
        rows.append(row)
    return table_from_rows(rows)


# -- the replay kernel's action stream -----------------------------------------


@dataclass
class ReplayArrays:
    """A log segment's Add/Remove stream as columns, in commit order.

    ``seq`` is the global action order (commit version major, position within
    the commit minor): last-writer-wins is the row with the largest ``seq``
    of each path (``actions/InMemoryLogReplay.scala:43-65`` semantics).
    """

    paths: List[str]  # dictionary: path_id -> path
    path_id: np.ndarray  # int32, one per action row
    seq: np.ndarray  # int64
    is_add: np.ndarray  # bool
    size: np.ndarray  # int64 (0 for removes without size)
    deletion_timestamp: np.ndarray  # int64, only for removes (0 otherwise)
    row_action: List[Action] = field(default_factory=list)  # aligned originals

    @property
    def num_rows(self) -> int:
        return len(self.path_id)


def actions_to_arrays(versioned_actions: Sequence[Tuple[int, Sequence[Action]]]) -> ReplayArrays:
    """Flatten ``[(version, actions), ...]`` into :class:`ReplayArrays`,
    keeping only file actions. ``seq = version << 31 | position``; a commit
    with 2^31 file actions or a version from 2^32 raises rather than share
    a seq."""
    mapping: Dict[str, int] = {}
    dictionary: List[str] = []
    path_id: List[int] = []
    seq: List[int] = []
    is_add: List[bool] = []
    size: List[int] = []
    del_ts: List[int] = []
    originals: List[Action] = []
    for version, actions in versioned_actions:
        for pos, a in enumerate(actions):
            if isinstance(a, AddFile):
                add, dts = True, 0
            elif isinstance(a, RemoveFile):
                add, dts = False, a.delete_timestamp
            else:
                continue
            code = mapping.get(a.path)
            if code is None:
                code = mapping[a.path] = len(dictionary)
                dictionary.append(a.path)
            path_id.append(code)
            if pos >= 1 << 31:
                raise ValueError(f"commit {version} has {pos + 1}+ file actions; "
                                 "more than 2^31 per commit is unsupported")
            if version >= 1 << 32:
                raise ValueError(f"version {version} exceeds 2^32; seq encoding unsupported")
            seq.append((version << 31) | pos)
            is_add.append(add)
            size.append(a.size or 0)
            del_ts.append(dts)
            originals.append(a)
    return ReplayArrays(
        paths=dictionary,
        path_id=np.asarray(path_id, np.int32),
        seq=np.asarray(seq, np.int64),
        is_add=np.asarray(is_add, bool),
        size=np.asarray(size, np.int64),
        deletion_timestamp=np.asarray(del_ts, np.int64),
        row_action=originals,
    )

"""Checkpoints: the reconciled log state as Parquet (the port's own copy of
``delta_tpu.log.checkpoints``, through the port's own nested Parquet codec,
``exec/parquet``, where the JAX package uses ``pyarrow``).

A checkpoint file holds one row per action, with nullable struct columns
``txn``/``add``/``remove``/``metaData``/``protocol`` (``PROTOCOL.md``
"Checkpoint Schema"), plus the ``_last_checkpoint`` pointer JSON. Tables
with struct stats on (:func:`write_stats_as_struct`) also get the V2 typed
``add.partitionValues_parsed`` and ``add.stats_parsed`` columns.

The JAX package has two writers (a columnar one over the segment's columns
and one over action rows); the port keeps one, over actions, whose rows
equal both. It writes PLAIN, uncompressed pages (what the port's Parquet
writer has); a DECIMAL stats leaf is a ``decimal128(p, s)`` column and a
list or map data column's a list or map column, as ``arrow_type_for`` lays
them out. Parts are written one after another; distributed part writes
wait for a later slice.
"""
from __future__ import annotations

import datetime as _dt
import decimal
import json
import math
import os
from collections import Counter
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from delta_tpu_torch.exec import parquet as pq
from delta_tpu_torch.expr.partition import typed_partition_row
from delta_tpu_torch.protocol import filenames
from delta_tpu_torch.protocol.actions import (
    Action, AddFile, Metadata, Protocol, RemoveFile, SetTransaction,
)
from delta_tpu_torch.expr.nested import NCol, decimal_type, embed, ncol_from_py
from delta_tpu_torch.schema.types import (
    ArrayType, BinaryType, BooleanType, ByteType, DataType, DateType, DecimalType, DoubleType,
    FloatType, IntegerType, LongType, MapType, ShortType, StringType, StructType, TimestampType,
)
from delta_tpu_torch.storage.logstore import LocalLogStore
from delta_tpu_torch.utils import errors
from delta_tpu_torch.utils.config import DeltaConfigs, conf
from delta_tpu_torch.utils.errors import DeltaIllegalStateError
from delta_tpu_torch.utils.timeparse import iso_to_date, iso_to_naive_utc

__all__ = ["CheckpointMetaData", "CheckpointInstance", "read_last_checkpoint",
           "write_last_checkpoint", "latest_complete_checkpoint",
           "find_last_complete_checkpoint_before", "write_checkpoint", "write_stats_as_struct",
           "read_checkpoint_actions", "row_to_action"]

#: stats leaf types the JAX package's vectorised struct-stats builder types;
#: the engine default writes ``stats_parsed`` only for schemas of these
_SIMPLE_STATS_TYPES = (ByteType, ShortType, IntegerType, LongType, FloatType, DoubleType,
                       StringType, BooleanType, DateType, TimestampType)

_EPOCH_DAY = _dt.date(1970, 1, 1)
_EPOCH_TS = _dt.datetime(1970, 1, 1)


@dataclass(frozen=True)
class CheckpointMetaData:
    """Content of ``_last_checkpoint`` (``Checkpoints.scala:51-58``)."""

    version: int
    size: int
    parts: Optional[int] = None

    def to_json(self) -> str:
        d: Dict[str, Any] = {"version": self.version, "size": self.size}
        if self.parts is not None:
            d["parts"] = self.parts
        return json.dumps(d, separators=(",", ":"))

    @staticmethod
    def from_json(s: str) -> "CheckpointMetaData":
        d = json.loads(s)
        return CheckpointMetaData(int(d["version"]), int(d.get("size", -1)), d.get("parts"))


@dataclass(frozen=True, order=True)
class CheckpointInstance:
    """A (version, parts) candidate checkpoint (``Checkpoints.scala:60-106``)."""

    version: int
    parts: Optional[int] = None

    def paths(self, log_path: str) -> List[str]:
        if self.parts is None:
            return [f"{log_path}/{filenames.checkpoint_file_single(self.version)}"]
        return [f"{log_path}/{p}"
                for p in filenames.checkpoint_file_with_parts(self.version, self.parts)]


def read_last_checkpoint(store: LocalLogStore, log_path: str) -> Optional[CheckpointMetaData]:
    """The ``_last_checkpoint`` pointer; None when it is absent or corrupt
    (callers then list, ``Checkpoints.scala:148-175``)."""
    try:
        lines = store.read(f"{log_path}/{filenames.LAST_CHECKPOINT}")
    except FileNotFoundError:
        return None
    try:
        return CheckpointMetaData.from_json("".join(lines))
    except (ValueError, KeyError, TypeError):
        return None


def write_last_checkpoint(store: LocalLogStore, log_path: str, md: CheckpointMetaData) -> None:
    store.write(f"{log_path}/{filenames.LAST_CHECKPOINT}", [md.to_json()], overwrite=True)


def latest_complete_checkpoint(instances: Sequence[CheckpointInstance],
                               not_later_than: Optional[int] = None
                               ) -> Optional[CheckpointInstance]:
    """The latest checkpoint all of whose parts are present
    (``Checkpoints.scala:210-218``): a multi-part file appears once a
    part, as ``CheckpointInstance(version, n)``; a tie prefers one part."""
    if not_later_than is not None:
        instances = [c for c in instances if c.version <= not_later_than]
    counts = Counter(instances)
    complete = [inst for inst, cnt in counts.items()
                if (inst.parts is None and cnt >= 1)
                or (inst.parts is not None and cnt >= inst.parts)]
    if not complete:
        return None
    return max(complete, key=lambda c: (c.version, -(c.parts or 0)))


def find_last_complete_checkpoint_before(store: LocalLogStore, log_path: str,
                                         version: int) -> Optional[CheckpointInstance]:
    """Backward scan in 1000-version windows (``Checkpoints.scala:187-204``)."""
    cur = max(0, version)
    while cur >= 0:
        start = max(0, cur - 1000)
        prefix = f"{log_path}/{filenames.check_version_prefix(start)}"
        candidates: List[CheckpointInstance] = []
        try:
            for st in store.list_from(prefix):
                name = st.name
                if filenames.is_checkpoint_file(name) and st.size > 0:
                    v = filenames.checkpoint_version(name)
                    if v < version if cur == version else v <= cur:
                        part = filenames.checkpoint_part(name)
                        candidates.append(CheckpointInstance(v, part[1] if part else None))
        except FileNotFoundError:
            return None
        upper = version - 1 if cur == version else cur
        found = latest_complete_checkpoint(candidates, not_later_than=upper)
        if found:
            return found
        if start == 0:
            return None
        cur = start - 1
    return None


# -- the schema -------------------------------------------------------------------

_STR_MAP = ("map", "string", "string")
_DV = ("struct", [("storageType", "string"), ("pathOrInlineDv", "string"),
                  ("sizeInBytes", "int64"), ("cardinality", "int64")])
_ADD = [("path", "string"), ("partitionValues", _STR_MAP), ("size", "int64"),
        ("modificationTime", "int64"), ("dataChange", "bool"), ("stats", "string"),
        ("tags", _STR_MAP), ("deletionVector", _DV)]
_REMOVE = [("path", "string"), ("deletionTimestamp", "int64"), ("dataChange", "bool"),
           ("extendedFileMetadata", "bool"), ("partitionValues", _STR_MAP), ("size", "int64"),
           ("tags", _STR_MAP), ("deletionVector", _DV)]
_SCHEMA = [
    ("txn", ("struct", [("appId", "string"), ("version", "int64"), ("lastUpdated", "int64")])),
    ("add", ("struct", _ADD)),
    ("remove", ("struct", _REMOVE)),
    ("metaData", ("struct", [
        ("id", "string"), ("name", "string"), ("description", "string"),
        ("format", ("struct", [("provider", "string"), ("options", _STR_MAP)])),
        ("schemaString", "string"), ("partitionColumns", ("list", "string")),
        ("configuration", _STR_MAP), ("createdTime", "int64")])),
    ("protocol", ("struct", [
        ("minReaderVersion", "int32"), ("minWriterVersion", "int32"),
        ("readerFeatures", ("list", "string")), ("writerFeatures", ("list", "string"))])),
]


def _stored(dt: DataType, name: str):
    """The codec's type of a stats or partition leaf (``arrow_type_for``'s
    layout): a stored type, a decimal's ``decimal128(p, s)``, or the spec of
    a struct, list or map."""
    for cls, st in ((BooleanType, "bool"), (ByteType, "int8"), (ShortType, "int16"),
                    (IntegerType, "int32"), (LongType, "int64"), (FloatType, "float32"),
                    (DoubleType, "float64"), (StringType, "string"), (DateType, "date32"),
                    (TimestampType, "timestamp[us]"), (BinaryType, "binary")):
        if isinstance(dt, cls):
            return st
    if isinstance(dt, StructType):
        return ("struct", [(f.name, _stored(f.data_type, f.name)) for f in dt.fields])
    if isinstance(dt, DecimalType):
        return decimal_type(dt.precision, dt.scale)
    if isinstance(dt, ArrayType):
        return ("list", _stored(dt.element_type, name))
    if isinstance(dt, MapType):
        return ("map", _stored(dt.key_type, name), _stored(dt.value_type, name))
    raise NotImplementedError(
        f"checkpoint column {name!r}: data type {type(dt).__name__} is not written by the "
        "port's Parquet writer")


def _null_count_spec(dt: DataType):
    if isinstance(dt, StructType):
        return ("struct", [(f.name, _null_count_spec(f.data_type)) for f in dt.fields])
    return "int64"


#: an action's checkpoint column
_KIND = {AddFile: "add", RemoveFile: "remove", Metadata: "metaData", Protocol: "protocol",
         SetTransaction: "txn"}


def _kind(a: Action) -> str:
    kind = _KIND.get(type(a))
    if kind is None:
        raise ValueError(f"Action not checkpointable: {a!r}")
    return kind


def _struct_stats_vectorizable(meta: Metadata) -> bool:
    schema = meta.schema
    known = {f.name for f in schema.fields}
    pcols = set(meta.partition_columns)
    if pcols and not pcols <= known:
        return False
    return all(isinstance(f.data_type, _SIMPLE_STATS_TYPES) for f in schema.fields)


def write_stats_as_struct(meta: Optional[Metadata]) -> bool:
    """The struct-stats gate: ``delta.checkpoint.writeStatsAsStruct`` (or
    its session default tier) where set, else the session conf
    ``delta.tpu.checkpoint.writeStatsAsStruct`` (on) for schemas whose
    stats leaves are all of :data:`_SIMPLE_STATS_TYPES`."""
    if meta is None:
        return False
    cfg = DeltaConfigs.CHECKPOINT_WRITE_STATS_AS_STRUCT
    explicit = ((meta.configuration or {}).get(cfg.key) is not None
                or conf.get(f"delta.tpu.properties.defaults.{cfg.key[len('delta.'):]}")
                is not None)
    if explicit:
        return cfg.from_metadata(meta)
    return (conf.get_bool("delta.tpu.checkpoint.writeStatsAsStruct", True)
            and _struct_stats_vectorizable(meta))


def _epoch(v, st):
    if v is None:
        return None
    if st == "date32":
        return (v - _EPOCH_DAY).days
    if st.startswith("timestamp"):
        return (v - _EPOCH_TS) // _dt.timedelta(microseconds=1)
    return v


def _typed(spec, v):
    """A coerced Python value as the codec's value of ``spec`` (dates and
    timestamps as epoch days and µs)."""
    if v is None:
        return None
    if isinstance(spec, tuple):
        return {name: _typed(cspec, v.get(name)) for name, cspec in spec[1]}
    return _epoch(v, spec)


def _v2(actions: Sequence[Action]):
    """The V2 add fields (``Checkpoints.scala:340-389``) as ``(extra
    (name, spec) pairs, builder)``, the builder taking the part's adds and
    giving each extra field's column over them; ``(None, None)`` when the
    table opts out or there is nothing to type. The builder parses each
    add's stats JSON once (one parse of the whole batch where every string
    is well formed) and fills one list a leaf, as the JAX package's
    vectorised builder fills its Arrow leaves."""
    meta = next((a for a in actions if isinstance(a, Metadata)), None)
    if meta is None or not write_stats_as_struct(meta):
        return None, None
    schema = meta.schema
    known = {f.name for f in schema.fields}
    pcols = list(meta.partition_columns)
    part_schema = meta.partition_schema
    data_fields = [f for f in schema.fields if f.name not in pcols]
    typed_pcols = bool(pcols) and set(pcols) <= known
    if not data_fields and not typed_pcols:
        return None, None
    extra = []
    if typed_pcols:
        extra.append(("partitionValues_parsed", ("struct", [
            (c, _stored(part_schema[c].data_type, c)) for c in pcols])))
    if data_fields:
        vals = ("struct", [(f.name, _stored(f.data_type, f.name)) for f in data_fields])
        extra.append(("stats_parsed", ("struct", [
            ("numRecords", "int64"), ("minValues", vals), ("maxValues", vals),
            ("nullCount", ("struct", [(f.name, _null_count_spec(f.data_type))
                                      for f in data_fields]))])))
    specs = dict(extra)

    def coerce(v, dt):
        if v is None:
            return None
        if isinstance(dt, StructType):
            if not isinstance(v, dict):
                return None
            return {f.name: coerce(v.get(f.name), f.data_type) for f in dt.fields}
        if isinstance(dt, DateType):
            return (iso_to_date(str(v)) - _EPOCH_DAY).days
        if isinstance(dt, TimestampType):
            return (iso_to_naive_utc(str(v)) - _EPOCH_TS) // _dt.timedelta(microseconds=1)
        if isinstance(dt, DecimalType):  # a JSON number's shortest digits
            return decimal.Decimal(str(v))
        return v

    def null_count(v, dt):
        if isinstance(dt, StructType):
            v = v if isinstance(v, dict) else {}
            return {f.name: null_count(v.get(f.name), f.data_type) for f in dt.fields}
        return int(v) if isinstance(v, (int, float)) else None

    def parse_all(stats: List[Optional[str]]) -> List[Any]:
        try:
            out = json.loads("[" + ",".join(s if s else "null" for s in stats) + "]")
            if len(out) == len(stats):
                return out
        except ValueError:
            pass
        out = []
        for s in stats:
            try:
                out.append(json.loads(s) if s else None)
            except ValueError:
                out.append(None)
        return out

    def build(adds: Sequence[AddFile]) -> Dict[str, NCol]:
        cols: Dict[str, NCol] = {}
        if typed_pcols:
            rows = [typed_partition_row(a, part_schema, exact_decimals=True) for a in adds]
            cols["partitionValues_parsed"] = ncol_from_py(
                specs["partitionValues_parsed"], [_typed(specs["partitionValues_parsed"], r)
                                                  for r in rows])
        if not data_fields:
            return cols
        parsed = [d if isinstance(d, dict) else {} for d in parse_all([a.stats for a in adds])]
        nr = [d.get("numRecords") for d in parsed]
        leaves: Dict[str, Dict[str, List[Any]]] = {}
        for key in ("minValues", "maxValues", "nullCount"):
            sub = [d.get(key) for d in parsed]
            sub = [x if isinstance(x, dict) else {} for x in sub]
            leaves[key] = {}
            for f in data_fields:
                col = [x.get(f.name) for x in sub]
                if key == "nullCount":
                    col = [null_count(v, f.data_type) for v in col]
                elif isinstance(f.data_type, (DateType, TimestampType, DecimalType, StructType)):
                    col = [coerce(v, f.data_type) for v in col]
                leaves[key][f.name] = col
        k = len(adds)
        ones = np.ones(k, bool)
        sp = specs["stats_parsed"][1]
        fields = {"numRecords": ncol_from_py("int64", [
            v if isinstance(v, int) and not isinstance(v, bool) else
            (int(v) if isinstance(v, float) else None) for v in nr])}
        for key, spec in sp[1:]:
            fields[key] = NCol("struct", ones.copy(), fields={
                name: ncol_from_py(cspec, leaves[key][name]) for name, cspec in spec[1]})
        cols["stats_parsed"] = NCol("struct", ones.copy(), fields=fields)
        return cols

    return extra, build


def _dv_row(dv):
    return None if dv is None else {k: dv.get(k) for k, _ in _DV[1]}


def _adds_ncol(adds: Sequence[AddFile], spec, build) -> NCol:
    """The ``add`` struct over ``adds``, column by column."""
    k = len(adds)
    fields = {
        "path": ncol_from_py("string", [a.path for a in adds]),
        "partitionValues": ncol_from_py(_STR_MAP, [a.partition_values for a in adds]),
        "size": ncol_from_py("int64", [a.size for a in adds]),
        "modificationTime": ncol_from_py("int64", [a.modification_time for a in adds]),
        "dataChange": ncol_from_py("bool", [a.data_change for a in adds]),
        "stats": ncol_from_py("string", [a.stats for a in adds]),
        "tags": ncol_from_py(_STR_MAP, [a.tags for a in adds]),
        "deletionVector": ncol_from_py(_DV, [_dv_row(a.deletion_vector) for a in adds]),
    }
    if build is not None:
        fields.update(build(adds))
    return NCol("struct", np.ones(k, bool), fields={name: fields[name] for name, _ in spec[1]})


def _part_bytes(acts: Sequence[Action], schema, v2_build, device) -> bytes:
    """One part's Parquet bytes: a row an action, in the order given; the
    adds column by column, the few other actions through their rows."""
    n = len(acts)
    by_kind: Dict[str, List[int]] = {}
    for i, a in enumerate(acts):
        by_kind.setdefault(_kind(a), []).append(i)
    cols = []
    for name, spec in schema:
        rows = np.asarray(by_kind.get(name, []), np.int64)
        picked = [acts[i] for i in rows.tolist()]
        if name == "add":
            col = _adds_ncol(picked, spec, v2_build)
        else:
            col = ncol_from_py(spec, [a.to_dict() for a in picked])
        cols.append((name, spec, embed(col, rows, n)))
    return pq.write_nested(cols, n, device=device)


def write_checkpoint(store: LocalLogStore, log_path: str, version: int,
                     actions: Sequence[Action], parts: Optional[int] = None,
                     part_size: int = 1_000_000, device="cuda") -> CheckpointMetaData:
    """Write a checkpoint of ``version`` holding ``actions`` (the
    reconciled state, ``Snapshot.checkpoint_actions``): one part, or
    ``parts`` (or as many as ``part_size`` actions a part need), each a
    slice of the actions in order, its pages compressed on ``device``; then
    ``_last_checkpoint``, after every part is written."""
    n = len(actions)
    if parts is None:
        parts = 1 if n <= part_size else math.ceil(n / part_size)
    extra, build = _v2(actions)
    schema = list(_SCHEMA)
    if extra:
        schema[1] = ("add", ("struct", _ADD + extra))
    if parts == 1:
        paths = [f"{log_path}/{filenames.checkpoint_file_single(version)}"]
        slices = [list(actions)]
    else:
        paths = [f"{log_path}/{p}" for p in filenames.checkpoint_file_with_parts(version, parts)]
        chunk = math.ceil(n / parts) if n else 0
        slices = [actions[i * chunk:(i + 1) * chunk] for i in range(parts)]
    for path, acts in zip(paths, slices):
        store.write_bytes(path, _part_bytes(acts, schema, build, device), overwrite=True)
    md = CheckpointMetaData(version, n, None if parts == 1 else parts)
    write_last_checkpoint(store, log_path, md)
    return md


# -- reading ----------------------------------------------------------------------


def row_to_action(name: str, d: Optional[Dict[str, Any]]) -> Optional[Action]:
    """An action from one checkpoint row's struct (``_row_to_action``)."""
    if d is None:
        return None
    d = dict(d)
    if name == "add":
        return AddFile.from_dict(d)
    if name == "remove":
        return RemoveFile.from_dict(d)
    if name == "metaData":
        return Metadata.from_dict(d)
    if name == "protocol":
        return Protocol.from_dict(d)
    if name == "txn":
        return SetTransaction.from_dict(d)
    return None


def read_checkpoint_actions(store: LocalLogStore, paths: Sequence[str],
                            device="cuda") -> List[Action]:
    """One checkpoint (all its parts) back into actions: parts in order,
    within a part protocol, metadata, txns, removes, adds; each part's
    pages inflate on ``device``."""
    out: List[Action] = []
    for p in paths:
        try:
            data = store.read_bytes(p)
        except FileNotFoundError as e:
            version = filenames.get_file_version(os.path.basename(paths[0]))
            raise errors.missing_part_files(version, e) from e
        _, cols = pq.read_nested(data, ["protocol", "metaData", "txn", "remove", "add"],
                                 device=device, source=p)
        for name in ("protocol", "metaData", "txn", "remove", "add"):
            col = cols.get(name)
            if col is None:
                continue
            rows = np.nonzero(col.valid)[0]
            for v in col.to_py(rows):
                a = row_to_action(name, v)
                if a is not None:
                    out.append(a)
    if not out:
        raise DeltaIllegalStateError(f"Empty checkpoint read from {list(paths)}")
    return out

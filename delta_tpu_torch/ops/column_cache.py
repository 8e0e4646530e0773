"""Device-resident scan column lanes and the residual filter mask on the card
(the port's own copy of ``delta_tpu.ops.column_cache``).

A scan whose residual predicate lowers (``expr/device_eval.compile_residual``)
computes each file's survivor mask on the card: the predicate's columns are
decoded once into per-(table, file, column) lanes — strings as int32
dictionary codes, dates as epoch days, timestamps as epoch microseconds,
numerics widened to int64/float64 — kept on the device across queries, and
one launch of K14 (``csrc/residual_mask.cu``, :func:`residual_mask`) per
file writes the Kleene-TRUE row mask. Only survivor rows are then decoded on
the host (``exec/scan.read_files_as_table``'s ``device_masks``), and
``scan_to_table`` re-applies the residual over them, so the mask may only
change what decodes, never what returns.

Cache discipline mirrors ``ops/key_cache.KeyCache``: a process-wide
singleton keyed by (log path, file path, column), per-table rewrite epochs
(:meth:`ColumnCache.bump_epoch`: a rewrite drops the table's lanes, and a
decode that raced it is served but never cached) and LRU eviction under
``delta.tpu.columnCache.maxBytes`` / ``maxEntries``.

Routing, as in the JAX package: ``delta.tpu.read.deviceResidual.mode=auto``
prices each scan with the link cost model (``parallel/link``): the device
mask (the cold lanes' host decode and upload, K14 over every row, the mask
download) against the host filter, with rows estimated from the files'
sizes and the resident lanes counted; ``force`` takes the device whenever
the residual lowers, ``off`` keeps the host path. Both priced modes record
a ``scan.residual`` router audit (``obs/router_audit``); a declined scan
counts ``scan.device.declined`` and its report says
``device_residual == "host"``.

Differences from the JAX package, each deliberate:

* no HBM ledger and no residency gauges yet: the budget is ``maxBytes``;
* no quiet fallback: a residual that does not lower
  (``NotDeviceCompilable``) or a column with no lane form returns None and
  counts ``scan.device.fallback``, as in JAX; but a kernel that fails to
  build or launch, or a device allocation that fails, raises out of the
  scan (the JAX package turns any exception into the host path);
* an ``IN`` takes each option's validity in its own row, the host
  evaluator's semantics (``expr/device_eval``'s ``row_in``). The JAX kernel
  reduces it over every row of the padded lane, so a padded file's
  not-found rows turn NULL and the mask under-keeps.
"""
from __future__ import annotations

import datetime as _dt
import functools
import os
import struct
import threading
import time
import urllib.parse
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from delta_tpu_torch.expr import device_eval
from delta_tpu_torch.expr.device_eval import DeviceColumn, NotDeviceCompilable, Program
from delta_tpu_torch.expr.vectorized import HostColumn
from delta_tpu_torch.ops import native
from delta_tpu_torch.ops.state_cache import _next_pow2
from delta_tpu_torch.utils import telemetry
from delta_tpu_torch.utils.config import conf

__all__ = ["ResidentColumn", "ColumnCache", "device_residual_masks", "residual_mask",
           "residual_mask_plain"]


def _abs_data_path(data_path: str, file_path: str) -> str:
    if "://" in file_path or os.path.isabs(file_path):
        return urllib.parse.unquote(file_path)
    return os.path.join(data_path, urllib.parse.unquote(file_path).replace("/", os.sep))


def _lane_from_column(col: HostColumn) -> Optional[Tuple[np.ndarray, np.ndarray,
                                                           Optional[Dict[str, int]]]]:
    """One decoded column in its lane encoding: ``(values, valid, dict)``.
    Strings become int32 dictionary codes (consistent within the file; a
    NULL is -1) with the value -> code map for literal binding, dates int32
    epoch days, timestamps int64 epoch µs, integers int64, floats float64,
    booleans bool; NULL rows hold 0. None for a kind with no lane form."""
    valid = np.asarray(col.valid, bool)
    if col.kind == "str":
        mapping: Dict[str, int] = {}
        codes = np.full(len(valid), -1, np.int32)
        codes[valid] = np.fromiter((mapping.setdefault(v, len(mapping))
                                    for v in col.values[valid].tolist()), np.int32,
                                   int(valid.sum()))
        return codes, valid, mapping
    dtype = {"date": np.int32, "ts": np.int64, "int": np.int64, "double": np.float64,
             "bool": bool}.get(col.kind)
    if dtype is None:
        return None
    vals = np.where(valid, col.values, 0).astype(dtype)
    return vals, valid, None


class ResidentColumn:
    """One decoded (file, column) lane on the device: values and validity
    padded to a power of two (floor 64, as in JAX); pad rows are invalid and
    never read. String lanes keep their value -> code dictionary on the host
    for per-scan literal binding."""

    __slots__ = ("log_path", "file_path", "column", "values", "valid", "n", "dict_codes",
                 "nbytes", "epoch", "last_used", "_lock")

    def __init__(self, log_path: str, file_path: str, column: str, values: np.ndarray,
                 valid: np.ndarray, dict_codes: Optional[Dict[str, int]], epoch: int,
                 device="cuda"):
        self.log_path = log_path
        self.file_path = file_path
        self.column = column
        self.n = int(len(values))
        cap = _next_pow2(max(self.n, 1), floor=64)
        pv = np.zeros(cap, dtype=values.dtype)
        pv[: self.n] = values
        pm = np.zeros(cap, dtype=bool)
        pm[: self.n] = valid
        self.nbytes = int(pv.nbytes + pm.nbytes)
        self.dict_codes = dict_codes
        self.epoch = epoch
        self.last_used = 0
        self._lock = threading.Lock()
        self.values = torch.from_numpy(pv).to(device)
        self.valid = torch.from_numpy(pm).to(device)

    @property
    def is_resident(self) -> bool:
        return self.values is not None

    def drop_device(self) -> None:
        with self._lock:
            self.values = None
            self.valid = None


class ColumnCache:
    """Process-wide registry of resident scan-column lanes, keyed by (log
    path, file path, column). Entries are immutable after construction
    (Parquet files never change), so there is only residency and the
    per-table rewrite epoch."""

    _instance: Optional["ColumnCache"] = None
    _instance_lock = threading.Lock()

    def __init__(self):
        self._entries: Dict[Tuple[str, str, str], ResidentColumn] = {}
        self._lock = threading.RLock()
        self._tick = 0
        # per-table rewrite generation: lanes decoded under an older epoch
        # are never cached, and a bump drops the table's lanes
        self._epochs: Dict[str, int] = {}

    @classmethod
    def instance(cls) -> "ColumnCache":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = ColumnCache()
            return cls._instance

    @classmethod
    def reset(cls) -> None:
        with cls._instance_lock:
            cls._instance = None

    def epoch(self, log_path: str) -> int:
        with self._lock:
            return self._epochs.get(log_path, 0)

    def bump_epoch(self, log_path: str) -> None:
        """File-rewrite invalidation (OPTIMIZE, and UPDATE / DELETE /
        RESTORE once ported): drop the table's lanes; the epoch keeps a
        decode that raced the rewrite from being cached."""
        with self._lock:
            self._epochs[log_path] = self._epochs.get(log_path, 0) + 1
            stale = [k for k in self._entries if k[0] == log_path]
            for k in stale:
                self._entries.pop(k).drop_device()
        if stale:
            telemetry.bump_counter("columnCache.invalidations", len(stale))

    def invalidate(self, log_path: str) -> None:
        with self._lock:
            for k in [k for k in self._entries if k[0] == log_path]:
                self._entries.pop(k).drop_device()

    def get(self, log_path: str, file_path: str, column: str) -> Optional[ResidentColumn]:
        with self._lock:
            self._tick += 1
            key = (log_path, file_path, column)
            e = self._entries.get(key)
            if e is not None and e.epoch != self._epochs.get(log_path, 0):
                # a registration that raced a bump: never served
                self._entries.pop(key, None)
                e.drop_device()
                return None
            if e is not None and e.is_resident:
                e.last_used = self._tick
                return e
            if e is not None:
                self._entries.pop(key, None)  # evicted husk
            return None

    def register(self, entry: ResidentColumn) -> bool:
        """Adopt a freshly decoded lane; refused when the table's epoch moved
        during the decode (the caller serves the lane uncached: its mask is
        exact for its snapshot, whose files are immutable)."""
        with self._lock:
            if entry.epoch != self._epochs.get(entry.log_path, 0):
                return False
            self._tick += 1
            entry.last_used = self._tick
            self._entries[(entry.log_path, entry.file_path, entry.column)] = entry
        self._evict(keep=(entry.log_path, entry.file_path, entry.column))
        return True

    def resident_bytes(self) -> int:
        with self._lock:
            return sum(e.nbytes for e in self._entries.values() if e.is_resident)

    def _evict(self, keep=None) -> None:
        budget = int(conf.get("delta.tpu.columnCache.maxBytes", 1 << 30))
        max_entries = int(conf.get("delta.tpu.columnCache.maxEntries", 4096))
        dropped = 0
        with self._lock:
            resident = [(k, e) for k, e in self._entries.items() if e.is_resident]
            total = sum(e.nbytes for _, e in resident)
            for k, e in sorted(resident, key=lambda kv: kv[1].last_used):
                if total <= budget and len(self._entries) <= max_entries:
                    break
                if k == keep:
                    continue
                self._entries.pop(k, None)
                e.drop_device()
                total -= e.nbytes
                dropped += 1
        if dropped:
            telemetry.bump_counter("columnCache.evictions", dropped)


# -- K14: the residual mask ----------------------------------------------------


@functools.lru_cache(maxsize=128)
def _mask_program(expr, dtypes: Tuple[Tuple[str, torch.dtype], ...],
                  scalars: Tuple[Tuple[str, int], ...]) -> Program:
    """The residual's program for lanes of these dtypes (the counterpart of
    JAX's ``_mask_kernel`` cache, which jits per rewritten expression and
    shape)."""
    return device_eval.lower(expr, dict(dtypes), row_in=True, scalars=dict(scalars))


def _launch_lits(program: Program, scalars: Dict[str, Tuple[int, bool]]):
    """The program's literal table with the per-launch scalars filled in."""
    lits = program.lits.copy()
    valid = program.lit_valid.copy()
    for name, slot in (program.scalar_slots or {}).items():
        lits[slot], valid[slot] = scalars[name]
    return lits, valid


def _check(program: Program, env: Dict[str, DeviceColumn], n: int) -> List[DeviceColumn]:
    if program.n_flags:
        raise ValueError("residual_mask: the program reduces an IN option over rows; "
                         "lower it with row_in=True")
    cols = [env[c] for c in program.columns]
    for c in cols:
        if c.values.dim() != 1 or c.values.shape[0] < n or c.valid.shape != c.values.shape:
            raise ValueError(f"residual_mask: lanes must be 1-D, at least {n} rows long, "
                             "with valid masks of the same shape")
    return cols


def residual_mask(program: Program, env: Dict[str, DeviceColumn], n: int,
                  scalars: Optional[Dict[str, Tuple[int, bool]]] = None) -> torch.Tensor:
    """The Kleene-TRUE mask (bool, ``n`` rows) of a residual program over
    lanes at least ``n`` rows long: K14 for lanes on a CUDA device, the
    plain version for lanes on the CPU. ``scalars`` fills the program's
    per-launch literal slots (name -> (int64 bits, valid))."""
    cols = _check(program, env, n)
    dev = cols[0].values.device if cols else torch.device("cpu")
    if dev.type == "cpu":
        return residual_mask_plain(program, env, n, scalars)
    for c in cols:
        if c.values.device != dev or c.valid.device != dev:
            raise ValueError("residual_mask: lanes on more than one device")
    lits, lit_valid = _launch_lits(program, scalars or {})
    vals = [c.values.contiguous() for c in cols]
    oks = [c.valid.contiguous() for c in cols]
    n_instr = program.instrs.shape[0]
    buf = np.concatenate([
        np.ascontiguousarray(program.instrs).reshape(-1).view(np.int64),
        lits, lit_valid.astype(np.int64),
        np.array([t.data_ptr() for t in vals] or [0], np.int64),
        np.array([t.data_ptr() for t in oks] or [0], np.int64)])
    lit_off = n_instr * 4
    litv_off = lit_off + len(lits)
    colv_off = litv_off + len(lits)
    colk_off = colv_off + max(len(vals), 1)
    dbuf = torch.from_numpy(buf).to(dev)
    mask = torch.empty(n, dtype=torch.bool, device=dev)
    native.call("residual_mask", dev, dbuf.data_ptr(), n_instr, lit_off, litv_off, colv_off,
                colk_off, n, mask.data_ptr(), program.root, program.root_dtype)
    native.launches["residual_mask"] += 1
    return mask


def residual_mask_plain(program: Program, env: Dict[str, DeviceColumn], n: int,
                        scalars: Optional[Dict[str, Tuple[int, bool]]] = None) -> torch.Tensor:
    """Plain PyTorch version of K14: ``expr_eval_plain`` over the first
    ``n`` rows of the lanes, then ``values != 0 & valid``."""
    _check(program, env, n)
    lits, lit_valid = _launch_lits(program, scalars or {})
    filled = Program(program.instrs, lits, lit_valid, program.columns, program.col_dtypes,
                     program.root, program.root_dtype, program.n_regs, program.n_flags,
                     program.passes, program.scalar, program.scalar_slots)
    cut = {c: DeviceColumn(env[c].values[:n], env[c].valid[:n]) for c in program.columns}
    out = device_eval.expr_eval_plain(filled, cut)
    return (out.values != 0) & out.valid


def _scalar_column(value: Any) -> Tuple[int, int, bool]:
    """A per-file scalar (a string literal's code, a partition value) as a
    literal: (program dtype, int64 bits, valid), typed as JAX's
    ``_scalar_column`` types the device scalar."""
    if value is None:
        return device_eval.F32, 0, False
    if isinstance(value, bool):
        return device_eval.BOOL, int(value), True
    if isinstance(value, _dt.datetime):
        if value.tzinfo is None:
            value = value.replace(tzinfo=_dt.timezone.utc)
        return device_eval.I64, int(value.timestamp() * 1_000_000), True
    if isinstance(value, _dt.date):
        return device_eval.I32, (value - _dt.date(1970, 1, 1)).days, True
    if isinstance(value, int):
        return device_eval.I64, value, True
    if isinstance(value, float):
        return device_eval.F64, struct.unpack("<q", struct.pack("<d", value))[0], True
    raise NotDeviceCompilable(f"partition value {value!r} has no lane form")


# -- the scan path ------------------------------------------------------------------


def _on(t: torch.Tensor, device: torch.device) -> bool:
    """``t`` lies on ``device`` (``cuda`` with no index names the current
    card)."""
    device = torch.device(device)
    if t.device.type != device.type:
        return False
    if device.type == "cpu":
        return True
    return t.device.index == (device.index if device.index is not None
                              else torch.cuda.current_device())


def _ensure_lanes(cache: ColumnCache, log_path: str, data_path: str, add, need: List[str],
                  epoch: int, counters: Dict[str, int],
                  device) -> Optional[Dict[str, ResidentColumn]]:
    """Resident lanes for one file's predicate columns, decoding the misses
    (the predicate's columns only; the projection decodes later, for
    survivors). None when a column has no lane form. A column the file
    predates binds an all-invalid (NULL) lane."""
    from delta_tpu_torch.exec.parquet import column_names, read_parquet_file
    from delta_tpu_torch.exec.rowgroups import read_footer

    out: Dict[str, ResidentColumn] = {}
    missing = []
    for c in need:
        e = cache.get(log_path, add.path, c)
        if e is not None and _on(e.values, device):
            out[c] = e
            counters["hits"] += 1
        else:
            missing.append(c)
            counters["misses"] += 1
    if not missing:
        return out
    abs_path = _abs_data_path(data_path, add.path)
    meta = read_footer(abs_path)
    present = {name.lower(): name for name in column_names(meta)}
    stored = [present[c] for c in missing if c in present]
    tbl = read_parquet_file(abs_path, stored, meta=meta) if stored else None
    if stored:
        counters["coldBytes"] += sum(int(rg.total_byte_size) for rg in meta.row_groups or [])
    for c in missing:
        if c in present:
            lane = _lane_from_column(tbl.columns[present[c]])
            if lane is None:
                return None
            vals, valid, codes = lane
        else:
            # schema evolution: the file predates the column
            vals = np.zeros(int(meta.num_rows), np.float64)
            valid = np.zeros(int(meta.num_rows), bool)
            codes = None
        entry = ResidentColumn(log_path, add.path, c, vals, valid, codes, epoch, device)
        cache.register(entry)  # an epoch race: served uncached, still exact
        out[c] = entry
    return out


def device_residual_masks(snapshot, files, predicate) -> Optional[Dict[str, np.ndarray]]:
    """Per-file physical-row survivor masks of ``predicate``, computed on the
    snapshot's device from resident lanes, or None where the predicate does
    not lower, a column has no lane form, or the mode is ``off`` (the
    caller's host path is exact on its own). Deletion vectors are not
    applied here: the decode composes them by physical position."""
    from delta_tpu_torch.expr.synthesis import schema_types
    from delta_tpu_torch.obs import scan_report

    mode = str(conf.get("delta.tpu.read.deviceResidual.mode", "auto")).lower()
    if mode == "off" or predicate is None or not files:
        return None
    metadata = snapshot.metadata
    log = snapshot.delta_log
    try:
        plan = device_eval.compile_residual(predicate, schema_types(metadata),
                                            metadata.partition_columns)
    except NotDeviceCompilable:
        telemetry.bump_counter("scan.device.fallback")
        return None
    if not plan.refs:
        return None  # a partition-only residual: file pruning is exact
    if plan.part_refs:
        raise NotImplementedError("reading a partitioned table is not ported")
    from delta_tpu_torch.obs import router_audit
    from delta_tpu_torch.parallel import link

    cache = ColumnCache.instance()
    est_rows = sum(max((f.size or 0) // 64, 1024) for f in files)
    ncols = max(len(plan.refs), 1)
    resident_rows = sum(
        e.n for f in files for c in plan.refs
        if (e := cache.get(log.log_path, f.path, c)) is not None
        and _on(e.values, log.device)) // ncols
    cold_rows = max(est_rows - resident_rows, 0)
    p = link.profile(log.device)
    predicted = {"device": link.device_residual_mask_s(cold_rows, resident_rows, ncols, p),
                 "host": link.host_residual_filter_s(est_rows, ncols)}
    decision = ("device" if mode == "force" or predicted["device"] < predicted["host"]
                else "host")
    rep = scan_report.current_report()
    if decision == "host":
        telemetry.bump_counter("scan.device.declined")
        router_audit.record_audit(
            "scan.residual", log.data_path, "host", predicted, predicted["host"],
            units={"rows": est_rows, "cols": ncols}, log_path=log.log_path,
            calibration_flush=False, files=len(files), mode=mode)
        if rep is not None:
            rep.device_residual = "host"
        return None
    counters = {"hits": 0, "misses": 0, "coldBytes": 0}
    masks: Dict[str, np.ndarray] = {}
    need = sorted(plan.refs)
    scalar_types = tuple((ph, device_eval.I64) for ph, _c, _v in plan.str_binds)
    t0 = time.perf_counter()
    for add in files:
        lanes = _ensure_lanes(cache, log.log_path, log.data_path, add, need,
                              cache.epoch(log.log_path), counters, log.device)
        if lanes is None:
            telemetry.bump_counter("scan.device.fallback")
            return None
        n = max((e.n for e in lanes.values()), default=0)
        env = {c: DeviceColumn(e.values, e.valid) for c, e in lanes.items()}
        dtypes = tuple(sorted((c, e.values.dtype) for c, e in lanes.items()))
        try:
            program = _mask_program(plan.expr, dtypes, scalar_types)
        except NotDeviceCompilable:
            telemetry.bump_counter("scan.device.fallback")
            return None
        scalars = {}
        for ph, col, value in plan.str_binds:
            code = (lanes[col].dict_codes or {}).get(value, device_eval.STR_CODE_ABSENT)
            _dt_, bits, ok = _scalar_column(int(code))
            scalars[ph] = (bits, ok)
        masks[add.path] = residual_mask(program, env, n, scalars).cpu().numpy()
    actual_s = time.perf_counter() - t0
    telemetry.bump_counter("scan.device.engaged")
    if counters["hits"]:
        telemetry.bump_counter("columnCache.hits", counters["hits"])
    if counters["misses"]:
        telemetry.bump_counter("columnCache.misses", counters["misses"])
    total_rows = sum(len(m) for m in masks.values())
    samples = []
    if total_rows and counters["misses"] == 0:
        # a warm pass: the whole wall time is K14 and the mask download,
        # a clean sample of the device per-cell constant
        samples.append(("DEVICE_RESIDUAL_S_PER_CELL", total_rows * ncols, actual_s))
    router_audit.record_audit(
        "scan.residual", log.data_path, "device", predicted, actual_s,
        units={"rows": total_rows, "cols": ncols}, samples=samples, log_path=log.log_path,
        calibration_flush=False, files=len(files), cacheHits=counters["hits"],
        cacheMisses=counters["misses"], mode=mode)
    if rep is not None:
        rep.device_residual = "device"
    return masks

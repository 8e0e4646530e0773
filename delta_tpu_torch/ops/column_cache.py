"""Device-resident scan column lanes and the residual filter mask on the card
(the port's own copy of ``delta_tpu.ops.column_cache``).

A scan whose residual predicate lowers (``expr/device_eval.compile_residual``)
computes each file's survivor mask on the card: the predicate's columns are
decoded once into per-(table, file, column) lanes — strings as int32
dictionary codes, dates as epoch days, timestamps as epoch microseconds,
numerics widened to int64/float64 — kept on the device across queries, and
one launch of K14 (``csrc/residual_mask.cu``, :func:`residual_masks`) per
query writes the Kleene-TRUE row masks of all its files (a further launch
for each further 64 files, or for files whose lanes have other dtypes; a
program or a file table past the launch's parameters, a long IN list say,
is staged in pinned memory and copied to the card on the launch's stream);
they come down in one copy. Only survivor rows are then decoded on
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
  not-found rows turn NULL and the mask under-keeps;
* a partition column the residual references binds as a per-file scalar
  of the column's declared lane dtype, a NULL value as that dtype with
  ``valid=False``, so files with and without a value share one program
  and one launch; the JAX kernel traces a NULL value as a float32 scalar.
"""
from __future__ import annotations

import array
import ctypes
import datetime as _dt
import functools
import itertools
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
from delta_tpu_torch.expr.partition import typed_partition_row
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
    shape). Every program the lowering emits fits K14's staged tables (at
    most MAX_INSTRS instructions, a literal each or a TIMEFIELD's two)."""
    return device_eval.lower(expr, dict(dtypes), row_in=True, scalars=dict(scalars))


def _launch_lits(program: Program, scalars: Dict[str, Tuple[int, bool]]):
    """The program's literal table with the per-launch scalars filled in."""
    lits = program.lits.copy()
    valid = program.lit_valid.copy()
    for name, slot in (program.scalar_slots or {}).items():
        lits[slot], valid[slot] = scalars[name]
    return lits, valid


def _k14_dtype(instrs: int, lits: int, files: int, ptrs: int, scal: int,
               lit_scal: str) -> np.dtype:
    """K14's input block (``csrc/residual_mask.cu``'s ``MaskTables``, field
    for field) with these capacities: the program, the literal table and a
    file table."""
    return np.dtype([
        ("lits", "<i8", (lits,)), ("fscal", "<i8", (scal,)), ("rows", "<i8", (files,)),
        ("out_off", "<i8", (files,)), ("ptr", "<u8", (ptrs,)), ("tile_end", "<i4", (files,)),
        ("hdr", "<i4", (16,)), ("ins", "<i2", (instrs, 8)), ("usrc", "<i2", (instrs, 4)),
        ("lit_scal", lit_scal, (lits,)), ("lit_valid", "u1", (lits,)),
        ("fscal_valid", "u1", (scal,))])


#: the block passed in the launch's parameters (``MaskParams``)
_K14_PARAMS = _k14_dtype(256, 128, 64, 512, 128, "i1")
#: the block staged in pinned memory and copied to the card on the launch's
#: stream (``MaskGlobal``): room for every program the lowering emits (an
#: instruction's literal or a TIMEFIELD's two, a column and a scalar each)
_K14_GLOBAL = _k14_dtype(device_eval.MAX_INSTRS, 2 * device_eval.MAX_INSTRS, 64,
                         2 * device_eval.MAX_INSTRS, 4096, "<i2")
assert (_K14_PARAMS.itemsize, _K14_GLOBAL.itemsize) == (14016, 101696)
# MaskParams::hdr
(_H_INSTR, _H_COLS, _H_FILES, _H_SCAL, _H_ROOT, _H_ROOT_DT, _H_ROOT_SLOT, _H_TILE, _H_REGS,
 _H_TILES) = range(10)


#: the register file a tile may hold in shared memory: K14's 48 KB; K15's
#: 55 KB, four CTAs an SM (the 64 registers a thread allow four) in its
#: 228 KB, which measured 20% faster on the normal leg's program
_K14_TILE_BYTES = 48 * 1024
_K15_TILE_BYTES = 55 * 1024


def _tile_rows(program: Program, budget: int = _K14_TILE_BYTES) -> int:
    """A tile: the most rows (2048 down to 256) whose register file, the
    program's registers x rows x 9 B in shared memory, fits in ``budget``."""
    for t in (2048, 1024, 512):
        if max(program.n_regs, 1) * t * 9 <= budget:
            return t
    return 256


def _uniform_slots(instrs: np.ndarray) -> np.ndarray:
    """(n, 4) int16 over the program: column 0 is 1 where the instruction is
    uniform (a LIT, or computed from uniform operands only: the kernel runs
    it once a tile), columns 1-3 give for each register operand (a, b, c)
    the uniform instruction whose slot it reads, or -1 where it reads a
    per-row register. Registers are reused (``device_eval._allocate``), so
    an operand names its last writer."""
    out = np.full((len(instrs), 4), -1, np.int16)
    out[:, 0] = 0
    writer: Dict[int, int] = {}
    for pc, ins in enumerate(instrs.tolist()):
        op = device_eval.OPS[ins[0]]
        reads = device_eval._READS.get(op, (3, 4))
        srcs = [_slot(out, writer.get(ins[k], -1)) for k in reads]
        if op == "LIT" or (op not in ("COL", "FLAGALL", "INFIN") and reads
                           and all(w >= 0 for w in srcs)):
            out[pc, 0] = 1
        out[pc, 1:1 + len(srcs)] = srcs
        if ins[2] >= 0:
            writer[ins[2]] = pc
    return out


def _slot(kinds: np.ndarray, w: int) -> int:
    """The uniform slot of a register last written by instruction ``w``, or
    -1 where that is a per-row register."""
    return w if w >= 0 and kinds[w, 0] else -1


_TEMPLATES: Dict[Tuple[int, int], Tuple[Program, bytes, List[str], int]] = {}
_TEMPLATES_LOCK = threading.Lock()


def _cap(layout: np.dtype, field: str) -> int:
    """A field's capacity (its first dimension) in a K14 layout."""
    return layout.fields[field][0].shape[0]


def _k14_template(program: Program, layout: np.dtype,
                  budget: int = _K14_TILE_BYTES) -> Tuple[bytes, List[str], int]:
    """The program's part of a block of this layout (bytes), built once per
    program and tile budget; the per-file scalars' names in the block's
    order; the tile."""
    key = (id(program), layout.itemsize, budget)
    with _TEMPLATES_LOCK:
        hit = _TEMPLATES.get(key)
        if hit is not None and hit[0] is program:
            return hit[1:]
    n = len(program.instrs)
    blk = np.zeros(1, layout)
    blk["lits"][0, :len(program.lits)] = program.lits
    blk["lit_valid"][0, :len(program.lits)] = program.lit_valid
    blk["lit_scal"][0] = -1
    names = sorted(program.scalar_slots or {})
    for k, name in enumerate(names):
        blk["lit_scal"][0, program.scalar_slots[name]] = k
    blk["ins"][0, :n] = program.instrs
    usrc = _uniform_slots(program.instrs)
    blk["usrc"][0, :n] = usrc
    writer = max((pc for pc in range(n) if program.instrs[pc, 2] == program.root), default=-1)
    tile = _tile_rows(program, budget)
    blk["hdr"][0, [_H_INSTR, _H_COLS, _H_SCAL, _H_ROOT, _H_ROOT_DT, _H_ROOT_SLOT, _H_TILE,
                   _H_REGS]] = [n, len(program.columns), len(names), program.root,
                                program.root_dtype, _slot(usrc, writer), tile,
                                max(program.n_regs, 1)]
    out = (program, blk.tobytes(), names, tile)
    with _TEMPLATES_LOCK:
        if len(_TEMPLATES) >= 256:
            _TEMPLATES.clear()
        _TEMPLATES[key] = out
    return out[1:]


def _fits_tables(program: Program, layout: np.dtype) -> bool:
    """The program fits a block of this layout (instructions, literals, one
    file's lane pointers and scalars, int16 fields)."""
    return (0 < len(program.instrs) <= _cap(layout, "ins")
            and len(program.lits) <= _cap(layout, "lits")
            and 2 * len(program.columns) <= _cap(layout, "ptr")
            and len(program.scalar_slots or {}) <= _cap(layout, "fscal")
            and int(np.abs(program.instrs).max()) < 1 << 15)


def _fits_k14(program: Program, layout: np.dtype) -> bool:
    """The program fits a K14 block of this layout and has no IN reduction
    over rows."""
    return not program.n_flags and _fits_tables(program, layout)


def _groups(program: Program, n_files: int, layout: np.dtype) -> List[Tuple[int, int]]:
    n_cols, n_scal = len(program.columns), len(program.scalar_slots or {})
    files = _cap(layout, "rows")
    per = min(files, _cap(layout, "ptr") // (2 * n_cols) if n_cols else files,
              _cap(layout, "fscal") // n_scal if n_scal else files)
    return [(lo, min(lo + per, n_files)) for lo in range(0, n_files, per)]


def _k14_layout(program: Program, n_files: int) -> np.dtype:
    """The layout of a query's K14 blocks: the launch's parameters, unless
    the program does not fit them or its files take fewer launches staged
    (many per-file scalars: each string literal is one a file)."""
    if not _fits_k14(program, _K14_GLOBAL):
        raise ValueError("residual_masks: the program does not fit K14's tables")
    if not _fits_k14(program, _K14_PARAMS):
        return _K14_GLOBAL
    staged = len(_groups(program, n_files, _K14_GLOBAL))
    return _K14_PARAMS if len(_groups(program, n_files, _K14_PARAMS)) <= staged else _K14_GLOBAL


def _launch_groups(program: Program, n_files: int) -> List[Tuple[int, int]]:
    """The files of one launch each, as [lo, hi) ranges: as many as a block
    of the query's layout (:func:`_k14_layout`) holds in its file table,
    lane pointers and per-file scalars."""
    return _groups(program, n_files, _k14_layout(program, n_files))


def mask_offsets(ns: List[int]) -> Tuple[List[int], int]:
    """Each file's offset in the one mask of a batched launch (each file's
    rows rounded up to 16), and the mask's length."""
    offs, pos = [], 0
    for n in ns:
        offs.append(pos)
        pos += (int(n) + 15) // 16 * 16
    return offs, pos


def _check(program: Program, env: Dict[str, DeviceColumn], n: int) -> List[DeviceColumn]:
    if program.n_flags:
        raise ValueError("residual_mask: the program reduces an IN option over rows; "
                         "lower it with row_in=True")
    cols = [env[c] for c in program.columns]
    for c, dt in zip(cols, program.col_dtypes):
        if c.values.dim() != 1 or c.values.shape[0] < n or c.valid.shape != c.values.shape:
            raise ValueError(f"residual_mask: lanes must be 1-D, at least {n} rows long, "
                             "with valid masks of the same shape")
        if c.values.dtype != device_eval._TORCH[dt] or c.valid.dtype != torch.bool:
            raise TypeError(f"residual_mask: a {c.values.dtype} lane where the program reads "
                            f"{device_eval._TORCH[dt]}")
    return cols


def residual_masks(program: Program, envs: List[Dict[str, DeviceColumn]], ns: List[int],
                   scalars_per_file: List[Optional[Dict[str, Tuple[int, bool]]]]
                   ) -> Tuple[torch.Tensor, List[int]]:
    """The Kleene-TRUE masks of one residual program over several files'
    lanes (``envs[i]``, at least ``ns[i]`` rows; ``scalars_per_file[i]``
    fills the program's per-launch literal slots for file ``i``: name ->
    (int64 bits, valid)). Returns one bool mask and each file's offset in
    it (:func:`mask_offsets`): file ``i``'s rows are
    ``mask[offs[i]:offs[i] + ns[i]]``, and the bytes between files are
    False. K14 for lanes on a CUDA device, one launch per block
    (:func:`_launch_groups`); the plain version for lanes on the CPU."""
    if not (len(envs) == len(ns) == len(scalars_per_file)):
        raise ValueError("residual_masks: one env, row count and scalar map a file")
    first = envs[0][program.columns[0]].values if envs and program.columns else None
    if first is None or first.device.type == "cpu":
        return residual_masks_plain(program, envs, ns, scalars_per_file)
    dev = first.device
    layout = _k14_layout(program, len(ns))
    ptrs = _lane_ptrs(program, envs, ns, dev)
    offs, total = mask_offsets(ns)
    out = torch.empty(total, dtype=torch.bool, device=dev)
    for blk in _param_blocks(program, ptrs, ns, scalars_per_file, offs, layout):
        host, tables, _keep = _block_args(blk, layout, dev)
        native.call("residual_mask", dev, host, len(blk), tables, out.data_ptr())
        native.launches["residual_mask"] += 1
    return out, offs


def _block_args(blk: bytearray, layout: np.dtype, dev: torch.device):
    """A block's launch arguments (the host address of its bytes, the
    address of its copy on the card or None) and what must outlive the
    launch: the launch's parameters carry a ``_K14_PARAMS`` block; a staged
    one goes to pinned memory, then by one asynchronous copy on the
    launch's stream to the card (the caching host allocator keeps the
    pinned block until the copy has run)."""
    if layout is _K14_PARAMS:
        raw = (ctypes.c_char * len(blk)).from_buffer(blk)
        return ctypes.addressof(raw), None, raw
    host = torch.frombuffer(blk, dtype=torch.uint8).pin_memory()
    tables = torch.empty(len(blk), dtype=torch.uint8, device=dev)
    tables.copy_(host, non_blocking=True)
    return host.data_ptr(), tables.data_ptr(), (host, tables)


def _lane_ptrs(program: Program, envs: List[Dict[str, DeviceColumn]], ns: List[int],
               dev: torch.device) -> List[int]:
    """The lanes' pointers, file by file and column by column (values, then
    validity), once each lane is checked: 1-D, at least the file's rows,
    the program's dtype, on ``dev``, contiguous and 16-byte aligned (the
    kernel reads 16 bytes a load)."""
    want = [device_eval._TORCH[dt] for dt in program.col_dtypes]
    ptrs = []
    for env, n in zip(envs, ns):
        for c, dt in zip(program.columns, want):
            v, ok = env[c].values, env[c].valid
            shape = v.shape
            if len(shape) != 1 or shape[0] < n or ok.shape != shape:
                raise ValueError(f"residual_mask: lanes must be 1-D, at least {n} rows long, "
                                 "with valid masks of the same shape")
            if v.dtype != dt or ok.dtype != torch.bool:
                raise TypeError(f"residual_mask: a {v.dtype} lane where the program reads {dt}")
            if v.device != dev or ok.device != dev:
                raise ValueError("residual_mask: lanes on more than one device")
            pv, pk = v.data_ptr(), ok.data_ptr()
            if (pv | pk) % 16 or not (v.is_contiguous() and ok.is_contiguous()):
                raise ValueError("residual_mask: lanes must be contiguous and 16-byte aligned")
            ptrs += (pv, pk)
    return ptrs


def _put(buf: bytearray, layout: np.dtype, field: str, code: str, values) -> None:
    off = layout.fields[field][1]
    b = array.array(code, values).tobytes()
    buf[off:off + len(b)] = b


def _param_blocks(program: Program, ptrs: List[int], ns: List[int],
                  scalars_per_file: List[Optional[Dict[str, Tuple[int, bool]]]],
                  offs: List[int], layout: np.dtype,
                  budget: int = _K14_TILE_BYTES) -> List[bytearray]:
    """K14's blocks of this layout for these files, one a launch
    (:func:`_groups`; a block whose files have no rows is left out): the
    program's template, then each file's rows, mask offset, tile prefix,
    lane pointers (``ptrs``: two a column, file by file) and per-file
    scalars. ``budget``: the tile's register file (:func:`_tile_rows`)."""
    tmpl, names, tile = _k14_template(program, layout, budget)
    per_file = 2 * len(program.columns)
    hdr = layout.fields["hdr"][1]
    out = []
    for lo, hi in _groups(program, len(ns), layout):
        tiles = list(itertools.accumulate((int(n) + tile - 1) // tile for n in ns[lo:hi]))
        if not tiles[-1]:
            continue
        buf = bytearray(tmpl)
        _put(buf, layout, "tile_end", "i", tiles)
        _put(buf, layout, "rows", "q", ns[lo:hi])
        _put(buf, layout, "out_off", "q", offs[lo:hi])
        _put(buf, layout, "ptr", "Q", ptrs[lo * per_file:hi * per_file])
        if names:
            scal = [(scalars_per_file[i] or {})[name] for i in range(lo, hi) for name in names]
            _put(buf, layout, "fscal", "q", [b for b, _ in scal])
            _put(buf, layout, "fscal_valid", "B", [int(v) for _, v in scal])
        struct.pack_into("<i", buf, hdr + 4 * _H_FILES, hi - lo)
        struct.pack_into("<i", buf, hdr + 4 * _H_TILES, tiles[-1])
        out.append(buf)
    return out


def residual_masks_plain(program: Program, envs: List[Dict[str, DeviceColumn]],
                         ns: List[int],
                         scalars_per_file: List[Optional[Dict[str, Tuple[int, bool]]]]
                         ) -> Tuple[torch.Tensor, List[int]]:
    """Plain PyTorch version of K14's batched launch: :func:`residual_mask_plain`
    over each file of each block (:func:`_launch_groups`), into one mask at
    the files' offsets."""
    offs, total = mask_offsets(ns)
    dev = envs[0][program.columns[0]].values.device if envs and program.columns else "cpu"
    out = torch.zeros(total, dtype=torch.bool, device=dev)
    for lo, hi in _launch_groups(program, len(envs)):
        for i in range(lo, hi):
            out[offs[i]:offs[i] + ns[i]] = residual_mask_plain(program, envs[i], ns[i],
                                                               scalars_per_file[i])
    return out, offs


def residual_mask(program: Program, env: Dict[str, DeviceColumn], n: int,
                  scalars: Optional[Dict[str, Tuple[int, bool]]] = None) -> torch.Tensor:
    """The Kleene-TRUE mask (bool, ``n`` rows) of a residual program over
    one file's lanes, at least ``n`` rows long: :func:`residual_masks` with
    one file. ``scalars`` fills the program's per-launch literal slots
    (name -> (int64 bits, valid))."""
    mask, _ = residual_masks(program, [env], [n], [scalars])
    return mask[:n]


def residual_mask_plain(program: Program, env: Dict[str, DeviceColumn], n: int,
                        scalars: Optional[Dict[str, Tuple[int, bool]]] = None) -> torch.Tensor:
    """Plain PyTorch version of K14 for one file: ``expr_eval_plain`` over
    the first ``n`` rows of the lanes, then ``values != 0 & valid``."""
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


def _partition_scalar(value: Any, want: int) -> Tuple[int, bool]:
    """A file's typed partition value as the (int64 bits, valid) of a
    scalar of program dtype ``want``, the column's declared lane dtype."""
    if value is None:
        return 0, False
    dt, bits, ok = _scalar_column(value)
    if dt != want:
        raise NotDeviceCompilable(f"partition value {value!r} does not fit its lane dtype")
    return bits, ok


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


#: the stored bytes of the files whose missing predicate columns decode in
#: one batch (one page-codec launch set a batch, not a file)
_LANE_BATCH_BYTES = 64 << 20


def _ensure_lanes(cache: ColumnCache, log_path: str, data_path: str, files, need: List[str],
                  epoch: int, counters: Dict[str, int],
                  device) -> Optional[List[Dict[str, ResidentColumn]]]:
    """Resident lanes for each file's predicate columns, one dict a file,
    decoding the misses (the predicate's columns only; the projection
    decodes later, for survivors) of consecutive files together, up to
    ``_LANE_BATCH_BYTES`` stored bytes a batch. None when a column has no
    lane form. A column a file predates binds an all-invalid (NULL) lane."""
    from delta_tpu_torch.exec.parquet import column_names, read_parquet_batch
    from delta_tpu_torch.exec.rowgroups import read_footer

    outs: List[Dict[str, ResidentColumn]] = []
    batch: list = []

    def flush() -> bool:
        reads = [(abs_path, stored, None, meta) for _, _, _, abs_path, meta, _, stored in batch
                 if stored]
        tabs = iter(read_parquet_batch(reads, device)) if reads else iter(())
        for i, add, missing, _abs, meta, present, stored in batch:
            tbl = next(tabs) if stored else None
            if stored:
                counters["coldBytes"] += sum(int(rg.total_byte_size)
                                             for rg in meta.row_groups or [])
            for c in missing:
                if c in present:
                    lane = _lane_from_column(tbl.columns[present[c]])
                    if lane is None:
                        return False
                    vals, valid, codes = lane
                else:
                    # schema evolution: the file predates the column
                    vals = np.zeros(int(meta.num_rows), np.float64)
                    valid = np.zeros(int(meta.num_rows), bool)
                    codes = None
                entry = ResidentColumn(log_path, add.path, c, vals, valid, codes, epoch, device)
                cache.register(entry)  # an epoch race: served uncached, still exact
                outs[i][c] = entry
        batch.clear()
        return True

    size = 0
    for add in files:
        out: Dict[str, ResidentColumn] = {}
        outs.append(out)
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
            continue
        abs_path = _abs_data_path(data_path, add.path)
        meta = read_footer(abs_path)
        present = {name.lower(): name for name in column_names(meta)}
        stored = [present[c] for c in missing if c in present]
        batch.append((len(outs) - 1, add, missing, abs_path, meta, present, stored))
        size += sum(int(rg.total_compressed_size or 0) for rg in meta.row_groups or [])
        if size >= _LANE_BATCH_BYTES:
            if not flush():
                return None
            size = 0
    if batch and not flush():
        return None
    return outs


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
    need = sorted(plan.refs)
    # a partition column binds as a per-file scalar of its declared lane
    # dtype, a NULL value as that dtype with valid=False: one program serves
    # files with and without a value (JAX's jit traces a NULL as float32)
    lane_dt = device_eval.lane_dtypes(schema_types(metadata))
    part_types = {c: device_eval._FROM_TORCH[lane_dt.get(c, torch.float64)]
                  for c in plan.part_refs}
    scalar_types = tuple(sorted([(ph, device_eval.I64) for ph, _c, _v in plan.str_binds]
                                + list(part_types.items())))
    part_schema = metadata.partition_schema
    t0 = time.perf_counter()
    # each file's lanes (decoding the misses), then one launch per program:
    # files whose lanes share dtypes share it (a file that predates a column
    # binds a float64 NULL lane, and so another program)
    groups: Dict[Tuple, List[Tuple[int, Dict[str, DeviceColumn], int, Dict]]] = {}
    all_lanes = _ensure_lanes(cache, log.log_path, log.data_path, files, need,
                              cache.epoch(log.log_path), counters, log.device)
    if all_lanes is None:
        telemetry.bump_counter("scan.device.fallback")
        return None
    for i, (add, lanes) in enumerate(zip(files, all_lanes)):
        n = max((e.n for e in lanes.values()), default=0)
        env = {c: DeviceColumn(e.values, e.valid) for c, e in lanes.items()}
        dtypes = tuple(sorted((c, e.values.dtype) for c, e in lanes.items()))
        scalars = {}
        for ph, col, value in plan.str_binds:
            code = (lanes[col].dict_codes or {}).get(value, device_eval.STR_CODE_ABSENT)
            _dt_, bits, ok = _scalar_column(int(code))
            scalars[ph] = (bits, ok)
        if part_types:
            typed = {k.lower(): v for k, v in typed_partition_row(add, part_schema).items()}
            try:
                for c, want in part_types.items():
                    scalars[c] = _partition_scalar(typed.get(c), want)
            except NotDeviceCompilable:
                telemetry.bump_counter("scan.device.fallback")
                return None
        groups.setdefault(dtypes, []).append((i, env, n, scalars))
    pending = []
    for dtypes, members in groups.items():
        try:
            program = _mask_program(plan.expr, dtypes, scalar_types)
        except NotDeviceCompilable:
            telemetry.bump_counter("scan.device.fallback")
            return None
        buf, offs = residual_masks(program, [m[1] for m in members], [m[2] for m in members],
                                   [m[3] for m in members])
        pending.append((members, buf, offs))
    # the masks come down in one copy a program, into pinned memory, with one
    # synchronisation; each file's mask is a view of it
    total = sum(buf.numel() for _, buf, _ in pending)
    on_card = any(buf.is_cuda for _, buf, _ in pending)
    host = torch.empty(total, dtype=torch.bool, pin_memory=on_card)
    pos, spans = 0, {}
    for members, buf, offs in pending:
        host[pos:pos + buf.numel()].copy_(buf, non_blocking=True)
        for (i, _env, n, _s), off in zip(members, offs):
            spans[i] = (pos + off, n)
        pos += buf.numel()
    for _, buf, _ in pending:
        if buf.is_cuda:
            torch.cuda.current_stream(buf.device).synchronize()
    arr = host.numpy()
    masks: Dict[str, np.ndarray] = {}
    for i, add in enumerate(files):
        off, n = spans[i]
        masks[add.path] = arr[off:off + n]
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

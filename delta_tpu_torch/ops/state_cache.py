"""Device-resident snapshot state: a table's scan-planning lanes on the card.

The port's own copy of ``delta_tpu.ops.state_cache``. The per-file min/max
stats lanes (float32, rounded outward), the alive lane and exact float64
host mirrors stay resident per table; a commit tail updates them in place
with two scatter kernels; a batch of range queries is one block-cull kernel
launch and one packed-bitmap download, finished exactly on the host mirrors
(coarse-fine, ``ResidentState._plan_device``).

Precision (as in the JAX package): min lanes round toward -inf, max lanes
toward +inf, and query bounds round outward the same way (`_f32_down` /
`_f32_up`), so a float32 verdict can only keep extra files, never drop a
matching one; the float64 fine pass then makes every plan exact. NaN =
missing stat = keep.

Kernels (hand-written CUDA in ``delta_tpu_torch/csrc``, bound in
``ops/native``), each beside its plain PyTorch version:

* :func:`block_cull` — replaces ``_block_kernel_fn`` (``state_cache.py:986``):
  one read of the lanes per launch, each file's bounds held against every
  query by two binary searches in per-column rank tables of the batch;
* :func:`sharded_block_cull` — replaces ``_sharded_block_kernel_fn``
  (``:1014``): with the lanes split along the file axis over the state mesh
  (``parallel/mesh``), one launch a distinct device writes a byte per
  1024-file block of each of its slices, straight into the gathered
  ``(M, blocks)`` map where every slice is on the lead device (else the
  devices' maps gather along the file axis on the lead);
* :func:`scatter_bool` / :func:`scatter_cols` — replace ``_scatter_bool_fn``
  / ``_scatter_cols_fn`` (``:959``, ``:970``).

A wrapper runs the plain version only for tensors on the CPU; for a CUDA
tensor it launches the kernel or raises. ``plan_ranges`` routes a batch by
``delta.tpu.stateCache.devicePlan.*``: under ``auto`` (the default) the
link cost model (``parallel/link``) prices the block cull against the host
plan over the float64 mirrors and ``obs/router_audit`` records the
``scan.plan`` decision; ``force`` and ``off`` pin one side. A device plan
runs sharded (``via="device-sharded"``, the ``dist.plan.sharded`` counter)
when ``delta.tpu.distributed.plan.*`` and the mesh allow it: ``force`` takes
the whole feasible mesh, ``auto`` takes it when
``link.sharded_plan_device_s`` prices it below one card. There is no
fallback to the host plan when a kernel fails: where the JAX package
catches a failed cull and plans on the host, the port raises.
"""
from __future__ import annotations

import bisect
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from delta_tpu_torch.expr import ir
from delta_tpu_torch.ops import native
from delta_tpu_torch.ops.state_export import (
    _NUMERIC, _stat_to_lane, arrays_from_columns, string_prefix_lane_value,
)
from delta_tpu_torch.schema.types import StringType, parse_data_type

__all__ = [
    "ResidentState", "DeviceStateCache", "PlanResult", "RangeSet", "PartLane",
    "extract_ranges", "extract_range_union", "build_entry",
    "resident_from_numpy", "block_cull", "block_cull_plain", "sharded_block_cull",
    "sharded_block_cull_plain", "scatter_bool",
    "scatter_bool_plain", "scatter_cols", "scatter_cols_plain", "tail_apply",
    "tail_apply_plain", "BLOCK",
]

# block-cull granularity: a power of two <= the capacity floor of _next_pow2,
# so the padded capacity always divides evenly
BLOCK = 1024

# DeviceStateCache budgets: device lanes beyond MAX_DEVICE_BYTES drop LRU
# (the host mirrors keep serving); tables beyond MAX_ENTRIES drop LRU whole
MAX_DEVICE_BYTES = 2 << 30
MAX_ENTRIES = 16


def _f32_down(x: np.ndarray) -> np.ndarray:
    """float64 -> float32 rounded toward -inf (result <= x). NaN passes."""
    with np.errstate(invalid="ignore", over="ignore"):
        f = x.astype(np.float32)
        bump = f.astype(np.float64) > x
    if bump.any():
        f = f.copy()
        f[bump] = np.nextafter(f[bump], np.float32(-np.inf))
    return f


def _f32_up(x: np.ndarray) -> np.ndarray:
    """float64 -> float32 rounded toward +inf (result >= x). NaN passes."""
    with np.errstate(invalid="ignore", over="ignore"):
        f = x.astype(np.float32)
        bump = f.astype(np.float64) < x
    if bump.any():
        f = f.copy()
        f[bump] = np.nextafter(f[bump], np.float32(np.inf))
    return f


def _next_pow2(n: int, floor: int = 1024) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


# -- the kernels and their plain versions -----------------------------------


def plan_bounds(lo: np.ndarray, hi: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The block cull's float32 ``(M, C)`` bounds for a batch of float64
    ranges, rounded outward. The query axis is the batch's own: the JAX
    package pads it to a power of two >= 8 with NaN rows to bound its
    recompiles, which a CUDA launch does not have, and a NaN row keeps every
    live file, so it would cost the kernel its early exit."""
    return (np.ascontiguousarray(_f32_down(lo), dtype=np.float32),
            np.ascontiguousarray(_f32_up(hi), dtype=np.float32))


def _packbits(bits: torch.Tensor) -> torch.Tensor:
    """``np.packbits(bits, axis=-1)``: big-endian bytes, zero-padded."""
    n = bits.shape[-1]
    pad = (-n) % 8
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    b = bits.reshape(*bits.shape[:-1], -1, 8).to(torch.uint8)
    w = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8, device=bits.device)
    return (b * w).sum(dim=-1, dtype=torch.uint8)


def _check_lanes(name, mins, maxs, alive, lo, hi, bounds_on_device=True):
    c, cap = mins.shape
    m = lo.shape[0]
    if (maxs.shape != (c, cap) or alive.shape != (cap,) or lo.shape != (m, c)
            or hi.shape != (m, c) or cap % BLOCK):
        raise ValueError(f"{name}: bad shapes mins {tuple(mins.shape)} maxs "
                         f"{tuple(maxs.shape)} alive {tuple(alive.shape)} lo "
                         f"{tuple(lo.shape)} hi {tuple(hi.shape)}")
    if any(t.dtype != torch.float32 for t in (mins, maxs, lo, hi)) or alive.dtype != torch.bool:
        raise TypeError(f"{name}: lanes and bounds must be float32, alive bool")
    if any(t.device != mins.device for t in ((maxs, alive, lo, hi) if bounds_on_device
                                             else (maxs, alive))):
        raise ValueError(f"{name}: all tensors must be on one device")


def _block_any(mins, maxs, alive, lo, hi, block: int = BLOCK) -> torch.Tensor:
    """The JAX kernels' keep test on whole (M, cap) masks, any-reduced over
    each block: (M, cap / block) bool."""
    m, cap = lo.shape[0], alive.shape[0]
    keep = alive[None, :].expand(m, cap).clone()
    for c in range(lo.shape[1]):
        mn, mx = mins[c][None, :], maxs[c][None, :]
        lo_c, hi_c = lo[:, c:c + 1], hi[:, c:c + 1]
        keep &= torch.isnan(mx) | torch.isnan(lo_c) | (mx >= lo_c)
        keep &= torch.isnan(mn) | torch.isnan(hi_c) | (mn <= hi_c)
    return keep.reshape(m, cap // block, block).any(dim=2)


def block_cull_plain(mins, maxs, alive, lo, hi, block: int = BLOCK) -> torch.Tensor:
    """Plain PyTorch version of the block cull: the JAX kernel's arithmetic
    (``state_cache.py:993-1004``) on whole (M, cap) masks."""
    return _packbits(_block_any(mins, maxs, alive, lo, hi, block))


#: bytes of one K1/K7 rank table (a 64-query tile and column,
#: ``csrc/block_cull.cu``'s ``Table``)
_TABLE_BYTES = 2064
#: slices one K7 launch takes (``csrc/block_cull.cu``'s ``kMaxShards``)
_MAX_SLICES = 64


def _rank_table_bytes(m: int, c: int) -> int:
    return (m + 63) // 64 * max(c, 1) * _TABLE_BYTES


def _check_aligned(name, mins, maxs, alive) -> None:
    """The kernel reads a lane's 4 files as one 16-byte load and their alive
    bytes as one word."""
    if mins.data_ptr() % 16 or maxs.data_ptr() % 16 or alive.data_ptr() % 4:
        raise ValueError(f"{name}: mins/maxs must start on 16 bytes and alive on 4")


def block_cull(mins: torch.Tensor, maxs: torch.Tensor, alive: torch.Tensor,
               lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Per query, which 1024-file blocks hold a file that can match, packed
    big-endian: ``(M, ceil(cap / 1024 / 8))`` uint8. mins/maxs ``(C, cap)``
    float32, alive ``(cap,)`` bool, lo/hi ``(M, C)`` float32 (NaN = no
    bound); cap a multiple of 1024."""
    _check_lanes("block_cull", mins, maxs, alive, lo, hi)
    c, cap = mins.shape
    m = lo.shape[0]
    ts = (mins, maxs, alive, lo, hi)
    if mins.device.type == "cpu":
        return block_cull_plain(mins, maxs, alive, lo, hi)
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("block_cull: tensors must be contiguous")
    _check_aligned("block_cull", mins, maxs, alive)
    out_w = (cap // BLOCK + 7) // 8
    # the kernel ORs block bits into whole 32-bit words of the output
    buf = torch.empty((m * out_w + 3) // 4 * 4, dtype=torch.uint8, device=mins.device)
    out = buf[:m * out_w].view(m, out_w)
    if m == 0:
        return out
    tables = torch.empty(_rank_table_bytes(m, c), dtype=torch.uint8, device=mins.device)
    native.call("block_cull", mins.device, mins.data_ptr(), maxs.data_ptr(),
                alive.data_ptr(), lo.data_ptr(), hi.data_ptr(), out.data_ptr(),
                c, cap, m, out_w, tables.data_ptr())
    native.launches["block_cull"] += 1
    return out


def sharded_block_cull_plain(shards, lo, hi) -> torch.Tensor:
    """Plain PyTorch version of K7 (``state_cache.py:1020-1038``): each
    shard's blocks as unpacked uint8, concatenated along the file axis on
    the first shard's device. ``shards``: one (mins, maxs, alive) slice a
    shard."""
    lead = shards[0][0].device
    return torch.cat([_block_any(mn, mx, al, lo.to(mn.device), hi.to(mn.device))
                      .to(torch.uint8).to(lead) for mn, mx, al in shards], dim=1)


def sharded_block_cull(shards, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """K7: per query, which 1024-file blocks hold a file that can match, one
    uint8 (0/1) a block, ``(M, sum of the slices' blocks)``, on the lead
    device (the first shard's). ``shards``: one (mins ``(C, cap_s)``
    float32, maxs, alive ``(cap_s,)`` bool) slice a shard, each on its own
    device, ``cap_s`` a multiple of 1024 (whole blocks); lo/hi ``(M, C)``
    float32, replicated to each device. One launch a distinct device (at
    most 64 slices a device) over all its slices, each writing its blocks
    at its columns of one map: the result itself where every slice is on
    the lead device, else a map a device gathered along the file axis. On
    the CPU the plain arithmetic fills the same layout; on the card the
    kernel, or an error."""
    from delta_tpu_torch.parallel import mesh as mesh_mod

    for mn, mx, al in shards:
        _check_lanes("sharded_block_cull", mn, mx, al, lo, hi, bounds_on_device=False)
    lead = shards[0][0].device
    kinds = {sh[0].device.type for sh in shards}
    if kinds not in ({"cpu"}, {"cuda"}):
        raise ValueError("sharded_block_cull: the slices must all be on the card, or all "
                         "on the CPU")
    c, m = lo.shape[1], lo.shape[0]
    groups: Dict[torch.device, List[int]] = {}
    for i, sh in enumerate(shards):
        groups.setdefault(sh[0].device, []).append(i)
    if any(len(idx) > _MAX_SLICES for idx in groups.values()):
        raise ValueError(f"sharded_block_cull: at most {_MAX_SLICES} slices a device")
    width = [sh[2].shape[0] // BLOCK for sh in shards]
    direct = list(groups) == [lead]
    col = np.cumsum([0] + width[:-1]) if direct else None
    out = torch.empty((m, sum(width)), dtype=torch.uint8, device=lead) if direct else None
    devices = list(groups)
    los = mesh_mod.replicate(lo.contiguous(), devices)
    his = mesh_mod.replicate(hi.contiguous(), devices)

    def launch(k, dev):
        idx = groups[dev]
        cols = (np.array([col[i] for i in idx], np.int64) if direct else
                np.cumsum([0] + [width[i] for i in idx[:-1]]).astype(np.int64))
        buf = out if direct else torch.empty((m, sum(width[i] for i in idx)),
                                             dtype=torch.uint8, device=dev)
        if dev.type == "cpu":
            for i, cl in zip(idx, cols):
                mn, mx, al = shards[i]
                buf[:, cl:cl + width[i]] = _block_any(mn, mx, al, los[dev], his[dev])
            return buf, cols
        for i in idx:
            if not all(t.is_contiguous() for t in shards[i]):
                raise ValueError("sharded_block_cull: tensors must be contiguous")
            _check_aligned("sharded_block_cull", *shards[i])
        if m:
            ptrs = np.array([[t.data_ptr() for t in shards[i]] for i in idx], np.uint64)
            caps = np.array([shards[i][2].shape[0] for i in idx], np.int64)
            tables = torch.empty(_rank_table_bytes(m, c), dtype=torch.uint8, device=dev)
            native.call("sharded_block_cull", dev, ptrs.ctypes.data, caps.ctypes.data,
                        cols.ctypes.data, len(idx), los[dev].data_ptr(), his[dev].data_ptr(),
                        buf.data_ptr(), c, m, buf.shape[1], tables.data_ptr())
            native.launches["sharded_block_cull"] += 1
        return buf, cols

    parts = mesh_mod.run_shards(devices, launch)
    if direct:
        return out
    view = {}
    for (buf, cols), idx in zip(parts, groups.values()):
        for i, cl in zip(idx, cols):
            view[i] = buf[:, cl:cl + width[i]]
    return mesh_mod.all_gather([view[i] for i in range(len(shards))], lead, axis=1)


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """``a`` on ``device``: on a card through pinned memory, without waiting
    (the host allocator keeps the pinned block until the copy is done)."""
    if device.type != "cuda":
        return torch.from_numpy(a).to(device)
    host = torch.empty(a.shape, dtype=torch.from_numpy(a[:0]).dtype, pin_memory=True)
    host.numpy()[...] = a
    return host.to(device, non_blocking=True)


def _xla_rows(rows: torch.Tensor, cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """XLA scatter index semantics: negative counts from the end, then
    anything outside [0, cap) is dropped. (kept mask, normalized rows)"""
    r = rows.to(torch.int64)
    r = torch.where(r < 0, r + cap, r)
    keep = (r >= 0) & (r < cap)
    return keep, r


def scatter_bool_plain(a: torch.Tensor, rows: torch.Tensor, value: bool) -> torch.Tensor:
    keep, r = _xla_rows(rows, a.shape[0])
    a[r[keep]] = value
    return a


def scatter_cols_plain(a: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    keep, r = _xla_rows(rows, a.shape[1])
    a[:, r[keep]] = vals[:, keep]
    return a


def scatter_bool(a: torch.Tensor, rows: torch.Tensor, value: bool) -> torch.Tensor:
    """``a[rows] = value`` IN PLACE with XLA drop semantics (an index outside
    [0, cap) after negative wrap-around is not written); returns ``a``.
    a ``(cap,)`` bool, rows ``(d,)`` int32."""
    if a.dtype != torch.bool or rows.dtype != torch.int32 or a.dim() != 1 or rows.dim() != 1:
        raise TypeError("scatter_bool: a must be 1-D bool, rows 1-D int32")
    if rows.device != a.device:
        raise ValueError("scatter_bool: a and rows must be on one device")
    if a.device.type == "cpu":
        return scatter_bool_plain(a, rows, value)
    if not (a.is_contiguous() and rows.is_contiguous()):
        raise ValueError("scatter_bool: tensors must be contiguous")
    native.call("scatter_bool", a.device, a.data_ptr(), rows.data_ptr(), rows.shape[0],
                1 if value else 0, a.shape[0])
    native.launches["scatter_bool"] += 1
    return a


def scatter_cols(a: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``a[:, rows] = vals`` IN PLACE with XLA drop semantics; returns ``a``.
    a ``(C, cap)`` float32, rows ``(n,)`` int32, vals ``(C, n)`` float32."""
    if (a.dtype != torch.float32 or vals.dtype != torch.float32
            or rows.dtype != torch.int32):
        raise TypeError("scatter_cols: a/vals must be float32, rows int32")
    if a.dim() != 2 or rows.dim() != 1 or vals.shape != (a.shape[0], rows.shape[0]):
        raise ValueError(f"scatter_cols: bad shapes a {tuple(a.shape)} rows "
                         f"{tuple(rows.shape)} vals {tuple(vals.shape)}")
    if rows.device != a.device or vals.device != a.device:
        raise ValueError("scatter_cols: all tensors must be on one device")
    if a.device.type == "cpu":
        return scatter_cols_plain(a, rows, vals)
    if not (a.is_contiguous() and rows.is_contiguous() and vals.is_contiguous()):
        raise ValueError("scatter_cols: tensors must be contiguous")
    native.call("scatter_cols", a.device, a.data_ptr(), rows.data_ptr(), vals.data_ptr(),
                a.shape[0], rows.shape[0], a.shape[1])
    native.launches["scatter_cols"] += 1
    return a


def tail_apply_plain(alive: torch.Tensor, mins: torch.Tensor, maxs: torch.Tensor,
                     dead: torch.Tensor, start: int, k: int, lo: torch.Tensor,
                     hi: torch.Tensor) -> None:
    """Plain PyTorch version of the tail apply: the four plain calls in the
    JAX package's order (``_apply_tail_device``), the added rows the range
    ``[start, start + k)``."""
    rows = torch.arange(start, start + k, dtype=torch.int64, device=alive.device)
    scatter_bool_plain(alive, dead, False)
    scatter_bool_plain(alive, rows, True)
    scatter_cols_plain(mins, rows, lo)
    scatter_cols_plain(maxs, rows, hi)


def tail_apply(alive: torch.Tensor, mins: torch.Tensor, maxs: torch.Tensor,
               dead: torch.Tensor, start: int, k: int, lo: torch.Tensor,
               hi: torch.Tensor) -> None:
    """One commit tail IN PLACE, in one launch of K3 with K2 on it: ``dead``
    (d,) int32 rows False in ``alive`` (cap,) bool, then the rows ``[start,
    start + k)`` True and ``lo``, ``hi`` (C, k) float32 into ``mins``,
    ``maxs`` (C, cap), each index with XLA drop semantics; a dead row inside
    the added range ends True. ``dead``, ``lo`` and ``hi`` may be views of
    one uploaded buffer."""
    if (alive.dtype != torch.bool or dead.dtype != torch.int32
            or any(t.dtype != torch.float32 for t in (mins, maxs, lo, hi))):
        raise TypeError("tail_apply: alive bool, dead int32, lanes and values float32")
    c, cap = mins.shape if mins.dim() == 2 else (-1, -1)
    if (alive.shape != (cap,) or maxs.shape != (c, cap) or dead.dim() != 1 or k < 0
            or lo.shape != (c, k) or hi.shape != (c, k)):
        raise ValueError(f"tail_apply: bad shapes alive {tuple(alive.shape)} mins "
                         f"{tuple(mins.shape)} maxs {tuple(maxs.shape)} dead "
                         f"{tuple(dead.shape)} lo {tuple(lo.shape)} hi {tuple(hi.shape)} k={k}")
    if any(t.device != alive.device for t in (mins, maxs, dead, lo, hi)):
        raise ValueError("tail_apply: all tensors must be on one device")
    if alive.device.type == "cpu":
        return tail_apply_plain(alive, mins, maxs, dead, start, k, lo, hi)
    if not all(t.is_contiguous() for t in (alive, mins, maxs, dead, lo, hi)):
        raise ValueError("tail_apply: tensors must be contiguous")
    native.call("tail_apply", alive.device, alive.data_ptr(), mins.data_ptr(), maxs.data_ptr(),
                c, cap, dead.data_ptr(), dead.shape[0], start, k, lo.data_ptr(), hi.data_ptr())
    native.launches["tail_apply"] += 1


# -- range extraction from skipping predicates ------------------------------


@dataclass
class RangeSet:
    """One query as per-column bounds: keep file iff for every column c,
    ``max.c >= lo[c] AND min.c <= hi[c]`` (NaN bound = unconstrained).
    ``verdict`` short-circuits structural cases: 'empty' (matches nothing),
    'all' (prunes nothing)."""

    lo: np.ndarray  # float64, len C, NaN = -inf
    hi: np.ndarray  # float64, len C, NaN = +inf
    verdict: Optional[str] = None  # None | 'empty' | 'all'
    # True when the lowering lost nothing: no strict comparison was relaxed
    # to non-strict, so the range verdict EQUALS the exact evaluator's
    exact: bool = True


def _part_lane_rows(codes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Partition lane rows from int32 codes: min=max=code; null (-1) becomes
    the inverted range (+inf, -inf) so every bounded query prunes it exactly
    (NaN would mean 'missing stat: keep' — the wrong semantics for a KNOWN
    null partition value)."""
    f = codes.astype(np.float64)
    lo = np.where(codes >= 0, f, np.inf)
    hi = np.where(codes >= 0, f, -np.inf)
    return lo, hi


@dataclass
class PartLane:
    """One partition column's dictionary lane: codes are ranks in VALUE
    order at build time (typed order for numeric/temporal columns, code-
    point order for strings), so value ranges lower to code ranges. A tail
    extension that arrives out of order appends its code at the end and
    clears ``sorted`` — equality lowering survives, range lowering stops
    until the entry rebuilds."""

    values: List[str]  # code -> raw partition string
    parsed: Optional[np.ndarray]  # typed sort keys (float64) or None (lex)
    code_of: Dict[str, int]
    sorted: bool = True
    dt: object = None  # DataType used to parse (set iff parsed is not None)

    def eq_code(self, lit) -> Optional[int]:
        """Code whose value equals the literal; -1 = no file has it; None =
        the literal isn't comparable against this lane."""
        if self.parsed is not None:
            if isinstance(lit, bool) or not isinstance(lit, (int, float)):
                return None
            v = float(lit)
            if self.sorted:
                i = int(np.searchsorted(self.parsed, v))
                return i if i < len(self.parsed) and self.parsed[i] == v else -1
            hits = np.nonzero(self.parsed == v)[0]
            return int(hits[0]) if len(hits) else -1
        if not isinstance(lit, str):
            return None
        c = self.code_of.get(lit)
        return c if c is not None else -1

    def bound_code(self, lit, op) -> Optional[Tuple[float, float]]:
        """(lo, hi) code bounds (NaN = unbounded) for `col <op> lit`, or
        None when not lowerable (unsorted lane / type mismatch)."""
        if not self.sorted:
            return None
        if self.parsed is not None:
            if isinstance(lit, bool) or not isinstance(lit, (int, float)):
                return None
            v = float(lit)
            left = int(np.searchsorted(self.parsed, v, side="left"))
            right = int(np.searchsorted(self.parsed, v, side="right"))
        else:
            if not isinstance(lit, str):
                return None
            left = bisect.bisect_left(self.values, lit)
            right = bisect.bisect_right(self.values, lit)
        if op == "lt":
            return (np.nan, left - 1 + 0.0)  # codes < first value >= lit
        if op == "le":
            return (np.nan, right - 1 + 0.0)
        if op == "gt":
            return (right + 0.0, np.nan)
        if op == "ge":
            return (left + 0.0, np.nan)
        return None


def _intersect_ranges(a: RangeSet, b: RangeSet) -> RangeSet:
    """Conjunction of two boxes: per-column max of lows / min of highs
    (NaN = unbounded, so fmax/fmin ignore it)."""
    exact = a.exact and b.exact
    if a.verdict == "empty" or b.verdict == "empty":
        return RangeSet(a.lo, a.hi, verdict="empty", exact=exact)
    if a.verdict == "all":
        return RangeSet(b.lo, b.hi, verdict=b.verdict, exact=exact)
    if b.verdict == "all":
        return RangeSet(a.lo, a.hi, verdict=a.verdict, exact=exact)
    return RangeSet(np.fmax(a.lo, b.lo), np.fmin(a.hi, b.hi), exact=exact)


def extract_range_union(
    pred: ir.Expression,
    columns: Sequence[str],
    part_info: Optional[Dict[str, PartLane]] = None,
    max_terms: int = 8,
    str_lanes: Optional[frozenset] = None,
) -> Optional[List[RangeSet]]:
    """Lower a rewritten skipping predicate to a UNION of per-column range
    boxes (limited DNF): OR branches union, AND distributes (capped at
    ``max_terms``), and partition IN-lists lower to runs of consecutive
    dictionary codes. Every term exact => the union equals the exact
    evaluator's keep-set. None when any branch doesn't lower."""
    t = type(pred)
    one = extract_ranges(pred, columns, part_info, str_lanes)
    if one is not None:
        return [one]
    if t is ir.Or or t is ir.And:
        left = extract_range_union(pred.left, columns, part_info, max_terms, str_lanes)
        if left is None:
            return None
        right = extract_range_union(pred.right, columns, part_info, max_terms, str_lanes)
        if t is ir.Or:
            if right is None or len(left) + len(right) > max_terms:
                return None
            return left + right
        if right is None or len(left) * len(right) > max_terms:
            return None
        return [_intersect_ranges(a, b) for a in left for b in right]
    if t is ir.In and part_info and isinstance(pred.value, ir.Column):
        pmap = {c.lower(): c for c in part_info}
        key = pmap.get(pred.value.name.lower())
        if key is None:
            return None
        part = part_info[key]
        i = list(columns).index(key)
        codes = []
        for o in pred.options:
            if not isinstance(o, ir.Literal) or o.value is None:
                return None
            c = part.eq_code(o.value)
            if c is None:
                return None
            if c >= 0:
                codes.append(c)
        if not codes:
            return [RangeSet(np.full(len(columns), np.nan),
                             np.full(len(columns), np.nan), verdict="empty")]
        runs: List[Tuple[int, int]] = []
        for c in sorted(set(codes)):
            if runs and c == runs[-1][1] + 1:
                runs[-1] = (runs[-1][0], c)
            else:
                runs.append((c, c))
        if len(runs) > max_terms:
            return None
        out = []
        for lo_c, hi_c in runs:
            lo = np.full(len(columns), np.nan)
            hi = np.full(len(columns), np.nan)
            lo[i], hi[i] = float(lo_c), float(hi_c)
            out.append(RangeSet(lo, hi))
        return out
    return None


_FLIP = {ir.Lt: ir.Gt, ir.Le: ir.Ge, ir.Gt: ir.Lt, ir.Ge: ir.Le, ir.Eq: ir.Eq}


def extract_ranges(
    pred: ir.Expression,
    columns: Sequence[str],
    part_info: Optional[Dict[str, PartLane]] = None,
    str_lanes: Optional[frozenset] = None,
) -> Optional[RangeSet]:
    """Lower a *rewritten* skipping predicate (``min.c``/``max.c`` lanes for
    stats columns; raw column references for partition columns) to
    per-column range bounds, or None when the shape doesn't fit. Strict stat
    comparisons are relaxed to non-strict and mark the result inexact;
    partition lowerings stay exact (dictionary codes are discrete)."""
    col_ix = {c: i for i, c in enumerate(columns)}
    pmap = {c.lower(): c for c in (part_info or {})}
    lo = np.full(len(columns), np.nan)
    hi = np.full(len(columns), np.nan)
    empty = False
    exact = True

    def set_bounds(i: int, b_lo: float, b_hi: float) -> None:
        if not np.isnan(b_lo):
            lo[i] = b_lo if np.isnan(lo[i]) else max(lo[i], b_lo)
        if not np.isnan(b_hi):
            hi[i] = b_hi if np.isnan(hi[i]) else min(hi[i], b_hi)

    def walk_part(e, t) -> bool:
        """Partition-column comparisons: Column(p) <op> Literal, both
        orientations (the skipping rewrite does not normalize these)."""
        nonlocal empty
        left, right = e.left, e.right
        if isinstance(left, ir.Literal) and isinstance(right, ir.Column):
            t = _FLIP[t]
            left, right = right, left
        if not (isinstance(left, ir.Column) and isinstance(right, ir.Literal)):
            return False
        key = pmap.get(left.name.lower())
        if key is None:
            return False
        part = part_info[key]
        i = col_ix[key]
        if right.value is None:
            empty = True  # col <op> NULL matches nothing
            return True
        if t is ir.Eq:
            code = part.eq_code(right.value)
            if code is None:
                return False
            if code < 0:
                empty = True  # value absent from the table entirely
                return True
            set_bounds(i, float(code), float(code))
            return True
        op = {ir.Lt: "lt", ir.Le: "le", ir.Gt: "gt", ir.Ge: "ge"}.get(t)
        if op is None:
            return False
        b = part.bound_code(right.value, op)
        if b is None:
            return False
        set_bounds(i, *b)
        if not np.isnan(hi[i]) and hi[i] < 0:
            empty = True  # upper bound below every code
        if not np.isnan(lo[i]) and lo[i] > len(part.values) - 1:
            empty = True  # lower bound above every code
        return True

    def walk(e: ir.Expression) -> bool:
        nonlocal empty, exact
        t = type(e)
        if t is ir.And:
            return walk(e.left) and walk(e.right)
        if t is ir.Literal:
            if e.value is None or e.value is True:
                return True  # unknown/true conjunct prunes nothing
            if e.value is False:
                empty = True
                return True
            return False
        if t in (ir.Le, ir.Lt, ir.Ge, ir.Gt, ir.Eq):
            left, right = e.left, e.right
            if pmap and walk_part(e, t):
                return True
            if t is ir.Eq:
                return False  # stat lanes never see raw equality
            if not (isinstance(left, ir.Column) and isinstance(right, ir.Literal)):
                return False
            name = left.name
            base = name[4:] if name.startswith(("min.", "max.")) else None
            if (isinstance(right.value, str) and base is not None
                    and base in (str_lanes or frozenset())):
                # string stat lane: compare in 6-byte-prefix space; the
                # truncation makes the bound conservative, never exact
                v = string_prefix_lane_value(right.value)
                exact = False
            elif not isinstance(right.value, (int, float)) or isinstance(right.value, bool):
                return False
            else:
                v = float(right.value)
            if name.startswith("min.") and t in (ir.Le, ir.Lt):
                i = col_ix.get(name[4:])
                if i is None:
                    return False
                if t is ir.Lt:
                    exact = False
                hi[i] = v if np.isnan(hi[i]) else min(hi[i], v)
                return True
            if name.startswith("max.") and t in (ir.Ge, ir.Gt):
                i = col_ix.get(name[4:])
                if i is None:
                    return False
                if t is ir.Gt:
                    exact = False
                lo[i] = v if np.isnan(lo[i]) else max(lo[i], v)
                return True
            return False
        return False

    if not walk(pred):
        return None
    if empty:
        return RangeSet(lo, hi, verdict="empty", exact=exact)
    if np.isnan(lo).all() and np.isnan(hi).all():
        return RangeSet(lo, hi, verdict="all", exact=exact)
    return RangeSet(lo, hi, exact=exact)


# -- the resident entry ------------------------------------------------------


@dataclass
class PlanResult:
    """One query's plan: ``rows`` are row indices into the entry's layout
    (map to paths via ``ResidentState.paths``); ``overflow`` means more than
    k files survived (``count`` stays exact)."""

    count: int
    rows: np.ndarray
    overflow: bool = False
    via: str = "host-resident"  # 'device' | 'device-sharded' | 'host-resident' | 'verdict'


class ResidentState:
    """One table's scan-planning lanes on ``device`` + exact host mirrors.

    Rows are append-only (a re-added path gets a fresh row; the old one's
    alive bit drops); device lanes are padded to a power-of-two capacity,
    on one card or split along the file axis over the state mesh.
    """

    def __init__(self, log_path: str, metadata_id: str, version: int,
                 columns: List[str], paths: List[str],
                 lanes: Dict[str, np.ndarray], device: torch.device,
                 part_info: Optional[Dict[str, PartLane]] = None,
                 str_lanes: Optional[frozenset] = None):
        self.log_path = log_path
        self.metadata_id = metadata_id
        self.version = version
        self.columns = columns
        self.device = device
        # partition pseudo-lanes: column name -> dictionary metadata; the
        # lane lives in h_lo/h_hi as min=max=code (+inf/-inf = null value)
        self.part_info: Dict[str, PartLane] = part_info or {}
        # stats columns whose lanes hold 6-byte string prefixes
        self.str_lanes: frozenset = str_lanes or frozenset()
        self.paths = list(paths)
        self.path_to_row: Dict[str, int] = {p: i for i, p in enumerate(paths)}
        n = len(paths)
        self.num_rows = n
        self.capacity = _next_pow2(max(n, 1))
        # exact host mirrors (float64 bounds; the device carries f32)
        self.h_alive = np.ones(n, bool)
        self.h_lo = lanes["min"]  # (C, n) float64
        self.h_hi = lanes["max"]
        self.h_size = lanes["size"]  # (n,) int64
        self._dead = 0
        # one card: {"mins", "maxs", "alive"}; sharded: a list of such dicts,
        # one slice of the file axis a mesh entry
        self._dev = None
        self._dev_shards = 1  # mesh shards the residency is placed over
        self._lock = threading.RLock()
        self.last_used = 0

    # -- device residency -------------------------------------------------

    def _pad2(self, a: np.ndarray) -> np.ndarray:
        out = np.full((a.shape[0], self.capacity), np.nan, np.float32)
        out[:, : a.shape[1]] = a
        return out

    @property
    def device_bytes(self) -> int:
        return self.capacity * (2 * len(self.columns) * 4 + 1)

    def _build_device(self, shards: int = 1) -> None:
        alive = np.zeros(self.capacity, bool)
        alive[: self.num_rows] = self.h_alive[: self.num_rows]
        mins = self._pad2(_f32_down(self.h_lo))
        maxs = self._pad2(_f32_up(self.h_hi))
        if shards > 1:
            # sharded residency: the lanes split along the file axis, one
            # slice of whole blocks a mesh entry, each on its own device
            from delta_tpu_torch.parallel.mesh import state_mesh

            mesh = state_mesh(shards, device=self.device)
            per = self.capacity // shards

            def piece(a, i):
                return torch.from_numpy(np.ascontiguousarray(a[..., i * per:(i + 1) * per]))

            self._dev = [{"mins": piece(mins, i).to(d), "maxs": piece(maxs, i).to(d),
                          "alive": piece(alive, i).to(d)} for i, d in enumerate(mesh)]
        else:
            d = self.device
            self._dev = {"mins": torch.from_numpy(mins).to(d),
                         "maxs": torch.from_numpy(maxs).to(d),
                         "alive": torch.from_numpy(alive).to(d)}
        self._dev_shards = shards

    def ensure_resident(self, shards: Optional[int] = None) -> None:
        with self._lock:
            if self._dev is None:
                self._build_device(shards if shards is not None else 1)

    @property
    def is_resident(self) -> bool:
        return self._dev is not None

    @property
    def resident_shards(self) -> int:
        """Mesh shards the device residency is placed over (1 = one card or
        not resident)."""
        return self._dev_shards if self._dev is not None else 1

    def drop_device(self) -> None:
        with self._lock:
            self._dev = None
            self._dev_shards = 1

    # -- incremental tail apply ------------------------------------------

    def apply_tail(self, version: int, removed_paths: Sequence[str],
                   added: Tuple[List[str], np.ndarray, np.ndarray, np.ndarray]) -> bool:
        """Advance to ``version``: drop removed paths, append added rows
        (paths, lo(C,k), hi(C,k), size(k)). Returns False when the entry
        must be rebuilt instead (capacity overflow / too much garbage)."""
        add_paths, add_lo, add_hi, add_size = added
        k = len(add_paths)
        with self._lock:
            # Pass 1: count dead rows WITHOUT mutating the mirrors, so a
            # rebuild verdict leaves the entry exactly at its old version
            dead_rows: List[int] = []
            seen_dead = set()
            for p in list(removed_paths) + list(add_paths):
                # a re-add supersedes the old row's stats
                r = self.path_to_row.get(p)
                if r is not None and self.h_alive[r] and r not in seen_dead:
                    dead_rows.append(r)
                    seen_dead.add(r)
            start = self.num_rows
            if (start + k > self.capacity
                    or self._dead + len(dead_rows) > max(1024, self.num_rows // 2)):
                return False
            # Pass 2: committed — kill exactly the rows Pass 1 counted
            for p in removed_paths:
                self.path_to_row.pop(p, None)
            self.h_alive[dead_rows] = False
            self._dead += len(dead_rows)
            if k:
                self.h_alive = np.concatenate([self.h_alive, np.ones(k, bool)])
                self.h_lo = np.concatenate([self.h_lo, add_lo], axis=1)
                self.h_hi = np.concatenate([self.h_hi, add_hi], axis=1)
                self.h_size = np.concatenate([self.h_size, add_size])
                for i, p in enumerate(add_paths):
                    self.paths.append(p)
                    self.path_to_row[p] = start + i
                self.num_rows = start + k
            if self._dev is not None:
                if self._dev_shards > 1:
                    # sharded lanes drop and rebuild from the mirrors on the
                    # next device plan, as in the JAX package (the router
                    # prices the cold upload)
                    self.drop_device()
                else:
                    self._apply_tail_device(dead_rows, start, k, add_lo, add_hi)
            self.version = version
            return True

    def map_tail_lanes(self, arr, metadata):
        """Translate a decoded tail's FileStateArrays into this entry's lane
        space: stats lanes pass through; partition codes re-map through the
        entry dictionaries, EXTENDING them for unseen values (an append that
        sorts after the current maximum keeps range lowering alive; an
        out-of-order value clears ``sorted``). None -> caller rebuilds."""
        with self._lock:
            if not arr.paths:  # pure-remove tail: no lanes to translate
                z = np.empty((len(self.columns), 0))
                return [], z, z.copy(), np.empty(0, np.int64)
            part_cols = sorted(self.part_info.keys())
            if part_cols != sorted(arr.partition_codes.keys()):
                return None
            stats_cols = [c for c in self.columns if c not in self.part_info]
            if stats_cols != sorted(arr.stats_min.keys()):
                return None
            mapped: Dict[str, np.ndarray] = {}
            for c in part_cols:
                part = self.part_info[c]
                tail_values = arr.partition_dicts[c]
                trans = np.empty(len(tail_values), np.int64)
                for j, v in enumerate(tail_values):
                    code = part.code_of.get(v)
                    if code is None:
                        code = len(part.values)
                        if code >= (1 << 24):
                            return None
                        if part.parsed is not None:
                            pv = _stat_to_lane(v, part.dt)
                            # a new STRING mapping to an already-present sort
                            # key ("1.0" joining "1") would split one value
                            # across two codes: rebuild instead
                            if pv is None or bool(np.any(part.parsed == pv)):
                                return None
                            if part.sorted and len(part.parsed):
                                part.sorted = pv > part.parsed[-1]
                            part.parsed = np.append(part.parsed, pv)
                        elif part.sorted and len(part.values):
                            part.sorted = v > part.values[-1]
                        part.values.append(v)
                        part.code_of[v] = code
                    trans[j] = code
                codes = arr.partition_codes[c]
                if len(tail_values) == 0:  # all-null tail for this column
                    mapped[c] = np.full(len(codes), -1, np.int32)
                else:
                    mapped[c] = np.where(
                        codes >= 0, trans[np.maximum(codes, 0)], -1).astype(np.int32)
            lanes = _stacked_lanes(arr, stats_cols, mapped)
            return list(arr.paths), lanes["min"], lanes["max"], lanes["size"]

    def _apply_tail_device(self, dead_rows, start, k, add_lo, add_hi) -> None:
        """One upload + one launch (:func:`tail_apply`), in place on the
        resident lanes. The dead rows, padded to a power of two with ``cap``
        (which the kernel drops), and the added rows' min and max columns
        travel in one buffer."""
        dev = self._dev
        cap = self.capacity
        c = self.h_lo.shape[0]
        nd = _next_pow2(max(len(dead_rows), 1), floor=8)
        packed = np.empty(nd + 2 * c * k, np.int32)
        packed[:nd] = cap
        packed[: len(dead_rows)] = dead_rows
        vals = packed[nd:].view(np.float32).reshape(2, c, k)
        vals[0] = _f32_down(add_lo)
        vals[1] = _f32_up(add_hi)
        buf = _upload(packed, self.device)
        lanes = buf[nd:].view(torch.float32).view(2, c, k)
        tail_apply(dev["alive"], dev["mins"], dev["maxs"], buf[:nd], start, k, lanes[0],
                   lanes[1])

    # -- serving ----------------------------------------------------------

    def plan_ranges(self, ranges: Sequence[RangeSet], k=256,
                    use_device: Optional[bool] = None,
                    expected_version: Optional[int] = None) -> Optional[List[PlanResult]]:
        """Evaluate a batch of range queries: one block-cull launch, one
        packed-bitmap download, then the exact host fine pass. Structural
        verdicts short-circuit. ``use_device=None`` routes by
        ``delta.tpu.stateCache.devicePlan.*`` (``auto`` prices both sides
        with the link cost model, :meth:`_route_plan`); True pins the block
        cull, False the float64 host mirrors alone (the exact reference).
        Each result records its route in ``via``.

        ``k`` caps each result's row list: a scalar for the whole batch, or
        one per range. ``expected_version`` guards against the entry having
        advanced past the caller's snapshot: the result is then None."""
        n = len(ranges)
        ks = (np.full(n, int(k), np.int64) if np.isscalar(k)
              else np.asarray(k, np.int64))
        if len(ks) != n:
            raise ValueError(f"per-range k length {len(ks)} != {n} ranges")
        priced = None
        with self._lock:
            if expected_version is not None and self.version != expected_version:
                return None
            real_ix = [i for i, r in enumerate(ranges) if r.verdict is None]
            out: List[Optional[PlanResult]] = [None] * n
            if any(r.verdict == "all" for r in ranges):
                alive_rows = np.nonzero(self.h_alive[: self.num_rows])[0]
            for i, r in enumerate(ranges):
                if r.verdict == "empty":
                    out[i] = PlanResult(0, np.empty(0, np.int64), via="verdict")
                elif r.verdict == "all":
                    out[i] = PlanResult(len(alive_rows), alive_rows[:ks[i]],
                                        overflow=len(alive_rows) > ks[i],
                                        via="verdict")
            if not real_ix:
                return out  # type: ignore[return-value]
            lo = np.stack([ranges[i].lo for i in real_ix])  # (M, C)
            hi = np.stack([ranges[i].hi for i in real_ix])
            real_ks = ks[real_ix]
            if use_device is None:
                use_device, priced = self._route_plan(len(real_ix))
            shards = self._plan_shards(priced, len(real_ix)) if use_device else 1
            t0 = time.perf_counter_ns()
            results = (self._plan_device(lo, hi, real_ks, shards=shards) if use_device
                       else self._plan_host(lo, hi, real_ks))
            plan_s = (time.perf_counter_ns() - t0) / 1e9
            ran_shards = self._dev_shards if use_device else 1
            via = ("device-sharded" if ran_shards > 1
                   else "device" if use_device else "host-resident")
            for j, i in enumerate(real_ix):
                results[j].via = via
                out[i] = results[j]
        # the audit runs outside the entry lock: the ledger (and the
        # calibrator's state file) must not serialize planners or a tail
        # apply. Only an auto-routed batch audits: a pinned mode made no
        # priced decision
        if priced is not None:
            from delta_tpu_torch.obs import router_audit

            device_s, host_s, cells, device_fixed_s, sharded_s, _ns = priced
            # the per-cell sample with the prediction's fixed terms taken
            # out first: the prediction adds them back
            if use_device:
                eff = plan_s - device_fixed_s
                # a sharded run did cells / shards of work a shard: sample
                # the per-cell rate at that count, so it fits one device
                cal_cells = cells // max(ran_shards, 1)
                samples = [("DEVICE_PRUNE_S_PER_CELL", cal_cells, eff)] if eff > 0 else []
            else:
                samples = [("HOST_PRUNE_S_PER_CELL", cells, plan_s)]
            predictions = {"device": device_s, "host-resident": host_s}
            if sharded_s is not None:
                predictions["device-sharded"] = sharded_s
            router_audit.record_audit(
                "scan.plan", self.log_path, via, predictions, plan_s,
                units={"cells": cells, "queries": len(real_ix)},
                samples=samples, log_path=self.log_path,
                calibration_flush=False)
        return out  # type: ignore[return-value]

    def _price_plan(self, m: int) -> Tuple[float, float, int, float, Optional[float], int]:
        """The cost model of planning ``m`` range queries against this
        entry: (device_s, host_s, cells, device_fixed_s, sharded_s,
        shards). ``device_fixed_s`` is the part of the device price that
        does not grow with the cells (round trips, the bitmap download, the
        first upload), which the calibrator takes out of a measured sample.
        ``sharded_s`` prices the same plan over the feasible mesh
        (``link.sharded_plan_device_s``), None when only one shard is
        feasible."""
        from delta_tpu_torch.parallel import link

        cells = m * self.num_rows * max(len(self.columns), 1)
        host_s = cells * link.constant("HOST_PRUNE_S_PER_CELL")
        p = link.profile(self.device)
        down_bytes = m * max(self.capacity // BLOCK // 8, 1)
        fixed_s = 2 * p.latency_s + p.download_s(down_bytes)
        if self._dev is None:
            # the first plan ships the lanes; charge it to this call
            fixed_s += p.upload_s(self.device_bytes)
        device_s = fixed_s + cells * link.constant("DEVICE_PRUNE_S_PER_CELL")
        shards = self._feasible_shards()
        sharded_s = None
        if shards > 1:
            sharded_s = fixed_s + link.sharded_plan_device_s(cells, shards, p)
        return device_s, host_s, cells, fixed_s, sharded_s, shards

    def _feasible_shards(self) -> int:
        """The largest power-of-two shard count the mesh and the lanes
        admit: every shard must hold whole 1024-file blocks (the capacity is
        a power of two, so divisibility falls with the count). 1 when
        sharded planning is off or the mesh has one entry."""
        from delta_tpu_torch.parallel.mesh import default_devices
        from delta_tpu_torch.utils.config import conf

        if not conf.get_bool("delta.tpu.distributed.plan.enabled", True):
            return 1
        if conf.get("delta.tpu.distributed.plan.mode", "auto") == "off":
            return 1
        nd = len(default_devices(self.device))
        s = 1
        while s * 2 <= nd and self.capacity % (s * 2 * BLOCK) == 0:
            s *= 2
        return s

    def _plan_shards(self, priced, m: int) -> int:
        """The shard count of a device-routed batch. An existing residency
        wins (no re-placement); otherwise ``force`` takes the feasible mesh
        and ``auto`` takes it when the sharded price is the lower."""
        from delta_tpu_torch.utils.config import conf

        if self._dev is not None:
            return self._dev_shards
        s = self._feasible_shards()
        if s <= 1:
            return 1
        if conf.get("delta.tpu.distributed.plan.mode", "auto") == "force":
            return s
        from delta_tpu_torch.parallel import link

        if priced is not None:
            device_s, _h, _c, _f, sharded_s, shards = priced
            return shards if sharded_s is not None and sharded_s < device_s else 1
        # a pinned device route skipped the batch's pricing: price only the
        # sharded-against-one-card choice here
        cells = m * self.num_rows * max(len(self.columns), 1)
        p = link.profile(self.device)
        single = cells * link.constant("DEVICE_PRUNE_S_PER_CELL")
        return s if link.sharded_plan_device_s(cells, s, p) < single else 1

    def _route_plan(self, m: int):
        """(use_device, priced) for ``m`` range queries. The enabled/mode
        checks run before any pricing, so a disabled or pinned deployment
        never pays the link probe and records no audit; ``priced`` is the
        :meth:`_price_plan` tuple under ``auto``, else None. The device side
        enters at its better price (sharded where the mesh wins)."""
        from delta_tpu_torch.utils.config import conf

        if not conf.get_bool("delta.tpu.stateCache.devicePlan.enabled", True):
            return False, None
        mode = conf.get("delta.tpu.stateCache.devicePlan.mode", "auto")
        if mode == "force":
            return True, None
        if mode == "off":
            return False, None
        priced = self._price_plan(m)
        best_device = priced[0] if priced[4] is None else min(priced[0], priced[4])
        return best_device < priced[1], priced

    def _plan_host(self, lo: np.ndarray, hi: np.ndarray,
                   ks: np.ndarray) -> List[PlanResult]:
        n = self.num_rows
        mins, maxs = self.h_lo[:, :n], self.h_hi[:, :n]
        alive = self.h_alive[:n]
        out = []
        for q in range(lo.shape[0]):
            keep = alive.copy()
            for c in range(lo.shape[1]):
                if not np.isnan(lo[q, c]):
                    keep &= ~(maxs[c] < lo[q, c])  # NaN stat keeps
                if not np.isnan(hi[q, c]):
                    keep &= ~(mins[c] > hi[q, c])
            rows = np.nonzero(keep)[0]
            k = ks[q]
            out.append(PlanResult(len(rows), rows[:k], overflow=len(rows) > k))
        return out

    def _plan_device(self, lo: np.ndarray, hi: np.ndarray,
                     ks: np.ndarray, shards: int = 1) -> List[PlanResult]:
        """Coarse-fine plan: the block cull drops 1024-file blocks on the
        resident f32 lanes (one launch, one packed-bitmap download), and
        the host evaluates exactly on the float64 mirrors inside the
        surviving blocks only. The query axis is not padded
        (:func:`plan_bounds`). With a sharded residency, K7
        culls each shard's slice on its device and the unpacked block maps
        gather along the file axis; the same fine pass makes the plans
        equal to one card's and to the host's."""
        from delta_tpu_torch.utils import telemetry

        self.ensure_resident(shards)
        m = lo.shape[0]
        lo_p, hi_p = plan_bounds(lo, hi)
        if self._dev_shards > 1:
            telemetry.bump_counter("dist.plan.sharded")
            bl = sharded_block_cull([(sh["mins"], sh["maxs"], sh["alive"]) for sh in self._dev],
                                    torch.from_numpy(lo_p), torch.from_numpy(hi_p))
            blocks = bl[:m].cpu().numpy().astype(bool)
        else:
            d = self.device
            bits = block_cull(self._dev["mins"], self._dev["maxs"], self._dev["alive"],
                              torch.from_numpy(lo_p).to(d), torch.from_numpy(hi_p).to(d))
            blocks = np.unpackbits(bits[:m].cpu().numpy(), axis=1,
                                   count=self.capacity // BLOCK)
        return self._fine_pass(blocks, lo, hi, ks)

    def _fine_pass(self, blocks: np.ndarray, lo: np.ndarray, hi: np.ndarray,
                   ks: np.ndarray) -> List[PlanResult]:
        """Exact float64 host evaluation inside the surviving blocks."""
        n = self.num_rows
        mins, maxs, alive = self.h_lo[:, :n], self.h_hi[:, :n], self.h_alive[:n]
        out = []
        for q in range(lo.shape[0]):
            hit = np.nonzero(blocks[q])[0]
            if not len(hit):
                out.append(PlanResult(0, np.empty(0, np.int64)))
                continue
            cand = (hit[:, None] * BLOCK + np.arange(BLOCK)[None, :]).reshape(-1)
            cand = cand[cand < n]
            keep = alive[cand].copy()
            for c in range(lo.shape[1]):
                if not np.isnan(lo[q, c]):
                    keep &= ~(maxs[c][cand] < lo[q, c])
                if not np.isnan(hi[q, c]):
                    keep &= ~(mins[c][cand] > hi[q, c])
            rows = cand[keep]
            k = ks[q]
            out.append(PlanResult(len(rows), rows[:k], overflow=len(rows) > k))
        return out


# -- building entries ----------------------------------------------------------


def _lanes_from_arrays(arr, columns: Sequence[str]):
    lo = (np.stack([arr.stats_min[c] for c in columns]) if columns
          else np.empty((0, arr.num_files)))
    hi = (np.stack([arr.stats_max[c] for c in columns]) if columns
          else np.empty((0, arr.num_files)))
    return {"min": lo, "max": hi, "size": arr.size.astype(np.int64)}


def _string_stat_cols(metadata) -> List[str]:
    pset = set(metadata.partition_columns)
    return sorted(f.name for f in metadata.schema.fields
                  if isinstance(f.data_type, StringType) and f.name not in pset)


def _build_part_info(arr, metadata):
    """Value-sort each partition dictionary (typed order when the column
    type parses every value, else code-point order), remap codes to ranks,
    and emit (part_info, remapped_codes) — or None when a dictionary is too
    large for exact f32 lanes."""
    types = {f.name: f.data_type for f in metadata.schema.fields}
    part_info: Dict[str, PartLane] = {}
    remapped: Dict[str, np.ndarray] = {}
    for c in sorted(arr.partition_codes.keys()):
        values = list(arr.partition_dicts[c])
        if len(values) > (1 << 24):  # codes must stay f32-exact
            return None
        dt = types.get(c)
        parsed = None
        if isinstance(dt, _NUMERIC):
            p = [_stat_to_lane(v, dt) for v in values]
            if all(x is not None for x in p):
                cand = np.asarray(p, np.float64)
                # duplicate sort keys ("1" vs "1.0") would make a value range
                # span two codes non-contiguously: fall back to lex order
                if len(np.unique(cand)) == len(cand):
                    parsed = cand
        if parsed is not None:
            order = np.argsort(parsed, kind="stable")
            parsed = parsed[order]
        else:
            order = np.argsort(np.asarray(values, object), kind="stable")
            dt = None
        rank = np.empty(len(values), np.int64)
        rank[order] = np.arange(len(values))
        codes = arr.partition_codes[c]
        if len(values) == 0:
            # every alive file carries null for this column
            remapped[c] = np.full(len(codes), -1, np.int32)
        else:
            remapped[c] = np.where(codes >= 0, rank[np.maximum(codes, 0)], -1).astype(np.int32)
        svals = [values[i] for i in order]
        part_info[c] = PartLane(values=svals, parsed=parsed,
                                code_of={v: i for i, v in enumerate(svals)}, dt=dt)
    return part_info, remapped


def _stacked_lanes(arr, stats_cols, part_codes: Dict[str, np.ndarray]):
    """Combined lane stack: stats columns first (sorted), then partition
    pseudo-lanes (sorted), matching the entry's ``columns`` order."""
    lanes = _lanes_from_arrays(arr, stats_cols)
    if part_codes:
        rows = [_part_lane_rows(part_codes[c]) for c in sorted(part_codes)]
        lanes["min"] = np.concatenate([lanes["min"], np.stack([r[0] for r in rows])], axis=0)
        lanes["max"] = np.concatenate([lanes["max"], np.stack([r[1] for r in rows])], axis=0)
    return lanes


def build_entry(snapshot, device: torch.device) -> Optional[ResidentState]:
    """Full build of a resident entry from a snapshot's columnar state,
    partitioned tables included (dictionary-coded partition lanes). None
    when the shape is unsupported (partition map missing / oversized
    dictionaries)."""
    str_cols = _string_stat_cols(snapshot.metadata)
    arr = arrays_from_columns(snapshot._columnar, snapshot._alive_mask,
                              snapshot.metadata, string_prefix_cols=str_cols)
    if arr is None:
        return None
    built = _build_part_info(arr, snapshot.metadata)
    if built is None:
        return None
    part_info, remapped = built
    stats_cols = sorted(arr.stats_min.keys())
    return ResidentState(
        log_path=snapshot.delta_log.log_path,
        metadata_id=snapshot.metadata.id,
        version=snapshot.version,
        columns=stats_cols + sorted(part_info.keys()),
        paths=list(arr.paths),
        lanes=_stacked_lanes(arr, stats_cols, remapped),
        device=device,
        part_info=part_info,
        str_lanes=frozenset(str_cols),
    )


def resident_from_numpy(
    *, columns: List[str], paths: List[str], h_lo: np.ndarray, h_hi: np.ndarray,
    h_size: np.ndarray, h_alive: np.ndarray, device,
    part_info: Optional[Dict[str, dict]] = None,
    str_lanes: frozenset = frozenset(), version: int = 0,
    log_path: str = "", metadata_id: str = "",
) -> ResidentState:
    """A :class:`ResidentState` on ``device`` from plain numpy state — the
    mirrors of another implementation's entry (the JAX package's), so both
    plan over the same state. ``part_info`` maps a partition column to a
    dict with ``values`` (code -> string), ``parsed`` (float64 sort keys or
    None), ``sorted`` and ``dt`` (the Spark type name, or None)."""
    n = len(paths)
    e = ResidentState(
        log_path=log_path, metadata_id=metadata_id, version=version,
        columns=list(columns), paths=list(paths),
        lanes={"min": np.array(h_lo, np.float64), "max": np.array(h_hi, np.float64),
               "size": np.array(h_size, np.int64)},
        device=torch.device(device),
        part_info={
            c: PartLane(values=list(p["values"]),
                        parsed=None if p["parsed"] is None else np.array(p["parsed"], np.float64),
                        code_of={v: i for i, v in enumerate(p["values"])},
                        sorted=bool(p["sorted"]),
                        dt=None if p["dt"] is None else parse_data_type(p["dt"]))
            for c, p in (part_info or {}).items()},
        str_lanes=frozenset(str_lanes),
    )
    e.h_alive = np.array(h_alive[:n], bool)
    e._dead = int((~e.h_alive).sum())
    return e


def _decode_tail(snapshot, from_version: int):
    """Decode commits (from_version, snapshot.version] to (removed_paths,
    FileStateArrays), or None when incremental apply isn't safe (a
    metadata change in the tail, undecodable shapes)."""
    from delta_tpu_torch.log.columnar import decode_segment
    from delta_tpu_torch.protocol import filenames
    from delta_tpu_torch.protocol.actions import Metadata

    log = snapshot.delta_log
    paths = [f"{log.log_path}/{filenames.delta_file(v)}"
             for v in range(from_version + 1, snapshot.version + 1)]
    try:
        cols = decode_segment(log.store, [], paths)
    except FileNotFoundError:
        return None
    if any(isinstance(a, Metadata) for a in cols.other_actions):
        return None  # schema/config may have changed -> rebuild
    w = cols.winner_mask()
    alive, _ = cols.replay(winner=w)
    removed = cols.paths_for(np.nonzero(w & ~alive)[0])
    arr = arrays_from_columns(cols, alive, snapshot.metadata,
                              string_prefix_cols=_string_stat_cols(snapshot.metadata))
    if arr is None:
        return None
    return removed, arr


class DeviceStateCache:
    """Process-wide registry of :class:`ResidentState` entries, one per
    (table, device), with a device byte budget
    (``delta.tpu.stateCache.maxBytes``) and LRU eviction."""

    _instance: Optional["DeviceStateCache"] = None
    _instance_lock = threading.Lock()

    def __init__(self):
        self._entries: Dict[Tuple[str, str], ResidentState] = {}
        self._lock = threading.RLock()
        self._build_locks: Dict[Tuple[str, str], threading.Lock] = {}
        self._tick = 0

    @classmethod
    def instance(cls) -> "DeviceStateCache":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = DeviceStateCache()
            return cls._instance

    @classmethod
    def reset(cls) -> None:
        with cls._instance_lock:
            cls._instance = None

    def _lookup(self, key, snapshot):
        """(entry_or_None, verdict): 'hit', 'older' (time travel below the
        residency) or 'advance' (tail apply / rebuild)."""
        with self._lock:
            e = self._entries.get(key)
            if e is not None and e.metadata_id != snapshot.metadata.id:
                e = None  # table replaced in place
            if e is None:
                return None, "advance"
            if e.version > snapshot.version:
                return None, "older"
            return e, ("hit" if e.version == snapshot.version else "advance")

    def get(self, snapshot) -> Optional[ResidentState]:
        """Entry current at the snapshot's version on the snapshot's device:
        cache hit, incremental tail apply, or full rebuild. None when
        unsupported or the snapshot is older than the entry."""
        device = snapshot.delta_log.device
        key = (snapshot.delta_log.log_path, str(device))
        with self._lock:
            self._tick += 1
            tick = self._tick
            build_lock = self._build_locks.setdefault(key, threading.Lock())
        e, verdict = self._lookup(key, snapshot)
        if verdict == "older":
            return None
        if verdict == "hit":
            e.last_used = tick
            return e
        with build_lock:
            e, verdict = self._lookup(key, snapshot)  # another thread may have won
            if verdict == "older":
                return None
            if verdict == "hit":
                e.last_used = tick
                return e
            if e is not None:  # behind: try the incremental tail
                tail = _decode_tail(snapshot, e.version)
                ok = False
                if tail is not None:
                    removed, arr = tail
                    added = e.map_tail_lanes(arr, snapshot.metadata)
                    if added is not None:
                        ok = e.apply_tail(snapshot.version, removed, added)
                if not ok:
                    e = None
            if e is None:
                e = build_entry(snapshot, device)
                if e is None:
                    return None
                with self._lock:
                    old = self._entries.get(key)
                    if old is not None and old is not e:
                        old.drop_device()
                    self._entries[key] = e
            e.last_used = tick
            with self._lock:
                self._evict_over_budget(keep=key)
            return e

    def _evict_over_budget(self, keep) -> None:
        # device budget: drop device lanes LRU (host mirrors keep serving)
        resident = [(p, e) for p, e in self._entries.items() if e.is_resident]
        total = sum(e.device_bytes for _, e in resident)
        for p, e in sorted(resident, key=lambda kv: kv[1].last_used):
            if total <= MAX_DEVICE_BYTES:
                break
            if p == keep:
                continue
            e.drop_device()
            total -= e.device_bytes
        # host budget: drop whole tables LRU beyond maxEntries
        if len(self._entries) > MAX_ENTRIES:
            for p, e in sorted(self._entries.items(), key=lambda kv: kv[1].last_used):
                if p == keep:
                    continue
                self._entries.pop(p, None)
                self._build_locks.pop(p, None)
                e.drop_device()
                if len(self._entries) <= MAX_ENTRIES:
                    break

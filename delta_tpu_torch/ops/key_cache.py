"""Resident MERGE join keys: a table's key lane kept on the card.

The port's own copy of ``delta_tpu.ops.key_cache``. A CDC
upsert loop merges into the same table every few minutes, so the target's
key lane is built once, kept resident, and advanced as the log moves: new
files' keys append (a projected Parquet read of just those files, through
the port's own codec, ``exec/parquet``), removed files' rows die, and
deletion-vector growth or shrink flips per-row validity. A probe then
uploads only the source keys and downloads the per-source matched bits and
the matched (slab row, first source row) pairs.

Layout: one int64 key lane per (table, join-key signature, device) in
PHYSICAL row order per file; deletion-vector-deleted rows stay in place,
marked invalid. Composite integer keys pack into one lane (hi<<32 | lo)
when both components fit int32.

Kernels (hand-written CUDA in ``delta_tpu_torch/csrc``, bound in
``ops/native``), each beside its plain PyTorch version, which the wrapper
takes only for tensors on the CPU; for a CUDA tensor it launches the kernel
or raises:

* K8 :func:`slab_sort` (``csrc/slab_sort.cu``) replaces ``_sort_kernel``
  (``key_cache.py:166``): a one-sweep LSD radix sort of the key lane,
  narrowed to the bytes that vary (``csrc/radix.cuh``);
* K9 :func:`slab_probe` (``csrc/slab_probe.cu``) replaces
  ``_probe_sorted_kernel`` (``:206``): binary search of each source key in
  the sorted slab, where the TPU kernel brute-compares blocks against
  candidate windows. It never overflows; the head's overflow byte is 0;
* K10 :func:`pair_compact` (``csrc/pair_compact.cu``) replaces
  ``_pair_compact_kernel`` (``:353``) together with the host's stable
  argsort of its pairs in the probe's finalize (``:908-912``): the pairs
  come out in physical slab order, and :func:`fetch_pairs` downloads just
  them;
* K11 (``csrc/slab_update.cu``) replaces ``_update_kernels`` (``:379``):
  :func:`slab_advance` applies a whole slab advance in one launch, from one
  pinned upload (:func:`pack_advance`: the touched rows, each once, with
  its final validity; the appended rows as a slice; a removed file as a
  run); :func:`slab_kill`, :func:`slab_revive`, :func:`slab_append`,
  :func:`slab_map_rows` and :func:`slab_slice_append` run its kernel with
  one update and keep the JAX kernels' contract (a new tensor, the input
  unchanged); :func:`slab_widen` is a kernel of its own.

JAX arrays are immutable, and a probe in flight on its staging thread
keeps the arrays it pinned while a tail advance binds new ones. The port
keeps what that protects, and no more: a probe holds the sorted view
(``sorted_keys``, ``sorted_valid``, ``perm``), and takes a pin on the entry
while its staging thread may still read them (:meth:`ResidentJoinKeys.
probe_async`). An advance writes the lanes IN PLACE when no probe holds
them; under a pin it binds a new ``sorted_valid`` (one copy of the lane in
the advance's launch) and leaves the pinned one unchanged. ``keys`` and
``valid`` are read only by the sort K8, which the probe's caller issues
under the entry's lock on the same stream, so an advance writes them in
place always; an advance that changes keys drops the sorted view (the
probe keeps its tensors) and the next probe re-sorts.

:class:`SlabBuilder` is the MERGE command's cold pipeline: each decoded
file's key lane lands on a pre-sized device slab as the next files decode,
and :meth:`KeyCache.register` adopts the finished slab so the next MERGE
against the table probes it without a rebuild. Its uploader thread launches
on the same stream as the merging thread (neither sets a side stream), so
the card runs their work in the order the host issued it; the merging
thread joins the uploader before it reads the slab.

Where the JAX package turns a failure into a quiet fallback, the port
raises: the builder's constructor and its uploader thread record an
exception and re-raise it in the merging thread; a device allocation that
fails after eviction had its chance raises; the post-commit warmup
(:meth:`KeyCache.warm`) runs off the committing thread and stores any
exception in :attr:`KeyCache.last_build_error`. The one data fallback kept
is a file whose key lane cannot be packed or whose rows disagree with its
recorded count: the builder then reports ``failed`` and the caller takes
another route.

``delta.tpu.keyCache.maxBytes``/``maxEntries`` are the constants
:data:`MAX_DEVICE_BYTES`/:data:`MAX_ENTRIES`; the HBM ledger, the link
router and the telemetry counters are not ported.
"""
from __future__ import annotations

import contextlib
import os
import threading
import urllib.parse
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from delta_tpu_torch.ops import native
from delta_tpu_torch.ops.join_kernel import PendingJoin as PendingProbe
from delta_tpu_torch.ops.join_kernel import _bucket
from delta_tpu_torch.ops.state_cache import _next_pow2, _packbits, _upload, _xla_rows
from delta_tpu_torch.utils.device import resolve

__all__ = ["ResidentJoinKeys", "KeyCache", "PhysicalProbe", "SlabBuilder", "key_cache_enabled",
           "MAX_DEVICE_BYTES", "MAX_ENTRIES",
           "slab_sort", "slab_sort_plain", "slab_probe", "slab_probe_plain", "pair_compact",
           "pair_compact_plain", "fetch_pairs", "AdvanceLayout", "pack_advance", "slab_advance",
           "slab_advance_plain", "slab_kill", "slab_revive", "slab_flip_plain", "slab_append",
           "slab_append_plain", "slab_widen", "slab_widen_plain", "slab_map_rows",
           "slab_map_rows_plain", "slab_slice_append", "slab_slice_append_plain"]

#: device bytes of resident slabs beyond which LRU entries drop their device
#: copy (``delta.tpu.keyCache.maxBytes``)
MAX_DEVICE_BYTES = 1 << 30
#: entries beyond which LRU entries drop whole (``delta.tpu.keyCache.maxEntries``)
MAX_ENTRIES = 8

# sentinel version for an entry whose tail application failed part-way:
# greater than any real snapshot version, so every staleness guard
# (`entry.version > snapshot.version`) discards the entry immediately
_POISON_VERSION = 1 << 62

_I64_MAX = (1 << 63) - 1
_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1


def key_cache_enabled() -> bool:
    """Whether the cross-MERGE resident key cache may serve and keep
    entries: ``delta.tpu.merge.keyCache.enabled`` and its older alias
    ``delta.tpu.merge.residentKeys.enabled``, either false disabling it."""
    from delta_tpu_torch.utils.config import conf

    return (conf.get_bool("delta.tpu.merge.keyCache.enabled", True)
            and conf.get_bool("delta.tpu.merge.residentKeys.enabled", True))


@dataclass
class PhysicalProbe:
    """Probe output in physical slab space: per-source matched flags and the
    matched PAIRS (physical slab row -> first matching source row).
    ``slabs`` maps file path -> (offset, rows). ``t_pairs`` is None for an
    insert-only probe. ``t_bits`` (per slab row) materializes lazily from
    the pairs."""

    s_matched: np.ndarray  # bool per source row
    any_multi: bool
    slabs: Dict[str, Tuple[int, int]]
    num_rows: int = 0  # live slab rows (t_bits length)
    # (physical slab rows ascending, first-match source row per pair)
    t_pairs: Optional[Tuple[np.ndarray, np.ndarray]] = None
    _bits: Optional[np.ndarray] = None

    @property
    def t_bits(self) -> Optional[np.ndarray]:
        """Bool per physical slab row; None for an insert-only probe."""
        if self._bits is None and self.t_pairs is not None:
            t = np.zeros(self.num_rows, bool)
            phys, _ = self.t_pairs
            t[phys[phys < self.num_rows]] = True
            self._bits = t
        return self._bits

    def bits_for_file(self, path: str, positions: Optional[np.ndarray],
                      num_rows: int) -> Optional[np.ndarray]:
        """Matched flags for a file's *decoded* rows. ``positions`` are the
        decoded rows' physical positions (None = decode was not DV-filtered).
        None when the file isn't in the slab or shapes disagree."""
        ent = self.slabs.get(path)
        if ent is None or self.t_bits is None:
            return None
        off, rows = ent
        if positions is None:
            if num_rows != rows:
                return None
            return self.t_bits[off:off + rows]
        if len(positions) and positions.max() >= rows:
            return None
        return self.t_bits[off + positions]

    def pairs_for_file(self, path: str, positions: Optional[np.ndarray],
                       num_rows: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """The matched pairs landing in one file, mapped onto its *decoded*
        rows: (decoded row indices, first-match source rows). None when the
        file isn't in the slab or the slab disagrees with the decode."""
        ent = self.slabs.get(path)
        if ent is None or self.t_pairs is None:
            return None
        off, rows = ent
        phys, srows = self.t_pairs
        lo = int(np.searchsorted(phys, off))
        hi = int(np.searchsorted(phys, off + rows))
        p_local = phys[lo:hi] - off
        s_local = srows[lo:hi]
        if positions is None:
            if num_rows != rows:
                return None
            return p_local, s_local
        if len(positions) and int(positions[-1]) >= rows:
            return None
        idx = np.searchsorted(positions, p_local)
        if (idx >= len(positions)).any():
            return None
        if len(idx) and not (positions[idx] == p_local).all():
            return None  # slab matched a row the decode dropped: fall back
        return idx, s_local


# -- the kernels and their plain versions -----------------------------------------


def _same_device(name: str, *ts: torch.Tensor) -> torch.device:
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError(f"{name}: all tensors must be on one device")
    return dev


def _contiguous(name: str, *ts: torch.Tensor) -> None:
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name}: tensors must be contiguous")


def slab_sort_plain(keys: torch.Tensor, valid: torch.Tensor, n: int):
    """Plain PyTorch version of K8: rows at or past ``n`` encode as
    int64.max, then a stable sort."""
    cap = keys.shape[0]
    iota = torch.arange(cap, dtype=torch.int64, device=keys.device)
    enc = torch.where(iota < n, keys, torch.full_like(keys, _I64_MAX))
    sk, perm = torch.sort(enc, stable=True)
    inv = torch.empty(cap, dtype=torch.int32, device=keys.device)
    inv[perm] = iota.to(torch.int32)
    sv = (valid & (iota < n))[perm]
    return sk, perm.to(torch.int32), inv, sv


#: rows per one-sweep tile of the radix sort (``csrc/radix.cuh``'s kTile)
_RADIX_TILE = 4096
_ALIGN = 256


def _aligned(nbytes: int) -> int:
    return (nbytes + _ALIGN - 1) // _ALIGN * _ALIGN


def _radix_scratch_bytes(n: int) -> int:
    """The scratch of the radix sort of ``n`` rows (what ``csrc/radix.cuh``'s
    ``sort_rows`` carves): the histograms, diff and tile counters; the digit
    offsets; 8 passes of look-back words; two ping-pong word and row
    lanes."""
    tiles = (n + _RADIX_TILE - 1) // _RADIX_TILE
    return (_aligned(4 * 8 * 256 + 8 + 4 * 8) + _aligned(4 * 8 * 256)
            + _aligned(8 * 8 * 256 * tiles) + 2 * (_aligned(8 * n) + _aligned(4 * n)))


def _sort_scratch_bytes(n: int) -> int:
    """K8's scratch (``csrc/slab_sort.cu``): the inverse's (row, i) pairs
    and 1024 bucket counters, then the radix sort's."""
    return _aligned(8 * max(n, 1)) + _aligned(4 * 1024) + _radix_scratch_bytes(n)


def slab_sort(keys: torch.Tensor, valid: torch.Tensor, n: int):
    """K8: the slab's key lane sorted, rows at or past ``n`` as int64.max at
    the tail. Returns (sorted keys int64, perm int32, inv int32 with
    ``inv[perm[i]] = i``, sorted validity ``valid[perm] & (perm < n)``).
    keys ``(cap,)`` int64, valid ``(cap,)`` bool. Stable: equal keys keep
    their row order."""
    if keys.dtype != torch.int64 or valid.dtype != torch.bool or keys.dim() != 1 \
            or valid.shape != keys.shape:
        raise TypeError("slab_sort: keys must be 1-D int64 and valid bool of the same shape")
    cap = keys.shape[0]
    if not 0 <= n <= cap or cap >= 1 << 31:
        raise ValueError(f"slab_sort: n={n} outside [0, cap={cap}] or cap too large")
    dev = _same_device("slab_sort", keys, valid)
    if dev.type == "cpu":
        return slab_sort_plain(keys, valid, n)
    _contiguous("slab_sort", keys, valid)
    sk = torch.empty(cap, dtype=torch.int64, device=dev)
    perm = torch.empty(cap, dtype=torch.int32, device=dev)
    inv = torch.empty(cap, dtype=torch.int32, device=dev)
    sv = torch.empty(cap, dtype=torch.bool, device=dev)
    nbytes = _sort_scratch_bytes(n)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    native.call("slab_sort", dev, keys.data_ptr(), valid.data_ptr(), n, cap, sk.data_ptr(),
                perm.data_ptr(), inv.data_ptr(), sv.data_ptr(), scratch.data_ptr(), nbytes)
    native.launches["slab_sort"] += 1
    return sk, perm, inv, sv


def slab_probe_plain(sorted_keys: torch.Tensor, sorted_valid: torch.Tensor, n: int,
                     s_keys: torch.Tensor):
    """Plain PyTorch version of K9, with the kernel's contract:

    * ``head`` = ``[multi | 0 | matched count, 4 bytes LE | s_bits]``,
      ``s_bits`` big-endian packed ``s_match``: source ``j`` equals a VALID
      slab row among the real rows ``[0, n)``; ``multi``: some matched
      source key occurs at least twice in the source;
    * ``t_match`` (cap,): a valid real row whose key equals a source key;
    * ``s_first`` (cap,) int32: for a real row whose key equals a source
      key, the smallest such source index; ``m`` elsewhere."""
    dev = sorted_keys.device
    cap, m = sorted_keys.shape[0], s_keys.shape[0]
    s = s_keys.to(torch.int64)
    jj = torch.arange(m, dtype=torch.int64, device=dev)
    sk = sorted_keys[:n]
    if n:
        lb = torch.searchsorted(sk, s)
        hit = (lb < n) & (sk[lb.clamp(max=n - 1)] == s)
    else:
        lb = torch.zeros(m, dtype=torch.int64, device=dev)
        hit = torch.zeros(m, dtype=torch.bool, device=dev)
    first = torch.full((max(n, 1),), m, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, lb[hit], jj[hit], "amin")
    start = torch.searchsorted(sk, sk) if n else torch.zeros(0, dtype=torch.int64, device=dev)
    row_first = first[start]
    row_hit = row_first < m
    run_valid = torch.zeros(max(n, 1), dtype=torch.int64, device=dev)
    run_valid.scatter_reduce_(0, start, (sorted_valid[:n] & row_hit).to(torch.int64), "amax")
    t_match = torch.zeros(cap, dtype=torch.bool, device=dev)
    t_match[:n] = row_hit & sorted_valid[:n]
    s_first = torch.full((cap,), m, dtype=torch.int32, device=dev)
    s_first[:n] = row_first.to(torch.int32)
    lbc = lb.clamp(max=max(n - 1, 0))
    s_match = hit & (run_valid[lbc] > 0)
    multi = bool((s_match & (first[lbc] != jj)).any())
    mc = int(t_match.sum())
    head = torch.cat([
        torch.tensor([int(multi), 0] + [(mc >> sh) & 0xFF for sh in (0, 8, 16, 24)],
                     dtype=torch.uint8, device=dev),
        _packbits(s_match),
    ])
    return head, t_match, s_first


def _probe_scratch_bytes(m: int, itemsize: int) -> int:
    """K9's scratch (``csrc/slab_probe.cu``): the source's table of 2 L + 8
    slots (L the power of two at least 2 m, and 16: the ordered part with
    its 8-slot window, then the overflow part), its keys (``itemsize`` bytes
    a slot) and its words (4 bytes a slot), then 256 bytes of counters."""
    slots = 16
    while slots < 2 * m:
        slots *= 2
    total = 2 * slots + 8
    return _aligned(itemsize * total) + _aligned(4 * total) + 256


def slab_probe(sorted_keys: torch.Tensor, sorted_valid: torch.Tensor, n: int,
               s_keys: torch.Tensor):
    """K9: membership probe of the source keys (``(m,)`` int32 or int64, m
    a multiple of 8) against the sorted slab's real rows ``[0, n)``.
    Returns (head uint8 ``(6 + m/8,)``, t_match bool ``(cap,)``, s_first
    int32 ``(cap,)``), as :func:`slab_probe_plain` defines them."""
    if sorted_keys.dtype != torch.int64 or sorted_valid.dtype != torch.bool \
            or s_keys.dtype not in (torch.int32, torch.int64):
        raise TypeError("slab_probe: sorted keys int64, validity bool, source int32/int64")
    cap, m = sorted_keys.shape[0], s_keys.shape[0]
    if sorted_valid.shape != (cap,) or s_keys.dim() != 1 or m % 8 or not 0 <= n <= cap:
        raise ValueError(f"slab_probe: bad shapes keys {tuple(sorted_keys.shape)} valid "
                         f"{tuple(sorted_valid.shape)} source {tuple(s_keys.shape)} n={n}")
    if m >= 1 << 31 or cap >= 1 << 31:
        raise ValueError("slab_probe: sizes must fit int32")
    dev = _same_device("slab_probe", sorted_keys, sorted_valid, s_keys)
    if dev.type == "cpu":
        return slab_probe_plain(sorted_keys, sorted_valid, n, s_keys)
    _contiguous("slab_probe", sorted_keys, sorted_valid, s_keys)
    # the three outputs in one allocation: s_first, t_match, head
    at_t, at_h = _aligned(4 * cap), _aligned(4 * cap) + _aligned(cap)
    out = torch.empty(at_h + 6 + m // 8, dtype=torch.uint8, device=dev)
    s_first = out[:4 * cap].view(torch.int32)
    t_match = out[at_t:at_t + cap].view(torch.bool)
    head = out[at_h:]
    nbytes = _probe_scratch_bytes(m, s_keys.element_size())
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    native.call("slab_probe", dev, sorted_keys.data_ptr(), sorted_valid.data_ptr(), n, cap,
                s_keys.data_ptr(), 1 if s_keys.dtype == torch.int32 else 0, m, head.data_ptr(),
                t_match.data_ptr(), s_first.data_ptr(), scratch.data_ptr(), nbytes)
    native.launches["slab_probe"] += 1
    return head, t_match, s_first


def pair_compact_plain(t_match: torch.Tensor, s_first: torch.Tensor, perm: torch.Tensor,
                       out_cap: int) -> torch.Tensor:
    """Plain PyTorch version of K10: the matched rows' (``perm[i]``,
    ``s_first[i]``) sorted by ``perm[i]``, the first ``out_cap`` of them,
    zeros after."""
    idx = torch.nonzero(t_match).reshape(-1)
    phys, order = torch.sort(perm[idx])
    keep = min(len(idx), out_cap)
    out = torch.zeros((2, out_cap), dtype=torch.int32, device=t_match.device)
    out[0, :keep] = phys[:keep]
    out[1, :keep] = s_first[idx[order[:keep]]]
    return out


def _compact_scratch_bytes(cap: int) -> int:
    """K10's scratch (``csrc/pair_compact.cu``): the physical bitmap (a bit
    a row), a status word a tile of 8,192 rows, the ticket and the count,
    then the source rows by physical row (4 bytes a row)."""
    words = (cap + 31) // 32
    tiles = (words + 255) // 256
    return _aligned(4 * words) + _aligned(8 * tiles) + _aligned(8) + _aligned(4 * cap)


def pair_compact(t_match: torch.Tensor, s_first: torch.Tensor, perm: torch.Tensor,
                 out_cap: int, mc: Optional[int] = None,
                 host: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K10: the matched sorted rows' (``perm[i]``, ``s_first[i]``) in
    physical order (ascending ``perm[i]``), compacted into a ``(2, out_cap)``
    int32; zeros past the matched count, and where ``out_cap`` is below it,
    the first ``out_cap`` pairs in physical order. ``mc``, the matched count
    when the caller knows it (the probe's head), spares zeroing the slots
    below it. ``host`` (int32 ``(2 mc + 1,)``, pinned for a CUDA launch)
    receives the pairs ``[:, :mc]`` and then the kernel's count, copied on
    the stream after the kernel (:func:`fetch_pairs` waits for it)."""
    cap = t_match.shape[0]
    if t_match.dtype != torch.bool or s_first.dtype != torch.int32 or perm.dtype != torch.int32:
        raise TypeError("pair_compact: t_match bool, s_first and perm int32")
    if s_first.shape != (cap,) or perm.shape != (cap,) or out_cap < 0:
        raise ValueError("pair_compact: bad shapes")
    if host is not None and (mc is None or not 0 <= mc <= out_cap
                             or host.dtype != torch.int32 or host.shape != (2 * mc + 1,)):
        raise ValueError("pair_compact: host needs mc <= out_cap and int32 (2 mc + 1,)")
    dev = _same_device("pair_compact", t_match, s_first, perm)
    if dev.type == "cpu":
        out = pair_compact_plain(t_match, s_first, perm, out_cap)
        if host is not None:
            host[:2 * mc] = out[:, :mc].reshape(-1)
            host[2 * mc] = int(t_match.sum())
        return out
    _contiguous("pair_compact", t_match, s_first, perm)
    if host is not None and not host.is_pinned():
        raise ValueError("pair_compact: host must be pinned")
    # the output and the scratch in one allocation, the scratch 256-aligned
    at = _aligned(8 * out_cap)
    nbytes = _compact_scratch_bytes(cap)
    buf = torch.empty(at + nbytes, dtype=torch.uint8, device=dev)
    out = buf[:8 * out_cap].view(torch.int32).view(2, out_cap)
    native.call("pair_compact", dev, t_match.data_ptr(), s_first.data_ptr(), perm.data_ptr(),
                cap, out.data_ptr(), out_cap, -1 if mc is None else mc,
                None if host is None else host.data_ptr(), buf.data_ptr() + at, nbytes)
    native.launches["pair_compact"] += 1
    return out


def fetch_pairs(t_match: torch.Tensor, s_first: torch.Tensor, perm: torch.Tensor,
                mc: int) -> torch.Tensor:
    """The probe's pairs on the host: K10 into a ``(2, out_cap)`` buffer
    (``out_cap`` the power of two from ``mc``, at least 64) and its first
    ``mc`` pairs and count downloaded into one int32 ``(2 mc + 1,)``
    (pinned for a CUDA launch): the physical rows ascending at ``[:mc]``,
    their first source rows at ``[mc:2 mc]``. Waits for the download on
    the current stream; raises if the kernel's count is not ``mc``."""
    dev = t_match.device
    host = torch.empty(2 * mc + 1, dtype=torch.int32, pin_memory=dev.type == "cuda")
    pair_compact(t_match, s_first, perm, _next_pow2(mc, floor=64), mc=mc, host=host)
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()
    if int(host[2 * mc]) != mc:
        raise RuntimeError(f"pair_compact counted {int(host[2 * mc])} matched rows where the "
                           f"probe's head counts {mc}")
    return host


class AdvanceLayout(NamedTuple):
    """One advance's parts in its upload: the row list (``d`` rows, with
    keys when ``keyed``), the slice (``a`` rows from ``start``) and the
    runs (``nr`` of them, ``run_rows`` rows); keys as int32 when
    ``keys_i32``. The ``o_*`` are byte offsets in the buffer, ``nbytes``
    its length."""

    d: int
    a: int
    start: int
    nr: int
    run_rows: int
    keyed: bool
    keys_i32: bool
    o_rows: int
    o_rvalid: int
    o_rkeys: int
    o_skeys: int
    o_svalid: int
    o_runs: int
    o_rval: int
    nbytes: int


def pack_advance(rows=None, rows_valid=None, rows_keys=None, start: int = 0, slice_keys=None,
                 slice_valid=None, runs=None, run_valid=None):
    """The host side of one slab advance: its parts in one uint8 buffer
    (one upload) and their :class:`AdvanceLayout`. ``rows`` (d,) row
    indices (XLA drop mode) with ``rows_valid`` (d,) bool and, for a keyed
    list, ``rows_keys`` (d,); the slice ``slice_keys`` / ``slice_valid``
    (a,) written from ``start``; ``runs`` (nr, 2) (start, count) with
    ``run_valid`` (nr,) bool. Keys travel as int32 when every one fits.
    Each part is cast to its type as it is copied in."""
    def arr(x, dt):
        return np.empty(0, dt) if x is None else np.asarray(x).reshape(-1)

    rows, rvalid, skeys, svalid = (arr(rows, np.int32), arr(rows_valid, bool),
                                   arr(slice_keys, np.int64), arr(slice_valid, bool))
    d, a = len(rows), len(skeys)
    rkeys = arr(rows_keys, np.int64) if rows_keys is not None and d else None
    runs = np.asarray(runs if runs is not None else [], np.int64).reshape(-1, 2)
    rval = arr(run_valid, bool)
    nr = len(runs)
    if len(rvalid) != d or len(svalid) != a or len(rval) != nr or (
            rkeys is not None and len(rkeys) != d):
        raise ValueError("pack_advance: each part's values must match its rows")
    keys_i32 = all(int(k.min()) >= _I32_MIN and int(k.max()) <= _I32_MAX
                   for k in (skeys, rkeys) if k is not None and len(k))
    kdt = np.int32 if keys_i32 else np.int64
    run_words = None
    if nr:  # the runs' starts, then the exclusive prefix of their counts
        run_words = np.zeros(2 * nr + 1, np.int64)
        run_words[:nr] = runs[:, 0]
        np.cumsum(runs[:, 1], out=run_words[nr + 1:])
    parts = ((rows, np.int32), (rvalid, np.bool_), (rkeys, kdt), (skeys, kdt),
             (svalid, np.bool_), (run_words, np.int64), (rval, np.bool_))
    offs, off = [], 0
    for x, dt in parts:
        offs.append(off)
        if x is not None:
            off += -(-len(x) * dt().itemsize // 16) * 16
    buf = np.empty(max(off, 16), np.uint8)
    for (x, dt), o in zip(parts, offs):
        if x is not None and len(x):
            buf[o:o + len(x) * dt().itemsize].view(dt)[:] = x
    return buf, AdvanceLayout(d, a, int(start), nr, int(run_words[-1]) if nr else 0,
                              rkeys is not None, keys_i32, *offs, len(buf))


def _advance_parts(buf: torch.Tensor, lay: AdvanceLayout):
    """The parts of an advance's buffer as views: (rows, rows_valid,
    rows_keys, slice_keys, slice_valid, runs (2 nr + 1,), run_valid)."""
    kdt = torch.int32 if lay.keys_i32 else torch.int64

    def part(o, n, dt):
        return buf[o:o + n * torch.empty(0, dtype=dt).element_size()].view(dt)

    return (part(lay.o_rows, lay.d, torch.int32), part(lay.o_rvalid, lay.d, torch.bool),
            part(lay.o_rkeys, lay.d if lay.keyed else 0, kdt), part(lay.o_skeys, lay.a, kdt),
            part(lay.o_svalid, lay.a, torch.bool),
            part(lay.o_runs, 2 * lay.nr + 1 if lay.nr else 0, torch.int64),
            part(lay.o_rval, lay.nr, torch.bool))


def slab_advance_plain(keys, valid, buf, lay: AdvanceLayout, sorted_valid=None, inv=None,
                       copy=()):
    """Plain PyTorch version of K11's advance: the slice, then the row list
    (drop mode), then the runs, each validity also at its sorted position
    ``inv[r]`` when ``sorted_valid`` is given; the lanes named in ``copy``
    written as new tensors, the others in place (a lane the advance does not
    write, keys without a slice or keyed rows, is returned as given)."""
    keys = keys.clone() if "keys" in copy and (lay.a or lay.keyed) else keys
    valid = valid.clone() if "valid" in copy else valid
    sv = sorted_valid
    if sv is not None and "sorted_valid" in copy:
        sv = sv.clone()
    cap = valid.shape[0]
    rows, rvalid, rkeys, skeys, svalid, runs, rval = _advance_parts(buf, lay)

    def put(r, v):
        valid[r] = v
        if sv is not None:
            sv[inv[r].long()] = v

    if lay.a:
        s = min(max(lay.start, 0), cap - lay.a)
        keys[s:s + lay.a] = skeys.to(torch.int64)
        valid[s:s + lay.a] = svalid
    if lay.d:
        keep, r = _xla_rows(rows, cap)
        if lay.keyed:
            keys[r[keep]] = rkeys[keep].to(torch.int64)
        put(r[keep], rvalid[keep])
    if lay.nr:
        starts, pre = runs[:lay.nr], runs[lay.nr:]
        counts = pre[1:] - pre[:-1]
        r = (torch.repeat_interleave(starts - pre[:-1], counts)
             + torch.arange(lay.run_rows, device=starts.device))
        v = torch.repeat_interleave(rval, counts)
        ok = (r >= 0) & (r < cap)
        put(r[ok], v[ok])
    return keys, valid, sv


def _advance_call(name: str, dev: torch.device, cap: int, *, keys=0, keys_src=0, valid=0,
                  valid_src=0, sorted_valid=0, sorted_src=0, inv=0, mapped=0, rows=0,
                  rows_valid=0, rows_keys=0, d=0, value=0, start=0, slice_keys=0,
                  slice_valid=0, a=0, runs=0, run_valid=0, nr=0, run_rows=0,
                  keys_i32=0) -> None:
    """One ``dtt_slab_advance`` launch (pointers as ints, 0 for an absent
    part), counted under ``name`` where it launches its kernel."""
    native.call(name, dev, keys, keys_src, valid, valid_src, sorted_valid, sorted_src, inv,
                mapped, cap, rows, rows_valid, rows_keys, d, value, start, slice_keys,
                slice_valid, a, runs, run_valid, nr, run_rows, keys_i32)
    if a + d + run_rows:
        native.launches[name] += 1


def slab_advance(keys: torch.Tensor, valid: torch.Tensor, buf: torch.Tensor,
                 lay: AdvanceLayout, sorted_valid: Optional[torch.Tensor] = None,
                 inv: Optional[torch.Tensor] = None, copy=()):
    """K11: one slab advance in one launch. ``buf`` is :func:`pack_advance`'s
    buffer on the lanes' device (the parts' rows distinct: the host
    resolved them), ``keys`` (cap,) int64, ``valid`` (cap,) bool; with
    ``sorted_valid`` (cap,) bool and ``inv`` (cap,) int32 (only when no key
    changes) each validity written is mirrored at ``inv[r]``. The lanes
    named in ``copy`` are written as new tensors (copied once, then
    written), the others in place. Returns (keys, valid, sorted_valid)."""
    cap = valid.shape[0]
    if keys.dtype != torch.int64 or valid.dtype != torch.bool or buf.dtype != torch.uint8 \
            or valid.dim() != 1 or keys.shape != (cap,) or buf.dim() != 1:
        raise TypeError("slab_advance: keys (cap,) int64, valid (cap,) bool, buf uint8")
    mirror = sorted_valid is not None
    if mirror != (inv is not None) or (mirror and (
            sorted_valid.dtype != torch.bool or inv.dtype != torch.int32
            or sorted_valid.shape != (cap,) or inv.shape != (cap,))):
        raise TypeError("slab_advance: sorted_valid (cap,) bool and inv (cap,) int32 together")
    if mirror and (lay.a or lay.keyed):
        raise ValueError("slab_advance: a key change drops the sorted view, it is not mirrored")
    if lay.nbytes > buf.numel() or lay.a > cap or cap >= 1 << 31:
        raise ValueError(f"slab_advance: a buffer of {buf.numel()} bytes for a layout of "
                         f"{lay.nbytes}, a={lay.a}, cap={cap}")
    ts = (keys, valid, buf) + ((sorted_valid, inv) if mirror else ())
    dev = _same_device("slab_advance", *ts)
    if dev.type == "cpu":
        return slab_advance_plain(keys, valid, buf, lay, sorted_valid, inv, copy)
    _contiguous("slab_advance", *ts)
    k = torch.empty_like(keys) if "keys" in copy and (lay.a or lay.keyed) else keys
    v = torch.empty_like(valid) if "valid" in copy else valid
    sv = torch.empty_like(sorted_valid) if mirror and "sorted_valid" in copy else sorted_valid
    base = buf.data_ptr()
    at = lambda o, n: base + o if n else 0  # noqa: E731
    _advance_call("slab_advance", dev, cap, keys=k.data_ptr(), keys_src=keys.data_ptr(),
                  valid=v.data_ptr(), valid_src=valid.data_ptr(),
                  sorted_valid=sv.data_ptr() if mirror else 0,
                  sorted_src=sorted_valid.data_ptr() if mirror else 0,
                  inv=inv.data_ptr() if mirror else 0, rows=at(lay.o_rows, lay.d),
                  rows_valid=at(lay.o_rvalid, lay.d),
                  rows_keys=at(lay.o_rkeys, lay.d if lay.keyed else 0), d=lay.d,
                  start=lay.start, slice_keys=at(lay.o_skeys, lay.a),
                  slice_valid=at(lay.o_svalid, lay.a), a=lay.a, runs=at(lay.o_runs, lay.nr),
                  run_valid=at(lay.o_rval, lay.nr), nr=lay.nr, run_rows=lay.run_rows,
                  keys_i32=int(lay.keys_i32))
    return k, v, sv


def slab_flip_plain(v: torch.Tensor, rows: torch.Tensor, value: bool) -> torch.Tensor:
    """Plain PyTorch version of K11's ``kill``/``revive``: a copy of ``v``
    with ``rows`` set to ``value`` (XLA drop semantics)."""
    out = v.clone()
    keep, r = _xla_rows(rows, v.shape[0])
    out[r[keep]] = value
    return out


def _flip(name: str, v: torch.Tensor, rows: torch.Tensor, value: bool) -> torch.Tensor:
    if v.dtype != torch.bool or rows.dtype != torch.int32 or v.dim() != 1 or rows.dim() != 1:
        raise TypeError(f"{name}: v must be 1-D bool, rows 1-D int32")
    dev = _same_device(name, v, rows)
    if dev.type == "cpu":
        return slab_flip_plain(v, rows, value)
    _contiguous(name, v, rows)
    out = torch.empty_like(v)
    _advance_call(name, dev, v.shape[0], valid=out.data_ptr(), valid_src=v.data_ptr(),
                  rows=rows.data_ptr(), d=rows.shape[0], value=int(value))
    return out


def slab_kill(v: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """K11 ``kill``: a new lane, ``v`` with ``rows`` False (drop-mode)."""
    return _flip("slab_kill", v, rows, False)


def slab_revive(v: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """K11 ``revive``: a new lane, ``v`` with ``rows`` True (drop-mode)."""
    return _flip("slab_revive", v, rows, True)


def slab_append_plain(keys, valid, rows, nk, nv):
    """Plain PyTorch version of K11's ``append``."""
    k2, v2 = keys.clone(), valid.clone()
    keep, r = _xla_rows(rows, keys.shape[0])
    k2[r[keep]] = nk[keep].to(torch.int64)
    v2[r[keep]] = nv[keep]
    return k2, v2


def slab_append(keys: torch.Tensor, valid: torch.Tensor, rows: torch.Tensor,
                nk: torch.Tensor, nv: torch.Tensor):
    """K11 ``append``: new lanes, ``keys[rows] = nk`` (int32 keys cast up)
    and ``valid[rows] = nv``, drop-mode; rows distinct."""
    a = rows.shape[0]
    if keys.dtype != torch.int64 or valid.dtype != torch.bool or rows.dtype != torch.int32 \
            or nk.dtype not in (torch.int32, torch.int64) or nv.dtype != torch.bool:
        raise TypeError("slab_append: keys int64, valid bool, rows int32, nk int32/int64, nv bool")
    if valid.shape != keys.shape or nk.shape != (a,) or nv.shape != (a,):
        raise ValueError("slab_append: bad shapes")
    dev = _same_device("slab_append", keys, valid, rows, nk, nv)
    if dev.type == "cpu":
        return slab_append_plain(keys, valid, rows, nk, nv)
    _contiguous("slab_append", keys, valid, rows, nk, nv)
    k2, v2 = torch.empty_like(keys), torch.empty_like(valid)
    _advance_call("slab_append", dev, keys.shape[0], keys=k2.data_ptr(), keys_src=keys.data_ptr(),
                  valid=v2.data_ptr(), valid_src=valid.data_ptr(), rows=rows.data_ptr(),
                  rows_valid=nv.data_ptr(), rows_keys=nk.data_ptr(), d=a,
                  keys_i32=int(nk.dtype == torch.int32))
    return k2, v2


def slab_widen_plain(k: torch.Tensor) -> torch.Tensor:
    return k.to(torch.int64)


def slab_widen(k: torch.Tensor) -> torch.Tensor:
    """K11 ``widen``: an int32 lane as int64."""
    if k.dtype != torch.int32 or k.dim() != 1:
        raise TypeError("slab_widen: k must be 1-D int32")
    if k.device.type == "cpu":
        return slab_widen_plain(k)
    _contiguous("slab_widen", k)
    out = torch.empty(k.shape[0], dtype=torch.int64, device=k.device)
    native.call("slab_widen", k.device, k.data_ptr(), out.data_ptr(), k.shape[0])
    native.launches["slab_widen"] += 1
    return out


def slab_map_rows_plain(inv: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    cap = inv.shape[0]
    keep, r = _xla_rows(rows, cap)
    return torch.where(keep, inv[r.clamp(0, cap - 1)], torch.full_like(rows, cap))


def slab_map_rows(inv: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """K11 ``map_rows``: rows to sorted positions through the inverse
    permutation, a negative row counting from the end (as the JAX kernel's
    ``take``); a row still outside [0, cap) maps to cap (the next scatter
    drops it)."""
    if inv.dtype != torch.int32 or rows.dtype != torch.int32 or inv.dim() != 1 \
            or rows.dim() != 1:
        raise TypeError("slab_map_rows: inv and rows must be 1-D int32")
    dev = _same_device("slab_map_rows", inv, rows)
    if dev.type == "cpu":
        return slab_map_rows_plain(inv, rows)
    _contiguous("slab_map_rows", inv, rows)
    out = torch.empty_like(rows)
    _advance_call("slab_map_rows", dev, inv.shape[0], inv=inv.data_ptr(), mapped=out.data_ptr(),
                  rows=rows.data_ptr(), d=rows.shape[0])
    return out


def slab_slice_append_plain(keys, valid, start: int, nk, nv):
    """Plain PyTorch version of K11's ``slice_append``
    (``dynamic_update_slice``: the start clamps so the slice fits)."""
    cap, a = keys.shape[0], nk.shape[0]
    s = min(max(start, 0), cap - a)
    k2, v2 = keys.clone(), valid.clone()
    k2[s:s + a] = nk.to(torch.int64)
    v2[s:s + a] = nv
    return k2, v2


def slab_slice_append(keys: torch.Tensor, valid: torch.Tensor, start: int,
                      nk: torch.Tensor, nv: torch.Tensor):
    """K11 ``slice_append``: new lanes with all ``a`` elements of ``nk``/
    ``nv`` written at ``start`` (clamped to ``[0, cap - a]``)."""
    cap, a = keys.shape[0], nk.shape[0]
    if keys.dtype != torch.int64 or valid.dtype != torch.bool \
            or nk.dtype not in (torch.int32, torch.int64) or nv.dtype != torch.bool:
        raise TypeError("slab_slice_append: keys int64, valid bool, nk int32/int64, nv bool")
    if valid.shape != keys.shape or nv.shape != (a,) or a > cap:
        raise ValueError("slab_slice_append: bad shapes")
    dev = _same_device("slab_slice_append", keys, valid, nk, nv)
    if dev.type == "cpu":
        return slab_slice_append_plain(keys, valid, start, nk, nv)
    _contiguous("slab_slice_append", keys, valid, nk, nv)
    k2, v2 = torch.empty_like(keys), torch.empty_like(valid)
    _advance_call("slab_slice_append", dev, cap, keys=k2.data_ptr(), keys_src=keys.data_ptr(),
                  valid=v2.data_ptr(), valid_src=valid.data_ptr(), start=start,
                  slice_keys=nk.data_ptr(), slice_valid=nv.data_ptr(), a=a,
                  keys_i32=int(nk.dtype == torch.int32))
    return k2, v2


def _decode_head(head: np.ndarray, cap_s: int, m: int):
    """Decode the probe head fetched from the device: (multi, overflow,
    matched_count, s_matched[:m])."""
    multi = bool(head[0])
    overflow = bool(head[1])
    mc = (int(head[2]) | (int(head[3]) << 8) | (int(head[4]) << 16)
          | (int(head[5]) << 24))
    s = np.unpackbits(head[6:6 + cap_s // 8], count=cap_s)[:m].astype(bool)
    return multi, overflow, mc, s


# -- the resident entry -----------------------------------------------------------


def _distinct(parts: List[np.ndarray]) -> np.ndarray:
    """The distinct rows of ``parts``, ascending; one part is taken as it
    is (a deletion vector's flipped rows are distinct and ascending)."""
    if len(parts) < 2:
        return parts[0] if parts else np.empty(0, np.int64)
    r = np.sort(np.concatenate(parts))
    return r[np.concatenate([[True], r[1:] != r[:-1]])]


class ResidentJoinKeys:
    """One table's packed join-key lane, resident on ``device`` with host
    mirrors."""

    def __init__(self, log_path: str, metadata_id: str, version: int,
                 signature: str, key_cols: List[str], device="cuda"):
        self.log_path = log_path
        self.metadata_id = metadata_id
        self.version = version
        self.signature = signature
        self.key_cols = key_cols
        self.device = resolve(device)
        # table rewrite generation at build time (KeyCache.bump_epoch)
        self.epoch = 0
        self.slabs: Dict[str, Tuple[int, int]] = {}  # path -> (offset, rows)
        # path -> (storageType, pathOrInlineDv, cardinality) of the masked DV
        self.dv_tags: Dict[str, Optional[Tuple[str, str, int]]] = {}
        self.h_keys = np.empty(0, np.int64)
        self.h_valid = np.empty(0, bool)
        # immutable per row once appended: key is non-NULL. h_valid is
        # derived: null_ok AND file alive AND not deletion-vector-deleted
        self.h_nullok = np.empty(0, bool)
        # the buffers the three mirrors are views of (keys, valid, null_ok),
        # grown by doubling: a table of thousands of small files (one a
        # partition) appends file by file in amortized O(rows)
        self._h_bufs: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
        # conservative valid-key range, maintained on append (kills and DV
        # masks only shrink the valid set): keeps the per-probe sentinel and
        # narrowing decision O(source)
        self.h_min = np.iinfo(np.int64).max
        self.h_max = np.iinfo(np.int64).min
        self.num_rows = 0
        self.capacity = 1024
        self._dead = 0
        self._dev: Optional[Dict[str, torch.Tensor]] = None
        self._pending = None  # batched device updates (see device_batch)
        # probes whose staging thread may still read the sorted view: an
        # advance then binds a new sorted_valid instead of writing in place
        self._pins = 0
        # True when the sorted view lags the key lane: set by key appends,
        # not by validity flips. The next probe re-sorts once.
        self._sort_stale = True
        self._lock = threading.RLock()
        self.last_used = 0.0

    # -- batched device updates ------------------------------------------
    #
    # A tail advance touches many files; inside a device_batch the mutators
    # queue what they touched (appended ranges, removed files' runs, rows a
    # deletion vector flipped) and the flush issues ONE slab advance.

    def device_batch(self):
        @contextlib.contextmanager
        def batch():
            with self._lock:
                self._pending = {"append": [], "runs": [], "rows": []}
            try:
                yield
            finally:
                self._flush_batch()

        return batch()

    def _flush_batch(self) -> None:
        with self._lock:
            p, self._pending = self._pending, None
            if p is not None:
                self._flush(p)

    def _queue(self, part: str, item) -> None:
        """Queue one touched range or row set for the batch's advance; outside
        a batch, advance the device copy at once."""
        if self._pending is not None:
            self._pending[part].append(item)
        elif self._dev is not None:
            self._flush({"append": [], "runs": [], "rows": [], part: [item]})

    def _flush(self, p) -> None:
        """One slab advance (:func:`slab_advance`) from one upload. Each
        touched row goes once, with its final validity from the mirror
        ``h_valid`` (which the mutators keep exact), so no order between a
        batch's scatters, kills and revives survives to the device: the
        appended rows as one slice with their keys, a removed file as a run,
        a deletion vector's flipped rows as the row list (less those inside
        the slice or a run). A key change drops the sorted view (the next
        probe re-sorts); otherwise its validity is mirrored in the same
        launch, into a new lane when a probe holds it (caller holds the
        entry lock)."""
        dev = self._dev
        if dev is None:
            return  # device copy dropped mid-batch: mirrors re-ship later
        rows = _distinct(p["rows"])
        # files append at num_rows, one after another: one block of rows
        start = p["append"][0][0] if p["append"] else 0
        a = sum(n for _, n in p["append"])
        runs = [(o, n) for o, n in p["runs"] if n]
        if len(rows) and (a or runs):
            keep = (rows < start) | (rows >= start + a)
            for o, n in runs:
                keep &= (rows < o) | (rows >= o + n)
            rows = rows[keep]
        if not (len(rows) or a or runs):
            return
        if a:
            self._sort_stale = True
            for name in ("sorted_keys", "perm", "inv_perm", "sorted_valid"):
                dev.pop(name, None)
        mirror = not self._sort_stale and "sorted_valid" in dev
        buf, lay = pack_advance(
            rows=rows, rows_valid=self.h_valid[rows], start=start,
            slice_keys=self.h_keys[start:start + a], slice_valid=self.h_valid[start:start + a],
            runs=runs, run_valid=[self.h_valid[o] for o, _ in runs])
        dev["keys"], dev["valid"], sv = slab_advance(
            dev["keys"], dev["valid"], self._upload(buf), lay,
            dev["sorted_valid"] if mirror else None, dev["inv_perm"] if mirror else None,
            copy=("sorted_valid",) if self._pins else ())
        if mirror:
            dev["sorted_valid"] = sv

    # -- host-side maintenance -------------------------------------------

    def _append_file(self, path: str, keys: np.ndarray, valid: np.ndarray) -> bool:
        with self._lock:
            n = len(keys)
            if path in self.slabs:
                return False
            self.slabs[path] = (self.num_rows, n)
            self._extend_mirrors(keys, valid)
            if valid.any():
                self.h_min = min(self.h_min, int(keys[valid].min()))
                self.h_max = max(self.h_max, int(keys[valid].max()))
            start = self.num_rows
            self.num_rows += n
            if self.num_rows > self.capacity:
                # regrow: drop the device copy; the next probe re-ships the
                # mirrors. 25% headroom so a steady append stream doesn't
                # cross a bucket every few commits
                self._dev = None
                self.capacity = max(_bucket(int(self.num_rows * 1.25)), 1024)
                return True
            self._queue("append", (start, n))
            return True

    def _extend_mirrors(self, keys: np.ndarray, valid: np.ndarray) -> None:
        """Append rows to the host mirrors (the JAX package concatenates the
        mirrors a file at a time: quadratic over many files)."""
        n0, n = len(self.h_keys), len(keys)
        bufs = self._h_bufs
        if bufs is None or n0 + n > len(bufs[0]) or self.h_keys.base is not bufs[0]:
            cap = max(2 * (n0 + n), 1024)
            bufs = (np.empty(cap, np.int64), np.empty(cap, bool), np.empty(cap, bool))
            for buf, cur in zip(bufs, (self.h_keys, self.h_valid, self.h_nullok)):
                buf[:n0] = cur
            self._h_bufs = bufs
        bufs[0][n0:n0 + n] = keys
        bufs[1][n0:n0 + n] = valid
        bufs[2][n0:n0 + n] = valid
        self.h_keys, self.h_valid, self.h_nullok = (b[:n0 + n] for b in bufs)

    def _kill_file(self, path: str) -> None:
        with self._lock:
            ent = self.slabs.pop(path, None)
            self.dv_tags.pop(path, None)
            if ent is None:
                return
            off, rows = ent
            self.h_valid[off:off + rows] = False
            self._dead += rows
            self._queue("runs", (off, rows))

    def _set_dv(self, path: str, positions: np.ndarray) -> bool:
        """Install a file's deletion-vector state EXACTLY: validity becomes
        null_ok AND NOT deleted (growth, shrink and replacement; the device
        gets only the diff rows). False when the DV disagrees with the slab
        (positions beyond the recorded row count, or no slab): the caller
        must rebuild."""
        with self._lock:
            ent = self.slabs.get(path)
            if ent is None:
                return False
            off, rows = ent
            if len(positions) and int(positions.max()) >= rows:
                return False
            new_valid = self.h_nullok[off:off + rows].copy()
            if len(positions):
                new_valid[positions] = False
            old_valid = self.h_valid[off:off + rows]
            diff = np.nonzero(new_valid != old_valid)[0]
            if len(diff) == 0:
                return True
            self.h_valid[off:off + rows] = new_valid
            self._queue("rows", off + diff)
            return True

    @property
    def garbage_fraction(self) -> float:
        return self._dead / max(self.num_rows, 1)

    # -- device residency -------------------------------------------------

    @property
    def device_bytes(self) -> int:
        # keys(8) + valid(1) + sorted view: sorted_keys(8) + perm(4) +
        # inv_perm(4) + sorted_valid(1)
        return self.capacity * 26

    @property
    def is_resident(self) -> bool:
        return self._dev is not None

    def drop_device(self) -> None:
        with self._lock:
            self._dev = None

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """An advance's buffer on the device, through pinned memory."""
        return _upload(arr, self.device)

    def alloc_device(self) -> None:
        """Pre-size the device lanes without uploading the host mirrors: the
        cold pipeline (:class:`SlabBuilder`) then writes each file's lane as
        it decodes. A failed allocation evicts the cache's other device
        copies and tries once more, then raises. No-op when a device copy
        exists."""
        with self._lock:
            if self._dev is not None:
                return
            try:
                keys = torch.zeros(self.capacity, dtype=torch.int64, device=self.device)
                valid = torch.zeros(self.capacity, dtype=torch.bool, device=self.device)
            except torch.cuda.OutOfMemoryError:
                KeyCache.instance().drop_devices(keep=self)
                keys = torch.zeros(self.capacity, dtype=torch.int64, device=self.device)
                valid = torch.zeros(self.capacity, dtype=torch.bool, device=self.device)
            self._dev = {"keys": keys, "valid": valid}
            self._sort_stale = True

    def ensure_resident(self) -> None:
        """Ship the mirrors to the device, the keys narrowed to int32 when
        every one fits (K11 ``widen`` casts them up there)."""
        with self._lock:
            if self._dev is not None:
                return
            keys = np.zeros(self.capacity, np.int64)
            keys[: self.num_rows] = self.h_keys
            valid = np.zeros(self.capacity, bool)
            valid[: self.num_rows] = self.h_valid
            # invalid/null rows store 0, so a raw min/max scan is the exact
            # narrowing test
            narrow = (self.num_rows == 0 or (
                int(keys.min()) >= np.iinfo(np.int32).min
                and int(keys.max()) <= np.iinfo(np.int32).max))
            up = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
            dk = slab_widen(up(keys.astype(np.int32))) if narrow else up(keys)
            dv = up(valid)
            self._dev = {"keys": dk, "valid": dv}
            self._sort_stale = True

    def _ensure_sorted(self) -> None:
        """Sort the slab (K8) if the sorted view is stale (caller holds the
        entry lock)."""
        if self._dev is None:
            return
        if not self._sort_stale and "sorted_keys" in self._dev:
            return
        sk, pm, inv, sv = slab_sort(self._dev["keys"], self._dev["valid"], self.num_rows)
        self._dev["sorted_keys"] = sk
        self._dev["perm"] = pm
        self._dev["inv_perm"] = inv
        self._dev["sorted_valid"] = sv
        self._sort_stale = False

    # -- probing ----------------------------------------------------------

    def probe_async(self, s_keys: np.ndarray, s_ok: np.ndarray,
                    expected_version: Optional[int] = None,
                    insert_only: bool = False) -> Optional[PendingProbe]:
        """Membership probe of the source keys against the resident slab,
        fused with the pairing: K9 emits each matched slab row's first
        source row and K10 compacts the pairs in physical order, so the
        finalize downloads O(matched) and sorts nothing. None when no sentinel value exists (the valid keys span
        int64) or the slab is not at ``expected_version``.

        ``insert_only``: only the per-source flags are fetched (the head).

        The device pipeline runs on a staging thread over the sorted view
        taken here, with a pin on the entry until its last download: a
        concurrent advance then binds a new ``sorted_valid`` and never
        changes these."""
        with self._lock:
            if expected_version is not None and self.version != expected_version:
                return None
            n = self.num_rows
            if n == 0:
                m = len(s_keys)
                slabs = dict(self.slabs)
                empty = np.empty(0, np.int64)
                return PendingProbe(lambda: PhysicalProbe(
                    np.zeros(m, bool), False, slabs, 0, (empty, empty)))
            s_key64 = np.ascontiguousarray(s_keys, np.int64)
            s_okb = np.asarray(s_ok, bool)
            # the slab's valid range is kept incrementally (a superset), so
            # only the source is scanned here. Narrow the source upload to
            # int32 when every valid key fits: the sentinel then lives in
            # int32 space
            lo = min(self.h_min, int(np.min(s_key64, where=s_okb, initial=2**62)))
            hi = max(self.h_max, int(np.max(s_key64, where=s_okb, initial=-2**62)))
            i32, i64 = np.iinfo(np.int32), np.iinfo(np.int64)
            if lo >= i32.min + 2 and hi <= i32.max - 2:
                dtype, s_sent = np.int32, i32.max - 1
            elif hi <= i64.max - 2:
                dtype, s_sent = np.int64, i64.max - 1
            elif lo >= i64.min + 2:
                dtype, s_sent = np.int64, i64.min + 1
            else:
                return None  # valid keys span int64: no sentinel room
            s_enc = np.where(s_okb, s_key64, s_sent).astype(dtype)
            self.ensure_resident()
            self._ensure_sorted()
            # pin this version's sorted view: until the staging thread's
            # last download, an advance binds a new sorted_valid rather than
            # write these (keys only change through a re-sort into new ones)
            dev = {"sorted_keys": self._dev["sorted_keys"],
                   "sorted_valid": self._dev["sorted_valid"],
                   "perm": self._dev["perm"]}
            slabs = dict(self.slabs)
            device = self.device
            self._pins += 1
        m = len(s_enc)
        cap_s = _bucket(m)
        s_in = np.full(cap_s, s_sent, s_enc.dtype)
        s_in[:m] = s_enc
        state: dict = {}

        def unpin():
            with self._lock:
                self._pins -= 1

        def launch():
            # the whole device pipeline runs on this thread, so the caller
            # overlaps it with host work; finalize joins and fetches pairs.
            # The downloads wait for K9 and K10: no kernel reads the pinned
            # view once they are done
            try:
                ctx = torch.cuda.device(device) if device.type == "cuda" \
                    else contextlib.nullcontext()
                with ctx:
                    head_dev, t_match_dev, s_first_dev = slab_probe(
                        dev["sorted_keys"], dev["sorted_valid"], n,
                        torch.from_numpy(s_in).to(device))
                    head = head_dev.cpu().numpy()  # waits for the kernel
                    state["head"] = head
                    _multi, _overflow, mc, _s = _decode_head(head, cap_s, m)
                    if insert_only or mc == 0:
                        return
                    # in physical order, downloaded and checked against mc
                    state["pairs"] = fetch_pairs(t_match_dev, s_first_dev, dev["perm"], mc)
            except BaseException as e:
                state["err"] = e
            finally:
                unpin()

        th = threading.Thread(target=launch, daemon=True, name="delta-merge-device-probe")
        try:
            th.start()
        except BaseException:
            unpin()
            raise

        def finalize() -> PhysicalProbe:
            th.join()
            if "err" in state:
                raise state["err"]
            multi, overflow, mc, s = _decode_head(state["head"], cap_s, m)
            if overflow:
                raise RuntimeError("slab_probe reported an overflow, which it never does")
            if insert_only:
                return PhysicalProbe(s, multi, slabs, n, None)
            if mc == 0:
                empty = np.empty(0, np.int64)
                return PhysicalProbe(s, multi, slabs, n, (empty, empty))
            pairs = state["pairs"].numpy()  # K10 put them in physical order
            return PhysicalProbe(s, multi, slabs, n, (pairs[:mc].astype(np.int64),
                                                      pairs[mc:2 * mc].astype(np.int64)))

        return PendingProbe(finalize)


# -- building / advancing ---------------------------------------------------------


def _abs_data_path(data_path: str, path: str) -> str:
    if "://" in path or os.path.isabs(path):
        return urllib.parse.unquote(path)
    return os.path.join(data_path, urllib.parse.unquote(path).replace("/", os.sep))


#: the stored bytes of the files whose key columns inflate in one batch
_KEY_BATCH_BYTES = 64 << 20


def _files_keys(data_path: str, adds, key_cols: List[str], exprs,
                device) -> Optional[Dict[str, Tuple[np.ndarray, np.ndarray]]]:
    """The packed target key lane over each file's PHYSICAL rows (no DV
    filtering; DV positions are masked invalid separately),
    ``{path: (keys, valid)}``, their pages in batches of up to
    ``_KEY_BATCH_BYTES`` stored bytes on ``device`` (one launch set a batch,
    not a file). None where any file is missing, lacks a key column or has
    an unpackable lane, as the JAX package's ``_file_keys`` is None for it;
    the codec's ``NotImplementedError`` and a failing page codec kernel's
    ``RuntimeError`` propagate."""
    from delta_tpu_torch.exec.parquet import column_names, read_metadata, read_parquet_batch
    from delta_tpu_torch.expr.vectorized import evaluate

    out: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    reads: list = []
    paths: List[str] = []

    def flush() -> bool:
        try:
            tabs = read_parquet_batch(reads, device)
        except (OSError, ValueError):
            return False
        for path, tab in zip(paths, tabs):
            kv = _pack_lanes(tab, exprs, evaluate)
            if kv is None:
                return False
            out[path] = kv
        reads.clear()
        paths.clear()
        return True

    size = 0
    for add in adds:
        abs_path = _abs_data_path(data_path, add.path)
        try:
            meta = read_metadata(abs_path)
        except (OSError, ValueError):
            return None
        names = column_names(meta)
        present = [c for c in key_cols if c in names]
        if len(present) != len(key_cols):
            return None
        reads.append((abs_path, present, None, meta))
        paths.append(add.path)
        size += sum(int(rg.total_compressed_size or 0) for rg in meta.row_groups or [])
        if size >= _KEY_BATCH_BYTES:
            if not flush():
                return None
            size = 0
    if reads and not flush():
        return None
    return out


def _pack_lanes(tab, exprs, evaluate) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(keys int64, valid) of the key expressions over ``tab`` (a
    ``HostTable``): one integer lane, or two packed ``hi<<32 | lo`` when
    both fit int32. None where a lane is not an integer."""
    lanes = []
    for e in exprs:
        try:
            vals = evaluate(e, tab)
        except Exception:
            return None
        if vals.kind != "int":
            return None
        valid = np.asarray(vals.valid, bool).copy()
        keys = np.where(valid, vals.values, 0).astype(np.int64)
        lanes.append((keys, valid))
    if len(lanes) == 1:
        return lanes[0]
    if len(lanes) != 2:
        return None
    i32 = np.iinfo(np.int32)
    (k0, v0), (k1, v1) = lanes
    ok = v0 & v1
    if (np.min(k0, where=ok, initial=0) < i32.min
            or np.max(k0, where=ok, initial=0) > i32.max
            or np.min(k1, where=ok, initial=0) < i32.min
            or np.max(k1, where=ok, initial=0) > i32.max):
        return None
    return (k0 << 32) | (k1 & 0xFFFFFFFF), ok


def _dv_tag(dv_dict) -> Optional[Tuple[str, str, int]]:
    if not dv_dict:
        return None
    return (dv_dict.get("storageType"), dv_dict.get("pathOrInlineDv"),
            int(dv_dict.get("cardinality", -1)))


def _dv_positions(dv_dict, data_path: str) -> Optional[np.ndarray]:
    from delta_tpu_torch.protocol.deletion_vectors import (
        DeletionVectorDescriptor, read_deletion_vector,
    )

    try:
        return read_deletion_vector(
            DeletionVectorDescriptor.from_dict(dv_dict), data_path)
    except Exception:
        return None


class SlabBuilder:
    """Streamed cold build of a :class:`ResidentJoinKeys` slab from per-file
    decoded key tables: the upload leg of the MERGE command's cold pipeline
    (``commands/merge``). Files arrive in decode-completion order; each
    file's packed lane lands on a pre-sized device slab.

    The slab is in PHYSICAL row order per file though the decode arrives
    deletion-vector filtered: each file's physical row count comes from its
    AddFile stats (``numRecords`` is physical as the engine writes it), or
    from its Parquet footer when it carries a deletion vector or no stats."""

    def __init__(self, log_path: str, metadata_id: str, version: int, signature: str,
                 key_cols: List[str], exprs, data_path: str, files, device="cuda",
                 epoch: int = 0):
        self.exprs = list(exprs)
        self.data_path = data_path
        self.failed: Optional[str] = None
        self._phys: Dict[str, int] = {}
        total = 0
        for add in files:
            nrec = add.num_logical_records
            if add.deletion_vector is not None or nrec is None:
                n = self._footer_rows(add)
                if n is None:
                    self.failed = f"no physical row count for {add.path}"
                    break
            else:
                n = int(nrec)
            self._phys[add.path] = n
            total += n
        entry = ResidentJoinKeys(log_path, metadata_id, version, signature, list(key_cols),
                                 device=device)
        entry.epoch = epoch
        entry.capacity = max(_bucket(max(total, 1)), 1024)
        self.entry = entry

    def _footer_rows(self, add) -> Optional[int]:
        from delta_tpu_torch.exec.parquet import read_metadata

        try:
            return int(read_metadata(_abs_data_path(self.data_path, add.path)).num_rows)
        except OSError:
            return None

    def add_file(self, add, table, positions: Optional[np.ndarray]) -> bool:
        """Pack one decoded file's key lane and append it to the slab on the
        device. ``positions`` are the decoded rows' physical positions (None
        when the decode was not DV-filtered). A lane that cannot be packed,
        or rows that disagree with the recorded physical count, fail the
        build (the caller takes another route)."""
        if self.failed is not None:
            return False
        from delta_tpu_torch.expr.vectorized import evaluate

        phys = self._phys.get(add.path)
        packed = _pack_lanes(table, self.exprs, evaluate)
        if phys is None or packed is None:
            self.failed = f"unpackable key lane for {add.path}"
            return False
        keys, valid = packed
        if positions is None:
            if len(keys) != phys:
                self.failed = f"row count mismatch for {add.path}"
                return False
            full_k = np.ascontiguousarray(keys, np.int64)
            full_v = np.asarray(valid, bool)
        else:
            if len(positions) != len(keys) or (len(positions) and int(positions[-1]) >= phys):
                self.failed = f"position/physical mismatch for {add.path}"
                return False
            full_k = np.zeros(phys, np.int64)
            full_v = np.zeros(phys, bool)
            full_k[positions] = keys
            full_v[positions] = valid
        e = self.entry
        e.alloc_device()
        if not e._append_file(add.path, full_k, full_v):
            self.failed = f"duplicate file {add.path}"
            return False
        e.dv_tags[add.path] = _dv_tag(add.deletion_vector)
        return True

    def finish(self, expected_files: int) -> Optional[ResidentJoinKeys]:
        if self.failed is not None or len(self.entry.slabs) != expected_files:
            return None
        return self.entry


class KeyCache:
    """Process-wide registry of resident join-key lanes, keyed by (log path,
    signature, device). Registry lock for lookups, per-entry build locks
    for the slow work."""

    _instance: Optional["KeyCache"] = None
    _instance_lock = threading.Lock()

    def __init__(self):
        self._entries: Dict[Tuple[str, str, str], ResidentJoinKeys] = {}
        self._build_locks: Dict[Tuple[str, str, str], threading.Lock] = {}
        self._lock = threading.RLock()
        self._tick = 0
        # per-table rewrite generation (bump_epoch): entries built under an
        # older epoch are never served or cached
        self._epochs: Dict[str, int] = {}
        # the exception of the last post-commit warmup (warm), None when it
        # built or had nothing to do
        self.last_build_error: Optional[BaseException] = None
        self._warmups: List[threading.Thread] = []

    @classmethod
    def instance(cls) -> "KeyCache":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = KeyCache()
            return cls._instance

    @classmethod
    def reset(cls) -> None:
        with cls._instance_lock:
            cls._instance = None

    def epoch(self, log_path: str) -> int:
        with self._lock:
            return self._epochs.get(log_path, 0)

    def bump_epoch(self, log_path: str) -> None:
        """File-rewrite invalidation (OPTIMIZE / UPDATE-rewrite / RESTORE):
        drop the table's entries outright. In-flight holders of a dropped
        entry fail their version guard: the version is poisoned first."""
        with self._lock:
            self._epochs[log_path] = self._epochs.get(log_path, 0) + 1
            for k in [k for k in self._entries if k[0] == log_path]:
                e = self._entries.pop(k)
                e.version = _POISON_VERSION
                self._build_locks.pop(k, None)
                e.drop_device()

    def register(self, entry: ResidentJoinKeys) -> bool:
        """Adopt a slab the MERGE cold pipeline built (:class:`SlabBuilder`)
        so later MERGEs against the table probe it. Refused when the table's
        epoch moved during the build or a newer entry holds the key; the
        caller's probe of the entry stays valid either way."""
        if not key_cache_enabled():
            return False
        key = (entry.log_path, entry.signature, str(entry.device))
        with self._lock:
            if entry.epoch != self._epochs.get(entry.log_path, 0):
                return False
            cur = self._entries.get(key)
            if cur is not None and cur.version >= entry.version:
                return False
            self._tick += 1
            entry.last_used = self._tick
            self._entries[key] = entry
            self._build_locks.setdefault(key, threading.Lock())
        self._evict(keep=key)
        return True

    def warm(self, log, signature: str, key_cols: List[str], exprs, min_rows: int) -> None:
        """The post-commit warmup: on a thread of its own, bring the table's
        key lane to its latest version and onto the device, so the next
        MERGE probes it. Never blocks the caller; an exception is stored in
        :attr:`last_build_error`, not swallowed. :meth:`wait_warmups` joins."""

        def build():
            try:
                snap = log.update()
                est = sum(f.num_logical_records or 0 for f in snap.all_files)
                if est < min_rows:
                    return
                e = self.get(snap, signature, key_cols, exprs, build_if_missing=True)
                if e is not None:
                    with e._lock:
                        e.ensure_resident()
                        e._ensure_sorted()
                    if e.device.type == "cuda":
                        torch.cuda.synchronize(e.device)
            except Exception as exc:  # stored for the caller, see above
                self.last_build_error = exc

        th = threading.Thread(target=build, daemon=True, name="delta-merge-keys-build")
        with self._lock:
            self._warmups = [t for t in self._warmups if t.is_alive()] + [th]
        th.start()

    def wait_warmups(self, timeout: Optional[float] = None) -> bool:
        """Join every post-commit warmup still running; False when one is
        still running after ``timeout`` seconds."""
        with self._lock:
            pending = list(self._warmups)
        for th in pending:
            th.join(timeout)
        return not any(th.is_alive() for th in pending)

    def drop_devices(self, keep=None) -> None:
        """Drop the device copy of every entry but ``keep`` (the host
        mirrors stay; a later probe re-ships them)."""
        with self._lock:
            for e in self._entries.values():
                if e is not keep:
                    e.drop_device()

    def peek(self, log_path: str, signature: str, device="cuda") -> Optional[ResidentJoinKeys]:
        with self._lock:
            return self._entries.get((log_path, signature, str(resolve(device))))

    def _usable(self, e, snapshot, cur_epoch) -> bool:
        return not (e.metadata_id != snapshot.metadata.id or e.version > snapshot.version
                    or e.epoch != cur_epoch)

    def get(self, snapshot, signature: str, key_cols: List[str],
            exprs, build_if_missing: bool = True) -> Optional[ResidentJoinKeys]:
        """Entry current at the snapshot's version on the snapshot's device,
        advancing incrementally through the log tail (appending new files'
        keys, killing removed files, masking DV changes), or built cold.
        ``build_if_missing=False`` only serves or advances an existing
        entry."""
        log_path = snapshot.delta_log.log_path
        device = snapshot.delta_log.device
        key = (log_path, signature, str(device))
        with self._lock:
            self._tick += 1
            tick = self._tick
            cur_epoch = self._epochs.get(log_path, 0)
            build_lock = self._build_locks.setdefault(key, threading.Lock())
            e = self._entries.get(key)
        if e is not None and not self._usable(e, snapshot, cur_epoch):
            e = None
        if e is not None and e.version == snapshot.version:
            e.last_used = tick
            return e
        if e is None and not build_if_missing:
            return None
        with build_lock:
            with self._lock:
                cur_epoch = self._epochs.get(log_path, 0)
                e = self._entries.get(key)
            if e is not None and not self._usable(e, snapshot, cur_epoch):
                e = None
            if e is not None and e.version == snapshot.version:
                e.last_used = tick
                return e
            if e is not None and not self._advance(e, snapshot, key_cols, exprs):
                # a failed advance may have half-applied its tail: the entry
                # must not stay visible at its (stale) version
                with self._lock:
                    if self._entries.get(key) is e:
                        self._entries.pop(key, None)
                e = None
            if e is None:
                if not build_if_missing:
                    return None
                e = self._build(snapshot, signature, key_cols, exprs, epoch=cur_epoch)
                if e is None:
                    return None
                with self._lock:
                    # a rewrite may have raced the build: the entry stays
                    # exact for the caller's snapshot, but is only CACHED
                    # when the epoch still matches
                    if self._epochs.get(log_path, 0) == cur_epoch:
                        self._entries[key] = e
            e.last_used = tick
            self._evict(keep=key)
            return e

    def _build(self, snapshot, signature, key_cols, exprs,
               epoch: int = 0) -> Optional[ResidentJoinKeys]:
        e = ResidentJoinKeys(snapshot.delta_log.log_path, snapshot.metadata.id,
                             snapshot.version, signature, list(key_cols),
                             device=snapshot.delta_log.device)
        e.epoch = epoch
        data_path = snapshot.delta_log.data_path
        files = snapshot.all_files
        kvs = _files_keys(data_path, files, key_cols, exprs, snapshot.delta_log.device)
        if kvs is None:
            return None
        for add in files:
            keys, valid = kvs[add.path]
            e._append_file(add.path, keys, valid)
            if add.deletion_vector is not None:
                pos = _dv_positions(add.deletion_vector, data_path)
                if pos is None:
                    return None
                if not e._set_dv(add.path, pos):
                    return None
                e.dv_tags[add.path] = _dv_tag(add.deletion_vector)
        return e

    def _advance(self, e: ResidentJoinKeys, snapshot, key_cols, exprs) -> bool:
        """Apply the log tail (e.version, snapshot.version]."""
        from delta_tpu_torch.log.columnar import decode_segment
        from delta_tpu_torch.protocol import filenames
        from delta_tpu_torch.protocol.actions import AddFile, Metadata, RemoveFile

        if e.garbage_fraction > 0.5 and e.num_rows > 1 << 20:
            return False  # too much garbage: a rebuild compacts
        log = snapshot.delta_log
        paths = [f"{log.log_path}/{filenames.delta_file(v)}"
                 for v in range(e.version + 1, snapshot.version + 1)]
        try:
            cols = decode_segment(log.store, [], paths)
        except Exception:
            return False
        if any(isinstance(a, Metadata) for a in cols.other_actions):
            return False
        actions = cols.materialize(cols.winner_mask())
        data_path = log.data_path
        # hold the ENTRY lock across the whole application and the version
        # bump: a concurrent probe sees the slab fully at its version or
        # fully past it
        with e._lock, e.device_batch():
            # poison a half-applied tail before releasing the lock, on a
            # clean failure and on an exception alike
            ok = False
            try:
                fresh = _files_keys(data_path, [a for a in actions if isinstance(a, AddFile)
                                                and a.path not in e.slabs], key_cols, exprs,
                                    log.device)
                if fresh is None:
                    return False
                for a in actions:
                    if isinstance(a, RemoveFile):
                        e._kill_file(a.path)
                    elif isinstance(a, AddFile):
                        if a.path not in e.slabs:
                            if not e._append_file(a.path, *fresh[a.path]):
                                return False
                        # re-adds keep their keys (physical rows are
                        # immutable); only the DV validity may change
                        new_tag = _dv_tag(a.deletion_vector)
                        if e.dv_tags.get(a.path) != new_tag:
                            if a.deletion_vector is not None:
                                pos = _dv_positions(a.deletion_vector, data_path)
                                if pos is None:
                                    return False
                            else:
                                pos = np.empty(0, np.int64)
                            if not e._set_dv(a.path, pos):
                                return False
                            e.dv_tags[a.path] = new_tag
                ok = True
                return True
            finally:
                e.version = snapshot.version if ok else _POISON_VERSION

    def _evict(self, keep) -> None:
        with self._lock:
            resident = [(k, e) for k, e in self._entries.items() if e.is_resident]
            total = sum(e.device_bytes for _, e in resident)
            for k, e in sorted(resident, key=lambda kv: kv[1].last_used):
                if total <= MAX_DEVICE_BYTES:
                    break
                if k == keep:
                    continue
                e.drop_device()
                total -= e.device_bytes
            if len(self._entries) > MAX_ENTRIES:
                for k, e in sorted(self._entries.items(), key=lambda kv: kv[1].last_used):
                    if k == keep:
                        continue
                    self._entries.pop(k, None)
                    self._build_locks.pop(k, None)
                    e.drop_device()
                    if len(self._entries) <= MAX_ENTRIES:
                        break

"""The MERGE join (the port's own copy of ``delta_tpu.ops.join_kernel``):
the upload join on one card (K12) or over the state mesh (K13), the host
joins, and the ``PendingJoin``/``JoinResult`` contract every executor
returns.

* :func:`inner_join_async` is the upload route: integer target and source
  keys (int64 values plus validity) are narrowed to int32 when both sides
  fit with a margin of 2, NULLs and pads become per-side sentinels
  (:func:`_sentinel_encode`, so invalid never matches anything), both sides
  are padded to :func:`_bucket` sizes, uploaded, and K12 (:func:`join_probe`,
  ``csrc/join_probe.cu``) returns the packed per-target and per-source
  match bits and the multi-match flag. The pairing (each matched target
  row's first source row) is recovered on the host
  (:func:`_first_match_recovery`), as in the JAX package. When the valid
  keys leave no sentinel room, the numpy sort-merge :func:`_host_join`
  gives the same result.
* :func:`host_equi_join` is the host join of the MERGE command's other
  shapes (any key type, any number of keys): factorized keys, a sort-merge,
  every pair, NULL never matching NULL.

K12 replaces ``_single_device_kernel`` (``join_kernel.py:127``): it builds
an open-addressing hash table of the source on the card and probes it with
every target key, where the TPU kernel sorts both sides. Its plain PyTorch
version :func:`join_probe_plain` (the TPU kernel's ``torch.sort`` +
``torch.searchsorted``) is what the wrapper runs for tensors on the CPU; for
a CUDA tensor it launches the kernel or raises. The launch runs on a staging
thread (the caller overlaps it with the full-column decode), on that
thread's current stream: the thread records a CUDA event after the launch
and its downloads are blocking copies, and the finalize joins the thread and
waits on the event, so no result is read before the card wrote it. Under
``devicePath.mode=auto`` the MERGE command passes a ``budget_s`` (the host
join's price): the link cost model (``parallel/link.estimate_device_s``)
prices the upload, K12 and the download, and the launch is declined (None)
when it costs more, or when the keys leave no sentinel room.

With a ``mesh`` of more than one entry (``parallel/mesh``; the MERGE
command passes the default mesh when it has several), the upload join runs
K13 (:func:`sharded_join_probe`, ``csrc/join_probe.cu``'s second entry
point), which replaces ``_sharded_kernel`` (``join_kernel.py:150``): the
target is split into contiguous slabs of ``cap_t / p``
(``cap_t = _bucket(ceil(n / p)) * p``), the padded source (``cap_s =
_bucket(ceil(m / p)) * p``) is uploaded in p pieces and all-gathered in its
original order on each distinct device, one launch a distinct device builds
the source's hash table there and probes all of that device's slabs against
it, its hits packed, and one combine launch ORs the devices' packed hits
and multi flags on the lead device (none where one device holds every
shard). A mesh of one entry takes K12, as the JAX package does.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from delta_tpu_torch.ops import native

__all__ = ["JoinResult", "PendingJoin", "inner_join", "inner_join_async", "join_probe",
           "join_probe_plain", "sharded_join_probe", "sharded_join_probe_plain",
           "host_equi_join"]


class JoinResult(NamedTuple):
    """Per-row join outcome (host numpy, unpadded)."""

    t_first_s: np.ndarray  # int64 per target row: first matching source row, -1 = no match
    s_matched: np.ndarray  # bool per source row: has at least one target match
    any_multi: bool  # some target row matched more than one source row

    @property
    def t_matched(self) -> np.ndarray:
        return self.t_first_s >= 0


class PendingJoin:
    """Handle for an in-flight device join; ``.result()`` blocks on the
    device->host transfer and finishes the host side once."""

    def __init__(self, finalize: Callable[[], object]):
        self._finalize = finalize
        self._result: Optional[object] = None

    def result(self):
        if self._result is None:
            self._result = self._finalize()
        return self._result


def _bucket(n: int) -> int:
    """Pad size: pow2 up to 4M (few distinct shapes), then 2M granularity
    (padding a 10M-row slab to 16.7M would ship 67% more bytes just to save
    a shape)."""
    p = 8
    while p < n:
        p *= 2
        if p >= 4_194_304:
            break
    if n <= p <= 4_194_304:
        return p
    g = 2_097_152
    return ((n + g - 1) // g) * g


# -- K12 and its plain version ------------------------------------------------------


def join_probe_plain(t: torch.Tensor, s: torch.Tensor):
    """Plain PyTorch version of K12, the TPU kernel's own formulation: sort
    both sides, count with two-way searchsorted. Returns (t_bits uint8
    ``(cap_t/8,)``, s_bits uint8 ``(cap_s/8,)``, multi bool ``(1,)``)."""
    from delta_tpu_torch.ops.state_cache import _packbits

    s_sorted = torch.sort(s).values
    t_sorted = torch.sort(t).values
    count = (torch.searchsorted(s_sorted, t, right=True) - torch.searchsorted(s_sorted, t))
    s_count = (torch.searchsorted(t_sorted, s, right=True) - torch.searchsorted(t_sorted, s))
    return _packbits(count > 0), _packbits(s_count > 0), (count > 1).any().reshape(1)


def _join_scratch_bytes(cap_s: int, itemsize: int) -> int:
    """K12's and K13's scratch (``csrc/join_probe.cu``): the hash table, the
    power of two at least ``2 cap_s`` slots of 8 bytes (int32 keys) or 16
    (int64), then the marker and multi words."""
    from delta_tpu_torch.ops.key_cache import _aligned

    slots = 16
    while slots < 2 * cap_s:
        slots *= 2
    return _aligned(slots * (8 if itemsize == 4 else 16)) + 256


def _aligned16(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def join_probe(t: torch.Tensor, s: torch.Tensor):
    """K12: the membership probe of the padded target keys ``t`` against the
    padded source keys ``s`` (1-D, both int32 or both int64, lengths
    multiples of 8, ``s`` at least 8). Returns (t_bits, s_bits, multi) as
    :func:`join_probe_plain` defines them."""
    if t.dtype not in (torch.int32, torch.int64) or s.dtype != t.dtype or t.dim() != 1 \
            or s.dim() != 1:
        raise TypeError("join_probe: t and s must be 1-D, both int32 or both int64")
    cap_t, cap_s = t.shape[0], s.shape[0]
    if cap_t % 8 or cap_s % 8 or cap_s < 8 or cap_s >= 1 << 31:
        raise ValueError(f"join_probe: bad sizes cap_t={cap_t} cap_s={cap_s}")
    if t.device != s.device:
        raise ValueError("join_probe: t and s must be on one device")
    dev = t.device
    if dev.type == "cpu":
        return join_probe_plain(t, s)
    if not (t.is_contiguous() and s.is_contiguous() and _aligned16(t, s)):
        raise ValueError("join_probe: tensors must be contiguous and 16-byte aligned")
    t_bits = torch.empty(cap_t // 8, dtype=torch.uint8, device=dev)
    s_bits = torch.empty(cap_s // 8, dtype=torch.uint8, device=dev)
    multi = torch.empty(1, dtype=torch.uint8, device=dev)
    nbytes = _join_scratch_bytes(cap_s, t.element_size())
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    native.call("join_probe", dev, t.data_ptr(), cap_t, s.data_ptr(), cap_s,
                1 if t.dtype == torch.int32 else 0, t_bits.data_ptr(), s_bits.data_ptr(),
                multi.data_ptr(), scratch.data_ptr(), nbytes)
    native.launches["join_probe"] += 1
    return t_bits, s_bits, multi.view(torch.bool)


# -- K13 and its plain version ------------------------------------------------------


def sharded_join_probe_plain(t_slabs, s_full):
    """Plain PyTorch version of K13, the TPU kernel's own formulation per
    shard (sort the gathered source and the slab, two-way searchsorted),
    then the reductions: returns (t_bits ``(cap_t/8,)`` with the shards'
    packed bits in shard order, s_bits ``(cap_s/8,)`` the packed OR of the
    shards' source hits, multi bool ``(1,)``)."""
    from delta_tpu_torch.ops.state_cache import _packbits

    s_sorted = torch.sort(s_full).values
    t_bits, s_hits, multi = [], [], []
    for t in t_slabs:
        t = t.to(s_full.device)
        count = torch.searchsorted(s_sorted, t, right=True) - torch.searchsorted(s_sorted, t)
        t_sorted = torch.sort(t).values
        s_count = (torch.searchsorted(t_sorted, s_full, right=True)
                   - torch.searchsorted(t_sorted, s_full))
        t_bits.append(_packbits(count > 0))
        s_hits.append(s_count > 0)
        multi.append((count > 1).any())
    return (torch.cat(t_bits), _packbits(torch.stack(s_hits).any(dim=0)),
            torch.stack(multi).any().reshape(1))


def sharded_join_probe(t_slabs, s_parts):
    """K13: the membership probe of target slabs against a source split in
    pieces, one (slab, piece) pair a shard on that shard's device (1-D, all
    int32 or all int64, slab and piece lengths multiples of 8, the pieces
    of one length). The pieces are all-gathered, in order, once on each
    distinct device; one launch a distinct device builds the source's hash
    table there and probes all that device's slabs against it (at most 64);
    the lead device (the first slab's) gathers the packed target bits in
    shard order and reduces the devices' source hits and multi flags with
    one combine launch (each device packs its own hits; none where one
    device holds every shard). Returns (t_bits, s_bits, multi) as
    :func:`join_probe` would on the concatenated slabs and the concatenated
    source. The plain version for tensors on the CPU; on the card the
    kernel, or an error."""
    from delta_tpu_torch.parallel import mesh as mesh_mod

    if len(t_slabs) != len(s_parts) or not t_slabs:
        raise ValueError("sharded_join_probe: one target slab and one source piece a shard")
    dt = t_slabs[0].dtype
    if dt not in (torch.int32, torch.int64) or any(
            x.dtype != dt or x.dim() != 1 for x in (*t_slabs, *s_parts)):
        raise TypeError("sharded_join_probe: slabs and pieces must be 1-D, all int32 or "
                        "all int64")
    if any(t.device != s.device for t, s in zip(t_slabs, s_parts)):
        raise ValueError("sharded_join_probe: a shard's slab and piece must be on one device")
    cap_s = sum(s.shape[0] for s in s_parts)
    if (any(t.shape[0] % 8 for t in t_slabs) or any(s.shape[0] != s_parts[0].shape[0]
                                                    for s in s_parts)
            or cap_s % 8 or cap_s < 8 or cap_s >= 1 << 31):
        raise ValueError(f"sharded_join_probe: bad sizes {[t.shape[0] for t in t_slabs]} / "
                         f"{[s.shape[0] for s in s_parts]}")
    mesh = [t.device for t in t_slabs]
    lead = mesh[0]
    if all(d.type == "cpu" for d in mesh):
        return sharded_join_probe_plain(t_slabs, mesh_mod.all_gather(s_parts, lead))
    if any(d.type != "cuda" for d in mesh):
        raise ValueError("sharded_join_probe: the shards must all be on the card, or all "
                         "on the CPU")
    if not all(x.is_contiguous() for x in (*t_slabs, *s_parts)) or not _aligned16(*t_slabs):
        raise ValueError("sharded_join_probe: tensors must be contiguous, the slabs 16-byte "
                         "aligned")
    devices = list(dict.fromkeys(mesh))
    shards_of = {d: [i for i, m in enumerate(mesh) if m == d] for d in devices}
    if max(len(v) for v in shards_of.values()) > 64:
        raise ValueError("sharded_join_probe: more than 64 slabs on one device")
    nbytes = _join_scratch_bytes(cap_s, t_slabs[0].element_size())
    is32 = 1 if dt == torch.int32 else 0
    def launch(_k, dev):
        # the tiled all-gather: the whole source once on this device
        s = mesh_mod.all_gather(s_parts, dev)
        slabs = [t_slabs[i] for i in shards_of[dev]]
        t_bits = torch.empty(sum(t.shape[0] for t in slabs) // 8, dtype=torch.uint8,
                             device=dev)
        s_bits = torch.empty(cap_s // 8, dtype=torch.uint8, device=dev)
        multi = torch.empty(1, dtype=torch.uint8, device=dev)
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        ptrs = np.array([t.data_ptr() for t in slabs], np.uint64)
        keys = np.array([t.shape[0] for t in slabs], np.int64)
        native.call("sharded_join_probe", dev, ptrs.ctypes.data, keys.ctypes.data, len(slabs),
                    s.data_ptr(), cap_s, is32, t_bits.data_ptr(), s_bits.data_ptr(),
                    multi.data_ptr(), scratch.data_ptr(), nbytes)
        native.launches["sharded_join_probe"] += 1
        return t_bits, s_bits, multi

    outs = mesh_mod.run_shards(devices, launch)
    if len(devices) == 1:  # its launch is the whole reduction, the bits in shard order
        t_bits, s_bits, multi = outs[0]
        return t_bits, s_bits, multi.view(torch.bool)
    # each shard's bits out of its device's row, on the lead, concatenated in
    # shard order (one copy kernel for the slices that share the lead)
    parts = [None] * len(mesh)
    for d, (bits, _, _) in zip(devices, outs):
        off = 0
        for i in shards_of[d]:
            parts[i] = bits[off:off + t_slabs[i].shape[0] // 8].to(lead, non_blocking=True)
            off += t_slabs[i].shape[0] // 8
    t_bits = torch.cat(parts)
    # the packed hits and the multi bytes ORed across devices in one launch
    s_bits, multi = mesh_mod.psum_many([([o[1] for o in outs], "or"),
                                        ([o[2] for o in outs], "or")])
    return t_bits, s_bits, multi.view(torch.bool)


# -- the host side -----------------------------------------------------------------


def _pad(col: np.ndarray, cap: int, fill) -> np.ndarray:
    out = np.full(cap, fill, dtype=col.dtype)
    out[: len(col)] = col
    return out


def _first_match_recovery(t_keys: np.ndarray, t_matched_idx: np.ndarray, s_keys: np.ndarray,
                          s_ok: np.ndarray) -> np.ndarray:
    """For each matched target row, the lowest source row index with an
    equal key: a binary search over the valid source keys, stable-sorted so
    ties resolve to the earliest original row."""
    vidx = np.flatnonzero(s_ok)
    vk = s_keys[vidx]
    order = np.argsort(vk, kind="stable")
    sk = vk[order]
    si = vidx[order]
    pos = np.searchsorted(sk, t_keys[t_matched_idx], side="left")
    return si[pos]


def _host_join(t_key64, t_ok, s_key64, s_ok) -> JoinResult:
    """The numpy sort-merge join: K12's semantics without the device (used
    when no sentinel value exists)."""
    n, m = len(t_key64), len(s_key64)
    sk = np.sort(s_key64[s_ok])
    lo = np.searchsorted(sk, t_key64, side="left")
    hi = np.searchsorted(sk, t_key64, side="right")
    count = np.where(t_ok, hi - lo, 0)
    t_first_s = np.full(n, -1, np.int64)
    idx = np.flatnonzero(count > 0)
    if idx.size:
        t_first_s[idx] = _first_match_recovery(t_key64, idx, s_key64, s_ok)
    ts = np.sort(t_key64[t_ok])
    s_matched = s_ok & (np.searchsorted(ts, s_key64, side="right")
                        > np.searchsorted(ts, s_key64, side="left"))
    return JoinResult(t_first_s, s_matched, bool((count > 1).any()))


def _sentinel_encode(t_key, t_ok, s_key, s_ok, dtype):
    """Replace invalid keys with per-side sentinels outside both sides'
    valid range (invalid never matches anything, other invalids included).
    Returns (t_enc, s_enc, t_pad_fill, s_pad_fill), or None when the valid
    values span the whole dtype range."""
    info = np.iinfo(dtype)
    lo = min(np.min(t_key, where=t_ok, initial=info.max),
             np.min(s_key, where=s_ok, initial=info.max))
    hi = max(np.max(t_key, where=t_ok, initial=info.min),
             np.max(s_key, where=s_ok, initial=info.min))
    if hi <= info.max - 2:
        t_sent, s_sent = info.max, info.max - 1
    elif lo >= info.min + 2:
        t_sent, s_sent = info.min, info.min + 1
    else:
        return None
    t_enc = t_key if t_ok.all() else np.where(t_ok, t_key, dtype(t_sent))
    s_enc = s_key if s_ok.all() else np.where(s_ok, s_key, dtype(s_sent))
    return (np.ascontiguousarray(t_enc, dtype), np.ascontiguousarray(s_enc, dtype),
            dtype(t_sent), dtype(s_sent))


def inner_join_async(t_keys: np.ndarray, t_valid: np.ndarray, s_keys: np.ndarray,
                     s_valid: np.ndarray, mesh=None, budget_s: Optional[float] = None,
                     device="cuda") -> Optional[PendingJoin]:
    """Launch the upload join on ``device`` without blocking. Rows with
    ``valid == False`` (SQL NULL keys) never match. ``device="cpu"`` runs
    K12's plain version. ``mesh`` (a list of devices, ``parallel/mesh``)
    of more than one entry runs K13 over it instead, the target split in
    contiguous slabs and the source gathered; None or one entry runs K12.
    With ``budget_s``, returns None instead of launching when the estimated
    device time exceeds it, or when the keys leave no sentinel room (the
    caller has its own host join)."""
    from delta_tpu_torch.utils.device import resolve

    dev = resolve(device) if mesh is None or len(mesh) <= 1 else mesh[0]
    n, m = len(t_keys), len(s_keys)
    if n == 0 or m == 0:
        return PendingJoin(lambda: JoinResult(np.full(n, -1, np.int64), np.zeros(m, bool), False))
    t_key64 = np.ascontiguousarray(t_keys, np.int64)
    s_key64 = np.ascontiguousarray(s_keys, np.int64)
    t_ok = np.asarray(t_valid, bool)
    s_ok = np.asarray(s_valid, bool)
    # narrow to int32 when exact; a margin of 2 keeps sentinel room
    i32 = np.iinfo(np.int32)
    if (np.min(t_key64, where=t_ok, initial=0) >= i32.min + 2
            and np.max(t_key64, where=t_ok, initial=0) <= i32.max
            and np.min(s_key64, where=s_ok, initial=0) >= i32.min + 2
            and np.max(s_key64, where=s_ok, initial=0) <= i32.max):
        enc = _sentinel_encode(np.where(t_ok, t_key64, 0).astype(np.int32), t_ok,
                               np.where(s_ok, s_key64, 0).astype(np.int32), s_ok, np.int32)
    else:
        enc = _sentinel_encode(t_key64, t_ok, s_key64, s_ok, np.int64)
    if enc is None:
        # the valid keys span the whole dtype: no sentinel room. With a
        # budget the caller's fallback is taken; without one, the numpy
        # sort-merge join honours the contract
        if budget_s is not None:
            return None
        return PendingJoin(lambda: _host_join(t_key64, t_ok, s_key64, s_ok))
    t_enc, s_enc, t_fill, s_fill = enc
    if mesh is None or len(mesh) <= 1:
        p = 1
        cap_t, cap_s = _bucket(n), _bucket(m)
    else:
        p = len(mesh)
        cap_t = _bucket((n + p - 1) // p) * p
        cap_s = _bucket((m + p - 1) // p) * p
    if budget_s is not None:
        from delta_tpu_torch.parallel import link

        itemsize = t_enc.dtype.itemsize
        # a shard's work: its target slab against the whole gathered source
        est = link.estimate_device_s(up_bytes=(cap_t + cap_s) * itemsize,
                                     down_bytes=cap_t // 8 + cap_s // 8,
                                     kernel_rows=cap_t // p + cap_s, device=dev)
        if est.device_s > budget_s:
            return None
    t_in = _pad(t_enc, cap_t, t_fill)
    s_in = _pad(s_enc, cap_s, s_fill)
    state: dict = {}

    def launch():
        try:
            ctx = torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
            with ctx:
                if p == 1:
                    t_bits, s_bits, multi = join_probe(torch.from_numpy(t_in).to(dev),
                                                       torch.from_numpy(s_in).to(dev))
                else:
                    t_sh, s_sh = t_in.reshape(p, -1), s_in.reshape(p, -1)
                    t_bits, s_bits, multi = sharded_join_probe(
                        [torch.from_numpy(t_sh[i]).to(d) for i, d in enumerate(mesh)],
                        [torch.from_numpy(s_sh[i]).to(d) for i, d in enumerate(mesh)])
                if dev.type == "cuda":
                    done = torch.cuda.Event()
                    done.record()
                    state["done"] = done
                state["out"] = (t_bits.cpu().numpy(), s_bits.cpu().numpy(),
                                bool(multi.cpu()[0]))
        except BaseException as e:  # surfaces in .result(), not on the thread
            state["err"] = e

    th = threading.Thread(target=launch, daemon=True, name="delta-join-upload")
    th.start()

    def finalize() -> JoinResult:
        th.join()
        if "err" in state:
            raise state["err"]
        if "done" in state:
            state["done"].synchronize()
        t_bits, s_bits, any_multi = state["out"]
        t_matched = np.unpackbits(t_bits)[:n].astype(bool)
        s_matched = np.unpackbits(s_bits)[:m].astype(bool)
        t_first_s = np.full(n, -1, np.int64)
        idx = np.flatnonzero(t_matched)
        if idx.size:
            t_first_s[idx] = _first_match_recovery(t_key64, idx, s_key64, s_ok)
        return JoinResult(t_first_s, s_matched, any_multi)

    return PendingJoin(finalize)


def inner_join(t_keys, t_valid, s_keys, s_valid, mesh=None, device="cuda") -> JoinResult:
    """Blocking wrapper of :func:`inner_join_async`."""
    return inner_join_async(t_keys, t_valid, s_keys, s_valid, mesh=mesh,
                            device=device).result()


# -- the host equi join ---------------------------------------------------------------


def _factorize(t_vals: np.ndarray, s_vals: np.ndarray) -> Tuple[np.ndarray, np.ndarray, int]:
    """Dense codes of one key column over both sides (equal values, equal
    codes), and the number of distinct values."""
    both = np.concatenate([t_vals, s_vals])
    uniq, inv = np.unique(both, return_inverse=True)
    return inv[: len(t_vals)].astype(np.int64), inv[len(t_vals):].astype(np.int64), len(uniq)


def host_equi_join(keys: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Inner equi join on one or more key columns, each given as (target
    values, target valid, source values, source valid) of one comparable
    type. Returns (target rows, source rows) of every matching pair, sorted
    by target row then source row; a row with a NULL key matches nothing."""
    n, m = len(keys[0][0]), len(keys[0][2])
    t_ok = np.ones(n, bool)
    s_ok = np.ones(m, bool)
    for _, tv, _, sv in keys:
        t_ok &= tv
        s_ok &= sv
    t_rows, s_rows = np.flatnonzero(t_ok), np.flatnonzero(s_ok)
    t0, s0 = keys[0][0][t_rows], keys[0][2][s_rows]
    if len(keys) == 1 and t0.dtype.kind in "iu" and s0.dtype.kind in "iu":
        t_code, s_code = t0, s0  # one integer key: its values are its codes
    else:
        t_code, s_code, _ = _factorize(t0, s0)
    for t_vals, _, s_vals, _ in keys[1:]:
        tc, sc, card = _factorize(t_vals[t_rows], s_vals[s_rows])
        # fold the column into the running code and re-densify
        t_code, s_code, _ = _factorize(t_code * card + tc, s_code * card + sc)
    order = np.argsort(s_code, kind="stable")
    sorted_codes = s_code[order]
    # search the target codes in sorted order (a cache-friendly merge walk,
    # several times faster than as many random binary searches), then the
    # run ends of the hits only
    t_order = np.argsort(t_code)
    lo = np.empty(len(t_code), np.int64)
    lo[t_order] = np.searchsorted(sorted_codes, t_code[t_order], side="left")
    hit = lo < len(sorted_codes)
    hit[hit] = sorted_codes[lo[hit]] == t_code[hit]
    counts = np.zeros(len(t_code), np.int64)
    counts[hit] = np.searchsorted(sorted_codes, t_code[hit], side="right") - lo[hit]
    pair_t = np.repeat(t_rows, counts)
    starts = np.repeat(lo - np.cumsum(counts) + counts, counts)
    within = np.arange(len(pair_t)) + starts
    pair_s = s_rows[order[within]] if len(pair_t) else np.empty(0, np.int64)
    return pair_t.astype(np.int64), np.asarray(pair_s, np.int64)

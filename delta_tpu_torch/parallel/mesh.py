"""The 1-D state mesh (the port's own copy of ``delta_tpu.parallel.mesh``).

Table-state kernels shard over one ``"shards"`` axis: the sharded replay
(K6, ``ops/replay_kernel.replay_sharded``), the sharded block cull (K7,
``ops/state_cache``) and the sharded join probe (K13,
``ops/join_kernel.inner_join_async(mesh=)``). Where the JAX package has a
``jax.sharding.Mesh`` and ``shard_map``, a mesh here is an ordered list of
``torch.device``s, one per shard, and the sharded kernels launch once a
shard, each on its own device (:func:`run_shards`).

The default list (:func:`default_devices`) is every visible card, or the
CPU for a port opened with ``device="cpu"``. :func:`using_devices`
installs another list, which may name one device more than once: PyTorch
has no virtual devices, so this is how a test holds the sharded paths on an
8-entry ``cpu`` mesh against the JAX package's forced 8-device CPU mesh,
and how one card runs every shard in turn. It is not a session conf key.

The two collectives the kernels need live here:

* :func:`all_gather`: the shards' tensors concatenated in shard order along
  one axis on one device (JAX's ``all_gather(..., tiled=True)``). Between
  distinct cards this is a copy (peer to peer where the cards allow it):
  communication, not computation;
* :func:`psum`: the partial results gathered to the lead device (the
  mesh's first entry) as ``(n, k)`` rows, then reduced there by the
  hand-written combine kernel (:func:`shard_combine`,
  ``csrc/shard_combine.cu``): a sum of int64 rows or a bytewise OR of byte
  rows. :func:`psum_many` reduces one or two ``(parts, op)`` pairs with one
  gather each and ONE combine launch (:func:`shard_combine_many`): K13's packed
  source hits and multi flags. Where one device holds every shard, the
  sharded kernels reduce in their own launch (K6 sums all its slabs into
  one row, K13 packs its hits) and no combine runs.

Each shard launches under ``torch.cuda.device(its device)`` on that
device's current stream, and the lead's current stream waits on an event
recorded on each shard's stream after its launch before anything reads a
shard's output. With one card named several times both are no-ops; the
waits across distinct cards are right by construction and have not run on
more than one card.
"""
from __future__ import annotations

import contextlib
import struct
import threading
from typing import Callable, Dict, List, Optional, Sequence

import torch

from delta_tpu_torch.ops import native
from delta_tpu_torch.utils.device import resolve

__all__ = ["STATE_AXIS", "state_mesh", "shard_count", "pad_to_multiple", "default_devices",
           "using_devices", "run_shards", "replicate", "all_gather", "psum", "psum_many",
           "shard_combine", "shard_combine_many", "shard_combine_plain", "COMBINE_OPS"]

STATE_AXIS = "shards"

#: the combine kernel's reductions, by name
COMBINE_OPS = {"sum": 0, "or": 1}
#: reductions one combine launch takes (``csrc/shard_combine.cu``'s kMaxSets)
COMBINE_MAX_SETS = 2

_lock = threading.Lock()
_installed: Optional[List[torch.device]] = None


def _norm(device) -> torch.device:
    d = resolve(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


@contextlib.contextmanager
def using_devices(devices: Sequence):
    """Install ``devices`` (an ordered list, repeats allowed) as the default
    mesh until the block ends."""
    global _installed
    devs = [_norm(d) for d in devices]
    if not devs:
        raise ValueError("using_devices: a mesh needs at least one device")
    with _lock:
        prev, _installed = _installed, devs
    try:
        yield list(devs)
    finally:
        with _lock:
            _installed = prev


def default_devices(device="cuda") -> List[torch.device]:
    """The default mesh: the installed list, else every visible card for a
    CUDA ``device``, else ``[cpu]``."""
    with _lock:
        if _installed is not None:
            return list(_installed)
    d = resolve(device)
    if d.type == "cpu":
        return [d]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def state_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None,
               device="cuda") -> List[torch.device]:
    """1-D mesh over ``n_devices`` entries (default: all) of ``devices``
    (default: :func:`default_devices` of ``device``)."""
    devs = [_norm(d) for d in devices] if devices is not None else default_devices(device)
    if n_devices is not None:
        devs = devs[:n_devices]
    return devs


def shard_count(mesh: Sequence[torch.device]) -> int:
    return len(mesh)


def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``n`` (and >= m)."""
    return max(((n + m - 1) // m) * m, m)


def _device_ctx(d: torch.device):
    return torch.cuda.device(d) if d.type == "cuda" else contextlib.nullcontext()


def run_shards(mesh: Sequence[torch.device], launch: Callable[[int, torch.device], object]
               ) -> list:
    """``launch(i, device)`` for each shard, under its device and on that
    device's current stream; then the lead's current stream waits on an
    event recorded after each launch on another card (a launch on the lead
    is on that stream already). Returns the results in shard order."""
    lead = mesh[0]
    outs, events = [], []
    for i, d in enumerate(mesh):
        with _device_ctx(d):
            outs.append(launch(i, d))
            if d.type == "cuda" and d != lead:
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(d))
                events.append(ev)
    if lead.type == "cuda":
        stream = torch.cuda.current_stream(lead)
        for ev in events:
            stream.wait_event(ev)
    return outs


def replicate(t: torch.Tensor, mesh: Sequence[torch.device]) -> Dict[torch.device, torch.Tensor]:
    """``t`` on every distinct device of the mesh, one copy each (a device
    named several times shares its copy)."""
    out: Dict[torch.device, torch.Tensor] = {}
    for d in mesh:
        if d not in out:
            out[d] = t if t.device == d else t.to(d, non_blocking=True)
    return out


def all_gather(parts: Sequence[torch.Tensor], device: torch.device, axis: int = 0
               ) -> torch.Tensor:
    """The shards' tensors concatenated along ``axis``, in shard order, into
    one new tensor on ``device`` (JAX's tiled all-gather): one copy a
    shard."""
    shape = list(parts[0].shape)
    shape[axis] = sum(p.shape[axis] for p in parts)
    out = torch.empty(shape, dtype=parts[0].dtype, device=device)
    off = 0
    for p in parts:
        out.narrow(axis, off, p.shape[axis]).copy_(p, non_blocking=True)
        off += p.shape[axis]
    return out


def _rows_on_lead(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The shards' partial results as ``(n, k)`` rows on the lead device
    (``parts[0]``'s): no copy when one part holds them all."""
    if len(parts) == 1:  # already on the lead: no gather
        return parts[0].reshape(-1, parts[0].shape[-1])
    return all_gather([p.reshape(-1, p.shape[-1]) for p in parts], parts[0].device)


def psum(parts: Sequence[torch.Tensor], op: str = "sum") -> torch.Tensor:
    """The shards' partial results (each ``(k,)``, or ``(r, k)`` for r
    shards of one device, on its device) reduced on the lead device
    (``parts[0]``'s): gathered as ``(n, k)`` rows, then one combine launch
    (``op`` of :data:`COMBINE_OPS`)."""
    return psum_many([(parts, op)])[0]


def psum_many(pairs) -> List[torch.Tensor]:
    """:func:`psum` of each ``(parts, op)`` pair, all on one lead device:
    one gather a pair, then one combine launch for all of them."""
    lead = pairs[0][0][0].device
    if any(parts[0].device != lead for parts, _ in pairs):
        raise ValueError("psum_many: every pair must lead on one device")
    sets = [(_rows_on_lead(parts), op) for parts, op in pairs]
    with _device_ctx(lead):
        return shard_combine_many(sets)


# -- the combine kernel and its plain version -------------------------------------------


def shard_combine_plain(rows: torch.Tensor, op: str) -> torch.Tensor:
    """Plain PyTorch version of the combine: ``rows.sum(0)`` (int64) or the
    bytewise OR of the rows (uint8)."""
    if op == "sum":
        return rows.sum(dim=0, dtype=torch.int64)
    out = rows[0].clone()
    for r in rows[1:]:
        out |= r
    return out


def _check_rows(rows: torch.Tensor, op: str) -> None:
    if op not in COMBINE_OPS:
        raise ValueError(f"shard_combine: op {op!r} is not one of {sorted(COMBINE_OPS)}")
    want = torch.int64 if op == "sum" else torch.uint8
    if rows.dtype != want or rows.dim() != 2 or rows.shape[0] < 1:
        raise TypeError(f"shard_combine: {op} takes (n >= 1, k) {want} rows, got "
                        f"{tuple(rows.shape)} {rows.dtype}")


def shard_combine(rows: torch.Tensor, op: str) -> torch.Tensor:
    """The cross-shard reduction of ``(n, k)`` rows on one device: ``"sum"``
    of int64 rows gives ``(k,)`` int64; ``"or"`` of uint8 rows gives their
    ``(k,)`` bytewise OR. The plain version for a tensor on the CPU; for a
    CUDA tensor the kernel, or an error."""
    return shard_combine_many([(rows, op)])[0]


def shard_combine_many(sets) -> List[torch.Tensor]:
    """:func:`shard_combine` of each of at most :data:`COMBINE_MAX_SETS`
    ``(rows, op)`` pairs, all on one device, in one launch of the kernel
    (none when every ``k`` is 0). Each set's rows are contiguous, at any
    offset."""
    if not 1 <= len(sets) <= COMBINE_MAX_SETS:
        raise ValueError(f"shard_combine_many: 1 to {COMBINE_MAX_SETS} sets, got {len(sets)}")
    dev = sets[0][0].device
    for rows, op in sets:
        _check_rows(rows, op)
        if rows.device != dev:
            raise ValueError("shard_combine_many: every set must be on one device")
        if not rows.is_contiguous():
            raise ValueError("shard_combine_many: each set's rows must be contiguous")
    if dev.type == "cpu":
        return [shard_combine_plain(rows, op) for rows, op in sets]
    outs, words = [], []
    for rows, op in sets:
        n, k = rows.shape
        out = torch.empty(k, dtype=rows.dtype, device=dev)
        outs.append(out)
        words += [rows.data_ptr(), out.data_ptr(), k, n, COMBINE_OPS[op]]
    if any(rows.shape[1] for rows, _ in sets):
        native.call("shard_combine", dev, struct.pack(f"{len(words)}q", *words), len(sets))
        native.launches["shard_combine"] += 1
    return outs

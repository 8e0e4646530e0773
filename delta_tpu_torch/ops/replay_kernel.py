"""Device log replay: last-writer-wins over the action stream.

The port's own copy of ``delta_tpu.ops.replay_kernel``'s single-device
paths, each with a hand-written CUDA kernel beside its plain PyTorch
version (taken only for tensors on the CPU):

* :func:`replay_alive_mask` (``replay_kernel.py:94``) over
  :class:`~delta_tpu_torch.ops.state_export.ReplayArrays`: the kernel
  :func:`replay` (K5, ``csrc/replay.cu``) replaces ``_replay_kernel``
  (``:56``) — winner by largest ``seq``, alive and tombstone masks and the
  three sums, all on the card;
* ``winner_mask_device`` (``:134``) and ``replay_columns`` (``:147``): the
  kernel :func:`winner_bits` (K4, ``csrc/winner_bits.cu``) replaces
  ``_winner_bits_kernel`` (``:115``).

The sharded replay waits for the multi-card slice.

Row order is the replay order (``log/columnar`` layout invariant), so the
winner of a path is its last row; padding rows carry path id -1 and never
win. Alive/tombstone masks and the aggregate stats are host numpy on the
downloaded mask, as in the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from delta_tpu_torch.ops import native
from delta_tpu_torch.ops.state_cache import _next_pow2, _packbits
from delta_tpu_torch.utils.device import resolve

_I64_MIN = -(1 << 63)

__all__ = ["ReplayStats", "ReplayResult", "replay", "replay_plain", "replay_alive_mask",
           "winner_bits", "winner_bits_plain", "winner_mask_device", "replay_columns"]


class ReplayStats(NamedTuple):
    num_files: np.int32
    total_size: np.int64
    num_tombstones: np.int32


class ReplayResult(NamedTuple):
    alive: np.ndarray  # bool per input row: surviving AddFile
    tombstone: np.ndarray  # bool per input row: retained RemoveFile
    stats: ReplayStats


def replay_plain(path_id: torch.Tensor, seq: torch.Tensor, is_add: torch.Tensor,
                 size: torch.Tensor, deletion_ts: torch.Tensor, num_paths: int,
                 min_retention_ts: int):
    """Plain PyTorch version of K5: the largest ``seq`` of each path by a
    scatter-max, the same winner test, masks and sums. Returns
    ``(alive, tombstone, sums)``, sums int64 ``[files, bytes, tombstones]``."""
    valid = path_id >= 0
    pid = path_id.to(torch.int64)
    best = torch.full((max(num_paths, 1),), _I64_MIN, dtype=torch.int64, device=seq.device)
    best.scatter_reduce_(0, pid[valid], seq[valid], reduce="amax")
    winner = valid & (best[pid.clamp(min=0)] == seq)
    alive = winner & is_add
    tombstone = winner & ~is_add & (deletion_ts > min_retention_ts)
    sums = torch.stack([alive.sum(), torch.where(alive, size, torch.zeros_like(size)).sum(),
                        tombstone.sum()]).to(torch.int64)
    return alive, tombstone, sums


def replay(path_id: torch.Tensor, seq: torch.Tensor, is_add: torch.Tensor,
           size: torch.Tensor, deletion_ts: torch.Tensor, num_paths: int,
           min_retention_ts: int = 0):
    """Replay an action stream: row i wins when ``path_id[i] >= 0`` and its
    ``seq`` is the largest of its path (``seq`` unique per path). Returns
    ``(alive, tombstone, sums)`` as :func:`replay_plain`. path_id ``(n,)``
    int32 with ids below ``num_paths`` (raises otherwise), seq / size /
    deletion_ts int64, is_add bool, all on one device."""
    cols = (path_id, seq, is_add, size, deletion_ts)
    want = (torch.int32, torch.int64, torch.bool, torch.int64, torch.int64)
    n = path_id.shape[0]
    for t, d in zip(cols, want):
        if t.dtype != d or t.dim() != 1 or t.shape[0] != n:
            raise TypeError("replay: path_id int32, seq/size/deletion_ts int64 and "
                            "is_add bool, all 1-D of one length")
    if n >= 1 << 31:
        raise ValueError(f"replay: {n} rows: at most 2^31 - 1")
    if path_id.device.type == "cpu":
        if n and int(path_id.max()) >= num_paths:
            raise ValueError(f"replay: a path id reaches num_paths={num_paths}")
        return replay_plain(*cols, num_paths, min_retention_ts)
    dev = path_id.device
    if any(t.device != dev or not t.is_contiguous() for t in cols):
        raise ValueError("replay: columns must be contiguous, on one device")
    alive = torch.empty(n, dtype=torch.bool, device=dev)
    tombstone = torch.empty(n, dtype=torch.bool, device=dev)
    best = torch.empty(max(num_paths, 1), dtype=torch.int64, device=dev)
    err = torch.empty(1, dtype=torch.int32, device=dev)
    sums = torch.empty(3, dtype=torch.int64, device=dev)
    native.call("replay", dev, path_id.data_ptr(), seq.data_ptr(), is_add.data_ptr(),
                size.data_ptr(), deletion_ts.data_ptr(), n, best.data_ptr(), num_paths,
                err.data_ptr(), int(min_retention_ts), alive.data_ptr(), tombstone.data_ptr(),
                sums.data_ptr())
    native.launches["replay"] += 1
    if int(err.item()) != 0:
        raise ValueError(f"replay: a path id reaches num_paths={num_paths}")
    return alive, tombstone, sums


def _pad(col: np.ndarray, cap: int, fill) -> np.ndarray:
    out = np.full(cap, fill, dtype=col.dtype)
    out[: len(col)] = col
    return out


def replay_alive_mask(arrays, min_retention_ts: int = 0, device="cuda") -> ReplayResult:
    """Replay a :class:`~delta_tpu_torch.ops.state_export.ReplayArrays`
    stream on ``device``: the rows pad to a power of two (at least 8) as
    the JAX package pads them, one K5 launch computes masks and sums, and
    the result comes back as host numpy."""
    n = arrays.num_rows
    cap = _next_pow2(n, floor=8)
    dev = resolve(device)
    cols = [torch.from_numpy(_pad(np.asarray(a, dt), cap, fill)).to(dev)
            for a, dt, fill in ((arrays.path_id, np.int32, -1), (arrays.seq, np.int64, 0),
                                (arrays.is_add, bool, False), (arrays.size, np.int64, 0),
                                (arrays.deletion_timestamp, np.int64, 0))]
    alive, tombstone, sums = replay(*cols, len(arrays.paths), int(min_retention_ts))
    files, size, tombs = sums.cpu().tolist()
    return ReplayResult(alive.cpu().numpy()[:n], tombstone.cpu().numpy()[:n],
                        ReplayStats(np.int32(files), np.int64(size), np.int32(tombs)))


def winner_bits_plain(path_id: torch.Tensor, num_paths: int) -> torch.Tensor:
    """Plain PyTorch version: the last row index of each path by a
    scatter-max, then the same test and big-endian packing."""
    n = path_id.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=path_id.device)
    valid = path_id >= 0
    pid = path_id.to(torch.int64)
    last = torch.full((num_paths,), -1, dtype=torch.int64, device=path_id.device)
    last.scatter_reduce_(0, pid[valid], idx[valid], reduce="amax")
    winner = valid & (last[pid.clamp(min=0)] == idx)
    return _packbits(winner)


def winner_bits(path_id: torch.Tensor, num_paths: int) -> torch.Tensor:
    """Winner mask packed big-endian into ``n / 8`` bytes: row i wins when
    ``path_id[i] >= 0`` and no later row has the same id. path_id ``(n,)``
    int32, n a multiple of 8, ids below ``num_paths`` (raises otherwise)."""
    if path_id.dtype != torch.int32 or path_id.dim() != 1:
        raise TypeError("winner_bits: path_id must be 1-D int32")
    n = path_id.shape[0]
    if n % 8 or n >= 1 << 31:
        raise ValueError(f"winner_bits: length {n} must be a multiple of 8 below 2^31")
    if path_id.device.type == "cpu":
        if n and int(path_id.max()) >= num_paths:
            raise ValueError(f"winner_bits: a path id reaches num_paths={num_paths}")
        return winner_bits_plain(path_id, num_paths)
    if not path_id.is_contiguous():
        raise ValueError("winner_bits: path_id must be contiguous")
    dev = path_id.device
    out = torch.empty(n // 8, dtype=torch.uint8, device=dev)
    last = torch.empty(max(num_paths, 1), dtype=torch.int32, device=dev)
    err = torch.empty(1, dtype=torch.int32, device=dev)
    native.call("winner_bits", dev, path_id.data_ptr(), n, last.data_ptr(), num_paths,
                err.data_ptr(), out.data_ptr())
    native.launches["winner_bits"] += 1
    if int(err.item()) != 0:
        raise ValueError(f"winner_bits: a path id reaches num_paths={num_paths}")
    return out


def winner_mask_device(path_id: np.ndarray, num_paths: int, device="cuda") -> np.ndarray:
    """Last-writer-wins winner mask for a replay-ordered action stream:
    one int32 column up, one bitmask down."""
    n = len(path_id)
    padded = np.full(_next_pow2(n, floor=8), -1, np.int32)
    padded[:n] = path_id
    bits = winner_bits(torch.from_numpy(padded).to(resolve(device)), num_paths)
    return np.unpackbits(bits.cpu().numpy(), count=n).astype(bool)


def replay_columns(cols, min_retention_ts: int = 0, device="cuda") -> ReplayResult:
    """Replay a :class:`delta_tpu_torch.log.columnar.SegmentColumns` stream:
    the winner mask on ``device``, alive/tombstone masks and the aggregate
    stats as host numpy."""
    winner = winner_mask_device(cols.path_id, cols.num_paths, device)
    alive, tombstone = cols.replay(min_retention_ts, winner=winner)
    stats = ReplayStats(
        num_files=np.int32(alive.sum()),
        total_size=np.int64(cols.size[alive].sum()),
        num_tombstones=np.int32(tombstone.sum()),
    )
    return ReplayResult(alive, tombstone, stats)

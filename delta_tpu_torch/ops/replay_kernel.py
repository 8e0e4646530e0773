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

* :func:`replay_sharded` (``replay_kernel.py:206``) over a state mesh
  (``parallel/mesh``): the host buckets the rows by :func:`_mix64` of the
  path id (every action of a path on one shard, :func:`_bucket_by_path`),
  the kernel :func:`sharded_replay` (K6, ``csrc/replay.cu``'s second entry
  point) replays each shard's slab on its own device, the combine kernel
  adds the shards' sums on the lead device (``mesh.psum``), and the host
  unscatters the masks.

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
           "winner_bits", "winner_bits_plain", "winner_mask_device", "replay_columns",
           "replay_sharded", "sharded_replay", "sharded_replay_plain"]


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


# -- the sharded replay (K6) ---------------------------------------------------------


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64's finalizer in wrapping uint64 (the reference's
    ``_mix64``): decorrelates the shard choice from path-id locality. It
    stays on the host: torch has no wrapping uint64 multiply."""
    z = x.astype(np.uint64)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def _bucket_by_path(arrays, n_shards: int):
    """Row -> shard ``mix(path_id) % n_shards`` (every action of a path on
    one shard), padded to one power-of-two length (at least 8) for every
    shard: one argsort and one scatter a column. Returns the stacked
    ``(n_shards, cap)`` columns (path_id, seq, is_add, size,
    deletion_timestamp; pads -1, 0, False, 0, 0), the row order and the
    flat destination of each ordered row."""
    bucket = (_mix64(arrays.path_id) % np.uint64(n_shards)).astype(np.int64)
    order = np.argsort(bucket, kind="stable")
    counts = np.bincount(bucket, minlength=n_shards)
    cap = _next_pow2(int(counts.max()) if len(counts) else 1, floor=8)
    starts = np.cumsum(counts) - counts
    within = np.arange(len(order), dtype=np.int64) - np.repeat(starts, counts)
    dest = bucket[order] * cap + within  # flat index into (n_shards * cap)

    def stack(col, fill):
        out = np.full(n_shards * cap, fill, dtype=col.dtype)
        out[dest] = col[order]
        return out.reshape(n_shards, cap)

    cols = (stack(np.asarray(arrays.path_id, np.int32), np.int32(-1)),
            stack(np.asarray(arrays.seq, np.int64), np.int64(0)),
            stack(np.asarray(arrays.is_add, bool), False),
            stack(np.asarray(arrays.size, np.int64), np.int64(0)),
            stack(np.asarray(arrays.deletion_timestamp, np.int64), np.int64(0)))
    return cols, order, dest


def sharded_replay_plain(slabs, num_paths: int, min_retention_ts: int):
    """Plain PyTorch version of K6: K5's plain version on each shard's slab,
    the sums added. ``slabs``: one (path_id, seq, is_add, size,
    deletion_ts) tuple a shard. Returns (alive list, tombstone list, sums
    (3,) int64)."""
    outs = [replay_plain(*cols, num_paths, min_retention_ts) for cols in slabs]
    sums = torch.stack([o[2].to(slabs[0][0].device) for o in outs]).sum(dim=0)
    return [o[0] for o in outs], [o[1] for o in outs], sums


def sharded_replay(slabs, num_paths: int, min_retention_ts: int = 0):
    """K6: each shard's slab (a (path_id int32, seq int64, is_add bool, size
    int64, deletion_ts int64) tuple of one length, on that shard's device)
    replayed by one launch on its device, ids global (below ``num_paths``;
    raises otherwise); the shards' (3,) int64 sums reduced on the lead
    device (the first slab's) by the combine kernel. Returns (alive list,
    tombstone list, sums (3,) int64: live files, their bytes, tombstones).
    The plain version for slabs on the CPU; on the card the kernel, or an
    error."""
    from delta_tpu_torch.parallel import mesh as mesh_mod

    want = (torch.int32, torch.int64, torch.bool, torch.int64, torch.int64)
    for cols in slabs:
        n = cols[0].shape[0]
        if any(t.dtype != d or t.dim() != 1 or t.shape[0] != n for t, d in zip(cols, want)):
            raise TypeError("sharded_replay: each slab is path_id int32, seq/size/"
                            "deletion_ts int64 and is_add bool, 1-D of one length")
        if n >= 1 << 31:
            raise ValueError(f"sharded_replay: a slab of {n} rows: at most 2^31 - 1")
        if any(t.device != cols[0].device for t in cols):
            raise ValueError("sharded_replay: a slab's columns must be on one device")
    if all(cols[0].device.type == "cpu" for cols in slabs):
        for cols in slabs:
            if cols[0].shape[0] and int(cols[0].max()) >= num_paths:
                raise ValueError(f"sharded_replay: a path id reaches num_paths={num_paths}")
        return sharded_replay_plain(slabs, num_paths, min_retention_ts)
    mesh = [cols[0].device for cols in slabs]
    if any(d.type != "cuda" for d in mesh):
        raise ValueError("sharded_replay: the slabs must all be on the card, or all on the CPU")

    def launch(i, dev):
        cols = slabs[i]
        if not all(t.is_contiguous() for t in cols):
            raise ValueError("sharded_replay: columns must be contiguous")
        n = cols[0].shape[0]
        alive = torch.empty(n, dtype=torch.bool, device=dev)
        tombstone = torch.empty(n, dtype=torch.bool, device=dev)
        best = torch.empty(max(num_paths, 1), dtype=torch.int64, device=dev)
        err = torch.empty(1, dtype=torch.int32, device=dev)
        sums = torch.empty((1, 3), dtype=torch.int64, device=dev)
        native.call("sharded_replay", dev, *(t.data_ptr() for t in cols[:5]), n,
                    best.data_ptr(), num_paths, err.data_ptr(), int(min_retention_ts),
                    alive.data_ptr(), tombstone.data_ptr(), sums.data_ptr(), 0)
        native.launches["sharded_replay"] += 1
        return alive, tombstone, sums[0], err

    outs = mesh_mod.run_shards(mesh, launch)
    if any(int(o[3].item()) != 0 for o in outs):
        raise ValueError(f"sharded_replay: a path id reaches num_paths={num_paths}")
    sums = mesh_mod.psum([o[2] for o in outs], "sum")
    return [o[0] for o in outs], [o[1] for o in outs], sums


def replay_sharded(arrays, mesh, min_retention_ts: int = 0) -> ReplayResult:
    """Replay an action stream sharded over ``mesh`` (a list of devices,
    ``parallel/mesh.state_mesh``): the host buckets the rows by path, each
    shard's slab goes to its device, K6 replays every shard, the combine
    kernel reduces the sums on the lead device, and the host unscatters the
    masks to the input order. Equal to :func:`replay_alive_mask` on the
    same stream."""
    n = len(mesh)
    stacked, order, dest = _bucket_by_path(arrays, n)
    slabs = [tuple(torch.from_numpy(np.ascontiguousarray(col[i])).to(dev) for col in stacked)
             for i, dev in enumerate(mesh)]
    # ids are global: the best-seq table spans the dictionary (or the
    # largest id, for a stream built without one)
    pid = np.asarray(arrays.path_id)
    num_paths = max(len(arrays.paths), int(pid.max()) + 1 if len(pid) else 0)
    alive_sh, tomb_sh, sums = sharded_replay(slabs, num_paths, int(min_retention_ts))
    files, size, tombs = sums.cpu().tolist()
    alive = np.zeros(arrays.num_rows, bool)
    tombstone = np.zeros(arrays.num_rows, bool)
    alive[order] = np.concatenate([a.cpu().numpy() for a in alive_sh])[dest]
    tombstone[order] = np.concatenate([t.cpu().numpy() for t in tomb_sh])[dest]
    return ReplayResult(alive, tombstone,
                        ReplayStats(np.int32(files), np.int64(size), np.int32(tombs)))

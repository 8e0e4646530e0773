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
  ``_winner_bits_kernel`` (``:115``): two launches, no memset (its table
  lives on the card from call to call, one a device and stream, and the
  call leaves it clean) and no read-back (the error word follows the mask,
  and ``winner_mask_device`` downloads both in one copy).

* :func:`replay_sharded` (``replay_kernel.py:206``) over a state mesh
  (``parallel/mesh``): the host buckets the rows by :func:`_mix64` of the
  path id (every action of a path on one shard, :func:`_bucket_by_path`),
  the kernel :func:`sharded_replay` (K6, ``csrc/replay.cu``: K5's body over
  all the shards of a device in one launch, one winner table a device)
  replays and sums them, the combine kernel adds the devices' sums on the
  lead device where there are several (``mesh.psum``), and the host
  unscatters the masks.

Row order is the replay order (``log/columnar`` layout invariant), so the
winner of a path is its last row; padding rows carry path id -1 and never
win. Alive/tombstone masks and the aggregate stats are host numpy on the
downloaded mask, as in the JAX package.
"""
from __future__ import annotations

import threading
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


def _best_plain(path_id: torch.Tensor, seq: torch.Tensor, num_paths: int) -> torch.Tensor:
    """The largest ``seq`` of each path (``INT64_MIN`` where it has no row),
    by a scatter-max over the non-pad rows."""
    valid = path_id >= 0
    best = torch.full((max(num_paths, 1),), _I64_MIN, dtype=torch.int64, device=seq.device)
    best.scatter_reduce_(0, path_id[valid].to(torch.int64), seq[valid], reduce="amax")
    return best


def _masks_plain(cols, best: torch.Tensor, min_retention_ts: int):
    """The winner test of each row against ``best``, the masks and the sums
    ``[files, bytes, tombstones]`` (int64)."""
    path_id, seq, is_add, size, deletion_ts = cols
    valid = path_id >= 0
    winner = valid & (best[path_id.to(torch.int64).clamp(min=0)] == seq)
    alive = winner & is_add
    tombstone = winner & ~is_add & (deletion_ts > min_retention_ts)
    sums = torch.stack([alive.sum(), torch.where(alive, size, torch.zeros_like(size)).sum(),
                        tombstone.sum()]).to(torch.int64)
    return alive, tombstone, sums


def replay_plain(path_id: torch.Tensor, seq: torch.Tensor, is_add: torch.Tensor,
                 size: torch.Tensor, deletion_ts: torch.Tensor, num_paths: int,
                 min_retention_ts: int):
    """Plain PyTorch version of K5: the largest ``seq`` of each path by a
    scatter-max, the same winner test, masks and sums. Returns
    ``(alive, tombstone, sums)``, sums int64 ``[files, bytes, tombstones]``."""
    cols = (path_id, seq, is_add, size, deletion_ts)
    return _masks_plain(cols, _best_plain(path_id, seq, num_paths), min_retention_ts)


_COLS = (torch.int32, torch.int64, torch.bool, torch.int64, torch.int64)
#: slabs a device a launch (``csrc/replay.cu``'s kMaxShards)
_MAX_SHARDS = 64


class _Launch(NamedTuple):
    alive: list  # a view a slab
    tombstone: list
    masks: torch.Tensor  # (2, rows of all the slabs) bool: alive, then tombstone
    # (4,) int64, the slabs' sums: files, bytes, tombstones, ids >= num_paths
    total: torch.Tensor


def _launch(name: str, slabs, num_paths: int, min_retention_ts: int) -> _Launch:
    """One launch of ``csrc/replay.cu`` over ``slabs`` (all on one CUDA
    device, contiguous: the callers check) with no synchronisation, so a
    CUDA graph can hold it."""
    dev = slabs[0][0].device
    ns = [cols[0].shape[0] for cols in slabs]
    total = sum(ns)
    masks = torch.empty((2, total), dtype=torch.bool, device=dev)
    # the sums row, then the winner table (num_paths words, rounded up to a row)
    scratch = torch.empty((1 + -(-num_paths // 4), 4), dtype=torch.int64, device=dev)
    tail = (int(min_retention_ts), scratch.data_ptr(), masks.data_ptr(), total)
    if name == "replay":
        native.call(name, dev, *(t.data_ptr() for t in slabs[0]), ns[0], num_paths, *tail)
    else:
        ptrs = np.array([[t.data_ptr() for t in cols] for cols in slabs], np.uint64)
        rows = np.array(ns, np.int64)
        native.call(name, dev, ptrs.ctypes.data, rows.ctypes.data, len(slabs), num_paths, *tail)
    native.launches[name] += 1
    alive, tombstone = (list(m.split_with_sizes(ns)) for m in masks.unbind(0))
    return _Launch(alive, tombstone, masks, scratch[0])


def _raise_bad(name: str, host_words, num_paths: int) -> None:
    if host_words[3]:
        raise ValueError(f"{name}: a path id reaches num_paths={num_paths}")


def _replay(cols, num_paths: int, min_retention_ts: int):
    """:func:`replay`, and the sums as host ints (one download on the card,
    which also carries the bad-id count: the call's one synchronisation)."""
    n = cols[0].shape[0]
    for t, d in zip(cols, _COLS):
        if t.dtype != d or t.dim() != 1 or t.shape[0] != n:
            raise TypeError("replay: path_id int32, seq/size/deletion_ts int64 and "
                            "is_add bool, all 1-D of one length")
        if not t.is_contiguous():
            raise ValueError("replay: columns must be contiguous")
    if n >= 1 << 31:
        raise ValueError(f"replay: {n} rows: at most 2^31 - 1")
    if cols[0].device.type == "cpu":
        if n and int(cols[0].max()) >= num_paths:
            raise ValueError(f"replay: a path id reaches num_paths={num_paths}")
        alive, tombstone, sums = replay_plain(*cols, num_paths, min_retention_ts)
        return alive, tombstone, sums, sums.tolist()
    if any(t.device != cols[0].device for t in cols):
        raise ValueError("replay: columns must be on one device")
    out = _launch("replay", [cols], num_paths, min_retention_ts)
    words = out.total
    # its own copy: `words` shares its buffer with the winner table
    sums = words[:3].clone()
    host = words.cpu().tolist()
    _raise_bad("replay", host, num_paths)
    return out.alive[0], out.tombstone[0], sums, host[:3]


def replay(path_id: torch.Tensor, seq: torch.Tensor, is_add: torch.Tensor,
           size: torch.Tensor, deletion_ts: torch.Tensor, num_paths: int,
           min_retention_ts: int = 0):
    """Replay an action stream: row i wins when ``path_id[i] >= 0`` and its
    ``seq`` is the largest of its path (``seq`` unique per path). Returns
    ``(alive, tombstone, sums)`` as :func:`replay_plain`. path_id ``(n,)``
    int32 with ids below ``num_paths`` (raises otherwise), seq / size /
    deletion_ts int64, is_add bool, all on one device. On the card: one K5
    launch (K6's body with one slab) and one download, of the sums and the
    count of bad ids together."""
    return _replay((path_id, seq, is_add, size, deletion_ts), num_paths, min_retention_ts)[:3]


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
    alive, tombstone, _, (files, size, tombs) = _replay(cols, len(arrays.paths),
                                                        int(min_retention_ts))
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


#: K4's self-cleaning tables: (device index, raw stream) -> (last, flag),
#: ``last`` all -1 and ``flag`` 0 between calls (the pack pass leaves them
#: so); one a stream, since two streams' calls could overlap
_winner_tables: dict = {}
_winner_lock = threading.Lock()


def _winner_table(key, dev: torch.device, num_paths: int):
    """The (last, flag) pair of ``key``, at least ``num_paths`` entries:
    filled with -1 once, when it is made or grown."""
    have = _winner_tables.get(key)
    if have is None or have[0].shape[0] < max(num_paths, 1):
        with _winner_lock:
            have = (torch.full((max(num_paths, 1),), -1, dtype=torch.int32, device=dev),
                    torch.zeros(1, dtype=torch.int32, device=dev))
            _winner_tables[key] = have
    return have


def _winner_launch(path_id: torch.Tensor, num_paths: int) -> torch.Tensor:
    """K4 on a CUDA tensor: ``(round_up(n / 8, 4) + 4,)`` uint8, the packed
    mask then the int32 error word (1 where an id reaches ``num_paths``).
    No memset and no synchronisation: the stream's table cleans itself. An
    out-of-range id leaves it clean too (such an id is never written); a
    failed launch drops it, and the next call fills a new one."""
    if not path_id.is_contiguous():
        raise ValueError("winner_bits: path_id must be contiguous")
    n = path_id.shape[0]
    dev = path_id.device
    cur = dev.index if dev.index is not None else torch.cuda.current_device()
    key = (cur, torch._C._cuda_getCurrentRawStream(cur))
    last, flag = _winner_table(key, dev, num_paths)
    out = torch.empty(-(-(n // 8) // 4) * 4 + 4, dtype=torch.uint8, device=dev)
    try:
        native.call("winner_bits", dev, path_id.data_ptr(), n, last.data_ptr(), num_paths,
                    flag.data_ptr(), out.data_ptr())
    except Exception:
        with _winner_lock:  # the table may be left unclean: the next call makes one
            _winner_tables.pop(key, None)
        raise
    native.launches["winner_bits"] += 1
    return out


def winner_bits(path_id: torch.Tensor, num_paths: int) -> torch.Tensor:
    """Winner mask packed big-endian into ``n / 8`` bytes: row i wins when
    ``path_id[i] >= 0`` and no later row has the same id. path_id ``(n,)``
    int32, n a multiple of 8. On the CPU an id at or above ``num_paths``
    raises here; on the card the call does not synchronise, and the error
    word rides after the mask: :func:`winner_mask_device` reads it with the
    mask and raises."""
    if path_id.dtype != torch.int32 or path_id.dim() != 1:
        raise TypeError("winner_bits: path_id must be 1-D int32")
    n = path_id.shape[0]
    if n % 8 or n >= 1 << 31:
        raise ValueError(f"winner_bits: length {n} must be a multiple of 8 below 2^31")
    if path_id.device.type == "cpu":
        if n and int(path_id.max()) >= num_paths:
            raise ValueError(f"winner_bits: a path id reaches num_paths={num_paths}")
        return winner_bits_plain(path_id, num_paths)
    if n == 0:
        return torch.empty(0, dtype=torch.uint8, device=path_id.device)
    return _winner_launch(path_id, num_paths)[:n // 8]


def winner_mask_device(path_id: np.ndarray, num_paths: int, device="cuda") -> np.ndarray:
    """Last-writer-wins winner mask for a replay-ordered action stream:
    one int32 column up, one download of the bitmask and its error word;
    raises ``ValueError`` when an id reaches ``num_paths``."""
    n = len(path_id)
    padded = np.full(_next_pow2(n, floor=8), -1, np.int32)
    padded[:n] = path_id
    pid = torch.from_numpy(padded).to(resolve(device))
    if pid.device.type == "cpu":
        bits = winner_bits(pid, num_paths).numpy()
    else:
        host = _winner_launch(pid, num_paths).cpu().numpy()
        if int(host[-4:].view(np.int32)[0]) != 0:
            raise ValueError(f"winner_bits: a path id reaches num_paths={num_paths}")
        bits = host[:len(padded) // 8]
    return np.unpackbits(bits, count=n).astype(bool)


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
    """Plain PyTorch version of K6 as the kernel computes it: one winner
    table a distinct device, over the rows of all that device's slabs
    (sound because :func:`_bucket_by_path` puts every path on one slab), then
    K5's test on each slab, the slabs' sums added on the lead device (the
    first slab's). ``slabs``: one (path_id, seq, is_add, size, deletion_ts)
    tuple a shard. Returns (alive list, tombstone list, sums (3,) int64)."""
    devices = list(dict.fromkeys(cols[0].device for cols in slabs))
    best = {d: _best_plain(torch.cat([c[0] for c in slabs if c[0].device == d]),
                           torch.cat([c[1] for c in slabs if c[0].device == d]), num_paths)
            for d in devices}
    outs = [_masks_plain(cols, best[cols[0].device], min_retention_ts) for cols in slabs]
    sums = torch.stack([o[2].to(slabs[0][0].device) for o in outs]).sum(dim=0)
    return [o[0] for o in outs], [o[1] for o in outs], sums


def _check_slabs(slabs, num_paths: int):
    """Refuse what K6 does not take. Returns None for slabs on the CPU, else
    each slab's CUDA device index."""
    if not slabs:
        raise ValueError("sharded_replay: no slab")
    where = []
    for cols in slabs:
        shape, g = cols[0].shape, cols[0].get_device()
        for t, d in zip(cols, _COLS):
            if t.dtype != d or t.shape != shape or len(shape) != 1:
                raise TypeError("sharded_replay: each slab is path_id int32, seq/size/"
                                "deletion_ts int64 and is_add bool, 1-D of one length")
            if t.get_device() != g or not t.is_contiguous():
                raise ValueError("sharded_replay: a slab's columns must be contiguous, on "
                                 "one device")
        if shape[0] >= 1 << 31:
            raise ValueError(f"sharded_replay: a slab of {shape[0]} rows: at most 2^31 - 1")
        where.append(g)
    if all(cols[0].device.type == "cpu" for cols in slabs):
        for cols in slabs:
            if cols[0].shape[0] and int(cols[0].max()) >= num_paths:
                raise ValueError(f"sharded_replay: a path id reaches num_paths={num_paths}")
        return None
    if not all(cols[0].is_cuda for cols in slabs):
        raise ValueError("sharded_replay: the slabs must all be on the card, or all on the CPU")
    if max(where.count(g) for g in set(where)) > _MAX_SHARDS:
        raise ValueError(f"sharded_replay: more than {_MAX_SHARDS} slabs on one device")
    return where


def _sharded_launch(slabs, num_paths: int, min_retention_ts: int, where=None):
    """K6 on the card with no synchronisation (a CUDA graph can hold it):
    one launch a distinct device over all its slabs (``where``: each slab's
    device index), each writing its slabs' sums row; across devices the
    rows are added on the lead device by one combine launch, and where one
    device holds every slab its row is the answer. Returns
    (alive list, tombstone list, the (4,) int64 words on the lead: files,
    bytes, tombstones, ids >= num_paths; [(a device's slab indices, its
    _Launch)])."""
    from delta_tpu_torch.parallel import mesh as mesh_mod

    if where is None:
        where = [cols[0].get_device() for cols in slabs]
    groups = {}
    for i, g in enumerate(where):
        groups.setdefault(g, []).append(i)
    parts = list(groups.values())
    outs = mesh_mod.run_shards(
        [slabs[idx[0]][0].device for idx in parts],
        lambda k, _dev: _launch("sharded_replay", [slabs[i] for i in parts[k]], num_paths,
                                min_retention_ts))
    alive, tombstone = [None] * len(slabs), [None] * len(slabs)
    for idx, out in zip(parts, outs):
        for j, i in enumerate(idx):
            alive[i], tombstone[i] = out.alive[j], out.tombstone[j]
    if len(outs) == 1:
        words = outs[0].total
    else:
        words = mesh_mod.psum([out.total for out in outs], "sum")
    return alive, tombstone, words, list(zip(parts, outs))


def _sharded_replay(slabs, num_paths: int, min_retention_ts: int):
    """:func:`sharded_replay`, the sums as host ints (the call's one
    download on the card, with the count of bad ids), and the masks as
    ``[(slab indices, (2, their rows) bool: alive, then tombstone)]``: one
    buffer a distinct device on the card, one a slab for the plain version."""
    where = _check_slabs(slabs, num_paths)
    if where is None:
        alive, tombstone, sums = sharded_replay_plain(slabs, num_paths, min_retention_ts)
        return (alive, tombstone, sums, sums.tolist(),
                [([i], torch.stack(m)) for i, m in enumerate(zip(alive, tombstone))])
    alive, tombstone, words, outs = _sharded_launch(slabs, num_paths, min_retention_ts, where)
    host = words.cpu().tolist()
    _raise_bad("sharded_replay", host, num_paths)
    return alive, tombstone, words[:3], host[:3], [(idx, out.masks) for idx, out in outs]


def sharded_replay(slabs, num_paths: int, min_retention_ts: int = 0):
    """K6: the shards' slabs (each a (path_id int32, seq int64, is_add bool,
    size int64, deletion_ts int64) tuple of one length, on that shard's
    device), ids global (below ``num_paths``; raises otherwise), every path
    on one slab (:func:`_bucket_by_path`). On the card: one launch a
    distinct device (at most 64 slabs a device) replays all its slabs
    against one winner table and sums them, the combine kernel adds the
    devices' sums on the lead device (the first slab's) where there are
    several, and one download of the sums and the count of bad ids is the
    call's one synchronisation. Returns (alive list, tombstone list, sums
    (3,) int64: live files, their bytes, tombstones). The plain version for
    slabs on the CPU."""
    alive, tombstone, sums = _sharded_replay(slabs, num_paths, min_retention_ts)[:3]
    # its own copy: on one device the sums share their buffer with the
    # winner table
    return alive, tombstone, sums.clone()


def replay_sharded(arrays, mesh, min_retention_ts: int = 0) -> ReplayResult:
    """Replay an action stream sharded over ``mesh`` (a list of devices,
    ``parallel/mesh.state_mesh``): the host buckets the rows by path, each
    device receives its shards' slabs as one ``(shards, cap)`` tensor a
    column (each slab a row of it), K6 replays every device's shards in one
    launch, which also sums them, the combine kernel adds the devices' sums
    on the lead device where there are several, and the
    host downloads the sums and one mask buffer a device, then unscatters
    the masks to the input order. Equal to :func:`replay_alive_mask` on the
    same stream."""
    n = len(mesh)
    stacked, order, dest = _bucket_by_path(arrays, n)
    cap = stacked[0].shape[1]
    devices = list(dict.fromkeys(mesh))
    slabs = [None] * n
    for d in devices:
        idx = [i for i, m in enumerate(mesh) if m == d]
        cols = [torch.from_numpy(col if len(idx) == n else col[idx]).to(d) for col in stacked]
        for j, i in enumerate(idx):
            slabs[i] = tuple(c[j] for c in cols)
    # ids are global: the winner table spans the dictionary (or the largest
    # id, for a stream built without one)
    pid = np.asarray(arrays.path_id)
    num_paths = max(len(arrays.paths), int(pid.max()) + 1 if len(pid) else 0)
    _, _, _, (files, size, tombs), parts = _sharded_replay(slabs, num_paths,
                                                            int(min_retention_ts))
    flat = np.empty((2, n, cap), bool)  # the alive and tombstone slabs in shard order
    for idx, masks in parts:  # one download a device: its slabs, each cap rows
        flat[:, idx] = masks.cpu().numpy().reshape(2, len(idx), cap)
    alive = np.zeros(arrays.num_rows, bool)
    tombstone = np.zeros(arrays.num_rows, bool)
    alive[order] = flat[0].reshape(-1)[dest]
    tombstone[order] = flat[1].reshape(-1)[dest]
    return ReplayResult(alive, tombstone,
                        ReplayStats(np.int32(files), np.int64(size), np.int32(tombs)))

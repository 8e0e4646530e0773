"""Action streams for the replay kernels K5 and K6, as numpy columns.

Imports numpy and ``delta_tpu_torch`` only, so the GPU tests (which run
where JAX cannot be imported) and the CPU tests (which hand the same
columns to ``delta_tpu``) share them. ``replay_stream(name, shards)``
returns a dict of ``ReplayArrays`` fields; ``name`` is one of
:data:`STREAM_NAMES`:

* ``all-pad-shard``: zipf-skewed paths of which none hashes to the last of
  ``shards`` shards, so that shard's slab is all pads;
* ``hot-path``: one path with 100,000 actions among 20,000 others;
* ``seq-extremes``: ``seq`` over the whole int64 range, with a path whose
  only row is at ``INT64_MIN`` (it wins), a path whose ``INT64_MIN`` row
  loses to a later one, and a row at ``INT64_MAX``: the sign-flipped slot
  encoding of the winner table;
* ``no-paths``: no row, ``num_paths = 0``;
* ``wrapping-sizes``: sizes near 2^62 whose int64 sum wraps.

``seq`` is unique in every stream, as ``actions_to_arrays`` makes it.
"""
import numpy as np

from delta_tpu_torch.ops.replay_kernel import _mix64

I64_MIN, I64_MAX = np.iinfo(np.int64).min, np.iinfo(np.int64).max
STREAM_NAMES = ["all-pad-shard", "hot-path", "seq-extremes", "no-paths", "wrapping-sizes"]


def _cols(rng, pid, seq, n_paths):
    n = len(pid)
    return dict(paths=[f"p{i}" for i in range(n_paths)], path_id=pid.astype(np.int32),
                seq=seq.astype(np.int64), is_add=rng.rand(n) > 0.3,
                size=rng.randint(0, 1 << 40, n).astype(np.int64),
                deletion_timestamp=rng.randint(0, 2000, n).astype(np.int64))


def replay_stream(name: str, shards: int) -> dict:
    rng = np.random.RandomState(STREAM_NAMES.index(name) * 100 + shards)
    if name == "all-pad-shard":
        n, n_paths = 20_000, 4_000
        ids = np.arange(n_paths, dtype=np.int64)
        ids = ids[(_mix64(ids) % np.uint64(shards)) != shards - 1]
        probs = 1.0 / np.arange(1, len(ids) + 1, dtype=np.float64)
        pid = ids[rng.choice(len(ids), n, p=probs / probs.sum())]
        return _cols(rng, pid, (rng.permutation(n).astype(np.int64) << 8) + 7, n_paths)
    if name == "hot-path":
        n, n_paths = 120_000, 20_001
        pid = np.concatenate([np.zeros(100_000, np.int64), rng.randint(1, n_paths, n - 100_000)])
        pid = pid[rng.permutation(n)]
        return _cols(rng, pid, rng.permutation(n).astype(np.int64) * 3 - (1 << 40), n_paths)
    if name == "seq-extremes":
        n, n_paths = 4096, 1000
        seq = np.unique(rng.randint(I64_MIN + 1, I64_MAX, 2 * n, dtype=np.int64))
        seq = seq[rng.permutation(len(seq))[:n]]
        pid = rng.randint(0, n_paths - 1, n)
        pid[0], seq[0] = n_paths - 1, I64_MIN  # a path's only row: it wins
        pid[1], seq[1] = pid[2], I64_MIN + 1  # below its path's other rows
        pid[3], seq[3] = pid[4], I64_MAX  # above its path's other rows
        cols = _cols(rng, pid, seq, n_paths)
        cols["is_add"][[0, 3]] = True
        return cols
    if name == "no-paths":
        return _cols(rng, np.zeros(0, np.int64), np.zeros(0, np.int64), 0)
    if name == "wrapping-sizes":
        n, n_paths = 8192, 2000
        cols = _cols(rng, rng.randint(0, n_paths, n), rng.permutation(n).astype(np.int64),
                     n_paths)
        cols["size"] = rng.randint(2**61, 2**62, n).astype(np.int64)
        cols["is_add"][:] = rng.rand(n) > 0.05
        return cols
    raise KeyError(name)

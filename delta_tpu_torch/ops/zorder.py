"""Z-order (Morton) clustering keys (the port's own copy of
``delta_tpu.ops.zorder``).

Each clustering column is rank-normalized to 16 bits on the host
(:func:`rank_u16`), the ranks are bit-interleaved into one 64-bit Morton key
per row on the card (K16, ``csrc/morton.cu``, :func:`interleave`), and the
rows sort by that key on the host. Sorting by Morton keys makes per-file
min/max boxes compact in every clustered dimension, which is what the
skipping predicate (``ops/pruning``) exploits.

Two rules carried over exactly: bit ``b`` of column ``c`` lands at
position ``b*k + c`` and a position of 64 or more is dropped (XLA's
``uint64 << s`` is 0 for ``s >= 64``); and the key sorts as UNSIGNED, so
keys with bit 63 set (k = 4 already sets it) order last. The JAX package's
quiet numpy fallback is not carried over: the interleave runs on the
device the caller names.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from delta_tpu_torch.ops import native

__all__ = ["rank_u16", "interleave", "interleave_plain", "morton_order"]

_BITS = 16


def rank_u16(values: np.ndarray) -> np.ndarray:
    """Rank a column (stable, ties by position) and scale into [0, 2^16):
    order-preserving and type-agnostic (strings sort on the host)."""
    order = np.argsort(values, kind="stable")
    ranks = np.empty(len(values), np.int64)
    ranks[order] = np.arange(len(values))
    n = max(len(values) - 1, 1)
    return ((ranks * ((1 << _BITS) - 1)) // n).astype(np.uint32)


def _check(ranks: torch.Tensor) -> None:
    if ranks.dim() != 2 or ranks.dtype != torch.int32 or not ranks.is_contiguous():
        raise ValueError("interleave: ranks must be a contiguous (k, n) int32 tensor")


def interleave(ranks: torch.Tensor) -> torch.Tensor:
    """The Morton key (int64 bit pattern) of each column of ``ranks`` ((k, n)
    int32, each below 2^16): K16 for a CUDA tensor, the plain version for a
    CPU one."""
    _check(ranks)
    if ranks.device.type == "cpu":
        return interleave_plain(ranks)
    k, n = ranks.shape
    key = torch.empty(n, dtype=torch.int64, device=ranks.device)
    native.call("morton", ranks.device, ranks.data_ptr(), k, n, key.data_ptr())
    native.launches["morton"] += 1
    return key


def interleave_plain(ranks: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K16: the 16 x k shifts in int64, bits whose
    position is 64 or more dropped."""
    _check(ranks)
    k, n = ranks.shape
    r = ranks.to(torch.int64)
    key = torch.zeros(n, dtype=torch.int64, device=ranks.device)
    for b in range(_BITS):
        for c in range(k):
            s = b * k + c
            if s < 64:
                key |= ((r[c] >> b) & 1) << s
    return key


def morton_order(columns: Sequence[np.ndarray], device="cuda") -> np.ndarray:
    """Row permutation sorting by the interleaved (Morton) key of the given
    columns' ranks: ranks on the host, the interleave on ``device``, the
    stable argsort of the unsigned key on the host."""
    k = len(columns)
    if k == 0:
        raise ValueError("morton_order needs at least one column")
    ranks = np.stack([rank_u16(c) for c in columns]).astype(np.int32)
    key = interleave(torch.from_numpy(ranks).to(device)).cpu().numpy()
    return np.argsort(key.view(np.uint64), kind="stable")

"""Z-order (Morton) clustering keys (the port's own copy of
``delta_tpu.ops.zorder``).

Each clustering column is rank-normalized to 16 bits, the ranks are
bit-interleaved into one 64-bit Morton key per row (K16, ``csrc/morton.cu``,
:func:`interleave`), and the rows sort by that key. Sorting by Morton keys
makes per-file min/max boxes compact in every clustered dimension, which is
what the skipping predicate (``ops/pruning``) exploits.

:func:`morton_order` runs on the device the caller names. On the card the
key never comes back: an integer column (the integer, date and timestamp
kinds) is ranked there (:func:`rank_column`, a stable radix sort whose sink
writes the scaled rank), a float or string column is ranked on the host
(:func:`rank_u16`: the order of NaN and -0.0, and strings, stay numpy's),
K16 interleaves, the key is sorted there (:func:`key_order`, the same radix
sort), and only the int32 permutation is downloaded. On the CPU the same
steps run their plain versions (``torch.sort(stable=True)``).

Two rules carried over exactly: bit ``b`` of column ``c`` lands at
position ``b*k + c`` and a position of 64 or more is dropped (XLA's
``uint64 << s`` is 0 for ``s >= 64``); and the key sorts as UNSIGNED, so
keys with bit 63 set (k = 4 already sets it) order last. The JAX package's
quiet numpy fallback is not carried over: the work runs on the device the
caller names.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from delta_tpu_torch.ops import native

__all__ = ["rank_u16", "rank_column", "rank_column_plain", "interleave", "interleave_plain",
           "key_order", "key_order_plain", "morton_order"]

_BITS = 16
_SCALE = (1 << _BITS) - 1
_I64_MIN = -(1 << 63)


def rank_u16(values: np.ndarray) -> np.ndarray:
    """Rank a column (stable, ties by position) and scale into [0, 2^16):
    order-preserving and type-agnostic (strings sort on the host)."""
    order = np.argsort(values, kind="stable")
    ranks = np.empty(len(values), np.int64)
    ranks[order] = np.arange(len(values))
    n = max(len(values) - 1, 1)
    return ((ranks * _SCALE) // n).astype(np.uint32)


def _check_sortable(name: str, t: torch.Tensor, dtypes) -> None:
    if t.dim() != 1 or t.dtype not in dtypes or not t.is_contiguous():
        raise TypeError(f"{name}: a contiguous 1-D {' or '.join(map(str, dtypes))} tensor, "
                        f"got {tuple(t.shape)} {t.dtype}")
    if t.shape[0] >= 1 << 31:
        raise ValueError(f"{name}: {t.shape[0]} rows: at most 2^31 - 1 (the sort's row tag)")


def _sort_scratch(n: int, dev) -> torch.Tensor:
    from delta_tpu_torch.ops.key_cache import _radix_scratch_bytes

    return torch.empty(_radix_scratch_bytes(n), dtype=torch.uint8, device=dev)


def rank_column_plain(values: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the device rank: the stable sort's position
    of each row, scaled as :func:`rank_u16` scales it, as int32."""
    n = values.shape[0]
    order = torch.sort(values, stable=True).indices
    pos = torch.empty(n, dtype=torch.int64, device=values.device)
    pos[order] = torch.arange(n, dtype=torch.int64, device=values.device)
    return (pos * _SCALE // max(n - 1, 1)).to(torch.int32)


def rank_column(values: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`rank_u16` of an integer column, on its device: ``values``
    ``(n,)`` int32 or int64; returns ``(n,)`` int32 ranks, written into
    ``out`` when given (a contiguous int32 view, e.g. a row of the ranks
    K16 reads). On the card one stable radix sort whose sink writes each
    row's scaled rank (it synchronises the stream once); the plain version
    for a tensor on the CPU."""
    _check_sortable("rank_column", values, (torch.int32, torch.int64))
    n = values.shape[0]
    if out is not None and (out.shape != (n,) or out.dtype != torch.int32
                            or not out.is_contiguous() or out.device != values.device):
        raise ValueError("rank_column: out must be a contiguous (n,) int32 tensor on the "
                         "values' device")
    if values.device.type == "cpu":
        ranks = rank_column_plain(values)
        return ranks if out is None else out.copy_(ranks)
    ranks = out if out is not None else torch.empty(n, dtype=torch.int32, device=values.device)
    if n:
        scratch = _sort_scratch(n, values.device)
        native.call("morton_rank", values.device, values.data_ptr(),
                    1 if values.dtype == torch.int32 else 0, n, ranks.data_ptr(),
                    scratch.data_ptr(), scratch.numel())
        native.launches["morton_rank"] += 1
    return ranks


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
    if ranks.data_ptr() % 16:
        raise ValueError("interleave: ranks must start on a 16-byte boundary")
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


def key_order_plain(key: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the key sort: the stable order of the
    int64 bit patterns as unsigned (the sign bit flipped, then a signed
    stable sort), as int32."""
    return torch.sort(key ^ _I64_MIN, stable=True).indices.to(torch.int32)


def key_order(key: torch.Tensor) -> torch.Tensor:
    """The stable order of ``key`` ((n,) int64 bit patterns) as UNSIGNED:
    ``np.argsort(key.view(np.uint64), kind="stable")`` as an int32 tensor
    on the key's device. On the card one stable radix sort whose sink
    writes the permutation (it synchronises the stream once); the plain
    version for a tensor on the CPU."""
    _check_sortable("key_order", key, (torch.int64,))
    if key.device.type == "cpu":
        return key_order_plain(key)
    n = key.shape[0]
    perm = torch.empty(n, dtype=torch.int32, device=key.device)
    if n:
        scratch = _sort_scratch(n, key.device)
        native.call("morton_sort", key.device, key.data_ptr(), n, perm.data_ptr(),
                    scratch.data_ptr(), scratch.numel())
        native.launches["morton_sort"] += 1
    return perm


def _device_rankable(values: np.ndarray) -> Optional[np.dtype]:
    """The dtype an integer column goes up as (its order kept exactly), or
    None for a column the host ranks (floats, strings, bools, uint64)."""
    kind, size = values.dtype.kind, values.dtype.itemsize
    if kind == "i":
        return np.dtype(np.int32 if size <= 4 else np.int64)
    if kind == "u" and size <= 4:
        return np.dtype(np.int32 if size <= 2 else np.int64)
    return None


def morton_order(columns: Sequence[np.ndarray], device="cuda") -> np.ndarray:
    """Row permutation (int64) sorting by the interleaved (Morton) key of
    the given columns' ranks: integer columns ranked on ``device``, other
    columns on the host (:func:`rank_u16`), the interleave and the key's
    stable unsigned sort on ``device``; only the permutation comes back."""
    from delta_tpu_torch.utils.device import resolve

    k = len(columns)
    if k == 0:
        raise ValueError("morton_order needs at least one column")
    n = len(columns[0])
    if any(len(c) != n for c in columns):
        raise ValueError("morton_order: the columns must have one length")
    dev = resolve(device)
    ranks = torch.empty((k, n), dtype=torch.int32, device=dev)
    for c, values in enumerate(columns):
        values = np.asarray(values)
        up = _device_rankable(values)
        if up is not None:
            rank_column(torch.from_numpy(np.ascontiguousarray(values, up)).to(dev), out=ranks[c])
        else:
            ranks[c].copy_(torch.from_numpy(rank_u16(values).astype(np.int32)))
    return key_order(interleave(ranks)).cpu().numpy().astype(np.int64)

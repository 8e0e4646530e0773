"""The MERGE join's shared pieces (the port's own copy of
``delta_tpu.ops.join_kernel``, cut to what the resident key slab uses).

:class:`PendingJoin` is the memoizing handle an in-flight device probe
returns (``ops/key_cache.ResidentJoinKeys.probe_async``); :func:`_bucket` is
the pad-size rule of the slab capacity and of the uploaded source lane. The
single-device and sharded join kernels (K12, K13) and the host sort-merge
join belong to a later slice.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

__all__ = ["PendingJoin"]


class PendingJoin:
    """Handle for an in-flight device join; ``.result()`` blocks on the
    device->host transfer and finishes the host side once."""

    def __init__(self, finalize: Callable[[], Any]):
        self._finalize = finalize
        self._result: Optional[Any] = None

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

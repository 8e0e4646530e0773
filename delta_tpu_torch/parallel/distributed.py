"""The host work partitioner (the port's own copy of the pure functions of
``delta_tpu.parallel.distributed``).

Every host computes the same assignment of a global work list with no RPC:
strided by default, size-weighted LPT (longest processing time first) when
byte weights are known (:func:`lpt_assign`). The port runs one process:
:func:`process_info` is ``(0, 1)``, and :func:`initialize` refuses more than
one process until the multi-host slice (a ``torch.distributed`` process
group with the work-stealing executor and its leases) is ported.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

__all__ = ["initialize", "process_info", "host_partition", "host_shard_indices",
           "lpt_assign", "lpt_loads", "bytes_skew"]


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> Tuple[int, int]:
    """Join the multi-host runtime; returns (process_id, num_processes).
    One process is ``(0, 1)``; a cluster raises ``NotImplementedError``."""
    if coordinator_address is not None or num_processes not in (None, 1) \
            or process_id not in (None, 0):
        raise NotImplementedError("delta_tpu_torch runs one process: the multi-host runtime "
                                  "is not ported")
    return 0, 1


def process_info() -> Tuple[int, int]:
    """(process_index, process_count) of the current runtime: ``(0, 1)``."""
    return 0, 1


def lpt_assign(sizes: Sequence[int], count: int) -> List[List[int]]:
    """Deterministic size-weighted LPT assignment of ``len(sizes)`` items
    over ``count`` hosts; returns per-host item-index lists, each sorted.
    Items go largest first (ties by index) to the least-loaded host (ties
    by host id), so every host derives the same assignment."""
    if count <= 1:
        return [list(range(len(sizes)))]
    loads = [0] * count
    buckets: List[List[int]] = [[] for _ in range(count)]
    order = sorted(range(len(sizes)), key=lambda j: (-int(sizes[j] or 0), j))
    for j in order:
        h = min(range(count), key=lambda i: (loads[i], i))
        loads[h] += int(sizes[j] or 0)
        buckets[h].append(j)
    for b in buckets:
        b.sort()
    return buckets


def lpt_loads(sizes: Sequence[int], assignment: Sequence[Sequence[int]]) -> List[int]:
    """Per-bin byte loads of an assignment."""
    return [sum(int(sizes[j] or 0) for j in b) for b in assignment]


def bytes_skew(sizes: Sequence[int], assignment: Sequence[Sequence[int]]) -> float:
    """max / mean per-host bytes of an assignment (1.0 is even)."""
    per_host = lpt_loads(sizes, assignment)
    if not per_host or sum(per_host) == 0:
        return 1.0
    mean = sum(per_host) / len(per_host)
    return max(per_host) / mean if mean else 1.0


def host_shard_indices(n_items: int, index: Optional[int] = None, count: Optional[int] = None,
                       sizes: Optional[Sequence[int]] = None) -> List[int]:
    """This host's item positions in a global work list: strided (host i
    takes i, i + n, ...) without ``sizes``, :func:`lpt_assign` with them.
    ``index`` and ``count`` go together (neither: :func:`process_info`)."""
    if (index is None) != (count is None):
        raise ValueError("host partitioning needs both index and count (or neither)")
    if index is None:
        index, count = process_info()
    if count <= 1:
        return list(range(n_items))
    if sizes is not None:
        if len(sizes) != n_items:
            raise ValueError(f"sizes has {len(sizes)} entries for {n_items} items")
        return lpt_assign(sizes, count)[index]
    return list(range(index, n_items, count))


def host_partition(items: Sequence, index: Optional[int] = None, count: Optional[int] = None,
                   sizes: Optional[Sequence[int]] = None) -> List:
    """This host's slice of a global work list (:func:`host_shard_indices`)."""
    return [items[j] for j in host_shard_indices(len(items), index, count, sizes=sizes)]

"""Per-query scan reports (the port's own copy of
``delta_tpu.obs.scan_report``, cut to the report and its lifecycle).

``exec/scan.scan_to_table`` opens a report (contextvar-scoped, so
concurrent scans on different threads never cross), ``read_files_as_table``
contributes the row-group numbers from the same sums that feed the
``scan.rowgroups.*`` counters, ``ops/column_cache`` marks the scans it
served or its router declined, and the finished report is retrievable with
:func:`last_scan_report`. The workload journal, the layout advisor and the
fired-rewrite attribution are not ported.
"""
from __future__ import annotations

import contextvars
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

__all__ = ["ScanReport", "last_scan_report", "start_report", "current_report", "contribute",
           "finish_report"]


@dataclass
class ScanReport:
    """One query's skipping ledger. Row-group and byte numbers are the exact
    per-scan deltas of the ``scan.rowgroups.*`` / ``scan.bytes.*`` counters."""

    path: str = ""
    version: int = -1
    predicate: Optional[str] = None  # residual predicate (SQL)
    columns: Optional[List[str]] = None
    files_total: int = 0            # snapshot files considered
    files_after_partition: int = 0  # survivors of partition pruning
    files_scanned: int = 0          # survivors of file-tier stats skipping
    row_groups_total: int = 0
    row_groups_pruned: int = 0        # footer-stats tier
    row_groups_late_skipped: int = 0  # late-materialization tier
    #: row groups whose device residual mask came back all False, skipped
    #: without a host decode (ops/column_cache)
    row_groups_device_skipped: int = 0
    bytes_read: int = 0
    bytes_skipped: int = 0
    #: the part of ``bytes_skipped`` the footer-stats planner avoided
    bytes_skipped_planned: int = 0
    #: the part of ``bytes_skipped`` the device mask avoided
    bytes_device_skipped: int = 0
    #: bytes of row groups decoded on the host because the device mask kept
    #: at least one of their rows
    bytes_device_survivor: int = 0
    #: ``"device"`` when the device residual served this scan, ``"host"``
    #: when the router priced the host filter cheaper, else None
    device_residual: Optional[str] = None
    rows_out: int = 0
    phase_ms: Dict[str, int] = field(default_factory=dict)

    @property
    def files_pruned(self) -> int:
        return max(0, self.files_total - self.files_scanned)


_CURRENT: "contextvars.ContextVar[Optional[ScanReport]]" = contextvars.ContextVar(
    "delta_torch_scan_report", default=None)
_LAST_LOCK = threading.Lock()
_LAST: Optional[ScanReport] = None


def start_report(path: str, version: int) -> "contextvars.Token":
    """Open a report for the scan running in this context."""
    return _CURRENT.set(ScanReport(path=path, version=version))


def current_report() -> Optional[ScanReport]:
    """The report being filled by the scan in this context, if any."""
    return _CURRENT.get()


def contribute(**deltas: int) -> None:
    """Add tallies (``ScanReport`` field names) into the in-flight report."""
    rep = _CURRENT.get()
    if rep is None:
        return
    for k, v in deltas.items():
        setattr(rep, k, getattr(rep, k) + v)


def finish_report(token: "contextvars.Token", completed: bool = True) -> Optional[ScanReport]:
    """Close the in-flight report; a completed one becomes
    :func:`last_scan_report` (a failed scan's never does)."""
    global _LAST
    rep = _CURRENT.get()
    _CURRENT.reset(token)
    if rep is not None and completed:
        with _LAST_LOCK:
            _LAST = rep
    return rep


def last_scan_report() -> Optional[ScanReport]:
    with _LAST_LOCK:
        return _LAST

"""Router audit ledger — every routed decision priced against what happened
(the port's own copy of ``delta_tpu.obs.router_audit``).

The link cost model (`parallel/link.py`) decides the MERGE join executor and
the scan-planning device/host pick, but until now nothing measured the miss:
on hardware unlike the bench machine the router silently picks the wrong
side forever. This ledger records one :class:`RouterAudit` per routed
decision — the per-candidate *predicted* costs the router compared, the
*actual* measured duration of the side it chose (from the operation's
existing phase timers), and the hindsight verdict:

    miss = some rejected candidate's predicted cost < the chosen side's
           actual cost

Every audit feeds ``router.predicted_ms`` / ``router.actual_ms`` histograms
(labeled op + decision), the ``router.audits`` / ``router.misses`` counters,
the ``router.missRate`` gauge, and — when calibration is enabled — hands its
attributable ``(constant, units, seconds)`` samples to `obs/calibration` so
the constants re-fit from live traffic. The last N records are kept
(bounded by ``delta.tpu.router.auditKeep``). A ``scan.plan`` audit over a
state mesh of several entries carries a third prediction,
``device-sharded`` (the sharded block cull), and takes that decision when
the plan ran sharded; the miss rule is the same for every route.

Blackout-gated end to end: ``delta.tpu.telemetry.enabled=false`` records
nothing and forwards nothing. The workload journal the JAX package also
feeds is not ported.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from delta_tpu_torch.utils import telemetry
from delta_tpu_torch.utils.config import conf

__all__ = ["RouterAudit", "record_audit", "recent_audits", "clear_audits",
           "audit_stats", "last_audit"]


@dataclass
class RouterAudit:
    """One routed decision: what the router believed, what actually ran."""

    op: str            # "merge.join" | "scan.plan"
    path: str          # table data path
    decision: str      # chosen route (e.g. "host", "resident", "device", "device-sharded")
    predicted_ms: Dict[str, float]  # per candidate route
    actual_ms: float   # measured duration of the chosen route
    miss: bool         # hindsight: a rejected route's prediction beat actual
    units: Dict[str, float] = field(default_factory=dict)  # workload sizes
    extra: Dict[str, Any] = field(default_factory=dict)
    timestamp_ms: int = 0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "op": self.op,
            "path": self.path,
            "decision": self.decision,
            "predictedMs": {k: round(v, 3) for k, v in self.predicted_ms.items()},
            "actualMs": round(self.actual_ms, 3),
            "miss": self.miss,
            "units": dict(self.units),
            "extra": dict(self.extra),
            "timestamp": self.timestamp_ms,
        }


_LOCK = threading.Lock()
_AUDITS: "deque[RouterAudit]" = deque(maxlen=256)
_COUNTS = {"audits": 0, "misses": 0}


def _keep() -> int:
    try:
        n = int(conf.get("delta.tpu.router.auditKeep", 256))
    except (TypeError, ValueError):
        n = 256
    return n if n > 0 else 256


def record_audit(op: str, path: str, decision: str,
                 predicted_s: Dict[str, float], actual_s: float,
                 units: Optional[Dict[str, float]] = None,
                 samples: Sequence[Tuple[str, float, float]] = (),
                 log_path: Optional[str] = None,
                 calibration_flush: bool = True,
                 **extra: Any) -> Optional[RouterAudit]:
    """Record one routed decision (costs in SECONDS, stored in ms). Returns
    the audit, or None under a telemetry blackout. ``samples`` and
    ``log_path`` flow to `obs/calibration.ingest` (a no-op unless
    calibration is enabled); hot-path callers pass
    ``calibration_flush=False`` so the calibrator's state-file write is
    interval-throttled instead of per-decision."""
    if not conf.get_bool("delta.tpu.telemetry.enabled", True):
        return None
    predicted_ms = {k: float(v) * 1000.0 for k, v in predicted_s.items()}
    actual_ms = float(actual_s) * 1000.0
    chosen_pred = predicted_ms.get(decision)
    miss = any(v < actual_ms for k, v in predicted_ms.items() if k != decision)
    audit = RouterAudit(
        op=op, path=path, decision=decision, predicted_ms=predicted_ms,
        actual_ms=actual_ms, miss=miss, units=dict(units or {}),
        extra=dict(extra), timestamp_ms=int(time.time() * 1000),
    )
    keep = _keep()
    with _LOCK:
        global _AUDITS
        if _AUDITS.maxlen != keep:
            _AUDITS = deque(_AUDITS, maxlen=keep)
        _AUDITS.append(audit)
        _COUNTS["audits"] += 1
        if miss:
            _COUNTS["misses"] += 1
        rate = _COUNTS["misses"] / _COUNTS["audits"]
    telemetry.bump_counter("router.audits")
    if miss:
        telemetry.bump_counter("router.misses")
    telemetry.set_gauge("router.missRate", round(rate, 4))
    if chosen_pred is not None:
        telemetry.observe("router.predicted_ms", chosen_pred,
                          op=op, decision=decision)
    telemetry.observe("router.actual_ms", actual_ms, op=op, decision=decision)
    telemetry.record_event("delta.router.audit", audit.to_dict(), path=path)
    if samples:
        from delta_tpu_torch.obs import calibration

        calibration.ingest(samples, log_path=log_path,
                           flush=calibration_flush)
    return audit


def last_audit() -> Optional[RouterAudit]:
    """The most recently recorded audit, if any."""
    with _LOCK:
        return _AUDITS[-1] if _AUDITS else None


def recent_audits(limit: int = 32) -> List[Dict[str, Any]]:
    """The last ``limit`` audit records, oldest first, as JSON-able dicts."""
    with _LOCK:
        records = list(_AUDITS)
    if limit > 0:
        records = records[-limit:]
    return [a.to_dict() for a in records]


def audit_stats() -> Dict[str, Any]:
    """Totals since process start (or :func:`clear_audits`)."""
    with _LOCK:
        audits, misses = _COUNTS["audits"], _COUNTS["misses"]
    return {
        "audits": audits,
        "misses": misses,
        "missRate": round(misses / audits, 4) if audits else 0.0,
    }


def clear_audits() -> None:
    with _LOCK:
        _AUDITS.clear()
        _COUNTS["audits"] = _COUNTS["misses"] = 0

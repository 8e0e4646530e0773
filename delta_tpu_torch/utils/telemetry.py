"""Process-wide counters, gauges, histograms and a bounded event ring (the
port's own copy of part of ``delta_tpu.utils.telemetry``).

* counters (:func:`bump_counter`, :func:`counters`): the read path's
  ``scan.*``, ``scan.device.*`` and ``columnCache.*`` and the router's
  ``merge.device.*`` and ``router.*`` tallies and the state mesh's
  ``dist.plan.sharded`` (a plan batch served by the sharded block cull),
  under the JAX package's names (``dist.degraded.*`` has no counterpart:
  where the JAX package degrades a failed sharded plan to the host, the
  port raises). Label-free, and live even under a telemetry blackout;
* gauges (:func:`set_gauge`, :func:`gauges`) and histograms
  (:func:`observe`, :func:`histograms`), keyed by name and labels: the
  router audit's ``router.missRate``, ``router.predicted_ms`` and
  ``router.actual_ms``, the calibrator's ``router.calibration``. A
  histogram keeps a summary of bounded size (count, sum, min, max), not the
  samples;
* events (:func:`record_event`, :func:`recent_events`): a ring of the last
  4096 events, recorded only while ``delta.tpu.telemetry.enabled`` holds.

Spans, traces and the Prometheus exposition are not ported.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Tuple

__all__ = ["bump_counter", "counters", "clear_counters", "set_gauge", "gauges", "observe",
           "histograms", "UsageEvent", "record_event", "recent_events", "reset_all"]

_LOCK = threading.Lock()
_COUNTERS: Dict[str, int] = {}


def _prefix_match(name: str, prefix: str) -> bool:
    """Dotted-name boundary match: ``"scan.device"`` matches itself and
    ``scan.device.*`` but not ``scan.deviceFoo``."""
    return not prefix or name == prefix or name.startswith(prefix + ".")


def bump_counter(name: str, by: int = 1) -> None:
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + by


def counters(prefix: str = "") -> Dict[str, int]:
    with _LOCK:
        return {k: v for k, v in _COUNTERS.items() if _prefix_match(k, prefix)}


def clear_counters() -> None:
    with _LOCK:
        _COUNTERS.clear()


# -- gauges + histograms -------------------------------------------------------------

LabelKey = Tuple[str, Tuple[Tuple[str, str], ...]]


class _Histogram:
    """A bounded summary of observed values."""

    __slots__ = ("count", "sum", "min", "max")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")


_GAUGES: Dict[LabelKey, float] = {}
_HISTOGRAMS: Dict[LabelKey, _Histogram] = {}


def _label_key(name: str, labels: Dict[str, Any]) -> LabelKey:
    return name, tuple(sorted((k, str(v)) for k, v in labels.items()))


def set_gauge(name: str, value: float, **labels: str) -> None:
    with _LOCK:
        _GAUGES[_label_key(name, labels)] = float(value)


def gauges(prefix: str = "") -> Dict[LabelKey, float]:
    with _LOCK:
        return {k: v for k, v in _GAUGES.items() if _prefix_match(k[0], prefix)}


def observe(name: str, value: float, **labels: str) -> None:
    """Fold ``value`` into the histogram ``name`` (with ``labels``)."""
    value = float(value)
    key = _label_key(name, labels)
    with _LOCK:
        h = _HISTOGRAMS.get(key)
        if h is None:
            h = _HISTOGRAMS[key] = _Histogram()
        h.count += 1
        h.sum += value
        h.min = min(h.min, value)
        h.max = max(h.max, value)


def histograms(prefix: str = "") -> Dict[LabelKey, _Histogram]:
    with _LOCK:
        return {k: v for k, v in _HISTOGRAMS.items() if _prefix_match(k[0], prefix)}


# -- events --------------------------------------------------------------------------


@dataclass
class UsageEvent:
    op_type: str
    timestamp_ms: int
    tags: Dict[str, str] = field(default_factory=dict)
    data: Dict[str, Any] = field(default_factory=dict)


_BUFFER: Deque[UsageEvent] = deque(maxlen=4096)


def record_event(op_type: str, data: Optional[Dict[str, Any]] = None, **tags: str) -> None:
    """Append one event to the ring; nothing under a telemetry blackout
    (``delta.tpu.telemetry.enabled=false``)."""
    from delta_tpu_torch.utils.config import conf

    if not conf.get_bool("delta.tpu.telemetry.enabled", True):
        return
    ev = UsageEvent(op_type, int(time.time() * 1000),
                    tags={k: str(v) for k, v in tags.items()}, data=data or {})
    with _LOCK:
        _BUFFER.append(ev)


def recent_events(op_prefix: str = "") -> List[UsageEvent]:
    with _LOCK:
        return [e for e in _BUFFER if _prefix_match(e.op_type, op_prefix)]


def reset_all() -> None:
    """Events, counters, gauges and histograms back to empty (tests)."""
    with _LOCK:
        _BUFFER.clear()
        _COUNTERS.clear()
        _GAUGES.clear()
        _HISTOGRAMS.clear()

"""Process-wide counters (the port's own copy of ``delta_tpu.utils.telemetry``,
cut to :func:`bump_counter`, :func:`counters` and :func:`clear_counters`).

The read path bumps the ``scan.*``, ``scan.device.*`` and ``columnCache.*``
counters the JAX package bumps, under the same names. Spans, gauges and
histograms are not ported.
"""
from __future__ import annotations

import threading
from typing import Dict

__all__ = ["bump_counter", "counters", "clear_counters"]

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

"""Self-calibrating cost model — EWMA re-fit of the link constants (the
port's own copy of ``delta_tpu.obs.calibration``; its state file has the
same format, so each package reads the file the other wrote).

The router constants in `parallel/link.py` (host join/decode per-row rates,
resident-probe and prune cell rates) were measured on one bench machine; on
different hardware the router silently picks the wrong side and nothing
corrects it. This module closes the loop: the router audit ledger
(`obs/router_audit`) hands each routed decision's attributable samples —
``(constant_name, units_of_work, measured_seconds)`` — to
:func:`ingest`, which EWMA-blends the implied per-unit rate into a running
estimate and, once a constant has ``delta.tpu.router.calibration.minSamples``
observations, installs it as a live override via ``link.set_calibrated`` —
so routing self-corrects on new hardware without a code change.

Strictly opt-in (``delta.tpu.router.calibration.enabled``, default off) and
blackout-gated: with telemetry disabled nothing is fitted or written.

State persists to a small JSON file so calibration survives the process:
``delta.tpu.router.calibration.statePath`` when set, else
``<table log dir>/.router_calibration.json`` next to the log that produced
the samples (local paths only — object-store tables need the conf'd path).
Each ingest seeds constants this process hasn't sampled from the file (the
read is skipped while its mtime is unchanged since our last load/save),
folds the new samples in, re-applies the overrides, and writes it back —
a fresh DeltaLog on the same table resumes exactly where the last process
left off. Delete the file (or flip the conf off and call :func:`reset`) to
return to the shipped defaults.

Hot-path callers (the scan planner audits once per planned query) pass
``flush=False``: the write is then throttled to at most one per
``delta.tpu.router.calibration.flushIntervalMs`` (default 2000), with
deferred state flushed by the next qualifying ingest or :func:`apply_state`
— so calibration never puts a per-query file write on the planning path it
is calibrating.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Optional, Sequence, Tuple

from delta_tpu_torch.parallel import link
from delta_tpu_torch.utils import telemetry
from delta_tpu_torch.utils.config import conf

__all__ = ["enabled", "ingest", "state_path", "load_state", "save_state",
           "apply_state", "current_state", "reset"]

STATE_FILE = ".router_calibration.json"
_STATE_VERSION = 1

_LOCK = threading.Lock()
# constant name -> {"value": s_per_unit, "samples": int}
_STATE: Dict[str, Dict[str, float]] = {}
# per-path disk sync bookkeeping (all under _LOCK):
_SYNC_MTIME: Dict[str, int] = {}    # mtime_ns at our last load/save
_LAST_SAVE: Dict[str, float] = {}   # time.monotonic() of our last save
_DIRTY: set = set()                 # paths with unflushed in-memory state


def enabled() -> bool:
    return (conf.get_bool("delta.tpu.router.calibration.enabled", False)
            and conf.get_bool("delta.tpu.telemetry.enabled", True))


def _alpha() -> float:
    try:
        a = float(conf.get("delta.tpu.router.calibration.alpha", 0.2))
    except (TypeError, ValueError):
        a = 0.2
    return min(max(a, 0.01), 1.0)


def _min_samples() -> int:
    try:
        return max(int(conf.get("delta.tpu.router.calibration.minSamples", 3)), 1)
    except (TypeError, ValueError):
        return 3


def _flush_interval_s() -> float:
    try:
        ms = float(conf.get(
            "delta.tpu.router.calibration.flushIntervalMs", 2000))
    except (TypeError, ValueError):
        ms = 2000.0
    return max(ms, 0.0) / 1000.0


def state_path(log_path: Optional[str] = None) -> Optional[str]:
    """Where calibration state persists: the conf'd path wins; else the
    table's log dir (local paths only); else None (in-memory only)."""
    p = conf.get("delta.tpu.router.calibration.statePath")
    if p:
        return str(p)
    if log_path and "://" not in log_path:
        return os.path.join(log_path, STATE_FILE)
    return None


def load_state(path: str) -> Dict[str, Dict[str, float]]:
    """Parse a state file; unknown constants and malformed entries are
    dropped (an old file must never poison routing)."""
    try:
        with open(path, encoding="utf-8") as f:
            raw = json.load(f)
        out: Dict[str, Dict[str, float]] = {}
        for name, ent in (raw.get("constants") or {}).items():
            if name not in link.CALIBRATABLE:
                continue
            value = float(ent["value"])
            samples = int(ent.get("samples", 1))
            if value > 0.0 and samples > 0:
                out[name] = {"value": value, "samples": samples}
        return out
    except (OSError, ValueError, TypeError, KeyError):
        return {}


def save_state(path: str, state: Dict[str, Dict[str, float]]) -> bool:
    """Atomic-enough JSON write (tmp + rename); best-effort — a read-only
    log dir downgrades persistence, never fails the operation."""
    import uuid

    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        # uuid-suffixed like logstore.write_bytes: _persist runs outside
        # _LOCK, so concurrent savers must not share (and finally-unlink)
        # one tmp name out from under each other
        tmp = f"{path}.{uuid.uuid4().hex}.tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump({"version": _STATE_VERSION, "constants": state}, f,
                          indent=1, sort_keys=True)
            os.replace(tmp, path)
        finally:
            try:
                os.unlink(tmp)  # no-op after a successful replace
            except OSError:
                pass
        return True
    except OSError:
        return False


def _seed_locked(path: str) -> None:
    """Merge on-disk constants this process hasn't (or has less-well)
    sampled into ``_STATE`` — skipped entirely while the file's mtime is
    unchanged since our last load/save, so steady-state ingests pay one
    ``stat``, not a JSON parse. Callers hold ``_LOCK``."""
    try:
        mtime = os.stat(path).st_mtime_ns
    except OSError:
        return
    if _SYNC_MTIME.get(path) == mtime:
        return
    for name, ent in load_state(path).items():
        cur = _STATE.get(name)
        if cur is None or cur["samples"] < ent["samples"]:
            _STATE[name] = dict(ent)
    _SYNC_MTIME[path] = mtime


def _persist(path: str, state: Dict[str, Dict[str, float]]) -> None:
    """Write the state file and record the sync point (the IO runs outside
    ``_LOCK``; only the bookkeeping re-takes it)."""
    if not save_state(path, state):
        return
    try:
        mtime = os.stat(path).st_mtime_ns
    except OSError:
        mtime = None
    with _LOCK:
        if mtime is not None:
            _SYNC_MTIME[path] = mtime
        _LAST_SAVE[path] = time.monotonic()
        _DIRTY.discard(path)


def _apply_locked() -> None:
    """Install every sufficiently-sampled constant as a link override and
    publish its gauge. Callers hold ``_LOCK``."""
    min_n = _min_samples()
    for name, ent in _STATE.items():
        if ent["samples"] >= min_n:
            try:
                link.set_calibrated(name, ent["value"])
            except ValueError:
                continue
            telemetry.set_gauge("router.calibration", ent["value"],
                                constant=name)


def apply_state(log_path: Optional[str] = None) -> Dict[str, Dict[str, float]]:
    """Load persisted state (merging constants this process hasn't sampled)
    and install the overrides — the fresh-process resume path. No-op unless
    :func:`enabled`."""
    if not enabled():
        return {}
    path = state_path(log_path)
    with _LOCK:
        if path is not None:
            _seed_locked(path)
        _apply_locked()
        state = {k: dict(v) for k, v in _STATE.items()}
        flush_dirty = path is not None and path in _DIRTY
    if flush_dirty:
        _persist(path, state)
    return state


def ingest(samples: Sequence[Tuple[str, float, float]],
           log_path: Optional[str] = None,
           flush: bool = True) -> Optional[Dict[str, Any]]:
    """Fold observed ``(constant_name, units, seconds)`` samples into the
    EWMA state, install matured overrides, and persist. Returns the updated
    state, or None when calibration is off / no sample was usable.
    ``flush=False`` (hot-path callers) defers the state-file write to the
    flush-interval throttle instead of paying it per call."""
    if not enabled() or not samples:
        return None
    alpha = _alpha()
    path = state_path(log_path)
    used = 0
    with _LOCK:
        if path is not None:
            # seed from disk first so a fresh process continues the fit
            _seed_locked(path)
        for name, units, seconds in samples:
            if name not in link.CALIBRATABLE:
                continue
            try:
                units = float(units)
                seconds = float(seconds)
            except (TypeError, ValueError):
                continue
            if units <= 0 or seconds <= 0:
                continue
            rate = seconds / units
            cur = _STATE.get(name)
            if cur is None:
                _STATE[name] = {"value": rate, "samples": 1}
            else:
                cur["value"] = alpha * rate + (1.0 - alpha) * cur["value"]
                cur["samples"] += 1
            used += 1
        if not used:
            return None
        _apply_locked()
        state = {k: dict(v) for k, v in _STATE.items()}
        last_save = _LAST_SAVE.get(path) if path is not None else None
        do_save = path is not None and (
            flush or last_save is None
            or time.monotonic() - last_save >= _flush_interval_s())
        if path is not None and not do_save:
            _DIRTY.add(path)
    telemetry.bump_counter("router.calibration.updates", used)
    if do_save:
        _persist(path, state)
    return state


def current_state() -> Dict[str, Dict[str, float]]:
    """The in-memory EWMA state (value + sample count per constant)."""
    with _LOCK:
        return {k: dict(v) for k, v in _STATE.items()}


def reset() -> None:
    """Drop in-memory state and the installed link overrides (tests).
    Persisted files are left alone — delete them to reset a deployment."""
    with _LOCK:
        _STATE.clear()
        _SYNC_MTIME.clear()
        _LAST_SAVE.clear()
        _DIRTY.clear()
    link.clear_calibrated()

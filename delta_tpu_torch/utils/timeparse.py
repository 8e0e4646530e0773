"""Timestamp parsing shared by the expression language and every surface
that takes a point in time (time-travel reads, RESTORE ... TO TIMESTAMP):
the port's own copy of ``delta_tpu.utils.timeparse``. Epoch milliseconds
(int, float or a numeric string) or ISO-8601, naive values ARE UTC."""
from __future__ import annotations

import datetime as _dt

from delta_tpu_torch.utils import errors

__all__ = ["iso_to_naive_utc", "iso_to_date", "timestamp_option_to_ms"]


def iso_to_naive_utc(s: str) -> _dt.datetime:
    """ISO-8601 -> naive datetime in UTC. 'Z' and explicit offsets convert
    to UTC before the tzinfo is dropped."""
    out = _dt.datetime.fromisoformat(
        str(s).strip().replace(" ", "T").replace("Z", "+00:00"))
    if out.tzinfo is not None:
        out = out.astimezone(_dt.timezone.utc).replace(tzinfo=None)
    return out


def iso_to_date(s: str) -> _dt.date:
    return _dt.date.fromisoformat(str(s).strip()[:10])


def timestamp_option_to_ms(ts) -> int:
    """A timestamp option as epoch milliseconds."""
    if isinstance(ts, bool):
        raise errors.invalid_timestamp_format(ts)
    if isinstance(ts, (int, float)):
        return int(ts)
    s = str(ts).strip()
    if s.lstrip("-").isdigit():
        return int(s)
    try:
        out = iso_to_naive_utc(s)
    except ValueError as e:
        raise errors.invalid_timestamp_format(ts, e)
    return int(out.replace(tzinfo=_dt.timezone.utc).timestamp() * 1000)

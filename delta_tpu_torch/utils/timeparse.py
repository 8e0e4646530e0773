"""ISO-8601 parsing shared by the expression language (the port's own copy
of ``delta_tpu.utils.timeparse``'s parsers): naive values ARE UTC."""
from __future__ import annotations

import datetime as _dt

__all__ = ["iso_to_naive_utc", "iso_to_date"]


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

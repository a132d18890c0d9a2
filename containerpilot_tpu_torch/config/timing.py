"""Duration parsing: bare numbers are seconds, strings use Go-style units.

Capability parity with the reference's timing helpers
(reference: config/timing/duration.go): ``parse_duration`` accepts an
int/float (seconds), a numeric string (seconds), or a Go-style duration
string ("300ms", "1.5h", "1h2m3s"); ``get_timeout`` maps the empty
value to zero (meaning "no timeout").

All durations in this framework are float seconds.

The port's own copy of ``containerpilot_tpu/config/timing.py``.
"""
from __future__ import annotations

import re
from typing import Any, Optional, Union

_UNITS = {
    "ns": 1e-9,
    "us": 1e-6,
    "µs": 1e-6,  # µs
    "ms": 1e-3,
    "s": 1.0,
    "m": 60.0,
    "h": 3600.0,
}

_SEGMENT = re.compile(r"(\d+(?:\.\d+)?)(ns|us|µs|ms|s|m|h)")


class DurationError(ValueError):
    """Raised for an unparseable duration value."""


def parse_duration(value: Any) -> float:
    """Parse a config duration into float seconds."""
    if isinstance(value, bool):
        raise DurationError(f"unexpected duration of type {type(value).__name__}")
    if isinstance(value, (int, float)):
        return float(value)
    if isinstance(value, str):
        s = value.strip()
        try:
            return float(int(s))  # bare integer string = seconds
        except ValueError:
            pass
        matched = _SEGMENT.findall(s)
        if not matched or "".join(n + u for n, u in matched) != s:
            raise DurationError(f"invalid duration: {value!r}")
        return sum(float(n) * _UNITS[u] for n, u in matched)
    raise DurationError(f"unexpected duration of type {type(value).__name__}")


def get_timeout(value: Optional[Union[str, int, float]]) -> float:
    """Like parse_duration but empty/None means no timeout (0.0)
    (reference: config/timing/duration.go:13-22)."""
    if value in (None, ""):
        return 0.0
    return parse_duration(value)

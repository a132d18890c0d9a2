"""Weakly-typed config decoding helpers.

Capability parity with the reference's mapstructure wrapper
(reference: config/decode/decode.go:13-23 — WeaklyTypedInput): config
values may arrive as strings where numbers are expected (templating
always produces strings), so numeric fields coerce before validation.

The port's own copy of ``containerpilot_tpu/config/decode.py``.
"""
from __future__ import annotations

from typing import Any, Optional


def coerce_number(value: Any) -> Any:
    """'8080' -> 8080, '7.5' -> 7.5; non-numeric strings pass through
    unchanged for the caller's validation to reject."""
    if isinstance(value, str):
        try:
            return int(value)
        except ValueError:
            try:
                return float(value)
            except ValueError:
                return value
    return value


def coerce_int(value: Any) -> Optional[int]:
    """Coerce to an integer, accepting integral floats ('8080', 8080.0);
    returns None when the value isn't an integral number."""
    value = coerce_number(value)
    if isinstance(value, bool):
        return None
    if isinstance(value, int):
        return value
    if isinstance(value, float) and value.is_integer():
        return int(value)
    return None

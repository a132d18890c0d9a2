"""Exec argument parsing: accept a shell-ish string or a list.

Capability parity with the reference's argument parsing
(reference: commands/args.go:12-31): a string is whitespace-split, a
list is coerced to strings, and an empty exec is a config error.

The port's own copy of ``containerpilot_tpu/commands/args.py``.
"""
from __future__ import annotations

from typing import Any, List, Tuple


class ArgsError(ValueError):
    """Raised for an unusable exec specification."""


def parse_args(raw: Any) -> Tuple[str, List[str]]:
    """Return (executable, args) from a raw config value."""
    if isinstance(raw, str):
        parts = raw.strip().split()
    elif isinstance(raw, (list, tuple)):
        parts = [str(a) for a in raw]
    elif raw is None:
        parts = []
    else:
        raise ArgsError(f"unparseable exec: {raw!r}")
    if not parts:
        raise ArgsError("received zero-length argument")
    return parts[0], parts[1:]

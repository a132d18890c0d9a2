"""Watches: upstream-change pollers (reference: watches/ package).

The port's own copy of ``containerpilot_tpu/watches/__init__.py``.
"""
from .watches import (
    Watch,
    WatchConfig,
    WatchConfigError,
    from_configs,
    new_watch_configs,
    poll_upstream,
)

__all__ = [
    "Watch",
    "WatchConfig",
    "WatchConfigError",
    "from_configs",
    "new_watch_configs",
    "poll_upstream",
]

"""Core runtime: the App generation loop, signals, CLI flags
(reference: core/ package).

The port's own copy of ``containerpilot_tpu/core/__init__.py``.
"""
from .app import App
from .flags import get_args

__all__ = ["App", "get_args"]

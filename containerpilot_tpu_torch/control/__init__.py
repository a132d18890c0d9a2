"""Control plane: unix-socket HTTP server (reference: control/ package).

The port's own copy of ``containerpilot_tpu/control/__init__.py``.
"""
from .config import ControlConfig, ControlConfigError, DEFAULT_SOCKET
from .control import ControlServer

__all__ = ["ControlConfig", "ControlConfigError", "ControlServer", "DEFAULT_SOCKET"]

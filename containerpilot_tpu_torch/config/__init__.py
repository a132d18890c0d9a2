"""Config pipeline: JSON5 loading, template rendering, validation
helpers (reference: config/ package and subpackages).

The port's own copy of ``containerpilot_tpu/config/__init__.py``.
"""
from .timing import DurationError, get_timeout, parse_duration
from .services import get_ip, validate_name, InterfaceIP

__all__ = [
    "parse_duration",
    "get_timeout",
    "DurationError",
    "get_ip",
    "validate_name",
    "InterfaceIP",
]

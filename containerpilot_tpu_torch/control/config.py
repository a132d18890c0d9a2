"""Control-plane config: the unix socket path
(reference: control/config.go — default /var/run/containerpilot.socket).

The port's own copy of ``containerpilot_tpu/control/config.py``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

DEFAULT_SOCKET = "/var/run/containerpilot.socket"


class ControlConfigError(ValueError):
    pass


class ControlConfig:
    def __init__(self, raw: Optional[Dict[str, Any]] = None) -> None:
        raw = raw or {}
        if not isinstance(raw, dict):
            raise ControlConfigError(f"control configuration must be a mapping")
        unknown = set(raw) - {"socket"}
        if unknown:
            raise ControlConfigError(f"control: unknown keys {sorted(unknown)}")
        self.socket: str = raw.get("socket") or DEFAULT_SOCKET

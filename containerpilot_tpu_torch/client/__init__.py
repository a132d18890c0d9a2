"""Client of the supervisor's control socket (the port's own copy)."""
from .client import ControlClient, ControlClientError

__all__ = ["ControlClient", "ControlClientError"]

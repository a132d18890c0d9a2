"""Telemetry of the port (counterpart of ``containerpilot_tpu/telemetry/``):
cross-hop request tracing (``tracing.py``) and the device-time goodput
ledger (``goodput.py``). The supervisor's own telemetry server is not
part of a replica and is not ported."""
from . import goodput, tracing
from .goodput import DeviceTimeLedger
from .tracing import Trace, TraceRecorder

__all__ = [
    "DeviceTimeLedger",
    "Trace",
    "TraceRecorder",
    "goodput",
    "tracing",
]

"""Telemetry of the port (counterpart of ``containerpilot_tpu/telemetry/``):
the supervisor's Prometheus ``/metrics`` and ``/status`` server with its
user-defined metrics (``config.py``, ``metrics.py``, ``telemetry.py``),
cross-hop request tracing (``tracing.py``) and the device-time goodput
ledger (``goodput.py``)."""
from . import goodput, tracing
from .config import MetricConfig, TelemetryConfig, TelemetryConfigError
from .goodput import DeviceTimeLedger
from .metrics import Metric
from .telemetry import Telemetry
from .tracing import Trace, TraceRecorder

__all__ = [
    "DeviceTimeLedger",
    "Metric",
    "MetricConfig",
    "Telemetry",
    "TelemetryConfig",
    "TelemetryConfigError",
    "Trace",
    "TraceRecorder",
    "goodput",
    "tracing",
]

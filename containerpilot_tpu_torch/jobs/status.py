"""Job health status enum (reference: jobs/status.go).

The port's own copy of ``containerpilot_tpu/jobs/status.py``.
"""
from __future__ import annotations

import enum


class JobStatus(enum.Enum):
    IDLE = "idle"  # default before starting
    UNKNOWN = "unknown"
    HEALTHY = "healthy"
    UNHEALTHY = "unhealthy"
    MAINTENANCE = "maintenance"
    ALWAYS_HEALTHY = "alwaysHealthy"  # hardcoded-healthy jobs (telemetry)
    COMPLETED = "completed"

    def __str__(self) -> str:
        """Serialized form for /status (reference: jobs/status.go:17-34):
        idle and unknown both render as "unknown", alwaysHealthy as
        "healthy"."""
        if self in (JobStatus.IDLE, JobStatus.UNKNOWN):
            return "unknown"
        if self is JobStatus.ALWAYS_HEALTHY:
            return "healthy"
        return self.value

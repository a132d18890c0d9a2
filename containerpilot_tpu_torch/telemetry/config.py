"""Telemetry configuration (reference: telemetry/telemetry_config.go,
telemetry/metrics_config.go).

The port's own copy of ``containerpilot_tpu/telemetry/config.py``.
"""
from __future__ import annotations

from typing import Any, Dict, List

from ..config.services import get_ip
from ..utils.prom import REGISTRY, Counter, Gauge, Histogram, Summary
from ..version import VERSION

# prometheus_client's default histogram buckets
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.075, 0.1, 0.25, 0.5, 0.75,
                   1.0, 2.5, 5.0, 7.5, 10.0)
DEFAULT_PORT = 9090  # reference: telemetry/telemetry_config.go:34
# hardcoded self-advertisement health cadence
# (reference: telemetry/telemetry_config.go:76-80)
SELF_HEARTBEAT = 5
SELF_TTL = 15


class TelemetryConfigError(ValueError):
    pass


_METRIC_CLASSES = {
    "counter": Counter,
    "gauge": Gauge,
    "histogram": Histogram,
    "summary": Summary,
}


class MetricConfig:
    """One user-defined metric (reference: metrics_config.go:12-23)."""

    def __init__(self, raw: Dict[str, Any]) -> None:
        unknown = set(raw) - {"namespace", "subsystem", "name", "help", "type"}
        if unknown:
            raise TelemetryConfigError(
                f"metric[{raw.get('name', '?')}]: unknown keys {sorted(unknown)}"
            )
        self.namespace = raw.get("namespace", "")
        self.subsystem = raw.get("subsystem", "")
        self.name = raw.get("name", "")
        self.help = raw.get("help", "") or self.name
        self.type = raw.get("type", "")
        if not self.name:
            raise TelemetryConfigError("metric must have a name")
        if self.type not in _METRIC_CLASSES:
            raise TelemetryConfigError(f"invalid metric type: {self.type}")
        self.full_name = "_".join(
            p for p in (self.namespace, self.subsystem, self.name) if p
        )
        # unregister-then-register so config reloads don't collide
        # (reference: metrics_config.go:85-88)
        cls = _METRIC_CLASSES[self.type]
        name = self.full_name
        if cls is Counter and name.endswith("_total"):
            name = name[:-len("_total")]
        REGISTRY.unregister(name)
        if cls is Histogram:
            self.collector = Histogram(name, self.help, (), REGISTRY,
                                       DEFAULT_BUCKETS)
        else:
            self.collector = cls(name, self.help, registry=REGISTRY)


class TelemetryConfig:
    """The telemetry section (reference: telemetry_config.go:16-68)."""

    def __init__(self, raw: Dict[str, Any]) -> None:
        if not isinstance(raw, dict):
            raise TelemetryConfigError("telemetry configuration must be a mapping")
        unknown = set(raw) - {"port", "interfaces", "tags", "metrics"}
        if unknown:
            raise TelemetryConfigError(f"telemetry: unknown keys {sorted(unknown)}")
        self.port = int(raw.get("port", DEFAULT_PORT) or DEFAULT_PORT)
        self.interfaces = raw.get("interfaces")
        self.tags: List[str] = list(raw.get("tags") or [])
        interfaces = self.interfaces
        if isinstance(interfaces, str):
            interfaces = [interfaces]
        try:
            self.address = get_ip(interfaces)
        except ValueError as exc:
            raise TelemetryConfigError(str(exc)) from None
        self.metrics = [MetricConfig(m) for m in (raw.get("metrics") or [])]

    def to_job_config_raw(self) -> Dict[str, Any]:
        """The synthetic self-advertising job
        (reference: telemetry_config.go:71-86)."""
        tags = list(self.tags)
        if VERSION:
            tags.append(VERSION)
        raw: Dict[str, Any] = {
            "name": "containerpilot",
            "port": self.port,
            "health": {"interval": SELF_HEARTBEAT, "ttl": SELF_TTL},
            "tags": tags,
        }
        if self.interfaces is not None:
            raw["interfaces"] = self.interfaces
        return raw

"""Metric actors: bus subscribers that record user-defined measurements.

Capability parity with the reference (reference: telemetry/metrics.go):
``{METRIC, "<name>|<value>"}`` events (published by the control plane's
``PutMetric`` endpoint) are matched by full metric name and recorded
into the Prometheus collector — counters Add, gauges Set,
histograms/summaries Observe.

The port's own copy of ``containerpilot_tpu/telemetry/metrics.py``.
"""
from __future__ import annotations

import asyncio
import logging
from typing import Optional

from ..events import (
    EventBus,
    EventCode,
    EventHandler,
    GLOBAL_SHUTDOWN,
    QUIT_BY_TEST,
)
from ..utils.prom import Counter, Gauge, Histogram, Summary
from ..utils.tasks import spawn
from .config import MetricConfig

log = logging.getLogger("containerpilot.telemetry")


class Metric(EventHandler):
    def __init__(self, cfg: MetricConfig) -> None:
        super().__init__()
        self.name = cfg.full_name
        self.type = cfg.type
        self.collector = cfg.collector
        self._task: Optional["asyncio.Task[None]"] = None

    def run(self, bus: EventBus) -> "asyncio.Task[None]":
        self.subscribe(bus)
        self.register(bus)
        self._task = spawn(self._loop(), name=f"metric:{self.name}")
        return self._task

    def stop(self) -> None:
        """Cancel the loop (the app stops metrics once all jobs have
        completed, mirroring generation-context cancellation)."""
        if self._task is not None and not self._task.done():
            self._task.cancel()

    async def _loop(self) -> None:
        try:
            while True:
                event = await self.next_event()
                if event in (GLOBAL_SHUTDOWN, QUIT_BY_TEST):
                    return
                if event.code == EventCode.METRIC:
                    self.process_metric(event.source)
        except asyncio.CancelledError:
            pass
        finally:
            self.unsubscribe()
            self.unregister()

    def process_metric(self, measurement: str) -> None:
        """Parse "<name>|<value>" (reference: metrics.go:47-57)."""
        parts = measurement.split("|")
        if len(parts) < 2:
            log.error("metric: invalid metric format: %s", measurement)
            return
        key, value = parts[0], parts[1]
        if key == self.name:
            self.record(value)

    def record(self, raw_value: str) -> None:
        try:
            val = float(raw_value.strip())
        except ValueError:
            log.error("metric produced non-numeric value: %r", raw_value)
            return
        if isinstance(self.collector, Counter):
            self.collector.inc(val)
        elif isinstance(self.collector, Gauge):
            self.collector.set(val)
        elif isinstance(self.collector, (Histogram, Summary)):
            self.collector.observe(val)

"""Prometheus exposition for the port's serving surface, with its own
small metric registry (the port's counterpart of
``containerpilot_tpu/utils/prom.py``).

The reference keeps its replica metrics in a private
``prometheus_client.CollectorRegistry``. The port depends on nothing
beyond torch and the standard library, so it writes the same text
format (version 0.0.4) itself: ``Counter``, ``Gauge`` (set, or read
through a callback at scrape time) and ``Histogram``, each with labels,
in a ``Registry`` that keeps registration order. A scrape of a torch
replica carries the same family names, types, help strings, label sets
and histogram buckets as a JAX replica's, laid out the way
``prometheus_client.generate_latest`` lays them out: counters as
``<name>_total``, histograms as ``_bucket``/``_count``/``_sum``, and
each counter's and histogram's ``_created`` sample in a gauge family of
its own after it. Labels are sorted by name; numbers are written as
``prometheus_client`` writes them (``floatToGoString``).
"""
from __future__ import annotations

import math
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

PROM_CONTENT_TYPE = "text/plain; version=0.0.4"


def format_value(value: float) -> str:
    """A sample value as ``prometheus_client`` writes it (Go's float
    format: exponents past 1e6, ``+Inf``/``-Inf``/``NaN``)."""
    value = float(value)
    if value == math.inf:
        return "+Inf"
    if value == -math.inf:
        return "-Inf"
    if math.isnan(value):
        return "NaN"
    text = repr(value)
    dot = text.find(".")
    if value > 0 and dot > 6:
        mantissa = f"{text[0]}.{text[1:dot]}{text[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return text


def _escape_help(text: str) -> str:
    return text.replace("\\", r"\\").replace("\n", r"\n")


def _escape_label(value: str) -> str:
    return (value.replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _sample(name: str, labels: Dict[str, str], value: float) -> str:
    if labels:
        inner = ",".join(f'{k}="{_escape_label(v)}"'
                         for k, v in sorted(labels.items()))
        return f"{name}{{{inner}}} {format_value(value)}\n"
    return f"{name} {format_value(value)}\n"


class Registry:
    """Metric families in registration order; a name registers once."""

    def __init__(self) -> None:
        self._metrics: List["_Metric"] = []
        self._lock = threading.Lock()

    def register(self, metric: "_Metric") -> None:
        with self._lock:
            if any(m.name == metric.name for m in self._metrics):
                raise ValueError(
                    f"duplicated timeseries in Registry: {metric.name}")
            self._metrics.append(metric)

    def metrics(self) -> List["_Metric"]:
        with self._lock:
            return list(self._metrics)


class _Child:
    """One labelled time series of a metric."""

    def __init__(self, metric: "_Metric") -> None:
        self._metric = metric
        self._lock = threading.Lock()
        self.created = time.time()
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None
        if isinstance(metric, Histogram):
            self._buckets = [0.0] * len(metric.buckets)
            self._sum = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters can only be incremented by "
                             "non-negative amounts")
        with self._lock:
            self._value += amount

    def set(self, value: float) -> None:
        with self._lock:
            self._fn = None
            self._value = float(value)

    def set_function(self, fn: Callable[[], float]) -> None:
        """Read the value through ``fn`` at every scrape."""
        with self._lock:
            self._fn = fn

    def observe(self, amount: float) -> None:
        buckets = self._metric.buckets
        with self._lock:
            self._sum += amount
            for i, bound in enumerate(buckets):
                if amount <= bound:
                    self._buckets[i] += 1.0
                    break

    def get(self) -> float:
        with self._lock:
            fn, value = self._fn, self._value
        return float(fn()) if fn is not None else value

    def histogram(self) -> Tuple[List[float], float]:
        """(cumulative bucket counts, sum)."""
        with self._lock:
            counts, total = list(self._buckets), self._sum
        out, acc = [], 0.0
        for n in counts:
            acc += n
            out.append(acc)
        return out, total


class _Metric:
    """A metric family: its children by label values."""

    def __init__(self, name: str, documentation: str,
                 labelnames: Sequence[str] = (),
                 registry: Optional[Registry] = None) -> None:
        self.name = name
        self.documentation = documentation
        self.labelnames = tuple(labelnames)
        self._children: Dict[Tuple[str, ...], _Child] = {}
        self._lock = threading.Lock()
        if not self.labelnames:
            self._children[()] = _Child(self)
        if registry is not None:
            registry.register(self)

    def labels(self, *values) -> _Child:
        values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames) or not values:
            raise ValueError(f"{self.name} takes labels {self.labelnames}")
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._children[values] = _Child(self)
            return child

    def _unlabelled(self) -> _Child:
        if self.labelnames:
            raise ValueError(f"{self.name} needs labels {self.labelnames}")
        return self._children[()]

    def children(self) -> List[Tuple[Dict[str, str], _Child]]:
        with self._lock:
            items = list(self._children.items())
        return [(dict(zip(self.labelnames, k)), c) for k, c in items]

    def render(self) -> str:
        raise NotImplementedError


class Counter(_Metric):
    """A monotonic count; exposed as ``<name>_total``."""

    def inc(self, amount: float = 1.0) -> None:
        self._unlabelled().inc(amount)

    def render(self) -> str:
        total = f"{self.name}_total"
        lines = [f"# HELP {total} {_escape_help(self.documentation)}\n",
                 f"# TYPE {total} counter\n"]
        created = []
        for labels, child in self.children():
            lines.append(_sample(total, labels, child.get()))
            created.append(_sample(f"{self.name}_created", labels,
                                   child.created))
        return "".join(lines + _created_family(self, created))


class Gauge(_Metric):
    """A value set, or read through a callback at every scrape."""

    def set(self, value: float) -> None:
        self._unlabelled().set(value)

    def set_function(self, fn: Callable[[], float]) -> None:
        self._unlabelled().set_function(fn)

    def render(self) -> str:
        lines = [f"# HELP {self.name} {_escape_help(self.documentation)}\n",
                 f"# TYPE {self.name} gauge\n"]
        for labels, child in self.children():
            lines.append(_sample(self.name, labels, child.get()))
        return "".join(lines)


class Histogram(_Metric):
    """Observations counted into fixed buckets (``+Inf`` added)."""

    def __init__(self, name: str, documentation: str,
                 labelnames: Sequence[str], registry: Optional[Registry],
                 buckets: Sequence[float]) -> None:
        bounds = [float(b) for b in buckets]
        if bounds != sorted(bounds):
            raise ValueError("buckets not in sorted order")
        if not bounds or bounds[-1] != math.inf:
            bounds.append(math.inf)
        self.buckets = tuple(bounds)
        super().__init__(name, documentation, labelnames, registry)

    def observe(self, amount: float) -> None:
        self._unlabelled().observe(amount)

    def render(self) -> str:
        lines = [f"# HELP {self.name} {_escape_help(self.documentation)}\n",
                 f"# TYPE {self.name} histogram\n"]
        created = []
        for labels, child in self.children():
            counts, total = child.histogram()
            for bound, n in zip(self.buckets, counts):
                lines.append(_sample(f"{self.name}_bucket",
                                     {**labels, "le": format_value(bound)},
                                     n))
            lines.append(_sample(f"{self.name}_count", labels, counts[-1]))
            lines.append(_sample(f"{self.name}_sum", labels, total))
            created.append(_sample(f"{self.name}_created", labels,
                                   child.created))
        return "".join(lines + _created_family(self, created))


def _created_family(metric: _Metric, lines: List[str]) -> List[str]:
    if not lines:
        return []
    name = f"{metric.name}_created"
    return [f"# HELP {name} {_escape_help(metric.documentation)}\n",
            f"# TYPE {name} gauge\n", *lines]


def exposition(registry: Registry) -> Tuple[bytes, str]:
    """(body, content_type) for a /metrics response over ``registry``."""
    body = "".join(m.render() for m in registry.metrics())
    return body.encode("utf-8"), PROM_CONTENT_TYPE


def ensure_build_info(registry: Registry, role: str) -> None:
    """Register the shared identity gauge ``cp_build_info{version,role}
    1``. Idempotent per registry (a second registration is a no-op)."""
    from ..version import VERSION

    try:
        gauge = Gauge(
            "cp_build_info",
            "build identity: constant 1, labeled by version and the "
            "process role (supervisor/replica/pod/gateway)",
            ["version", "role"],
            registry=registry,
        )
    except ValueError:
        return
    gauge.labels(VERSION, role).set(1)


def ensure_goodput_gauges(registry: Registry, ledger, counters=None) -> None:
    """Register the device-time ledger's gauges over a
    ``telemetry/goodput.DeviceTimeLedger``: ``cp_device_seconds_total
    {stage}`` (read live, open segment included) plus, when
    ``counters`` (a zero-arg callable returning ``(dispatches,
    tokens_out)``) is given, ``cp_decode_dispatches_total`` and
    ``cp_tokens_out_total``. Idempotent per registry."""
    from ..telemetry.goodput import STAGES

    try:
        gauge = Gauge(
            "cp_device_seconds_total",
            "device-time ledger: cumulative wall seconds attributed "
            "to each stage of this replica's life "
            "(docs/90-observability.md has the stage glossary)",
            ["stage"],
            registry=registry,
        )
    except ValueError:
        return
    for stage in STAGES:
        gauge.labels(stage).set_function(
            lambda s=stage: ledger.stage_seconds(s)
        )
    if counters is None:
        return
    Gauge(
        "cp_decode_dispatches_total",
        "host->device dispatches the decode path has issued "
        "(prefills + chunk rounds); divide by cp_tokens_out_total "
        "for dispatches/token",
        registry=registry,
    ).set_function(lambda: float(counters()[0]))
    Gauge(
        "cp_tokens_out_total",
        "tokens the decode path has emitted (pre-trim engine "
        "emission)",
        registry=registry,
    ).set_function(lambda: float(counters()[1]))


def ensure_loop_lag_gauge(registry: Registry, probe) -> None:
    """Register the event-loop health gauge ``cp_loop_lag_ms{stat=
    "max"|"p99"}`` over an ``analysis/loopcheck.LoopLagProbe``.
    Idempotent per registry."""
    try:
        gauge = Gauge(
            "cp_loop_lag_ms",
            "event-loop scheduling delay over the probe ring, ms "
            "(docs/70-static-analysis.md has the loopcheck runbook)",
            ["stat"],
            registry=registry,
        )
    except ValueError:
        return
    gauge.labels("max").set_function(probe.max_ms)
    gauge.labels("p99").set_function(probe.p99_ms)

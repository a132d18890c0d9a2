"""Trace-driven load + chaos harness, gated on SLO-goodput (the port's
own copy of ``containerpilot_tpu/chaos/``).

The fleet's adversarial proving ground: replay realistic multi-tenant
traffic (trace.py) through a real gateway-fronted fleet of the port's
replicas while injecting the faults members actually die of (faults.py)
— replica SIGKILL, wedged health checks, brownouts, lossy transport,
catalog flaps, slow boots — and judge the run by goodput, the fraction
of work meeting TTFT/TPOT SLOs per wall-second (slo.py), not raw QPS.

``python -m containerpilot_tpu_torch.chaos`` runs scenarios from the
registry (scenarios.py) on the card (``--device cpu`` asks for the
CPU).
"""
from .faults import ChaosProxy, Fault, FlakyBackend
from .slo import SLO, RequestRecord, ScenarioScore, percentile
from .scenarios import (
    SCENARIOS,
    FleetHarness,
    ScenarioSpec,
    full_scenarios,
    quick_scenarios,
    run_scenario,
    run_scenario_async,
)
from .trace import TraceConfig, TraceRequest, generate_trace, trace_summary

__all__ = [
    "SCENARIOS",
    "SLO",
    "ChaosProxy",
    "Fault",
    "FlakyBackend",
    "FleetHarness",
    "RequestRecord",
    "ScenarioScore",
    "ScenarioSpec",
    "TraceConfig",
    "TraceRequest",
    "full_scenarios",
    "generate_trace",
    "percentile",
    "quick_scenarios",
    "run_scenario",
    "run_scenario_async",
    "trace_summary",
]

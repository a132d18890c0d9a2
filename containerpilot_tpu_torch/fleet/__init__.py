"""Inference fleet: discovery-driven serving replicas + gateway (the
port's own copy of ``containerpilot_tpu/fleet/``).

- ``FleetMember`` (member.py): registers one running InferenceServer in
  a discovery Backend with a TTL check, heartbeats the TTL off the
  replica's real health state, and implements the drain path.
- ``FleetGateway`` (gateway.py, ``python -m containerpilot_tpu_torch.fleet``):
  discovers healthy replicas through a watches-style catalog poll and
  proxies the inference API over them with least-outstanding routing,
  session/prefix/cache affinity, retry-on-a-different-replica, tail
  hedging, disaggregated prefill/decode handoffs, drain migration, and
  per-replica cp-mux/1 connections or keep-alive pools (pool.py).
- ``AdmissionController`` (admission.py): bounded queue, TTFT deadlines,
  priority classes, per-session token buckets and load shedding with an
  honest drain-rate-derived Retry-After.
- ``Autoscaler`` (autoscaler.py): launches and retires replicas through
  a caller-provided launcher with hysteresis, sustain windows and a
  cooldown; ``StandbyLauncher`` (standby.py) turns its scale-up into the
  promotion of a warm standby.

The replica half (cp-mux/1's client, the heartbeat notes, the standby's
weight transfer) lives beside them. None of these modules needs the
JAX package, ``prometheus_client`` or ``json5``.
"""
from .admission import (
    AdmissionController,
    AdmissionError,
    DeadlineExpired,
    SessionLimited,
    ShedError,
)
from .autoscaler import Autoscaler, AutoscalerConfig, FleetLoad
from .gateway import FleetGateway, Replica
from .member import FleetMember
from .pool import ConnectionPool, StaleConnection, UpstreamError
from .standby import (
    ROLE_ACTIVE,
    ROLE_DECODE,
    ROLE_PREFILL,
    ROLE_STANDBY,
    StandbyLauncher,
    fetch_params,
)

__all__ = [
    "AdmissionController",
    "AdmissionError",
    "Autoscaler",
    "AutoscalerConfig",
    "ConnectionPool",
    "DeadlineExpired",
    "FleetGateway",
    "FleetLoad",
    "FleetMember",
    "ROLE_ACTIVE",
    "ROLE_DECODE",
    "ROLE_PREFILL",
    "ROLE_STANDBY",
    "Replica",
    "SessionLimited",
    "ShedError",
    "StaleConnection",
    "StandbyLauncher",
    "UpstreamError",
    "fetch_params",
]

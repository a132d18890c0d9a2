"""Service-discovery backend interface (the port's own copy of
``containerpilot_tpu/discovery/backend.py``).

Capability parity with the reference's Backend interface
(reference: discovery/discovery.go:8-14) — five methods: upstream
change detection, TTL check updates, and service register/deregister.

Backends provided in-tree:

- ``ConsulBackend`` (consul.py): the Consul HTTP API, for deployments
  with a real catalog.
- ``FileCatalogBackend`` (filecatalog.py): a shared-filesystem catalog
  for TPU-VM pods, where hosts in a pod slice see a common NFS/GCS-fuse
  mount and no Consul is available.
- ``NoopBackend`` (noop.py): test double with a settable change signal.
"""
from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import List, Tuple


@dataclass
class ServiceRegistration:
    """Everything a backend needs to advertise one service instance
    (reference: consul api.AgentServiceRegistration usage,
    discovery/service.go:93-110)."""

    id: str
    name: str
    port: int = 0
    ttl: int = 0
    tags: List[str] = field(default_factory=list)
    address: str = ""
    initial_status: str = ""
    enable_tag_override: bool = False
    deregister_critical_service_after: str = ""


@dataclass(frozen=True)
class ServiceInstance:
    """One healthy instance of an upstream service as seen in the
    catalog (reference: consul api.ServiceEntry subset used by
    discovery/consul.go:102-125)."""

    id: str
    name: str
    address: str
    port: int
    #: last TTL-check output ("ok occ=0.50" from fleet members):
    #: a coarse, TTL-fresh load hint; empty when the backend doesn't
    #: surface check output
    notes: str = ""


class Backend(abc.ABC):
    """The discovery catalog interface (reference: discovery/discovery.go:8-14)."""

    @abc.abstractmethod
    def check_for_upstream_changes(
        self, service_name: str, tag: str = "", dc: str = ""
    ) -> Tuple[bool, bool]:
        """Poll the catalog for healthy instances of ``service_name``.

        Returns (did_change, is_healthy): whether membership changed
        since the last poll, and whether at least one healthy instance
        exists (reference: discovery/consul.go:87-110).
        """

    @abc.abstractmethod
    def update_ttl(self, check_id: str, output: str, status: str) -> None:
        """Refresh a TTL health check (reference: discovery/consul.go)."""

    @abc.abstractmethod
    def service_register(
        self, registration: ServiceRegistration, status: str = ""
    ) -> None:
        """Register a service instance plus its TTL check."""

    @abc.abstractmethod
    def service_deregister(self, service_id: str) -> None:
        """Remove a service instance from the catalog."""

    def instances(self, service_name: str, tag: str = "") -> List[ServiceInstance]:
        """Current healthy instances (used by /status and templating)."""
        return []


class DiscoveryError(RuntimeError):
    """A backend operation failed (network, catalog rejection, ...)."""

"""No-op discovery backend: a test double with a settable change signal
(the port's own copy of ``containerpilot_tpu/discovery/noop.py``).

Capability parity with the reference's mock backend
(reference: tests/mocks/discovery.go:6-41): ``val`` drives what
``check_for_upstream_changes`` reports, and a compare-against-last-seen
mimics real change detection. Shipped in the package (not just tests)
so the supervisor can run catalog-free ("consul: none" deployments).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from .backend import Backend, ServiceInstance, ServiceRegistration


class NoopBackend(Backend):
    def __init__(self) -> None:
        self.val = False  # "is the upstream healthy right now?"
        self._last_val = False
        self.registered: Dict[str, ServiceRegistration] = {}
        self.ttl_updates: List[str] = []

    def check_for_upstream_changes(
        self, service_name: str, tag: str = "", dc: str = ""
    ) -> Tuple[bool, bool]:
        did_change = self.val != self._last_val
        self._last_val = self.val
        return did_change, self.val

    def update_ttl(self, check_id: str, output: str, status: str) -> None:
        self.ttl_updates.append(check_id)

    def service_register(
        self, registration: ServiceRegistration, status: str = ""
    ) -> None:
        self.registered[registration.id] = registration

    def service_deregister(self, service_id: str) -> None:
        self.registered.pop(service_id, None)

    def instances(self, service_name: str, tag: str = "") -> List[ServiceInstance]:
        return [
            ServiceInstance(r.id, r.name, r.address, r.port)
            for r in self.registered.values()
            if r.name == service_name
        ]

"""Discovery backend construction from config (the port's own copy of
``containerpilot_tpu/discovery/factory.py``).

Capability parity with the reference's discovery config
(reference: discovery/config.go:29-61 — URI or map forms, CONSUL_*
environment overrides), extended with TPU-pod-friendly backends:

    consul: "consul:8500"                  -> ConsulBackend
    consul: {address: ..., scheme: ...}    -> ConsulBackend
    consul: "file:/shared/catalog"         -> FileCatalogBackend
    consul: "none"                         -> NoopBackend (catalog-free)
    (section absent)                       -> no discovery (None)
"""
from __future__ import annotations

from typing import Any, Optional

from .backend import Backend
from .consul import ConsulBackend
from .filecatalog import FileCatalogBackend
from .noop import NoopBackend


class DiscoveryConfigError(ValueError):
    pass


def new_backend(raw: Any) -> Optional[Backend]:
    if raw is None:
        return None
    if isinstance(raw, str):
        value = raw.strip()
        if value == "none":
            return NoopBackend()
        if value.startswith("file:"):
            return FileCatalogBackend(value[len("file:"):])
        return ConsulBackend.from_uri(value)
    if isinstance(raw, dict):
        return ConsulBackend.from_map(raw)
    raise DiscoveryConfigError(f"unparseable 'consul' config: {raw!r}")

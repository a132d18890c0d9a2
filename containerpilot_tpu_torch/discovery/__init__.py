"""Service discovery: catalog backends and per-job registration state
(the port's own copy of ``containerpilot_tpu/discovery/``, without the
supervisor's ``catalog_server.py``)."""
from .backend import (
    Backend,
    DiscoveryError,
    ServiceInstance,
    ServiceRegistration,
)
from .consul import ConsulBackend
from .factory import DiscoveryConfigError, new_backend
from .filecatalog import FileCatalogBackend
from .noop import NoopBackend
from .service import ServiceDefinition

__all__ = [
    "Backend",
    "ConsulBackend",
    "DiscoveryConfigError",
    "DiscoveryError",
    "FileCatalogBackend",
    "NoopBackend",
    "ServiceDefinition",
    "ServiceInstance",
    "ServiceRegistration",
    "new_backend",
]

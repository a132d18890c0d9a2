"""Multi-process initialization: ``torch.distributed`` wired to the
supervisor's catalog (counterpart of
``containerpilot_tpu/parallel/distributed.py``).

Every rank must agree on (coordinator address, world size, rank) before
a process group exists. Two paths, as in the reference:

- ``initialize_from_env()``: the reference's own variables
  (``COORDINATOR_ADDRESS`` as host:port, ``NUM_PROCESSES``,
  ``PROCESS_ID``). With none set the world is one rank and no process
  group is made, as the reference's one-device mesh.
- ``initialize_from_catalog(backend, ...)``: the catalog elects the
  coordinator: rank 0 registers ``COORDINATOR_SERVICE`` and hosts the
  rendezvous store; the other ranks poll the catalog until it appears.

Either way the rendezvous is ``dist.init_process_group(init_method=
"tcp://<coordinator>", rank=..., world_size=...)``. The service name is
``torch-coordinator``, not the reference's ``jax-coordinator``: a torch
rank must never try to join a JAX coordinator registered in the same
catalog (their wire protocols differ), and vice versa.

The backend is chosen, never fallen back to: NCCL when every rank has a
card of its own, gloo when ranks share a card or run on the CPU
(``mesh.pick_backend``).
"""
from __future__ import annotations

import datetime
import logging
import os
import socket
import time

import torch
import torch.distributed as dist

from ..discovery import Backend, ServiceRegistration

log = logging.getLogger("containerpilot.distributed")

COORDINATOR_SERVICE = "torch-coordinator"
DEFAULT_COORDINATOR_PORT = 29500


def _backend_for(device, num_processes: int) -> str:
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= num_processes:
        return "nccl"
    return "gloo"


def _init(coordinator: str, num_processes: int, process_id: int, device,
          timeout: float) -> None:
    backend = _backend_for(device, num_processes)
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}", rank=process_id,
        world_size=num_processes,
        timeout=datetime.timedelta(seconds=timeout),
    )


def initialize_from_env(device="cuda", timeout: float = 300.0) -> None:
    """Join the world the environment names; a world of one (no process
    group) when ``COORDINATOR_ADDRESS`` is unset."""
    address = os.environ.get("COORDINATOR_ADDRESS")
    if not address:
        log.info("distributed: no COORDINATOR_ADDRESS, a world of one")
        return
    num = int(os.environ.get("NUM_PROCESSES", "1"))
    pid = int(os.environ.get("PROCESS_ID", "0"))
    _init(address, num, pid, device, timeout)
    log.info("distributed: process %d/%d ready", dist.get_rank(),
             dist.get_world_size())


def initialize_from_catalog(
    backend: Backend,
    process_id: int,
    num_processes: int,
    coordinator_port: int = DEFAULT_COORDINATOR_PORT,
    advertise_address: str = "",
    timeout: float = 300.0,
    poll_interval: float = 2.0,
    device="cuda",
) -> None:
    """Rendezvous through the supervisor's catalog.

    Process 0 clears any stale coordinator registration, registers
    ``torch-coordinator`` (passing, with a TTL that outlives the job)
    and hosts the store; other processes poll the catalog for it."""
    if process_id == 0:
        address = advertise_address or _routable_address()
        # the coordinator role is singular: clear a stale registration so
        # workers cannot rendezvous with a dead host
        for stale in backend.instances(COORDINATOR_SERVICE):
            log.info("distributed: removing stale coordinator %s", stale.id)
            try:
                backend.service_deregister(stale.id)
            except Exception as exc:  # noqa: BLE001
                # best-effort: another agent's registration may not be
                # removable locally; never abort the rendezvous
                log.warning("distributed: could not remove %s: %s",
                            stale.id, exc)
        backend.service_register(
            ServiceRegistration(
                id=f"{COORDINATOR_SERVICE}-{socket.gethostname()}",
                name=COORDINATOR_SERVICE,
                port=coordinator_port,
                address=address,
                ttl=max(int(timeout), 7 * 24 * 3600),
            ),
            status="passing",
        )
        coordinator = f"{address}:{coordinator_port}"
        log.info("distributed: registered coordinator at %s", coordinator)
    else:
        coordinator = _discover_coordinator(
            backend, coordinator_port, timeout, poll_interval
        )
    _init(coordinator, num_processes, process_id, device, timeout)
    log.info("distributed: process %d/%d ready via catalog rendezvous",
             dist.get_rank(), dist.get_world_size())


def _routable_address() -> str:
    """This host's routable IP. ``gethostbyname(hostname)`` often
    resolves to 127.0.0.1, which would make every worker rendezvous with
    itself; prefer the interface an outbound route uses (no packet is
    sent)."""
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.connect(("10.255.255.255", 1))
            address = s.getsockname()[0]
        if not address.startswith("127."):
            return address
    except OSError:
        pass
    address = socket.gethostbyname(socket.gethostname())
    if address.startswith("127."):
        log.warning(
            "distributed: advertising loopback %s as coordinator; pass "
            "advertise_address= for multi-host jobs", address,
        )
    return address


def _discover_coordinator(
    backend: Backend,
    coordinator_port: int,
    timeout: float,
    poll_interval: float,
) -> str:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        instances = backend.instances(COORDINATOR_SERVICE)
        if instances:
            inst = instances[0]
            port = inst.port or coordinator_port
            return f"{inst.address}:{port}"
        time.sleep(poll_interval)
    raise TimeoutError(
        f"no {COORDINATOR_SERVICE!r} appeared in the catalog within "
        f"{timeout:.0f}s"
    )

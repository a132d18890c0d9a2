"""File-based service catalog (the port's own copy of
``containerpilot_tpu/discovery/filecatalog.py``; the record format is
the same, so replicas of both packages share one catalog directory).

TPU-native analog of the reference's Consul backend for deployments
without a catalog server: hosts in a TPU pod slice (or any fleet with a
shared filesystem — NFS, GCS-fuse, or a local dir for single-host) use
a directory as the catalog. Each registered service instance is one
JSON file carrying address/port/TTL state; TTL expiry marks instances
critical exactly like Consul's TTL checks
(reference behavior: discovery/consul.go, discovery/service.go:93-110).

Layout:  <root>/services/<service-name>/<instance-id>.json

Change detection mirrors the reference's compare-and-swap of the
last-seen instance list (reference: discovery/consul.go:102-125).
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Tuple

from .backend import (
    Backend,
    DiscoveryError,
    ServiceInstance,
    ServiceRegistration,
)


class FileCatalogBackend(Backend):
    def __init__(self, root: str) -> None:
        self.root = root
        self._services_dir = os.path.join(root, "services")
        os.makedirs(self._services_dir, exist_ok=True)
        # last-seen healthy instance set per watched service
        self._last_seen: Dict[str, List[ServiceInstance]] = {}

    # -- paths ----------------------------------------------------------

    def _service_dir(self, name: str) -> str:
        return os.path.join(self._services_dir, name)

    def _instance_path(self, name: str, instance_id: str) -> str:
        return os.path.join(self._service_dir(name), f"{instance_id}.json")

    def _find_instance_file(self, instance_id: str) -> Optional[str]:
        try:
            names = os.listdir(self._services_dir)
        except OSError as exc:
            raise DiscoveryError(str(exc)) from None
        for name in names:
            path = self._instance_path(name, instance_id)
            if os.path.exists(path):
                return path
        return None

    # -- Backend interface ----------------------------------------------

    def service_register(
        self, registration: ServiceRegistration, status: str = ""
    ) -> None:
        record = {
            "id": registration.id,
            "name": registration.name,
            "address": registration.address,
            "port": registration.port,
            "tags": registration.tags,
            "ttl": registration.ttl,
            "status": status or "critical",
            # an empty status registers as unchecked-but-present; TTL
            # expiry is what flips healthy -> critical
            "expires": time.time() + registration.ttl
            if status == "passing"
            else 0.0,
        }
        sdir = self._service_dir(registration.name)
        try:
            os.makedirs(sdir, exist_ok=True)
            tmp = self._instance_path(registration.name, registration.id) + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(record, f)
            os.replace(tmp, self._instance_path(registration.name, registration.id))
        except OSError as exc:
            raise DiscoveryError(str(exc)) from None

    def service_deregister(self, service_id: str) -> None:
        path = self._find_instance_file(service_id)
        if path is None:
            return
        try:
            os.unlink(path)
        except OSError as exc:
            raise DiscoveryError(str(exc)) from None

    def update_ttl(self, check_id: str, output: str, status: str) -> None:
        # check ids look like "service:<instance-id>" (reference:
        # discovery/service.go:45)
        instance_id = check_id.split(":", 1)[-1]
        path = self._find_instance_file(instance_id)
        if path is None:
            raise DiscoveryError(f"unknown check {check_id!r}")
        try:
            with open(path, "r", encoding="utf-8") as f:
                record = json.load(f)
            record["status"] = "passing" if status == "pass" else status
            record["expires"] = time.time() + float(record.get("ttl") or 0)
            # the TTL check's output (e.g. "ok occ=0.50" from fleet
            # members): a coarse load signal readers can surface
            record["notes"] = output
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(record, f)
            os.replace(tmp, path)
        except (OSError, ValueError) as exc:
            raise DiscoveryError(str(exc)) from None

    def _healthy_instances(self, service_name: str, tag: str) -> List[ServiceInstance]:
        sdir = self._service_dir(service_name)
        if not os.path.isdir(sdir):
            return []
        now = time.time()
        out: List[ServiceInstance] = []
        for fname in sorted(os.listdir(sdir)):
            # only settled records. This also skips writer scratch
            # files (`<id>.json.tmp`, left behind by a crash between
            # write and os.replace): they don't end in ".json"
            if not fname.endswith(".json"):
                continue
            # a torn/partial write (concurrent writer on NFS, killed
            # host) or a malformed record is CRITICAL — skipped from
            # the healthy set — never an exception that kills the
            # whole listing for every healthy peer next to it
            try:
                with open(os.path.join(sdir, fname), encoding="utf-8") as f:
                    record = json.load(f)
                if not isinstance(record, dict):
                    continue
                instance = ServiceInstance(
                    id=record["id"],
                    name=record["name"],
                    address=str(record.get("address") or ""),
                    port=int(record.get("port") or 0),
                    notes=str(record.get("notes") or ""),
                )
                healthy = (
                    record.get("status") == "passing"
                    and float(record.get("expires") or 0) >= now
                )
                tags = record.get("tags") or []
            except (OSError, ValueError, KeyError, TypeError):
                continue
            if not healthy:
                continue
            if tag and (not isinstance(tags, list) or tag not in tags):
                continue
            out.append(instance)
        return out

    def check_for_upstream_changes(
        self, service_name: str, tag: str = "", dc: str = ""
    ) -> Tuple[bool, bool]:
        instances = self._healthy_instances(service_name, tag)
        last = self._last_seen.get(service_name)
        did_change = last is not None and last != instances
        if last is None and instances:
            did_change = True  # first sighting of a healthy upstream
        self._last_seen[service_name] = instances
        return did_change, bool(instances)

    def instances(self, service_name: str, tag: str = "") -> List[ServiceInstance]:
        return self._healthy_instances(service_name, tag)

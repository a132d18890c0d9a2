"""Job configuration: parsing and validation.

Capability parity with the reference's job config
(reference: jobs/config.go). The validation surface preserved:

- ``when`` defaults to GLOBAL_STARTUP with one start
  (reference: config.go:178-186); ``interval``/``once``/``each`` are
  mutually exclusive (config.go:188-193); interval jobs must tick at
  >= 1ms (config.go:200-215); SIGHUP/SIGUSR2 sources become Signal
  events with unlimited starts (config.go:239-243).
- ``restarts`` accepts non-negative ints, "never", "unlimited";
  defaults: unlimited for interval jobs else 0; "unlimited" is
  forbidden with ``when.each`` (config.go:346-396).
- advertised jobs (``port`` set) require ``health`` with interval and
  ttl >= 1 (config.go:297-310); service names are validated and the
  advertised IP resolved from the interface DSL (config.go:139-160,
  400-440).
- exec timeouts >= 1ms; interval jobs default their exec timeout to
  the interval itself (config.go:259-277).
- jobs whose ``when.once/each: stopping`` of another job wire up the
  stop-dependency handshake on that *other* job
  (config.go:99-114,135-137).

The port's own copy of ``containerpilot_tpu/jobs/config.py``.
"""
from __future__ import annotations

import os
import socket
from typing import Any, Dict, List, Optional

from ..commands import ArgsError, Command
from ..config.decode import coerce_int, coerce_number
from ..config.services import get_ip, validate_name
from ..config.timing import DurationError, get_timeout, parse_duration
from ..discovery import Backend, ServiceDefinition, ServiceRegistration
from ..events import (
    Event,
    EventCode,
    GLOBAL_STARTUP,
    NON_EVENT,
    code_from_string,
)

UNLIMITED = -1
TASK_MIN_DURATION = 0.001  # 1ms (reference: jobs/config.go:18)


class JobConfigError(ValueError):
    """A job config failed validation."""


class JobConfig:
    """One validated job definition."""

    def __init__(self, raw: Dict[str, Any]) -> None:
        if not isinstance(raw, dict):
            raise JobConfigError(f"job configuration must be a mapping: {raw!r}")
        known = {
            "name", "exec", "port", "initial_status", "initialStatus",
            "interfaces", "tags", "consul", "health", "timeout", "restarts",
            "stopTimeout", "when", "logging",
        }
        unknown = set(raw) - known
        if unknown:
            raise JobConfigError(
                f"job[{raw.get('name', '?')}]: unknown keys {sorted(unknown)}"
            )
        self.name: str = raw.get("name", "") or ""
        self.exec_raw = raw.get("exec")
        port = coerce_int(raw.get("port", 0) or 0)
        if port is None:
            raise JobConfigError(f"job[{self.name}].port must be an integer")
        self.port: int = port
        self.initial_status: str = (
            raw.get("initial_status") or raw.get("initialStatus") or ""
        )
        self.interfaces = raw.get("interfaces")
        tags = raw.get("tags") or []
        if not isinstance(tags, (list, tuple)):
            raise JobConfigError(f"job[{self.name}].tags must be a list")
        self.tags: List[str] = [str(t) for t in tags]
        # structured sections must be mappings (JSON5 objects)
        for key in ("consul", "health", "when", "logging"):
            value = raw.get(key)
            if value is not None and not isinstance(value, dict):
                raise JobConfigError(
                    f"job[{self.name}].{key} must be an object"
                )
        self.consul_extras: Optional[Dict[str, Any]] = raw.get("consul")
        self.health_raw: Optional[Dict[str, Any]] = raw.get("health")
        self.exec_timeout_raw = raw.get("timeout", "")
        self.restarts_raw = raw.get("restarts")
        self.stop_timeout_raw = raw.get("stopTimeout", "")
        self.when_raw: Optional[Dict[str, Any]] = raw.get("when")
        self.logging_raw: Optional[Dict[str, Any]] = raw.get("logging")

        # validated/derived state
        self.exec: Optional[Command] = None
        self.exec_timeout: float = 0.0
        self.freq_interval: float = 0.0
        self.when_event: Event = GLOBAL_STARTUP
        self.when_timeout: float = 0.0
        self.when_starts_limit: int = 1
        self.stopping_wait_event: Event = NON_EVENT
        self.stopping_timeout: float = 0.0
        self.restart_limit: int = 0
        self.heartbeat_interval: float = 0.0
        self.ttl: int = 0
        self.health_check_exec: Optional[Command] = None
        self.service_definition: Optional[ServiceDefinition] = None

    # -- validation pipeline (reference: jobs/config.go:118-133) --------

    def validate(self, disc: Optional[Backend]) -> "JobConfig":
        self._validate_discovery(disc)
        self._validate_when()
        self._validate_stopping_timeout()
        self._validate_restarts()
        self._validate_exec()
        return self

    def set_stopping(self, dependent_name: str) -> None:
        """Wire the stop-dependency handshake: this job's cleanup waits
        for {STOPPED, dependent} (reference: jobs/config.go:135-137)."""
        self.stopping_wait_event = Event(EventCode.STOPPED, dependent_name)

    # -- discovery ------------------------------------------------------

    def _validate_discovery(self, disc: Optional[Backend]) -> None:
        self._validate_health_check()
        if (self.port == 0 or disc is None) and self.name != "":
            return  # not an advertised service
        if self.port == 0:
            return
        self._validate_initial_status()
        try:
            validate_name(self.name)
        except ValueError as exc:
            raise JobConfigError(str(exc)) from None
        self._add_discovery_config(disc)

    def _validate_initial_status(self) -> None:
        if self.initial_status and self.initial_status not in (
            "passing", "warning", "critical",
        ):
            raise JobConfigError(
                f"job[{self.name}].initialStatus must be one of 'passing', "
                "'warning' or 'critical'"
            )

    def _validate_health_check(self) -> None:
        if self.port != 0 and self.health_raw is None and self.name != "containerpilot":
            raise JobConfigError(
                f"job[{self.name}].health must be set if 'port' is set"
            )
        if self.health_raw is None:
            return
        heartbeat = coerce_number(self.health_raw.get("interval", 0))
        ttl = coerce_number(self.health_raw.get("ttl", 0))
        if not isinstance(heartbeat, (int, float)) or heartbeat < 1:
            raise JobConfigError(f"job[{self.name}].health.interval must be > 0")
        if not isinstance(ttl, (int, float)) or ttl < 1:
            raise JobConfigError(f"job[{self.name}].health.ttl must be > 0")
        self.ttl = int(ttl)
        self.heartbeat_interval = float(heartbeat)
        try:
            check_timeout = get_timeout(self.health_raw.get("timeout", ""))
        except DurationError as exc:
            raise JobConfigError(
                f"could not parse job[{self.name}].health.timeout: {exc}"
            ) from None
        if not check_timeout:
            check_timeout = self.heartbeat_interval
        check_exec = self.health_raw.get("exec")
        if check_exec is not None:
            check_name = f"check.{self.name}"
            fields: Optional[Dict[str, Any]] = {"check": check_name}
            health_logging = self.health_raw.get("logging") or {}
            if not isinstance(health_logging, dict):
                raise JobConfigError(
                    f"job[{self.name}].health.logging must be an object"
                )
            if health_logging.get("raw"):
                fields = None
            try:
                self.health_check_exec = Command.from_config(
                    check_exec, timeout=check_timeout, fields=fields,
                    name=check_name,
                )
            except ArgsError as exc:
                raise JobConfigError(
                    f"unable to create job[{self.name}].health.exec: {exc}"
                ) from None

    def _add_discovery_config(self, disc: Backend) -> None:
        interfaces = self.interfaces
        if isinstance(interfaces, str):
            interfaces = [interfaces]
        try:
            ip_address = get_ip(interfaces)
        except ValueError as exc:
            raise JobConfigError(str(exc)) from None
        hostname = socket.gethostname()
        dereg_after = ""
        enable_tag_override = False
        if self.consul_extras:
            dereg_after = self.consul_extras.get(
                "deregisterCriticalServiceAfter", ""
            )
            if dereg_after:
                try:
                    parse_duration(dereg_after)
                except DurationError as exc:
                    raise JobConfigError(
                        f"unable to parse job[{self.name}].consul."
                        f"deregisterCriticalServiceAfter: {exc}"
                    ) from None
            enable_tag_override = bool(
                self.consul_extras.get("enableTagOverride", False)
            )
        registration = ServiceRegistration(
            id=f"{self.name}-{hostname}",
            name=self.name,
            port=self.port,
            ttl=self.ttl,
            tags=self.tags,
            address=ip_address,
            initial_status=self.initial_status,
            enable_tag_override=enable_tag_override,
            deregister_critical_service_after=dereg_after,
        )
        self.service_definition = ServiceDefinition(registration, disc)

    # -- when -----------------------------------------------------------

    def _validate_when(self) -> None:
        when = self.when_raw
        if when is None:
            self.when_event = GLOBAL_STARTUP
            self.when_timeout = 0.0
            self.when_starts_limit = 1
            return
        freq = when.get("interval", "")
        once = when.get("once", "")
        each = when.get("each", "")
        if (freq and once) or (freq and each) or (once and each):
            raise JobConfigError(
                f"job[{self.name}].when can have only one of 'interval', "
                "'once', or 'each'"
            )
        if freq:
            self._validate_frequency(freq)
            return
        self._validate_when_event(when, once, each)

    def _validate_frequency(self, freq_raw: Any) -> None:
        try:
            freq = parse_duration(freq_raw)
        except DurationError as exc:
            raise JobConfigError(
                f"unable to parse job[{self.name}].when.interval "
                f"{freq_raw!r}: {exc}"
            ) from None
        if freq < TASK_MIN_DURATION:
            raise JobConfigError(
                f"job[{self.name}].when.interval {freq_raw!r} cannot be "
                f"less than {TASK_MIN_DURATION}s"
            )
        self.freq_interval = freq
        self.when_timeout = 0.0
        self.when_event = GLOBAL_STARTUP
        self.when_starts_limit = 1

    def _validate_when_event(
        self, when: Dict[str, Any], once: str, each: str
    ) -> None:
        try:
            self.when_timeout = get_timeout(when.get("timeout", ""))
        except DurationError as exc:
            raise JobConfigError(
                f"unable to parse job[{self.name}].when.timeout: {exc}"
            ) from None
        source = when.get("source", "")
        code = EventCode.NONE
        try:
            if once:
                code = code_from_string(once)
                self.when_starts_limit = 1
            elif each:
                code = code_from_string(each)
                self.when_starts_limit = UNLIMITED
        except ValueError as exc:
            raise JobConfigError(
                f"unable to parse job[{self.name}].when.event: {exc}"
            ) from None
        if source in ("SIGHUP", "SIGUSR2"):
            code = EventCode.SIGNAL
            self.when_starts_limit = UNLIMITED
        self.when_event = Event(code, source)

    # -- stopping / restarts / exec -------------------------------------

    def _validate_stopping_timeout(self) -> None:
        try:
            self.stopping_timeout = get_timeout(self.stop_timeout_raw)
        except DurationError as exc:
            raise JobConfigError(
                f"unable to parse job[{self.name}].stopTimeout "
                f"{self.stop_timeout_raw!r}: {exc}"
            ) from None
        self.stopping_wait_event = NON_EVENT

    def _validate_restarts(self) -> None:
        raw = self.restarts_raw
        if raw is None:
            self.restart_limit = UNLIMITED if self.freq_interval else 0
            return
        msg = f"job[{self.name}].restarts field {raw!r} invalid"
        when_each = bool(self.when_raw and self.when_raw.get("each"))
        if isinstance(raw, str):
            if raw == "unlimited":
                if when_each:
                    raise JobConfigError(
                        f"{msg}: may not be used when 'job.when.each' is set "
                        "because it may result in infinite processes"
                    )
                self.restart_limit = UNLIMITED
            elif raw == "never":
                self.restart_limit = 0
            elif raw.isdigit():
                self.restart_limit = int(raw)
            else:
                raise JobConfigError(
                    f'{msg}: accepts positive integers, "unlimited", or "never"'
                )
        elif isinstance(raw, bool):
            raise JobConfigError(
                f'{msg}: accepts positive integers, "unlimited", or "never"'
            )
        elif isinstance(raw, (int, float)):
            if raw < 0:
                raise JobConfigError(f"{msg}: number must be positive integer")
            self.restart_limit = int(raw)
        else:
            raise JobConfigError(
                f'{msg}: accepts positive integers, "unlimited", or "never"'
            )

    def _validate_exec(self) -> None:
        if not self.exec_timeout_raw and self.freq_interval:
            # periodic tasks require a timeout (reference: config.go:261-264)
            self.exec_timeout = self.freq_interval
        if self.exec_timeout_raw:
            try:
                timeout = get_timeout(self.exec_timeout_raw)
            except DurationError as exc:
                raise JobConfigError(
                    f"unable to parse job[{self.name}].timeout "
                    f"{self.exec_timeout_raw!r}: {exc}"
                ) from None
            if timeout < TASK_MIN_DURATION:
                raise JobConfigError(
                    f"job[{self.name}].timeout {self.exec_timeout_raw!r} "
                    "cannot be less than 1ms"
                )
            self.exec_timeout = timeout
        if self.exec_raw is not None:
            fields: Optional[Dict[str, Any]] = {"job": self.name}
            if self.logging_raw and self.logging_raw.get("raw"):
                fields = None
            try:
                cmd = Command.from_config(
                    self.exec_raw, timeout=self.exec_timeout, fields=fields
                )
            except ArgsError as exc:
                raise JobConfigError(
                    f"unable to create job[{self.name}].exec: {exc}"
                ) from None
            if not self.name:
                self.name = cmd.exec
            cmd.name = self.name
            if fields is not None:
                cmd.fields = {"job": self.name}
            self.exec = cmd


def new_job_configs(
    raw: Optional[List[Dict[str, Any]]], disc: Optional[Backend]
) -> List[JobConfig]:
    """Parse and validate a list of raw job configs, wiring up
    stop-dependencies (reference: jobs/config.go:91-115)."""
    if raw is None:
        return []
    if not isinstance(raw, list):
        raise JobConfigError("job configuration must be a list")
    configs = [JobConfig(item) for item in raw]
    stop_dependencies: Dict[str, str] = {}
    for cfg in configs:
        cfg.validate(disc)
        if cfg.when_event.code == EventCode.STOPPING:
            stop_dependencies[cfg.when_event.source] = cfg.name
    for cfg in configs:
        if cfg.name in stop_dependencies:
            cfg.set_stopping(stop_dependencies[cfg.name])
    return configs

"""The Job actor: the supervisor's core state machine.

Capability parity with the reference's job runtime
(reference: jobs/jobs.go). Each job runs an event-loop task over its
bounded mailbox and dispatches on (code, source) pairs through eleven
handlers (reference: jobs/jobs.go:187-376):

- private ``run-every``/``heartbeat`` tickers and ``wait-timeout``
  one-shot feed the job's own mailbox, not the global bus
  (reference: jobs/jobs.go:147-161);
- health-check execs publish ``check.<name>`` exit events on the global
  bus, which the job maps to healthy/unhealthy status plus a catalog
  TTL heartbeat (reference: jobs/jobs.go:278-293);
- restarts decrement a budget; start events respect the
  once/each/unlimited starts limit (reference: jobs/jobs.go:333-383);
- pre-stop/post-stop jobs (started by another job's ``stopping`` /
  ``stopped`` events) get one more run during global shutdown
  (reference: jobs/jobs.go:295-312);
- cleanup publishes ``{STOPPING, name}``, waits for the configured
  stop-dependency's ``{STOPPED, dep}`` with a timeout, deregisters from
  the catalog, then publishes ``{STOPPED, name}``
  (reference: jobs/jobs.go:388-416).

The port's own copy of ``containerpilot_tpu/jobs/jobs.py``.
"""
from __future__ import annotations

import asyncio
import logging
from typing import Callable, List, Optional

from ..events import (
    Event,
    EventBus,
    EventCode,
    EventHandler,
    GLOBAL_ENTER_MAINTENANCE,
    GLOBAL_EXIT_MAINTENANCE,
    GLOBAL_SHUTDOWN,
    NON_EVENT,
    QUIT_BY_TEST,
    cancel_timer,
    event_timeout,
    event_timer,
)
from ..utils.tasks import spawn
from .config import UNLIMITED, JobConfig
from .status import JobStatus

log = logging.getLogger("containerpilot.jobs")

_HALT = True
_CONTINUE = False


class Job(EventHandler):
    """One supervised job: exec + health + discovery + lifecycle."""

    def __init__(self, cfg: JobConfig) -> None:
        super().__init__()
        self.name = cfg.name
        self.exec = cfg.exec
        self.status = JobStatus.IDLE
        self.service = cfg.service_definition
        self.health_check_exec = cfg.health_check_exec
        self.start_event = cfg.when_event
        self.start_timeout = cfg.when_timeout
        self.starts_remain = cfg.when_starts_limit
        self.start_timeout_event: Event = NON_EVENT
        self.stopping_wait_event = cfg.stopping_wait_event
        self.stopping_timeout = cfg.stopping_timeout
        self.heartbeat = cfg.heartbeat_interval
        self.restart_limit = cfg.restart_limit
        self.restarts_remain = cfg.restart_limit
        self.frequency = cfg.freq_interval
        self.is_complete = False
        self._timers: List["asyncio.Task[None]"] = []
        self._task: Optional["asyncio.Task[None]"] = None
        if self.name == "containerpilot":
            # the telemetry service advertises itself as always-healthy
            # (reference: jobs/jobs.go:82-87)
            self.status = JobStatus.ALWAYS_HEALTHY

    # -- status ---------------------------------------------------------

    def get_status(self) -> JobStatus:
        return self.status

    def set_status(self, status: JobStatus) -> None:
        if self.status is not JobStatus.ALWAYS_HEALTHY:
            self.status = status

    def send_heartbeat(self) -> None:
        if self.service is not None:
            self.service.send_heartbeat()

    def check_registration(self) -> None:
        """Retry initial-status registration every loop iteration so a
        flaky catalog heals (reference: jobs/jobs.go:108-113,168-171)."""
        if self.service is not None and self.service.initial_status:
            self.service.register_with_initial_status()

    def kill(self) -> None:
        if self.exec is not None:
            self.exec.kill()

    # -- run loop -------------------------------------------------------

    def run(
        self, on_complete: Optional[Callable[["Job"], None]] = None
    ) -> "asyncio.Task[None]":
        """Start timers and the event-loop task
        (reference: jobs/jobs.go:144-185)."""
        if self.frequency > 0:
            self._timers.append(
                event_timer(self.receive, self.frequency, f"{self.name}.run-every")
            )
        if self.heartbeat > 0:
            self._timers.append(
                event_timer(self.receive, self.heartbeat, f"{self.name}.heartbeat")
            )
        if self.start_timeout > 0:
            timeout_name = f"{self.name}.wait-timeout"
            self._timers.append(
                event_timeout(self.receive, self.start_timeout, timeout_name)
            )
            self.start_timeout_event = Event(EventCode.TIMER_EXPIRED, timeout_name)
        else:
            self.start_timeout_event = NON_EVENT
        self._task = spawn(
            self._loop(on_complete), name=f"job:{self.name}"
        )
        return self._task

    async def _loop(self, on_complete: Optional[Callable[["Job"], None]]) -> None:
        try:
            while True:
                self.check_registration()
                event = await self.next_event()
                if event == QUIT_BY_TEST:
                    return
                if self._process_event(event) == _HALT:
                    return
        except asyncio.CancelledError:
            pass  # hard teardown: skip the stopping handshake
        finally:
            await self._cleanup()
            if on_complete is not None:
                on_complete(self)

    # -- dispatch (reference: jobs/jobs.go:187-234) ---------------------

    def _process_event(self, event: Event) -> bool:
        run_every_source = f"{self.name}.run-every"
        heartbeat_source = f"{self.name}.heartbeat"
        health_check_name = (
            self.health_check_exec.name
            if self.health_check_exec is not None
            else f"check.{self.name}"
        )

        if event == Event(EventCode.TIMER_EXPIRED, heartbeat_source):
            return self._on_heartbeat_timer_expired()
        if event == self.start_timeout_event:
            return self._on_start_timeout_expired()
        if event == Event(EventCode.TIMER_EXPIRED, run_every_source):
            return self._on_run_every_timer_expired()
        if event == Event(EventCode.EXIT_FAILED, health_check_name):
            return self._on_health_check_failed()
        if event == Event(EventCode.EXIT_SUCCESS, health_check_name):
            return self._on_health_check_passed()
        if event in (Event(EventCode.QUIT, self.name), GLOBAL_SHUTDOWN):
            return self._on_quit()
        if event == GLOBAL_ENTER_MAINTENANCE:
            return self._on_enter_maintenance()
        if event == GLOBAL_EXIT_MAINTENANCE:
            return self._on_exit_maintenance()
        if event in (
            Event(EventCode.EXIT_SUCCESS, self.name),
            Event(EventCode.EXIT_FAILED, self.name),
        ):
            return self._on_exec_exit()
        if event in (
            Event(EventCode.SIGNAL, "SIGHUP"),
            Event(EventCode.SIGNAL, "SIGUSR2"),
        ):
            return self._on_signal_event(event.source)
        if event == self.start_event:
            return self._on_start_event()
        return _CONTINUE

    # -- handlers (reference: jobs/jobs.go:245-383) ---------------------

    def _start_job_exec(self) -> None:
        self.start_timeout_event = NON_EVENT
        self.set_status(JobStatus.UNKNOWN)
        if self.exec is not None and self.bus is not None:
            self.exec.run(self.bus)

    def _on_heartbeat_timer_expired(self) -> bool:
        status = self.get_status()
        if status not in (JobStatus.MAINTENANCE, JobStatus.IDLE):
            if self.health_check_exec is not None and self.bus is not None:
                self.health_check_exec.run(self.bus)
            elif self.service is not None:
                # advertised but uncheck-ed services (e.g. telemetry)
                self.send_heartbeat()
        return _CONTINUE

    def _on_start_timeout_expired(self) -> bool:
        self.publish(Event(EventCode.TIMER_EXPIRED, self.name))
        self.receive(Event(EventCode.QUIT, self.name))
        return _CONTINUE

    def _on_run_every_timer_expired(self) -> bool:
        if not self._restart_permitted():
            log.debug("interval expired but restart not permitted: %s", self.name)
            self.start_event = NON_EVENT
            return _HALT
        self.restarts_remain -= 1
        self._start_job_exec()
        return _CONTINUE

    def _on_health_check_failed(self) -> bool:
        if self.get_status() is not JobStatus.MAINTENANCE:
            self.set_status(JobStatus.UNHEALTHY)
            self.publish(Event(EventCode.STATUS_UNHEALTHY, self.name))
        return _CONTINUE

    def _on_health_check_passed(self) -> bool:
        if self.get_status() is not JobStatus.MAINTENANCE:
            self.set_status(JobStatus.HEALTHY)
            self.publish(Event(EventCode.STATUS_HEALTHY, self.name))
            self.send_heartbeat()
        return _CONTINUE

    def _on_quit(self) -> bool:
        self.restarts_remain = 0
        if (
            self.start_event.code in (EventCode.STOPPING, EventCode.STOPPED)
            and self.exec is not None
        ):
            # pre-stop/post-stop jobs ride out the global shutdown and
            # halt on their own exec exit; the app's stopTimeout then
            # SIGKILL bounds them (reference: jobs/jobs.go:297-308)
            if self.starts_remain == UNLIMITED:
                self.starts_remain = 1
            return _CONTINUE
        self.starts_remain = 0
        self.start_event = NON_EVENT
        return _HALT

    def _on_enter_maintenance(self) -> bool:
        self.set_status(JobStatus.MAINTENANCE)
        if self.service is not None:
            self.service.mark_for_maintenance()
        if self.start_event == GLOBAL_ENTER_MAINTENANCE:
            return self._on_start_event()
        return _CONTINUE

    def _on_exit_maintenance(self) -> bool:
        self.set_status(JobStatus.UNKNOWN)
        if self.start_event == GLOBAL_EXIT_MAINTENANCE:
            return self._on_start_event()
        return _CONTINUE

    def _on_exec_exit(self) -> bool:
        if self.frequency > 0:
            return _CONTINUE  # periodic jobs ignore their exits
        if self._restart_permitted():
            self.restarts_remain -= 1
            self._start_job_exec()
            return _CONTINUE
        if self.starts_remain != 0:
            return _CONTINUE
        log.debug("job exited but restart not permitted: %s", self.name)
        self.start_event = NON_EVENT
        self.set_status(JobStatus.UNKNOWN)
        return _HALT

    def _on_signal_event(self, sig: str) -> bool:
        if (
            self.start_event.code == EventCode.SIGNAL
            and self.start_event.source == sig
        ):
            self._start_job_exec()
        return _CONTINUE

    def _on_start_event(self) -> bool:
        if self.starts_remain == 0:
            self.start_event = NON_EVENT
            return _HALT
        if self.starts_remain != UNLIMITED:
            self.starts_remain -= 1
            if self.starts_remain == 0 or self.restarts_remain == 0:
                # don't receive the start event again while running
                self.start_event = NON_EVENT
        self._start_job_exec()
        return _CONTINUE

    def _restart_permitted(self) -> bool:
        return self.restart_limit == UNLIMITED or self.restarts_remain > 0

    # -- cleanup (reference: jobs/jobs.go:388-416) ----------------------

    async def _cleanup(self) -> None:
        stopping_timeout_name = f"{self.name}.stopping-timeout"
        self.publish(Event(EventCode.STOPPING, self.name))
        if self.stopping_wait_event != NON_EVENT:
            if self.stopping_timeout > 0:
                self._timers.append(
                    event_timeout(
                        self.receive, self.stopping_timeout, stopping_timeout_name
                    )
                )
            while True:
                event = await self.next_event()
                if event == self.stopping_wait_event:
                    break
                if event == Event(EventCode.TIMER_EXPIRED, stopping_timeout_name):
                    break
        for timer in self._timers:
            cancel_timer(timer)
        self._timers = []
        # the reference cancels the job-scoped context here, which
        # SIGTERMs any still-running exec/health-check process groups
        # (reference: jobs/jobs.go:408 + commands/commands.go:114-121);
        # the app's stopTimeout then bounds stragglers with SIGKILL
        if self.exec is not None:
            self.exec.term()
        if self.health_check_exec is not None:
            self.health_check_exec.term()
        if self.service is not None:
            future = self.service.deregister()
            if future is not None:
                # keep ordering: our stopped event follows deregistration.
                # shield so a timeout gives up *waiting* without
                # cancelling the queued deregister itself — it must
                # still run once the catalog unwedges
                try:
                    await asyncio.wait_for(
                        asyncio.shield(asyncio.wrap_future(future)),
                        timeout=10.0,
                    )
                except Exception:  # noqa: BLE001 — cpcheck: disable=CP-SWALLOW cleanup never raises; deregister failure already logged by the service queue
                    pass
        self.unsubscribe()
        self.unregister()
        self.is_complete = True
        self.status = JobStatus.COMPLETED
        self.publish(Event(EventCode.STOPPED, self.name))

    def __repr__(self) -> str:  # pragma: no cover - trivial
        return f"jobs.Job[{self.name}]"


def from_configs(configs: List[JobConfig]) -> List[Job]:
    """Build Jobs from validated configs (reference: jobs/jobs.go:92-99)."""
    return [Job(cfg) for cfg in configs]

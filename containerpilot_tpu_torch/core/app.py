"""The App: one supervisor process, many config generations.

Capability parity with the reference's core runtime
(reference: core/app.go). The generation loop:

1. build everything from config (jobs, watches, telemetry, control);
2. per generation: fresh bus, bind the control socket, subscribe every
   job *before* running any (race rule, reference: core/app.go:201-207),
   start watches/metrics/telemetry, publish GLOBAL_STARTUP;
3. a completion watcher cancels the generation once every job reports
   complete — the supervisor is NOT a server and must exit when its jobs
   are done (reference: core/app.go:100-140);
4. ``await bus.wait()`` → reload=True: rebuild from the same config path
   and loop (reference: core/app.go:183-196); reload=False: give
   stragglers ``stopTimeout`` of grace then group-SIGKILL and exit
   (reference: core/app.go:147-156).

Signals (reference: core/signals.go): SIGTERM/SIGINT terminate;
SIGHUP/SIGUSR2 are *events* jobs can start on (v3 semantics — SIGHUP
does not reload); SIGUSR1 reopens the log file for rotation.

The port's own copy of ``containerpilot_tpu/core/app.py``.
"""
from __future__ import annotations

import asyncio
import logging
import os
import signal
from typing import List, Optional

from ..commands import env_name
from ..config.loader import AppConfig, load_config
from ..config.logger import reopen_log_file
from ..control import ControlServer
from ..events import Event, EventBus, EventCode, GLOBAL_STARTUP
from ..jobs import Job, from_configs as jobs_from_configs
from ..telemetry import Metric, Telemetry
from ..utils.tasks import spawn
from ..watches import Watch, from_configs as watches_from_configs

log = logging.getLogger("containerpilot.core")


class App:
    def __init__(self, cfg: AppConfig) -> None:
        self.cfg = cfg
        self.config_path = cfg.config_path
        self.stop_timeout = cfg.stop_timeout
        self.jobs: List[Job] = jobs_from_configs(cfg.jobs)
        self.watches: List[Watch] = watches_from_configs(cfg.watches)
        self.control_server = ControlServer(cfg.control)
        self.telemetry: Optional[Telemetry] = (
            Telemetry(cfg.telemetry) if cfg.telemetry is not None else None
        )
        self.bus: Optional[EventBus] = None
        self._export_job_ips()

    @classmethod
    def from_config_path(cls, path: str) -> "App":
        """Load + validate config and build the app
        (reference: core/app.go:45-98)."""
        cfg = load_config(path)
        cfg.init_logging()
        return cls(cfg)

    def _export_job_ips(self) -> None:
        """Export CONTAINERPILOT_<JOB>_IP for advertised jobs
        (reference: core/app.go:81-97)."""
        for job in self.jobs:
            if job.service is not None:
                os.environ[f"CONTAINERPILOT_{env_name(job.name)}_IP"] = (
                    job.service.registration.address
                )

    # -- signals (reference: core/signals.go) ---------------------------

    def handle_signals(self) -> None:
        loop = asyncio.get_event_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(sig, self.terminate)
        for sig, name in ((signal.SIGHUP, "SIGHUP"), (signal.SIGUSR2, "SIGUSR2")):
            loop.add_signal_handler(sig, self.signal_event, name)
        loop.add_signal_handler(signal.SIGUSR1, reopen_log_file)

    def _remove_signal_handlers(self) -> None:
        loop = asyncio.get_event_loop()
        for sig in (signal.SIGTERM, signal.SIGINT, signal.SIGHUP,
                    signal.SIGUSR2, signal.SIGUSR1):
            try:
                loop.remove_signal_handler(sig)
            except (ValueError, RuntimeError):  # pragma: no cover
                pass

    def terminate(self) -> None:
        """SIGTERM/SIGINT: shut the generation down
        (reference: core/app.go:166-171)."""
        if self.bus is not None:
            self.bus.shutdown()

    def signal_event(self, name: str) -> None:
        """SIGHUP/SIGUSR2 become job-triggerable events
        (reference: core/app.go:173-178)."""
        if self.bus is not None:
            self.bus.publish(Event(EventCode.SIGNAL, name))

    def reload(self) -> None:
        """Programmatic reload (what POST /v3/reload does)."""
        if self.bus is not None:
            self.bus.set_reload_flag()
            self.bus.shutdown()

    # -- the generation loop --------------------------------------------

    async def run(self) -> None:
        """Run generations until shutdown (reference: core/app.go:100-163)."""
        self.handle_signals()
        try:
            while True:
                reload = await self._run_generation()
                if not reload:
                    if self.stop_timeout > 0:
                        log.debug(
                            "killing all processes in %s seconds",
                            self.stop_timeout,
                        )
                        await asyncio.sleep(self.stop_timeout)
                    for job in self.jobs:
                        log.info("killing processes for job %r", job.name)
                        job.kill()
                    # give the SIGKILL waiters a beat to reap
                    await asyncio.sleep(0.05)
                    break
                if not self._reload_app():
                    break
        finally:
            self._remove_signal_handlers()

    async def _run_generation(self) -> bool:
        bus = EventBus()
        self.bus = bus
        stop_task: Optional["asyncio.Task[None]"] = None

        def on_job_complete(_job: Job) -> None:
            # escape hatch: all jobs complete -> tear the generation
            # down even without a shutdown event
            # (reference: core/app.go:110-140)
            nonlocal stop_task
            if stop_task is not None:
                return
            if all(j.is_complete for j in self.jobs):
                stop_task = spawn(
                    self._stop_generation(), name="stop-generation"
                )

        await self.control_server.run(bus)

        # subscribe-before-run so no job misses another's early events
        # (reference: core/app.go:201-207)
        for job in self.jobs:
            job.subscribe(bus)
            job.register(bus)
        job_tasks = [job.run(on_complete=on_job_complete) for job in self.jobs]
        for watch in self.watches:
            watch.run(bus)
        if self.telemetry is not None:
            for metric in self.telemetry.metrics:
                metric.run(bus)
            self.telemetry.monitor_jobs(self.jobs)
            self.telemetry.monitor_watches(self.watches)
            await self.telemetry.run()
        bus.publish(GLOBAL_STARTUP)

        reload = await bus.wait()
        await asyncio.gather(*job_tasks, return_exceptions=True)
        # the completion watcher may have scheduled teardown; it MUST
        # finish before a reload rebinds the same control socket, or
        # gen N's unlink would race gen N+1's fresh bind
        if stop_task is not None:
            await stop_task
        else:
            await self._stop_generation()
        return reload

    async def _stop_generation(self) -> None:
        """Serialize teardown of the non-job actors after jobs finish
        (reference: ctx-cancel cascade, core/app.go:113-121)."""
        for watch in self.watches:
            watch.stop()
        if self.telemetry is not None:
            for metric in self.telemetry.metrics:
                metric.stop()
            await self.telemetry.stop()
        await self.control_server.stop()

    def _reload_app(self) -> bool:
        """Rebuild everything from the same config path
        (reference: core/app.go:183-196)."""
        try:
            new_app = App.from_config_path(self.config_path)
        except Exception as exc:
            log.error("error initializing config: %s", exc)
            return False
        # old-generation execs got SIGTERM in their jobs' cleanup; give
        # them the old stopTimeout of grace, then SIGKILL stragglers so
        # a TERM-ignoring child can't double-run alongside the new
        # generation (improvement over the reference, which only kills
        # on final shutdown — core/app.go:147-156)
        old_jobs = self.jobs
        old_grace = self.stop_timeout

        async def _kill_stragglers() -> None:
            await asyncio.sleep(old_grace)
            for job in old_jobs:
                if job.exec is not None and job.exec.running:
                    log.info(
                        "reload: killing straggler processes for job %r",
                        job.name,
                    )
                    job.kill()

        # fire-and-forget by design, but never unreferenced: spawn's
        # module-level pending set keeps the killer alive across the
        # generation swap, and its done-callback logs a death
        spawn(_kill_stragglers(), name="reload-kill-stragglers")
        self.cfg = new_app.cfg
        self.jobs = new_app.jobs
        self.watches = new_app.watches
        self.stop_timeout = new_app.stop_timeout
        self.telemetry = new_app.telemetry
        self.control_server = new_app.control_server
        return True

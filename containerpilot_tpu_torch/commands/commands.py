"""Process execution: spawn, supervise, and tear down child processes.

Capability parity with the reference's command wrapper
(reference: commands/commands.go). Semantics preserved:

- every child runs in its own process group / session so the whole
  subtree can be signalled together (reference: commands.go:104);
- per-exec timeout: on deadline the group is SIGKILLed and the exec is
  reported failed (reference: commands.go:114-120);
- ``term``/``kill`` signal the *group* (reference: commands.go:172-188);
- exit publishes ``{EXIT_SUCCESS|EXIT_FAILED, name}`` plus an
  ``{ERROR, <msg>}`` on failure (reference: commands.go:151-159);
- the child's PID is exported as ``CONTAINERPILOT_<NAME>_PID``
  (reference: commands.go:139-141);
- stdout/stderr are captured line-by-line into structured logging when
  log fields are configured, else passed through raw
  (reference: commands.go:97-103, jobs/config.go:280-283).

Host note: supervised children here are typically per-host torch
training/serving processes; group signalling matters because such
runtimes fork helper processes (e.g. compilation workers, dataloaders)
that must die with the trainer.

The port's own copy of ``containerpilot_tpu/commands/commands.py``.
"""
from __future__ import annotations

import asyncio
import logging
import os
import signal
import re
import time
from typing import Any, Dict, List, Optional

from ..events import Event, EventBus, EventCode
from ..utils.tasks import spawn
from .args import parse_args

log = logging.getLogger("containerpilot.commands")

_NON_ALNUM = re.compile(r"[^A-Za-z0-9]+")
_MULTI_SCORE = re.compile(r"__+")


def env_name(name: str) -> str:
    """Format a job name for env-var use — CONTAINERPILOT_<NAME>_PID /
    _IP (reference: commands/commands.go:59-81): basename, extension
    stripped, non-alphanumerics collapsed to single underscores,
    uppercased."""
    if not name:
        return name
    base = os.path.basename(name)
    root, ext = os.path.splitext(base)
    if ext:
        base = root
    base = _NON_ALNUM.sub("_", base)
    base = _MULTI_SCORE.sub("_", base)
    return base.upper()


class Command:
    """A runnable child-process specification plus its live handle."""

    def __init__(
        self,
        exec_: str,
        args: Optional[List[str]] = None,
        timeout: Optional[float] = None,
        fields: Optional[Dict[str, Any]] = None,
        name: Optional[str] = None,
    ) -> None:
        self.exec = exec_
        self.args = list(args or [])
        self.name = name or exec_
        self.timeout = timeout
        # fields set => capture output into structured logs; fields
        # None => raw passthrough to the supervisor's own stdio.
        self.fields = fields
        self._proc: Optional[asyncio.subprocess.Process] = None
        self._lock = asyncio.Lock()
        self._reader_tasks: List["asyncio.Task[None]"] = []
        # a term/kill that arrives after run() but before the (fire-and-
        # forget) spawn task has actually started the child is remembered
        # and delivered right after spawn, so teardown can't race it; a
        # term/kill with no spawn in flight is simply a no-op
        self._pending_signal: Optional[signal.Signals] = None
        self._spawn_pending = False

    @classmethod
    def from_config(
        cls,
        raw: Any,
        timeout: Optional[float] = None,
        fields: Optional[Dict[str, Any]] = None,
        name: Optional[str] = None,
    ) -> "Command":
        """Build from a raw config value (string or list of args)."""
        exec_, args = parse_args(raw)
        return cls(exec_, args, timeout=timeout, fields=fields, name=name)

    # -- naming ---------------------------------------------------------

    def env_name(self) -> str:
        """Format the name for the CONTAINERPILOT_<NAME>_PID env var."""
        return env_name(self.name)

    # -- state ----------------------------------------------------------

    @property
    def pid(self) -> Optional[int]:
        return self._proc.pid if self._proc is not None else None

    @property
    def running(self) -> bool:
        return self._proc is not None and self._proc.returncode is None

    # -- execution ------------------------------------------------------

    def run(self, bus: EventBus) -> "asyncio.Task[Optional[int]]":
        """Start the child and return the waiter task.

        The waiter publishes exit events on the bus; callers normally
        fire-and-forget the task (the job state machine reacts to the
        published events, not the task result).
        """
        self._spawn_pending = True
        self._pending_signal = None  # nothing queued from before this run
        return spawn(self._run(bus), name=f"exec:{self.name}")

    async def _run(self, bus: EventBus) -> Optional[int]:
        # Exit events are collected while the run lock is held and
        # published only after it is released: fan-out is synchronous,
        # and a subscriber reacting to an exit event may re-enter this
        # command (restart paths) — publishing under the lock is the
        # CP-LOCKPUB deadlock shape.
        events: List[Event] = []
        try:
            async with self._lock:  # never more than one live instance
                return await self._run_locked(events)
        finally:
            for event in events:
                bus.publish(event)

    async def _run_locked(self, events: List[Event]) -> Optional[int]:
        log.debug("%s.run start", self.name)
        started = time.monotonic()
        capture = self.fields is not None
        # drop the previous run's handle so a term/kill arriving
        # mid-spawn queues instead of hitting the dead process
        self._proc = None
        try:
            self._proc = await asyncio.create_subprocess_exec(
                self.exec,
                *self.args,
                stdout=asyncio.subprocess.PIPE if capture else None,
                stderr=asyncio.subprocess.PIPE if capture else None,
                start_new_session=True,
            )
        except Exception as exc:  # spawn failure (ENOENT, EACCES, ...)
            log.error("unable to start %s: %s", self.name, exc)
            self._spawn_pending = False
            self._pending_signal = None
            events.append(Event(EventCode.EXIT_FAILED, self.name))
            events.append(Event(EventCode.ERROR, str(exc)))
            return None
        proc = self._proc
        self._spawn_pending = False
        if self._pending_signal is not None:
            sig, self._pending_signal = self._pending_signal, None
            log.debug(
                "%s: delivering %s queued before spawn", self.name, sig.name
            )
            try:
                os.killpg(proc.pid, sig)
            except ProcessLookupError:
                pass
        env_key = f"CONTAINERPILOT_{self.env_name()}_PID"
        os.environ[env_key] = str(proc.pid)
        if capture:
            fields = dict(self.fields or {})
            fields["pid"] = proc.pid
            self._reader_tasks = [
                asyncio.ensure_future(self._log_stream(proc.stdout, fields)),
                asyncio.ensure_future(self._log_stream(proc.stderr, fields)),
            ]
        try:
            returncode = await self._wait_with_timeout(proc)
        finally:
            if os.environ.get(env_key) == str(proc.pid):
                os.environ.pop(env_key, None)
            if self._reader_tasks:
                # streams EOF once the child exits; drain them fully
                # so trailing output isn't lost
                try:
                    await asyncio.wait_for(
                        asyncio.gather(*self._reader_tasks), timeout=5.0
                    )
                except asyncio.TimeoutError:
                    for t in self._reader_tasks:
                        if not t.done():
                            t.cancel()
            self._reader_tasks = []
            log.debug(
                "%s.run end (%.1fms)",
                self.name,
                (time.monotonic() - started) * 1e3,
            )
        if returncode == 0:
            log.debug("%s exited without error", self.name)
            events.append(Event(EventCode.EXIT_SUCCESS, self.name))
        else:
            log.error("%s exited with error: code %s", self.name, returncode)
            events.append(Event(EventCode.EXIT_FAILED, self.name))
            events.append(
                Event(EventCode.ERROR, f"{self.name}: exit code {returncode}")
            )
        return returncode

    async def _wait_with_timeout(self, proc: asyncio.subprocess.Process) -> int:
        if self.timeout and self.timeout > 0:
            try:
                return await asyncio.wait_for(
                    asyncio.shield(proc.wait()), self.timeout
                )
            except asyncio.TimeoutError:
                log.warning(
                    "%s timeout after %ss: %r",
                    self.name,
                    self.timeout,
                    [self.exec] + self.args,
                )
                self.kill()
                return await proc.wait()
        return await proc.wait()

    async def _log_stream(
        self, stream: Optional[asyncio.StreamReader], fields: Dict[str, Any]
    ) -> None:
        """Forward a child stream into structured logging, line by line."""
        if stream is None:
            return
        job_log = logging.getLogger(f"containerpilot.job.{self.name}")
        try:
            while True:
                line = await stream.readline()
                if not line:
                    break
                job_log.info(
                    line.decode("utf-8", "replace").rstrip("\n"), extra=fields
                )
        except asyncio.CancelledError:
            pass

    # -- signalling (whole process group) -------------------------------

    def _signal_group(self, sig: signal.Signals) -> None:
        if self._proc is None:
            if self._spawn_pending:
                # spawn task created but child not started yet: queue it
                self._pending_signal = sig
            return
        if self._proc.returncode is not None:
            return
        pid = self._proc.pid
        log.debug("%s: signalling group %d with %s", self.name, pid, sig.name)
        try:
            os.killpg(pid, sig)
        except ProcessLookupError:
            pass

    def kill(self) -> None:
        """SIGKILL the whole process group (reference: commands.go:172-178)."""
        self._signal_group(signal.SIGKILL)

    def term(self) -> None:
        """SIGTERM the whole process group (reference: commands.go:182-188)."""
        self._signal_group(signal.SIGTERM)

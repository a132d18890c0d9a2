"""Watch actors: poll the catalog for upstream membership changes.

Capability parity with the reference's watches
(reference: watches/watches.go, watches/config.go): every ``interval``
seconds poll the discovery backend for healthy instances of an upstream
service; when membership changes, publish ``{STATUS_CHANGED,
watch.<name>}`` followed by ``{STATUS_HEALTHY|STATUS_UNHEALTHY,
watch.<name>}``. Jobs with ``when: {source: "watch.<name>", each:
"changed"}`` react to these (e.g. re-render an nginx upstream list, or
repoint a serving process at a moved parameter server).

Config names get the ``watch.`` prefix so watch events can't collide
with job events (reference: watches/config.go:45).

The port's own copy of ``containerpilot_tpu/watches/watches.py``.
"""
from __future__ import annotations

import asyncio
import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

from ..config.decode import coerce_number
from ..config.services import validate_name
from ..discovery import Backend
from ..events import (
    Event,
    EventBus,
    EventCode,
    EventHandler,
    QUIT_BY_TEST,
    cancel_timer,
    event_timer,
)
from ..utils.tasks import spawn

log = logging.getLogger("containerpilot.watches")


class WatchConfigError(ValueError):
    pass


# catalog polls run on a SMALL dedicated pool, not the default
# executor: HTTP backends keep one persistent agent connection per
# thread (discovery/consul.py), so concentrating every poll onto a
# few long-lived threads means the poll reuses a warm connection each
# interval instead of spreading dials across whatever transient
# default-executor thread happens to be free. Eight workers bounds
# head-of-line blocking when a backend call blackholes for its full
# timeout (every watch actor AND every gateway in the process shares
# this pool) while still keeping the per-thread connections warm.
_POLL_EXECUTOR = ThreadPoolExecutor(
    max_workers=8, thread_name_prefix="catalog-poll"
)


async def poll_upstream(
    backend: Backend, service_name: str, tag: str = "", dc: str = ""
) -> tuple:
    """One catalog poll for healthy instances of ``service_name``,
    run OFF the event loop (catalog polls are blocking HTTP/file
    I/O — on the single asyncio loop a slow catalog would stall every
    actor's timers). Returns the backend's (did_change, is_healthy).

    Shared by the supervisor's Watch actors and the fleet gateway's
    replica-discovery loop so both sides poll with one discipline —
    and with one persistent catalog connection per poll thread.
    """
    return await asyncio.get_event_loop().run_in_executor(
        _POLL_EXECUTOR,
        lambda: backend.check_for_upstream_changes(service_name, tag, dc),
    )


class WatchConfig:
    """One validated watch definition (reference: watches/config.go)."""

    def __init__(self, raw: Dict[str, Any]) -> None:
        if not isinstance(raw, dict):
            raise WatchConfigError(f"watch configuration must be a mapping: {raw!r}")
        unknown = set(raw) - {"name", "interval", "tag", "dc"}
        if unknown:
            raise WatchConfigError(
                f"watch[{raw.get('name', '?')}]: unknown keys {sorted(unknown)}"
            )
        self.service_name: str = raw.get("name", "")
        # weakly-typed numerics, like the reference's mapstructure
        # decoding (reference: config/decode/decode.go:14-18)
        self.poll = coerce_number(raw.get("interval", 0))
        self.tag: str = raw.get("tag", "")
        self.dc: str = raw.get("dc", "")
        self.name = ""
        self.backend: Optional[Backend] = None

    def validate(self, disc: Optional[Backend]) -> "WatchConfig":
        try:
            validate_name(self.service_name)
        except ValueError as exc:
            raise WatchConfigError(str(exc)) from None
        self.name = f"watch.{self.service_name}"
        if not isinstance(self.poll, (int, float)) or self.poll < 1:
            raise WatchConfigError(
                f"watch[{self.service_name}].interval must be > 0"
            )
        self.backend = disc
        return self


def new_watch_configs(
    raw: Optional[List[Dict[str, Any]]], disc: Optional[Backend]
) -> List[WatchConfig]:
    if raw is None:
        return []
    if not isinstance(raw, list):
        raise WatchConfigError("watch configuration must be a list")
    return [WatchConfig(item).validate(disc) for item in raw]


class Watch(EventHandler):
    """One watch actor (reference: watches/watches.go:13-117)."""

    def __init__(self, cfg: WatchConfig) -> None:
        super().__init__()
        self.name = cfg.name
        self.service_name = cfg.service_name
        self.tag = cfg.tag
        self.dc = cfg.dc
        self.poll = float(cfg.poll)
        self.backend = cfg.backend
        self._timer: Optional["asyncio.Task[None]"] = None
        self._task: Optional["asyncio.Task[None]"] = None

    def run(self, bus: EventBus) -> "asyncio.Task[None]":
        """Register, start the poll ticker, and run the event loop
        (reference: watches/watches.go:66-103). Unlike jobs, watches
        are registered-only (they publish but don't need global
        subscription — their only input is the private poll timer)."""
        self.register(bus)
        timer_source = f"{self.name}.poll"
        # immediate=True: the first poll happens right away rather than
        # one full interval after startup (improvement over the
        # reference, whose dependents see no upstream state until the
        # first tick)
        self._timer = event_timer(
            self.receive, self.poll, timer_source, immediate=True
        )
        self._task = spawn(
            self._loop(timer_source), name=f"watch:{self.name}"
        )
        return self._task

    def stop(self) -> None:
        """Stop the poll loop (the app cancels watches on teardown)."""
        if self._task is not None and not self._task.done():
            self._task.cancel()

    async def _loop(self, timer_source: str) -> None:
        try:
            while True:
                event = await self.next_event()
                if event == QUIT_BY_TEST:
                    return
                if event == Event(EventCode.TIMER_EXPIRED, timer_source):
                    assert self.backend is not None
                    try:
                        did_change, is_healthy = await poll_upstream(
                            self.backend, self.service_name,
                            self.tag, self.dc,
                        )
                    except Exception as exc:  # a flaky catalog isn't fatal
                        log.warning("%s: poll failed: %s", self.name, exc)
                        continue
                    if did_change:
                        self.publish(Event(EventCode.STATUS_CHANGED, self.name))
                        if is_healthy:
                            self.publish(Event(EventCode.STATUS_HEALTHY, self.name))
                        else:
                            self.publish(Event(EventCode.STATUS_UNHEALTHY, self.name))
        except asyncio.CancelledError:
            pass
        finally:
            cancel_timer(self._timer)
            self.unregister()

    def __repr__(self) -> str:  # pragma: no cover - trivial
        return f"watches.Watch[{self.name}]"


def from_configs(configs: List[WatchConfig]) -> List[Watch]:
    return [Watch(cfg) for cfg in configs]

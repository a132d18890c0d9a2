"""Autoscaler actor: launch capacity into a burst, drain it back out (the
port's own copy of ``containerpilot_tpu/fleet/autoscaler.py``).

The supervisor already knows how to spawn, health-check, and drain
things (jobs/ + the fleet's drain path); what nothing did until now is
*decide* when the serving fleet needs more or fewer of them. This
actor closes the loop:

- **Signals.** Each tick reads one ``FleetLoad`` snapshot — the
  gateway's admission queue depth plus per-replica DISPATCHED load
  (queued work lives in the depth term only, so nothing is counted
  twice). Utilization is ``(Σ load + queue_depth) /
  (replicas * slots_per_replica)``: queued work counts, so a burst
  registers before a single replica saturates.
- **Scale up.** Utilization at/above ``high_water`` for a sustained
  ``up_sustain_s`` launches one replica (up to ``max_replicas``).
  Launching goes through a ``launcher`` the caller provides — the
  chaos harness spawns in-process replicas; a production deployment
  submits a supervisor job (the jobs machinery already spawns and
  health-checks processes, and a launched replica registers itself
  exactly like any FleetMember).
- **Scale down.** Utilization at/below ``low_water`` for a sustained
  ``down_sustain_s`` retires the least-loaded replica (down to
  ``min_replicas``) through the launcher, whose retire path is the
  fleet's drain: deregister, finish in-flight, stop — zero client-visible 5xx.
- **Repair.** The managed set below ``min_replicas`` (a replica
  SIGKILLed under burst) relaunches immediately — min is a floor, not
  a suggestion.
- **Hysteresis + cooldown.** The high/low-water gap, the sustain
  windows, and a post-event ``cooldown_s`` mean one decision per
  burst edge. Catalog flaps can't thrash it: the managed count comes
  from the launcher (its children don't vanish when a poll tears),
  and the gateway's hold-down keeps the load signal continuous.

The actor is pure asyncio (no threads, no locks); wired to an event
bus it announces scale events as METRIC events and stops on
GLOBAL_SHUTDOWN.
"""
from __future__ import annotations

import asyncio
import logging
import random
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Optional

from ..events import Event, EventBus, EventCode
from ..utils.tasks import spawn
from .standby import equal_jitter

log = logging.getLogger("containerpilot.fleet")


class FleetLoad(NamedTuple):
    """One tick's demand snapshot, as the gateway sees it."""

    queue_depth: int
    per_replica: Dict[str, float]


@dataclass
class AutoscalerConfig:
    min_replicas: int = 1
    max_replicas: int = 4
    #: capacity unit per replica (its decode slots): the denominator
    #: of utilization
    slots_per_replica: int = 2
    high_water: float = 0.75
    low_water: float = 0.25
    up_sustain_s: float = 0.3
    down_sustain_s: float = 1.5
    cooldown_s: float = 1.0
    tick_interval: float = 0.2
    #: failed-launch retry backoff (equal-jitter, doubling to the
    #: cap): a launcher that keeps raising — bad image, full host —
    #: must not be hammered every tick, but the fleet keeps trying
    #: and converges to min the moment launches heal
    launch_backoff_s: float = 0.5
    launch_backoff_cap_s: float = 5.0
    #: seed for the backoff jitter (chaos reproducibility)
    jitter_seed: Optional[int] = None

    def __post_init__(self) -> None:
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError("need 1 <= min_replicas <= max_replicas")
        if not 0.0 <= self.low_water < self.high_water:
            raise ValueError("need 0 <= low_water < high_water")
        if self.slots_per_replica < 1:
            raise ValueError("slots_per_replica must be >= 1")
        if self.launch_backoff_s <= 0 or (
            self.launch_backoff_cap_s < self.launch_backoff_s
        ):
            raise ValueError(
                "need 0 < launch_backoff_s <= launch_backoff_cap_s"
            )


class Autoscaler:
    """``launcher`` duck type: ``count() -> int`` and
    ``ids() -> list[str]`` (the replicas this actor manages and
    believes alive), ``async launch() -> str`` (spawn + register one
    replica, returning its id), ``async retire(id)`` (drain + stop
    one). ``signals`` returns a FleetLoad per call."""

    def __init__(
        self,
        launcher: Any,
        signals: Callable[[], FleetLoad],
        cfg: Optional[AutoscalerConfig] = None,
        *,
        bus: Optional[EventBus] = None,
        registry: Any = None,
        pool: str = "",
    ) -> None:
        self.launcher = launcher
        self.signals = signals
        self.cfg = cfg or AutoscalerConfig()
        self.bus = bus
        #: which pool this actor sizes ("" = the whole mixed fleet;
        #: a disaggregated fleet runs one autoscaler per role with
        #: pool="prefill"/"decode") — stamped into scale_log entries
        #: and stats so /fleet attributes every decision to its pool.
        #: Only ONE of the co-attached autoscalers may pass the
        #: gateway registry (the metric names would collide).
        self.pool = pool
        self.scale_ups = 0
        self.scale_downs = 0
        #: launches that raised (or replicas that died during their
        #: warmup, surfacing as a raise from launch()): each one
        #: decrements nothing — the failed replica never joined the
        #: managed count — and arms the equal-jitter retry backoff so
        #: a broken launcher can't be hammered every tick
        self.launch_failures = 0
        #: retires whose drain raised (drainer died mid-migration,
        #: TTL-expired during its migrate window): the tick survives,
        #: the managed-count repair refills any real loss next tick
        self.retire_failures = 0
        self._launch_backoff = self.cfg.launch_backoff_s
        self._launch_retry_at = float("-inf")
        self._rng = random.Random(self.cfg.jitter_seed)
        #: every scale decision, stamped on the tick's monotonic
        #: clock — the fleet goodput ledger reads this to compute
        #: time-to-first-routed-token per launch (gateway.
        #: scale_event_report). Bounded: a marathon autoscaler must
        #: not grow an entry per event forever.
        self._scale_log: "deque[Dict[str, Any]]" = deque(maxlen=128)
        self.last_utilization = 0.0
        self.ticks = 0
        self._over_since: Optional[float] = None
        self._under_since: Optional[float] = None
        # "never scaled": -inf, so the first event can't be held by a
        # cooldown measured against an arbitrary clock origin
        self._last_event = float("-inf")
        self._task: Optional["asyncio.Task[None]"] = None
        self._m_scale = self._g_replicas = self._g_util = None
        self._m_launch_failed = None
        if registry is not None:
            # live in the caller's registry (the gateway's, usually)
            # so /metrics shows admission + autoscaler side by side
            from ..utils.prom import Counter, Gauge

            self._m_scale = Counter(
                "containerpilot_autoscaler_scale_events",
                "replica launches/retires decided by the autoscaler",
                ["direction"], registry=registry,
            )
            self._m_launch_failed = Counter(
                "containerpilot_autoscaler_launch_failed",
                "launch attempts that raised (or whose replica died "
                "during warmup); retried with equal-jitter backoff",
                registry=registry,
            )
            self._g_replicas = Gauge(
                "containerpilot_autoscaler_replicas",
                "replicas currently managed by the autoscaler",
                registry=registry,
            )
            self._g_replicas.set_function(self.launcher.count)
            self._g_util = Gauge(
                "containerpilot_autoscaler_utilization",
                "fleet utilization at the last autoscaler tick "
                "((load + queue depth) / (replicas * slots))",
                registry=registry,
            )

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "asyncio.Task[None]":
        self._task = spawn(self._loop(), name="fleet-autoscaler")
        return self._task

    async def stop(self) -> None:
        if self._task is not None and not self._task.done():
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
        self._task = None

    @property
    def scale_log(self) -> List[Dict[str, Any]]:
        """Stamped scale events, oldest first (bounded window)."""
        return list(self._scale_log)

    @property
    def stats(self) -> Dict[str, Any]:
        out = {
            "pool": self.pool or "fleet",
            "replicas": self.launcher.count(),
            "min_replicas": self.cfg.min_replicas,
            "max_replicas": self.cfg.max_replicas,
            "scale_ups": self.scale_ups,
            "scale_downs": self.scale_downs,
            "launch_failures": self.launch_failures,
            "retire_failures": self.retire_failures,
            "utilization": round(self.last_utilization, 4),
            "high_water": self.cfg.high_water,
            "low_water": self.cfg.low_water,
            "cooldown_s": self.cfg.cooldown_s,
        }
        # a StandbyLauncher exposes its pool (promotions, refills,
        # failures) — surfaced here so /fleet shows the whole
        # promote-instead-of-launch story in one block
        standby = getattr(self.launcher, "standby_stats", None)
        if callable(standby):
            out["standby"] = standby()
        return out

    # -- the control loop -----------------------------------------------

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.cfg.tick_interval)
            try:
                await self.tick()
            except Exception as exc:
                # a failed launch/flaky signal must not kill the
                # loop: a dead autoscaler silently strands the fleet
                # at its current size
                log.warning("autoscaler: tick failed: %s", exc)

    async def tick(self, now: Optional[float] = None) -> None:
        """One observe-decide-act round (public so tests and external
        schedulers can drive it without the timer loop)."""
        now = time.monotonic() if now is None else now
        self.ticks += 1
        load = self.signals()
        n = self.launcher.count()
        if n < self.cfg.min_replicas:
            # repair path: a managed replica died (SIGKILL under
            # burst). No sustain window and NO cooldown — min is an
            # invariant, and a production-scale cooldown must not
            # leave the fleet under-floor for a minute. launch() is
            # awaited inline and count() reflects it immediately, so
            # repairs can't storm — and a FAILING launcher is gated
            # by the launch-retry backoff, so repairs can't storm
            # through failures either.
            if now >= self._launch_retry_at:
                await self._scale_up(now, reason="below min")
            return
        capacity = max(1, n * self.cfg.slots_per_replica)
        util = (
            sum(load.per_replica.values()) + load.queue_depth
        ) / capacity
        self.last_utilization = util
        if self._g_util is not None:
            self._g_util.set(util)
        if util >= self.cfg.high_water:
            self._under_since = None
            if self._over_since is None:
                self._over_since = now
            sustained = now - self._over_since >= self.cfg.up_sustain_s
            cooled = now - self._last_event >= self.cfg.cooldown_s
            if (
                sustained and cooled and n < self.cfg.max_replicas
                and now >= self._launch_retry_at
            ):
                await self._scale_up(now, reason=f"util {util:.2f}")
        elif util <= self.cfg.low_water:
            self._over_since = None
            if self._under_since is None:
                self._under_since = now
            sustained = now - self._under_since >= self.cfg.down_sustain_s
            cooled = now - self._last_event >= self.cfg.cooldown_s
            if sustained and cooled and n > self.cfg.min_replicas:
                await self._scale_down(now, load)
        else:
            # hysteresis band: demand is roughly matched, hold
            self._over_since = None
            self._under_since = None

    async def _scale_up(self, now: float, reason: str) -> None:
        # the decision instant, stamped BEFORE the launch await: the
        # ledger's time-to-first-routed-token must charge the whole
        # cold start (spawn + boot + compile + register + route) to
        # the scale event, not just the post-launch tail
        decided = time.monotonic()
        try:
            replica_id = await self.launcher.launch()
        except Exception as exc:
            # a launch that raised (launcher bug, full host, replica
            # died during its own warmup) must not leak a managed
            # slot or be re-hammered every tick: count it, arm the
            # equal-jitter retry backoff (the gateway's discipline),
            # and let the next eligible tick try again — repair and
            # pressure paths both honor _launch_retry_at
            self.launch_failures += 1
            if self._m_launch_failed is not None:
                self._m_launch_failed.inc()
            delay = equal_jitter(self._launch_backoff, self._rng)
            self._launch_retry_at = now + delay
            self._launch_backoff = min(
                self._launch_backoff * 2, self.cfg.launch_backoff_cap_s
            )
            log.warning(
                "autoscaler: launch failed (%s): %s; retrying in "
                "%.2fs", reason, exc, delay,
            )
            return
        self._launch_backoff = self.cfg.launch_backoff_s
        self._launch_retry_at = float("-inf")
        self.scale_ups += 1
        entry = {"direction": "up", "replica": replica_id, "at": decided}
        if self.pool:
            entry["pool"] = self.pool
        # a StandbyLauncher reports HOW the launch happened
        # ("promoted" vs "cold"): the split the TTFRT report — and
        # the promoted-path chaos bound — are judged on
        last = getattr(self.launcher, "last_launch", None)
        if isinstance(last, dict) and last.get("mode"):
            entry["mode"] = last["mode"]
        self._scale_log.append(entry)
        self._last_event = now  # the tick's clock, not the wall's
        self._over_since = None
        if self._m_scale is not None:
            self._m_scale.labels("up").inc()
        log.info(
            "autoscaler: launched %s (%s, %s; fleet now %d)",
            replica_id, reason, entry.get("mode", "cold"),
            self.launcher.count(),
        )
        self._announce("scale-up", replica_id)

    async def _scale_down(self, now: float, load: FleetLoad) -> None:
        victim = self._least_loaded(load)
        if victim is None:
            return
        decided = time.monotonic()
        try:
            await self.launcher.retire(victim)
        except Exception as exc:
            # the drainer can die MID-retire (TTL expiry inside its
            # migrate window, a SIGKILL racing the drain): the tick
            # must survive it. Count the failure, don't record a
            # scale-down that didn't cleanly happen, and leave the
            # cooldown armed — if the victim really is gone the
            # managed count falls below min and the ordinary repair
            # path relaunches next tick (no slot leak); sessions the
            # partial migration already landed keep their repointed
            # pins (the gateway applied those as they beat).
            self.retire_failures += 1
            self._last_event = now
            self._under_since = None
            log.warning(
                "autoscaler: retire of %s failed mid-drain: %s",
                victim, exc,
            )
            return
        self.scale_downs += 1
        entry = {"direction": "down", "replica": victim, "at": decided}
        if self.pool:
            entry["pool"] = self.pool
        self._scale_log.append(entry)
        self._last_event = now  # the tick's clock, not the wall's
        self._under_since = None
        if self._m_scale is not None:
            self._m_scale.labels("down").inc()
        log.info(
            "autoscaler: retired %s (fleet now %d)",
            victim, self.launcher.count(),
        )
        self._announce("scale-down", victim)

    def _least_loaded(self, load: FleetLoad) -> Optional[str]:
        """The managed replica with the least folded load; replicas
        the gateway has no signal for count as idle."""
        managed = self.launcher.ids()
        if not managed:
            return None
        return min(
            managed,
            key=lambda rid: (load.per_replica.get(rid, 0.0), rid),
        )

    def _announce(self, what: str, replica_id: str) -> None:
        if self.bus is not None:
            self.bus.publish(
                Event(EventCode.METRIC, f"autoscaler.{what}:{replica_id}")
            )

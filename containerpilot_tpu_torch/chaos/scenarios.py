"""Chaos scenarios: a real fleet, a real trace, scheduled faults, and
an SLO-goodput verdict (the port's own copy of
``containerpilot_tpu/chaos/scenarios.py``: its replicas are the port's
``InferenceServer`` on the device the harness is given).

The harness boots the ``make fleet-smoke`` topology for real — N
in-process ``InferenceServer`` replicas (slot engine enabled, so SSE
streaming and cancellation work), one ``FleetMember`` each
heartbeating a ``FileCatalogBackend``, and a ``FleetGateway`` polling
that catalog (through a ``FlakyBackend`` so catalog flaps can be
injected). The trace replays through the gateway exactly as an
external client fleet would: one connection per request, sessions
sticky, streams abandoned mid-flight when the trace says so.

A scenario is declarative: a trace config, a fault schedule, gateway
knobs, an SLO, and the invariant thresholds the run must clear
(``max_5xx`` is 0 for every scenario that models survivable faults —
the whole point of drains, retries, hedging, and hold-downs is that
members dying is not the client's problem). ``run_scenario`` returns a
JSON-able report with the goodput score, per-fault ledger, gateway
counters, and pass/fail per check; the CLI and the tier-1 tests both
consume it.

Determinism: the trace, the fault schedule, per-request seeds, and the
gateway's retry jitter all derive from the scenario seed. Wall-clock
measurements (TTFT/TPOT) naturally vary run to run; WHICH requests
arrive, WHAT they ask, and WHEN faults fire do not.
"""
from __future__ import annotations

import asyncio
import dataclasses
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..analysis.loopcheck import LoopLagProbe, TaskWatchdog
from ..telemetry import goodput as goodput_mod
from .client import issue_request
from .faults import ChaosProxy, Fault, FlakyBackend
from .slo import SLO, RequestRecord, ScenarioScore
from .trace import TraceConfig, TraceRequest, generate_trace, trace_summary

SERVICE = "inference"


def _counter_total(counter) -> float:
    """Sum a labeled counter (``utils/prom``) across its label values."""
    return sum(child.get() for _labels, child in counter.children())


def _counter_by_label(counter, label: str) -> Dict[str, float]:
    """Per-label-value totals of a labeled counter (``utils/prom``)."""
    return {
        labels.get(label, ""): child.get()
        for labels, child in counter.children()
    }


class _HarnessLauncher:
    """The autoscaler's launcher, backed by the harness: launch =
    spawn an in-process replica + member (a production launcher
    submits a supervisor job instead — same duck type), retire =
    the fleet's drain path then stop. ``count``/``ids`` reflect what the
    harness believes alive AND active — standbys are parked capacity,
    not managed count — and catalog flaps can't shrink it, which is
    half the no-thrash story. The standby verbs (``launch_standby``/
    ``promote``) are the inner half of fleet/standby.StandbyLauncher;
    a production launcher would submit a ``--standby`` job and POST
    ``/v3/standby/promote`` at the replica instead."""

    def __init__(self, harness: "FleetHarness") -> None:
        self.harness = harness

    def ids(self) -> List[str]:
        h = self.harness
        return [
            f"replica-{i}"
            for i in range(len(h.servers))
            if i not in h.killed and i not in h.retired
            and h.roles.get(i, "active") == "active"
        ]

    def count(self) -> int:
        return len(self.ids())

    async def launch(self) -> str:
        return await self.harness.spawn_replica()

    async def launch_standby(self) -> str:
        return await self.harness.spawn_replica(role="standby")

    async def promote(self, replica_id: str) -> bool:
        return await self.harness.promote_replica(replica_id)

    async def retire(self, replica_id: str) -> None:
        await self.harness.retire_replica(replica_id)


class _PoolLauncher(_HarnessLauncher):
    """One phase pool's launcher for a disaggregated fleet: the same
    harness duck type scoped to replicas of ONE role, so a prefill
    autoscaler and a decode autoscaler can size their pools
    independently off ``gateway.pool_load(role)`` without either
    counting (or launching into) the other's capacity."""

    def __init__(self, harness: "FleetHarness", role: str) -> None:
        super().__init__(harness)
        self.role = role

    def ids(self) -> List[str]:
        h = self.harness
        return [
            f"replica-{i}"
            for i in range(len(h.servers))
            if i not in h.killed and i not in h.retired
            and h.roles.get(i) == self.role
        ]

    async def launch(self) -> str:
        return await self.harness.spawn_replica(role=self.role)


class FleetHarness:
    """A live multi-replica fleet the fault verbs operate on."""

    def __init__(
        self,
        catalog_dir: str,
        replicas: int = 2,
        *,
        ttl: int = 1,
        heartbeat_interval: float = 0.1,
        use_proxies: bool = False,
        gateway_kwargs: Optional[Dict[str, Any]] = None,
        autoscaler_kwargs: Optional[Dict[str, Any]] = None,
        server_kwargs: Optional[Dict[str, Any]] = None,
        standby_count: int = 0,
        roles: Tuple[str, ...] = (),
        pool_autoscaler_kwargs: Optional[
            Dict[str, Dict[str, Any]]
        ] = None,
        device: str = "cuda",
    ) -> None:
        self.catalog_dir = catalog_dir
        #: where every replica's params and caches live ("cuda" raises
        #: without a card; the CPU only when asked for)
        self.device = device
        self.n_replicas = replicas
        self.ttl = ttl
        self.heartbeat_interval = heartbeat_interval
        self.use_proxies = use_proxies
        self.gateway_kwargs = dict(gateway_kwargs or {})
        # extra InferenceServer knobs (e.g. prefix_cache_entries +
        # kv_spill_bytes for the KV-reuse scenarios)
        self.server_kwargs = dict(server_kwargs or {})
        self.autoscaler_kwargs = (
            dict(autoscaler_kwargs)
            if autoscaler_kwargs is not None else None
        )
        # warm-standby pool size (fleet/standby.py): boots after the
        # active fleet converges, promoted by the autoscaler's
        # launch path — requires autoscaler_kwargs
        self.standby_count = standby_count
        # disaggregated boot roles: replica i boots with
        # init_roles[i] ("prefill"/"decode"), or "active" (mixed)
        # past the tuple's end — the serve --role flag's in-process
        # twin, carried to the catalog by the same heartbeat note
        self.init_roles = tuple(roles)
        # role -> AutoscalerConfig kwargs: one INDEPENDENT autoscaler
        # per phase pool, signalled by gateway.pool_load(role) —
        # prefill sizes on admission-queue/TTFT pressure, decode on
        # slot occupancy (docs/60 § pool sizing)
        self.pool_autoscaler_kwargs = dict(pool_autoscaler_kwargs or {})
        self.pool_autoscalers: Dict[str, Any] = {}
        self.servers: List[Any] = []
        self.members: List[Any] = []
        self.proxies: List[Optional[ChaosProxy]] = []
        #: replica index -> role; promotion flips it active
        self.roles: Dict[int, str] = {}
        self.backend = None  # members' (real) catalog view
        self.flaky: Optional[FlakyBackend] = None  # the gateway's view
        self.gateway = None
        self.autoscaler = None
        self.standby_launcher = None
        self.killed: set = set()
        self.retired: set = set()
        #: slow_boot fault state: replicas spawned while this is > 0
        #: take the extra seconds in warmup (chaos_hook seam)
        self.slow_boot_s = 0.0
        self.fault_log: List[Dict[str, Any]] = []
        self._model = None  # (cfg, params), built once at start

    # -- lifecycle ---------------------------------------------------

    async def spawn_replica(self, role: str = "active") -> str:
        """Boot one replica (server + member, proxy when enabled) and
        register it; the autoscaler's launch verb, the standby
        refill, and the boot loop share this path. Every replica
        shares the harness's params and the process's built kernels,
        so a mid-trace launch warms in milliseconds — UNLESS the
        ``slow_boot`` fault is armed, in which case warmup parks for
        the injected seconds (the production cold-start shape). A
        launch that dies mid-boot tears down what it started and
        re-raises, so the autoscaler's launch-failure path counts it
        instead of leaking a half-born replica."""
        from ..fleet import FleetMember
        from ..workload.serve import InferenceServer

        cfg, params = self._model
        # the index is claimed SYNCHRONOUSLY, before any await: a
        # background standby refill racing a cold launch must mint
        # two distinct replica ids, never two replica-N twins
        # heartbeating one catalog record
        index = len(self.servers)
        self.servers.append(None)
        self.members.append(None)
        self.proxies.append(None)
        self.roles[index] = role
        server = InferenceServer(
            cfg, params, "127.0.0.1", 0, max_len=64,
            slots=2, slot_chunk=4, role=role, device=self.device,
            **self.server_kwargs,
        )
        if self.slow_boot_s > 0:
            delay = self.slow_boot_s

            async def boot_hook(endpoint: str, _d=delay) -> None:
                if endpoint == "warmup":
                    await asyncio.sleep(_d)

            server.chaos_hook = boot_hook
        proxy: Optional[ChaosProxy] = None
        member = None
        try:
            await server.run()
            advertise = None
            if self.use_proxies:
                proxy = ChaosProxy("127.0.0.1", server.port)
                await proxy.start()
                advertise = proxy.port
            member = FleetMember(
                server, self.backend, SERVICE, ttl=self.ttl,
                heartbeat_interval=self.heartbeat_interval,
                instance_id=f"replica-{index}",
                advertise_port=advertise,
            )
            await member.start()
        except BaseException:
            # died during boot/warmup: release what was claimed so
            # the failure is a clean raise that frees its managed
            # slot (the autoscaler counts it as launch_failed), not
            # a leaked listener or a half-born catalog record
            self.killed.add(index)
            if member is not None:
                await member.stop(deregister=True)
            if proxy is not None:
                await proxy.stop()
            await server.stop()
            raise
        self.servers[index] = server
        self.members[index] = member
        self.proxies[index] = proxy
        return f"replica-{index}"

    async def promote_replica(self, replica_id: str) -> bool:
        """Flip one standby active (the StandbyLauncher's promote
        verb): False when the standby died or was already promoted —
        the caller drops it and tries the next. On success the
        member's heartbeat is forced NOW, so the role flip reaches
        the catalog (and the gateway's next poll) without waiting out
        a beat interval — promotion must be a milliseconds event."""
        index = int(replica_id.rsplit("-", 1)[1])
        if index in self.killed or index in self.retired:
            return False
        server = self.servers[index]
        if server is None or not server.promote():
            return False  # still booting, dead, or already promoted
        self.roles[index] = "active"
        try:
            self.members[index]._beat_once()  # noqa: SLF001
        except Exception as exc:
            # the regular beat loop (which already survives per-beat
            # exceptions) will carry the role flip on its next tick
            import logging

            logging.getLogger("containerpilot.chaos").warning(
                "promote %s: forced beat failed: %s", replica_id, exc
            )
        return True

    async def retire_replica(self, replica_id: str) -> None:
        """Scale-down: the fleet's drain invariant — deregister, finish
        in-flight, stop — so retiring capacity is as invisible to
        clients as replica maintenance."""
        index = int(replica_id.rsplit("-", 1)[1])
        if index in self.killed or index in self.retired:
            return
        if self.members[index] is None:
            return  # still booting: nothing registered to drain yet
        self.retired.add(index)
        await self.members[index].drain(timeout=10.0)
        await self.members[index].stop(deregister=True)
        proxy = self.proxies[index]
        if proxy is not None:
            await proxy.stop()
        await self.servers[index].stop()

    def fleet_load(self):
        """The autoscaler's signal: admission queue depth + per-
        replica DISPATCHED load, straight from the gateway's own
        state. Dispatched only, deliberately: every queued request —
        sticky-pinned or not — is already in ``queue_depth``, and
        folding ``Replica.queued`` in as well would double-count
        pinned waiters and scale up on phantom load."""
        from ..fleet import FleetLoad

        gw = self.gateway
        return FleetLoad(
            queue_depth=gw.admission.depth,
            per_replica={
                r.id: float(r.outstanding)
                for r in gw._replicas.values()  # noqa: SLF001
            },
        )

    async def start(self) -> None:
        # torch imports live here, not at module import: the
        # trace/SLO halves of the chaos package stay importable without
        # building a model
        import torch

        from .. import resolve_device
        from ..discovery import FileCatalogBackend
        from ..fleet import Autoscaler, AutoscalerConfig, FleetGateway
        from ..models.transformer import TransformerConfig, init_params

        cfg = TransformerConfig(
            vocab_size=64, d_model=32, n_heads=2, n_layers=1, d_ff=64,
            max_seq_len=64, dtype=torch.float32,
        )
        device = resolve_device(self.device)
        params = init_params(0, cfg, device=device)
        self._model = (cfg, params)
        self.backend = FileCatalogBackend(self.catalog_dir)
        for i in range(self.n_replicas):
            role = (
                self.init_roles[i]
                if i < len(self.init_roles) else "active"
            )
            await self.spawn_replica(role=role)
        self.flaky = FlakyBackend(self.backend)
        kwargs = dict(
            poll_interval=0.1, retries=3, retry_backoff=0.02,
            hedge=False,
        )
        kwargs.update(self.gateway_kwargs)
        self.gateway = FleetGateway(
            self.flaky, SERVICE, "127.0.0.1", 0, **kwargs
        )
        await self.gateway.run()
        for _ in range(200):
            if self.gateway.replica_count == self.n_replicas:
                break
            await asyncio.sleep(0.05)
        if self.gateway.replica_count != self.n_replicas:
            raise RuntimeError(
                f"fleet failed to converge: "
                f"{self.gateway.replica_count}/{self.n_replicas}"
            )
        if self.autoscaler_kwargs is not None:
            launcher: Any = _HarnessLauncher(self)
            if self.standby_count > 0:
                from ..fleet import StandbyLauncher

                launcher = StandbyLauncher(
                    launcher, self.standby_count,
                    jitter_seed=self.gateway_kwargs.get("jitter_seed"),
                )
                # the initial pool boots BEFORE traffic: warm
                # standbys are part of the fleet's steady state, and
                # their boot/compile badput belongs to the pre-trace
                # window exactly like the active replicas' warmup
                await launcher.prefill()
                self.standby_launcher = launcher
            # launch-retry jitter rides the run's seed like the
            # gateway's (seeded replays must replay backoff timing)
            scaler_kwargs = dict(self.autoscaler_kwargs)
            scaler_kwargs.setdefault(
                "jitter_seed", self.gateway_kwargs.get("jitter_seed")
            )
            self.autoscaler = Autoscaler(
                launcher,
                self.fleet_load,
                AutoscalerConfig(**scaler_kwargs),
                registry=self.gateway.registry,
            )
            self.gateway.attach_autoscaler(self.autoscaler)
        for role, kwargs in self.pool_autoscaler_kwargs.items():
            pool_kwargs = dict(kwargs)
            pool_kwargs.setdefault(
                "jitter_seed", self.gateway_kwargs.get("jitter_seed")
            )
            # registry=None: co-attached autoscalers would collide on
            # the per-pool metric names — the fleet-wide autoscaler
            # (when present) keeps the /metrics side; every
            # attached scaler's stats still reach /fleet and the
            # scenario report through scale_event_report
            scaler = Autoscaler(
                _PoolLauncher(self, role),
                lambda r=role: self.gateway.pool_load(r),
                AutoscalerConfig(**pool_kwargs),
                registry=None,
                pool=role,
            )
            self.gateway.attach_autoscaler(scaler)
            self.pool_autoscalers[role] = scaler

    def start_autoscalers(self) -> None:
        """Arm the scaler tick loops. Called AFTER warmup, not inside
        ``start()``: warm requests bypass the gateway, so a fleet
        booted above ``min_replicas`` would read as sustained-idle
        during the (minutes-long on a cold box) compile window and
        scale down replicas the warmup is still talking to. The
        autoscaler's clock starts with the traffic clock."""
        if self.autoscaler is not None:
            self.autoscaler.start()
        for scaler in self.pool_autoscalers.values():
            scaler.start()

    async def stop(self) -> None:
        for scaler in self.pool_autoscalers.values():
            await scaler.stop()
        if self.autoscaler is not None:
            await self.autoscaler.stop()
        if self.standby_launcher is not None:
            await self.standby_launcher.stop()
        if self.gateway is not None:
            await self.gateway.stop()
        for i, member in enumerate(self.members):
            if i in self.retired or member is None:
                continue  # retire_replica already stopped it / mid-boot
            await member.stop(deregister=i not in self.killed)
        for i, proxy in enumerate(self.proxies):
            if proxy is not None and i not in self.retired:
                await proxy.stop()
        for i, server in enumerate(self.servers):
            if (
                i not in self.killed and i not in self.retired
                and server is not None
            ):
                await server.stop()

    # -- fault verbs -------------------------------------------------

    def _log(self, fault: Fault) -> None:
        self.fault_log.append(
            {
                "at_s": fault.at_s, "kind": fault.kind,
                "replica": fault.replica, "value": fault.value,
            }
        )

    def kv_stats(self) -> Dict[str, int]:
        """Summed prefix-cache/spill counters across every replica
        ever booted (killed and retired included — their in-process
        stats remain readable): the fleet-wide reuse ledger."""
        totals: Dict[str, int] = {
            "hits": 0, "misses": 0, "tokens_reused": 0,
            "spilled": 0, "readmitted": 0,
        }
        for server in self.servers:
            pc = getattr(server, "prefix_cache", None)
            if pc is None:
                continue
            for key in totals:
                totals[key] += pc.stats.get(key, 0)
        return totals

    def goodput_stats(self) -> Dict[str, float]:
        """Summed device-time-ledger totals (+ dispatch/token
        counters) across every replica ever booted — killed and
        retired included (their ledgers froze at death, exactly as a
        dead process's heartbeat note stops updating). Snapshotted
        before/after the driven window, the delta is the scenario's
        goodput ledger: scale-up replicas launched mid-trace
        contribute their whole boot/compile life, which is precisely
        the badput the cold-start ROADMAP item must collapse."""
        per = []
        for server in self.servers:
            ledger = getattr(server, "ledger", None)
            if ledger is None:
                continue
            totals = ledger.totals()
            engine = getattr(server, "slot_engine", None)
            totals["dispatches"] = float(
                getattr(engine, "dispatches", 0)
            )
            totals["tokens_out"] = float(
                getattr(engine, "tokens_out", 0)
            )
            per.append(totals)
        return goodput_mod.sum_stage_totals(per)

    def goodput_breakdown(self) -> Dict[str, Any]:
        """Per-replica ledger snapshots (cumulative, whole life) for
        the report — the departed-fold-in view: killed/retired
        replicas stay listed with their frozen totals."""
        out: Dict[str, Any] = {}
        for index, server in enumerate(self.servers):
            ledger = getattr(server, "ledger", None)
            if ledger is None:
                continue
            totals = ledger.totals()
            out[f"replica-{index}"] = {
                "departed": (
                    index in self.killed or index in self.retired
                ),
                "productive_fraction": (
                    goodput_mod.productive_fraction(totals)
                ),
                "stages_s": {
                    s: round(totals[s], 3) for s in goodput_mod.STAGES
                },
            }
        return out

    def goodput_stats_by_role(self) -> Dict[str, Dict[str, float]]:
        """Per-ROLE summed stage totals (cumulative; snapshot twice
        and difference for the driven window) — the disaggregation
        ledger: a decode pool whose productive fraction beats the
        mixed arm's is the whole point of the split, and only a
        per-role cut of the device-time ledger can say so. Roles reflect
        end state (a promoted standby's life lands under "active"),
        and departed replicas' frozen ledgers fold in as ever."""
        per: Dict[str, List[Dict[str, float]]] = {}
        for index, server in enumerate(self.servers):
            ledger = getattr(server, "ledger", None)
            if ledger is None:
                continue
            role = self.roles.get(index, "active")
            per.setdefault(role, []).append(ledger.totals())
        return {
            role: goodput_mod.sum_stage_totals(totals)
            for role, totals in per.items()
        }

    async def apply(self, fault: Fault) -> None:
        self._log(fault)
        if fault.kind == "kill":
            await self.kill(fault.replica)
        elif fault.kind == "drain":
            # graceful scale-away mid-conversation: the fleet's drain
            # invariant (deregister, finish in-flight, stop) — the
            # rebalance event cache-aware routing must absorb warmly
            await self.retire_replica(f"replica-{fault.replica}")
        elif fault.kind == "wedge":
            self.servers[fault.replica].ready = False
        elif fault.kind == "unwedge":
            self.servers[fault.replica].ready = True
        elif fault.kind == "slow":
            self.set_delay(fault.replica, fault.value)
        elif fault.kind == "slow_boot":
            # arms for every replica launched from now on: their
            # warmup parks fault.value seconds (0 disarms) — the
            # cold-start tax the standby pool must mask
            self.slow_boot_s = fault.value
        elif fault.kind == "lossy":
            proxy = self.proxies[fault.replica]
            if proxy is None:
                raise RuntimeError("lossy fault needs use_proxies=True")
            proxy.reset_after_bytes = (
                int(fault.value) if fault.value > 0 else None
            )
        elif fault.kind == "flap":
            assert self.flaky is not None
            self.flaky.flap(int(fault.value))
        else:
            raise ValueError(f"unknown fault kind {fault.kind!r}")

    async def kill(self, i: int) -> None:
        """SIGKILL semantics: heartbeats stop WITHOUT deregistering
        (the record decays critical by TTL), then the server aborts —
        listener and live connections drop with no drain."""
        self.killed.add(i)
        await self.members[i].stop(deregister=False)
        proxy = self.proxies[i]
        if proxy is not None:
            await proxy.stop()
        await self.servers[i].abort()

    def set_delay(self, i: int, delay_s: float) -> None:
        server = self.servers[i]
        if delay_s <= 0:
            server.chaos_hook = None
            return

        async def hook(endpoint: str) -> None:
            if endpoint in ("generate", "completions"):
                await asyncio.sleep(delay_s)

        server.chaos_hook = hook

    async def run_schedule(
        self, faults: Tuple[Fault, ...], clock_zero: float
    ) -> None:
        for fault in sorted(faults, key=lambda f: f.at_s):
            delay = clock_zero + fault.at_s - time.monotonic()
            if delay > 0:
                await asyncio.sleep(delay)
            await self.apply(fault)


@dataclass(frozen=True)
class ScenarioSpec:
    """One scenario: the workload, the faults, and the bar to clear."""

    name: str
    description: str
    trace: TraceConfig
    faults: Tuple[Fault, ...] = ()
    replicas: int = 2
    ttl: int = 1
    use_proxies: bool = False
    gateway: Dict[str, Any] = field(default_factory=dict)
    #: extra InferenceServer knobs per replica (e.g.
    #: prefix_cache_entries + kv_spill_bytes for KV-reuse scenarios)
    server: Dict[str, Any] = field(default_factory=dict)
    #: disaggregated boot roles: replica i boots with roles[i]
    #: ("prefill"/"decode"); replicas past the tuple's end (and the
    #: whole fleet when empty) boot mixed. The role rides the same
    #: heartbeat note role=standby does, and the gateway's
    #: phase-aware _pick degrades to mixed routing the moment a pool
    #: empties — which is exactly what prefill_pool_killed proves
    roles: Tuple[str, ...] = ()
    #: AutoscalerConfig kwargs; None runs without an autoscaler
    autoscaler: Optional[Dict[str, Any]] = None
    #: role -> AutoscalerConfig kwargs: one independent autoscaler
    #: per phase pool (prefill sizes on admission-queue pressure,
    #: decode on slot occupancy — gateway.pool_load(role) is the
    #: signal); None runs without pool autoscalers
    pool_autoscaler: Optional[Dict[str, Dict[str, Any]]] = None
    #: warm-standby pool size (fleet/standby.py; needs autoscaler):
    #: booted before traffic, promoted instead of launched on scale
    #: events, refilled in the background
    standby: int = 0
    slo: SLO = field(default_factory=SLO)
    #: seconds after the last request for TTL expiries / polls to
    #: converge before end-state checks run (and, for autoscaled
    #: scenarios, the sustained-idle window scale-down needs)
    settle_s: float = 0.5
    quick: bool = True
    # -- invariant thresholds ----------------------------------------
    max_5xx: int = 0
    max_transport_errors: int = 0
    min_goodput_fraction: float = 0.9
    expect_hedged_min: int = 0
    expect_flaps_damped_min: int = 0
    #: replica indices that must have left catalog AND routing table
    expect_absent: Tuple[int, ...] = ()
    max_ttft_p99_ms: Optional[float] = None
    max_truncated_streams: Optional[int] = None
    # -- overload / autoscaling invariants ---------------------------
    #: the burst must actually shed (proves admission bit, and that
    #: every shed was honest 429/504, since max_5xx still holds)
    expect_sheds_min: int = 0
    #: goodput floor over the requests the fleet ADMITTED
    min_admitted_goodput_fraction: Optional[float] = None
    expect_scale_up_min: int = 0
    expect_scale_down_min: int = 0
    #: thrash bound: scale_ups + scale_downs must stay under this
    max_scale_events: Optional[int] = None
    # -- mux transport invariants ------------------------------------
    #: abandoned/cancelled streams must become CANCEL frames (stream
    #: id freed, shared connection kept), not connection teardowns
    expect_mux_cancels_min: int = 0
    #: closes where the HTTP/1.1 path would have burned a connection
    expect_conns_saved_min: int = 0
    #: a replica launched mid-run (index >= the boot count) must have
    #: been registered and routed to
    expect_scaled_replica_routed: bool = False
    #: replicas the autoscaler manages at the end (back to min)
    expect_managed_at_end: Optional[int] = None
    # -- KV reuse invariants -------------------------------------------
    #: routing picks that must land on a digest-warm replica (a
    #: drained session re-pinning onto the replica that absorbed its
    #: retried turns is the canonical hit)
    expect_cache_hint_hits_min: int = 0
    #: fleet-wide prefix tokens reused during the trace (warmup
    #: excluded) — proves the reuse machinery ran, not just routed
    expect_tokens_reused_min: int = 0
    #: spill-tier readmissions (device LRU eviction -> host RAM ->
    #: device again) that must have happened
    expect_readmitted_min: int = 0
    # -- disaggregation invariants -------------------------------------
    #: completed prefill->decode KV handoffs (gateway-orchestrated
    #: /v1/prefill seed + /v1/kv/pull, the cp-mux/1 stream) the run
    #: must have performed — proves the split fleet actually moved
    #: KV replica-to-replica instead of silently falling back to
    #: decode-side prefill on every request
    expect_handoffs_min: int = 0
    # -- drain-migration invariants ------------------------------------
    #: sessions a draining replica must have pushed (KV prefix over
    #: the handoff wire, or digest-warm landing) onto survivors —
    #: proves drain ran as a migration, not an eviction
    expect_migrations_min: int = 0
    #: ceiling on migration window timeouts (0 gates "nothing fell
    #: back to the eviction path"; None skips)
    expect_migration_timeouts_max: Optional[int] = None
    #: sessions_migrated must cover pins_repointed: every sticky pin
    #: the gateway moved off an mg= landing corresponds to a prefix
    #: that actually landed on the survivor first
    expect_migrations_cover_moves: bool = False
    #: violation class -> a stage that must NOT dominate it (e.g.
    #: {"ttft": "replica.prefill"}: migrated sessions' TTFT misses
    #: must not be re-prefill — the KV landed, so blame belongs to
    #: queueing/transport, never recompute). Vacuously true when the
    #: class has no violations.
    forbid_dominant_stage: Dict[str, str] = field(default_factory=dict)
    # -- latency-attribution invariants --------------------------------
    #: violation class -> the stage that must dominate it in the
    #: report's stage_attribution (e.g. {"ttft":
    #: "admission_queue_wait"}: a burst's TTFT misses must be queue
    #: wait, not replica compute). Vacuously true when the class has
    #: no violations — the invariant constrains the blame, not the
    #: failure count (goodput floors do that).
    expect_dominant_stage: Dict[str, str] = field(default_factory=dict)
    # -- device-time-ledger invariants ----------------------------------
    #: floor on the driven window's fleet productive fraction —
    #: (prefill + decode) device-seconds over ALL device-seconds the
    #: fleet accrued between traffic start and the end-state reads
    #: (settle included; mid-run scale-ups contribute their whole
    #: boot/compile cold start). Lab-box bars are necessarily low —
    #: the tiny model decodes in ms while injected slow-hooks and
    #: admission waits burn idle wall time — but a floor still
    #: catches the regression class where serving stops progressing
    #: while the fleet stays "up" (None skips the check)
    min_productive_fraction: Optional[float] = None
    #: a scale-up event must carry a finite time-to-first-routed-
    #: token (launch decision -> first 200 served by the new
    #: replica) — the cold-start collapse item's yardstick
    expect_scale_up_ttfrt: bool = False
    #: the PROMOTED-path TTFRT bound: at least one ``mode ==
    #: "promoted"`` scale-up must carry a finite TTFRT, and every
    #: finite one must sit at or under this many seconds — the
    #: tightened cold-start yardstick (cold launches measured
    #: 0.4-5.4s on the lab box; a promotion skips boot AND compile,
    #: so the bound is stated, not aspirational). A promoted event
    #: with ttfrt None is one the trace never routed to (e.g. a
    #: repair promotion in the idle tail) — not serving when nothing
    #: asks is not a violation, which is why the bound applies to
    #: the finite set and the existence check covers the rest.
    #: None skips.
    max_scale_up_ttfrt_s: Optional[float] = None
    #: standby promotions the autoscaler's launcher must have
    #: performed (proves scale-up rode the promote path, not a lucky
    #: cold launch)
    expect_promotions_min: int = 0
    # -- event-loop health invariant ------------------------------------
    #: loopcheck bound: the harness loop (which carries the gateway,
    #: every replica, the members, AND the chaos client) must never
    #: stall longer than this during the driven window. The stated
    #: default leaves generous room for GIL contention with the
    #: decode/compile executor threads on a loaded CPU box while
    #: still catching the CP-ASYNCBLOCK failure shape (a sync sleep,
    #: file read, or device fetch on the loop shows up as its own
    #: duration). Scenarios with harsher compute may raise it —
    #: stating the bound is the point.
    max_loop_lag_ms: float = 1500.0


async def _warm_fleet(
    harness: FleetHarness, requests: List[TraceRequest]
) -> None:
    """Compile every prompt-length bucket the trace will use BEFORE
    the clock starts: each distinct prompt length is a first-use shape
    (kernel builds and allocator growth on the card), and both are
    process-wide, so one warm request per bucket against one replica
    warms the whole in-process fleet. Mid-trace first uses would
    otherwise land in TTFT and score the run on warm-up, not on the
    fleet."""
    port = harness.servers[0].port
    index = 0

    async def warm_one(tokens: List[int]) -> None:
        nonlocal index
        index += 1
        warm = TraceRequest(
            index=-index, at_s=0.0, session_id="warm", tenant=0,
            tokens=tokens, max_new_tokens=2, seed=0,
        )
        record = await issue_request(port, warm, time.monotonic())
        if record.status != 200:
            raise RuntimeError(
                f"warm request (prompt len {len(tokens)}) failed: "
                f"status={record.status} error={record.error!r}"
            )

    lengths = sorted({len(r.tokens) for r in requests})
    for length in lengths:
        await warm_one([1] * length)
    if getattr(harness.servers[0], "prefix_cache", None) is None:
        return
    # with a prefix cache on, the REUSE path has its own compile set:
    # one (1, bucket)-shaped extend program per suffix bucket a hit
    # can rewind+extend. The chained [1]*L warms above only ever
    # produce the smallest bucket (each length extends its
    # predecessor), so larger jumps — turn k of one session matching
    # only a short prefix of a longer prompt — would compile mid-trace
    # and bill warm-up to that request's TTFT. Warm each bucket with a
    # fresh token family: store a MIN_REUSE base, then jump by the
    # bucket so the hit extends exactly that shape.
    from ..workload.serve_prefix import BUCKET, MIN_REUSE

    max_len = lengths[-1] if lengths else 0
    targets = set()
    jump = MIN_REUSE + BUCKET
    while jump <= max_len:
        targets.add(jump)
        jump += BUCKET
    if max_len > MIN_REUSE:
        # the ragged largest jump (max_len - MIN_REUSE may not be a
        # bucket multiple, and its rounded-up bucket is a shape no
        # aligned jump produces)
        targets.add(max_len)
    for i, length in enumerate(sorted(targets)):
        family = 2 + i  # distinct ids, never the [1]* family above
        await warm_one([family] * MIN_REUSE)
        await warm_one([family] * length)


async def _drive(
    requests: List[TraceRequest], port: int, clock_zero: float
) -> List[RequestRecord]:
    tasks = []
    for req in requests:
        delay = clock_zero + req.at_s - time.monotonic()
        if delay > 0:
            await asyncio.sleep(delay)
        tasks.append(
            asyncio.ensure_future(issue_request(port, req, clock_zero))
        )
    return list(await asyncio.gather(*tasks))


async def run_scenario_async(
    spec: ScenarioSpec, catalog_dir: str, seed: int = 0,
    device: str = "cuda",
) -> Dict[str, Any]:
    """Boot the fleet on ``device``, replay the trace while the fault
    schedule fires, and score the run. Returns the JSON-able report."""
    trace_cfg = dataclasses.replace(spec.trace, seed=seed)
    requests = generate_trace(trace_cfg)
    # event-loop sentinel (analysis/loopcheck.py): the watchdog wraps
    # the task factory BEFORE the fleet boots so every task the run
    # creates is covered; the lag probe starts with the traffic clock
    # (boot/warmup deliberately build kernels — that stall is
    # paid before the SLO window opens and must not pollute the bound)
    probe = LoopLagProbe()
    watchdog = TaskWatchdog().install()
    harness = FleetHarness(
        catalog_dir,
        spec.replicas,
        ttl=spec.ttl,
        use_proxies=spec.use_proxies,
        gateway_kwargs=dict(spec.gateway, jitter_seed=seed),
        autoscaler_kwargs=spec.autoscaler,
        server_kwargs=spec.server,
        standby_count=spec.standby,
        roles=spec.roles,
        pool_autoscaler_kwargs=spec.pool_autoscaler,
        device=device,
    )
    try:
        # start() inside the try: a boot that fails half-way (e.g.
        # convergence timeout on a loaded box) must still tear down
        # the members/servers it already launched — stop() tolerates
        # partial state
        await harness.start()
        gw = harness.gateway
        await _warm_fleet(harness, requests)
        harness.start_autoscalers()
        # reuse accounting starts AFTER warmup: the warm requests
        # seed replica-0's prefix cache with [1]*L prompts whose
        # chained matches must not inflate the trace's reuse numbers
        kv_before = harness.kv_stats()
        # device-time accounting starts here too: boot + warmup
        # compile happened before the clock, so the scenario's
        # goodput ledger scores the DRIVEN window (a mid-run
        # scale-up's cold start still lands inside it, deliberately)
        gp_before = harness.goodput_stats()
        gp_role_before = harness.goodput_stats_by_role()
        probe.start()
        clock_zero = time.monotonic()
        schedule = asyncio.ensure_future(
            harness.run_schedule(spec.faults, clock_zero)
        )
        records = await _drive(requests, gw.port, clock_zero)
        await schedule
        # wall clock for goodput stops when the WORKLOAD ends: the
        # settle window below is a convergence knob for the end-state
        # checks, and folding it in would deflate goodput_rps by a
        # constant idle tax that varies per scenario
        wall_s = time.monotonic() - clock_zero
        await asyncio.sleep(spec.settle_s)
        # the settle window stays inside the measured span: autoscaler
        # drain/retire and late TTL expiries run on the same loop and
        # a stall there is just as real to the next request
        probe.stop()
        loop_stats = probe.snapshot()
        score = ScenarioScore(records, wall_s, spec.slo).as_dict()
        catalog_ids = {
            inst.id for inst in harness.backend.instances(SERVICE)
        }
        routing_ids = set(gw._replicas)  # noqa: SLF001
        gateway_stats = {
            "replicas_at_end": gw.replica_count,
            "retried": _counter_total(gw._m_retried),  # noqa: SLF001
            "hedged": _counter_total(gw._m_hedged),  # noqa: SLF001
            "drained_away": _counter_total(gw._m_drained),  # noqa: SLF001
            "catalog_flaps_damped": gw.flaps_damped,
            "admission": gw.admission.stats(),
            "routed": _counter_by_label(
                gw._m_routed, "replica"  # noqa: SLF001
            ),
            "mux_streams": _counter_total(gw._m_mux_streams),  # noqa: SLF001
            "mux_cancels": _counter_total(gw._m_mux_cancels),  # noqa: SLF001
            "conns_saved_by_mux": _counter_total(
                gw._m_conns_saved  # noqa: SLF001
            ),
            "proxy_resets": sum(
                p.resets_injected
                for p in harness.proxies if p is not None
            ),
            "sticky": {
                "size": len(gw._sticky),  # noqa: SLF001
                "capacity": gw.sticky_capacity,
                "evicted": gw.sticky_evicted,
            },
            # disaggregation ledger: completed KV handoffs, bytes
            # moved, failures (fell back to local prefill),
            # digest-warm skips, and summed transfer wall ms
            "handoff": dict(gw.handoffs),
            # drain-migration ledger: sessions landed on survivors,
            # counted fallbacks (failed pushes / window timeouts),
            # sticky pins repointed off mg= landings, and 503 drain
            # answers that carried X-CP-Migrated-To
            "migration": dict(gw.migrations),
        }
        kv_after = harness.kv_stats()
        prompt_tokens = sum(len(r.tokens) for r in requests)
        kv_stats = {
            key: kv_after[key] - kv_before[key] for key in kv_after
        }
        kv_stats.update(
            cache_hint_hits=gw.hint_hits,
            cache_hint_misses=gw.hint_misses,
            prompt_tokens=prompt_tokens,
            # the ML-goodput yardstick: prefix tokens the fleet did
            # NOT recompute, per prompt token it was sent
            tokens_reused_per_prompt_token=round(
                kv_stats["tokens_reused"] / max(1, prompt_tokens), 4
            ),
        )
        autoscaler_stats = (
            dict(harness.autoscaler.stats)
            if harness.autoscaler is not None else None
        )
        # the scenario's device-time ledger: per-stage fleet seconds
        # over the driven window (delta against the pre-traffic
        # snapshot), the productive fraction the specs gate on, the
        # per-replica breakdown (departed replicas' frozen ledgers
        # folded in), and per-scale-event time-to-first-routed-token
        gp_after = harness.goodput_stats()
        gp_delta = {
            key: max(gp_after[key] - gp_before.get(key, 0.0), 0.0)
            for key in gp_after
        }
        gp_tokens = gp_delta["tokens_out"]
        goodput_ledger = {
            "stages_s": {
                s: round(gp_delta[s], 3) for s in goodput_mod.STAGES
            },
            "device_seconds": round(
                sum(gp_delta[s] for s in goodput_mod.STAGES), 3
            ),
            "productive_fraction": goodput_mod.productive_fraction(
                gp_delta
            ),
            "dispatches": int(gp_delta["dispatches"]),
            "tokens_out": int(gp_tokens),
            "dispatches_per_token": (
                round(gp_delta["dispatches"] / gp_tokens, 4)
                if gp_tokens else None
            ),
            "per_replica": harness.goodput_breakdown(),
            "scale_events": gw.scale_event_report(),
        }
        # the per-ROLE cut of the same driven-window delta: the
        # disagg_bench compares the decode pool's productive
        # fraction against the mixed arm's fleet-wide number, and
        # prefill_pool_killed reads it to show where the TTFT hit
        # migrated when the pool died
        gp_role_after = harness.goodput_stats_by_role()
        per_role: Dict[str, Any] = {}
        for role, totals in gp_role_after.items():
            before = gp_role_before.get(role, {})
            role_delta = {
                key: max(totals[key] - before.get(key, 0.0), 0.0)
                for key in totals
            }
            per_role[role] = {
                "replicas": sum(
                    1 for i in harness.roles
                    if harness.roles[i] == role
                ),
                "productive_fraction": (
                    goodput_mod.productive_fraction(role_delta)
                ),
                "device_seconds": round(
                    sum(
                        role_delta.get(s, 0.0)
                        for s in goodput_mod.STAGES
                    ), 3
                ),
            }
        goodput_ledger["per_role"] = per_role
    finally:
        probe.stop()
        await harness.stop()
        watchdog.uninstall()
        # the leak ledger is read AFTER teardown and one drained grace
        # window: a task that died during harness.stop() (or in the
        # final grace_s of the run) must not slip past the
        # task_exceptions == [] gate because its deferred _check
        # hadn't fired when the snapshot was taken
        await asyncio.sleep(watchdog.grace_s * 2)

    loop_stats["task_exceptions"] = watchdog.snapshot()
    loop_stats["tasks_created"] = watchdog.tasks_created

    checks: List[Dict[str, Any]] = []

    def check(name: str, ok: bool, detail: str) -> None:
        checks.append({"name": name, "ok": bool(ok), "detail": detail})

    check(
        "5xx", score["count_5xx"] <= spec.max_5xx,
        f"{score['count_5xx']} client-visible 5xx "
        f"(allowed {spec.max_5xx})",
    )
    check(
        "loop_lag",
        loop_stats["lag_max_ms"] <= spec.max_loop_lag_ms,
        f"event-loop lag max {loop_stats['lag_max_ms']}ms over "
        f"{loop_stats['heartbeats']} heartbeats "
        f"(bound {spec.max_loop_lag_ms}ms; p99 "
        f"{loop_stats['lag_p99_ms']}ms — a blocking call on the loop "
        f"shows up here as its own duration)",
    )
    check(
        "transport_errors",
        score["transport_errors"] <= spec.max_transport_errors,
        f"{score['transport_errors']} client transport errors "
        f"(allowed {spec.max_transport_errors})",
    )
    check(
        "goodput",
        score["goodput_fraction"] is not None
        and score["goodput_fraction"] >= spec.min_goodput_fraction,
        f"goodput fraction {score['goodput_fraction']} "
        f"(floor {spec.min_goodput_fraction})",
    )
    if spec.expect_hedged_min > 0:
        check(
            "hedged",
            gateway_stats["hedged"] >= spec.expect_hedged_min,
            f"{gateway_stats['hedged']:.0f} hedge dispatches "
            f"(expected >= {spec.expect_hedged_min})",
        )
    if spec.expect_flaps_damped_min > 0:
        check(
            "flaps_damped",
            gateway_stats["catalog_flaps_damped"]
            >= spec.expect_flaps_damped_min,
            f"{gateway_stats['catalog_flaps_damped']} empty polls "
            f"damped (expected >= {spec.expect_flaps_damped_min})",
        )
    for idx in spec.expect_absent:
        rid = f"replica-{idx}"
        check(
            f"{rid}_absent",
            rid not in catalog_ids and rid not in routing_ids,
            f"{rid} at end: in catalog={rid in catalog_ids}, in "
            f"routing table={rid in routing_ids} "
            f"(catalog={sorted(catalog_ids)}, "
            f"routing={sorted(routing_ids)})",
        )
    if spec.max_ttft_p99_ms is not None:
        p99 = score["ttft_ms"]["p99"]
        check(
            "ttft_p99",
            p99 is not None and p99 <= spec.max_ttft_p99_ms,
            f"TTFT p99 {p99}ms (cap {spec.max_ttft_p99_ms}ms)",
        )
    if spec.max_truncated_streams is not None:
        check(
            "truncated_streams",
            score["truncated_streams"] <= spec.max_truncated_streams,
            f"{score['truncated_streams']} truncated streams "
            f"(allowed {spec.max_truncated_streams})",
        )
    if spec.expect_sheds_min > 0:
        check(
            "sheds",
            score["sheds"] >= spec.expect_sheds_min,
            f"{score['sheds']} sheds (429={score['shed_429']}, "
            f"504={score['shed_504']}; expected >= "
            f"{spec.expect_sheds_min})",
        )
    if spec.min_admitted_goodput_fraction is not None:
        check(
            "admitted_goodput",
            score["goodput_fraction_admitted"] is not None
            and score["goodput_fraction_admitted"]
            >= spec.min_admitted_goodput_fraction,
            f"goodput over admitted requests "
            f"{score['goodput_fraction_admitted']} "
            f"(floor {spec.min_admitted_goodput_fraction})",
        )
    if spec.expect_scale_up_min > 0:
        ups = (autoscaler_stats or {}).get("scale_ups", 0)
        check(
            "scale_up",
            ups >= spec.expect_scale_up_min,
            f"{ups} scale-ups (expected >= {spec.expect_scale_up_min})",
        )
    if spec.expect_scale_down_min > 0:
        downs = (autoscaler_stats or {}).get("scale_downs", 0)
        check(
            "scale_down",
            downs >= spec.expect_scale_down_min,
            f"{downs} scale-downs "
            f"(expected >= {spec.expect_scale_down_min})",
        )
    if spec.max_scale_events is not None:
        events = (autoscaler_stats or {}).get("scale_ups", 0) + (
            autoscaler_stats or {}
        ).get("scale_downs", 0)
        check(
            "scale_thrash",
            events <= spec.max_scale_events,
            f"{events} scale events (thrash bound "
            f"{spec.max_scale_events})",
        )
    if spec.expect_mux_cancels_min > 0:
        check(
            "mux_cancels",
            gateway_stats["mux_cancels"] >= spec.expect_mux_cancels_min,
            f"{gateway_stats['mux_cancels']:.0f} CANCEL frames "
            f"(expected >= {spec.expect_mux_cancels_min}; an abandoned "
            f"stream must free its stream id, not its connection)",
        )
    if spec.expect_conns_saved_min > 0:
        check(
            "conns_saved_by_mux",
            gateway_stats["conns_saved_by_mux"]
            >= spec.expect_conns_saved_min,
            f"{gateway_stats['conns_saved_by_mux']:.0f} connection "
            f"teardowns avoided (expected >= "
            f"{spec.expect_conns_saved_min})",
        )
    if spec.expect_scaled_replica_routed:
        launched = {
            f"replica-{i}"
            for i in range(spec.replicas, len(harness.servers))
        }
        routed_launched = {
            rid for rid, n in gateway_stats["routed"].items()
            if rid in launched and n > 0
        }
        check(
            "scaled_replica_routed",
            bool(routed_launched),
            f"launched={sorted(launched)}, routed-to="
            f"{sorted(routed_launched)} (a scale-up must register "
            f"AND take traffic)",
        )
    if spec.expect_managed_at_end is not None:
        managed = (autoscaler_stats or {}).get("replicas", -1)
        check(
            "managed_at_end",
            managed == spec.expect_managed_at_end,
            f"{managed} managed replicas at end "
            f"(expected {spec.expect_managed_at_end})",
        )
    if spec.expect_cache_hint_hits_min > 0:
        check(
            "cache_hint_hits",
            kv_stats["cache_hint_hits"]
            >= spec.expect_cache_hint_hits_min,
            f"{kv_stats['cache_hint_hits']} cache-hint routing hits "
            f"(expected >= {spec.expect_cache_hint_hits_min}; a "
            f"re-pinned session must land on the warmest survivor)",
        )
    if spec.expect_tokens_reused_min > 0:
        check(
            "tokens_reused",
            kv_stats["tokens_reused"] >= spec.expect_tokens_reused_min,
            f"{kv_stats['tokens_reused']} prefix tokens reused "
            f"fleet-wide ({kv_stats['tokens_reused_per_prompt_token']}"
            f"/prompt token; expected >= "
            f"{spec.expect_tokens_reused_min})",
        )
    if spec.expect_readmitted_min > 0:
        check(
            "spill_readmitted",
            kv_stats["readmitted"] >= spec.expect_readmitted_min,
            f"{kv_stats['readmitted']} spill-tier readmissions "
            f"(expected >= {spec.expect_readmitted_min}; evicted KV "
            f"must come back from host RAM, not re-prefill)",
        )
    if spec.expect_handoffs_min > 0:
        done = gateway_stats["handoff"]["total"]
        check(
            "kv_handoffs",
            done >= spec.expect_handoffs_min,
            f"{done:.0f} completed prefill->decode KV handoffs, "
            f"{gateway_stats['handoff']['bytes']:.0f} bytes in "
            f"{gateway_stats['handoff']['ms_sum']:.0f}ms total "
            f"(failed={gateway_stats['handoff']['failed']:.0f}, "
            f"digest-warm skips="
            f"{gateway_stats['handoff']['skipped_warm']:.0f}; "
            f"expected >= {spec.expect_handoffs_min})",
        )
    migration_stats = gateway_stats.get("migration", {})
    if spec.expect_migrations_min > 0:
        moved = migration_stats.get("sessions_migrated", 0)
        check(
            "sessions_migrated",
            moved >= spec.expect_migrations_min,
            f"{moved} sessions migrated off draining replicas "
            f"(failed={migration_stats.get('failed', 0)}, "
            f"timeout={migration_stats.get('timeout', 0)}; expected "
            f">= {spec.expect_migrations_min}; a drain must push its "
            f"live KV to survivors, not evict it)",
        )
    if spec.expect_migration_timeouts_max is not None:
        timed_out = migration_stats.get("timeout", 0)
        check(
            "migration_timeouts",
            timed_out <= spec.expect_migration_timeouts_max,
            f"{timed_out} migration window timeouts (bound "
            f"{spec.expect_migration_timeouts_max}; a timeout is the "
            f"counted eviction fallback — this run must not need it)",
        )
    if spec.expect_migrations_cover_moves:
        moved = migration_stats.get("sessions_migrated", 0)
        repointed = migration_stats.get("pins_repointed", 0)
        check(
            "migrations_cover_moves",
            moved >= repointed,
            f"{moved} sessions migrated vs {repointed} sticky pins "
            f"repointed (every repoint must ride an mg= landing — a "
            f"pin moved without its KV is a silent re-prefill)",
        )
    if spec.min_productive_fraction is not None:
        fraction = goodput_ledger["productive_fraction"]
        check(
            "productive_fraction",
            fraction is not None
            and fraction >= spec.min_productive_fraction,
            f"fleet productive fraction {fraction} over the driven "
            f"window (floor {spec.min_productive_fraction}; stages "
            f"{goodput_ledger['stages_s']})",
        )
    if spec.expect_scale_up_ttfrt:
        ups = [
            e for e in goodput_ledger["scale_events"]
            if e["direction"] == "up"
        ]
        finite = [
            e["ttfrt_s"] for e in ups
            if e.get("ttfrt_s") is not None
        ]
        check(
            "scale_up_ttfrt",
            bool(finite),
            f"scale-up time-to-first-routed-token: "
            f"{finite or 'none finite'} over {len(ups)} launch(es) "
            f"(a scale-up must serve its first 200, and the ledger "
            f"must say how long the cold start took)",
        )
    if spec.max_scale_up_ttfrt_s is not None:
        promoted = [
            e for e in goodput_ledger["scale_events"]
            if e["direction"] == "up" and e.get("mode") == "promoted"
        ]
        finite = [
            e["ttfrt_s"] for e in promoted
            if e.get("ttfrt_s") is not None
        ]
        check(
            "promoted_ttfrt_bound",
            bool(finite)
            and max(finite) <= spec.max_scale_up_ttfrt_s,
            f"promoted-path TTFRT {finite or 'none finite'} over "
            f"{len(promoted)} promotion(s) (bound "
            f"{spec.max_scale_up_ttfrt_s}s — a promotion skips boot "
            f"and compile, so this is the fast path's contract)",
        )
    if spec.expect_promotions_min > 0:
        promotions = (
            (autoscaler_stats or {}).get("standby", {})
        ).get("promotions", 0)
        check(
            "standby_promotions",
            promotions >= spec.expect_promotions_min,
            f"{promotions} standby promotions (expected >= "
            f"{spec.expect_promotions_min}; scale-up must ride the "
            f"warm pool, not a cold launch)",
        )
    for cls, want in sorted(spec.expect_dominant_stage.items()):
        attributed = score["stage_attribution"].get(cls)
        if attributed is None:
            check(
                f"dominant_{cls}", True,
                f"no {cls} violations to attribute (vacuous pass)",
            )
        elif attributed["with_stage_data"] == 0:
            # violations happened but NONE carried a stage breakdown:
            # that is a tracing regression (digest dropped or parse
            # broken), not a vacuous pass — failing here keeps the
            # attribution invariant honest
            check(
                f"dominant_{cls}", False,
                f"{attributed['count']} {cls} violations but none "
                f"carried stage data — trace propagation broken?",
            )
        else:
            check(
                f"dominant_{cls}",
                attributed["dominant"] == want,
                f"{attributed['count']} {cls} violations dominated by "
                f"{attributed['dominant']!r} (expected {want!r}; "
                f"stage totals {attributed['stages_ms']})",
            )
    for cls, banned in sorted(spec.forbid_dominant_stage.items()):
        attributed = score["stage_attribution"].get(cls)
        if attributed is None:
            check(
                f"not_dominant_{cls}", True,
                f"no {cls} violations to attribute (vacuous pass)",
            )
        elif attributed["with_stage_data"] == 0:
            check(
                f"not_dominant_{cls}", False,
                f"{attributed['count']} {cls} violations but none "
                f"carried stage data — trace propagation broken?",
            )
        else:
            check(
                f"not_dominant_{cls}",
                attributed["dominant"] != banned,
                f"{attributed['count']} {cls} violations dominated by "
                f"{attributed['dominant']!r} (must NOT be {banned!r}; "
                f"stage totals {attributed['stages_ms']})",
            )

    fault_counts: Dict[str, int] = {}
    for entry in harness.fault_log:
        fault_counts[entry["kind"]] = (
            fault_counts.get(entry["kind"], 0) + 1
        )
    return {
        "scenario": spec.name,
        "description": spec.description,
        "seed": seed,
        "passed": all(c["ok"] for c in checks),
        "checks": checks,
        "trace": trace_summary(requests),
        "score": score,
        # event-loop health (analysis/loopcheck.py): the gated max is
        # also surfaced top-level as the report's schema-stable name
        "loop_lag_max_ms": loop_stats["lag_max_ms"],
        "loop": loop_stats,
        "gateway": gateway_stats,
        "goodput_ledger": goodput_ledger,
        "kv": kv_stats,
        "autoscaler": autoscaler_stats,
        "faults": harness.fault_log,
        "fault_counts": fault_counts,
    }


def run_scenario(
    spec_or_name, catalog_dir: str, seed: int = 0, device: str = "cuda",
) -> Dict[str, Any]:
    """Synchronous entry point (CLI, bench): fresh event loop."""
    spec = (
        SCENARIOS[spec_or_name]
        if isinstance(spec_or_name, str) else spec_or_name
    )
    return asyncio.run(
        run_scenario_async(spec, catalog_dir, seed, device=device)
    )


# -- the registry ----------------------------------------------------

def _trace(**overrides: Any) -> TraceConfig:
    base = dict(
        duration_s=2.5, mean_rps=10.0, burst_factor=3.0,
        tenants=3, sessions_per_tenant=3,
        stream_fraction=0.25, abandon_fraction=0.3,
    )
    base.update(overrides)
    return TraceConfig(**base)


SCENARIOS: Dict[str, ScenarioSpec] = {}


def _register(spec: ScenarioSpec) -> None:
    SCENARIOS[spec.name] = spec


_register(ScenarioSpec(
    name="kill_spare",
    description=(
        "SIGKILL one of three replicas mid-trace with spare capacity: "
        "retries absorb the resets, the record TTL-expires, zero "
        "client-visible 5xx"
    ),
    trace=_trace(),
    faults=(Fault(at_s=0.8, kind="kill", replica=2),),
    replicas=3,
    settle_s=1.5,  # ttl=1 expiry + a poll must land before end checks
    expect_absent=(2,),
    min_goodput_fraction=0.85,
))

_register(ScenarioSpec(
    name="wedged_health",
    description=(
        "a replica's health wedges (heartbeats stop, process still "
        "answers): the record goes catalog-critical by TTL and "
        "traffic routes around it with zero 5xx — the reference "
        "ContainerPilot's core failure mode"
    ),
    trace=_trace(duration_s=3.0),
    faults=(Fault(at_s=0.6, kind="wedge", replica=1),),
    replicas=2,
    settle_s=1.5,
    expect_absent=(1,),
    min_goodput_fraction=0.9,
))

_register(ScenarioSpec(
    name="catalog_flap",
    description=(
        "the catalog transiently answers empty (torn read): the "
        "gateway's hold-down keeps the routing table, zero 5xx, "
        "catalog_flaps_damped > 0"
    ),
    trace=_trace(),
    faults=(
        Fault(at_s=0.5, kind="flap", value=2),
        Fault(at_s=1.5, kind="flap", value=2),
    ),
    replicas=2,
    expect_flaps_damped_min=2,
    min_goodput_fraction=0.95,
))

_register(ScenarioSpec(
    name="slow_replica",
    description=(
        "one replica browns out (injected per-request latency): tail "
        "hedging races the slow legs to the healthy replica, keeping "
        "scenario p99 bounded with zero 5xx"
    ),
    trace=_trace(stream_fraction=0.0),  # hedging covers buffered legs
    faults=(Fault(at_s=0.4, kind="slow", replica=0, value=0.5),),
    replicas=2,
    gateway={"hedge": True, "hedge_after_ms": 100.0},
    expect_hedged_min=1,
    min_goodput_fraction=0.85,
    max_ttft_p99_ms=1800.0,
))

_register(ScenarioSpec(
    name="abandoned_streams_mux",
    description=(
        "SSE-heavy trace where most clients hang up mid-stream, all "
        "over the mux transport: every abandon becomes a CANCEL "
        "frame that frees its stream id while the replicas' shared "
        "connections keep serving the co-resident streams — zero "
        "client-visible 5xx, no connection teardowns"
    ),
    trace=_trace(
        duration_s=2.5, mean_rps=12.0,
        stream_fraction=0.7, abandon_fraction=0.6,
        # long outputs so streams span many decode rounds: an abandon
        # after 1-2 SSE events must land MID-stream (a stream that
        # already ended has nothing to CANCEL), warm caches included
        output_median=24, output_sigma=0.3, max_output=32,
    ),
    replicas=2,
    min_goodput_fraction=0.85,
    expect_mux_cancels_min=1,
    expect_conns_saved_min=3,
))

_register(ScenarioSpec(
    name="lossy_transport",
    description=(
        "the gateway->replica transport turns lossy (RST after a "
        "byte budget, mid-response): buffered requests retry to "
        "clean replicas with zero 5xx; stream truncations stay "
        "bounded"
    ),
    trace=_trace(duration_s=3.0, stream_fraction=0.15),
    faults=(
        Fault(at_s=0.5, kind="lossy", replica=0, value=512),
        Fault(at_s=2.0, kind="lossy", replica=0, value=0),  # heal
    ),
    replicas=2,
    use_proxies=True,
    quick=False,
    min_goodput_fraction=0.75,
    max_truncated_streams=4,
))

_register(ScenarioSpec(
    name="kill_under_burst",
    description=(
        "a replica dies at the height of a 5x burst while the "
        "catalog also flaps: jittered retries + hold-down keep the "
        "run at zero 5xx"
    ),
    trace=_trace(
        duration_s=5.0, mean_rps=16.0, burst_factor=5.0,
        burst_dwell_s=0.6,
    ),
    faults=(
        Fault(at_s=1.0, kind="kill", replica=2),
        Fault(at_s=2.0, kind="flap", value=2),
    ),
    replicas=3,
    settle_s=1.5,
    quick=False,
    expect_absent=(2,),
    expect_flaps_damped_min=1,
    min_goodput_fraction=0.8,
))

_register(ScenarioSpec(
    name="burst_10x",
    description=(
        "a 10x arrival-rate burst slams a browned-out two-replica "
        "fleet: admission control sheds the overflow honestly (429 "
        "for batch past high-water, 504 at the TTFT deadline, both "
        "with drain-rate-derived Retry-After the clients honor with "
        "jitter) — zero client-visible 5xx, and the work the fleet "
        "DID admit still meets its SLOs — and the whole "
        "burst rides the mux transport (interleaved streams on one "
        "warm connection per replica). burst_10x_standby is the SAME "
        "burst with a warm-standby pool: its shed count against this "
        "one's is the cold-start-collapse yardstick"
    ),
    # the injected per-request service floor stands in for a
    # production-sized model's decode time: the lab model answers in
    # ms, which no burst the 1-core box can generate would saturate
    trace=_trace(
        # dwell means favor the burst state so EVERY seed spends
        # real time at 10x — a seed that never bursts can't prove
        # shedding
        duration_s=5.0, mean_rps=6.0, burst_factor=10.0,
        quiet_dwell_s=0.6, burst_dwell_s=1.2,
        stream_fraction=0.1, abandon_fraction=0.2,
        batch_fraction=0.35,
    ),
    faults=(
        Fault(at_s=0.0, kind="slow", replica=0, value=0.15),
        Fault(at_s=0.0, kind="slow", replica=1, value=0.15),
    ),
    replicas=2,
    gateway={
        "admission": {
            "per_replica_inflight": 2,
            "max_queue_depth": 16,
            "high_water": 8,
            "deadline_s": 1.2,
            "session_rate": 8.0,
        },
    },
    settle_s=1.0,
    # TTFT is honest — measured from the FIRST attempt, so a shed
    # that retried after Retry-After (~1-2s) and then served carries
    # the whole dance. The scenario SLO allows one polite retry
    # (3s); the fleet-side bar stays sharp via the 1.2s admission
    # deadline. Floors leave headroom for 1-core-box scheduling
    # noise: observed run-to-run spread is wide under overload.
    slo=SLO(ttft_s=3.0, tpot_s=0.5),
    min_goodput_fraction=0.2,
    min_admitted_goodput_fraction=0.8,
    expect_sheds_min=1,
    # the tracing attribution invariant: a burst's TTFT misses are QUEUE
    # time (gateway admission wait + Retry-After parking, which the
    # client folds into the same stage), never replica compute — an
    # overloaded-but-honest fleet pages the operator at admission,
    # not at the replicas
    expect_dominant_stage={"ttft": "admission_queue_wait"},
    # device-time floor: even shedding honestly under 10x, the fleet
    # must keep ADVANCING admitted work. Measured 0.12-0.28 on the
    # CPU lab box depending on whether the process's jit caches were
    # warm (cold runs bill mid-trace compiles to prefill); the floor
    # sits 3x under the warm minimum and still catches the
    # wedged-but-up regression shape (pf ~ 0: fleet up, nothing
    # advancing)
    min_productive_fraction=0.04,
))

_register(ScenarioSpec(
    name="burst_10x_standby",
    description=(
        "the SAME 10x burst, trace and admission knobs as burst_10x, "
        "with a warm-standby pool: the autoscaler PROMOTES the "
        "standby into the sustained pressure (admission capacity "
        "grows the moment its role flips — ~a poll interval instead "
        "of a full boot), so the fleet OUTRUNS part of the burst "
        "instead of only shedding it. Shed counts against burst_10x "
        "in the same report are the cold-start-collapse yardstick "
        "(105 -> 53 at the suite seed; a lightly-loaded seed can "
        "reach zero sheds, which is the point — so no shed minimum "
        "here; burst_10x keeps the shed-honesty proof)"
    ),
    trace=_trace(
        duration_s=5.0, mean_rps=6.0, burst_factor=10.0,
        quiet_dwell_s=0.6, burst_dwell_s=1.2,
        stream_fraction=0.1, abandon_fraction=0.2,
        batch_fraction=0.35,
    ),
    faults=(
        Fault(at_s=0.0, kind="slow", replica=0, value=0.15),
        Fault(at_s=0.0, kind="slow", replica=1, value=0.15),
    ),
    replicas=2,
    # ttl 2 (not the default 1): the standby pool adds a third (and,
    # refilled, fourth) in-process replica to the one-core box, and
    # a contention spike in a hot suite process can starve a
    # heartbeat thread past a 1s TTL — flapping a HEALTHY replica
    # out of routing mid-burst into no-healthy-replica 503s (the
    # multiturn scenarios carry the same stated mitigation)
    ttl=2,
    gateway={
        "admission": {
            "per_replica_inflight": 2,
            "max_queue_depth": 16,
            "high_water": 8,
            "deadline_s": 1.2,
            "session_rate": 8.0,
        },
    },
    autoscaler={
        "min_replicas": 2,
        "max_replicas": 3,
        "slots_per_replica": 2,
        "high_water": 0.75,
        "low_water": 0.1,
        "up_sustain_s": 0.3,
        "down_sustain_s": 2.0,
        "cooldown_s": 0.7,
        "tick_interval": 0.15,
    },
    standby=1,
    max_scale_events=6,
    settle_s=1.0,
    # mid-run standby refills run a replica warmup on an executor
    # thread; even jit-cache-warm, the GIL bursts bleed into loop
    # scheduling on the 1-core box — same raised, stated bound as
    # the other autoscaled scenarios
    max_loop_lag_ms=3000.0,
    slo=SLO(ttft_s=3.0, tpot_s=0.5),
    min_goodput_fraction=0.2,
    min_admitted_goodput_fraction=0.8,
    expect_promotions_min=1,
    expect_dominant_stage={"ttft": "admission_queue_wait"},
    min_productive_fraction=0.04,
))

_register(ScenarioSpec(
    name="kill_under_burst_autoscaled",
    description=(
        "a replica is SIGKILLed inside an 8x burst while the catalog "
        "flaps: the autoscaler relaunches to hold the min, scales "
        "into the pressure (launched replica registers and takes "
        "traffic), then drains back to min in the idle tail — no "
        "scale thrash, zero client-visible 5xx"
    ),
    trace=_trace(
        # burst-favored dwells, like burst_10x: every seed must
        # spend real time over capacity or the scale-up/-down
        # choreography has nothing to react to
        duration_s=6.5, mean_rps=6.0, burst_factor=8.0,
        quiet_dwell_s=0.6, burst_dwell_s=1.4,
        stream_fraction=0.1, abandon_fraction=0.2,
        batch_fraction=0.25,
    ),
    faults=(
        Fault(at_s=0.0, kind="slow", replica=0, value=0.12),
        Fault(at_s=0.0, kind="slow", replica=1, value=0.12),
        Fault(at_s=1.2, kind="kill", replica=1),
        Fault(at_s=2.5, kind="flap", value=2),
        Fault(at_s=4.0, kind="flap", value=2),
    ),
    replicas=2,
    gateway={
        "admission": {
            "per_replica_inflight": 2,
            "max_queue_depth": 24,
            "high_water": 12,
            "deadline_s": 1.5,
        },
    },
    autoscaler={
        "min_replicas": 2,
        "max_replicas": 4,
        "slots_per_replica": 2,
        "high_water": 0.75,
        "low_water": 0.2,
        "up_sustain_s": 0.3,
        "down_sustain_s": 1.0,
        "cooldown_s": 0.7,
        "tick_interval": 0.15,
    },
    # scale-down needs sustained idle AFTER the trace: the settle
    # window is where the fleet shrinks back to min
    settle_s=5.0,
    # mid-run scale-ups warm a fresh replica on an
    # executor thread; the GIL bursts bleed into loop scheduling
    # (~0.9s observed on the CPU lab box) — a raised, stated bound,
    # not an exemption
    max_loop_lag_ms=3000.0,
    min_goodput_fraction=0.2,
    min_admitted_goodput_fraction=0.8,
    expect_flaps_damped_min=1,
    expect_absent=(1,),
    expect_scale_up_min=1,
    expect_scale_down_min=1,
    max_scale_events=8,
    expect_scaled_replica_routed=True,
    expect_managed_at_end=2,
    # the cold-start yardstick: every launch is stamped into the
    # ledger, and at least one scale-up must carry a finite
    # time-to-first-routed-token (launch decision -> first 200 from
    # the new replica) — the number the ROADMAP's warm-standby work
    # must drive down release-over-release
    expect_scale_up_ttfrt=True,
    slo=SLO(ttft_s=2.5, tpot_s=0.5),
))

_register(ScenarioSpec(
    name="kill_under_burst_promoted",
    description=(
        "the promoted-path variant of kill_under_burst_autoscaled, "
        "with the slow_boot fault armed (every NEW launch pays +2s "
        "of warmup — the production cold-start tax): a replica is "
        "SIGKILLed inside an 8x burst, and repair PROMOTES the warm "
        "standby instead of paying boot+compile — the promoted "
        "scale-up's time-to-first-routed-token stays under a stated "
        "bound that a slow-booted cold launch could not meet, while "
        "the background refill absorbs the slow boot off the "
        "critical path. Zero client-visible 5xx throughout"
    ),
    trace=_trace(
        duration_s=6.5, mean_rps=6.0, burst_factor=8.0,
        quiet_dwell_s=0.6, burst_dwell_s=1.4,
        stream_fraction=0.1, abandon_fraction=0.2,
        batch_fraction=0.25,
    ),
    faults=(
        # slow_boot armed from t=0: anything launched after this —
        # including the standby refill — pays +2s of warmup; only
        # promotion dodges it, which is the point
        Fault(at_s=0.0, kind="slow_boot", value=2.0),
        Fault(at_s=0.0, kind="slow", replica=0, value=0.12),
        Fault(at_s=0.0, kind="slow", replica=1, value=0.12),
        Fault(at_s=1.2, kind="kill", replica=1),
        Fault(at_s=2.5, kind="flap", value=2),
    ),
    replicas=2,
    # ttl 2, like burst_10x: the pool's extra in-process replicas
    # make 1s-TTL heartbeat starvation a real flake shape on the
    # one-core box; the killed corpse still expires well inside the
    # 5s settle window
    ttl=2,
    gateway={
        "admission": {
            "per_replica_inflight": 2,
            "max_queue_depth": 24,
            "high_water": 12,
            "deadline_s": 1.5,
        },
    },
    autoscaler={
        "min_replicas": 2,
        "max_replicas": 4,
        "slots_per_replica": 2,
        "high_water": 0.75,
        "low_water": 0.2,
        "up_sustain_s": 0.3,
        "down_sustain_s": 1.0,
        "cooldown_s": 0.7,
        "tick_interval": 0.15,
    },
    standby=1,
    # scale-down needs sustained idle AFTER the trace; the refilled
    # standby's +2s slow boot also completes inside this window
    settle_s=5.0,
    # same stated GIL-burst allowance as the autoscaled sibling
    max_loop_lag_ms=3000.0,
    min_goodput_fraction=0.2,
    min_admitted_goodput_fraction=0.8,
    expect_flaps_damped_min=1,
    expect_absent=(1,),
    expect_scale_up_min=1,
    max_scale_events=8,
    expect_scaled_replica_routed=True,
    expect_managed_at_end=2,
    expect_promotions_min=1,
    expect_scale_up_ttfrt=True,
    # THE tightened cold-start yardstick: the reference measured
    # cold-launch TTFRT at 0.4-5.4s on its CPU lab box, and the armed slow_boot adds
    # +2s to any cold path — a promotion (role flip + forced beat +
    # one poll + first routed token) must land in 2.0s even on a
    # contended 1-core box
    max_scale_up_ttfrt_s=2.0,
    slo=SLO(ttft_s=2.5, tpot_s=0.5),
))

#: the KV-reuse fleet: a TINY device LRU (2 entries) so a session's
#: newest key is routinely evicted between its turns — forcing the
#: host-RAM spill tier to earn its readmissions — with a budget
#: comfortably holding the lab model's ~16KB entries
_REUSE_SERVER = {
    "prefix_cache_entries": 2,
    "kv_spill_bytes": 512 * 1024,
}

#: sticky pins bounded WELL below the session count: pins churn out
#: of the LRU between most turns (the satellite bound doing its job),
#: and each re-pin is exactly the decision cache-aware routing
#: upgrades — digest-warm replica vs. wherever least-loaded points.
#: cache_slack 2 = one 2-slot replica's worth of queue: warmth may
#: absorb that much extra load (a readmit is far cheaper than a
#: re-prefill) but never out-shouts a real hotspot; retries carry one
#: extra attempt because a drain racing a contention spike can bounce
#: a request off more than one replica
_REUSE_GATEWAY = {"sticky_capacity": 2, "cache_slack": 2, "retries": 3}

#: the multi-turn conversation workload both reuse scenarios replay:
#: growing chat histories whose successive turns share an
#: ever-longer prefix (prompts stop at 48 so prompt + max_new fits
#: the lab model's max_len=64)
#: enough CONCURRENT sessions that one replica cannot hold the whole
#: working set: with sparse arrivals the blind tie-break concentrates
#: every no-pin pick on the lowest-id replica, which is accidentally
#: cache-optimal — routing policies only separate under overlap, the
#: regime a fleet exists for. The think floor keeps turn k+1 from
#: arriving before turn k even completes (real users read the answer)
_REUSE_TRACE = _trace(
    multiturn=True, duration_s=1.2,
    think_time_s=0.5, think_floor_s=0.4,
    tenants=3, sessions_per_tenant=4, turns_per_session=5,
    max_prompt=56, max_output=6, output_median=4,
    stream_fraction=0.15, abandon_fraction=0.3,
)

_REUSE_FAULTS = (Fault(at_s=0.9, kind="drain", replica=0),)

_register(ScenarioSpec(
    name="multiturn_rebalance",
    description=(
        "multi-turn chat sessions (growing shared-prefix histories) "
        "against a bounded sticky table while a replica DRAINS "
        "mid-conversation: evicted/drained pins re-route, and "
        "cache-aware routing lands each re-pinned session on the "
        "replica that actually holds its KV (cache_hint_hits > 0) "
        "with zero client-visible 5xx — the host-RAM spill tier "
        "readmitting what the tiny device LRU evicted between turns "
        "instead of re-prefilling it"
    ),
    trace=_REUSE_TRACE,
    faults=_REUSE_FAULTS,
    replicas=4,
    # ttl 2 (not the default 1): four replicas + gateway + client in
    # ONE lab-box process means a contention spike can starve a
    # heartbeat thread past a 1s TTL and flap a healthy replica out
    # of the routing table mid-drain
    ttl=2,
    server=dict(_REUSE_SERVER),
    gateway=dict(_REUSE_GATEWAY),
    settle_s=1.0,
    # spill readmits (device_put) and mid-trace extend-bucket jit
    # compiles burst the GIL from the executor threads (~0.35-0.65s
    # lag observed on the CPU lab box) — a raised, stated bound
    max_loop_lag_ms=2500.0,
    # 2 slots/replica on the 1-core lab box: bursts of co-resident
    # turns queue on slots, so the TTFT bar carries headroom the way
    # burst_10x's does — the floor still bites on real regressions
    slo=SLO(ttft_s=4.0, tpot_s=0.5),
    expect_absent=(0,),
    min_goodput_fraction=0.8,
    expect_cache_hint_hits_min=1,
    expect_tokens_reused_min=100,
    expect_readmitted_min=1,
    # the drain is now a MIGRATION: at least one session's KV must
    # land on a survivor over the handoff wire, and every sticky pin
    # the gateway repoints must ride one of those landings (reuse
    # holding through the drain is the expect_tokens_reused_min gate
    # above — migration is HOW it holds)
    expect_migrations_min=1,
    expect_migrations_cover_moves=True,
    # device-time floor: measured ~0.044 warm-process (tier-1 module
    # runs — the tiny model's reuse-accelerated turns cost ms) up to
    # ~0.59 cold (mid-trace extend-bucket compiles billed to
    # prefill); the floor sits 4x under the warm minimum and catches
    # the regression that turns serving into pure idle waiting
    min_productive_fraction=0.01,
))

_register(ScenarioSpec(
    name="multiturn_sticky_baseline",
    description=(
        "the SAME multi-turn drain workload with cache-aware routing "
        "OFF (pure session-sticky + least-outstanding): the baseline "
        "prefix_reuse_bench compares fleet tokens_reused/token "
        "against — re-pins after an eviction or the drain land by "
        "load, blind to where the KV lives"
    ),
    trace=_REUSE_TRACE,
    faults=_REUSE_FAULTS,
    replicas=4,
    # ttl 2 (not the default 1): four replicas + gateway + client in
    # ONE lab-box process means a contention spike can starve a
    # heartbeat thread past a 1s TTL and flap a healthy replica out
    # of the routing table mid-drain
    ttl=2,
    server=dict(_REUSE_SERVER),
    gateway=dict(_REUSE_GATEWAY, cache_routing=False),
    settle_s=1.0,
    quick=False,  # the bench drives it explicitly, by name
    slo=SLO(ttft_s=4.0, tpot_s=0.5),
    expect_absent=(0,),
    # this arm is the COMPARISON BASELINE, not a robustness gate: its
    # blind tie-break concentrates no-pin picks onto one replica, and
    # on the shared-core lab box that hot spot can starve heartbeats
    # into transient no-healthy-replica 503s and TTFT spikes — the
    # degradation prefix_reuse_bench exists to measure, not a reason
    # to fail the measurement. The aware arm keeps the strict bars.
    max_5xx=30,
    min_goodput_fraction=0.0,
    expect_tokens_reused_min=1,
))

_register(ScenarioSpec(
    name="scale_down_migrated",
    description=(
        "the AUTOSCALER retires a replica out of a live multi-turn "
        "fleet (3 -> min 2) and the retire path runs the migrate "
        "window: every live session's KV pushes to a digest-chosen "
        "survivor over the handoff wire before the record "
        "deregisters, sticky pins repoint off mg= landings, and the "
        "next turns land warm — zero client-visible 5xx, zero "
        "migration-window timeouts, and any TTFT violations must "
        "NOT be re-prefill (the KV moved, so recompute is the one "
        "cause this scenario forbids)"
    ),
    trace=_REUSE_TRACE,
    # no injected fault: the scale-down IS the event, decided by the
    # autoscaler when the trace's load falls away
    faults=(),
    replicas=3,
    # ttl 2 for the same reason as multiturn_rebalance: one lab-box
    # process carries the whole fleet, and a contention spike must
    # not flap a healthy replica mid-retire
    ttl=2,
    server=dict(_REUSE_SERVER),
    # sticky capacity raised well above the session count: this
    # scenario gates on pins REPOINTING (mg= landings / drain
    # answers), so pins must still exist when the retire fires —
    # LRU churn is multiturn_rebalance's subject, not this one's
    gateway=dict(_REUSE_GATEWAY, sticky_capacity=12),
    autoscaler={
        "min_replicas": 2,
        "max_replicas": 3,
        "slots_per_replica": 2,
        # high_water parked out of reach: the scenario is about the
        # way DOWN — a surprise scale-up would hide the migration
        # under fresh capacity
        "high_water": 0.95,
        # low_water UNDER one outstanding request's occupancy (1/6):
        # only a totally idle fleet reads as under, so the down can
        # only fire once the conversations have stopped arriving —
        # when the victim's prefix cache is at its fullest
        "low_water": 0.1,
        "up_sustain_s": 10.0,
        "down_sustain_s": 2.0,
        "cooldown_s": 0.5,
        "tick_interval": 0.15,
    },
    # the idle tail is where down_sustain elapses, the retire's
    # migrate window runs, and the survivors serve the repointed
    # sessions' final turns
    settle_s=5.0,
    # spill readmits + extend-bucket compiles burst the GIL exactly
    # as in multiturn_rebalance — same raised, stated bound
    max_loop_lag_ms=2500.0,
    slo=SLO(ttft_s=4.0, tpot_s=0.5),
    min_goodput_fraction=0.8,
    expect_scale_down_min=1,
    expect_managed_at_end=2,
    expect_migrations_min=1,
    # the counted eviction fallback must stay unused: a localhost
    # push inside a 5s window has no business timing out
    expect_migration_timeouts_max=0,
    expect_migrations_cover_moves=True,
    forbid_dominant_stage={"ttft": "replica.prefill"},
    min_productive_fraction=0.01,
))

#: the disaggregation fleet's server knobs: the KV-reuse tiering
#: (tiny device LRU + host spill, so handoffs adopt into the spill
#: tier and readmit on demand) PLUS the synthetic cold-admission
#: floor. The lab model prefills in ~ms, so phase specialization
#: would have nothing to relieve; prefill_floor_s stands in for a
#: production-sized prompt occupying the slot worker between decode
#: windows, and serve_slots carves the floor's seconds to IDLE in
#: the device-time ledger so the mixed arm's productive fraction is
#: not inflated by the very interference the split removes
_DISAGG_SERVER = dict(_REUSE_SERVER, prefill_floor_s=0.25)

#: default-capacity sticky pins (the decode pin made by the handoff
#: orchestration must survive until the generation routes) with the
#: reuse scenarios' cache_slack and retry depth
_DISAGG_GATEWAY = {"cache_slack": 2, "retries": 3}

#: the disaggregation workload: multiturn conversations whose first
#: turns all clear the fingerprint floor (handoff-eligible by
#: construction: first_turn_min=16), streaming-heavy with NO
#: abandons so nearly every request carries a measurable TPOT — the
#: headline disagg_bench metric is the decode pool's TPOT p99 under
#: concurrent cold-prefill pressure
_DISAGG_TRACE = _trace(
    multiturn=True, duration_s=1.6,
    think_time_s=0.5, think_floor_s=0.4,
    tenants=3, sessions_per_tenant=3, turns_per_session=4,
    max_prompt=56, max_output=10, output_median=8,
    stream_fraction=0.85, abandon_fraction=0.0,
)

#: one prefill replica, two decode replicas — the SAME fleet size as
#: the mixed baseline, split into phase pools
_DISAGG_ROLES = ("prefill", "decode", "decode")

_register(ScenarioSpec(
    name="disagg_mixed_baseline",
    description=(
        "the disaggregation comparison arm: three MIXED replicas "
        "serve the multiturn streaming trace while every cold "
        "prefill occupies its replica's slot worker for the "
        "injected admission floor — the interference that inflates "
        "co-resident streams' TPOT and that disagg_split removes. "
        "disagg_bench replays this arm and the split arm on the "
        "same seed and compares decode TPOT p99, handoff cost, and "
        "per-role productive fraction"
    ),
    trace=_DISAGG_TRACE,
    replicas=3,
    # ttl 2: three replicas + gateway + client in one lab-box
    # process, same heartbeat-starvation mitigation as the other
    # multiturn scenarios
    ttl=2,
    server=dict(_DISAGG_SERVER),
    gateway=dict(_DISAGG_GATEWAY),
    settle_s=1.0,
    quick=False,  # the bench drives it explicitly, by name
    # spill readmits + the deliberate admission floors burst the GIL
    # from executor threads — the multiturn scenarios' stated bound
    max_loop_lag_ms=2500.0,
    # loose bars: this arm is the MEASUREMENT BASELINE — the floors
    # are supposed to hurt its tail, and the bench reads the p99s
    # from both arms' reports rather than this spec failing the run
    slo=SLO(ttft_s=4.0, tpot_s=0.5),
    min_goodput_fraction=0.5,
    min_productive_fraction=0.01,
))

_register(ScenarioSpec(
    name="disagg_split",
    description=(
        "the SAME trace, fleet size, and admission floor as "
        "disagg_mixed_baseline, with the fleet split into phase "
        "pools (1 prefill + 2 decode): fresh prompts prefill on the "
        "prefill pool, the KV prefix ships replica-to-replica over "
        "the cp-mux/1 handoff stream, and the decode pool readmits "
        "it through the same reuse_admission path a local spill "
        "takes — so decode slot workers never stall on a cold "
        "prefill floor, and each pool's independent autoscaler "
        "(admission-pressure for prefill, slot occupancy for "
        "decode) holds its own size"
    ),
    trace=_DISAGG_TRACE,
    replicas=3,
    roles=_DISAGG_ROLES,
    ttl=2,
    server=dict(_DISAGG_SERVER),
    gateway=dict(_DISAGG_GATEWAY),
    # one independent autoscaler per pool, signalled by
    # gateway.pool_load(role); min==max holds the 1+2 split so the
    # bench compares a FIXED fleet, but the wiring (pool-stamped
    # scale log + stats, per-pool load signal) runs for real
    pool_autoscaler={
        "prefill": {
            "min_replicas": 1, "max_replicas": 1,
            "slots_per_replica": 2, "tick_interval": 0.2,
        },
        "decode": {
            "min_replicas": 2, "max_replicas": 2,
            "slots_per_replica": 2, "tick_interval": 0.2,
        },
    },
    settle_s=1.0,
    quick=False,  # the bench drives it explicitly, by name
    max_loop_lag_ms=2500.0,
    slo=SLO(ttft_s=4.0, tpot_s=0.5),
    min_goodput_fraction=0.5,
    # the split must actually MOVE KV: fresh first turns (>= 3 per
    # seed with 9 sessions) each complete a prefill->decode handoff,
    # and the decode pool readmits what it adopted
    expect_handoffs_min=3,
    expect_tokens_reused_min=50,
    expect_readmitted_min=1,
    min_productive_fraction=0.01,
))

_register(ScenarioSpec(
    name="prefill_pool_killed",
    description=(
        "the ENTIRE prefill pool is SIGKILLed early in a multiturn "
        "streaming run: in-flight handoff legs fail onto the "
        "degradation ladder (dead leg excluded + sticky pin "
        "invalidated in the same cycle), fresh prompts fall back to "
        "decode-side local prefill — paying the admission floor "
        "there, which is exactly where the TTFT attribution must "
        "land (replica.prefill, not a mystery smear) — and every "
        "conversation completes with zero client-visible 5xx"
    ),
    trace=_DISAGG_TRACE,
    # kill at 0.25s: early enough that most sessions' first turns
    # arrive AFTER the pool is gone (the local-prefill cohort must
    # dominate the TTFT attribution), late enough that in-flight
    # handoffs are routinely caught mid-leg
    faults=(Fault(at_s=0.25, kind="kill", replica=0),),
    replicas=3,
    roles=_DISAGG_ROLES,
    ttl=2,
    server=dict(_DISAGG_SERVER),
    gateway=dict(_DISAGG_GATEWAY),
    # killed-corpse TTL expiry (2s) + a poll must land before the
    # end-state absence checks
    settle_s=2.5,
    max_loop_lag_ms=2500.0,
    # the TTFT bar sits BELOW the admission floor on purpose, the
    # burst_10x discipline: every floor-paying cold prefill is a
    # violation, and the invariant pins WHERE the time went — the
    # decode replicas' own prefill windows — while the goodput floor
    # (warm turns reuse and stay fast) keeps the run honest
    slo=SLO(ttft_s=0.2, tpot_s=0.5),
    min_goodput_fraction=0.5,
    expect_absent=(0,),
    expect_dominant_stage={"ttft": "replica.prefill"},
    min_productive_fraction=0.01,
))

_register(ScenarioSpec(
    name="rolling_chaos",
    description=(
        "the marathon: brownout, catalog flap, wedged health, "
        "recovery, and a kill across one long bursty trace — the "
        "compound-fault bar every future routing change must clear"
    ),
    trace=_trace(duration_s=8.0, mean_rps=12.0),
    faults=(
        Fault(at_s=0.8, kind="slow", replica=0, value=0.3),
        Fault(at_s=1.6, kind="flap", value=2),
        Fault(at_s=2.5, kind="wedge", replica=1),
        Fault(at_s=4.0, kind="slow", replica=0, value=0.0),  # heal
        Fault(at_s=4.5, kind="unwedge", replica=1),
        Fault(at_s=6.0, kind="kill", replica=2),
    ),
    replicas=3,
    ttl=2,
    settle_s=2.5,
    gateway={"hedge": True, "hedge_after_ms": 150.0},
    quick=False,
    expect_absent=(2,),
    expect_flaps_damped_min=1,
    min_goodput_fraction=0.75,
))


def quick_scenarios() -> List[str]:
    return [s.name for s in SCENARIOS.values() if s.quick]


def full_scenarios() -> List[str]:
    return list(SCENARIOS)

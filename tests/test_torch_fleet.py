"""The port's fleet membership against the reference: the heartbeat note
a torch server produces parses, through the reference's
``notes.split_note``/``parse_field``, to the same fields as a JAX
server's; a port ``FleetMember`` registers, heartbeats and drains in a
``FileCatalogBackend`` directory the reference backend reads; the port's
Consul backend puts the reference's requests on the wire; and the port's
event bus and note registry pass cases mirrored from
``tests/test_events.py`` and ``tests/test_notes.py``."""
import asyncio
import http.server
import json
import math
import socket
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from containerpilot_tpu.discovery import (
    FileCatalogBackend as RefFileCatalog,
)
from containerpilot_tpu.discovery.consul import ConsulBackend as RefConsul
from containerpilot_tpu.fleet import notes as ref_notes
from containerpilot_tpu.kvtier import HostSpillTier as RefSpill
from containerpilot_tpu.models import transformer as jtf
from containerpilot_tpu.workload.serve import (
    InferenceServer as JaxServer,
)
from containerpilot_tpu_torch import bridge
from containerpilot_tpu_torch.discovery import (
    FileCatalogBackend,
    NoopBackend,
    ServiceDefinition,
    ServiceRegistration,
    new_backend,
)
from containerpilot_tpu_torch.discovery.consul import ConsulBackend
from containerpilot_tpu_torch.events import (
    DEBUG_RING_SIZE,
    Event,
    EventBus,
    EventCode,
    EventHandler,
    GLOBAL_ENTER_MAINTENANCE,
    GLOBAL_EXIT_MAINTENANCE,
    GLOBAL_SHUTDOWN,
    GLOBAL_STARTUP,
    QUIT_BY_TEST,
    cancel_timer,
    code_from_string,
    event_timeout,
    event_timer,
)
from containerpilot_tpu_torch.fleet import FleetMember, notes
from containerpilot_tpu_torch.kvtier.spill import HostSpillTier
from containerpilot_tpu_torch.models import transformer as ttf
from containerpilot_tpu_torch.utils import tasks
from containerpilot_tpu_torch.workload.serve import InferenceServer

BASE = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=1, d_ff=64,
            max_seq_len=64, dtype="float32")
MAX_LEN = 64


# -- the note schema, held against the reference -------------------------


class _Server:
    """The full duck-typed member surface, every field populated."""

    occupancy = 0.5
    role = "standby"

    def compile_cache_note(self):
        return notes.encode_compile_cache("beef", "/tmp/cache dir")

    def kv_note(self):
        return "5,2,160,1,1"

    def prefix_digest_note(self):
        return "v7:" + "ab" * 16

    def goodput_note(self):
        return "1.000,2.000,3.000,0.100,0.200,0.000,0.000,4,40"

    def migrate_note(self):
        return "2,3,0,0,1;0000002a:r2"


def test_note_registry_is_the_reference_vocabulary_in_its_order():
    assert [f.name for f in notes.FIELDS] == [
        f.name for f in ref_notes.FIELDS]
    assert notes.field_names() == ref_notes.field_names()
    assert notes.ROLE_ACTIVE == ref_notes.ROLE_ACTIVE


@pytest.mark.parametrize("server", [_Server(), object()],
                         ids=["every_field", "bare"])
def test_member_note_equals_the_references(server):
    assert notes.member_note(server) == ref_notes.member_note(server)


@pytest.mark.parametrize("name,raw", [
    ("occ", "0.50"), ("occ", "2.5"), ("occ", "nan"), ("occ", None),
    ("role", " decode "), ("role", 3), ("cc", "beef:%2Ftmp%2Fcc"),
    ("cc", ":x"), ("kv", "7,x,9"), ("kv", "3,4,120,2,1"),
    ("pd", "v2:0000002a"), ("pd", "v1:abc"),
    ("gp", "1,2,3,4,5,6,7,8,9"), ("gp", "bogus"),
    ("mg", "2,3,0,0,1;0000002a:r2;zz:q"), ("mg", ""),
])
def test_parse_field_equals_the_references(name, raw):
    assert notes.parse_field(name, raw) == ref_notes.parse_field(name, raw)


def test_active_role_advertises_by_omission_and_parsers_are_tolerant():
    class _Active(_Server):
        role = notes.ROLE_ACTIVE

    assert "role=" not in notes.member_note(_Active())
    assert notes.parse_occ("-1") == 0.0
    assert notes.parse_occ(math.pi) is None
    assert notes.parse_compile_cache(None) == ("", "")
    with pytest.raises(KeyError):
        notes.parse_field("zz", "1")


def _jax_and_torch_params():
    jcfg = jtf.TransformerConfig(**{**BASE, "dtype": jnp.float32})
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                "cpu")
    return jcfg, jp, ttf.TransformerConfig(**bridge.config_kwargs(BASE)), tp


def test_torch_server_note_parses_like_a_jax_servers():
    """Both servers hold the same cached prefix (one spilled, one on the
    device) and the decode role: through the reference's parsers their
    notes give the same occ, role, kv and pd fields, and gp the same
    stage names; neither has migrated, so neither sends mg=."""
    jcfg, jp, tcfg, tp = _jax_and_torch_params()
    jax_server = JaxServer(jcfg, jp, "127.0.0.1", 0, max_len=MAX_LEN,
                           prefix_cache_entries=1, kv_spill_bytes=1 << 20,
                           role="decode")
    torch_server = InferenceServer(
        tcfg, tp, "127.0.0.1", 0, MAX_LEN, device="cpu",
        prefix_cache_entries=1, kv_spill_bytes=1 << 20, role="decode")
    keys = [tuple(range(1, 33)), tuple(range(40, 60))]
    for key in keys:
        base = jnp.full((2, 8), key[0], jnp.float32)
        jax_server.prefix_cache.store(key, {"k": base, "v": base,
                                            "pos": jnp.int32(8)})
        t = torch.full((2, 8), float(key[0]))
        torch_server.prefix_cache.store(key, {"k": t, "v": t, "pos": 8})
    fields = [ref_notes.split_note(ref_notes.member_note(s))
              for s in (jax_server, torch_server)]
    assert fields[0].keys() == fields[1].keys() == {
        "occ", "role", "kv", "pd", "gp"}
    for name in ("occ", "role", "kv", "pd"):
        assert ref_notes.parse_field(name, fields[1][name]) == (
            ref_notes.parse_field(name, fields[0][name])), name
    assert ref_notes.parse_field("role", fields[1]["role"]) == "decode"
    assert ref_notes.parse_field("kv", fields[1]["kv"])["spilled"] == 1
    gp = [ref_notes.parse_field("gp", f["gp"]) for f in fields]
    assert gp[0].keys() == gp[1].keys() and gp[1]["dispatches"] == 0
    assert torch_server.prefix_cache.spill.snapshot()["entries"] == 1


# -- membership through a catalog the reference reads --------------------


def test_member_registers_heartbeats_and_drains_in_a_shared_catalog(
        run, tmp_path):
    _jcfg, _jp, tcfg, tp = _jax_and_torch_params()
    root = str(tmp_path / "catalog")
    ref_backend = RefFileCatalog(root)

    async def until(pred, what, tries=200):
        for _ in range(tries):
            if pred():
                return
            await asyncio.sleep(0.05)
        raise AssertionError(f"timed out waiting for {what}")

    async def scenario():
        server = InferenceServer(
            tcfg, tp, "127.0.0.1", 0, MAX_LEN, device="cpu",
            prefix_cache_entries=2, role="prefill")
        await server.run()
        member = FleetMember(server, new_backend(f"file:{root}"),
                             "inference", ttl=5, heartbeat_interval=0.05,
                             instance_id="torch-1")
        await member.start()
        out = {}
        try:
            await until(lambda: ref_backend.instances("inference"),
                        "registration")
            inst = ref_backend.instances("inference")[0]
            out["instance"] = (inst.id, inst.address, inst.port)
            out["port"] = server.port
            server.prefix_cache.store(tuple(range(1, 21)), {"pos": 0})
            await until(lambda: "pd=" in ref_backend.instances(
                "inference")[0].notes and ref_notes.parse_field(
                    "pd", ref_notes.split_note(ref_backend.instances(
                        "inference")[0].notes)["pd"])[1], "digest beat")
            out["fields"] = ref_notes.split_note(
                ref_backend.instances("inference")[0].notes)
            out["drained"] = await member.drain(timeout=5.0)
            out["after_drain"] = ref_backend.instances("inference")
            out["health_draining"] = server.draining
            # the control plane's maintenance verbs over the bus
            member.resume()
            bus = EventBus()
            member.attach_bus(bus)
            await until(lambda: ref_backend.instances("inference"),
                        "re-registration after resume")
            bus.publish(GLOBAL_ENTER_MAINTENANCE)
            await until(lambda: not ref_backend.instances("inference"),
                        "bus-driven drain")
            bus.publish(GLOBAL_EXIT_MAINTENANCE)
            await until(lambda: ref_backend.instances("inference"),
                        "bus-driven resume")
            bus.shutdown()
            await asyncio.wait_for(bus.wait(), 5)
        finally:
            await member.stop()
            await server.stop()
        out["after_stop"] = ref_backend.instances("inference")
        return out

    out = run(scenario(), timeout=60)
    assert out["instance"] == ("torch-1", "127.0.0.1", out["port"])
    fields = out["fields"]
    assert ref_notes.parse_field("role", fields["role"]) == "prefill"
    assert ref_notes.parse_field("occ", fields["occ"]) == 0.0
    assert ref_notes.parse_field("kv", fields["kv"])["hits"] == 0
    assert "gp" in fields and "mg" not in fields
    assert out["drained"] is True and out["after_drain"] == []
    assert out["health_draining"] is True
    assert out["after_stop"] == []


def test_service_definition_fifo_and_noop_backend():
    backend = NoopBackend()
    svc = ServiceDefinition(
        ServiceRegistration(id="r1", name="inference", port=9, ttl=5),
        backend)
    svc.send_heartbeat("ok occ=0.10").result(timeout=5)
    assert backend.registered["r1"].port == 9
    assert backend.ttl_updates == ["service:r1"]
    assert svc.deregister().result(timeout=5) is None
    assert backend.registered == {} and svc.was_registered is False
    assert [i.id for i in backend.instances("inference")] == []
    backend.val = True
    assert backend.check_for_upstream_changes("x") == (True, True)
    assert backend.check_for_upstream_changes("x") == (False, True)


def test_backend_factory():
    assert isinstance(new_backend("none"), NoopBackend)
    assert new_backend(None) is None
    consul = new_backend("https://agent:8501")
    assert isinstance(consul, ConsulBackend)
    assert (consul.scheme, consul.address) == ("https", "agent:8501")
    with pytest.raises(ValueError):
        new_backend(3)


def test_file_catalog_records_are_the_references(tmp_path):
    """Each package's backend reads the other's records: registration,
    TTL note, expiry and deregistration."""
    port_backend = FileCatalogBackend(str(tmp_path))
    ref_backend = RefFileCatalog(str(tmp_path))
    reg = ServiceRegistration(id="t1", name="inference", port=7,
                              ttl=30, address="10.0.0.1")
    port_backend.service_register(reg, "passing")
    port_backend.update_ttl("service:t1", "ok occ=0.25", "pass")
    inst = ref_backend.instances("inference")
    assert [(i.id, i.address, i.port, i.notes) for i in inst] == [
        ("t1", "10.0.0.1", 7, "ok occ=0.25")]
    assert port_backend.check_for_upstream_changes("inference") == (
        True, True)
    port_backend.service_deregister("t1")
    assert ref_backend.instances("inference") == []


# -- the Consul wire, held against the reference -------------------------


class _Recorder(http.server.BaseHTTPRequestHandler):
    requests = []

    def _handle(self):
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length) if length else b""
        type(self).requests.append(
            (self.command, self.path, json.loads(body) if body else None))
        payload = b"null"
        if self.path.startswith("/v1/health/service/"):
            payload = json.dumps([{
                "Service": {"ID": "r1", "Service": "inference",
                            "Address": "10.0.0.2", "Port": 80},
                "Node": {"Address": "10.0.0.9"}}]).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    do_GET = do_PUT = _handle

    def log_message(self, *args):
        pass


def test_consul_backend_sends_the_references_requests():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    server = http.server.ThreadingHTTPServer(("127.0.0.1", port), _Recorder)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        seen = []
        for cls in (RefConsul, ConsulBackend):
            _Recorder.requests = []
            backend = cls(address=f"127.0.0.1:{port}", token="tok")
            backend.service_register(ServiceRegistration(
                id="r/1", name="inference", port=80, ttl=10,
                tags=["a"], address="10.0.0.2"), "passing")
            backend.update_ttl("service:r/1", "ok occ=0.5", "pass")
            inst = backend.instances("inference", tag="a")
            backend.service_deregister("r/1")
            seen.append((list(_Recorder.requests),
                         [(i.id, i.address, i.port) for i in inst]))
        assert seen[1] == seen[0]
        assert seen[1][1] == [("r1", "10.0.0.2", 80)]
    finally:
        server.shutdown()
        thread.join(timeout=5)


# -- the event bus: cases mirrored from tests/test_events.py -------------


class CollectingActor(EventHandler):
    """Records every event, quits on QUIT/SHUTDOWN."""

    def __init__(self, name="actor"):
        super().__init__()
        self.name = name
        self.seen = []

    async def run(self):
        while True:
            ev = await self.next_event()
            self.seen.append(ev)
            if ev.code in (EventCode.QUIT, EventCode.SHUTDOWN):
                break
        self.unsubscribe()
        self.unregister()


def test_event_codes_and_aliases():
    assert Event(EventCode.STARTUP, "global") == GLOBAL_STARTUP
    assert code_from_string("exitSuccess") is EventCode.EXIT_SUCCESS
    assert code_from_string("EXIT_SUCCESS") is EventCode.EXIT_SUCCESS
    assert code_from_string("healthy") is EventCode.STATUS_HEALTHY
    assert code_from_string("changed") is EventCode.STATUS_CHANGED
    with pytest.raises(ValueError):
        code_from_string("nope")


def test_bus_fanout_wait_and_reload_flag(run):
    async def scenario():
        bus = EventBus()
        a, b = CollectingActor("a"), CollectingActor("b")
        for actor in (a, b):
            actor.subscribe(bus)
            actor.register(bus)
        ta = asyncio.ensure_future(a.run())
        tb = asyncio.ensure_future(b.run())
        bus.publish(GLOBAL_STARTUP)
        bus.publish(Event(EventCode.EXIT_SUCCESS, "job1"))
        bus.set_reload_flag()
        bus.shutdown()
        reload = await bus.wait()
        await asyncio.gather(ta, tb)
        return bus, a, b, reload

    bus, a, b, reload = run(scenario())
    expected = [GLOBAL_STARTUP, Event(EventCode.EXIT_SUCCESS, "job1"),
                GLOBAL_SHUTDOWN]
    assert a.seen == b.seen == bus.debug_events() == expected
    assert reload is True


def test_quit_by_test_and_bounded_ring(run):
    async def scenario():
        bus = EventBus()
        a = CollectingActor("a")
        a.subscribe(bus)
        a.register(bus)
        t = asyncio.ensure_future(a.run())
        bus.publish(QUIT_BY_TEST)
        reload = await bus.wait()
        await t
        for i in range(25):
            bus.publish(Event(EventCode.METRIC, f"m{i}"))
        return a.seen, reload, bus.debug_events()

    seen, reload, ring = run(scenario())
    assert seen == [QUIT_BY_TEST] and reload is False
    assert len(ring) == DEBUG_RING_SIZE
    assert ring[-1] == Event(EventCode.METRIC, "m24")


def test_timers_fire_and_cancel(run):
    async def scenario():
        bus = EventBus()
        event_timeout(bus, 0.02, "job.wait")
        t = event_timer(bus, 0.02, "job.tick")
        await asyncio.sleep(0.09)
        cancel_timer(t)
        at_cancel = len(bus.debug_events())
        await asyncio.sleep(0.05)
        return bus.debug_events(), at_cancel

    ring, at_cancel = run(scenario())
    assert Event(EventCode.TIMER_EXPIRED, "job.wait") in ring
    assert ring.count(Event(EventCode.TIMER_EXPIRED, "job.tick")) >= 2
    assert len(ring) == at_cancel  # no ticks after cancellation


def test_mailbox_overflow_drops_and_counts(run):
    async def scenario():
        bus = EventBus()
        actor = CollectingActor()
        actor.subscribe(bus)
        for _ in range(1100):
            bus.publish(Event(EventCode.METRIC, "x"))
        return actor.rx.qsize(), actor.dropped

    assert run(scenario()) == (1000, 100)


def test_publish_from_foreign_thread_and_from_receive(run):
    async def scenario():
        bus = EventBus()
        actor = CollectingActor()
        actor.subscribe(bus)
        bus.register(actor)  # remembers the home loop
        t = threading.Thread(target=bus.publish,
                             args=(Event(EventCode.METRIC, "offloop"),))
        t.start()
        t.join()
        for _ in range(50):
            if actor.rx.qsize():
                break
            await asyncio.sleep(0.01)
        first = actor.rx.get_nowait()

        class Reactor(CollectingActor):
            def receive(self, event):
                super().receive(event)
                if event.code is EventCode.STARTUP:
                    CollectingActor("late").subscribe(bus)
                    bus.publish(Event(EventCode.STATUS_CHANGED, "react"))

        Reactor("reactor").subscribe(bus)
        bus.publish(GLOBAL_STARTUP)
        return first, [e.code for e in bus.debug_events()]

    first, codes = run(scenario())
    assert first == Event(EventCode.METRIC, "offloop")
    assert codes[-2:] == [EventCode.STARTUP, EventCode.STATUS_CHANGED]


def test_spawn_keeps_a_reference_and_logs_deaths(run, caplog):
    async def scenario():
        async def boom():
            raise RuntimeError("bang")

        task = tasks.spawn(boom(), name="boom")
        during = tasks.pending_count()
        await asyncio.sleep(0)
        await asyncio.sleep(0)
        return task, during

    with caplog.at_level("ERROR", logger="containerpilot.tasks"):
        task, during = run(scenario())
    assert during >= 1 and task.done()
    assert any("bang" in r.getMessage() for r in caplog.records)


def test_spill_tier_budget_matches_the_references():
    """A spilled entry costs the same bytes in both packages' tiers (a
    JAX entry's 0-d int32 pos against the port's int)."""
    ref = RefSpill(1 << 20)
    ref.put((1,), {"k": jnp.zeros((4, 8), jnp.float32),
                   "pos": jnp.int32(3)})
    port = HostSpillTier(1 << 20, device="cpu")
    port.put((1,), {"k": torch.zeros(4, 8), "pos": 3})
    assert port.bytes_used == ref.bytes_used == 4 * 8 * 4 + 4


# -- the serve CLI in a fleet ---------------------------------------------


def test_serve_cli_prefill_replica_and_standby_join_a_catalog(tmp_path):
    """Two serve CLIs on the CPU: a prefill replica, and a standby that
    fetches its weights from it (--weights-from). Both register with
    their roles; the standby serves the replica's tokens once promoted
    and its role leaves the note; SIGTERM drains both out of the
    catalog."""
    import os
    import signal
    import subprocess
    import sys
    import time
    import urllib.request

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    catalog = str(tmp_path / "catalog")
    ref_backend = RefFileCatalog(catalog)
    model = ["--device", "cpu", "--host", "127.0.0.1", "--port", "0",
             "--vocab", "64", "--d-model", "32", "--n-layers", "1",
             "--n-heads", "2", "--max-len", "64", "--slots", "2",
             "--slot-chunk", "4", "--prefix-cache", "2", "--kv-spill-mb",
             "1", "--fleet-catalog", f"file:{catalog}", "--fleet-ttl", "2"]

    def launch(*extra):
        return subprocess.Popen(
            [sys.executable, "-m", "containerpilot_tpu_torch.workload.serve",
             *model, *extra], cwd=root,
            env={**os.environ, "PYTHONPATH": root},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def fields(instance_id, deadline=60.0):
        end = time.monotonic() + deadline
        while time.monotonic() < end:
            for inst in ref_backend.instances("inference"):
                if inst.id == instance_id:
                    return inst, ref_notes.split_note(inst.notes)
            time.sleep(0.1)
        raise AssertionError(f"{instance_id} never registered")

    def post(port, path, body):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read().decode())

    procs = [launch("--fleet-id", "pf-1", "--role", "prefill")]
    try:
        inst_a, fa = fields("pf-1")
        assert ref_notes.parse_field("role", fa["role"]) == "prefill"
        procs.append(launch("--fleet-id", "sb-1", "--standby",
                            "--weights-from", f"127.0.0.1:{inst_a.port}"))
        inst_c, fc = fields("sb-1")
        assert ref_notes.parse_field("role", fc["role"]) == "standby"
        assert post(inst_c.port, "/v3/standby/promote", {})["promoted"]
        body = {"tokens": [list(range(1, 21))], "max_new_tokens": 6}
        assert post(inst_c.port, "/v1/generate", body) == post(
            inst_a.port, "/v1/generate", body)
        end = time.monotonic() + 10
        while "role" in fields("sb-1")[1]:
            assert time.monotonic() < end, "promotion never reached a beat"
            time.sleep(0.1)
    finally:
        logs = []
        for proc in procs:
            proc.send_signal(signal.SIGTERM)
        for proc in procs:
            logs.append(proc.communicate(timeout=60)[0])
    assert [p.returncode for p in procs] == [0, 0], logs
    assert "weights fetched from peer" in logs[1]
    assert ref_backend.instances("inference") == []


def test_kernel_build_dir_note_and_same_host_adoption(tmp_path, monkeypatch):
    """The cc= field of the port names its kernel build directory (a
    digest of the built libraries' names); a launch adopts a same-host
    peer's existing directory, never a remote one's."""
    from containerpilot_tpu_torch.discovery import ServiceInstance
    from containerpilot_tpu_torch.workload.modelcfg import (
        adopt_fleet_compile_cache,
        compile_cache_note,
    )

    build = tmp_path / "kernels"
    build.mkdir()
    assert compile_cache_note(str(build)) == ""  # nothing built yet
    assert compile_cache_note(str(tmp_path / "missing")) == ""
    (build / "flash_fwd-0123abcd.so").write_bytes(b"")
    note = compile_cache_note(str(build))
    digest, path = ref_notes.parse_field("cc", note)
    assert path == str(build) and len(digest) == 8
    (build / "int8_matmul-89ab.so").write_bytes(b"")
    assert ref_notes.parse_field("cc", compile_cache_note(str(build)))[0] \
        != digest

    class _Catalog:
        def __init__(self, *instances):
            self.list = list(instances)

        def instances(self, _service):
            return self.list

    def peer(address, note):
        return ServiceInstance("p", "inference", address, 1, notes=note)

    # recorded, then removed: the adoption's write is undone afterwards
    monkeypatch.setenv("CONTAINERPILOT_TORCH_BUILD_DIR", "")
    monkeypatch.delenv("CONTAINERPILOT_TORCH_BUILD_DIR")
    cc = f"ok cc={compile_cache_note(str(build))}"
    assert adopt_fleet_compile_cache(
        _Catalog(peer("203.0.113.9", cc)), "inference") is None
    assert adopt_fleet_compile_cache(
        _Catalog(peer("127.0.0.1", "ok cc=beef:%2Fno%2Fsuch")),
        "inference") is None
    assert adopt_fleet_compile_cache(
        _Catalog(peer("127.0.0.1", cc)), "inference") == str(build)
    from containerpilot_tpu_torch.ops import _build

    assert _build.build_dir() == str(build)


@pytest.mark.parametrize("mux", [True, False], ids=["mux", "no_mux"])
def test_fetch_params_resumes_on_a_fresh_dial_or_falls_back(run, mux):
    """``standby.fetch_params`` dials its own cp-mux/1 connection per
    attempt: a weight stream its peer CANCELs after the first chunk resumes at
    ``?chunk=1`` on a second connection and rebuilds bit-equal params; a
    peer that declines the upgrade yields None (the caller's local
    load) without a second dial."""
    import torch

    from containerpilot_tpu_torch.fleet import standby
    from containerpilot_tpu_torch.utils.http import (
        HTTPServer, StreamingResponse,
    )

    gen = torch.Generator().manual_seed(0)
    params = {"b": torch.randn(3, 512, generator=gen),
              "a": {"w": torch.randn(700, generator=gen)}}
    manifest = standby.weights_manifest(params, chunk_bytes=2048)
    head = standby.encode_manifest(manifest)
    flat = [standby.leaf_bytes(leaf)
            for _name, leaf in standby.param_leaves(params)]
    pieces = [flat[c["leaf"]][c["offset"]:c["offset"] + c["len"]]
              for c in manifest["chunks"]]
    asked = []

    async def scenario():
        server = HTTPServer()
        server.mux_enabled = mux

        async def weights(req):
            start = int(req.query.get("chunk", ["0"])[0])
            asked.append(start)

            async def body():
                yield head
                for index, piece in enumerate(pieces[start:], start):
                    if len(asked) == 1 and index == 1:
                        raise RuntimeError("peer died mid-stream")
                    yield piece

            return StreamingResponse(
                body(), content_type="application/octet-stream")

        server.route("GET", standby.WEIGHTS_PATH, weights)
        await server.start_tcp("127.0.0.1", 0)
        try:
            like = {"b": torch.zeros(3, 512), "a": {"w": torch.zeros(700)}}
            return await standby.fetch_params(
                "127.0.0.1", server.bound_port, like, read_timeout=10.0)
        finally:
            await server.stop()

    got = run(scenario())
    assert len(pieces) > 2
    if mux:
        assert asked == [0, 1]
        for (name, want), (_n, have) in zip(
                standby.param_leaves(params), standby.param_leaves(got)):
            assert torch.equal(want, have), name
    else:
        assert got is None and asked == []

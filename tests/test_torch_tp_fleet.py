"""The fleet's wires and roles through a server over ranks, against the
JAX package, on the CPU: a tp2 pod's KV entries and weights cross the
wire whole, in the one-rank format, both ways; the serve CLI's ``--tp 2
--standby --weights-from`` fetches once and promotes; a drain migrates a
session out of the pod to a JAX survivor; ``--tp 2 --cp 2`` answers
beams and ``/v1/weights`` as one rank and keeps the reference's
refusals.

Two settings, as in ``tests/test_torch_handoff.py`` (the one-rank
mirror), each with a JAX replica and a one-rank torch replica on one
event loop in a thread, params from ``jax.random.PRNGKey(0)``:

- float32, the pod an ``InferenceServer`` over a gloo world of 2
  ``python -m torch_serve_jobs`` children (its params cut by
  ``bridge.shard_from_jax``): ``/v1/prefill`` + ``/v1/kv`` out of the
  pod, pulls both ways, ``/v1/weights`` out of the pod;
- bf16 (the serve CLI's dtype), the pod the serve CLI as a subprocess
  that spawns its follower, in one file catalog with both replicas (the
  torch one ``--role prefill``, which a drain skips); the ``--tp 2 --cp
  2`` CLI fetches the JAX replica's params the same way.

The reference's mux client drops the upgraded connection's
``StreamWriter`` (ROADMAP.md queue 3); the fixtures hold it, as
``tests/test_torch_handoff.py`` does.
"""
import asyncio
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from containerpilot_tpu.discovery import FileCatalogBackend as RefCatalog
from containerpilot_tpu.fleet import FleetMember as RefMember
from containerpilot_tpu.fleet import pool as ref_pool
from containerpilot_tpu.fleet import standby as ref_standby
from containerpilot_tpu.kvtier import handoff as ref_handoff
from containerpilot_tpu.models import beam as jbeam
from containerpilot_tpu.models import decode as jdecode
from containerpilot_tpu.models import transformer as jtf
from containerpilot_tpu.workload.serve import InferenceServer as JaxServer
from containerpilot_tpu_torch import bridge
from containerpilot_tpu_torch.discovery import FileCatalogBackend
from containerpilot_tpu_torch.fleet import FleetMember
from containerpilot_tpu_torch.models import transformer as ttf
from containerpilot_tpu_torch.workload.serve import InferenceServer
from torch_serve_jobs import ROOT, finish_world, flat, results, start_world

WORLD = 2
MAX_LEN = 64
MAX_NEW = 8
SERVE = dict(slots=2, slot_chunk=4, prefix_cache_entries=2,
             kv_spill_bytes=1 << 20)
FP32 = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=1, d_ff=64,
            max_seq_len=MAX_LEN, dtype="float32")
# the serve CLI's model for CLI_MODEL: d_ff as the CLI derives it, bf16
CLI_MODEL = ["--device", "cpu", "--d-model", "32", "--n-layers", "2",
             "--n-heads", "2", "--vocab", "64", "--max-len", str(MAX_LEN)]
CLI_SERVE = ["--slots", "2", "--slot-chunk", "4", "--prefix-cache", "2",
             "--kv-spill-mb", "1"]
BF16 = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=128,
            max_seq_len=MAX_LEN)


def _row(seed, n=32):
    return [int(t) for t in
            np.random.default_rng(seed).integers(1, 64, size=n)]


def _http(port, method, path, payload=None, timeout=120):
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data, method=method,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read(), dict(exc.headers)


def _generate(port, row, new=MAX_NEW):
    status, data, _ = _http(port, "POST", "/v1/generate",
                            {"tokens": [row], "max_new_tokens": new})
    assert status == 200, data
    return json.loads(data)["tokens"][0]


def _model(port):
    return json.loads(_http(port, "GET", "/v1/model")[1])


def _split_stream(raw: bytes):
    """(manifest, chunks) of a manifest-framed stream's bytes."""
    n = int.from_bytes(raw[:8], "big")
    manifest = json.loads(raw[8:8 + n])
    chunks, at = [], 8 + n
    for spec in manifest["chunks"]:
        chunks.append(raw[at:at + spec["len"]])
        at += spec["len"]
    assert at == len(raw)
    return manifest, chunks


class _Replicas:
    """A JAX replica and a one-rank torch replica of the same params,
    on one event loop in a thread."""

    def __init__(self, jcfg, jp, tcfg, torch_kw=None):
        self.jcfg, self.jp = jcfg, jp
        self.tp = bridge.params_from_jax(
            jax.tree_util.tree_map(np.asarray, jp), "cpu")
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()
        self.servers, self.members = [], []
        self.jax = self.call(self.start(JaxServer(
            jcfg, jp, "127.0.0.1", 0, max_len=MAX_LEN, **SERVE)))
        self.torch = self.call(self.start(InferenceServer(
            tcfg, self.tp, "127.0.0.1", 0, MAX_LEN, device="cpu",
            **SERVE, **(torch_kw or {}))))

    async def start(self, server):
        await server.run()
        self.servers.append(server)
        return server

    def call(self, coro, timeout=120):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout)

    def join(self, root):
        """Register both in the file catalog ``root``: the JAX replica
        as ``jax-1``, the torch one as ``torch-1``."""
        async def go():
            for member in (
                    RefMember(self.jax, RefCatalog(root), "inference",
                              ttl=5, heartbeat_interval=0.05,
                              instance_id="jax-1"),
                    FleetMember(self.torch, FileCatalogBackend(root),
                                "inference", ttl=5,
                                heartbeat_interval=0.05,
                                instance_id="torch-1")):
                await member.start()
                self.members.append(member)

        self.call(go())

    def greedy(self, row, new=MAX_NEW):
        return np.asarray(jdecode.generate(
            self.jp, jnp.asarray([row], jnp.int32), self.jcfg,
            max_new_tokens=new, max_len=MAX_LEN))[0].tolist()

    def close(self):
        async def stop_all():
            for member in self.members:
                await member.stop()
            for server in reversed(self.servers):
                await server.stop()

        self.call(stop_all())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=10)


@pytest.fixture(scope="module")
def keep_writer():
    mp = pytest.MonkeyPatch()
    adopt = ref_pool.MuxConnection.adopt

    def adopt_and_keep(self, reader, writer):
        self._kept_writer = writer
        return adopt(self, reader, writer)

    mp.setattr(ref_pool.MuxConnection, "adopt", adopt_and_keep)
    yield
    mp.undo()


# -- float32: the in-library pod against both replicas ---------------------

ROW_OUT = _row(11)   # prefilled on the pod, pulled out of it
ROW_IN = _row(12)    # prefilled on the JAX replica, pulled into the pod


@pytest.fixture(scope="module")
def wire(tmp_path_factory, keep_writer):
    """The pod's answers while both replicas run, then the replicas."""
    tmp = tmp_path_factory.mktemp("tp_fleet")
    jcfg = jtf.TransformerConfig(**{**FP32, "dtype": jnp.float32})
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    np.savez(tmp / "params.npz",
             **flat(jax.tree_util.tree_map(np.asarray, jp)))
    reps = _Replicas(jcfg, jp,
                     ttf.TransformerConfig(**bridge.config_kwargs(FP32)))
    try:
        status, data, _ = _http(reps.jax.port, "POST", "/v1/prefill",
                                {"tokens": [ROW_IN]})
        assert status == 200 and json.loads(data)["cached"], data
        jax_entry = _http(reps.jax.port, "POST", "/v1/kv",
                          {"tokens": [ROW_IN]})[1]
        pull_out = {"tokens": [ROW_OUT], "from": "127.0.0.1:{self}"}
        requests = [
            {"method": "POST", "path": "/v1/prefill",
             "body": {"tokens": [ROW_OUT]}},
            {"method": "POST", "path": "/v1/kv", "raw": True,
             "body": {"tokens": [ROW_OUT]}},
            {"method": "POST", "path": "/v1/kv/pull", "body": pull_out,
             "port": reps.jax.port},
            {"method": "POST", "path": "/v1/kv/pull", "body": pull_out,
             "port": reps.torch.port},
            {"method": "POST", "path": "/v1/kv/pull", "body": {
                "tokens": [ROW_IN], "from": f"127.0.0.1:{reps.jax.port}"}},
            {"tokens": [ROW_IN], "max_new_tokens": MAX_NEW},
            {"method": "GET", "path": "/v1/weights", "raw": True},
            {"method": "POST", "path": "/v1/kv", "body": {
                "tokens": [[1, 2, 3]]}},
        ]
        procs, out = start_world(tmp, [{
            "name": "kv", "kind": "server", "config": FP32,
            "plan": dict(data=1, model=2), "params": str(tmp / "params.npz"),
            "server": {"max_len": MAX_LEN, **SERVE},
            "requests": requests}], WORLD)
        finish_world(procs)
        yield results(out, "kv", WORLD), reps, jax_entry
    finally:
        reps.close()


def test_pod_kv_entry_has_the_one_rank_manifest(wire):
    """The pod's /v1/kv entry (every rank's kv heads gathered over
    ``model``) is the one-rank entry: skeleton, leaf dtypes and shapes
    and bytes equal to the JAX replica's for a prompt of the same
    length; its k/v within 1e-5 of max|ref| of the reference's prefill
    of the same prompt (float32), pos the prompt's length."""
    ranks, reps, jax_entry = wire
    answers = ranks[0]["answers"]
    assert answers[0] == [200, {"ok": True, "cached": True,
                                "tokens_prefilled": len(ROW_OUT)}]
    status, hexed = answers[1]
    assert status == 200
    manifest, chunks = _split_stream(bytes.fromhex(hexed))
    ref_manifest, _ = _split_stream(jax_entry)
    for key in ("skeleton", "total_bytes", "version"):
        assert manifest[key] == ref_manifest[key]
    assert [(x["dtype"], x["shape"]) for x in manifest["leaves"]] == [
        (x["dtype"], x["shape"]) for x in ref_manifest["leaves"]]
    entry = ref_handoff.rebuild_kv(manifest, chunks)
    _logits, ref = jdecode.prefill(
        reps.jp, jnp.asarray([ROW_OUT], jnp.int32), reps.jcfg, MAX_LEN)
    assert int(entry["pos"]) == len(ROW_OUT)
    for name in ("k", "v"):
        want = np.asarray(ref[name])
        scale = float(np.abs(want).max())
        # float32 on both sides: summation order only
        assert np.abs(np.asarray(entry[name]) - want).max() <= 1e-5 * scale
    assert answers[7][0] == 404  # never cached: every rank agrees


def test_pod_entry_pulled_both_ways_decodes_the_jax_tokens(wire):
    """The JAX replica and the one-rank torch replica each pull the
    pod's entry and decode the reference's greedy tokens from it
    (readmitted once); the pod pulls the JAX replica's entry into its
    ranks' spill tiers (each its part), readmits it once and decodes the
    same tokens; every rank's prefix-cache keys agree."""
    ranks, reps, _entry = wire
    answers = ranks[0]["answers"]
    total = 2 * MAX_LEN * 2 * 16 * 4 + 4  # float32 k, v and the int32 pos
    for status, got in answers[2:5]:
        assert status == 200 and got["ok"] and got["bytes"] == total
    for port in (reps.jax.port, reps.torch.port):
        before = _model(port)["prefix_cache"]["readmitted"]
        assert _generate(port, ROW_OUT) == reps.greedy(ROW_OUT)
        assert _model(port)["prefix_cache"]["readmitted"] == before + 1
    assert answers[5] == [200, {"tokens": [reps.greedy(ROW_IN)]}]
    info = ranks[0]["info"]
    assert info["prefix_cache"]["readmitted"] == 1
    assert info["prefix_cache"]["hits"] == 1
    lockstep = info["lockstep"]
    assert lockstep["agree"]
    assert len({r["prefix"] for r in lockstep["ranks"]}) == 1


def test_pod_weights_rebuild_bit_equal_in_the_jax_replica(wire):
    """/v1/weights of the pod (each leaf gathered along its rule) is the
    whole params' stream: the reference's rebuild_params reads it into
    bit-equal params, and its manifest is the JAX replica's."""
    ranks, reps, _entry = wire
    status, hexed = ranks[0]["answers"][6]
    assert status == 200
    manifest, chunks = _split_stream(bytes.fromhex(hexed))
    assert manifest == ref_standby.weights_manifest(reps.jp)
    back = ref_standby.rebuild_params(manifest, chunks, reps.jp)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(reps.jp)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# -- bf16: the serve CLI's pod in a file catalog ---------------------------


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _start_cli(args, port):
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": ROOT}
    return subprocess.Popen(
        [sys.executable, "-m", "containerpilot_tpu_torch.workload.serve",
         *CLI_MODEL, "--host", "127.0.0.1", "--port", str(port), *args],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def _wait_warm(proc, port, standby=False, timeout=120):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise AssertionError(proc.communicate()[0][-3000:])
        try:
            status, body, _ = _http(port, "GET", "/health", timeout=2)
            if status == 200 or (standby and status == 503
                                 and body.startswith(b"standby")):
                return
        except OSError:
            pass
        time.sleep(0.2)
    raise AssertionError("serve CLI never warmed")


def _stop(proc):
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
    try:
        log = proc.communicate(timeout=90)[0]
    except subprocess.TimeoutExpired:
        proc.kill()
        log = proc.communicate()[0]
    return proc.returncode, log


ROW_CLI = _row(21, 24)
ROW_DRAIN = _row(22, 24)


@pytest.fixture(scope="module")
def cli_fleet(tmp_path_factory, keep_writer):
    """The CLI pod's drill, recorded: standby, the weight fetch from the
    JAX replica, promotion, answers, /v1/weights, then a SIGTERM drain
    polled for its migration-aware refusal."""
    root = str(tmp_path_factory.mktemp("tp_cli_fleet") / "catalog")
    jcfg = jtf.TransformerConfig(**{**BF16, "dtype": jnp.bfloat16})
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    reps = _Replicas(jcfg, jp,
                     ttf.TransformerConfig(**bridge.config_kwargs(
                         {**BF16, "dtype": "bfloat16"})),
                     torch_kw={"role": "prefill"})
    rec = {"reps": reps}
    try:
        reps.join(root)
        port = _free_port()
        proc = _start_cli([
            "--tp", "2", *CLI_SERVE, "--standby", "--weights-from",
            f"127.0.0.1:{reps.jax.port}", "--fleet-catalog",
            f"file:{root}", "--fleet-id", "tp2", "--fleet-ttl", "5",
            "--migrate-window", "30"], port)
        try:
            _wait_warm(proc, port, standby=True)
            rec["standby_health"] = _http(port, "GET", "/health")[:2]
            rec["standby_generate"] = _http(port, "POST", "/v1/generate", {
                "tokens": [ROW_CLI], "max_new_tokens": 4})[0]
            rec["promote"] = _http(port, "POST", "/v3/standby/promote")[:2]
            rec["health"] = _http(port, "GET", "/health")[0]
            rec["pod_tokens"] = _generate(port, ROW_CLI)
            rec["jax_tokens"] = _generate(reps.jax.port, ROW_CLI)
            rec["weights"] = reps.call(ref_standby.fetch_params(
                "127.0.0.1", port, jp))
            rec["drain_tokens"] = _generate(port, ROW_DRAIN)  # cached
            rec["jax_readmitted"] = _model(reps.jax.port)[
                "prefix_cache"]["readmitted"]
            proc.send_signal(signal.SIGTERM)
            refusal, t0 = None, time.monotonic()
            while proc.poll() is None and refusal is None:
                try:
                    status, _body, headers = _http(
                        port, "POST", "/v1/generate",
                        {"tokens": [ROW_DRAIN], "max_new_tokens": 4}, 30)
                except OSError:
                    break
                headers = {k.lower(): v for k, v in headers.items()}
                if status == 503 and "x-cp-migrated-to" in headers:
                    refusal = headers
                assert time.monotonic() - t0 < 90, "the drain never ended"
                time.sleep(0.02)
            rec["refusal"] = refusal
        finally:
            rec["rc"], rec["log"] = _stop(proc)
        yield rec
    finally:
        reps.close()


def test_cli_standby_fetches_weights_once_and_promotes(cli_fleet):
    """``serve --tp 2 --standby --weights-from <JAX replica>``: the front
    alone fetches the whole params and hands the follower its blocks;
    the pod answers /health and generate 503 until promoted, then
    answers as the JAX replica does; its /v1/weights rebuilds bit-equal
    params in the JAX replica."""
    rec = cli_fleet
    assert rec["standby_health"][0] == 503
    assert rec["standby_health"][1].startswith(b"standby")
    assert rec["standby_generate"] == 503
    assert rec["promote"][0] == 200 and json.loads(rec["promote"][1])[
        "promoted"]
    assert rec["health"] == 200
    assert rec["pod_tokens"] == rec["jax_tokens"]
    assert rec["log"].count("weights fetched from peer") == 1
    back = rec["weights"]
    assert back is not None
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(rec["reps"].jp)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_cli_pod_drain_migrates_a_session_to_the_jax_survivor(cli_fleet):
    """SIGTERM drains the pod: its cached sessions (both prompts it
    served) migrate to the JAX survivor (the one-rank torch replica is
    the prefill pool, which a drain skips), a refused request names the
    survivor in ``X-CP-Migrated-To``, and the survivor readmits the
    entry and decodes the pod's tokens (byte parity); the pod exits
    0."""
    rec = cli_fleet
    reps = rec["reps"]
    assert rec["refusal"] is not None, rec["log"][-3000:]
    assert rec["refusal"]["x-cp-migrated-to"] == "jax-1"
    assert rec["rc"] == 0, rec["log"][-3000:]
    assert "migration moved 2/2 entries" in rec["log"]
    assert ", 0 failed, 0 timed out" in rec["log"]
    assert _generate(reps.jax.port, ROW_DRAIN) == rec["drain_tokens"]
    assert _model(reps.jax.port)["prefix_cache"]["readmitted"] == (
        rec["jax_readmitted"] + 1)


def test_cli_tp2_cp2_beams_and_weights_answer_as_one_rank(cli_fleet):
    """``--tp 2 --cp 2`` (4 ranks) on the JAX replica's params (from
    ``jax.random.PRNGKey(0)``, fetched with ``--weights-from``): a beam
    request (on the model axis, seq ranks repeating it) answers the
    reference's ``beam_search`` on those params, as the JAX replica
    itself does, and /v1/weights (gathered over ``model`` only) is the
    JAX tree's manifest and rebuilds bit-equal params in the
    reference."""
    reps = cli_fleet["reps"]
    row = [1, 2, 3, 4, 5]
    beam = {"tokens": [row], "max_new_tokens": 6, "beam_width": 3}
    want, _score = jbeam.beam_search(
        reps.jp, jnp.asarray([row], jnp.int32), reps.jcfg, 6, MAX_LEN,
        beam_width=3)
    status, data, _ = _http(reps.jax.port, "POST", "/v1/generate", beam)
    assert status == 200 and json.loads(data) == {
        "tokens": [np.asarray(want).tolist()]}
    port = _free_port()
    proc = _start_cli(["--tp", "2", "--cp", "2", "--weights-from",
                       f"127.0.0.1:{reps.jax.port}"], port)
    try:
        _wait_warm(proc, port)
        status, data, _ = _http(port, "POST", "/v1/generate", beam)
        weights = _http(port, "GET", "/v1/weights")
        info = _model(port)
    finally:
        rc, log = _stop(proc)
    assert rc == 0, log[-3000:]
    assert log.count("weights fetched from peer") == 1
    assert info["mesh"] == {"data": 1, "seq": 2, "model": 2}
    assert info["lockstep"]["agree"]
    assert status == 200, data
    # bf16 on both sides, the reference's tokens exactly
    assert json.loads(data) == {"tokens": [np.asarray(want).tolist()]}
    assert weights[0] == 200
    manifest, chunks = _split_stream(weights[1])
    assert manifest == ref_standby.weights_manifest(reps.jp)
    back = ref_standby.rebuild_params(manifest, chunks, reps.jp)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(reps.jp)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("flags,message", [
    (["--prefix-cache", "2"], "--cp does not compose with --prefix-cache"),
    (["--draft-layers", "1"], "--cp does not compose with --draft-layers"),
])
def test_cli_cp_keeps_the_references_refusals(flags, message):
    """Under --cp the reference's own refusals stand, with its
    messages, before any rank starts."""
    proc = _start_cli(["--tp", "2", "--cp", "2", *flags], _free_port())
    log = proc.communicate(timeout=60)[0]
    assert proc.returncode != 0
    assert message in log
    assert "serving over" not in log


def test_torch_params_of_the_cli_pod_template_match(cli_fleet):
    """The torch one-rank replica of the CLI setting holds the same
    params the pod fetched (its bf16 config is the CLI's), so each of
    the fleet's replicas answers alike."""
    reps = cli_fleet["reps"]
    assert _generate(reps.torch.port, ROW_CLI) == cli_fleet["jax_tokens"]
    assert all(t.dtype == torch.float32
               for t in jax.tree_util.tree_leaves(reps.tp))


def test_cli_pod_weight_fetch_failure_falls_back_to_its_own_load():
    """A ``--weights-from`` peer that does not answer: the front's one
    fetch fails, every rank falls back to the seeded load (the one-rank
    CLI's fallback), and the pod serves those weights: its greedy tokens
    equal one rank's generate on the seeded params."""
    from containerpilot_tpu_torch.models import decode as tdecode
    from containerpilot_tpu_torch.workload import serve_cli

    port = _free_port()
    args = ["--tp", "2", "--weights-from", f"127.0.0.1:{_free_port()}"]
    proc = _start_cli(args, port)
    try:
        _wait_warm(proc, port)
        got = _generate(port, ROW_CLI)
    finally:
        rc, log = _stop(proc)
    assert rc == 0, log[-3000:]
    assert "falling back to the seeded weights" in log
    cfg, params, _ = serve_cli.load_model(
        serve_cli.build_arg_parser().parse_args(CLI_MODEL))
    want = tdecode.generate(params, torch.tensor([ROW_CLI]), cfg, MAX_NEW,
                            MAX_LEN)
    assert got == want[0].tolist()

"""The port's pod server (``containerpilot_tpu_torch/workload/serve_dist.py``)
against the JAX package, on the CPU: real OS processes rendezvous
through a catalog (a file catalog, or the reference's live catalog
server), hold their blocks of the params on a mesh of ranks (pure tp at
2 processes, a 2x2 dp x tp mesh at 4) and answer HTTP as the reference
pod does. A wedged follower makes every rank exit 86; under the
reference supervisor the pod restarts, re-rendezvouses and serves again.

Params come from ``jax.random.PRNGKey(0)``, carried by ``bridge`` into a
port checkpoint that the pod serves with ``--checkpoint-dir`` (the
reference pod initializes the same params itself). Greedy tokens equal
the reference ``generate`` with the server's key convention and
``_trim`` exactly, and so do seeded sampled tokens (both packages draw
row i of a request from ``fold_in(PRNGKey(seed), i)``); where a pod's
flags have no in-process reference recipe here (the cp ring), sampled
rows equal the port's one-rank ``generate`` with the same keys; the MoE
pod with int8 and LoRA draws what a SlotEngine over the same tp2 layout
draws, and that model on one rank draws the reference's row; beams equal the reference ``beam_search``; ``/v1/score``
equals the reference ``score_logprobs_fn`` at ``SCORE_TOL`` (bf16
models) and the logprobs echo equals the pod's own ``/v1/score``.

Mirrors ``tests/test_serve_dist.py`` :156 (tp2 and dp2xtp2), :507, :546,
:621, :708, :738, :898, :1003, :1140, :1301 and :1401 with the same
flags at the same sizes. The :708 mirror holds the prefix_cache block
to the seven keys the single-host server reports (the reference test's
four-key literal predates the spill tier). Also: the reference pod and
the port pod, two processes each with the same flags on the same
params, answer ``/v1/model`` with the same keys and ``/v1/generate``
with the same tokens; ``serve_dist`` loads no jax.

Rank processes are children of this process, killed in ``finally``;
every wait has its own timeout; no process group is made here.
"""
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from containerpilot_tpu.models import decode as jdecode
from containerpilot_tpu.models import transformer as jtf
from containerpilot_tpu.workload.modelcfg import derive_d_ff
from containerpilot_tpu_torch import bridge
from containerpilot_tpu_torch.models import decode as tdecode
from containerpilot_tpu_torch.models import transformer as ttf
from containerpilot_tpu_torch.models.quantized import cast_params
from containerpilot_tpu_torch.parallel.checkpoint import save_checkpoint
from containerpilot_tpu_torch.parallel.train import TrainState, make_optimizer
from containerpilot_tpu_torch.workload.serve import InferenceServer

from torch_draws import first_difference, teacher_forced_gap
from torch_serve_jobs import finish_world, results, start_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POD = "containerpilot_tpu_torch.workload.serve_dist"

MODEL_FLAGS = [
    "--max-len", "48", "--d-model", "64", "--n-layers", "1",
    "--n-heads", "2", "--vocab", "128",
]
DEFAULT = dict(vocab_size=128, d_model=64, n_heads=2, n_layers=1,
               d_ff=derive_d_ff(64), max_seq_len=48)
# bf16 models: /v1/score against the reference's float32 log-softmax of
# bf16 logits (a bf16 step of logits of magnitude ~8)
SCORE_TOL = 5e-2
BOOT_S = 120  # a pod's start-up, rendezvous to /health 200
REQUEST_S = 120


def _free_port() -> int:
    """A free port below the ephemeral range (32768 and up), so a port
    chosen now is not taken by some process's outgoing or gloo socket
    before the pod binds it."""
    import random

    while True:
        port = random.randrange(20000, 32000)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port


def _sub_env() -> dict:
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)  # one CPU device per reference process
    return env


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_cfg(**over):
    return jtf.TransformerConfig(**{**DEFAULT, **over})


def port_cfg(**over):
    return ttf.TransformerConfig(**{**DEFAULT, **over})


def write_checkpoint(directory, jax_params, step: int) -> None:
    """A port checkpoint (float32 masters, a fresh optimizer state) of
    JAX params, at ``step``."""
    params = bridge.params_from_jax(_np(jax_params), "cpu")
    state = TrainState(params, make_optimizer().init(params), step)
    save_checkpoint(str(directory), step, state)


def port_params(jax_params, cfg):
    """What a pod rank holds of bridged params before cutting: the
    float32 masters cast once to the compute dtype."""
    return cast_params(bridge.params_from_jax(_np(jax_params), "cpu"),
                       cfg.dtype)


def _reference(tokens, max_new, cfg=None, params=None, row=0, **kw):
    """Single-device JAX generate with the server key convention (row i
    draws from fold_in(PRNGKey(seed), i)) and the server's trim."""
    from containerpilot_tpu.workload.serve import (
        InferenceServer as JServer,
    )

    cfg = cfg or jax_cfg()
    if params is None:
        params = jtf.init_params(jax.random.PRNGKey(0), cfg)
    seed = kw.pop("seed", 0)
    eos = kw.pop("eos_id", -1)
    out = jdecode.generate(
        params, jnp.asarray([tokens], jnp.int32), cfg, max_new,
        cfg.max_seq_len,
        rng=jnp.stack([jax.random.fold_in(jax.random.PRNGKey(seed), row)]),
        eos_id=eos, **kw,
    )
    return JServer._trim([[int(t) for t in np.asarray(out)[0]]],
                         max_new, eos)[0]


def _port_reference(tokens, max_new, cfg, params, row=0, **kw):
    """The port's one-rank generate with the server key convention
    (``row_key(seed, row)``), trimmed as the server trims: what a sampled
    pod row equals."""
    seed = kw.pop("seed", 0)
    eos = kw.pop("eos_id", -1)
    out = tdecode.generate(
        params, torch.tensor([tokens]), cfg, max_new, cfg.max_seq_len,
        rng=tdecode.row_key(seed, row)[None], eos_id=eos, **kw,
    )
    return InferenceServer._trim([out[0].tolist()], max_new, eos)[0]


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """(checkpoint dir of the bridged PRNGKey(0) params of MODEL_FLAGS,
    JAX params, port params as a rank holds them before cutting)."""
    ck = tmp_path_factory.mktemp("pod_base") / "ck"
    jp = jtf.init_params(jax.random.PRNGKey(0), jax_cfg())
    write_checkpoint(ck, jp, 1)
    return str(ck), jp, port_params(jp, port_cfg())


class Pod:
    """One pod's processes (``procs``, rank order, output in
    ``<tmp>/<tag><r>.log``) and its frontend on ``port``. ``launch``
    starts a port pod; the HTTP helpers need only ``port``."""

    def __init__(self, tmp=None, port=None, procs=(), tag="pod",
                 logs=()):
        self.tmp, self.port, self.tag = tmp, port, tag
        self.procs, self._logs = list(procs), list(logs)
        self.n = len(self.procs)

    @classmethod
    def launch(cls, tmp, n, flags, catalog=None, tag="pod", env=None,
               rank_flags=None):
        """``n`` serve_dist processes on ``catalog`` (default a fresh
        file catalog)."""
        pod = cls(tmp, _free_port(), tag=tag)
        catalog = catalog or f"file:{tmp}/{tag}-catalog"
        coord = _free_port()
        env = env or _sub_env()
        for r in range(n):
            fh = open(os.path.join(tmp, f"{tag}{r}.log"), "w")
            pod._logs.append(fh)
            pod.procs.append(subprocess.Popen(
                [sys.executable, "-u", "-m", POD, "--device", "cpu",
                 "--process-id", str(r), "--num-processes", str(n),
                 "--catalog", catalog,
                 "--coordinator-port", str(coord),
                 "--advertise-address", "127.0.0.1",
                 "--host", "127.0.0.1", "--port", str(pod.port)]
                + list(flags) + list((rank_flags or {}).get(r, [])),
                cwd=REPO, env=env, stdout=fh, stderr=subprocess.STDOUT))
        pod.n = n
        return pod

    @property
    def base(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def log(self, r: int) -> str:
        with open(os.path.join(self.tmp, f"{self.tag}{r}.log")) as fh:
            return fh.read()

    def logs(self) -> str:
        return "\n".join(f"--- {self.tag}{r}\n{self.log(r)[-2500:]}"
                         for r in range(self.n))

    def wait_healthy(self, timeout=BOOT_S) -> None:
        deadline = time.monotonic() + timeout
        while True:
            try:
                urllib.request.urlopen(f"{self.base}/health", timeout=2)
                return
            except Exception:
                for proc in self.procs:
                    assert proc.poll() is None, self.logs()
                if time.monotonic() > deadline:
                    pytest.fail("pod never became healthy:\n" + self.logs())
                time.sleep(0.1)

    def post(self, path, body, timeout=REQUEST_S):
        req = urllib.request.Request(
            f"{self.base}{path}", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return resp.status, json.loads(resp.read().decode())
        except urllib.error.HTTPError as exc:
            return exc.code, exc.read().decode()

    def generate(self, body):
        status, data = self.post("/v1/generate", body)
        assert status == 200, (status, data)
        return data

    def get(self, path):
        with urllib.request.urlopen(f"{self.base}{path}",
                                    timeout=30) as resp:
            return resp.read().decode()

    def stop(self, timeout=60) -> list:
        """SIGTERM to the frontend; every rank's exit code."""
        self.procs[0].send_signal(signal.SIGTERM)
        return [proc.wait(timeout=timeout) for proc in self.procs]

    def stats(self) -> list:
        """Every rank's exit line (``pod rank stats {...}``)."""
        out = []
        for r in range(self.n):
            line = [ln for ln in self.log(r).splitlines()
                    if ln.startswith("pod rank stats ")]
            assert line, self.log(r)[-2000:]
            out.append(json.loads(line[-1][len("pod rank stats "):]))
        return out

    def close(self) -> None:
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
        for proc in self.procs:
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass
        for fh in self._logs:
            fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _sse(pod, body, keep_open=False):
    """POST a streamed generate; the events (and, with keep_open, the
    live response after the first event)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", pod.port,
                                      timeout=REQUEST_S)
    conn.request("POST", body.pop("_path", "/v1/generate"),
                 json.dumps(body), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200
    assert resp.getheader("Content-Type") == "text/event-stream"
    buf = b""
    while b"\n\n" not in buf:
        buf += resp.read1(65536)
    if keep_open:
        return conn, resp, buf
    while True:
        data = resp.read1(65536)
        if not data:
            break
        buf += data
    conn.close()
    return _events(buf)


def _events(buf):
    return [json.loads(raw[len(b"data: "):])
            for raw in buf.split(b"\n\n") if raw.startswith(b"data: ")]


def _streamed(events):
    assert events[-1]["done"] is True
    toks = sum((e["tokens"] for e in events if "tokens" in e), [])
    assert events[-1]["count"] == len(toks)
    return toks


@pytest.mark.parametrize(
    "n_procs,dp", [(2, 1), (4, 2)], ids=["tp2", "dp2xtp2"]
)
def test_pod_serves_http(tmp_path, base, n_procs, dp):
    """Mirror of :156: greedy, sampled, knobs, n, stop, a wide
    logit_bias, prefix reuse with chunked admission (tp2), score, the
    logprobs echo, beams, SSE, co-batching, a disconnect, /v1/model and
    /metrics, and SIGTERM ending every rank with 0; every rank's token
    digest agrees."""
    ck, jp, _tp = base
    knob_matrix = n_procs == 2
    flags = (["--dp", str(dp), "--checkpoint-dir", ck]
             + (["--prefix-cache", "2", "--prefill-chunk", "4"]
                if knob_matrix else [])
             + MODEL_FLAGS)
    with Pod.launch(str(tmp_path), n_procs, flags) as pod:
        # the references, while the ranks start
        ref = _reference([1, 2, 3], 6, params=jp)
        want_knobs = _reference(
            [7, 8, 9], 6, params=jp, min_new_tokens=3,
            frequency_penalty=30.0, logit_bias={11: -100.0})
        want_sampled = [
            _reference([5, 6], 5, params=jp, row=r, temperature=0.8,
                       top_k=20, seed=9) for r in (0, 1)]
        want_long = _reference([5, 6], 40, params=jp, temperature=0.8,
                               top_k=20, seed=9)
        history = [(i * 5 + 2) % 128 for i in range(20)]
        if knob_matrix:
            want_wide = _reference(
                [1, 2, 3], 6, params=jp,
                logit_bias={i: -100.0 for i in range(20)})
            want_t1 = _reference(history, 5, params=jp)
            want_t2 = _reference(history + [7, 3], 5, params=jp,
                                 temperature=0.6, seed=5)
            from containerpilot_tpu.models.beam import beam_search

            bt, _sc = beam_search(
                jp, jnp.asarray([[1, 2, 3]], jnp.int32), jax_cfg(),
                max_new_tokens=6, max_len=48, beam_width=2)
            want_beam = [int(t) for t in np.asarray(bt)]
        from containerpilot_tpu.workload.modelcfg import score_logprobs_fn

        want_score = np.asarray(score_logprobs_fn(jax_cfg())(
            jp, jnp.asarray([[1, 2, 3, 4] + [0] * 12], jnp.int32)))[0][:3]
        pod.wait_healthy(BOOT_S * max(1, n_procs // 2))

        greedy = pod.generate({"tokens": [[1, 2, 3]], "max_new_tokens": 6})
        assert greedy["tokens"][0] == ref
        sampled = pod.generate({
            "tokens": [[5, 6]], "max_new_tokens": 5,
            "temperature": 0.8, "top_k": 20, "seed": 9,
        })
        assert sampled["tokens"][0] == want_sampled[0]
        knobs = pod.generate({
            "tokens": [[7, 8, 9]], "max_new_tokens": 6,
            "min_new_tokens": 3, "frequency_penalty": 30.0,
            "logit_bias": {"11": -100},
        })
        assert knobs["tokens"][0] == want_knobs
        assert 11 not in knobs["tokens"][0]

        if knob_matrix:
            two = pod.generate({"tokens": [[1, 2, 3]], "max_new_tokens": 6,
                                "n": 2})
            assert two["tokens"] == [ref, ref]
            sampled2 = pod.generate({
                "tokens": [[5, 6]], "max_new_tokens": 5,
                "temperature": 0.8, "top_k": 20, "seed": 9, "n": 2,
            })
            assert sampled2["tokens"] == want_sampled
            stop_seq = ref[2:4]
            stopped = pod.generate({"tokens": [[1, 2, 3]],
                                    "max_new_tokens": 6,
                                    "stop": [stop_seq]})
            assert stopped["tokens"][0] == InferenceServer._trim_stops(
                [list(ref)], [stop_seq])[0]
            assert len(stopped["tokens"][0]) < len(ref)
            wb = pod.generate({
                "tokens": [[1, 2, 3]], "max_new_tokens": 6,
                "logit_bias": {str(i): -100.0 for i in range(20)},
            })
            assert wb["tokens"][0] == want_wide
            assert all(t >= 20 for t in wb["tokens"][0])
            # prefix reuse: turn 1 misses and seeds every rank's LRU (its
            # 20 ids prefill in 4-id pieces), turn 2 extends through it
            t1 = pod.generate({"tokens": [history], "max_new_tokens": 5})
            assert t1["tokens"][0] == want_t1
            t2 = pod.generate({"tokens": [history + [7, 3]],
                               "max_new_tokens": 5, "temperature": 0.6,
                               "seed": 5})
            assert t2["tokens"][0] == want_t2
            pc = json.loads(pod.get("/v1/model"))["prefix_cache"]
            assert (pc["entries"], pc["misses"], pc["hits"]) == (2, 1, 1)
            assert pc["tokens_reused"] > 0

        status, scored = pod.post("/v1/score", {"tokens": [[1, 2, 3, 4]]})
        assert status == 200
        np.testing.assert_allclose(scored["logprobs"][0], want_score,
                                   atol=SCORE_TOL)

        if knob_matrix:
            lp = pod.generate({"tokens": [[1, 2, 3]], "max_new_tokens": 6,
                               "logprobs": True})
            assert lp["tokens"][0] == ref
            _, echo = pod.post("/v1/score", {"tokens": [[1, 2, 3] + ref]})
            assert lp["logprobs"][0] == echo["logprobs"][0][2:2 + len(ref)]
            beam = pod.generate({"tokens": [[1, 2, 3]], "max_new_tokens": 6,
                                 "beam_width": 2})
            assert beam["tokens"][0] == want_beam

        # SSE: the deltas concatenate to the buffered answer
        assert _streamed(_sse(pod, {"tokens": [[1, 2, 3]],
                                    "max_new_tokens": 6,
                                    "stream": True})) == ref
        # co-batching: a buffered request joins beside a live stream, and
        # both equal their solo references
        conn, resp, buf = _sse(pod, {
            "tokens": [[5, 6]], "max_new_tokens": 40, "temperature": 0.8,
            "top_k": 20, "seed": 9, "stream": True}, keep_open=True)
        mid = pod.generate({"tokens": [[1, 2, 3]], "max_new_tokens": 6})
        assert mid["tokens"][0] == ref
        while True:
            data = resp.read1(65536)
            if not data:
                break
            buf += data
        conn.close()
        assert _streamed(_events(buf)) == want_long
        # a disconnect mid-stream: the slot is evicted, the pool serves on
        conn, resp, _buf = _sse(pod, {"tokens": [[5, 6]],
                                      "max_new_tokens": 40,
                                      "stream": True}, keep_open=True)
        resp.close()
        conn.close()
        again = pod.generate({"tokens": [[1, 2, 3]], "max_new_tokens": 6})
        assert again["tokens"][0] == ref

        info = json.loads(pod.get("/v1/model"))
        assert info["pod"]["num_processes"] == n_procs
        assert info["pod"]["mesh"] == {"data": dp, "seq": 1,
                                       "model": n_procs // dp}
        assert info["slot_engine"]["slots"] == 4
        time.sleep(1)  # the disconnected stream's close lands
        metrics = pod.get("/metrics")
        n_200 = 16.0 if knob_matrix else 8.0
        assert ('containerpilot_pod_requests_total'
                '{endpoint="generate",status="200"} %s' % n_200) in metrics
        assert ('containerpilot_pod_requests_total'
                '{endpoint="model",status="200"} %s'
                % (2.0 if knob_matrix else 1.0)) in metrics
        assert "containerpilot_pod_generated_tokens_total" in metrics

        rcs = pod.stop(timeout=60 * max(1, n_procs // 2))
        assert rcs == [0] * n_procs, pod.logs()
        stats = pod.stats()
        assert all(s["digest"] == stats[0]["digest"]
                   and s["ops"] == stats[0]["ops"] for s in stats), stats
        assert all(s["step_program"] == "eager" for s in stats)


def test_pod_frontend_parse_never_leaks_exceptions():
    """Mirror of :507: adversarial bodies against the frontend's parse
    layer raise only the ValueError family the handlers turn into 422s."""
    import random

    from containerpilot_tpu_torch.workload.serve_dist import _Frontend

    f = _Frontend("127.0.0.1", 0, max_len=48, vocab=512)
    rng = random.Random(0)
    atoms = [
        None, True, False, 0, 1, -1, 2**40, -2**40, 1.5, float("nan"),
        float("inf"), "x", "", [], {}, [None], [[]], [[1]], [[-1]],
        [[1, "a"]], [[True]], [[2**40]], {"1": 1}, [[1], [2]],
        [[1, 2, 3]],
    ]
    keys = [
        "tokens", "max_new_tokens", "temperature", "top_k", "top_p",
        "eos_id", "seed", "min_new_tokens", "presence_penalty",
        "frequency_penalty", "logit_bias", "n", "stop", "stream",
        "logprobs", "beam_width",
    ]
    ok = 0
    for _ in range(300):
        body = {k: rng.choice(atoms)
                for k in rng.sample(keys, rng.randrange(1, 6))}
        try:
            tokens = f._parse_single_row(body)
            f._parse_work(body, tokens)
            ok += 1
        except (ValueError, KeyError, TypeError, OverflowError):
            pass  # the 422 family the handlers catch
    assert ok >= 0


def _admit_payload(sd, tokens, slot, mask, max_len=48, slots=4,
                   row_idx=0, **knobs):
    work = {
        "tokens": tokens, "max_new": 9, "temperature": 0.0, "top_k": 0,
        "top_p": 0.0, "eos_id": -1, "seed": 0, "min_new": 0,
        "presence": 0.0, "frequency": 0.0, "logit_bias": {},
    }
    work.update(knobs)
    p = sd._payload_zeros(max_len, slots)
    if tokens is not None:
        sd._fill_admission(p, work, row_idx=row_idx, slot=slot)
    p["run_chunk"] = np.asarray(1, np.int32)
    p["done"] = np.asarray(mask, np.int32)
    return p


def test_pod_warmup_covers_serve_path(base):
    """Mirror of :546: after ``warm_pod`` a plen-4 admission with
    arbitrary sampling knobs (operands, not shapes), the chunk and the
    width-16 scorer dispatch no program shape for the first time, build
    and capture nothing; an unwarmed prompt length (11) is caught."""
    from containerpilot_tpu_torch.ops import _build
    from containerpilot_tpu_torch.workload import serve_dist as sd

    _ck, _jp, tp = base
    mirror = sd._SlotMirror(port_cfg(), tp, 48, 4, 8)
    sd.warm_pod(mirror)
    mirror.mark_warm()
    graphs, builds = mirror.program.graphs, _build.BUILDS
    sd._apply_round(mirror, _admit_payload(
        sd, [1, 2, 3, 4], 1, [1, 0, 1, 1], temperature=0.7, top_k=5,
        seed=3, min_new=2, presence=0.5, frequency=0.25,
        logit_bias={7: -5.0}))
    sc = sd._payload_zeros(48, 4)
    sc["prompt"][:9] = 1
    sc["plen"] = np.asarray(9, np.int32)
    sd._score_pod(mirror, sc)
    assert mirror.fresh_after_warm == []
    assert (mirror.program.graphs, _build.BUILDS) == (graphs, builds)
    sd._apply_round(mirror, _admit_payload(sd, list(range(1, 12)), 2,
                                           [1, 0, 0, 1]))
    assert mirror.fresh_after_warm == [("prefill", 11)]


def test_mirror_rounds_match_generate(base):
    """Mirror of :621: the per-round device ops every rank replays
    (admission, chunks under a churning done mask, retirement, slot
    reuse) equal the reference's solo generate, greedy and sampled
    rows alike."""
    from containerpilot_tpu_torch.models.slots import append_chunk
    from containerpilot_tpu_torch.workload import serve_dist as sd

    _ck, jp, tp = base
    cfg = port_cfg()
    S, chunk = 4, 8
    mirror = sd._SlotMirror(cfg, tp, 48, S, chunk)
    sd.warm_pod(mirror)

    def rnd(mask, tokens=None, slot=0, **kw):
        return sd._apply_round(mirror, _admit_payload(
            sd, tokens, slot, mask, **kw))

    # A (slot 0, greedy, 20 new) decodes alone for one round...
    em_a: list = []
    first, toks = rnd([0, 1, 1, 1], [1, 2, 3, 4], 0, max_new=20)
    em_a.append(first)
    append_chunk(em_a, toks[0], 20, -1)
    # ...then B (slot 1, sampled) joins
    em_b: list = []
    first, toks = rnd([0, 0, 1, 1], [5, 6, 7, 8], 1, max_new=12,
                      temperature=0.8, top_k=20, seed=9)
    em_b.append(first)
    append_chunk(em_a, toks[0], 20, -1)
    append_chunk(em_b, toks[1], 12, -1)
    _f, toks = rnd([0, 0, 1, 1])
    append_chunk(em_a, toks[0], 20, -1)
    append_chunk(em_b, toks[1], 12, -1)
    assert len(em_a) == 20
    _f, toks = rnd([1, 0, 1, 1])  # A retired; B finishes alone
    append_chunk(em_b, toks[1], 12, -1)
    assert len(em_b) == 12
    assert em_a == _reference([1, 2, 3, 4], 20, params=jp)
    assert em_b == _reference([5, 6, 7, 8], 12, params=jp,
                              temperature=0.8, top_k=20, seed=9)
    # slot 0 REUSED: nothing of A, nor of B's knobs
    em_c: list = []
    first, toks = rnd([0, 0, 1, 1], [9, 8, 7, 6], 0, max_new=9, seed=3)
    em_c.append(first)
    append_chunk(em_c, toks[0], 9, -1)
    _f, toks = rnd([0, 1, 1, 1])
    append_chunk(em_c, toks[0], 9, -1)
    assert em_c == _reference([9, 8, 7, 6], 9, params=jp, seed=3)


def test_pod_model_prefix_schema_stable_across_boot(run):
    """Mirror of :708: /v1/model's prefix_cache block carries the same
    keys during the boot window as after warm-up: the seven keys of the
    single-host server's block (spill fields included), zeroed before
    the live cache lands. No block at all without a cache."""
    from containerpilot_tpu_torch.workload.serve_dist import _Frontend
    from containerpilot_tpu_torch.workload.serve_prefix import PrefixCache

    f = _Frontend("127.0.0.1", 0, max_len=48, vocab=128,
                  pod_info={"prefix_cache": {"entries": 2}},
                  prefix_entries=2)
    before = json.loads(run(f._model(None)).body.decode())
    assert before["prefix_cache"] == {
        "entries": 2, "hits": 0, "misses": 0, "tokens_reused": 0,
        "spilled": 0, "readmitted": 0, "spill_bytes": 0,
    }
    pc = PrefixCache(2)
    pc.stats["misses"] = 1
    f.prefix_cache = pc
    after = json.loads(run(f._model(None)).body.decode())
    assert set(after["prefix_cache"]) == set(before["prefix_cache"])
    assert after["prefix_cache"]["misses"] == 1
    bare = _Frontend("127.0.0.1", 0, max_len=48, vocab=128)
    assert "prefix_cache" not in json.loads(
        run(bare._model(None)).body.decode())


def test_pod_text_completions(tmp_path):
    """Mirror of :738: --text completions (buffered, stop strings,
    streamed with UTF-8 holdback) equal the reference text contract, and
    with --draft-layers the greedy buffered completion runs the lockstep
    SPEC op on both ranks."""
    from containerpilot_tpu.workload.text import ByteTokenizer

    cfg = jax_cfg(vocab_size=512, n_layers=2)
    jp = jtf.init_params(jax.random.PRNGKey(0), cfg)
    ck = tmp_path / "ck"
    write_checkpoint(ck, jp, 1)
    env = dict(_sub_env(), CONTAINERPILOT_POD_DEBUG="1")
    flags = ["--text", "--vocab", "512", "--max-len", "48", "--d-model",
             "64", "--n-layers", "2", "--n-heads", "2", "--draft-layers",
             "1", "--speculate", "2", "--checkpoint-dir", str(ck)]
    with Pod.launch(str(tmp_path), 2, flags, env=env) as pod:
        tok = ByteTokenizer(512)
        want = _reference(tok.encode("hi"), 6, cfg=cfg, params=jp,
                          eos_id=tok.EOS)
        pod.wait_healthy()
        status, comp = pod.post("/v1/completions",
                                {"prompt": "hi", "max_new_tokens": 6})
        assert status == 200
        assert comp["tokens"] == want
        assert comp["text"] == tok.decode(comp["tokens"])
        time.sleep(0.5)
        for r in (0, 1):
            assert "SPEC plen=" in pod.log(r), f"rank {r} ran no spec op"
        info = json.loads(pod.get("/v1/model"))
        assert info["speculative"] == {"draft_layers": 1, "speculate": 2}
        s1, with_stop = pod.post("/v1/completions", {
            "prompt": "hi", "max_new_tokens": 6, "stop": ["\x00zz"]})
        assert s1 == 200 and with_stop["tokens"] == want
        events = _sse(pod, {"_path": "/v1/completions", "prompt": "hi",
                            "max_new_tokens": 6, "stream": True})
        assert events[-1]["done"] is True
        assert sum((e["tokens"] for e in events if "tokens" in e),
                   []) == comp["tokens"]
        assert "".join(e["text"] for e in events
                       if "text" in e) == comp["text"]
        assert pod.stop() == [0, 0], pod.logs()


def test_pod_restores_checkpoint_in_lockstep(tmp_path):
    """Mirror of :898: every rank restores its blocks of one checkpoint
    (step 2, written whole by one process) and serves ``--kv-int8``; the
    greedy answer equals the reference kv-int8 generate of the same
    weights."""
    cfg = jax_cfg(vocab_size=64, d_model=32, d_ff=derive_d_ff(32),
                  kv_int8=True)
    jp = jtf.init_params(jax.random.PRNGKey(2), cfg)
    ck = tmp_path / "ck"
    write_checkpoint(ck, jp, 2)
    flags = ["--max-len", "48", "--d-model", "32", "--n-layers", "1",
             "--n-heads", "2", "--vocab", "64", "--checkpoint-dir",
             str(ck), "--kv-int8"]
    with Pod.launch(str(tmp_path), 2, flags) as pod:
        want = _reference([1, 2, 3], 6, cfg=cfg, params=jp)
        pod.wait_healthy()
        got = pod.generate({"tokens": [[1, 2, 3]], "max_new_tokens": 6})
        assert "pod serving checkpoint step 2" in pod.log(0)
        assert got["tokens"][0] == want
        assert pod.stop() == [0, 0], pod.logs()


def test_pod_serves_moe_int8_lora(tmp_path):
    """Mirror of :1003: --moe-experts (experts over the model axis),
    --lora-dir (merged before quantization), --int8 (the whole tree
    quantized, then cut) and --window (ring caches that wrap) in one
    boot. Greedy equals the reference's quantize(apply_lora(base)) of
    the same params. The sampled request is held exactly twice: the
    port's one-rank load_model of the same flags draws the reference's
    single-device row token for token (the packages agree), and the pod
    draws what a SlotEngine of the pod's layout draws (a gloo world of
    2 ranks, load_model of the same flags on its tp2 mesh, the pod's
    slots, chunk and window), whose bf16 partial sums over ``model``
    round as the pod's do. Where the pod's row leaves the one-rank row,
    the test prints the step and the draw's top-two gap there."""
    from containerpilot_tpu.models.lora import apply_lora, init_lora_params
    from containerpilot_tpu.models.quantized import quantize_model_params
    from containerpilot_tpu_torch.parallel import lora_abstract_state
    from containerpilot_tpu_torch.workload import serve_cli

    cfg = jax_cfg(vocab_size=64, d_model=32, d_ff=derive_d_ff(32),
                  moe_experts=2, window=8)
    base_jp = jtf.init_params(jax.random.PRNGKey(0), cfg)
    # an adapter whose B is not zero, so the merge changes the weights
    adapter = _np(init_lora_params(jax.random.PRNGKey(3), cfg, 4))
    rng = np.random.default_rng(3)
    for name in adapter:
        if name.endswith("_b"):
            adapter[name] = rng.normal(
                0, 0.1, adapter[name].shape).astype(np.float32)
    ck, lora_dir = tmp_path / "ck", tmp_path / "lora"
    write_checkpoint(ck, base_jp, 1)
    t_adapter = bridge.lora_from_jax(adapter, "cpu")
    like = lora_abstract_state(port_cfg(**{k: getattr(cfg, k) for k in (
        "vocab_size", "d_model", "d_ff", "moe_experts", "window")}), 4)
    assert set(t_adapter) == set(like.params)
    save_checkpoint(str(lora_dir), 3, TrainState(
        t_adapter, make_optimizer().init(t_adapter), 3))
    model_flags = [
        "--max-len", "48", "--d-model", "32", "--n-layers", "1",
        "--n-heads", "2", "--vocab", "64", "--moe-experts", "2",
        "--int8", "--lora-dir", str(lora_dir), "--lora-rank", "4",
        "--window", "8", "--checkpoint-dir", str(ck),
    ]
    sampled_body = {"tokens": [[5, 6]], "max_new_tokens": 5,
                    "temperature": 0.7, "top_k": 12, "seed": 4}
    layout = tmp_path / "tp2"
    layout.mkdir()
    procs, out = start_world(layout, [{
        "name": "pod_layout", "kind": "slots", "plan": {"data": 1,
                                                       "model": 2},
        "cli_flags": model_flags,
        "engine": {"max_len": 48, "slots": 4, "chunk": 8, "window": 4},
        "requests": [[[5, 6], {"max_new": 5, "temperature": 0.7,
                               "top_k": 12, "seed": 4}]],
    }], world=2)
    try:
        with Pod.launch(str(tmp_path), 2, model_flags) as pod:
            ref_params = quantize_model_params(
                apply_lora(base_jp, jax.tree_util.tree_map(jnp.asarray,
                                                           adapter), cfg))
            want = _reference([1, 2, 3], 6, cfg=cfg, params=ref_params)
            want_sampled = _reference([5, 6], 5, cfg=cfg, params=ref_params,
                                      temperature=0.7, top_k=12, seed=4)
            args = serve_cli.build_arg_parser().parse_args(
                ["--device", "cpu"] + model_flags)
            tcfg, tparams, _ = serve_cli.load_model(args,
                                                    say=lambda s: None)
            one_rank = _port_reference([5, 6], 5, tcfg, tparams,
                                       temperature=0.7, top_k=12, seed=4)
            pod.wait_healthy()
            log0 = pod.log(0)
            assert "pod merged lora adapter (rank 4, step 3)" in log0
            assert "pod int8: resident params" in log0
            info = json.loads(pod.get("/v1/model"))
            assert info["moe_experts"] == 2 and info["int8"] is True
            assert info["lora"] == {"rank": 4}
            assert info["window"] == 8
            greedy = pod.generate({"tokens": [[1, 2, 3]],
                                   "max_new_tokens": 6})
            assert greedy["tokens"][0] == want
            got = pod.generate(sampled_body)["tokens"][0]
            assert pod.stop() == [0, 0], pod.logs()
    finally:
        finish_world(procs)
    assert one_rank == want_sampled
    layout_row = results(out, "pod_layout", 2)[0]["outs"][0]
    where = first_difference([one_rank], [got])
    if where is not None:
        step = where[1]
        print(f"pod sampled row {got} leaves the one-rank row {one_rank} "
              f"at step {step}; the one-rank draw's top-two gap there",
              teacher_forced_gap(tparams, tcfg, [5, 6], one_rank, step,
                                 tdecode.row_key(4, 0), temperature=0.7,
                                 top_k=12))
    assert got == layout_row


def test_pod_serves_cp_long_prompt(tmp_path):
    """Mirror of :1140: --sp 2 rings long admissions' prefill over the
    seq axis (a bucketed head, the remainder extended), short prompts
    take the plain path. Greedy long answers equal the reference's
    cp_prefill_with_remainder + generate_from_cache on an in-process
    seq=2 mesh; the sampled long answer equals the port's one-rank cp
    recipe; the --sp compositions are refused before any rendezvous."""
    from containerpilot_tpu.models.decode import generate_from_cache
    from containerpilot_tpu.parallel import MeshPlan, make_mesh
    from containerpilot_tpu.parallel.context import (
        cp_head_buckets,
        cp_prefill_with_remainder,
        pick_cp_head,
    )

    max_len = 96
    cfg = jax_cfg(vocab_size=64, d_model=32, d_ff=derive_d_ff(32),
                  max_seq_len=max_len)
    jp = jtf.init_params(jax.random.PRNGKey(0), cfg)
    ck = tmp_path / "ck"
    write_checkpoint(ck, jp, 1)
    flags = ["--max-len", str(max_len), "--d-model", "32", "--n-layers",
             "1", "--n-heads", "2", "--vocab", "64", "--sp", "2",
             "--cp-min-len", "24", "--checkpoint-dir", str(ck)]
    long_even = [(i * 7 + 3) % 64 for i in range(40)]
    long_odd = long_even + [11]
    with Pod.launch(str(tmp_path), 2, flags) as pod:
        ref_mesh = make_mesh(jax.devices()[:2],
                             plan=MeshPlan(data=1, model=1, seq=2))
        buckets = cp_head_buckets(24, max_len, 2)
        assert buckets == [24, 48]

        def cp_ref(tokens, max_new):
            head = pick_cp_head(len(tokens), buckets)
            logits, cache = cp_prefill_with_remainder(
                jp, np.asarray([tokens], np.int32), cfg, ref_mesh,
                max_len, head=head)
            out = generate_from_cache(
                jp, cache, logits, cfg, max_new, pos=len(tokens),
                rng=jnp.stack([jax.random.fold_in(jax.random.PRNGKey(0),
                                                  0)]))
            return [int(t) for t in np.asarray(out)[0]][:max_new]

        want_even, want_odd = cp_ref(long_even, 8), cp_ref(long_odd, 8)
        tcfg = port_cfg(vocab_size=64, d_model=32, d_ff=derive_d_ff(32),
                        max_seq_len=max_len)
        tp = port_params(jp, tcfg)
        # the port's sampled cp reference: its ring on a layout of one
        # rank is the plain prefill, so the one-rank generate stands in
        want_sampled = _port_reference(long_even, 6, tcfg, tp, seed=9,
                                       temperature=0.8, top_k=12)
        want_short = _reference([1, 2, 3], 6, cfg=cfg, params=jp)
        pod.wait_healthy()
        info = json.loads(pod.get("/v1/model"))
        assert info["cp"] == {"seq": 2, "min_len": 24}
        assert info["pod"]["mesh"] == {"data": 1, "seq": 2, "model": 1}
        got = pod.generate({"tokens": [long_even], "max_new_tokens": 8})
        assert got["tokens"][0] == want_even
        got = pod.generate({"tokens": [long_odd], "max_new_tokens": 8})
        assert got["tokens"][0] == want_odd
        sampled = pod.generate({"tokens": [long_even], "max_new_tokens": 6,
                                "temperature": 0.8, "top_k": 12,
                                "seed": 9})
        assert sampled["tokens"][0] == want_sampled
        short = pod.generate({"tokens": [[1, 2, 3]], "max_new_tokens": 6})
        assert short["tokens"][0] == want_short
        assert pod.stop() == [0, 0], pod.logs()
        stats = pod.stats()
        assert stats[0]["digest"] == stats[1]["digest"]
    for extra, msg in (
        (["--window", "8"], b"--sp does not compose with --window"),
        (["--draft-layers", "1"],
         b"--sp does not compose with --draft-layers"),
    ):
        res = subprocess.run(
            [sys.executable, "-m", POD, "--device", "cpu",
             "--process-id", "0", "--num-processes", "2",
             "--catalog", "127.0.0.1:1", "--sp", "2"] + extra
            + ["--max-len", "96", "--d-model", "32", "--n-layers", "2",
               "--n-heads", "2", "--vocab", "64"],
            cwd=REPO, env=_sub_env(), capture_output=True, timeout=120)
        assert res.returncode != 0
        assert msg in res.stderr + res.stdout


def test_pod_watchdog_turns_wedged_follower_into_exit(tmp_path, base):
    """Mirror of :1301: a follower that wedges without dying makes every
    rank exit 86 within the deadline (the idle check op bounds every
    rank's cycle)."""
    ck, _jp, _tp = base
    wedge = tmp_path / "wedge"
    flags = ["--watchdog", "6", "--startup-grace", "240", "--wedge-file",
             str(wedge), "--checkpoint-dir", ck] + MODEL_FLAGS
    with Pod.launch(str(tmp_path), 2, flags) as pod:
        pod.wait_healthy()
        t0 = time.monotonic()
        wedge.write_text("1")
        rcs = [proc.wait(timeout=60) for proc in pod.procs]
        assert rcs == [86, 86], pod.logs()
        assert time.monotonic() - t0 < 30
        assert "follower: injected wedge" in pod.log(1)


def _supervisor_config(tmp_path, idx, n_procs, catalog_port, http_port,
                       coord_port, wedge, ck):
    exec_argv = [
        sys.executable, "-u", "-m", POD, "--device", "cpu",
        "--process-id", str(idx), "--num-processes", str(n_procs),
        "--catalog", f"127.0.0.1:{catalog_port}",
        "--coordinator-port", str(coord_port),
        "--advertise-address", "127.0.0.1",
        "--host", "127.0.0.1", "--port", str(http_port),
        "--dp", "2", "--watchdog", "20", "--startup-grace", "420",
        "--checkpoint-dir", ck,
    ] + MODEL_FLAGS
    if idx == 1:  # exactly one follower carries the fault injector
        exec_argv += ["--wedge-file", str(wedge)]
    config = {
        "stopTimeout": "15s",
        "control": {"socket": str(tmp_path / f"cp{idx}.socket")},
        "logging": {"level": "INFO", "format": "default",
                    "output": "stdout"},
        "jobs": [{"name": f"pod{idx}", "exec": exec_argv, "restarts": 6}],
    }
    path = tmp_path / f"pod{idx}.json5"
    path.write_text(json.dumps(config))
    return str(path)


def _catalog_server(port):
    proc = subprocess.Popen(
        [sys.executable, "-m", "containerpilot_tpu",
         "-catalog-server", f"127.0.0.1:{port}"],
        cwd=REPO, env=_sub_env(), stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    deadline = time.monotonic() + 30
    while True:
        try:
            urllib.request.urlopen(
                f"http://127.0.0.1:{port}/v1/health/service/x", timeout=1)
            return proc
        except Exception:
            if time.monotonic() > deadline:
                proc.kill()
                pytest.fail("catalog never became ready")
            time.sleep(0.1)


def _supervised_scenario(tmp_path, ck, out) -> None:
    """The :1401 drill, run on a thread from the module's start (its
    watchdog wait overlaps the other tests): four supervisors on a live
    catalog server, a request, the wedge, the pod down and back, a
    request, SIGTERM to every supervisor. Records the served tokens and
    exit codes in ``out``; any failure as ``out["error"]``."""
    n_procs = 4
    catalog_port, http_port, coord_port = (_free_port(), _free_port(),
                                           _free_port())
    wedge = tmp_path / "wedge"
    sups, logs = [], []
    pod = Pod(port=http_port)  # its HTTP helpers, on the pod's port
    catalog = None

    def sup_logs():
        return "\n".join((tmp_path / f"sup{i}.log").read_text()[-2500:]
                         for i in range(n_procs))

    def wait_healthy(timeout):
        deadline = time.monotonic() + timeout
        while True:
            try:
                urllib.request.urlopen(f"{pod.base}/health", timeout=2)
                return
            except Exception:
                for sup in sups:
                    if sup.poll() is not None:
                        raise AssertionError(sup_logs())
                if time.monotonic() > deadline:
                    raise AssertionError("pod never became healthy:\n"
                                         + sup_logs())
                time.sleep(0.2)

    try:
        catalog = _catalog_server(catalog_port)
        for idx in range(n_procs):
            cfg = _supervisor_config(tmp_path, idx, n_procs, catalog_port,
                                     http_port, coord_port, wedge, ck)
            fh = open(tmp_path / f"sup{idx}.log", "w")
            logs.append(fh)
            sups.append(subprocess.Popen(
                [sys.executable, "-m", "containerpilot_tpu", "-config",
                 cfg], cwd=REPO, env=_sub_env(), stdout=fh,
                stderr=subprocess.STDOUT))
        wait_healthy(BOOT_S * 2)
        out["before"] = pod.generate({"tokens": [[1, 2, 3, 4]],
                                      "max_new_tokens": 6})["tokens"][0]
        wedge.write_text("1")
        deadline = time.monotonic() + 120
        while True:  # the pod goes down as the watchdogs fire...
            try:
                urllib.request.urlopen(f"{pod.base}/health", timeout=2)
                if time.monotonic() > deadline:
                    raise AssertionError("pod never went unhealthy:\n"
                                         + sup_logs())
                time.sleep(0.2)
            except AssertionError:
                raise
            except Exception:
                break
        wait_healthy(BOOT_S * 2)  # ...and comes back
        out["after"] = pod.generate({"tokens": [[5, 6, 7, 8]],
                                     "max_new_tokens": 5})["tokens"][0]
        out["wedged"] = "follower: injected wedge" in (
            tmp_path / "sup1.log").read_text()
        for sup in sups:
            sup.send_signal(signal.SIGTERM)
        out["rcs"] = [sup.wait(timeout=90) for sup in sups]
        out["logs"] = sup_logs()
    except BaseException as exc:  # noqa: BLE001 - reported by the test
        out["error"] = exc
    finally:
        for sup in sups:
            if sup.poll() is None:
                sup.terminate()
        for sup in sups:
            try:
                sup.wait(timeout=20)
            except subprocess.TimeoutExpired:
                sup.kill()
        if catalog is not None:
            catalog.kill()
            catalog.wait(timeout=10)
        for fh in logs:
            fh.close()


@pytest.fixture(scope="module", autouse=True)
def background(tmp_path_factory, base):
    """The two drills that spend most of their time waiting (the
    supervised pod's watchdog and restart, the reference pod's compile),
    started when the module starts and read by the last two tests."""
    import threading

    ck, _jp, _tp = base
    sup_out: dict = {}
    sup_thread = threading.Thread(
        target=_supervised_scenario,
        args=(tmp_path_factory.mktemp("supervised"), ck, sup_out),
        daemon=True)
    sup_thread.start()
    pair = _ReferencePair(tmp_path_factory.mktemp("ref_pair"), ck)
    try:
        yield {"supervised": (sup_thread, sup_out), "pair": pair}
    finally:
        pair.close()
        sup_thread.join(timeout=300)


def test_supervised_pod_recovers_from_wedged_follower(background, base):
    """Mirror of :1401: a dp2 x tp2 pod of four ranks under four
    reference supervisors on the reference's live catalog server; a
    follower wedges, every rank exits 86, the supervisors restart them,
    the pod re-rendezvouses and answers as before; SIGTERM to every
    supervisor ends all of them with 0."""
    _ck, jp, _tp = base
    thread, out = background["supervised"]
    want_before = _reference([1, 2, 3, 4], 6, params=jp)
    want_after = _reference([5, 6, 7, 8], 5, params=jp)
    thread.join(timeout=600)
    assert not thread.is_alive()
    if "error" in out:
        raise out["error"]
    assert out["before"] == want_before
    assert out["after"] == want_after
    assert out["wedged"]
    assert out["rcs"] == [0, 0, 0, 0], out["logs"]


def _reference_wrapper(tmp_path):
    """The reference pod's CPU wrapper (the image pins jax to its
    accelerator otherwise), as its own tests write it."""
    wrapper = tmp_path / "serve_dist_cpu.py"
    wrapper.write_text(
        "import sys\n"
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from containerpilot_tpu.workload.serve_dist import main\n"
        "sys.exit(main())\n"
    )
    return wrapper


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return None


class _ReferencePair:
    """The reference pod and the port pod, two processes each, on one
    live catalog server with the same flags on the same params (the
    port's from the bridged checkpoint), launched together when the
    module starts (the reference pod's compile overlaps the other
    tests)."""

    FLAGS = ["--prefix-cache", "2"] + MODEL_FLAGS

    def __init__(self, tmp_path, ck):
        self.catalog = _catalog_server(_free_port())
        catalog = self.catalog.args[-1]
        wrapper = _reference_wrapper(tmp_path)
        env = dict(_sub_env(), CONTAINERPILOT_COMPILE_CACHE=str(
            tmp_path / "xla-cache"))
        self.ref = Pod(str(tmp_path), _free_port(), tag="ref")
        coord = _free_port()
        for r in (0, 1):
            fh = open(tmp_path / f"ref{r}.log", "w")
            self.ref._logs.append(fh)
            self.ref.procs.append(subprocess.Popen(
                [sys.executable, "-u", str(wrapper), "--process-id",
                 str(r), "--num-processes", "2", "--catalog", catalog,
                 "--coordinator-port", str(coord), "--advertise-address",
                 "127.0.0.1", "--host", "127.0.0.1", "--port",
                 str(self.ref.port)] + self.FLAGS,
                cwd=REPO, env=env, stdout=fh, stderr=subprocess.STDOUT))
        self.ref.n = 2
        self.port = Pod.launch(str(tmp_path), 2,
                               self.FLAGS + ["--checkpoint-dir", ck],
                               catalog=catalog)

    def close(self) -> None:
        self.ref.close()
        self.port.close()
        self.catalog.kill()
        self.catalog.wait(timeout=10)


def test_reference_pod_and_port_pod_answer_alike(background):
    """The reference pod and the port pod, two processes each, on one
    live catalog server with the same flags on the same params:
    ``/v1/model`` has the same keys (the ``pod`` and ``prefix_cache``
    blocks' values too) and ``/v1/generate`` the same tokens, byte for
    byte, greedy and seeded sampled (n rows, top-k, top-p, penalties)."""
    pair = background["pair"]
    pair.port.wait_healthy()
    pair.ref.wait_healthy(BOOT_S * 2)
    bodies = [
        {"tokens": [[1, 2, 3]], "max_new_tokens": 6},
        {"tokens": [[(i * 5 + 2) % 128 for i in range(20)]],
         "max_new_tokens": 5},
        {"tokens": [[7, 8, 9]], "max_new_tokens": 6, "min_new_tokens": 3,
         "frequency_penalty": 30.0, "logit_bias": {"11": -100}},
        {"tokens": [[5, 6]], "max_new_tokens": 7, "temperature": 0.8,
         "top_k": 20, "seed": 9, "n": 2},
        {"tokens": [[4, 1, 4]], "max_new_tokens": 6, "temperature": 1.1,
         "top_p": 0.9, "presence_penalty": 0.5, "seed": 2**30 + 7},
    ]
    for body in bodies:
        got = pair.port.generate(dict(body))
        want = pair.ref.generate(dict(body))
        assert json.dumps(got) == json.dumps(want), body
    ref_info = json.loads(pair.ref.get("/v1/model"))
    port_info = json.loads(pair.port.get("/v1/model"))
    assert _keys(port_info) == _keys(ref_info)
    assert port_info["pod"] == ref_info["pod"]
    assert port_info["prefix_cache"] == ref_info["prefix_cache"]
    assert pair.port.stop() == [0, 0], pair.port.logs()
    assert pair.ref.stop() == [0, 0]


def test_serve_dist_loads_no_jax():
    """The pod module and everything it imports load no jax and nothing
    of the JAX package."""
    code = (
        "import sys\n"
        f"import {POD} as m\n"
        "m.build_arg_parser()\n"
        "bad = [k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'containerpilot_tpu' or "
        "k.startswith('containerpilot_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=_sub_env(), capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "clean" in res.stdout

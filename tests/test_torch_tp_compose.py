"""The serve compositions over ranks against the JAX package, on the CPU:
beams, the speculative engine, the prefix cache and its spill tier, each
served by an ``InferenceServer`` whose params are cut into the blocks of
a tp2 mesh (the front and a ``ServingFollower`` in lockstep).

One gloo world of 2 ranks runs every case, as ``python -m
torch_serve_jobs`` children (one thread each, ``file://`` rendezvous,
killed in ``finally``); the pytest process never makes a process group
and computes the JAX side, and runs the one-rank servers it is compared
with, while they run. Params come from ``jax.random.PRNGKey(0)`` in
float32, carried into each rank's blocks by ``bridge.shard_from_jax``.

A second world, of 4 ranks on model 4, serves a GQA model whose 2 kv
heads do not divide by 4 (the replicated-kv rule: each rank's cache
holds the kv of its query heads) with every composition at once: the
speculative engine, the slot engine, a 1-entry prefix cache with its
spill tier, ``/v1/prefill``, ``/v1/kv`` out of the pod (each kv head
sent once) and ``/v1/kv/pull`` into it from a one-rank torch replica.

Mirrors ``tests/test_workload.py`` :2728 and :2647 (the beam server;
width 1 is greedy), :1355 and ``tests/test_torch_speculative.py`` :180
(the speculative server equals plain greedy decoding), :2457 and
``tests/test_slots.py`` :668 (prefix reuse in the server and in slot
admission) and ``tests/test_kvtier.py`` :187 and :341 (spill on
eviction, readmission). Tokens exactly; every rank's token digest and
prefix-cache keys equal rank 0's (the lockstep's check).
"""
import asyncio
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from containerpilot_tpu.models import beam as jbeam
from containerpilot_tpu.models import decode as jdecode
from containerpilot_tpu.models import transformer as jtf
from containerpilot_tpu.workload.serve import InferenceServer as JaxServer
from containerpilot_tpu_torch import bridge
from containerpilot_tpu_torch.kvtier import handoff
from containerpilot_tpu_torch.models import decode as tdecode
from containerpilot_tpu_torch.models import transformer as ttf
from containerpilot_tpu_torch.workload.serve import InferenceServer
from torch_serve_jobs import finish_world, flat, results, start_world

WORLD = 2
TP2 = dict(data=1, model=2)
BASE = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=1, d_ff=64,
            max_seq_len=64, dtype="float32")
SPEC = dict(BASE, n_layers=2)
PREFIX = dict(BASE, max_seq_len=128)

BEAM_BASE = {"tokens": [[1, 2, 3]], "max_new_tokens": 6}
BEAMS = [BEAM_BASE, {**BEAM_BASE, "beam_width": 1},
         {**BEAM_BASE, "beam_width": 4},
         {**BEAM_BASE, "beam_width": 2, "length_penalty": 0.6}]
SPEC_SERVER = {"max_len": 64, "draft_layers": 1, "speculate": 3}
SPEC_BODIES = [{"tokens": [[1, 2, 3]], "max_new_tokens": 12},
               {"tokens": [[7, 5, 3, 1, 9, 11, 13, 2, 4]],
                "max_new_tokens": 10}]
PREFIX_SERVER = {"max_len": 128, "prefix_cache_entries": 2}
SHARED = list(range(1, 41))  # the 40-token history of :2457
TURN2 = SHARED + [50, 51, 52]
PREFIX_BODIES = [{"tokens": [SHARED], "max_new_tokens": 8},
                 {"tokens": [TURN2], "max_new_tokens": 8},
                 {"tokens": [TURN2], "max_new_tokens": 8,
                  "temperature": 0.8, "seed": 7},
                 {"tokens": [[9] * 40], "max_new_tokens": 8}]
SPILL_SERVER = {"max_len": 64, "slots": 2, "slot_chunk": 4,
                "prefix_cache_entries": 1, "kv_spill_bytes": 1 << 20}
ROW_A = [(i * 5 + 2) % 64 for i in range(20)]
ROW_B = [(i * 7 + 3) % 64 for i in range(24)]
SPILL_BODIES = [{"tokens": [ROW_A], "max_new_tokens": 6},
                {"tokens": [ROW_B], "max_new_tokens": 6},
                {"tokens": [ROW_A], "max_new_tokens": 6}]


def jax_cfg(cfg):
    return jtf.TransformerConfig(**{**cfg, "dtype": jnp.float32})


def torch_cfg(cfg):
    return ttf.TransformerConfig(**bridge.config_kwargs(cfg))


def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read().decode())


def _model(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/model",
                                timeout=60) as resp:
        return json.loads(resp.read().decode())


def serve_one(server, bodies):
    """Run ``server`` (a JAX or a one-rank torch InferenceServer) on a
    loop of its own, send ``bodies`` one after another, read
    /v1/model, stop it: (answers, model info)."""
    out = {}

    async def scenario():
        await server.run()
        try:
            loop = asyncio.get_running_loop()
            answers = []
            for body in bodies:
                answers.append(await loop.run_in_executor(
                    None, _post, server.port, "/v1/generate", body))
            out["info"] = await loop.run_in_executor(
                None, _model, server.port)
            out["answers"] = [a["tokens"] for a in answers]
        finally:
            await server.stop()

    thread = threading.Thread(target=lambda: asyncio.run(scenario()))
    thread.start()
    thread.join(timeout=240)
    return out["answers"], out["info"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(results dir, JAX params by config, the one-device sides)."""
    tmp = tmp_path_factory.mktemp("tp_compose")
    trees = {name: jtf.init_params(jax.random.PRNGKey(0), jax_cfg(cfg))
             for name, cfg in (("base", BASE), ("spec", SPEC),
                               ("prefix", PREFIX))}
    for name, tree in trees.items():
        np.savez(tmp / f"{name}.npz",
                 **flat(jax.tree_util.tree_map(np.asarray, tree)))

    def case(name, cfg, params, server, requests):
        return {"name": name, "kind": "server", "config": cfg, "plan": TP2,
                "params": str(tmp / f"{params}.npz"), "server": server,
                "requests": requests}

    cases = [
        case("beam", BASE, "base", {"max_len": 64}, BEAMS),
        case("spec", SPEC, "spec", SPEC_SERVER, SPEC_BODIES),
        case("prefix", PREFIX, "prefix", PREFIX_SERVER, PREFIX_BODIES),
        case("spill", BASE, "base", SPILL_SERVER, SPILL_BODIES),
    ]
    procs, out = start_world(tmp, cases, WORLD)
    try:
        refs = {"jax": trees}
        params = {name: bridge.params_from_jax(
            jax.tree_util.tree_map(np.asarray, tree), "cpu")
            for name, tree in trees.items()}
        cfgs = {"base": BASE, "spec": SPEC, "prefix": PREFIX}
        for name, server, bodies in (
                ("spec", SPEC_SERVER, SPEC_BODIES),
                ("prefix", PREFIX_SERVER, PREFIX_BODIES),
                ("spill", SPILL_SERVER, SPILL_BODIES)):
            tree = "base" if name == "spill" else name
            refs[f"one_rank_{name}"] = serve_one(InferenceServer(
                torch_cfg(cfgs[tree]), params[tree], "127.0.0.1", 0,
                device="cpu", **server), bodies)
        refs["reference_prefix"] = serve_one(JaxServer(
            jax_cfg(PREFIX), trees["prefix"], "127.0.0.1", 0,
            **PREFIX_SERVER), PREFIX_BODIES)
    finally:
        finish_world(procs)
    return out, refs


def jax_greedy(tree, cfg, row, new, max_len):
    return np.asarray(jdecode.generate(
        tree, jnp.asarray([row], jnp.int32), jax_cfg(cfg), new,
        max_len))[0].tolist()


def front(out, name):
    """Rank 0's answers and /v1/model; every rank's digest, op count and
    watched state agree."""
    ranks = results(out, name, WORLD)
    info = ranks[0]["info"]
    lockstep = info["lockstep"]
    assert lockstep["agree"] and len(lockstep["ranks"]) == WORLD
    assert info["mesh"] == {"data": 1, "model": 2}
    return ranks[0]["answers"], info


def test_beams_over_ranks_equal_jax_beam_search(world):
    """:2728 / :2647 on a tp2 mesh: a beam request is one lockstep op,
    every rank's beam_search on its blocks; width 1 equals greedy, and
    each width's tokens equal the reference's beam_search on the whole
    params (the reference server's beam strategy)."""
    out, refs = world
    answers, _info = front(out, "beam")
    tree = refs["jax"]["base"]
    prompt = jnp.asarray([[1, 2, 3]], jnp.int32)
    greedy = jax_greedy(tree, BASE, [1, 2, 3], 6, 64)
    assert answers[0] == [200, {"tokens": [greedy]}]
    assert answers[1] == [200, {"tokens": [greedy]}]
    for (status, got), body in zip(answers[2:], BEAMS[2:]):
        want, _score = jbeam.beam_search(
            tree, prompt, jax_cfg(BASE), 6, 64,
            beam_width=body["beam_width"],
            length_penalty=body.get("length_penalty", 0.0))
        assert status == 200
        assert got["tokens"] == [np.asarray(want).tolist()]


def test_speculative_engine_over_ranks_equals_greedy(world):
    """:1355 and test_torch_speculative.py :180 on a tp2 mesh: greedy
    single rows ride the speculative engine (its verbs ``spec.*`` ops
    beside the slot engine's), whose output is the reference's greedy
    decode; its dispatches and tokens (admissions and draft-and-verify
    rounds) equal the one-rank port server's."""
    out, refs = world
    answers, info = front(out, "spec")
    for (status, got), body in zip(answers, SPEC_BODIES):
        row = body["tokens"][0]
        assert status == 200
        assert got["tokens"] == [jax_greedy(refs["jax"]["spec"], SPEC, row,
                                            body["max_new_tokens"], 64)]
    one_answers, one_info = refs["one_rank_spec"]
    assert one_answers == [g["tokens"] for _s, g in answers]
    engine = info["speculative"]["engine"]
    assert engine["dispatches"] == one_info["speculative"]["engine"][
        "dispatches"] > 2 * len(SPEC_BODIES)
    assert engine["tokens_out"] == one_info["speculative"]["engine"][
        "tokens_out"]
    assert info["speculative"]["draft_layers"] == 1


def test_prefix_cache_over_ranks_counts_as_the_reference(world):
    """:2457 on a tp2 mesh: a prefix-path request is one lockstep op on
    every rank's own cache; greedy rows equal the reference's generate,
    the sampled hit the one-rank port server's (the same keys),
    and hits, misses and tokens reused equal the reference server's
    for the same requests; the LRU holds 2 entries on every rank (their
    keys agree)."""
    out, refs = world
    answers, info = front(out, "prefix")
    tree = refs["jax"]["prefix"]
    for i in (0, 1, 3):
        row = PREFIX_BODIES[i]["tokens"][0]
        assert answers[i] == [200, {"tokens": [jax_greedy(
            tree, PREFIX, row, 8, 128)]}]
    one_answers, _one_info = refs["one_rank_prefix"]
    assert answers[2] == [200, {"tokens": one_answers[2]}]
    _ref_answers, ref_info = refs["reference_prefix"]
    for key in ("hits", "misses", "tokens_reused"):
        assert info["prefix_cache"][key] == ref_info["prefix_cache"][key]
    assert info["prefix_cache"]["hits"] >= 2
    assert info["prefix_cache"].keys() == ref_info["prefix_cache"].keys()
    prefixes = {r["prefix"] for r in info["lockstep"]["ranks"]}
    assert len(prefixes) == 1


def test_spill_tier_over_ranks_counts_a_ranks_bytes(world):
    """test_kvtier.py :187 / :341 and test_slots.py :668 on a tp2 mesh:
    slot admissions store every rank's KV blocks under one key; the
    1-entry LRU spills A when B arrives and readmits it on A's repeat.
    Spilled and readmitted equal the one-rank port server's, and
    spill_bytes counts a rank's bytes (the --kv-spill-mb budget is a
    rank's): its half of the kv heads, plus the entry's 4-byte pos. The
    readmitted row's tokens equal the reference's greedy decode."""
    out, refs = world
    answers, info = front(out, "spill")
    for (status, got), body in zip(answers, SPILL_BODIES):
        row = body["tokens"][0]
        assert status == 200
        assert got["tokens"] == [jax_greedy(refs["jax"]["base"], BASE, row,
                                            6, 64)]
    _one_answers, one_info = refs["one_rank_spill"]
    pc, one = info["prefix_cache"], one_info["prefix_cache"]
    assert pc["spilled"] == one["spilled"] >= 2
    assert pc["readmitted"] == one["readmitted"] == 1
    assert pc["hits"] == one["hits"] and pc["misses"] == one["misses"]
    entries = info["kv_spill"]["entries"]
    assert entries == one_info["kv_spill"]["entries"] >= 1
    # float32 k and v of one max_len row: 2 * 64 * 2 heads * 16 * 4 bytes
    kv_whole = 2 * 64 * 2 * 16 * 4
    assert one["spill_bytes"] == entries * (kv_whole + 4)
    assert pc["spill_bytes"] == entries * (kv_whole // WORLD + 4)
    prefixes = {r["prefix"] for r in info["lockstep"]["ranks"]}
    assert len(prefixes) == 1


# -- model 4, replicated GQA kv heads, every composition at once -----------

WORLD4 = 4
GQA = dict(vocab_size=64, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
           d_ff=128, max_seq_len=64, dtype="float32")
GQA_SERVER = {"max_len": 64, "slots": 2, "slot_chunk": 4,
              "prefix_cache_entries": 1, "kv_spill_bytes": 1 << 20,
              "draft_layers": 1, "speculate": 3}
ROW_G = [3, 1, 4, 1, 5, 9, 2, 6]
ROW_A4 = [(i * 3 + 1) % 64 for i in range(20)]
ROW_B4 = [(i * 11 + 5) % 64 for i in range(20)]
ROW_C4 = [(i * 13 + 7) % 64 for i in range(20)]
SAMPLED = {"temperature": 0.8, "seed": 4}


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """The 4-rank GQA pod's answers; a one-rank torch replica (its entry
    of ROW_C4 prefilled before the world starts) runs beside it."""
    tmp = tmp_path_factory.mktemp("tp_compose4")
    jp = jtf.init_params(jax.random.PRNGKey(0), jax_cfg(GQA))
    np.savez(tmp / "gqa.npz", **flat(jax.tree_util.tree_map(np.asarray, jp)))
    params = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                    "cpu")
    one = InferenceServer(torch_cfg(GQA), params, "127.0.0.1", 0,
                          device="cpu", **{**GQA_SERVER, "draft_layers": 0})
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    def call(coro):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(120)

    call(one.run())
    try:
        assert _post(one.port, "/v1/prefill", {"tokens": [ROW_C4]})["cached"]
        requests = [
            {"tokens": [ROW_G], "max_new_tokens": 10},
            {"method": "POST", "path": "/v1/prefill",
             "body": {"tokens": [ROW_A4]}},
            {"method": "POST", "path": "/v1/kv", "raw": True,
             "body": {"tokens": [ROW_A4]}},
            {"tokens": [ROW_B4], "max_new_tokens": 6, **SAMPLED},
            {"method": "POST", "path": "/v1/kv/pull", "body": {
                "tokens": [ROW_C4], "from": f"127.0.0.1:{one.port}"}},
            {"tokens": [ROW_C4], "max_new_tokens": 6, **SAMPLED},
        ]
        procs, out = start_world(tmp, [{
            "name": "gqa", "kind": "server", "config": GQA,
            "plan": dict(data=1, model=4), "params": str(tmp / "gqa.npz"),
            "server": GQA_SERVER, "requests": requests}], WORLD4)
        finish_world(procs)
    finally:
        call(one.stop())
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=10)
    return results(out, "gqa", WORLD4)[0], jp, params


def test_gqa_model4_pod_serves_every_composition(world4):
    """On model 4 with 2 replicated kv heads: a greedy row through the
    speculative engine equals the reference's generate; sampled slot
    admissions equal the one-rank port's solo generate; B's admission
    spills A (1-entry LRU), and C, pulled whole from a one-rank replica
    into every rank's spill tier (each keeping the kv of its query
    heads), readmits once; every rank's tokens and cache keys agree."""
    front, jp, params = world4
    answers, info = front["answers"], front["info"]
    assert info["mesh"] == {"data": 1, "model": 4}
    lockstep = info["lockstep"]
    assert lockstep["agree"] and len(lockstep["ranks"]) == WORLD4
    assert len({r["prefix"] for r in lockstep["ranks"]}) == 1
    assert answers[0] == [200, {"tokens": [jax_greedy(jp, GQA, ROW_G, 10,
                                                      64)]}]
    cfg = torch_cfg(GQA)
    for i, row in ((3, ROW_B4), (5, ROW_C4)):
        solo = tdecode.generate(params, torch_rows([row]), cfg, 6, 64,
                                temperature=0.8, rng=4)
        assert answers[i] == [200, {"tokens": solo.tolist()}]
    assert answers[1][0] == 200 and answers[1][1]["cached"]
    assert answers[4][0] == 200 and answers[4][1]["ok"]
    pc = info["prefix_cache"]
    assert pc["readmitted"] == 1 and pc["spilled"] >= 1
    # the warm-up's request (speculate + 2 tokens), then ROW_G's 10
    assert info["speculative"]["engine"]["tokens_out"] == 3 + 2 + 10


def test_gqa_model4_entry_sends_each_kv_head_once(world4):
    """The pod's /v1/kv entry of a prompt is the one-rank entry: its 2 kv
    heads, each sent once (gathered over model 4 from the ranks' repeated
    kv), within 1e-5 of max|ref| of the reference's prefill (float32)."""
    front, jp, _params = world4
    status, hexed = front["answers"][2]
    assert status == 200
    raw = bytes.fromhex(hexed)
    n = int.from_bytes(raw[:8], "big")
    manifest = json.loads(raw[8:8 + n])
    chunks, at = [], 8 + n
    for spec in manifest["chunks"]:
        chunks.append(raw[at:at + spec["len"]])
        at += spec["len"]
    entry = handoff.rebuild_kv(manifest, chunks)
    _logits, ref = jdecode.prefill(
        jp, jnp.asarray([ROW_A4], jnp.int32), jax_cfg(GQA), 64)
    assert entry["pos"] == len(ROW_A4)
    for name in ("k", "v"):
        want = np.asarray(ref[name])
        assert tuple(entry[name].shape) == want.shape  # 2 kv heads
        got = entry[name].numpy()
        # float32 on both sides: summation order only
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def torch_rows(rows):
    import torch

    return torch.tensor(rows, dtype=torch.int64)

"""The port's slot engine (models/slots.py, models/stepprog.py,
workload/serve_slots.py) on the CPU, on params bridged from JAX, at the
reference tests' tiny config: per-request parity with the port's solo
``generate`` (greedy and sampled), staggered admission, eos trim, more
requests than slots, validation, recovery from a failed dispatch,
chunked admission, min_new, penalties, stream deltas, cancel, and the
server over HTTP; a window's ring pools and the int8 KV pool.
Cross-package: greedy and seeded sampled tokens equal the JAX
``SlotEngine``'s on the same staggered requests, and JAX ``generate``'s
on a windowed config. Mirrors
tests/test_slots.py (without its streaming-server, cp and tp cases;
streaming is tests/test_torch_stream.py)."""
import asyncio
import dataclasses
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from containerpilot_tpu.models import decode as jdecode
from containerpilot_tpu.models import transformer as jtf
from containerpilot_tpu.workload.serve_slots import SlotEngine as JaxSlotEngine
from containerpilot_tpu_torch import bridge
from containerpilot_tpu_torch.models import decode as tdecode
from containerpilot_tpu_torch.models import stepprog
from containerpilot_tpu_torch.models import transformer as ttf
from containerpilot_tpu_torch.workload.serve import InferenceServer
from containerpilot_tpu_torch.workload.serve_prefix import PrefixCache
from containerpilot_tpu_torch.workload.serve_slots import SlotEngine

BASE = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=1, d_ff=64,
            max_seq_len=64, dtype="float32")
CFG = ttf.TransformerConfig(**bridge.config_kwargs(BASE))
MAX_LEN = 48
WAIT = 120  # seconds any future may take


@pytest.fixture(scope="module")
def jax_params():
    jcfg = jtf.TransformerConfig(**{**BASE, "dtype": jnp.float32})
    return jcfg, jtf.init_params(jax.random.PRNGKey(0), jcfg)


@pytest.fixture(scope="module")
def params(jax_params):
    return bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jax_params[1]), "cpu"
    )


@pytest.fixture()
def engine(params):
    eng = SlotEngine(CFG, params, MAX_LEN, slots=2, chunk=3)
    yield eng
    eng.stop()


def solo(params, tokens, max_new, cfg=CFG, **kw):
    """The port's solo generate with the server's seed convention (row 0
    of ``seed``), trimmed the way the server trims (keep eos, drop the
    pads after it)."""
    seed = kw.pop("seed", 0)
    eos = kw.pop("eos_id", -1)
    out = tdecode.generate(
        params, torch.tensor([tokens]), cfg, max_new, MAX_LEN, rng=seed,
        eos_id=eos, **kw,
    )
    row = out[0].tolist()
    if eos >= 0 and eos in row:
        row = row[: row.index(eos) + 1]
    return row


def test_single_request_matches_generate_greedy(params, engine):
    tokens = [1, 2, 3, 4]
    got = engine.submit(tokens, max_new=7).result(timeout=WAIT)
    assert got == solo(params, tokens, 7)


def test_single_request_matches_generate_sampled(params, engine):
    tokens = [5, 6, 7]
    kw = dict(temperature=0.9, top_k=12, top_p=0.8, seed=11)
    got = engine.submit(tokens, max_new=9, **kw).result(timeout=WAIT)
    assert got == solo(params, tokens, 9, **kw)


def test_staggered_admission_is_isolated(params, engine):
    """A request admitted mid-flight (other prompt, other sampling,
    later chunk) changes nothing for either row."""
    a = engine.submit([1, 2, 3, 4, 5], max_new=12, temperature=0.7, seed=3)
    b = engine.submit([9, 8], max_new=5)
    assert a.result(timeout=WAIT) == solo(
        params, [1, 2, 3, 4, 5], 12, temperature=0.7, seed=3
    )
    assert b.result(timeout=WAIT) == solo(params, [9, 8], 5)


def test_eos_trims_like_generate(params, engine):
    tokens = [2, 4, 6]
    free = solo(params, tokens, 6)
    eos = free[1]
    got = engine.submit(tokens, max_new=6, eos_id=eos).result(timeout=WAIT)
    assert got == solo(params, tokens, 6, eos_id=eos)
    assert got[-1] == eos and len(got) == free.index(eos) + 1


def test_more_requests_than_slots_all_complete(params, engine):
    prompts = [[i + 1, i + 2] for i in range(5)]  # 5 requests, 2 slots
    futs = [
        engine.submit(p, max_new=4, seed=i, temperature=0.5 * (i % 2))
        for i, p in enumerate(prompts)
    ]
    for i, (p, f) in enumerate(zip(prompts, futs)):
        assert f.result(timeout=WAIT) == solo(
            params, p, 4, seed=i, temperature=0.5 * (i % 2)
        )


def test_submit_validation(engine):
    with pytest.raises(ValueError, match="prompt"):
        engine.submit([], max_new=4)
    with pytest.raises(ValueError, match="exceeds"):
        engine.submit([1] * 40, max_new=20)
    with pytest.raises(ValueError, match="max_new"):
        engine.submit([1, 2], max_new=0)
    with pytest.raises(ValueError, match="logit_bias"):
        engine.submit([1, 2], max_new=2, logit_bias={999: 1.0})


def test_chunk_failure_recovers_pool(params, monkeypatch):
    """A failed dispatch fails the in-flight request once; the program
    is reset to the empty state and the next request serves normally."""
    eng = SlotEngine(CFG, params, MAX_LEN, slots=2, chunk=2)
    try:
        original = stepprog.gated_round
        calls = {"n": 0}

        def boom(params_, pool, state, *args):
            calls["n"] += 1
            if calls["n"] == 1:
                pool["k"].fill_(float("nan"))  # a half-done round
                state["done"].fill_(False)
                raise RuntimeError("injected chunk failure")
            return original(params_, pool, state, *args)

        monkeypatch.setattr(stepprog, "gated_round", boom)
        failed = eng.submit([1, 2, 3], max_new=5)
        with pytest.raises(RuntimeError, match="injected"):
            failed.result(timeout=WAIT)
        ok = eng.submit([1, 2, 3], max_new=5)
        assert ok.result(timeout=WAIT) == solo(params, [1, 2, 3], 5)
    finally:
        eng.stop()


def test_chunked_admission_matches_generate(params):
    """--prefill-chunk composes with the pool: admissions longer than the
    chunk prefill in pieces and still match solo generate; short prompts
    skip the pieces; a chunk-admitted slot is reused."""
    eng = SlotEngine(CFG, params, MAX_LEN, slots=2, chunk=3,
                     prefill_chunk=4)
    try:
        long_p = [(i * 3 + 1) % 64 for i in range(11)]
        got = eng.submit(long_p, max_new=7).result(timeout=WAIT)
        assert got == solo(params, long_p, 7)
        got = eng.submit([5, 6], max_new=5).result(timeout=WAIT)
        assert got == solo(params, [5, 6], 5)
        kw = dict(temperature=0.9, top_k=12, seed=11)
        got = eng.submit(long_p, max_new=6, **kw).result(timeout=WAIT)
        assert got == solo(params, long_p, 6, **kw)
    finally:
        eng.stop()


def test_stats_and_stop(params):
    eng = SlotEngine(CFG, params, MAX_LEN, slots=3, chunk=2)
    stats = eng.stats
    assert stats["slots"] == 3 and stats["chunk"] == 2
    assert eng.submit([1, 2], max_new=9).result(timeout=WAIT)
    assert eng.round_times_ms() and eng.round_host_ms()
    eng.stop()
    with pytest.raises(RuntimeError):
        eng.submit([1, 2], max_new=3)


def test_engine_refuses_what_is_not_ported(params):
    # cp_mesh is ported: a mesh without a seq axis is refused with the
    # reference server's message
    from containerpilot_tpu_torch.parallel.mesh import MeshPlan, make_mesh

    no_seq = make_mesh(MeshPlan(data=2, model=1), world_size=2, rank=0)
    with pytest.raises(ValueError, match="needs a seq axis"):
        SlotEngine(CFG, params, MAX_LEN, slots=1, chunk=2, cp_mesh=no_seq)
    # the device-time ledger is ported: accepted, and an idle engine
    # never cuts the server's boot stage short (its stamps are held in
    # tests/test_torch_telemetry.py)
    from containerpilot_tpu_torch.telemetry.goodput import DeviceTimeLedger

    ledger = DeviceTimeLedger()
    SlotEngine(CFG, params, MAX_LEN, slots=1, chunk=2, ledger=ledger).stop()
    assert ledger.stage == "boot" and ledger.transitions == 0
    with pytest.raises(ValueError, match="prefill_chunk"):
        SlotEngine(CFG, params, MAX_LEN, slots=1, chunk=2, prefill_chunk=-1)


def test_stream_deltas_concatenate_to_result(params, engine):
    deltas = []
    got = engine.submit(
        [1, 2, 3], max_new=8, temperature=0.7, seed=11,
        on_tokens=deltas.append,
    ).result(timeout=WAIT)
    assert sum(deltas, []) == got
    assert got == solo(params, [1, 2, 3], 8, temperature=0.7, seed=11)
    # the first delta is the admission sample
    assert len(deltas) >= 2 and len(deltas[0]) == 1


def test_cancel_frees_slot_mid_generation(params, engine):
    cancel = threading.Event()
    first = threading.Event()

    def on_tokens(_delta):
        first.set()

    max_new = MAX_LEN - 3
    fut = engine.submit([5, 6, 7], max_new=max_new, on_tokens=on_tokens,
                        cancel=cancel)
    assert first.wait(timeout=WAIT), "no first token"
    cancel.set()
    got = fut.result(timeout=WAIT)
    assert 0 < len(got) < max_new
    deadline = time.monotonic() + 30
    while engine.stats["active"]:
        assert time.monotonic() < deadline
        time.sleep(0.05)
    after = engine.submit([1, 2, 3, 4], max_new=7).result(timeout=WAIT)
    assert after == solo(params, [1, 2, 3, 4], 7)


def test_min_new_matches_generate(params, engine):
    tokens = [2, 4, 6]
    free = solo(params, tokens, 6)
    eos = free[1]
    got = engine.submit(tokens, max_new=6, eos_id=eos,
                        min_new=4).result(timeout=WAIT)
    assert got == solo(params, tokens, 6, eos_id=eos, min_new_tokens=4)
    assert eos not in got[:4]
    with pytest.raises(ValueError, match="min_new"):
        engine.submit(tokens, max_new=4, min_new=5)


def test_penalties_and_logit_bias_match_generate(params, engine):
    tokens = [1, 2, 3]
    kw = dict(frequency_penalty=50.0, temperature=0.7, seed=8)
    got = engine.submit(tokens, max_new=8, **kw).result(timeout=WAIT)
    assert got == solo(params, tokens, 8, temperature=0.7, seed=8,
                       frequency_penalty=50.0)
    assert len(set(got)) == len(got)
    bias = {3: 5.0, 9: -100.0}
    got = engine.submit(tokens, max_new=8, presence_penalty=0.5,
                        logit_bias=bias).result(timeout=WAIT)
    assert got == solo(params, tokens, 8, presence_penalty=0.5,
                       logit_bias=bias)


def test_greedy_tokens_match_jax_slot_engine(params, jax_params):
    """Cross-package: the same staggered greedy requests through the
    port's engine and the JAX engine give the same tokens."""
    jcfg, jparams = jax_params
    reqs = [([1, 2, 3, 4, 5], 12), ([9, 8], 5), ([7, 7, 7], 9),
            ([4, 3, 2, 1], 7)]
    results = {}
    for name, make in (
        ("torch", lambda: SlotEngine(CFG, params, MAX_LEN, slots=2,
                                     chunk=3)),
        ("jax", lambda: JaxSlotEngine(jcfg, jparams, MAX_LEN, slots=2,
                                      chunk=3)),
    ):
        eng = make()
        try:
            futs = []
            for tokens, max_new in reqs:
                futs.append(eng.submit(tokens, max_new=max_new))
                time.sleep(0.01)  # staggered arrival
            results[name] = [f.result(timeout=WAIT) for f in futs]
        finally:
            eng.stop()
    assert results["torch"] == results["jax"]


def test_sampled_tokens_match_jax_slot_engine(params, jax_params):
    """Cross-package: staggered seeded sampled requests (temperature,
    top-k, top-p, a penalty, a seed past int32) through the port's engine
    and the JAX engine give the same tokens: both draw row 0 of the seed
    from fold_in(PRNGKey(seed), 0) and fold in each step."""
    from torch_draws import assert_same_tokens, teacher_forced_gap

    jcfg, jparams = jax_params
    reqs = [
        ([1, 2, 3, 4, 5], dict(max_new=12, temperature=0.9, top_k=12,
                               top_p=0.8, seed=11)),
        ([9, 8], dict(max_new=5, temperature=1.3, seed=2**31 + 7)),
        ([7, 7, 7], dict(max_new=9, temperature=0.7, seed=3,
                         frequency_penalty=0.5)),
        ([4, 3, 2, 1], dict(max_new=7, temperature=1.0, top_p=0.6,
                            seed=0)),
    ]
    results = {}
    for name, make in (
        ("torch", lambda: SlotEngine(CFG, params, MAX_LEN, slots=2,
                                     chunk=3)),
        ("jax", lambda: JaxSlotEngine(jcfg, jparams, MAX_LEN, slots=2,
                                      chunk=3)),
    ):
        eng = make()
        try:
            futs = []
            for tokens, kw in reqs:
                futs.append(eng.submit(tokens, **kw))
                time.sleep(0.01)  # staggered arrival
            results[name] = [f.result(timeout=WAIT) for f in futs]
        finally:
            eng.stop()

    def gap(r, i):
        tokens, kw = reqs[r]
        knobs = {k: kw[k] for k in ("temperature", "top_k", "top_p")
                 if k in kw}
        return teacher_forced_gap(params, CFG, tokens, results["jax"][r], i,
                                  tdecode.row_key(kw["seed"], 0), **knobs)

    assert_same_tokens(results["jax"], results["torch"], gap)


async def _http(port, method, path, body=None):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = json.dumps(body).encode() if body is not None else b""
    writer.write(
        f"{method} {path} HTTP/1.1\r\nHost: x\r\nConnection: close\r\n"
        f"Content-Length: {len(payload)}\r\n\r\n".encode() + payload
    )
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, data = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), data


def test_inference_server_slot_engine(run, params):
    """Concurrent single-row requests through --slots match solo
    answers; /v1/model reports the engine in the reference's schema."""
    reqs = [
        {"tokens": [[1, 2, 3]], "max_new_tokens": 6, "temperature": 0.8,
         "seed": 5},
        {"tokens": [[7, 8]], "max_new_tokens": 4},
        {"tokens": [[4, 5, 6, 7]], "max_new_tokens": 5, "seed": 2,
         "temperature": 0.5, "top_k": 10},
    ]

    async def scenario():
        server = InferenceServer(CFG, params, "127.0.0.1", 0, MAX_LEN,
                                 device="cpu", slots=2, slot_chunk=4)
        await server.run()
        try:
            assert server.ready and server.ready_at is not None
            outs = await asyncio.gather(*[
                _http(server.port, "POST", "/v1/generate", r) for r in reqs
            ])
            # two rows go to the batcher, not the engine
            multi = await _http(server.port, "POST", "/v1/generate", {
                "tokens": [[1, 2], [3, 4]], "max_new_tokens": 3})
            info = await _http(server.port, "GET", "/v1/model")
            return outs, multi, json.loads(info[1])
        finally:
            await server.stop()

    outs, multi, info = run(scenario(), timeout=WAIT)
    stats = dict(info["slot_engine"])
    assert stats.pop("dispatches") >= 1
    assert stats.pop("tokens_out") >= 1
    assert stats == {"slots": 2, "chunk": 4, "window": 4, "active": 0,
                     "queued": 0}
    assert info["prefix_cache"] is None and info["prefix_digest"] is None
    for (status, body), r in zip(outs, reqs):
        kw = {k: r[k] for k in ("temperature", "seed", "top_k") if k in r}
        assert status == 200
        assert json.loads(body)["tokens"][0] == solo(
            params, r["tokens"][0], r["max_new_tokens"], **kw)
    assert multi[0] == 200 and json.loads(multi[1])["tokens"] == [
        solo(params, [1, 2], 3), solo(params, [3, 4], 3)]


def test_slots_reject_max_len_too_small_for_warmup(params):
    with pytest.raises(ValueError, match="max_len >= slot_chunk"):
        InferenceServer(CFG, params, "127.0.0.1", 0, 8, device="cpu",
                        slots=2, slot_chunk=8)
    with pytest.raises(ValueError, match="slot_window"):
        InferenceServer(CFG, params, "127.0.0.1", 0, MAX_LEN, device="cpu",
                        slots=2, slot_window=0)
    with pytest.raises(ValueError, match="prefill_chunk"):
        InferenceServer(CFG, params, "127.0.0.1", 0, MAX_LEN, device="cpu",
                        prefill_chunk=-1)
    # the boundary itself is fine: 4 + chunk + 1 == max_len
    server = InferenceServer(CFG, params, "127.0.0.1", 0, 9, device="cpu",
                             slots=1, slot_chunk=4)
    server.slot_engine.stop()


def test_gqa_pool_matches_generate():
    """Grouped kv heads in the head-major pool: query head j reads kv
    head j // group, as solo generate's decode does."""
    cfg = ttf.TransformerConfig(vocab_size=64, d_model=64, n_heads=4,
                                n_kv_heads=2, n_layers=2, d_ff=64,
                                dtype=torch.float32)
    params = ttf.init_params(3, cfg, device="cpu")
    eng = SlotEngine(cfg, params, MAX_LEN, slots=3, chunk=2, window=2)
    try:
        futs = [eng.submit([1, 2, 3], max_new=9),
                eng.submit([4, 5, 6, 7, 8], max_new=7, temperature=0.8,
                           seed=2)]
        got = [f.result(timeout=WAIT) for f in futs]
    finally:
        eng.stop()
    assert got == [solo(params, [1, 2, 3], 9, cfg=cfg),
                   solo(params, [4, 5, 6, 7, 8], 7, cfg=cfg,
                        temperature=0.8, seed=2)]


def test_concurrent_submitters_each_get_their_own_tokens(params, engine):
    """More submitting threads than slots (and cores), with a short
    switch interval: every future resolves to its own request's solo
    tokens, none is lost or swapped."""
    import sys

    reqs = [([(i * 5 + j) % 64 for j in range(2 + i % 4)],
             dict(max_new=3 + i % 5, seed=i, temperature=0.6 * (i % 2)))
            for i in range(12)]
    futs = [None] * len(reqs)

    def submit(i):
        tokens, kw = reqs[i]
        futs[i] = engine.submit(tokens, **kw)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=submit, args=(i,))
                   for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
        assert not any(t.is_alive() for t in threads)
        got = [f.result(timeout=WAIT) for f in futs]
    finally:
        sys.setswitchinterval(old)
    for (tokens, kw), out in zip(reqs, got):
        kw = dict(kw)
        assert out == solo(params, tokens, kw.pop("max_new"), **kw)


@pytest.fixture(scope="module")
def window_setup(params):
    """A sliding-window engine (ring pools) over the same params: the
    solo reference runs the same windowed config's ring cache."""
    cfg = dataclasses.replace(CFG, window=8)
    eng = SlotEngine(cfg, params, MAX_LEN, slots=2, chunk=3)
    yield cfg, eng
    eng.stop()


def test_window_long_prompt_and_decode_cross_the_ring(params, jax_params,
                                                      window_setup):
    """A prompt longer than the window and a decode past the wrap point:
    every ring write of the pool matches solo generate, and the greedy
    tokens equal JAX generate's on the windowed config
    (tests/test_slots.py:169)."""
    cfg, eng = window_setup
    tokens = list(range(1, 13))  # 12 > window 8
    got = eng.submit(tokens, max_new=9).result(timeout=WAIT)
    assert got == solo(params, tokens, 9, cfg=cfg)
    jcfg = dataclasses.replace(jax_params[0], window=8)
    ref = jdecode.generate(jax_params[1], jnp.asarray([tokens], jnp.int32),
                           jcfg, max_new_tokens=9, max_len=MAX_LEN)
    assert got == np.asarray(ref)[0].tolist()


def test_window_slot_reuse_carries_no_stale_context(params, window_setup):
    """A freed ring slot's rows are not zeroed: re-admission must
    overwrite the row wholesale (insert_row) so nothing of the previous
    occupant survives. Fill both slots, finish them, then reuse them
    with fresh prompts (tests/test_slots.py:178)."""
    cfg, eng = window_setup
    first = [
        eng.submit([1, 2, 3, 4, 5, 6, 7, 8, 9], max_new=6, seed=1),
        eng.submit([9, 8, 7], max_new=6, seed=2),
    ]
    for fut in first:
        fut.result(timeout=WAIT)
    reused = [
        ([5, 4, 3, 2], dict(max_new=10, seed=7)),
        ([2, 2], dict(max_new=10, temperature=0.8, top_k=16, seed=4)),
    ]
    futs = [eng.submit(p, **kw) for p, kw in reused]
    for (p, kw), fut in zip(reused, futs):
        kw = dict(kw)
        assert fut.result(timeout=WAIT) == solo(
            params, p, kw.pop("max_new"), cfg=cfg, **kw)


def test_prefix_cache_refuses_window(params):
    """A ring cache's stale rows are live window context, so the prefix
    cache refuses a window at construction, in the engine and in the
    server (tests/test_slots.py:703)."""
    win_cfg = dataclasses.replace(CFG, window=8)
    with pytest.raises(ValueError, match="window"):
        SlotEngine(win_cfg, params, MAX_LEN, slots=2, chunk=3,
                   prefix_cache=PrefixCache(2))
    with pytest.raises(ValueError, match="--prefix-cache does not compose"):
        InferenceServer(win_cfg, params, "127.0.0.1", 0, MAX_LEN,
                        device="cpu", slots=2, prefix_cache_entries=2)


@pytest.mark.parametrize("over", [
    {"kv_int8": True},
    {"kv_int8": True, "window": 8},
    {"kv_int8": True, "n_heads": 4, "n_kv_heads": 2},
])
def test_kv_int8_pool_tokens_equal_solo_generate(over):
    """The int8 KV pool (int8 k/v, float32 scales, quantized on write):
    staggered requests, one sampled, one past a window's ring and one
    through chunked admission, equal solo generate's tokens on the same
    config."""
    cfg = ttf.TransformerConfig(**{**bridge.config_kwargs(BASE), **over})
    params = ttf.init_params(5, cfg, device="cpu")
    eng = SlotEngine(cfg, params, MAX_LEN, slots=2, chunk=3,
                     prefill_chunk=5)
    try:
        pool = eng.program._pool
        assert pool["k"].dtype == torch.int8
        assert pool["k_scale"].shape == pool["k"].shape[:-1]
        reqs = [(list(range(3, 16)), dict(max_new=12)),
                ([4, 5], dict(max_new=9, temperature=0.8, seed=6)),
                ([7, 7, 7], dict(max_new=7))]
        futs = [eng.submit(p, **kw) for p, kw in reqs]
        got = [f.result(timeout=WAIT) for f in futs]
    finally:
        eng.stop()
    for (p, kw), out in zip(reqs, got):
        kw = dict(kw)
        assert out == solo(params, p, kw.pop("max_new"), cfg=cfg, **kw)

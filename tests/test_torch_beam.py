"""The port's beam search on the CPU (models/beam.py, serve_strategies.
run_beam and the server's beam handling), held against the JAX package:
width 1 equals greedy, a vocab-wide beam finds the brute-force optimum,
eos freezes beams, tokens equal JAX's ``beam_search`` exactly with the
score within 1e-5 relative (plain, length penalty and eos, int8
weights, the int8 KV cache, chunked prefill), and the server's route and
refusals. Mirrors tests/test_workload.py:2647, :2689 and :2728."""
import asyncio
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from containerpilot_tpu.models import beam as jbeam
from containerpilot_tpu.models import quantized as jquant
from containerpilot_tpu.models import transformer as jtf
from containerpilot_tpu_torch import bridge
from containerpilot_tpu_torch.models import beam as tbeam
from containerpilot_tpu_torch.models import decode as tdecode
from containerpilot_tpu_torch.models import transformer as ttf
from containerpilot_tpu_torch.workload.serve import InferenceServer

SCORE_RTOL = 1e-5


def _pair(seed=0, **over):
    base = {**dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2,
                   d_ff=64, max_seq_len=64, dtype="float32"), **over}
    jcfg = jtf.TransformerConfig(**{**base, "dtype": jnp.float32})
    tcfg = ttf.TransformerConfig(**bridge.config_kwargs(base))
    jp = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp


def _bridged(jp):
    return bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                  "cpu")


def test_beam_width1_equals_greedy_and_exhaustive_optimum():
    """beam_width=1 reproduces greedy generate exactly; a beam as wide
    as the vocab keeps every first token, so it finds the brute-force
    best pair of tokens, and its score is that pair's log-probability."""
    jcfg, cfg, jp = _pair(seed=3, vocab_size=8, max_seq_len=32,
                          flash_min_seq=0)
    tp = _bridged(jp)
    prompt = torch.tensor([[1, 2, 3]])
    greedy = tdecode.generate(tp, prompt, cfg, 4, 32)[0].tolist()
    b1, _ = tbeam.beam_search(tp, prompt, cfg, 4, 32, beam_width=1)
    assert b1.tolist() == greedy
    best, score = tbeam.beam_search(tp, prompt, cfg, 2, 32, beam_width=8)

    def seq_logprob(cont):
        toks = torch.tensor([[1, 2, 3, *cont]])
        with torch.no_grad():
            logp = torch.log_softmax(ttf.forward(tp, toks, cfg).float(), -1)
        return sum(float(logp[0, 2 + i, cont[i]]) for i in range(len(cont)))

    brute = max(((a, b) for a in range(8) for b in range(8)),
                key=seq_logprob)
    assert tuple(best.tolist()) == brute
    np.testing.assert_allclose(score, seq_logprob(brute), rtol=SCORE_RTOL)


CASES = {
    "width4": dict(beam_width=4),
    "penalty_eos": dict(beam_width=4, length_penalty=0.7, eos_id=7),
    "int8": dict(beam_width=4, int8=True),
    "kv_int8": dict(beam_width=3, kv_int8=True),
    "prefill_chunk": dict(beam_width=4, prefill_chunk=8),
    "moe": dict(beam_width=4, moe_experts=2),
    "moe_int8": dict(beam_width=3, moe_experts=4, int8=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_beam_tokens_and_score_equal_jax(case):
    """Same weights, same prompt: the port's best beam is JAX's, token
    for token, and the score agrees within 1e-5 relative."""
    kw = dict(CASES[case])
    int8 = kw.pop("int8", False)
    kv_int8 = kw.pop("kv_int8", False)
    moe = kw.pop("moe_experts", 0)
    jcfg, cfg, jp = _pair(kv_int8=kv_int8, moe_experts=moe)
    if int8:
        jp = jquant.quantize_model_params(jp)
    tp = _bridged(jp)
    prompt = np.random.default_rng(1).integers(0, 64, (1, 13)).tolist()
    want, want_score = jbeam.beam_search(
        jp, jnp.asarray(prompt, jnp.int32), jcfg, 12, 40, **kw)
    got, score = tbeam.beam_search(tp, torch.tensor(prompt), cfg, 12, 40,
                                   **kw)
    assert got.tolist() == np.asarray(want).tolist()
    np.testing.assert_allclose(score, want_score, rtol=SCORE_RTOL)


def test_beam_eos_and_validation():
    """A finished beam freezes (pad after eos); bad arguments raise with
    the reference's wording."""
    _jcfg, cfg, jp = _pair(vocab_size=16, n_layers=1)
    tp = _bridged(jp)
    prompt = torch.tensor([[1, 2]])
    greedy = tdecode.generate(tp, prompt, cfg, 6, 32)[0].tolist()
    eos = greedy[1]
    toks, _ = tbeam.beam_search(tp, prompt, cfg, 6, 32, beam_width=1,
                                eos_id=eos, pad_id=0)
    toks = toks.tolist()
    after = toks[toks.index(eos) + 1:]
    assert len(after) >= 4 and all(t == 0 for t in after), toks
    with pytest.raises(ValueError, match="beam_width"):
        tbeam.beam_search(tp, prompt, cfg, 4, 32, beam_width=0)
    with pytest.raises(ValueError, match="one prompt"):
        tbeam.beam_search(tp, torch.ones((2, 3), dtype=torch.int64), cfg,
                          4, 32)
    with pytest.raises(ValueError, match="sliding-window"):
        tbeam.beam_search(tp, prompt, dataclasses.replace(cfg, window=8),
                          4, 32)
    with pytest.raises(ValueError, match="pad_id"):
        tbeam.beam_search(tp, prompt, cfg, 4, 32, pad_id=16)
    with pytest.raises(ValueError, match="exceeds max_len"):
        tbeam.beam_search(tp, prompt, cfg, 31, 32)


async def _post(port, body):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = json.dumps(body).encode()
    writer.write(
        f"POST /v1/generate HTTP/1.1\r\nHost: x\r\nConnection: close\r\n"
        f"Content-Length: {len(payload)}\r\n\r\n".encode() + payload)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, data = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), data


REFUSALS = [
    ({"temperature": 0.7}, "beam search is deterministic"),
    ({"top_k": 5}, "beam search is deterministic"),
    ({"n": 2}, "n does not compose with beam search"),
    ({"logit_bias": {"3": 1.0}}, "logit_bias does not apply to beam search"),
    ({"presence_penalty": 0.5}, "penalties do not apply to beam search"),
    ({"min_new_tokens": 2}, "min_new_tokens does not apply to beam search"),
    ({"beam_width": 5}, "beam_width capped at --max-batch-rows (4)"),
    ({"tokens": [[1, 2], [3, 4]]}, "one prompt at a time"),
    ({"top_p": 0.9}, "beam search is deterministic"),
]


def test_server_beam_route_and_refusals(run):
    """/v1/generate with beam_width: width 1 equals the greedy request,
    width 4 equals JAX's beam_search (deterministic on repeat) and goes
    through the Batcher's counters; every incompatible knob is a 422
    with the reference's message, and so is a windowed server's beam."""
    jcfg, cfg, jp = _pair()
    tp = _bridged(jp)
    prompt = [1, 2, 3]
    want4 = np.asarray(jbeam.beam_search(
        jp, jnp.asarray([prompt], jnp.int32), jcfg, 6, 64, beam_width=4,
    )[0]).tolist()

    async def scenario():
        server = InferenceServer(cfg, tp, "127.0.0.1", 0, 64,
                                 max_batch_rows=4, device="cpu")
        windowed = InferenceServer(dataclasses.replace(cfg, window=16), tp,
                                   "127.0.0.1", 0, 64, device="cpu")
        await server.run()
        await windowed.run()
        try:
            base = {"tokens": [prompt], "max_new_tokens": 6}
            greedy = await _post(server.port, base)
            calls = server.batch_stats["calls"]
            b1 = await _post(server.port, {**base, "beam_width": 1})
            b4 = await _post(server.port, {**base, "beam_width": 4})
            b4b = await _post(server.port, {**base, "beam_width": 4})
            calls = server.batch_stats["calls"] - calls
            refused = [await _post(server.port,
                                   {**base, "beam_width": 2, **body})
                       for body, _ in REFUSALS]
            win = await _post(windowed.port, {**base, "beam_width": 2})
            return greedy, b1, b4, b4b, calls, refused, win
        finally:
            await server.stop()
            await windowed.stop()

    greedy, b1, b4, b4b, calls, refused, win = run(scenario(), timeout=120)
    assert greedy[0] == b1[0] == b4[0] == 200
    assert json.loads(b1[1]) == json.loads(greedy[1])
    assert json.loads(b4[1]) == {"tokens": [want4]} and b4 == b4b
    assert calls == 3
    for (status, data), (body, match) in zip(refused, REFUSALS):
        assert status == 422 and match in data.decode(), (body, data)
    assert win[0] == 422 and b"sliding-window" in win[1]

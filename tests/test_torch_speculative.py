"""The port's self-speculative decoding on the CPU (models/speculative.py,
the SpeculativeStepProgram under the slot engine, and the server's
--draft-layers route), held against the JAX package: tokens equal greedy
``generate`` and JAX's ``speculative_generate`` exactly, and so do the
stats (plain, int8 weights, the int8 KV cache, where rejected rounds
leave stale rows and scales past the rewound frontier); the step program
through the engine emits what the standalone loop emits with honest
dispatch counts; windows and bad shapes are refused. Mirrors
tests/test_workload.py:1108 and :1355, tests/test_stepprog.py:326, :375
and :391, and the speculative case of tests/test_window.py:217."""
import asyncio
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from containerpilot_tpu.models import quantized as jquant
from containerpilot_tpu.models import speculative as jspec
from containerpilot_tpu.models import transformer as jtf
from containerpilot_tpu_torch import bridge
from containerpilot_tpu_torch.models import decode as tdecode
from containerpilot_tpu_torch.models import speculative as tspec
from containerpilot_tpu_torch.models import transformer as ttf
from containerpilot_tpu_torch.workload.serve import InferenceServer
from containerpilot_tpu_torch.workload.serve_slots import SlotEngine

MAX_LEN = 48
BASE = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=3, d_ff=64,
            max_seq_len=64, dtype="float32")


def _pair(int8=False, **over):
    base = {**BASE, **over}
    jcfg = jtf.TransformerConfig(**{**base, "dtype": jnp.float32})
    cfg = ttf.TransformerConfig(**bridge.config_kwargs(base))
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    if int8:
        jp = jquant.quantize_model_params(jp)
    tp = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                "cpu")
    return jcfg, cfg, jp, tp


@pytest.mark.parametrize("variant", ["plain", "int8", "kv_int8", "moe",
                                     "moe_int8"])
def test_speculative_equals_greedy_and_jax(variant):
    """Weak draft (1 layer) and perfect draft (the target itself): the
    tokens are greedy ``generate``'s and JAX's, the stats JAX's, and the
    eos exit stops early with the same prefix. The MoE variants slice
    the router and experts like every other layer leaf."""
    jcfg, cfg, jp, tp = _pair(int8=variant.endswith("int8"),
                              kv_int8=variant == "kv_int8",
                              moe_experts=2 if "moe" in variant else 0)
    prompt = np.random.default_rng(1).integers(0, 64, (1, 5)).tolist()
    want = tdecode.generate(tp, torch.tensor(prompt), cfg, 20, 40).tolist()
    jdp, jdc = jspec.layer_prefix_draft(jp, jcfg, 1)
    tdp, tdc = tspec.layer_prefix_draft(tp, cfg, 1)
    for draft in ((jdp, jdc, tdp, tdc), (jp, jcfg, tp, cfg)):
        for eos in (-1, want[0][2]):
            jt, jstats = jspec.speculative_generate(
                jp, draft[0], jnp.asarray(prompt, jnp.int32), jcfg,
                draft[1], max_new_tokens=20, max_len=40, speculate=4,
                eos_id=eos)
            got, stats = tspec.speculative_generate(
                tp, draft[2], torch.tensor(prompt), cfg, draft[3],
                max_new_tokens=20, max_len=40, speculate=4, eos_id=eos)
            assert got.tolist() == np.asarray(jt).tolist(), (draft, eos)
            assert stats == jstats, (stats, jstats)
            row = got.tolist()[0]
            if eos < 0:
                assert row == want[0]
            else:
                cut = want[0].index(eos) + 1
                assert row[:cut] == want[0][:cut] and eos in row
                assert stats["tokens"] < 20
    # the perfect draft fully accepts: 19 tokens after prefill in
    # ceil(19 / 5) = 4 rounds of 4 drafts + the bonus token
    _, perfect = tspec.speculative_generate(
        tp, tp, torch.tensor(prompt), cfg, cfg, 20, 40, speculate=4)
    assert perfect["rounds"] == 4 and perfect["accepted_drafts"] == 16
    with pytest.raises(ValueError, match="batch 1"):
        tspec.speculative_generate(tp, tdp, torch.ones((2, 3),
                                                       dtype=torch.int64),
                                   cfg, tdc, 4, 40)
    with pytest.raises(ValueError, match="draft layers"):
        tspec.layer_prefix_draft(tp, cfg, 3)


def test_layer_prefix_draft_slices_every_layer_leaf():
    """The draft's layer leaves are views of the target's first N layers,
    the int8 values and scales included; the rest is shared."""
    _jcfg, cfg, _jp, tp = _pair(int8=True)
    dp, dcfg = tspec.layer_prefix_draft(tp, cfg, 2)
    assert dcfg.n_layers == 2 and dcfg.vocab_size == cfg.vocab_size
    assert set(dp["layers"]) == set(tp["layers"]) >= {"wq_q", "wq_s"}
    for name, leaf in dp["layers"].items():
        assert leaf.shape[0] == 2
        assert leaf.data_ptr() == tp["layers"][name].data_ptr()
        assert torch.equal(leaf, tp["layers"][name][:2])
    assert dp["embed_q"] is tp["embed_q"]


def test_speculative_program_matches_speculative_generate():
    """Through the engine the program emits what speculative_generate
    emits (trimmed after eos) for greedy, eos-stopped and max_new-capped
    requests, in the same number of rounds: one dispatch per admission
    plus dispatch_cost 2 a round."""
    _jcfg, cfg, _jp, tp = _pair(n_layers=2)
    dp, dcfg = tspec.layer_prefix_draft(tp, cfg, 1)
    eng = SlotEngine(cfg, tp, MAX_LEN, program=tspec.SpeculativeStepProgram(
        cfg, dcfg, tp, dp, MAX_LEN, speculate=4))
    try:
        assert eng.stats["slots"] == 1 and eng.stats["chunk"] == 5
        ref, _ = tspec.speculative_generate(
            tp, dp, torch.tensor([[2, 4, 6]]), cfg, dcfg, 16, MAX_LEN)
        cases = [([1, 2, 3, 4], 12, -1), ([5, 6], 10, -1),
                 ([2, 4, 6], 16, ref[0, 1].item())]
        rounds = 0
        for tokens, max_new, eos in cases:
            want, stats = tspec.speculative_generate(
                tp, dp, torch.tensor([tokens]), cfg, dcfg, max_new, MAX_LEN,
                speculate=4, eos_id=eos)
            rounds += stats["rounds"]
            row = want[0].tolist()
            if eos >= 0 and eos in row:
                row = row[: row.index(eos) + 1]
            got = eng.submit(tokens, max_new=max_new,
                             eos_id=eos).result(timeout=120)
            assert got == row, (tokens, got, row)
        assert eng.dispatches == len(cases) + 2 * rounds
    finally:
        eng.stop()


def test_speculative_program_rejects_bad_shapes():
    _jcfg, cfg, _jp, tp = _pair(n_layers=2)
    dp, dcfg = tspec.layer_prefix_draft(tp, cfg, 1)
    with pytest.raises(ValueError, match="speculate"):
        tspec.SpeculativeStepProgram(cfg, dcfg, tp, dp, MAX_LEN,
                                     speculate=0)
    with pytest.raises(ValueError, match="window"):
        tspec.SpeculativeStepProgram(dataclasses.replace(cfg, window=8),
                                     dcfg, tp, dp, MAX_LEN)
    with pytest.raises(ValueError, match="share a vocab"):
        tspec.SpeculativeStepProgram(
            cfg, dataclasses.replace(dcfg, vocab_size=32), tp, dp, MAX_LEN)


def test_window_refuses_speculative():
    """Ring writes cannot be rolled back: a windowed config is refused
    by the standalone loop and by the server."""
    _jcfg, cfg, _jp, tp = _pair(window=8)
    dp, dcfg = tspec.layer_prefix_draft(tp, cfg, 1)
    with pytest.raises(ValueError, match="sliding-window"):
        tspec.speculative_generate(tp, dp, torch.ones((1, 4),
                                                      dtype=torch.int64),
                                   cfg, dcfg, 4, 32)
    with pytest.raises(ValueError, match="--draft-layers does not compose"):
        InferenceServer(cfg, tp, "127.0.0.1", 0, 32, device="cpu",
                        draft_layers=1)


async def _http(port, method, path, body=None):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = json.dumps(body).encode() if body is not None else b""
    writer.write(
        f"{method} {path} HTTP/1.1\r\nHost: x\r\nConnection: close\r\n"
        f"Content-Length: {len(payload)}\r\n\r\n".encode() + payload)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, data = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), json.loads(data)


def test_server_speculative_equals_vanilla(run):
    """Two servers on the same weights, one with --draft-layers 1
    --speculate 4: greedy requests (with and without eos) give the same
    JSON and ride the speculative engine; sampled and batched requests
    take the other paths; /v1/model reports the reference's schema;
    speculate 0 is refused at construction."""
    jcfg, cfg, jp, tp = _pair()
    with pytest.raises(ValueError, match="speculate"):
        InferenceServer(cfg, tp, "127.0.0.1", 0, 64, device="cpu",
                        draft_layers=1, speculate=0)
    greedy = {"tokens": [[3, 1, 4, 1, 5]], "max_new_tokens": 24}
    jdp, jdc = jspec.layer_prefix_draft(jp, jcfg, 1)
    jrow = np.asarray(jspec.speculative_generate(
        jp, jdp, jnp.asarray(greedy["tokens"], jnp.int32), jcfg, jdc, 24,
        64)[0]).tolist()

    async def scenario():
        vanilla = InferenceServer(cfg, tp, "127.0.0.1", 0, 64, device="cpu")
        spec = InferenceServer(cfg, tp, "127.0.0.1", 0, 64, device="cpu",
                               draft_layers=1, speculate=4)
        await vanilla.run()
        await spec.run()
        try:
            engine = spec.spec_engine
            warm = engine.dispatches
            a = await _http(vanilla.port, "POST", "/v1/generate", greedy)
            b = await _http(spec.port, "POST", "/v1/generate", greedy)
            rode = engine.dispatches - warm
            eos = {**greedy, "eos_id": a[1]["tokens"][0][2]}
            ae = await _http(vanilla.port, "POST", "/v1/generate", eos)
            be = await _http(spec.port, "POST", "/v1/generate", eos)
            before = engine.dispatches
            sampled = await _http(spec.port, "POST", "/v1/generate", {
                "tokens": [[3, 1, 4]], "max_new_tokens": 8,
                "temperature": 1.0, "seed": 7})
            batched = await _http(spec.port, "POST", "/v1/generate", {
                "tokens": [[1, 2], [3, 4]], "max_new_tokens": 4})
            bypassed = engine.dispatches - before
            info = await _http(spec.port, "GET", "/v1/model")
            return a, b, rode, ae, be, sampled, batched, bypassed, info
        finally:
            await vanilla.stop()
            await spec.stop()

    a, b, rode, ae, be, sampled, batched, bypassed, info = run(
        scenario(), timeout=120)
    assert a == b and a[0] == 200 and a[1]["tokens"] == jrow
    assert ae == be and len(ae[1]["tokens"][0]) <= 3
    assert rode >= 1 + 2 and bypassed == 0
    assert len(sampled[1]["tokens"][0]) == 8
    assert len(batched[1]["tokens"]) == 2
    spec_info = dict(info[1]["speculative"])
    engine_stats = spec_info.pop("engine")
    assert spec_info == {"draft_layers": 1, "speculate": 4}
    assert engine_stats["slots"] == 1 and engine_stats["dispatches"] >= 2
    assert info[1]["batching"]["device_calls"] >= 2  # sampled + batched

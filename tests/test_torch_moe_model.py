"""A switch-MoE model of the port against the JAX reference on bridged
params, on the CPU: whole-model parity for 2 and 4 experts, each beside
a window and beside GQA (``forward_with_aux`` logits and aux at 1e-4,
greedy ``generate`` tokens exactly, ``loss_fn`` value and gradients at
GRAD_TOL), and the model through every serving path: the slot engine
(the eager round) against the JAX engine, the server's /v1/generate
JSON through the Batcher and the slot engine (float32 and int8) against
JAX generate, the serve CLI with ``--moe-experts`` (bf16 and ``--int8``)
against the port's and JAX's generate on the same weights, and a LoRA
adapter merged on an MoE base."""
import asyncio
import dataclasses
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from containerpilot_tpu.models import decode as jdecode
from containerpilot_tpu.models import lora as jlora
from containerpilot_tpu.models import quantized as jquant
from containerpilot_tpu.models import transformer as jtf
from containerpilot_tpu.workload.serve_slots import SlotEngine as JaxSlotEngine
from containerpilot_tpu_torch import bridge
from containerpilot_tpu_torch.models import decode as tdecode
from containerpilot_tpu_torch.models import lora as tlora
from containerpilot_tpu_torch.models import transformer as ttf
from containerpilot_tpu_torch.workload import serve_cli
from containerpilot_tpu_torch.workload.serve import InferenceServer
from containerpilot_tpu_torch.workload.serve_slots import SlotEngine

from test_torch_moe import (
    GRAD_TOL,
    LOGIT_TOL,
    MOE,
    MOE2,
    bridged,
    close,
    configs,
    to_np,
    tokens,
)
from test_torch_train import assert_tree_close, port_value_and_grad


# -- the whole model against JAX ---------------------------------------------

MODEL_CASES = {
    f"E{E}_{name}": {"moe_experts": E, **over}
    for E in (2, 4)
    for name, over in (("plain", {}), ("window", {"window": 8}),
                       ("gqa", {"n_kv_heads": 2}))
}


@pytest.fixture(scope="module", params=sorted(MODEL_CASES))
def model(request):
    jcfg, cfg = configs(MOE2, **MODEL_CASES[request.param])
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jp, bridged(jp)


def test_forward_with_aux_matches_jax(model):
    jcfg, cfg, jp, tp = model
    toks = tokens(1, (2, 24), 128)
    with jax.default_matmul_precision("float32"):
        jl, ja = jtf.forward_with_aux(jp, jnp.asarray(toks), jcfg)
    with torch.no_grad():
        tl, ta = ttf.forward_with_aux(tp, torch.from_numpy(toks).long(), cfg)
    close(tl, jl, LOGIT_TOL, "logits")
    np.testing.assert_allclose(ta.item(), float(ja), rtol=LOGIT_TOL)


def test_generate_greedy_equals_jax(model):
    jcfg, cfg, jp, tp = model
    toks = tokens(2, (2, 6), 128)
    want = np.asarray(jdecode.generate(jp, jnp.asarray(toks), jcfg,
                                       max_new_tokens=16, max_len=48))
    got = tdecode.generate(tp, torch.from_numpy(toks).long(), cfg,
                           max_new_tokens=16, max_len=48)
    np.testing.assert_array_equal(got.numpy(), want)


def test_loss_and_grads_match_jax(model):
    jcfg, cfg, jp, tp = model
    toks = tokens(3, (2, 17), 128)
    with jax.default_matmul_precision("float32"):
        jl, jg = jax.value_and_grad(jtf.loss_fn)(jp, jnp.asarray(toks), jcfg)
    tl, tg = port_value_and_grad(tp, toks, cfg)
    np.testing.assert_allclose(tl, float(jl), rtol=GRAD_TOL)
    assert_tree_close(tg, to_np(jg), GRAD_TOL)


# -- serving paths -----------------------------------------------------------


@pytest.mark.parametrize("int8", [False, True])
def test_slot_engine_tokens_equal_jax_slot_engine(int8):
    """Staggered greedy requests through the port's slot engine (the
    eager round on the CPU) and the JAX engine give the same tokens,
    which are also solo generate's."""
    jcfg, cfg = configs(MOE)
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    if int8:
        jp = jquant.quantize_model_params(jp)
    tp = bridged(jp)
    reqs = [([1, 2, 3, 4, 5], 12), ([9, 8], 5), ([7, 7, 7], 9),
            ([4, 3, 2, 1], 7)]
    results = {}
    for name, make in (
        ("torch", lambda: SlotEngine(cfg, tp, 48, slots=2, chunk=3)),
        ("jax", lambda: JaxSlotEngine(jcfg, jp, 48, slots=2, chunk=3)),
    ):
        eng = make()
        try:
            futs = [eng.submit(t, max_new=n) for t, n in reqs]
            results[name] = [f.result(timeout=120) for f in futs]
        finally:
            eng.stop()
    assert results["torch"] == results["jax"]
    for (row, n), got in zip(reqs, results["torch"]):
        assert got == tdecode.generate(tp, torch.tensor([row]), cfg, n,
                                       48)[0].tolist()


async def _generate(port, body):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = json.dumps(body).encode()
    writer.write(
        b"POST /v1/generate HTTP/1.1\r\nHost: x\r\nConnection: close\r\n"
        b"Content-Length: " + str(len(payload)).encode() + b"\r\n\r\n"
        + payload)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, data = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), json.loads(data)


def _serve(run, cfg, params, body, max_len=64, **kw):
    async def scenario():
        server = InferenceServer(cfg, params, "127.0.0.1", 0, max_len,
                                 device="cpu", **kw)
        await server.run()
        try:
            return await _generate(server.port, body)
        finally:
            await server.stop()

    return run(scenario(), timeout=120)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("slots", [0, 2])
def test_server_json_equals_jax_generate(run, int8, slots):
    """/v1/generate on an MoE model (float32; int8 weights dequantized a
    layer at a time), through the Batcher and the slot engine, equals
    JAX generate's tokens."""
    jcfg, cfg = configs(MOE2)
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    if int8:
        jp = jquant.quantize_model_params(jp)
    rows = tokens(5, (2 if not slots else 1, 7), 128).tolist()
    want = np.asarray(jdecode.generate(
        jp, jnp.asarray(rows, jnp.int32), jcfg, max_new_tokens=10,
        max_len=64)).tolist()
    status, body = _serve(run, cfg, bridged(jp),
                          {"tokens": rows, "max_new_tokens": 10},
                          slots=slots)
    assert status == 200 and body == {"tokens": want}


def _to_jax_tree(params):
    """The port's (cast) params as a numpy tree JAX runs: bf16 through
    its bit pattern into ml_dtypes.bfloat16."""
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()

    return conv(params)


@pytest.mark.parametrize("int8", [False, True])
def test_serve_cli_moe_experts_json_equals_generate(run, int8, capsys):
    """serve --moe-experts 2 (bf16, and --int8): the CLI builds the MoE
    tree (router float32, experts bf16 or int8 with float32 scales), and
    its /v1/generate JSON equals the port's in-process generate and JAX
    generate on the same weights."""
    args = serve_cli.build_arg_parser().parse_args(
        ["--device", "cpu", "--max-len", "64", "--d-model", "64",
         "--n-layers", "2", "--n-heads", "2", "--vocab", "128",
         "--moe-experts", "2"] + (["--int8"] if int8 else []))
    serve_cli.check_ported(args)
    cfg, params, checkpoint = serve_cli.load_model(args)
    assert cfg.moe_experts == 2 and checkpoint is None
    layers = params["layers"]
    assert layers["router"].dtype == torch.float32
    expert = layers["moe_w_in_q" if int8 else "moe_w_in"]
    assert expert.dtype == (torch.int8 if int8 else torch.bfloat16)
    assert expert.shape[:2] == (2, 2) and "w_gate" not in layers
    prompt = [[3, 1, 4, 1, 5, 9, 2, 6]]
    want = tdecode.generate(params, torch.tensor(prompt), cfg, 10,
                            64).tolist()
    jcfg = jtf.TransformerConfig(**{
        **{f.name: getattr(cfg, f.name)
           for f in dataclasses.fields(cfg) if f.name != "dtype"},
        "dtype": jnp.bfloat16})
    jtokens = np.asarray(jdecode.generate(
        jax.tree_util.tree_map(jnp.asarray, _to_jax_tree(params)),
        jnp.asarray(prompt, jnp.int32), jcfg, max_new_tokens=10,
        max_len=64)).tolist()
    status, body = _serve(run, cfg, params,
                          {"tokens": prompt, "max_new_tokens": 10})
    assert status == 200 and body == {"tokens": want} == {"tokens": jtokens}


def test_lora_merged_on_an_moe_base_equals_jax():
    """A LoRA adapter (wq, wv) merged on an MoE base equals JAX's merge
    leaf for leaf, and the merged model's greedy tokens equal JAX's."""
    jcfg, cfg = configs(MOE2)
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    lora = jlora.init_lora_params(jax.random.PRNGKey(2), jcfg, 4)
    keys = jax.random.split(jax.random.PRNGKey(3), len(lora))
    lora = {k: (v if k.endswith("_a")
                else 0.05 * jax.random.normal(key, v.shape, jnp.float32))
            for key, (k, v) in zip(keys, sorted(lora.items()))}
    jmerged = jlora.apply_lora(jp, lora, jcfg)
    tmerged = tlora.apply_lora(bridged(jp), bridge.lora_from_jax(
        to_np(lora), "cpu"), cfg)
    for name, leaf in to_np(jmerged)["layers"].items():
        close(tmerged["layers"][name], leaf, 1e-6, name)
    toks = tokens(4, (2, 6), 128)
    want = np.asarray(jdecode.generate(jmerged, jnp.asarray(toks), jcfg,
                                       max_new_tokens=12, max_len=48))
    got = tdecode.generate(tmerged, torch.from_numpy(toks).long(), cfg,
                           max_new_tokens=12, max_len=48)
    np.testing.assert_array_equal(got.numpy(), want)

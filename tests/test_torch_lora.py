"""The port's LoRA on the CPU (models/lora.py, parallel/train.py's
``make_lora_train_step``, the trainer's --lora-rank and
--base-checkpoint-dir, the serve CLI's and the evaluator's --lora-dir and
--lora-rank), held against the JAX package on bridged params and
adapters: a zero-init adapter reproduces the base exactly; ``apply_lora``
equals JAX's; the adapter gradient equals ``jax.grad`` through JAX's
``apply_lora`` and ``loss_fn`` (plain and flash attention) and two steps
equal JAX's LoRA step; training lowers the loss with the base frozen;
checkpoints round-trip; the train -> serve -> evaluate chain on
``--device cpu``, with SIGTERM and resume. Mirrors
tests/test_workload.py:1449.

Tolerances are tests/test_torch_train.py's: gradients 1e-4 relative to
each leaf's largest entry, a train step 2e-4."""
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from containerpilot_tpu.models import lora as jlora
from containerpilot_tpu.models import transformer as jtf
from containerpilot_tpu.parallel import MeshPlan, make_mesh
from containerpilot_tpu.parallel import train as jtrain
from containerpilot_tpu_torch import bridge
from containerpilot_tpu_torch.models import decode as tdecode
from containerpilot_tpu_torch.models import lora as tlora
from containerpilot_tpu_torch.models import quantized as tquant
from containerpilot_tpu_torch.models import transformer as ttf
from containerpilot_tpu_torch.parallel import (
    abstract_train_state,
    lora_abstract_state,
    make_lora_train_step,
    restore_checkpoint,
    restore_params,
    save_checkpoint,
)
from containerpilot_tpu_torch.parallel import train as ttrain
from containerpilot_tpu_torch.workload import evaluate as teval
from containerpilot_tpu_torch.workload import serve_cli
from containerpilot_tpu_torch.workload import train as ttrain_cli
from containerpilot_tpu_torch.workload.data import write_token_shards
from containerpilot_tpu_torch.workload.modelcfg import (
    average_eval_loss,
    derive_d_ff,
)
from containerpilot_tpu_torch.workload.serve import InferenceServer

from test_torch_train import assert_tree_close
from test_torch_train_cli import _cli

SMALL = dict(vocab_size=128, d_model=64, n_heads=4, n_layers=2, d_ff=128,
             max_seq_len=128, dtype="float32")
GRAD_TOL = 1e-4
STEP_TOL = 2e-4
RANK = 4


def configs(**over):
    d = {**SMALL, **over}
    jcfg = jtf.TransformerConfig(**{**d, "dtype": jnp.float32})
    return jcfg, ttf.TransformerConfig(**bridge.config_kwargs(d))


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_adapter(jcfg, seed=2):
    """A JAX adapter with B drawn too, so every adapter leaf gets a
    gradient (B = 0 leaves dA at zero)."""
    lora = jlora.init_lora_params(jax.random.PRNGKey(seed), jcfg, RANK)
    keys = jax.random.split(jax.random.PRNGKey(seed + 1), len(lora))
    return {k: (v if k.endswith("_a")
                else 0.05 * jax.random.normal(key, v.shape, jnp.float32))
            for key, (k, v) in zip(keys, sorted(lora.items()))}


def tokens(seed, shape, vocab=128):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def test_zero_init_adapter_reproduces_the_base():
    _jcfg, cfg = configs()
    base = ttf.init_params(0, cfg, device="cpu")
    lora = tlora.init_lora_params(2, cfg, RANK, device="cpu")
    assert set(lora) == {"wq_a", "wq_b", "wv_a", "wv_b"}
    assert lora["wq_a"].shape == (2, 64, RANK)
    assert lora["wv_b"].shape == (2, RANK, 64) and not lora["wv_b"].any()
    toks = torch.from_numpy(tokens(1, (2, 16))).long()
    with torch.no_grad():
        want = ttf.forward(base, toks, cfg)
        got = ttf.forward(tlora.apply_lora(base, lora, cfg), toks, cfg)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="rank"):
        tlora.init_lora_params(0, cfg, 0, device="cpu")


def test_apply_lora_matches_jax_and_refuses_a_quantized_base():
    """The merge of a bridged adapter equals JAX's leaf for leaf (GQA's
    narrower wv included), and so do the merged model's logits; an int8
    base is refused with the reference's wording."""
    jcfg, cfg = configs(n_kv_heads=2)
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    jl = jax_adapter(jcfg)
    tp = bridge.params_from_jax(to_np(jp), "cpu")
    tl = bridge.lora_from_jax(to_np(jl), "cpu")
    assert tl["wv_b"].shape == (2, RANK, 2 * 16)
    jmerged = jlora.apply_lora(jp, jl, jcfg)
    tmerged = tlora.apply_lora(tp, tl, cfg)
    assert_tree_close(tmerged, to_np(jmerged), 1e-6)
    toks = tokens(1, (2, 16))
    with jax.default_matmul_precision("float32"):
        jlogits = jtf.forward(jmerged, jnp.asarray(toks), jcfg)
    with torch.no_grad():
        tlogits = ttf.forward(tmerged, torch.from_numpy(toks).long(), cfg)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-5)
    quantized = tquant.quantize_model_params(tp)
    with pytest.raises(ValueError, match="merge before quantizing"):
        tlora.apply_lora(quantized, tl, cfg)
    with pytest.raises(ValueError, match="not a LoRA adapter leaf"):
        bridge.lora_from_jax({"wq": np.zeros((2, 3))}, "cpu")


@pytest.mark.parametrize("over,seq", [
    ({}, 16),                                       # plain attention
    ({"flash_min_seq": 128, "remat": "dots"}, 128),  # flash fwd + bwd
])
def test_adapter_gradient_matches_jax_grad(over, seq):
    """One step's adapter gradient: autograd through the port's
    apply_lora and loss_fn (the flash kernels' plain versions on the
    flash path) against jax.grad through JAX's, base frozen."""
    jcfg, cfg = configs(**over)
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    jl = jax_adapter(jcfg)
    toks = tokens(3, (2, seq + 1))
    with jax.default_matmul_precision("float32"):
        jloss, jgrad = jax.value_and_grad(
            lambda lo: jtf.loss_fn(jlora.apply_lora(jp, lo, jcfg),
                                   jnp.asarray(toks), jcfg))(jl)
    base = bridge.params_from_jax(to_np(jp), "cpu")
    lora = ttrain._master(bridge.lora_from_jax(to_np(jl), "cpu"))
    loss = ttf.loss_fn(tlora.apply_lora(base, lora, cfg),
                       torch.from_numpy(toks).long(), cfg)
    leaves = ttrain.tree_leaves(lora)
    grads = dict(zip(sorted(lora), torch.autograd.grad(loss, leaves)))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=GRAD_TOL)
    assert_tree_close(grads, to_np(jgrad), GRAD_TOL)
    assert not any(t.requires_grad for t in ttrain.tree_leaves(base))


def test_lora_train_step_matches_jax_step():
    """Two make_lora_train_step steps against JAX's on a one-device mesh
    from the same bridged adapter: loss and every updated adapter leaf."""
    jcfg, cfg = configs()
    mesh = make_mesh(jax.devices()[:1], plan=MeshPlan(1, 1))
    jbase = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    jinit, jstep, _abstract = jtrain.make_lora_train_step(
        jcfg, mesh, RANK, learning_rate=1e-2)
    jstate = jinit(jax.random.PRNGKey(3))
    tinit, tstep, _ = make_lora_train_step(cfg, RANK, learning_rate=1e-2)
    tstate = tinit(0, "cpu")
    lora = bridge.lora_from_jax(to_np(jstate.params), "cpu")
    tstate = ttrain.TrainState(
        ttrain._master(lora), tstate.opt_state, 0)
    base = bridge.params_from_jax(to_np(jbase), "cpu")
    for i in range(2):
        toks = tokens(10 + i, (4, 17))
        with jax.default_matmul_precision("float32"):
            jstate, jloss = jstep(jstate, jbase, jnp.asarray(toks))
        tstate, tloss = tstep(tstate, base, torch.from_numpy(toks).long())
        np.testing.assert_allclose(tloss.item(), float(jloss), rtol=GRAD_TOL)
    assert tstate.step == int(jstate.step) == 2
    assert_tree_close(tstate.params, to_np(jstate.params), STEP_TOL)


def test_training_lowers_loss_with_the_base_frozen(tmp_path):
    """15 steps at lr 1e-2 lower the loss; the base never moves and
    never requires grad; the adapter checkpoint resumes (train state)
    and restores params-only (what serving merges)."""
    _jcfg, cfg = configs()
    base = ttf.init_params(0, cfg, device="cpu")
    before = {k: v.clone() for k, v in base["layers"].items()}
    init_fn, step_fn, abstract = make_lora_train_step(cfg, RANK,
                                                      learning_rate=1e-2)
    state = init_fn(3, "cpu")
    toks = torch.from_numpy(tokens(1, (8, 33))).long()
    losses = []
    for _ in range(15):
        state, loss = step_fn(state, base, toks)
        losses.append(loss.item())
    assert losses[-1] < losses[0] - 0.1, losses
    for name, leaf in base["layers"].items():
        assert torch.equal(leaf, before[name]) and not leaf.requires_grad
    assert state.params["wq_b"].abs().max() > 0
    save_checkpoint(str(tmp_path), 15, state)
    resumed = restore_checkpoint(str(tmp_path), abstract, device="cpu")
    assert resumed.step == 15
    assert torch.equal(resumed.params["wq_a"], state.params["wq_a"])
    only, step = restore_params(str(tmp_path),
                                lora_abstract_state(cfg, RANK),
                                device="cpu")
    assert step == 15 and torch.equal(only["wv_b"], state.params["wv_b"])


TINY_MODEL = ["--d-model", "64", "--n-layers", "1", "--n-heads", "2",
              "--vocab", "128"]
TINY = ["--device", "cpu", "--batch", "2", "--seq-len", "32", *TINY_MODEL]


@pytest.fixture(scope="module")
def base_and_adapter(tmp_path_factory):
    """A base checkpoint of 4 trainer steps, then rank-4 adapters trained
    over it for 4 steps by the train CLI."""
    root = tmp_path_factory.mktemp("lora_chain")
    base, adapter = str(root / "base"), str(root / "adapter")
    assert ttrain_cli.main(TINY + ["--steps", "4", "--checkpoint-dir", base,
                                   "--checkpoint-every", "4"]) == 0
    assert ttrain_cli.main(TINY + [
        "--steps", "4", "--lora-rank", str(RANK), "--learning-rate", "1e-2",
        "--base-checkpoint-dir", base, "--checkpoint-dir", adapter,
        "--checkpoint-every", "4"]) == 0
    return base, adapter


def _merged(base, adapter):
    cfg = ttf.TransformerConfig(vocab_size=128, d_model=64, n_heads=2,
                                n_layers=1, d_ff=derive_d_ff(64))
    params = restore_params(base, abstract_train_state(cfg),
                            device="cpu")[0]
    lora = restore_params(adapter, lora_abstract_state(cfg, RANK),
                          device="cpu")[0]
    return cfg, tlora.apply_lora(params, lora, cfg)


@pytest.mark.parametrize("int8", [False, True])
def test_serve_cli_merges_the_adapter_before_int8(
        run, base_and_adapter, capsys, int8):
    """serve --checkpoint-dir BASE --lora-dir ADAPTER --lora-rank 4
    (and --int8): the params are the merged float32 masters, quantized
    after the merge, cast once; the server's greedy tokens equal an
    in-process generate on them."""
    import asyncio

    base, adapter = base_and_adapter
    args = serve_cli.build_arg_parser().parse_args(
        ["--device", "cpu", "--max-len", "64", *TINY_MODEL,
         "--checkpoint-dir", base, "--lora-dir", adapter,
         "--lora-rank", str(RANK)] + (["--int8"] if int8 else []))
    serve_cli.check_ported(args)
    cfg, params, checkpoint = serve_cli.load_model(args)
    assert "merged lora adapter (rank 4, step 4)" in capsys.readouterr().out
    assert checkpoint == {"step": 4, "ema": False}
    _cfg, merged = _merged(base, adapter)
    if int8:
        merged = tquant.quantize_model_params(merged)
    want_params = tquant.cast_params(merged, cfg.dtype)
    for name, leaf in want_params["layers"].items():
        assert torch.equal(params["layers"][name], leaf), name
    prompt = [[3, 1, 4, 1, 5, 9, 2, 6]]
    want = tdecode.generate(want_params, torch.tensor(prompt), cfg, 10,
                            64).tolist()

    async def scenario():
        server = InferenceServer(cfg, params, "127.0.0.1", 0, 64,
                                 device="cpu", checkpoint=checkpoint)
        await server.run()
        try:
            reader, writer = await asyncio.open_connection("127.0.0.1",
                                                           server.port)
            body = json.dumps({"tokens": prompt,
                               "max_new_tokens": 10}).encode()
            writer.write(b"POST /v1/generate HTTP/1.1\r\nHost: x\r\n"
                         b"Connection: close\r\nContent-Length: "
                         + str(len(body)).encode() + b"\r\n\r\n" + body)
            await writer.drain()
            raw = await reader.read()
            writer.close()
            return json.loads(raw.partition(b"\r\n\r\n")[2])
        finally:
            await server.stop()

    assert run(scenario(), timeout=120) == {"tokens": want}


def test_evaluate_scores_the_merged_params(base_and_adapter, tmp_path,
                                           capsys):
    """evaluate --lora-dir prints the loss of the merged params, which is
    not the base's."""
    base, adapter = base_and_adapter
    shards = str(tmp_path / "shards")
    write_token_shards(np.random.default_rng(0).integers(0, 128, 4000),
                       shards, shard_size=2000)
    argv = ["--device", "cpu", "--checkpoint-dir", base, "--data-dir",
            shards, "--eval-holdout", "8", "--batch", "2", "--seq-len",
            "32", *TINY_MODEL]
    assert teval.main(argv + ["--lora-dir", adapter, "--lora-rank",
                              str(RANK)]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["lora"] is True and report["checkpoint_step"] == 4
    from containerpilot_tpu_torch.workload.data import TokenShardDataset

    cfg, merged = _merged(base, adapter)
    data = TokenShardDataset(shards, 32, 2, vocab_size=128,
                             holdout_windows=8)
    want = average_eval_loss(merged, cfg, data.n_eval_batches,
                             data.eval_batch)
    assert report["eval_loss"] == round(want, 6)
    assert teval.main(argv) == 0
    plain = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert plain["lora"] is False and plain["eval_loss"] != want


def test_lora_trainer_sigterm_resume_equals_uninterrupted(
        tmp_path, base_and_adapter, capsys):
    """The LoRA trainer preempted by SIGTERM saves and exits 0; the
    resumed run ends with exactly the adapters and optimizer state of an
    uninterrupted one."""
    base, _adapter = base_and_adapter
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    lora = ["--lora-rank", str(RANK), "--base-checkpoint-dir", base,
            "--ema-decay", "0.5"]
    progress = str(tmp_path / "progress.json")
    rc, out = _cli(TINY + lora + ["--steps", "100000", "--checkpoint-dir",
                                  a, "--checkpoint-every", "100000",
                                  "--progress-file", progress],
                   stop_after=2)
    saved = re.search(r"checkpoint saved at step (\d+)", out)
    assert rc == 0 and saved, out
    assert "lora: frozen base from checkpoint step 4" in out
    at = int(saved.group(1))
    end = str(at + 2)
    assert ttrain_cli.main(TINY + lora + ["--steps", end, "--checkpoint-dir",
                                          a, "--checkpoint-every", end]) == 0
    assert f"resumed from checkpoint at step {at}" in capsys.readouterr().out
    assert ttrain_cli.main(TINY + lora + ["--steps", end, "--checkpoint-dir",
                                          b, "--checkpoint-every", end]) == 0
    got, want = (torch.load(os.path.join(d, f"step_{end}", "state.pt"),
                            weights_only=True) for d in (a, b))
    assert set(got["params"]) == {"wq_a", "wq_b", "wv_a", "wv_b"}
    for tree in ("params", "opt_state"):
        left = ttrain.tree_leaves(got[tree])
        right = ttrain.tree_leaves(want[tree])
        assert len(left) == len(right) and all(
            (torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y)
            for x, y in zip(left, right)), tree


@pytest.mark.parametrize("which,argv,match", [
    ("serve", ["--lora-rank", "4"], "without --lora-dir does nothing"),
    ("serve", ["--lora-dir", "/nowhere"], "--lora-dir requires --lora-rank"),
    ("serve", ["--lora-dir", "/nowhere", "--lora-rank", "4"],
     "no adapter checkpoint in /nowhere"),
    ("train", ["--lora-rank", "4", "--accum-steps", "2"],
     "composes with the plain trainer only"),
    ("train", ["--lora-rank", "4", "--base-checkpoint-dir", "/nowhere"],
     "no checkpoint in /nowhere"),
    ("evaluate", ["--lora-dir", "/x"], "--lora-dir requires --lora-rank"),
])
def test_lora_flag_misuse_exits(which, argv, match):
    with pytest.raises(SystemExit, match=re.escape(match)):
        if which == "serve":
            serve_cli.load_model(serve_cli.build_arg_parser().parse_args(
                ["--device", "cpu", *TINY_MODEL, *argv]))
        elif which == "train":
            ttrain_cli.main(TINY + ["--steps", "1", *argv])
        else:
            teval.main(["--device", "cpu", "--checkpoint-dir", "/x",
                        "--data-dir", "/y", "--eval-holdout", "1", *argv])

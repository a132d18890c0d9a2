"""The port's InferenceServer over real HTTP on 127.0.0.1:0 with
device="cpu": health after warmup, /v1/model, /v1/generate JSON equal to
JAX ``generate`` tokens after the same trim, a 422 for a bad row,
/v1/score against JAX's ``score_logprobs_fn``, the CLI's flag surface,
and serving the trainer's checkpoints (raw and EMA). Seeded sampled
requests answer the same JSON as the reference's server beside it,
through the Batcher, the slot engine and a prefix-cache hit."""
import asyncio
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from containerpilot_tpu.models import decode as jdecode
from containerpilot_tpu.models import transformer as jtf
from containerpilot_tpu.workload import modelcfg as jmodelcfg
from containerpilot_tpu.workload.serve import InferenceServer as JaxServer
from containerpilot_tpu_torch import bridge
from containerpilot_tpu_torch.models import decode as tdecode
from containerpilot_tpu_torch.models import transformer as ttf
from containerpilot_tpu_torch.workload import serve_cli
from containerpilot_tpu_torch.workload.serve import InferenceServer

from torch_draws import assert_same_tokens, teacher_forced_gap

BASE = dict(vocab_size=128, d_model=64, n_heads=2, n_layers=2, d_ff=128,
            max_seq_len=64, dtype="float32")
MAX_LEN = 64


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


def _reference(jp, jcfg, rows, max_new, **kw):
    """JAX generate at the reference server's bucketed length, then the
    server's trim (first max_new, cut after eos)."""
    bucket = min(-(-max_new // 16) * 16, MAX_LEN - len(rows[0]))
    out = np.asarray(jdecode.generate(
        jp, jnp.asarray(rows, jnp.int32), jcfg, max_new_tokens=bucket,
        max_len=MAX_LEN, **kw,
    )).tolist()
    out = [r[:max_new] for r in out]
    eos = kw.get("eos_id", -1)
    if eos >= 0:
        out = [r[: r.index(eos) + 1] if eos in r else r for r in out]
    return out


def test_server_generate_matches_jax_and_routes(run):
    jcfg = jtf.TransformerConfig(**{**BASE, "dtype": jnp.float32})
    tcfg = ttf.TransformerConfig(**bridge.config_kwargs(BASE))
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), "cpu"
    )
    rows = np.random.default_rng(0).integers(0, 128, (2, 7)).tolist()
    greedy_ref = _reference(jp, jcfg, rows, 9)
    jax_lp = np.asarray(jmodelcfg.score_logprobs_fn(jcfg)(
        jp, jnp.asarray([rows[0] + greedy_ref[0]], jnp.int32)
    ))[0, len(rows[0]) - 1:]
    eos = greedy_ref[0][3]
    eos_ref = _reference(jp, jcfg, rows, 9, eos_id=eos)

    async def scenario():
        server = InferenceServer(tcfg, tp, "127.0.0.1", 0, MAX_LEN,
                                 max_batch_rows=8, device="cpu")
        await server._server.start_tcp("127.0.0.1", 0)
        port = server._server.bound_port
        server._batcher.start()
        try:
            status, _ = await _http(port, "GET", "/health")
            assert status == 503  # not warm yet
            await server.warmup()
            status, body = await _http(port, "GET", "/health")
            assert (status, body) == (200, b"ok\n")
            status, body = await _http(port, "GET", "/v1/model")
            info = json.loads(body)
            assert status == 200 and info["n_layers"] == 2
            assert info["device"] == "cpu" and info["slot_engine"] is None
            status, body = await _http(port, "POST", "/v1/generate", {
                "tokens": rows, "max_new_tokens": 9,
            })
            assert status == 200
            assert json.loads(body) == {"tokens": greedy_ref}
            status, body = await _http(port, "POST", "/v1/generate", {
                "tokens": rows, "max_new_tokens": 9, "eos_id": eos,
            })
            assert json.loads(body) == {"tokens": eos_ref}
            # n duplicates one row; greedy duplicates are identical
            status, body = await _http(port, "POST", "/v1/generate", {
                "tokens": rows[:1], "max_new_tokens": 9, "n": 3,
            })
            assert json.loads(body) == {"tokens": [greedy_ref[0]] * 3}
            # seeded sampling: the same seed gives the same answer
            req = {"tokens": rows[:1], "max_new_tokens": 6,
                   "temperature": 1.0, "seed": 4, "top_k": 8}
            first = await _http(port, "POST", "/v1/generate", req)
            again = await _http(port, "POST", "/v1/generate", req)
            assert first == again and first[0] == 200
            status, body = await _http(port, "POST", "/v1/generate", {
                "tokens": [[1, 2], [3]], "max_new_tokens": 4,
            })
            assert status == 422 and b"share a length" in body
            status, _ = await _http(port, "POST", "/v1/generate", {
                "tokens": [[1, 2]], "max_new_tokens": 4, "stream": True,
            })
            assert status == 422
            status, body = await _http(port, "POST", "/v1/score", {
                "tokens": [rows[0] + greedy_ref[0]],
            })
            assert status == 200
            scored = json.loads(body)
            np.testing.assert_allclose(
                scored["logprobs"][0][len(rows[0]) - 1:], jax_lp,
                rtol=1e-4, atol=1e-4)
            status, body = await _http(port, "POST", "/v1/score", {
                "tokens": [[5]],
            })
            assert status == 422 and b">= 2 ids" in body
            assert server.batch_stats["calls"] >= 5
        finally:
            await server.stop()

    run(scenario(), timeout=120)


_ROWS = np.random.default_rng(3).integers(0, 128, (2, 18)).tolist()
# seeded sampled requests a server path serves, and the server flags
# that send them there; the prefix path's second request hits the entry
# the first one stored
SAMPLED_PATHS = {
    "batcher": ({}, [
        {"tokens": _ROWS, "max_new_tokens": 9, "temperature": 0.9,
         "top_k": 20, "top_p": 0.9, "seed": 5},
        {"tokens": _ROWS[:1], "max_new_tokens": 7, "temperature": 1.1,
         "n": 3, "seed": 2**31 + 3},
        {"tokens": _ROWS, "max_new_tokens": 6, "temperature": 0.7,
         "presence_penalty": 0.5, "frequency_penalty": 0.2,
         "logit_bias": {"3": 1.5}, "seed": 8},
    ]),
    "slots": ({"slots": 2, "slot_chunk": 4}, [
        {"tokens": _ROWS[:1], "max_new_tokens": 9, "temperature": 0.9,
         "top_k": 20, "top_p": 0.9, "seed": 5},
        {"tokens": _ROWS[1:], "max_new_tokens": 12, "temperature": 1.2,
         "seed": 11, "frequency_penalty": 0.4},
    ]),
    "prefix": ({"prefix_cache_entries": 2}, [
        {"tokens": _ROWS[:1], "max_new_tokens": 8, "temperature": 0.8,
         "top_k": 30, "seed": 6},
        {"tokens": [_ROWS[0] + [7, 9]], "max_new_tokens": 8,
         "temperature": 1.0, "top_p": 0.85, "seed": 6},
    ]),
}


@pytest.mark.parametrize("path", sorted(SAMPLED_PATHS))
def test_sampled_server_json_equals_reference_server(run, path):
    """The reference's server and the port's, side by side on the same
    weights and flags, answer the same seeded sampled requests with the
    same JSON: the Batcher (a batch, n, penalties and logit_bias), the
    slot engine and a prefix-cache hit."""
    flags, bodies = SAMPLED_PATHS[path]
    jcfg = jtf.TransformerConfig(**{**BASE, "dtype": jnp.float32})
    tcfg = ttf.TransformerConfig(**bridge.config_kwargs(BASE))
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                "cpu")

    async def scenario():
        servers = [
            JaxServer(jcfg, jp, "127.0.0.1", 0, max_len=MAX_LEN, **flags),
            InferenceServer(tcfg, tp, "127.0.0.1", 0, MAX_LEN, device="cpu",
                            **flags),
        ]
        for server in servers:
            await server.run()
        answers = ([], [])
        try:
            for body in bodies:
                for out, server in zip(answers, servers):
                    out.append(await _http(server.port, "POST",
                                           "/v1/generate", body))
            info = [json.loads((await _http(s.port, "GET", "/v1/model"))[1])
                    for s in servers]
        finally:
            for server in servers:
                await server.stop()
        return answers, info

    (ref, got), info = run(scenario(), timeout=240)
    for body, (rs, rb), (gs, gb) in zip(bodies, ref, got):
        assert (gs, rs) == (200, 200), (gb, rb)
        rows = body["tokens"] * body.get("n", 1)
        want, have = json.loads(rb)["tokens"], json.loads(gb)["tokens"]

        def gap(r, i):
            knobs = {k: body[k] for k in ("temperature", "top_k", "top_p")
                     if k in body}
            key = tdecode.row_key(body["seed"], r)
            return teacher_forced_gap(tp, tcfg, rows[r], want[r], i, key,
                                      **knobs)

        assert_same_tokens(want, have, gap)
        assert gb == rb
    if path == "prefix":
        for stats in info:
            assert stats["prefix_cache"]["hits"] >= 1, stats


def test_cli_parses_supported_flags():
    args = serve_cli.build_arg_parser().parse_args(
        ["--n-layers", "3", "--int8", "--device", "cpu", "--mux",
         "--slots", "4", "--slot-chunk", "2", "--slot-window", "3",
         "--prefix-cache", "5", "--prefill-chunk", "64"]
    )
    assert args.n_layers == 3 and args.int8 and args.device == "cpu"
    assert (args.slots, args.slot_chunk, args.slot_window,
            args.prefix_cache, args.prefill_chunk) == (4, 2, 3, 5, 64)
    serve_cli.check_ported(args)  # all supported: no exit
    cfg, params, checkpoint = serve_cli.load_model(
        serve_cli.build_arg_parser().parse_args(
            ["--n-layers", "1", "--d-model", "128", "--n-heads", "2",
             "--vocab", "64", "--int8", "--device", "cpu"]
        )
    )
    assert cfg.n_layers == 1 and cfg.d_ff == 384
    assert "wq_q" in params["layers"] and checkpoint is None


# what the reference does with each case's flags (its messages); None =
# it starts (its own startup checks pass)
_REFERENCE_OUTCOME = {
    ("--moe-experts", "4", "--tp", "4"): None,
    ("--draft-layers", "1", "--cp", "2"):
        (ValueError, "--cp does not compose with --draft-layers"),
    ("--lora-rank", "4", "--tp", "2"):
        (SystemExit, "--lora-rank without --lora-dir does nothing"),
    ("--cp-min-len", "64"): None,  # no --cp: the threshold is unused
}


@pytest.mark.parametrize("argv,flag", [
    (["--moe-experts", "4", "--tp", "4"], "--tp"),
    (["--draft-layers", "1", "--cp", "2"], "--cp"),
    (["--lora-rank", "4", "--tp", "2"], "--tp"),
    (["--cp-min-len", "64"], "--cp-min-len"),
])
def test_cli_flag_not_ported_yet_exits(argv, flag):
    """--tp, --cp and --cp-min-len are ported: each case's startup
    checks give what the reference gives for the same flags."""
    args = serve_cli.build_arg_parser().parse_args(argv)
    assert getattr(args, flag.lstrip("-").replace("-", "_")) != (
        serve_cli.build_arg_parser().parse_args([]).__dict__[
            flag.lstrip("-").replace("-", "_")])
    outcome = _REFERENCE_OUTCOME[tuple(argv)]
    if outcome is None:
        serve_cli.check_ported(args)  # starts
    else:
        with pytest.raises(outcome[0], match=outcome[1]):
            serve_cli.check_ported(args)


def test_http_keepalive_serves_two_requests_on_one_connection(run):
    """The port's plain HTTP/1.1 server keeps a connection open between
    Content-Length-framed responses, and answers 405/404 by route."""
    from containerpilot_tpu_torch.utils.http import HTTPServer, Response

    async def scenario():
        server = HTTPServer()

        async def ok(_req):
            return Response(200, b"ok\n")

        server.route("GET", "/ok", ok)
        await server.start_tcp("127.0.0.1", 0)
        try:
            reader, writer = await asyncio.open_connection(
                "127.0.0.1", server.bound_port
            )
            statuses = []
            for path in ("/ok", "/ok", "/missing"):
                writer.write(f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
                await writer.drain()
                head = await reader.readuntil(b"\r\n\r\n")
                length = int(head.split(b"Content-Length: ")[1].split(b"\r\n")[0])
                await reader.readexactly(length)
                statuses.append(int(head.split()[1]))
            writer.write(b"POST /ok HTTP/1.1\r\nConnection: close\r\n\r\n")
            await writer.drain()
            tail = await reader.read()
            writer.close()
            return statuses, int(tail.split()[1])
        finally:
            await server.stop()

    statuses, last = run(scenario(), timeout=30)
    assert statuses == [200, 200, 404] and last == 405


MODEL_FLAGS = ["--d-model", "64", "--n-layers", "1", "--n-heads", "2",
               "--vocab", "128"]


@pytest.fixture(scope="module")
def trained_checkpoint(tmp_path_factory):
    """A checkpoint of a few CPU training steps with an EMA shadow."""
    from containerpilot_tpu_torch.workload import train as ttrain_cli

    ckpt = str(tmp_path_factory.mktemp("serve_ckpt") / "ckpt")
    assert ttrain_cli.main([
        "--device", "cpu", "--batch", "2", "--seq-len", "32", *MODEL_FLAGS,
        "--steps", "6", "--ema-decay", "0.5", "--learning-rate", "1e-2",
        "--checkpoint-dir", ckpt, "--checkpoint-every", "6",
    ]) == 0
    return ckpt


@pytest.mark.parametrize("use_ema", [False, True])
def test_serve_checkpoint_greedy_equals_in_process_generate(
        run, trained_checkpoint, use_ema):
    """--checkpoint-dir serves the trainer's step_<n>/ params (the EMA
    shadow with --use-ema): the server's greedy tokens equal an
    in-process generate on restore_params(prefer_ema=...), and
    /v1/model says which weights it loaded."""
    import torch

    from containerpilot_tpu_torch.models import decode as tdecode
    from containerpilot_tpu_torch.parallel import (
        abstract_train_state,
        restore_params,
    )

    argv = ["--device", "cpu", "--max-len", "64", *MODEL_FLAGS,
            "--checkpoint-dir", trained_checkpoint]
    args = serve_cli.build_arg_parser().parse_args(
        argv + (["--use-ema"] if use_ema else []))
    serve_cli.check_ported(args)
    cfg, params, checkpoint = serve_cli.load_model(args)
    assert checkpoint == {"step": 6, "ema": use_ema}
    restored = restore_params(trained_checkpoint, abstract_train_state(cfg),
                              prefer_ema=use_ema, device="cpu")
    other = restore_params(trained_checkpoint, abstract_train_state(cfg),
                           prefer_ema=not use_ema, device="cpu")
    # the EMA shadow is not the raw params: the flag picks a weight set
    assert not torch.equal(restored[0]["unembed"], other[0]["unembed"])
    prompt = [[3, 1, 4, 1, 5, 9, 2, 6]]
    want = tdecode.generate(restored[0], torch.tensor(prompt), cfg, 12,
                            64).tolist()

    async def scenario():
        server = InferenceServer(cfg, params, "127.0.0.1", 0, 64,
                                 device="cpu", checkpoint=checkpoint)
        await server._server.start_tcp("127.0.0.1", 0)
        port = server._server.bound_port
        server._batcher.start()
        try:
            await server.warmup()
            status, body = await _http(port, "POST", "/v1/generate", {
                "tokens": prompt, "max_new_tokens": 12})
            _, info = await _http(port, "GET", "/v1/model")
            return status, json.loads(body), json.loads(info)
        finally:
            await server.stop()

    status, body, info = run(scenario(), timeout=120)
    assert status == 200 and body["tokens"] == want
    assert info["checkpoint"] == {"step": 6, "ema": use_ema}


def test_serve_checkpoint_with_other_model_flags_fails(trained_checkpoint):
    """A model flag that disagrees with the checkpoint fails at startup,
    and a directory without a step_<n>/ serves the seeded init."""
    args = serve_cli.build_arg_parser().parse_args([
        "--device", "cpu", "--d-model", "64", "--n-layers", "2",
        "--n-heads", "2", "--vocab", "128",
        "--checkpoint-dir", trained_checkpoint])
    with pytest.raises(ValueError, match="checkpoint params"):
        serve_cli.load_model(args)
    empty = os.path.join(os.path.dirname(trained_checkpoint), "empty")
    os.makedirs(empty, exist_ok=True)
    args = serve_cli.build_arg_parser().parse_args(
        ["--device", "cpu", *MODEL_FLAGS, "--checkpoint-dir", empty])
    _cfg, _params, checkpoint = serve_cli.load_model(args)
    assert checkpoint is None


@pytest.mark.parametrize("argv,dest,value", [
    (["--window", "16"], "window", 16),
    (["--kv-int8"], "kv_int8", True),
])
def test_cli_window_and_kv_int8_configure_the_model(argv, dest, value):
    args = serve_cli.build_arg_parser().parse_args(
        ["--device", "cpu", *MODEL_FLAGS, *argv])
    serve_cli.check_ported(args)
    cfg, _params, _ckpt = serve_cli.load_model(args)
    assert getattr(cfg, dest) == value

"""The port's text surface and metrics face against a JAX replica on the
same params (workload/serve.py ``/v1/completions`` and ``/metrics``,
workload/text.py, serve_cli ``--text``): equal completion text and
tokens, buffered and streamed; the reference's stop-string, vocab and
CLI checks; and the same metric families, types, label sets and request
counts after the same request sequence. Mirrors
tests/test_workload.py:2885, :2969, :2986, :3602 and :3779."""
import asyncio
import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from containerpilot_tpu.models import transformer as jtf
from containerpilot_tpu.workload import text as ref_text
from containerpilot_tpu.workload.serve import (
    InferenceServer as JaxServer,
)
from containerpilot_tpu_torch import bridge
from containerpilot_tpu_torch.models import transformer as ttf
from containerpilot_tpu_torch.workload import serve_cli
from containerpilot_tpu_torch.workload.serve import InferenceServer
from containerpilot_tpu_torch.workload.text import (
    ByteTokenizer,
    stream_decoder,
)

BASE = dict(vocab_size=512, d_model=32, n_heads=2, n_layers=1, d_ff=64,
            max_seq_len=64, dtype="float32")
MAX_LEN = 64
WAIT = 300


@pytest.fixture(scope="module")
def bridged():
    jcfg = jtf.TransformerConfig(**{**BASE, "dtype": jnp.float32})
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                "cpu")
    return jcfg, ttf.TransformerConfig(**bridge.config_kwargs(BASE)), jp, tp


def fetch(port, path, body=None, timeout=120):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(body).encode() if body is not None else None,
        headers={"Content-Type": "application/json"} if body else {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            raw = resp.read().decode()
            status = resp.status
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()
    if "text/event-stream" in resp.headers.get("Content-Type", ""):
        return status, [json.loads(line[len("data: "):])
                        for line in raw.splitlines()
                        if line.startswith("data: ")]
    try:
        return status, json.loads(raw)
    except ValueError:
        return status, raw


def test_tokenizer_and_stream_decoder_equal_reference():
    port, ref = ByteTokenizer(512), ref_text.ByteTokenizer(512)
    for text in ("hi", "héllo wörld ✓", "\x00\x7f", "日本語"):
        assert port.encode(text) == ref.encode(text)
        assert port.encode(text, bos=False) == ref.encode(text, bos=False)
    ids = [1, 2, 0, 3, 300, 511, *port.encode("añ✓", bos=False)]
    assert port.decode(ids) == ref.decode(ids)
    assert port.to_bytes(ids) == ref.to_bytes(ids)
    # a multibyte character split across deltas decodes only once whole
    chars = port.encode("✓ok", bos=False)
    for deltas in ([chars[:1], chars[1:2], chars[2:]], [chars]):
        outs = []
        for mod, tok in ((stream_decoder, port),
                         (ref_text.stream_decoder, ref)):
            event, tail = mod(tok)
            outs.append([event(d) for d in deltas] + tail())
        assert outs[0] == outs[1]
        assert "".join(e["text"] for e in outs[0]) == "✓ok"


def test_inference_server_text_completions(run, bridged):
    """/v1/completions encodes through the byte tokenizer, equals
    /v1/generate on the encoded ids, and answers the reference's 422s
    (tests/test_workload.py:2885)."""
    _jcfg, cfg, _jp, tp = bridged
    server = InferenceServer(cfg, tp, "127.0.0.1", 0, MAX_LEN, text=True,
                             device="cpu")
    tok = ByteTokenizer(cfg.vocab_size)

    async def scenario():
        await server.run()
        loop = asyncio.get_running_loop()
        try:
            return await loop.run_in_executor(None, lambda: (
                fetch(server.port, "/v1/completions",
                      {"prompt": "hi", "max_new_tokens": 6}),
                fetch(server.port, "/v1/generate",
                      {"tokens": [tok.encode("hi")], "max_new_tokens": 6,
                       "eos_id": tok.EOS}),
                fetch(server.port, "/v1/completions", {"prompt": ""}),
                fetch(server.port, "/v1/completions",
                      {"prompt": "x", "max_new_tokens": 999}),
                fetch(server.port, "/v1/completions",
                      {"prompt": "x", "stream": True}),
                fetch(server.port, "/v1/completions",
                      {"prompt": "x", "n": 2}),
                fetch(server.port, "/v1/model")))
        finally:
            await server.stop()

    comp, gen, bad, too_long, streamed, n2, info = run(scenario(),
                                                       timeout=WAIT)
    assert comp[0] == 200 and gen[0] == 200
    assert comp[1]["tokens"] == gen[1]["tokens"][0]
    assert comp[1]["text"] == tok.decode(comp[1]["tokens"])
    assert bad[0] == 422 and too_long[0] == 422
    assert streamed[0] == 422 and "--slots" in streamed[1]
    assert n2[0] == 422 and "use /v1/generate" in n2[1]
    assert info[1]["text"] is True


def test_completions_equal_jax_buffered_and_streamed(run, bridged):
    """The same params and greedy requests: the JAX and the torch
    replica give equal /v1/completions text and tokens, buffered and
    streamed (the streamed events concatenate to the buffered answer),
    and the final event carries the trace id and span digest."""
    jcfg, cfg, jp, tp = bridged
    prompts = [("hello", 9, {}), ("ab", 12, {"eos_id": -1}),
               ("the quick brown fox", 7, {}),
               ("ü", 10, {"eos_id": 100})]

    async def serve_all(server):
        await server.run()
        loop = asyncio.get_running_loop()

        def go():
            out = []
            for prompt, max_new, extra in prompts:
                body = {"prompt": prompt, "max_new_tokens": max_new, **extra}
                out.append((fetch(server.port, "/v1/completions", body),
                            fetch(server.port, "/v1/completions",
                                  {**body, "stream": True})))
            return out

        try:
            return await loop.run_in_executor(None, go)
        finally:
            await server.stop()

    jax_out = run(serve_all(JaxServer(
        jcfg, jp, "127.0.0.1", 0, max_len=MAX_LEN, text=True, slots=2,
        slot_chunk=4)), timeout=WAIT)
    torch_out = run(serve_all(InferenceServer(
        cfg, tp, "127.0.0.1", 0, MAX_LEN, text=True, slots=2, slot_chunk=4,
        device="cpu")), timeout=WAIT)
    for (j_buf, j_sse), (t_buf, t_sse) in zip(jax_out, torch_out):
        assert j_buf[0] == t_buf[0] == 200
        assert t_buf[1] == j_buf[1]
        assert t_sse[0] == 200 and t_sse[1][-1]["done"] is True
        t_events = t_sse[1]
        assert "".join(e.get("text", "") for e in t_events) == \
            t_buf[1]["text"]
        assert sum((e.get("tokens", []) for e in t_events), []) == \
            t_buf[1]["tokens"]
        assert [{k: v for k, v in e.items() if k not in ("trace", "spans")}
                for e in t_events] == [
            {k: v for k, v in e.items() if k not in ("trace", "spans")}
            for e in j_sse[1]]
        done = t_events[-1]
        assert len(done["trace"]) == 16 and "prefill~" in done["spans"]


def test_completions_stop_strings(run, bridged):
    """Stop strings are byte-encoded and excluded
    (tests/test_workload.py:3602); a bad stop is a 422 in the text
    endpoint's words."""
    _jcfg, cfg, _jp, tp = bridged
    server = InferenceServer(cfg, tp, "127.0.0.1", 0, MAX_LEN, text=True,
                             device="cpu")
    tok = ByteTokenizer(cfg.vocab_size)

    async def scenario():
        await server.run()

        def go():
            # the first prompt whose 2nd+3rd generated ids round-trip as
            # text (specials and ids past the bytes would test another
            # stop sequence)
            for prompt in ("ab", "ag", "ao", "ad"):
                free = fetch(server.port, "/v1/completions",
                             {"prompt": prompt, "max_new_tokens": 6})[1]
                stop_text = tok.decode(free["tokens"][1:3])
                if (stop_text and tok.encode(stop_text, bos=False)
                        == free["tokens"][1:3]):
                    break
            else:
                return free, None, None, None
            stopped = fetch(server.port, "/v1/completions",
                            {"prompt": prompt, "max_new_tokens": 6,
                             "stop": stop_text})[1]
            bad = fetch(server.port, "/v1/completions",
                        {"prompt": prompt, "stop": ["x" * 33]})
            return free, stop_text, stopped, bad

        try:
            return await asyncio.get_running_loop().run_in_executor(None, go)
        finally:
            await server.stop()

    free, stop_text, stopped, bad = run(scenario(), timeout=WAIT)
    assert stop_text is not None, free
    assert stopped["tokens"] == free["tokens"][:1]
    assert stop_text not in stopped["text"]
    assert bad[0] == 422 and "UTF-8 bytes" in bad[1]


def test_serve_text_requires_byte_vocab():
    """--text with a vocab too small for bytes fails at construction
    (tests/test_workload.py:2969)."""
    small = {**BASE, "vocab_size": 64}
    cfg = ttf.TransformerConfig(**bridge.config_kwargs(small))
    params = ttf.init_params(0, cfg, device="cpu")
    with pytest.raises(ValueError, match="vocab_size >= 259"):
        InferenceServer(cfg, params, "127.0.0.1", 0, 32, text=True,
                        device="cpu")


def test_serve_cli_text_and_mux_flags():
    """--text and --mux/--no-mux parse and are ported
    (tests/test_workload.py:2986)."""
    parser = serve_cli.build_arg_parser()
    args = parser.parse_args(["--text", "--vocab", "512"])
    assert args.text is True and args.vocab == 512 and args.mux is True
    defaults = parser.parse_args([])
    assert defaults.text is False and defaults.mux is True
    off = parser.parse_args(["--no-mux", "--text"])
    assert off.mux is False
    for argv in (["--text"], ["--no-mux"], ["--mux"]):
        serve_cli.check_ported(parser.parse_args(argv))  # no exit
    assert "text" not in serve_cli._NOT_PORTED
    assert "mux" not in serve_cli._NOT_PORTED


def test_inference_server_metrics_endpoint_equals_jax(run, bridged):
    """The same request sequence to a JAX and a torch replica: both
    /metrics bodies parse, with equal family names, types, help strings
    and label sets, and equal request and token counters
    (tests/test_workload.py:3779)."""
    from prometheus_client.parser import text_string_to_metric_families

    jcfg, cfg, jp, tp = bridged
    sequence = [
        ("/v1/generate", {"tokens": [[1, 2, 3]], "max_new_tokens": 6}),
        ("/v1/generate", {"tokens": [[4, 5]], "max_new_tokens": 4}),
        ("/v1/generate", {"tokens": [[4, 5]], "max_new_tokens": 999}),
        ("/v1/completions", {"prompt": "hi", "max_new_tokens": 5}),
        ("/v1/score", {"tokens": [[1, 2, 3, 4]]}),
        ("/v1/model", None),
    ]

    async def drive(server):
        await server.run()

        def go():
            codes = [fetch(server.port, path, body)[0]
                     for path, body in sequence]
            return codes, fetch(server.port, "/metrics")[1]

        try:
            return await asyncio.get_running_loop().run_in_executor(None, go)
        finally:
            await server.stop()

    j_codes, j_text = run(drive(JaxServer(
        jcfg, jp, "127.0.0.1", 0, max_len=MAX_LEN, text=True)), timeout=WAIT)
    t_codes, t_text = run(drive(InferenceServer(
        cfg, tp, "127.0.0.1", 0, MAX_LEN, text=True, device="cpu")),
        timeout=WAIT)
    assert t_codes == j_codes == [200, 200, 422, 200, 200, 200]
    assert ('containerpilot_serve_requests_total{'
            'code="200",endpoint="generate"} 2.0') in t_text
    assert "containerpilot_serve_generated_tokens_total" in t_text
    assert ('containerpilot_serve_request_seconds_count{'
            'endpoint="generate"} 3.0') in t_text

    def shape(text):
        fams = {}
        for fam in text_string_to_metric_families(text):
            fams[fam.name] = (fam.type, fam.documentation, sorted(
                (s.name, tuple(sorted(s.labels.items())))
                for s in fam.samples))
        return fams

    def values(text, name):
        return {tuple(sorted(s.labels.items())): s.value
                for fam in text_string_to_metric_families(text)
                for s in fam.samples if s.name == name}

    assert shape(t_text) == shape(j_text)
    for name in ("containerpilot_serve_requests_total",
                 "containerpilot_serve_generated_tokens_total",
                 "containerpilot_serve_request_seconds_count",
                 "cp_build_info"):
        assert values(t_text, name) == values(j_text, name), name

"""The port's SSE streaming, logprobs echo and /v1/score over real HTTP
on 127.0.0.1:0 with device="cpu" (workload/serve.py, utils/http.py):
streamed deltas concatenate to the non-streamed tokens, a disconnect
frees the slot, bad compositions are refused with the reference's
messages, the echo equals /v1/score, and /v1/score equals the JAX
package's ``score_logprobs_fn`` on the same params. Mirrors
tests/test_slots.py:380-650 and tests/test_workload.py:3837."""
import asyncio
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from containerpilot_tpu.models import transformer as jtf
from containerpilot_tpu.workload import modelcfg as jmodelcfg
from containerpilot_tpu_torch import bridge
from containerpilot_tpu_torch.models import transformer as ttf
from containerpilot_tpu_torch.utils.http import (
    HTTPServer,
    Response,
    StreamingResponse,
)
from containerpilot_tpu_torch.workload.serve import InferenceServer

BASE = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=1, d_ff=64,
            max_seq_len=64, dtype="float32")
MAX_LEN = 48
WAIT = 120


def model(**over):
    d = {**BASE, **over}
    jcfg = jtf.TransformerConfig(**{**d, "dtype": jnp.float32})
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                "cpu")
    return jcfg, ttf.TransformerConfig(**bridge.config_kwargs(d)), jp, tp


@pytest.fixture(scope="module")
def bridged():
    return model()


async def post(port, path, body):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = json.dumps(body).encode()
    writer.write(
        f"POST {path} HTTP/1.1\r\nHost: x\r\nConnection: close\r\n"
        f"Content-Length: {len(payload)}\r\n\r\n".encode() + payload)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, data = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), data


async def read_sse(port, body, abort_after=None):
    """(status, head, events) of a streamed /v1/generate; with
    ``abort_after`` the client drops the connection after that many
    events."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = json.dumps(body).encode()
    writer.write(
        f"POST /v1/generate HTTP/1.1\r\nHost: x\r\n"
        f"Content-Length: {len(payload)}\r\n\r\n".encode() + payload)
    await writer.drain()
    head = await reader.readuntil(b"\r\n\r\n")
    events, buf = [], b""
    try:
        while abort_after is None or len(events) < abort_after:
            chunk = await reader.read(65536)
            if not chunk:
                break
            buf += chunk
            while b"\n\n" in buf:
                event, buf = buf.split(b"\n\n", 1)
                events.append(json.loads(event[len(b"data: "):]))
    finally:
        writer.close()
    return int(head.split()[1]), head, events


def serving(params, cfg, **kw):
    return InferenceServer(cfg, params, "127.0.0.1", 0, MAX_LEN,
                           device="cpu", **kw)


def test_stream_deltas_concatenate_to_non_streamed(run, bridged):
    """Greedy and sampled: the SSE deltas (one event per window
    boundary) concatenate to the non-streamed row, and the terminal
    event reports the count (tests/test_slots.py:380)."""
    _jcfg, cfg, _jp, tp = bridged
    reqs = [
        {"tokens": [[1, 2, 3]], "max_new_tokens": 7},
        {"tokens": [[4, 5]], "max_new_tokens": 11, "temperature": 0.9,
         "top_k": 12, "seed": 3},
        {"tokens": [[6, 7, 8, 9]], "max_new_tokens": 9, "eos_id": 5},
    ]

    async def scenario():
        server = serving(tp, cfg, slots=2, slot_chunk=3, slot_window=2)
        await server.run()
        try:
            out = []
            for body in reqs:
                status, data = await post(server.port, "/v1/generate", body)
                assert status == 200
                streamed = await read_sse(server.port,
                                          {**body, "stream": True})
                out.append((json.loads(data), streamed))
            return out
        finally:
            await server.stop()

    for plain, (status, head, events) in run(scenario(), timeout=WAIT):
        assert status == 200 and b"text/event-stream" in head
        assert b"Connection: close" in head
        assert events[-1]["done"] is True
        toks = sum((e["tokens"] for e in events[:-1]), [])
        assert toks == plain["tokens"][0]
        assert events[-1]["count"] == len(toks)
        assert len(events) >= 2


def test_stream_disconnect_frees_the_slot(run, bridged):
    """Dropping the connection after the first event cancels the
    request: the slot returns to the pool long before the requested
    length could have decoded, and the server keeps serving
    (tests/test_slots.py:434)."""
    _jcfg, cfg, _jp, tp = bridged

    async def scenario():
        server = serving(tp, cfg, slots=1, slot_chunk=2, slot_window=1)
        await server.run()
        engine = server.slot_engine
        try:
            status, _head, events = await read_sse(server.port, {
                "tokens": [[7, 8, 9]], "max_new_tokens": MAX_LEN - 3,
                "stream": True}, abort_after=1)
            deadline = time.monotonic() + 30
            while engine.stats["active"] and time.monotonic() < deadline:
                await asyncio.sleep(0.01)
            active = engine.stats["active"]
            out = engine.tokens_out
            status2, data = await post(server.port, "/v1/generate", {
                "tokens": [[1, 2]], "max_new_tokens": 3})
            return status, events, active, out, status2, data
        finally:
            await server.stop()

    status, events, active, tokens_out, status2, data = run(
        scenario(), timeout=WAIT)
    assert status == 200 and "tokens" in events[0]
    assert active == 0
    # warmup's tokens + the cancelled row's partial decode, well short of
    # the MAX_LEN - 3 it asked for
    assert tokens_out < (4 + 3) + (MAX_LEN - 3)
    assert status2 == 200 and len(json.loads(data)["tokens"][0]) == 3


@pytest.mark.parametrize("body,slots,match", [
    ({"stream": True}, 0, "stream requires --slots"),
    ({"stream": True, "stop": [[3]]}, 1, "stream does not compose with stop"),
    ({"stream": True, "logprobs": True}, 1,
     "stream does not compose with logprobs"),
    ({"stream": True, "beam_width": 2}, 1,
     "stream does not compose with beam_width"),
    ({"stream": True, "n": 2}, 1, "n does not compose with stream"),
    ({"beam_width": 2, "temperature": 0.5}, 1,
     "beam search is deterministic"),
])
def test_bad_compositions_are_refused(run, bridged, body, slots, match):
    """Each refusal is a 422 with the reference's message before any
    decode starts (tests/test_slots.py:614)."""
    _jcfg, cfg, _jp, tp = bridged

    async def scenario():
        server = serving(tp, cfg, slots=slots, slot_chunk=2)
        await server.run()
        try:
            return await post(server.port, "/v1/generate", {
                "tokens": [[1, 2]], "max_new_tokens": 4, **body})
        finally:
            await server.stop()

    status, data = run(scenario(), timeout=WAIT)
    assert status == 422 and match in data.decode()


def test_logprobs_echo_equals_score(run, bridged):
    """{"logprobs": true} echoes the trimmed generated ids' logprobs
    from one teacher-forced pass: exactly /v1/score's tail on prompt +
    generated; rows of different trimmed lengths share one echo batch
    (tests/test_workload.py:3837)."""
    _jcfg, cfg, _jp, tp = bridged

    async def scenario():
        server = serving(tp, cfg)
        await server.run()
        try:
            prompt = [1, 2, 3]
            _, data = await post(server.port, "/v1/generate", {
                "tokens": [prompt], "max_new_tokens": 6, "logprobs": True})
            gen = json.loads(data)
            row = gen["tokens"][0]
            _, data = await post(server.port, "/v1/score",
                                 {"tokens": [prompt + row]})
            score = json.loads(data)
            _, data = await post(server.port, "/v1/generate", {
                "tokens": [prompt, [4, 5, 6]], "max_new_tokens": 6,
                "eos_id": row[1], "logprobs": True})
            return gen, row, score, json.loads(data)
        finally:
            await server.stop()

    gen, row, score, two = run(scenario(), timeout=WAIT)
    lps = gen["logprobs"][0]
    assert len(lps) == len(row) and all(x <= 0.0 for x in lps)
    assert lps == score["logprobs"][0][-len(row):]
    assert score["sums"][0] == pytest.approx(sum(score["logprobs"][0]),
                                             abs=1e-5)
    assert len(two["tokens"][0]) < len(two["tokens"][1])
    for toks, lp_row in zip(two["tokens"], two["logprobs"]):
        assert len(toks) == len(lp_row)


@pytest.mark.parametrize("over,width", [
    ({}, 20),
    ({"window": 8, "n_heads": 4, "n_kv_heads": 2}, 40),
])
def test_score_matches_jax_score_logprobs_fn(run, over, width):
    """/v1/score equals the JAX package's score_logprobs_fn on the same
    params at 1e-4, dense and windowed GQA; a one-token row is a 422."""
    jcfg, cfg, jp, tp = model(**over)
    rows = np.random.default_rng(4).integers(0, 64, (2, width)).tolist()
    ref = np.asarray(jmodelcfg.score_logprobs_fn(jcfg)(
        jp, jnp.asarray(rows, jnp.int32)))

    async def scenario():
        server = serving(tp, cfg)
        await server.run()
        try:
            ok = await post(server.port, "/v1/score", {"tokens": rows})
            short = await post(server.port, "/v1/score", {"tokens": [[3]]})
            return ok, short
        finally:
            await server.stop()

    (status, data), short = run(scenario(), timeout=WAIT)
    assert status == 200
    got = json.loads(data)
    np.testing.assert_allclose(np.asarray(got["logprobs"]), ref, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got["sums"], ref.sum(axis=1), rtol=1e-4,
                               atol=1e-4)
    assert short[0] == 422


def test_streaming_response_closes_once_and_keeps_keepalive(run):
    """A StreamingResponse is close-delimited; a client disconnect
    aclose()s the iterator (its finally runs) and calls ``close``; a
    buffered response on another connection keeps keep-alive."""
    seen = {"finally": 0, "close": 0}

    async def scenario():
        gate = asyncio.Event()

        async def chunks():
            try:
                yield b"data: 1\n\n"
                await gate.wait()  # never set: the client leaves first
                yield b"data: 2\n\n"
            finally:
                seen["finally"] += 1

        def close():
            seen["close"] += 1

        async def stream(_req):
            return StreamingResponse(chunks(), close=close)

        async def ok(_req):
            return Response(200, b"ok\n")

        server = HTTPServer()
        server.route("GET", "/stream", stream)
        server.route("GET", "/ok", ok)
        await server.start_tcp("127.0.0.1", 0)
        try:
            reader, writer = await asyncio.open_connection(
                "127.0.0.1", server.bound_port)
            writer.write(b"GET /stream HTTP/1.1\r\nHost: x\r\n\r\n")
            await writer.drain()
            head = await reader.readuntil(b"\r\n\r\n")
            first = await reader.readuntil(b"\n\n")
            writer.close()
            for _ in range(200):
                if seen["close"]:
                    break
                await asyncio.sleep(0.01)
            reader, writer = await asyncio.open_connection(
                "127.0.0.1", server.bound_port)
            statuses = []
            for _ in range(2):
                writer.write(b"GET /ok HTTP/1.1\r\nHost: x\r\n\r\n")
                await writer.drain()
                h = await reader.readuntil(b"\r\n\r\n")
                await reader.readexactly(3)
                statuses.append((int(h.split()[1]), b"keep-alive" in h))
            writer.close()
            return head, first, statuses
        finally:
            await server.stop()

    head, first, statuses = run(scenario(), timeout=30)
    assert b"200 OK" in head and b"Connection: close" in head
    assert b"Content-Length" not in head and first == b"data: 1\n\n"
    assert seen == {"finally": 1, "close": 1}
    assert statuses == [(200, True), (200, True)]

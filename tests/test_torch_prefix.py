"""The port's prefix reuse and chunked prefill on the CPU
(workload/serve_prefix.py, workload/serve_strategies.py,
models/decode.py's chunked_prefill/extend_pieces, kvtier/digest.py):
the digest's bytes equal the reference's, chunked prefill equals the
JAX chunked prefill (logits and cache) with the reference's piece plan,
a prefix hit leaves the stored entry bit-unchanged (the port extends
caches in place), and the engine, the prefix path and the chunked path
match solo generate, also through the server's routing."""
import asyncio
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from containerpilot_tpu.kvtier import digest as jdigest
from containerpilot_tpu.models import decode as jdecode
from containerpilot_tpu.models import transformer as jtf
from containerpilot_tpu_torch import bridge
from containerpilot_tpu_torch.kvtier import digest as tdigest
from containerpilot_tpu_torch.models import decode as tdecode
from containerpilot_tpu_torch.models import transformer as ttf
from containerpilot_tpu_torch.workload import serve_prefix
from containerpilot_tpu_torch.workload.serve import InferenceServer
from containerpilot_tpu_torch.workload.serve_prefix import (
    PrefixCache,
    generate_with_prefix,
    plan_reuse,
    reuse_admission,
)
from containerpilot_tpu_torch.workload.serve_slots import SlotEngine

BASE = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=1, d_ff=64,
            max_seq_len=64, dtype="float32")
CFG = ttf.TransformerConfig(**bridge.config_kwargs(BASE))
MAX_LEN = 48
WAIT = 120


@pytest.fixture(scope="module")
def params():
    jcfg = jtf.TransformerConfig(**{**BASE, "dtype": jnp.float32})
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    return bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                  "cpu")


def solo(params, tokens, max_new, **kw):
    seed = kw.pop("seed", 0)
    return tdecode.generate(params, torch.tensor([tokens]), CFG, max_new,
                            MAX_LEN, rng=seed, **kw)[0].tolist()


@pytest.mark.parametrize("rows", [
    [list(range(100, 116))],
    [list(range(100, 116)) + [1, 2, 3], [7] * 20, [-3, 5] * 9],
    [list(range(i, i + 40)) for i in range(200)],   # truncated digest
    [[1, 2, 3]],                                     # too short
])
def test_digest_bytes_match_reference(rows):
    assert tdigest.FP_TOKENS == jdigest.FP_TOKENS == serve_prefix.MIN_REUSE
    assert tdigest.DIGEST_MAX_BYTES == jdigest.DIGEST_MAX_BYTES
    tfps = [tdigest.prefix_fingerprint(r) for r in rows]
    assert tfps == [jdigest.prefix_fingerprint(r) for r in rows]
    fps = [fp for fp in tfps if fp is not None]
    for version, cap in ((3, None), (12, 64)):
        kw = {} if cap is None else {"max_bytes": cap}
        assert tdigest.encode_fingerprints(version, fps, **kw) == (
            jdigest.encode_fingerprints(version, fps, **kw))


@pytest.mark.parametrize("over,chunk_len", [
    ({}, 7), ({"n_kv_heads": 2}, 7), ({}, 16), ({}, 4),
])
def test_chunked_prefill_matches_jax(over, chunk_len, monkeypatch):
    """Logits and cache equal the JAX chunked_prefill's at the
    tolerances of tests/test_workload.py's chunked-prefill test, and the
    pieces are the reference's plan."""
    d = {**BASE, "n_heads": 4, "n_layers": 2, "d_ff": 128, **over}
    jcfg = jtf.TransformerConfig(**{**d, "dtype": jnp.float32})
    tcfg = ttf.TransformerConfig(**bridge.config_kwargs(d))
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                "cpu")
    toks = np.random.default_rng(1).integers(0, 64, (2, 23)).astype(np.int32)
    pieces = []
    real = jdecode._jitted_extend

    def spy(cfg):
        fn = real(cfg)

        def run(p, cache, chunk):
            pieces.append(chunk.shape[1])
            return fn(p, cache, chunk)
        return run

    monkeypatch.setattr(jdecode, "_jitted_extend", spy)
    ref_logits, ref_cache = jdecode.chunked_prefill(
        jp, jnp.asarray(toks), jcfg, 64, chunk_len=chunk_len)
    got_logits, got_cache = tdecode.chunked_prefill(
        tp, torch.from_numpy(toks).long(), tcfg, 64, chunk_len=chunk_len)
    assert tdecode.piece_plan(23, chunk_len) == pieces
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(ref_logits),
                               rtol=2e-3, atol=2e-3)
    for name in ("k", "v"):
        np.testing.assert_allclose(got_cache[name].numpy(),
                                   np.asarray(ref_cache[name]),
                                   rtol=1e-4, atol=1e-5)
    assert got_cache["pos"] == int(ref_cache["pos"]) == 23
    with pytest.raises(ValueError, match="chunk_len"):
        tdecode.chunked_prefill(tp, torch.from_numpy(toks).long(), tcfg, 64,
                                chunk_len=0)


def test_prefix_hit_leaves_stored_entry_unchanged(params):
    """The port extends caches in place: a hit must extend a copy. Two
    exact hits on one entry give the same logits, and the entry's
    tensors stay bit-identical."""
    pc = PrefixCache(entries=2)
    row = [(i * 5 + 2) % 64 for i in range(20)]
    with torch.inference_mode():
        logits, cache = tdecode.prefill(params, torch.tensor([row]), CFG,
                                        MAX_LEN)
    pc.store(tuple(row), cache)
    snapshot = {k: cache[k].clone() for k in ("k", "v")}
    assert plan_reuse(pc, row)[0] == 19  # an exact repeat re-extends 1
    first = reuse_admission(pc, row, CFG, params)
    second = reuse_admission(pc, row + [9, 9, 5], CFG, params)
    third = reuse_admission(pc, row, CFG, params)
    for name in ("k", "v"):
        assert torch.equal(cache[name], snapshot[name])
        assert first[1][name].data_ptr() != cache[name].data_ptr()
    assert cache["pos"] == 20
    assert torch.equal(first[0], third[0])
    torch.testing.assert_close(first[0], logits, rtol=1e-5, atol=1e-5)
    assert second[1]["pos"] == 23 and third[1]["pos"] == 20
    assert pc.stats == {"hits": 3, "misses": 0, "tokens_reused": 19 + 7 + 19,
                        "spilled": 0, "readmitted": 0, "spill_bytes": 0}
    # too short a match is a miss
    assert reuse_admission(pc, row[:10] + [1] * 10, CFG, params) is None
    assert pc.stats["misses"] == 1


def test_prefix_cache_lru_and_digest():
    pc = PrefixCache(entries=2)
    rows = [tuple(range(i, i + 16)) for i in range(3)]
    for r in rows:
        pc.store(r, {"pos": 16})
    assert len(pc) == 2 and pc.get(rows[0]) is None
    want = jdigest.encode_fingerprints(
        pc.version, [jdigest.prefix_fingerprint(r) for r in rows[1:]])
    assert pc.digest() == want and pc.digest() is pc.digest()
    assert pc.match_len(list(rows[2]) + [5]) == 16


def test_prefix_cache_admission_matches_generate(params):
    """--prefix-cache composes with the pool: cold miss (chunked), exact
    repeat (sampled) and the chat-turn hit all match solo generate, and
    repeated exact hits keep decoding the same tokens."""
    pc = PrefixCache(entries=4)
    eng = SlotEngine(CFG, params, MAX_LEN, slots=2, chunk=3,
                     prefix_cache=pc, prefill_chunk=4)
    try:
        base = [(i * 5 + 2) % 64 for i in range(20)]
        assert eng.submit(base, max_new=6).result(timeout=WAIT) == solo(
            params, base, 6)
        assert pc.stats["misses"] == 1 and len(pc) == 1
        kw = dict(temperature=0.7, seed=3)
        for _ in range(2):
            got = eng.submit(base, max_new=6, **kw).result(timeout=WAIT)
            assert got == solo(params, base, 6, **kw)
        assert pc.stats["hits"] == 2 and pc.stats["tokens_reused"] > 0
        turn2 = base + [9, 9, 5]
        got = eng.submit(turn2, max_new=6).result(timeout=WAIT)
        assert got == solo(params, turn2, 6)
        assert pc.stats["hits"] == 3 and len(pc) == 2
        # warmup-sized prompts skip the prefix machinery
        eng.submit([0] * 4, max_new=3).result(timeout=WAIT)
        assert len(pc) == 2 and pc.stats["misses"] == 1
    finally:
        eng.stop()


async def _post(port, body):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = json.dumps(body).encode()
    writer.write(
        b"POST /v1/generate HTTP/1.1\r\nHost: x\r\nConnection: close\r\n"
        + f"Content-Length: {len(payload)}\r\n\r\n".encode() + payload
    )
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, data = raw.partition(b"\r\n\r\n")
    assert int(head.split()[1]) == 200, data
    return json.loads(data)["tokens"]


async def _get(port, path):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: x\r\n"
                 "Connection: close\r\n\r\n".encode())
    await writer.drain()
    raw = await reader.read()
    writer.close()
    return json.loads(raw.partition(b"\r\n\r\n")[2])


def test_server_routes_prefix_and_chunked_without_slots(run, params,
                                                        monkeypatch):
    """Without --slots, a single row takes the prefix path (miss seeds,
    hit reuses) or, past --prefill-chunk, the chunked path; both match
    solo generate, and /v1/model reports the cache and its digest."""
    from containerpilot_tpu_torch.workload import serve_strategies

    taken = []
    for mod, name in ((serve_strategies, "run_chunked"),):
        real = getattr(mod, name)
        monkeypatch.setattr(
            mod, name,
            lambda *a, _real=real, _n=name, **k: taken.append(_n)
            or _real(*a, **k))
    base = [(i * 7 + 1) % 64 for i in range(20)]

    async def scenario(prefix):
        server = InferenceServer(CFG, params, "127.0.0.1", 0, MAX_LEN,
                                 device="cpu", prefill_chunk=8,
                                 prefix_cache_entries=prefix)
        await server.run()
        try:
            outs = [
                await _post(server.port, {"tokens": [base],
                                          "max_new_tokens": 5}),
                await _post(server.port, {"tokens": [base + [3, 4]],
                                          "max_new_tokens": 5,
                                          "temperature": 0.9, "seed": 4}),
            ]
            return outs, await _get(server.port, "/v1/model")
        finally:
            await server.stop()

    outs, info = run(scenario(prefix=2), timeout=WAIT)
    assert outs[0] == [solo(params, base, 5)]
    assert outs[1] == [solo(params, base + [3, 4], 5, temperature=0.9,
                            seed=4)]
    assert info["prefix_cache"] == {
        "entries": 2, "hits": 1, "misses": 1, "tokens_reused": 6,
        "spilled": 0, "readmitted": 0, "spill_bytes": 0}
    assert info["prefix_digest"] == jdigest.encode_fingerprints(
        2, [jdigest.prefix_fingerprint(base)])
    assert taken == []
    outs, info = run(scenario(prefix=0), timeout=WAIT)
    assert outs[0] == [solo(params, base, 5)]
    assert taken == ["run_chunked", "run_chunked"]
    assert info["prefix_cache"] is None and info["slot_engine"] is None


def solo_cfg(params, tokens, max_new, cfg):
    return tdecode.generate(params, torch.tensor([tokens]), cfg, max_new,
                            MAX_LEN)[0].tolist()


def test_prefix_cache_with_kv_int8_keeps_entries_and_matches_generate():
    """Under kv_int8 a prefix hit copies the int8 k/v AND their scales
    up to the reused length, and the Batcher-side prefix path decodes a
    copy of every leaf: repeated hits decode solo generate's tokens and
    leave the stored entry's leaves bit-unchanged."""
    cfg = dataclasses.replace(CFG, kv_int8=True)
    params = ttf.init_params(2, cfg, device="cpu")
    pc = PrefixCache(entries=2)
    eng = SlotEngine(cfg, params, MAX_LEN, slots=2, chunk=3, prefix_cache=pc)
    try:
        base = [(i * 3 + 1) % 64 for i in range(20)]
        for _ in range(3):
            got = eng.submit(base, max_new=6).result(timeout=WAIT)
            assert got == solo_cfg(params, base, 6, cfg)
        entry = pc.get(tuple(base))
        assert set(entry) == {"k", "v", "k_scale", "v_scale", "pos"}
        snapshot = {k: v.clone() for k, v in entry.items() if k != "pos"}
        turn2 = base + [9, 9, 5]
        got = eng.submit(turn2, max_new=6).result(timeout=WAIT)
        assert got == solo_cfg(params, turn2, 6, cfg)
        assert pc.stats["hits"] == 3
        for name, leaf in snapshot.items():
            assert torch.equal(entry[name], leaf), name
    finally:
        eng.stop()

    class _Srv:  # the fields generate_with_prefix reads
        pass

    srv = _Srv()
    srv.prefix_cache, srv.cfg, srv.params = pc, cfg, params
    srv.max_len, srv.prefill_chunk = MAX_LEN, 0
    srv.batch_stats = {"calls": 0, "rows": 0}
    for _ in range(2):
        out = generate_with_prefix(srv, base, 6, 0.0, 0, 0.0, -1, 0)
        assert out[0] == solo_cfg(params, base, 6, cfg)
    for name, leaf in snapshot.items():
        assert torch.equal(entry[name], leaf), name

"""The port's KV spill tier, prefix cache and wire codecs against the
reference: cases mirrored from ``tests/test_kvtier.py:109-341`` (spill
round trip, byte budget, fingerprint candidates, take-once, spill on
eviction and readmit, ``reuse_admission`` readmit byte parity), and the
KV and weight manifests of both packages equal byte for byte on the same
numpy input (bf16 built with ``ml_dtypes``), each package's rebuild
reading the other's stream."""
import threading
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from containerpilot_tpu.fleet import standby as ref_standby
from containerpilot_tpu.kvtier import handoff as ref_handoff
from containerpilot_tpu.models import quantized as jquant
from containerpilot_tpu.models import transformer as jtf
from containerpilot_tpu.workload import serve_prefix as ref_prefix
from containerpilot_tpu_torch import bridge
from containerpilot_tpu_torch.fleet import standby
from containerpilot_tpu_torch.kvtier import (
    FP_TOKENS,
    HostSpillTier,
    handoff,
    parse_digest,
    prefix_fingerprint,
)
from containerpilot_tpu_torch.models import transformer as ttf
from containerpilot_tpu_torch.workload.serve_prefix import (
    BUCKET,
    MIN_REUSE,
    PrefixCache,
    generate_with_prefix,
    plan_reuse,
    reuse_admission,
)

BASE = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=1, d_ff=64,
            max_seq_len=128, dtype="float32")


def _tier(max_bytes):
    return HostSpillTier(max_bytes, device="cpu")


def _entry(tag: int, rows: int = 8) -> dict:
    """A fake KV entry: deterministic contents, predictable bytes."""
    base = torch.full((rows, 16), float(tag))
    return {"k": base, "v": base + 1, "pos": rows}


def _entry_bytes(rows: int = 8) -> int:
    return 2 * rows * 16 * 4 + 4


def _equal(a, b):
    assert a.keys() == b.keys()
    for name in a:
        if isinstance(a[name], torch.Tensor):
            assert a[name].dtype == b[name].dtype
            assert torch.equal(a[name], b[name]), name
        else:
            assert a[name] == b[name], name


# -- host spill tier (tests/test_kvtier.py:109-184) -----------------------


def test_spill_roundtrip_is_byte_exact():
    tier = _tier(1 << 20)
    assert tier.put((1, 2, 3), _entry(3))
    back = tier.take((1, 2, 3))
    _equal(back, _entry(3))
    assert list(back) == ["k", "pos", "v"]  # the host tree's key order
    assert tier.stats["spilled"] == 1 and tier.stats["readmitted"] == 1


def test_spill_byte_budget_evicts_lru_and_refuses_oversize():
    per = _entry_bytes()
    tier = _tier(2 * per)  # room for exactly two entries
    for tag in range(4):
        assert tier.put((tag,), _entry(tag))
    assert len(tier) == 2 and tier.bytes_used <= tier.max_bytes
    assert tier.stats["evicted"] == 2
    assert tier.take((0,)) is None and tier.take((1,)) is None
    assert tier.take((2,)) is not None and tier.take((3,)) is not None
    big = _tier(per - 1)
    assert not big.put((9,), _entry(9))
    assert big.stats["refused"] == 1 and len(big) == 0
    tier.put((5,), _entry(5))
    tier.put((5,), _entry(6))
    assert len(tier) == 1 and tier.bytes_used == per


def test_spill_candidates_bucket_by_fingerprint():
    tier = _tier(1 << 20)
    key_a = tuple(range(FP_TOKENS)) + (1, 2)
    key_a2 = tuple(range(FP_TOKENS)) + (9,)
    key_b = tuple(range(50, 50 + FP_TOKENS))
    for key in (key_a, key_a2, key_b):
        assert tier.put(key, _entry(1))
    fp_a = prefix_fingerprint(list(key_a))
    assert set(tier.candidates(fp_a)) == {key_a, key_a2}
    assert tier.candidates(prefix_fingerprint(list(key_b))) == [key_b]
    assert tier.candidates(None) == [] and tier.candidates(0x1234) == []
    assert tier.take(key_a) is not None
    assert set(tier.candidates(fp_a)) == {key_a2}
    tight = _tier(_entry_bytes())
    tight.put(key_a, _entry(1))
    tight.put(key_b, _entry(2))  # evicts key_a
    assert tight.candidates(fp_a) == []


def test_spill_take_serves_a_key_exactly_once():
    tier = _tier(1 << 20)
    tier.put((1,), _entry(1))
    assert tier.take((1,)) is not None
    assert tier.take((1,)) is None and tier.stats["misses"] == 1
    assert tier.take((404,)) is None and tier.stats["misses"] == 2


# -- prefix cache + spill (tests/test_kvtier.py:187-341) ------------------


def test_prefix_cache_spills_on_eviction_and_readmits():
    pc = PrefixCache(1, spill=_tier(1 << 20))
    key_a = tuple(range(MIN_REUSE + 4))
    key_b = tuple(range(100, 100 + MIN_REUSE))
    pc.store(key_a, _entry(1))
    pc.store(key_b, _entry(2))  # the device LRU evicts A to the tier
    assert pc.stats["spilled"] == 1 and pc.stats["spill_bytes"] > 0
    n, key = pc.best_match(list(key_a) + [1, 2])
    assert key == key_a and n == len(key_a)
    got = pc.get(key_a)
    assert pc.stats["readmitted"] == 1 and pc.readmit_seconds > 0.0
    with pc._lock:
        assert list(pc._cache) == [key_a]
    _equal(got, _entry(1))
    assert pc.export_keys() == [key_a, key_b]  # device MRU, then spilled


def test_match_then_evicted_between_match_and_fetch():
    pc = PrefixCache(1, spill=_tier(1 << 20))
    key = tuple(range(MIN_REUSE))
    pc.store(key, _entry(1))
    _n, matched = pc.best_match(list(key))
    assert matched == key
    pc.store(tuple(range(50, 50 + MIN_REUSE)), _entry(2))
    assert pc.spill.take(key) is not None
    assert pc.get(matched) is None
    assert plan_reuse(pc, list(key) + [1] * BUCKET) == (0, None)


def test_reuse_admission_counts_miss_when_base_vanishes():
    class RacingCache(PrefixCache):
        def get(self, key):
            with self._lock:
                self._cache.pop(key, None)
            if self.spill is not None:
                self.spill.take(key)
            return super().get(key)

    pc = RacingCache(2, spill=_tier(1 << 20))
    key = tuple(range(MIN_REUSE + BUCKET))
    pc.store(key, _entry(1))
    assert reuse_admission(pc, list(key) + [3] * BUCKET, cfg=None,
                           params=None) is None
    assert pc.stats["misses"] == 1 and pc.stats["hits"] == 0


def test_readmit_under_concurrent_evictions():
    pc = PrefixCache(1, spill=_tier(3 * _entry_bytes()))
    hot = tuple(range(MIN_REUSE))
    pc.store(hot, _entry(7))
    stop = threading.Event()
    errors = []

    def churn():
        tag = 100
        try:
            while not stop.is_set():
                tag += 1
                pc.store(tuple(range(tag * 50, tag * 50 + MIN_REUSE)),
                         _entry(tag % 50))
        except Exception as exc:  # pragma: no cover - the assertion
            errors.append(exc)

    t = threading.Thread(target=churn, daemon=True)
    t.start()
    served = 0
    try:
        for _ in range(200):
            got = pc.get(hot)
            if got is not None:
                served += 1
                assert torch.equal(got["k"], _entry(7)["k"])
                pc.store(hot, got)
            else:
                pc.store(hot, _entry(7))
    finally:
        stop.set()
        t.join(timeout=10)
    assert not errors and served > 0
    assert pc.spill.bytes_used <= pc.spill.max_bytes
    assert pc.stats["readmitted"] == pc.spill.stats["readmitted"]


def test_digest_advertises_spilled_and_adopted_entries():
    pc = PrefixCache(2, spill=_tier(1 << 20))
    assert parse_digest(pc.digest()) == (0, frozenset())
    key = tuple(range(MIN_REUSE))
    pc.store(key, _entry(1))
    v1, fps1 = parse_digest(pc.digest())
    assert fps1 == {prefix_fingerprint(key)}
    assert pc.digest() is pc.digest()
    pc.store(tuple(range(60, 60 + MIN_REUSE)), _entry(2))
    pc.store(tuple(range(90, 90 + MIN_REUSE)), _entry(3))
    v2, fps2 = parse_digest(pc.digest())
    assert v2 > v1 and prefix_fingerprint(key) in fps2 and len(fps2) == 3
    adopted_key = tuple(range(200, 200 + MIN_REUSE))
    assert pc.adopt_host(adopted_key, _entry(4)) == _entry_bytes()
    assert prefix_fingerprint(adopted_key) in parse_digest(pc.digest())[1]
    assert PrefixCache(1).adopt_host(adopted_key, _entry(4)) == 0


def test_spill_disabled_keeps_stats_schema_zeroed():
    pc = PrefixCache(1)
    for tag in range(3):
        pc.store(tuple(range(tag * 40, tag * 40 + MIN_REUSE)), _entry(tag))
    assert pc.stats["spilled"] == pc.stats["readmitted"] == 0
    assert pc.stats["spill_bytes"] == 0
    assert pc.get(tuple(range(MIN_REUSE))) is None
    assert pc.stats.keys() == ref_prefix.PrefixCache(1).stats.keys()


def test_reuse_admission_readmits_from_spill_byte_parity():
    """A server whose device LRU holds ONE entry plus a spill tier gives
    the tokens of a server with a roomy LRU, and of the reference on the
    same params: the host round trip is invisible to rewind+extend."""
    from containerpilot_tpu.kvtier import HostSpillTier as RefSpill

    jcfg = jtf.TransformerConfig(**{**BASE, "dtype": jnp.float32})
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                "cpu")
    tcfg = ttf.TransformerConfig(**bridge.config_kwargs(BASE))

    def srv(pc, cfg, params, fn):
        return SimpleNamespace(
            cfg=cfg, params=params, max_len=128, prefill_chunk=0,
            prefix_cache=pc, batch_stats={"calls": 0, "rows": 0}), fn

    servers = {
        "spilling": srv(PrefixCache(1, spill=_tier(1 << 20)), tcfg, tp,
                        generate_with_prefix),
        "roomy": srv(PrefixCache(4), tcfg, tp, generate_with_prefix),
        "reference": srv(ref_prefix.PrefixCache(1, spill=RefSpill(1 << 20)),
                         jcfg, jp, ref_prefix.generate_with_prefix),
    }
    turn_a = list(range(1, 33))
    turn_b = [9] * 32
    turn_a2 = turn_a + [50] * 16
    outs = {
        name: [fn(s, turn, 8, 0.0, 0, 0.0, -1, 0)
               for turn in (turn_a, turn_b, turn_a2)]
        for name, (s, fn) in servers.items()
    }
    assert outs["spilling"] == outs["roomy"] == outs["reference"]
    stats = servers["spilling"][0].prefix_cache.stats
    assert stats["spilled"] >= 1 and stats["readmitted"] == 1, stats
    assert stats["hits"] == 1 and stats["tokens_reused"] >= 16, stats
    assert servers["roomy"][0].prefix_cache.stats["readmitted"] == 0
    assert servers["reference"][0].prefix_cache.stats == stats


# -- the KV wire, byte for byte against the reference ---------------------


def _numpy_entry(kind: str):
    """The same entry as numpy (what the reference serializes from a
    device_get'd JAX cache) and as the port's host tree."""
    rng = np.random.default_rng(0)
    shape = (2, 1, 64, 2, 16)
    if kind == "bf16":
        k = rng.standard_normal(shape).astype(ml_dtypes.bfloat16)
        v = rng.standard_normal(shape).astype(ml_dtypes.bfloat16)
        ref = {"k": k, "pos": np.asarray(24, np.int32), "v": v}
        port = {"k": bridge._to_torch(k), "pos": 24, "v": bridge._to_torch(v)}
    else:  # the int8 KV layout: int8 k/v, float32 scales per (token, head)
        q = rng.integers(-127, 128, shape).astype(np.int8)
        s = rng.random(shape[:-1]).astype(np.float32)
        ref = {"k": q, "k_scale": s, "pos": np.asarray(24, np.int32),
               "v": -q, "v_scale": 2 * s}
        port = {"k": torch.from_numpy(q.copy()),
                "k_scale": torch.from_numpy(s.copy()), "pos": 24,
                "v": torch.from_numpy(-q), "v_scale": torch.from_numpy(2 * s)}
    return ref, port


def _chunks(manifest, blobs):
    return [blobs[c["leaf"]][c["offset"]:c["offset"] + c["len"]]
            for c in manifest["chunks"]]


@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("chunk", [handoff.KV_CHUNK, 1000])
def test_kv_manifest_equals_the_references_byte_for_byte(kind, chunk):
    ref_tree, port_tree = _numpy_entry(kind)
    want_m, want_blobs = ref_handoff.kv_transfer_plan(ref_tree, chunk)
    want = ref_handoff.encode_kv_manifest(want_m)
    for tree in (ref_tree, port_tree):
        got_m, got_blobs = handoff.kv_transfer_plan(tree, chunk)
        assert handoff.encode_kv_manifest(got_m) == want
        assert got_blobs == want_blobs


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_each_rebuild_kv_reads_the_others_stream(kind):
    ref_tree, port_tree = _numpy_entry(kind)
    ref_m, ref_blobs = ref_handoff.kv_transfer_plan(ref_tree, 1000)
    _equal(handoff.rebuild_kv(ref_m, _chunks(ref_m, ref_blobs)), port_tree)
    port_m, port_blobs = handoff.kv_transfer_plan(port_tree, 1000)
    back = ref_handoff.rebuild_kv(port_m, _chunks(port_m, port_blobs))
    assert back.keys() == ref_tree.keys()
    for name, leaf in ref_tree.items():
        assert back[name].dtype == leaf.dtype
        np.testing.assert_array_equal(back[name], leaf)


def test_rebuild_kv_refuses_a_malformed_stream():
    _ref, port_tree = _numpy_entry("bf16")
    m, blobs = handoff.kv_transfer_plan(port_tree, 1000)
    chunks = _chunks(m, blobs)
    with pytest.raises(handoff.KVTransferError):
        handoff.rebuild_kv(m, chunks[:-1])
    with pytest.raises(handoff.KVTransferError):
        handoff.rebuild_kv({**m, "skeleton": {"x": 99}}, chunks)
    bad = {**m, "leaves": [dict(m["leaves"][0], dtype="float8")]
           + m["leaves"][1:]}
    with pytest.raises(handoff.KVTransferError):
        handoff.rebuild_kv(bad, chunks)


def test_plan_migration_equals_the_references():
    keys = [tuple(range(i, i + 20)) for i in range(0, 90, 10)]
    keys += [tuple(range(20)) + (7,), (1, 2, 3)]
    targets = [("r2", frozenset({prefix_fingerprint(list(keys[3]))})),
               ("r1", frozenset())]
    assert handoff.plan_migration(keys, targets) == (
        ref_handoff.plan_migration(keys, targets))
    assert handoff.plan_migration(reversed(keys), targets) == (
        handoff.plan_migration(keys, targets))
    assert handoff.plan_migration(keys, []) == []


# -- the weight wire, byte for byte against the reference -----------------


def _param_sets(kind):
    """``kind`` is float32, bf16 or int8, with a "moe_" prefix for a
    two-expert MoE tree."""
    experts = 2 if kind.startswith("moe_") else 0
    kind = kind.removeprefix("moe_")
    jcfg = jtf.TransformerConfig(**{**BASE, "dtype": jnp.float32,
                                    "moe_experts": experts})
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    if kind == "bf16":
        jp = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), jp)
    elif kind == "int8":
        jp = jquant.quantize_model_params(jp)
    np_tree = jax.tree_util.tree_map(np.asarray, jp)
    return jp, np_tree, bridge.params_from_jax(np_tree, "cpu")


@pytest.mark.parametrize("kind", ["float32", "bf16", "int8", "moe_float32",
                                  "moe_bf16", "moe_int8"])
def test_weights_manifest_equals_the_references_byte_for_byte(kind):
    """An MoE tree (router, moe_w_in, moe_w_out; int8 experts with their
    scales) included: tree_flatten's sorted keys put the MoE leaves in
    their own order."""
    jp, _np_tree, tp = _param_sets(kind)
    if kind.startswith("moe_"):
        assert "router" in tp["layers"] and "w_gate" not in tp["layers"]
    want = ref_standby.encode_manifest(
        ref_standby.weights_manifest(jp, chunk_bytes=4096))
    got = standby.encode_manifest(
        standby.weights_manifest(tp, chunk_bytes=4096))
    assert got == want
    names = [name for name, _ in standby.param_leaves(tp)]
    assert names == [jax.tree_util.keystr(path) for path, _ in
                     jax.tree_util.tree_flatten_with_path(jp)[0]]


@pytest.mark.parametrize("kind", ["float32", "bf16", "int8", "moe_float32",
                                  "moe_bf16", "moe_int8"])
def test_each_rebuild_params_reads_the_others_stream(kind):
    """An MoE tree (router, moe_w_in, moe_w_out; int8 experts with their
    scales) included: tree_flatten's sorted keys put the MoE leaves in
    their own order."""
    jp, np_tree, tp = _param_sets(kind)
    ref_m = ref_standby.weights_manifest(jp, chunk_bytes=4096)
    ref_leaves = [ref_standby.leaf_bytes(x)
                  for x in jax.tree_util.tree_leaves(jp)]
    got = standby.rebuild_params(ref_m, _chunks(ref_m, ref_leaves), tp)
    for (name, a), (_n, b) in zip(standby.param_leaves(got),
                                  standby.param_leaves(tp)):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    port_m = standby.weights_manifest(tp, chunk_bytes=4096)
    port_leaves = [standby.leaf_bytes(x)
                   for _n, x in standby.param_leaves(tp)]
    back = ref_standby.rebuild_params(
        port_m, _chunks(port_m, port_leaves), jp)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(np_tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_rebuild_params_refuses_a_config_mismatch():
    _jp, _np, tp = _param_sets("float32")
    m = standby.weights_manifest(tp, chunk_bytes=4096)
    leaves = [standby.leaf_bytes(x) for _n, x in standby.param_leaves(tp)]
    chunks = _chunks(m, leaves)
    with pytest.raises(standby.WeightTransferError, match="leaves"):
        standby.rebuild_params(m, chunks, {"embed": tp["embed"]})
    wider = dict(tp, norm_out=torch.zeros(64))
    with pytest.raises(standby.WeightTransferError, match="shape"):
        standby.rebuild_params(m, chunks, wider)
    with pytest.raises(standby.WeightTransferError, match="chunks"):
        standby.rebuild_params(m, chunks[1:], tp)

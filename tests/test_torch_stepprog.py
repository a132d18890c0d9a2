"""The port's step program and fused K-round windows on the CPU
(models/stepprog.py, models/slots.py): a window equals K sequential
chunks in its tokens and in every state leaf, the early exit on budget
and on done leaves pad and advances by exactly rounds_run, engine
parity at K=1 vs K>1, honest dispatch counters, cancel mid-window, the
quantized program and the tiny-max_len clamp; the program's dispatch
handles under lookahead; windows over a ring and the int8 KV leaves.
Cross-package: sampled requests give the reference's tokens through the
eager window functions (``slots.decode_slots_window``) and through the
step program. Mirrors tests/test_stepprog.py (without its speculative
cases)."""
import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from containerpilot_tpu.models import slots as jslots
from containerpilot_tpu.models import stepprog as jstepprog
from containerpilot_tpu.models import transformer as jtf
from containerpilot_tpu.models.decode import _jitted_prefill
from containerpilot_tpu.workload.serve_slots import _Request as JaxRequest
from containerpilot_tpu_torch import bridge
from containerpilot_tpu_torch.models import decode as tdecode
from containerpilot_tpu_torch.models import quantized as tquant
from containerpilot_tpu_torch.models import slots as tslots
from containerpilot_tpu_torch.models import stepprog
from containerpilot_tpu_torch.models import transformer as ttf
from containerpilot_tpu_torch.workload.serve import InferenceServer
from containerpilot_tpu_torch.workload.serve_slots import SlotEngine, _Request

from torch_draws import assert_same_tokens, teacher_forced_gap

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
    eos = kw.pop("eos_id", -1)
    row = tdecode.generate(
        params, torch.tensor([tokens]), CFG, max_new, MAX_LEN, rng=seed,
        eos_id=eos, **kw,
    )[0].tolist()
    if eos >= 0 and eos in row:
        row = row[: row.index(eos) + 1]
    return row


@torch.inference_mode()
def admitted_pool(params, tokens, seed=7, temperature=0.8, top_k=12,
                  cfg=CFG):
    """A 2-slot pool with one sampled request admitted at slot 0."""
    pool = tslots.slot_cache(cfg, 2, MAX_LEN, device="cpu")
    state = tslots.init_slot_state(cfg, 2, device="cpu")
    logits, row = tdecode.prefill(params, torch.tensor([tokens]), cfg,
                                  MAX_LEN)
    key = tslots.seed_slot(state, 0, seed)
    first = tslots.first_sample(logits, key, temperature, top_k, 0.0)
    tslots.insert_row(pool, row, 0)
    tslots.admit_slot_state(
        state, 0, cfg, last=first, temperature=temperature, top_k=top_k,
        top_p=0.0, eos_id=-1, pad_id=0, min_new=0, presence=0.0,
        frequency=0.0, bias_idx=[-1] * tdecode.BIAS_SLOTS_MAX,
        bias_val=[0.0] * tdecode.BIAS_SLOTS_MAX, done=False,
    )
    return pool, state


def leaves(pool, state):
    out = {f"pool.{k}": v.clone() for k, v in pool.items()}
    for name in tslots.SLOT_STATE_KEYS:
        out[name] = state[name].clone()
    return out


def assert_same(a, b):
    assert a.keys() == b.keys()
    for name in a:
        assert torch.equal(a[name], b[name]), f"leaf {name} diverged"


def test_window_matches_sequential_chunks(params):
    """One fused K-round window emits the tokens of K sequential chunks
    and leaves every state leaf (the pool, the keys) the same."""
    chunk, k_rounds = 3, 4
    pool, state = admitted_pool(params, [1, 2, 3, 4])
    seq = []
    for _ in range(k_rounds):
        pool, state, toks = tslots.decode_slots_chunk(
            params, pool, state, CFG, chunk)
        seq.append(toks.clone())
    sequential = torch.cat(seq, dim=1)
    want = leaves(pool, state)

    pool2, state2 = admitted_pool(params, [1, 2, 3, 4])
    pool2, state2, toks, run = tslots.decode_slots_window(
        params, pool2, state2, CFG, chunk, k_rounds,
        [chunk * k_rounds, 0],
    )
    assert int(run) == k_rounds
    assert torch.equal(toks, sequential)
    assert_same(leaves(pool2, state2), want)
    # and slot 0's stream is its solo generate's
    first = solo(params, [1, 2, 3, 4], 1 + chunk * k_rounds,
                 temperature=0.8, top_k=12, seed=7)
    assert toks[0].tolist() == first[1:]


@pytest.mark.parametrize("over", [
    {"window": 8}, {"window": 8, "kv_int8": True}, {"kv_int8": True},
])
def test_window_program_with_ring_and_int8_leaves_matches_chunks(params,
                                                                 over):
    """The same identity with a window's ring and the int8 KV leaves
    (k/v int8, k_scale/v_scale): a prompt longer than the ring, then
    4 rounds of 3 tokens that wrap it; and slot 0's stream is its solo
    generate's on that config."""
    cfg = dataclasses.replace(CFG, **over)
    chunk, k_rounds = 3, 4
    prompt = list(range(1, 11))
    pool, state = admitted_pool(params, prompt, cfg=cfg)
    if cfg.kv_int8:
        assert pool["k"].dtype == torch.int8 and "v_scale" in pool
    seq = []
    for _ in range(k_rounds):
        pool, state, toks = tslots.decode_slots_chunk(
            params, pool, state, cfg, chunk)
        seq.append(toks.clone())
    want = leaves(pool, state)
    pool2, state2 = admitted_pool(params, prompt, cfg=cfg)
    pool2, state2, toks, run = tslots.decode_slots_window(
        params, pool2, state2, cfg, chunk, k_rounds, [chunk * k_rounds, 0])
    assert int(run) == k_rounds
    assert torch.equal(toks, torch.cat(seq, dim=1))
    assert_same(leaves(pool2, state2), want)
    first = tdecode.generate(
        params, torch.tensor([prompt]), cfg, 1 + chunk * k_rounds, MAX_LEN,
        temperature=0.8, top_k=12, rng=7)[0].tolist()
    assert toks[0].tolist() == first[1:]


def test_window_early_exit_on_budget_and_done(params):
    """A 2-token budget exits after one 3-token round: the skipped
    rounds' columns stay pad and the state equals one chunk's; a pool
    with no budget runs zero rounds and changes no leaf (rounds past the
    exit draw from the unchanged keys and steps, and keep nothing)."""
    chunk, k_rounds = 3, 4
    ref_pool, ref_state = admitted_pool(params, [1, 2, 3, 4])
    _p, _s, ref = tslots.decode_slots_chunk(params, ref_pool, ref_state,
                                            CFG, chunk)
    want = leaves(ref_pool, ref_state)

    pool, state = admitted_pool(params, [1, 2, 3, 4])
    pool, state, toks, run = tslots.decode_slots_window(
        params, pool, state, CFG, chunk, k_rounds, [2, 0])
    assert int(run) == 1
    assert torch.equal(toks[:, :chunk], ref)
    assert (toks[:, chunk:] == 0).all()  # pad_id 0
    got = leaves(pool, state)
    # the exit round's k/v write at the unchanged pos differs; nothing
    # reads it before the next real step overwrites it
    got.pop("pool.k"), got.pop("pool.v"), want.pop("pool.k"), want.pop("pool.v")
    assert_same(got, want)

    before = leaves(pool, state)
    pool, state, toks, run = tslots.decode_slots_window(
        params, pool, state, CFG, chunk, k_rounds, [0, 0])
    assert int(run) == 0 and (toks == 0).all()
    after = leaves(pool, state)
    for name in ("last", "keys", "done", "counts", "step_idx", "pool.pos"):
        assert torch.equal(after[name], before[name]), name
    # a done slot is not live however large its budget
    tslots.retire_slot(state, 0)
    pool, state, toks, run = tslots.decode_slots_window(
        params, pool, state, CFG, chunk, k_rounds, [99, 99])
    assert int(run) == 0


@pytest.mark.parametrize("window", [2, 4])
def test_engine_fused_parity_with_window_one(params, window):
    """The same request mix on a fused engine and a window=1 engine gives
    the same outputs, and both match solo generate."""
    reqs = [
        ([1, 2, 3, 4], dict(max_new=12)),
        ([5, 6, 7], dict(max_new=9, temperature=0.9, top_k=12, top_p=0.8,
                         seed=11)),
        ([1, 2, 3], dict(max_new=8, temperature=0.7, seed=8,
                         frequency_penalty=50.0)),
    ]
    results = {}
    for w in (1, window):
        eng = SlotEngine(CFG, params, MAX_LEN, slots=2, chunk=3, window=w)
        try:
            futs = [eng.submit(list(t), **dict(kw)) for t, kw in reqs]
            results[w] = [f.result(timeout=WAIT) for f in futs]
        finally:
            eng.stop()
    assert results[1] == results[window]
    for (tokens, kw), got in zip(reqs, results[window]):
        kw = dict(kw)
        assert got == solo(params, tokens, kw.pop("max_new"), **kw)


def test_engine_fused_eos_parity(params):
    tokens = [2, 4, 6]
    free = solo(params, tokens, 9)
    eos = free[1]
    eng = SlotEngine(CFG, params, MAX_LEN, slots=2, chunk=3, window=4)
    try:
        got = eng.submit(tokens, max_new=9, eos_id=eos).result(timeout=WAIT)
    finally:
        eng.stop()
    assert got == solo(params, tokens, 9, eos_id=eos)
    assert got[-1] == eos


def test_fused_dispatch_counters_honest(params):
    """dispatches counts device dispatches (not rounds) and tokens_out
    every emission: K=4 decodes the same long request with well under
    half the K=1 engine's dispatches a token."""
    dpt = {}
    for w in (1, 4):
        eng = SlotEngine(CFG, params, MAX_LEN, slots=2, chunk=3, window=w)
        try:
            eng.submit([1, 2], max_new=2).result(timeout=WAIT)
            d0, t0 = eng.dispatches, eng.tokens_out
            out = eng.submit([1, 2, 3, 4], max_new=36).result(timeout=WAIT)
            assert len(out) == 36
            d, t = eng.dispatches - d0, eng.tokens_out - t0
            assert t >= 36
            dpt[w] = d / t
        finally:
            eng.stop()
    assert dpt[4] <= 0.5 * dpt[1], dpt


def test_cancel_mid_window_retires_within_one_window(params):
    eng = SlotEngine(CFG, params, MAX_LEN, slots=2, chunk=2, window=4)
    try:
        cancel = threading.Event()
        first = threading.Event()
        timings = {}
        max_new = MAX_LEN - 3
        fut = eng.submit([5, 6, 7], max_new=max_new,
                         on_tokens=lambda _d: first.set(), cancel=cancel,
                         timings=timings)
        assert first.wait(timeout=WAIT), "no first token"
        abandoned_at = time.monotonic()
        cancel.set()
        got = fut.result(timeout=WAIT)
        assert 0 < len(got) < max_new
        assert timings["done"] >= timings["admitted"]
        assert timings["done"] >= abandoned_at
        assert timings["rounds"] >= 1
        deadline = time.monotonic() + 30
        while eng.stats["active"]:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        after = eng.submit([1, 2, 3, 4], max_new=7).result(timeout=WAIT)
        assert after == solo(params, [1, 2, 3, 4], 7)
    finally:
        eng.stop()


def test_make_step_program_picks_quantized():
    masters = ttf.init_params(0, CFG, device="cpu")
    plain = stepprog.make_step_program(CFG, masters, MAX_LEN, 2, 3)
    assert type(plain) is stepprog.PlainStepProgram
    qparams = tquant.quantize_model_params(masters)
    quant = stepprog.make_step_program(CFG, qparams, MAX_LEN, 2, 3,
                                       rounds=4)
    assert isinstance(quant, tquant.QuantizedStepProgram)
    assert quant.rounds == 4
    with pytest.raises(ValueError, match="quantize_model_params"):
        tquant.QuantizedStepProgram(CFG, masters, MAX_LEN, 2, 3)
    with pytest.raises(ValueError, match=">= 1"):
        stepprog.PlainStepProgram(CFG, masters, MAX_LEN, 0, 3)


def test_quantized_program_decodes_through_engine():
    """int8 weights under the fused engine match the quantized params'
    own solo generate. d_model 128 makes can_fuse_int8 hold for the pool,
    so the step runs fused_qkv/fused_attn_out/fused_mlp (K2's plain
    version on the CPU)."""
    cfg = ttf.TransformerConfig(vocab_size=64, d_model=128, n_heads=2,
                                n_layers=1, d_ff=128, dtype=torch.float32)
    qparams = tquant.quantize_model_params(
        ttf.init_params(0, cfg, device="cpu"))
    assert tquant.can_fuse_int8(qparams["layers"], cfg, rows=2)
    eng = SlotEngine(cfg, qparams, MAX_LEN, slots=2, chunk=3, window=4)
    try:
        assert type(eng.program).__name__ == "QuantizedStepProgram"
        got = eng.submit([1, 2, 3], max_new=8).result(timeout=WAIT)
        sampled = eng.submit([4, 5], max_new=8, temperature=0.8,
                             seed=3).result(timeout=WAIT)
    finally:
        eng.stop()
    assert got == tdecode.generate(qparams, torch.tensor([[1, 2, 3]]), cfg,
                                   8, MAX_LEN)[0].tolist()
    assert sampled == tdecode.generate(
        qparams, torch.tensor([[4, 5]]), cfg, 8, MAX_LEN, temperature=0.8,
        rng=3)[0].tolist()


def test_tiny_max_len_clamps_window(params):
    server = InferenceServer(CFG, params, "127.0.0.1", 0, 9, device="cpu",
                             slots=1, slot_chunk=4)
    roomy = InferenceServer(CFG, params, "127.0.0.1", 0, MAX_LEN,
                            device="cpu", slots=1, slot_chunk=4)
    try:
        assert server.slot_engine.window == 1
        assert roomy.slot_engine.window == 4
    finally:
        server.slot_engine.stop()
        roomy.slot_engine.stop()


def test_lookahead_handles_keep_their_own_tokens(params):
    """Two dispatches in flight (the engine's lookahead): each handle's
    tokens are its own window's, fetched in order; a third dispatch
    before any fetch is refused rather than overwriting a handle."""
    prog = stepprog.PlainStepProgram(CFG, params, MAX_LEN, 2, 2, rounds=2)
    with torch.inference_mode():
        logits, row = tdecode.prefill(params, torch.tensor([[3, 1, 4]]),
                                      CFG, MAX_LEN)
        req = _Request(tokens=[3, 1, 4], max_new=20, temperature=0.0,
                       top_k=0, top_p=0.0, eos_id=-1, pad_id=0, seed=0,
                       bias_idx=[-1] * tdecode.BIAS_SLOTS_MAX,
                       bias_val=[0.0] * tdecode.BIAS_SLOTS_MAX)
        first = prog.admit(0, req, logits, row)
    h1 = prog.dispatch(np.array([19, 0]), True)
    h2 = prog.dispatch(np.array([19, 0]), True)
    h3 = prog.dispatch(np.array([19, 0]), False)
    with pytest.raises(RuntimeError, match="handle"):
        prog.dispatch(np.array([19, 0]), True)
    t1, v1, r1 = prog.tokens(h1)
    t2, v2, r2 = prog.tokens(h2)
    t3, v3, r3 = prog.tokens(h3)
    assert (r1, r2, r3) == (2, 2, 1) and v3.tolist() == [2, 2]
    got = [first] + t1[0].tolist() + t2[0].tolist() + t3[0].tolist()
    assert got == solo(params, [3, 1, 4], 11)
    assert (t1[1] == 0).all()
    prog.reset()
    assert prog._state["done"].all() and not prog._pool["pos"].any()


def test_window_replays_only_rounds_a_budget_can_use(params, monkeypatch):
    """A window replays ceil(max budget / chunk) of its K rounds: the
    rounds left out would fail the exit test for every slot, so the
    tokens and the state equal a full K-round window's."""
    calls = []
    real = stepprog.gated_round
    monkeypatch.setattr(stepprog, "gated_round",
                        lambda *a: calls.append(1) or real(*a))

    def run(budgets):
        prog = stepprog.PlainStepProgram(CFG, params, MAX_LEN, 2, 2,
                                         rounds=4)
        with torch.inference_mode():
            logits, row = tdecode.prefill(params, torch.tensor([[2, 7]]),
                                          CFG, MAX_LEN)
            req = _Request(tokens=[2, 7], max_new=20, temperature=0.9,
                           top_k=0, top_p=0.0, eos_id=-1, pad_id=5, seed=4,
                           bias_idx=[-1] * tdecode.BIAS_SLOTS_MAX,
                           bias_val=[0.0] * tdecode.BIAS_SLOTS_MAX)
            prog.admit(1, req, logits, row)
        calls.clear()
        h = prog.dispatch(np.array(budgets), True)
        return len(calls), prog.tokens(h), prog._state["step_idx"].clone()

    n, (toks, valid, run_), idx = run([0, 3])
    assert (n, run_, valid.tolist()) == (2, 2, [4, 4])
    full = tslots.decode_slots_window  # the K-round reference
    with torch.inference_mode():
        pool = tslots.slot_cache(CFG, 2, MAX_LEN, device="cpu")
        state = tslots.init_slot_state(CFG, 2, device="cpu")
        logits, row = tdecode.prefill(params, torch.tensor([[2, 7]]), CFG,
                                      MAX_LEN)
        key = tslots.seed_slot(state, 1, 4)
        first = tslots.first_sample(logits, key, 0.9, 0, 0.0)
        tslots.insert_row(pool, row, 1)
        tslots.admit_slot_state(
            state, 1, CFG, last=first, temperature=0.9, top_k=0, top_p=0.0,
            eos_id=-1, pad_id=5, min_new=0, presence=0.0, frequency=0.0,
            bias_idx=[-1] * tdecode.BIAS_SLOTS_MAX,
            bias_val=[0.0] * tdecode.BIAS_SLOTS_MAX, done=False)
    _p, state, ref, ref_run = full(params, pool, state, CFG, 2, 4, [0, 3])
    assert int(ref_run) == 2 and torch.equal(ref[:, :4], torch.from_numpy(toks))
    assert (ref[1, 4:] == 5).all() and (ref[0, 4:] == 0).all()  # pads
    assert torch.equal(state["step_idx"], idx)
    n, (toks, valid, run_), _ = run([0, 0])
    assert (n, run_, toks.shape) == (0, 0, (2, 0))


SAMPLED = [  # (prompt, slot, knobs of a sampled admission)
    ([1, 2, 3, 4], 0, dict(seed=7, temperature=0.8, top_k=12, top_p=0.0)),
    ([9, 8, 7], 1, dict(seed=2**31 + 1, temperature=1.1, top_k=0,
                        top_p=0.85)),
]
NO_BIAS = ([-1] * tdecode.BIAS_SLOTS_MAX, [0.0] * tdecode.BIAS_SLOTS_MAX)


@pytest.fixture(scope="module")
def jax_model():
    jcfg = jtf.TransformerConfig(**{**BASE, "dtype": jnp.float32})
    return jcfg, jtf.init_params(jax.random.PRNGKey(0), jcfg)


def _knobs(kw):
    return dict(temperature=kw["temperature"], top_k=kw["top_k"],
                top_p=kw["top_p"])


def assert_same_rows(ref, got, params, firsts):
    """``SAMPLED``'s rows of a decode against the reference's, with the
    draw's top-two gap where they part (teacher-forced on the
    reference's tokens after token 0)."""
    def gap(r, i):
        tokens, _slot, kw = SAMPLED[r]
        return teacher_forced_gap(
            params, CFG, tokens, [firsts[r]] + list(ref[r]), i + 1,
            tdecode.row_key(kw["seed"], 0), **_knobs(kw))

    assert_same_tokens(ref, got, gap)


def test_sampled_eager_window_matches_reference_window(params, jax_model):
    """Two sampled slots admitted and decoded by the eager window
    functions draw the reference's tokens (its ``decode_slots_window``
    on the same admissions): token 0 from ``fold_in(row_key, 0)``, then
    every step's ``fold_in(row_key, step_idx)``."""
    jcfg, jp = jax_model
    chunk, k_rounds, budget = 3, 3, [9, 9]
    pool = tslots.slot_cache(CFG, 2, MAX_LEN, device="cpu")
    state = tslots.init_slot_state(CFG, 2, device="cpu")
    jpool = jslots.slot_cache(jcfg, 2, MAX_LEN)
    jstate = jslots.init_slot_state(jcfg, 2)
    firsts = []
    for tokens, slot, kw in SAMPLED:
        knobs = _knobs(kw)
        with torch.inference_mode():
            logits, row = tdecode.prefill(params, torch.tensor([tokens]),
                                          CFG, MAX_LEN)
            key = tslots.seed_slot(state, slot, kw["seed"])
            first = tslots.first_sample(logits, key, **knobs)
            tslots.insert_row(pool, row, slot)
            tslots.admit_slot_state(
                state, slot, CFG, last=first, eos_id=-1, pad_id=0,
                min_new=0, presence=0.0, frequency=0.0, bias_idx=NO_BIAS[0],
                bias_val=NO_BIAS[1], done=False, **knobs)
        jlogits, jrow = _jitted_prefill(jcfg, MAX_LEN)(
            jp, jnp.asarray([tokens], jnp.int32))
        jkey = jax.random.fold_in(jax.random.PRNGKey(kw["seed"]), 0)
        jfirst = jslots.first_sample(jlogits, jkey, cfg=jcfg, **knobs)
        jpool = jslots.insert_row(jpool, jrow, slot, jcfg)
        jstate = jslots.admit_slot_state(
            jstate, slot, jcfg, last=jfirst, key=jkey, eos_id=-1, pad_id=0,
            min_new=0, presence=0.0, frequency=0.0,
            bias_idx=jnp.asarray(NO_BIAS[0], jnp.int32),
            bias_val=jnp.asarray(NO_BIAS[1], jnp.float32), done=False,
            **knobs)
        assert int(first) == int(jfirst)
        firsts.append(int(first))
    _p, _s, toks, run = tslots.decode_slots_window(
        params, pool, state, CFG, chunk, k_rounds, budget)
    _jp, _js, jtoks, jrun = jslots.decode_slots_window(
        jp, jpool, jstate, jcfg, chunk, k_rounds, budget)
    assert int(run) == int(jrun) == k_rounds
    assert_same_rows(np.asarray(jtoks).tolist(), toks.tolist(), params,
                     firsts)


def test_sampled_step_program_matches_reference_program(params, jax_model):
    """The step program (the slot engine's device side) admits the same
    sampled requests as the reference's and dispatches a fused window
    and a chunk: the same tokens, token 0 included."""
    jcfg, jp = jax_model
    prog = stepprog.PlainStepProgram(CFG, params, MAX_LEN, 2, 3, rounds=3)
    jprog = jstepprog.PlainStepProgram(jcfg, jp, MAX_LEN, 2, 3, rounds=3)
    firsts, jfirsts = [], []
    for tokens, slot, kw in SAMPLED:
        fields = dict(tokens=tokens, max_new=20, eos_id=-1, pad_id=0,
                      seed=kw["seed"], **_knobs(kw))
        with torch.inference_mode():
            logits, row = tdecode.prefill(params, torch.tensor([tokens]),
                                          CFG, MAX_LEN)
            firsts.append(prog.admit(slot, _Request(
                **fields, bias_idx=NO_BIAS[0], bias_val=NO_BIAS[1]),
                logits, row))
        jlogits, jrow = _jitted_prefill(jcfg, MAX_LEN)(
            jp, jnp.asarray([tokens], jnp.int32))
        jfirsts.append(jprog.admit(slot, JaxRequest(
            **fields, bias_idx=np.asarray(NO_BIAS[0], np.int32),
            bias_val=np.asarray(NO_BIAS[1], np.float32)), jlogits, jrow))
    assert firsts == jfirsts
    got, want = [[] for _ in SAMPLED], [[] for _ in SAMPLED]
    for fused in (True, False):
        toks, _valid, _run = prog.tokens(prog.dispatch(np.array([9, 9]),
                                                       fused))
        jtoks, _jvalid, _jrun = jprog.tokens(jprog.dispatch(
            np.array([9, 9]), fused))
        for r in range(len(SAMPLED)):
            got[r] += toks[r].tolist()
            want[r] += np.asarray(jtoks)[r].tolist()
    assert_same_rows(want, got, params, firsts)

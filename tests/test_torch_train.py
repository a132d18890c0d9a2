"""The port's training half against the JAX reference on bridged params,
float32 on the CPU: ``loss_fn`` value and gradients (whole and chunked
loss, every remat mode, flash and plain attention, GQA), the optimizer
and its schedules against optax, and whole train steps against the JAX
step on a one-device mesh.

Tolerances: loss and gradients 1e-4 relative to each gradient leaf's
largest entry (float32, summation order only; the flash path adds the
online softmax); optimizer updates 1e-5 on parameters of magnitude ~1;
a train step 2e-4 (a loss-gradient difference of 1e-5 moves Adam's
first update by up to lr x 1e-5 / sqrt(v))."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from containerpilot_tpu.models import transformer as jtf
from containerpilot_tpu.parallel import MeshPlan, make_mesh
from containerpilot_tpu.parallel import train as jtrain
from containerpilot_tpu_torch import bridge
from containerpilot_tpu_torch.models import transformer as ttf
from containerpilot_tpu_torch.parallel import train as ttrain

SMALL = dict(vocab_size=128, d_model=64, n_heads=2, n_layers=2, d_ff=128,
             max_seq_len=128, dtype="float32")
GRAD_TOL = 1e-4
STEP_TOL = 2e-4


def configs(**over):
    d = {**SMALL, **over}
    jcfg = jtf.TransformerConfig(**{**d, "dtype": jnp.dtype(d["dtype"])})
    return jcfg, ttf.TransformerConfig(**bridge.config_kwargs(d))


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def bridged(jparams):
    return bridge.params_from_jax(to_np(jparams), "cpu")


def tokens(seed, shape, vocab=128):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def assert_tree_close(port, ref, tol, what=""):
    """Each leaf within tol of the reference, relative to the leaf's
    largest magnitude."""
    if isinstance(ref, dict):
        assert set(port) == set(ref), what
        for k in ref:
            assert_tree_close(port[k], ref[k], tol, f"{what}/{k}")
        return
    got = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-6)
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def port_value_and_grad(tparams, toks, tcfg):
    params = ttrain._master(tparams)
    loss = ttf.loss_fn(params, torch.from_numpy(toks).long(), tcfg)
    leaves = ttrain.tree_leaves(params)
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    return loss.item(), ttrain.tree_map(lambda _p: next(it), params)


@pytest.mark.parametrize("over,seq", [
    ({}, 16),                                        # whole logits, remat full
    ({"loss_chunk": 5}, 16),                         # chunked, padded tail
    ({"remat": "dots"}, 16),
    ({"remat": "none"}, 16),
    ({"n_heads": 4, "n_kv_heads": 2}, 16),           # GQA, plain attention
    ({"flash_min_seq": 128}, 128),                   # flash fwd + bwd
    ({"flash_min_seq": 128, "n_heads": 4, "n_kv_heads": 2,
      "remat": "dots", "loss_chunk": 48}, 128),      # flash, GQA, dots, chunks
])
def test_loss_fn_value_and_grads_match_jax(over, seq):
    jcfg, tcfg = configs(**over)
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    toks = tokens(1, (2, seq + 1))
    with jax.default_matmul_precision("float32"):
        jl, jg = jax.value_and_grad(jtf.loss_fn)(jp, jnp.asarray(toks), jcfg)
    tl, tg = port_value_and_grad(bridged(jp), toks, tcfg)
    np.testing.assert_allclose(tl, float(jl), rtol=GRAD_TOL)
    assert_tree_close(tg, to_np(jg), GRAD_TOL)


def test_remat_modes_agree_and_flash_matches_plain_attention():
    """test_training_through_auto_flash_matches_causal on the port: the
    flash path (K1/K3/K4's plain versions) against plain attention, at
    that test's bounds; every remat mode gives the same gradients."""
    _, t_flash = configs(n_layers=1, flash_min_seq=128)
    _, t_plain = configs(n_layers=1, flash_min_seq=0)
    jcfg, _ = configs(n_layers=1)
    tp = bridged(jtf.init_params(jax.random.PRNGKey(0), jcfg))
    toks = tokens(1, (2, 129))
    lf, gf = port_value_and_grad(tp, toks, t_flash)
    lc, gc = port_value_and_grad(tp, toks, t_plain)
    np.testing.assert_allclose(lf, lc, rtol=1e-2)
    for f, c in zip(ttrain.tree_leaves(gf), ttrain.tree_leaves(gc)):
        np.testing.assert_allclose(f.numpy(), c.numpy(), rtol=5e-2, atol=5e-3)
    for remat in ("dots", "none", False):
        _, t_r = configs(n_layers=1, flash_min_seq=128, remat=remat)
        lr, gr = port_value_and_grad(tp, toks, t_r)
        assert lr == pytest.approx(lf, rel=1e-6)
        assert_tree_close(gr, ttrain.tree_map(lambda t: t.numpy(), gf), 1e-5)


def _jax_updates(opt, params, grads_seq):
    state = opt.init(params)
    for g in grads_seq:
        upd, state = opt.update(g, state, params)
        params = optax.apply_updates(params, upd)
    return params, state


@pytest.mark.parametrize("kwargs", [
    dict(learning_rate=1e-2),
    dict(learning_rate=1e-2, warmup_steps=2),
    dict(learning_rate=1e-2, warmup_steps=1, decay_steps=3),
    dict(learning_rate=1e-2, decay_steps=2),
])
def test_optimizer_matches_optax_over_three_steps(kwargs):
    """make_optimizer (clip, AdamW, schedule) against optax; step 2's
    gradient is large enough to be clipped."""
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((4, 3)).astype(np.float32),
              "layers": {"b": rng.standard_normal((5,)).astype(np.float32)}}
    grads = [
        jax.tree_util.tree_map(
            lambda p: (rng.standard_normal(p.shape) * scale).astype(np.float32),
            params,
        )
        for scale in (0.1, 5.0, 0.3)
    ]
    jopt = jtrain.make_optimizer(**kwargs)
    jp, _ = _jax_updates(jopt, jax.tree_util.tree_map(jnp.asarray, params), grads)

    topt = ttrain.make_optimizer(**kwargs)
    tp = ttrain.tree_map(torch.from_numpy, params)
    tp = ttrain.tree_map(lambda t: t.clone(), tp)
    state = topt.init(tp)
    for g in grads:
        gl = [torch.from_numpy(x.copy()) for x in ttrain.tree_leaves(g)]
        state = topt.update(gl, state, tp)
    assert state["count"] == 3
    assert_tree_close(tp, to_np(jp), 1e-5)


@pytest.mark.parametrize("kwargs", [
    dict(learning_rate=3e-4, warmup_steps=3),
    dict(learning_rate=3e-4, warmup_steps=2, decay_steps=4, min_lr_ratio=0.2),
    dict(learning_rate=3e-4, decay_steps=3),
])
def test_lr_schedule_matches_optax(kwargs):
    ref = jtrain.lr_schedule(**kwargs)
    port = ttrain.lr_schedule(**kwargs)
    for count in range(10):
        assert port(count) == pytest.approx(float(ref(count)), rel=1e-6, abs=1e-12)
    assert ttrain.lr_schedule(1e-3) == 1e-3


def test_with_ema_matches_optax():
    rng = np.random.default_rng(1)
    params = {"w": rng.standard_normal((3, 2)).astype(np.float32)}
    grads = [{"w": rng.standard_normal((3, 2)).astype(np.float32)} for _ in range(3)]
    jopt = jtrain.with_ema(jtrain.make_optimizer(1e-2), 0.9)
    jp, jstate = _jax_updates(jopt, {"w": jnp.asarray(params["w"])}, grads)
    jema = jtrain.ema_params(jtrain.TrainState(jp, jstate, 0))

    topt = ttrain.with_ema(ttrain.make_optimizer(1e-2), 0.9)
    tp = {"w": torch.from_numpy(params["w"].copy())}
    state = ttrain.TrainState(tp, topt.init(tp), 0)
    for g in grads:
        topt.update([torch.from_numpy(g["w"])], state.opt_state, tp)
    assert_tree_close(tp, to_np(jp), 1e-5)
    assert_tree_close(ttrain.ema_params(state), to_np(jema), 1e-5)
    with pytest.raises(ValueError, match="ema decay"):
        ttrain.with_ema(topt, 1.0)


@pytest.mark.parametrize("accum,over", [
    (1, {}),
    (2, {}),
    (1, {"flash_min_seq": 128, "max_seq_len": 128}),
])
def test_train_step_matches_jax_step(accum, over):
    """Two make_train_step steps against the JAX step on a 1-device
    mesh: loss and every updated parameter."""
    jcfg, tcfg = configs(**over)
    seq = 128 if over else 16
    mesh = make_mesh(jax.devices()[:1], plan=MeshPlan(1, 1))
    jstate = jtrain.init_train_state(jax.random.PRNGKey(0), jcfg, mesh,
                                     learning_rate=1e-3)
    tstate = ttrain.init_train_state(bridged(jstate.params), tcfg,
                                     learning_rate=1e-3)
    jstep = jtrain.make_train_step(jcfg, mesh, learning_rate=1e-3,
                                   accum_steps=accum)
    tstep = ttrain.make_train_step(tcfg, accum_steps=accum, learning_rate=1e-3)
    for i in range(2):
        toks = tokens(10 + i, (4, seq + 1))
        with jax.default_matmul_precision("float32"):
            jstate, jloss = jstep(jstate, jnp.asarray(toks))
        tstate, tloss = tstep(tstate, torch.from_numpy(toks).long())
        np.testing.assert_allclose(tloss.item(), float(jloss), rtol=GRAD_TOL)
    assert tstate.step == int(jstate.step) == 2
    assert_tree_close(tstate.params, to_np(jstate.params), STEP_TOL)


def test_train_step_rejects_indivisible_accum():
    _, tcfg = configs()
    state = ttrain.init_train_state(0, tcfg, device="cpu")
    step = ttrain.make_train_step(tcfg, accum_steps=3)
    with pytest.raises(ValueError, match="not divisible"):
        step(state, torch.zeros((4, 17), dtype=torch.long))
    with pytest.raises(ValueError, match="accum_steps"):
        ttrain.make_train_step(tcfg, accum_steps=0)

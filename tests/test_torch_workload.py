"""The port's trainer support modules against the JAX package: token
shards and batches (exactly equal), FLOP accounting (equal), the eval
loss on bridged params (float32, 1e-4), torch-native checkpoints (round
trip, pruning, crash safety, async commit, EMA restore), the data
prefetcher, and the control-socket client."""
import http.server
import json
import os
import socketserver
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from containerpilot_tpu.models import transformer as jtf
from containerpilot_tpu.workload import data as jdata
from containerpilot_tpu.workload import flops as jflops
from containerpilot_tpu.workload import modelcfg as jmodelcfg
from containerpilot_tpu_torch import bridge
from containerpilot_tpu_torch.client import ControlClient, ControlClientError
from containerpilot_tpu_torch.models import transformer as ttf
from containerpilot_tpu_torch.parallel import checkpoint as tckpt
from containerpilot_tpu_torch.parallel import train as ttrain
from containerpilot_tpu_torch.workload import data as tdata
from containerpilot_tpu_torch.workload import flops as tflops
from containerpilot_tpu_torch.workload import modelcfg as tmodelcfg

SMALL = dict(vocab_size=128, d_model=64, n_heads=2, n_layers=2, d_ff=128,
             max_seq_len=64)


def _shards(tmp_path, n=5000, vocab=128):
    toks = np.random.default_rng(0).integers(0, vocab, n)
    d = str(tmp_path / "shards")
    paths = tdata.write_token_shards(toks, d, shard_size=1200)
    ref_paths = jdata.write_token_shards(toks, str(tmp_path / "ref"), shard_size=1200)
    assert [os.path.basename(p) for p in paths] == [
        os.path.basename(p) for p in ref_paths]
    for a, b in zip(paths, ref_paths):
        np.testing.assert_array_equal(np.load(a), np.load(b))
    return d


@pytest.mark.parametrize("seed,holdout", [(0, 0), (3, 7)])
def test_token_shard_batches_equal_the_reference(tmp_path, seed, holdout):
    d = _shards(tmp_path)
    port = tdata.TokenShardDataset(d, 31, 4, seed=seed, vocab_size=128,
                                   holdout_windows=holdout)
    ref = jdata.TokenShardDataset(d, 31, 4, seed=seed, vocab_size=128,
                                  holdout_windows=holdout)
    assert port.n_windows == ref.n_windows
    for step in (0, 1, 5, 40, 123):  # 40+ wraps past an epoch
        np.testing.assert_array_equal(port.batch_at(step), ref.batch_at(step))
    if holdout:
        assert port.n_eval_batches == ref.n_eval_batches
        for i in range(port.n_eval_batches):
            np.testing.assert_array_equal(port.eval_batch(i), ref.eval_batch(i))
    with pytest.raises(ValueError, match="out of range"):
        tdata.TokenShardDataset(d, 31, 4, vocab_size=10).batch_at(0)


def test_prefetcher_stages_batches_in_order_and_surfaces_errors(tmp_path):
    ds = tdata.TokenShardDataset(_shards(tmp_path), 31, 2)
    pf = tdata.DevicePrefetcher(ds, start_step=3, device="cpu")
    try:
        for step in (3, 4, 5):
            got_step, batch = pf.next()
            assert got_step == step and batch.dtype == torch.int64
            np.testing.assert_array_equal(batch.numpy(), ds.batch_at(step))
    finally:
        pf.stop()

    class Broken:
        def batch_at(self, step):
            raise OSError("disk gone")

    pf = tdata.DevicePrefetcher(Broken(), device="cpu")
    with pytest.raises(RuntimeError, match="worker died"):
        pf.next()
    pf.stop()


@pytest.mark.parametrize("over", [
    {}, {"window": 16}, {"moe_experts": 4}, {"n_kv_heads": 1},
])
def test_flop_accounting_equals_the_reference(over):
    jcfg = jtf.TransformerConfig(**SMALL, **over)
    tcfg = ttf.TransformerConfig(**SMALL, **over)
    for seq, frozen in ((64, 0), (48, 1000)):
        assert tflops.train_flops_per_token(tcfg, 123456, seq, frozen) == (
            jflops.train_flops_per_token(jcfg, 123456, seq, frozen))
        assert tflops.train_step_flops(tcfg, 123456, 4, seq) == (
            jflops.train_step_flops(jcfg, 123456, 4, seq))


def test_count_params_and_the_nvidia_peak_table():
    jcfg = jtf.TransformerConfig(**SMALL, n_kv_heads=1)
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    assert tflops.count_params(tp) == jflops.count_params(jp)
    assert tflops.peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert tflops.peak_flops("NVIDIA A100-SXM4-40GB") == 312e12
    assert tflops.peak_flops("cpu") is None


def test_average_eval_loss_matches_the_reference(tmp_path):
    ds = tdata.TokenShardDataset(_shards(tmp_path), 16, 2, holdout_windows=6)
    jcfg = jtf.TransformerConfig(**SMALL, dtype=jnp.float32)
    tcfg = ttf.TransformerConfig(**SMALL, dtype=torch.float32)
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    with jax.default_matmul_precision("float32"):
        ref = jmodelcfg.average_eval_loss(jp, jcfg, ds.n_eval_batches, ds.eval_batch)
    got = tmodelcfg.average_eval_loss(tp, tcfg, ds.n_eval_batches, ds.eval_batch)
    assert got == pytest.approx(ref, rel=1e-4)


def _state(ema=False):
    cfg = ttf.TransformerConfig(**SMALL, dtype=torch.float32)
    opt = ttrain.make_optimizer(1e-2)
    if ema:
        opt = ttrain.with_ema(opt, 0.5)
    state = ttrain.init_train_state(0, cfg, "cpu", optimizer=opt)
    step = ttrain.make_train_step(cfg, opt)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 128, (2, 17)))
    state, _ = step(state, toks)
    return cfg, opt, state


def _equal_trees(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _equal_trees(a[k], b[k])
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a.detach(), b.detach())
    else:
        assert a == b


def test_checkpoint_round_trip_prune_and_crash_safety(tmp_path):
    cfg, opt, state = _state()
    d = str(tmp_path / "ckpt")
    assert tckpt.latest_step(d) is None
    assert tckpt.restore_checkpoint(d, ttrain.abstract_train_state(cfg, opt),
                                    device="cpu") is None
    for step in (1, 2, 3):
        tckpt.save_checkpoint(d, step, state)
    assert sorted(os.listdir(d)) == ["step_2", "step_3"]  # KEEP_CHECKPOINTS
    # a save that died mid-write leaves only a tmp dir: never picked
    os.makedirs(os.path.join(d, ".step_9.123.4.tmp"))
    assert tckpt.latest_step(d) == 3
    restored = tckpt.restore_checkpoint(
        d, ttrain.abstract_train_state(cfg, opt), device="cpu")
    assert restored.step == 1  # the state's own step, saved as step_3
    _equal_trees(restored.params, state.params)
    _equal_trees(restored.opt_state, state.opt_state)
    assert all(p.requires_grad for p in ttrain.tree_leaves(restored.params))
    # other model flags than the checkpoint's refuse to resume
    wide = ttf.TransformerConfig(**{**SMALL, "d_model": 128}, dtype=torch.float32)
    with pytest.raises(ValueError, match="the model wants"):
        tckpt.restore_checkpoint(d, ttrain.abstract_train_state(wide, opt),
                                 device="cpu")
    with pytest.raises(ValueError, match="device="):
        tckpt.restore_checkpoint(d, ttrain.abstract_train_state(cfg, opt))


def test_async_checkpoint_commits_a_copy_and_ema_restores(tmp_path):
    cfg, opt, state = _state(ema=True)
    d = str(tmp_path / "ckpt")
    before = ttrain.tree_map(lambda t: t.detach().clone(), state.params)
    tckpt.save_checkpoint(d, 5, state, wait=False)
    with torch.no_grad():  # the loop goes on updating in place
        for p in ttrain.tree_leaves(state.params):
            p.add_(1.0)
    tckpt.wait_for_checkpoints()
    assert tckpt.latest_step(d) == 5
    like = ttrain.abstract_train_state(cfg, opt)
    params, step = tckpt.restore_params(d, like, device="cpu")
    _equal_trees(params, before)
    restored = tckpt.restore_params(d, like, prefer_ema=True, device="cpu")
    assert restored.ema and restored[1] == 1
    _equal_trees(restored[0], ttrain.ema_params(state))
    # a checkpoint without a shadow falls back to the raw params
    _cfg, _opt, plain = _state()
    tckpt.save_checkpoint(d, 6, plain)
    fallback = tckpt.restore_params(d, like, prefer_ema=True, device="cpu")
    assert not fallback.ema
    _equal_trees(fallback[0], plain.params)


class _MetricSink(socketserver.ThreadingMixIn, socketserver.UnixStreamServer):
    daemon_threads = True


def serve_control_socket(path):
    """A stand-in for the supervisor's control socket: records every
    POST /v3/metric body."""
    posted, conns = [], []

    class Handler(http.server.BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def setup(self):
            super().setup()
            conns.append(1)

        def address_string(self):
            return "unix"

        def log_message(self, *args):
            pass

        def _reply(self, status=200):
            self.send_response(status)
            self.send_header("Content-Length", "0")
            self.end_headers()

        def do_POST(self):
            body = self.rfile.read(int(self.headers["Content-Length"]))
            if self.path == "/v3/metric":
                posted.append(json.loads(body))
                self._reply()
            else:
                self._reply(404)

    server = _MetricSink(path, Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, posted, conns


def test_control_client_posts_metrics_over_one_kept_connection(tmp_path):
    path = str(tmp_path / "control.sock")
    server, posted, conns = serve_control_socket(path)
    try:
        client = ControlClient(path)
        for metrics in ({"training_loss": 1.5}, {"training_steps_total": 10},
                        {"training_mfu": 0.1}):
            client.put_metric(metrics)
        assert posted == [{"training_loss": 1.5}, {"training_steps_total": 10},
                          {"training_mfu": 0.1}]
        assert len(conns) == 1
        with pytest.raises(ControlClientError, match="404"):
            client._request("POST", "/v3/nothing", {})
        client.close()
    finally:
        server.shutdown()
        server.server_close()
    with pytest.raises(ControlClientError):
        ControlClient(str(tmp_path / "missing.sock"), retries=1,
                      retry_delay=0.01).put_metric({})

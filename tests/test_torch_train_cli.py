"""The port's train and evaluate CLIs on ``--device cpu``: SIGTERM
finishes the step, saves and exits 0, and the resumed run ends with
exactly the parameters of an uninterrupted run; the parallel flags run
or are refused with the reference's own messages in a world of one, and
two CPU ranks train with --zero1 on the reference's mesh; the default
device raises without a card; metrics reach the control socket; the
profiler window and in-loop eval run; the evaluator scores the
checkpoint."""
import json
import os
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from containerpilot_tpu_torch.workload import evaluate as teval
from containerpilot_tpu_torch.workload import train as ttrain_cli
from containerpilot_tpu_torch.workload.data import write_token_shards

from test_torch_workload import serve_control_socket

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--batch", "2", "--seq-len", "32", "--d-model",
        "64", "--n-layers", "1", "--n-heads", "2", "--vocab", "128"]


def _cli(args, stop_after=None, timeout=240):
    """Run the train CLI in a subprocess; with ``stop_after``, SIGTERM
    it once its progress file reports that step."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "containerpilot_tpu_torch.workload.train",
         *args], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env={**os.environ, "PYTHONPATH": ROOT},
    )
    try:
        if stop_after is not None:
            progress = args[args.index("--progress-file") + 1]
            deadline = time.monotonic() + timeout
            while proc.poll() is None and time.monotonic() < deadline:
                try:
                    with open(progress) as fh:
                        if json.load(fh)["step"] >= stop_after:
                            proc.send_signal(signal.SIGTERM)
                            break
                except (OSError, ValueError):
                    pass
                time.sleep(0.02)
        out, _ = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return proc.returncode, out


def _final_params(ckpt_dir, step):
    raw = torch.load(os.path.join(ckpt_dir, f"step_{step}", "state.pt"),
                     weights_only=True)
    assert raw["step"] == step
    return raw["params"]


def test_sigterm_saves_exits_zero_and_resume_equals_uninterrupted(
        tmp_path, capsys):
    """The preempted run is a real process receiving SIGTERM; the
    resumed and the uninterrupted runs call the same main in-process."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    progress = str(tmp_path / "progress.json")
    rc, out = _cli(TINY + ["--steps", "100000", "--checkpoint-dir", a,
                           "--checkpoint-every", "100000",
                           "--progress-file", progress], stop_after=2)
    saved = re.search(r"checkpoint saved at step (\d+)", out)
    assert rc == 0 and saved, out
    at = int(saved.group(1))
    end = str(at + 3)
    assert ttrain_cli.main(TINY + ["--steps", end, "--checkpoint-dir", a,
                                   "--checkpoint-every", end]) == 0
    assert f"resumed from checkpoint at step {at}" in capsys.readouterr().out
    assert ttrain_cli.main(TINY + ["--steps", end, "--checkpoint-dir", b,
                                   "--checkpoint-every", end]) == 0
    assert "resumed" not in capsys.readouterr().out
    resumed, straight = _final_params(a, at + 3), _final_params(b, at + 3)
    flat = lambda t: {k: v for k, v in t.items() if k != "layers"} | {
        f"layers/{k}": v for k, v in t["layers"].items()}
    for key, value in flat(straight).items():
        assert torch.equal(flat(resumed)[key], value), key


LORA_REFUSAL = r"--lora-rank composes with the plain trainer only"


def _stages(n):
    return rf"1 devices not divisible by pipeline-stages x tensor-parallel = {n} x 1"


@pytest.mark.parametrize("flag,refusal", [
    (["--lora-rank", "4", "--zero1"], LORA_REFUSAL),
    (["--base-checkpoint-dir", "/x", "--fsdp"], None),  # dir needs --lora-rank
    (["--pipeline-stages", "2"], _stages(2)),
    (["--tensor-parallel", "2"], None),  # model axis only when pipelining
    (["--zero1"], None),
    (["--fsdp"], None),
    (["--moe-experts", "2", "--zero1"], None),
    (["--moe-experts", "2", "--moe-capacity", "1.5", "--pipeline-stages",
      "4"], _stages(4)),
    (["--moe-experts", "4", "--window", "64", "--microbatches", "8"], None),
    (["--microbatches", "2"], None),  # microbatches only when pipelining
])
def test_unported_train_flags_exit(flag, refusal, capsys):
    """The flags that once exited "not ported yet", in a world of one:
    each is refused with the reference's own message where the
    reference's rules (workload/train.py:155-241) refuse it for one
    device, and otherwise runs on the reference's one-device mesh."""
    if refusal is not None:
        with pytest.raises(SystemExit, match=refusal):
            ttrain_cli.main(TINY + flag)
        return
    assert ttrain_cli.main(TINY + flag + ["--steps", "1"]) == 0
    out = capsys.readouterr().out
    assert "mesh: {'data': 1, 'model': 1} on cpu" in out
    assert re.search(r"step 1: loss=[\d.]+", out), out


def test_parallel_refusals_carry_the_reference_messages():
    with pytest.raises(SystemExit, match="--loss-chunk does not apply"):
        ttrain_cli.main(TINY + ["--pipeline-stages", "2", "--loss-chunk",
                                "8"])
    with pytest.raises(SystemExit, match=LORA_REFUSAL):
        ttrain_cli.main(TINY + ["--lora-rank", "4", "--accum-steps", "2"])


JAX_CLI = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
from containerpilot_tpu.workload.train import main
sys.argv = ["train"] + sys.argv[1:]
sys.exit(main())
"""


def test_two_cpu_ranks_zero1_match_the_reference_mesh_and_loss(tmp_path):
    """Two CPU ranks meet through a file catalog and train 2 steps with
    --zero1: their mesh line is the JAX CLI's on two devices, their
    step-1 loss equals the port's one-rank run on the same seed (the same
    init and batch; bf16 tensor parallelism moves it by rounding only)
    and the JAX CLI's (both packages draw the init from PRNGKey(0) and
    the tokens from fold_in(PRNGKey(1), step)), and both sit at the
    uniform-prediction loss ln(vocab)."""
    import socket

    args = TINY + ["--steps", "2", "--zero1"]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    ranks = []
    try:
        for pid in (0, 1):
            ranks.append(subprocess.Popen(
                [sys.executable, "-m",
                 "containerpilot_tpu_torch.workload.train", *args,
                 "--catalog", f"file:{tmp_path / 'catalog'}",
                 "--num-processes", "2", "--process-id", str(pid),
                 "--advertise-address", "127.0.0.1",
                 "--coordinator-port", str(port)],
                cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        jax_env = {**env, "XLA_FLAGS":
                   "--xla_force_host_platform_device_count=2"}
        ref = subprocess.run(
            [sys.executable, "-c", JAX_CLI,
             *[a for a in args if a not in ("--device", "cpu")]],
            cwd=ROOT, env=jax_env, capture_output=True, text=True,
            timeout=240)
        outs = [p.communicate(timeout=240)[0] for p in ranks]
    finally:
        for p in ranks:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert ref.returncode == 0, ref.stderr[-2000:]
    jax_mesh = re.search(r"mesh: (\{.*\}) on cpu", ref.stdout).group(1)
    assert jax_mesh == "{'data': 1, 'model': 2}"
    loss_of = lambda out: float(re.search(r"step 1: loss=([\d.]+)",
                                          out).group(1))
    for p, out in zip(ranks, outs):
        assert p.returncode == 0, out[-3000:]
        assert f"mesh: {jax_mesh} on cpu" in out
        assert "collectives over gloo" in out
    assert loss_of(outs[0]) == loss_of(outs[1])
    import io
    from contextlib import redirect_stdout

    one = io.StringIO()
    with redirect_stdout(one):
        assert ttrain_cli.main(args) == 0
    assert loss_of(outs[0]) == pytest.approx(loss_of(one.getvalue()),
                                             rel=1e-3)
    assert loss_of(outs[0]) == pytest.approx(loss_of(ref.stdout), rel=1e-3)
    for loss in (loss_of(outs[0]), loss_of(ref.stdout)):
        assert loss == pytest.approx(np.log(128), rel=0.15)


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [a for a in TINY if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain_cli.main(args + ["--steps", "1"])


def test_metrics_profile_eval_and_the_evaluator(tmp_path, capsys):
    """One in-process run with shards, in-loop eval, an EMA, the
    profiler window and the control socket; then the evaluator scores
    its checkpoint with the same eval loss."""
    sock = str(tmp_path / "control.sock")
    server, posted, _conns = serve_control_socket(sock)
    data = str(tmp_path / "shards")
    write_token_shards(np.random.default_rng(0).integers(0, 128, 4000), data,
                       shard_size=1000)
    ckpt, prof = str(tmp_path / "ckpt"), str(tmp_path / "prof")
    try:
        assert ttrain_cli.main(TINY + [
            "--steps", "10", "--data-dir", data, "--eval-holdout", "6",
            "--eval-every", "10", "--ema-decay", "0.9", "--accum-steps", "2",
            "--warmup-steps", "2", "--decay-steps", "5",
            "--control-socket", sock, "--profile-dir", prof,
            "--profile-steps", "2", "--checkpoint-dir", ckpt,
            "--checkpoint-every", "5", "--checkpoint-async",
        ]) == 0
    finally:
        server.shutdown()
        server.server_close()
    out = capsys.readouterr().out
    eval_loss = float(re.search(r"step 10: eval_loss=([\d.]+)", out).group(1))
    assert os.path.exists(os.path.join(prof, "trace.json"))
    assert sorted(os.listdir(ckpt)) == ["step_10", "step_5"]
    assert [sorted(m) for m in posted] == [
        ["training_loss", "training_steps_total", "training_tokens_per_sec"],
        ["training_eval_loss"],
    ]
    assert posted[1]["training_eval_loss"] == pytest.approx(eval_loss, abs=1e-4)

    assert teval.main([
        "--device", "cpu", "--checkpoint-dir", ckpt, "--data-dir", data,
        "--eval-holdout", "6", "--batch", "2", "--seq-len", "32",
        "--d-model", "64", "--n-layers", "1", "--n-heads", "2",
        "--vocab", "128", "--use-ema",
    ]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["checkpoint_step"] == 10 and report["ema"] is True
    assert report["split"] == "holdout" and report["batches"] == 3
    assert report["eval_loss"] == pytest.approx(eval_loss, abs=1e-4)


def test_window_trains_and_the_evaluator_scores_it(tmp_path, capsys):
    """--window runs in the trainer and the evaluator: the evaluator's
    loss equals the trainer's in-loop eval with the same window, and
    the full-causal score of the same checkpoint differs (the window's
    mask is live at seq 32 > window 8)."""
    data = str(tmp_path / "shards")
    write_token_shards(np.random.default_rng(1).integers(0, 128, 4000), data,
                       shard_size=1000)
    ckpt = str(tmp_path / "ckpt")
    assert ttrain_cli.main(TINY + [
        "--window", "8", "--steps", "4", "--data-dir", data,
        "--eval-holdout", "6", "--eval-every", "4",
        "--checkpoint-dir", ckpt, "--checkpoint-every", "4",
    ]) == 0
    out = capsys.readouterr().out
    eval_loss = float(re.search(r"step 4: eval_loss=([\d.]+)", out).group(1))
    scores = {}
    for window in ("8", "0"):
        assert teval.main([
            "--device", "cpu", "--checkpoint-dir", ckpt, "--data-dir", data,
            "--eval-holdout", "6", "--batch", "2", "--seq-len", "32",
            "--d-model", "64", "--n-layers", "1", "--n-heads", "2",
            "--vocab", "128", "--window", window,
        ]) == 0
        report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        scores[window] = report["eval_loss"]
    assert scores["8"] == pytest.approx(eval_loss, abs=1e-4)
    assert abs(scores["0"] - scores["8"]) > 1e-4


@pytest.mark.parametrize("variant", ["moe", "moe_window", "moe_lora"])
def test_moe_trains_and_the_evaluator_scores_it(tmp_path, capsys, run,
                                                variant):
    """Trainer -> checkpoint -> evaluator (-> server) for a switch-MoE
    model: ``--moe-experts 2 --moe-capacity 1.5`` trains (with
    ``--window 8``, or as the frozen base of rank-4 adapters), the
    trainer's in-loop eval is the capacity model's loss, and
    ``evaluate --moe-experts 2`` scores the checkpoint drop-free: its
    loss equals ``average_eval_loss`` of the restored (merged) params
    under the drop-free config. The plain case also serves the
    capacity-trained checkpoint with ``--moe-experts`` alone: greedy
    tokens equal an in-process generate on the restored params."""
    import asyncio
    import dataclasses

    from containerpilot_tpu_torch.models import decode as tdecode
    from containerpilot_tpu_torch.models import quantized as tquant
    from containerpilot_tpu_torch.models.transformer import TransformerConfig
    from containerpilot_tpu_torch.workload import serve_cli
    from containerpilot_tpu_torch.workload.data import TokenShardDataset
    from containerpilot_tpu_torch.workload.modelcfg import (
        average_eval_loss,
        derive_d_ff,
        restore_merged_params,
    )
    from containerpilot_tpu_torch.workload.serve import InferenceServer

    data = str(tmp_path / "shards")
    write_token_shards(np.random.default_rng(2).integers(0, 128, 4000), data,
                       shard_size=1000)
    window = ["--window", "8"] if variant == "moe_window" else []
    moe = ["--moe-experts", "2"]
    ckpt, adapter = str(tmp_path / "ckpt"), str(tmp_path / "adapter")
    assert ttrain_cli.main(TINY + moe + window + [
        "--moe-capacity", "1.5", "--steps", "4", "--data-dir", data,
        "--eval-holdout", "6", "--eval-every", "4", "--learning-rate",
        "1e-2", "--checkpoint-dir", ckpt, "--checkpoint-every", "4",
    ]) == 0
    out = capsys.readouterr().out
    in_loop = float(re.search(r"step 4: eval_loss=([\d.]+)", out).group(1))
    lora = []
    if variant == "moe_lora":
        assert ttrain_cli.main(TINY + moe + [
            "--steps", "4", "--lora-rank", "4", "--learning-rate", "1e-2",
            "--base-checkpoint-dir", ckpt, "--checkpoint-dir", adapter,
            "--checkpoint-every", "4"]) == 0
        assert "lora: frozen base from checkpoint step 4" in \
            capsys.readouterr().out
        lora = ["--lora-dir", adapter, "--lora-rank", "4"]
    assert teval.main([
        "--device", "cpu", "--checkpoint-dir", ckpt, "--data-dir", data,
        "--eval-holdout", "6", "--batch", "2", "--seq-len", "32",
        "--d-model", "64", "--n-layers", "1", "--n-heads", "2",
        "--vocab", "128", *moe, *window, *lora,
    ]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["checkpoint_step"] == 4 and report["lora"] == bool(lora)

    cfg = TransformerConfig(vocab_size=128, d_model=64, n_heads=2,
                            n_layers=1, d_ff=derive_d_ff(64),
                            max_seq_len=32, moe_experts=2,
                            window=8 if window else 0)
    params, _step = restore_merged_params(
        cfg, ckpt, lora_dir=adapter if lora else "",
        lora_rank=4 if lora else 0, device="cpu")
    assert "moe_w_in" in params["layers"]
    dataset = TokenShardDataset(data, 32, 2, vocab_size=128,
                                holdout_windows=6)
    n, batch_at = dataset.n_eval_batches, dataset.eval_batch
    assert report["eval_loss"] == round(
        average_eval_loss(params, cfg, n, batch_at), 6)
    if not lora:
        capacity = dataclasses.replace(cfg, moe_train_capacity=1.5)
        assert in_loop == pytest.approx(
            average_eval_loss(params, capacity, n, batch_at), abs=1e-4)
    if variant != "moe":
        return

    args = serve_cli.build_arg_parser().parse_args(
        ["--device", "cpu", "--max-len", "64", "--d-model", "64",
         "--n-layers", "1", "--n-heads", "2", "--vocab", "128",
         "--checkpoint-dir", ckpt, *moe])
    serve_cfg, served, checkpoint = serve_cli.load_model(args)
    assert checkpoint == {"step": 4, "ema": False}
    assert serve_cfg.moe_experts == 2 and serve_cfg.moe_train_capacity == 0
    prompt = [[5, 3, 9, 1, 4, 4, 2]]
    want = tdecode.generate(tquant.cast_params(params, serve_cfg.dtype),
                            torch.tensor(prompt), serve_cfg, 8, 64).tolist()

    async def scenario():
        server = InferenceServer(serve_cfg, served, "127.0.0.1", 0, 64,
                                 device="cpu", checkpoint=checkpoint)
        await server.run()
        try:
            reader, writer = await asyncio.open_connection("127.0.0.1",
                                                           server.port)
            body = json.dumps({"tokens": prompt,
                               "max_new_tokens": 8}).encode()
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

"""The port's train and evaluate CLIs on ``--device cpu``: SIGTERM
finishes the step, saves and exits 0, and the resumed run ends with
exactly the parameters of an uninterrupted run; reference flags that
are not ported exit with "not ported yet"; the default device raises
without a card; metrics reach the control socket; the profiler window
and in-loop eval run; the evaluator scores the checkpoint."""
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


@pytest.mark.parametrize("flag", [
    ["--lora-rank", "4", "--zero1"], ["--base-checkpoint-dir", "/x", "--fsdp"],
    ["--pipeline-stages", "2"], ["--tensor-parallel", "2"], ["--zero1"],
    ["--fsdp"], ["--moe-experts", "2"], ["--moe-capacity", "1.5"],
    ["--moe-experts", "4", "--window", "64"], ["--microbatches", "2"],
])
def test_unported_train_flags_exit(flag):
    with pytest.raises(SystemExit, match="not ported yet"):
        ttrain_cli.main(TINY + flag)


@pytest.mark.parametrize("flag", [
    ["--moe-experts", "2", "--window", "64"], ["--moe-experts", "2"],
    ["--lora-dir", "/x", "--moe-experts", "2"],
    ["--lora-rank", "2", "--moe-experts", "3"],
])
def test_unported_evaluate_flags_exit(flag):
    with pytest.raises(SystemExit, match="not ported yet"):
        teval.main(["--checkpoint-dir", "/x", "--data-dir", "/y",
                    "--eval-holdout", "1", *flag])


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

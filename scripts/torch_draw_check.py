"""The sampling draw on one GPU: the draw kernel against its plain
version, and the decode steps and start-up it sits in, timed from this
checkout or from another one.

    python3 scripts/torch_draw_check.py --kernel
    python3 scripts/torch_draw_check.py --steps --startup [--root DIR]

``--kernel``: the seconds of the draw kernel's first call in this
process (its compile), then ``chip_smoke.check_draw`` at [1, 32768] and
[8, 32768] (the Batcher's sampled row, the slot pool: known answers,
bits and tokens equal to the plain version, kernel and plain ms, the
bound).

``--steps`` on the 1.2B flagship (vocab 32768, d_model 2048, 16 heads,
16 layers, d_ff 8192; bf16 weights from ``init_params(0)``): the eager
8-row sampled decode step, ``generate`` on 8 rows of 1024-token prompts
at temperature 0.8 and top-k 40, ``(t(33 new) - t(1 new)) / 32`` with
each time the best of 3 (host clock, synchronized); and the slot step,
``scripts/torch_decode_profile.py --slots 8`` of the same checkout (its
device kernel ms a step and idle share under the profiler).

``--startup``: seconds of the process's first ``init_params(0)`` for the
flagship on the card (synchronized) and of a second one (``init_params_s``, what ``--steps`` reports alone), seconds
of ``import triton`` alone in a fresh interpreter, and seconds from
launching ``python -m containerpilot_tpu_torch.workload.serve`` at the
flagship's flags with no checkpoint (random weights) to its first
``/health`` 200, twice, the nvcc kernels already built.

``--root DIR`` imports the package from DIR and runs DIR's profile
script and serve CLI: another checkout (the parent commit unpacked into
a git-ignored directory) timed on the same card in the same call. Every
line carries the card's name and power limit as nvidia-smi gives them.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = dict(vocab_size=32768, d_model=2048, n_heads=16, n_layers=16,
                d_ff=8192, max_seq_len=2048)
IMPORT_TRITON = """import time
t0 = time.perf_counter()
import triton, triton.language
from triton.language.extra import libdevice
print(time.perf_counter() - t0)"""
CLI_FLAGS = ["--vocab", "32768", "--d-model", "2048", "--n-heads", "16",
             "--n-layers", "16", "--d-ff", "8192", "--max-len", "2048"]


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def eager_step_ms(cfg, params) -> dict:
    from containerpilot_tpu_torch.models import decode

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (8, 1024), generator=gen,
                           device="cuda")

    def run(new):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode.generate(params, prompt, cfg, new, 2048, temperature=0.8,
                        top_k=40, rng=7)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run(2)  # warm
    t1 = min(run(1) for _ in range(3))
    t33 = min(run(33) for _ in range(3))
    return {"eager_sampled_step_ms_8_rows": (t33 - t1) / 32 * 1e3,
            "request_ms_8_rows_new1": t1 * 1e3,
            "request_ms_8_rows_new33": t33 * 1e3}


def slot_step(root) -> dict:
    out = subprocess.run(
        [sys.executable, os.path.join(root, "scripts",
                                      "torch_decode_profile.py"),
         "--slots", "8", "--windows", "4"],
        cwd=root, env={**os.environ, "PYTHONPATH": root},
        capture_output=True, text=True, timeout=600, check=True)
    prof = json.loads(out.stdout.strip().splitlines()[-1])
    return {"slot_step_device_ms": prof["device_kernel_ms_per_step"],
            "slot_step_wall_ms": prof["wall_ms_per_step"],
            "slot_step_idle_share": prof["device_idle_share"],
            "slot_step_launches": prof["kernel_launches_per_step"],
            "slot_step_top_kernels": prof["top_kernels_ms_per_step"][:5]}


def init_seconds(tf, cfg) -> float:
    """Seconds of one synchronized ``init_params(0)`` of ``cfg``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    masters = tf.init_params(0, cfg, device="cuda")
    torch.cuda.synchronize()
    del masters
    torch.cuda.empty_cache()
    return time.perf_counter() - t0


def cli_startup_s(root) -> float:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "containerpilot_tpu_torch.workload.serve",
         "--device", "cuda", "--host", "127.0.0.1", "--port", str(port),
         *CLI_FLAGS],
        cwd=root, env={**os.environ, "PYTHONPATH": root},
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        while True:
            if proc.poll() is not None:
                raise RuntimeError(f"serve CLI exited {proc.returncode}")
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/health", timeout=5) as r:
                    if r.status == 200:
                        return time.perf_counter() - t0
            except OSError:
                pass
            if time.perf_counter() - t0 > 600:
                raise RuntimeError("serve CLI never became healthy")
            time.sleep(0.1)
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernel", action="store_true")
    parser.add_argument("--steps", action="store_true")
    parser.add_argument("--startup", action="store_true")
    parser.add_argument("--root", default=HERE)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from containerpilot_tpu_torch.models import quantized
    from containerpilot_tpu_torch.models import transformer as tf
    from containerpilot_tpu_torch.ops import _build

    smi = card()
    tag = {"root": os.path.relpath(root, HERE), "card": smi}
    if args.kernel:
        sys.path.insert(1, HERE)
        import chip_smoke

        from containerpilot_tpu_torch.ops import draw

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        draw.gumbel_argmax(
            torch.zeros((1, 32768), device="cuda"),
            torch.zeros((1, 2), dtype=torch.int64, device="cuda"), 0)
        torch.cuda.synchronize()
        first = {"draw": time.perf_counter() - t0}
        print(json.dumps({"first_call_s": first, **tag}), flush=True)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        for rows in chip_smoke.DRAW_ROWS:
            print(json.dumps({**chip_smoke.check_draw(gen, rows, 32768),
                              **tag}), flush=True)
    if not (args.steps or args.startup):
        return 0
    _build.build_all()
    cfg = tf.TransformerConfig(**FLAGSHIP)
    out = {**tag}
    if args.startup:
        out["first_init_s"] = init_seconds(tf, cfg)
    out["init_params_s"] = init_seconds(tf, cfg)
    if args.steps:
        params = quantized.cast_params(
            tf.init_params(0, cfg, device="cuda"), cfg.dtype)
        out.update(eager_step_ms(cfg, params))
        del params
        torch.cuda.empty_cache()
        out.update(slot_step(root))
    if args.startup:
        torch.cuda.empty_cache()
        out["import_triton_s"] = float(subprocess.run(
            [sys.executable, "-c", IMPORT_TRITON], capture_output=True,
            text=True, timeout=300, check=True).stdout.split()[-1])
        out["serve_cli_startup_s"] = [cli_startup_s(root) for _ in range(2)]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

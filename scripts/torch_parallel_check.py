"""Hold the 4-rank layouts of ``chip_smoke.py``'s train_parallel phase
(dp2 x tp2, pp2 x tp2 with 4 microbatches) with one card a rank, where
the ranks' collectives run over NCCL instead of gloo through the host.

    python3 scripts/torch_parallel_check.py              # 4 cards
    python3 scripts/torch_parallel_check.py --device cpu # rehearsal
    python3 scripts/torch_parallel_check.py --serve [--device cpu]

On the cards it runs chip_smoke's one-rank reference (the training
configuration, seed-0 masters, one seeded batch) and its rank job in 4
child processes, each on ``cuda:<rank>``, and checks what the phase
checks: the loss within TRAIN_LOSS_REL_TOL and every gathered gradient
leaf within TRAIN_GRAD_REL_TOL of the one-rank run, K1/K3/K4 exactly
2 / 1 / 1 per local layer and microbatch a rank a step, every rank on
the same step loss, and the backend NCCL with nothing staged through the
host. Prints the card's name and power limit, one JSON line per layout
(step ms of the first step, which also builds NCCL's communicators:
not a speed figure) and exits non-zero on a failed check. ``--device
cpu`` runs the same flow at a tiny size over gloo, with no launch
counts.

``--serve`` runs chip_smoke's serve_parallel drive for ``--tp 2 --cp 2
--cp-min-len 1024 --slots 8`` instead (the serve CLI at the flagship
CLI's width, its three followers each on their own card): every request
judged against the one-rank model, every rank's tokens equal, K1 never
for the ringed heads, the mesh, cp and NCCL reported by ``/v1/model``,
nothing staged through the host.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

TINY = dict(vocab_size=256, d_model=64, n_heads=4, n_layers=4, d_ff=128,
            max_seq_len=256, flash_min_seq=128, remat="full")


def _setup(device: str) -> None:
    if device == "cpu":
        cs.TRAIN_CFG.clear()
        cs.TRAIN_CFG.update(TINY)
        cs.TRAIN_BATCH, cs.TRAIN_SEQ = 8, 128
    cs.PARALLEL_LAYOUTS[:] = [lay for lay in cs.PARALLEL_LAYOUTS
                              if lay[1] == 4]
    cs.RANK_SCRIPT = os.path.abspath(__file__)


SERVE_TINY = ["--vocab", "512", "--d-model", "64", "--n-layers", "2",
              "--n-heads", "4", "--max-len", "256"]


def serve_check(device: str) -> int:
    """The tp2 x cp2 serve CLI over 4 ranks (chip_smoke's drive; on the
    cards each rank has its own, so NCCL and no host staging)."""
    t0 = time.perf_counter()
    world = 4
    card = {"kind": device}
    if device == "cuda":
        from containerpilot_tpu_torch.ops import _build

        if torch.cuda.device_count() < world:
            raise SystemExit(f"needs {world} cards, found "
                             f"{torch.cuda.device_count()}")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        print(smi, flush=True)
        card = {"kind": torch.cuda.get_device_name(0), "nvidia_smi": smi}
        _build.build_all()
    cs.PAR_RUNS = tuple(run for run in cs.PAR_RUNS if run[0] == "tp2_cp2")
    small = device != "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        # a wedged rank dumps every thread's stack at 0.9 of its
        # start-up deadline (120 s) and the front exits at it
        out = cs.drive_serve_parallel(
            tmp, card, device, model=SERVE_TINY if small else None,
            lens={"tp": (128,), "cp": (192, 131)} if small else None,
            min_len=128 if small else 1024,
            extra_args=("--lockstep-deadline", "60"), timeout=240)
    run = out["tp2_cp2"]
    print(json.dumps({"serve": "tp2_cp2", **{k: run[k] for k in (
        "backend", "staging", "step_program", "ranks_agree", "judged",
        "k1_launches_by_rank", "wall_ms_by_request", "ready_s",
        "front_staged_bytes_a_token")}}), flush=True)
    print(json.dumps({"seconds": time.perf_counter() - t0}), flush=True)
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--rank-job", nargs=2, metavar=("SPEC", "RANK"))
    parser.add_argument("--serve", action="store_true",
                        help="the tp2 x cp2 serve CLI, a card a rank")
    args = parser.parse_args()
    if args.serve:
        return serve_check(args.device)
    _setup(args.device)
    if args.rank_job:
        return cs.rank_job(args.rank_job[0], int(args.rank_job[1]))
    t0 = time.perf_counter()
    world = 4
    if args.device == "cuda":
        from containerpilot_tpu_torch.ops import _build

        if torch.cuda.device_count() < world:
            raise SystemExit(f"needs {world} cards, found "
                             f"{torch.cuda.device_count()}")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        print(smi, flush=True)
        _build.build_all()
    gen = torch.Generator(device=args.device)
    gen.manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        ref = cs.parallel_reference(gen, tmp, args.device)["{}"]
        jobs = []
        for name, _n, plan, opts, over in cs.PARALLEL_LAYOUTS:
            jobs.append({
                "name": name, "plan": plan, "opts": opts, "over": over,
                "ref_grads": os.path.join(tmp, f"{ref['name']}_grads.pt"),
                "routes": "", "out": os.path.join(tmp, name)})
            os.makedirs(jobs[-1]["out"])
        spec = {"layouts": jobs, "device": args.device,
                "tokens": os.path.join(tmp, "tokens.pt")}
        spec_path = os.path.join(tmp, "spec.json")
        with open(spec_path, "w") as fh:
            json.dump(spec, fh)
        port = cs._free_port()
        envs = [{**os.environ, "PYTHONPATH": ROOT,
                 "COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                 "NUM_PROCESSES": str(world), "PROCESS_ID": str(r)}
                for r in range(world)]
        extra = ["--device", args.device]
        cs._launch_ranks(
            [[sys.executable, cs.RANK_SCRIPT, *extra, "--rank-job",
              spec_path, str(r)] for r in range(world)],
            envs, tmp, cs.RANK_TIMEOUT)
        on_cards = args.device == "cuda"
        for job in jobs:
            ranks = []
            for r in range(world):
                with open(os.path.join(job["out"], f"rank{r}.json")) as fh:
                    ranks.append(json.load(fh))
            head = ranks[0]
            loss_rel = abs(head["loss"] - ref["loss"]) / abs(ref["loss"])
            local = cs.TRAIN_CFG["n_layers"] // job["plan"].get("pipe", 1)
            mb = job["opts"].get("microbatches", 1)
            want = [2 * local * mb, local * mb, local * mb]
            got = [[rk["k1_launches"], rk["dq_launches"],
                    rk["dkdv_launches"]] for rk in ranks]
            ok = (loss_rel <= cs.TRAIN_LOSS_REL_TOL
                  and head["worst_grad_rel"] <= cs.TRAIN_GRAD_REL_TOL
                  and len({rk["step_loss"] for rk in ranks}) == 1
                  and all(rk["backend"] == ("nccl" if on_cards else "gloo")
                          and rk["host_staged_bytes_a_step"] == 0
                          for rk in ranks)
                  and (not on_cards or all(g == want for g in got)))
            print(json.dumps({
                "layout": job["name"], "mesh": job["plan"],
                "backend": head["backend"], "loss_rel": loss_rel,
                "worst_grad_rel": head["worst_grad_rel"],
                "launches_a_rank_a_step": got,
                "step_ms": [rk["step_ms"] for rk in ranks],
                "peak_memory_bytes": [rk["peak_memory_bytes"]
                                      for rk in ranks],
                "ok": ok}), flush=True)
            if not ok:
                return 1
    print(json.dumps({"seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

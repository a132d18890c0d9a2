"""Hold the 4-rank layouts of ``chip_smoke.py``'s train_parallel phase
(dp2 x tp2, pp2 x tp2 with 4 microbatches, sp2 x tp2) with one card a
rank, where the ranks' collectives run over NCCL instead of gloo through
the host.

    python3 scripts/torch_parallel_check.py              # 4 cards
    python3 scripts/torch_parallel_check.py --device cpu # rehearsal
    python3 scripts/torch_parallel_check.py --serve [--device cpu]
    python3 scripts/torch_parallel_check.py --pod [--device cpu]
    python3 scripts/torch_parallel_check.py --resume [--device cpu]

On the cards it runs chip_smoke's one-rank reference (the training
configuration, seed-0 masters, one seeded batch) and its rank job in 4
child processes, each on ``cuda:<rank>``, and checks what the phase
checks: the loss within TRAIN_LOSS_REL_TOL and every gathered gradient
leaf within TRAIN_GRAD_REL_TOL of the one-rank run, K1/K3/K4 exactly
2 / 1 / 1 per local layer and microbatch a rank a step (0 under a seq
axis: the ring), every rank on
the same step loss, and the backend NCCL with nothing staged through the
host. Prints the card's name and power limit, one JSON line per layout
(step ms of the first step, which also builds NCCL's communicators:
not a speed figure) and exits non-zero on a failed check. ``--device
cpu`` runs the same flow at a tiny size over gloo, with no launch
counts.

``--serve`` runs chip_smoke's serve_parallel drive for the composed pod
P (``--tp 2 --int8 --slots 8 --prefix-cache 4 --kv-spill-mb 64
--draft-layers 2 --standby --weights-from E --fleet-catalog``, its two
ranks on cards 0 and 1, beside the one-rank E: the weight wire,
promotion, beams, speculation, a prefix hit, KV pulls both ways,
/v1/weights and a drain) and for ``--tp 2 --cp 2 --cp-min-len 1024
--slots 8`` (its three followers each on their own card) instead, the
serve CLI at the flagship CLI's width: every answer judged against the
one-rank model, every rank's tokens and caches equal, K1/K2 a rank by
path, K1 never for the ringed heads, the mesh, cp and NCCL reported by
``/v1/model``, nothing staged through the host.

``--pod`` runs chip_smoke's serve_pod drive as a dp2 x tp2 pod of 4
serve_dist ranks (a card each, NCCL): every answer judged against the
one-rank model, every rank's digest equal, K1 ``n_layers`` times a rank,
nothing staged through the host; then the wedge drill: a fresh 4-rank
pod with ``--watchdog POD_WATCHDOG`` whose rank 1 finds its
``--wedge-file`` and stops without exiting; every rank must exit 86
within the deadline (plus start of the next check op and the
watchdog's poll), not at the process group's 300 s timeout.

``--resume`` runs chip_smoke's train_resume drive (the train CLI as 4
ranks, data 1 x model 4, with checkpoints, a rank SIGKILLed, the
relaunch, one rank, the served checkpoint, LoRA on 2 ranks) with a card
a rank: the
checkpoints' gather and rank 0's outcome then go over NCCL. NCCL does
not see a peer die: the survivors of the SIGKILLed rank wait in their
collective until the process group's timeout (300 s, the trainer's
rendezvous default) and NCCL's watchdog ends them, so the killed world
is given NCCL_KILL_TIMEOUT instead of chip_smoke's RESUME_TIMEOUT.
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
        cs.PARALLEL_CFG.clear()
        cs.PARALLEL_CFG.update(TINY)
        cs.TRAIN_BATCH, cs.TRAIN_SEQ = 8, 128
    cs.PARALLEL_LAYOUTS[:] = [lay for lay in cs.PARALLEL_LAYOUTS
                              if lay[1] == 4]
    cs.RANK_SCRIPT = os.path.abspath(__file__)


# 4 layers: the composed pod's 2-layer draft needs a deeper target
SERVE_TINY = ["--vocab", "512", "--d-model", "64", "--n-layers", "4",
              "--n-heads", "4", "--max-len", "256"]


def serve_check(device: str) -> int:
    """The composed tp2 pod P over 2 ranks and the tp2 x cp2 serve CLI
    over 4 (chip_smoke's drive; on the cards each rank has its own, so
    NCCL and no host staging)."""
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
    pod = out["tp2_int8"]
    print(json.dumps({"serve": "composed_pod", **{k: pod[k] for k in (
        "backend", "staging", "step_program", "ranks_agree",
        "rank_caches_agree", "judged", "beam_equal_one_rank",
        "launches_by_path", "pool", "wall_ms_by_path", "ready_s", "kv",
        "weights",
        "drain", "front_staged_bytes_a_token") if k in pod}}), flush=True)
    run = out["tp2_cp2"]
    print(json.dumps({"serve": "tp2_cp2", **{k: run[k] for k in (
        "backend", "staging", "step_program", "ranks_agree", "judged",
        "k1_launches_by_rank", "wall_ms_by_request", "ready_s",
        "front_staged_bytes_a_token")}}), flush=True)
    print(json.dumps({"seconds": time.perf_counter() - t0}), flush=True)
    return 0


POD_WATCHDOG = 20  # the wedge drill's --watchdog, seconds
POD_TINY = ["--vocab", "512", "--d-model", "64", "--n-layers", "2",
            "--n-heads", "4", "--max-len", "256"]


def _card(device: str, world: int) -> dict:
    """The card's figures (and every kernel built) on the cards."""
    if device != "cuda":
        return {"kind": device}
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
    return {"kind": torch.cuda.get_device_name(0), "nvidia_smi": smi}


def pod_wedge(tmp: str, device: str, model) -> dict:
    """A 4-rank dp2 x tp2 pod whose rank 1 wedges once healthy: every
    rank's exit code and the seconds from the wedge to the last exit."""
    import urllib.request

    world, port = 4, cs._free_port()
    wedge = os.path.join(tmp, "wedge")
    argv = [sys.executable, "-m", "containerpilot_tpu_torch.workload."
            "serve_dist", "--device", device, "--num-processes",
            str(world), "--catalog", f"file:{tmp}/wedge_catalog",
            "--coordinator-port", str(cs._free_port()),
            "--advertise-address", "127.0.0.1", "--host", "127.0.0.1",
            "--port", str(port), "--dp", "2", "--watchdog",
            str(POD_WATCHDOG), *model]
    procs, logs = [], []
    try:
        for r in range(world):
            logs.append(os.path.join(tmp, f"wedge{r}.log"))
            with open(logs[-1], "w") as fh:
                procs.append(subprocess.Popen(
                    argv + ["--process-id", str(r)]
                    + (["--wedge-file", wedge] if r == 1 else []),
                    cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT},
                    stdout=fh, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + cs.POD_TIMEOUT
        while True:
            try:
                urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                       timeout=2)
                break
            except Exception:
                if any(p.poll() is not None for p in procs) or (
                        time.monotonic() > deadline):
                    raise AssertionError("the wedge pod never became "
                                         "healthy")
                time.sleep(0.2)
        t0 = time.monotonic()
        with open(wedge, "w") as fh:
            fh.write("1")
        rcs = [p.wait(timeout=240) for p in procs]
        seconds = time.monotonic() - t0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    wedged = "follower: injected wedge" in open(logs[1]).read()
    return {"exit_codes": rcs, "seconds_to_exit": seconds,
            "wedged": wedged}


def pod_check(device: str) -> int:
    """chip_smoke's serve_pod drive as a dp2 x tp2 pod of 4 ranks, then
    the wedge drill."""
    t0 = time.perf_counter()
    card = _card(device, 4)
    small = device != "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        out = cs.drive_serve_pod(
            tmp, card, device, model=POD_TINY if small else None,
            long_len=160 if small else cs.PROMPT_LEN, ranks=4,
            extra_args=("--dp", "2"))
    print(json.dumps({k: out[k] for k in (
        "mesh", "k1_launches_by_rank", "k2_launches_by_rank", "digests",
        "step_program", "captures_builds_loads_after_warm", "judged",
        "score_rel_err", "ready_s", "rank_startup_s", "wall_ms",
        "front_staged_bytes_a_token", "exit_codes", "seconds")}),
        flush=True)
    if device == "cuda" and out["front_staged_bytes_a_token"] != 0:
        raise AssertionError("a card a rank staged bytes through the host")
    with tempfile.TemporaryDirectory() as tmp:
        drill = pod_wedge(tmp, device, POD_TINY if small else cs.POD_MODEL)
    print(json.dumps({"wedge": drill}), flush=True)
    # the deadline, the next check op (a quarter of it) and the
    # watchdog's poll, well before the 300 s group timeout
    if not (drill["wedged"] and drill["exit_codes"] == [86] * 4
            and drill["seconds_to_exit"] < 2 * POD_WATCHDOG):
        raise AssertionError(f"the wedge drill: {drill}")
    print(json.dumps({"seconds": time.perf_counter() - t0}), flush=True)
    return 0


NCCL_KILL_TIMEOUT = 480  # the 300 s group timeout, the watchdog, start-up
RESUME_TINY = ["--vocab", "512", "--d-model", "64", "--n-heads", "4",
               "--n-layers", "2", "--seq-len", "64", "--batch", "4",
               "--learning-rate", "1e-3"]


def resume_check(device: str) -> int:
    """chip_smoke's train_resume drive, a card a rank on the cards."""
    t0 = time.perf_counter()
    card = {"kind": device}
    if device == "cuda":
        from containerpilot_tpu_torch.ops import _build

        if torch.cuda.device_count() < 4:
            raise SystemExit(f"needs 4 cards, found "
                             f"{torch.cuda.device_count()}")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        print(smi, flush=True)
        card = {"kind": torch.cuda.get_device_name(0), "nvidia_smi": smi}
        _build.build_all()
    run_world = cs._run_world

    def patient(*args, **kwargs):
        if kwargs.get("kill") is not None and device == "cuda":
            kwargs["timeout"] = NCCL_KILL_TIMEOUT
        return run_world(*args, **kwargs)

    cs._run_world = patient
    with tempfile.TemporaryDirectory() as tmp:
        out = cs.drive_train_resume(
            tmp, card, device,
            model=RESUME_TINY if device != "cuda" else None)
    print(json.dumps(out), flush=True)
    print(json.dumps({"seconds": time.perf_counter() - t0}), flush=True)
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--train-rank"]:  # a train_resume child
        cs.RANK_SCRIPT = os.path.abspath(__file__)
        return cs.train_rank(sys.argv[1:])
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--rank-job", nargs=2, metavar=("SPEC", "RANK"))
    parser.add_argument("--serve", action="store_true",
                        help="the tp2 x cp2 serve CLI, a card a rank")
    parser.add_argument("--pod", action="store_true",
                        help="the dp2 x tp2 pod server and its wedge "
                        "drill, a card a rank")
    parser.add_argument("--resume", action="store_true",
                        help="the train CLI's checkpoints across 4 "
                        "ranks, a card a rank")
    args = parser.parse_args()
    if args.serve:
        return serve_check(args.device)
    if args.pod:
        return pod_check(args.device)
    if args.resume:
        cs.RANK_SCRIPT = os.path.abspath(__file__)
        return resume_check(args.device)
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
            local = (cs.PARALLEL_CFG["n_layers"] // job["plan"].get("pipe", 1)
                     if job["plan"].get("seq", 1) == 1 else 0)
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

"""One rank of a gloo world on the CPU serving the port over ranks, for
the tensor- and context-parallel serving tests
(``tests/test_torch_{ring,tp_serve,cp_serve,serve_dist}.py``):

    python -m torch_serve_jobs SPEC.json RANK

with ``tests/`` on PYTHONPATH. The spec names the world size, a
``file://`` rendezvous path, an output directory and the cases; each
case makes its own mesh from the world. Every rank writes
``<out>/<case>.rank<r>.json`` (tokens, outputs, answers), so a test can
hold every rank to rank 0 and rank 0 to the JAX package. The params of
a case are a JAX pytree the test process wrote as an ``.npz`` (leaf
paths joined with "/"), carried into each rank's blocks by
``bridge.shard_from_jax``, or, where the case gives ``cli_flags``
instead, the serve CLI's ``load_model`` of those flags on the case's
mesh (a checkpoint, a merged adapter, int8: each rank's blocks as a pod
rank builds them). Kinds:

- ``ring``: ``ops.ring_attention.ring_attention`` on whole q/k/v;
- ``generate``: ``models.decode.generate`` on the mesh, or
  ``parallel.context.cp_generate`` when the plan has a seq axis, once
  for each set of sampling arguments;
- ``server``: rank 0 runs an ``InferenceServer`` with its lockstep on
  127.0.0.1:0 and sends it the case's requests one after another (a
  ``/v1/generate`` body, or ``{"method", "path", "body"}``, with
  ``"port"`` to send it to another server instead, ``"{self}"`` in the
  body standing for this server's port, and ``"raw": true`` to keep a
  binary answer as hex), then reads ``/v1/model``; the other ranks are
  ``ServingFollower``s built with the same arguments;
- ``slots``: rank 0 runs a ``SlotEngine`` with its lockstep and submits
  the case's requests at once; the other ranks' engines follow.

The child imports torch and the port only, uses one thread, and never
outlives its world (every collective has the group's timeout). The test
process imports this module for ``start_world``, ``finish_world`` and
``results`` and never makes a process group.
"""
import asyncio
import datetime
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from containerpilot_tpu_torch import bridge
from containerpilot_tpu_torch.models import decode as tdecode
from containerpilot_tpu_torch.models import transformer as ttf
from containerpilot_tpu_torch.ops import ring_attention as tring
from containerpilot_tpu_torch.parallel import context as tctx
from containerpilot_tpu_torch.parallel import mesh as tmesh
from containerpilot_tpu_torch.parallel.serving import Lockstep


def unflatten(npz) -> dict:
    tree: dict = {}
    for key in npz.files:
        node = tree
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = npz[key]
    return tree


def sampling(kw: dict) -> dict:
    """A JSON sampling dict -> generate's arguments (logit_bias keys back
    to ints)."""
    kw = dict(kw)
    if kw.get("logit_bias"):
        kw["logit_bias"] = {int(k): v for k, v in kw["logit_bias"].items()}
    return kw


def load(case, mesh):
    if "cli_flags" in case:
        from containerpilot_tpu_torch.workload import serve_cli

        args = serve_cli.build_arg_parser().parse_args(
            ["--device", "cpu"] + case["cli_flags"])
        cfg, params, _ = serve_cli.load_model(args, mesh, "cpu",
                                              say=lambda line: None)
        return cfg, params
    cfg = ttf.TransformerConfig(**bridge.config_kwargs(case["config"]))
    with np.load(case["params"]) as npz:
        full = unflatten(npz)
    return cfg, bridge.shard_from_jax(full, mesh, "cpu", cfg)


async def http(port, method, path, body=None, raw=False):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = json.dumps(body).encode() if body is not None else b""
    writer.write(
        f"{method} {path} HTTP/1.1\r\nHost: x\r\nConnection: close\r\n"
        f"Content-Length: {len(payload)}\r\n\r\n".encode() + payload)
    await writer.drain()
    data = await reader.read()
    writer.close()
    head, _, data = data.partition(b"\r\n\r\n")
    return int(head.split()[1]), data.hex() if raw else data.decode()


# the server arguments a follower is built with too
FOLLOWER_ARGS = ("cp_min_len", "prefill_chunk", "slots", "slot_chunk",
                 "slot_window", "draft_layers", "speculate",
                 "prefix_cache_entries", "kv_spill_bytes")


def run_server(case, cfg, params, mesh, lockstep, rank):
    from containerpilot_tpu_torch.workload.serve import (
        InferenceServer,
        ServingFollower,
    )

    kw = dict(case.get("server", {}))
    cp_mesh = mesh if mesh.axis_size("seq") > 1 else None
    if rank != 0:
        ServingFollower(
            cfg, params, kw["max_len"], mesh, lockstep, cp_mesh=cp_mesh,
            **{k: kw[k] for k in FOLLOWER_ARGS if k in kw}).run()
        return {}
    server = InferenceServer(
        cfg, params, "127.0.0.1", 0, device="cpu", mesh=mesh,
        cp_mesh=cp_mesh, lockstep=lockstep, **kw)
    lockstep.start_checks()

    async def scenario():
        await server.run()
        try:
            answers = []
            for req in case["requests"]:
                # a generate body, or {"method", "path", "body"}
                method, path, body = (
                    (req["method"], req["path"], req.get("body"))
                    if "path" in req else ("POST", "/v1/generate", req))
                if body is not None:
                    body = json.loads(json.dumps(body).replace(
                        "{self}", str(server.port)))
                raw = req.get("raw", False)
                status, data = await http(req.get("port", server.port),
                                          method, path, body, raw)
                answers.append([status, json.loads(data)
                                if status == 200 and not raw else data])
            status, info = await http(server.port, "GET", "/v1/model")
            return answers, json.loads(info)
        finally:
            await server.stop()

    answers, info = asyncio.run(scenario())
    return {"answers": answers, "info": info}


def run_slots(case, cfg, params, mesh, lockstep, rank):
    from containerpilot_tpu_torch.workload.serve_slots import SlotEngine

    kw = case["engine"]
    engine = SlotEngine(cfg, params, mesh=mesh, lockstep=lockstep,
                        worker=rank == 0, **kw)
    if rank != 0:
        with torch.inference_mode():
            lockstep.follow()
        return {}
    lockstep.start_checks()
    try:
        futures = [engine.submit(tokens, **sampling(r))
                   for tokens, r in case["requests"]]
        out = [f.result(timeout=120) for f in futures]
    finally:
        engine.stop()
        lockstep.shutdown()
    return {"outs": out, "step_program": engine.program.mode}


def run_case(case: dict, spec: dict, rank: int) -> dict:
    plan = tmesh.MeshPlan(**case["plan"])
    mesh = tmesh.make_mesh(plan, device="cpu")
    kind = case["kind"]
    if kind == "ring":
        with np.load(case["inputs"]) as npz:
            q, k, v = (torch.from_numpy(npz[n]) for n in ("q", "k", "v"))
        return {"out": tring.ring_attention(q, k, v, mesh).tolist()}
    cfg, params = load(case, mesh)
    if kind == "generate":
        with np.load(case["prompt"]) as npz:
            prompt = torch.from_numpy(npz["prompt"]).long()
        outs = []
        for kw in case["runs"]:
            kw = sampling(kw)
            seed = kw.pop("seed", 0)
            if plan.seq > 1:
                got = tctx.cp_generate(params, prompt, cfg, mesh,
                                       case["max_new"], case["max_len"],
                                       rng=seed, **kw)
            else:
                got = tdecode.generate(params, prompt, cfg, case["max_new"],
                                       case["max_len"], rng=seed, mesh=mesh,
                                       **kw)
            outs.append(got.tolist())
        return {"outs": outs}
    lockstep = Lockstep(deadline_s=case.get("deadline_s", 120.0))
    if kind == "server":
        return run_server(case, cfg, params, mesh, lockstep, rank)
    if kind == "slots":
        return run_slots(case, cfg, params, mesh, lockstep, rank)
    raise ValueError(f"unknown case kind {kind!r}")


# -- the test process's side ------------------------------------------

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def start_world(tmp, cases, world=4, timeout=120):
    """Start one gloo world of ``world`` child ranks (``python -m
    torch_serve_jobs``, one thread each, ``file://`` rendezvous under
    ``tmp``) running every case; returns (children, results dir). The
    caller computes the JAX side while they run, then calls
    ``finish_world``."""
    import subprocess

    out = tmp / "out"
    out.mkdir()
    spec = {"world": world, "init_file": str(tmp / "rendezvous"),
            "out": str(out), "cases": cases, "timeout": timeout}
    (tmp / "spec.json").write_text(json.dumps(spec))
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([ROOT, os.path.join(ROOT, "tests")])}
    procs = []
    try:
        for rank in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "torch_serve_jobs",
                 str(tmp / "spec.json"), str(rank)],
                cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    except BaseException:
        finish_world(procs, timeout=0)
        raise
    return procs, out


def finish_world(procs, timeout=240):
    """Wait for every child (killing any still alive at the end) and
    require each to have exited 0."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0] if timeout else "")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]


def results(out, name, world):
    """Every rank's results of case ``name``, in rank order."""
    ranks = []
    for r in range(world):
        with open(os.path.join(out, f"{name}.rank{r}.json")) as fh:
            ranks.append(json.load(fh))
    return ranks


def main() -> int:
    spec_path, rank = sys.argv[1], int(sys.argv[2])
    torch.set_num_threads(1)
    with open(spec_path) as fh:
        spec = json.load(fh)
    dist.init_process_group(
        "gloo", init_method=f"file://{spec['init_file']}", rank=rank,
        world_size=spec["world"],
        timeout=datetime.timedelta(seconds=spec.get("timeout", 120)))
    try:
        for case in spec["cases"]:
            out = run_case(case, spec, rank)
            path = os.path.join(spec["out"], f"{case['name']}.rank{rank}.json")
            with open(path, "w") as fh:
                json.dump(out, fh)
            print(f"rank {rank}: {case['name']} done", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""CLI for the port's inference server (counterpart of
``containerpilot_tpu/workload/serve_cli.py``).

``python -m containerpilot_tpu_torch.workload.serve`` lands here. The
flags the port runs: --host, --port, --mux/--no-mux, --max-len,
--d-model, --n-layers, --n-heads, --n-kv-heads, --moe-experts,
--window, --vocab, --checkpoint-dir, --use-ema, --int8, --kv-int8,
--lora-dir, --lora-rank, --draft-layers, --speculate, --max-batch-rows,
--prefill-chunk, --prefix-cache, --kv-spill-mb, --text, --slots,
--slot-chunk, --slot-window, the fleet's --fleet-catalog,
--fleet-service, --fleet-ttl, --fleet-address, --fleet-id,
--migrate-window, --role, --standby, --weights-from and
--adopt-compile-cache, --tp, --cp, --cp-min-len, and --device (default
cuda; the part JAX_PLATFORMS plays for the reference).

``--tp N`` and ``--cp M`` serve over N*M ranks, one process a rank, as
one command: this process is rank 0 (the front: HTTP, the
``InferenceServer``), and it spawns the N*M - 1 followers itself, a
hidden follower mode of the same module joined through a
``tcp://127.0.0.1`` rendezvous (parallel/serving.py is the lockstep
between them). Rank r serves on ``cuda:(r % device_count)``: NCCL when
every rank has a card of its own, gloo with collectives staged through
host buffers when ranks share one (printed at startup). Each rank
restores the one-process checkpoint or makes the seeded init, merges a
LoRA adapter on the float32 masters, quantizes them under --int8, and
only then takes its blocks. The front exits non-zero when a follower
exits or wedges; nothing falls back to one rank. Compositions the
reference serves over a mesh but this port does not yet (--draft-layers,
--prefix-cache, --kv-spill-mb, --standby, --role, --weights-from,
--fleet-catalog; beams answer 422) exit at startup "... is not ported
yet under --tp/--cp".

Weights come from the latest ``step_<n>/`` checkpoint of the port's
trainer under --checkpoint-dir (params only: the optimizer moments stay
on disk; the EMA shadow with --use-ema), or from a seeded
initialization when there is none; a LoRA adapter under --lora-dir is
merged into those float32 weights before --int8 quantizes them. Model
flags that disagree with the checkpoint fail at startup. With
--weights-from HOST:PORT the weights are fetched from that warm peer over
cp-mux/1 instead (fleet/standby.py), the seeded tree as the template; a
failed fetch falls back to the checkpoint, else to the seeded weights.

With --fleet-catalog (``file:DIR`` or a Consul address) the replica
joins a fleet: a FleetMember registers it and heartbeats its note, and
SIGTERM drains it (migrate the cached sessions to the survivors within
--migrate-window, deregister, finish in-flight work).
"""
from __future__ import annotations

import argparse
import asyncio
from typing import Any, Dict, Tuple

# reference flags the port does not run yet: dest -> (flag, default)
_NOT_PORTED: Dict[str, Tuple[str, Any]] = {}


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="supervised inference server (PyTorch/CUDA port)"
    )
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument(
        "--mux", default=True, action=argparse.BooleanOptionalAction,
        help="accept cp-mux/1 upgrades (the fleet gateway's "
        "multiplexed transport); --no-mux keeps this replica plain "
        "HTTP/1.1 and gateways fall back per-replica",
    )
    parser.add_argument("--max-len", type=int, default=512)
    parser.add_argument("--d-model", type=int, default=256)
    parser.add_argument("--n-layers", type=int, default=2)
    parser.add_argument("--n-heads", type=int, default=4)
    parser.add_argument("--n-kv-heads", type=int, default=0,
                        help="GQA kv heads (0 = full multi-head); must "
                        "match the checkpoint being served")
    parser.add_argument("--moe-experts", type=int, default=0,
                        help="switch-MoE experts; must match the "
                        "checkpoint being served")
    parser.add_argument("--window", type=int, default=0,
                        help="sliding-window attention; must match the "
                        "checkpoint being served. Decode KV memory "
                        "becomes a ring of `window` slots")
    parser.add_argument("--vocab", type=int, default=1024)
    parser.add_argument(
        "--checkpoint-dir", default="",
        help="load trained params from the latest checkpoint",
    )
    parser.add_argument(
        "--use-ema", action="store_true",
        help="serve the EMA shadow weights from the checkpoint "
        "(trained with --ema-decay) instead of the raw params",
    )
    parser.add_argument(
        "--int8", action="store_true",
        help="weight-only int8; decode projections run the int8 kernel",
    )
    parser.add_argument(
        "--kv-int8", action="store_true",
        help="int8 KV cache: halves decode KV memory vs bf16 "
        "(per-token-per-head scales; composes with GQA and --window)",
    )
    parser.add_argument(
        "--lora-dir", default="",
        help="merge a trained LoRA adapter checkpoint into the base "
        "weights at startup (zero runtime overhead); requires "
        "--lora-rank to match the adapter",
    )
    parser.add_argument(
        "--lora-rank", type=int, default=0,
        help="rank of the adapter in --lora-dir",
    )
    parser.add_argument(
        "--draft-layers", type=int, default=0,
        help="self-speculative decoding: draft with the model's first "
        "N layers; greedy single-sequence requests decode several "
        "tokens per target pass with identical output (0 = off)",
    )
    parser.add_argument(
        "--speculate", type=int, default=4,
        help="draft tokens proposed per verify round",
    )
    parser.add_argument(
        "--max-batch-rows", type=int, default=16,
        help="continuous batching: max sequences coalesced into one "
        "device call",
    )
    parser.add_argument(
        "--prefill-chunk", type=int, default=0,
        help="stream prompts longer than N through chunked prefill "
        "(peak prefill activations O(N) instead of O(prompt)); 0 = "
        "one-shot prefill",
    )
    parser.add_argument(
        "--prefix-cache", type=int, default=0,
        help="prefix KV reuse: keep the KV caches of the last N prompts "
        "and re-prefill only the unseen suffix of single-row requests "
        "sharing a prefix; 0 = off",
    )
    parser.add_argument(
        "--kv-spill-mb", type=float, default=0.0,
        help="host-RAM spill tier under --prefix-cache: evicted KV "
        "prefixes move to a byte-budgeted host LRU (this many MiB) and "
        "readmit on a later match; handed-off entries (/v1/kv/pull) "
        "land here too. 0 = off",
    )
    parser.add_argument(
        "--text", action="store_true",
        help="enable the text surface: POST /v1/completions encodes "
        "prompts with the built-in byte-level tokenizer (requires "
        "--vocab >= 259)",
    )
    parser.add_argument(
        "--slots", type=int, default=0,
        help="continuous decode admission: single-row requests join a "
        "running chunked decode over a pool of N slots (on the card, "
        "each chunk is a CUDA-graph replay); 0 = off. Composes with "
        "--prefill-chunk and --prefix-cache",
    )
    parser.add_argument(
        "--slot-chunk", type=int, default=8,
        help="tokens decoded per slot-engine chunk between admissions",
    )
    parser.add_argument(
        "--slot-window", type=int, default=4,
        help="decode chunk-rounds per dispatch with an early exit on the "
        "device; 1 = one dispatch per chunk",
    )
    # fleet membership: register in the discovery catalog with a TTL
    # heartbeat; SIGTERM drains (migrate, deregister, finish in-flight)
    parser.add_argument(
        "--fleet-catalog", default="",
        help="join an inference fleet: discovery backend URI "
        "('file:/shared/catalog' or 'consul:8500'); empty = lone "
        "replica (no registration)",
    )
    parser.add_argument(
        "--fleet-service", default="inference",
        help="service name to register under",
    )
    parser.add_argument(
        "--fleet-ttl", type=int, default=10,
        help="TTL seconds on the catalog health check",
    )
    parser.add_argument(
        "--fleet-address", default="127.0.0.1",
        help="address to advertise in the catalog",
    )
    parser.add_argument(
        "--fleet-id", default="",
        help="instance id in the catalog (default: <service>-<random>)",
    )
    parser.add_argument(
        "--migrate-window", type=float, default=5.0,
        help="seconds a drain spends migrating this replica's cached KV "
        "prefixes to the digest-coldest healthy survivors before "
        "deregistering; 0 = plain drain. Failures fall back to "
        "re-prefill on the survivors",
    )
    parser.add_argument(
        "--standby", action="store_true",
        help="boot as a warm standby: load weights, warm, register under "
        "role=standby (heartbeating, never routed to); POST "
        "/v3/standby/promote turns it active",
    )
    parser.add_argument(
        "--role", default="mixed", choices=("mixed", "prefill", "decode"),
        help="phase specialization for a disaggregated fleet: 'prefill' "
        "replicas take fresh prompts and ship the KV prefix to a decode "
        "peer over cp-mux/1; 'decode' replicas generate off handed-off "
        "prefixes; 'mixed' serves both. Routing advice only; --standby "
        "wins over it",
    )
    parser.add_argument(
        "--weights-from", default="",
        help="fetch the weights from a warm peer replica (host:port) over "
        "cp-mux/1 instead of reading a checkpoint; any failure falls "
        "back to the --checkpoint-dir or seeded load",
    )
    parser.add_argument(
        "--adopt-compile-cache", default=True,
        action=argparse.BooleanOptionalAction,
        help="when joining a fleet without CONTAINERPILOT_TORCH_BUILD_DIR "
        "set, adopt a same-host peer's advertised kernel build "
        "directory (its cc= heartbeat field): its built libraries load "
        "and nvcc is skipped",
    )
    parser.add_argument(
        "--tp", type=int, default=1,
        help="tensor-parallel ways: shard the model over N ranks (heads, "
        "ffn and vocab partitioned; one process a rank, spawned by this "
        "command); 1 = one rank",
    )
    parser.add_argument(
        "--cp", type=int, default=1,
        help="context-parallel prefill ways: long single-row prompts ring "
        "their prefill over a seq axis of N ranks; 1 = off. Composes "
        "with --tp (a seq x model mesh over cp*tp ranks) and --slots; "
        "rejects --draft-layers/--prefix-cache/--window",
    )
    parser.add_argument(
        "--cp-min-len", type=int, default=0,
        help="prompts at least this long take the --cp ring (default 8x "
        "the seq axis)",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="torch device to serve on (default cuda; 'cpu' runs the "
        "plain torch versions of the kernels)",
    )
    # the follower mode the front spawns (--tp/--cp): never set by hand
    parser.add_argument("--follower-rank", type=int, default=0,
                        help=argparse.SUPPRESS)
    parser.add_argument("--rendezvous", default="", help=argparse.SUPPRESS)
    parser.add_argument("--lockstep-deadline", type=float, default=600.0,
                        help=argparse.SUPPRESS)
    not_ported = parser.add_argument_group(
        "reference flags not ported yet (any value but the default "
        "exits)"
    )
    for dest, (flag, default) in _NOT_PORTED.items():
        if isinstance(default, bool):
            action = (
                argparse.BooleanOptionalAction if default else "store_true"
            )
            not_ported.add_argument(flag, dest=dest, default=default,
                                    action=action)
        else:
            not_ported.add_argument(flag, dest=dest, default=default,
                                    type=type(default))
    return parser


def check_ported(args: argparse.Namespace) -> None:
    """Refuse at startup, before any rank starts, what the reference
    refuses (its messages: --tp that does not divide the model, the
    compositions --cp rejects, LoRA flag misuse), and exit with a clear
    message for a flag this port does not run yet, or not yet under
    --tp/--cp."""
    from .modelcfg import derive_d_ff, validate_lora_flags
    from .serve import refuse_cp_compositions, unported_under_mesh

    for dest, (flag, default) in _NOT_PORTED.items():
        if getattr(args, dest) != default:
            raise SystemExit(
                f"{flag} is not ported yet to the PyTorch/CUDA server "
                "(see ROADMAP.md queue 1)"
            )
    tp, cp = max(args.tp, 1), max(args.cp, 1)
    if tp > 1:
        _validate_tp(args.n_heads, derive_d_ff(args.d_model), args.vocab,
                     args.moe_experts, tp)
    if cp > 1:
        refuse_cp_compositions(args.draft_layers, args.prefix_cache,
                               args.window)
    validate_lora_flags(args.lora_dir, args.lora_rank)
    if tp * cp > 1:
        role = "standby" if args.standby else (
            "active" if args.role == "mixed" else args.role)
        refused = unported_under_mesh(
            args.draft_layers, args.prefix_cache, args.kv_spill_mb, role)
        for flag, on in (("--weights-from", bool(args.weights_from)),
                         ("--fleet-catalog", bool(args.fleet_catalog))):
            if refused is None and on:
                refused = (flag, f"{flag} is not ported yet under "
                           "--tp/--cp (see ROADMAP.md queue 1)")
        if refused is not None:
            raise SystemExit(refused[1])


def _validate_tp(n_heads: int, d_ff: int, vocab: int, moe_experts: int,
                 tp: int) -> None:
    """Every axis the partition rules put on ``model`` must divide by
    tp (the reference's messages)."""
    for name, size in (("n_heads", n_heads), ("d_ff", d_ff),
                       ("vocab", vocab)):
        if size % tp:
            raise SystemExit(f"--tp {tp} must divide {name} ({size})")
    if moe_experts > 1 and moe_experts % tp:
        raise SystemExit(f"--tp {tp} must divide moe_experts ({moe_experts})")


def load_model(args: argparse.Namespace, mesh=None, device=None):
    """-> (cfg, params, checkpoint) per the flags: float32 masters from
    the latest checkpoint under --checkpoint-dir (its EMA shadow with
    --use-ema, the raw params with a warning when it has none) or, with
    no checkpoint there, seeded; a --lora-dir adapter merged into them;
    quantized under --int8 (on the merged masters); on a ``mesh``, cut
    to this rank's blocks (``shard_params``, the int8 leaves with the
    float rules); then cast once to the compute dtype. ``checkpoint`` is
    {"step", "ema"} of what was restored, None for the seeded init.
    ``device`` defaults to --device."""
    from .. import resolve_device
    from ..models.quantized import (
        cast_params,
        param_bytes,
        quantize_model_params,
    )
    from ..models.transformer import TransformerConfig, init_params
    from ..parallel import abstract_train_state, restore_params
    from .modelcfg import derive_d_ff, merge_lora, validate_lora_flags

    cfg = TransformerConfig(
        vocab_size=args.vocab,
        d_model=args.d_model,
        n_heads=args.n_heads,
        n_kv_heads=args.n_kv_heads,
        n_layers=args.n_layers,
        d_ff=derive_d_ff(args.d_model),
        max_seq_len=args.max_len,
        moe_experts=args.moe_experts,
        window=args.window,
        kv_int8=args.kv_int8,
    )
    device = args.device if device is None else device
    params, checkpoint = None, None
    if args.checkpoint_dir:
        # params only: serving never pays train-state memory
        restored = restore_params(
            args.checkpoint_dir, abstract_train_state(cfg),
            prefer_ema=args.use_ema, device=resolve_device(device),
        )
        if restored is not None:
            params, step = restored
            checkpoint = {"step": int(step), "ema": restored.ema}
            print(f"serving checkpoint step {step}"
                  + (" (EMA weights)" if restored.ema else ""))
    if params is None:
        params = init_params(0, cfg, device=device)
    validate_lora_flags(args.lora_dir, args.lora_rank)
    if args.lora_dir:
        params, lora_step = merge_lora(params, cfg, args.lora_dir,
                                       args.lora_rank)
        print(f"merged lora adapter (rank {args.lora_rank}, "
              f"step {lora_step})")
    if args.int8:
        dense = param_bytes(cast_params(params, cfg.dtype))
        params = quantize_model_params(params)
        quant = param_bytes(cast_params(params, cfg.dtype))
        print(
            f"int8: resident params {dense} -> {quant} bytes "
            f"({dense / quant:.1f}x smaller)"
        )
    if mesh is not None and mesh.size > 1:
        from ..parallel.sharding import shard_params

        params = shard_params(params, mesh, cfg)
    return cfg, cast_params(params, cfg.dtype), checkpoint


def fetch_peer_weights(args: argparse.Namespace, params):
    """--weights-from: the peer's params over cp-mux/1 with ``params``
    as the template, or None when the transfer failed."""
    import time

    from ..fleet.standby import fetch_params

    host, _, port_s = args.weights_from.rpartition(":")
    t0 = time.perf_counter()
    fetched = asyncio.run(
        fetch_params(host or "127.0.0.1", int(port_s), params)
    )
    if fetched is not None:
        print(f"weights fetched from peer {args.weights_from} in "
              f"{time.perf_counter() - t0:.3f}s", flush=True)
    return fetched


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _join(args: argparse.Namespace, rank: int, world: int, url: str):
    """This rank's process group, mesh and lockstep: NCCL when every
    rank has a card of its own, else gloo (collectives on CUDA tensors
    staged through host buffers)."""
    import datetime

    import torch
    import torch.distributed as dist

    from .. import resolve_device
    from ..parallel.distributed import _backend_for
    from ..parallel.mesh import MeshPlan, make_mesh, rank_device
    from ..parallel.serving import Lockstep

    device = resolve_device(rank_device(rank, args.device))
    backend = _backend_for(device, world)
    if backend == "nccl":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=url, rank=rank, world_size=world,
        timeout=datetime.timedelta(
            seconds=max(args.lockstep_deadline, 300.0)))
    mesh = make_mesh(MeshPlan(data=1, model=max(args.tp, 1),
                              seq=max(args.cp, 1)), device=device)
    if rank == 0:
        print(f"mesh: {mesh.shape} on {device.type}", flush=True)
    print(f"rank {rank} of {mesh.size}: collectives over {mesh.backend}"
          + (", staged through host buffers" if mesh.staging else ""),
          flush=True)
    # armed now: a rank that wedges while loading or warming ends the
    # world (the first deadline at least 120 s, for the model's load)
    lockstep = Lockstep(args.lockstep_deadline)
    return mesh, lockstep.start(grace_s=max(args.lockstep_deadline, 120.0))


def serve_over_ranks(args: argparse.Namespace, argv=None,
                     follower_cmd=None) -> int:
    """--tp/--cp: rank 0 spawns the followers (``follower_cmd`` + this
    command's arguments + the hidden follower flags; default ``python
    -m containerpilot_tpu_torch.workload.serve``), every rank joins the
    world, loads its blocks and builds its side of the server; the
    front serves HTTP until SIGTERM and exits non-zero as soon as a
    follower exits on its own."""
    import os
    import signal
    import subprocess
    import sys
    import threading

    import torch
    import torch.distributed as dist

    from ..parallel.watchdog import EXIT_CODE
    from .serve import ServingFollower

    world = max(args.tp, 1) * max(args.cp, 1)
    rank = args.follower_rank
    procs = []
    if rank == 0:
        if torch.device(args.device).type == "cuda":
            from ..ops import _build

            # built once, before the followers load them
            _build.build_all()
        url = f"tcp://127.0.0.1:{_free_port()}"
        cmd = follower_cmd or [sys.executable, "-m",
                               "containerpilot_tpu_torch.workload.serve"]
        base = list(sys.argv[1:] if argv is None else argv)
        for r in range(1, world):
            procs.append(subprocess.Popen(
                [*cmd, *base, "--follower-rank", str(r), "--rendezvous",
                 url]))
        print(f"serving over {world} ranks: follower pids "
              f"{[p.pid for p in procs]}", flush=True)
    else:
        url = args.rendezvous
        # a follower ends by the front's shutdown op (or when the front
        # is gone); a signal to the process group is the front's to take
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, signal.SIG_IGN)
    stopping = threading.Event()

    def watch_followers() -> None:
        while not stopping.wait(0.2):
            for r, p in enumerate(procs, start=1):
                if p.poll() is not None and not stopping.is_set():
                    print(f"follower rank {r} exited with code "
                          f"{p.returncode}; the front exits {EXIT_CODE}",
                          file=sys.stderr, flush=True)
                    os._exit(EXIT_CODE)

    try:
        if procs:
            threading.Thread(target=watch_followers, daemon=True,
                             name="followers").start()
        mesh, lockstep = _join(args, rank, world, url)
        cp_mesh = mesh if args.cp > 1 else None
        cfg, params, checkpoint = load_model(args, mesh, mesh.device)
        if rank == 0:
            return _serve(args, cfg, params, checkpoint, mesh=mesh,
                          cp_mesh=cp_mesh, lockstep=lockstep,
                          stopping=stopping)
        follower = ServingFollower(
            cfg, params, args.max_len, mesh, lockstep, cp_mesh=cp_mesh,
            cp_min_len=args.cp_min_len, prefill_chunk=args.prefill_chunk,
            slots=args.slots, slot_chunk=args.slot_chunk,
            slot_window=args.slot_window)
        return follower.run()
    finally:
        stopping.set()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        if dist.is_initialized():
            dist.destroy_process_group()


def main(argv=None, follower_cmd=None) -> int:
    import logging
    import os

    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(name)s %(message)s"
    )
    args = build_arg_parser().parse_args(argv)
    check_ported(args)
    if max(args.tp, 1) * max(args.cp, 1) > 1:
        return serve_over_ranks(args, argv, follower_cmd)
    backend = None
    if args.fleet_catalog:
        from ..discovery.factory import new_backend

        backend = new_backend(args.fleet_catalog)
        if backend is None:
            raise SystemExit(
                "--fleet-catalog resolved to no discovery backend"
            )
    if (backend is not None and args.adopt_compile_cache
            and not os.environ.get("CONTAINERPILOT_TORCH_BUILD_DIR")):
        from .modelcfg import adopt_fleet_compile_cache

        adopted = adopt_fleet_compile_cache(backend, args.fleet_service)
        if adopted:
            print(f"adopted fleet kernel build dir {adopted}", flush=True)
    checkpoint_dir = args.checkpoint_dir
    if args.weights_from:
        if not args.weights_from.rpartition(":")[2].isdigit():
            raise SystemExit(
                f"--weights-from wants host:port, got {args.weights_from!r}"
            )
        args.checkpoint_dir = ""  # skip the restore the peer replaces
    cfg, params, checkpoint = load_model(args)
    if args.weights_from:
        fetched = fetch_peer_weights(args, params)
        if fetched is not None:
            params = fetched
        elif checkpoint_dir:
            print("peer weight transfer failed; falling back to the "
                  "checkpoint restore", flush=True)
            args.checkpoint_dir = checkpoint_dir
            cfg, params, checkpoint = load_model(args)
        else:
            print("peer weight transfer failed; serving the seeded "
                  "weights", flush=True)
    return _serve(args, cfg, params, checkpoint, backend=backend)


def _serve(args: argparse.Namespace, cfg, params, checkpoint, backend=None,
           mesh=None, cp_mesh=None, lockstep=None, stopping=None) -> int:
    """Build the server (the front, over ranks) and serve until SIGTERM."""
    import signal

    from .serve import InferenceServer

    # --standby wins; "mixed" is the server's "active", so fleets that
    # never pass --role send the notes they always did
    role = "standby" if args.standby else (
        "active" if args.role == "mixed" else args.role)
    server = InferenceServer(
        cfg, params, args.host, args.port, args.max_len,
        checkpoint=checkpoint,
        max_batch_rows=args.max_batch_rows,
        device=args.device if mesh is None else mesh.device,
        prefix_cache_entries=args.prefix_cache,
        kv_spill_bytes=int(args.kv_spill_mb * 1024 * 1024),
        prefill_chunk=args.prefill_chunk, slots=args.slots,
        slot_chunk=args.slot_chunk, slot_window=args.slot_window,
        draft_layers=args.draft_layers, speculate=args.speculate,
        text=args.text, mux=args.mux, role=role,
        mesh=mesh, cp_mesh=cp_mesh, cp_min_len=args.cp_min_len,
        lockstep=lockstep,
    )
    if server.slot_engine is not None and mesh is not None:
        mode = server.slot_engine.program.mode
        why = ("collectives staged through host buffers cannot be "
               "captured" if mesh.staging else
               "NCCL collectives in a captured round are not ported")
        print(f"step program: {mode}"
              + (f" ({why})" if mode == "uncaptured" else ""), flush=True)
    if lockstep is not None:
        lockstep.start_checks()
    member = None
    if backend is not None:
        from ..fleet import FleetMember

        member = FleetMember(
            server, backend, args.fleet_service,
            ttl=args.fleet_ttl, address=args.fleet_address,
            instance_id=args.fleet_id,
            migrate_window=args.migrate_window,
        )

    async def serve() -> None:
        await server.run()
        if member is not None:
            # after run(): a --port 0 bind has resolved, and the
            # heartbeat only fires once warmup turned ready
            await member.start()
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(sig, stop.set)
        await stop.wait()
        if member is not None:
            # SIGTERM is a drain: migrate the cached sessions within
            # --migrate-window, deregister, finish in-flight work
            await member.drain(timeout=30.0)
            await member.stop(deregister=False)
        if stopping is not None:
            stopping.set()  # the followers' exits are expected from here
        await server.stop()

    asyncio.run(serve())
    return 0

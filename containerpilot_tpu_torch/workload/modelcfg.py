"""The flag, request, scoring, eval and LoRA-merge helpers the server,
the trainer and the evaluator share (counterparts of
``containerpilot_tpu/workload/modelcfg.py``'s ``derive_d_ff``,
``parse_logit_bias``, ``parse_stop_ids``, ``score_logprobs_fn``,
``average_eval_loss``, ``validate_lora_flags``, ``merge_lora`` and
``restore_merged_params``; the port keeps its own), and the kernel
build directory as a fleet artifact (``compile_cache_note``,
``adopt_fleet_compile_cache``).

The port's counterpart of the reference's XLA compile cache is the
kernel build directory (``ops/_build.py``): each built library's name
carries a hash of its sources and flags, so a launch pointed at a
same-host peer's directory loads the peer's libraries and runs no
``nvcc``. The reference's warm-bucket markers have no counterpart: the
port compiles no per-shape program (its CUDA graphs are captured in
each process and cannot be persisted)."""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from ..models.decode import BIAS_SLOTS_MAX
from ..models.transformer import FLASH_BLOCK, forward_with_aux, loss_fn


def derive_d_ff(d_model: int) -> int:
    """The shared SwiGLU width rule: ~3x d_model, floored to a 128
    multiple, never 0."""
    return d_model * 3 // 128 * 128 or 128


def score_logprobs_fn(cfg: Any, mesh: Any = None) -> Callable:
    """The one teacher-forced scoring function: ``score(params, toks)``
    -> per-token logprobs [b, n - 1] float32 of toks[:, 1:] from a
    forward over toks[:, :-1] (a float32 log-softmax, then a gather).
    The forward's length is padded to a multiple of the flash block, so
    a long row takes the flash kernel (K1 on the card); causal attention
    leaves every real position unchanged by the pad. ``mesh``: the
    params are a rank's blocks (the vocab shards gathered whole)."""

    @torch.inference_mode()
    def score(params, toks: torch.Tensor) -> torch.Tensor:
        s = toks.shape[1] - 1
        inputs = torch.nn.functional.pad(
            toks[:, :-1], (0, -s % FLASH_BLOCK)
        )
        logits = forward_with_aux(params, inputs, cfg, mesh)[0][:, :s]
        logp = torch.log_softmax(logits.float(), dim=-1)
        return torch.gather(logp, -1, toks[:, 1:, None].long())[..., 0]

    return score


def parse_logit_bias(raw: Any, vocab_size: int):
    """OpenAI's {token_id: bias} with string or int keys; ``{}`` and None
    are a no-op. Raises ValueError for the 422 path."""
    if raw is None:
        return None
    if not isinstance(raw, dict):
        raise ValueError("'logit_bias' must be a {token_id: bias} object")
    if not raw:
        return None
    if len(raw) > BIAS_SLOTS_MAX:
        raise ValueError(f"'logit_bias' is capped at {BIAS_SLOTS_MAX} tokens")
    out = {}
    for k, v in raw.items():
        try:
            tok = int(k)
            bias = float(v)
        except (TypeError, ValueError):
            raise ValueError(
                "'logit_bias' keys must be token ids and values numbers"
            ) from None
        if not 0 <= tok < vocab_size:
            raise ValueError(
                f"'logit_bias' token ids must be in [0, {vocab_size})"
            )
        if not abs(bias) <= 100:
            raise ValueError("'logit_bias' values must be in [-100, 100]")
        out[tok] = bias
    return out


def parse_stop_ids(raw: Any, vocab_size: int):
    """A list of at most 8 non-empty id rows (1..32 ids each). Raises
    ValueError for the 422 path."""
    if raw is None:
        return []
    if not isinstance(raw, list) or len(raw) > 8 or not all(
        isinstance(s, list)
        and 1 <= len(s) <= 32
        and all(
            isinstance(t, int) and not isinstance(t, bool)
            and 0 <= t < vocab_size
            for t in s
        )
        for s in raw
    ):
        raise ValueError(
            "'stop' must be a list of at most 8 sequences, each "
            f"1..32 token ids in [0, {vocab_size})"
        )
    return raw


@torch.no_grad()
def parse_stop_strings(raw: Any):
    """The string-level half of the ``stop`` contract, shared by both
    text surfaces (single-host and pod /v1/completions): one string or
    a list of at most 8, each 1..32 UTF-8 bytes. Validated BEFORE
    encoding so the 422 speaks the text endpoint's language (the
    id-level bounds in parse_stop_ids would otherwise leak through).
    Returns the list of strings (None -> None)."""
    if raw is None:
        return None
    if isinstance(raw, str):
        raw = [raw]
    if (
        not isinstance(raw, list)
        or len(raw) > 8
        or not all(
            isinstance(s, str) and 1 <= len(s.encode()) <= 32
            for s in raw
        )
    ):
        raise ValueError(
            "'stop' must be a non-empty string (or a list of at "
            "most 8), each at most 32 UTF-8 bytes"
        )
    return raw


def average_eval_loss(
    params, cfg, n: int, batch_at: Callable[[int], np.ndarray],
    mesh: Any = None, microbatches: int = 0,
) -> float:
    """The one eval-loss computation (loss_fn averaged over n batches,
    no autograd) shared by the trainer's in-loop eval and the standalone
    evaluate CLI, so their numbers are comparable by construction.

    With a ``mesh`` of several ranks (collective: every rank calls it
    with the same batches) ``params`` are the rank's blocks (FSDP's
    under ``mesh.fsdp``, a pipeline's when ``microbatches`` > 0): each
    rank scores its rows and positions and the means are averaged over
    ``data`` and ``seq``, so every rank returns the same number, one
    rank's eval of the gathered params up to reassociation."""
    multi = mesh is not None and mesh.size > 1
    device = params["norm_out"].device
    total = 0.0
    with torch.no_grad():
        for i in range(n):
            toks = torch.as_tensor(np.asarray(batch_at(i))).long().to(device)
            if not multi:
                total += float(loss_fn(params, toks, cfg))
                continue
            from ..parallel import train as ptrain

            if microbatches:
                from ..parallel.mesh import wait_all
                from ..parallel.pipeline import pipeline_loss_fn

                loss = pipeline_loss_fn(params, toks, cfg, mesh,
                                        microbatches)
                wait_all(mesh.traffic["pending"])
            else:
                loss = loss_fn(params, ptrain.local_rows(toks, mesh),
                               ptrain.seq_train_config(cfg, mesh), mesh)
            total += float(ptrain.batch_mean(loss, mesh))
    return total / n


def validate_lora_flags(lora_dir: str, lora_rank: int) -> None:
    """Clean SystemExit for the flag-misuse cases every CLI shares."""
    if lora_rank > 0 and not lora_dir:
        raise SystemExit("--lora-rank without --lora-dir does nothing; "
                         "pass the adapter checkpoint dir")
    if lora_dir and lora_rank < 1:
        raise SystemExit("--lora-dir requires --lora-rank")


def merge_lora(params, cfg, lora_dir: str, lora_rank: int,
               device=None, mesh=None) -> Tuple[Any, int]:
    """Restore a trained adapter (params only) from the latest
    checkpoint under ``lora_dir`` onto ``device`` (default: the params')
    and fold it into the base weights -> (merged params, adapter step).
    Merge before any quantization: an int8 base is not adaptable.
    ``mesh``: ``params`` may be this rank's blocks (``apply_lora``'s
    ``mesh``); every rank restores the whole adapter, which is small."""
    from ..models.lora import apply_lora
    from ..parallel import lora_abstract_state, restore_params

    adapter = restore_params(
        lora_dir, lora_abstract_state(cfg, lora_rank),
        device=device or params["norm_out"].device,
    )
    if adapter is None:
        raise SystemExit(f"no adapter checkpoint in {lora_dir}")
    return apply_lora(params, adapter[0], cfg, mesh=mesh), int(adapter[1])


def restore_params_only(cfg, mesh, checkpoint_dir: str,
                        use_ema: bool = False, device="cuda"):
    """The serving restore: params only (the EMA shadow with
    ``use_ema``) of the latest checkpoint under ``checkpoint_dir`` ->
    ``RestoredParams`` (params, step), or None when there is none. With
    a ``mesh`` of several ranks (collective: every rank calls it) the
    step is rank 0's and each rank keeps only its blocks under the
    tensor-parallel rules, so no rank holds the whole model."""
    from ..models.transformer import init_params
    from ..parallel import TrainState, restore_params
    from ..parallel.sharding import param_sharding_rules

    multi = mesh is not None and mesh.size > 1
    # the params' structure on the meta device: a restore reads only the
    # params, so no optimizer is built (its first init imports much)
    like = TrainState(init_params(0, cfg, device="meta"), {}, 0)
    return restore_params(
        checkpoint_dir, like, prefer_ema=use_ema,
        device=device, mesh=mesh if multi else None,
        rules=param_sharding_rules(cfg, mesh) if multi else None,
    )


def restore_merged_params(cfg, checkpoint_dir: str, use_ema: bool = False,
                          lora_dir: str = "", lora_rank: int = 0,
                          device="cuda") -> Optional[Any]:
    """A params-only restore of the latest checkpoint plus an optional
    ``merge_lora``: what the evaluate CLI scores. Returns
    ``RestoredParams`` (params, checkpoint step, with ``.ema`` from the
    base restore), or None when no checkpoint exists."""
    from ..parallel import abstract_train_state, restore_params
    from ..parallel.checkpoint import RestoredParams

    validate_lora_flags(lora_dir, lora_rank)
    restored = restore_params(checkpoint_dir, abstract_train_state(cfg),
                              prefer_ema=use_ema, device=device)
    if restored is None:
        return None
    params, step = restored
    if lora_dir:
        params, _ = merge_lora(params, cfg, lora_dir, lora_rank, device)
    return RestoredParams(params, step, restored.ema)


def compile_cache_note(build_dir: str) -> str:
    """The ``cc=`` heartbeat value for a replica whose kernels live in
    ``build_dir``: ``<digest>:<quoted dir>``, the digest over the built
    libraries' names (each carries its sources' hash), so readers see
    when the built set moved. Empty when the directory holds no built
    library (a CPU replica builds none)."""
    import hashlib
    import os

    from ..fleet.notes import encode_compile_cache

    try:
        libs = sorted(f for f in os.listdir(build_dir) if f.endswith(".so"))
    except OSError:
        return ""
    if not libs:
        return ""
    digest = hashlib.blake2b("\n".join(libs).encode(),
                             digest_size=4).hexdigest()
    return encode_compile_cache(digest, build_dir)


def _local_addresses() -> set:
    """Addresses that mean "this host" for build-directory adoption."""
    import socket

    local = {"127.0.0.1", "localhost", "0.0.0.0", "::1", ""}
    try:
        hostname = socket.gethostname()
        local.add(hostname)
        local.update(info[4][0] for info in socket.getaddrinfo(hostname, None))
    except OSError:
        # a host that can't resolve itself still adopts loopback
        # advertisements; remote ones are skipped either way
        return local
    return local


def adopt_fleet_compile_cache(backend: Any, service_name: str) -> Optional[str]:
    """Scan the catalog for a peer on THIS host advertising its kernel
    build directory (``cc=``) and point this process's builds at it
    (``CONTAINERPILOT_TORCH_BUILD_DIR``): the peer's libraries load and
    ``nvcc`` is skipped. Returns the adopted directory, or None when no
    same-host peer advertises one that exists here."""
    import os

    from ..fleet import notes as notes_mod

    try:
        instances = backend.instances(service_name)
    except Exception:
        return None
    local = _local_addresses()
    for inst in instances:
        if getattr(inst, "address", "") not in local:
            continue
        fields = notes_mod.split_note(getattr(inst, "notes", ""))
        _digest, build_dir = notes_mod.parse_field("cc", fields.get("cc", ""))
        if build_dir and os.path.isdir(build_dir):
            os.environ["CONTAINERPILOT_TORCH_BUILD_DIR"] = build_dir
            return build_dir
    return None

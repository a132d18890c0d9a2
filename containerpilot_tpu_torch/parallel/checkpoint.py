"""Checkpoint save/restore for the supervised trainer, torch-native
(counterpart of ``containerpilot_tpu/parallel/checkpoint.py``; no orbax).

Layout: ``<dir>/step_<n>/state.pt``, one ``torch.save`` of
``{"params", "opt_state", "step"}`` with every tensor on the host, whole.
A save writes into ``<dir>/.step_<n>.<pid>.tmp/`` and renames the
directory into place, so a crash mid-save never leaves a ``step_<n>``
that ``latest_step`` would pick; older steps are pruned after each save
(``KEEP_CHECKPOINTS``).

``save_checkpoint(..., wait=False)`` copies the tensors to the host
before it returns, so the train loop may go on updating its state in
place, and writes to disk on a background thread;
``wait_for_checkpoints`` joins it and raises its error, if any.

Across ranks (``mesh=`` a mesh of more than one rank), the reference's
contract holds: every rank calls save and restore in lockstep on ONE
shared directory.

- The resume step is rank 0's ``latest_step``, broadcast, so every rank
  makes the same decision (a rank that found no checkpoint while its
  peers restore would deadlock the world).
- A save gathers the whole state (``sharding.gather_state``: a
  collective, synchronous on every rank) and rank 0 alone writes the
  one-process format above and prunes; no other rank writes. With
  ``wait=False`` rank 0 writes on its background thread.
- A failed write on rank 0 is made every rank's failure: after a
  synchronous write, or at the next save or ``wait_for_checkpoints``
  for an asynchronous one, rank 0's outcome is broadcast and every rank
  raises.
- A restore loads the file on every rank (memory-mapped) and cuts the
  rank's blocks (``sharding.shard_state``) under the caller's layout.

Because the format is one, a checkpoint of any layout restores into any
other, into one process, and into ``restore_params`` for serving and
evaluation.
"""
from __future__ import annotations

import logging
import os
import re
import shutil
import threading
import time
from typing import Any, Optional

import torch

from .sharding import gather_state, shard_state
from .train import TrainState, tree_leaves, tree_map

log = logging.getLogger("containerpilot.checkpoint")

_STEP_DIR = re.compile(r"^step_(\d+)$")
_FILE = "state.pt"

# older checkpoints kept after each save (crash tolerance only needs
# the latest; one spare guards against a corrupt newest)
KEEP_CHECKPOINTS = 2

_pending: Optional[threading.Thread] = None
_pending_error: Optional[BaseException] = None


def _step_path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"step_{step}")


def latest_step(directory: str) -> Optional[int]:
    """Newest complete checkpoint step in the directory, if any."""
    try:
        entries = os.listdir(directory)
    except OSError:
        return None
    steps = [int(m.group(1)) for e in entries if (m := _STEP_DIR.match(e))]
    return max(steps) if steps else None


def _prune(directory: str, keep: int) -> None:
    try:
        entries = os.listdir(directory)
    except OSError:
        return
    steps = sorted(
        int(m.group(1)) for e in entries if (m := _STEP_DIR.match(e))
    )
    for step in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(_step_path(directory, step), ignore_errors=True)


def _host_copy(state: TrainState) -> dict:
    """Everything on the host, detached, copied (never a view of a
    tensor the train loop goes on updating)."""
    def copy(t):
        if isinstance(t, torch.Tensor):
            return t.detach().to("cpu", copy=True)
        return t
    return {
        "params": tree_map(copy, state.params),
        "opt_state": tree_map(copy, state.opt_state),
        "step": int(state.step),
    }


def _write(directory: str, step: int, payload: dict, keep: int) -> None:
    os.makedirs(directory, exist_ok=True)
    final = _step_path(directory, step)
    tmp = os.path.join(
        os.path.abspath(directory),
        f".step_{step}.{os.getpid()}.{threading.get_ident()}.tmp",
    )
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(payload, os.path.join(tmp, _FILE))
    if os.path.exists(final):  # a re-save of the same step replaces it
        shutil.rmtree(final)
    os.replace(tmp, final)
    _prune(directory, keep)
    log.info("checkpoint: saved step %d to %s", step, directory)


def _multi(mesh) -> bool:
    return mesh is not None and mesh.size > 1


def _from_rank0(mesh, value: int) -> int:
    """Rank 0's ``value`` on every rank (a world all-reduce of a tensor
    that only rank 0 fills)."""
    t = torch.tensor([value if mesh.rank == 0 else 0], dtype=torch.int64,
                     device=mesh.device)
    return int(mesh.all_reduce_world(t).item())


def _join() -> Optional[BaseException]:
    """Join this process's in-flight write; its error, cleared."""
    global _pending, _pending_error
    if _pending is not None:
        _pending.join()
        _pending = None
    err, _pending_error = _pending_error, None
    return err


def _agree_on_write(mesh, err: Optional[BaseException]) -> None:
    """Rank 0's write outcome on every rank (collective): every rank
    raises when rank 0's write failed."""
    if _from_rank0(mesh, int(err is not None)):
        raise RuntimeError(
            "checkpoint save failed on rank 0"
            + (f": {err!r}" if err is not None else "")) from err


def wait_for_checkpoints(mesh=None) -> None:
    """Block until the in-flight background save has committed; raise
    its error if it failed. With a ``mesh`` of several ranks this is
    collective: rank 0's outcome is broadcast and every rank raises on
    a failed write."""
    err = _join()
    if _multi(mesh):
        _agree_on_write(mesh, err)
    elif err is not None:
        raise RuntimeError("background checkpoint save failed") from err


def save_checkpoint(
    directory: str, step: int, state: TrainState,
    keep: int = KEEP_CHECKPOINTS, wait: bool = True, *,
    mesh=None, layout=None,
) -> Optional[dict]:
    """Write ``state`` as ``<directory>/step_<step>``. ``wait=False``
    returns once the device->host copy is done and commits on a
    background thread (a second save first drains the previous one).

    With a ``mesh`` of several ranks, ``state`` is the rank's blocks
    under ``layout`` (the step's ``Layout``; None for a replicated state
    such as LoRA adapters) and every rank must call this: the gather is
    collective and rank 0 writes. Returns the save's figures on every
    rank of a multi-rank world (``gather_s``, ``write_s``: rank 0's
    synchronous write, ``host_bytes``: the full state rank 0 stages on
    the host), else None."""
    global _pending
    multi = _multi(mesh)
    wait_for_checkpoints(mesh)
    if not multi:
        payload = _host_copy(state)
    else:
        t0 = time.perf_counter()
        writer = mesh.rank == 0
        params, opt_state = gather_state(
            state.params, state.opt_state, mesh, layout, keep=writer,
            host=mesh.backend == "gloo")
        payload = None
        if writer:
            host = lambda t: (t.to("cpu") if isinstance(t, torch.Tensor)
                              else t)
            payload = {"params": tree_map(host, params),
                       "opt_state": tree_map(host, opt_state),
                       "step": int(state.step)}
        del params, opt_state
        figures = {"gather_s": time.perf_counter() - t0, "write_s": 0.0,
                   "host_bytes": _nbytes(payload) if writer else 0}
    if wait:
        if not multi:
            _write(directory, step, payload, keep)
            return None
        err = None
        if payload is not None:
            t0 = time.perf_counter()
            try:
                _write(directory, step, payload, keep)
            except Exception as exc:  # every rank raises below
                err = exc
            figures["write_s"] = time.perf_counter() - t0
        del payload
        _agree_on_write(mesh, err)
        return figures

    def commit() -> None:
        global _pending_error
        try:
            _write(directory, step, payload, keep)
        except BaseException as exc:  # surfaced by wait_for_checkpoints
            _pending_error = exc

    if payload is not None:
        _pending = threading.Thread(target=commit, daemon=False,
                                    name="checkpoint-commit")
        _pending.start()
    return figures if multi else None


def _nbytes(tree: Any) -> int:
    return sum(t.numel() * t.element_size()
               for part in ("params", "opt_state")
               for t in tree_leaves(tree[part])
               if isinstance(t, torch.Tensor))


def _device_of(state_like: Any, device) -> torch.device:
    if device is not None:
        return torch.device(device)
    first = next(
        (t for t in _leaves(state_like.params) if isinstance(t, torch.Tensor)),
        None,
    )
    if first is None or first.device.type == "meta":
        raise ValueError(
            "pass device= when state_like lives on the meta device"
        )
    return first.device


def _leaves(tree: Any, prefix: str = ""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _check_like(name: str, got: Any, like: Any) -> None:
    """Same tree, shapes and dtypes as the target; a mismatch (other
    model flags than the checkpoint's) raises instead of resuming wrong."""
    got_l, like_l = dict(_leaves(got)), dict(_leaves(like))
    if set(got_l) != set(like_l):
        raise ValueError(
            f"checkpoint {name} leaves {sorted(got_l)} differ from the "
            f"model's {sorted(like_l)}"
        )
    for path, t in like_l.items():
        c = got_l[path]
        if isinstance(t, torch.Tensor) and (
            not isinstance(c, torch.Tensor) or c.shape != t.shape
            or c.dtype != t.dtype
        ):
            got = (f"{c.dtype} {tuple(c.shape)}"
                   if isinstance(c, torch.Tensor) else type(c).__name__)
            raise ValueError(
                f"checkpoint {name}{path} is {got}, the model wants "
                f"{t.dtype} {tuple(t.shape)}"
            )


def _load(directory: str, step: int) -> dict:
    # mmap: only the storages actually moved to the device are read
    return torch.load(
        os.path.join(_step_path(directory, step), _FILE),
        map_location="cpu", mmap=True, weights_only=True,
    )


def resume_step(directory: str, mesh=None) -> Optional[int]:
    """``latest_step`` as every rank must see it: rank 0's, broadcast
    (collective) over a mesh of several ranks."""
    if not _multi(mesh):
        return latest_step(directory)
    step = latest_step(directory) if mesh.rank == 0 else None
    got = _from_rank0(mesh, -1 if step is None else step)
    return None if got < 0 else got


def restore_checkpoint(
    directory: str, state_like: TrainState, device=None, *,
    mesh=None, layout=None,
) -> Optional[TrainState]:
    """The latest checkpoint as a TrainState on ``device`` (default: the
    device of ``state_like``'s params), checked leaf for leaf against
    ``state_like`` (e.g. ``abstract_train_state``, on the meta device:
    the whole model's shapes); None when no checkpoint exists. Params
    come back requiring grad.

    With a ``mesh`` of several ranks (collective: every rank calls it)
    the step is rank 0's, every rank loads that step's file and keeps
    its blocks under ``layout`` (None: the whole state on every rank)."""
    step = resume_step(directory, mesh)
    if step is None:
        return None
    dev = _device_of(state_like, device)
    raw = _load(directory, step)
    _check_like("params", raw["params"], state_like.params)
    _check_like("opt_state", raw["opt_state"], state_like.opt_state)
    if _multi(mesh):
        params, opt_state = shard_state(raw["params"], raw["opt_state"],
                                        mesh, layout, dev)
        params = tree_map(lambda t: t.requires_grad_(True), params)
    else:
        move = lambda t: t.to(dev) if isinstance(t, torch.Tensor) else t
        params = tree_map(lambda t: move(t).requires_grad_(True),
                          raw["params"])
        opt_state = tree_map(move, raw["opt_state"])
    log.info("checkpoint: restored step %d from %s", step, directory)
    return TrainState(params, opt_state, int(raw["step"]))


class RestoredParams(tuple):
    """``(params, step)``, with ``.ema`` saying whether the EMA shadow
    is what came back."""

    ema: bool

    def __new__(cls, params: Any, step: int, ema: bool):
        self = super().__new__(cls, (params, step))
        self.ema = ema
        return self

    def __getnewargs__(self):
        return (self[0], self[1], self.ema)


def restore_params(
    directory: str, state_like: TrainState, prefer_ema: bool = False,
    device=None, *, mesh=None, rules: Any = None,
) -> Optional[RestoredParams]:
    """Only the params (and step) of the latest checkpoint, on ``device``:
    the optimizer moments stay on disk (the file is memory-mapped), so
    serving and evaluation pay params-sized memory. ``prefer_ema`` takes
    the EMA shadow when the checkpoint has one, else the raw params with
    a warning. Returns None when no checkpoint exists. With a ``mesh`` of
    several ranks (collective) the step is rank 0's and each rank keeps
    its blocks under ``rules``."""
    step = resume_step(directory, mesh)
    if step is None:
        return None
    dev = _device_of(state_like, device)
    raw = _load(directory, step)
    ema = raw["opt_state"].get("ema") if prefer_ema else None
    if prefer_ema and ema is None:
        log.warning(
            "checkpoint: prefer_ema requested but %s step %d has no EMA "
            "shadow; restoring raw params", directory, step,
        )
    chosen = ema if ema is not None else raw["params"]
    _check_like("params", chosen, state_like.params)
    if not _multi(mesh):
        params = tree_map(lambda t: t.to(dev), chosen)
        return RestoredParams(params, int(raw["step"]), ema is not None)
    from .sharding import local_slice

    if rules is None:
        raise ValueError("restore_params over ranks needs the rules")
    params = _map_rules(
        lambda t, r: local_slice(t, r, mesh).to(dev, copy=True), chosen,
        rules)
    return RestoredParams(params, int(raw["step"]), ema is not None)


def _map_rules(fn, tree, rules):
    if isinstance(tree, dict):
        return {k: _map_rules(fn, tree[k], rules[k]) for k in tree}
    return fn(tree, rules)

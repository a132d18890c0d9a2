"""Checkpoint save/restore for the supervised trainer, torch-native
(counterpart of ``containerpilot_tpu/parallel/checkpoint.py``; no orbax).

Layout: ``<dir>/step_<n>/state.pt``, one ``torch.save`` of
``{"params", "opt_state", "step"}`` with every tensor on the host.
A save writes into ``<dir>/.step_<n>.<pid>.tmp/`` and renames the
directory into place, so a crash mid-save never leaves a ``step_<n>``
that ``latest_step`` would pick; older steps are pruned after each save
(``KEEP_CHECKPOINTS``).

``save_checkpoint(..., wait=False)`` copies the tensors to the host
before it returns, so the train loop may go on updating its state in
place, and writes to disk on a background thread;
``wait_for_checkpoints`` joins it and raises its error, if any. Single
process only: the port has no multi-process trainer yet.
"""
from __future__ import annotations

import logging
import os
import re
import shutil
import threading
from typing import Any, Optional

import torch

from .train import TrainState, tree_map

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


def wait_for_checkpoints() -> None:
    """Block until the in-flight background save has committed; raise
    its error if it failed."""
    global _pending, _pending_error
    if _pending is not None:
        _pending.join()
        _pending = None
    if _pending_error is not None:
        err, _pending_error = _pending_error, None
        raise RuntimeError("background checkpoint save failed") from err


def save_checkpoint(
    directory: str, step: int, state: TrainState,
    keep: int = KEEP_CHECKPOINTS, wait: bool = True,
) -> None:
    """Write ``state`` as ``<directory>/step_<step>``. ``wait=False``
    returns once the device->host copy is done and commits on a
    background thread (a second save first drains the previous one)."""
    global _pending
    wait_for_checkpoints()
    payload = _host_copy(state)
    if wait:
        _write(directory, step, payload, keep)
        return

    def commit() -> None:
        global _pending_error
        try:
            _write(directory, step, payload, keep)
        except BaseException as exc:  # surfaced by wait_for_checkpoints
            _pending_error = exc

    _pending = threading.Thread(target=commit, daemon=False,
                                name="checkpoint-commit")
    _pending.start()


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


def restore_checkpoint(
    directory: str, state_like: TrainState, device=None,
) -> Optional[TrainState]:
    """The latest checkpoint as a TrainState on ``device`` (default: the
    device of ``state_like``'s params), checked leaf for leaf against
    ``state_like`` (e.g. ``abstract_train_state``, on the meta device);
    None when no checkpoint exists. Params come back requiring grad."""
    step = latest_step(directory)
    if step is None:
        return None
    dev = _device_of(state_like, device)
    raw = _load(directory, step)
    _check_like("params", raw["params"], state_like.params)
    _check_like("opt_state", raw["opt_state"], state_like.opt_state)
    move = lambda t: t.to(dev) if isinstance(t, torch.Tensor) else t
    params = tree_map(lambda t: move(t).requires_grad_(True), raw["params"])
    log.info("checkpoint: restored step %d from %s", step, directory)
    opt_state = tree_map(move, raw["opt_state"])
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
    device=None,
) -> Optional[RestoredParams]:
    """Only the params (and step) of the latest checkpoint, on ``device``:
    the optimizer moments stay on disk (the file is memory-mapped), so
    serving and evaluation pay params-sized memory. ``prefer_ema`` takes
    the EMA shadow when the checkpoint has one, else the raw params with
    a warning. Returns None when no checkpoint exists."""
    step = latest_step(directory)
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
    params = tree_map(lambda t: t.to(dev), chosen)
    return RestoredParams(params, int(raw["step"]), ema is not None)

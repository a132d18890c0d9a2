"""Token-shard data loading for the supervised trainer (counterpart of
``containerpilot_tpu/workload/data.py``; the port keeps its own copy).

- Shards are memory-mapped flat ``.npy`` token-id arrays
  (``<dir>/shard_*.npy``, written by ``write_token_shards``).
- The window served at step N is a pure function of (seed, N), so a
  trainer resumed from a checkpoint replays the exact stream; batches
  equal the reference's batch for batch.
- ``DevicePrefetcher`` stages upcoming batches on a side thread: pinned
  host memory and a ``non_blocking`` copy on a side CUDA stream, which
  the consumer's stream waits on (the reference's ``jax.device_put``).
"""
from __future__ import annotations

import glob
import os
import queue
import threading
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

_SHARD_GLOB = "shard_*.npy"


def write_token_shards(
    tokens: Sequence[int] | np.ndarray,
    directory: str,
    shard_size: int = 1 << 20,
    dtype=np.int32,
) -> List[str]:
    """Split a flat token stream into memmap-able .npy shards."""
    os.makedirs(directory, exist_ok=True)
    arr = np.asarray(tokens, dtype=dtype)
    paths = []
    for i, start in enumerate(range(0, len(arr), shard_size)):
        path = os.path.join(directory, f"shard_{i:05d}.npy")
        np.save(path, arr[start : start + shard_size])
        paths.append(path)
    return paths


class TokenShardDataset:
    """Deterministic [batch, seq_len + 1] windows over memmapped shards
    (the +1 is the next-token target column)."""

    def __init__(
        self,
        directory: str,
        seq_len: int,
        batch_size: int,
        seed: int = 0,
        vocab_size: int = 0,
        holdout_windows: int = 0,
    ) -> None:
        paths = sorted(glob.glob(os.path.join(directory, _SHARD_GLOB)))
        if not paths:
            raise FileNotFoundError(
                f"no {_SHARD_GLOB} shards under {directory!r}"
            )
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.seed = seed
        # >0: every served batch is range-checked (an out-of-range id
        # would index past the embedding)
        self.vocab_size = vocab_size
        self._shards = [np.load(p, mmap_mode="r") for p in paths]
        window = seq_len + 1
        counts = np.array(
            [len(s) // window for s in self._shards], dtype=np.int64
        )
        # prefix sum; window i lives in shard searchsorted(i)
        self._window_starts = np.concatenate([[0], np.cumsum(counts)])
        total = int(self._window_starts[-1])
        if total == 0:
            raise ValueError(
                f"shards under {directory!r} are shorter than "
                f"seq_len+1 = {window} tokens"
            )
        # the LAST holdout_windows windows are the held-out eval split
        if holdout_windows < 0 or holdout_windows >= total:
            raise ValueError(
                f"holdout_windows {holdout_windows} must be in "
                f"[0, {total})"
            )
        self.holdout_windows = holdout_windows
        self._total_windows = total
        self.n_windows = total - holdout_windows

    def _window(self, index: int) -> np.ndarray:
        index = index % self._total_windows
        si = int(
            np.searchsorted(self._window_starts, index, side="right") - 1
        )
        off = (index - int(self._window_starts[si])) * (self.seq_len + 1)
        return np.asarray(
            self._shards[si][off : off + self.seq_len + 1], dtype=np.int32
        )

    def batch_at(self, step: int) -> np.ndarray:
        """The [batch, seq_len+1] batch for a given global step: windows
        in a per-epoch affine permutation (a coprime stride) of the
        window index space."""
        rows = []
        stride = self._epoch_stride()
        for j in range(self.batch_size):
            flat = step * self.batch_size + j
            epoch, pos = divmod(flat, self.n_windows)
            index = (stride * pos + epoch * 7919 + self.seed) % self.n_windows
            rows.append(self._window(index))
        return self._check_vocab(np.stack(rows))

    def _check_vocab(self, batch: np.ndarray) -> np.ndarray:
        if self.vocab_size:
            top = int(batch.max())
            if top >= self.vocab_size or int(batch.min()) < 0:
                raise ValueError(
                    f"shard token id {top} out of range for vocab_size "
                    f"{self.vocab_size} — wrong shards or wrong --vocab"
                )
        return batch

    def _epoch_stride(self) -> int:
        n = self.n_windows
        for cand in (7919, 104729, 1299709, 15485863):
            if n > 1 and np.gcd(cand % n or 1, n) == 1:
                return cand % n or 1
        return 1

    def batches(self, start_step: int = 0) -> Iterator[np.ndarray]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1

    @property
    def n_eval_batches(self) -> int:
        return (
            self.holdout_windows + self.batch_size - 1
        ) // self.batch_size

    def eval_batch(self, index: int) -> np.ndarray:
        """Held-out batch ``index`` in fixed order (the tail pads by
        wrapping within the holdout split)."""
        if not self.holdout_windows:
            raise ValueError("dataset has no holdout split")
        rows = []
        for j in range(self.batch_size):
            pos = (index * self.batch_size + j) % self.holdout_windows
            rows.append(self._window(self.n_windows + pos))
        return self._check_vocab(np.stack(rows))


class DevicePrefetcher:
    """Stage upcoming batches onto ``device`` from a background thread
    (double buffering: host IO and the host-to-device copy overlap the
    train step). Batches come out as int64 tensors. ``device`` defaults
    to the card and raises without one; pass ``device="cpu"`` to stage
    onto the CPU."""

    def __init__(
        self,
        dataset: TokenShardDataset,
        start_step: int = 0,
        depth: int = 2,
        device="cuda",
    ) -> None:
        from .. import resolve_device

        self._device = resolve_device(device)
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        cuda = self._device.type == "cuda"
        side = torch.cuda.Stream(self._device) if cuda else None

        def stage(batch: np.ndarray):
            host = torch.from_numpy(batch).long()
            if not cuda:
                return host.to(self._device), None
            host = host.pin_memory()
            with torch.cuda.stream(side):
                staged = host.to(self._device, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record(side)
            return staged, ready

        def worker() -> None:
            step = start_step
            try:
                while not self._stop.is_set():
                    staged = stage(dataset.batch_at(step))
                    while not self._stop.is_set():
                        try:
                            self._queue.put((step, *staged), timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    step += 1
            except BaseException as exc:  # surface it — never die silent
                self._error = exc
                while not self._stop.is_set():
                    try:
                        self._queue.put(None, timeout=0.1)  # wake next()
                        break
                    except queue.Full:
                        continue

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def next(self):
        """(step, device batch) in order. Re-raises any exception that
        killed the background worker: a dead loader must fail the
        training step, not hang it."""
        item = self._queue.get()
        if item is None:
            raise RuntimeError("data prefetch worker died") from self._error
        step, batch, ready = item
        if ready is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(ready)
            batch.record_stream(stream)
        return step, batch

    def stop(self) -> None:
        self._stop.set()
        # drain so the worker's blocked put wakes and sees the flag
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)

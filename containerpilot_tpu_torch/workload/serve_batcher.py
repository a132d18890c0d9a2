"""Continuous batching for the inference server (counterpart of
``containerpilot_tpu/workload/serve_batcher.py``).

Requests queue here; the batcher coalesces whatever accumulated while
the device was busy into ONE generate call with per-row sampling knobs.
Row i of a request seeded s samples from ``fold_in(PRNGKey(s), i)``, the
reference's key, so a request's output never depends on what it was
batched with and equals the reference server's. The device call is ``generate_rows`` on the group's host data, so
a server over ranks can run it through its lockstep
(parallel/serving.py) on every rank (``Batcher.run_rows``).
"""
from __future__ import annotations

import asyncio
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

from ..models.decode import generate, row_key
from ..ops import prng


@dataclass
class GenJob:
    """One /v1/generate request waiting in the batcher queue."""

    rows: List[List[int]]
    prompt_len: int
    max_new: int
    temperature: float
    top_k: int
    top_p: float
    eos_id: int
    seed: int
    min_new: int = 0
    presence: float = 0.0
    frequency: float = 0.0
    logit_bias: Optional[dict] = None
    future: "asyncio.Future[List[List[int]]]" = field(repr=False, default=None)


_KNOBS = ("temperature", "top_k", "top_p", "eos_id", "min_new",
          "presence", "frequency", "logit_bias")


def generate_rows(srv: Any, jobs: List[Dict[str, Any]]) -> List[List[int]]:
    """One generate call for a group of jobs given as host data (each
    ``{"rows", "seed", "max_new"}`` plus the sampling knobs), on
    ``srv``'s params, config, max_len and mesh (runs on the inference
    thread, or on each rank under a lockstep)."""
    device = srv.params["norm_out"].device
    rows: List[List[int]] = []
    knobs: Dict[str, list] = {k: [] for k in _KNOBS}
    keys = []
    for job in jobs:
        for i, r in enumerate(job["rows"]):
            rows.append(r)
            for key in _KNOBS:
                knobs[key].append(job[key])
            keys.append(row_key(job["seed"], i, device))
    # pad the batch to a power of two, as the reference does (its reason
    # is compile churn; kept so batch shapes stay comparable)
    target = 1
    while target < len(rows):
        target *= 2
    pad_rows = target - len(rows)
    for _ in range(pad_rows):
        rows.append([0] * len(rows[0]))
        for key, value in zip(_KNOBS, (0.0, 0, 0.0, -1, 0, 0.0, 0.0, None)):
            knobs[key].append(value)
        keys.append(prng.prng_key(0, device))
    out = generate(
        srv.params,
        torch.tensor(rows, dtype=torch.int64, device=device),
        srv.cfg,
        max_new_tokens=jobs[0]["max_new"],
        max_len=srv.max_len,
        temperature=knobs["temperature"],
        rng=torch.stack(keys),
        top_k=knobs["top_k"],
        top_p=knobs["top_p"],
        eos_id=knobs["eos_id"],
        min_new_tokens=knobs["min_new"],
        presence_penalty=knobs["presence"],
        frequency_penalty=knobs["frequency"],
        logit_bias=(
            knobs["logit_bias"] if any(b for b in knobs["logit_bias"])
            else None
        ),
        mesh=getattr(srv, "mesh", None),
    )
    out = out[: len(rows) - pad_rows].tolist()
    lockstep = getattr(srv, "lockstep", None)
    if lockstep is not None:
        lockstep.record_tokens(out)
    return out


class Batcher:
    """Owns the request queue and the drain loop; one generate call per
    compatible group (same prompt length and decode length).
    ``run_rows`` makes the group's device call (``generate_rows`` on
    this batcher's params by default)."""

    def __init__(self, params: Any, cfg: Any, max_len: int,
                 max_batch_rows: int, executor: Any) -> None:
        self.params = params
        self.cfg = cfg
        self.max_len = max_len
        self.max_batch_rows = max_batch_rows
        self._executor = executor
        self.queue: "asyncio.Queue[GenJob]" = asyncio.Queue()
        self._task: Optional["asyncio.Task[None]"] = None
        self.stats = {"calls": 0, "rows": 0}
        self.run_rows = lambda jobs: generate_rows(self, jobs)

    def idle(self) -> bool:
        return self.queue.empty()

    async def submit(self, job: GenJob) -> List[List[int]]:
        await self.queue.put(job)
        return await job.future

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(
            self._loop(), name="serve-batcher"
        )

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        while not self.queue.empty():
            job = self.queue.get_nowait()
            if not job.future.done():
                job.future.set_exception(RuntimeError("server stopping"))

    async def _loop(self) -> None:
        carry: Optional[GenJob] = None
        try:
            while True:
                first = carry if carry is not None else await self.queue.get()
                carry = None
                jobs = [first]
                rows = len(first.rows)
                while rows < self.max_batch_rows and not self.queue.empty():
                    nxt = self.queue.get_nowait()
                    if rows + len(nxt.rows) > self.max_batch_rows:
                        carry = nxt
                        break
                    jobs.append(nxt)
                    rows += len(nxt.rows)
                groups: Dict[Any, List[GenJob]] = {}
                for job in jobs:
                    groups.setdefault(
                        (job.prompt_len, job.max_new), []
                    ).append(job)
                for group in groups.values():
                    await self._run_group(group)
        finally:
            if carry is not None and not carry.future.done():
                carry.future.set_exception(RuntimeError("server stopping"))

    def _generate_rows(self, jobs: List[GenJob]) -> List[List[int]]:
        """One generate call for a group (runs on the executor thread)."""
        return self.run_rows([
            {"rows": job.rows, "seed": job.seed, "max_new": job.max_new,
             **{key: getattr(job, key) for key in _KNOBS}}
            for job in jobs])

    async def _run_group(self, jobs: List[GenJob]) -> None:
        loop = asyncio.get_running_loop()
        self.stats["calls"] += 1
        self.stats["rows"] += sum(len(j.rows) for j in jobs)
        try:
            outs = await loop.run_in_executor(
                self._executor, self._generate_rows, jobs
            )
        except asyncio.CancelledError:
            for job in jobs:
                if not job.future.done():
                    job.future.set_exception(RuntimeError("server stopping"))
            raise
        except Exception as exc:  # surfaces as a per-request 500
            for job in jobs:
                if not job.future.done():
                    job.future.set_exception(exc)
            return
        i = 0
        for job in jobs:
            if not job.future.done():
                job.future.set_result(outs[i:i + len(job.rows)])
            i += len(job.rows)

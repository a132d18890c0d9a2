"""Owned-task discipline for fire-and-forget asyncio tasks (the port's
own copy of ``containerpilot_tpu/utils/tasks.py``).

The event loop holds only a weak reference to a running task: a task
whose handle is dropped can be collected mid-flight, and its exception
evaporates with it. ``spawn`` gives every background task a live
reference (``owner``'s set, or the module-level ``_BACKGROUND`` set) and
a done-callback that logs any exception other than a cancellation.
"""
from __future__ import annotations

import asyncio
import logging
from typing import Coroutine, Optional, Set

log = logging.getLogger("containerpilot.tasks")

#: the reference of last resort for spawns with no owner object
_BACKGROUND: Set["asyncio.Task"] = set()


def _log_done(task: "asyncio.Task") -> None:
    """Done-callback: surface non-CancelledError deaths immediately."""
    if task.cancelled():
        return
    exc = task.exception()
    if exc is not None:
        log.error(
            "background task %r died: %r", task.get_name(), exc,
            exc_info=exc,
        )


def spawn(
    coro: Coroutine,
    *,
    name: Optional[str] = None,
    owner: Optional[Set["asyncio.Task"]] = None,
) -> "asyncio.Task":
    """``create_task`` plus a live reference (``owner``, else the
    module-level set; the task leaves it on completion) and an
    exception-logging done-callback."""
    task = asyncio.get_event_loop().create_task(coro, name=name)
    holder = _BACKGROUND if owner is None else owner
    holder.add(task)
    task.add_done_callback(holder.discard)
    task.add_done_callback(_log_done)
    return task


def pending_count() -> int:
    """How many ownerless background tasks are still in flight."""
    return len(_BACKGROUND)

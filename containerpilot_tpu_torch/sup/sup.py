"""PID-1 mode: fork the real supervisor, forward signals, reap orphans.

Capability parity with the reference's sup package (reference:
sup/sup.go): when the supervisor finds itself as PID 1 inside a
container it must behave as init — fork the actual worker process
(re-exec of ourselves), pass SIGINT/SIGTERM/SIGHUP/SIGUSR1/SIGUSR2
through to the worker, and reap any orphans reparented onto PID 1 via a
``waitpid(-1)`` loop on SIGCHLD, *without* stealing the worker's own
waits (reference: sup/sup.go:61-92).

Two implementations, same behavior:

- the C++ binary ``native/cpsup`` (preferred as the container
  entrypoint — a single static-ish native init that execs any command,
  ``cpsup python -m containerpilot_tpu_torch ...``; see
  native/sup.cpp), and
- this Python fallback, used when ``python -m containerpilot_tpu_torch``
  is itself PID 1.

The port's own copy of ``containerpilot_tpu/sup/sup.py``.
"""
from __future__ import annotations

import errno
import os
import signal
import sys
from typing import List, Optional

PASS_THROUGH_SIGNALS = (
    signal.SIGINT,
    signal.SIGTERM,
    signal.SIGHUP,
    signal.SIGUSR1,
    signal.SIGUSR2,
)


PR_SET_CHILD_SUBREAPER = 36  # linux/prctl.h


def claim_subreaper() -> bool:
    """Mark this process a child subreaper (ctypes twin of
    native/sup.cpp's prctl call): orphans of our descendants reparent
    to US, not to PID 1, so the waitpid(-1) loop actually collects
    them even when we are not literal PID 1 (systemd on a host VM, a
    test harness, a PID namespace with a shim at 1). Best-effort:
    returns False on kernels/platforms without the prctl."""
    try:
        import ctypes

        libc = ctypes.CDLL(None, use_errno=True)
        return libc.prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) == 0
    except (OSError, AttributeError):
        return False


def run(argv: Optional[List[str]] = None) -> int:
    """Fork the worker and babysit it as PID 1; returns the worker's
    exit code (reference: sup/sup.go:15-30)."""
    argv = argv if argv is not None else sys.argv
    claim_subreaper()
    worker_pid = os.fork()
    if worker_pid == 0:
        # child: become the real supervisor process
        os.execv(sys.executable, [sys.executable, "-m", "containerpilot_tpu_torch"]
                 + argv[1:])
        return 127  # pragma: no cover - execv doesn't return

    exit_code = 0

    def forward(signum: int, _frame: object) -> None:
        try:
            os.kill(worker_pid, signum)
        except ProcessLookupError:
            pass

    for sig in PASS_THROUGH_SIGNALS:
        signal.signal(sig, forward)

    # reap until our worker exits (reference: sup/sup.go:61-92); the
    # blocking wait on -1 reaps any orphan that gets reparented to us
    while True:
        try:
            pid, status = os.waitpid(-1, 0)
        except InterruptedError:
            continue
        except ChildProcessError:
            break
        if pid == worker_pid:
            if os.WIFEXITED(status):
                exit_code = os.WEXITSTATUS(status)
            elif os.WIFSIGNALED(status):
                exit_code = 128 + os.WTERMSIG(status)
            break
    # final non-blocking sweep for any remaining zombies
    while True:
        try:
            pid, _status = os.waitpid(-1, os.WNOHANG)
        except (ChildProcessError, OSError):
            break
        if pid == 0:
            break
    return exit_code

"""PID-1 supervisor: fork the worker, pass signals, reap zombies
(reference: sup/ package).

The port's own copy of ``containerpilot_tpu/sup/__init__.py``.
"""
from .sup import run as run_sup

__all__ = ["run_sup"]

"""Process execution layer (reference: commands/ package).

The port's own copy of ``containerpilot_tpu/commands/__init__.py``.
"""
from .args import ArgsError, parse_args
from .commands import Command, env_name

__all__ = ["Command", "env_name", "parse_args", "ArgsError"]

"""Top-level config loading: file -> template -> JSON5 -> validated App
config (JSON5 read by the port's own ``json5_reader``).

Capability parity with the reference's loader
(reference: config/config.go): the path comes from the ``-config`` flag
or the ``CONTAINERPILOT`` environment variable
(reference: core/flags.go:101-103); the raw text is template-rendered
over the environment, JSON5-parsed with line/column error highlighting
(reference: config.go:198-232), unknown top-level keys are rejected
(reference: config.go:261-267), sections are decoded through each
domain package's validator, the telemetry section synthesizes its
self-advertising job (reference: config.go:172-179), and stopTimeout
defaults to 5 seconds (reference: config.go:45-48).

The port's own copy of ``containerpilot_tpu/config/loader.py``.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

from ..control.config import ControlConfig
from ..discovery import Backend, new_backend
from ..jobs import JobConfig, new_job_configs
from ..watches import WatchConfig, new_watch_configs
from .json5_reader import loads as json5_loads
from .logger import LogConfig
from .template import apply_template
from .timing import DurationError, get_timeout

DEFAULT_STOP_TIMEOUT = 5.0  # seconds (reference: config/config.go:45-48)

_TOP_LEVEL_KEYS = {
    "consul",
    "logging",
    "jobs",
    "watches",
    "telemetry",
    "control",
    "stopTimeout",
}


class ConfigError(ValueError):
    pass


class AppConfig:
    """The fully-validated configuration for one App generation
    (reference: config/config.go:35-43)."""

    def __init__(self) -> None:
        self.discovery: Optional[Backend] = None
        self.jobs: List[JobConfig] = []
        self.watches: List[WatchConfig] = []
        self.telemetry = None  # telemetry.TelemetryConfig | None
        self.control: ControlConfig = ControlConfig()
        self.logging: LogConfig = LogConfig()
        self.stop_timeout: float = DEFAULT_STOP_TIMEOUT
        self.config_path: str = ""

    def init_logging(self) -> None:
        self.logging.init()


def _highlight_parse_error(text: str, exc: Exception) -> str:
    """Friendly JSON5 parse errors with the offending line marked
    (reference: config/config.go:198-232)."""
    msg = str(exc)
    import re

    # pyjson5 reports "<string>:3 ..."; other parsers say "line 3"
    m = re.search(r"line (\d+)", msg) or re.search(r"<string>:(\d+)", msg)
    if not m:
        return msg
    lineno = int(m.group(1))
    lines = text.splitlines()
    lo = max(0, lineno - 3)
    hi = min(len(lines), lineno + 2)
    context = []
    for i in range(lo, hi):
        marker = ">>> " if i + 1 == lineno else "    "
        context.append(f"{marker}{i + 1}: {lines[i]}")
    return msg + "\n" + "\n".join(context)


def render_config_template(
    template_path: str, env: Optional[Dict[str, str]] = None
) -> str:
    """Render a config file's template only (the -template/-out
    subcommand; reference: config/config.go:67-86)."""
    with open(template_path, encoding="utf-8") as f:
        text = f.read()
    return apply_template(text, env)


def parse_config(text: str) -> Dict[str, Any]:
    rendered = apply_template(text)
    try:
        raw = json5_loads(rendered)
    except Exception as exc:
        raise ConfigError(
            f"parse error in configuration: {_highlight_parse_error(rendered, exc)}"
        ) from None
    if not isinstance(raw, dict):
        raise ConfigError("configuration must be a JSON5 object")
    unknown = set(raw) - _TOP_LEVEL_KEYS
    if unknown:
        raise ConfigError(f"unknown configuration keys: {sorted(unknown)}")
    return raw


def new_config(raw: Dict[str, Any]) -> AppConfig:
    """Assemble + validate an AppConfig from parsed JSON5
    (reference: config/config.go:128-182)."""
    cfg = AppConfig()
    cfg.logging = LogConfig(raw.get("logging"))
    try:
        stop_timeout = get_timeout(raw.get("stopTimeout"))
    except DurationError as exc:
        raise ConfigError(f"unable to parse stopTimeout: {exc}") from None
    cfg.stop_timeout = stop_timeout or DEFAULT_STOP_TIMEOUT
    cfg.discovery = new_backend(raw.get("consul"))
    cfg.control = ControlConfig(raw.get("control"))

    job_raws: List[Dict[str, Any]] = list(raw.get("jobs") or [])

    telemetry_raw = raw.get("telemetry")
    if telemetry_raw is not None:
        from ..telemetry.config import TelemetryConfig

        cfg.telemetry = TelemetryConfig(telemetry_raw)
        # the telemetry server advertises itself via a synthetic job
        # (reference: config/config.go:172-179)
        job_raws.append(cfg.telemetry.to_job_config_raw())

    cfg.jobs = new_job_configs(job_raws, cfg.discovery)
    cfg.watches = new_watch_configs(raw.get("watches"), cfg.discovery)
    return cfg


def load_config(path: Optional[str] = None) -> AppConfig:
    """Load, render, parse, and validate the config file
    (reference: config/config.go:91-125)."""
    if not path:
        path = os.environ.get("CONTAINERPILOT", "")
    if not path:
        raise ConfigError(
            "-config flag is required (or set the CONTAINERPILOT "
            "environment variable)"
        )
    try:
        with open(path, encoding="utf-8") as f:
            text = f.read()
    except OSError as exc:
        raise ConfigError(f"could not read config file: {exc}") from None
    cfg = new_config(parse_config(text))
    cfg.config_path = path
    return cfg

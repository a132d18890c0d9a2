"""Logging configuration: level, format, output, and SIGUSR1 reopen.

Capability parity with the reference's logging setup
(reference: config/logger/logging.go): level names, three formats
(default/text/json), three outputs (stdout/stderr/file), and log-file
reopen on SIGUSR1 for logrotate integration
(reference: logging.go:116-129).

The port's own copy of ``containerpilot_tpu/config/logger.py``.
"""
from __future__ import annotations

import json
import logging
import sys
import threading
from typing import Any, Dict, Optional

_LEVELS = {
    "DEBUG": logging.DEBUG,
    "INFO": logging.INFO,
    "WARN": logging.WARNING,
    "WARNING": logging.WARNING,
    "ERROR": logging.ERROR,
    "FATAL": logging.CRITICAL,
    "PANIC": logging.CRITICAL,
}


class LogConfigError(ValueError):
    pass


def _trace_fields() -> Dict[str, Any]:
    """trace_id/stream_id from the tracing contextvars, when a
    request is active on the logging task's context — the glue that
    lets replica logs and gateway logs grep together by trace id.
    Lazy import (cached on first success) keeps config.logger free of
    a package-level dependency on telemetry."""
    global _tracing
    if _tracing is None:
        try:
            from ..telemetry import tracing as _tracing_mod
        except ImportError:  # partial install; logging must not die
            return {}
        _tracing = _tracing_mod
    fields: Dict[str, Any] = {}
    trace_id = _tracing.current_trace_id()
    if trace_id:
        fields["trace_id"] = trace_id
    stream_id = _tracing.current_stream_id()
    if stream_id:
        fields["stream_id"] = stream_id
    return fields


_tracing = None


class _DefaultFormatter(logging.Formatter):
    """The reference's custom default formatter prints time, level, and
    any job/pid/check fields before the message
    (reference: logging.go:92-114)."""

    def format(self, record: logging.LogRecord) -> str:
        ts = self.formatTime(record, "%Y-%m-%dT%H:%M:%S")
        fields = ""
        for key in ("job", "check", "watch", "pid"):
            val = record.__dict__.get(key)
            if val is not None:
                fields += f" {key}={val}"
        return f"{ts} [{record.levelname}]{fields} {record.getMessage()}"


class _JSONFormatter(logging.Formatter):
    """The opt-in structured formatter (``"format": "json"``). Every
    record emitted while a traced request is active additionally
    carries ``trace_id`` (and ``stream_id`` for cp-mux streams) from
    the tracing contextvars, so one ``grep <trace_id>`` correlates a
    request's replica and gateway log lines with its /v1/traces
    timeline."""

    def format(self, record: logging.LogRecord) -> str:
        entry: Dict[str, Any] = {
            "time": self.formatTime(record, "%Y-%m-%dT%H:%M:%S%z"),
            "level": record.levelname.lower(),
            "msg": record.getMessage(),
        }
        for key in ("job", "check", "watch", "pid"):
            val = record.__dict__.get(key)
            if val is not None:
                entry[key] = val
        entry.update(_trace_fields())
        return json.dumps(entry)


class _ReopenableFileHandler(logging.FileHandler):
    """A file handler whose stream can be reopened on SIGUSR1
    (reference: client9/reopen usage, logging.go:116-129)."""

    def __init__(self, path: str) -> None:
        super().__init__(path, mode="a", encoding="utf-8", delay=False)
        self._reopen_lock = threading.Lock()

    def reopen(self) -> None:
        with self._reopen_lock:
            self.acquire()
            try:
                self.close()
                self.stream = self._open()
            finally:
                self.release()


_active_file_handler: Optional[_ReopenableFileHandler] = None


def reopen_log_file() -> None:
    """SIGUSR1 handler hook: reopen the log file for logrotate."""
    if _active_file_handler is not None:
        _active_file_handler.reopen()


class LogConfig:
    """Parsed logging section (reference: config/logger/logging.go:17-37)."""

    def __init__(self, raw: Optional[Dict[str, Any]] = None) -> None:
        raw = raw or {}
        unknown = set(raw) - {"level", "format", "output"}
        if unknown:
            raise LogConfigError(f"logging: unknown keys {sorted(unknown)}")
        self.level = (raw.get("level") or "INFO").upper()
        self.format = raw.get("format") or "default"
        self.output = raw.get("output") or "stdout"
        if self.level not in _LEVELS:
            raise LogConfigError(f"unknown log level {self.level!r}")
        if self.format not in ("default", "text", "json"):
            raise LogConfigError(f"unknown log format {self.format!r}")

    def init(self) -> None:
        """Install onto the root 'containerpilot' logger
        (reference: logging.go:39-90)."""
        global _active_file_handler
        logger = logging.getLogger("containerpilot")
        logger.setLevel(_LEVELS[self.level])
        for handler in list(logger.handlers):
            logger.removeHandler(handler)
        if self.output == "stdout":
            handler: logging.Handler = logging.StreamHandler(sys.stdout)
        elif self.output == "stderr":
            handler = logging.StreamHandler(sys.stderr)
        elif self.output:
            _active_file_handler = _ReopenableFileHandler(self.output)
            handler = _active_file_handler
        else:
            raise LogConfigError("logging.output must not be empty")
        if self.format == "json":
            handler.setFormatter(_JSONFormatter())
        elif self.format == "text":
            handler.setFormatter(
                logging.Formatter("time=%(asctime)s level=%(levelname)s msg=%(message)s")
            )
        else:
            handler.setFormatter(_DefaultFormatter())
        logger.addHandler(handler)
        logger.propagate = False

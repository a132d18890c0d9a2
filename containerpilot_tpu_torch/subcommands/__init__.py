"""One-shot CLI verbs (reference: subcommands/ package).

Each handler loads the config only to find the control socket, then
calls the client (reference: subcommands/subcommands.go:118-128).

The port's own copy of ``containerpilot_tpu/subcommands/__init__.py``.
"""
from __future__ import annotations

import sys
from typing import Dict, List, Optional

from ..client import ControlClient, ControlClientError
from ..config.loader import ConfigError, load_config, render_config_template
from ..version import GIT_HASH, VERSION


class SubcommandError(RuntimeError):
    pass


def _client_for(config_path: Optional[str]) -> ControlClient:
    cfg = load_config(config_path)
    return ControlClient(cfg.control.socket)


def _parse_kv(pairs: List[str], flag: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for pair in pairs:
        key, sep, value = pair.partition("=")
        if not sep or not key:
            raise SubcommandError(f"-{flag} requires 'key=value' format: {pair!r}")
        out[key] = value
    return out


def version_handler(_params: dict) -> int:
    print(f"Version: {VERSION}\nGitHash: {GIT_HASH}")
    return 0


def render_handler(params: dict) -> int:
    """-template [-out path] (reference: subcommands.go:37-56)."""
    try:
        rendered = render_config_template(params["config_path"])
    except (OSError, ConfigError, ValueError) as exc:
        print(f"error rendering template: {exc}", file=sys.stderr)
        return 1
    out = params.get("render_flag") or "-"
    if out == "-":
        sys.stdout.write(rendered)
    else:
        with open(out, "w", encoding="utf-8") as f:
            f.write(rendered)
    return 0


def reload_handler(params: dict) -> int:
    try:
        _client_for(params.get("config_path")).reload()
        return 0
    except (ConfigError, ControlClientError) as exc:
        print(f"reload failed: {exc}", file=sys.stderr)
        return 1


def maintenance_handler(params: dict) -> int:
    flag = params.get("maintenance_flag", "")
    if flag not in ("enable", "disable"):
        print(
            "-maintenance accepts 'enable' or 'disable'", file=sys.stderr
        )
        return 1
    try:
        _client_for(params.get("config_path")).set_maintenance(flag == "enable")
        return 0
    except (ConfigError, ControlClientError) as exc:
        print(f"maintenance failed: {exc}", file=sys.stderr)
        return 1


def put_env_handler(params: dict) -> int:
    try:
        env = _parse_kv(params.get("env", []), "putenv")
        _client_for(params.get("config_path")).put_env(env)
        return 0
    except (ConfigError, ControlClientError, SubcommandError) as exc:
        print(f"putenv failed: {exc}", file=sys.stderr)
        return 1


def put_metrics_handler(params: dict) -> int:
    try:
        metrics = _parse_kv(params.get("metrics", []), "putmetric")
        _client_for(params.get("config_path")).put_metric(metrics)
        return 0
    except (ConfigError, ControlClientError, SubcommandError) as exc:
        print(f"putmetric failed: {exc}", file=sys.stderr)
        return 1


def catalog_server_handler(params: dict) -> int:
    """Run the Consul-compatible catalog daemon until SIGTERM/SIGINT."""
    import asyncio
    import signal as signal_mod

    from ..discovery.catalog_server import CatalogServer

    addr = params.get("catalog_addr", "0.0.0.0:8500")
    host, _, port_str = addr.rpartition(":")
    host = host or "0.0.0.0"
    try:
        port = int(port_str)
    except ValueError:
        print(f"-catalog-server expects HOST:PORT, got {addr!r}",
              file=sys.stderr)
        return 1

    async def serve() -> None:
        server = CatalogServer(
            host, port, snapshot_path=params.get("catalog_snapshot", "")
        )
        await server.run()
        stop = asyncio.Event()
        loop = asyncio.get_event_loop()
        for sig in (signal_mod.SIGTERM, signal_mod.SIGINT):
            loop.add_signal_handler(sig, stop.set)
        await stop.wait()
        await server.stop()

    asyncio.run(serve())
    return 0


def ping_handler(params: dict) -> int:
    try:
        _client_for(params.get("config_path")).get_ping()
        print("ok")
        return 0
    except (ConfigError, ControlClientError) as exc:
        print(f"ping failed: {exc}", file=sys.stderr)
        return 1

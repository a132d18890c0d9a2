"""CLI argument parsing and subcommand dispatch
(reference: core/flags.go, main.go).

Flags mirror the reference: -config, -version, -template/-out, -reload,
-maintenance enable|disable, -putenv k=v (repeatable), -putmetric k=v
(repeatable), -ping. With no subcommand flag, the supervisor itself
runs.

The port's own copy of ``containerpilot_tpu/core/flags.py``.
"""
from __future__ import annotations

import argparse
import os
from typing import Callable, Optional, Tuple

from .. import subcommands


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="containerpilot-tpu",
        description=(
            "An application-lifecycle supervisor for accelerator hosts: runs, "
            "health-checks, and service-registers per-host processes."
        ),
    )
    parser.add_argument(
        "-config",
        dest="config",
        default="",
        help="File path to JSON5 configuration file. "
        "Defaults to the CONTAINERPILOT env var.",
    )
    parser.add_argument(
        "-version", dest="version", action="store_true",
        help="Show version identifier and quit.",
    )
    parser.add_argument(
        "-template", dest="template", action="store_true",
        help="Render template and quit.",
    )
    parser.add_argument(
        "-out", dest="out", default="-",
        help="File path to save the rendered config when '-template' is "
        "used. Defaults to stdout ('-').",
    )
    parser.add_argument(
        "-reload", dest="reload", action="store_true",
        help="Reload a running supervisor through its control socket.",
    )
    parser.add_argument(
        "-maintenance", dest="maintenance", default="",
        choices=["", "enable", "disable"],
        help="Toggle maintenance mode through the control socket.",
    )
    parser.add_argument(
        "-putenv", dest="putenv", action="append", default=[],
        metavar="KEY=VALUE",
        help="Update the environ of a running supervisor (repeatable).",
    )
    parser.add_argument(
        "-putmetric", dest="putmetric", action="append", default=[],
        metavar="KEY=VALUE",
        help="Update metrics of a running supervisor (repeatable).",
    )
    parser.add_argument(
        "-ping", dest="ping", action="store_true",
        help="Check that the control socket is up.",
    )
    parser.add_argument(
        "-catalog-server", dest="catalog_server", default="",
        metavar="HOST:PORT",
        help="Run the Consul-API-compatible catalog server for pods "
        "without an external catalog (e.g. '0.0.0.0:8500').",
    )
    parser.add_argument(
        "-catalog-snapshot", dest="catalog_snapshot", default="",
        metavar="PATH",
        help="With -catalog-server: journal catalog state to this file "
        "and restore it on start, so a restarted daemon serves its "
        "last known registrations immediately.",
    )
    return parser


def get_args(
    argv: Optional[list] = None,
) -> Tuple[Optional[Callable[[dict], int]], dict]:
    """Returns (subcommand_handler, params); handler None means "run the
    supervisor" (reference: core/flags.go:46-130)."""
    args = build_parser().parse_args(argv)
    config_path = args.config or os.environ.get("CONTAINERPILOT", "")
    params = {
        "config_path": config_path,
        "render_flag": args.out,
        "maintenance_flag": args.maintenance,
        "env": args.putenv,
        "metrics": args.putmetric,
    }
    if args.version:
        return subcommands.version_handler, params
    if args.template:
        return subcommands.render_handler, params
    if args.reload:
        return subcommands.reload_handler, params
    if args.maintenance:
        return subcommands.maintenance_handler, params
    if args.putenv:
        return subcommands.put_env_handler, params
    if args.putmetric:
        return subcommands.put_metrics_handler, params
    if args.ping:
        return subcommands.ping_handler, params
    if args.catalog_server:
        params["catalog_addr"] = args.catalog_server
        params["catalog_snapshot"] = args.catalog_snapshot
        return subcommands.catalog_server_handler, params
    return None, params

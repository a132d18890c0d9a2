"""CLI entrypoint (reference: main.go).

- As PID 1 (container entrypoint) we first become the init/reaper and
  fork the real supervisor (reference: main.go:23-27).
- With a subcommand flag we run the one-shot verb.
- Otherwise we run the supervisor's generation loop until shutdown.

The port's own copy of ``containerpilot_tpu/__main__.py``.
"""
from __future__ import annotations

import asyncio
import logging
import os
import sys


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s [%(levelname)s] %(message)s",
    )
    if os.getpid() == 1 and os.environ.get("CONTAINERPILOT_SUP", "1") != "0":
        from .sup import run_sup

        # mark the forked worker so it doesn't recurse into sup mode
        os.environ["CONTAINERPILOT_SUP"] = "0"
        return run_sup(sys.argv if argv is None else ["containerpilot"] + list(argv))

    from .core import App, get_args

    handler, params = get_args(argv)
    if handler is not None:
        return handler(params)

    config_path = params["config_path"]
    try:
        app = App.from_config_path(config_path)
    except Exception as exc:
        print(f"{exc}", file=sys.stderr)
        return 1
    try:
        asyncio.run(app.run())
    except KeyboardInterrupt:  # pragma: no cover
        return 130
    except OSError as exc:
        # e.g. telemetry/control bind exhausting its retries — a clean
        # one-line fatal beats an asyncio traceback; the full trace
        # still lands in the log for diagnosis
        logging.getLogger("containerpilot").exception("fatal error")
        print(f"fatal: {exc}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

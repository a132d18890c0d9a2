"""Run a reference test's body against both packages.

``load(name, "torch")`` executes ``tests/<name>.py`` as a fresh module
with every ``containerpilot_tpu`` import pointed at
``containerpilot_tpu_torch``; ``load(name, "jax")`` executes the same
source unchanged. The two modules share the reference file's stubs,
fake launchers, seeds and assertions, so a case that passes under both
gave the same observable results on both packages.

Two reads of a ``prometheus_client`` private (``metric._value.get()``)
go through ``read_value``, which reads either package's metric. The
reference's mux client drops its upgraded socket's ``StreamWriter``,
which CPython 3.12 closes on collection: its cases run under
``keep_mux_writer``, which holds the writer (the port's client keeps
it itself).
"""
import ast
import os
import re
import types

import pytest

from containerpilot_tpu.fleet import pool as ref_pool

TESTS = os.path.dirname(os.path.abspath(__file__))
PACKAGES = ("jax", "torch")


@pytest.fixture
def keep_mux_writer(monkeypatch):
    adopt = ref_pool.MuxConnection.adopt

    def adopt_and_keep(self, reader, writer):
        self._kept_writer = writer
        return adopt(self, reader, writer)

    monkeypatch.setattr(ref_pool.MuxConnection, "adopt", adopt_and_keep)


def read_value(metric) -> float:
    """The value of an unlabelled metric or of one labelled child."""
    if hasattr(getattr(metric, "_value", None), "get"):  # prometheus_client
        return metric._value.get()  # noqa: SLF001
    if hasattr(metric, "labels"):  # utils/prom: a family
        return metric._unlabelled().get()  # noqa: SLF001
    return metric.get()  # utils/prom: a child


def _rewrite(src: str, drop_imports) -> str:
    """Blank the top-level ``from <module> import`` blocks named in
    ``drop_imports`` (names the port does not carry and the chosen cases
    do not use), then point every import at the port."""
    lines = src.splitlines(keepends=True)
    for node in ast.parse(src).body:
        if isinstance(node, ast.ImportFrom) and node.module in drop_imports:
            for i in range(node.lineno - 1, node.end_lineno):
                lines[i] = "\n"
    src = "".join(lines)
    return re.sub(r"\bcontainerpilot_tpu(?=[. ])", "containerpilot_tpu_torch",
                  src)


def load(name: str, package: str, drop_imports=(),
         replace=()) -> types.ModuleType:
    """``replace`` holds (old, new) text pairs applied to the port's
    copy only: names the port spells its own way (a make target)."""
    path = os.path.join(TESTS, f"{name}.py")
    with open(path, encoding="utf-8") as f:
        src = f.read()
    src = re.sub(r"([\w.]+(?:\([^()]*\))?)\._value\.get\(\)",
                 r"read_value(\1)", src)
    if package == "torch":
        src = _rewrite(src, drop_imports)
        for old, new in replace:
            src = src.replace(old, new)
    mod = types.ModuleType(f"{name}__{package}")
    mod.__file__ = path
    mod.read_value = read_value
    exec(compile(src, path, "exec"), mod.__dict__)  # noqa: S102
    return mod


def case_args(fn, fixtures: dict) -> dict:
    """The fixtures a case's signature names, from ``fixtures``."""
    names = fn.__code__.co_varnames[:fn.__code__.co_argcount]
    return {n: fixtures[n] for n in names}

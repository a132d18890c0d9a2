"""The port stands alone: importing it loads no jax, nothing of the
JAX package and no prometheus_client (the card's machine has none: the
port writes its own exposition); no file of it imports any of them; and an entry point asked
for the default device on a machine without a card raises instead of
quietly running on the CPU."""
import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(ROOT, "containerpilot_tpu_torch")


def _port_modules():
    mods = []
    for dirpath, _dirs, files in os.walk(PACKAGE):
        for name in files:
            if name.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, name), ROOT)
                mod = rel[:-3].replace(os.sep, ".")
                mods.append(mod[: -len(".__init__")] if mod.endswith(
                    ".__init__") else mod)
    return sorted(mods)


def _is_forbidden(name: str) -> bool:
    return (
        name == "jax" or name.startswith("jax.")
        or name == "jaxlib" or name.startswith("jaxlib.")
        or name == "optax"
        or name == "prometheus_client"
        or name.startswith("prometheus_client.")
        or name == "containerpilot_tpu"
        or name.startswith("containerpilot_tpu.")
    )


def test_importing_every_port_module_loads_no_jax():
    mods = _port_modules()
    assert {
        "containerpilot_tpu_torch.workload.serve",
        "containerpilot_tpu_torch.workload.serve_slots",
        "containerpilot_tpu_torch.workload.serve_prefix",
        "containerpilot_tpu_torch.workload.serve_strategies",
        "containerpilot_tpu_torch.models.slots",
        "containerpilot_tpu_torch.models.stepprog",
        "containerpilot_tpu_torch.models.beam",
        "containerpilot_tpu_torch.models.speculative",
        "containerpilot_tpu_torch.models.lora",
        "containerpilot_tpu_torch.kvtier.digest",
        "containerpilot_tpu_torch.workload.train",
        "containerpilot_tpu_torch.workload.evaluate",
        "containerpilot_tpu_torch.workload.data",
        "containerpilot_tpu_torch.workload.flops",
        "containerpilot_tpu_torch.parallel.train",
        "containerpilot_tpu_torch.parallel.checkpoint",
        "containerpilot_tpu_torch.client.client",
        "containerpilot_tpu_torch.utils.httpclient",
        "containerpilot_tpu_torch.utils.http",
        "containerpilot_tpu_torch.utils.prom",
        "containerpilot_tpu_torch.telemetry.tracing",
        "containerpilot_tpu_torch.telemetry.goodput",
        "containerpilot_tpu_torch.analysis.loopcheck",
        "containerpilot_tpu_torch.fleet.pool",
        "containerpilot_tpu_torch.workload.text",
        "containerpilot_tpu_torch.version",
        "containerpilot_tpu_torch.utils.tasks",
        "containerpilot_tpu_torch.events",
        "containerpilot_tpu_torch.events.bus",
        "containerpilot_tpu_torch.events.events",
        "containerpilot_tpu_torch.events.subscriber",
        "containerpilot_tpu_torch.events.timer",
        "containerpilot_tpu_torch.discovery",
        "containerpilot_tpu_torch.discovery.backend",
        "containerpilot_tpu_torch.discovery.service",
        "containerpilot_tpu_torch.discovery.noop",
        "containerpilot_tpu_torch.discovery.filecatalog",
        "containerpilot_tpu_torch.discovery.consul",
        "containerpilot_tpu_torch.discovery.factory",
        "containerpilot_tpu_torch.fleet.notes",
        "containerpilot_tpu_torch.fleet.member",
        "containerpilot_tpu_torch.fleet.standby",
        "containerpilot_tpu_torch.kvtier.spill",
        "containerpilot_tpu_torch.kvtier.handoff",
    } <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib', "
        "'optax', 'containerpilot_tpu', 'prometheus_client') or "
        "m.startswith(('jax.', 'jaxlib.', 'containerpilot_tpu.', "
        "'prometheus_client.')))\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, cwd=ROOT,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_fleet_entry_modules_alone_load_no_jax():
    """The three modules a replica joining a fleet starts from, imported
    on their own in a fresh interpreter."""
    code = (
        "import sys\n"
        "import containerpilot_tpu_torch.fleet.member, "
        "containerpilot_tpu_torch.kvtier.handoff, "
        "containerpilot_tpu_torch.fleet.standby\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib', "
        "'containerpilot_tpu') or m.startswith(('jax.', 'jaxlib.', "
        "'containerpilot_tpu.')))\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, cwd=ROOT,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_port_file_imports_jax_or_the_jax_package():
    offenders = []
    for dirpath, _dirs, files in os.walk(PACKAGE):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            with open(path) as fh:
                tree = ast.parse(fh.read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module or ""]
                else:
                    continue
                offenders += [
                    (path, n) for n in names if _is_forbidden(n)
                ]
    assert offenders == []


def test_chip_smoke_imports_no_jax():
    path = os.path.join(ROOT, "chip_smoke.py")
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            assert not any(_is_forbidden(a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            assert not _is_forbidden(node.module or "")


def test_default_device_without_a_card_raises(monkeypatch):
    from containerpilot_tpu_torch import resolve_device
    from containerpilot_tpu_torch.models.decode import init_cache
    from containerpilot_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
    )
    from containerpilot_tpu_torch.workload.data import DevicePrefetcher
    from containerpilot_tpu_torch.workload.serve import InferenceServer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TransformerConfig(vocab_size=64, d_model=32, n_heads=2,
                            n_layers=1, d_ff=128, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(0, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_cache(cfg, 1, 8)
    from containerpilot_tpu_torch.models.lora import init_lora_params

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_lora_params(0, cfg, 4)
    params = init_params(0, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceServer(cfg, params, "127.0.0.1", 0, 32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceServer(cfg, params, "127.0.0.1", 0, 32, slots=2,
                        slot_chunk=4, prefix_cache_entries=2)
    from containerpilot_tpu_torch.models.slots import (
        init_slot_state,
        slot_cache,
    )

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        slot_cache(cfg, 2, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_slot_state(cfg, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DevicePrefetcher(dataset=None)  # raises before touching the data
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("script", [
    "chip_smoke.py", os.path.join("scripts", "torch_flash_check.py"),
    os.path.join("scripts", "torch_flash_ab.py"),
    os.path.join("scripts", "torch_int8_check.py"),
    os.path.join("scripts", "torch_int8_lab.py"),
    os.path.join("scripts", "torch_parallel_check.py"),
])
def test_card_scripts_fail_without_a_card(script):
    """Without CUDA the card scripts exit non-zero and print no
    result."""
    if torch.cuda.is_available():
        pytest.skip("a card is present here")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, script)], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout and '"failed"' not in proc.stdout

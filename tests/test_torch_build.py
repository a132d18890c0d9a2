"""The kernel build helper of the port, on a machine without nvcc: it
finds both CUDA sources, names each library by a hash of its source and
flags, and fails with a clear message where the toolkit is missing
(the kernels themselves build and run only on a card)."""
import os

import pytest

from containerpilot_tpu_torch.ops import _build


def test_sources_and_content_hashed_targets(tmp_path, monkeypatch):
    assert _build.sources() == ["flash_fwd", "int8_matmul"]
    monkeypatch.setenv("CONTAINERPILOT_TORCH_BUILD_DIR", str(tmp_path))
    src, out = _build._target("flash_fwd")
    assert src.endswith(os.path.join("csrc", "flash_fwd.cu"))
    assert os.path.dirname(out) == str(tmp_path)
    assert os.path.basename(out).startswith("flash_fwd-")
    assert out != _build._target("int8_matmul")[1]


def test_missing_nvcc_fails_loudly(monkeypatch, tmp_path):
    monkeypatch.setenv("CONTAINERPILOT_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is installed here")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()

"""The kernel build helper of the port, on a machine without nvcc: it
finds every CUDA source, names each library by a hash of its source and
flags, and fails with a clear message where the toolkit is missing
(the kernels themselves build and run only on a card)."""
import os

import pytest

from containerpilot_tpu_torch.ops import _build


def test_sources_and_content_hashed_targets(tmp_path, monkeypatch):
    assert _build.sources() == [
        "flash_bwd_dkdv", "flash_bwd_dq", "flash_fwd", "int8_matmul",
    ]
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


def test_target_hashes_shared_headers(tmp_path, monkeypatch):
    """A kernel's library name covers every ``csrc/*.cuh`` beside its own
    source: an edited header rebuilds, an untouched tree reuses."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "kern.cu").write_text('#include "shared.cuh"\n')
    header = csrc / "shared.cuh"
    header.write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setenv("CONTAINERPILOT_TORCH_BUILD_DIR", str(tmp_path / "b"))
    assert _build.sources() == ["kern"]
    assert _build.headers() == ["shared.cuh"]
    first = _build._target("kern")[1]
    assert _build._target("kern")[1] == first
    header.write_text("// v2\n")
    second = _build._target("kern")[1]
    assert second != first
    assert os.path.basename(second).startswith("kern-")
    (csrc / "other.cuh").write_text("// new\n")
    assert _build._target("kern")[1] not in (first, second)

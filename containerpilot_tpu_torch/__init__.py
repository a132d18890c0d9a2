"""containerpilot_tpu_torch: the PyTorch/CUDA port of the supervised
transformer workload (``containerpilot_tpu`` is the JAX reference it is
held against; this package imports nothing of it, and no jax).

Module paths mirror the JAX package (``models/transformer.py`` here is
the counterpart of ``containerpilot_tpu/models/transformer.py``). Every
Pallas kernel on the ported path is a hand-written CUDA C++ kernel for
Hopper under ``csrc/``, built on first use by ``ops/_build.py``.

Numerics policy, set once here for the whole package: float32 matrix
products stay full float32 (no TF32) on both cuBLAS and cuDNN, and bf16
GEMMs may not reduce in reduced precision, so a bf16 projection is "bf16
inputs, float32 accumulation, one rounding" exactly as the reference's
``einsum(..., preferred_element_type=float32).astype(bf16)``.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

__all__ = ["resolve_device"]


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. ``"cuda"`` (every entry
    point's default) raises when no card is present instead of quietly
    running on the CPU; pass ``device="cpu"`` to ask for the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but CUDA is not available; "
                "pass device='cpu' to run on the CPU"
            )
        if dev.index is None:  # tensors report the index: cuda:N
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev

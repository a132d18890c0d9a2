"""ops of the PyTorch/CUDA port (module paths mirror containerpilot_tpu/ops)."""
from .flash_training import memory_efficient_attention

__all__ = ["memory_efficient_attention"]

"""workload of the PyTorch/CUDA port (module paths mirror containerpilot_tpu/workload)."""

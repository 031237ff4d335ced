"""stamp_tpu_torch — the PyTorch/CUDA port of stamp_tpu for NVIDIA Hopper."""

__version__ = "2.5.0"

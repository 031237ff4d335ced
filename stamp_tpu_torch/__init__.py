"""stamp_tpu_torch — the PyTorch/CUDA port of stamp_tpu for NVIDIA Hopper.

``__version__`` is the version string of ``stamp_tpu/__init__.py`` (the
reference release the two packages are capability-matched to): checkpoints
and feature files record it, and loading gates on it.
"""

__version__ = "2.5.0"

"""Training-time feature transforms.

Copy of ``stamp_tpu/modeling/transforms.py``: ``vary_precision`` randomly
masks float mantissa bits (the reference's experimental robustness
augmentation), on numpy host arrays in the data pipeline.
"""

import numpy as np


def vary_precision(data: np.ndarray, *, min_fraction_bits: int) -> np.ndarray:
    """Randomly reduces the precision of the tensor's values."""
    if min_fraction_bits < 1:
        raise ValueError("min_fraction bits has to be at least 1")

    if data.dtype == np.float32:
        fraction_bits = 23
        mask_dtype = np.int32
    elif data.dtype == np.float16:
        fraction_bits = 10
        mask_dtype = np.int16
    else:
        raise NotImplementedError(f"precision variation not implemented for {data.dtype}")

    no_of_bits_to_mask = np.random.randint(0, fraction_bits - min_fraction_bits, size=data.shape)
    mask = (~np.zeros_like(no_of_bits_to_mask) << no_of_bits_to_mask).astype(mask_dtype)
    return (data.view(mask_dtype) & mask).view(data.dtype)


class VaryPrecisionTransform:
    """A transform randomly reducing the precision of its inputs."""

    def __init__(self, *, min_fraction_bits: int = 1) -> None:
        self.min_fraction_bits = min_fraction_bits

    def __call__(self, batch: np.ndarray) -> np.ndarray:
        return vary_precision(batch, min_fraction_bits=self.min_fraction_bits)

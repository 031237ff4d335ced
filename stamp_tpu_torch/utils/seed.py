"""Global seeding utility.

Copy of ``stamp_tpu/utils/seed.py`` for the port: the same ``set`` and the
same host RNG (``np.random.default_rng(seed)``), so both packages draw the
same bags and the same epoch orders from one seed.  The JAX package's root
``jax.random`` key becomes a ``torch.Generator`` (``torch_generator``); the
two give different numbers from the same seed.
"""

import random
from typing import ClassVar

import numpy as np
import torch


class Seed:
    seed: ClassVar[int | None] = None
    _numpy_rng: ClassVar[np.random.Generator | None] = None

    @classmethod
    def set(cls, seed: int) -> None:
        random.seed(seed)
        np.random.seed(seed)
        cls._numpy_rng = np.random.default_rng(seed)
        cls.seed = seed

    @classmethod
    def torch_generator(cls, device: torch.device | str = "cpu") -> torch.Generator:
        """A generator on ``device`` seeded from the global seed (0 if unset)."""
        return torch.Generator(device=device).manual_seed(cls.seed if cls.seed is not None else 0)

    @classmethod
    def numpy_rng(cls) -> np.random.Generator:
        """Host-side RNG used by the data pipeline (bag sampling)."""
        if cls._numpy_rng is None:
            cls._numpy_rng = np.random.default_rng()
        return cls._numpy_rng

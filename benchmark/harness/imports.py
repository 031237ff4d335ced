"""The check that nothing the benchmark runs loaded JAX or the JAX package.

Names are compared by their top-level part (before the first dot), whole:
``stamp_tpu_torch`` begins with ``stamp_tpu`` and is not it.
"""

from __future__ import annotations

from collections.abc import Iterable

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "stamp_tpu"})

#: set in a run's environment so that libraries the port uses do not load JAX themselves
ENVIRONMENT = {"USE_FLAX": "0", "USE_JAX": "0", "USE_TF": "0"}


def forbidden(module_names: Iterable[str]) -> list[str]:
    """The loaded module names whose top-level name is a forbidden one, sorted."""
    return sorted(name for name in module_names if name.split(".", 1)[0] in FORBIDDEN)

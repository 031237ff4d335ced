"""The collectives a training step hands to a model's forward.

A forward that runs inside a step over a mesh of ranks computes some things
over more than its own rows and tiles: the ALiBi Welford statistic (a ratio
of sums over the whole batch), TransMIL's pseudo-inverse scale (a max over
the whole batch), dropout masks (the whole batch's draw, so that a mesh
gives the one-rank result for one seed), and, under sequence parallelism,
the keys and values of the whole sequence.  The step passes a
:class:`StepGroup` that does these; the parallel layer
(``parallel.mesh``) builds the one that talks to the other ranks.

This base class is a group of one: every method is the identity, and it is
what a forward gets outside a step (``SINGLE``).  The models and ops import
only this module, never ``parallel``.

The sequence axis: the ranks of a sequence group (``seq_parts`` of them,
this one at ``seq_index``) each hold one contiguous share of a bag's tiles.
``gather_seq`` concatenates the shares in rank order (its backward
reduce-scatters the gradient back to the owners).  Gradients follow one
convention throughout: each rank's backward gives its part of the gradient
of the global loss, and the step sums the parts over every rank.
"""

from __future__ import annotations

from collections.abc import Callable, Sequence

import torch


class StepGroup:
    """A group of one: the identity for every collective."""

    #: ranks that share one sequence, and this rank's place among them
    seq_parts = 1
    seq_index = 0

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the step's ranks (no gradient)."""
        return t

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """The max of a scalar ``t`` over the step's ranks (differentiable)."""
        return t

    def draw(
        self,
        shape: Sequence[int],
        draw: Callable[[Sequence[int]], torch.Tensor],
        *,
        seq_dim: int | None = None,
        lead: int = 0,
    ) -> torch.Tensor:
        """``draw(shape)`` for a tensor whose first axis is this rank's rows
        and, when ``seq_dim`` is given, whose axis ``seq_dim`` holds ``lead``
        tokens every rank has (a CLS token) followed by this rank's share of
        the sequence.  In a step the draw covers the whole batch and
        sequence, and this rank keeps its part of it."""
        return draw(shape)

    def gather_seq(self, t: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """Every rank's share of the sequence along ``dim``, in rank order."""
        return t


#: what a forward gets outside a step
SINGLE = StepGroup()

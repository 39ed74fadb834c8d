"""The gradient clip both trainers put in front of Adam, and the means and
gradient sums that make an update on a mesh the update of the whole batch.

Counterpart of ``optax.clip_by_global_norm`` as the JAX trainers chain it,
and of the reductions XLA derives from a sharded batch.  On a mesh
(``parallel/mesh.py``) each rank holds its rows of the batch:

* a mean is each rank's sum over the **global** count (``GlobalMean``): the
  ranks' shares sum to the mean of the whole batch, and so do their
  gradients;
* ``all_sum`` adds the shares of the metrics over the ranks;
* ``all_reduce_grads`` sums the gradients before ``clip_grad_global_norm_``,
  so that the clip sees the global norm and every rank's Adam step is the
  same.

Without a mesh every function here is the plain single-process arithmetic.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch


def clip_grad_global_norm_(params: Iterable[torch.nn.Parameter], max_norm: float) -> None:
    """Scale the gradients of ``params`` in place to a global norm of at
    most ``max_norm``, as optax writes it: ``g / norm * max_norm`` where
    ``norm >= max_norm``, untouched below (``clip_grad_norm_`` adds 1e-6 to
    the norm and scales by ``max_norm / (norm + 1e-6)`` instead)."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    keep = norm < max_norm
    with torch.no_grad():
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm * max_norm))


def all_sum(mesh, x: torch.Tensor, what: str = "metrics") -> torch.Tensor:
    """``x`` summed over the ranks of ``mesh``; ``x`` itself without one."""
    return x if mesh is None else mesh.all_reduce(x, what=what)


def all_reduce_grads(mesh, params: Iterable[torch.nn.Parameter]) -> None:
    """Sum the gradients of ``params`` over the ranks (nothing without a mesh)."""
    if mesh is not None:
        mesh.all_reduce_grads(params)


class GlobalMean:
    """Means over the whole batch of a mesh, of tensors shaped like this
    rank's rows.  ``weights`` (for example the active slots) makes it the
    weighted mean, over the global sum of the weights (at least
    ``min_count`` where given); without weights, over the global number of
    elements of a tensor like ``like``.  Calling it on ``x`` returns this
    rank's share, ``sum(x * weights) / count``: summed over the ranks
    (``all_sum``), the mean of the whole batch."""

    def __init__(self, mesh=None, weights: Optional[torch.Tensor] = None,
                 like: Optional[torch.Tensor] = None, min_count: Optional[float] = None):
        self.weights = weights
        if weights is not None:
            n = all_sum(mesh, weights.sum(), what="count")
            self.count = n if min_count is None else torch.clamp(n, min=min_count)
        else:
            self.count = float(like.numel() * (1 if mesh is None else mesh.size))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        total = x.sum() if self.weights is None else (x * self.weights).sum()
        return total / self.count

"""The gradient clip both trainers put in front of Adam.

Counterpart of ``optax.clip_by_global_norm`` as the JAX trainers chain it.
"""

from __future__ import annotations

from typing import Iterable

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

"""Per-seat batched observation container.

Counterpart of ``madrona_rl_envs_playground_tpu/api/vectorobservation.py``
and field for field of the reference's ``VectorObservation``
(``pantheonrl_extension/vectorobservation.py:19-32``): the ``active`` mask,
the partial ``obs``, the full-state ``state`` (``obs`` when not given) and an
optional ``action_mask``, as a frozen dataclass of tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class VectorObservation:
    """active: [N] bool, does this seat act on the next step.

    obs:         [N, ...] per-seat observation
    state:       [N, ...] full-state observation (critic input)
    action_mask: [N, A] bool or None (None = all actions legal)
    """

    active: torch.Tensor
    obs: torch.Tensor
    state: Optional[torch.Tensor] = None
    action_mask: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.state is None:
            object.__setattr__(self, "state", self.obs)

"""Agent interface for the vector multi-agent API.

Counterpart of ``madrona_rl_envs_playground_tpu/api/agents.py`` and of the
reference's ``VectorAgent`` (``pantheonrl_extension/vectoragent.py:9-40``):
``get_action`` takes a batched ``VectorObservation`` and returns one int32
action per env; ``update`` delivers the rewards and dones earned since the
most recent recorded ``get_action`` (several ``update`` calls between two
actions accumulate, which turn-based envs rely on).
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import torch

from ..device import DeviceLike, resolve_device
from .vectorobservation import VectorObservation


class VectorAgent(ABC):
    @abstractmethod
    def get_action(self, obs: VectorObservation, record: bool = True) -> torch.Tensor:
        """Return int32 actions [N] for the batch; optionally record for training."""

    @abstractmethod
    def update(self, rewards: torch.Tensor, dones: torch.Tensor) -> None:
        """Deliver rewards/dones for the most recent recorded action."""


class RandomVectorAgent(VectorAgent):
    """Uniform over the legal actions where the observation has a mask, and
    over all ``num_actions`` without one (the reference's sampler-callable
    version ignores masks; turn-based envs need legal actions).  Draws come
    from a ``torch.Generator`` on ``device`` (the env's; default the card)
    seeded with ``seed``; the stream differs from JAX's."""

    def __init__(self, num_actions: int, seed: int = 0, device: DeviceLike = None):
        self.num_actions = num_actions
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def get_action(self, obs: VectorObservation, record: bool = True) -> torch.Tensor:
        if obs.action_mask is None:
            n = obs.active.shape[0]
            return torch.randint(0, self.num_actions, (n,), generator=self.generator,
                                 device=self.device, dtype=torch.int32)
        a = torch.multinomial(obs.action_mask.float(), 1, generator=self.generator)
        return a[:, 0].to(torch.int32)

    def update(self, rewards: torch.Tensor, dones: torch.Tensor) -> None:
        return

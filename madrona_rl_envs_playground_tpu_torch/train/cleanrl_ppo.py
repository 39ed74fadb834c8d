"""CleanRL PPO pieces: the rollout buffer and plain GAE.

Counterpart of part of ``madrona_rl_envs_playground_tpu/train/cleanrl_ppo.py``.
The active-masked GAE and the decentralized ``CleanPPOAgent`` come with the
slices that need them (Hanabi, the API).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Rollout:
    obs: torch.Tensor                     # [T, M, obs]
    states: torch.Tensor                  # [T, M, state]
    actions: torch.Tensor                 # [T, M] int32
    action_masks: Optional[torch.Tensor]  # [T, M, A] bool
    logprobs: torch.Tensor                # [T, M] f32
    rewards: torch.Tensor                 # [T, M] f32
    dones: torch.Tensor                   # [T, M] bool
    active: Optional[torch.Tensor]        # [T, M] bool
    values: torch.Tensor                  # [T, M] f32


def plain_gae(rewards: torch.Tensor, dones: torch.Tensor, values: torch.Tensor,
              next_value: torch.Tensor, next_done: torch.Tensor,
              gamma: float, gae_lambda: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Standard GAE over [T, M] buffers as a reverse loop over T.

    ``dones[t]`` is the done delivered before slot t; ``next_done`` and
    ``next_value`` follow the last slot.  Returns (advantages, returns).
    The JAX version evaluates the same recurrence with an associative scan,
    so the two agree to float32 reassociation.
    """
    nnt = 1.0 - torch.cat([dones[1:].float(), next_done.float()[None]], 0)
    nv = torch.cat([values[1:], next_value[None]], 0)
    delta = rewards + gamma * nv * nnt - values
    coeff = gamma * gae_lambda * nnt
    adv = torch.empty_like(delta)
    last = torch.zeros_like(delta[0])
    for t in range(delta.shape[0] - 1, -1, -1):
        last = delta[t] + coeff[t] * last
        adv[t] = last
    return adv, adv + values

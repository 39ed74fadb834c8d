"""CleanRL PPO pieces: the rollout buffer, the active-masked GAE and plain GAE.

Counterpart of part of ``madrona_rl_envs_playground_tpu/train/cleanrl_ppo.py``.
The decentralized ``CleanPPOAgent`` comes with the API slice.
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


def active_masked_gae(buf: Rollout, next_value: torch.Tensor, next_done: torch.Tensor,
                      final_active: torch.Tensor, gamma: float, gae_lambda: float
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's active-mask GAE loop (``vectoragent.py:230-262``) as a
    reverse loop over T.  A stream's active slot bootstraps from the
    stream's next active slot (or the final value where the stream is active
    after the rollout).  Scanning back from the end, while some stream has
    not been active yet, only a stream's first active slot is computed, and
    it is not trained; once every stream has been, every active slot is
    computed and trained.  Returns (advantages [T, M], returns [T, M],
    trainable active [T, M] bool)."""
    bootstrapped = final_active
    nextnonterminal = torch.where(final_active, 1.0 - next_done.float(),
                                  torch.zeros_like(next_value))
    nextvalues = torch.where(final_active, next_value, torch.zeros_like(next_value))
    lastgaelam = torch.zeros_like(next_value)
    adv = torch.empty_like(buf.values)
    active_out = torch.empty_like(buf.active)
    for t in range(buf.values.shape[0] - 1, -1, -1):
        mask_t = buf.active[t]
        all_boot = bootstrapped.all()
        bootmask = mask_t & ~bootstrapped
        computemask = torch.where(all_boot, mask_t, bootmask)
        active_out[t] = mask_t & ~(bootmask & ~all_boot)
        bootstrapped = bootstrapped | mask_t
        delta = buf.rewards[t] + gamma * nextvalues * nextnonterminal - buf.values[t]
        cand = delta + gamma * gae_lambda * nextnonterminal * lastgaelam
        lastgaelam = torch.where(computemask, cand, lastgaelam)
        adv[t] = torch.where(computemask, cand, torch.zeros_like(cand))
        nextnonterminal = torch.where(mask_t, 1.0 - buf.dones[t].float(), nextnonterminal)
        nextvalues = torch.where(mask_t, buf.values[t], nextvalues)
    return adv, adv + buf.values, active_out


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

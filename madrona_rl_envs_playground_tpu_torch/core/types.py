"""Containers shared by every environment.

Counterpart of ``madrona_rl_envs_playground_tpu/core/types.py``: dataclasses of
tensors with the batch axis written out (JAX adds it with ``vmap``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class StepOutput:
    """What every world reports after one step, batched over N worlds.

    obs:         [N, P, obs_size]    per-agent observation
    state_obs:   [N, P, state_size]  per-agent full-state observation
    action_mask: [N, P, A] bool      legal-action mask
    active:      [N, P] bool         which agents act next step
    reward:      [N, P]              per-agent reward (int32 for Overcooked)
    done:        [N] bool            episode ended this step
    """

    obs: torch.Tensor
    state_obs: torch.Tensor
    action_mask: torch.Tensor
    active: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor


@dataclasses.dataclass(frozen=True)
class BatchState:
    """Env states batched on axis 0 plus the episode counter.

    ``episode_counter`` is the reference's global ``EpisodeManager::curEpisode``:
    a uint32, held as an int64 scalar tensor in [0, 2**32).
    """

    env_states: Any
    episode_counter: torch.Tensor

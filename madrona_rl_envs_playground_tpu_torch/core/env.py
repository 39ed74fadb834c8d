"""Environment protocol: each env is three functions over batched state.

Counterpart of ``madrona_rl_envs_playground_tpu/core/env.py``.  The reference
expresses an env as an ECS task graph (action system, obs system, checkDone
with in-graph auto-reset, e.g. ``src/balance_beam_env/sim.cpp:159-175``);
here, as in JAX, a step is split into three phases so the batched step
(``core/batch.py``) can fuse the auto-reset without encoding observations
twice:

* ``transition(state, actions [N, P]) -> (state', reward [N, P], done [N])``:
  the dynamics, no observation work;
* ``init_core(episode_idx [N]) -> state``: fresh episodes (deal cards,
  randomise positions, seed the in-state LCG), with no observation encoding;
* ``encode(state, just_reset [N]) -> (state', obs, state_obs, action_mask,
  active)``: observations and action masks.  ``just_reset`` lets turn-based
  envs (Hanabi) refresh every seat's obs buffer on a reset but only the
  acting seat's otherwise, as the reference's obs systems do
  (``src/hanabi_env/sim.cpp:794-810``).

JAX writes the three per world and ``vmap``s them; here each takes and
returns tensors with a leading N axis (episode indices are int64 holding
uint32 values), so the batch needs no ``vmap``.  The static configuration
lives on the env object, as in JAX.
"""

from __future__ import annotations

from typing import Any, Protocol, Tuple

import torch


class Environment(Protocol):
    """Structural interface implemented by each env module's ``Env`` class."""

    # --- static metadata -------------------------------------------------
    num_agents: int
    obs_size: int
    state_size: int
    num_actions: int
    reward_dtype: torch.dtype
    obs_dtype: torch.dtype

    # --- batched functions (leading N axis) -------------------------------
    def init_core(self, episode_idx: torch.Tensor) -> Any:
        ...

    def transition(self, state: Any, actions: torch.Tensor
                   ) -> Tuple[Any, torch.Tensor, torch.Tensor]:
        ...

    def encode(self, state: Any, just_reset: torch.Tensor):
        """Returns (state', obs, state_obs, action_mask, active)."""
        ...

"""Env base class: the flags every env declares.

Counterpart of ``madrona_rl_envs_playground_tpu/core/base.py``.  The JAX env
is also hashable, because ``jit`` takes it as a static argument; PyTorch runs
eagerly and needs no such key.
"""

from __future__ import annotations


class EnvBase:
    # state_is_obs: state_obs is the same tensor as obs every step.
    # masked: action_mask/active are informative; False = the env always
    #   emits an all-ones mask and all-active seats.
    state_is_obs: bool = False
    masked: bool = True

"""Kernel-backed rollout collection for the trainers (Overcooked so far).

Counterpart of ``madrona_rl_envs_playground_tpu/train/fused_collect.py``
(``_overcooked_collect``).  A collector holds three functions:

* ``pack(bstate) -> carry``: env-major ``BatchState`` -> the kernel layout;
* ``step(carry, actions [N, P]) -> (carry', StepOutput)``: one step through
  ``ops.overcooked.fused_step`` (K1 on the card, its plain version on the
  CPU), with a ``StepOutput`` equal to ``batched_step``'s;
* ``unpack(carry) -> bstate``.

Pack and unpack run once per rollout, not once per step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from ..core.rng import _MASK32
from ..core.types import BatchState, StepOutput
from ..device import DeviceLike, resolve_device
from ..ops import overcooked as ok


@dataclasses.dataclass(frozen=True)
class FusedCollect:
    pack: Callable[[BatchState], Any]
    step: Callable[[Any, torch.Tensor], Tuple[Any, StepOutput]]
    unpack: Callable[[Any], BatchState]


def make_fused_collect(env, num_envs: int, device: DeviceLike = None) -> FusedCollect:
    """The Overcooked collector on ``device`` (default ``"cuda"``).  Raises
    for an env outside the kernels' envelope."""
    dev = resolve_device(device)
    ok._require_fused(env)
    P, A = env.num_players, env.num_actions
    # all-ones masks and active flags: Overcooked never masks
    mask = torch.ones((num_envs, P, A), dtype=torch.bool, device=dev)
    active = torch.ones((num_envs, P), dtype=torch.bool, device=dev)

    def pack(bstate: BatchState):
        return ok.pack_state(env, bstate.env_states), bstate.episode_counter

    def step(carry, actions: torch.Tensor):
        ts, counter = carry
        actions_t = actions.t().to(torch.int32).contiguous()
        ts2, obs, rew, done = ok.fused_step(env, ts, actions_t)
        out = StepOutput(obs=obs, state_obs=obs, action_mask=mask,
                         active=active, reward=rew.t(), done=done)
        # resets draw no episode index; the counter only tracks allocation
        counter = (counter + done.sum()) & _MASK32
        return (ts2, counter), out

    def unpack(carry):
        ts, counter = carry
        return BatchState(env_states=ok.unpack_state(env, ts),
                          episode_counter=counter)

    return FusedCollect(pack=pack, step=step, unpack=unpack)

"""Batched simulator driver: reset and step N worlds in lockstep.

Counterpart of ``madrona_rl_envs_playground_tpu/core/batch.py``.  An env here
works on the whole batch at once (``init_core``, ``transition`` and
``encode`` take and return tensors with a leading N axis), so there is no
``vmap``.  Two semantics carry over:

* the auto-reset happens inside the step, and the encode runs after it, so a
  world that is done this step reports the fresh episode's observation;
* the episode counter is a uint32 that advances by ``sum(done)``; world w of
  the batch is handed index ``counter + (number of done worlds before w)``.

On a ``mesh`` (``parallel/mesh.py``) the batch is this rank's rows of a
global batch of N worlds, and the episode indices are those of the whole
batch: world w of rank r starts as episode ``start + r N / R + w``, and on
each step a rank first learns how many worlds of the ranks before it are
done (one all-gather of a scalar), so the resets take the indices the
single-process step hands them; the counter advances by the global sum.

``Simulator`` owns one batch, the counterpart of JAX's ``Simulator`` (the
reference Manager's analog): plain ``batched_reset``/``batched_step`` on the
chosen device, with no jit; ``mesh`` takes the place of JAX's ``sharding``.
On the card it steps the plain env on CUDA tensors: the general path for
every env, as JAX's ``jnp`` route is, not a kernel's fallback.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..device import DeviceLike, resolve_device
from .rng import _MASK32
from .types import BatchState, StepOutput


def select_state(done: torch.Tensor, a, b):
    """Field-wise ``where(done, a, b)`` over two batched state dataclasses."""

    def sel(x, y):
        d = done.reshape(done.shape + (1,) * (x.dim() - 1))
        return torch.where(d, x, y)

    return type(a)(**{f.name: sel(getattr(a, f.name), getattr(b, f.name))
                      for f in dataclasses.fields(a)})


def batched_reset(env, num_envs: int, start_episode: int = 0,
                  device: DeviceLike = None, mesh=None) -> Tuple[BatchState, StepOutput]:
    """Construct N worlds; world w gets episode index ``start_episode + w``.
    On a ``mesh``, ``num_envs`` is the global N and the batch this rank's
    rows of it (``device`` is then the mesh's)."""
    dev = resolve_device(device) if mesh is None else mesh.device
    rows = slice(0, num_envs) if mesh is None else mesh.rows(num_envs)
    n = rows.stop - rows.start
    eps = (torch.arange(rows.start, rows.stop, dtype=torch.int64, device=dev)
           + start_episode) & _MASK32
    states = env.init_core(eps)
    just_reset = torch.ones(n, dtype=torch.bool, device=dev)
    states, obs, state_obs, mask, active = env.encode(states, just_reset)
    out = StepOutput(
        obs=obs,
        state_obs=state_obs,
        action_mask=mask,
        active=active,
        reward=torch.zeros((n, env.num_agents), dtype=env.reward_dtype, device=dev),
        done=torch.zeros(n, dtype=torch.bool, device=dev),
    )
    counter = torch.tensor((start_episode + num_envs) & _MASK32,
                           dtype=torch.int64, device=dev)
    return BatchState(env_states=states, episode_counter=counter), out


def batched_step(env, bstate: BatchState, actions: torch.Tensor,
                 mesh=None) -> Tuple[BatchState, StepOutput]:
    """One lockstep step of all worlds with in-step auto-reset.

    actions: int [N, P] (on a ``mesh``, this rank's rows).
    """
    s2, reward, done = env.transition(bstate.env_states, actions)

    # episode indices in world order (the reference's fetch_add sequence),
    # after the done worlds of the ranks before this one
    done_i = done.to(torch.int64)
    rank = torch.cumsum(done_i, 0) - done_i
    n_done = done_i.sum()
    if mesh is not None:
        before, n_done = mesh.exclusive_scan(n_done)
        rank = rank + before
    eps = (bstate.episode_counter + rank) & _MASK32
    counter2 = (bstate.episode_counter + n_done) & _MASK32

    fresh = env.init_core(eps)
    s3 = select_state(done, fresh, s2)
    s4, obs, state_obs, mask, active = env.encode(s3, done)

    out = StepOutput(obs=obs, state_obs=state_obs, action_mask=mask,
                     active=active, reward=reward, done=done)
    return BatchState(env_states=s4, episode_counter=counter2), out


class Simulator:
    """Owns the batched state of ``num_envs`` worlds of one env.

    ``step(actions)`` (int ``[N, P]``, world-major) advances every world and
    returns the ``StepOutput``; ``reset()`` rebuilds the batch from
    ``start_episode``.  ``bstate`` and ``last_out`` hold the current state
    and the latest output.  On a ``mesh`` they hold this rank's rows of the
    ``num_envs`` worlds, ``step`` takes this rank's actions, and every rank
    steps together."""

    def __init__(self, env, num_envs: int, start_episode: int = 0,
                 device: DeviceLike = None, mesh=None):
        self.env = env
        self.num_envs = num_envs
        self.mesh = mesh
        self.device = resolve_device(device) if mesh is None else mesh.device
        self._start_episode = start_episode
        self.reset()

    def step(self, actions: torch.Tensor) -> StepOutput:
        actions = actions.to(device=self.device, dtype=torch.int32)
        self.bstate, self.last_out = batched_step(self.env, self.bstate, actions,
                                                  mesh=self.mesh)
        return self.last_out

    def reset(self) -> StepOutput:
        self.bstate, self.last_out = batched_reset(self.env, self.num_envs,
                                                   self._start_episode, device=self.device,
                                                   mesh=self.mesh)
        return self.last_out

"""Kernel-backed rollout collection for the trainers.

Counterpart of ``madrona_rl_envs_playground_tpu/train/fused_collect.py``
(``_overcooked_collect``, ``_acrobot_collect``, ``_cartpole_collect``,
``_balance_collect``, ``_hanabi_collect``).  A collector holds three functions:

* ``pack(bstate) -> carry``: env-major ``BatchState`` -> the kernel layout;
* ``step(carry, actions [N, P]) -> (carry', StepOutput)``: one step through
  the env's ``fused_step`` (its kernel on the card, its plain version on the
  CPU), with a ``StepOutput`` equal to ``batched_step``'s;
* ``unpack(carry) -> bstate``.

Where no kernel applies, ``make_fused_collect`` returns the plain collector
(``kernel`` False): ``batched_step`` with identity pack and unpack, so the
trainers always step through a collector.  Pack and unpack run once per
rollout, not once per step.  The episode counter stays a uint32 in an int64
scalar tensor on the device, wrapping at 2^32 as ``core/batch.py``'s does.

On a ``mesh`` (``parallel/mesh.py``; ``num_envs`` the global N, the batch
this rank's rows), JAX's rule holds: Overcooked steps its kernel, K1, on
each rank's shard, since its resets draw no episode index, so each rank is
exact with no collective in the step (the counter adds up the ranks' done
worlds once, at ``unpack``).  The other envs allocate episode indices
across the whole batch inside their kernels, which a rank cannot do without
the counts of the ranks before it: on a mesh they take the plain collector,
``batched_step`` with the mesh's offsets, as JAX takes its ``jnp`` path.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from ..core.batch import batched_step
from ..core.rng import _MASK32
from ..core.types import BatchState, StepOutput
from ..device import DeviceLike, resolve_device
from ..envs import acrobot, balance_beam, cartpole, hanabi
from ..envs.overcooked_base import OvercookedEnv
from ..ops import acrobot as ap
from ..ops import balance as bp
from ..ops import cartpole as cp
from ..ops import hanabi as hk
from ..ops import overcooked as ok


@dataclasses.dataclass(frozen=True)
class FusedCollect:
    pack: Callable[[BatchState], Any]
    step: Callable[[Any, torch.Tensor], Tuple[Any, StepOutput]]
    unpack: Callable[[Any], BatchState]
    kernel: bool = True  # False: the plain ``batched_step``


def make_fused_collect(env, num_envs: int, device: DeviceLike = None,
                       mesh=None) -> FusedCollect:
    """The env's collector on ``device`` (default ``"cuda"``), or the plain
    one where no kernel applies (an Overcooked layout outside the kernels'
    envelope, Hanabi of more than two players; JAX returns None there).  On
    a ``mesh``, this rank's shard of ``num_envs`` worlds on the mesh's
    device: K1 for Overcooked, the plain collector for the rest."""
    if mesh is not None:
        n = mesh.local_size(num_envs)
        if isinstance(env, OvercookedEnv) and ok.fused_supported(env):
            return _overcooked_collect(env, n, mesh.device, mesh)
        return _plain_collect(env, mesh)
    dev = resolve_device(device)
    if isinstance(env, OvercookedEnv) and ok.fused_supported(env):
        return _overcooked_collect(env, num_envs, dev)
    if isinstance(env, acrobot.Env):
        return _acrobot_collect(env, num_envs, dev)
    if isinstance(env, cartpole.Env):
        return _cartpole_collect(env, num_envs, dev)
    if isinstance(env, balance_beam.Env):
        return _balance_collect(env, num_envs, dev)
    if isinstance(env, hanabi.Env) and hk.fused_supported(env):
        return _hanabi_collect(env, num_envs, dev)
    return _plain_collect(env)


def _plain_collect(env, mesh=None) -> FusedCollect:
    ident = lambda x: x  # noqa: E731
    return FusedCollect(pack=ident, step=lambda c, a: batched_step(env, c, a, mesh=mesh),
                        unpack=ident, kernel=False)


def _constant_outputs(env, num_envs: int, dev: torch.device):
    """All-ones masks and active flags: these envs never mask."""
    P, A = env.num_agents, env.num_actions
    return (torch.ones((num_envs, P, A), dtype=torch.bool, device=dev),
            torch.ones((num_envs, P), dtype=torch.bool, device=dev))


def _overcooked_collect(env, num_envs: int, dev: torch.device, mesh=None) -> FusedCollect:
    mask, active = _constant_outputs(env, num_envs, dev)

    # resets draw no episode index; the counter only tracks allocation: the
    # carry holds the counter at pack and this rank's done worlds since, and
    # unpack adds up the ranks' (one collective a rollout on a mesh)
    def pack(bstate: BatchState):
        return (ok.pack_state(env, bstate.env_states), bstate.episode_counter,
                torch.zeros((), dtype=torch.int64, device=dev))

    def step(carry, actions: torch.Tensor):
        ts, counter, n_done = carry
        actions_t = actions.t().to(torch.int32).contiguous()
        ts2, obs, rew, done = ok.fused_step(env, ts, actions_t)
        out = StepOutput(obs=obs, state_obs=obs, action_mask=mask,
                         active=active, reward=rew.t(), done=done)
        return (ts2, counter, n_done + done.sum()), out

    def unpack(carry):
        ts, counter, n_done = carry
        if mesh is not None:
            n_done = mesh.all_reduce(n_done, what="episodes")
        return BatchState(env_states=ok.unpack_state(env, ts),
                          episode_counter=(counter + n_done) & _MASK32)

    return FusedCollect(pack=pack, step=step, unpack=unpack)


def _acrobot_collect(env, num_envs: int, dev: torch.device) -> FusedCollect:
    mask, active = _constant_outputs(env, num_envs, dev)
    reward = torch.full((num_envs, 1), -1.0, dtype=torch.float32, device=dev)

    def pack(bstate: BatchState):
        return ap.pack_state(bstate.env_states), bstate.episode_counter

    def step(carry, actions: torch.Tensor):
        ts, counter = carry
        ts2, done, counter = ap.fused_step(ts, counter, actions.to(torch.int32).contiguous())
        obs = ts2.st.view(num_envs, 1, 4)  # the state is the obs
        out = StepOutput(obs=obs, state_obs=obs, action_mask=mask,
                         active=active, reward=reward, done=done)
        return (ts2, counter), out

    def unpack(carry):
        ts, counter = carry
        return BatchState(env_states=ap.unpack_state(ts), episode_counter=counter)

    return FusedCollect(pack=pack, step=step, unpack=unpack)


def _cartpole_collect(env, num_envs: int, dev: torch.device) -> FusedCollect:
    mask, active = _constant_outputs(env, num_envs, dev)
    reward = torch.ones((num_envs, 1), dtype=torch.float32, device=dev)

    def pack(bstate: BatchState):
        return cp.pack_state(bstate.env_states), bstate.episode_counter

    def step(carry, actions: torch.Tensor):
        ts, counter = carry
        ts2, done, counter = cp.fused_step(ts, counter, actions.to(torch.int32).contiguous())
        obs = ts2.st.view(num_envs, 1, 4)  # the state is the obs
        out = StepOutput(obs=obs, state_obs=obs, action_mask=mask,
                         active=active, reward=reward, done=done)
        return (ts2, counter), out

    def unpack(carry):
        ts, counter = carry
        return BatchState(env_states=cp.unpack_state(ts), episode_counter=counter)

    return FusedCollect(pack=pack, step=step, unpack=unpack)


def _balance_collect(env, num_envs: int, dev: torch.device) -> FusedCollect:
    mask, active = _constant_outputs(env, num_envs, dev)

    def pack(bstate: BatchState):
        return bp.pack_state(bstate.env_states), bstate.episode_counter

    def step(carry, actions: torch.Tensor):
        ts, counter = carry
        ts2, rew, done, counter = bp.fused_step(ts, counter,
                                                actions.to(torch.int32).contiguous())
        out = StepOutput(obs=ts2.obs, state_obs=ts2.obs, action_mask=mask,
                         active=active, reward=rew[:, None].expand(num_envs, 2),
                         done=done)
        return (ts2, counter), out

    def unpack(carry):
        ts, counter = carry
        return BatchState(env_states=bp.unpack_state(ts), episode_counter=counter)

    return FusedCollect(pack=pack, step=step, unpack=unpack)


def _hanabi_collect(env, num_envs: int, dev: torch.device) -> FusedCollect:
    seats = torch.arange(env.players, device=dev)
    cur_row = hk.row_offsets(env)["scal"] + hk.CUR

    def pack(bstate: BatchState):
        return hk.pack_state(env, bstate.env_states), bstate.episode_counter

    def step(carry, actions: torch.Tensor):
        ts, counter = carry
        ts2, rew, done, counter = hk.fused_step(env, ts, counter,
                                                actions.to(torch.int32).contiguous())
        out = StepOutput(obs=ts2.obs, state_obs=torch.cat([ts2.obs, ts2.own], -1),
                         action_mask=ts2.mask, active=ts2.st[cur_row][:, None] == seats,
                         reward=rew.to(env.reward_dtype)[:, None].expand(num_envs, env.players),
                         done=done)
        return (ts2, counter), out

    def unpack(carry):
        ts, counter = carry
        return BatchState(env_states=hk.unpack_state(env, ts), episode_counter=counter)

    return FusedCollect(pack=pack, step=step, unpack=unpack)

"""Balance Beam batch simulator (plain PyTorch).

Counterpart of ``madrona_rl_envs_playground_tpu/envs/balance_beam.py``
(reference ``src/balance_beam_env/sim.cpp``): a 2-player cooperative toy on 5
spaces with moves {-2, -1, +1, +2} and episodes of 3 timesteps.  The reward
is 1 if the players share a space, else ``-|delta| * 0.2``; falling off the
beam ends the episode with ``(-5 * (time + 1)) * 0.2``.  The observation is
int32 ``[N, 2, 7]``: per seat a rolling history ``[own x3, partner x3,
time]`` with positions offset by +2.  A reset draws both start positions as
``int(5 * rand())`` from the TEA+LCG episode stream.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import rng
from ..core.base import EnvBase

NUM_SPACES = 5
TIME = 3
BUFFER = 2
SCALE = 0.2
MOVES = (-2, -1, 1, 2)
NUM_MOVES = 4


@dataclasses.dataclass(frozen=True)
class State:
    loc: torch.Tensor    # [N, 2] int32
    obs: torch.Tensor    # [N, 2, 7] int32: rolling history + time
    time: torch.Tensor   # [N] int32
    rng_v: torch.Tensor  # [N] int64 holding the uint32 LCG word


class Env(EnvBase):
    state_is_obs = True
    masked = False

    num_agents = 2
    obs_size = 2 * TIME + 1
    state_size = 2 * TIME + 1
    num_actions = NUM_MOVES
    reward_dtype = torch.float32
    obs_dtype = torch.int32

    def __init__(self):
        self._tables_by_device = {}

    def _tables(self, device: torch.device) -> dict:
        key = str(device)
        tb = self._tables_by_device.get(key)
        if tb is None:
            f32 = dict(dtype=torch.float32, device=device)
            tb = dict(moves=torch.tensor(MOVES, dtype=torch.int32, device=device),
                      scale=torch.tensor(SCALE, **f32),
                      fall=torch.tensor(-float(NUM_SPACES), **f32),
                      one=torch.tensor(1.0, **f32))
            self._tables_by_device[key] = tb
        return tb

    def init_core(self, episode_idx: torch.Tensor) -> State:
        v = rng.seed(episode_idx)
        v, l0 = rng.randint(v, NUM_SPACES)
        v, l1 = rng.randint(v, NUM_SPACES)
        N = episode_idx.shape[0]
        t = torch.full((N,), TIME - 1, dtype=torch.int32, device=episode_idx.device)
        obs = torch.zeros((N, 2, 2 * TIME + 1), dtype=torch.int32, device=episode_idx.device)
        obs[:, :, 2 * TIME] = t[:, None]
        obs[:, 0, 0] = l0 + BUFFER
        obs[:, 1, 0] = l1 + BUFFER
        obs[:, 0, TIME] = l1 + BUFFER
        obs[:, 1, TIME] = l0 + BUFFER
        return State(loc=torch.stack([l0, l1], 1), obs=obs, time=t, rng_v=v)

    def transition(self, state: State, actions: torch.Tensor):
        """actions [N, 2] -> (state', reward [N, 2] f32, done [N] bool)."""
        tb = self._tables(actions.device)
        loc = state.loc + tb["moves"][actions.long()]
        t = state.time - 1
        N = loc.shape[0]

        # rolling history: shift both 3-slots down, then write the current
        # own / partner positions and the new time
        o = state.obs
        hist = torch.cat([
            (loc + BUFFER)[:, :, None],
            o[:, :, 0:2],
            (loc.flip(1) + BUFFER)[:, :, None],
            o[:, :, 3:5],
            t[:, None, None].expand(N, 2, 1),
        ], dim=2)

        diff = loc[:, 0] - loc[:, 1]
        reward_val = torch.where(diff == 0, tb["one"],
                                 -diff.abs().to(torch.float32) * tb["scale"])
        off_beam = ((loc < 0) | (loc >= NUM_SPACES)).any(1)
        reward_val = torch.where(
            off_beam, tb["fall"] * (t + 1).to(torch.float32) * tb["scale"], reward_val)
        done = off_beam | (t == 0)
        reward = reward_val[:, None].expand(N, 2)
        return State(loc=loc, obs=hist, time=t, rng_v=state.rng_v), reward, done

    def encode(self, state: State, just_reset: torch.Tensor):
        N, dev = state.time.shape[0], state.time.device
        mask = torch.ones((N, 2, NUM_MOVES), dtype=torch.bool, device=dev)
        active = torch.ones((N, 2), dtype=torch.bool, device=dev)
        return state, state.obs, state.obs, mask, active

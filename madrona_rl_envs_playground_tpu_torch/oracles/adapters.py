"""Host-side oracle environments with the SyncVectorEnv per-env protocol.

The port's own copy of ``madrona_rl_envs_playground_tpu/oracles/adapters.py``,
its counterpart: the code is that file's, line for line
(``tests/test_torch_oracles.py`` compares the two).

These are the "baseline" backends of the reference example scripts
(``--use-baseline``: original python envs under SyncVectorEnv,
``scripts/overcooked_example.py:54-67``).  Each adapter exposes::

    n_reset() -> (obs_list, mask_list, active_list)      # per-seat rows
    n_step(actions[P]) -> (obs_list, mask_list, active_list, rewards[P], done)

plus ``num_agents`` / ``obs_size`` / ``num_actions`` metadata.
"""

from __future__ import annotations

import numpy as np

from . import cartpole as cartpole_oracle
from .hanabi import Counter, HanabiOracle
from .overcooked import OvercookedOracle


class CartpoleOracleEnv:
    num_agents = 1
    obs_size = 4
    num_actions = 2

    def __init__(self, seed: int = 0):
        self.rs = np.random.RandomState(seed)
        self.state = None

    def _pack(self):
        obs = [np.asarray(self.state, np.float32)]
        return obs, [np.ones(2, bool)], [np.True_]

    def n_reset(self):
        self.state = self.rs.uniform(-0.05, 0.05, size=4)
        return self._pack()

    def n_step(self, actions):
        nxt, rew, done = cartpole_oracle.step(self.state, int(actions[0]))
        self.state = nxt
        obs, masks, active = self._pack()
        return obs, masks, active, np.asarray([rew], np.float32), bool(done)


class BalanceOracleEnv:
    """Stateful Balance Beam line game (reference ``PantheonLine``,
    ``envs/balance_beam_env.py:88-152``): 5 spaces, 3 timesteps, rolling
    newest-first history observation."""

    num_agents = 2
    obs_size = 7
    num_actions = 4

    NUM_SPACES, TIME, BUFFER, SCALE = 5, 3, 2, 0.2
    MOVES = [-2, -1, 1, 2]

    def __init__(self, seed: int = 0):
        self.rs = np.random.RandomState(seed)

    def _obs(self):
        out = []
        for a in range(2):
            own = [v + self.BUFFER for v in self.hist[a]]
            other = [v + self.BUFFER for v in self.hist[1 - a]]
            out.append(np.asarray(own + other + [self.t], np.int64))
        return out

    def _pack(self):
        return self._obs(), [np.ones(4, bool)] * 2, [np.True_] * 2

    def n_reset(self):
        locs = [int(self.rs.randint(self.NUM_SPACES)) for _ in range(2)]
        self.hist = [[locs[a], -self.BUFFER, -self.BUFFER] for a in range(2)]
        self.t = self.TIME
        return self._pack()

    def n_step(self, actions):
        locs = [self.hist[a][0] + self.MOVES[int(actions[a])] for a in range(2)]
        self.t -= 1
        for a in range(2):
            self.hist[a] = [locs[a], self.hist[a][0], self.hist[a][1]]
        if locs[0] == locs[1]:
            rew = 1.0
        else:
            rew = -abs(locs[0] - locs[1]) * self.SCALE
        done = self.t == 0
        if any(l < 0 or l >= self.NUM_SPACES for l in locs):
            done = True
            rew = -self.NUM_SPACES * (self.t + 1) * self.SCALE
        obs, masks, active = self._pack()
        return obs, masks, active, np.asarray([rew, rew], np.float32), bool(done)


class OvercookedOracleEnv:
    num_actions = 6

    def __init__(self, variant: str, params: dict):
        self.oracle = OvercookedOracle(variant, params)
        self.num_agents = self.oracle.P
        self.obs_size = self.oracle.S * self.oracle.C

    def _pack(self, obs):
        P = self.num_agents
        flat = [np.asarray(obs[p], np.int8).reshape(-1) for p in range(P)]
        return flat, [np.ones(6, bool)] * P, [np.True_] * P

    def n_reset(self):
        return self._pack(self.oracle.reset())

    def n_step(self, actions):
        obs, rew, done = self.oracle.step([int(a) for a in actions])
        o, m, act = self._pack(obs)
        rews = np.full(self.num_agents, rew, np.float32)
        return o, m, act, rews, bool(done)


class HanabiOracleEnv:
    def __init__(self, counter: Counter = None, **cfg):
        self.oracle = HanabiOracle(counter or Counter(), **cfg)
        self.num_agents = self.oracle.P
        self.obs_size = len(self.oracle.obs[0][0])
        self.num_actions = len(self.oracle.masks[0])

    def _pack(self):
        o = self.oracle
        obs = [np.asarray(o.obs[a][0], np.int8) for a in range(o.P)]
        masks = [np.asarray(o.masks[a], bool) for a in range(o.P)]
        active = [np.bool_(a == o.cur) for a in range(o.P)]
        return obs, masks, active

    def n_reset(self):
        self.oracle.reset()
        return self._pack()

    def n_step(self, actions):
        o = self.oracle
        uid = int(actions[o.cur])
        rew, done = o.step(uid)
        obs, masks, active = self._pack()
        rews = np.full(o.P, rew, np.float32)
        return obs, masks, active, rews, bool(done)

"""Gym-interop vectorized wrappers (SB3-shaped VecEnv contract).

Counterpart of ``madrona_rl_envs_playground_tpu/api/gym_interop.py``.  The
reference exposes two single-policy gym surfaces beside its multi-agent API:

* gym ``VectorEnv`` Cartpole wrappers (``envs/cartpole_env.py:27-128``):
  ``reset() -> obs [N, 4]``, ``step(actions [N]) -> (obs, rew, done, infos)``
  with ``Box`` observation / ``Discrete(2)`` action spaces and in-step
  auto-reset;
* ``BalanceGym`` (``envs/balance_beam_env.py:46-79``): a single-agent view
  over the 2-player Balance Beam env with a random partner,
  ``MultiDiscrete`` obs / ``Discrete(4)`` action.

Here both are thin host adapters over ``DeviceVecEnv.n_step``, so on the
card each step is one replay of the env's captured step, one launch of its
step kernel (K5 for Cartpole, K7 for Balance Beam); on the CPU the plain
version steps.  ``step`` takes numpy or tensor actions and returns numpy
arrays (SB3's VecEnv contract, and JAX's) that the caller owns: on the card
each step copies its outputs to the host, and on the CPU they are views of
the step's own tensors, which no later step writes.  Spaces
come from ``gymnasium`` where it is installed, else from this package's
metadata spaces.  The auto-reset is fused in the step (the post-done
observation is the next episode's first), as in the reference sims.
"""

from __future__ import annotations

import numpy as np
import torch

try:  # gymnasium where it is installed; the metadata spaces otherwise
    from gymnasium import spaces as _spaces
except ImportError:
    from . import spaces as _spaces

from ..device import DeviceLike
from ..envs import balance_beam, cartpole
from .vectorenv import DeviceVecEnv

__all__ = ["CartpoleVecGym", "BalanceVecGym"]


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


class _VecGymBase:
    """SB3 VecEnv-shaped base: reset() -> obs; step(a) -> (obs, r, d, infos)."""

    def __init__(self, num_envs: int):
        self.num_envs = num_envs

    @property
    def infos(self):
        # fresh, DISTINCT dicts every step: SB3-style consumers write
        # per-env keys (e.g. infos[i]["terminal_observation"]); a shared
        # dict ([{}] * n) or reused list would alias those writes across
        # envs and across steps
        return [{} for _ in range(self.num_envs)]

    def close(self, **kwargs):
        pass

    def seed(self, seed=None):  # parity no-op: episode streams are counter-keyed
        return [seed] * self.num_envs

    def _actions(self, actions) -> torch.Tensor:
        """numpy or tensor actions -> int32 on the env's device."""
        if not isinstance(actions, torch.Tensor):
            actions = torch.as_tensor(np.asarray(actions))
        return actions.to(device=self.venv.device, dtype=torch.int32)


class CartpoleVecGym(_VecGymBase):
    """``CartpoleMadronaNumpy/Torch`` analog (``envs/cartpole_env.py:27-128``)."""

    def __init__(self, num_envs: int, start_episode: int = 0, device: DeviceLike = None):
        super().__init__(num_envs)
        high = np.array(
            [
                cartpole.X_THRESHOLD * 2,
                np.finfo(np.float32).max,
                cartpole.THETA_THRESHOLD * 2,
                np.finfo(np.float32).max,
            ],
            dtype=np.float32,
        )
        self.single_observation_space = _spaces.Box(-high, high, shape=high.shape,
                                                    dtype=np.float32)
        self.single_action_space = _spaces.Discrete(2)
        self.observation_space = self.single_observation_space
        self.action_space = self.single_action_space
        self.venv = DeviceVecEnv(cartpole.Env(), num_envs, start_episode=start_episode,
                                 device=device)

    def reset(self):
        return _host(self.venv.last_out.obs).reshape(self.num_envs, -1)

    def step(self, actions):
        seats, rews, done, _ = self.venv.n_step(self._actions(actions).reshape(1, self.num_envs))
        return _host(seats[0].obs), _host(rews[0]), _host(done), self.infos


class BalanceVecGym(_VecGymBase):
    """``BalanceGym`` analog: ego seat 0, partner seat driven by a provided
    policy (default: uniform-random from ``np.random.RandomState(seed)``, as
    JAX's; the reference's ``RandomVectorAgent``)."""

    def __init__(self, num_envs: int, partner_fn=None, seed: int = 0,
                 start_episode: int = 0, device: DeviceLike = None):
        super().__init__(num_envs)
        nvec = (
            [balance_beam.NUM_SPACES + 2 * balance_beam.BUFFER]
            * 2 * balance_beam.TIME
            + [balance_beam.TIME]
        )
        self.single_observation_space = _spaces.MultiDiscrete(nvec)
        self.single_action_space = _spaces.Discrete(balance_beam.NUM_MOVES)
        self.observation_space = self.single_observation_space
        self.action_space = self.single_action_space
        self._rng = np.random.RandomState(seed)
        self._partner_fn = partner_fn or (
            lambda obs: self._rng.randint(
                0, balance_beam.NUM_MOVES, size=self.num_envs
            )
        )
        self.venv = DeviceVecEnv(balance_beam.Env(), num_envs, start_episode=start_episode,
                                 device=device)

    def _ego_obs(self):
        # obs [N, 2, 7]; ego is seat 0 (BalanceGym returns obs.obs.float():
        # the ego VectorObservation)
        return _host(self.venv.last_out.obs[:, 0]).astype(np.float32)

    def reset(self):
        return self._ego_obs()

    def step(self, actions):
        partner = self._actions(self._partner_fn(self._ego_obs()))
        joint = torch.stack([self._actions(actions).reshape(-1), partner.reshape(-1)])
        _, rews, done, _ = self.venv.n_step(joint)
        return self._ego_obs(), _host(rews[0]), _host(done), self.infos

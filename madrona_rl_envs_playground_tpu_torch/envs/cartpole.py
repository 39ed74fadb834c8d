"""Cartpole batch simulator (plain PyTorch).

Counterpart of ``madrona_rl_envs_playground_tpu/envs/cartpole.py`` (reference
``src/cartpole_env/sim.cpp``): classic gym dynamics with Euler integration
(force +-10, tau 0.02), termination at |x| > 2.4 or |theta| > 12 degrees,
reward 1 every step, and a reset that re-draws all four state variables
uniformly in [-0.05, 0.05) from the TEA+LCG episode stream.  The reset
happens inside the step, so a done step already reports the new episode.

Every constant is a float32, the two thresholds included (JAX compares f32
arrays against Python floats, which act as f32 values).  The arithmetic runs
in the JAX operation order, one rounding per operation, and every division
divides by a tensor: PyTorch's CUDA division by a Python scalar multiplies by
its reciprocal, which rounds differently.  So on the card this env equals the
step kernels of ``ops/cartpole.py`` bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import rng
from ..core.base import EnvBase

X_THRESHOLD = 2.4
THETA_THRESHOLD = 12 * 2 * 3.141592653589793238463 / 360

_CONSTS = dict(gravity=9.8, masspole=0.1, total_mass=1.1, length=0.5,
               polemass_length=0.05, force_mag=10.0, tau=0.02,
               four_thirds=4.0 / 3.0, x_threshold=X_THRESHOLD,
               theta_threshold=THETA_THRESHOLD, lo=-0.05, hi=0.05)


@dataclasses.dataclass(frozen=True)
class State:
    x: torch.Tensor          # [N] f32
    x_dot: torch.Tensor      # [N] f32
    theta: torch.Tensor      # [N] f32
    theta_dot: torch.Tensor  # [N] f32
    rng_v: torch.Tensor      # [N] int64 holding the uint32 LCG word


class Env(EnvBase):
    state_is_obs = True
    masked = False

    num_agents = 1
    obs_size = 4
    state_size = 4
    num_actions = 2
    reward_dtype = torch.float32
    obs_dtype = torch.float32

    def __init__(self):
        self._consts_by_device = {}

    def _c(self, device: torch.device) -> dict:
        """The constants as float32 scalar tensors on ``device``."""
        key = str(device)
        c = self._consts_by_device.get(key)
        if c is None:
            c = {k: torch.tensor(v, dtype=torch.float32, device=device)
                 for k, v in _CONSTS.items()}
            c["range"] = c["hi"] - c["lo"]
            self._consts_by_device[key] = c
        return c

    def init_core(self, episode_idx: torch.Tensor) -> State:
        c = self._c(episode_idx.device)
        v = rng.seed(episode_idx)
        draws = []
        for _ in range(4):
            v, r = rng.uniform(v)
            draws.append(c["lo"] + r * c["range"])
        return State(x=draws[0], x_dot=draws[1], theta=draws[2],
                     theta_dot=draws[3], rng_v=v)

    def transition(self, state: State, actions: torch.Tensor):
        """actions [N, 1] -> (state', reward [N, 1] f32, done [N] bool)."""
        c = self._c(actions.device)
        th, thd = state.theta, state.theta_dot
        force = torch.where(actions[:, 0] == 1, c["force_mag"], -c["force_mag"])
        costheta = torch.cos(th)
        sintheta = torch.sin(th)

        temp = (force + c["polemass_length"] * thd * thd * sintheta) / c["total_mass"]
        thetaacc = (c["gravity"] * sintheta - costheta * temp) / (
            c["length"] * (c["four_thirds"]
                           - c["masspole"] * costheta * costheta / c["total_mass"]))
        xacc = temp - c["polemass_length"] * thetaacc * costheta / c["total_mass"]

        x = state.x + c["tau"] * state.x_dot
        x_dot = state.x_dot + c["tau"] * xacc
        theta = th + c["tau"] * thd
        theta_dot = thd + c["tau"] * thetaacc

        xt, tt = c["x_threshold"], c["theta_threshold"]
        done = (x < -xt) | (x > xt) | (theta < -tt) | (theta > tt)
        reward = torch.ones((x.shape[0], 1), dtype=torch.float32, device=x.device)
        return (State(x=x, x_dot=x_dot, theta=theta, theta_dot=theta_dot,
                      rng_v=state.rng_v), reward, done)

    def encode(self, state: State, just_reset: torch.Tensor):
        N, dev = state.x.shape[0], state.x.device
        obs = torch.stack([state.x, state.x_dot, state.theta, state.theta_dot], -1)[:, None, :]
        mask = torch.ones((N, 1, 2), dtype=torch.bool, device=dev)
        active = torch.ones((N, 1), dtype=torch.bool, device=dev)
        return state, obs, obs, mask, active

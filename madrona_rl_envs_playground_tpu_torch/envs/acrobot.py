"""Acrobot batch simulator (plain PyTorch).

Counterpart of ``madrona_rl_envs_playground_tpu/envs/acrobot.py`` (reference
``src/acrobat_env/sim.cpp``): gym Acrobot-v1 dynamics through one RK4 step
of ``_ds_dt``, torque -1, 0 or +1, both angles wrapped to [-pi, pi), the
velocities clamped to 4 pi and 9 pi, reward -1 every step, termination when
``-cos(t1) - cos(t2 + t1) > 1`` or when ``steps > 500`` (so an episode that
never reaches the height lasts 501 steps), and a reset that re-draws the four
state variables uniformly in [-0.1, 0.1) from the TEA+LCG episode stream.

Float rules, as in ``envs/cartpole.py``: every constant is a float32 tensor,
the arithmetic runs in the JAX operation order with one rounding per
operation, and every division divides by a tensor.  The Python constants
that JAX folds in double before rounding to float32 are folded the same way
here (``0.25 + (1.0 + 0.25 + c2) + 2.0`` is ``(0.25 + (1.25 + c2)) + 2.0``,
``2.0 * 0.5 * w2`` is ``w2``, ``(0.5 + 1.0) * G`` is ``f32(1.5) * f32(9.8)``,
``0.25 + 1.0 - x`` is ``1.25 - x``).  So on the card this env equals the
step kernels of ``ops/acrobot.py`` bit for bit.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core import rng
from ..core.base import EnvBase

MAX_STEPS = 500

_F32 = dict(
    quarter=0.25, half=0.5, one=1.0, two=2.0, five_quarters=1.25, neg_half=-0.5,
    g=9.8, half_pi=math.pi / 2.0, pi=math.pi, neg_pi=-math.pi,
    max_vel_1=4 * math.pi, max_vel_2=9 * math.pi, dt=0.2, six=6.0,
    lo=-0.1, hi=0.1, height=1.0)


@dataclasses.dataclass(frozen=True)
class State:
    theta1: torch.Tensor  # [N] f32
    theta2: torch.Tensor  # [N] f32
    omega1: torch.Tensor  # [N] f32
    omega2: torch.Tensor  # [N] f32
    steps: torch.Tensor   # [N] int32, steps into the episode
    rng_v: torch.Tensor   # [N] int64 holding the uint32 LCG word


def _consts(device: torch.device) -> dict:
    c = {k: torch.tensor(v, dtype=torch.float32, device=device) for k, v in _F32.items()}
    # the products and quotients JAX computes in float32
    c["half_g"] = c["half"] * c["g"]
    c["three_halves_g"] = torch.tensor(1.5, dtype=torch.float32, device=device) * c["g"]
    c["half_dt"] = c["dt"] / c["two"]
    c["sixth_dt"] = c["dt"] / c["six"]
    c["two_pi"] = c["pi"] - c["neg_pi"]
    c["range"] = c["hi"] - c["lo"]
    c["torque"] = torch.tensor([-1.0, 0.0, 1.0], dtype=torch.float32, device=device)
    return c


def _ds_dt(c, t1, t2, w1, w2, torque):
    """The dynamics "from the book" (m1 = m2 = l1 = 1, lc1 = lc2 = 0.5,
    I1 = I2 = 1), float32 in the order of JAX ``envs/acrobot._ds_dt``."""
    c2, s2 = torch.cos(t2), torch.sin(t2)
    d1 = (c["quarter"] + (c["five_quarters"] + c2)) + c["two"]
    d2 = (c["quarter"] + c["half"] * c2) + c["one"]
    phi2 = c["half_g"] * torch.cos(t1 + t2 - c["half_pi"])
    phi1 = (c["neg_half"] * w2 * w2 * s2 - w2 * w1 * s2
            + c["three_halves_g"] * torch.cos(t1 - c["half_pi"]) + phi2)
    a2 = (torque + d2 / d1 * phi1 - c["half"] * w1 * w1 * s2 - phi2) / (
        c["five_quarters"] - d2 * d2 / d1)
    a1 = -(d2 * a2 + phi1) / d1
    return (w1, w2, a1, a2)


def rk4_step(c, s, torque):
    """One RK4 step of ``_ds_dt`` over ``dt``; ``s`` is (t1, t2, w1, w2)."""
    def axpy(y, k, h):
        return tuple(yi + h * ki for yi, ki in zip(y, k))

    k1 = _ds_dt(c, *s, torque)
    k2 = _ds_dt(c, *axpy(s, k1, c["half_dt"]), torque)
    k3 = _ds_dt(c, *axpy(s, k2, c["half_dt"]), torque)
    k4 = _ds_dt(c, *axpy(s, k3, c["dt"]), torque)
    return tuple(y + c["sixth_dt"] * (a + c["two"] * b + c["two"] * q + d)
                 for y, a, b, q, d in zip(s, k1, k2, k3, k4))


class Env(EnvBase):
    state_is_obs = True
    masked = False

    num_agents = 1
    obs_size = 4
    state_size = 4
    num_actions = 3
    reward_dtype = torch.float32
    obs_dtype = torch.float32

    def __init__(self):
        self._consts_by_device = {}

    def _c(self, device: torch.device) -> dict:
        key = str(device)
        if key not in self._consts_by_device:
            self._consts_by_device[key] = _consts(device)
        return self._consts_by_device[key]

    def init_core(self, episode_idx: torch.Tensor) -> State:
        c = self._c(episode_idx.device)
        v = rng.seed(episode_idx)
        draws = []
        for _ in range(4):
            v, r = rng.uniform(v)
            draws.append(c["lo"] + r * c["range"])
        return State(theta1=draws[0], theta2=draws[1], omega1=draws[2], omega2=draws[3],
                     steps=torch.zeros_like(episode_idx, dtype=torch.int32), rng_v=v)

    def transition(self, state: State, actions: torch.Tensor):
        """actions [N, 1] -> (state', reward [N, 1] f32, done [N] bool)."""
        c = self._c(actions.device)
        torque = c["torque"][actions[:, 0].long()]
        s = (state.theta1, state.theta2, state.omega1, state.omega2)
        t1, t2, w1, w2 = rk4_step(c, s, torque)
        # jnp.remainder(x - lo, hi - lo) + lo with lo = -pi, hi = pi
        t1 = torch.remainder(t1 - c["neg_pi"], c["two_pi"]) + c["neg_pi"]
        t2 = torch.remainder(t2 - c["neg_pi"], c["two_pi"]) + c["neg_pi"]
        w1 = torch.clamp(w1, -c["max_vel_1"], c["max_vel_1"])
        w2 = torch.clamp(w2, -c["max_vel_2"], c["max_vel_2"])
        steps = state.steps + 1
        done = (-torch.cos(t1) - torch.cos(t2 + t1) > c["height"]) | (steps > MAX_STEPS)
        reward = torch.full((t1.shape[0], 1), -1.0, dtype=torch.float32, device=t1.device)
        return (State(theta1=t1, theta2=t2, omega1=w1, omega2=w2, steps=steps,
                      rng_v=state.rng_v), reward, done)

    def encode(self, state: State, just_reset: torch.Tensor):
        N, dev = state.theta1.shape[0], state.theta1.device
        obs = torch.stack([state.theta1, state.theta2, state.omega1, state.omega2],
                          -1)[:, None, :]
        mask = torch.ones((N, 1, 3), dtype=torch.bool, device=dev)
        active = torch.ones((N, 1), dtype=torch.bool, device=dev)
        return state, obs, obs, mask, active

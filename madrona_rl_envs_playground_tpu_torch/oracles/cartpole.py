"""Pure-numpy cartpole oracle for differential validation.

The port's own copy of ``madrona_rl_envs_playground_tpu/oracles/cartpole.py``,
its counterpart: the code is that file's, line for line
(``tests/test_torch_oracles.py`` compares the two).

Independent double-precision implementation of gym classic-control cartpole
dynamics — the same oracle the reference validates against
(``envs/cartpole_env.py:130-241``).  Used by tests and the example script's
``--validation`` mode; agreement tolerance is 1e-6 per transition, matching
the reference harness (``envs/cartpole_env.py:277``).
"""

from __future__ import annotations

import math

import numpy as np

GRAVITY = 9.8
MASSCART = 1.0
MASSPOLE = 0.1
TOTAL_MASS = MASSPOLE + MASSCART
LENGTH = 0.5
POLEMASS_LENGTH = MASSPOLE * LENGTH
FORCE_MAG = 10.0
TAU = 0.02
X_THRESHOLD = 2.4
THETA_THRESHOLD = 12 * 2 * math.pi / 360


def step(state, action):
    """One transition. state: array-like [x, x_dot, theta, theta_dot]."""
    x, x_dot, theta, theta_dot = (float(s) for s in state)
    force = FORCE_MAG if action == 1 else -FORCE_MAG
    cos_t, sin_t = math.cos(theta), math.sin(theta)

    temp = (force + POLEMASS_LENGTH * theta_dot**2 * sin_t) / TOTAL_MASS
    theta_acc = (GRAVITY * sin_t - cos_t * temp) / (
        LENGTH * (4.0 / 3.0 - MASSPOLE * cos_t**2 / TOTAL_MASS)
    )
    x_acc = temp - POLEMASS_LENGTH * theta_acc * cos_t / TOTAL_MASS

    nxt = np.array(
        [
            x + TAU * x_dot,
            x_dot + TAU * x_acc,
            theta + TAU * theta_dot,
            theta_dot + TAU * theta_acc,
        ],
        dtype=np.float64,
    )
    done = bool(
        nxt[0] < -X_THRESHOLD
        or nxt[0] > X_THRESHOLD
        or nxt[2] < -THETA_THRESHOLD
        or nxt[2] > THETA_THRESHOLD
    )
    return nxt, 1.0, done


def validate_step(states, actions, dones, next_states, atol=1e-6):
    """Batched differential check; returns list of mismatching env indices."""
    bad = []
    for i in range(len(dones)):
        true_next, _, true_done = step(states[i], int(actions[i]))
        if bool(true_done) != bool(dones[i]):
            bad.append(i)
            continue
        if not true_done and not np.all(np.abs(true_next - next_states[i]) < atol):
            bad.append(i)
    return bad

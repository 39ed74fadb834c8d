"""Numpy Balance Beam oracle for differential validation.

The port's own copy of ``madrona_rl_envs_playground_tpu/oracles/balance_beam.py``,
its counterpart: the code is that file's, line for line
(``tests/test_torch_oracles.py`` compares the two).

Implements the same cooperative line game as the reference's ``PantheonLine``
(``envs/balance_beam_env.py:88-152``) but with an explicit newest-first history
representation.  ``validate_step`` reconstructs the oracle state purely from
the previous observation, so arbitrary transitions can be checked without
trajectory tracking (the reference's ``unview`` trick,
``envs/balance_beam_env.py:172-177``).
"""

from __future__ import annotations

import numpy as np

NUM_SPACES = 5
TIME = 3
BUFFER = 2
SCALE = 0.2
MOVES = [-2, -1, 1, 2]


def step_from_obs(obs_pair, actions):
    """Transition from a pair of per-agent observations.

    obs_pair: int array [2, 7] — [own hist ×3, partner hist ×3, time].
    actions: [2] ints in [0, 4).
    Returns (next_obs [2,7], reward, done).
    """
    obs = np.asarray(obs_pair, dtype=np.int64)
    locs = obs[:, 0] - BUFFER
    t = int(obs[0, -1])

    locs = locs + np.array([MOVES[int(a)] for a in actions])
    t -= 1

    nxt = np.empty_like(obs)
    nxt[:, 0] = locs + BUFFER
    nxt[:, 1:TIME] = obs[:, 0 : TIME - 1]
    nxt[:, TIME] = locs[::-1] + BUFFER
    nxt[:, TIME + 1 : 2 * TIME] = obs[:, TIME : 2 * TIME - 1]
    nxt[:, -1] = t

    if locs[0] == locs[1]:
        reward = 1.0
    else:
        reward = -abs(float(locs[0] - locs[1])) * SCALE
    done = t == 0
    if np.any((locs < 0) | (locs >= NUM_SPACES)):
        done = True
        reward = -NUM_SPACES * (t + 1) * SCALE
    return nxt, np.float32(reward), done


def validate_step(prev_obs, actions, dones, next_obs, rewards, atol=1e-6):
    """Batched check; prev_obs/next_obs: [2, N, 7]; returns bad env indices."""
    prev_obs = np.asarray(prev_obs)
    next_obs = np.asarray(next_obs)
    bad = []
    for i in range(prev_obs.shape[1]):
        true_next, true_rew, true_done = step_from_obs(prev_obs[:, i], actions[:, i])
        if bool(true_done) != bool(dones[i]):
            bad.append(i)
            continue
        if not np.all(np.abs(np.float32(true_rew) - np.asarray(rewards[:, i])) < atol):
            bad.append(i)
            continue
        if not true_done and not np.array_equal(true_next, next_obs[:, i]):
            bad.append(i)
    return bad

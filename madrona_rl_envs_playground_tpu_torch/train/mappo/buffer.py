"""The shared episode buffer of MAPPO.

Counterpart of ``madrona_rl_envs_playground_tpu/train/mappo/buffer.py``
(reference ``SharedReplayBuffer``, ``train/MAPPO/utils/shared_buffer.py``):
time-major tensors, the ``insert`` (simultaneous envs: the next obs goes to
slot t + 1) and ``chooseinsert`` (turn-based: the obs goes to slot t) write
modes, ``after_update``'s carry-over of the last slot, and
``compute_returns``, GAE with masks, bad masks and an optional
value-normalizer.

The thread and agent axes are stored merged, ``M = N * A`` thread-major, as
in JAX (every consumer flattens them), and scalar fields drop the
reference's trailing 1.  The rnn states are ``[T+1, M, L, H]``, written at
slot t + 1 by both inserts, as the reference's; a feed-forward run keeps
width-1 placeholders, as JAX does.  The obs are stored in the env's own dtype (int8 for Overcooked): the network bases cast to float32 at
their input.  Unlike the JAX pytree, the functions here write into the
buffer in place and return it.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch

from ...device import DeviceLike, resolve_device
from .valuenorm import ValueNormState, vn_denormalize


@dataclasses.dataclass
class MAPPOBuffer:
    share_obs: torch.Tensor          # [T+1, M, S]  (M = N * A, thread-major)
    obs: torch.Tensor                # [T+1, M, O]
    rnn_states: torch.Tensor         # [T+1, M, L, H]
    rnn_states_critic: torch.Tensor  # [T+1, M, L, H]
    value_preds: torch.Tensor        # [T+1, M]
    returns: torch.Tensor            # [T+1, M]
    available_actions: torch.Tensor  # [T+1, M, Act] bool
    actions: torch.Tensor            # [T, M] int32
    action_log_probs: torch.Tensor   # [T, M]
    rewards: torch.Tensor            # [T, M]
    masks: torch.Tensor              # [T+1, M]  (0: an episode ended before t)
    bad_masks: torch.Tensor          # [T+1, M]
    active_masks: torch.Tensor       # [T+1, M]


def init_buffer(episode_length: int, n_rollout_threads: int, num_agents: int,
                obs_size: int, share_obs_size: int, num_actions: int,
                recurrent_N: int = 1, hidden_size: int = 1,
                obs_dtype=torch.float32, device: DeviceLike = None) -> MAPPOBuffer:
    dev = resolve_device(device)
    T, M = episode_length, n_rollout_threads * num_agents
    L, H = recurrent_N, hidden_size

    def z(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def ones(shape, dtype=torch.float32):
        return torch.ones(shape, dtype=dtype, device=dev)

    return MAPPOBuffer(
        share_obs=z((T + 1, M, share_obs_size), obs_dtype),
        obs=z((T + 1, M, obs_size), obs_dtype),
        rnn_states=z((T + 1, M, L, H)),
        rnn_states_critic=z((T + 1, M, L, H)),
        value_preds=z((T + 1, M)),
        returns=z((T + 1, M)),
        available_actions=ones((T + 1, M, num_actions), torch.bool),
        actions=z((T, M), torch.int32),
        action_log_probs=z((T, M)),
        rewards=z((T, M)),
        masks=ones((T + 1, M)),
        bad_masks=ones((T + 1, M)),
        active_masks=ones((T + 1, M)),
    )


def _write(buf: MAPPOBuffer, obs_slot: int, step: int, share_obs, obs, rnn_states,
           rnn_states_critic, actions, action_log_probs, value_preds, rewards, masks,
           bad_masks, active_masks, available_actions) -> MAPPOBuffer:
    buf.share_obs[obs_slot] = share_obs
    buf.obs[obs_slot] = obs
    buf.rnn_states[step + 1] = rnn_states
    buf.rnn_states_critic[step + 1] = rnn_states_critic
    buf.actions[step] = actions
    buf.action_log_probs[step] = action_log_probs
    buf.value_preds[step] = value_preds
    buf.rewards[step] = rewards
    buf.masks[step + 1] = masks
    if bad_masks is not None:
        buf.bad_masks[step + 1] = bad_masks
    if active_masks is not None:
        buf.active_masks[obs_slot] = active_masks
    if available_actions is not None:
        buf.available_actions[obs_slot] = available_actions
    return buf


def insert(buf: MAPPOBuffer, step: int, share_obs, obs, rnn_states, rnn_states_critic,
           actions, action_log_probs, value_preds, rewards, masks, bad_masks=None,
           active_masks=None, available_actions=None) -> MAPPOBuffer:
    """Simultaneous-env insert (reference ``shared_buffer.py:80-114``): the
    obs, rnn states, active flags and legal moves land at slot t + 1.  Slot
    values are ``[M, ...]``."""
    return _write(buf, step + 1, step, share_obs, obs, rnn_states, rnn_states_critic, actions,
                  action_log_probs, value_preds, rewards, masks, bad_masks, active_masks,
                  available_actions)


def chooseinsert(buf: MAPPOBuffer, step: int, share_obs, obs, rnn_states, rnn_states_critic,
                 actions, action_log_probs, value_preds, rewards, masks, bad_masks=None,
                 active_masks=None, available_actions=None) -> MAPPOBuffer:
    """Turn-based insert (reference ``shared_buffer.py:116-148``): the
    current obs, active flags and legal moves land at slot t, the rnn states
    and masks at t + 1."""
    return _write(buf, step, step, share_obs, obs, rnn_states, rnn_states_critic, actions,
                  action_log_probs, value_preds, rewards, masks, bad_masks, active_masks,
                  available_actions)


def after_update(buf: MAPPOBuffer) -> MAPPOBuffer:
    """Copy the last slot to slot 0 (reference ``:150-163``)."""
    for f in ("share_obs", "obs", "rnn_states", "rnn_states_critic", "masks", "bad_masks",
              "active_masks", "available_actions"):
        t = getattr(buf, f)
        t[0] = t[-1]
    return buf


def returns_scan(rewards: torch.Tensor, vp: torch.Tensor, masks: torch.Tensor,
                 bad: torch.Tensor, next_value: torch.Tensor, gamma: float, gae_lambda: float,
                 use_gae: bool = True, use_proper_time_limits: bool = False) -> torch.Tensor:
    """``compute_returns``' reverse loop over T: the returns ``[T, M]`` of
    slots 0..T-1 from the rewards ``[T, M]``, the (denormalized) value
    predictions, masks and bad masks ``[T+1, M]`` and the bootstrap value
    ``[M]``.  The runner replays it from a CUDA graph on the card."""
    T = rewards.shape[0]
    returns = torch.empty_like(rewards)
    if use_gae:
        gae = torch.zeros_like(next_value)
        for t in range(T - 1, -1, -1):
            delta = rewards[t] + gamma * vp[t + 1] * masks[t + 1] - vp[t]
            gae = delta + gamma * gae_lambda * masks[t + 1] * gae
            if use_proper_time_limits:
                gae = gae * bad[t + 1]
            returns[t] = gae + vp[t]
    else:
        ret = next_value
        for t in range(T - 1, -1, -1):
            ret = ret * gamma * masks[t + 1] + rewards[t]
            if use_proper_time_limits:
                ret = ret * bad[t + 1] + (1.0 - bad[t + 1]) * vp[t]
            returns[t] = ret
    return returns


def compute_returns(buf: MAPPOBuffer, next_value: torch.Tensor,
                    vn_state: Optional[ValueNormState], gamma: float, gae_lambda: float,
                    use_gae: bool = True, use_proper_time_limits: bool = False,
                    scan: Optional[Callable] = None) -> MAPPOBuffer:
    """GAE over the episode buffer (reference ``shared_buffer.py:176-233``),
    a reverse loop over T (``returns_scan``, or ``scan``, a callable of its
    first five arguments that computes the same); writes ``value_preds[T]``
    and ``returns``."""
    buf.value_preds[-1] = next_value
    # the denormalized predictions, once for the whole [T+1, M] buffer
    vp = buf.value_preds if vn_state is None else vn_denormalize(vn_state, buf.value_preds)
    if scan is None:
        scan = functools.partial(returns_scan, gamma=gamma, gae_lambda=gae_lambda,
                                 use_gae=use_gae, use_proper_time_limits=use_proper_time_limits)
    buf.returns[:-1] = scan(buf.rewards, vp, buf.masks, buf.bad_masks, next_value)
    if not use_gae:
        buf.returns[-1] = next_value
    return buf

"""The port's masked self-play path against the JAX package, on Hanabi.

Both sides run float32 on the CPU with the same parameters (flax params
loaded into the torch modules) and the same inputs from numpy seeds.
Integer and bool buffers (obs, state obs, masks, active flags, actions,
rewards, dones) compare exactly.  Tolerances: log-probs, values, the credit
routing and the active-masked GAE ``atol 1e-5`` (float32; the two frameworks
reduce in other orders); the PPO update as ``tests/test_torch_train.py``
states it (``rtol 1e-4`` on the losses and the parameter deltas), with every
loss term also within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_rl_envs_playground_tpu.envs import hanabi as jh
from madrona_rl_envs_playground_tpu.train import cleanrl_ppo as j_ppo
from madrona_rl_envs_playground_tpu.train import selfplay as j_selfplay
from madrona_rl_envs_playground_tpu_torch.core.batch import batched_reset, batched_step
from madrona_rl_envs_playground_tpu_torch.envs import hanabi as th
from madrona_rl_envs_playground_tpu_torch.models.cleanrl import load_flax_params
from madrona_rl_envs_playground_tpu_torch.train import cleanrl_ppo as t_ppo
from madrona_rl_envs_playground_tpu_torch.train import selfplay as t_selfplay

from .test_torch_hanabi import J_RESET, THREE_PLAYERS, legal_actions
from .test_torch_train import _np_params, assert_update_matches_jax, jax_rollout_injected

F32 = dict(atol=1e-5, rtol=0)
N, T = 4, 16


def _random_streams(seed, T_=19, M=23):
    rs = np.random.RandomState(seed)
    rew = rs.randn(T_, M).astype(np.float32)
    active = rs.rand(T_, M) < 0.5
    dones = rs.rand(T_, M) < 0.15
    vals = rs.randn(T_, M).astype(np.float32)
    return rs, rew, active, dones, vals


def test_credit_rewards_matches_jax():
    _, rew, active, dones, _ = _random_streams(1)
    j_c, j_sd = j_selfplay.credit_rewards(jnp.asarray(rew), jnp.asarray(active),
                                          jnp.asarray(dones))
    t_c, t_sd = t_selfplay.credit_rewards(torch.from_numpy(rew), torch.from_numpy(active),
                                          torch.from_numpy(dones))
    np.testing.assert_allclose(t_c.numpy(), np.asarray(j_c), **F32)
    np.testing.assert_array_equal(t_sd.numpy(), np.asarray(j_sd))
    # rewards after a done and before the seat's next action are dropped
    assert float(np.abs(t_c.numpy()).sum()) < float(np.abs(rew).sum())


def _buffers(rew, active, dones, vals, torch_side):
    conv = torch.from_numpy if torch_side else jnp.asarray
    cls = t_ppo.Rollout if torch_side else j_ppo.Rollout
    return cls(obs=None, states=None, actions=None, action_masks=None, logprobs=None,
               rewards=conv(rew), dones=conv(dones), active=conv(active), values=conv(vals))


@pytest.mark.parametrize("final_all_active", [False, True])
def test_active_masked_gae_matches_jax(final_all_active):
    rs, rew, active, dones, vals = _random_streams(2)
    M = rew.shape[1]
    nv = rs.randn(M).astype(np.float32)
    nd = rs.rand(M) < 0.2
    fa = np.ones(M, bool) if final_all_active else rs.rand(M) < 0.5
    j_out = j_ppo.active_masked_gae(_buffers(rew, active, dones, vals, False), jnp.asarray(nv),
                                    jnp.asarray(nd), jnp.asarray(fa), 0.99, 0.95)
    t_out = t_ppo.active_masked_gae(_buffers(rew, active, dones, vals, True),
                                    torch.from_numpy(nv), torch.from_numpy(nd),
                                    torch.from_numpy(fa), 0.99, 0.95)
    np.testing.assert_allclose(t_out[0].numpy(), np.asarray(j_out[0]), **F32)
    np.testing.assert_allclose(t_out[1].numpy(), np.asarray(j_out[1]), **F32)
    np.testing.assert_array_equal(t_out[2].numpy(), np.asarray(j_out[2]))
    # first active slots (from the end) train only once every stream has been active
    assert t_out[2].sum() < active.sum() or final_all_active


def test_plain_gae_equals_masked_gae_all_active():
    """plain_gae is the all-active case of active_masked_gae (the port of
    the JAX test of the same name, at its tolerance)."""
    rs = np.random.RandomState(3)
    T_, M = 17, 33
    rew = rs.randn(T_, M).astype(np.float32)
    dones = rs.rand(T_, M) < 0.15
    vals = rs.randn(T_, M).astype(np.float32)
    nv = torch.from_numpy(rs.randn(M).astype(np.float32))
    nd = torch.from_numpy(rs.rand(M) < 0.3)
    ones = np.ones((T_, M), bool)
    adv_m, ret_m, act = t_ppo.active_masked_gae(_buffers(rew, ones, dones, vals, True), nv, nd,
                                                torch.ones(M, dtype=torch.bool), 0.99, 0.95)
    adv_p, ret_p = t_ppo.plain_gae(torch.from_numpy(rew), torch.from_numpy(dones),
                                   torch.from_numpy(vals), nv, nd, 0.99, 0.95)
    assert bool(act.all())
    np.testing.assert_allclose(adv_p.numpy(), adv_m.numpy(), rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(ret_p.numpy(), ret_m.numpy(), rtol=2e-5, atol=2e-6)


def _trainers(**overrides):
    common = dict(num_steps=T, hidden=32, num_layers=1, update_epochs=2, num_minibatches=2,
                  lr=1e-3)
    common.update(overrides)
    cfg = jh.CONFIGS["very_small"]
    # the JAX trainer's reset, jitted: eagerly it compiles op by op (~15 s)
    real = j_selfplay.batched_reset
    j_selfplay.batched_reset = lambda env, n, start=0: J_RESET(env, n, start)
    try:
        jt = j_selfplay.SelfPlayPPO(jh.Env(**cfg), N, j_selfplay.SelfPlayConfig(
            rollout_backend="jnp", **common), seed=0)
    finally:
        j_selfplay.batched_reset = real
    tt = t_selfplay.SelfPlayPPO(th.Env(**cfg), N, t_selfplay.SelfPlayConfig(**common), seed=0,
                                device="cpu")
    load_flax_params(tt.net, _np_params(jt.state["params"]))
    return jt, tt


def _legal_schedule():
    """[T, N, P] actions, each legal for its seat's mask at its step (the
    inactive seats' too, so every stored log-prob is finite), from the plain
    env that both trainers start from."""
    env = th.Env(**th.CONFIGS["very_small"])
    bstate, out = batched_reset(env, N, device="cpu")
    rs = np.random.RandomState(6)
    acts = []
    for _ in range(T):
        a = legal_actions(rs, out.action_mask.numpy())
        bstate, out = batched_step(env, bstate, torch.from_numpy(a))
        acts.append(a)
    return np.stack(acts)


@pytest.fixture(scope="module")
def jax_rollout():
    """The JAX rollout with injected legal actions: (actions, bstate, out,
    trajectory)."""
    jt, _ = _trainers()
    acts = _legal_schedule()
    return (acts,) + jax_rollout_injected(jt, acts)


def test_rollout_matches_jax_with_injected_actions(jax_rollout):
    acts, j_bstate, j_out, j_tr = jax_rollout
    _, tt = _trainers()
    assert tt._fused.kernel  # 2 players: through the K3 collector
    t_bstate, t_out, t_tr = tt._rollout(torch.from_numpy(acts))
    for k in ("obs", "state_obs", "mask", "active", "action", "reward", "done"):
        got, ref = t_tr[k].numpy(), np.asarray(j_tr[k])
        assert got.dtype == ref.dtype and got.shape == ref.shape, (k, got.dtype, ref.dtype)
        np.testing.assert_array_equal(got, ref, err_msg=k)
    for k in ("logp", "value"):
        np.testing.assert_allclose(t_tr[k].numpy(), np.asarray(j_tr[k]), err_msg=k, **F32)
    assert np.asarray(j_tr["done"]).any() and np.asarray(j_tr["reward"]).any()
    for f in ("obs", "state_obs", "action_mask", "active", "done"):
        np.testing.assert_array_equal(getattr(t_out, f).numpy(), np.asarray(getattr(j_out, f)))
    assert int(t_bstate.episode_counter) == int(j_bstate.episode_counter)
    np.testing.assert_array_equal(t_bstate.env_states.deck.numpy(),
                                  np.asarray(j_bstate.env_states.deck))


@pytest.mark.parametrize("value_loss", ["clipped_mse", "smooth_l1"])
def test_one_update_matches_jax(value_loss, jax_rollout):
    """One PPO update on the JAX trajectory: the credit routing, the
    active-masked GAE, the active-masked advantage normalisation, every
    loss term and the parameters."""
    _, _, j_out, j_tr = jax_rollout
    jt, tt = _trainers(value_loss=value_loss)
    assert_update_matches_jax(jt, tt, j_tr, j_out, loss_abs=1e-5)


@pytest.mark.parametrize("cfg,has_kernel", [(th.CONFIGS["small"], True), (THREE_PLAYERS, False)])
def test_trainer_picks_the_collector_by_player_count(cfg, has_kernel):
    """Two players step through K3's collector, three through the plain env,
    as in JAX; both train."""
    scfg = t_selfplay.SelfPlayConfig(num_steps=4, hidden=8, num_layers=1, num_minibatches=2)
    tr = t_selfplay.SelfPlayPPO(th.Env(**cfg), 3, scfg, seed=1, device="cpu")
    assert tr._fused.kernel == has_kernel
    for _ in range(2):
        m = tr.train_step()
    assert all(torch.isfinite(v) for v in m.values())

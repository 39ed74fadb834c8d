"""The port's MAPPO (nets, ValueNorm/PopArt, buffer, trainer, runner)
against the JAX package.

Both sides run float32 on the CPU with the same parameters (the flax trees
loaded into the torch modules by ``load_mappo_params``) and the same inputs
from numpy seeds.  Tolerances: network outputs, returns and ValueNorm
statistics ``atol 1e-5`` (float32; the frameworks reduce in other orders,
and flax's LayerNorm takes the variance as E[x^2] - E[x]^2 where PyTorch
takes it in two passes); one ``train`` ``rtol 1e-4`` on its losses and
``rtol 1e-4, atol 1e-6`` on every parameter delta (the backward passes sum
gradients in other orders, Adam divides by ``sqrt(nu) + eps``).  Integer and boolean fields (actions,
masks, dones, int8 obs) are compared exactly; Acrobot's float obs at
``atol 1e-5`` over its 8 steps (XLA's and PyTorch's CPU sin/cos round the
last bit differently).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_rl_envs_playground_tpu.envs import acrobot as j_acrobot
from madrona_rl_envs_playground_tpu.envs import overcooked2 as j_oc2
from madrona_rl_envs_playground_tpu.models import mappo_nets as j_nets
from madrona_rl_envs_playground_tpu.train import mappo as jm
from madrona_rl_envs_playground_tpu.train.mappo import policy as j_policy_mod
from madrona_rl_envs_playground_tpu_torch.envs import acrobot as t_acrobot
from madrona_rl_envs_playground_tpu_torch.envs import balance_beam as t_balance
from madrona_rl_envs_playground_tpu_torch.envs import overcooked2 as t_oc2
from madrona_rl_envs_playground_tpu_torch.models import common as t_common
from madrona_rl_envs_playground_tpu_torch.models import mappo_nets as t_nets
from madrona_rl_envs_playground_tpu_torch.train import mappo as tm

CPU = torch.device("cpu")
F32 = dict(rtol=0, atol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().cpu().numpy(), np.asarray(j), **(tol or F32))


def _t_vn(s) -> tm.ValueNormState:
    return tm.ValueNormState(*(torch.tensor(float(np.asarray(getattr(s, f))))
                               for f in ("running_mean", "running_mean_sq", "debiasing_term")))


def _assert_vn(t_vn, j_vn, **tol):
    for f in ("running_mean", "running_mean_sq", "debiasing_term"):
        _close(getattr(t_vn, f), getattr(j_vn, f), **(tol or dict(rtol=1e-5, atol=1e-7)))


# ---- ValueNorm and PopArt ---------------------------------------------------

@pytest.mark.parametrize("per_element", [False, True])
def test_valuenorm_matches_jax_and_reference_ema(per_element):
    rng = np.random.RandomState(0)
    t_s, j_s = tm.init_valuenorm(CPU), jm.init_valuenorm()
    beta = 0.99999 if not per_element else 0.9999
    rm = rm_sq = db = 0.0
    for _ in range(5):
        x = rng.randn(64).astype(np.float32) * 3 + 1
        t_s = tm.vn_update(t_s, torch.from_numpy(x), beta=beta, per_element_update=per_element)
        j_s = jm.vn_update(j_s, jnp.asarray(x), beta=beta, per_element_update=per_element)
        w = beta ** x.size if per_element else beta
        rm = rm * w + x.mean() * (1 - w)
        rm_sq = rm_sq * w + (x ** 2).mean() * (1 - w)
        db = db * w + (1 - w)
        _assert_vn(t_s, j_s)
    mean = rm / max(db, 1e-5)
    var = max(rm_sq / max(db, 1e-5) - mean ** 2, 1e-2)
    y = rng.randn(16).astype(np.float32)
    for t_fn, j_fn, oracle in ((tm.vn_normalize, jm.vn_normalize, (y - mean) / np.sqrt(var)),
                               (tm.vn_denormalize, jm.vn_denormalize, y * np.sqrt(var) + mean)):
        got = t_fn(t_s, torch.from_numpy(y))
        _close(got, j_fn(j_s, jnp.asarray(y)), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-4, atol=1e-5)


def test_popart_matches_jax_and_preserves_outputs():
    rng = np.random.RandomState(1)
    kernel = rng.randn(8).astype(np.float32)
    bias = np.float32(0.3)
    x_in = rng.randn(4, 8).astype(np.float32)
    batch = rng.randn(32).astype(np.float32) * 5 + 2
    s0 = tm.vn_update(tm.init_valuenorm(CPU), torch.from_numpy(rng.randn(50).astype(np.float32)),
                      beta=0.9)
    j_s0 = jm.ValueNormState(**{f: jnp.float32(float(getattr(s0, f)))
                                for f in ("running_mean", "running_mean_sq", "debiasing_term")})
    k2, b2, s2 = tm.popart_update(torch.from_numpy(kernel), torch.tensor(bias), s0,
                                  torch.from_numpy(batch), beta=0.9)
    jk2, jb2, js2 = jm.popart_update(jnp.asarray(kernel), jnp.float32(bias), j_s0,
                                     jnp.asarray(batch), beta=0.9)
    _close(k2, jk2, rtol=1e-5, atol=1e-6)
    _close(b2, jb2, rtol=1e-5, atol=1e-6)
    _assert_vn(s2, js2)
    x = torch.from_numpy(x_in)
    before = tm.vn_denormalize(s0, x @ torch.from_numpy(kernel) + torch.tensor(bias))
    after = tm.vn_denormalize(s2, x @ k2 + b2)
    torch.testing.assert_close(after, before, rtol=1e-4, atol=1e-4)


# ---- buffer -------------------------------------------------------------------

T, N, A, OBS, SOBS, ACT = 6, 4, 2, 5, 7, 3
M = N * A


def _buffers():
    j_buf = jm.init_buffer(T, N, A, OBS, SOBS, ACT, 1, 1)
    t_buf = tm.init_buffer(T, N, A, OBS, SOBS, ACT, device=CPU)
    return j_buf, t_buf


def _assert_buf(t_buf, j_buf, **tol):
    for f in dataclasses.fields(t_buf):
        got, ref = getattr(t_buf, f.name), np.asarray(getattr(j_buf, f.name))
        assert got.shape == ref.shape, f.name
        if got.dtype.is_floating_point:
            np.testing.assert_allclose(got.numpy(), ref, **(tol or F32), err_msg=f.name)
        else:
            np.testing.assert_array_equal(got.numpy(), ref, err_msg=f.name)


def _slot_values(rs):
    return dict(
        share_obs=rs.randn(M, SOBS).astype(np.float32), obs=rs.randn(M, OBS).astype(np.float32),
        rnn_states=rs.randn(M, 1, 1).astype(np.float32),
        rnn_states_critic=rs.randn(M, 1, 1).astype(np.float32),
        actions=rs.randint(0, ACT, M).astype(np.int32),
        action_log_probs=rs.randn(M).astype(np.float32),
        value_preds=rs.randn(M).astype(np.float32), rewards=rs.randn(M).astype(np.float32),
        masks=(rs.rand(M) > 0.3).astype(np.float32), bad_masks=(rs.rand(M) > 0.3).astype(np.float32),
        active_masks=(rs.rand(M) > 0.3).astype(np.float32),
        available_actions=rs.rand(M, ACT) > 0.3)


@pytest.mark.parametrize("mode", ["insert", "chooseinsert"])
def test_insert_and_after_update_match_jax(mode):
    rs = np.random.RandomState(2)
    j_buf, t_buf = _buffers()
    for step in range(T):
        v = _slot_values(rs)
        j_buf = getattr(jm, mode)(j_buf, step, **{k: jnp.asarray(x) for k, x in v.items()})
        t_buf = getattr(tm, mode)(t_buf, step, **{k: torch.from_numpy(x) for k, x in v.items()})
    _assert_buf(t_buf, j_buf, rtol=0, atol=0)
    _assert_buf(tm.after_update(t_buf), jm.after_update(j_buf), rtol=0, atol=0)


@pytest.mark.parametrize("use_gae", [True, False])
@pytest.mark.parametrize("with_vn", [False, True])
@pytest.mark.parametrize("proper_time_limits", [False, True])
def test_compute_returns_matches_jax(use_gae, with_vn, proper_time_limits):
    rs = np.random.RandomState(3)
    j_buf, t_buf = _buffers()
    rew = rs.randn(T, M).astype(np.float32)
    vp = rs.randn(T + 1, M).astype(np.float32)
    masks = (rs.rand(T + 1, M) > 0.2).astype(np.float32)
    bad = (rs.rand(T + 1, M) > 0.2).astype(np.float32)
    nv = rs.randn(M).astype(np.float32)
    j_buf = j_buf.replace(rewards=jnp.asarray(rew), value_preds=jnp.asarray(vp),
                          masks=jnp.asarray(masks), bad_masks=jnp.asarray(bad))
    for f, x in (("rewards", rew), ("value_preds", vp), ("masks", masks), ("bad_masks", bad)):
        getattr(t_buf, f).copy_(torch.from_numpy(x))
    j_vn = t_vn = None
    if with_vn:
        j_vn = jm.vn_update(jm.init_valuenorm(), jnp.asarray(rs.randn(100) * 2 + 3), beta=0.9)
        t_vn = _t_vn(j_vn)
    j_out = jm.compute_returns(j_buf, jnp.asarray(nv), j_vn, 0.99, 0.95, use_gae,
                               proper_time_limits)
    t_out = tm.compute_returns(t_buf, torch.from_numpy(nv), t_vn, 0.99, 0.95, use_gae,
                               proper_time_limits)
    _close(t_out.value_preds, j_out.value_preds, rtol=0, atol=0)
    _close(t_out.returns, j_out.returns, rtol=1e-5, atol=1e-5)


# ---- networks -----------------------------------------------------------------

@pytest.mark.parametrize("layer_n,relu,feature_norm,masked", [
    (1, True, True, True), (2, False, False, True), (1, False, True, False),
    (2, True, False, False)])
def test_networks_match_flax(layer_n, relu, feature_norm, masked):
    F, S, A_, B = 11, 13, 5, 17
    mc = j_nets.ModelConfig(hidden_size=16, layer_N=layer_n, use_relu=relu,
                            use_feature_normalization=feature_norm)
    tc = t_nets.ModelConfig(**{f.name: getattr(mc, f.name)
                               for f in dataclasses.fields(t_nets.ModelConfig)})
    j_actor, j_critic = j_nets.R_Actor(mc, (F,), A_), j_nets.R_Critic(mc, (S,))
    rnn, msk = jnp.zeros((1, 1, 16)), jnp.ones((1,))
    ap = j_actor.init(jax.random.PRNGKey(0), jnp.zeros((1, F)), rnn, msk)
    cp = j_critic.init(jax.random.PRNGKey(1), jnp.zeros((1, S)), rnn, msk)
    # perturb the LayerNorm scales and biases so the copy of each is checked
    rs = np.random.RandomState(4)
    ap, cp = (jax.tree_util.tree_map(lambda x: np.asarray(x) + 0.1 * rs.randn(*x.shape), p)
              for p in (ap, cp))
    t_actor, t_critic = t_nets.R_Actor(tc, (F,), A_), t_nets.R_Critic(tc, (S,))
    t_nets.load_mappo_params(t_actor, t_critic, ap, cp)
    obs = rs.randint(-2, 3, size=(B, F)).astype(np.int8)
    sobs = rs.randn(B, S).astype(np.float32)
    avail = rs.rand(B, A_) > 0.4 if masked else None
    if masked:
        avail[:, 1] = True
    j_logits, _ = j_actor.apply(ap, jnp.asarray(obs), rnn, msk,
                                None if avail is None else jnp.asarray(avail))
    j_values, _ = j_critic.apply(cp, jnp.asarray(sobs), rnn, msk)
    t_logits, t_h = t_actor(torch.from_numpy(obs), t_actor.zero_states(B), torch.ones(B),
                            None if avail is None else torch.from_numpy(avail))
    t_values, _ = t_critic(torch.from_numpy(sobs), t_critic.zero_states(B), torch.ones(B))
    assert tuple(t_h.shape) == (B, 1, 1) and not t_h.any()  # placeholders pass through
    _close(t_logits, j_logits, rtol=1e-5, atol=1e-5)
    _close(t_values, j_values)
    if masked:
        assert (t_logits.detach().numpy()[~avail] == -1e10).all()
    acts = np.where(avail[np.arange(B), 1], 1, 0) if masked else rs.randint(0, A_, B)
    _close(t_common.dist_entropy(t_logits), j_policy_mod.dist_entropy(j_logits))
    _close(t_common.dist_log_prob(t_logits, torch.from_numpy(acts.astype(np.int32))),
           j_policy_mod.dist_log_prob(j_logits, jnp.asarray(acts.astype(np.int32))))


def test_init_layernorm_eps_and_critic_head():
    mc = t_nets.ModelConfig(hidden_size=16, layer_N=1)
    critic = t_nets.R_Critic(mc, (6,))
    norms = [m for m in critic.modules() if isinstance(m, torch.nn.LayerNorm)]
    assert norms and all(n.eps == 1e-6 for n in norms)
    head = t_nets.get_critic_head(critic)
    assert head is critic.v_out and head.out_features == 1
    # orthogonal init: gain 1.0 on the value head, zero biases
    w = head.weight.detach()
    torch.testing.assert_close(w.norm(), torch.tensor(1.0), rtol=1e-5, atol=1e-6)
    assert all(float(lin.bias.detach().abs().max()) == 0 for lin in critic.base.layers)
    del critic.v_out
    with pytest.raises(KeyError):
        t_nets.get_critic_head(critic)
    # the recurrent and CNN nets build: a GRU and its LayerNorm (flax's eps
    # too), a 3x3 conv of hidden // 2 channels over a [W, H, C] grid
    rec = t_nets.ModelConfig(hidden_size=16, use_recurrent_policy=True, recurrent_N=2)
    critic = t_nets.R_Critic(rec, (6,))
    assert len(critic.rnn.cells) == 2 and critic.rnn.norm.eps == 1e-6
    assert float(critic.rnn.cells[0].input.bias.detach().abs().max()) == 0
    actor = t_nets.R_Actor(t_nets.ModelConfig(hidden_size=16, layer_N=1), (5, 4, 3), 6)
    assert isinstance(actor.base, t_nets.CNNBase) and actor.rnn is None
    assert tuple(actor.base.conv.weight.shape) == (8, 3, 3, 3)
    logits, _ = actor(torch.zeros(2, 60), actor.zero_states(2), torch.ones(2))
    assert tuple(logits.shape) == (2, 6)


# ---- one update -----------------------------------------------------------------

def _cfg_kwargs(**kw):
    base = dict(episode_length=T, n_rollout_threads=N, hidden_size=16, layer_N=1, ppo_epoch=2,
                num_mini_batch=1, lr=1e-3, critic_lr=2e-3, seed=0)
    base.update(kw)
    return base


def _policies(**kw):
    j_cfg = jm.MAPPOConfig(**_cfg_kwargs(**kw))
    t_cfg = tm.MAPPOConfig(**_cfg_kwargs(**kw))
    j_pol = jm.MAPPOPolicy(j_cfg, (OBS,), (SOBS,), ACT, seed=0)
    j_tr = jm.RMAPPOTrainer(j_cfg, j_pol)
    t_pol = tm.MAPPOPolicy(t_cfg, (OBS,), (SOBS,), ACT, seed=0, device=CPU)
    t_tr = tm.RMAPPOTrainer(t_cfg, t_pol)
    ps = j_tr.state.policy
    t_nets.load_mappo_params(t_pol.actor, t_pol.critic, _np(ps.actor_params),
                             _np(ps.critic_params))
    return j_tr, t_tr


def _filled_buffers(j_tr):
    """A JAX and a port buffer with the same random episode, whose old
    log-probs are the JAX actor's (so the ratios start near 1) and whose
    value statistics have been updated once."""
    rs = np.random.RandomState(5)
    j_buf, t_buf = _buffers()
    avail = rs.rand(T + 1, M, ACT) > 0.3
    avail[..., 0] = True
    acts = np.where(avail[:-1][..., 2], 2, 0).astype(np.int32)
    obs = rs.randn(T + 1, M, OBS).astype(np.float32)
    sobs = rs.randn(T + 1, M, SOBS).astype(np.float32)
    ps = j_tr.state.policy
    logits, _ = j_tr.policy.actor.apply(ps.actor_params, jnp.asarray(obs[:-1]),
                                        jnp.zeros((T, M, 1, 1)), jnp.ones((T, M)),
                                        jnp.asarray(avail[:-1]))
    logp = np.asarray(j_policy_mod.dist_log_prob(logits, jnp.asarray(acts)))
    v = dict(share_obs=sobs, obs=obs, available_actions=avail, actions=acts,
             action_log_probs=logp + 0.05 * rs.randn(T, M).astype(np.float32),
             value_preds=rs.randn(T + 1, M).astype(np.float32),
             returns=(rs.randn(T + 1, M) * 2 + 1).astype(np.float32),
             masks=(rs.rand(T + 1, M) > 0.1).astype(np.float32),
             active_masks=(rs.rand(T + 1, M) > 0.2).astype(np.float32))
    j_buf = j_buf.replace(**{k: jnp.asarray(x) for k, x in v.items()})
    for k, x in v.items():
        getattr(t_buf, k).copy_(torch.from_numpy(x))
    return j_buf, t_buf


def _params_of(t_pol):
    return [{k: p.detach().clone() for k, p in m.named_parameters()}
            for m in (t_pol.actor, t_pol.critic)]


def _modules_from(t_pol, policy_state):
    """Fresh port modules holding a JAX policy state's parameters."""
    actor = t_nets.R_Actor(t_pol.mc, t_pol.obs_shape, ACT)
    critic = t_nets.R_Critic(t_pol.mc, t_pol.share_obs_shape)
    t_nets.load_mappo_params(actor, critic, _np(policy_state.actor_params),
                             _np(policy_state.critic_params))
    return actor, critic


def _assert_update_matches(t_pol, j_state0, j_state1, before):
    """Every parameter delta of the port's update against JAX's."""
    j0, j1 = _modules_from(t_pol, j_state0.policy), _modules_from(t_pol, j_state1.policy)
    for ours, b, m0, m1 in zip((t_pol.actor, t_pol.critic), before, j0, j1):
        for (name, p), p0, p1 in zip(ours.named_parameters(), m0.parameters(), m1.parameters()):
            # the deltas are lr-sized (1e-3 a step); the parameters are O(1),
            # so a float32 difference of two of them carries ~1e-7 already
            np.testing.assert_allclose((p.detach() - b[name]).numpy(),
                                       (p1 - p0).detach().numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=name)


@pytest.mark.parametrize("norm", ["valuenorm", "popart", "none"])
def test_one_train_matches_jax(norm):
    """One ``train`` at one minibatch: the info, the ValueNorm statistics
    and every parameter delta, with ValueNorm, PopArt or neither."""
    kw = dict(use_valuenorm=norm == "valuenorm", use_popart=norm == "popart")
    j_tr, t_tr = _policies(**kw)
    j_buf, t_buf = _filled_buffers(j_tr)
    if norm != "none":  # start from non-trivial statistics
        x = np.random.RandomState(6).randn(40).astype(np.float32) * 3 + 2
        j_tr.state = j_tr.state.replace(vn=jm.vn_update(j_tr.state.vn, jnp.asarray(x)))
        t_tr.vn = tm.vn_update(t_tr.vn, torch.from_numpy(x))
    before = _params_of(t_tr.policy)
    j_state0 = j_tr.state
    j_state1, j_info = j_tr.train(j_state0, j_buf, jax.random.PRNGKey(0),
                                  (jnp.float32(1e-3), jnp.float32(2e-3)))
    t_info = t_tr.train(t_buf, (1e-3, 2e-3))
    for k in ("value_loss", "policy_loss", "dist_entropy", "ratio"):
        np.testing.assert_allclose(float(t_info[k]), float(j_info[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    _assert_vn(t_tr.vn, j_state1.vn)
    _assert_update_matches(t_tr.policy, j_state0, j_state1, before)


def test_train_two_minibatches_matches_jax_on_its_permutation():
    """At ``num_mini_batch`` 2 the port replays JAX's per-epoch permutations
    of the ``T * M`` samples."""
    j_tr, t_tr = _policies(num_mini_batch=2)
    j_buf, t_buf = _filled_buffers(j_tr)
    key = jax.random.PRNGKey(3)
    perms = [torch.from_numpy(np.asarray(jax.random.permutation(k, T * M)).astype(np.int64))
             for k in jax.random.split(key, j_tr.cfg.ppo_epoch)]
    before = _params_of(t_tr.policy)
    j_state0 = j_tr.state
    j_state1, j_info = j_tr.train(j_state0, j_buf, key, (jnp.float32(1e-3), jnp.float32(2e-3)))
    t_info = t_tr.train(t_buf, (1e-3, 2e-3), perms=perms)
    for k in ("value_loss", "policy_loss", "dist_entropy", "ratio"):
        np.testing.assert_allclose(float(t_info[k]), float(j_info[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    _assert_vn(t_tr.vn, j_state1.vn)
    _assert_update_matches(t_tr.policy, j_state0, j_state1, before)


# ---- runner ---------------------------------------------------------------------

def _runners(name, n=4, steps=8):
    kw = dict(episode_length=steps, n_rollout_threads=n, hidden_size=16, layer_N=1,
              ppo_epoch=1, seed=0)
    if name == "cramped_room":
        j_env, t_env = j_oc2.make(name, horizon=6), t_oc2.make(name, horizon=6)
    else:
        j_env, t_env = j_acrobot.Env(), t_acrobot.Env()
    jr = jm.MAPPORunner(jm.MAPPOConfig(**kw), j_env)
    tr = tm.MAPPORunner(tm.MAPPOConfig(**kw), t_env, device=CPU)
    ps = jr.trainer.state.policy
    t_nets.load_mappo_params(tr.policy.actor, tr.policy.critic, _np(ps.actor_params),
                             _np(ps.critic_params))
    if name == "acrobot":  # start near the step limit, so episodes end in the rollout
        steps0 = 495 + np.arange(n, dtype=np.int32) % 8
        jr.bstate = jr.bstate.replace(
            env_states=jr.bstate.env_states.replace(steps=jnp.asarray(steps0)))
        tr.bstate = dataclasses.replace(tr.bstate, env_states=dataclasses.replace(
            tr.bstate.env_states, steps=torch.from_numpy(steps0)))
    return jr, tr


def _jax_collect_injected(jr, acts):
    """JAX ``_collect`` with the policy's sampler replaced by the injected
    actions (``acts`` [T, N, A]); the sampler finds its step by matching the
    key it is handed against the collect's chain of ``split`` keys.  Jitted
    afresh each call, so that this call's table of actions is traced in."""
    T_, N_, A_ = acts.shape
    key = jax.random.PRNGKey(11)
    step_keys, k = [], key
    for _ in range(T_):
        k, ak = jax.random.split(k)
        step_keys.append(ak)
    step_keys = jnp.stack(step_keys)
    table = jnp.asarray(acts.reshape(T_, N_ * A_))

    def injected(key, logits):
        return table[jnp.argmax(jnp.all(step_keys == key[None], axis=1))]

    real = j_policy_mod.dist_sample
    j_policy_mod.dist_sample = injected
    try:
        return jax.jit(jr._collect_impl)(jr.trainer.state.policy, jr.bstate, jr.out, jr._rnn,
                                          jr._rnnc, jr._masks, key)
    finally:
        j_policy_mod.dist_sample = real


@pytest.mark.parametrize("name", ["cramped_room", "acrobot"])
def test_collect_with_injected_actions_matches_jax(name):
    jr, tr = _runners(name)
    n, steps = tr.N, tr.cfg.episode_length
    rs = np.random.RandomState(8)
    acts = rs.randint(0, tr.env.num_actions, size=(steps, n, tr.A)).astype(np.int32)
    j_bstate, j_out, _, j_rnnc, j_masks, _, j_tr = _jax_collect_injected(jr, acts)
    t_tr = tr._collect(torch.from_numpy(acts))
    obs_tol = F32 if name == "acrobot" else dict(rtol=0, atol=0)
    for k in ("share_obs", "obs"):
        _close(t_tr[k], j_tr[k], **obs_tol)
    for k in ("actions", "rewards", "masks", "active", "avail", "done"):
        np.testing.assert_array_equal(t_tr[k].numpy(), np.asarray(j_tr[k]), err_msg=k)
    assert np.asarray(j_tr["done"]).any()
    for k, j_k in (("logp", "logp"), ("values", "values")):
        _close(t_tr[k], j_tr[j_k])
    np.testing.assert_array_equal(tr._masks.numpy(), np.asarray(j_masks))
    assert int(tr.bstate.episode_counter) == int(j_bstate.episode_counter)
    _close(tr.out.obs.float(), np.asarray(j_out.obs, np.float32), **obs_tol)
    # the buffer and the returns from it
    t_buf = tr._compute(tr._tr_to_buffer(t_tr, tr._masks, tr.out.active.float()))
    j_buf = jr._compute(jr.trainer.state, jr._tr_to_buffer(j_tr, j_masks,
                                                           j_out.active.astype(jnp.float32)),
                        j_out, j_rnnc, j_masks)
    for f in ("masks", "active_masks", "rewards", "actions"):
        np.testing.assert_array_equal(getattr(t_buf, f).numpy(), np.asarray(getattr(j_buf, f)))
    _close(t_buf.returns, j_buf.returns, rtol=1e-5, atol=1e-5)


def test_terminal_mask_written_to_final_slot():
    """With the horizon equal to episode_length (Balance Beam's 3 steps),
    done fires at the last collected step; the mask after it must land in
    the buffer's slot T, so the last transition does not bootstrap from the
    next episode's first obs."""
    cfg = tm.MAPPOConfig(episode_length=3, n_rollout_threads=4, hidden_size=16, layer_N=1,
                         ppo_epoch=1)
    runner = tm.MAPPORunner(cfg, t_balance.Env(), device=CPU)
    tr = runner._collect()
    m = runner._masks
    assert float(m.min()) == 0.0, "at least one env must end at the last step"
    buf = runner._tr_to_buffer(tr, m, runner.out.active.float())
    assert torch.equal(buf.masks[-1], m)
    out_buf = tm.compute_returns(buf, torch.full((8,), 123.0), None, 0.99, 0.95)
    final_ret, final_rew = out_buf.returns[2], buf.rewards[-1]
    ended = m == 0.0
    torch.testing.assert_close(final_ret[ended], final_rew[ended], rtol=1e-5, atol=1e-5)
    assert bool((final_ret[~ended] != final_rew[~ended]).all()) or bool(ended.all())


def test_runner_smoke_two_episodes():
    cfg = tm.MAPPOConfig(episode_length=6, n_rollout_threads=8, hidden_size=32, layer_N=1,
                         ppo_epoch=2, num_mini_batch=2, lr=1e-3, critic_lr=2e-3,
                         use_eval=True, eval_interval=2, eval_episodes=8,
                         use_linear_lr_decay=True)
    runner = tm.MAPPORunner(cfg, t_balance.Env(), device=CPU)
    j_policy = jm.MAPPOPolicy(jm.MAPPOConfig(**{f: getattr(cfg, f) for f in (
        "lr", "critic_lr", "use_linear_lr_decay", "hidden_size", "layer_N")}),
        obs_shape=(7,), share_obs_shape=(7,), num_actions=4)
    for ep in range(2):
        assert runner.policy.lr_for(ep, 2) == j_policy.lr_for(ep, 2)
    lines = []
    info = runner.run(episodes=2, log=lines.append)
    assert runner.policy.actor_opt.param_groups[0]["lr"] == 5e-4  # decayed by half
    assert all(np.isfinite(float(v)) for v in info.values())
    assert len(runner.episode_rewards) == 2 and any("eval @ episode 2" in s for s in lines)
    assert np.isfinite(runner.evaluate(episodes=1))


def test_runner_needs_a_card_and_names_what_is_left_out(monkeypatch):
    env = t_balance.Env()
    small = dict(episode_length=2, n_rollout_threads=2, hidden_size=8)
    # the recurrent policy builds; the CNN needs a grid env (JAX raises the
    # same ValueError); timestep-band minibatches need T % num_mini_batch == 0
    # (JAX's ValueError)
    assert tm.MAPPORunner(tm.MAPPOConfig(**small, use_recurrent_policy=True), env,
                          device=CPU).policy.actor.rnn is not None
    with pytest.raises(ValueError, match="grid env"):
        tm.MAPPORunner(tm.MAPPOConfig(**small, use_cnn_obs=True), env, device=CPU)
    bands = tm.MAPPORunner(tm.MAPPOConfig(**small, shard_local_minibatch=True,
                                          num_mini_batch=3), env, device=CPU)
    with pytest.raises(ValueError, match="shard_local_minibatch"):
        bands.run(episodes=1, log=None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.MAPPORunner(tm.MAPPOConfig(**small), env)
    assert tm.MAPPORunner(tm.MAPPOConfig(**small), env, device="cpu").device.type == "cpu"

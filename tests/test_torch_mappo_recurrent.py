"""The port's recurrent and CNN MAPPO (``RNNLayer``, ``CNNBase``,
``_train_recurrent``, AdamW, the recurrent collect) against the JAX package.

Both sides run float32 on the CPU with the same parameters (the flax trees
loaded into the torch modules by ``load_mappo_params``) and the same inputs
from numpy seeds.  Tolerances, as ``tests/test_torch_mappo.py``'s: network
outputs and hidden states ``atol 1e-5`` (the frameworks sum products and
LayerNorm variances in other orders); one ``train`` ``rtol 1e-4`` on its
losses and ``rtol 1e-4, atol 1e-6`` on every parameter delta; obs, actions,
rewards, masks and dones exactly.  JAX's recurrent update permutes the
chunks with its key; the port replays those permutations (``perms=``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_rl_envs_playground_tpu.envs import balance_beam as j_balance
from madrona_rl_envs_playground_tpu.envs import overcooked2 as j_oc2
from madrona_rl_envs_playground_tpu.models import mappo_nets as j_nets
from madrona_rl_envs_playground_tpu.train import mappo as jm
from madrona_rl_envs_playground_tpu.train.mappo import policy as j_policy_mod
from madrona_rl_envs_playground_tpu_torch.envs import balance_beam as t_balance
from madrona_rl_envs_playground_tpu_torch.envs import overcooked2 as t_oc2
from madrona_rl_envs_playground_tpu_torch.models import mappo_nets as t_nets
from madrona_rl_envs_playground_tpu_torch.train import mappo as tm
from tests.test_torch_mappo import _close, _jax_collect_injected, _np

CPU = torch.device("cpu")


def _t_cfg(mc):
    return t_nets.ModelConfig(**{f.name: getattr(mc, f.name)
                                 for f in dataclasses.fields(t_nets.ModelConfig)})


def _perturbed(params, seed):
    """Random offsets on every leaf (the zero biases and unit LayerNorm
    scales too), so that the copy of each is checked."""
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.1 * rs.randn(*x.shape)).astype(np.float32), params)


# ---- RNNLayer and CNNBase ------------------------------------------------------

@pytest.mark.parametrize("recurrent_n", [1, 2])
def test_gru_step_and_unroll_match_flax(recurrent_n):
    """flax's GRUCell (no biases on hr, hz) with masks that reset the hidden
    state mid-sequence."""
    H, T, N = 16, 7, 5
    mc = j_nets.ModelConfig(hidden_size=H, use_recurrent_policy=True, recurrent_N=recurrent_n)
    layer = j_nets.RNNLayer(mc)
    rs = np.random.RandomState(recurrent_n)
    xs = rs.randn(T, N, H).astype(np.float32)
    h0 = rs.randn(N, recurrent_n, H).astype(np.float32)
    masks = (rs.rand(T, N) > 0.3).astype(np.float32)
    masks[3] = 0.0  # every sequence resets once
    params = _perturbed(layer.init(jax.random.PRNGKey(0), xs[0], h0, masks[0],
                                   method=j_nets.RNNLayer.step), 5)
    ours = t_nets.RNNLayer(_t_cfg(mc))
    assert sum(p.numel() for p in ours.parameters()) == sum(
        x.size for x in jax.tree_util.tree_leaves(params))  # flax's parameter set
    with torch.no_grad():
        t_nets._copy_rnn(ours, params["params"], "rnn")
    j_out, j_h = layer.apply(params, xs[0], h0, masks[0], method=j_nets.RNNLayer.step)
    t_out, t_h = ours.step(torch.from_numpy(xs[0]), torch.from_numpy(h0),
                           torch.from_numpy(masks[0]))
    _close(t_out, j_out)
    _close(t_h, j_h)
    j_outs, j_hT = layer.apply(params, xs, h0, masks, method=j_nets.RNNLayer.unroll)
    t_outs, t_hT = ours.unroll(torch.from_numpy(xs), torch.from_numpy(h0),
                               torch.from_numpy(masks))
    _close(t_outs, j_outs)
    _close(t_hT, j_hT)


@pytest.mark.parametrize("recurrent", [False, True])
def test_cnn_nets_match_flax_on_the_cramped_room_grid(recurrent):
    """The actor and critic over Overcooked2 cramped_room's [W, H, C] grid
    (the conv kernel's layout, the channels-last flatten), with and without
    the GRU, on obs a few random steps in."""
    from madrona_rl_envs_playground_tpu_torch.core.batch import batched_reset, batched_step

    env = t_oc2.make("cramped_room", horizon=20)  # its obs are JAX's (test_torch_env.py)
    shape = (env.width, env.height, env.num_channels)
    mc = j_nets.ModelConfig(hidden_size=16, use_recurrent_policy=recurrent)
    rs = np.random.RandomState(7)
    bstate, out = batched_reset(env, 3, device=CPU)
    for _ in range(5):
        bstate, out = batched_step(env, bstate, torch.from_numpy(
            rs.randint(0, 6, size=(3, 2)).astype(np.int32)))
    obs = out.obs.reshape(6, -1).numpy()  # int8, (x, y, c)-ordered
    avail = out.action_mask.reshape(6, -1).numpy()
    h = rs.randn(6, 1, 16).astype(np.float32)
    m = np.array([1, 0, 1, 1, 0, 1], np.float32)
    j_actor, j_critic = j_nets.R_Actor(mc, shape, 6), j_nets.R_Critic(mc, shape)
    ap = _perturbed(j_actor.init(jax.random.PRNGKey(0), obs[:1], h[:1], m[:1]), 1)
    cp = _perturbed(j_critic.init(jax.random.PRNGKey(1), obs[:1], h[:1], m[:1]), 2)
    t_actor, t_critic = t_nets.R_Actor(_t_cfg(mc), shape, 6), t_nets.R_Critic(_t_cfg(mc), shape)
    assert isinstance(t_actor.base, t_nets.CNNBase)
    t_nets.load_mappo_params(t_actor, t_critic, ap, cp)
    j_logits, j_h = j_actor.apply(ap, jnp.asarray(obs), h, m, jnp.asarray(avail))
    j_values, j_hc = j_critic.apply(cp, jnp.asarray(obs), h, m)
    t_logits, t_h = t_actor(torch.from_numpy(obs), torch.from_numpy(h), torch.from_numpy(m),
                            torch.from_numpy(avail))
    t_values, t_hc = t_critic(torch.from_numpy(obs), torch.from_numpy(h), torch.from_numpy(m))
    _close(t_logits, j_logits)
    _close(t_values, j_values)
    _close(t_h, j_h)
    _close(t_hc, j_hc)
    # zero_states: JAX's [N, L, H], width-1 placeholders for a feed-forward net
    assert tuple(t_actor.zero_states(6).shape) == (6, 1, 16 if recurrent else 1)
    if not recurrent:  # a feed-forward net hands the states back unchanged
        assert torch.equal(t_h, torch.from_numpy(h)) and torch.equal(t_hc, torch.from_numpy(h))


# ---- one update -------------------------------------------------------------------

T, N, A, ACT = 6, 4, 2, 4
M = N * A
GRID = (4, 3, 2)  # a CNN's [W, H, C] obs, flat 24
KINDS = {
    "chunked": dict(use_recurrent_policy=True, data_chunk_length=3),
    "naive": dict(use_naive_recurrent_policy=True, recurrent_N=2),
    "cnn": dict(use_cnn_obs=True),
    "cnn_chunked": dict(use_cnn_obs=True, use_recurrent_policy=True, data_chunk_length=2),
    "adamw": dict(weight_decay=0.05),
}


def _policies(kind):
    kw = dict(KINDS[kind])
    cnn = kw.pop("use_cnn_obs", False)
    base = dict(episode_length=T, n_rollout_threads=N, hidden_size=16, layer_N=1, ppo_epoch=2,
                num_mini_batch=2, lr=1e-3, critic_lr=2e-3, seed=0, **kw)
    shape = GRID if cnn else (24,)
    j_pol = jm.MAPPOPolicy(jm.MAPPOConfig(**base), shape, shape, ACT, seed=0)
    j_tr = jm.RMAPPOTrainer(j_pol.cfg, j_pol)
    t_pol = tm.MAPPOPolicy(tm.MAPPOConfig(**base), shape, shape, ACT, seed=0, device=CPU)
    ps = j_tr.state.policy
    t_nets.load_mappo_params(t_pol.actor, t_pol.critic, _np(ps.actor_params),
                             _np(ps.critic_params))
    return j_tr, tm.RMAPPOTrainer(t_pol.cfg, t_pol)


def _filled_buffers(j_tr):
    """A JAX and a port buffer with the same random episode: rnn states at
    every slot, masks that end episodes, old log-probs near the JAX actor's
    (at the stored states, so the ratios start near 1)."""
    mc = j_tr.policy.mc
    L, H = mc.recurrent_N, (mc.hidden_size if mc.use_recurrent_policy else 1)
    rs = np.random.RandomState(5)
    avail = rs.rand(T + 1, M, ACT) > 0.3
    avail[..., 0] = True
    acts = np.where(avail[:-1][..., 2], 2, 0).astype(np.int32)
    obs = rs.randn(T + 1, M, 24).astype(np.float32)
    rnn = (0.5 * rs.randn(T + 1, M, L, H)).astype(np.float32)
    rnnc = (0.5 * rs.randn(T + 1, M, L, H)).astype(np.float32)
    masks = (rs.rand(T + 1, M) > 0.2).astype(np.float32)
    ps = j_tr.state.policy
    logits, _ = j_tr.policy.actor.apply(ps.actor_params, jnp.asarray(obs[:-1]).reshape(T * M, -1),
                                        jnp.asarray(rnn[:-1]).reshape(T * M, L, H),
                                        jnp.asarray(masks[:-1]).reshape(-1),
                                        jnp.asarray(avail[:-1]).reshape(T * M, -1))
    logp = np.asarray(j_policy_mod.dist_log_prob(logits, jnp.asarray(acts).reshape(-1)))
    v = dict(share_obs=obs, obs=obs, rnn_states=rnn, rnn_states_critic=rnnc,
             available_actions=avail, actions=acts,
             action_log_probs=logp.reshape(T, M) + 0.05 * rs.randn(T, M).astype(np.float32),
             value_preds=rs.randn(T + 1, M).astype(np.float32),
             returns=(rs.randn(T + 1, M) * 2 + 1).astype(np.float32), masks=masks,
             active_masks=(rs.rand(T + 1, M) > 0.2).astype(np.float32))
    j_buf = jm.init_buffer(T, N, A, 24, 24, ACT, L, H).replace(
        **{k: jnp.asarray(x) for k, x in v.items()})
    t_buf = tm.init_buffer(T, N, A, 24, 24, ACT, L, H, device=CPU)
    for k, x in v.items():
        getattr(t_buf, k).copy_(torch.from_numpy(x))
    return j_buf, t_buf


def _params_of(t_pol):
    return [{k: p.detach().clone() for k, p in m.named_parameters()}
            for m in (t_pol.actor, t_pol.critic)]


def _modules_from(t_pol, policy_state):
    actor = t_nets.R_Actor(t_pol.mc, t_pol.obs_shape, ACT)
    critic = t_nets.R_Critic(t_pol.mc, t_pol.share_obs_shape)
    t_nets.load_mappo_params(actor, critic, _np(policy_state.actor_params),
                             _np(policy_state.critic_params))
    return actor, critic


@pytest.mark.parametrize("kind", list(KINDS))
def test_one_train_matches_jax(kind):
    """One ``train`` of 2 epochs x 2 minibatches on JAX's permutations (of
    the chunks where recurrent, of the ``T * M`` samples otherwise): the
    info, the ValueNorm statistics and every parameter delta."""
    j_tr, t_tr = _policies(kind)
    j_buf, t_buf = _filled_buffers(j_tr)
    cfg = j_tr.cfg
    recurrent = cfg.use_recurrent_policy or cfg.use_naive_recurrent_policy
    L = cfg.data_chunk_length if cfg.use_recurrent_policy else T
    n = (T // L) * M if recurrent else T * M
    key = jax.random.PRNGKey(3)
    perms = [torch.from_numpy(np.asarray(jax.random.permutation(k, n)).astype(np.int64))
             for k in jax.random.split(key, cfg.ppo_epoch)]
    before = _params_of(t_tr.policy)
    j_state0 = j_tr.state
    j_state1, j_info = j_tr.train(j_state0, j_buf, key, (jnp.float32(1e-3), jnp.float32(2e-3)))
    t_info = t_tr.train(t_buf, (1e-3, 2e-3), perms=perms)
    if kind == "adamw":
        assert isinstance(t_tr.policy.actor_opt, torch.optim.AdamW)
    for k in ("value_loss", "policy_loss", "dist_entropy", "ratio"):
        np.testing.assert_allclose(float(t_info[k]), float(j_info[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    for f in ("running_mean", "running_mean_sq", "debiasing_term"):
        _close(getattr(t_tr.vn, f), getattr(j_state1.vn, f), rtol=1e-5, atol=1e-7)
    j0 = _modules_from(t_tr.policy, j_state0.policy)
    j1 = _modules_from(t_tr.policy, j_state1.policy)
    for ours, b, m0, m1 in zip((t_tr.policy.actor, t_tr.policy.critic), before, j0, j1):
        for (name, p), p0, p1 in zip(ours.named_parameters(), m0.parameters(), m1.parameters()):
            np.testing.assert_allclose((p.detach() - b[name]).numpy(),
                                       (p1 - p0).detach().numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=name)


def test_train_recurrent_refuses_a_ragged_chunk():
    cfg = tm.MAPPOConfig(episode_length=T, n_rollout_threads=N, hidden_size=8,
                         use_recurrent_policy=True, data_chunk_length=4)
    pol = tm.MAPPOPolicy(cfg, (24,), (24,), ACT, device=CPU)
    buf = tm.init_buffer(T, N, A, 24, 24, ACT, 1, 8, device=CPU)
    with pytest.raises(ValueError, match="data_chunk_length"):
        tm.RMAPPOTrainer(cfg, pol).train(buf)


# ---- the collect ----------------------------------------------------------------

@pytest.mark.parametrize("cnn", [False, True])
def test_recurrent_collect_with_injected_actions_matches_jax(cnn):
    """Two collects of a GRU policy on cramped_room (horizon 5, so that
    episodes end inside each and at their seam): the hidden states at every
    slot within 1e-5, obs, rewards, masks and dones exactly, and the returns
    of the buffer built from them."""
    n, steps = 3, 8
    kw = dict(episode_length=steps, n_rollout_threads=n, hidden_size=16, layer_N=1,
              ppo_epoch=1, seed=0, use_recurrent_policy=True, data_chunk_length=4,
              use_cnn_obs=cnn)
    jr = jm.MAPPORunner(jm.MAPPOConfig(**kw), j_oc2.make("cramped_room", horizon=5))
    tr = tm.MAPPORunner(tm.MAPPOConfig(**kw), t_oc2.make("cramped_room", horizon=5), device=CPU)
    ps = jr.trainer.state.policy
    t_nets.load_mappo_params(tr.policy.actor, tr.policy.critic, _np(ps.actor_params),
                             _np(ps.critic_params))
    rs = np.random.RandomState(8)
    for _ in range(2):
        acts = rs.randint(0, 6, size=(steps, n, 2)).astype(np.int32)
        jr.bstate, jr.out, jr._rnn, jr._rnnc, jr._masks, _, j_tr = _jax_collect_injected(jr, acts)
        t_tr = tr._collect(torch.from_numpy(acts))
        for k in ("share_obs", "obs", "actions", "rewards", "masks", "done"):
            np.testing.assert_array_equal(t_tr[k].numpy(), np.asarray(j_tr[k]), err_msg=k)
        assert np.asarray(j_tr["done"]).any()
        for k in ("rnn", "rnnc", "logp", "values"):
            _close(t_tr[k], j_tr[k])
        assert float(np.abs(np.asarray(j_tr["rnn"])).max()) > 0.01
        _close(tr._rnn, jr._rnn)
        _close(tr._rnnc, jr._rnnc)
        np.testing.assert_array_equal(tr._masks.numpy(), np.asarray(jr._masks))
    t_buf = tr._compute(tr._tr_to_buffer(t_tr, tr._masks, tr.out.active.float()))
    j_buf = jr._compute(jr.trainer.state, jr._tr_to_buffer(j_tr, jr._masks,
                                                           jr.out.active.astype(jnp.float32)),
                        jr.out, jr._rnnc, jr._masks)
    _close(t_buf.rnn_states, j_buf.rnn_states)
    _close(t_buf.returns, j_buf.returns)


def test_recurrent_evaluate_matches_jax():
    """The deterministic eval carries the hidden states and zeroes them at
    episode ends (Balance Beam's, every 3 steps): the score equals JAX's
    within float32 summation."""
    kw = dict(episode_length=8, n_rollout_threads=4, hidden_size=16, layer_N=1, seed=0,
              use_recurrent_policy=True, data_chunk_length=4)
    jr = jm.MAPPORunner(jm.MAPPOConfig(**kw), j_balance.Env())
    tr = tm.MAPPORunner(tm.MAPPOConfig(**kw), t_balance.Env(), device=CPU)
    ps = _perturbed(jr.trainer.state.policy.actor_params, 3)
    jr.trainer.state = jr.trainer.state.replace(
        policy=jr.trainer.state.policy.replace(actor_params=ps))
    t_nets.load_mappo_params(tr.policy.actor, tr.policy.critic, ps,
                             _np(jr.trainer.state.policy.critic_params))
    score = tr.evaluate(episodes=2)
    assert score == pytest.approx(jr.evaluate(episodes=2), rel=1e-5) and score != 0


# ---- the JAX package's runner smokes, and the checkpoint ----------------------------

def test_mappo_recurrent_smoke():
    cfg = tm.MAPPOConfig(episode_length=8, n_rollout_threads=4, hidden_size=32, layer_N=1,
                         ppo_epoch=2, use_recurrent_policy=True, data_chunk_length=4)
    runner = tm.MAPPORunner(cfg, t_balance.Env(), device=CPU)
    info = runner.run(episodes=1, log=None)
    assert np.isfinite(float(info["value_loss"]))


def test_mappo_naive_recurrent_smoke():
    cfg = tm.MAPPOConfig(episode_length=8, n_rollout_threads=4, hidden_size=32, layer_N=1,
                         ppo_epoch=2, use_naive_recurrent_policy=True, num_mini_batch=2)
    runner = tm.MAPPORunner(cfg, t_balance.Env(), device=CPU)
    info = runner.run(episodes=2, log=None)
    assert np.isfinite(float(info["value_loss"]))
    assert np.isfinite(runner.evaluate(episodes=1))


def test_mappo_cnn_smoke():
    """``use_cnn_obs`` routes the base to the CNN over the Overcooked
    ``[W, H, C]`` grid; train and eval run and the actor holds the 4-D conv
    kernel ``[hidden // 2, C, 3, 3]``."""
    cfg = tm.MAPPOConfig(episode_length=8, n_rollout_threads=4, hidden_size=32, layer_N=1,
                         ppo_epoch=2, use_cnn_obs=True)
    env = t_oc2.make("cramped_room", horizon=8)
    runner = tm.MAPPORunner(cfg, env, device=CPU)
    conv = [p for p in runner.policy.actor.parameters() if p.dim() == 4]
    assert [tuple(p.shape) for p in conv] == [(16, env.num_channels, 3, 3)]
    info = runner.run(episodes=2, log=None)
    assert np.isfinite(float(info["value_loss"]))
    assert np.isfinite(runner.evaluate(episodes=1, deterministic=True))


def test_config_takes_jax_flags_and_refuses_unread_ones():
    """The parser takes every flag of JAX's ``get_config`` but
    ``rollout_backend`` (the device decides); the four that nothing reads
    parse at their defaults and are refused at any other value."""
    t_parser, j_parser = tm.get_config(), jm.get_config()
    assert ({a.dest for a in j_parser._actions} - {a.dest for a in t_parser._actions}
            == {"rollout_backend"})
    assert tm.config_from_args(t_parser.parse_args([])) == tm.MAPPOConfig()
    for argv in (["--n_eval_rollout_threads", "4"], ["--save_gifs"], ["--ifi", "0.5"],
                 ["--n_render_rollout_threads", "2"]):
        with pytest.raises(ValueError, match="read by nothing"):
            tm.config_from_args(t_parser.parse_args(argv))
    cfg = tm.config_from_args(t_parser.parse_args(["--use_naive_recurrent_policy",
                                                   "--weight_decay", "0.1"]))
    assert cfg.model_config().use_recurrent_policy and cfg.weight_decay == 0.1


def test_mappo_cnn_obs_requires_grid_env():
    cfg = tm.MAPPOConfig(episode_length=4, n_rollout_threads=2, hidden_size=16,
                         use_cnn_obs=True)
    with pytest.raises(ValueError, match="grid"):
        tm.MAPPORunner(cfg, t_balance.Env(), device=CPU)
    with pytest.raises(ValueError):  # JAX refuses it too
        jm.MAPPORunner(jm.MAPPOConfig(episode_length=4, n_rollout_threads=2, hidden_size=16,
                                      use_cnn_obs=True), j_balance.Env())


def test_recurrent_cnn_adamw_checkpoint_roundtrip(tmp_path):
    """``save``/``restore`` carry the GRU and conv parameters, the AdamW
    states, the ValueNorm statistics; the restored runner's next update
    equals the original's."""
    cfg = tm.MAPPOConfig(episode_length=4, n_rollout_threads=2, hidden_size=16, layer_N=1,
                         ppo_epoch=1, use_cnn_obs=True, use_recurrent_policy=True,
                         data_chunk_length=2, weight_decay=0.01)
    env = t_oc2.make("cramped_room", horizon=8)
    a = tm.MAPPORunner(cfg, env, device=CPU)
    a.run(episodes=1, log=None)
    a.save(str(tmp_path))
    b = tm.MAPPORunner(dataclasses.replace(cfg, seed=5), env, device=CPU)
    b.restore(str(tmp_path))
    for x, y in ((a.policy.actor, b.policy.actor), (a.policy.critic, b.policy.critic)):
        sd = x.state_dict()
        assert any(k.startswith("rnn.cells.0.") for k in sd) and "base.conv.weight" in sd
        for k, v in y.state_dict().items():
            assert torch.equal(v, sd[k]), k
    assert b.policy.actor_opt.state_dict()["state"][0]["step"] == 1
    assert b.policy.actor_opt.state_dict()["param_groups"][0]["weight_decay"] == 0.01
    acts = torch.from_numpy(np.random.RandomState(1).randint(0, 6, (4, 2, 2)).astype(np.int32))
    b.bstate, b.out, b._masks, b._rnn, b._rnnc = a.bstate, a.out, a._masks, a._rnn, a._rnnc
    tr_a, tr_b = a._collect(acts), b._collect(acts)
    for k in tr_a:
        assert torch.equal(tr_a[k], tr_b[k]), k


def test_server_and_tester_take_a_recurrent_cnn_checkpoint(tmp_path, capsys):
    """``torch_serve_policy.py`` and ``torch_tester.py`` named the
    trainer's flags: the server answers each request from a zero hidden
    state and masks of 1 (JAX's ``serve_policy.py``), the tester prints
    the runner's own carried-state eval."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
    import torch_serve_policy
    import torch_tester

    cfg = tm.MAPPOConfig(episode_length=6, n_rollout_threads=4, hidden_size=16, layer_N=1,
                         ppo_epoch=1, use_cnn_obs=True, use_recurrent_policy=True,
                         data_chunk_length=3, recurrent_N=2)
    env = t_oc2.make("cramped_room", horizon=6)
    runner = tm.MAPPORunner(cfg, env, device=CPU)
    runner.run(episodes=1, log=None)
    runner.save(str(tmp_path))
    flags = dict(use_recurrent_policy=True, use_naive_recurrent_policy=False, recurrent_N=2,
                 use_cnn_obs=True)
    args = type("Args", (), dict(agent="mappo", env_name="overcooked",
                                 over_layout="cramped_room", episode_length=6, hidden_size=16,
                                 layer_N=1, device="cpu", checkpoint=str(tmp_path), **flags))
    act, senv = torch_serve_policy.load_actor(args)
    rs = np.random.RandomState(0)
    obs = rs.randint(0, 2, size=(5, senv.obs_size)).astype(np.float32)
    mask = rs.rand(5, senv.num_actions) > 0.3
    mask[:, 0] = True
    with torch.no_grad():
        actor = runner.policy.actor
        logits, _ = actor(torch.from_numpy(obs), actor.zero_states(5), torch.ones(5),
                          torch.from_numpy(mask))
        assert tuple(actor.zero_states(5).shape) == (5, 2, 16)
    np.testing.assert_array_equal(act(obs, mask, 0, True), torch.argmax(logits, -1).numpy())
    capsys.readouterr()
    score = torch_tester.main(["--model_dir", str(tmp_path), "--over_layout", "cramped_room",
                               "--episode_length", "6", "--n_rollout_threads", "4",
                               "--hidden_size", "16", "--use_recurrent_policy",
                               "--recurrent_N", "2", "--use_cnn_obs", "--device", "cpu"])
    assert score == runner.evaluate(episodes=1)
    assert capsys.readouterr().out.splitlines()[-1] == f"average episode score: {score:.3f}"

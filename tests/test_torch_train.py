"""The port's network, GAE and self-play PPO against the JAX package.

Both sides run float32 on the CPU with the same parameters (flax params
loaded into the torch modules) and the same inputs from numpy seeds.

Tolerances: network outputs and GAE ``atol 1e-5`` (float32; the two
frameworks reduce in different orders, and JAX's GAE is an associative scan
where the port loops); the PPO update ``rtol 1e-4`` on losses and on the
parameter deltas (float32 on both sides; the backward passes sum gradients
in different orders, and Adam divides by ``sqrt(nu) + 1e-5``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_rl_envs_playground_tpu.envs import overcooked as j_oc
from madrona_rl_envs_playground_tpu.models import common as j_common
from madrona_rl_envs_playground_tpu.models.cleanrl import CleanRLNetwork as JNet
from madrona_rl_envs_playground_tpu.train import selfplay as j_selfplay
from madrona_rl_envs_playground_tpu.train.cleanrl_ppo import plain_gae as j_gae
from madrona_rl_envs_playground_tpu_torch.core.types import StepOutput
from madrona_rl_envs_playground_tpu_torch.envs import overcooked as t_oc
from madrona_rl_envs_playground_tpu_torch.models import common as t_common
from madrona_rl_envs_playground_tpu_torch.models.cleanrl import CleanRLNetwork as TNet
from madrona_rl_envs_playground_tpu_torch.models.cleanrl import load_flax_params
from madrona_rl_envs_playground_tpu_torch.train import selfplay as t_selfplay
from madrona_rl_envs_playground_tpu_torch.train.cleanrl_ppo import plain_gae as t_gae

CPU = torch.device("cpu")
F32 = dict(atol=1e-5, rtol=0)


def _np_params(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **(tol or F32))


@pytest.mark.parametrize("masked", [False, True])
def test_network_matches_flax(masked):
    F, A, B = 40, 6, 33
    jnet = JNet(num_actions=A, hidden=32, num_layers=2)
    rs = np.random.RandomState(0)
    obs = rs.randint(-1, 3, size=(B, F)).astype(np.int8)
    mask = rs.rand(B, A) > 0.3 if masked else None
    if masked:
        mask[:, 0] = True
    params = jnet.init(jax.random.PRNGKey(1), jnp.zeros((1, F)), jnp.zeros((1, F)),
                       jnp.ones((1, A), bool))
    j_logits, j_value = jnet.apply(params, jnp.asarray(obs), jnp.asarray(obs),
                                   None if mask is None else jnp.asarray(mask))
    tnet = TNet(F, A, hidden=32, num_layers=2)
    load_flax_params(tnet, _np_params(params))
    t_obs = torch.from_numpy(obs)
    t_logits, t_value = tnet(t_obs, t_obs, None if mask is None else torch.from_numpy(mask))
    _close(t_logits, j_logits)
    _close(t_value, j_value)
    acts = rs.randint(0, A, size=B).astype(np.int32)
    if masked:
        acts = np.where(mask[np.arange(B), acts], acts, 0).astype(np.int32)
    _close(t_common.dist_log_prob(t_logits, torch.from_numpy(acts)),
           j_common.dist_log_prob(j_logits, jnp.asarray(acts)))
    _close(t_common.dist_entropy(t_logits), j_common.dist_entropy(j_logits))


def test_network_bf16_compute_keeps_f32_params_and_heads():
    F, A = 24, 6
    net = TNet(F, A, hidden=16, num_layers=2, use_bf16=True)
    x = torch.randint(-1, 2, (5, F), dtype=torch.int8)
    logits, value = net(x, x)
    assert logits.dtype == torch.float32 and value.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in net.parameters())
    ref = TNet(F, A, hidden=16, num_layers=2)
    ref.load_state_dict(net.state_dict())
    r_logits, r_value = ref(x, x)
    # bf16 keeps ~3 significant digits through two hidden layers
    torch.testing.assert_close(logits, r_logits, atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(value, r_value, atol=2e-2, rtol=2e-2)


def test_plain_gae_matches_jax():
    T, M = 19, 23
    rs = np.random.RandomState(3)
    r = rs.randn(T, M).astype(np.float32)
    d = rs.rand(T, M) < 0.1
    v = rs.randn(T, M).astype(np.float32)
    nv = rs.randn(M).astype(np.float32)
    nd = rs.rand(M) < 0.2
    j_adv, j_ret = j_gae(jnp.asarray(r), jnp.asarray(d), jnp.asarray(v), jnp.asarray(nv),
                         jnp.asarray(nd), 0.99, 0.95)
    t_adv, t_ret = t_gae(torch.from_numpy(r), torch.from_numpy(d), torch.from_numpy(v),
                         torch.from_numpy(nv), torch.from_numpy(nd), 0.99, 0.95)
    _close(t_adv, j_adv)
    _close(t_ret, j_ret)


def _trainers(value_loss="clipped_mse", num_envs=4, T=8, epochs=2, nmb=2, use_bf16=False):
    common = dict(num_steps=T, hidden=32, num_layers=1, update_epochs=epochs,
                  num_minibatches=nmb, lr=1e-3, value_loss=value_loss, use_bf16=use_bf16)
    j_env = j_oc.make("cramped_room", horizon=8)
    t_env = t_oc.make("cramped_room", horizon=8)
    jt = j_selfplay.SelfPlayPPO(
        j_env, num_envs, j_selfplay.SelfPlayConfig(rollout_backend="jnp", **common), seed=0)
    tt = t_selfplay.SelfPlayPPO(
        t_env, num_envs, t_selfplay.SelfPlayConfig(**common), seed=0, device="cpu")
    load_flax_params(tt.net, _np_params(jt.state["params"]))
    return jt, tt


def jax_rollout_injected(jt, acts):
    """JAX ``_rollout`` of trainer ``jt`` with its sampler replaced by the
    injected actions ``acts`` ([T, N, P] int32).  The sampler finds the step
    by matching the key it is handed against the rollout's known chain of
    ``split`` keys, so the rollout still runs as one jitted scan.  Returns
    (bstate, out, trajectory)."""
    T, N, P = acts.shape
    key, step_keys = jt.state["key"], []
    for _ in range(T):
        key, ak = jax.random.split(key)
        step_keys.append(ak)
    step_keys = jnp.stack(step_keys)
    table = jnp.asarray(acts.reshape(T, N * P))

    def injected(key, logits):
        t = jnp.argmax(jnp.all(step_keys == key[None], axis=1))
        return table[t]

    real = j_selfplay.dist_sample
    j_selfplay.dist_sample = injected
    try:
        bstate, out, _, tr = jax.jit(jt._rollout)(jt.state)
    finally:
        j_selfplay.dist_sample = real
    return bstate, out, tr


@pytest.fixture(scope="module")
def jax_rollout():
    """The JAX rollout of ``_trainers()`` with injected actions, shared by
    the tests below.  Returns (actions [T, N, P], bstate, out, trajectory)."""
    jt, _ = _trainers()
    T, N, P = 8, 4, 2
    rs = np.random.RandomState(4)
    acts = rs.choice(6, size=(T, N, P), p=[.15, .15, .15, .15, .05, .35]).astype(np.int32)
    # env 0 scripted: player 0 fetches an onion and puts it in the pot (a
    # placement reward at step 5); player 1 stays
    acts[:6, 0, 0] = [0, 3, 5, 2, 0, 5]
    acts[:6, 0, 1] = 4
    return (acts,) + jax_rollout_injected(jt, acts)


def test_rollout_matches_jax_with_injected_actions(jax_rollout):
    acts, j_bstate, j_out, j_tr = jax_rollout
    _, tt = _trainers()
    t_bstate, t_out, t_tr = tt._rollout(torch.from_numpy(acts))
    for k in ("obs", "action", "reward", "done"):
        np.testing.assert_array_equal(t_tr[k].numpy(), np.asarray(j_tr[k]), err_msg=k)
    _close(t_tr["logp"], j_tr["logp"])
    _close(t_tr["value"], j_tr["value"])
    assert np.asarray(j_tr["done"]).any()  # horizon 8 crosses one reset
    assert np.asarray(j_tr["reward"]).any()
    np.testing.assert_array_equal(t_out.obs.numpy(), np.asarray(j_out.obs))
    np.testing.assert_array_equal(t_out.done.numpy(), np.asarray(j_out.done))
    for f in j_bstate.env_states.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(t_bstate.env_states, f).numpy(),
                                      np.asarray(getattr(j_bstate.env_states, f)), err_msg=f)
    assert int(t_bstate.episode_counter) == int(j_bstate.episode_counter)


@pytest.mark.parametrize("value_loss", ["clipped_mse", "smooth_l1"])
def test_one_update_matches_jax(value_loss, jax_rollout):
    _, _, j_out, j_tr = jax_rollout
    jt, tt = _trainers(value_loss)
    assert_update_matches_jax(jt, tt, j_tr, j_out)


def test_one_update_matches_jax_when_minibatches_do_not_divide_steps():
    """num_minibatches = 4 does not divide num_steps = 6: both packages fall
    back to T-major flat chunks of T * M // 4 rows, the remainder dropped.
    8 envs give minibatches of 24 rows, near the other update tests' 32: at
    12 rows a few first-layer gradient elements come out near Adam's eps,
    where a float32 rounding difference moves the step by ~1e-3 of itself."""
    T, N, P = 6, 8, 2
    jt, tt = _trainers(T=T, nmb=4, num_envs=N)
    rs = np.random.RandomState(6)
    acts = rs.choice(6, size=(T, N, P), p=[.15, .15, .15, .15, .05, .35]).astype(np.int32)
    _, j_out, j_tr = jax_rollout_injected(jt, acts)
    _, t_out, t_tr = tt._rollout(torch.from_numpy(acts))
    np.testing.assert_array_equal(t_tr["obs"].numpy(), np.asarray(j_tr["obs"]))
    chunks, _ = tt._advantage(t_tr, t_out)
    assert chunks["obs"].shape[:2] == (4, T * N * P // 4)
    assert_update_matches_jax(jt, tt, j_tr, j_out)


def test_one_update_matches_jax_in_bf16():
    """``use_bf16`` (bfloat16 towers, float32 parameters, heads' outputs and
    optimizer) against JAX's, from the same parameters and injected actions:
    the rollout's obs, actions and rewards equal and its log-probs and values
    within float32 tolerance (the forward rounds to bf16 at the same
    places); one update's losses within rtol 5e-3, and every parameter delta
    within 1e-4 (a tenth of lr), with at most 1 in 1,000 beyond 1e-5.  The
    backward passes round the bf16 products' gradients in different orders;
    bf16 keeps about 3 significant digits, and Adam scales a gradient
    element near zero up to lr, so a few deltas move by a few percent of lr
    (4.4e-5 at most here)."""
    jt, tt = _trainers(use_bf16=True)
    T, N, P = 8, 4, 2
    rs = np.random.RandomState(4)
    acts = rs.choice(6, size=(T, N, P), p=[.15, .15, .15, .15, .05, .35]).astype(np.int32)
    _, j_out, j_tr = jax_rollout_injected(jt, acts)
    _, _, t_tr = tt._rollout(torch.from_numpy(acts))
    for k in ("obs", "action", "reward", "done"):
        np.testing.assert_array_equal(t_tr[k].numpy(), np.asarray(j_tr[k]), err_msg=k)
    _close(t_tr["logp"], j_tr["logp"])
    _close(t_tr["value"], j_tr["value"])

    params0 = jt.state["params"]
    chunks, _ = jt._advantage(params0, j_tr, j_out)
    params1, _, auxes = jt._update(params0, jt.state["opt_state"], chunks)
    t_tr = {k: torch.from_numpy(np.array(j_tr[k]))
            for k in ("obs", "action", "logp", "value", "reward", "done")}
    t_out = StepOutput(**{f: torch.from_numpy(np.array(getattr(j_out, f)))
                          for f in ("obs", "state_obs", "action_mask", "active",
                                    "reward", "done")})
    before = {k: v.detach().clone() for k, v in tt.net.state_dict().items()}
    t_chunks, _ = tt._advantage(t_tr, t_out)
    _close(t_chunks["advantages"], chunks[5])
    t_aux = tt._update(t_chunks)
    for name, t_v, j_v in zip(("pg_loss", "v_loss", "entropy", "approx_kl"), t_aux, auxes):
        np.testing.assert_allclose(float(t_v), float(j_v[-1]), rtol=5e-3, atol=1e-7,
                                   err_msg=name)
    j0, j1 = _np_params(params0)["params"], _np_params(params1)["params"]
    after = tt.net.state_dict()
    diffs = []
    for tower in ("actor", "critic"):
        for i in range(len(tt.net.actor.layers)):
            for leaf, key in (("kernel", "weight"), ("bias", "bias")):
                j_delta = j1[tower][f"Dense_{i}"][leaf] - j0[tower][f"Dense_{i}"][leaf]
                tk = f"{tower}.layers.{i}.{key}"
                t_delta = (after[tk] - before[tk]).numpy()
                if leaf == "kernel":
                    t_delta = t_delta.T
                np.testing.assert_allclose(t_delta, j_delta, rtol=0, atol=1e-4, err_msg=tk)
                diffs.append(np.abs(t_delta - j_delta).ravel())
    assert (np.concatenate(diffs) > 1e-5).mean() <= 1e-3


def assert_update_matches_jax(jt, tt, j_tr, j_out, loss_atol=1e-7, loss_abs=None):
    """One PPO update of the port's ``tt`` on the JAX trajectory ``j_tr``
    against the JAX trainer ``jt``'s: advantages, returns, stats, the last
    epoch's losses (``rtol 1e-4``, ``atol loss_atol``, and within
    ``loss_abs`` where given) and every parameter delta.  A masked env's
    trajectory also carries its state obs, masks and active flags."""
    params0 = jt.state["params"]
    chunks, j_stats = jt._advantage(params0, j_tr, j_out)
    params1, _, auxes = jt._update(params0, jt.state["opt_state"], chunks)

    t_tr = {k: torch.from_numpy(np.array(j_tr[k]))
            for k in ("obs", "state_obs", "mask", "active", "action", "logp", "value",
                      "reward", "done") if k in j_tr}
    t_out = StepOutput(**{f: torch.from_numpy(np.array(getattr(j_out, f)))
                          for f in ("obs", "state_obs", "action_mask", "active",
                                    "reward", "done")})
    before = {k: v.detach().clone() for k, v in tt.net.state_dict().items()}
    t_chunks, t_stats = tt._advantage(t_tr, t_out)
    _close(t_chunks["advantages"], chunks[5])
    _close(t_chunks["returns"], chunks[6])
    for k in j_stats:
        _close(t_stats[k], j_stats[k])
    t_aux = tt._update(t_chunks)
    for name, t_v, j_v in zip(("pg_loss", "v_loss", "entropy", "approx_kl"), t_aux, auxes):
        np.testing.assert_allclose(float(t_v), float(j_v[-1]), rtol=1e-4, atol=loss_atol,
                                   err_msg=name)
        if loss_abs is not None:
            assert abs(float(t_v) - float(j_v[-1])) <= loss_abs, name

    assert_deltas_match_jax(before, tt.net.state_dict(), params0, params1)


def assert_deltas_match_jax(before, after, params0, params1):
    """Every parameter delta of the port's network (state dicts ``before``
    and ``after`` an update) against JAX's (flax params ``params0`` and
    ``params1``)."""
    j0, j1 = _np_params(params0)["params"], _np_params(params1)["params"]
    layers = sum(1 for k in before if k.startswith("actor.layers.") and k.endswith(".weight"))
    for tower in ("actor", "critic"):
        for i in range(layers):
            for leaf, key in (("kernel", "weight"), ("bias", "bias")):
                j_delta = j1[tower][f"Dense_{i}"][leaf] - j0[tower][f"Dense_{i}"][leaf]
                tk = f"{tower}.layers.{i}.{key}"
                t_delta = (after[tk] - before[tk]).numpy()
                if leaf == "kernel":
                    t_delta = t_delta.T
                # the deltas are lr-sized (1e-3); compare them at 1e-4 of that
                np.testing.assert_allclose(t_delta, j_delta, rtol=1e-4, atol=1e-7,
                                           err_msg=tk)


def test_trainer_runs_on_cpu():
    env = t_oc.make("cramped_room", horizon=6)
    cfg = t_selfplay.SelfPlayConfig(num_steps=6, hidden=16, num_layers=1,
                                    update_epochs=1, num_minibatches=2)
    tr = t_selfplay.SelfPlayPPO(env, 3, cfg, seed=1, device="cpu")
    for _ in range(2):
        m = tr.train_step()
    assert all(torch.isfinite(v) for v in m.values())
    assert int(tr.state["bstate"].episode_counter) == 3 + 3 * 2  # two resets per env


def test_entry_points_need_a_card_unless_asked_for_cpu(monkeypatch):
    from madrona_rl_envs_playground_tpu_torch.core.batch import batched_reset
    from madrona_rl_envs_playground_tpu_torch.ops import overcooked as tok
    from madrona_rl_envs_playground_tpu_torch.train.fused_collect import make_fused_collect

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    env = t_oc.make("cramped_room", horizon=6)
    cfg = t_selfplay.SelfPlayConfig(num_steps=2, hidden=8, num_layers=1)
    for build in (lambda: t_selfplay.SelfPlayPPO(env, 2, cfg),
                  lambda: make_fused_collect(env, 2),
                  lambda: batched_reset(env, 2),
                  lambda: tok.init_packed(env, 2),
                  lambda: tok.init_action_rng(2, 2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    # asking for the CPU is the only way onto it
    assert t_selfplay.SelfPlayPPO(env, 2, cfg, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("name,has_kernel", [
    ("cramped_room", True), ("many_player_layout", False), ("cartpole", True),
    ("balance", True), ("acrobot", True)])
def test_trainer_picks_the_collector_by_env(name, has_kernel):
    """Envs with a step kernel get a collector; an Overcooked grid outside
    the kernels' envelope steps through the plain env, as in JAX."""
    from madrona_rl_envs_playground_tpu_torch.envs import acrobot, balance_beam, cartpole

    env = {"cartpole": cartpole.Env, "balance": balance_beam.Env, "acrobot": acrobot.Env}.get(
        name, lambda: t_oc.make(name, horizon=6, num_players=6 if "many" in name else None))()
    cfg = t_selfplay.SelfPlayConfig(num_steps=2, hidden=8, num_layers=1)
    tr = t_selfplay.SelfPlayPPO(env, 2, cfg, device="cpu")
    assert tr._fused.kernel == has_kernel
    m = tr.train_step()
    assert all(torch.isfinite(v) for v in m.values())

"""The port's decentralized ``CleanPPOAgent`` against the JAX package's.

Both packages run on the CPU from the same flax parameters
(``load_flax_params``) and the same actions: each package's ``dist_sample``
is replaced by a table of actions made from a numpy seed (JAX's finds the
call by the sampling key it is handed, as ``tests/test_torch_train.py``'s
``jax_rollout_injected`` does; the port's by the agent's generator), and an
ego and a partner agent train on their own seats of the same env.

Tolerances: the rollout buffers' integer fields (obs, actions, masks, dones,
active flags) exactly, their floats (log-probs, values, credited rewards)
within ``atol 1e-6``; the parameter change of every train within
``assert_update_matches_jax``'s ``rtol 1e-4, atol 1e-7`` (float32 on both
sides; the backward passes sum gradients in different orders); each train's
metrics within ``atol 1e-5``.  After each train the port takes JAX's
parameters and Adam moments, so that the next rollout and train start from
the same state.  In a train where the reference's GAE freeze leaves every
trainable advantage 0, the critic's target is its own old value: JAX's
critic does not move (it recomputes the values bit for bit) while the
port's moves by float noise that Adam scales up; there the actor is
compared and the critic's move is bounded by ``update_epochs * lr``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_rl_envs_playground_tpu.api import TpuVecEnv
from madrona_rl_envs_playground_tpu.envs import balance_beam as j_bb
from madrona_rl_envs_playground_tpu.envs import hanabi as j_hanabi
from madrona_rl_envs_playground_tpu.train import cleanrl_ppo as j_ppo
from madrona_rl_envs_playground_tpu_torch.api import DeviceVecEnv
from madrona_rl_envs_playground_tpu_torch.core.batch import batched_reset, batched_step
from madrona_rl_envs_playground_tpu_torch.envs import balance_beam as t_bb
from madrona_rl_envs_playground_tpu_torch.envs import hanabi as t_hanabi
from madrona_rl_envs_playground_tpu_torch.models.cleanrl import flax_params, load_flax_params
from madrona_rl_envs_playground_tpu_torch.train import cleanrl_ppo as t_ppo

from .test_torch_train import _np_params

N, T, HIDDEN, LR = 8, 6, 32, 1e-3
STEPS = 2 * T + 2  # across two train boundaries
BUF_TOL = dict(rtol=0, atol=1e-6)
METRIC_TOL = dict(rtol=0, atol=1e-5)


def jax_action_keys(seed, steps):
    """The sampling keys a JAX ``CleanPPOAgent`` of ``seed`` hands
    ``dist_sample`` on its first ``steps`` calls of ``get_action``, one
    ``update`` after each: a split of its key per call, and one more before
    it at each train."""
    key, _ = jax.random.split(jax.random.PRNGKey(seed))
    keys = []
    for step in range(steps):
        if step > 0 and step % T == 0:
            key, _ = jax.random.split(key)
        key, ak = jax.random.split(key)
        keys.append(np.asarray(ak))
    return keys


def legal_schedule(env, steps, seed):
    """[steps, N, P] int32 actions, each legal for its seat's mask at its
    step, from the port's plain env started as the vector envs start."""
    bstate, out = batched_reset(env, N, device="cpu")
    rs = np.random.RandomState(seed)
    acts = []
    for _ in range(steps):
        mask = out.action_mask.numpy()
        a = np.array([[rs.choice(np.nonzero(mask[n, p])[0]) for p in range(env.num_agents)]
                      for n in range(N)], np.int32)
        bstate, out = batched_step(env, bstate, torch.from_numpy(a))
        acts.append(a)
    return np.stack(acts)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().cpu().numpy(), np.asarray(j), **tol)


def assert_buffers_match(t_agent, j_agent, what):
    t_buf, j_buf = t_agent.carry.buf, j_agent.carry.buf
    for f in ("obs", "states", "actions", "action_masks", "dones", "active"):
        np.testing.assert_array_equal(getattr(t_buf, f).numpy(), np.asarray(getattr(j_buf, f)),
                                      err_msg=f"{what} {f}")
    for f in ("logprobs", "values", "rewards"):
        _close(getattr(t_buf, f), getattr(j_buf, f), err_msg=f"{what} {f}", **BUF_TOL)
    t_c, j_c = t_agent.carry, j_agent.carry
    for f in ("next_done", "new_game", "last_active", "num_returns"):
        np.testing.assert_array_equal(getattr(t_c, f).numpy(), np.asarray(getattr(j_c, f)),
                                      err_msg=f"{what} {f}")
    for f in ("running_rewards", "mean_return_sum"):
        _close(getattr(t_c, f), getattr(j_c, f), err_msg=f"{what} {f}", **BUF_TOL)


def assert_params_moved_alike(t_net, j_before, j_after, t_before, what,
                              towers=("actor", "critic")):
    """The port's parameter change equals JAX's within
    ``assert_update_matches_jax``'s tolerances."""
    j0, j1 = _np_params(j_before)["params"], _np_params(j_after)["params"]
    t1 = flax_params(t_net)["params"]
    for tower in towers:
        for layer in j0[tower]:
            for leaf in ("kernel", "bias"):
                np.testing.assert_allclose(
                    t1[tower][layer][leaf] - t_before[tower][layer][leaf],
                    j1[tower][layer][leaf] - j0[tower][layer][leaf], rtol=1e-4, atol=1e-7,
                    err_msg=f"{what} {tower}.{layer}.{leaf}")


def zero_value_targets(j_before, j_after, j_metrics) -> bool:
    """JAX's train left the critic exactly where it was, with a value loss
    of exactly 0."""
    j0, j1 = _np_params(j_before)["params"]["critic"], _np_params(j_after)["params"]["critic"]
    return (float(j_metrics["v_loss"]) == 0.0
            and all(np.array_equal(j0[layer][leaf], j1[layer][leaf])
                    for layer in j0 for leaf in ("kernel", "bias")))


def adam_steps(t_agent) -> int:
    """The Adam steps the port's agent has taken (0 before the first)."""
    return max((int(st["step"]) for st in t_agent.opt.state.values()), default=0)


def sync_from_jax(t_agent, j_agent) -> None:
    """The JAX agent's parameters and Adam state (moments and count) into
    the port's agent."""
    load_flax_params(t_agent.net, _np_params(j_agent.params))
    adam = j_agent.opt_state.inner_state[1][0]
    mu, nu = _np_params(adam.mu)["params"], _np_params(adam.nu)["params"]
    with torch.no_grad():
        for tower in ("actor", "critic"):
            for i, layer in enumerate(getattr(t_agent.net, tower).layers):
                for leaf, p in (("kernel", layer.weight), ("bias", layer.bias)):
                    m, v = mu[tower][f"Dense_{i}"][leaf], nu[tower][f"Dense_{i}"][leaf]
                    if leaf == "kernel":
                        m, v = m.T, v.T
                    st = t_agent.opt.state[p]
                    st["exp_avg"].copy_(torch.from_numpy(np.array(m)))
                    st["exp_avg_sq"].copy_(torch.from_numpy(np.array(v)))
                    st["step"].fill_(int(adam.count))


def run_both(case, j_env, t_env, seed, captured=False, **agent_kw):
    """Ego (seat 0) and partner (seat 1) agents of both packages over
    ``STEPS`` steps of the same actions; every check happens inside.
    ``captured``: the port's env and agents replay graphs (the caller made
    the capture rule answer yes), and each train is checked around its
    graph's call.  Returns each train's (name, Adam steps the port applied,
    towers compared)."""
    acts = legal_schedule(t_env, STEPS, seed)
    seeds = {"ego": 2, "partner": 1}
    j_table = {}
    for name, s in seeds.items():
        for step, key in enumerate(jax_action_keys(s, STEPS)):
            j_table[key.tobytes()] = acts[step, :, 0 if name == "ego" else 1]
    j_keys = jnp.asarray(np.stack([np.frombuffer(k, np.uint32) for k in j_table]))
    j_acts = jnp.asarray(np.stack(list(j_table.values())))

    def j_inject(key, logits):
        return j_acts[jnp.argmax(jnp.all(j_keys == key[None], axis=1))]

    kw = dict(num_updates=4, verbose=False, num_steps=T, hidden=HIDDEN, lr=LR, **agent_kw)
    j_venv = TpuVecEnv(j_env, num_envs=N)
    t_venv = DeviceVecEnv(t_env, num_envs=N, device="cpu")
    agents = {}
    for name, s in seeds.items():
        j_agent = j_ppo.CleanPPOAgent(j_venv, name, seed=s, **kw)
        t_agent = t_ppo.CleanPPOAgent(t_venv, name, seed=s, **kw)
        load_flax_params(t_agent.net, _np_params(j_agent.params))
        agents[name] = (t_agent, j_agent)
    assert all(obj.captured is captured for obj in (t_venv, agents["ego"][0],
                                                     agents["partner"][0]))
    j_venv.add_partner_agent(agents["partner"][1])
    t_venv.add_partner_agent(agents["partner"][0])
    t_calls = {id(a.sample_gen): (name, a) for name, (a, _) in agents.items()}

    def t_inject(generator, logits):
        # the action of the agent's step (a graph's capture samples again)
        name, agent = t_calls[id(generator)]
        return torch.from_numpy(acts[agent.global_step, :, 0 if name == "ego" else 1].copy())

    case.setattr(j_ppo, "dist_sample", j_inject)
    case.setattr(t_ppo, "dist_sample", t_inject)

    # each port train is checked against JAX's, which runs first (JAX's ego
    # acts, and JAX's env steps its partner, before the port's); then the
    # port takes JAX's parameters and Adam state, so that every train and
    # the next actions start from the same ones
    before, trains = {}, []

    def checked_train(name, t_agent, j_agent, train):
        def run(*args):
            steps0 = adam_steps(t_agent)
            metrics = train(*args)
            j_before, t_before = before[name]
            what = f"{name} train {len(trains) + 1}"
            towers = ("actor", "critic")
            if zero_value_targets(j_before, j_agent.params, j_agent._last_metrics):
                # the reference's freeze quirk left every trainable row with
                # advantage 0, so the critic's target is its own old value:
                # JAX's critic loss and update are exactly 0 (it recomputes
                # the values bit for bit), the port's gradient is float
                # noise, which Adam scales up to steps of about lr each (the
                # value loss stays within METRIC_TOL, checked below)
                t1 = flax_params(t_agent.net)["params"]["critic"]
                moved = max(np.abs(t1[layer][leaf] - t_before["critic"][layer][leaf]).max()
                            for layer in t1 for leaf in ("kernel", "bias"))
                assert moved <= t_agent.update_epochs * LR, what
                towers = ("actor",)
            assert_params_moved_alike(t_agent.net, j_before, j_agent.params, t_before, what,
                                      towers)
            for k, j_v in j_agent._last_metrics.items():
                _close(metrics[k], j_v, err_msg=f"{what} {k}", equal_nan=True, **METRIC_TOL)
            trains.append((what, adam_steps(t_agent) - steps0, towers))
            sync_from_jax(t_agent, j_agent)
            return metrics
        return run

    train = "_train_graph" if captured else "_train_impl"
    for name, (t_agent, j_agent) in agents.items():
        setattr(t_agent, train, checked_train(name, t_agent, j_agent, getattr(t_agent, train)))

    j_obs, t_obs = j_venv.reset(), t_venv.reset()
    dones = 0
    for step in range(STEPS):
        if step > 0 and step % T == 0:
            # the rollout each agent trains on at this call
            for name, (t_agent, j_agent) in agents.items():
                assert_buffers_match(t_agent, j_agent, f"{name} step {step}")
                before[name] = (_np_params(j_agent.params), flax_params(t_agent.net)["params"])
        j_act = agents["ego"][1].get_action(j_obs)
        t_act = agents["ego"][0].get_action(t_obs)
        j_obs, j_rew, j_done, _ = j_venv.step(j_act)
        t_obs, t_rew, t_done, _ = t_venv.step(t_act)
        np.testing.assert_array_equal(t_act.numpy(), np.asarray(j_act))
        np.testing.assert_array_equal(t_obs.obs.numpy(), np.asarray(j_obs.obs))
        np.testing.assert_array_equal(t_rew.numpy(), np.asarray(j_rew))
        np.testing.assert_array_equal(t_done.numpy(), np.asarray(j_done))
        dones += int(t_done.sum())
        agents["ego"][1].update(j_rew, j_done)
        agents["ego"][0].update(t_rew, t_done)
    for name, (t_agent, j_agent) in agents.items():
        assert_buffers_match(t_agent, j_agent, f"{name} end")
    assert len(trains) == 4 and dones > 0  # two trains of each agent
    return trains


SWITCHES = [
    dict(clip_vloss=True, norm_adv=True),
    dict(clip_vloss=False, norm_adv=True),
    dict(clip_vloss=True, norm_adv=False),
    dict(clip_vloss=False, norm_adv=False),
]


@pytest.mark.parametrize("switches", SWITCHES, ids=lambda s: f"vclip{int(s['clip_vloss'])}"
                         f"-norm{int(s['norm_adv'])}")
def test_agent_matches_jax_on_balance(monkeypatch, switches):
    run_both(monkeypatch, j_bb.Env(), t_bb.Env(), seed=0, **switches)


def test_agent_target_kl_stop_matches_jax_on_balance(monkeypatch):
    """A target KL far below one step's: the epoch whose pre-update KL
    exceeds it still applies its update, the later epochs are skipped."""
    trains = run_both(monkeypatch, j_bb.Env(), t_bb.Env(), seed=1, target_kl=1e-7)
    assert all(0 < applied < 4 for _, applied, _ in trains)  # the stop fired


@pytest.mark.parametrize("switches", [
    dict(clip_vloss=True, norm_adv=True),
    dict(clip_vloss=False, norm_adv=False, target_kl=1e-7),
], ids=["vclip1-norm1", "vclip0-norm0-kl"])
def test_agent_matches_jax_on_turn_based_hanabi(monkeypatch, switches):
    """very_small Hanabi, 2 players: the seats take turns, so rewards earned
    while a seat waits go to its last active slot, and those of a new game
    before the seat's first action are dropped (``new_game``)."""
    cfg = j_hanabi.CONFIGS["very_small"]
    trains = run_both(monkeypatch, j_hanabi.Env(**cfg), t_hanabi.Env(**t_hanabi.CONFIGS[
        "very_small"]), seed=2, **switches)
    if "target_kl" in switches:
        assert any(applied < 4 for _, applied, _ in trains)  # the stop fired


def _balance_agent(venv, seed):
    return t_ppo.CleanPPOAgent(venv, f"agent{seed}", num_updates=4, verbose=False,
                               num_steps=T, hidden=HIDDEN, lr=LR, seed=seed)


def test_agent_save_load_round_trip(tmp_path):
    """An agent loaded from a checkpoint into one of another seed acts and
    trains as the saved one does: same actions from the same observations,
    and equal parameters after the next train."""
    from madrona_rl_envs_playground_tpu_torch.api import RandomVectorAgent

    venvs, agents = [], []
    for seed in (3, 9):
        venv = DeviceVecEnv(t_bb.Env(), N, device="cpu")
        venv.add_partner_agent(RandomVectorAgent(4, seed=5, device="cpu"))
        venvs.append(venv)
        agents.append(_balance_agent(venv, seed))
    first, second = agents
    t_ppo.run_decentralized(venvs[0], first, T + 1)  # one train, one step after it
    path = str(tmp_path / "agent.pt")
    first.save(path)
    second.load(path)
    assert (second.updates, second.global_step) == (first.updates, first.global_step) == (2, T + 1)
    for a, b in zip(first.net.state_dict().values(), second.net.state_dict().values()):
        assert torch.equal(a, b)
    # the rollout buffer is not saved (nor in JAX): both start a fresh
    # window on the same observations, and train once in it
    venvs[1].partners[0][0].generator.set_state(venvs[0].partners[0][0].generator.get_state())
    for agent in agents:
        agent.step, agent.global_step = 0, 0
        agent.carry = t_ppo.init_carry(T, N, 7, 7, 4, "cpu")
    obs = [venvs[0].reset(), venvs[1].reset()]
    for _ in range(T + 1):
        acts = [agent.get_action(o) for agent, o in zip(agents, obs)]
        assert torch.equal(acts[0], acts[1])
        steps = [venv.step(a) for venv, a in zip(venvs, acts)]
        for agent, (o, r, d, _) in zip(agents, steps):
            agent.update(r, d)
        obs = [s[0] for s in steps]
    assert first.updates == second.updates == 3
    for a, b in zip(first.net.state_dict().values(), second.net.state_dict().values()):
        assert torch.equal(a, b)


def test_agent_entry_points_need_a_card_unless_asked_for_cpu(monkeypatch):
    class StubEnvs:  # a vector env on the card (the default device)
        device, num_envs = None, 2
        observation_space = share_observation_space = np.zeros((7,))
        action_space = type("Space", (), {"n": 4})()

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: t_ppo.init_carry(T, 2, 7, 7, 4),
                  lambda: t_ppo.CleanPPOAgent(StubEnvs(), "x", 1, verbose=False)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    venv = DeviceVecEnv(t_bb.Env(), 2, device="cpu")
    assert _balance_agent(venv, 0).carry.buf.obs.device.type == "cpu"

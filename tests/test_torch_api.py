"""The port's vector multi-agent API against the JAX package's.

Mirrors the contracts of ``tests/test_api.py``, ``tests/test_gym_interop.py``
and ``tests/test_baseline_envs.py`` on the port, and holds the port's
``DeviceVecEnv`` (on the CPU: each env's plain step, the CPU side of its
kernel) against JAX's ``TpuVecEnv`` and the gym wrappers against JAX's, on
the same actions from numpy seeds.

Tolerances: integer fields (int obs, masks, active flags, dones, integer
rewards, episode counters) exactly.  Cartpole and Acrobot observations are
float32 physics, which XLA and PyTorch on the CPU round differently in the
last bit (a reset's draw already differs by up to 4e-9), so they are held at
``tests/test_torch_cartpole.py``'s and ``test_torch_acrobot.py``'s
free-running ``atol 1e-4``; their rewards and dones exactly.  Balance Beam
is integer and exact, the Balance Beam gym wrapper included.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_rl_envs_playground_tpu.api import SyncVectorEnv as JSyncVectorEnv
from madrona_rl_envs_playground_tpu.api import TpuVecEnv
from madrona_rl_envs_playground_tpu.api import gym_interop as j_gym
from madrona_rl_envs_playground_tpu.envs import acrobot as j_acrobot
from madrona_rl_envs_playground_tpu.envs import balance_beam as j_bb
from madrona_rl_envs_playground_tpu.envs import cartpole as j_cartpole
from madrona_rl_envs_playground_tpu.envs import hanabi as j_hanabi
from madrona_rl_envs_playground_tpu.envs import overcooked as j_oc
from madrona_rl_envs_playground_tpu.envs.layouts import get_base_layout_params
from madrona_rl_envs_playground_tpu.oracles.adapters import (BalanceOracleEnv, CartpoleOracleEnv,
                                                             HanabiOracleEnv, OvercookedOracleEnv)
from madrona_rl_envs_playground_tpu_torch.api import (AsyncVectorEnv, BalanceVecGym,
                                                      CartpoleVecGym, DeviceVecEnv,
                                                      PlayerException, RandomVectorAgent,
                                                      SyncVectorEnv, VectorObservation)
from madrona_rl_envs_playground_tpu_torch.envs import acrobot as t_acrobot
from madrona_rl_envs_playground_tpu_torch.envs import balance_beam as t_bb
from madrona_rl_envs_playground_tpu_torch.envs import cartpole as t_cartpole
from madrona_rl_envs_playground_tpu_torch.envs import hanabi as t_hanabi
from madrona_rl_envs_playground_tpu_torch.envs import overcooked as t_oc
from madrona_rl_envs_playground_tpu_torch.envs import overcooked2 as t_oc2

CPU = "cpu"
FREE_TOL = dict(rtol=0, atol=1e-4)


# ---- the contracts of tests/test_api.py ------------------------------------

def test_vectorobservation_state_defaults_to_obs():
    obs = torch.ones((4, 3))
    v = VectorObservation(active=torch.ones(4, dtype=torch.bool), obs=obs)
    assert v.state is obs
    assert v.action_mask is None


def test_device_vecenv_step_loop_balance():
    env = t_bb.Env()
    venv = DeviceVecEnv(env, num_envs=8, device=CPU)
    venv.add_partner_agent(RandomVectorAgent(env.num_actions, seed=1, device=CPU))
    ego_sampler = RandomVectorAgent(env.num_actions, seed=2, device=CPU)
    obs = venv.reset()
    assert obs.obs.shape == (8, env.obs_size)
    total, dones = 0.0, 0
    for _ in range(7):  # crosses the 3-step episode boundary
        act = ego_sampler.get_action(obs)
        assert act.dtype == torch.int32 and act.shape == (8,)
        obs, rew, done, _ = venv.step(act)
        assert rew.shape == (8,) and done.shape == (8,)
        total += float(rew.sum())
        dones += int(done.sum())
    assert np.isfinite(total) and dones > 0


def test_device_vecenv_multiplayer_seats():
    env = t_oc2.make("simple")
    venv = DeviceVecEnv(env, num_envs=4, device=CPU)
    venv.add_partner_agent(RandomVectorAgent(env.num_actions, seed=3, device=CPU))
    venv.reset()
    seats, rews, done, _ = venv.n_step(torch.zeros((2, 4), dtype=torch.int32))
    assert len(seats) == 2
    assert rews.shape == (2, 4)
    assert seats[0].obs.shape == (4, env.obs_size)
    assert seats[0].obs.dtype == torch.int8
    assert venv.observation_space.shape == (env.obs_size,)
    assert venv.action_space.n == env.num_actions


def test_partner_management_errors():
    env = t_bb.Env()
    venv = DeviceVecEnv(env, num_envs=2, device=CPU)
    with pytest.raises(PlayerException):
        venv.add_partner_agent(RandomVectorAgent(env.num_actions, device=CPU), player_num=0)
    venv.add_partner_agent(RandomVectorAgent(env.num_actions, seed=4, device=CPU))
    venv.add_partner_agent(RandomVectorAgent(env.num_actions, seed=5, device=CPU))
    venv.reset()
    first = venv.partnerids[0]
    venv.reset()
    assert venv.partnerids[0] == (first + 1) % 2  # round-robin resample
    agent = RandomVectorAgent(env.num_actions, device=CPU)
    with pytest.raises(PlayerException, match="number of partners"):
        DeviceVecEnv(env, 2, partners=[[agent], [agent]], device=CPU)
    with pytest.raises(PlayerException, match="nonempty"):
        DeviceVecEnv(env, 2, partners=[[]], device=CPU)
    with pytest.raises(PlayerException, match="Invalid"):
        DeviceVecEnv(env, 2, resample_policy="nearest", device=CPU)
    three = t_hanabi.Env(colors=2, ranks=5, players=3, max_information_tokens=3,
                         max_life_tokens=2)
    with pytest.raises(PlayerException, match="round robin"):
        DeviceVecEnv(three, 2, resample_policy="robin", device=CPU)
    venv3 = DeviceVecEnv(three, 2, device=CPU)  # default: random for 3 players
    assert venv3.resample_partner == venv3.resample_random
    venv3.add_partner_agent(agent, player_num=2)
    assert venv3.partners[1] == [agent] and venv3._get_partner_num(1) == 0
    # sharding: a mesh of this one process steps every world, as unsharded
    from madrona_rl_envs_playground_tpu_torch.parallel import make_mesh

    sharded = DeviceVecEnv(env, 2, sharding=make_mesh(device=CPU))
    plain = DeviceVecEnv(env, 2, device=CPU)
    assert sharded.num_envs == 2 and sharded.device.type == "cpu"
    for a, b in zip(sharded.n_reset(), plain.n_reset()):
        assert torch.equal(a.obs, b.obs)
    acts = torch.ones((env.num_agents, 2), dtype=torch.int32)
    (sa, sr, sd, _), (pa, pr, pd, _) = sharded.n_step(acts), plain.n_step(acts)
    assert torch.equal(sr, pr) and torch.equal(sd, pd)


def test_random_agent_draws_legal_actions():
    agent = RandomVectorAgent(5, seed=0, device=CPU)
    mask = torch.zeros((64, 5), dtype=torch.bool)
    mask[:, 3] = True
    mask[::2, 1] = True
    obs = VectorObservation(active=torch.ones(64, dtype=torch.bool), obs=torch.zeros(64, 1),
                            action_mask=mask)
    a = agent.get_action(obs)
    assert a.dtype == torch.int32
    assert bool(mask[torch.arange(64), a.long()].all())
    assert set(a[::2].tolist()) == {1, 3}
    free = agent.get_action(VectorObservation(active=obs.active, obs=obs.obs))
    assert int(free.min()) >= 0 and int(free.max()) < 5


# ---- DeviceVecEnv against TpuVecEnv -----------------------------------------

def _envs(name):
    if name == "balance":
        return j_bb.Env(), t_bb.Env()
    if name == "cartpole":
        return j_cartpole.Env(), t_cartpole.Env()
    if name == "acrobot":
        return j_acrobot.Env(), t_acrobot.Env()
    if name == "hanabi":
        return j_hanabi.Env(**j_hanabi.CONFIGS["full"]), t_hanabi.Env(**t_hanabi.CONFIGS["full"])
    return j_oc.make("cramped_room", horizon=20), t_oc.make("cramped_room", horizon=20)


# env -> steps, enough that episodes end (Acrobot's from step counts set near
# its 501-step limit)
VEC_STEPS = {"balance": 10, "cartpole": 60, "acrobot": 30, "hanabi": 60, "overcooked": 45}


def _stagger_acrobot(j_venv, t_venv):
    """Both batches' step counts set to 480 + n % 16, so every episode
    reaches the 501-step limit within 30 steps."""
    N = t_venv.num_envs
    steps = (480 + np.arange(N) % 16).astype(np.int32)
    bs = j_venv.sim.bstate
    j_venv.sim.bstate = bs.replace(env_states=bs.env_states.replace(steps=jnp.asarray(steps)))
    tb = t_venv.bstate
    t_venv.bstate = dataclasses.replace(
        tb, env_states=dataclasses.replace(tb.env_states, steps=torch.from_numpy(steps)))


def _assert_seats(t_seats, j_seats, float_obs, what):
    for p, (t, j) in enumerate(zip(t_seats, j_seats)):
        for f in ("obs", "state", "action_mask", "active"):
            got, ref = getattr(t, f).numpy(), np.asarray(getattr(j, f))
            if float_obs and f in ("obs", "state"):
                np.testing.assert_allclose(got, ref, **FREE_TOL, err_msg=f"{what} seat {p} {f}")
            else:
                np.testing.assert_array_equal(got, ref, err_msg=f"{what} seat {p} {f}")


@pytest.mark.parametrize("name", list(VEC_STEPS))
def test_device_vecenv_matches_tpu_vecenv(name):
    N = 8
    j_env, t_env = _envs(name)
    j_venv, t_venv = TpuVecEnv(j_env, num_envs=N), DeviceVecEnv(t_env, num_envs=N, device=CPU)
    float_obs = t_env.obs_dtype == torch.float32
    _assert_seats(t_venv.n_reset(), j_venv.n_reset(), float_obs, "reset")
    assert t_venv._collect.kernel  # the kernel's collector (its plain version on the CPU)
    if name == "acrobot":
        _stagger_acrobot(j_venv, t_venv)
    rs = np.random.RandomState(7)
    out = t_venv.last_out
    dones = 0
    for t in range(VEC_STEPS[name]):
        mask = out.action_mask.numpy()
        acts = np.array([[rs.choice(np.nonzero(mask[n, p])[0]) for n in range(N)]
                         for p in range(t_env.num_agents)], np.int32)  # [P, N]
        j_seats, j_rew, j_done, _ = j_venv.n_step(jnp.asarray(acts))
        seats, rew, done, _ = t_venv.n_step(torch.from_numpy(acts))
        out = t_venv.last_out
        _assert_seats(seats, j_seats, float_obs, f"t={t}")
        np.testing.assert_array_equal(rew.numpy(), np.asarray(j_rew), err_msg=f"t={t} reward")
        np.testing.assert_array_equal(done.numpy(), np.asarray(j_done), err_msg=f"t={t} done")
        assert rew.shape == (t_env.num_agents, N)
        dones += int(done.sum())
    assert dones > 0, f"{name}: no episode ended in {VEC_STEPS[name]} steps"
    assert int(t_venv.bstate.episode_counter) == int(np.asarray(
        j_venv.sim.bstate.episode_counter).astype(np.uint32))


# ---- the gym wrappers -------------------------------------------------------

def test_cartpole_vec_gym_matches_jax():
    N = 8
    j, t = j_gym.CartpoleVecGym(N), CartpoleVecGym(N, device=CPU)
    obs = t.reset()
    assert obs.shape == (N, 4) and obs.dtype == np.float32
    np.testing.assert_allclose(obs, j.reset(), **FREE_TOL)
    assert t.single_action_space.n == 2
    np.testing.assert_array_equal(t.single_observation_space.high,
                                  j.single_observation_space.high)
    rs = np.random.RandomState(0)
    saw_done = False
    for step in range(250):
        acts = rs.randint(0, 2, size=N)
        obs, rew, done, infos = t.step(acts)
        j_obs, j_rew, j_done, _ = j.step(acts)
        assert obs.shape == (N, 4) and rew.shape == (N,) and done.shape == (N,)
        np.testing.assert_allclose(obs, j_obs, **FREE_TOL, err_msg=f"step {step}")
        np.testing.assert_array_equal(rew, j_rew)
        np.testing.assert_array_equal(done, j_done)
        assert len(infos) == N and len({id(i) for i in infos}) == N  # distinct dicts
        assert np.all(np.abs(obs[:, 0]) <= t.single_observation_space.high[0])
        saw_done = saw_done or bool(done.any())
    assert saw_done, "random cartpole must terminate within 250 steps"


def test_balance_vec_gym_matches_jax_exactly():
    N = 8
    j, t = j_gym.BalanceVecGym(N, seed=3), BalanceVecGym(N, seed=3, device=CPU)
    obs = t.reset()
    assert obs.shape == (N, 7) and obs.dtype == np.float32
    np.testing.assert_array_equal(obs, j.reset())
    assert t.single_action_space.n == 4
    assert tuple(t.single_observation_space.nvec) == tuple(j.single_observation_space.nvec)
    rs = np.random.RandomState(1)
    dones, last_infos = 0, None
    for _ in range(12):
        acts = rs.randint(0, 4, size=N)
        obs, rew, done, infos = t.step(acts)
        j_obs, j_rew, j_done, _ = j.step(acts)
        np.testing.assert_array_equal(obs, j_obs)
        np.testing.assert_array_equal(rew, j_rew)
        np.testing.assert_array_equal(done, j_done)
        assert infos is not last_infos and infos[0] is not infos[1]
        last_infos = infos
        dones += int(done.sum())
    assert dones > 0, "balance episodes are 3 steps; 12 steps must see dones"


def test_balance_vec_gym_custom_partner():
    N = 8
    calls = []

    def partner(obs):
        calls.append(obs.shape)
        return np.zeros(N, dtype=np.int64)

    env = BalanceVecGym(N, partner_fn=partner, device=CPU)
    env.reset()
    env.step(np.zeros(N, dtype=np.int64))
    assert calls == [(N, 7)]


def test_gym_wrappers_without_gymnasium(monkeypatch):
    """Where gymnasium is not installed the wrappers take the port's
    metadata spaces, with the same shapes and sizes."""
    from madrona_rl_envs_playground_tpu_torch.api import gym_interop, spaces

    monkeypatch.setattr(gym_interop, "_spaces", spaces)
    cart, bal = CartpoleVecGym(4, device=CPU), BalanceVecGym(4, device=CPU)
    assert isinstance(cart.single_observation_space, spaces.Box)
    assert cart.single_observation_space.shape == (4,)
    np.testing.assert_array_equal(cart.single_observation_space.high,
                                  j_gym.CartpoleVecGym(4).single_observation_space.high)
    assert cart.single_action_space.n == 2 and bal.single_action_space.n == 4
    assert bal.single_observation_space.nvec == (9,) * 6 + (3,)
    assert cart.step(np.zeros(4))[0].shape == (4, 4)


# ---- SyncVectorEnv and AsyncVectorEnv over the oracle adapters -------------

def test_sync_cartpole_rollout_matches_jax_sync():
    fns = [functools.partial(CartpoleOracleEnv, seed=i) for i in range(4)]
    t, j = SyncVectorEnv(fns, device=CPU), JSyncVectorEnv(fns)
    _assert_seats(t.n_reset(), j.n_reset(), False, "reset")
    for step in range(30):
        acts = np.zeros((1, 4), np.int32) + step % 2
        seats, rews, dones, _ = t.n_step(torch.from_numpy(acts))
        j_seats, j_rews, j_dones, _ = j.n_step(jnp.asarray(acts))
        assert rews.shape == (1, 4)
        _assert_seats(seats, j_seats, False, f"step {step}")
        np.testing.assert_array_equal(rews.numpy(), np.asarray(j_rews))
        np.testing.assert_array_equal(dones.numpy(), np.asarray(j_dones))


def test_sync_overcooked_matches_device_vecenv():
    params = get_base_layout_params("simple", 30, variant="v2")
    N = 4
    sync = SyncVectorEnv([functools.partial(OvercookedOracleEnv, "v2", params)] * N,
                         device=CPU)
    venv = DeviceVecEnv(t_oc2.make("simple", horizon=30), N, device=CPU)
    sync.n_reset()
    venv.n_reset()
    rs = np.random.RandomState(0)
    for t in range(40):
        a = rs.randint(0, 6, size=(2, N)).astype(np.int32)
        seats, rews, dones, _ = sync.n_step(torch.from_numpy(a))
        v_seats, v_rews, v_dones, _ = venv.n_step(torch.from_numpy(a))
        np.testing.assert_array_equal(dones.numpy(), v_dones.numpy())
        np.testing.assert_array_equal(rews.numpy(), v_rews.numpy(), err_msg=f"t={t}")
        for p in range(2):
            np.testing.assert_array_equal(seats[p].obs.numpy().astype(np.int8),
                                          v_seats[p].obs.numpy(), err_msg=f"t={t}")


def test_sync_hanabi_turn_based_active():
    fn = functools.partial(HanabiOracleEnv, colors=2, ranks=3, players=2,
                           max_information_tokens=3, max_life_tokens=2)
    venv = SyncVectorEnv([fn] * 3, device=CPU)
    obs = venv.n_reset()
    assert bool(obs[0].active.all()) and not bool(obs[1].active.any())
    masks = obs[0].action_mask.numpy()
    acts = np.zeros((2, 3), np.int32)
    for i in range(3):
        acts[0, i] = int(np.nonzero(masks[i])[0][0])
    obs, rews, dones, _ = venv.n_step(torch.from_numpy(acts))
    assert not bool(obs[0].active.any()) and bool(obs[1].active.all())


def test_async_balance_rollout_matches_sync():
    """Constructors are ``functools.partial``s, so pickle carries them where
    cloudpickle is not installed."""
    fns = [functools.partial(BalanceOracleEnv, seed=i) for i in range(3)]
    venv = AsyncVectorEnv(fns, device=CPU)
    sync = SyncVectorEnv(fns, device=CPU)
    try:
        obs = venv.n_reset()
        assert obs[0].obs.shape == (3, 7)
        _assert_seats(obs, sync.n_reset(), False, "reset")
        total = 0.0
        for step in range(7):
            acts = torch.ones((2, 3), dtype=torch.int32)
            obs, rews, dones, _ = venv.n_step(acts)
            s_obs, s_rews, s_dones, _ = sync.n_step(acts)
            _assert_seats(obs, s_obs, False, f"step {step}")
            np.testing.assert_array_equal(rews.numpy(), s_rews.numpy())
            np.testing.assert_array_equal(dones.numpy(), s_dones.numpy())
            total += float(rews.sum())
        assert np.isfinite(total)
    finally:
        venv.close()
    # close() joins each worker for 2 s, as JAX's does; a worker that has
    # imported torch may take longer than that to exit on a loaded machine,
    # so wait for each with a limit of its own before checking that all ended
    for p in venv.procs:
        p.join(timeout=60)
    assert not any(p.is_alive() for p in venv.procs)


# ---- the card ---------------------------------------------------------------

def test_api_entry_points_need_a_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fns = [functools.partial(BalanceOracleEnv, seed=0)]
    for build in (lambda: DeviceVecEnv(t_bb.Env(), 2),
                  lambda: RandomVectorAgent(4),
                  lambda: SyncVectorEnv(fns),
                  lambda: AsyncVectorEnv(fns),
                  lambda: CartpoleVecGym(2),
                  lambda: BalanceVecGym(2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    assert DeviceVecEnv(t_bb.Env(), 2, device="cpu").device.type == "cpu"

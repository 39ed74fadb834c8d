"""The port's env-axis data parallelism (``parallel/``) against the JAX
package and against the port's own single-process runs.

One gloo group of 4 CPU ranks, joined through a ``FileStore`` under
``tmp_path`` (a TCP port would collide between test workers), runs every
rank-side check of this module once (``tests/torch_parallel_ranks.py``);
the tests then hold what the ranks returned:

* the sharded plain step (``Simulator(mesh=)``), N = 32 over 12 steps of
  JAX's sharded-step actions, on Cartpole, Balance Beam, Overcooked2 simple
  and very_small Hanabi: against JAX's single-device ``batched_step``,
  integer fields and the episode counter exact on every rank, floats within
  Cartpole's free-running tolerance (``atol 1e-4``); against the port's
  unsharded step, every field exact;
* ``DeviceVecEnv(sharding=)`` against JAX's ``TpuVecEnv`` on one device,
  the same legal actions, on Cartpole, full Hanabi and cramped_room: every
  rank's seat views, rewards and dones as ``tests/test_torch_api.py`` holds
  the unsharded env's, and the episode counter on every rank;
* ``SelfPlayPPO(mesh=)`` and ``MAPPORunner(mesh=)`` against JAX's
  single-device trainers: one update from JAX's parameters on the same
  injected actions (and, for MAPPO's minibatches, JAX's permutations), on
  every rank the metrics, the ValueNorm statistics and every parameter delta
  at the trainer tests' tolerances (``tests/test_torch_train.py``,
  ``tests/test_torch_mappo.py``): self-play with rank-local T-axis chunks,
  with JAX's gathered fallback and on Hanabi's active-slot means; MAPPO with
  one minibatch (the env axis local), two (gathered) and timestep bands;
* the same trainers against the unsharded port from the same seed, 2
  updates (self-play) or one episode (MAPPO; one minibatch, two and bands)
  of sampled actions, at JAX's mesh tolerances
  (``tests/test_multidevice.py``: metrics ``rtol 2e-3, atol 2e-3``,
  parameters ``rtol 5e-3, atol 5e-4``), and every rank's parameters equal;
* ``shard_local_minibatch`` on 4 ranks against 1, and the port's ``train``
  with JAX's band permutation against JAX's, at the MAPPO tests'
  tolerances.

Every join has a generous limit of its own; nothing asserts how fast a
rank runs.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_rl_envs_playground_tpu.api import TpuVecEnv
from madrona_rl_envs_playground_tpu.core.batch import batched_reset as j_reset
from madrona_rl_envs_playground_tpu.core.batch import batched_step as j_step
from madrona_rl_envs_playground_tpu.envs import balance_beam as j_bb
from madrona_rl_envs_playground_tpu.envs import cartpole as j_cp
from madrona_rl_envs_playground_tpu.envs import hanabi as j_hanabi
from madrona_rl_envs_playground_tpu.envs import overcooked2 as j_oc2
from madrona_rl_envs_playground_tpu.train import mappo as jm
from madrona_rl_envs_playground_tpu_torch.models import mappo_nets as t_nets
from madrona_rl_envs_playground_tpu_torch.parallel import launch, make_mesh
from madrona_rl_envs_playground_tpu_torch.train import mappo as tm

from . import torch_parallel_ranks as ranks
from .test_torch_api import FREE_TOL as API_FREE_TOL
from .test_torch_api import _envs as _api_envs
from .test_torch_hanabi_train import _legal_schedule
from .test_torch_hanabi_train import _trainers as hanabi_trainers
from .test_torch_mappo import (_assert_update_matches, _assert_vn, _filled_buffers,
                               _jax_collect_injected, _np, _params_of, _policies)
from .test_torch_train import _np_params, _trainers, assert_deltas_match_jax, jax_rollout_injected

WORLD = 4
METRIC_TOL = dict(rtol=2e-3, atol=2e-3)
PARAM_TOL = dict(rtol=5e-3, atol=5e-4)
FLOAT_TOL = dict(rtol=0, atol=1e-4)
MAPPO_KEY = jax.random.PRNGKey(3)  # JAX's MAPPO minibatch permutations


def _jax_cases():
    """JAX's single-device trainers of SELFPLAY_VS_JAX and MAPPO_VS_JAX,
    each with the ranks' inputs: JAX's parameters, the actions and MAPPO's
    permutations."""
    selfplay = {}
    for name, c in ranks.SELFPLAY_VS_JAX.items():
        if c["env"] == "hanabi":
            jt, _ = hanabi_trainers()
            acts = _legal_schedule()
        else:
            jt, _ = _trainers(T=c["num_steps"], nmb=c["num_minibatches"],
                              num_envs=c["num_envs"])
            rs = np.random.RandomState(4)
            acts = rs.choice(6, size=(c["num_steps"], c["num_envs"], 2),
                             p=[.15, .15, .15, .15, .05, .35]).astype(np.int32)
        selfplay[name] = {"trainer": jt, "inputs": (_np_params(jt.state["params"]), acts)}
    mappo = {}
    env = j_oc2.make("cramped_room", horizon=6)
    base = ranks.MAPPO_VS_JAX_BASE
    T, N, A = base["episode_length"], base["n_rollout_threads"], env.num_agents
    acts = np.random.RandomState(8).randint(0, env.num_actions, size=(T, N, A)).astype(np.int32)
    for name, case in ranks.MAPPO_VS_JAX.items():
        cfg = jm.MAPPOConfig(**base, **case)
        jr = jm.MAPPORunner(cfg, env)
        ps = jr.trainer.state.policy
        perms = None
        if cfg.num_mini_batch > 1:
            n = T if cfg.shard_local_minibatch else T * N * A
            perms = [np.asarray(jax.random.permutation(k, n)).astype(np.int64)
                     for k in jax.random.split(MAPPO_KEY, cfg.ppo_epoch)]
        mappo[name] = {"runner": jr,
                       "inputs": ((_np(ps.actor_params), _np(ps.critic_params)), acts, perms)}
    vecenv = {name: {"inputs": (ranks.vecenv_actions(name),)} for name in ranks.VECENV_STEPS}
    return {"vecenv": vecenv, "selfplay": selfplay, "mappo": mappo}


def _jax_vecenv(name, actions):
    """JAX's ``TpuVecEnv`` on one device stepped with ``actions``: what
    ``ranks.vecenv`` returns, for the whole batch."""
    j_env, _ = _api_envs(name)
    venv = TpuVecEnv(j_env, num_envs=ranks.VECENV_N)
    seats, rewards, dones = [venv.n_reset()], [], []
    for a in actions:
        s, r, d, _ = venv.n_step(jnp.asarray(a))
        seats.append(s)
        rewards.append(np.asarray(r))
        dones.append(np.asarray(d))
    return {"seats": {f: np.stack([np.stack([np.asarray(getattr(v, f)) for v in s])
                                   for s in seats]) for f in ranks.SEAT_FIELDS},
            "reward": np.stack(rewards), "done": np.stack(dones),
            "counter": int(np.asarray(venv.sim.bstate.episode_counter).astype(np.uint32))}


def _jax_updates(cases):
    """Each case's run on JAX's single device: the vector env's steps and
    the trainers' updates."""
    for name, case in cases["vecenv"].items():
        case.update(_jax_vecenv(name, case["inputs"][0]))
    rollouts = {}
    for name, case in cases["selfplay"].items():
        jt, acts = case["trainer"], case["inputs"][1]
        # the cramped_room cases share JAX's rollout: the same parameters
        # (seed 0), actions and env; only the minibatches differ
        env = ranks.SELFPLAY_VS_JAX[name]["env"]
        if env not in rollouts:
            rollouts[env] = jax_rollout_injected(jt, acts)
        _, j_out, j_tr = rollouts[env]
        params0 = jt.state["params"]
        chunks, stats = jt._advantage(params0, j_tr, j_out)
        params1, _, auxes = jt._update(params0, jt.state["opt_state"], chunks)
        case.update(params0=params0, params1=params1, stats=stats,
                    losses=dict(zip(("pg_loss", "v_loss", "entropy", "approx_kl"),
                                    (float(a[-1]) for a in auxes))))
    j_buf = None
    base = ranks.MAPPO_VS_JAX_BASE
    for case in cases["mappo"].values():
        jr, acts = case["runner"], case["inputs"][1]
        if j_buf is None:  # one collect serves every case: the same parameters and actions
            _, j_out, _, j_rnnc, j_masks, _, j_tr = _jax_collect_injected(jr, acts)
            j_buf = jr._compute(jr.trainer.state, jr._tr_to_buffer(
                j_tr, j_masks, j_out.active.astype(jnp.float32)), j_out, j_rnnc, j_masks)
            T, N, A = acts.shape
            score = float(np.asarray(j_tr["rewards"]).reshape(T, N, A)[:, :, 0].sum()) / N
        state0 = jr.trainer.state
        state1, info = jr.trainer.train(state0, j_buf, MAPPO_KEY,
                                        (jnp.float32(base["lr"]), jnp.float32(base["critic_lr"])))
        case.update(state0=state0, state1=state1, score=score,
                    info={k: float(v) for k, v in info.items()})
    return cases


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(every rank's results in rank order, JAX's runs): the ranks start
    once JAX's parameters and actions are ready, and run while JAX computes
    its updates."""
    cases = _jax_cases()
    inputs = {part: {name: case["inputs"] for name, case in part_cases.items()}
              for part, part_cases in cases.items()}
    store = tmp_path_factory.mktemp("ranks")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks_done = pool.submit(launch.spawn, ranks.run_all, WORLD, (inputs,),
                                 store_dir=str(store), backend="gloo", device="cpu",
                                 timeout_s=600, threads=1)
        jax_runs = _jax_updates(cases)
        return ranks_done.result(), jax_runs


@pytest.fixture(scope="module")
def sharded(runs):
    return runs[0]


@pytest.fixture(scope="module")
def jax_runs(runs):
    return runs[1]


@pytest.fixture(scope="module")
def single():
    return {"steps": {n: ranks.steps(None, n) for n in ranks.STEP_ENVS},
            "selfplay": {n: ranks.selfplay(None, n) for n in ranks.SELFPLAY},
            "mappo": {n: ranks.mappo(None, n) for n in ranks.MAPPO}}


def _jax_env(name):
    if name == "cartpole":
        return j_cp.Env()
    if name == "balance":
        return j_bb.Env()
    if name == "overcooked2":
        return j_oc2.make("simple", horizon=20)
    return j_hanabi.Env(**j_hanabi.CONFIGS["very_small"])


def _gathered(sharded, name, field):
    return torch.cat([r["steps"][name]["fields"][field] for r in sharded], 1)


@pytest.mark.parametrize("name", ranks.STEP_ENVS)
def test_sharded_step_matches_jax_single_device(sharded, name):
    env = _jax_env(name)
    acts = ranks.step_actions(ranks.step_env(name))
    step = jax.jit(j_step, static_argnums=(0,))
    bstate, _ = j_reset(env, ranks.N)
    counters = [int(bstate.episode_counter)]
    outs = []
    for t in range(ranks.STEPS):
        bstate, out = step(env, bstate, jnp.asarray(acts[t]))
        outs.append(out)
        counters.append(int(bstate.episode_counter))
    for r in sharded:
        np.testing.assert_array_equal(r["steps"][name]["counter"].numpy(), counters)
    for f in ranks.FIELDS:
        ref = np.stack([np.asarray(getattr(o, f)) for o in outs])
        got = _gathered(sharded, name, f).numpy()
        assert got.shape == ref.shape, f
        if np.issubdtype(ref.dtype, np.floating):
            np.testing.assert_allclose(got, ref, **FLOAT_TOL, err_msg=f"{name} {f}")
        else:
            np.testing.assert_array_equal(got, ref, err_msg=f"{name} {f}")


@pytest.mark.parametrize("name", ranks.STEP_ENVS)
def test_sharded_step_equals_unsharded(sharded, single, name):
    for f in ranks.FIELDS:
        assert torch.equal(_gathered(sharded, name, f), single["steps"][name]["fields"][f]), f
    for r in sharded:
        assert torch.equal(r["steps"][name]["counter"], single["steps"][name]["counter"])


def _assert_params(sharded_trees, single_tree):
    """Every rank's parameters equal rank 0's, and those within the mesh
    tolerances of the single-process run's."""
    for tree in sharded_trees[1:]:
        for k, v in tree.items():
            assert torch.equal(v, sharded_trees[0][k]), k
    for k, v in single_tree.items():
        np.testing.assert_allclose(sharded_trees[0][k].numpy(), v.numpy(), **PARAM_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("name", list(ranks.SELFPLAY))
def test_selfplay_on_a_mesh_matches_single(sharded, single, name):
    want = single["selfplay"][name]
    for r in sharded:
        for got_m, want_m in zip(r["selfplay"][name]["metrics"], want["metrics"]):
            for k in want_m:
                np.testing.assert_allclose(got_m[k], want_m[k], **METRIC_TOL, err_msg=k)
    _assert_params([r["selfplay"][name]["params"] for r in sharded], want["params"])


@pytest.mark.parametrize("name", list(ranks.MAPPO))
def test_mappo_runner_on_a_mesh_matches_single(sharded, single, name):
    want = single["mappo"][name]
    for r in sharded:
        got = r["mappo"][name]
        for k in want["info"]:
            np.testing.assert_allclose(got["info"][k], want["info"][k], **METRIC_TOL,
                                       err_msg=k)
        np.testing.assert_allclose(got["episode_rewards"], want["episode_rewards"],
                                   **METRIC_TOL)
    for net in ("actor", "critic"):
        _assert_params([r["mappo"][name][net] for r in sharded], want[net])


@pytest.mark.parametrize("name", list(ranks.VECENV_STEPS))
def test_device_vecenv_sharded_matches_tpu_vecenv(sharded, jax_runs, name):
    want = jax_runs["vecenv"][name]
    assert want["done"].any(), f"{name}: no episode ended"
    for r in sharded:
        got = r["vecenv"][name]
        assert int(got["counter"]) == want["counter"]
    float_obs = ranks.vecenv_env(name).obs_dtype == torch.float32
    for f in ranks.SEAT_FIELDS:  # [steps + 1, P, N, ...], the ranks' columns side by side
        got = torch.cat([r["vecenv"][name]["seats"][f] for r in sharded], 2).numpy()
        if float_obs and f in ("obs", "state"):
            np.testing.assert_allclose(got, want["seats"][f], **API_FREE_TOL, err_msg=f)
        else:
            np.testing.assert_array_equal(got, want["seats"][f], err_msg=f)
    np.testing.assert_array_equal(
        torch.cat([r["vecenv"][name]["reward"] for r in sharded], 2).numpy(), want["reward"])
    np.testing.assert_array_equal(
        torch.cat([r["vecenv"][name]["done"] for r in sharded], 1).numpy(), want["done"])


@pytest.mark.parametrize("name", list(ranks.SELFPLAY_VS_JAX))
def test_selfplay_on_a_mesh_matches_jax(sharded, jax_runs, name):
    """Every rank's update, from JAX's parameters on JAX's actions, against
    JAX's single-device update: the last epoch's losses ``rtol 1e-4`` (and
    within 1e-5), the mean step reward and value ``atol 1e-5``, and every
    parameter delta as ``tests/test_torch_train.py`` holds one process's."""
    want = jax_runs["selfplay"][name]
    for r in sharded:
        got = r["selfplay_vs_jax"][name]
        for k, v in want["losses"].items():
            np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-4, atol=1e-7, err_msg=k)
            assert abs(got["metrics"][k] - v) <= 1e-5, k
        for k, v in want["stats"].items():
            np.testing.assert_allclose(got["metrics"][k], float(v), rtol=0, atol=1e-5,
                                       err_msg=k)
        assert_deltas_match_jax(got["before"], got["after"], want["params0"], want["params1"])


def _port_nets(state):
    """A JAX MAPPO policy state's parameters, named as the port's nets name
    them."""
    cfg = tm.MAPPOConfig(**ranks.MAPPO_VS_JAX_BASE)
    env = ranks.mappo_env()
    pol = tm.MAPPOPolicy(cfg, (env.obs_size,), (env.state_size,), env.num_actions, seed=0,
                         device="cpu")
    t_nets.load_mappo_params(pol.actor, pol.critic, _np(state.policy.actor_params),
                             _np(state.policy.critic_params))
    return {net: dict(getattr(pol, net).named_parameters()) for net in ("actor", "critic")}


@pytest.mark.parametrize("name", list(ranks.MAPPO_VS_JAX))
def test_mappo_runner_on_a_mesh_matches_jax(sharded, jax_runs, name):
    """Every rank's ``update``, from JAX's parameters on JAX's actions and
    permutations, against JAX's collect, returns and ``train``: the info
    ``rtol 1e-4, atol 1e-6``, the episode score, the ValueNorm statistics
    and every parameter delta as ``tests/test_torch_mappo.py`` holds one
    process's."""
    want = jax_runs["mappo"][name]
    j0, j1 = _port_nets(want["state0"]), _port_nets(want["state1"])
    for r in sharded:
        got = r["mappo_vs_jax"][name]
        for k, v in want["info"].items():
            np.testing.assert_allclose(got["info"][k], v, rtol=1e-4, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(got["score"], want["score"], rtol=1e-6, atol=1e-6)
        _assert_vn(tm.ValueNormState(**got["vn"]), want["state1"].vn)
        for net in ("actor", "critic"):
            for k, p0 in j0[net].items():
                np.testing.assert_allclose((got["after"][net][k] - got["before"][net][k]).numpy(),
                                           (j1[net][k] - p0).detach().numpy(), rtol=1e-4,
                                           atol=1e-6, err_msg=f"{net} {k}")


def test_shard_local_minibatch_matches_jax_on_its_band_permutation():
    """Timestep bands ``[T / 3, M, ...]`` from JAX's permutation of T, on
    one device: the info, the ValueNorm statistics and every parameter
    delta, as the MAPPO tests hold a flat-minibatch train."""
    j_tr, t_tr = _policies(num_mini_batch=3, shard_local_minibatch=True, use_valuenorm=True)
    j_buf, t_buf = _filled_buffers(j_tr)
    T = t_buf.rewards.shape[0]
    key = jax.random.PRNGKey(4)
    perms = [torch.from_numpy(np.asarray(jax.random.permutation(k, T)).astype(np.int64))
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


def test_shard_local_minibatch_refuses_bands_that_do_not_divide_t():
    j_tr, t_tr = _policies(num_mini_batch=4, shard_local_minibatch=True)
    _, t_buf = _filled_buffers(j_tr)
    with pytest.raises(ValueError, match="shard_local_minibatch"):
        t_tr.train(t_buf)


def test_initialize_is_a_no_op_for_a_single_process(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert launch.initialize(device="cpu") is False
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert launch.initialize(device="cpu") is False
    assert launch.is_primary()
    mesh = make_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.rows(8)) == (1, 0, slice(0, 8))
    with pytest.raises(ValueError, match="process group"):
        make_mesh(2, device="cpu")

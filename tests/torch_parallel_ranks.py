"""What the ranks of ``tests/test_torch_parallel.py`` run.

A module of its own, importing only the port, so that each spawned rank
imports neither JAX nor the test module.  Every function takes a mesh
(``parallel.mesh.Mesh``), or None for the single-process run it is held
against, and returns tensors and numbers only.  What the ranks need of the
JAX package (its trainers' parameters, as numpy trees, and the minibatch
permutations) the test module computes and hands to ``run_all``.
"""

from __future__ import annotations

import numpy as np
import torch

from madrona_rl_envs_playground_tpu_torch.api import DeviceVecEnv
from madrona_rl_envs_playground_tpu_torch.core.batch import Simulator
from madrona_rl_envs_playground_tpu_torch.envs import balance_beam, cartpole, hanabi, overcooked
from madrona_rl_envs_playground_tpu_torch.envs import overcooked2
from madrona_rl_envs_playground_tpu_torch.models.cleanrl import load_flax_params
from madrona_rl_envs_playground_tpu_torch.models.mappo_nets import load_mappo_params
from madrona_rl_envs_playground_tpu_torch.train import SelfPlayConfig, SelfPlayPPO
from madrona_rl_envs_playground_tpu_torch.train.mappo import MAPPOConfig, MAPPORunner

CPU = torch.device("cpu")
N = 32  # the global batch: 8 worlds a rank on 4 ranks
STEPS = 12
STEP_ENVS = ("cartpole", "balance", "overcooked2", "hanabi")
FIELDS = ("obs", "state_obs", "action_mask", "active", "reward", "done")
SELFPLAY = {"balance": dict(), "cramped_room": dict(),
            # 3 minibatches do not divide 8 steps: JAX's fallback, gathered
            "balance_gathered": dict(num_minibatches=3)}
MAPPO = {"balance": dict(), "simple": dict(),
         "balance_bands": dict(shard_local_minibatch=True),
         # one minibatch: the env axis stays local (the Colab recipe's path)
         "balance_one_minibatch": dict(num_mini_batch=1)}

# DeviceVecEnv(sharding=) against JAX's TpuVecEnv: an env with a kernel
# that runs on each rank's shard (Overcooked), one whose kernel takes the
# plain collector on a mesh (Cartpole) and a turn-based one (full Hanabi),
# each long enough that episodes end
VECENV_STEPS = {"cartpole": 60, "hanabi": 60, "overcooked": 45}
VECENV_N = 8
SEAT_FIELDS = ("obs", "state", "action_mask", "active")

# held against the JAX package's single-device trainers: one update from
# JAX's parameters on injected actions, the whole batch's [T, N, P]
SELFPLAY_VS_JAX = {
    # T-axis chunks, rank-local
    "cramped_room": dict(env="cramped_room", num_envs=8, num_steps=8, num_minibatches=2),
    # 3 minibatches do not divide 8 steps: JAX's fallback, gathered
    "cramped_room_gathered": dict(env="cramped_room", num_envs=8, num_steps=8,
                                  num_minibatches=3),
    # means over the active slots; one world a rank
    "hanabi": dict(env="hanabi", num_envs=4, num_steps=16, num_minibatches=2),
}
MAPPO_VS_JAX_BASE = dict(episode_length=8, n_rollout_threads=8, hidden_size=16, layer_N=1,
                         ppo_epoch=2, lr=1e-3, critic_lr=2e-3, seed=0)
MAPPO_VS_JAX = {"one_minibatch": dict(num_mini_batch=1),
                "two_minibatches": dict(num_mini_batch=2),
                "bands": dict(num_mini_batch=2, shard_local_minibatch=True)}


def step_env(name):
    if name == "cartpole":
        return cartpole.Env()
    if name == "balance":
        return balance_beam.Env()
    if name == "overcooked2":
        return overcooked2.make("simple", horizon=20)
    return hanabi.Env(**hanabi.CONFIGS["very_small"])


def step_actions(env) -> np.ndarray:
    """[STEPS, N, P] int32, JAX's sharded-step test's stream."""
    rs = np.random.RandomState(5)
    return np.stack([rs.randint(0, env.num_actions, size=(N, env.num_agents))
                     for _ in range(STEPS)]).astype(np.int32)


def steps(mesh, name):
    """``Simulator`` over STEPS steps: each step's outputs (this rank's
    rows) and the episode counter after reset and after each step."""
    env = step_env(name)
    acts = torch.from_numpy(step_actions(env))
    sim = Simulator(env, N, device=CPU, mesh=mesh)
    rows = slice(0, N) if mesh is None else mesh.rows(N)
    outs, counters = [], [sim.bstate.episode_counter.clone()]
    for t in range(STEPS):
        out = sim.step(acts[t, rows])
        outs.append({f: getattr(out, f).clone() for f in FIELDS})
        counters.append(sim.bstate.episode_counter.clone())
    return {"fields": {f: torch.stack([o[f] for o in outs]) for f in FIELDS},
            "counter": torch.stack(counters)}


def selfplay(mesh, name):
    """JAX's mesh test: 2 updates of 8 steps from seed 3."""
    env = (overcooked.make("cramped_room", horizon=10) if name == "cramped_room"
           else balance_beam.Env())
    cfg = SelfPlayConfig(num_steps=8, hidden=32, num_layers=1, lr=1e-3, **SELFPLAY[name])
    trainer = SelfPlayPPO(env, N, cfg, seed=3, device=CPU, mesh=mesh)
    metrics = [{k: float(v) for k, v in trainer.train_step().items()} for _ in range(2)]
    return {"metrics": metrics, "params": trainer.net.state_dict()}


def mappo(mesh, name):
    """JAX's mesh test: one episode of 6 steps, 2 epochs of 2 minibatches."""
    env = overcooked2.make("simple", horizon=20) if name == "simple" else balance_beam.Env()
    cfg = MAPPOConfig(**{**dict(episode_length=6, n_rollout_threads=N, hidden_size=32,
                                layer_N=1, ppo_epoch=2, num_mini_batch=2, lr=1e-3,
                                critic_lr=1e-3, seed=11), **MAPPO[name]})
    runner = MAPPORunner(cfg, env, device=CPU, mesh=mesh)
    info = runner.run(episodes=1, log=None)
    return {"info": {k: float(v) for k, v in info.items()},
            "episode_rewards": list(runner.episode_rewards),
            "actor": runner.policy.actor.state_dict(),
            "critic": runner.policy.critic.state_dict()}


def vecenv_env(name):
    if name == "cartpole":
        return cartpole.Env()
    if name == "hanabi":
        return hanabi.Env(**hanabi.CONFIGS["full"])
    return overcooked.make("cramped_room", horizon=20)


def vecenv_actions(name) -> np.ndarray:
    """[steps, P, N] int32, each legal for its seat at its step, drawn as
    ``tests/test_torch_api.py`` draws them, from the unsharded env."""
    env = vecenv_env(name)
    venv = DeviceVecEnv(env, VECENV_N, device=CPU)
    venv.n_reset()
    rs = np.random.RandomState(7)
    acts = []
    for _ in range(VECENV_STEPS[name]):
        mask = venv.last_out.action_mask.numpy()
        a = np.array([[rs.choice(np.nonzero(mask[n, p])[0]) for n in range(VECENV_N)]
                      for p in range(env.num_agents)], np.int32)
        venv.n_step(torch.from_numpy(a))
        acts.append(a)
    return np.stack(acts)


def vecenv(mesh, name, actions):
    """``DeviceVecEnv(sharding=mesh)`` stepped with ``actions`` ([steps, P,
    N], the whole batch's; this rank takes its columns): the seat views
    after the reset and after each step, the rewards [steps, P, n] and
    dones [steps, n] (this rank's), and the episode counter."""
    env = vecenv_env(name)
    venv = (DeviceVecEnv(env, VECENV_N, device=CPU) if mesh is None
            else DeviceVecEnv(env, VECENV_N, sharding=mesh))
    cols = slice(0, VECENV_N) if mesh is None else mesh.rows(VECENV_N)
    seats, rewards, dones = [venv.n_reset()], [], []
    for a in actions:
        s, r, d, _ = venv.n_step(torch.from_numpy(a[:, cols]))
        seats.append(s)
        rewards.append(r.clone())
        dones.append(d.clone())
    return {"seats": {f: torch.stack([torch.stack([getattr(v, f) for v in s]) for s in seats])
                      for f in SEAT_FIELDS},
            "reward": torch.stack(rewards), "done": torch.stack(dones),
            "counter": venv.bstate.episode_counter.clone()}


def selfplay_env(name):
    kind = SELFPLAY_VS_JAX[name]["env"]
    if kind == "hanabi":
        return hanabi.Env(**hanabi.CONFIGS["very_small"])
    return overcooked.make(kind, horizon=8)


def selfplay_config(name) -> SelfPlayConfig:
    c = SELFPLAY_VS_JAX[name]
    return SelfPlayConfig(num_steps=c["num_steps"], hidden=32, num_layers=1, update_epochs=2,
                          num_minibatches=c["num_minibatches"], lr=1e-3)


def selfplay_from(mesh, name, params, actions):
    """One ``train_step`` of the port's trainer from ``params`` (JAX's, a
    numpy tree) on the injected ``actions`` (the whole batch's [T, N, P];
    this rank takes its rows): the metrics and the parameters before and
    after."""
    n = SELFPLAY_VS_JAX[name]["num_envs"]
    trainer = SelfPlayPPO(selfplay_env(name), n, selfplay_config(name), seed=0, device=CPU,
                          mesh=mesh)
    load_flax_params(trainer.net, params)
    before = {k: v.clone() for k, v in trainer.net.state_dict().items()}
    rows = slice(0, n) if mesh is None else mesh.rows(n)
    m = trainer.train_step(torch.from_numpy(actions[:, rows]))
    return {"metrics": {k: float(v) for k, v in m.items()}, "before": before,
            "after": trainer.net.state_dict()}


def mappo_env():
    return overcooked2.make("cramped_room", horizon=6)


def mappo_from(mesh, name, params, actions, perms):
    """One ``MAPPORunner.update`` from ``params`` (JAX's actor and critic,
    numpy trees) on the injected ``actions`` (the whole batch's [T, N, A];
    this rank takes its rows), with JAX's minibatch permutations ``perms``
    (None for one minibatch): the info, the episode score, both nets before
    and after, and the ValueNorm statistics."""
    cfg = MAPPOConfig(**MAPPO_VS_JAX_BASE, **MAPPO_VS_JAX[name])
    runner = MAPPORunner(cfg, mappo_env(), device=CPU, mesh=mesh)
    pol = runner.policy
    load_mappo_params(pol.actor, pol.critic, *params)

    def nets():
        return {net: {k: v.detach().clone() for k, v in getattr(pol, net).named_parameters()}
                for net in ("actor", "critic")}

    before = nets()
    n = cfg.n_rollout_threads
    rows = slice(0, n) if mesh is None else mesh.rows(n)
    info, score = runner.update(0, 1, actions=torch.from_numpy(actions[:, rows]),
                                perms=None if perms is None else
                                [torch.from_numpy(p) for p in perms])
    vn = runner.trainer.vn
    return {"info": {k: float(v) for k, v in info.items()}, "score": score, "before": before,
            "after": nets(), "vn": {f: getattr(vn, f).clone() for f in vn.__dataclass_fields__}}


def run_all(mesh, jax_inputs):
    """Every check of the test module, on one rank.  ``jax_inputs`` holds,
    by case, the arguments after the name of ``vecenv``, ``selfplay_from``
    and ``mappo_from``: the actions, JAX's parameters and MAPPO's
    permutations."""
    return {"steps": {name: steps(mesh, name) for name in STEP_ENVS},
            "vecenv": {name: vecenv(mesh, name, *jax_inputs["vecenv"][name])
                       for name in VECENV_STEPS},
            "selfplay": {name: selfplay(mesh, name) for name in SELFPLAY},
            "mappo": {name: mappo(mesh, name) for name in MAPPO},
            "selfplay_vs_jax": {name: selfplay_from(mesh, name, *jax_inputs["selfplay"][name])
                                for name in SELFPLAY_VS_JAX},
            "mappo_vs_jax": {name: mappo_from(mesh, name, *jax_inputs["mappo"][name])
                             for name in MAPPO_VS_JAX}}

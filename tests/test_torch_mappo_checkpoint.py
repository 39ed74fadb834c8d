"""The port's MAPPO checkpoints, run directory and the CLIs over them.

Counterpart of ``tests/test_checkpoint_resume.py::test_mappo_optimizer_state_roundtrip``:
``MAPPORunner.save``/``restore`` carries both nets' parameters, both Adam
states and the ValueNorm statistics exactly, and a checkpoint of parameters
and ValueNorm only still loads.  Also: a ``run_dir`` gets ``metrics.jsonl``
with the JAX runner's tags (``train/mappo/runner.py`` of the JAX package:
``mappo/average_episode_rewards``, ``mappo/<train info key>`` for its
trainer's four keys, ``mappo/eval_score``) and a checkpoint every
``save_interval`` updates; ``scripts/torch_mappo_train.py --model_dir``
resumes from a saved run; ``scripts/torch_tester.py`` prints the restored
runner's finite score.
"""

import dataclasses
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

from madrona_rl_envs_playground_tpu_torch.envs import balance_beam
from madrona_rl_envs_playground_tpu_torch.train.mappo import MAPPOConfig, MAPPORunner
from madrona_rl_envs_playground_tpu_torch.utils.checkpoint import load_pytree, save_pytree

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))

import torch_mappo_train  # noqa: E402
import torch_tester  # noqa: E402

CPU = "cpu"
SMALL = dict(episode_length=6, n_rollout_threads=8, hidden_size=16, layer_N=1, ppo_epoch=2)
JAX_TAGS = {"mappo/average_episode_rewards", "mappo/value_loss", "mappo/policy_loss",
            "mappo/dist_entropy", "mappo/ratio"}


def assert_tree_equal(a, b, what=""):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype, what
        torch.testing.assert_close(a.cpu(), b.cpu(), rtol=0, atol=0, msg=what)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            assert_tree_equal(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            assert_tree_equal(x, y, f"{what}[{i}]")
    else:
        assert a == b, what


def runner_state(r: MAPPORunner):
    pol, vn = r.policy, r.trainer.vn
    return {"model_config": dataclasses.asdict(pol.mc),
            "actor_params": pol.actor.state_dict(), "critic_params": pol.critic.state_dict(),
            "actor_opt": pol.actor_opt.state_dict(), "critic_opt": pol.critic_opt.state_dict(),
            "vn": {k: getattr(vn, k) for k in ("running_mean", "running_mean_sq",
                                                "debiasing_term")}}


def test_mappo_optimizer_state_roundtrip(tmp_path):
    cfg = MAPPOConfig(**SMALL)
    runner = MAPPORunner(cfg, balance_beam.Env(), device=CPU)
    runner.run(episodes=1, log=None)
    path = str(tmp_path / "run")
    runner.save(path)
    assert os.listdir(path) == ["checkpoint.pt"]

    runner2 = MAPPORunner(cfg, balance_beam.Env(), device=CPU)
    runner2.restore(path)
    want = runner_state(runner)
    assert float(want["vn"]["debiasing_term"]) > 0 and want["actor_opt"]["state"]
    assert_tree_equal(runner_state(runner2), want)

    # parameters and ValueNorm only (older checkpoints) still load; the
    # runner keeps its own Adam states
    blob = load_pytree(os.path.join(path, "checkpoint.pt"))
    save_pytree(os.path.join(path, "checkpoint.pt"),
                {k: blob[k] for k in ("actor_params", "critic_params", "vn")})
    runner3 = MAPPORunner(cfg, balance_beam.Env(), device=CPU)
    runner3.restore(path)
    got = runner_state(runner3)
    for k in ("actor_params", "critic_params", "vn"):
        assert_tree_equal(got[k], want[k], k)
    assert not got["actor_opt"]["state"] and not got["critic_opt"]["state"]
    runner3.run(episodes=1, log=None)  # and trains on


def test_run_dir_logs_jax_tags_and_saves_every_save_interval(tmp_path):
    run_dir = str(tmp_path / "run")
    cfg = MAPPOConfig(**SMALL, save_interval=2, use_eval=True, eval_interval=1,
                      eval_episodes=8)
    runner = MAPPORunner(cfg, balance_beam.Env(), run_dir=run_dir, device=CPU)
    runner.run(episodes=1, log=None)
    assert not os.path.exists(os.path.join(run_dir, "checkpoint.pt"))
    runner.run(episodes=2, log=None)
    assert os.path.exists(os.path.join(run_dir, "checkpoint.pt"))
    rows = [json.loads(line) for line in open(os.path.join(run_dir, "metrics.jsonl"))]
    by_step = {}
    for row in rows:
        (tag,) = set(row) - {"t", "step"}
        by_step.setdefault(row["step"], set()).add(tag)
        assert np.isfinite(row[tag])
    steps = SMALL["episode_length"] * SMALL["n_rollout_threads"]
    assert sorted(by_step) == [steps, 2 * steps]
    assert all(tags == JAX_TAGS | {"mappo/eval_score"} for tags in by_step.values())
    assert len(rows) == 3 * len(JAX_TAGS | {"mappo/eval_score"})  # three updates


MAPPO_ARGS = ["--env_name", "balance", "--episode_length", "6", "--n_rollout_threads", "8",
              "--hidden_size", "16", "--layer_N", "1", "--ppo_epoch", "1", "--device", CPU]


def test_mappo_train_model_dir_resumes_and_tester_scores(tmp_path, capsys):
    first = str(tmp_path / "first")
    runner, _ = torch_mappo_train.main(MAPPO_ARGS + ["--num_env_steps", "96",
                                                     "--run_dir", first])
    saved = load_pytree(os.path.join(first, "checkpoint.pt"))
    assert_tree_equal(runner_state(runner), saved)  # saved after the last update

    # --model_dir restores first: with no update to run the runner holds the
    # saved state exactly; with one it trains on and saves into --run_dir
    resumed, _ = torch_mappo_train.main(MAPPO_ARGS + ["--num_env_steps", "0", "--model_dir",
                                                      first, "--run_dir", str(tmp_path / "b")])
    assert_tree_equal(runner_state(resumed), saved)
    again, _ = torch_mappo_train.main(MAPPO_ARGS + ["--num_env_steps", "48", "--model_dir",
                                                    first, "--run_dir", str(tmp_path / "c")])
    step = {k: v["step"] for k, v in again.policy.actor_opt.state_dict()["state"].items()}
    assert all(float(s) == 3 for s in step.values())  # two updates x 1 epoch, then one more
    assert os.path.exists(tmp_path / "c" / "checkpoint.pt")
    capsys.readouterr()

    score = torch_tester.main(["--model_dir", first, "--env_name", "balance",
                               "--episode_length", "6", "--n_rollout_threads", "8",
                               "--hidden_size", "16", "--device", CPU])
    assert capsys.readouterr().out.splitlines()[-1] == f"average episode score: {score:.3f}"
    assert np.isfinite(score) and score == resumed.evaluate(episodes=1)


def test_use_render_names_item_14b(tmp_path, capsys):
    """``--use_render`` (ROADMAP item 14b, now ported) on a non-Overcooked
    env writes JAX's ``trajectory.json``: ``--render_episodes`` episodes of
    the greedy actor, its actions and rewards."""
    run = str(tmp_path / "run")
    torch_mappo_train.main(MAPPO_ARGS + ["--num_env_steps", "48", "--run_dir", run,
                                         "--use_render", "--render_episodes", "2"])
    assert capsys.readouterr().out.splitlines()[-1] == (
        f"render: wrote {run}/render/trajectory.json")
    traj = json.load(open(os.path.join(run, "render", "trajectory.json")))
    assert sorted(traj) == ["actions", "rewards"] and len(traj["actions"]) == 2 * 6
    assert all(len(a) == 2 and all(0 <= x < 4 for x in a) for a in traj["actions"])

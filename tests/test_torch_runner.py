"""The port's runner pieces against the JAX package: ``Simulator``,
``SelfPlayPPO.run``/``save``/``load``, the weight exporters, the scalar
logger and ``scripts/torch_selfplay_train.py``.

Everything runs on the CPU.  The simulators are integer envs here, so their
outputs are compared exactly.  A resumed trainer runs the same float32
operations on the same values as the uninterrupted one in the same process,
so its metrics and parameters are compared exactly too.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_rl_envs_playground_tpu.core.batch import Simulator as JSimulator
from madrona_rl_envs_playground_tpu.envs import hanabi as j_hanabi
from madrona_rl_envs_playground_tpu.envs import overcooked as j_oc
from madrona_rl_envs_playground_tpu.train import selfplay as j_selfplay
from madrona_rl_envs_playground_tpu.utils import checkpoint as j_ckpt
from madrona_rl_envs_playground_tpu.utils.logger import ScalarLogger as JLogger
from madrona_rl_envs_playground_tpu_torch.core.batch import Simulator as TSimulator
from madrona_rl_envs_playground_tpu_torch.envs import balance_beam as t_balance
from madrona_rl_envs_playground_tpu_torch.envs import hanabi as t_hanabi
from madrona_rl_envs_playground_tpu_torch.envs import overcooked as t_oc
from madrona_rl_envs_playground_tpu_torch.envs import overcooked2 as t_oc2
from madrona_rl_envs_playground_tpu_torch.models.cleanrl import flax_params, load_flax_params
from madrona_rl_envs_playground_tpu_torch.train import selfplay as t_selfplay
from madrona_rl_envs_playground_tpu_torch.utils import checkpoint as t_ckpt
from madrona_rl_envs_playground_tpu_torch.utils.logger import ScalarLogger as TLogger

REPO = Path(__file__).resolve().parents[1]
OUT_FIELDS = ("obs", "action_mask", "reward", "done")


def _envs(name):
    if name == "cramped_room":
        return j_oc.make("cramped_room", horizon=9), t_oc.make("cramped_room", horizon=9)
    cfg = t_hanabi.CONFIGS["small"]
    return j_hanabi.Env(**cfg), t_hanabi.Env(**cfg)


def _assert_out(t_out, j_out, msg):
    for f in OUT_FIELDS:
        np.testing.assert_array_equal(getattr(t_out, f).numpy(), np.asarray(getattr(j_out, f)),
                                      err_msg=f"{msg}: {f}")


@pytest.mark.parametrize("name", ["cramped_room", "hanabi_small"])
def test_simulator_matches_jax(name):
    """The same numpy actions (legal ones for Hanabi) over 20 steps give the
    same obs, masks, rewards and dones; ``reset()`` returns to the first
    output."""
    j_env, t_env = _envs(name)
    n, rs = 8, np.random.RandomState(4)
    j_sim, t_sim = JSimulator(j_env, n, start_episode=3), TSimulator(t_env, n, start_episode=3,
                                                                      device="cpu")
    _assert_out(t_sim.last_out, j_sim.last_out, "reset")
    first = t_sim.last_out
    for t in range(20):
        mask = t_sim.last_out.action_mask.numpy()
        acts = np.array([[rs.choice(np.nonzero(m)[0]) for m in row] for row in mask], np.int32)
        _assert_out(t_sim.step(torch.from_numpy(acts)), j_sim.step(jnp.asarray(acts)),
                    f"step {t}")
    assert int(t_sim.bstate.episode_counter) == int(j_sim.bstate.episode_counter)
    again = t_sim.reset()
    _assert_out(again, j_sim.reset(), "reset again")
    for f in OUT_FIELDS:
        assert torch.equal(getattr(again, f), getattr(first, f)), f


def _assert_params_equal(a, b):
    for (k, x), (_, y) in zip(a.net.state_dict().items(), b.net.state_dict().items()):
        assert torch.equal(x, y), k


def test_selfplay_full_resume(tmp_path):
    """Mirrors tests/test_checkpoint_resume.py: a trainer of another seed
    loaded from a checkpoint takes exactly the uninterrupted trainer's next
    update."""
    env = t_oc2.make("simple", horizon=10)
    cfg = t_selfplay.SelfPlayConfig(num_steps=8, hidden=16, num_layers=1, update_epochs=2)
    tr = t_selfplay.SelfPlayPPO(env, 8, cfg, seed=5, device="cpu")
    tr.run(2)
    path = str(tmp_path / "ck")
    tr.save(path)
    m_cont = tr.train_step()

    tr2 = t_selfplay.SelfPlayPPO(env, 8, cfg, seed=99, device="cpu")  # another seed
    tr2.load(path)
    m_res = tr2.train_step()
    assert {k: float(v) for k, v in m_cont.items()} == {k: float(v) for k, v in m_res.items()}
    _assert_params_equal(tr, tr2)
    assert torch.equal(tr.state["out"].obs, tr2.state["out"].obs)


def test_selfplay_policy_only_restore_across_batch_sizes(tmp_path):
    env = t_balance.Env()
    cfg = t_selfplay.SelfPlayConfig(num_steps=6, hidden=16, num_layers=1, update_epochs=1)
    tr = t_selfplay.SelfPlayPPO(env, 8, cfg, seed=1, device="cpu")
    tr.run(1)
    path = str(tmp_path / "ck")
    tr.save(path)

    tr2 = t_selfplay.SelfPlayPPO(env, 16, cfg, seed=2, device="cpu")  # another batch size
    fresh = tr2.state["out"].obs.clone()
    tr2.load(path)  # env state dropped; network, Adam and sampler restored
    _assert_params_equal(tr, tr2)
    assert torch.equal(tr2.state["out"].obs, fresh)
    assert torch.equal(tr.sample_gen.get_state(), tr2.sample_gen.get_state())
    assert tr2.opt.state_dict()["state"][0]["step"] == tr.opt.state_dict()["state"][0]["step"]
    m = tr2.train_step()
    assert np.isfinite(float(m["pg_loss"]))

    # a policy-only save loads at the same batch size and keeps the env state
    tr.save(path, with_env_state=False)
    tr3 = t_selfplay.SelfPlayPPO(env, 8, cfg, seed=3, device="cpu")
    fresh = tr3.state["out"].obs.clone()
    tr3.load(path)
    _assert_params_equal(tr, tr3)
    assert torch.equal(tr3.state["out"].obs, fresh)


@pytest.fixture(scope="module")
def logged_runs(tmp_path_factory):
    """A JAX and a port trainer with the same recipe, each run for 4 updates
    logging every 2 to its package's ScalarLogger."""
    common = dict(num_steps=8, hidden=16, num_layers=2, update_epochs=1)
    j_env, t_env = _envs("cramped_room")
    jt = j_selfplay.SelfPlayPPO(
        j_env, 4, j_selfplay.SelfPlayConfig(rollout_backend="jnp", **common), seed=0)
    tt = t_selfplay.SelfPlayPPO(t_env, 4, t_selfplay.SelfPlayConfig(**common), seed=0,
                                device="cpu")
    load_flax_params(tt.net, jax.tree_util.tree_map(np.asarray, jt.state["params"]))
    dirs = {}
    for side, trainer, logger_cls in (("jax", jt, JLogger), ("port", tt, TLogger)):
        d = tmp_path_factory.mktemp(side)
        logger = logger_cls(str(d), use_tensorboard=False)
        trainer.run(4, log_every=2, logger=logger)
        logger.close()
        dirs[side] = d
    return jt, tt, dirs


def test_run_logs_the_tags_and_steps_jax_logs(logged_runs):
    _, _, dirs = logged_runs
    entries = {}
    for side, d in dirs.items():
        lines = [json.loads(x) for x in (d / "metrics.jsonl").read_text().splitlines()]
        entries[side] = [(e["step"], next(k for k in e if k not in ("t", "step")))
                         for e in lines]
    assert entries["port"] == entries["jax"]
    assert [s for s, _ in entries["port"]] == [2] * 6 + [4] * 6
    assert {t for _, t in entries["port"]} == {
        "selfplay/pg_loss", "selfplay/v_loss", "selfplay/entropy", "selfplay/approx_kl",
        "selfplay/mean_step_reward", "selfplay/mean_value"}


def test_run_without_logger_prints_like_jax(logged_runs, capsys):
    jt, tt, _ = logged_runs
    printed = {}
    for side, trainer in (("jax", jt), ("port", tt)):
        trainer.run(2, log_every=1)
        lines = capsys.readouterr().out.splitlines()
        printed[side] = [(x.split(":")[0], list(ast.literal_eval(x.split(": ", 1)[1])))
                         for x in lines]
    assert printed["port"] == printed["jax"] and len(printed["port"]) == 2


def test_export_weights_match_jax(logged_runs, tmp_path):
    """Parameters carried from a JAX trainer: the port's npz holds the same
    keys and arrays as JAX's ``export_weights_npz``, and its JSON is the
    same file."""
    jt, _, _ = logged_runs
    t_env = _envs("cramped_room")[1]
    cfg = t_selfplay.SelfPlayConfig(num_steps=8, hidden=16, num_layers=2)
    tt = t_selfplay.SelfPlayPPO(t_env, 4, cfg, seed=7, device="cpu")
    load_flax_params(tt.net, jax.tree_util.tree_map(np.asarray, jt.state["params"]))
    j_ckpt.export_weights_npz(str(tmp_path / "jax.npz"), jt.state["params"])
    t_ckpt.export_weights_npz(str(tmp_path / "port.npz"), flax_params(tt.net))
    j_npz, t_npz = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    assert list(t_npz.keys()) == list(j_npz.keys())
    assert "params.actor.Dense_0.kernel" in t_npz
    for k in j_npz:
        assert t_npz[k].dtype == j_npz[k].dtype and t_npz[k].shape == j_npz[k].shape, k
        np.testing.assert_array_equal(t_npz[k], j_npz[k], err_msg=k)
    j_ckpt.export_weights_json(str(tmp_path / "jax.json"), jt.state["params"])
    t_ckpt.export_weights_json(str(tmp_path / "port.json"), flax_params(tt.net))
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()


def test_checkpoint_tree_round_trip(tmp_path):
    tree = {"a": torch.arange(3), "b": [torch.ones(2, dtype=torch.bool), 1.5, None],
            "c": {"d": (torch.zeros(()), "x")}}
    path = str(tmp_path / "sub" / "t.pt")
    t_ckpt.save_pytree(path, tree)
    back = t_ckpt.load_pytree(path)
    assert torch.equal(back["a"], tree["a"]) and torch.equal(back["b"][0], tree["b"][0])
    assert back["b"][1:] == [1.5, None] and back["c"]["d"][1] == "x"


def _cli(args, env=None):
    return subprocess.run([sys.executable, str(REPO / "scripts" / "torch_selfplay_train.py"),
                           *args], cwd=REPO, env=env, text=True, capture_output=True,
                          timeout=120)


def test_selfplay_cli_on_cpu_and_refused_without_a_card():
    tiny = ["--env", "overcooked", "--num-envs", "8", "--num-steps", "8", "--updates", "2",
            "--hidden", "16"]
    r = _cli(tiny + ["--device", "cpu"])
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert lines[-1].startswith("total: 128 env-steps in ") and lines[-1].endswith(
        "(steady-state; 1 warmup update excluded)")
    assert [x.split(":")[0] for x in lines[:-1]] == ["update 1", "update 2"]
    r = _cli(tiny, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0 and "total:" not in r.stdout
    assert "device='cpu'" in r.stderr


def test_flagship_recipe_is_the_jax_record_s():
    """scripts/torch_flagship.py's recipe, parsed by the CLI, names the JAX
    record's env, batch, net and updates, and the CLI builds its trainer
    (here at 8 envs on the CPU) with selfplay_train.py's defaults for the
    rest."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("torch_flagship",
                                                  REPO / "scripts" / "torch_flagship.py")
    fl = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fl)
    record = json.loads((REPO / "docs" / "runs" / "selfplay_cramped_1B.json").read_text())
    args = fl.recipe(1, "cpu")
    assert f"{args.env} {args.layout}" == record["env"]
    assert (args.num_envs, args.num_steps, args.updates) == (
        record["num_envs"], record["num_steps"], record["updates"])
    assert f"{args.layers}x{args.hidden} {'bf16' if args.bf16 else 'fp32'}" == record["net"]
    assert args.log_every == 1 and fl.LAST * args.num_steps % args.horizon == 0
    args.num_envs = 8
    trainer = fl.cli.build_trainer(args)
    cfg = trainer.cfg
    assert (cfg.num_steps, cfg.hidden, cfg.num_layers, cfg.use_bf16) == (64, 64, 2, True)
    assert (cfg.lr, cfg.update_epochs, cfg.num_minibatches, cfg.ent_coef, cfg.value_loss) == (
        2.5e-4, 4, 1, 0.01, "clipped_mse")
    assert trainer.env.horizon == 400 and trainer.num_envs == 8

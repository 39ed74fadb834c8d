"""The port's experiment drivers (``scripts/torch_*``) on the CPU, at tiny
sizes, against the JAX package's scripts where they compute the same thing:

* ``torch_mappo_layout_sweep.py`` writes JAX's JSON fields by layout;
* ``torch_hanabi_long_run.py``: its greedy eval, on parameters carried over
  from JAX's network, gives JAX's ``build_eval`` score and episode count
  (within float32 rounding of the summed scores); ``--resume`` continues the
  JSONL exactly;
* ``torch_many_player_train_run.py --mesh-check`` passes on 2 CPU ranks;
* ``torch_multihost_projection.py`` counts gradient bytes equal to the
  network's parameter bytes x epochs x minibatches an update, printed beside
  the JAX script's count from the compiled HLO of its sharded train step on
  the CPU mesh.
"""

import json
import os
import sys

import jax
import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
if SCRIPTS not in sys.path:
    sys.path.insert(0, SCRIPTS)

import torch_hanabi_long_run as t_long  # noqa: E402
import torch_many_player_train_run as t_many  # noqa: E402
import torch_mappo_layout_sweep as t_sweep  # noqa: E402
import torch_multihost_projection as t_proj  # noqa: E402

CPU = ["--device", "cpu"]
JAX_SWEEP_KEYS = {"deterministic", "stochastic_avg3", "train_wall_s", "env_steps", "seed"}


def test_layout_sweep_writes_jax_fields(tmp_path):
    out = tmp_path / "sweep.json"
    results = t_sweep.main(CPU + ["--layouts", "simple", "random1", "--n-rollout-threads", "4",
                                  "--episode-length", "8", "--num-env-steps", "64",
                                  "--out", str(out)])
    saved = json.loads(out.read_text())
    assert saved == results and list(saved) == ["simple", "random1"]
    for row in saved.values():
        assert set(row) == JAX_SWEEP_KEYS  # no card on the CPU
        assert row["env_steps"] == 64 and row["seed"] == 1
        assert all(np.isfinite(row[k]) for k in ("deterministic", "stochastic_avg3"))


def test_hanabi_greedy_eval_matches_jax_build_eval():
    import hanabi_long_run as j_long
    from madrona_rl_envs_playground_tpu.envs import hanabi as j_hanabi
    from madrona_rl_envs_playground_tpu.train import SelfPlayConfig as JConfig
    from madrona_rl_envs_playground_tpu.train import SelfPlayPPO as JPPO
    from madrona_rl_envs_playground_tpu_torch.envs import hanabi as t_hanabi
    from madrona_rl_envs_playground_tpu_torch.models.cleanrl import load_flax_params
    from madrona_rl_envs_playground_tpu_torch.train import SelfPlayConfig, SelfPlayPPO

    n, steps = 16, 60
    kw = dict(num_steps=8, hidden=32, num_layers=2)
    j_env = j_hanabi.Env(**j_hanabi.CONFIGS["very_small"])
    jt = JPPO(j_env, n, JConfig(**kw), seed=2)
    j_score, j_eps = j_long.build_eval(jt, j_env, n, steps)(jt.state["params"])
    tt = SelfPlayPPO(t_hanabi.Env(**t_hanabi.CONFIGS["very_small"]), n, SelfPlayConfig(**kw),
                     seed=2, device="cpu")
    load_flax_params(tt.net, jax.tree_util.tree_map(np.asarray, jt.state["params"]))
    t_score, t_eps = t_long.build_eval(tt, tt.env, n, steps)()
    assert int(j_eps) > 0 and t_eps == int(j_eps)
    np.testing.assert_allclose(t_score, float(j_score), rtol=1e-6)


def test_hanabi_long_run_resume_continues_exactly(tmp_path):
    base = CPU + ["--config", "very_small", "--num-envs", "8", "--num-steps", "8",
                  "--hidden", "16", "--layers", "1", "--minibatches", "2", "--log-every", "1",
                  "--eval-every", "2", "--save-every", "2", "--eval-envs", "8",
                  "--eval-steps", "20"]
    whole = t_long.main(base + ["--run-dir", str(tmp_path / "whole"), "--updates", "4"])
    first = t_long.main(base + ["--run-dir", str(tmp_path / "split"), "--updates", "2"])
    resumed = t_long.main(base + ["--run-dir", str(tmp_path / "split"), "--updates", "4",
                                  "--resume"])
    assert [r["update"] for r in first] == [1, 2, 2] and first[-1]["final"]
    keys = ("pg_loss", "v_loss", "entropy", "approx_kl", "mean_step_reward", "mean_value")
    by_update = {r["update"]: r for r in whole if not r.get("final")}
    for r in resumed[:-1]:
        assert {k: r[k] for k in keys} == {k: by_update[r["update"]][k] for k in keys}
    assert [r["update"] for r in resumed] == [3, 4, 4]
    assert resumed[-1]["eval_score"] == whole[-1]["eval_score"]
    lines = (tmp_path / "split" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(line)["update"] for line in lines] == [1, 2, 2, 3, 4, 4]


def test_many_player_mesh_check_passes_on_two_cpu_ranks():
    single, sharded = t_many.mesh_check(8, "cpu")
    assert len(sharded) == t_many.MESH_RANKS
    assert len(single) == t_many.MESH_UPDATES and all(len(s) == 6 for s in single)


def test_projection_counts_gradient_bytes_of_the_network():
    """Port: one flat all-reduce of every parameter a minibatch.  JAX (the
    compiled HLO of the sharded train step, counted once as written): its
    all-reduces of more than 64 bytes, the gradient leaves less the two
    small head biases, times the applications an update."""
    import multihost_projection as j_proj
    from madrona_rl_envs_playground_tpu.parallel.mesh import make_mesh

    counted = t_proj.count_collectives(2)
    grad = counted["collectives"]["all_reduce/grad"]
    apps = counted["applications_per_update"]
    assert apps == 4 and grad["calls"] == apps
    assert grad["bytes"] == counted["param_bytes"] * apps
    assert not any(k.startswith("all_gather/") for k in counted["collectives"])

    n_dev = len(jax.devices())
    trainer = j_proj.build_trainer(num_envs=16 * n_dev, mesh=make_mesh(n_dev))
    hlo = jax.jit(trainer._train_step).lower(trainer.state).compile().as_text()
    _, ops = j_proj.collective_bytes_from_hlo(hlo)
    j_grad = sum(o["bytes"] for o in ops if o["kind"] == "all-reduce" and o["bytes"] > 64)
    j_params = sum(int(np.prod(np.shape(x)))
                   for x in jax.tree_util.tree_leaves(trainer.state["params"]))
    assert j_params * 4 == counted["param_bytes"]
    print(f"gradient all-reduce bytes an update: port {grad['bytes']:,} "
          f"({counted['param_bytes']:,} parameter bytes x {apps}); JAX HLO on the "
          f"{n_dev}-device CPU mesh {j_grad * apps:,} ({j_grad:,} x {apps}); the "
          f"difference, {grad['bytes'] - j_grad * apps:,}, is the JAX script's > 64-byte "
          f"filter dropping the small head biases")
    if n_dev > 1:
        assert 0 <= grad["bytes"] - j_grad * apps <= 64 * apps


def test_scaling_bench_prints_jax_line_at_world_size_one(capsys):
    import torch_scaling_bench as t_scale

    rows = t_scale.main(CPU + ["--envs-per-device", "8", "--num-steps", "4", "--repeats", "1"])
    assert [r[:2] for r in rows] == [(1, 8)] and rows[0][3] == 1.0
    assert "devices=  1 envs=      8" in capsys.readouterr().out
    assert torch.distributed.is_initialized() is False

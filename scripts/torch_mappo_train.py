#!/usr/bin/env python3
"""MAPPO self-play training on the PyTorch port (reference: train/trainer.py).

    python scripts/torch_mappo_train.py --device cpu --seed 2
    python scripts/torch_mappo_train.py --model_dir runs/mappo --run_dir runs/mappo2

Defaults to the reference Colab's configuration on Overcooked2 ``simple``
(``COLAB_RECIPE``: 800 envs, episode 200, hidden 64 x 1 layer, lr 1e-2,
ppo_epoch 7, 8M env-steps, so 50 updates); every flag of the reference's
``get_config()`` overrides it.  Prints the runner's per-episode line every
``--log_interval`` updates, then the deterministic eval score.  The runner
saves to ``--run_dir`` (default ``runs/mappo``) every ``--save_interval``
updates and logs its scalars there (``metrics.jsonl``); ``--model_dir``
restores a saved run first, so training resumes.  ``--use_render`` then
writes a replay of the trained actor under ``<run_dir>/render/`` (JAX's
``render_policy``): for Overcooked the browser pages of
``utils/demo_export.py`` over ``--render_episodes`` horizons, elsewhere
``trajectory.json``.  Imports only the port; the device defaults to the
card.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from madrona_rl_envs_playground_tpu_torch.train.mappo import (  # noqa: E402
    COLAB_RECIPE,
    MAPPORunner,
    config_from_args,
    get_config,
)


def make_env(env_name: str, layout: str, horizon: int):
    from madrona_rl_envs_playground_tpu_torch.envs import balance_beam, overcooked, overcooked2

    if env_name == "overcooked":
        return overcooked2.make(layout, horizon=horizon)
    if env_name == "overcooked-new":
        return overcooked.make(layout, horizon=horizon)
    if env_name == "balance":
        return balance_beam.Env()
    raise ValueError(f"unknown --env_name {env_name!r} (overcooked, overcooked-new, balance)")


def main(argv=None):
    parser = get_config()
    parser.set_defaults(**COLAB_RECIPE)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    env = make_env(args.env_name, args.over_layout, cfg.episode_length)
    runner = MAPPORunner(cfg, env, run_dir=args.run_dir, device=args.device)
    if args.model_dir:
        runner.restore(args.model_dir)
    t0 = time.perf_counter()
    runner.run()
    train_s = time.perf_counter() - t0
    score = runner.evaluate(episodes=1, deterministic=True)
    print(f"deterministic eval score: {score:.3f} (training {train_s:.1f} s on "
          f"{runner.device})")
    if cfg.use_render:
        render_policy(runner, env, cfg, args.run_dir or "runs/mappo")
    return runner, score


def render_policy(runner, env, cfg, run_dir):
    """The reference's ``--use_render``/``--render_episodes`` gif pipeline,
    re-expressed as JAX's ``render_policy``: a self-contained browser replay
    driven by the trained actor (the Overcooked family), or a trajectory JSON
    elsewhere.  As in JAX, the actor acts greedily from a zero hidden state
    and masks of 1 at every step, and the pages' actor bundle refuses a
    recurrent actor (``ValueError``)."""
    import torch

    outdir = os.path.join(run_dir, "render")
    actor, mc, dev = runner.policy.actor, cfg.model_config(), runner.device

    def policy(obs, mask):
        B = obs.shape[0] * obs.shape[1]
        with torch.no_grad():
            logits, _ = actor(obs.reshape(B, -1).float(), actor.zero_states(B, dev),
                              torch.ones((B,), device=dev), mask.reshape(B, -1))
        return torch.argmax(logits, -1).reshape(obs.shape[:2]).to(torch.int32)

    if hasattr(env, "terrain"):  # the Overcooked family: the canvas replay pages
        from madrona_rl_envs_playground_tpu_torch.utils.demo_export import export_demo

        export_demo(outdir, env, actor=actor, model_cfg=mc,
                    num_traj_steps=cfg.render_episodes * env.horizon, policy=policy,
                    seed=cfg.seed, device=dev)
        print(f"render: wrote {outdir}/play.html and replay.html")
    else:
        from madrona_rl_envs_playground_tpu_torch.utils.demo_export import record_rollout

        traj = record_rollout(env, cfg.render_episodes * cfg.episode_length, policy=policy,
                              seed=cfg.seed, device=dev)
        os.makedirs(outdir, exist_ok=True)
        with open(os.path.join(outdir, "trajectory.json"), "w") as f:
            json.dump(traj, f)
        print(f"render: wrote {outdir}/trajectory.json")
    return outdir


if __name__ == "__main__":
    main()

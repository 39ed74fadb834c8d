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
restores a saved run first, so training resumes.  Imports only the port;
the device defaults to the card.
"""

from __future__ import annotations

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
    if args.use_render:
        raise SystemExit("--use_render: the replay export is not ported yet: "
                         "ROADMAP queue 1, item 14b")
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
    return runner, score


if __name__ == "__main__":
    main()

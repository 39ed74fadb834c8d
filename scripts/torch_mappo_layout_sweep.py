#!/usr/bin/env python3
"""MAPPO self-play across the classic Overcooked layouts (counterpart of
``scripts/mappo_layout_sweep.py``).

    python3 scripts/torch_mappo_layout_sweep.py            # all six, on the card
    python3 scripts/torch_mappo_layout_sweep.py --device cpu --layouts simple \\
        --n-rollout-threads 8 --episode-length 10 --num-env-steps 160 --out /tmp/sweep.json

The reference Colab's configuration (800 envs, episodes of 200 steps, a
64 x 1 net, lr 1e-2, 7 PPO epochs, 8M env-steps; ``COLAB_RECIPE``) trained
on each layout in one process: the overcooked_ai five (simple =
cramped_room, random1 = coordination_ring, random0 = forced_coordination,
random3 = counter_circuit, unident_s = asymmetric_advantages) and
scenario1_s.  On the card every env step is one launch of the Overcooked
step kernel, K1.  Writes JAX's JSON fields by layout (``deterministic``,
``stochastic_avg3``, ``train_wall_s``, ``env_steps``, ``seed``) and, on the
card, ``card``: its name and power limit.  ``--n-rollout-threads`` and
``--episode-length`` only shrink the recipe for a test.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

SCRIPTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(SCRIPTS))
sys.path.insert(0, SCRIPTS)

LAYOUTS = ["simple", "random1", "random0", "random3", "unident_s", "scenario1_s"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--layouts", nargs="*", default=LAYOUTS)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--num-env-steps", type=float, default=8e6)
    p.add_argument("--n-rollout-threads", type=int, default=800)
    p.add_argument("--episode-length", type=int, default=200)
    p.add_argument("--out", default=None,
                   help="output JSON (default docs/runs/torch_mappo_layout_sweep.json)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from torch_common import card_line

    from madrona_rl_envs_playground_tpu_torch.device import resolve_device
    from madrona_rl_envs_playground_tpu_torch.envs import overcooked2
    from madrona_rl_envs_playground_tpu_torch.train.mappo import MAPPOConfig, MAPPORunner

    dev = resolve_device(args.device)
    card = card_line(dev)
    results = {}
    for layout in args.layouts:
        cfg = MAPPOConfig(
            n_rollout_threads=args.n_rollout_threads, episode_length=args.episode_length,
            hidden_size=64, layer_N=1, lr=1e-2, critic_lr=1e-2, ppo_epoch=7,
            num_env_steps=args.num_env_steps, seed=args.seed,
        )
        env = overcooked2.make(layout, horizon=cfg.episode_length)
        runner = MAPPORunner(cfg, env, device=dev)
        t0 = time.time()
        runner.run(log=None)
        wall = time.time() - t0
        det = runner.evaluate(episodes=1, deterministic=True)
        sto = runner.evaluate(episodes=3, deterministic=False)
        results[layout] = {
            "deterministic": round(float(det), 2),
            "stochastic_avg3": round(float(sto), 2),
            "train_wall_s": round(wall, 1),
            "env_steps": int(args.num_env_steps),
            "seed": args.seed,
        }
        if card is not None:
            results[layout]["card"] = card
        print(f"[{layout}] det={det:.1f} stoch={sto:.1f} wall={wall:.0f}s", flush=True)

    out = args.out or os.path.join(SCRIPTS, "..", "docs", "runs", "torch_mappo_layout_sweep.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()

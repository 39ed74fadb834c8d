#!/usr/bin/env python3
"""Deterministic evaluation of a saved MAPPO policy on the port (counterpart
of ``scripts/tester.py``; reference: train/tester.py).

    python3 scripts/torch_tester.py --model_dir runs/mappo
    python3 scripts/torch_tester.py --model_dir runs/mappo --device cpu \\
        --n_rollout_threads 8

Restores ``<model_dir>/checkpoint.pt`` (``MAPPORunner.save``) into a runner
of the given width, calls ``evaluate`` and prints ``average episode score:
...``.  On the card each eval step is one launch of the env's step kernel.
A recurrent or CNN policy is named by the trainer's flags
(``--use_recurrent_policy``, ``--recurrent_N``, ``--use_cnn_obs``); the
eval carries a recurrent actor's hidden states (``MAPPORunner.evaluate``).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_serve_policy import NET_FLAGS, add_net_flags, make_serve_env  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_dir", required=True)
    p.add_argument("--env_name", default="overcooked")
    p.add_argument("--over_layout", default="simple")
    p.add_argument("--episode_length", type=int, default=200)
    p.add_argument("--n_rollout_threads", type=int, default=32)
    p.add_argument("--hidden_size", type=int, default=64)
    p.add_argument("--layer_N", type=int, default=1)
    add_net_flags(p)
    p.add_argument("--episodes", type=int, default=1)
    p.add_argument("--stochastic", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from madrona_rl_envs_playground_tpu_torch.train.mappo import MAPPOConfig, MAPPORunner

    cfg = MAPPOConfig(
        episode_length=args.episode_length,
        n_rollout_threads=args.n_rollout_threads,
        hidden_size=args.hidden_size,
        layer_N=args.layer_N,
        **{k: getattr(args, k) for k in NET_FLAGS},
    )
    env = make_serve_env(args)

    runner = MAPPORunner(cfg, env, device=args.device)
    runner.restore(args.model_dir)
    score = runner.evaluate(episodes=args.episodes, deterministic=not args.stochastic)
    print(f"average episode score: {score:.3f}")
    return score


if __name__ == "__main__":
    main()

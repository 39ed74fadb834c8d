#!/usr/bin/env python3
"""Decentralized CleanRL PPO on Balance Beam: ego and partner each learn
(counterpart of ``scripts/balance_train.py``; reference:
scripts/balance_train.py).

    python3 scripts/torch_balance_train.py
    python3 scripts/torch_balance_train.py --device cpu --num-envs 8 \\
        --total-timesteps 4096 --num-steps 128

The flags and defaults are ``balance_train.py``'s, plus ``--device``
(default: the card).  Two ``CleanPPOAgent``s (the partner with seed + 1)
step a ``DeviceVecEnv`` of Balance Beam, so on the card every env step is
one launch of the Balance Beam step kernel.  After each update it prints
``update U/N return=... ent=...``.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--num-envs", type=int, default=32)
    p.add_argument("--total-timesteps", type=int, default=100_000)
    p.add_argument("--num-steps", type=int, default=128)
    p.add_argument("--lr", type=float, default=2.5e-4)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--run-dir", default=None)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def build(args):
    """(venv, ego, num_updates) as ``args`` describe them; the partner
    agent is in ``venv.partners``."""
    from madrona_rl_envs_playground_tpu_torch.api import DeviceVecEnv
    from madrona_rl_envs_playground_tpu_torch.envs import balance_beam
    from madrona_rl_envs_playground_tpu_torch.train import CleanPPOAgent

    venv = DeviceVecEnv(balance_beam.Env(), num_envs=args.num_envs, device=args.device)
    num_updates = args.total_timesteps // (args.num_steps * args.num_envs)
    partner = CleanPPOAgent(
        venv, "balance-partner", num_updates=num_updates, num_steps=args.num_steps,
        lr=args.lr, seed=args.seed + 1, verbose=False,
    )
    venv.add_partner_agent(partner)
    ego = CleanPPOAgent(
        venv, "balance-ego", num_updates=num_updates, num_steps=args.num_steps,
        lr=args.lr, seed=args.seed, run_dir=args.run_dir, verbose=args.run_dir is not None,
    )
    return venv, ego, num_updates


def main(argv=None):
    from madrona_rl_envs_playground_tpu_torch.train.cleanrl_ppo import run_decentralized

    args = parse_args(argv)
    venv, ego, num_updates = build(args)

    def report(u, m):
        print(f"update {u}/{num_updates} return={float(m['mean_return']):.3f} "
              f"ent={float(m['entropy']):.3f}")

    return run_decentralized(venv, ego, num_updates * args.num_steps, report)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Hanabi CleanRL PPO training through the port (counterpart of
``scripts/hanabi_train.py``; reference: scripts/hanabi_train.py, with the
fixed-budget variants folded in: ``--total-timesteps`` is the
``hanabi_train_experience`` fixed-experience mode, ``--max-seconds`` the
``hanabi_train_timed`` fixed-wall-clock mode).

    python3 scripts/torch_hanabi_train.py
    python3 scripts/torch_hanabi_train.py --device cpu --config very_small \\
        --num-envs 8 --total-timesteps 2048 --num-steps 128

Decentralized mode (default): two independent ``CleanPPOAgent``s, ego and
partner (seed + 1), each learning from its own turn-based trajectory with
the active-mask GAE, over a ``DeviceVecEnv``: on the card every env step of
a 2-player game is one launch of the Hanabi step kernel.  ``--single``
switches to centralized self-play, one policy for both seats
(``SelfPlayPPO``; the reference's ``hanabi_train_single``/
``hanabi_agent.py`` path), which ends by printing its kernel launches.  The
flags and defaults are ``hanabi_train.py``'s, plus ``--device`` (default:
the card).
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", default="full", choices=["full", "small", "very_small"])
    p.add_argument("--num-envs", type=int, default=128)
    p.add_argument("--total-timesteps", type=int, default=500_000)
    p.add_argument("--num-steps", type=int, default=128)
    p.add_argument("--lr", type=float, default=2.5e-4)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--single", action="store_true", help="centralized self-play")
    p.add_argument("--max-seconds", type=float, default=None,
                   help="stop after this much wall-clock (hanabi_train_timed)")
    p.add_argument("--run-dir", default=None)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def num_updates(args) -> int:
    return max(args.total_timesteps // (args.num_steps * args.num_envs), 1)


def build(args):
    """Decentralized mode: (venv, ego, num_updates) as ``args`` describe
    them; the partner agent is in ``venv.partners``."""
    from madrona_rl_envs_playground_tpu_torch.api import DeviceVecEnv
    from madrona_rl_envs_playground_tpu_torch.envs import hanabi
    from madrona_rl_envs_playground_tpu_torch.train import CleanPPOAgent

    env = hanabi.Env(**hanabi.CONFIGS[args.config])
    updates = num_updates(args)
    venv = DeviceVecEnv(env, num_envs=args.num_envs, device=args.device)
    partner = CleanPPOAgent(
        venv, "hanabi-partner", num_updates=updates, num_steps=args.num_steps,
        lr=args.lr, seed=args.seed + 1, verbose=False,
    )
    venv.add_partner_agent(partner)
    ego = CleanPPOAgent(
        venv, "hanabi-ego", num_updates=updates, num_steps=args.num_steps,
        lr=args.lr, seed=args.seed, run_dir=args.run_dir,
        verbose=args.run_dir is not None,
    )
    return venv, ego, updates


def print_launches() -> None:
    """One line, ``kernel launches: {"<ops module>.<wrapper>": n, ...}``:
    the kernel launches of this process, every wrapper that launched."""
    import json

    from madrona_rl_envs_playground_tpu_torch.ops import acrobot, balance, cartpole, hanabi
    from madrona_rl_envs_playground_tpu_torch.ops import overcooked

    counts = {f"{m.__name__.rsplit('.', 1)[-1]}.{k}": n
              for m in (acrobot, balance, cartpole, hanabi, overcooked)
              for k, n in m.LAUNCHES.items() if n}
    print(f"kernel launches: {json.dumps(counts)}", flush=True)


def main(argv=None):
    args = parse_args(argv)
    if args.single:
        from madrona_rl_envs_playground_tpu_torch.envs import hanabi
        from madrona_rl_envs_playground_tpu_torch.train import SelfPlayConfig, SelfPlayPPO

        env = hanabi.Env(**hanabi.CONFIGS[args.config])
        updates = num_updates(args)
        cfg = SelfPlayConfig(num_steps=args.num_steps, lr=args.lr)
        trainer = SelfPlayPPO(env, num_envs=args.num_envs, cfg=cfg, seed=args.seed,
                              device=args.device)
        metrics = trainer.run(updates, log_every=max(updates // 20, 1))
        print_launches()
        return metrics

    from madrona_rl_envs_playground_tpu_torch.train.cleanrl_ppo import run_decentralized

    venv, ego, updates = build(args)

    def report(u, m):
        print(f"update {u}/{updates} return={float(m['mean_return']):.2f} "
              f"ent={float(m['entropy']):.3f}")

    return run_decentralized(venv, ego, updates * args.num_steps, report,
                             max_seconds=args.max_seconds)


if __name__ == "__main__":
    main()

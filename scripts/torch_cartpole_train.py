#!/usr/bin/env python3
"""CleanRL PPO on Cartpole through the port's vector API (counterpart of
``scripts/cartpole_train.py``; reference: scripts/cartpole_train_torch.py).

    python3 scripts/torch_cartpole_train.py
    python3 scripts/torch_cartpole_train.py --device cpu --num-envs 8 \\
        --total-timesteps 4096 --num-steps 128

The flags and defaults are ``cartpole_train.py``'s, plus ``--device``
(default: the card).  One ``CleanPPOAgent`` steps a ``DeviceVecEnv`` of
Cartpole, so on the card every env step is one launch of the Cartpole step
kernel; with ``--use-baseline`` it steps the port's copy of the Python
oracle env (``oracles/adapters.py`` ``CartpoleOracleEnv(seed=seed + i)``)
under ``SyncVectorEnv``, the batches delivered on the device.  After each
update it prints ``update U/N return=... pg=... ent=...``.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--num-envs", type=int, default=32)
    p.add_argument("--total-timesteps", type=int, default=200_000)
    p.add_argument("--num-steps", type=int, default=128)
    p.add_argument("--lr", type=float, default=2.5e-4)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--run-dir", default=None)
    p.add_argument("--use-baseline", action="store_true",
                   help="python oracle envs under SyncVectorEnv "
                        "(reference: scripts/cartpole_train_numpy.py)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def build(args):
    """(venv, agent, num_updates) as ``args`` describe them."""
    from madrona_rl_envs_playground_tpu_torch.api import DeviceVecEnv, SyncVectorEnv
    from madrona_rl_envs_playground_tpu_torch.envs import cartpole
    from madrona_rl_envs_playground_tpu_torch.train import CleanPPOAgent

    if args.use_baseline:
        from madrona_rl_envs_playground_tpu_torch.api.spaces import Box, Discrete
        from madrona_rl_envs_playground_tpu_torch.oracles.adapters import CartpoleOracleEnv

        venv = SyncVectorEnv([lambda i=i: CartpoleOracleEnv(seed=args.seed + i)
                              for i in range(args.num_envs)], device=args.device)
        venv.observation_space = Box(-float("inf"), float("inf"), (4,))
        venv.share_observation_space = venv.observation_space
        venv.action_space = Discrete(2)
    else:
        venv = DeviceVecEnv(cartpole.Env(), num_envs=args.num_envs, device=args.device)
    num_updates = args.total_timesteps // (args.num_steps * args.num_envs)
    agent = CleanPPOAgent(
        venv, "cartpole", num_updates=num_updates, num_steps=args.num_steps,
        lr=args.lr, seed=args.seed, run_dir=args.run_dir, verbose=args.run_dir is not None,
    )
    return venv, agent, num_updates


def main(argv=None):
    from madrona_rl_envs_playground_tpu_torch.train.cleanrl_ppo import run_decentralized

    args = parse_args(argv)
    venv, agent, num_updates = build(args)

    def report(u, m):
        print(f"update {u}/{num_updates} return={float(m['mean_return']):.2f} "
              f"pg={float(m['pg_loss']):.4f} ent={float(m['entropy']):.3f}")

    return run_decentralized(venv, agent, num_updates * args.num_steps, report)


if __name__ == "__main__":
    main()

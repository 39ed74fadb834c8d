#!/usr/bin/env python3
"""Self-play PPO on any env of the PyTorch port (counterpart of
``scripts/selfplay_train.py``).

    python3 scripts/torch_selfplay_train.py --env overcooked --layout cramped_room \\
        --num-envs 8192 --num-steps 64 --hidden 64 --layers 2 --bf16 --updates 2000 \\
        --log-every 1 --seed 1
    python3 scripts/torch_selfplay_train.py --device cpu --num-envs 8 --num-steps 8 \\
        --updates 2 --hidden 16

The flags and defaults are ``selfplay_train.py``'s, less ``--rollout-backend``
(the device decides: the env's step kernel on the card, its plain version on
the CPU), plus ``--device`` (default: the card).  Under ``torchrun
--nproc_per_node=R`` the R ranks train one policy on a mesh, each on its
``--num-envs / R`` worlds (``parallel/``), as JAX's script does under
``jax.distributed``; rank 0 prints.  One
untimed update runs first; the timed updates end on a value read from the
device, and the last line is ``total: ... steps/s``.  Every ``--log-every``
updates the metrics are printed as ``update N: {...}``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_env(name, layout, horizon, num_players):
    from madrona_rl_envs_playground_tpu_torch.envs import (balance_beam, cartpole, hanabi,
                                                           overcooked, overcooked2)

    if name == "cartpole":
        return cartpole.Env()
    if name == "balance":
        return balance_beam.Env()
    if name == "hanabi":
        return hanabi.Env(**hanabi.CONFIGS[layout or "full"])
    if name == "overcooked":
        return overcooked.make(layout or "cramped_room", horizon=horizon,
                               num_players=num_players)
    if name == "overcooked2":
        return overcooked2.make(layout or "simple", horizon=horizon,
                                num_players=num_players)
    raise ValueError(name)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--env", default="overcooked2")
    p.add_argument("--layout", default=None)
    p.add_argument("--horizon", type=int, default=400)
    p.add_argument("--num-players", type=int, default=None)
    p.add_argument("--num-envs", type=int, default=800)
    p.add_argument("--num-steps", type=int, default=128)
    p.add_argument("--updates", type=int, default=50)
    p.add_argument("--lr", type=float, default=2.5e-4)
    p.add_argument("--hidden", type=int, default=512)
    p.add_argument("--layers", type=int, default=3)
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--num-minibatches", type=int, default=1)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 network compute (f32 params/losses)")
    p.add_argument("--ent-coef", type=float, default=0.01)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--log-every", type=int, default=1)
    p.add_argument("--value-loss", default="clipped_mse",
                   choices=["clipped_mse", "smooth_l1"],
                   help="clipped_mse = decentralized driver "
                        "(vectoragent.py); smooth_l1 = centralized driver's "
                        "huber loss with its x128 whole-loss scale "
                        "(centralized_agent.py:381-384)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def build_trainer(args, mesh=None):
    """The ``SelfPlayPPO`` that ``args`` (``parse_args``) describe (on
    ``mesh``, where given)."""
    from madrona_rl_envs_playground_tpu_torch.train.selfplay import (SelfPlayConfig,
                                                                     SelfPlayPPO)

    env = make_env(args.env, args.layout, args.horizon, args.num_players)
    cfg = SelfPlayConfig(
        num_steps=args.num_steps, lr=args.lr, hidden=args.hidden,
        num_layers=args.layers, update_epochs=args.epochs, ent_coef=args.ent_coef,
        num_minibatches=args.num_minibatches, use_bf16=args.bf16,
        value_loss=args.value_loss,
    )
    return SelfPlayPPO(env, num_envs=args.num_envs, cfg=cfg, seed=args.seed,
                       device=args.device, mesh=mesh)


def main(argv=None) -> None:
    from madrona_rl_envs_playground_tpu_torch.parallel import launch, make_mesh

    args = parse_args(argv)
    # a no-op unless torchrun's MASTER_ADDR / WORLD_SIZE / RANK are set
    mesh = make_mesh(device=args.device) if launch.initialize(device=args.device) else None
    if mesh is not None and args.num_envs % mesh.size:
        raise SystemExit(f"--num-envs {args.num_envs} must be divisible by the mesh "
                         f"size {mesh.size}")
    trainer = build_trainer(args, mesh)
    # one untimed update first (kernel load, allocator warm-up); the fence
    # is a device -> host read of a metric, which waits for every update
    # before it, since each depends on the one before
    sync = lambda m: float(next(iter(m.values())))  # noqa: E731
    sync(trainer.run(1, log_every=0))
    t0 = time.time()
    sync(trainer.run(args.updates, log_every=args.log_every))
    dt = time.time() - t0
    steps = args.updates * args.num_steps * args.num_envs
    if launch.is_primary():
        print(f"total: {steps:,} env-steps in {dt:.1f}s -> {steps / dt:,.0f} steps/s "
              f"(steady-state; 1 warmup update excluded)")


if __name__ == "__main__":
    main()

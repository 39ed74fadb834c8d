#!/usr/bin/env python3
"""Self-play PPO on the 8-player ``many_player_layout`` (counterpart of
``scripts/many_player_train_run.py``).

    python3 scripts/torch_many_player_train_run.py --num-envs 16384 --num-steps 4 \\
        --updates 200 --out docs/runs/torch_many_player_training.json
    python3 scripts/torch_many_player_train_run.py --mesh-check
    python3 scripts/torch_many_player_train_run.py --device cpu --mesh-check

A ``SelfPlayPPO`` run on ``many_player_layout`` with ``--players`` seats at
``--num-envs``, recording env-steps/s and the reward curve to ``--out``
with the card's name and power limit.  Eight players lie outside the
Overcooked kernels' envelope (at most 4 players), so every env step is the
plain env on the card (``batched_step``), as JAX steps its ``jnp`` path;
no kernel runs.  One untimed update first, as JAX's compile.  A rollout's
obs buffer holds ``num_steps x num_envs x players x 14,280`` bytes: at
16,384 envs, 4 steps take 7.5 GB and JAX's default 64 would take 120 GB.

``--mesh-check`` runs JAX's tiny config (64 envs, 3 updates of 8 steps, a
2 x 32 net, seed 7) twice, on 2 spawned ranks of one mesh (``gloo``; on the
card both share it) and in this process, and holds the metric streams
against each other at JAX's ``rtol 2e-4, atol 1e-5``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

SCRIPTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(SCRIPTS)
sys.path.insert(0, REPO)
sys.path.insert(0, SCRIPTS)

MESH_ENVS, MESH_UPDATES, MESH_RANKS = 64, 3, 2


def make_env(players):
    from madrona_rl_envs_playground_tpu_torch.envs import overcooked

    return overcooked.make("many_player_layout", num_players=players)


def run(num_envs, players, updates, cfg, seed=0, device=None, log_every=10):
    import torch

    from madrona_rl_envs_playground_tpu_torch.train.selfplay import SelfPlayPPO

    ppo = SelfPlayPPO(make_env(players), num_envs, cfg, seed=seed, device=device)
    sync = lambda m: float(m["pg_loss"])  # noqa: E731
    curve = []
    sync(ppo.train_step())  # warm-up (untimed)
    t0 = time.time()
    for u in range(updates):
        m = ppo.train_step()
        if (u + 1) % log_every == 0 or u == updates - 1:
            curve.append({"update": u + 1, "mean_step_reward": float(m["mean_step_reward"]),
                          "v_loss": float(m["v_loss"]), "entropy": float(m["entropy"])})
    sync(m)
    dt = time.time() - t0
    steps = updates * num_envs * cfg.num_steps
    return {
        "env": "overcooked many_player_layout",
        "players": players,
        "num_envs": num_envs,
        "num_steps": cfg.num_steps,
        "updates": updates,
        "seed": seed,
        "device": str(ppo.device),
        "peak_memory_gb": (torch.cuda.max_memory_allocated(ppo.device) / 1e9
                           if ppo.device.type == "cuda" else None),
        "env_steps_per_s": steps / dt,
        "wall_s": dt,
        "curve": curve,
    }


def _tiny():
    from madrona_rl_envs_playground_tpu_torch.train.selfplay import SelfPlayConfig

    return SelfPlayConfig(num_steps=8, hidden=32, num_layers=2)


def stream(mesh, players, device=None):
    """The tiny config's metrics, update by update (on a ``mesh``, or in
    this process)."""
    from madrona_rl_envs_playground_tpu_torch.train.selfplay import SelfPlayPPO

    ppo = SelfPlayPPO(make_env(players), MESH_ENVS, _tiny(), seed=7,
                      device=device if mesh is None else None, mesh=mesh)
    return [{k: float(v) for k, v in ppo.train_step().items()} for _ in range(MESH_UPDATES)]


def mesh_check(players, device=None):
    """Sharded (2 ranks) against one process: the metric streams must agree
    (float reduction order only)."""
    import numpy as np

    from madrona_rl_envs_playground_tpu_torch.device import resolve_device
    from madrona_rl_envs_playground_tpu_torch.parallel import launch

    dev = resolve_device(device)
    ranks_dir = os.path.join(REPO, "build", "ranks")
    os.makedirs(ranks_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ranks_dir) as store:
        sharded = launch.spawn(stream, MESH_RANKS, (players,), store_dir=store,
                               backend="gloo", device=dev.type, timeout_s=900,
                               threads=1 if dev.type == "cpu" else None)
    single = stream(None, players, dev)
    for r, ranked in enumerate(sharded):
        for u, (a, b) in enumerate(zip(single, ranked)):
            for k in a:
                np.testing.assert_allclose(a[k], b[k], rtol=2e-4, atol=1e-5,
                                           err_msg=f"rank {r} update {u} metric {k}")
    print(f"mesh equivalence OK: {MESH_UPDATES} updates x {len(single[0])} metrics match "
          f"on {MESH_RANKS} ranks ({dev.type})", flush=True)
    return single, sharded


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--num-envs", type=int, default=16384)
    p.add_argument("--players", type=int, default=8)
    p.add_argument("--updates", type=int, default=200)
    p.add_argument("--num-steps", type=int, default=64)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--mesh-check", action="store_true")
    p.add_argument("--out", default="docs/runs/torch_many_player_training.json")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.mesh_check:
        return mesh_check(args.players, args.device)
    from torch_common import card_line

    from madrona_rl_envs_playground_tpu_torch.train.selfplay import SelfPlayConfig

    cfg = SelfPlayConfig(num_steps=args.num_steps, hidden=args.hidden, num_layers=args.layers,
                         use_bf16=args.bf16)
    report = run(args.num_envs, args.players, args.updates, cfg, seed=args.seed,
                 device=args.device, log_every=args.log_every)
    import torch

    report["card"] = card_line(torch.device(report["device"]))
    print(json.dumps({k: v for k, v in report.items() if k != "curve"}, indent=2))
    first, last = report["curve"][0], report["curve"][-1]
    print(f"reward curve: {first['mean_step_reward']:.4f} (u{first['update']})"
          f" -> {last['mean_step_reward']:.4f} (u{last['update']})")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()

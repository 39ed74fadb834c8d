#!/usr/bin/env python3
"""Weak-scaling efficiency of the whole-rollout kernels across world sizes
(counterpart of ``scripts/scaling_bench.py``).

    torchrun --nproc_per_node=4 scripts/torch_scaling_bench.py --envs-per-device 524288
    python3 scripts/torch_scaling_bench.py                     # world size 1
    python3 scripts/torch_scaling_bench.py --device cpu --envs-per-device 8 --num-steps 4

For each world size 1, 2, 4, ... up to the launched world, every rank of
the mesh's first ranks runs ``scripts/torch_bench.py``'s rollout route (K2
for Overcooked, K6, K8, K4) on its ``--envs-per-device`` worlds: one
untimed call, then ``--repeats`` calls between two barriers, each ending on
a read of its checksum.  Each size prints JAX's line, ``devices= envs=
steps/s efficiency=``, where the efficiency is the rate over the world
size's multiple of the one-rank rate.  The rollouts share nothing, so the
barriers are the only collectives.  On the card the kernels run; with
``--device cpu`` their plain versions do (ranks join over ``gloo``).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--env", default="overcooked")
    p.add_argument("--layout", default=None)
    p.add_argument("--envs-per-device", type=int, default=2048)
    p.add_argument("--num-steps", type=int, default=200)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    """Returns the rows ``(devices, envs, steps/s, efficiency)`` of this
    rank's meshes (rank 0: every size)."""
    args = parse_args(argv)
    import torch.distributed as dist

    from madrona_rl_envs_playground_tpu_torch.parallel import launch, make_mesh

    scripts = os.path.dirname(os.path.abspath(__file__))
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    from torch_bench import build_rollout, make_env

    joined = launch.initialize(device=args.device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    sizes, d = [], 1
    while d <= world:
        sizes.append(d)
        d *= 2
    env = make_env(args.env, args.layout, None)
    rows, base_rate = [], None
    for nd in sizes:
        mesh = make_mesh(nd, device=args.device)
        if mesh is not None:
            carry, run = build_rollout(env, args.env, args.envs_per_device, args.num_steps,
                                       device=mesh.device)
            carry, s = run(carry)  # warm-up
            float(s)
            mesh.barrier()
            t0 = time.perf_counter()
            for _ in range(args.repeats):
                carry, s = run(carry)
                float(s)
            mesh.barrier()
            dt = time.perf_counter() - t0
            N = args.envs_per_device * nd
            rate = args.repeats * args.num_steps * N / dt
            base_rate = rate if base_rate is None else base_rate
            eff = rate / (base_rate * nd)
            rows.append((nd, N, rate, eff))
            if mesh.rank == 0:
                print(f"devices={nd:3d} envs={N:7d} {rate:15,.0f} steps/s  "
                      f"efficiency={eff:.1%}", flush=True)
            del carry
        if dist.is_initialized():
            dist.barrier()
    if joined:
        dist.destroy_process_group()
    return rows


if __name__ == "__main__":
    main()

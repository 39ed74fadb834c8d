#!/usr/bin/env python3
"""Multi-card scaling projection of self-play PPO (counterpart of
``scripts/multihost_projection.py``).

    python3 scripts/torch_multihost_projection.py                 # times on the card
    python3 scripts/torch_multihost_projection.py --device cpu --num-envs 16 --repeats 1

The efficiency bound of env-axis data parallelism depends on two numbers,
and the script measures both:

1. **Collective bytes per update**, counted by ``parallel/mesh.py``'s
   ``COLLECTIVES`` over one ``SelfPlayPPO.train_step`` of the bench
   configuration on the CPU, 16 envs a rank as JAX's count: the gradient
   all-reduce (one flat buffer of every parameter a minibatch), the counts
   and the metrics.  The rollout has none.  A rank hands the collectives
   the same bytes whatever the number of ranks, the batch or the device,
   so the count runs in this process on a mesh of one rank.
2. **Compute time of one update** at the bench configuration
   (cramped_room, 64-step rollouts, 2 x 64 net, 4 epochs of one minibatch)
   at ``--num-envs``, one process on the card (K1 steps the env), the
   median of ``--repeats`` after one untimed update, each ending on a read
   of a metric.

The all-reduce traffic of a ring of p ranks is ``2 (p - 1) / p`` times the
bytes a rank hands it, and the projected efficiency ``t_comp / (t_comp +
sum over calls (traffic / B + L))``.  The links' rates ``B`` are NVIDIA's
data sheet figures: NVLink 4 between H100 SXM cards, 900 GB/s a card, and
InfiniBand NDR between hosts, 400 Gb/s a port.  The latency ``L`` a call of
each link is an assumption, not a measurement (``LINKS``).  Prints one JSON
object.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# name -> (bytes/s, seconds a collective call).  The rates are NVIDIA's
# data sheets: NVLink 4 (H100 SXM) 900 GB/s a card; ConnectX-7 InfiniBand
# NDR 400 Gb/s a port.  The latencies are assumptions, not measured: a
# small all-reduce's start-up inside one host, and across hosts through
# the network
LINKS = {"nvlink4_h100_sxm_900GBs": (900e9, 10e-6),
         "ib_ndr_400Gbps_port": (400e9 / 8, 25e-6)}
HOSTS = (2, 4, 8, 16)
COUNT_ENVS_PER_RANK = 16


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--num-envs", type=int, default=8192)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--device", default=None, help="cuda (default) or cpu, for the timing")
    return p.parse_args(argv)


def build_trainer(num_envs, device=None, mesh=None):
    from madrona_rl_envs_playground_tpu_torch.envs import overcooked
    from madrona_rl_envs_playground_tpu_torch.train.selfplay import (SelfPlayConfig,
                                                                     SelfPlayPPO)

    # the published end-to-end bench config: 64-step rollouts, 2 x 64 MLP,
    # 4 PPO epochs of one minibatch
    cfg = SelfPlayConfig(num_steps=64, hidden=64, num_layers=2)
    return SelfPlayPPO(overcooked.make("cramped_room"), num_envs=num_envs, cfg=cfg, seed=0,
                       device=device, mesh=mesh)


def count_update(mesh):
    """On one rank: the collectives of one train_step after an untimed one."""
    from madrona_rl_envs_playground_tpu_torch.parallel import COLLECTIVES, reset_collectives

    trainer = build_trainer(COUNT_ENVS_PER_RANK * mesh.size, mesh=mesh)
    trainer.train_step()
    reset_collectives()
    trainer.train_step()
    params = sum(p.numel() for p in trainer.net.parameters())
    cfg = trainer.cfg
    return {"collectives": {k: dict(v) for k, v in COLLECTIVES.items()}, "param_count": params,
            "param_bytes": sum(p.numel() * p.element_size() for p in trainer.net.parameters()),
            "applications_per_update": cfg.update_epochs * cfg.num_minibatches}


def count_collectives(world: int = 1):
    """Rank 0's count on a mesh of ``world`` CPU ranks (spawned where more
    than one)."""
    from madrona_rl_envs_playground_tpu_torch.parallel import launch, make_mesh

    if world == 1:
        return count_update(make_mesh(device="cpu"))
    os.makedirs(os.path.join(REPO, "build", "ranks"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build", "ranks")) as store:
        return launch.spawn(count_update, world, store_dir=store, backend="gloo",
                            device="cpu", threads=1, timeout_s=600)[0]


def time_update(num_envs, repeats, device=None):
    """Median seconds of one update, on one process."""
    trainer = build_trainer(num_envs, device=device)
    float(trainer.train_step()["pg_loss"])  # untimed
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        float(trainer.train_step()["pg_loss"])
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2], trainer.cfg.num_steps * num_envs


def projection(counted, t_comp):
    """Efficiency by link and number of ranks: the all-reduce bytes of one
    update over a ring, each call paying the link's latency."""
    reduces = {k: v for k, v in counted["collectives"].items() if k.startswith("all_reduce/")}
    nbytes = sum(v["bytes"] for v in reduces.values())
    calls = sum(v["calls"] for v in counted["collectives"].values())
    table = {}
    for name, (bw, latency_s) in LINKS.items():
        table[name] = {f"{p}_ranks": t_comp / (t_comp + 2 * (p - 1) / p * nbytes / bw
                                               + calls * latency_s) for p in HOSTS}
    return table


def main(argv=None):
    args = parse_args(argv)
    from madrona_rl_envs_playground_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    counted = count_collectives()
    grad = counted["collectives"]["all_reduce/grad"]
    out = {
        "param_count": counted["param_count"],
        "collectives_per_update": counted["collectives"],
        "grad_allreduce_bytes": grad["bytes"] // grad["calls"],
        "applications_per_update": counted["applications_per_update"],
        "grad_bytes_per_update": grad["bytes"],
        "allreduce_bytes_per_update": sum(v["bytes"] for k, v in counted["collectives"].items()
                                          if k.startswith("all_reduce/")),
        "all_gathers_per_update": sum(v["calls"] for k, v in counted["collectives"].items()
                                      if k.startswith("all_gather/")),
    }
    t_comp, steps = time_update(args.num_envs, args.repeats, dev)
    out.update(device=str(dev), num_envs=args.num_envs, t_update_s=t_comp,
               env_steps_per_update=steps, steps_per_s=steps / t_comp,
               latency_us_assumed={k: lat * 1e6 for k, (_, lat) in LINKS.items()},
               projected_efficiency=projection(counted, t_comp))
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()

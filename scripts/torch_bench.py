#!/usr/bin/env python3
"""Headline benchmark of the PyTorch port: env-steps/s of one batch simulator.

    python3 scripts/torch_bench.py                      # cramped_room, K2, on the card
    python3 scripts/torch_bench.py --env hanabi --backend step
    python3 scripts/torch_bench.py --device cpu --num-envs 8 --num-steps 4 --repeats 1

Prints ONE JSON line ``{"metric", "value", "unit", "vs_baseline"}`` with
``bench.py``'s keys, metric names and defaults (524,288 envs x 1,000 steps,
median of 5 repeats after one warm-up call, each repeat synced by reading
its checksum), and ``vs_baseline`` against the reference's best A40 figure
(``REFERENCE_GPU``, a copy of ``bench.py``'s table).  ``--backend`` picks the
route, each consuming its outputs as ``bench.py``'s route of that name does:

* ``rollout`` (default; ``bench.py``'s ``persistent`` route): the
  whole-rollout kernels, K2 (Overcooked), K6 (Cartpole), K8 (Balance Beam)
  and K4 (Hanabi), actions from their in-kernel LCGs, the checksum
  ``chk.sum() + dcnt.sum()`` in ``bench.py``'s dtypes;
* ``step`` (``bench.py``'s ``pallas`` route): the step kernels K1, K5, K7 and K3, random actions
  from a ``torch.Generator`` (uniform over the legal moves of K3's mask for
  Hanabi) and every output summed each step;
* ``env`` (``bench.py``'s ``jnp`` route): the plain env through ``core.batch.Simulator``.

A kernel route refuses an env outside its kernel's envelope with
``SystemExit``; nothing changes route on its own.  K4 checks its entry
state on the card; the Hanabi rollout route calls ``check_rollout_envelope``
after each run's checksum read, outside the timed span.  On the card the kernels
run; with ``--device cpu`` their plain versions do.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from madrona_rl_envs_playground_tpu_torch.core.batch import Simulator  # noqa: E402
from madrona_rl_envs_playground_tpu_torch.core.rng import _to_i32  # noqa: E402
from madrona_rl_envs_playground_tpu_torch.device import resolve_device  # noqa: E402
from madrona_rl_envs_playground_tpu_torch.ops import balance as bp  # noqa: E402
from madrona_rl_envs_playground_tpu_torch.ops import cartpole as cp  # noqa: E402
from madrona_rl_envs_playground_tpu_torch.ops import hanabi as hk  # noqa: E402
from madrona_rl_envs_playground_tpu_torch.ops import overcooked as ok  # noqa: E402

# the reference's best A40 number over all its published batch sizes
# (BASELINE.md: overcooked @100k, overcooked2 @10k, hanabi @100k,
# cartpole @1M, balance @1M); a copy of bench.py's REFERENCE_GPU
REFERENCE_GPU = {
    "overcooked": 14_100_000.0,
    "overcooked2": 19_100_000.0,
    "hanabi": 15_700_000.0,
    "cartpole": 1_370_000_000.0,
    "balance": 399_000_000.0,
}
ROUTES = ("rollout", "step", "env")


def make_env(name: str, layout, num_players):
    from madrona_rl_envs_playground_tpu_torch.envs import (balance_beam, cartpole, hanabi,
                                                           overcooked, overcooked2)

    if name == "overcooked":
        return overcooked.make(layout or "cramped_room", num_players=num_players)
    if name == "overcooked2":
        return overcooked2.make(layout or "simple", num_players=num_players)
    if name == "hanabi":
        return hanabi.Env(**hanabi.CONFIGS[layout or "full"])
    if name == "cartpole":
        return cartpole.Env()
    if name == "balance":
        return balance_beam.Env()
    raise ValueError(name)


def metric_name(name: str, layout) -> str:
    tag = layout or {"overcooked": "cramped_room", "overcooked2": "simple",
                     "hanabi": "full"}.get(name, "")
    return f"{name}{'_' + tag if tag else ''}_steps_per_s"


def _i32_total(*parts) -> torch.Tensor:
    """The int32 (wrapping) sum of integer tensors, as JAX sums int32."""
    return _to_i32(sum(p.sum(dtype=torch.int64) for p in parts))


def _require(ok_: bool, backend: str, msg: str) -> None:
    if not ok_:
        raise SystemExit(f"--backend {backend}: {msg}; use --backend env")


def _rollout_route(env, name, N, T, dev):
    if name in ("overcooked", "overcooked2"):
        _require(ok.fused_supported(env), "rollout", "the overcooked kernels cover layouts of "
                 "<= 100 cells and <= 4 players (many_player-scale grids step the plain env)")
        carry = (ok.init_packed(env, N, device=dev),
                 ok.init_action_rng(N, env.num_agents, device=dev))

        def run(carry):
            ts, w, dcnt, chk = ok.fused_rollout(env, *carry, T)
            return (ts, w), _i32_total(chk, dcnt).to(torch.float32)
    elif name in ("cartpole", "balance"):
        mod = cp if name == "cartpole" else bp
        ts, cnt = mod.init_packed(N, device=dev)
        carry = (ts, cnt, mod.init_action_rng(N, device=dev))

        def run(carry):
            ts, w, cnt, dcnt, chk = mod.fused_rollout(*carry, T)
            return (ts, cnt, w), chk.sum() + dcnt.to(torch.float32).sum()
    else:
        _require(hk.fused_supported(env), "rollout", "the hanabi kernels cover 2-player "
                 "configs only")
        _require((env.colors, env.ranks) in _rollout_cards(), "rollout",
                 f"the hanabi rollout kernel is built for {hk.ROLLOUT_CONFIGS}")
        ts, cnt = hk.init_packed(env, N, device=dev)
        carry = (ts, cnt, hk.init_action_rng(N, device=dev))

        def run(carry):
            ts, w, cnt, dcnt, chk = hk.fused_rollout(env, *carry, T)
            return (ts, cnt, w), _i32_total(chk, dcnt).to(torch.float32)
    return carry, run


def _rollout_cards():
    """The (colours, ranks) K4 is instantiated for."""
    from madrona_rl_envs_playground_tpu_torch.envs.hanabi import CONFIGS

    return {(CONFIGS[c]["colors"], CONFIGS[c]["ranks"]) for c in hk.ROLLOUT_CONFIGS}


def legal_uniform(gen, mask: torch.Tensor) -> torch.Tensor:
    """A uniform legal move per (env, seat) of the bool mask ``[N, P, A]``
    (move 0 where none is legal), int32 ``[N, P]``."""
    u = torch.rand(mask.shape, generator=gen, device=mask.device)
    return torch.where(mask, u, -1.0).argmax(-1).to(torch.int32)


def _step_route(env, name, N, T, dev, gen):
    P, A = env.num_agents, env.num_actions
    rand = lambda *shape: torch.randint(0, A, shape, generator=gen, device=dev,  # noqa: E731
                                        dtype=torch.int32)
    if name in ("overcooked", "overcooked2"):
        _require(ok.fused_supported(env), "step", "the overcooked step kernel covers layouts "
                 "of <= 100 cells and <= 4 players")
        carry = (ok.init_packed(env, N, device=dev),)

        def run(carry):
            ts, sums = carry[0], []
            for _ in range(T):
                ts, obs, rew, done = ok.fused_step(env, ts, rand(P, N))
                sums.append(_i32_total(obs, rew, done))
            return (ts,), _i32_total(torch.stack(sums))
    elif name == "cartpole":
        carry = cp.init_packed(N, device=dev)

        def run(carry):
            ts, cnt = carry
            for _ in range(T):
                ts, done, cnt = cp.fused_step(ts, cnt, rand(N, 1))
                chk = ts.st.sum() + done.sum()
            # bench.py's Cartpole step route keeps the last step's sum
            return (ts, cnt), chk + cnt.to(torch.float32)
    elif name == "balance":
        carry = bp.init_packed(N, device=dev)

        def run(carry):
            (ts, cnt), sums = carry, []
            for _ in range(T):
                ts, rew, done, cnt = bp.fused_step(ts, cnt, rand(N, 2))
                sums.append(_i32_total(ts.obs, rew.sum().to(torch.int32), done))
            return (ts, cnt), _i32_total(torch.stack(sums))
    else:
        _require(hk.fused_supported(env), "step", "the hanabi step kernel covers 2-player "
                 "configs only")
        carry = hk.init_packed(env, N, device=dev)

        def run(carry):
            (ts, cnt), sums = carry, []
            for _ in range(T):
                ts, rew, done, cnt = hk.fused_step(env, ts, cnt, legal_uniform(gen, ts.mask))
                sums.append(_i32_total(ts.obs, ts.own, rew, done))
            return (ts, cnt), _i32_total(torch.stack(sums))
    return carry, run


def _env_route(env, name, N, T, dev, gen):
    sim = Simulator(env, N, device=dev)

    def run(sim):
        sums = []
        for _ in range(T):
            if env.masked:
                a = legal_uniform(gen, sim.last_out.action_mask)
            else:
                a = torch.randint(0, env.num_actions, (N, env.num_agents), generator=gen,
                                  device=dev, dtype=torch.int32)
            out = sim.step(a)
            sums.append(_i32_total(out.reward.to(torch.int32), out.obs, out.action_mask,
                                   out.done))
        return sim, _i32_total(torch.stack(sums))
    return sim, run


def build_rollout(env, name: str, num_envs: int, num_steps: int, backend: str = "rollout",
                  device=None):
    """``(carry, run)``: ``run(carry) -> (carry', checksum)`` runs
    ``num_steps`` steps of ``num_envs`` worlds on the route ``backend``
    picks (the step and env routes draw actions from a generator seeded 0)."""
    if backend not in ROUTES:
        raise ValueError(f"backend must be one of {ROUTES}, got {backend!r}")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    if backend == "rollout":
        return _rollout_route(env, name, num_envs, num_steps, dev)
    if backend == "step":
        return _step_route(env, name, num_envs, num_steps, dev, gen)
    return _env_route(env, name, num_envs, num_steps, dev, gen)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--env", default="overcooked", choices=list(REFERENCE_GPU))
    p.add_argument("--layout", default=None,
                   help="layout (overcooked*) or config name (hanabi)")
    p.add_argument("--num-players", type=int, default=None)
    p.add_argument("--num-envs", type=int, default=524288)
    p.add_argument("--num-steps", type=int, default=1000)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--backend", default="rollout", choices=ROUTES,
                   help="rollout (default; bench.py's persistent route): the whole-rollout "
                        "kernel; step (bench.py's pallas route): the step kernel, every "
                        "output summed each step; env (bench.py's jnp route): the plain env "
                        "through Simulator")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def bench(argv=None):
    """Run the bench; returns ``(line, times)``: the JSON line's dict and
    the seconds of each repeat."""
    args = parse_args(argv)
    env = make_env(args.env, args.layout, args.num_players)
    carry, run = build_rollout(env, args.env, args.num_envs, args.num_steps, args.backend,
                               device=args.device)
    # K4 checks its entry state on the card; a refused launch raises here,
    # after the checksum's read has synced
    check = (hk.check_rollout_envelope if args.env == "hanabi" and args.backend == "rollout"
             else lambda device: None)
    carry, s = run(carry)  # warm-up
    float(s)
    check(args.device)
    # each repeat ends on a device -> host read of its checksum
    times = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        carry, s = run(carry)
        float(s)
        times.append(time.perf_counter() - t0)
        check(args.device)
    dt = sorted(times)[len(times) // 2]
    sps = args.num_steps * args.num_envs / dt
    line = {"metric": metric_name(args.env, args.layout), "value": round(sps, 1),
            "unit": "env-steps/s", "vs_baseline": round(sps / REFERENCE_GPU[args.env], 4)}
    return line, times


def main(argv=None) -> None:
    line, _ = bench(argv)
    print(json.dumps(line))


if __name__ == "__main__":
    main()

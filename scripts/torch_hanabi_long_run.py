#!/usr/bin/env python3
"""Long-horizon Hanabi self-play with a logged learning curve (counterpart
of ``scripts/hanabi_long_run.py``).

    python3 scripts/torch_hanabi_long_run.py --run-dir docs/runs/torch_hanabi_long \\
        --max-seconds 1200
    python3 scripts/torch_hanabi_long_run.py --device cpu --config very_small --num-envs 8 \\
        --num-steps 8 --hidden 16 --layers 1 --updates 4 --run-dir /tmp/hl

Centralized self-play (``SelfPlayPPO``, one policy for both seats) on the
full 2-player config, at JAX's flags and defaults (1,024 envs x 128 steps,
a 3 x 512 net, 4 minibatches, lr 2.5e-4, seed 1), with

* a JSONL learning curve in ``--run-dir``/``metrics.jsonl`` (update,
  env-steps, wall-clock, the train metrics, and every ``--eval-every``
  updates a greedy eval), on the card one launch of the Hanabi step kernel,
  K3, an env step;
* the checkpoint ``checkpoint.pt`` (network, Adam, sampler and env state)
  every ``--save-every`` updates and at the end, beside ``progress.json``,
  the update and wall-clock it holds; ``--resume`` continues from them,
  exactly: the resumed run's updates equal the uninterrupted run's;
* ``--max-seconds``, checked before each update, so that the run stops
  between updates and its last checkpoint holds its last logged update.

The greedy eval (``build_eval``) plays ``--eval-envs`` fresh games from
episode 50,000,000 for ``--eval-steps`` steps through the env's collector
(K3 on the card; JAX's steps ``batched_step``) and scores the mean
completed-episode score: Hanabi's reward is the score's change, so an
episode's summed seat-0 reward is its final score.  The run prints the
card's name and power limit first, and each record carries them.
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


def build_eval(trainer, env, num_envs: int, num_steps: int):
    """``eval_fn() -> (mean score, completed episodes)`` of the trainer's
    current network, greedy, on the trainer's device."""
    import torch

    from madrona_rl_envs_playground_tpu_torch.core.batch import batched_reset
    from madrona_rl_envs_playground_tpu_torch.train.fused_collect import make_fused_collect

    N, P, dev = num_envs, env.num_agents, trainer.device
    collect = make_fused_collect(env, N, dev)

    def eval_fn():
        bstate, out = batched_reset(env, N, start_episode=50_000_000, device=dev)
        carry = collect.pack(bstate)
        acc = torch.zeros(N, device=dev)
        total = torch.zeros((), device=dev)
        cnt = torch.zeros((), dtype=torch.int64, device=dev)
        with torch.no_grad():
            for _ in range(num_steps):
                obs = out.obs.reshape(N * P, -1)
                st = out.state_obs.reshape(N * P, -1)
                logits, _ = trainer.net(obs, st, out.action_mask.reshape(N * P, -1))
                action = torch.argmax(logits, -1).to(torch.int32).reshape(N, P)
                carry, out = collect.step(carry, action)
                acc = acc + out.reward[:, 0].float()
                total = total + torch.where(out.done, acc, torch.zeros_like(acc)).sum()
                cnt = cnt + out.done.sum()
                acc = torch.where(out.done, torch.zeros_like(acc), acc)
        return float(total / torch.clamp(cnt, min=1).float()), int(cnt)

    return eval_fn


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", default="full", choices=["full", "small", "very_small"])
    p.add_argument("--num-envs", type=int, default=1024)
    p.add_argument("--num-steps", type=int, default=128)
    p.add_argument("--lr", type=float, default=2.5e-4)
    p.add_argument("--hidden", type=int, default=512)
    p.add_argument("--layers", type=int, default=3)
    p.add_argument("--minibatches", type=int, default=4)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--updates", type=int, default=1_000_000)
    p.add_argument("--max-seconds", type=float, default=None)
    p.add_argument("--run-dir", default="docs/runs/torch_hanabi_long")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--eval-every", type=int, default=100)
    p.add_argument("--save-every", type=int, default=100)
    p.add_argument("--eval-envs", type=int, default=256)
    p.add_argument("--eval-steps", type=int, default=256)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    """Returns the records written by this call."""
    args = parse_args(argv)
    from torch_common import card_line

    from madrona_rl_envs_playground_tpu_torch.envs import hanabi
    from madrona_rl_envs_playground_tpu_torch.train import SelfPlayConfig, SelfPlayPPO

    env = hanabi.Env(**hanabi.CONFIGS[args.config])
    cfg = SelfPlayConfig(num_steps=args.num_steps, lr=args.lr, hidden=args.hidden,
                         num_layers=args.layers, num_minibatches=args.minibatches)
    trainer = SelfPlayPPO(env, num_envs=args.num_envs, cfg=cfg, seed=args.seed,
                          device=args.device)
    card = card_line(trainer.device)
    print(f"card: {card}", flush=True)
    eval_fn = build_eval(trainer, env, args.eval_envs, args.eval_steps)

    os.makedirs(args.run_dir, exist_ok=True)
    ckpt = os.path.join(args.run_dir, "checkpoint.pt")
    progress = os.path.join(args.run_dir, "progress.json")
    curve = os.path.join(args.run_dir, "metrics.jsonl")

    start_update, elapsed0 = 0, 0.0
    if args.resume and os.path.exists(progress):
        trainer.load(ckpt)
        with open(progress) as f:
            done = json.load(f)
        start_update, elapsed0 = done["update"], done["wall_s"]
        print(f"resumed from update {start_update} ({elapsed0:.0f}s elapsed)")

    def save(update, wall):
        trainer.save(ckpt)
        with open(progress, "w") as f:
            json.dump({"update": update, "wall_s": wall}, f)

    steps_per_update = args.num_envs * args.num_steps
    t0 = time.time()
    records = []
    last = start_update  # the last update trained
    with open(curve, "a") as f:
        def write(rec):
            rec["card"] = card
            f.write(json.dumps(rec) + "\n")
            f.flush()
            records.append(rec)

        try:
            for u in range(start_update, args.updates):
                if args.max_seconds is not None and time.time() - t0 > args.max_seconds:
                    break
                metrics = trainer.train_step()
                last = u + 1
                now = time.time()
                if (u + 1) % args.log_every == 0 or u == start_update:
                    rec = {"update": u + 1, "env_steps": (u + 1) * steps_per_update,
                           "wall_s": elapsed0 + (now - t0),
                           **{k: float(v) for k, v in metrics.items()}}
                    if (u + 1) % args.eval_every == 0 or u == start_update:
                        rec["eval_score"], rec["eval_episodes"] = eval_fn()
                    write(rec)
                    print(f"update {rec['update']} steps={rec['env_steps']:,} "
                          f"wall={rec['wall_s']:.0f}s rew={rec['mean_step_reward']:.4f} "
                          f"ent={rec['entropy']:.3f}"
                          + (f" eval_score={rec['eval_score']:.3f}" if "eval_score" in rec
                             else ""), flush=True)
                if (u + 1) % args.save_every == 0:
                    save(u + 1, elapsed0 + (time.time() - t0))
        finally:
            save(last, elapsed0 + (time.time() - t0))
            score, n_eps = eval_fn()
            final = {"final": True, "update": last, "eval_score": score,
                     "eval_episodes": n_eps, "wall_s": elapsed0 + (time.time() - t0),
                     "max_seconds": args.max_seconds}
            write(final)
            print("final deterministic eval:", final, flush=True)
    return records


if __name__ == "__main__":
    main()

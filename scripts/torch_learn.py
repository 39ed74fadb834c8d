#!/usr/bin/env python3
"""Run the self-play learning recipe on the PyTorch port over seeds.

    python scripts/torch_learn.py --env hanabi --seeds 1 2 --device cpu

The recipe is ``chip_smoke.py``'s learning check (``learn_trainer``): 64
envs x 24 steps, a 2 x 64 net, lr 1e-3, 4 epochs of one minibatch, 120
updates, on Balance Beam or on Hanabi's very_small config.  For each seed it
prints the mean step reward per 10 updates, the last-10 mean (the check's
metric) and the entropy of the first and last update.  Imports only the
port; the device defaults to the card.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import LEARN_UPDATES, learn_trainer  # noqa: E402


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--env", choices=["balance", "hanabi"], default="hanabi")
    p.add_argument("--seeds", type=int, nargs="+", default=[1])
    p.add_argument("--updates", type=int, default=LEARN_UPDATES)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args()

    for seed in args.seeds:
        trainer = learn_trainer(args.env, seed, args.device)
        t0 = time.perf_counter()
        metrics = [trainer.train_step() for _ in range(args.updates)]
        wall = time.perf_counter() - t0
        curve = [float(m["mean_step_reward"]) for m in metrics]
        means = [sum(curve[i:i + 10]) / len(curve[i:i + 10]) for i in range(0, len(curve), 10)]
        print(f"{args.env} seed {seed} on {trainer.device}: mean step reward per 10 updates "
              + " ".join(f"{m:.4f}" for m in means)
              + f"; last-10 {means[-1]:.4f}; entropy {float(metrics[0]['entropy']):.4f} -> "
              f"{float(metrics[-1]['entropy']):.4f}; {wall:.1f} s", flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""The flagship self-play run of the PyTorch port, recorded.

    python3 scripts/torch_flagship.py --seeds 1 7 --out runs/flagship

Runs ``scripts/torch_selfplay_train.py`` with the recipe of
``docs/runs/selfplay_cramped_1B.json`` (``RECIPE``: Overcooked cramped_room,
8,192 envs x 64 steps, a 2 x 64 bf16 net, 2,000 updates; lr, epochs,
minibatches, entropy coefficient and horizon at the script's defaults) once
per seed, in its own process, logging every update, and keeps each run's
output (``<out>/seed<S>.log``).  Then, in this process, with trainers built
by the same script from the same recipe: the short form that
``chip_smoke.py`` checks (the first ``SHORT_UPDATES`` updates, every
update's mean step reward) for every seed, and, on the first seed, one
update split into rollout, advantage and PPO epochs, each phase
synchronised, with the rollout's device time from ``torch.profiler``.
Writes ``<out>/torch_selfplay_cramped_1B.json``: the card, each run's
wall-clock, env-steps/s, curve every 100 updates (mean step reward,
entropy) and mean step reward over the last 100 updates (16 whole episodes:
every env resets at once, every 400 / 64 = 6.25 updates), the short forms
and the split.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path[:0] = [REPO, HERE]

import torch_selfplay_train as cli  # noqa: E402

# the flagship's arguments to torch_selfplay_train.py, less the seed
RECIPE = ["--env", "overcooked", "--layout", "cramped_room", "--num-envs", "8192",
          "--num-steps", "64", "--hidden", "64", "--layers", "2", "--bf16",
          "--updates", "2000", "--log-every", "1"]
LAST = 100  # the updates the run's figure averages: whole episodes, as 64 x 100 / 400 = 16
SHORT_UPDATES = 200  # the short form's updates, which chip_smoke.py checks
TOTAL = re.compile(r"total: ([\d,]+) env-steps in ([\d.]+)s -> ([\d,]+) steps/s")
UPDATE = re.compile(r"update (\d+): (\{.*\})")
RUN_TIMEOUT_S = 1500  # one seed's run; about 200 s on an H100


def recipe(seed: int, device=None):
    """The flagship's parsed arguments for ``seed``."""
    argv = RECIPE + ["--seed", str(seed)] + (["--device", str(device)] if device else [])
    return cli.parse_args(argv)


def flagship_trainer(seed: int, device=None):
    """A fresh flagship trainer, built as the CLI builds it."""
    return cli.build_trainer(recipe(seed, device))


class _Curve:
    """A logger for ``SelfPlayPPO.run`` that keeps the mean step rewards."""

    def __init__(self):
        self.values = []

    def add_scalar(self, tag, value, step):
        if tag == "selfplay/mean_step_reward":
            self.values.append(value)


def run_curve(trainer, updates: int):
    """``updates`` updates through ``run``, logging each; returns every
    update's mean step reward."""
    curve = _Curve()
    trainer.run(updates, log_every=1, logger=curve)
    return curve.values


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def run_seed(seed: int, out_dir: str):
    """One CLI run; returns its record."""
    args = recipe(seed)
    argv = RECIPE + ["--seed", str(seed)]
    cmd = [sys.executable, os.path.join(HERE, "torch_selfplay_train.py"), *argv]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=RUN_TIMEOUT_S, cwd=REPO)
    wall = time.perf_counter() - t0
    with open(os.path.join(out_dir, f"seed{seed}.log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"seed {seed}: exit {proc.returncode}\n{proc.stderr[-4000:]}")
    logged = {int(m.group(1)): ast.literal_eval(m.group(2))
              for m in UPDATE.finditer(proc.stdout)}
    window = range(args.updates - LAST + 1, args.updates + 1)
    missing = [u for u in window if u not in logged]
    if missing:
        raise RuntimeError(f"seed {seed}: updates {missing[:5]}... were not logged")
    last = [logged[u]["mean_step_reward"] for u in window]
    total = TOTAL.search(proc.stdout)
    steps_per_update = args.num_envs * args.num_steps
    return {
        "seed": seed, "updates": args.updates, "env_steps": args.updates * steps_per_update,
        "wall_s": float(total.group(2)), "process_wall_s": wall,
        "env_steps_per_s": float(total.group(3).replace(",", "")),
        f"last{LAST}_mean_step_reward": sum(last) / LAST,
        f"last{LAST}": last,
        "curve": [{"update": u, "env_steps": u * steps_per_update,
                   "mean_step_reward": logged[u]["mean_step_reward"],
                   "entropy": logged[u]["entropy"]}
                  for u in sorted(logged) if u % 100 == 0],
        "cmd": "python3 scripts/torch_selfplay_train.py " + " ".join(argv),
    }


def short_form(seed: int):
    """chip_smoke.py's short form: every update's mean step reward."""
    import torch

    curve = run_curve(flagship_trainer(seed, torch.device("cuda", 0)), SHORT_UPDATES)
    return {"seed": seed, "updates": SHORT_UPDATES, "first": curve[0],
            "last10_mean": sum(curve[-10:]) / 10,
            "per_10": [sum(curve[i:i + 10]) / 10 for i in range(0, SHORT_UPDATES, 10)]}


def split(seed: int):
    """One update after three, each phase synchronised; the rollout's
    device time from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    trainer = flagship_trainer(seed, torch.device("cuda", 0))
    trainer.run(3)
    torch.cuda.synchronize()
    t = [time.perf_counter()]
    bstate, out, tr = trainer._rollout()
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    chunks, _ = trainer._advantage(tr, out)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    trainer._update(chunks)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    trainer.state = {"bstate": bstate, "out": out}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer._rollout()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
    return {"rollout_s": t[1] - t[0], "advantage_s": t[2] - t[1], "update_s": t[3] - t[2],
            "profiled_rollout_wall_s": wall, "profiled_rollout_device_s": device,
            "rollout_idle_share": 1 - device / wall if device else None,
            "peak_memory_bytes": torch.cuda.max_memory_allocated()}


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seeds", type=int, nargs="+", default=[1, 7])
    p.add_argument("--out", default=os.path.join(REPO, "runs", "flagship"))
    args = p.parse_args()

    os.makedirs(args.out, exist_ok=True)
    card = card_line()
    print(card, flush=True)
    r = recipe(args.seeds[0])
    record = {"env": f"{r.env} {r.layout}", "num_envs": r.num_envs, "num_steps": r.num_steps,
              "net": f"{r.layers}x{r.hidden} {'bf16' if r.bf16 else 'fp32'}",
              "recipe": f"lr {r.lr}, {r.epochs} epochs, {r.num_minibatches} minibatch, "
                        f"ent_coef {r.ent_coef}, horizon {r.horizon}, {r.value_loss} "
                        f"(scripts/torch_selfplay_train.py defaults)",
              "card": card, "runs": []}
    for seed in args.seeds:
        run = run_seed(seed, args.out)
        print(json.dumps({k: v for k, v in run.items() if k not in ("curve", f"last{LAST}")}),
              flush=True)
        for pt in run["curve"]:
            print(f"  seed {seed} update {pt['update']}: mean step reward "
                  f"{pt['mean_step_reward']:.6f}, entropy {pt['entropy']:.6f}", flush=True)
        record["runs"].append(run)
    record["short_form"] = [short_form(seed) for seed in args.seeds]
    print(json.dumps(record["short_form"]), flush=True)
    record["split"] = split(args.seeds[0])
    print(json.dumps(record["split"]), flush=True)
    with open(os.path.join(args.out, "torch_selfplay_cramped_1B.json"), "w") as f:
        json.dump(record, f, indent=2)


if __name__ == "__main__":
    main()

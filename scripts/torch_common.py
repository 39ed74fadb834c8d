"""Shared benchmark and validation loops of the port's example CLIs.

Counterpart of ``scripts/_common.py`` (reference methodology,
``scripts/cartpole_example.py:11-91``): 5 warm-up steps, a timed
random-action loop reporting step*worlds/sec, optional differential
validation with an ``Error rate:`` line and ``--asserts``, the
``--use-baseline``/``--use-async`` oracle backends and an ``--isolated``
loop.  The env steps through its collector (``train/fused_collect.py``): on
the card its step kernel, on the CPU the kernel's plain version; envs
without a kernel take the plain ``batched_step``.  The device decides, and
the first line printed names the route.  Imports only the port; the device
defaults to the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from madrona_rl_envs_playground_tpu_torch.core.batch import batched_reset  # noqa: E402
from madrona_rl_envs_playground_tpu_torch.core.types import StepOutput  # noqa: E402
from madrona_rl_envs_playground_tpu_torch.device import resolve_device  # noqa: E402
from madrona_rl_envs_playground_tpu_torch.train.fused_collect import (  # noqa: E402
    make_fused_collect,
)


def base_parser(**defaults) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--num-envs", type=int, default=defaults.get("num_envs", 32))
    p.add_argument("--num-steps", type=int, default=defaults.get("num_steps", 1000))
    p.add_argument("--validation", action="store_true")
    p.add_argument("--asserts", action="store_true")
    p.add_argument("--isolated", action="store_true",
                   help="device-side random actions and checksum (isolated sim throughput)")
    p.add_argument("--use-baseline", action="store_true",
                   help="python oracle envs under SyncVectorEnv")
    p.add_argument("--use-async", action="store_true",
                   help="python oracle envs under AsyncVectorEnv (process/env)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def card_line(dev: torch.device):
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them (the first card's), or
    None on the CPU: what every recorded number is written beside."""
    if dev.type != "cuda":
        return None
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def host_output(out: StepOutput, names=None) -> StepOutput:
    """``out`` with its fields copied to numpy arrays (the validators'
    input): all of them, or only ``names`` (the others None)."""
    return StepOutput(**{f.name: (getattr(out, f.name).cpu().numpy()
                                  if names is None or f.name in names else None)
                         for f in dataclasses.fields(out)})


class Stepper:
    """N worlds of ``env`` on ``device`` behind the env's collector."""

    def __init__(self, env, num_envs: int, device):
        self.dev = resolve_device(device)
        self.collect = make_fused_collect(env, num_envs, self.dev)
        bstate, self.out = batched_reset(env, num_envs, device=self.dev)
        self.carry = self.collect.pack(bstate)
        kind = "kernel" if self.collect.kernel and self.dev.type == "cuda" else "plain"
        what = ("its step kernel" if kind == "kernel" else
                "the kernel's plain version" if self.collect.kernel else "batched_step")
        print(f"route: {kind} ({type(env).__module__.rsplit('.', 1)[-1]} through {what} "
              f"on {self.dev})", flush=True)

    def step(self, actions) -> StepOutput:
        actions = torch.as_tensor(actions, dtype=torch.int32).to(self.dev)
        self.carry, self.out = self.collect.step(self.carry, actions)
        return self.out


def run_baseline_loop(env_fns, num_steps: int, seed: int, use_async: bool = False,
                      device=None):
    """Timed random-action loop over the python oracle envs (the reference's
    --use-baseline backend), the batches delivered on ``device``."""
    from madrona_rl_envs_playground_tpu_torch.api import AsyncVectorEnv, SyncVectorEnv

    venv = (AsyncVectorEnv if use_async else SyncVectorEnv)(env_fns, device=device)
    num_envs = venv.num_envs
    P = venv.n_players
    A = venv.env.num_actions
    rs = np.random.RandomState(seed)
    venv.n_reset()
    t0 = time.perf_counter()
    for _ in range(num_steps):
        acts = torch.as_tensor(rs.randint(0, A, size=(P, num_envs)).astype(np.int32))
        venv.n_step(acts)
    dt = time.perf_counter() - t0
    venv.close()
    sps = num_steps * num_envs / dt
    print(f"{sps:,.0f} step*worlds/sec (baseline)")
    return sps


def run_timed_loop(env, num_envs: int, num_steps: int, seed: int,
                   validate_fn=None, asserts: bool = False, device=None):
    """Per-step host-driven loop (the reference's timing bracket).
    ``validate_fn(t, actions, out)`` gets the step's outputs as numpy
    arrays (``host_output``)."""
    sim = Stepper(env, num_envs, device)
    rs = np.random.RandomState(seed)
    errors = 0
    checks = 0

    # warmup (reference warms 5 steps before timing, validating them too:
    # scripts/overcooked_example.py:88-95)
    for t in range(-5, 0):
        a = rs.randint(0, env.num_actions, size=(num_envs, env.num_agents)).astype(np.int32)
        out = sim.step(a)
        if validate_fn is not None:
            bad = validate_fn(t, a, host_output(out))
            if bad and asserts:
                raise AssertionError(f"validation failed at warmup step {t}: {bad}")
    sync(sim.dev)

    t0 = time.perf_counter()
    for t in range(num_steps):
        a = rs.randint(0, env.num_actions, size=(num_envs, env.num_agents)).astype(np.int32)
        out = sim.step(a)
        if validate_fn is not None:
            bad = validate_fn(t, a, host_output(out))
            checks += 1
            if bad:
                errors += 1
                if asserts:
                    raise AssertionError(f"validation failed at step {t}: {bad}")
    sync(sim.dev)
    dt = time.perf_counter() - t0

    sps = num_steps * num_envs / dt
    print(f"{sps:,.0f} step*worlds/sec ({num_steps} steps x {num_envs} worlds in {dt:.3f}s)")
    if validate_fn is not None:
        print(f"Error rate: {errors / max(checks, 1)}")
    return sps


def run_isolated(env, num_envs: int, num_steps: int, seed: int, repeats: int = 3,
                 device=None, draw=None):
    """The whole random-action loop on the device: actions from
    ``torch.randint`` with a seeded ``torch.Generator`` on the device (or
    ``draw(gen, out)``), a checksum kept there, one sync per repeat (JAX
    scans the same loop in one executable; its action stream differs, so
    only the rate compares).  One untimed repeat first."""
    sim = Stepper(env, num_envs, device)
    dev = sim.dev
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (num_envs, env.num_agents)
    if draw is None:
        def draw(gen, out):
            return torch.randint(0, env.num_actions, shape, generator=gen, device=dev,
                                 dtype=torch.int32)

    def run():
        chk = torch.zeros((), dtype=torch.int64, device=dev)
        for _ in range(num_steps):
            out = sim.step(draw(gen, sim.out))
            chk += (out.reward.to(torch.int32).sum() + out.obs.to(torch.int32).sum()
                    + out.done.to(torch.int32).sum())
        return int(chk)  # the repeat's one sync

    run()
    t0 = time.perf_counter()
    for _ in range(repeats):
        run()
    dt = time.perf_counter() - t0
    sps = repeats * num_steps * num_envs / dt
    print(f"{sps:,.0f} step*worlds/sec (isolated, {repeats}x{num_steps} steps x "
          f"{num_envs} worlds)")
    return sps

#!/usr/bin/env python3
"""Count the device records torch.profiler keeps of K11's windows.

    python3 scripts/torch_profiler_windows.py --windows 150

Builds ``csrc/hanabi.cu`` and, for full Hanabi with 2 and with 5 players at
131,072 worlds (hands 30 legal moves in), traces ``--windows`` windows of
100 ``legal_moves`` calls each way: ``cold``, a profiler started just
before the calls, as ``chip_smoke.device_profile`` traces a window; and
``warm``, the active step of a schedule after a traced warm-up step of 20
calls, its ``ProfilerStep`` annotation left out.  Each call launches one
kernel, so a whole window holds 100 records.  Prints one JSON line: the
card, torch's version, and per game a histogram of the records a window
kept.  Needs a CUDA card; imports only the port and ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

CALLS, WARMUP = 100, 20


def records(prof) -> int:
    import torch

    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("ProfilerStep"))


def cold_window(fn) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    return records(prof)


def warm_window(fn) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for window in (WARMUP, CALLS):
            for _ in range(window):
                fn()
            torch.cuda.synchronize()
            prof.step()
    return records(prof)


def main() -> None:
    import torch

    from madrona_rl_envs_playground_tpu_torch.ops import _build

    p = argparse.ArgumentParser()
    p.add_argument("--windows", type=int, default=150)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    _build.build_all(["hanabi"])
    dev, hk = torch.device("cuda"), cs.ops("hanabi")
    out = {"card": cs.card_line(), "torch": torch.__version__, "calls": CALLS}
    for players in (2, 5):
        env = cs.hanabi_env(f"full_{players}p")
        hands = cs.reachable_hands(dev, env, cs.HANABI_SIM_ENVS, seed=7)

        def fn():
            hk.legal_moves(env, *hands)
        fn()
        torch.cuda.synchronize()
        kept, t0 = {"cold": [], "warm": []}, time.perf_counter()
        for _ in range(args.windows):
            kept["cold"].append(cold_window(fn))
            kept["warm"].append(warm_window(fn))
        out[f"{players}p"] = {way: {str(n): xs.count(n) for n in sorted(set(xs))}
                              for way, xs in kept.items()}
        out[f"{players}p"]["seconds"] = time.perf_counter() - t0
    print(json.dumps(out))


if __name__ == "__main__":
    main()

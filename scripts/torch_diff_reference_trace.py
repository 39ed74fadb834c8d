#!/usr/bin/env python3
"""Replay a recorded trace through the port and diff every field exactly
(counterpart of ``scripts/diff_reference_trace.py``).

    python3 scripts/torch_diff_reference_trace.py tests/data/golden/balance.npz
    python3 scripts/torch_diff_reference_trace.py trace.npz --device cpu

The format is ``utils/golden_trace.py``'s (either package writes it); the
replay steps through the env's collector, on the card its step kernel.
Prints the trace's meta, the summary JSON (with its ``route``) and MATCH or
MISMATCH.  Exit code 0 only when the replay matches exactly.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from madrona_rl_envs_playground_tpu_torch.utils.golden_trace import (  # noqa: E402
    diff_trace,
    load_trace,
    make_env_from_meta,
)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("trace")
    p.add_argument("--max-report", type=int, default=10)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    trace = load_trace(args.trace)
    print(f"trace: {json.dumps(trace.meta)}")
    env = make_env_from_meta(trace.meta)
    summary = diff_trace(trace, env, max_report=args.max_report, device=args.device)
    print(json.dumps(summary, indent=2))
    if summary["ok"]:
        print("MATCH: replay is bitwise identical to the recorded trace")
        return 0
    print("MISMATCH: see field report above")
    return 1


if __name__ == "__main__":
    raise SystemExit(main())

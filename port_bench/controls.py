"""Readings that the limits of a cell's compared numbers are set from.

    python3 port_bench/controls.py --workload <cell> --side <side> --seeds <n> [<n> ...]

For each seed, in one process, the cell's compared numbers without a
measured window, from one side: ``program`` (the program's timed path, as a
run's set-up drives it) or one of the driver's ``SIDES`` (the plain
reference put in the program's place: in the precision below the one the
configuration states, or with a fault planted).  Prints one JSON line a
seed.  The benchmark's runs never run this; ``port_bench/tests`` runs it
at a small size.
"""

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def readings(workload: str, side: str, seed: int, device, detail=None):
    """The compared numbers of ``workload`` on ``seed`` from ``side``;
    ``detail``, a dict, gets what the driver reports beside them."""
    from port_bench import common

    bench = load_json(HERE.parent / "BENCHMARK.json")
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    wl = load_json(HERE / "workloads" / f"{workload}.json")
    config = load_json(HERE / "configs" / f"{cell['config']}.json")
    driver = importlib.import_module(f"port_bench.drivers.{wl['driver']}")
    ctx = common.Context(workload=workload, config=config, traffic=wl["traffic"],
                         limits=wl["limits"], seed=seed, seconds=0.0, trace=False,
                         device=device, t0=time.perf_counter())
    if detail is None:
        return driver.readings(ctx, side)
    return driver.readings(ctx, side, detail=detail)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--side", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--detail", action="store_true",
                   help="also print what the driver reports beside the numbers")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("port_bench/controls.py: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        detail = {} if args.detail else None
        checks = readings(args.workload, args.side, seed, dev, detail=detail)
        line = {"workload": args.workload, "side": args.side, "seed": seed,
                "readings": {c["name"]: c["value"] for c in checks}}
        if detail:
            line["detail"] = detail
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

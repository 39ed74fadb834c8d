"""Run one cell of the port's benchmark once and print its result line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: the cell in ``BENCHMARK.json``, its file
``port_bench/workloads/<cell>.json`` (the configuration's name, the
driver's name, the traffic's parameters and the limits of the compared
numbers), the configuration ``port_bench/configs/<config>.json``, the
driver ``port_bench/drivers/<driver>.py`` and each per-layer metric's
reader ``port_bench/metrics/<metric>.py``.  With ``--trace 0`` the line
carries the cell's end-to-end metrics, with ``--trace 1`` its per-layer
ones.  The last lines on standard error, and the line's last key
(``checks``), give each compared number beside its limit.

Exits 2 without a result where the card is missing or has fewer devices
than the cell asks for, and 1 where JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def cell_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def applies(metric: dict, cell: str, e2e_names) -> bool:
    """A metric with ``workloads`` is the listed cells'; one without is
    every cell's (end-to-end) or every cell that reports the end-to-end
    metric it moves (per-layer)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def reader(name: str):
    """The per-layer metric's reader module, ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    args = parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    cell = cell_entry(bench, args.workload)
    wl = load_json(HERE / "workloads" / f"{args.workload}.json")
    config = load_json(HERE / "configs" / f"{cell['config']}.json")

    import torch

    from port_bench import common

    print(f"[{time.perf_counter() - T0:8.3f}] torch imported", file=sys.stderr, flush=True)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"port_bench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    # the precision the configurations state: float32 products in float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    driver = importlib.import_module(f"port_bench.drivers.{wl['driver']}")
    ctx = common.Context(workload=args.workload, config=config, traffic=wl["traffic"],
                         limits=wl["limits"], seed=args.seed, seconds=args.seconds,
                         trace=bool(args.trace), device=torch.device("cuda", 0), t0=T0)
    res = driver.run(ctx)

    e2e_defs = [m for m in bench["end_to_end"] if applies(m, args.workload, ())]
    e2e_names = {m["name"] for m in e2e_defs}
    metrics = {}
    if not args.trace:
        for m in e2e_defs:
            metrics[m["name"]] = {"value": res.e2e[m["name"]], "unit": m["unit"]}
    else:
        for m in bench["per_layer"]:
            if applies(m, args.workload, e2e_names):
                value = reader(m["name"]).read(res.trace)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    found = common.loaded_forbidden()
    if found:
        print(f"port_bench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 1
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in res.checks)
    correct = correct and res.failed == 0
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
              "memory_peak_bytes": res.memory_peak_bytes}
    if args.trace and "profile" in res.trace:
        device["busy_s"] = res.trace["profile"]["busy_s"]
        device["window_s"] = res.trace["profile"]["window_s"]
    line = {"correct": correct, "attempted": res.attempted, "failed": res.failed,
            "metrics": metrics, "device": device}
    if args.trace and res.breakdown:
        line["breakdown"] = res.breakdown
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in res.checks}
    for c in res.checks:
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

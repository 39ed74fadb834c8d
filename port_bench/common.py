"""What every driver of the benchmark shares: the run's context, CUDA-event
spans around the program's phases, the profiled window, the device line
and the checks that decide ``correct``."""

from __future__ import annotations

import dataclasses
import gc
import sys
import time
from typing import Callable, Dict, List, Optional

import torch

from . import yardstick

# the top-level module names that may not be loaded in a run: JAX and the
# JAX package (whose name the port's name begins with, so names are
# compared whole)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "madrona_rl_envs_playground_tpu")
PROFILE_ATTEMPTS = 3  # windows traced before a damaged one is given up
PROFILE_PAD = 200  # small launches ahead of each profiled window, which a dropped head takes


@dataclasses.dataclass
class Context:
    """One run: the cell's configuration and traffic files, its arguments,
    and the process's start on the host clock."""
    workload: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float

    def log(self, msg: str) -> None:
        print(f"[{time.perf_counter() - self.t0:8.3f}] {msg}", file=sys.stderr, flush=True)


@dataclasses.dataclass
class Result:
    """What a driver hands back: its end-to-end values (``--trace 0``) or
    its trace for the per-layer readers (``--trace 1``), the work attempted
    and failed in the window, and the compared numbers with their limits."""
    e2e: Dict[str, float]
    trace: Dict
    attempted: int
    failed: int
    checks: List[Dict]
    memory_peak_bytes: int
    breakdown: Optional[Dict] = None


def loaded_forbidden(modules=None) -> List[str]:
    """The forbidden top-level names among ``modules`` (by default the
    names ``sys.modules`` holds)."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN_MODULES))


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


class Spans:
    """CUDA events recorded on the current stream before and after each call
    of the wrapped methods, with no synchronisation added; on the CPU, host
    times after a synchronous call.  ``total_ms(name)`` sums a method's
    spans once the work has finished."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pairs: Dict[str, list] = {}

    def wrap(self, obj, attr: str, name: str) -> None:
        """Wrap ``obj.attr`` on the instance (its class is left alone)."""
        fn = getattr(obj, attr)
        pairs = self.pairs.setdefault(name, [])
        cuda = self.device.type == "cuda"

        def timed(*args, **kwargs):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                start.record()
            else:
                start = time.perf_counter()
            with torch.profiler.record_function(name):
                out = fn(*args, **kwargs)
            if cuda:
                stop = torch.cuda.Event(enable_timing=True)
                stop.record()
            else:
                stop = time.perf_counter()
            pairs.append((start, stop))
            return out

        setattr(obj, attr, timed)

    @staticmethod
    def unwrap(obj, attr: str) -> None:
        if attr in vars(obj):
            delattr(obj, attr)

    def total_ms(self, name: str) -> float:
        sync(self.device)
        if self.device.type == "cuda":
            return sum(s.elapsed_time(e) for s, e in self.pairs.get(name, []))
        return sum((e - s) * 1e3 for s, e in self.pairs.get(name, []))


def profiled(ctx: Context, fn: Callable[[], None], labels, kernel_prefix: str,
             kernel_records: int) -> Dict:
    """``fn()`` (whole units of work, ending synchronised) under
    ``torch.profiler``, reduced by ``yardstick.reduce_trace``.  On some
    hosts the profiler drops records of a trace (about the first 50, now
    and then most of them), so PROFILE_PAD small launches go ahead of the
    window, and a window that kept no more than half of the
    ``kernel_records`` records of the kernels whose names hold ``kernel_prefix`` that
    ``fn`` launches is traced again, up to PROFILE_ATTEMPTS windows.
    ``labels`` are the names of the ``record_function`` ranges inside, which
    the profiler also reports on the device and which are not device work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    labels = set(labels) | {"window"}
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        sync(ctx.device)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            pad = torch.zeros(1, device=ctx.device)
            for _ in range(PROFILE_PAD):
                pad.add_(1)
            sync(ctx.device)
            with record_function("window"):
                fn()
                sync(ctx.device)
        events = prof.events()
        dev_ev, host_ev, window = [], [], None
        for e in events:
            tr = e.time_range
            if e.device_type == DeviceType.CUDA:
                if e.name not in labels and not getattr(e, "is_user_annotation", False):
                    dev_ev.append((e.name, tr.start, tr.end))
            else:
                host_ev.append((e.name, tr.start, tr.end))
                if e.name == "window":
                    window = (tr.start, tr.end)
        kept = sum(1 for n, s, e in dev_ev if kernel_prefix in n
                   and window is not None and window[0] < e and s < window[1])
        if window is not None and 2 * kept > kernel_records:
            red = yardstick.reduce_trace(dev_ev, host_ev, window)
            red["kernel_records"] = kept
            return red
        ctx.log(f"torch.profiler kept {kept} of {kernel_records} {kernel_prefix} records in "
                f"window {attempt} of {PROFILE_ATTEMPTS}")
    raise RuntimeError(f"torch.profiler kept no more than half the {kernel_prefix} records in "
                       f"{PROFILE_ATTEMPTS} windows")


def breakdown(red: Dict) -> Dict:
    """The trace's ten longest device operations and idle stretches."""
    return {"device_ops": yardstick.top({k: v["seconds"] for k, v in red["ops"].items()}),
            "idle_gaps": yardstick.top(red["idle"])}


def train_window(ctx: Context, step: Callable[[], bool], phases, world_steps: int,
                 flop_per_update: float, peak_flop_per_s: float, k1: Dict,
                 k1_per_update: int) -> Result:
    """A training cell's measured window, and with ``--trace 1`` its spans
    and profiled stretch; the checks are left for the driver to add once
    the trainer is freed.

    ``step()`` runs one update through the cell's own call, makes the host
    read its users make, and returns whether what it read was finite;
    ``phases`` are the (object, method, span name) that the traced window
    times; an update steps ``world_steps`` worlds and launches K1
    (``oc_step_kernel``, at the shape ``k1``) ``k1_per_update`` times."""
    spans = Spans(ctx.device)
    if ctx.trace:
        for obj, attr, name in phases:
            spans.wrap(obj, attr, name)
    failed = updates = 0
    stamps = [time.perf_counter()]
    setup_s = stamps[0] - ctx.t0
    end = stamps[0] + ctx.seconds
    while True:
        failed += not step()
        updates += 1
        stamps.append(time.perf_counter())
        if stamps[-1] >= end:
            break
    window_s = stamps[-1] - stamps[0]
    each = sorted(b - a for a, b in zip(stamps, stamps[1:]))
    ctx.log(f"window: {updates} updates in {window_s:.3f} s, set-up {setup_s:.3f} s; ms an "
            f"update min {each[0] * 1e3:.2f}, median {each[len(each) // 2] * 1e3:.2f}, "
            f"max {each[-1] * 1e3:.2f}")

    res = Result(e2e={}, trace={}, attempted=updates, failed=failed, checks=[],
                 memory_peak_bytes=0)
    if not ctx.trace:
        res.e2e = {"train_env_steps_per_s": updates * world_steps / window_s,
                   "setup_s": setup_s}
    else:
        from madrona_rl_envs_playground_tpu_torch.ops import overcooked as ok

        res.trace["spans"] = {name: spans.total_ms(name) / updates for _, _, name in phases}
        res.trace["window"] = {"seconds": window_s, "updates": updates,
                               "flop_per_update": flop_per_update,
                               "peak_flop_per_s": peak_flop_per_s}
        ok.reset_launches()
        n_prof = ctx.traffic["profile_updates"]

        def stretch():
            for _ in range(n_prof):
                with torch.profiler.record_function("update"):
                    step()

        if ctx.device.type == "cuda":
            red = profiled(ctx, stretch, [n for _, _, n in phases] + ["update"],
                           "oc_step_kernel", n_prof * k1_per_update)
            res.trace["profile"] = red
            res.breakdown = breakdown(red)
        else:
            stretch()
        launches = ok.LAUNCHES["fused_step"]
        ctx.log(f"K1 launches in the profiled stretch: {launches} "
                f"({launches / n_prof:.1f} an update, {k1_per_update} steps an update)")
        res.trace["launches_per_update"] = launches / n_prof
        res.trace["k1"] = k1
        for obj, attr, _ in phases:
            Spans.unwrap(obj, attr)
    res.memory_peak_bytes = memory_peak(ctx.device)
    return res


def free(device: torch.device) -> None:
    """Give back the memory of what the caller has deleted, before the
    reference runs on the same card."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def check(name: str, value: float, limit: float) -> Dict:
    """One compared number: the run is correct only where ``value <=
    limit`` (a number that is not finite fails)."""
    return {"name": name, "value": value, "limit": limit}


def value_gap(program: torch.Tensor, reference: torch.Tensor) -> float:
    """The widest gap between the program's values and the reference's,
    over the reference's largest."""
    ref = reference.float()
    prog = program.to(ref.device).float().reshape(ref.shape)
    return float((prog - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def leaf_norm_gap(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor],
                  keep=None) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    over the larger of the reference's norm of that leaf and of the median
    leaf (some leaves are all but zero).  ``keep`` names the leaves that
    count (all by default)."""
    names = [k for k in reference if keep is None or k in keep]
    ref = {k: float(torch.linalg.vector_norm(reference[k].double())) for k in names}
    prog = {k: float(torch.linalg.vector_norm(program[k].double())) for k in names}
    median = sorted(ref.values())[len(ref) // 2]
    return max(abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30) for k in names)

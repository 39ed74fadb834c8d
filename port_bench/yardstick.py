"""The benchmark's frozen measurement arithmetic: peaks, bounds, FLOP counts
and the reduction of a profiler trace.

Copied from ``chip_smoke.py`` (``HBM_BYTES_PER_S``, ``SCALAR_OPS_PER_S``,
``bound``, ``overcooked_step_work``, ``overcooked_rollout_ops``,
``overcooked_rollout_bound``, ``epoch_flop``, ``device_profile``'s retry of a
damaged window) and kept here, so that a later change to that script or to
the program cannot move the yardstick.  Every count comes from shapes;
nothing here reads a clock.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

# H100 SXM peaks.  HBM: 3.35 TB/s (NVIDIA data sheet).  Instructions:
# 132 SMs x 4 schedulers x 32 lanes x 1.98 GHz = 33.45 T thread-instructions
# a second, the rate at which the card issues instructions of any kind; the
# kernels' operations are counted as single instructions.  Dense matrix
# products: 989 TFLOP/s in bf16 on the tensor cores, 67 TFLOP/s in float32
# outside them (TF32 off), both at the 700 W limit.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 33.45e12
PEAK_FLOP_PER_S = {"bfloat16": 989e12, "float32": 67e12}


def bound(nbytes: float, nops: float) -> Tuple[float, str]:
    """The least time (ms) the card could take: the larger of the bytes at
    HBM speed and the operations at the instruction rate, and which."""
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, nops / SCALAR_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def overcooked_step_work(size: int, players: int, obs_size: int, num_envs: int):
    """What one K1 step of ``num_envs`` worlds must do at the least: the
    bytes it moves (state, timestep and actions read once; state, timestep,
    obs, reward and done written once) and the 32-bit operations of the
    step (one per obs byte, about 4 per cell for the pot snapshot, cook
    ticks and reset, and 50 per player for the interact and the move)."""
    R, P = 4 * size + 6 * players, players
    per_env = (R + 4 + 4 * P) + (R + 4 + obs_size * P + 4 * P + 1)
    nops = num_envs * (P * obs_size + 4 * size + 50 * P)
    return per_env * num_envs, nops


def overcooked_step_bound_ms(size: int, players: int, obs_size: int, num_envs: int) -> float:
    return bound(*overcooked_step_work(size, players, obs_size, num_envs))[0]


def overcooked_rollout_ops(size: int, players: int, variant: str) -> int:
    """Operations of one K2 world-step, a lower count: per cell the load,
    the cook-tick test, each dynamic object channel (v1: 10; v2: 5) and
    each presence and orientation value of the player block (5P); per
    player the LCG draw (4) and the interact and the move (50)."""
    dyn = 10 if variant == "v1" else 5
    return size * (2 + dyn + 5 * players) + 54 * players


def overcooked_rollout_bound_ms(size: int, players: int, variant: str, num_envs: int,
                                num_steps: int) -> float:
    """K2's bound: state, timestep and action words read and written once,
    done count and checksum written, and ``num_steps`` world-steps of
    ``overcooked_rollout_ops`` a world."""
    R, P = 4 * size + 6 * players, players
    return bound(num_envs * (2 * (R + 4 + 4 * P) + 8),
                 num_envs * num_steps * overcooked_rollout_ops(size, players, variant))[0]


def mlp_forward_flop(widths: Sequence[int]) -> int:
    """Matrix-product FLOP of one row through a dense tower whose layer
    widths are ``widths`` (input first): 2 * in * out a layer."""
    return sum(2 * a * b for a, b in zip(widths[:-1], widths[1:]))


def mlp_epoch_flop(widths: Sequence[int]) -> int:
    """Matrix-product FLOP of one row through forward and backward of a
    dense tower: 2 * in * out forward, as much again for the weight
    gradient and for the input gradient, none of the latter for the first
    layer, whose input is the observation (``chip_smoke.py``'s
    ``epoch_flop`` rule)."""
    pairs = list(zip(widths[:-1], widths[1:]))
    return sum(2 * a * b * (2 if i == 0 else 3) for i, (a, b) in enumerate(pairs))


def selfplay_update_flop(towers: Iterable[Sequence[int]], rows: int, epochs: int) -> int:
    """An update's FLOP: the rollout's forward of every tower over ``rows``
    policy rows, then ``epochs`` passes of forward and backward over them."""
    towers = list(towers)
    return rows * (sum(mlp_forward_flop(w) for w in towers)
                   + epochs * sum(mlp_epoch_flop(w) for w in towers))


# ---- the profiler trace ------------------------------------------------------

SHORT_GAP_US = 10.0  # idle stretches shorter than this are summed, not attributed
ATTRIBUTED = 500  # the longest idle stretches each named by the host's activity

def merge_intervals(spans: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def reduce_trace(device_events: Sequence[Tuple[str, float, float]],
                 host_events: Sequence[Tuple[str, float, float]],
                 window: Tuple[float, float]) -> Dict:
    """Device time and idle gaps of one profiled window.

    ``device_events`` and ``host_events`` are (name, start, end) in
    microseconds on one clock; ``window`` is the (start, end) of the host's
    window.  Returns ``busy_s`` (the union of the device operations' spans
    inside the window), ``window_s``, the device time and record count of
    every operation of the window by name (``ops``), and the device's idle
    seconds within the window by what the host was doing (``idle``: label
    -> seconds)."""
    w0, w1 = window
    clipped = [(max(s, w0), min(e, w1)) for _, s, e in device_events if e > w0 and s < w1]
    busy = merge_intervals(clipped)
    busy_us = sum(e - s for s, e in busy)
    ops: Dict[str, Dict[str, float]] = {}
    for name, s, e in device_events:
        if e <= w0 or s >= w1:
            continue
        rec = ops.setdefault(name, {"count": 0, "seconds": 0.0})
        rec["count"] += 1
        rec["seconds"] += (e - s) / 1e6
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    # each long gap is named by the innermost host event that covers its
    # middle; the many short ones between back-to-back operations, and the
    # long ones past the ATTRIBUTED longest, are summed under one name each
    starts = np.array([h[1] for h in host_events], dtype=np.float64)
    ends = np.array([h[2] for h in host_events], dtype=np.float64)
    idle: Dict[str, float] = {}
    long_gaps = sorted((g for g in gaps if g[1] - g[0] >= SHORT_GAP_US),
                       key=lambda g: g[0] - g[1])
    for i, (s, e) in enumerate(long_gaps):
        label = "later gaps (not attributed)"
        if i < ATTRIBUTED and len(starts):
            mid = (s + e) / 2
            cover = np.nonzero((starts <= mid) & (ends >= mid))[0]
            label = (host_events[cover[np.argmin(ends[cover] - starts[cover])]][0]
                     if len(cover) else "no host event")
        idle[label] = idle.get(label, 0.0) + (e - s) / 1e6
    short = sum(e - s for s, e in gaps if e - s < SHORT_GAP_US)
    if short:
        idle[f"gaps under {SHORT_GAP_US:g} us between operations"] = short / 1e6
    return {"busy_s": busy_us / 1e6, "window_s": (w1 - w0) / 1e6, "ops": ops, "idle": idle}


def top(items: Dict[str, float], n: int = 10) -> List[List]:
    """The ``n`` largest entries as [name, value] pairs."""
    return [[k, v] for k, v in sorted(items.items(), key=lambda kv: -kv[1])[:n]]

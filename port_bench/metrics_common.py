"""What the per-layer readers share: a kernel's roofline share and the
device's idle share, from the trace a driver hands back."""

from __future__ import annotations

from typing import Optional

from port_bench import yardstick


def kernel_roofline(trace: dict, prefix: str, shape_key: str) -> Optional[float]:
    """The bound of the kernel whose device records name ``prefix``,
    at the shape ``trace[shape_key]``, over its mean device time a record,
    in %; None where the trace holds no such record."""
    prof, shape = trace.get("profile"), trace.get(shape_key)
    if not prof or not shape:
        return None
    recs = [v for k, v in prof["ops"].items() if prefix in k]
    count = sum(r["count"] for r in recs)
    if not count:
        return None
    mean_ms = sum(r["seconds"] for r in recs) / count * 1e3
    if "num_steps" in shape:
        bound_ms = yardstick.overcooked_rollout_bound_ms(
            shape["size"], shape["players"], shape["variant"], shape["num_envs"],
            shape["num_steps"])
    else:
        bound_ms = yardstick.overcooked_step_bound_ms(
            shape["size"], shape["players"], shape["obs_size"], shape["num_envs"])
    return 100.0 * bound_ms / mean_ms


def idle_share(trace: dict) -> Optional[float]:
    prof = trace.get("profile")
    if not prof or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])

"""K3 (``hk_step_kernel``, ``ops/hanabi.py`` ``fused_step``) at the
trainer's batch: its frozen bound (``yardstick_hanabi.k3_bound_ms`` at the
shape ``trace["k3"]``) over its mean device time a launch in the profiled
stretch, in %."""

from port_bench import yardstick_hanabi


def read(trace):
    prof, shape = trace.get("profile"), trace.get("k3")
    if not prof or not shape:
        return None
    recs = [v for k, v in prof["ops"].items() if "hk_step_kernel" in k]
    count = sum(r["count"] for r in recs)
    if not count:
        return None
    mean_ms = sum(r["seconds"] for r in recs) / count * 1e3
    game = {k: v for k, v in shape.items() if k != "num_envs"}
    return 100.0 * yardstick_hanabi.k3_bound_ms(game, shape["num_envs"]) / mean_ms

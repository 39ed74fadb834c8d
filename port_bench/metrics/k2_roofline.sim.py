"""K2 (``oc_rollout_kernel``, ``ops/overcooked.py`` ``fused_rollout``): its
bound (``yardstick.overcooked_rollout_bound_ms``) over its mean device time
a launch in the profiled stretch, in %."""

from port_bench.metrics_common import kernel_roofline


def read(trace):
    return kernel_roofline(trace, "oc_rollout_kernel", "k2")

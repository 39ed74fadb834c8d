"""K1 (``oc_step_kernel``, ``ops/overcooked.py`` ``fused_step``) stepped
alone at the simulator's batch: its bound
(``yardstick.overcooked_step_bound_ms``) over its mean device time a launch
in the profiled stretch, in %."""

from port_bench.metrics_common import kernel_roofline


def read(trace):
    return kernel_roofline(trace, "oc_step_kernel", "k1")

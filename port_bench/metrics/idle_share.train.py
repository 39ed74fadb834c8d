"""The card's idle share over the profiled stretch of whole updates, in %:
1 - (the union of the device operations' spans) / (the stretch's wall
time)."""

from port_bench.metrics_common import idle_share


def read(trace):
    return idle_share(trace)

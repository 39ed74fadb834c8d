"""Set-up in capturing the trainers' graphs (``LoopGraph``'s
``graph.capture:<graph>`` spans: each graph's first call, eager, then its
capture), host seconds over the process."""

from port_bench.metrics_tracing import host_seconds, snapshot


def value(snap):
    return host_seconds(snap, "graph.capture:")


def read(trace):
    return value(snapshot())

"""Set-up in the trainers' construction (the ``construct`` spans of
``SelfPlayPPO`` and ``MAPPORunner``: the nets, the first optimizer, the
collector, the env's reset), host seconds over the process."""

from port_bench.metrics_tracing import host_seconds, snapshot


def value(snap):
    return host_seconds(snap, "construct")


def read(trace):
    return value(snapshot())

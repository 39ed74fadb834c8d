"""The MAPPO runner's returns (``update``'s ``compute`` span: the bootstrap
value, ValueNorm's denormalisation and the replayed returns scan), ms an
update on the device's clock: the program's own span (``utils/tracing.py``),
median over the process's replayed updates."""

from port_bench.metrics_tracing import phase_ms, snapshot


def value(snap):
    return phase_ms(snap, "compute")


def read(trace):
    return value(snapshot())

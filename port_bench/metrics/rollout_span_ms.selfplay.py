"""The self-play trainer's rollout phase (``train_step``'s ``rollout`` span:
pack, the rollout graph's input copy and replay, unpack), ms an update on
the device's clock: the program's own span (``utils/tracing.py``), median
over the process's replayed updates."""

from port_bench.metrics_tracing import phase_ms, snapshot


def value(snap):
    return phase_ms(snap, "rollout")


def read(trace):
    return value(snapshot())

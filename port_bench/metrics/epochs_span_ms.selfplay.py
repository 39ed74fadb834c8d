"""The self-play trainer's PPO epochs (``train_step``'s ``epochs`` span: the
epochs graph's input copy and replay), ms an update on the device's clock:
the program's own span (``utils/tracing.py``), median over the process's
replayed updates."""

from port_bench.metrics_tracing import phase_ms, snapshot


def value(snap):
    return phase_ms(snap, "epochs")


def read(trace):
    return value(snapshot())

"""The MAPPO runner's collect (``update``'s ``collect`` span: pack, the
collect graph's input copy and replay with K1 at the recipe's 800 worlds,
unpack), ms an update on the device's clock: the program's own span
(``utils/tracing.py``), median over the process's replayed updates."""

from port_bench.metrics_tracing import phase_ms, snapshot


def value(snap):
    return phase_ms(snap, "collect")


def read(trace):
    return value(snapshot())

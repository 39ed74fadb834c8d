"""The self-play trainer's advantage phase (``train_step``'s ``advantage``
span: the replayed credit and GAE scans, the normalisation, the chunks), ms
an update on the device's clock: the program's own span
(``utils/tracing.py``), median over the process's replayed updates."""

from port_bench.metrics_tracing import phase_ms, snapshot


def value(snap):
    return phase_ms(snap, "advantage")


def read(trace):
    return value(snapshot())

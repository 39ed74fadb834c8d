"""What a trainer's update runs outside its graphs: the device self time
of the update's phases (each phase's span less its ``graph.*`` children),
ms an update, median over the process's replayed updates."""

from port_bench.metrics_tracing import median_over_updates, phases, snapshot


def per_update(update):
    ms = [s["self_ms"] for s in phases(update) if s["device_ms"] is not None]
    return sum(ms) if ms else None


def value(snap):
    return median_over_updates(snap, per_update)


def read(trace):
    return value(snapshot())

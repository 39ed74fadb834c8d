"""The copies into the trainers' graphs' static inputs (``LoopGraph``'s
``graph.inputs:<graph>`` spans), ms an update on the device's clock, summed
over an update's graphs, median over the process's replayed updates."""

from port_bench.metrics_tracing import median_over_updates, snapshot


def per_update(update):
    ms = [s["device_ms"] for s in update["spans"] if s["name"].startswith("graph.inputs:")]
    return sum(ms) if ms and None not in ms else None


def value(snap):
    return median_over_updates(snap, per_update)


def read(trace):
    return value(snapshot())

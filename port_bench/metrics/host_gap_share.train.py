"""The share of an update's device period (its ``update`` span's first
event to the next update's) that none of its spans covers: device time
that waits on the host between updates, in %, median over the process's
replayed updates.  No profiler is involved."""

from port_bench.metrics_tracing import median_over_updates, snapshot


def per_update(update):
    if not update["period_ms"]:
        return None
    return 100.0 * update["uncovered_ms"] / update["period_ms"]


def value(snap):
    return median_over_updates(snap, per_update)


def read(trace):
    return value(snapshot())

"""The share of the rows the self-play epochs' towers compute that no loss
weighs, in %: 100 x (1 - ``active_rows:epochs`` / ``rows:epochs``), the
program's own counters (``utils/tracing.py``) summed over the process's
updates.  None where the program counts neither."""

from port_bench.metrics_tracing import snapshot


def value(snap):
    counters = (snap or {}).get("counters", {})
    rows, active = counters.get("rows:epochs"), counters.get("active_rows:epochs")
    if not rows or not active or not rows["sum"]:
        return None
    return 100.0 * (1.0 - active["sum"] / rows["sum"])


def read(trace):
    return value(snapshot())

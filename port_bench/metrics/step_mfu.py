"""The whole update's share of the card's dense peak, in %: the matrix
products of every update of the traced run's window (the rollout's forward
of every tower over every policy row, and the epochs' forward and backward,
``yardstick.selfplay_update_flop``), over the window's seconds, over the
peak of the towers' dtype (``yardstick.PEAK_FLOP_PER_S``)."""


def read(trace):
    w = trace.get("window")
    if not w or not w.get("updates") or "flop_per_update" not in w:
        return None
    return 100.0 * w["flop_per_update"] * w["updates"] / w["seconds"] / w["peak_flop_per_s"]

"""Self-play trainer's rollout phase (``SelfPlayPPO._rollout``: the replayed
rollout graph, K1 inside), ms an update: CUDA events around the phase,
summed over the traced run's window and divided by its updates."""


def read(trace):
    return trace.get("spans", {}).get("rollout")

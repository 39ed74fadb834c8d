"""MAPPO runner's collect (``MAPPORunner._collect``: the replayed collect
graph, K1 at the recipe's 800 worlds inside), ms an update: CUDA events
around the phase, summed over the traced run's window and divided by its
updates."""


def read(trace):
    return trace.get("spans", {}).get("collect")

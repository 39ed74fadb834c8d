"""Self-play trainer's PPO epochs (``SelfPlayPPO._update``: the replayed
epochs graph, forward, backward, clip and Adam), ms an update: CUDA events
around the phase, summed over the traced run's window and divided by its
updates."""


def read(trace):
    return trace.get("spans", {}).get("epochs")

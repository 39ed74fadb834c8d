"""MAPPO trainer's epochs (``RMAPPOTrainer.train``: the replayed train
graph over ``models/mappo_nets.py``), ms an update: CUDA events around the
phase, summed over the traced run's window and divided by its updates."""


def read(trace):
    return trace.get("spans", {}).get("train")

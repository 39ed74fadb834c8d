"""Env-axis data parallelism over ``torch.distributed``.

Counterpart of ``madrona_rl_envs_playground_tpu/parallel/``: one process a
rank, each holding its rows of the env batch, the parameters replicated and
the gradients summed across ranks.
"""

from .mesh import (COLLECTIVES, ENV_AXIS, Mesh, batch_sharding, gather_batch_pytree, make_mesh,
                   put_selfplay_state, replicated, reset_collectives, shard_batch_pytree)

__all__ = [
    "COLLECTIVES",
    "ENV_AXIS",
    "Mesh",
    "batch_sharding",
    "gather_batch_pytree",
    "make_mesh",
    "put_selfplay_state",
    "replicated",
    "reset_collectives",
    "shard_batch_pytree",
]

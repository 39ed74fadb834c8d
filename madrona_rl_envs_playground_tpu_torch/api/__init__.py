"""Vector multi-agent API: the PantheonRL-extension layer, on the device.

Counterpart of ``madrona_rl_envs_playground_tpu/api``, with ``DeviceVecEnv``
in place of JAX's ``TpuVecEnv``.
"""

from .agents import RandomVectorAgent, VectorAgent
from .asyncvectorenv import AsyncVectorEnv
from .gym_interop import BalanceVecGym, CartpoleVecGym
from .spaces import Box, Discrete, MultiBinary, MultiDiscrete
from .vectorenv import DeviceVecEnv, PlayerException, SyncVectorEnv, VectorMultiAgentEnv
from .vectorobservation import VectorObservation

__all__ = [
    "BalanceVecGym",
    "CartpoleVecGym",
    "AsyncVectorEnv",
    "RandomVectorAgent",
    "VectorAgent",
    "Box",
    "Discrete",
    "MultiBinary",
    "MultiDiscrete",
    "PlayerException",
    "SyncVectorEnv",
    "DeviceVecEnv",
    "VectorMultiAgentEnv",
    "VectorObservation",
]

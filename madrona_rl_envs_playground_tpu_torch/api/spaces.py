"""Minimal gym-style space descriptors.

The port's own copy of ``madrona_rl_envs_playground_tpu/api/spaces.py`` (the
port imports nothing of the JAX package).  The reference exposes
``gym.spaces`` objects on its vector envs (``pantheonrl_extension/
vectorenv.py:17-23``, ``envs/overcooked_env.py:92-106``) purely as shape and
dtype metadata for building agent networks and sampling actions; gym is not a
dependency here, so these self-contained dataclasses carry the same metadata
under the same attribute names (``shape``, ``dtype``, ``n``, ``nvec``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import numpy as np


@dataclass(frozen=True)
class Space:
    shape: Tuple[int, ...]
    dtype: np.dtype


@dataclass(frozen=True)
class Discrete(Space):
    n: int = 0

    def __init__(self, n: int):
        object.__setattr__(self, "n", int(n))
        object.__setattr__(self, "shape", ())
        object.__setattr__(self, "dtype", np.dtype(np.int64))

    def sample(self, rng=np.random):
        return int(rng.randint(self.n))


@dataclass(frozen=True)
class Box(Space):
    low: float = -np.inf
    high: float = np.inf

    def __init__(self, low, high, shape, dtype=np.float32):
        object.__setattr__(self, "low", low)
        object.__setattr__(self, "high", high)
        object.__setattr__(self, "shape", tuple(shape))
        object.__setattr__(self, "dtype", np.dtype(dtype))


@dataclass(frozen=True)
class MultiBinary(Space):
    def __init__(self, shape):
        if isinstance(shape, int):
            shape = (shape,)
        object.__setattr__(self, "shape", tuple(shape))
        object.__setattr__(self, "dtype", np.dtype(np.int8))


@dataclass(frozen=True)
class MultiDiscrete(Space):
    nvec: Tuple[int, ...] = field(default_factory=tuple)

    def __init__(self, nvec):
        object.__setattr__(self, "nvec", tuple(int(v) for v in nvec))
        object.__setattr__(self, "shape", (len(self.nvec),))
        object.__setattr__(self, "dtype", np.dtype(np.int64))

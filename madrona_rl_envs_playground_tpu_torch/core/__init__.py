from . import rng
from .base import EnvBase
from .batch import batched_reset, batched_step
from .types import BatchState, StepOutput

__all__ = ["rng", "EnvBase", "batched_reset", "batched_step",
           "BatchState", "StepOutput"]

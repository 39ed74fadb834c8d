"""PyTorch/CUDA port of ``madrona_rl_envs_playground_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference; every module here keeps the
name and structure of its JAX counterpart.  Plain tensor code is PyTorch; every
Pallas TPU kernel of the JAX package becomes a CUDA C++ kernel for ``sm_90a``
(sources in ``csrc/``, built with ``nvcc`` at first use into
``build/kernels/``).

The device decides the backend: entry points take ``device=`` and default to
``"cuda"``; a kernel wrapper launches its kernel for a CUDA tensor and runs its
plain PyTorch version only for a CPU tensor.  Nothing falls back.
"""

from .device import resolve_device

__all__ = ["resolve_device"]

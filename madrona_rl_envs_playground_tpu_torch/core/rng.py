"""Bitwise-parity RNG: the reference simulators' per-episode TEA + LCG streams.

Counterpart of ``madrona_rl_envs_playground_tpu/core/rng.py``.  An episode
index is hashed by an 8-round TEA into the first word of a 32-bit LCG whose
low 24 bits become a float in [0, 1).

PyTorch has no full ``uint32`` arithmetic, and ``>>`` on a signed int32 tensor
is an arithmetic shift where TEA needs a logical one.  So a uint32 word is
held here as an int64 tensor masked with ``& 0xFFFFFFFF`` after every step
that can carry past bit 31.  The kernels' int32 helpers (``_i32``,
``_tea_seed``, ``_lcg_next``, ``_unif``; the JAX package keeps them in
``ops/cartpole_pallas.py``) take and return int32 tensors holding the same
bits in two's complement; the CUDA sources use ``uint32_t``.
"""

from __future__ import annotations

import torch

__all__ = ["seed", "next_uint", "uniform", "randint", "uniform_from",
           "lcg_skip_constants"]

_MASK32 = 0xFFFFFFFF
_LCG_A = 1664525
_LCG_C = 1013904223
_TEA_DELTA = 0x9E3779B9
_K0, _K1, _K2, _K3 = 0xA341316C, 0xC8013EA4, 0xAD90777D, 0x7E95761E
_MASK24 = 0x00FFFFFF
_INV_2_24 = 1.0 / float(0x01000000)


def _u32(x) -> torch.Tensor:
    """Any integer tensor -> its low 32 bits as a non-negative int64."""
    return torch.as_tensor(x).to(torch.int64) & _MASK32


def _to_i32(v: torch.Tensor) -> torch.Tensor:
    """uint32 bits held in int64 -> the int32 with the same bits."""
    return (((v & _MASK32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def _tea_u32(v0: torch.Tensor) -> torch.Tensor:
    v0 = _u32(v0)
    v1 = torch.zeros_like(v0)
    s0 = 0
    for _ in range(8):
        s0 = (s0 + _TEA_DELTA) & _MASK32
        v0 = (v0 + ((((v1 << 4) + _K0) ^ (v1 + s0) ^ ((v1 >> 5) + _K1))
                    & _MASK32)) & _MASK32
        v1 = (v1 + ((((v0 << 4) + _K2) ^ (v0 + s0) ^ ((v0 >> 5) + _K3))
                    & _MASK32)) & _MASK32
    return v0


def seed(episode_idx) -> torch.Tensor:
    """Hash episode indices into initial LCG words (uint32 values in int64).

    Parity target: ``RNG::make(idx)`` (reference ``src/cartpole_env/rng.hpp:7-26``).
    """
    return _tea_u32(episode_idx)


def next_uint(v: torch.Tensor) -> torch.Tensor:
    """Advance the LCG word one step."""
    return (_u32(v) * _LCG_A + _LCG_C) & _MASK32


def lcg_skip_constants(k: int):
    """(A^k, C_k) mod 2^32 such that v_k = A^k * v_0 + C_k."""
    a, c = 1, 0
    for _ in range(k):
        a = (a * _LCG_A) % (1 << 32)
        c = (c * _LCG_A + _LCG_C) % (1 << 32)
    return a, c


def uniform_from(v: torch.Tensor) -> torch.Tensor:
    """The [0, 1) sample the LCG word v itself encodes (low 24 bits)."""
    return (v & _MASK24).to(torch.float32) * _INV_2_24


def uniform(v: torch.Tensor):
    """Draw one float32 in [0, 1) with 24-bit resolution; returns (v', sample).

    Parity target: ``RNG::rand()`` (reference ``src/cartpole_env/rng.hpp:28-36``).
    """
    v = next_uint(v)
    return v, uniform_from(v)


def randint(v: torch.Tensor, n):
    """Draw ``int32(n * rand())`` with the reference's truncating casts."""
    v, u = uniform(v)
    n = torch.as_tensor(n, dtype=torch.float32, device=u.device)
    return v, (n * u).to(torch.int32)


# ---- int32 forms shared by the kernels' plain versions ---------------------

def _i32(x: int) -> int:
    """uint32 constant as its two's-complement int32 value."""
    return x - (1 << 32) if x >= (1 << 31) else x


def _tea_seed(idx: torch.Tensor) -> torch.Tensor:
    """8-round TEA on int32 words (bit-parity with ``seed``)."""
    return _to_i32(_tea_u32(idx))


def _lcg_next(v: torch.Tensor) -> torch.Tensor:
    """One LCG step on int32 words, wrapping as uint32 arithmetic does."""
    return _to_i32(next_uint(v))


def _unif(v: torch.Tensor) -> torch.Tensor:
    """[0, 1) from the low 24 bits of the (already advanced) int32 word."""
    return uniform_from(v.to(torch.int64))

"""Value normalization for MAPPO.

Counterpart of ``madrona_rl_envs_playground_tpu/train/mappo/valuenorm.py``:

* ``ValueNorm``: the debiased running mean and variance of the value
  targets (reference ``train/MAPPO/utils/valuenorm.py``: EMA with
  beta = 0.99999, optional per-element weighting, variance clamped to
  >= 1e-2), as three float32 scalar tensors;
* ``popart_update``: the PopArt head update (reference ``utils/popart.py``),
  which rescales the critic's output layer so that its outputs survive the
  new statistics.  It shares the ValueNorm state.

The functions return new states; a trainer keeps one state for its
lifetime and ``vn_copy_``s each new one into it, since a CUDA graph of its
update reads and writes those tensors.

On a mesh (``parallel/mesh.py``) the batch moments are those of the whole
batch: this rank's sums and the global count, summed over the ranks in one
all-reduce.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from ...device import DeviceLike, resolve_device
from ..optim import all_sum


@dataclasses.dataclass(frozen=True)
class ValueNormState:
    running_mean: torch.Tensor     # [] f32
    running_mean_sq: torch.Tensor  # [] f32
    debiasing_term: torch.Tensor   # [] f32


def init_valuenorm(device: DeviceLike = None) -> ValueNormState:
    dev = resolve_device(device)
    z = lambda: torch.zeros((), dtype=torch.float32, device=dev)  # noqa: E731
    return ValueNormState(running_mean=z(), running_mean_sq=z(), debiasing_term=z())


def vn_copy_(dst: ValueNormState, src: ValueNormState) -> None:
    """Copy ``src``'s statistics into ``dst``'s tensors in place (from either
    device)."""
    with torch.no_grad():
        for f in dataclasses.fields(dst):
            getattr(dst, f.name).copy_(getattr(src, f.name))


def _debiased_mean_var(s: ValueNormState, epsilon=1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    mean = s.running_mean / torch.clamp(s.debiasing_term, min=epsilon)
    mean_sq = s.running_mean_sq / torch.clamp(s.debiasing_term, min=epsilon)
    var = torch.clamp(mean_sq - mean ** 2, min=1e-2)
    return mean, var


def vn_update(s: ValueNormState, x: torch.Tensor, beta: float = 0.99999,
              per_element_update: bool = False, mesh=None) -> ValueNormState:
    """Fold the moments of ``x`` (on a ``mesh``, of the whole batch of which
    ``x`` is this rank's rows) into the running statistics."""
    n = math.prod(x.shape) * (1 if mesh is None else mesh.size)
    batch_mean, batch_sq_mean = all_sum(mesh, torch.stack([x.sum(), (x ** 2).sum()]),
                                        "valuenorm") / float(n)
    weight = beta ** float(n) if per_element_update else beta
    return ValueNormState(
        running_mean=s.running_mean * weight + batch_mean * (1.0 - weight),
        running_mean_sq=s.running_mean_sq * weight + batch_sq_mean * (1.0 - weight),
        debiasing_term=s.debiasing_term * weight + (1.0 - weight),
    )


def vn_normalize(s: ValueNormState, x: torch.Tensor) -> torch.Tensor:
    mean, var = _debiased_mean_var(s)
    return (x - mean) / torch.sqrt(var)


def vn_denormalize(s: ValueNormState, x: torch.Tensor) -> torch.Tensor:
    mean, var = _debiased_mean_var(s)
    return x * torch.sqrt(var) + mean


def popart_update(kernel: torch.Tensor, bias: torch.Tensor, s: ValueNormState,
                  x: torch.Tensor, beta: float = 0.99999, mesh=None):
    """Update the statistics on ``x`` and rescale the value head so that its
    outputs are preserved (reference ``popart.py:49-73``).  ``kernel`` is
    the head's ``[H]`` weight row, ``bias`` its scalar bias.  Returns
    (kernel', bias', state')."""
    old_mean, old_var = _debiased_mean_var(s)
    old_std = torch.sqrt(old_var)
    s2 = vn_update(s, x, beta=beta, mesh=mesh)
    new_mean, new_var = _debiased_mean_var(s2)
    new_std = torch.sqrt(new_var)
    kernel2 = kernel * old_std / new_std
    bias2 = (old_std * bias + old_mean - new_mean) / new_std
    return kernel2, bias2, s2

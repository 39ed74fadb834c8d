"""Shared network building blocks.

Counterpart of ``madrona_rl_envs_playground_tpu/models/common.py``: orthogonal
weights and zero biases (the reference's ``layer_init``,
``pantheonrl_extension/vectoragent.py:60-64``) and the masked categorical
helpers.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# Large finite mask value instead of -inf: exp(-1e9) == 0 exactly in f32,
# but no infinity enters the graph (-inf gives 0 * -inf = NaN in the entropy
# backward).  MAPPO uses -1e10 for the same reason.
_MASK_NEG = -1e9


def dense(in_features: int, out_features: int, scale: float = math.sqrt(2.0),
          generator: Optional[torch.Generator] = None) -> nn.Linear:
    """``nn.Linear`` with an orthogonal weight of gain ``scale`` and a zero
    bias."""
    layer = nn.Linear(in_features, out_features)
    with torch.no_grad():
        nn.init.orthogonal_(layer.weight, gain=scale, generator=generator)
        layer.bias.zero_()
    return layer


def masked_categorical_logits(logits: torch.Tensor,
                              action_mask: Optional[torch.Tensor]) -> torch.Tensor:
    if action_mask is None:
        return logits
    return torch.where(action_mask, logits, torch.full_like(logits, _MASK_NEG))


def dist_log_prob(logits: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    lp = F.log_softmax(logits, dim=-1)
    return lp.gather(-1, actions.long().unsqueeze(-1)).squeeze(-1)


def dist_entropy(logits: torch.Tensor) -> torch.Tensor:
    lp = F.log_softmax(logits, dim=-1)
    return -(lp.exp() * lp).sum(-1)


def dist_sample(generator: Optional[torch.Generator], logits: torch.Tensor,
                rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """One categorical draw per row, int32, by the Gumbel-max rule JAX's
    ``categorical`` uses: the argmax of the logits plus Gumbel noise made
    from uniforms of ``generator``.  ``rows = (start, total)`` says that the
    logits are rows ``start..`` of a batch of ``total`` rows (one rank's
    share of a batch split over a mesh): the noise is drawn for the whole
    batch and these rows of it are taken, so the draws do not depend on how
    the batch is split.  The stream differs from JAX's threefry draws, so
    tests inject actions instead of comparing samples."""
    flat = logits.float().reshape(-1, logits.shape[-1])
    start, total = rows if rows is not None else (0, flat.shape[0])
    u = torch.rand((total, flat.shape[1]), generator=generator, device=flat.device)
    gumbel = -torch.log(-torch.log(u[start:start + flat.shape[0]]))
    a = torch.argmax(flat + gumbel, dim=-1)
    return a.reshape(logits.shape[:-1]).to(torch.int32)

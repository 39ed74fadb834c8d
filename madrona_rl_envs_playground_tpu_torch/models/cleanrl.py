"""CleanRL-style actor/critic network.

Counterpart of ``madrona_rl_envs_playground_tpu/models/cleanrl.py`` and of the
reference ``CleanRLNetwork`` (``pantheonrl_extension/vectoragent.py:67-116``):
separate actor and critic MLPs, ReLU, orthogonal init (gain sqrt(2) on hidden
layers, 0.01 on the heads), zero biases and a masked categorical head.
Inputs are cast to float at entry (the reference calls ``.float()`` on int8
observations).  With ``use_bf16`` the towers compute in bfloat16 while the
parameters stay float32 and the heads return float32.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .common import dense, masked_categorical_logits


class MLPTower(nn.Module):
    def __init__(self, in_features: int, out_features: int, hidden: int = 512,
                 num_layers: int = 3, out_scale: float = 0.01,
                 use_bf16: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        widths = [in_features] + [hidden] * num_layers
        self.layers = nn.ModuleList(
            [dense(widths[i], widths[i + 1], generator=generator)
             for i in range(num_layers)]
            + [dense(widths[-1], out_features, scale=out_scale, generator=generator)])
        self.compute_dtype = torch.bfloat16 if use_bf16 else torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        h = x.to(dt)
        for layer in self.layers[:-1]:
            h = F.relu(F.linear(h, layer.weight.to(dt), layer.bias.to(dt)))
        head = self.layers[-1]
        return F.linear(h, head.weight.to(dt), head.bias.to(dt)).float()


class CleanRLNetwork(nn.Module):
    def __init__(self, obs_size: int, num_actions: int, hidden: int = 512,
                 num_layers: int = 3, use_bf16: bool = False,
                 state_size: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.actor = MLPTower(obs_size, num_actions, hidden, num_layers,
                              use_bf16=use_bf16, generator=generator)
        self.critic = MLPTower(state_size or obs_size, 1, hidden, num_layers,
                               use_bf16=use_bf16, generator=generator)

    def get_value(self, state: torch.Tensor) -> torch.Tensor:
        return self.critic(state)[..., 0]

    def get_logits(self, obs: torch.Tensor,
                   action_mask: Optional[torch.Tensor]) -> torch.Tensor:
        return masked_categorical_logits(self.actor(obs), action_mask)

    def forward(self, obs: torch.Tensor, state: torch.Tensor,
                action_mask: Optional[torch.Tensor] = None):
        """Returns (logits, value); sampling and log-probs happen outside."""
        return self.get_logits(obs, action_mask), self.get_value(state)


def load_flax_params(net: CleanRLNetwork, params: Mapping) -> None:
    """Copy the JAX package's flax params into ``net`` in place.

    ``params`` is ``{"params": {"actor"|"critic": {"Dense_i": {"kernel":
    [in, out], "bias": [out]}}}}`` with numpy (or array-like) leaves; a flax
    kernel is the transpose of ``nn.Linear.weight`` ``[out, in]``."""
    p = params["params"]
    with torch.no_grad():
        for tower_name in ("actor", "critic"):
            tower = getattr(net, tower_name)
            src = p[tower_name]
            if len(src) != len(tower.layers):
                raise ValueError(f"{tower_name}: {len(src)} flax layers, "
                                 f"{len(tower.layers)} torch layers")
            for i, layer in enumerate(tower.layers):
                d = src[f"Dense_{i}"]
                k = torch.from_numpy(np.array(d["kernel"], np.float32))
                b = torch.from_numpy(np.array(d["bias"], np.float32))
                if tuple(k.shape) != (layer.in_features, layer.out_features):
                    raise ValueError(f"{tower_name}.Dense_{i}: kernel {tuple(k.shape)} "
                                     f"does not fit {layer}")
                layer.weight.copy_(k.t())
                layer.bias.copy_(b)


def flax_params(net: CleanRLNetwork) -> dict:
    """The inverse of ``load_flax_params``: ``net``'s weights as numpy
    arrays in flax's layout and names (``{"params": {"actor"|"critic":
    {"Dense_i": {"kernel": [in, out], "bias": [out]}}}}``)."""
    towers = {}
    for tower_name in ("actor", "critic"):
        towers[tower_name] = {
            f"Dense_{i}": {"kernel": layer.weight.detach().cpu().numpy().T.copy(),
                           "bias": layer.bias.detach().cpu().numpy().copy()}
            for i, layer in enumerate(getattr(net, tower_name).layers)}
    return {"params": towers}

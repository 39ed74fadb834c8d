"""MAPPO actor and critic networks, feed-forward.

Counterpart of ``madrona_rl_envs_playground_tpu/models/mappo_nets.py`` (after
the reference's ``train/MAPPO/utils/mlp.py``, ``act.py`` and
``r_actor_critic.py``):

* ``MLPBase``: an optional LayerNorm of the features, then (Linear -> act ->
  LayerNorm) x (1 + layer_N);
* ``ACTLayer``: the categorical head, illegal logits set to -1e10 (MAPPO's
  value, not the -1e9 of ``models/common.py``);
* ``R_Actor`` / ``R_Critic``: base -> head; the critic's head is named
  ``R_Critic.HEAD_NAME`` (``"v_out"``), which PopArt rescales in place.

Every LayerNorm uses ``eps = 1e-6``, flax's default (PyTorch's is 1e-5).
Init: orthogonal with gain sqrt(2) (ReLU) or 5/3 (tanh) on the base, the
config's ``gain`` (0.01) on the actor head, 1.0 on ``v_out``, zero biases;
Xavier-uniform when ``use_orthogonal`` is off.  ``load_mappo_params`` copies
the JAX package's flax parameters into these modules.

The CNN base (``use_cnn_obs``) and the GRU (``use_recurrent_policy``) are
not ported yet (ROADMAP queue 1, item 11); asking for them raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

_MASK_NEG = -1e10  # reference train/MAPPO/utils/distributions.py
LN_EPS = 1e-6      # flax.linen.LayerNorm's default epsilon


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The reference ``get_config()`` flags that shape the networks."""

    hidden_size: int = 64
    layer_N: int = 1
    use_relu: bool = True
    use_orthogonal: bool = True
    use_feature_normalization: bool = True
    gain: float = 0.01
    use_recurrent_policy: bool = False
    use_popart: bool = True


def _gain(use_relu: bool) -> float:
    # torch.nn.init.calculate_gain('relu') = sqrt(2), 'tanh' = 5/3
    return math.sqrt(2.0) if use_relu else 5.0 / 3.0


def _linear(cfg: ModelConfig, in_features: int, out_features: int,
            scale: Optional[float], generator: Optional[torch.Generator]) -> nn.Linear:
    layer = nn.Linear(in_features, out_features)
    with torch.no_grad():
        if cfg.use_orthogonal:
            gain = _gain(cfg.use_relu) if scale is None else scale
            nn.init.orthogonal_(layer.weight, gain=gain, generator=generator)
        else:
            nn.init.xavier_uniform_(layer.weight, generator=generator)
        layer.bias.zero_()
    return layer


def _check_supported(cfg: ModelConfig, obs_shape: Sequence[int]) -> None:
    if cfg.use_recurrent_policy:
        raise NotImplementedError("the recurrent MAPPO policy (RNNLayer, _train_recurrent) "
                                  "is not ported yet: ROADMAP queue 1, item 11")
    if len(obs_shape) != 1:
        raise NotImplementedError("the CNN base (grid-shaped obs, use_cnn_obs) is not "
                                  "ported yet: ROADMAP queue 1, item 11")


class MLPBase(nn.Module):
    def __init__(self, cfg: ModelConfig, in_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        H = cfg.hidden_size
        self.feature_norm = (nn.LayerNorm(in_features, eps=LN_EPS)
                             if cfg.use_feature_normalization else None)
        widths = [in_features] + [H] * (1 + cfg.layer_N)
        self.layers = nn.ModuleList([_linear(cfg, widths[i], H, None, generator)
                                     for i in range(1 + cfg.layer_N)])
        self.norms = nn.ModuleList([nn.LayerNorm(H, eps=LN_EPS)
                                    for _ in range(1 + cfg.layer_N)])
        self.act = torch.relu if cfg.use_relu else torch.tanh

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.feature_norm is not None:
            x = self.feature_norm(x)
        for lin, norm in zip(self.layers, self.norms):
            x = norm(self.act(lin(x)))
        return x


class ACTLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, num_actions: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.linear = _linear(cfg, cfg.hidden_size, num_actions, cfg.gain, generator)

    def forward(self, x: torch.Tensor, available_actions: Optional[torch.Tensor]):
        logits = self.linear(x)
        if available_actions is not None:
            logits = torch.where(available_actions.bool(), logits,
                                 torch.full_like(logits, _MASK_NEG))
        return logits


class R_Actor(nn.Module):
    def __init__(self, cfg: ModelConfig, obs_shape: Tuple[int, ...], num_actions: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_supported(cfg, obs_shape)
        self.base = MLPBase(cfg, obs_shape[0], generator)
        self.act = ACTLayer(cfg, num_actions, generator)

    def forward(self, obs, available_actions=None):
        """Logits ``[..., A]`` for flat obs ``[..., F]``.  Feed-forward: no
        rnn states and no masks, which only the GRU reads."""
        return self.act(self.base(obs), available_actions)


class R_Critic(nn.Module):
    # the value head's name; PopArt (train/mappo/trainer.py) rescales it
    HEAD_NAME = "v_out"

    def __init__(self, cfg: ModelConfig, obs_shape: Tuple[int, ...],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_supported(cfg, obs_shape)
        self.base = MLPBase(cfg, obs_shape[0], generator)
        # orthogonal with gain 1.0 (r_actor_critic.py:143-147)
        setattr(self, self.HEAD_NAME, _linear(cfg, cfg.hidden_size, 1, 1.0, generator))

    def forward(self, cent_obs):
        head = getattr(self, self.HEAD_NAME)
        return head(self.base(cent_obs))[..., 0]


def get_critic_head(critic: nn.Module) -> nn.Linear:
    """The critic's value head, a ``Linear(H, 1)``.  Raises if a critic
    refactor moved or reshaped it, instead of letting PopArt skip it."""
    head = getattr(critic, R_Critic.HEAD_NAME, None)
    if not isinstance(head, nn.Linear):
        raise KeyError(f"critic has no '{R_Critic.HEAD_NAME}' head; PopArt rescales this "
                       "layer in place: update R_Critic.HEAD_NAME if the head was renamed")
    if head.out_features != 1:
        raise ValueError(f"critic head '{R_Critic.HEAD_NAME}' has {head.out_features} "
                         "outputs; PopArt expects a Linear(H, 1) head")
    return head


# ---- flax parameters -> these modules --------------------------------------

def _copy_linear(layer: nn.Linear, d: Mapping, where: str) -> None:
    k = torch.from_numpy(np.array(d["kernel"], np.float32))
    if tuple(k.shape) != (layer.in_features, layer.out_features):
        raise ValueError(f"{where}: kernel {tuple(k.shape)} does not fit {layer}")
    layer.weight.copy_(k.t())
    layer.bias.copy_(torch.from_numpy(np.array(d["bias"], np.float32)))


def _copy_norm(norm: nn.LayerNorm, d: Mapping, where: str) -> None:
    scale = torch.from_numpy(np.array(d["scale"], np.float32))
    if tuple(scale.shape) != tuple(norm.weight.shape):
        raise ValueError(f"{where}: scale {tuple(scale.shape)} does not fit {norm}")
    norm.weight.copy_(scale)
    norm.bias.copy_(torch.from_numpy(np.array(d["bias"], np.float32)))


def _copy_base(base: MLPBase, src: Mapping, where: str) -> None:
    dense = sorted((k for k in src if k.startswith("Dense_")), key=lambda k: int(k[6:]))
    norms = sorted((k for k in src if k.startswith("LayerNorm_")), key=lambda k: int(k[10:]))
    ours = ([base.feature_norm] if base.feature_norm is not None else []) + list(base.norms)
    if len(dense) != len(base.layers) or len(norms) != len(ours):
        raise ValueError(f"{where}: flax has {len(dense)} Dense and {len(norms)} LayerNorm, "
                         f"the port {len(base.layers)} and {len(ours)}")
    for name, layer in zip(dense, base.layers):
        _copy_linear(layer, src[name], f"{where}.{name}")
    for name, norm in zip(norms, ours):
        _copy_norm(norm, src[name], f"{where}.{name}")


def load_mappo_params(actor: R_Actor, critic: R_Critic, actor_params: Mapping,
                      critic_params: Mapping) -> None:
    """Copy the JAX package's flax MAPPO parameters (numpy or array-like
    leaves) into ``actor`` and ``critic`` in place.  A flax kernel ``[in,
    out]`` is the transpose of ``nn.Linear.weight``; a flax LayerNorm's
    ``scale`` and ``bias`` are ``nn.LayerNorm``'s ``weight`` and ``bias``."""
    a, c = actor_params["params"], critic_params["params"]
    with torch.no_grad():
        _copy_base(actor.base, a["base"], "actor.base")
        _copy_linear(actor.act.linear, a["act"]["Dense_0"], "actor.act")
        _copy_base(critic.base, c["base"], "critic.base")
        _copy_linear(get_critic_head(critic), c[R_Critic.HEAD_NAME], "critic.v_out")

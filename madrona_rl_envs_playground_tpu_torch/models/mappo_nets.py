"""MAPPO actor and critic networks.

Counterpart of ``madrona_rl_envs_playground_tpu/models/mappo_nets.py`` (after
the reference's ``train/MAPPO/utils/mlp.py``, ``cnn.py``, ``rnn.py``,
``act.py`` and ``r_actor_critic.py``):

* ``MLPBase``: an optional LayerNorm of the features, then (Linear -> act ->
  LayerNorm) x (1 + layer_N);
* ``CNNBase``: one 3x3 VALID conv of ``hidden // 2`` channels and the
  activation over input ``[..., W, H, C]`` (JAX's layout), flattened in
  flax's ``[W', H', O]`` order, then (Linear -> act) x 2;
* ``RNNLayer``: ``recurrent_N`` GRU cells, each cell's input hidden state
  multiplied by ``masks`` first (0 resets it), then a LayerNorm; ``step``
  runs one timestep, ``unroll`` a ``[T, N]`` sequence;
* ``ACTLayer``: the categorical head, illegal logits set to -1e10 (MAPPO's
  value, not the -1e9 of ``models/common.py``);
* ``R_Actor`` / ``R_Critic``: base -> optional GRU -> head; the base is the
  CNN where the obs shape has rank 3.  The critic's head is named
  ``R_Critic.HEAD_NAME`` (``"v_out"``), which PopArt rescales in place.

``GRUCell`` holds flax 0.12's ``GRUCell`` parameters, not ``torch.nn.GRU``'s:
input kernels with biases (``ir``, ``iz``, ``in``), recurrent kernels
without (``hr``, ``hz``) and with one (``hn``), stored as one input and one
recurrent ``Linear`` of three blocks each, so that two products make a step.
The optimizer and the global-norm clip see exactly flax's parameters.

Every LayerNorm uses ``eps = 1e-6``, flax's default (PyTorch's is 1e-5).
Init: orthogonal with gain sqrt(2) (ReLU) or 5/3 (tanh) on the bases, the
config's ``gain`` (0.01) on the actor head, 1.0 on ``v_out`` and on the GRU's
input kernels, orthogonal 1.0 on its recurrent kernels, zero biases;
Xavier-uniform where ``use_orthogonal`` is off (the recurrent kernels stay
orthogonal, as in JAX).  ``load_mappo_params`` copies the JAX package's flax
parameters into these modules.
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
    recurrent_N: int = 1
    use_popart: bool = True


def _gain(use_relu: bool) -> float:
    # torch.nn.init.calculate_gain('relu') = sqrt(2), 'tanh' = 5/3
    return math.sqrt(2.0) if use_relu else 5.0 / 3.0


def _init_kernel(cfg: ModelConfig, weight: torch.Tensor, scale: Optional[float],
                 generator: Optional[torch.Generator]) -> None:
    if cfg.use_orthogonal:
        gain = _gain(cfg.use_relu) if scale is None else scale
        nn.init.orthogonal_(weight, gain=gain, generator=generator)
    else:
        nn.init.xavier_uniform_(weight, generator=generator)


def _linear(cfg: ModelConfig, in_features: int, out_features: int,
            scale: Optional[float], generator: Optional[torch.Generator]) -> nn.Linear:
    layer = nn.Linear(in_features, out_features)
    with torch.no_grad():
        _init_kernel(cfg, layer.weight, scale, generator)
        layer.bias.zero_()
    return layer


def _act_fn(cfg: ModelConfig):
    return torch.relu if cfg.use_relu else torch.tanh


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
        self.act = _act_fn(cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.feature_norm is not None:
            x = self.feature_norm(x)
        for lin, norm in zip(self.layers, self.norms):
            x = norm(self.act(lin(x)))
        return x


class CNNBase(nn.Module):
    """Input ``[..., W, H, C]``.  The conv runs channels-first with W on its
    first spatial axis (the flax kernel ``[3, 3, C, O]`` is this
    ``weight.permute(2, 3, 1, 0)``); its output goes back to channels-last
    before the flatten, so that the first Linear's inputs are in flax's
    order."""

    def __init__(self, cfg: ModelConfig, obs_shape: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        W, H, C = (int(d) for d in obs_shape)
        O = cfg.hidden_size // 2
        self.conv = nn.Conv2d(C, O, kernel_size=3)
        with torch.no_grad():
            _init_kernel(cfg, self.conv.weight, None, generator)
            self.conv.bias.zero_()
        flat = (W - 2) * (H - 2) * O
        self.layers = nn.ModuleList([_linear(cfg, flat, cfg.hidden_size, None, generator),
                                     _linear(cfg, cfg.hidden_size, cfg.hidden_size, None,
                                             generator)])
        self.act = _act_fn(cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-3]
        x = x.float().reshape((-1,) + tuple(x.shape[-3:])).permute(0, 3, 1, 2)
        x = self.act(self.conv(x)).permute(0, 2, 3, 1)
        x = x.reshape(tuple(lead) + (-1,))
        for lin in self.layers:
            x = self.act(lin(x))
        return x


class GRUCell(nn.Module):
    """flax's ``GRUCell``: ``r = sigmoid(W_ir x + b_ir + W_hr h)``, ``z =
    sigmoid(W_iz x + b_iz + W_hz h)``, ``n = tanh(W_in x + b_in + r * (W_hn h
    + b_hn))``, ``h' = (1 - z) n + z h``.  ``input`` holds ``[W_ir; W_iz;
    W_in]`` and their biases, ``hidden`` ``[W_hr; W_hz; W_hn]``, ``hn_bias``
    ``b_hn``."""

    def __init__(self, cfg: ModelConfig, in_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        H = cfg.hidden_size
        self.input = nn.Linear(in_features, 3 * H)
        self.hidden = nn.Linear(H, 3 * H, bias=False)
        self.hn_bias = nn.Parameter(torch.zeros(H))
        with torch.no_grad():
            for g in range(3):  # each gate's kernel on its own, as flax's Dense
                _init_kernel(cfg, self.input.weight[g * H:(g + 1) * H], 1.0, generator)
                nn.init.orthogonal_(self.hidden.weight[g * H:(g + 1) * H], gain=1.0,
                                    generator=generator)
            self.input.bias.zero_()

    def forward(self, x: torch.Tensor, h: torch.Tensor,
                gi: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``gi``, when given, is ``self.input(x)`` computed beforehand."""
        i_r, i_z, i_n = (self.input(x) if gi is None else gi).chunk(3, -1)
        h_r, h_z, h_n = self.hidden(h).chunk(3, -1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * (h_n + self.hn_bias))
        return (1.0 - z) * n + z * h


class RNNLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cells = nn.ModuleList([GRUCell(cfg, cfg.hidden_size, generator)
                                    for _ in range(cfg.recurrent_N)])
        self.norm = nn.LayerNorm(cfg.hidden_size, eps=LN_EPS)

    def _cells(self, x, hxs, masks, gi=None):
        m = masks.float().unsqueeze(-1)
        new_h = []
        for i, cell in enumerate(self.cells):
            x = cell(x, hxs[..., i, :] * m, gi if i == 0 else None)
            new_h.append(x)
        return x, torch.stack(new_h, dim=-2)

    def step(self, x: torch.Tensor, hxs: torch.Tensor,
             masks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """One timestep.  x ``[N, H]``; hxs ``[N, L, H]``; masks ``[N]``.
        Returns (features ``[N, H]``, hxs')."""
        x, hxs = self._cells(x, hxs, masks)
        return self.norm(x), hxs

    def unroll(self, xs: torch.Tensor, hxs: torch.Tensor,
               masks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Sequence form.  xs ``[T, N, H]``; hxs ``[N, L, H]``; masks
        ``[T, N]``.  The first cell's input products of all T steps are one
        product; the LayerNorm runs once over the stacked outputs."""
        gi = self.cells[0].input(xs)
        outs = []
        for t in range(xs.shape[0]):
            x, hxs = self._cells(xs[t], hxs, masks[t], gi[t])
            outs.append(x)
        return self.norm(torch.stack(outs)), hxs


class ACTLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, num_actions: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.linear = _linear(cfg, cfg.hidden_size, num_actions, cfg.gain, generator)

    def forward(self, x: torch.Tensor, available_actions: Optional[torch.Tensor] = None):
        logits = self.linear(x)
        if available_actions is not None:
            logits = torch.where(available_actions.bool(), logits,
                                 torch.full_like(logits, _MASK_NEG))
        return logits


def _make_base(cfg: ModelConfig, obs_shape: Sequence[int],
               generator: Optional[torch.Generator]) -> nn.Module:
    if len(obs_shape) == 3:
        return CNNBase(cfg, obs_shape, generator)
    if len(obs_shape) != 1:
        raise ValueError(f"obs shape {tuple(obs_shape)}: MAPPO's bases take rank 1 or 3")
    return MLPBase(cfg, obs_shape[0], generator)


class _Recurrent(nn.Module):
    """Base -> optional GRU, the trunk both nets share."""

    def __init__(self, cfg: ModelConfig, obs_shape: Sequence[int],
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.obs_shape = tuple(int(d) for d in obs_shape)
        self.base = _make_base(cfg, self.obs_shape, generator)
        self.rnn = RNNLayer(cfg, generator) if cfg.use_recurrent_policy else None
        self.state_shape = (cfg.recurrent_N, cfg.hidden_size if self.rnn is not None else 1)

    def _trunk(self, obs, rnn_states, masks, sequence: bool):
        x = self.base(obs.reshape(tuple(obs.shape[:-1]) + self.obs_shape))
        if self.rnn is not None:
            x, rnn_states = (self.rnn.unroll if sequence else self.rnn.step)(
                x, rnn_states, masks)
        return x, rnn_states

    def zero_states(self, batch: int, device=None) -> torch.Tensor:
        """Zero hidden states ``[batch, L, H]`` for ``forward``; width-1
        placeholders where the net is feed-forward, as JAX keeps."""
        return torch.zeros((batch,) + self.state_shape, device=device)


class R_Actor(_Recurrent):
    def __init__(self, cfg: ModelConfig, obs_shape: Tuple[int, ...], num_actions: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg, obs_shape, generator)
        self.act = ACTLayer(cfg, num_actions, generator)

    def forward(self, obs, rnn_states, masks, available_actions=None):
        """JAX's single-step call: flat obs ``[N, F]``, rnn_states ``[N, L,
        H]`` (``zero_states``) and masks ``[N]``.  Returns (logits ``[N,
        A]``, rnn_states'), the states unchanged where the actor is
        feed-forward."""
        x, rnn_states = self._trunk(obs, rnn_states, masks, sequence=False)
        return self.act(x, available_actions), rnn_states

    def unroll(self, obs, rnn_states, masks, available_actions=None):
        """Sequence logits for recurrent training.  obs ``[T, N, F]``;
        masks ``[T, N]``.  Returns (logits ``[T, N, A]``, rnn_states')."""
        x, rnn_states = self._trunk(obs, rnn_states, masks, sequence=True)
        return self.act(x, available_actions), rnn_states


class R_Critic(_Recurrent):
    # the value head's name; PopArt (train/mappo/trainer.py) rescales it
    HEAD_NAME = "v_out"

    def __init__(self, cfg: ModelConfig, obs_shape: Tuple[int, ...],
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg, obs_shape, generator)
        # orthogonal with gain 1.0 (r_actor_critic.py:143-147)
        setattr(self, self.HEAD_NAME, _linear(cfg, cfg.hidden_size, 1, 1.0, generator))

    def _value(self, x):
        return getattr(self, self.HEAD_NAME)(x)[..., 0]

    def forward(self, cent_obs, rnn_states, masks):
        """Returns (values ``[N]``, rnn_states'), as ``R_Actor.forward``."""
        x, rnn_states = self._trunk(cent_obs, rnn_states, masks, sequence=False)
        return self._value(x), rnn_states

    def unroll(self, cent_obs, rnn_states, masks):
        x, rnn_states = self._trunk(cent_obs, rnn_states, masks, sequence=True)
        return self._value(x), rnn_states


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

def _arr(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def _copy_linear(layer: nn.Linear, d: Mapping, where: str) -> None:
    k = _arr(d["kernel"])
    if tuple(k.shape) != (layer.in_features, layer.out_features):
        raise ValueError(f"{where}: kernel {tuple(k.shape)} does not fit {layer}")
    layer.weight.copy_(k.t())
    layer.bias.copy_(_arr(d["bias"]))


def _copy_norm(norm: nn.LayerNorm, d: Mapping, where: str) -> None:
    scale = _arr(d["scale"])
    if tuple(scale.shape) != tuple(norm.weight.shape):
        raise ValueError(f"{where}: scale {tuple(scale.shape)} does not fit {norm}")
    norm.weight.copy_(scale)
    norm.bias.copy_(_arr(d["bias"]))


def _numbered(src: Mapping, prefix: str):
    return sorted((k for k in src if k.startswith(prefix)), key=lambda k: int(k[len(prefix):]))


def _copy_base(base: nn.Module, src: Mapping, where: str) -> None:
    dense = _numbered(src, "Dense_")
    if len(dense) != len(base.layers):
        raise ValueError(f"{where}: flax has {len(dense)} Dense, the port {len(base.layers)}")
    for name, layer in zip(dense, base.layers):
        _copy_linear(layer, src[name], f"{where}.{name}")
    if isinstance(base, CNNBase):
        k = _arr(src["Conv_0"]["kernel"]).permute(3, 2, 0, 1)
        if tuple(k.shape) != tuple(base.conv.weight.shape):
            raise ValueError(f"{where}.Conv_0: kernel does not fit {base.conv}")
        base.conv.weight.copy_(k)
        base.conv.bias.copy_(_arr(src["Conv_0"]["bias"]))
        return
    norms = _numbered(src, "LayerNorm_")
    ours = ([base.feature_norm] if base.feature_norm is not None else []) + list(base.norms)
    if len(norms) != len(ours):
        raise ValueError(f"{where}: flax has {len(norms)} LayerNorm, the port {len(ours)}")
    for name, norm in zip(norms, ours):
        _copy_norm(norm, src[name], f"{where}.{name}")


def _copy_rnn(rnn: Optional[RNNLayer], src: Optional[Mapping], where: str) -> None:
    if (rnn is None) != (src is None):
        raise ValueError(f"{where}: the port's net and the flax tree disagree on the GRU")
    if rnn is None:
        return
    if len(_numbered(src, "gru")) != len(rnn.cells):
        raise ValueError(f"{where}: flax has {len(_numbered(src, 'gru'))} GRU cells, "
                         f"the port {len(rnn.cells)}")
    H = rnn.norm.weight.shape[0]
    for i, cell in enumerate(rnn.cells):
        g = src[f"gru{i}"]
        cell.input.weight.copy_(torch.cat([_arr(g[k]["kernel"]).t() for k in ("ir", "iz", "in")]))
        cell.input.bias.copy_(torch.cat([_arr(g[k]["bias"]) for k in ("ir", "iz", "in")]))
        cell.hidden.weight.copy_(torch.cat([_arr(g[k]["kernel"]).t() for k in ("hr", "hz", "hn")]))
        cell.hn_bias.copy_(_arr(g["hn"]["bias"]))
        if tuple(cell.hidden.weight.shape) != (3 * H, H):
            raise ValueError(f"{where}.gru{i}: recurrent kernels do not fit width {H}")
    _copy_norm(rnn.norm, src["norm"], f"{where}.norm")


def load_mappo_params(actor: R_Actor, critic: R_Critic, actor_params: Mapping,
                      critic_params: Mapping) -> None:
    """Copy the JAX package's flax MAPPO parameters (numpy or array-like
    leaves) into ``actor`` and ``critic`` in place.  A flax kernel ``[in,
    out]`` is the transpose of ``nn.Linear.weight``, a conv kernel ``[3, 3,
    C, O]`` the ``permute(3, 2, 0, 1)`` of ``nn.Conv2d.weight``; a flax
    LayerNorm's ``scale`` and ``bias`` are ``nn.LayerNorm``'s ``weight`` and
    ``bias``; a GRU cell's six Dense layers fill its two Linears and
    ``hn_bias``."""
    a, c = actor_params["params"], critic_params["params"]
    with torch.no_grad():
        _copy_base(actor.base, a["base"], "actor.base")
        _copy_rnn(actor.rnn, a.get("rnn"), "actor.rnn")
        _copy_linear(actor.act.linear, a["act"]["Dense_0"], "actor.act")
        _copy_base(critic.base, c["base"], "critic.base")
        _copy_rnn(critic.rnn, c.get("rnn"), "critic.rnn")
        _copy_linear(get_critic_head(critic), c[R_Critic.HEAD_NAME], "critic.v_out")

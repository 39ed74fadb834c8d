"""MAPPO policy: an actor and a critic, each with its own optimizer.

Counterpart of ``madrona_rl_envs_playground_tpu/train/mappo/policy.py``
(reference ``R_MAPPOPolicy``, ``train/MAPPO/rMAPPOPolicy.py``):
``get_actions``, ``get_values``, ``evaluate_actions``, two Adam optimizers
(lr and critic_lr, eps ``opti_eps``),
each behind optax's global-norm clip (``train/optim.py``, applied by the
trainer), and the linear learning-rate decay.  The JAX policy keeps its
state in a pytree; here the modules and optimizers hold it.  Sampling goes
through ``models/common.dist_sample`` with an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...device import DeviceLike, resolve_device
from ...models.common import dist_entropy, dist_log_prob, dist_sample
from ...models.mappo_nets import R_Actor, R_Critic
from .config import MAPPOConfig


class MAPPOPolicy:
    def __init__(self, cfg: MAPPOConfig, obs_shape, share_obs_shape, num_actions: int,
                 seed: int = 0, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.mc = cfg.model_config()
        self.num_actions = num_actions
        self.obs_shape = tuple(obs_shape)
        self.share_obs_shape = tuple(share_obs_shape)
        gen = torch.Generator().manual_seed(seed)
        self.actor = R_Actor(self.mc, self.obs_shape, num_actions, gen).to(self.device)
        self.critic = R_Critic(self.mc, self.share_obs_shape, gen).to(self.device)
        self.actor_opt = torch.optim.Adam(self.actor.parameters(), lr=cfg.lr,
                                          eps=cfg.opti_eps)
        self.critic_opt = torch.optim.Adam(self.critic.parameters(), lr=cfg.critic_lr,
                                           eps=cfg.opti_eps)

    def get_actions(self, share_obs, obs, available_actions=None, deterministic: bool = False,
                    generator: Optional[torch.Generator] = None,
                    actions: Optional[torch.Tensor] = None):
        """All inputs flat ``[B, ...]``.  ``actions``, when given, replaces
        the sampled ones (tests drive both packages with the same actions).
        Returns (values, actions, log_probs)."""
        logits = self.actor(obs, available_actions)
        if actions is None:
            actions = (torch.argmax(logits, -1).to(torch.int32) if deterministic
                       else dist_sample(generator, logits))
        logp = dist_log_prob(logits, actions)
        return self.critic(share_obs), actions, logp

    def get_values(self, share_obs):
        return self.critic(share_obs)

    def evaluate_actions(self, share_obs, obs, actions, available_actions=None,
                         active_masks=None):
        """Returns (values, log_probs, entropy), the entropy a scalar (its
        mean over the active samples where ``use_policy_active_masks``)."""
        logits = self.actor(obs, available_actions)
        values = self.critic(share_obs)
        logp = dist_log_prob(logits, actions)
        ent = dist_entropy(logits)
        if self.cfg.use_policy_active_masks and active_masks is not None:
            entropy = (ent * active_masks).sum() / active_masks.sum()
        else:
            entropy = ent.mean()
        return values, logp, entropy

    def lr_for(self, episode: int, episodes: int) -> Tuple[float, float]:
        """Linear decay (reference ``utils/util.py::update_linear_schedule``)."""
        if not self.cfg.use_linear_lr_decay:
            return self.cfg.lr, self.cfg.critic_lr
        frac = 1.0 - episode / float(episodes)
        return self.cfg.lr * frac, self.cfg.critic_lr * frac

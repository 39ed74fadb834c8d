"""MAPPO policy: an actor and a critic, each with its own optimizer.

Counterpart of ``madrona_rl_envs_playground_tpu/train/mappo/policy.py``
(reference ``R_MAPPOPolicy``, ``train/MAPPO/rMAPPOPolicy.py``):
``get_actions``, ``get_values``, ``evaluate_actions`` with JAX's arguments
(the rnn states and masks, which only a recurrent net reads, and the new
states returned), two optimizers (lr and critic_lr, eps ``opti_eps``): Adam,
or AdamW where ``weight_decay`` is set (optax's ``adamw``: every parameter
decays, scaled by the learning rate), each behind optax's global-norm clip
(``train/optim.py``, applied by the trainer before the step; on the card
with their state and learning rate there, as optax's
``inject_hyperparams``), and the linear learning-rate decay.  The JAX
policy keeps its state in a pytree; here the modules and optimizers hold
it.  Sampling goes through ``models/common.dist_sample`` with an explicit
``torch.Generator``.  On a mesh the entropy is the mean over the whole
batch (``evaluate_actions``'s ``mesh``) and ``get_actions`` takes this
rank's rows of the noise drawn for the whole batch (``rows``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...device import DeviceLike, resolve_device
from ...models.common import dist_entropy, dist_log_prob, dist_sample
from ...models.mappo_nets import R_Actor, R_Critic
from ..optim import GlobalMean, adam
from .config import MAPPOConfig


class MAPPOPolicy:
    def __init__(self, cfg: MAPPOConfig, obs_shape, share_obs_shape, num_actions: int,
                 seed: int = 0, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.mc = cfg.model_config()
        self.recurrent = self.mc.use_recurrent_policy
        self.num_actions = num_actions
        self.obs_shape = tuple(obs_shape)
        self.share_obs_shape = tuple(share_obs_shape)
        gen = torch.Generator().manual_seed(seed)
        self.actor = R_Actor(self.mc, self.obs_shape, num_actions, gen).to(self.device)
        self.critic = R_Critic(self.mc, self.share_obs_shape, gen).to(self.device)
        self.actor_opt = self._optimizer(self.actor, cfg.lr)
        self.critic_opt = self._optimizer(self.critic, cfg.critic_lr)

    def _optimizer(self, net, lr):
        return adam(net.parameters(), lr, eps=self.cfg.opti_eps,
                    weight_decay=self.cfg.weight_decay)

    def get_actions(self, share_obs, obs, rnn_states, rnn_states_critic, masks,
                    available_actions=None, deterministic: bool = False,
                    generator: Optional[torch.Generator] = None,
                    actions: Optional[torch.Tensor] = None,
                    rows: Optional[Tuple[int, int]] = None):
        """All inputs flat ``[B, ...]``, rnn states ``[B, L, H]``, masks
        ``[B]``.  ``actions``, when given, replaces the sampled ones (tests
        drive both packages with the same actions).  ``rows`` is
        ``dist_sample``'s.  Returns (values, actions, log_probs,
        rnn_states', rnn_states_critic')."""
        logits, rnn2 = self.actor(obs, rnn_states, masks, available_actions)
        if actions is None:
            actions = (torch.argmax(logits, -1).to(torch.int32) if deterministic
                       else dist_sample(generator, logits, rows))
        logp = dist_log_prob(logits, actions)
        values, rnnc2 = self.critic(share_obs, rnn_states_critic, masks)
        return values, actions, logp, rnn2, rnnc2

    def get_values(self, share_obs, rnn_states_critic, masks):
        return self.critic(share_obs, rnn_states_critic, masks)[0]

    def evaluate_actions(self, share_obs, obs, rnn_states, rnn_states_critic, actions, masks,
                         available_actions=None, active_masks=None, sequence: bool = False,
                         mesh=None):
        """Returns (values, log_probs, entropy), the entropy a scalar (its
        mean over the active samples where ``use_policy_active_masks``; on
        a ``mesh``, this rank's share of the mean over the whole batch).
        With ``sequence=True`` the inputs are ``[L, B, ...]``, the rnn states
        ``[B, L_rnn, H]`` at each sequence's first step, and the GRU is
        unrolled."""
        if sequence:
            logits, _ = self.actor.unroll(obs, rnn_states, masks, available_actions)
            values, _ = self.critic.unroll(share_obs, rnn_states_critic, masks)
        else:
            logits, _ = self.actor(obs, rnn_states, masks, available_actions)
            values, _ = self.critic(share_obs, rnn_states_critic, masks)
        logp = dist_log_prob(logits, actions)
        ent = dist_entropy(logits)
        if self.cfg.use_policy_active_masks and active_masks is not None:
            entropy = GlobalMean(mesh, weights=active_masks)(ent)
        else:
            entropy = GlobalMean(mesh, like=ent)(ent)
        return values, logp, entropy

    def lr_for(self, episode: int, episodes: int) -> Tuple[float, float]:
        """Linear decay (reference ``utils/util.py::update_linear_schedule``)."""
        if not self.cfg.use_linear_lr_decay:
            return self.cfg.lr, self.cfg.critic_lr
        frac = 1.0 - episode / float(episodes)
        return self.cfg.lr * frac, self.cfg.critic_lr * frac

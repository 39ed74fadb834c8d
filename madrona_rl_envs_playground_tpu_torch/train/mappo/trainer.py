"""The R_MAPPO update.

Counterpart of ``RMAPPOTrainer`` in
``madrona_rl_envs_playground_tpu/train/mappo/trainer.py`` (reference
``R_MAPPO``, ``train/MAPPO/r_mappo.py``):

* advantages are the returns minus the denormalized value predictions,
  normalized over the active steps (population variance, as the reference's
  ``np.nanstd``);
* ``ppo_epoch`` x ``num_mini_batch`` updates on random permutations of the
  flat batch; with one minibatch the whole ``[T, M]`` batch, unshuffled
  (every reduction is order-free, so the reference's shuffle changes
  nothing there); with ``shard_local_minibatch``, minibatches of permuted
  timestep bands ``[T / num_mini_batch, M, ...]`` from one permutation of
  T a epoch, which never cut across the env axis;
* recurrent (``_train_recurrent``, reference ``shared_buffer.py:393-502``):
  the ``[T, M]`` buffer cut into ``C = (T / L) * M`` chunks of ``L =
  data_chunk_length`` steps (``L = T`` for the naive form), chunk-major as
  JAX's (chunk ``c = m * T / L + k``), each starting from the hidden state
  stored at its first step; each epoch permutes the chunks and every
  minibatch unrolls the GRU over its ``[L, chunks]`` sequences;
* the actor loss: the clipped surrogate weighted by the active masks, minus
  the entropy bonus; the critic loss: value clipping and a Huber loss
  against the value-normalized returns, the ValueNorm or PopArt statistics
  updated minibatch by minibatch *before* the normalization, as the
  reference's ``cal_value_loss``; each network behind its own global-norm
  clip and Adam.

On the card, where the runner's collector steps a kernel and there is no
mesh (``captured``; ``train/graphs.py``), ``train``'s epochs are captured
as one CUDA graph on the first call and replayed from then on, the
counterpart of JAX's jitted ``train``: the buffer is copied into the
graph's inputs, the minibatch permutations are drawn inside it from the
trainer's generator (registered with the graph), and it reads and writes
state that lives as long as the trainer: the nets' parameters and
gradients (zeroed in place), both optimizers' state and learning rates
(``train/optim.py``'s ``adam``; ``_set_lrs`` fills the rates in place, so
the linear decay reaches every replay) and the ValueNorm statistics
(``vn_copy_``).

On a mesh (``parallel/mesh.py``; the buffer holds this rank's streams) the
advantage normalisation, the ValueNorm moments, every loss and the metrics
are over the whole batch (``train/optim.py``'s ``GlobalMean``), and the
gradients of both networks are summed over the ranks before their clips.
The env axis stays local with one minibatch and with timestep bands; other
minibatches draw from the whole batch, so there the buffers are gathered
and every rank runs the same update on all of it, as JAX's all-gather does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from ...models.mappo_nets import get_critic_head
from ..graphs import LoopGraph
from ..optim import (GlobalMean, all_reduce_grads, all_sum, clip_grad_global_norm_, set_lr,
                     update_tensors)
from .buffer import MAPPOBuffer
from .config import MAPPOConfig
from .policy import MAPPOPolicy
from .valuenorm import (ValueNormState, init_valuenorm, popart_update, vn_copy_,
                        vn_denormalize, vn_normalize, vn_update)


def huber(e: torch.Tensor, delta: float) -> torch.Tensor:
    a = torch.abs(e)
    return torch.where(a > delta, delta * (a - 0.5 * delta), 0.5 * e ** 2)


class RMAPPOTrainer:
    """``captured``: replay ``train`` from a CUDA graph (the runner decides:
    a kernel collector on the card; never on a mesh, whose gradient
    all-reduce is a gloo call)."""

    def __init__(self, cfg: MAPPOConfig, policy: MAPPOPolicy, mesh=None, captured: bool = False):
        if cfg.use_popart and cfg.use_valuenorm:
            raise ValueError("use_popart and use_valuenorm are exclusive")
        if captured and mesh is not None:
            raise ValueError("a trainer on a mesh updates eagerly")
        self.cfg = cfg
        self.policy = policy
        self.mesh = mesh
        self.recurrent = cfg.use_recurrent_policy or cfg.use_naive_recurrent_policy
        # the statistics live as long as the trainer: updated in place
        self.vn: ValueNormState = init_valuenorm(policy.device)
        self.generator = torch.Generator(device=policy.device).manual_seed(cfg.seed)
        self._train_graph = (LoopGraph(self._train_body, [self.generator], owner=self,
                                       name="train")
                             if captured else None)

    @property
    def captured(self) -> bool:
        return self._train_graph is not None

    def update_state(self):
        """The tensors ``train`` writes in place, in a fixed order: both
        nets' parameters and gradients, both optimizers' state and learning
        rates (``train/optim.py``'s ``update_tensors``) and the ValueNorm
        statistics; a captured ``train`` reads and writes these very
        tensors."""
        pol = self.policy
        return (update_tensors([pol.actor, pol.critic], [pol.actor_opt, pol.critic_opt])
                + [getattr(self.vn, f.name) for f in dataclasses.fields(self.vn)])

    @property
    def _update_mesh(self):
        """The mesh an update's means and gradient sums run over: None where
        the minibatches draw from the whole batch (more than one, and not
        timestep bands), so that ``train`` gathers the buffers and every
        rank runs the same update on all of it."""
        bands = self.cfg.shard_local_minibatch and not self.recurrent
        return self.mesh if self.cfg.num_mini_batch == 1 or bands else None

    def _normalized(self) -> bool:
        return self.cfg.use_popart or self.cfg.use_valuenorm

    def _value_loss(self, vn, values, value_preds_b, return_b, active_b,
                    stats_updated: bool = False):
        cfg, mesh = self.cfg, self._update_mesh
        clipped = value_preds_b + torch.clamp(values - value_preds_b, -cfg.clip_param,
                                              cfg.clip_param)
        if self._normalized():
            if not stats_updated:
                vn = vn_update(vn, return_b, mesh=mesh)
            target = vn_normalize(vn, return_b)
        else:
            target = return_b
        err_clip, err_orig = target - clipped, target - values
        if cfg.use_huber_loss:
            l_clip, l_orig = huber(err_clip, cfg.huber_delta), huber(err_orig, cfg.huber_delta)
        else:
            l_clip, l_orig = 0.5 * err_clip ** 2, 0.5 * err_orig ** 2
        loss = torch.maximum(l_orig, l_clip) if cfg.use_clipped_value_loss else l_orig
        if cfg.use_value_active_masks:
            vl = GlobalMean(mesh, weights=active_b)(loss)
        else:
            vl = GlobalMean(mesh, like=loss)(loss)
        return vl, vn

    def _ppo_update(self, sample: Sequence[Optional[torch.Tensor]], sequence: bool = False):
        """One minibatch, JAX's sample tuple (share_obs, obs, rnn_states,
        rnn_states_critic, actions, value_preds, returns, masks,
        active_masks, old log-probs, advantages, available_actions; the rnn
        states and masks None for a feed-forward policy): PopArt's head
        update where enabled, then one optimizer step of the actor and one of
        the critic.  ``sequence``: the fields are ``[L, B, ...]`` and the
        rnn states those of each sequence's first step.  Returns (value
        loss, policy loss, entropy, mean ratio), detached (on a mesh, this
        rank's shares)."""
        cfg, pol, mesh = self.cfg, self.policy, self._update_mesh
        (sobs, obs, rnn, rnnc, act, vp, ret, msk, amsk, old_logp, adv, avail) = sample
        stats_updated = False
        if cfg.use_popart:
            # refresh the statistics on this minibatch's returns and rescale
            # the value head so that its outputs are preserved
            head = get_critic_head(pol.critic)
            with torch.no_grad():
                k2, b2, vn = popart_update(head.weight[0], head.bias[0], self.vn, ret, mesh=mesh)
                head.weight[0] = k2
                head.bias[0] = b2
                vn_copy_(self.vn, vn)
            stats_updated = True

        values, logp, entropy = pol.evaluate_actions(sobs, obs, rnn, rnnc, act, msk, avail, amsk,
                                                     sequence=sequence, mesh=mesh)
        ratio = torch.exp(logp - old_logp)
        surr1 = ratio * adv
        surr2 = torch.clamp(ratio, 1 - cfg.clip_param, 1 + cfg.clip_param) * adv
        per = -torch.minimum(surr1, surr2)
        pg_loss = GlobalMean(mesh, **({"weights": amsk} if cfg.use_policy_active_masks
                                      else {"like": per}))(per)
        v_loss, vn = self._value_loss(self.vn, values, vp, ret, amsk, stats_updated)

        # in place: a captured step reads the gradients the first backward made
        pol.actor_opt.zero_grad(set_to_none=False)
        pol.critic_opt.zero_grad(set_to_none=False)
        (pg_loss - entropy * cfg.entropy_coef).backward()
        (v_loss * cfg.value_loss_coef).backward()
        all_reduce_grads(mesh, list(pol.actor.parameters()) + list(pol.critic.parameters()))
        if cfg.use_max_grad_norm:
            clip_grad_global_norm_(pol.actor.parameters(), cfg.max_grad_norm)
            clip_grad_global_norm_(pol.critic.parameters(), cfg.max_grad_norm)
        pol.actor_opt.step()
        pol.critic_opt.step()
        if vn is not self.vn:
            vn_copy_(self.vn, vn)
        return torch.stack([v_loss.detach(), pg_loss.detach(), entropy.detach(),
                            GlobalMean(mesh, like=ratio)(ratio).detach()])

    def _advantages(self, buf: MAPPOBuffer) -> torch.Tensor:
        """Returns minus the denormalized predictions, normalized over the
        active steps (population variance, the reference's ``np.nanstd``),
        of the whole batch on a mesh."""
        mesh = self._update_mesh
        with torch.no_grad():
            vp = buf.value_preds[:-1]
            adv_raw = buf.returns[:-1] - (vn_denormalize(self.vn, vp) if self._normalized()
                                          else vp)
            active = buf.active_masks[:-1] > 0
            n_act = torch.clamp(all_sum(mesh, active.sum(), "count"), min=1)
            zero = torch.zeros_like(adv_raw)
            mean_adv = all_sum(mesh, torch.where(active, adv_raw, zero).sum(),
                               "advantage") / n_act
            var_adv = all_sum(mesh, torch.where(active, (adv_raw - mean_adv) ** 2, zero).sum(),
                              "advantage") / n_act
            return (adv_raw - mean_adv) / (torch.sqrt(var_adv) + 1e-5)

    def _set_lrs(self, lrs: Optional[Tuple[float, float]]) -> None:
        """JAX's ``tree_set`` of both learning rates: on the card filled into
        the optimizers' rate tensors, which a captured ``train`` reads."""
        cfg, pol = self.cfg, self.policy
        actor_lr, critic_lr = lrs if lrs is not None else (cfg.lr, cfg.critic_lr)
        set_lr(pol.actor_opt, actor_lr)
        set_lr(pol.critic_opt, critic_lr)

    def _perm(self, epoch: int, n: int, perms) -> torch.Tensor:
        dev = self.policy.device
        return (perms[epoch].to(dev) if perms is not None
                else torch.randperm(n, generator=self.generator, device=dev))

    def train(self, buf: MAPPOBuffer, lrs: Optional[Tuple[float, float]] = None,
              perms: Optional[Sequence[torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """``ppo_epoch`` passes over ``buf``; ``lrs`` = (actor, critic)
        learning rates (default the config's).  Feed-forward, with
        ``num_mini_batch > 1`` each epoch draws a permutation of the ``T *
        M`` samples (with ``shard_local_minibatch``, of the T timesteps)
        from the trainer's generator, or takes ``perms[epoch]`` where given
        (tests replay JAX's order); recurrent, a permutation of the chunks
        (``_train_recurrent``).  Returns the mean losses, entropy and ratio
        (on a mesh, of the whole batch, on every rank).  A captured trainer
        replays its graph unless ``perms`` are given; its info is the
        graph's, which the next replay overwrites."""
        self._set_lrs(lrs)
        cfg, nmb = self.cfg, self.cfg.num_mini_batch
        T = buf.rewards.shape[0]
        local = cfg.shard_local_minibatch and nmb > 1 and not self.recurrent
        if local and T % nmb:
            raise ValueError(f"shard_local_minibatch needs episode_length ({T}) % "
                             f"num_mini_batch ({nmb}) == 0")
        if self.mesh is not None and self._update_mesh is None:
            buf = MAPPOBuffer(**{f.name: self.mesh.all_gather(getattr(buf, f.name), dim=1,
                                                              what="buffers")
                                 for f in dataclasses.fields(buf)})
        if self.captured and perms is None:
            return self._train_graph(buf)
        return self._train_body(buf, perms)

    def _train_body(self, buf: MAPPOBuffer, perms: Optional[Sequence[torch.Tensor]] = None):
        """The epochs over ``buf``: the loop that the CPU runs and the card
        captures."""
        if self.recurrent:
            return self._train_recurrent(buf, perms)
        cfg, nmb = self.cfg, self.cfg.num_mini_batch
        local = cfg.shard_local_minibatch and nmb > 1
        T, M = buf.rewards.shape
        advantages = self._advantages(buf)
        B = T * M
        flat = ((lambda x: x) if nmb == 1 or local
                else (lambda x: x.reshape((B,) + x.shape[2:])))
        data = tuple(None if x is None else flat(x) for x in (
            buf.share_obs[:-1], buf.obs[:-1], None, None, buf.actions, buf.value_preds[:-1],
            buf.returns[:-1], None, buf.active_masks[:-1], buf.action_log_probs, advantages,
            buf.available_actions[:-1]))

        epochs = []
        for epoch in range(cfg.ppo_epoch):
            if nmb == 1:
                epochs.append(self._ppo_update(data))
                continue
            if local:  # permuted timestep bands [T / nmb, M, ...]
                idxs = self._perm(epoch, T, perms).reshape(nmb, T // nmb)
            else:
                mb = B // nmb
                idxs = self._perm(epoch, B, perms)[: nmb * mb].reshape(nmb, mb)
            epochs.append(torch.stack([
                self._ppo_update(tuple(None if d is None else d[idx] for d in data))
                for idx in idxs]).mean(0))
        return self._info(epochs)

    def _train_recurrent(self, buf: MAPPOBuffer,
                         perms: Optional[Sequence[torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """The recurrent update (JAX ``trainer.py:258-337``).  Each epoch
        permutes the ``C`` chunks (``perms[epoch]`` where given) and cuts
        them into ``num_mini_batch`` minibatches; the chunks are held
        sequence-major, ``[L, C, ...]``, so a minibatch is one gather along
        the chunk axis."""
        cfg = self.cfg
        T, M = buf.rewards.shape
        L = cfg.data_chunk_length if cfg.use_recurrent_policy else T
        if T % L:
            raise ValueError(f"episode_length ({T}) must be a multiple of data_chunk_length "
                             f"({L})")
        K = T // L
        C = K * M
        advantages = self._advantages(buf)

        def chunk(x):
            # [T, M, ...] -> [L, C, ...], chunk c = m * K + k
            y = x.reshape((K, L, M) + tuple(x.shape[2:])).transpose(0, 2)  # [M, L, K, ...]
            return y.transpose(0, 1).reshape((L, C) + tuple(x.shape[2:]))

        def chunk_start(x):
            # the state at each chunk's first step: [T, M, Lr, H] -> [C, Lr, H]
            return x[::L].transpose(0, 1).reshape((C,) + tuple(x.shape[2:]))

        data = (chunk(buf.share_obs[:-1]), chunk(buf.obs[:-1]),
                chunk_start(buf.rnn_states[:-1]), chunk_start(buf.rnn_states_critic[:-1]),
                chunk(buf.actions), chunk(buf.value_preds[:-1]), chunk(buf.returns[:-1]),
                chunk(buf.masks[:-1]), chunk(buf.active_masks[:-1]),
                chunk(buf.action_log_probs), chunk(advantages),
                chunk(buf.available_actions[:-1]))
        starts = (2, 3)  # the chunk-start states, [C, ...]: gathered on their first axis

        nmb = cfg.num_mini_batch
        mb = C // nmb
        epochs = []
        for epoch in range(cfg.ppo_epoch):
            idxs = self._perm(epoch, C, perms)[: nmb * mb].reshape(nmb, mb)
            epochs.append(torch.stack([
                self._ppo_update(tuple(d[idx] if i in starts else d[:, idx]
                                       for i, d in enumerate(data)), sequence=True)
                for idx in idxs]).mean(0))
        return self._info(epochs)

    def _info(self, epochs) -> Dict[str, torch.Tensor]:
        m = all_sum(self._update_mesh, torch.stack(epochs).mean(0), "metrics")
        return {"value_loss": m[0], "policy_loss": m[1], "dist_entropy": m[2], "ratio": m[3]}

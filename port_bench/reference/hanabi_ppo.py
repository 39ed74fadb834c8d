"""Plain masked self-play PPO on Hanabi: the benchmark's reference for the
self-play trainer on a turn-based game.

One policy (separate actor and critic towers, ReLU, a categorical head over
the legal moves) acts for every seat of every world; the actor reads the
seat's observation, the critic its state tensor (the observation and the
seat's own hand).  Every (world, seat) stream records a slot every step,
active or not.  An update is a rollout of ``num_steps`` steps, the reward
credit, the active-masked GAE with its advantages normalised over the
trainable slots, then ``update_epochs`` passes of the clipped PPO loss with
the clipped value loss, a global-norm gradient clip and Adam, every mean
over the trainable slots.  Written out from the rules of the reference
repository's ``pantheonrl_extension/vectoragent.py`` (197-262: the credit
and the GAE; 279-327: the update), with plain tensor operations and
autograd; it imports nothing of the program.  The towers, the weights, the
observation hash and the loss's size come from ``reference/ppo.py``.

* **Credit** (``credit``): the reward of step t goes to the stream's last
  active slot at or before t; a reward that arrives after the stream's
  episode has ended and before its first move in the next is dropped, as
  is one that arrives before its first active slot of the rollout.
* **GAE** (``masked_gae``), scanning back from the end: an active slot
  bootstraps from the stream's next active slot (the final value where the
  stream is active after the rollout), its non-terminal factor the done
  delivered just before that slot (the done recorded with it).  While some
  stream of the batch has not yet been active in the scan, only a stream's
  first active slot from the end is computed, and it is not trained; the
  stream's other active slots are trained with an advantage of zero (the
  reference's bootstrapping quirk).  Once every stream has been active,
  every active slot is computed and trained.
* **Masks**: the logits of illegal moves are replaced by -1e9.

``PlainHanabiSelfPlay`` runs the same updates in two roles, as
``reference/ppo.py``'s ``PlainSelfPlay``: the judge, following the
program's actions, and the control, in the program's place.  Precisions:
``float32`` (what the configuration states; TF32 off) and ``tf32`` (the
control: the towers' products in TF32).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from . import hanabi as ref_env
from .ppo import BETA1, BETA2, obs_hash, tower

MASKED_LOGIT = -1e9


def credit(rewards: torch.Tensor, active: torch.Tensor, dones: torch.Tensor) -> torch.Tensor:
    """[T, M] rewards credited to the slot of the move that earned them;
    ``dones[t]`` is the stream's episode end at step t."""
    T, M = rewards.shape
    dev = rewards.device
    out = torch.zeros((T + 1, M), dtype=rewards.dtype, device=dev)  # row T: dropped
    last = torch.full((M,), T, dtype=torch.long, device=dev)  # no active slot yet
    ended = torch.zeros(M, dtype=torch.bool, device=dev)  # the episode ended, no move since
    cols = torch.arange(M, device=dev)
    for t in range(T):
        last = torch.where(active[t], t, last)
        ended = ended & ~active[t]
        out[last, cols] += torch.where(ended, torch.zeros_like(rewards[t]), rewards[t])
        ended = ended | dones[t]
    return out[:T]


def masked_gae(rewards, slot_dones, values, active, next_value, next_done, final_active,
               gamma, lam):
    """The active-masked GAE over [T, M].  Returns (advantages, returns,
    trainable [T, M] bool)."""
    T = values.shape[0]
    booted = final_active.clone()
    nonterminal = torch.where(final_active, 1.0 - next_done.float(), 0.0)
    next_values = torch.where(final_active, next_value, 0.0)
    last = torch.zeros_like(next_value)
    adv = torch.zeros_like(values)
    trainable = torch.zeros_like(active)
    for t in range(T - 1, -1, -1):
        act = active[t]
        if bool(booted.all()):
            compute = act
            trainable[t] = act
        else:
            compute = act & ~booted
            trainable[t] = act & booted
        booted = booted | act
        cand = (rewards[t] + gamma * next_values * nonterminal - values[t]
                + gamma * lam * nonterminal * last)
        last = torch.where(compute, cand, last)
        adv[t] = torch.where(compute, cand, 0.0)
        nonterminal = torch.where(act, 1.0 - slot_dones[t].float(), nonterminal)
        next_values = torch.where(act, values[t], next_values)
    return adv, adv + values, trainable


class PlainHanabiSelfPlay:
    """The recipe's updates on ``num_envs`` worlds of the plain game from
    episodes 0..N-1, with the weights ``params`` and the sampler's noise
    drawn from a generator seeded with ``seed`` on ``device``: each step one
    ``torch.rand((rows, moves))`` and the Gumbel-max rule over the masked
    logits.

    ``fault`` plants one fault where it is produced: ``"half_batch"`` (the
    losses are means over the first half of the rows), ``"action"`` (world
    0's first seat's action each step moved to the next move), ``"frozen"``
    (the update leaves the parameters and Adam unchanged), ``"no_credit"``
    (each step's reward stays at its own slot: the credit left out)."""

    def __init__(self, config: dict, num_envs: int, params: Dict[str, torch.Tensor], seed: int,
                 device, precision: Optional[str] = None, fault: Optional[str] = None):
        self.rc = config["recipe"]
        if self.rc["num_minibatches"] != 1 or self.rc["value_loss"] != "clipped_mse":
            raise ValueError("the plain masked self-play takes one minibatch an epoch and the "
                             "clipped MSE value loss")
        self.env = ref_env.make_env(config)
        self.N, self.P = num_envs, self.env.P
        self.M = self.N * self.P
        self.dev = torch.device(device)
        self.precision = precision or config["precision"]["towers"]
        self.fault = fault
        self.layers = self.rc["num_layers"] + 1
        self.params = {k: v.detach().clone().float() for k, v in params.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.t = 0
        self.grad_norms = []  # each epoch's global gradient norm before the clip
        self.noise = torch.Generator(device=self.dev).manual_seed(seed)
        (self.state, self.counter, self.obs, self.sobs, self.mask,
         self.active) = ref_env.reset(self.env, self.N, self.dev)
        self.done = torch.zeros(self.N, dtype=torch.bool, device=self.dev)

    def logits(self, params, obs, mask):
        x = tower(params, "actor", obs, self.layers, "float32")
        return torch.where(mask, x, torch.full_like(x, MASKED_LOGIT))

    def value(self, params, sobs):
        return tower(params, "critic", sobs, self.layers, "float32")[..., 0]

    def update(self, actions: Optional[torch.Tensor] = None) -> Dict:
        """One update.  ``actions`` ([T, M] int, the program's), when given,
        are stepped instead of sampled, and each is read against this
        side's noisy masked logits.  Returns the update's record: the step
        buffers (``obs_hash``, ``state_hash``, ``mask``, ``active``,
        ``action``, ``reward``, ``done``), the last epoch's losses,
        ``action_gap`` (the widest gap, over the steps, by which a given
        action's noisy logit lies below the best legal one) and the
        rollout's values ([T, M])."""
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.precision == "tf32"
        try:
            return self._update(actions)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev

    def _update(self, actions):
        rc, env, N, P, M = self.rc, self.env, self.N, self.P, self.M
        T, dev = rc["num_steps"], self.dev
        keys = ("obs_hash", "state_hash", "mask", "active", "action", "reward", "done")
        rec = {k: [] for k in keys}
        obs_buf, sobs_buf, logp_buf, val_buf = [], [], [], []
        gap = torch.zeros((), device=dev)
        with torch.no_grad():
            for t in range(T):
                obs, sobs = self.obs.reshape(M, -1), self.sobs.reshape(M, -1)
                mask, active = self.mask.reshape(M, -1), self.active.reshape(M)
                logits = self.logits(self.params, obs, mask)
                value = self.value(self.params, sobs)
                u = torch.rand((M, logits.shape[1]), generator=self.noise, device=dev)
                score = logits - torch.log(-torch.log(u))
                if actions is None:
                    a = torch.argmax(score, -1)
                    if self.fault == "action":
                        a[0] = (a[0] + 1) % env.num_actions
                else:
                    a = actions[t].to(device=dev, dtype=torch.int64)
                    best = torch.where(mask, score, float("-inf")).max(-1).values
                    gap = torch.maximum(gap, (best - score.gather(1, a[:, None])[:, 0]).max())
                logp = F.log_softmax(logits, -1).gather(1, a[:, None])[:, 0]
                (self.state, self.counter, obs2, sobs2, mask2, active2, rew,
                 done) = ref_env.step(env, self.state, self.counter, a.reshape(N, P))
                rec["obs_hash"].append(obs_hash(obs))
                rec["state_hash"].append(obs_hash(sobs))
                rec["mask"].append(mask)
                rec["active"].append(active)
                rec["action"].append(a.to(torch.int32))
                rec["reward"].append(rew.reshape(M))
                rec["done"].append(done[:, None].expand(N, P).reshape(M))
                obs_buf.append(obs)
                sobs_buf.append(sobs)
                logp_buf.append(logp)
                val_buf.append(value)
                self.obs, self.sobs, self.mask, self.active = obs2, sobs2, mask2, active2
                self.done = done
            raw = torch.stack(rec["reward"])
            act = torch.stack(rec["active"])
            done_b = torch.stack(rec["done"])
            rewards = raw if self.fault == "no_credit" else credit(raw, act, done_b)
            slot_dones = torch.cat([torch.zeros_like(done_b[:1]), done_b[:-1]])
            values = torch.stack(val_buf)
            next_value = self.value(self.params, self.sobs.reshape(M, -1))
            next_done = self.done[:, None].expand(N, P).reshape(M)
            adv, returns, trainable = masked_gae(
                rewards, slot_dones, values, act, next_value, next_done,
                self.active.reshape(M), rc["gamma"], rc["gae_lambda"])
            w = trainable.float()
            n = w.sum().clamp(min=1.0)
            mean = (adv * w).sum() / n
            std = torch.sqrt(((adv - mean) ** 2 * w).sum() / n * n / (n - 1.0).clamp(min=1.0))
            adv = (adv - mean) / (std + 1e-8)
        rows = T * M
        batch = dict(obs=torch.stack(obs_buf).reshape(rows, -1),
                     sobs=torch.stack(sobs_buf).reshape(rows, -1),
                     mask=torch.stack(rec["mask"]).reshape(rows, -1),
                     actions=torch.stack(rec["action"]).reshape(rows).long(),
                     logprobs=torch.stack(logp_buf).reshape(rows),
                     advantages=adv.reshape(rows), returns=returns.reshape(rows),
                     values=values.reshape(rows), weights=w.reshape(rows))
        losses = None
        for _ in range(rc["update_epochs"]):
            losses = self._epoch(batch)
        out = {k: torch.stack(v) for k, v in rec.items()}
        out.update(losses=losses, action_gap=float(gap), values=values, rewards=rewards,
                   advantages=adv, trainable=trainable)
        return out

    def _epoch(self, b):
        """One pass over the batch as one minibatch: the masked losses as
        means over the trainable slots, gradients, the global-norm clip,
        Adam.  Returns the losses (pg, v, entropy, kl)."""
        rc = self.rc
        if self.fault == "half_batch":
            half = b["obs"].shape[0] // 2
            b = {k: v[:half] for k, v in b.items()}
        params = {k: v.detach().requires_grad_(True) for k, v in self.params.items()}
        logits = self.logits(params, b["obs"], b["mask"])
        newvalue = self.value(params, b["sobs"])
        w = b["weights"]
        n = w.sum().clamp(min=1.0)

        def mean(x):
            return (x * w).sum() / n

        lp = F.log_softmax(logits, -1)
        newlogprob = lp.gather(1, b["actions"][:, None])[:, 0]
        entropy = -(lp.exp() * lp).sum(-1)
        logratio = newlogprob - b["logprobs"]
        ratio = torch.exp(logratio)
        adv, clip = b["advantages"], rc["clip_coef"]
        pg = mean(torch.maximum(-adv * ratio, -adv * torch.clamp(ratio, 1 - clip, 1 + clip)))
        ent = mean(entropy)
        clipped = b["values"] + torch.clamp(newvalue - b["values"], -clip, clip)
        vl = 0.5 * mean(torch.maximum((newvalue - b["returns"]) ** 2,
                                      (clipped - b["returns"]) ** 2))
        total = pg - rc["ent_coef"] * ent + vl * rc["vf_coef"]
        kl = mean((ratio - 1) - logratio)
        grads = torch.autograd.grad(total, [params[k] for k in self.params])
        if self.fault == "frozen":
            return torch.stack([pg, vl, ent, kl]).detach()
        with torch.no_grad():
            norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
            self.grad_norms.append(float(norm))
            scale = torch.where(norm < rc["max_grad_norm"], torch.ones_like(norm),
                                rc["max_grad_norm"] / norm)
            self.t += 1
            bc1, bc2 = 1 - BETA1 ** self.t, 1 - BETA2 ** self.t
            for k, g in zip(self.params, grads):
                g = g * scale
                self.m[k] = BETA1 * self.m[k] + (1 - BETA1) * g
                self.v[k] = BETA2 * self.v[k] + (1 - BETA2) * g * g
                step = (self.m[k] / bc1) / (torch.sqrt(self.v[k] / bc2) + rc["adam_eps"])
                self.params[k] = self.params[k] - rc["lr"] * step
        return torch.stack([pg, vl, ent, kl]).detach()

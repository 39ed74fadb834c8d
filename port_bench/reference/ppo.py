"""Plain self-play PPO: the benchmark's reference for the self-play trainer.

One policy (separate actor and critic towers, ReLU, a categorical head)
acts for every seat of every world; an update is a rollout of ``num_steps``
steps, GAE with its advantages normalised, then ``update_epochs`` passes of
the clipped PPO loss with the clipped value loss, a global-norm gradient
clip and Adam.  This is CleanRL's ``ppo.py`` update (separate towers, the
clipped MSE value loss), not the reference repository's
``centralized_agent.py`` (a shared trunk, a Huber value loss), written out
from the recipe in the configuration file with plain tensor operations and
autograd.  It imports nothing of the program.

``PlainSelfPlay`` runs the same updates in two roles:

* the judge: it follows the program's first updates, stepping the frozen
  env with the actions the program chose and working out everything else
  again (observations, rewards, logits, values, advantages, losses,
  gradients, Adam), and reads each action against its own sampling rule;
* the control: put in the program's place, it chooses its own actions,
  computed in a lower precision or with a fault planted.

Precisions: ``bfloat16`` computes the towers in bfloat16 from float32
parameters (what the flagship recipe states), ``float32`` in float32, and
``float8`` rounds the towers' inputs and weights to float8 e4m3 with one
scale a tensor (the control of a bfloat16 recipe).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from . import overcooked as ref_env

BETA1, BETA2 = 0.9, 0.999
FP8_MAX = 448.0  # the largest float8 e4m3 value


def towers(config: dict, env) -> Dict[str, List[int]]:
    """The widths of each tower, input first."""
    h, n = config["recipe"]["hidden"], config["recipe"]["num_layers"]
    return {"actor": [env.obs_size] + [h] * n + [env.num_actions],
            "critic": [env.state_size] + [h] * n + [1]}


def make_weights(widths: Dict[str, List[int]], seed: int, device) -> Dict[str, torch.Tensor]:
    """Float32 weights from ``seed``, made on ``device`` in one draw: each
    weight normal with standard deviation gain / sqrt(fan-in) (gain sqrt(2)
    on the hidden layers, 0.01 on the heads, the scales of the orthogonal
    init the recipe names), every bias zero.  Named as the program's
    parameters are (``actor.layers.0.weight``)."""
    shapes = []
    for tower, w in widths.items():
        for i in range(len(w) - 1):
            gain = 0.01 if i == len(w) - 2 else math.sqrt(2.0)
            shapes.append((f"{tower}.layers.{i}", (w[i + 1], w[i]), gain))
    total = sum(o * i for _, (o, i), _ in shapes)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, (o, i), gain in shapes:
        out[f"{name}.weight"] = (flat[at:at + o * i].reshape(o, i) * (gain / math.sqrt(i))).contiguous()
        out[f"{name}.bias"] = torch.zeros(o, dtype=torch.float32, device=device)
        at += o * i
    return out


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale (its largest magnitude
    maps to 448), returned in float32."""
    scale = x.detach().abs().amax().clamp(min=1e-12) / FP8_MAX
    q = (x / scale).to(torch.float8_e4m3fn).to(torch.float32)
    # straight-through: the rounding has no gradient of its own
    return x + (q * scale - x).detach()


def _linear(x, w, b, precision: str):
    if precision == "bfloat16":
        return F.linear(x.to(torch.bfloat16), w.to(torch.bfloat16), b.to(torch.bfloat16))
    if precision == "float8":
        return F.linear(_fp8(x.float()), _fp8(w), b)
    return F.linear(x.float(), w, b)


def tower(params, name: str, x: torch.Tensor, layers: int, precision: str) -> torch.Tensor:
    h = x
    for i in range(layers):
        h = _linear(h, params[f"{name}.layers.{i}.weight"], params[f"{name}.layers.{i}.bias"],
                    precision)
        if i < layers - 1:
            h = F.relu(h)
    return h.float()


def gae(rewards, slot_dones, values, next_value, next_done, gamma, lam):
    """GAE over [T, M]: ``slot_dones[t]`` is the done delivered before slot t."""
    nnt = 1.0 - torch.cat([slot_dones[1:].float(), next_done.float()[None]], 0)
    nv = torch.cat([values[1:], next_value[None]], 0)
    delta = rewards + gamma * nv * nnt - values
    adv = torch.empty_like(delta)
    last = torch.zeros_like(delta[0])
    for t in range(delta.shape[0] - 1, -1, -1):
        last = delta[t] + gamma * lam * nnt[t] * last
        adv[t] = last
    return adv, adv + values


def obs_hash(obs: torch.Tensor) -> torch.Tensor:
    """One int64 a row of int8 observations ``[..., D]``: the sum of each
    byte times a fixed odd weight of its position, so that any changed byte
    changes it."""
    d = obs.shape[-1]
    w = (torch.arange(d, dtype=torch.int64, device=obs.device) * 2654435761 + 97) % 1000003
    return (obs.to(torch.int64) * w).sum(-1)


class PlainSelfPlay:
    """The recipe's updates on ``num_envs`` worlds of the frozen env from
    fresh episodes, with the weights ``params`` and the sampler's noise drawn
    from a generator seeded with ``seed`` on ``device``: each step one
    ``torch.rand((rows, actions))`` and the Gumbel-max rule, the sampling
    rule the configuration states.

    ``fault`` plants one fault where it is produced, for the checks of the
    comparison: ``"half_batch"`` (the loss is the mean over the first half
    of the rows only), ``"action"`` (one world's action each step is moved
    to the next action), ``"frozen"`` (the update leaves the parameters
    and Adam unchanged)."""

    def __init__(self, config: dict, num_envs: int, params: Dict[str, torch.Tensor], seed: int,
                 device, precision: Optional[str] = None, fault: Optional[str] = None):
        self.rc = config["recipe"]
        self.env = ref_env.make_env(config)
        self.N, self.P = num_envs, self.env.num_players
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
        self.state = ref_env.init_state(self.env, self.N, self.dev)
        _, obs, _, _, _ = self.env.encode(self.state, torch.ones(self.N, dtype=torch.bool,
                                                                  device=self.dev))
        self.obs = obs
        self.done = torch.zeros(self.N, dtype=torch.bool, device=self.dev)

    def forward(self, params, obs):
        logits = tower(params, "actor", obs, self.layers, self.precision)
        value = tower(params, "critic", obs, self.layers, self.precision)[..., 0]
        return logits, value

    def update(self, actions: Optional[torch.Tensor] = None) -> Dict:
        """One update.  ``actions`` ([T, M] int, the program's), when given,
        are stepped instead of sampled, and each is read against this
        side's noisy logits.  Returns the update's record: the step
        buffers (``obs_hash``, ``action``, ``reward``, ``done``), the last
        epoch's losses, ``action_gap`` (the widest gap, over the steps, by
        which a given action's noisy logit lies below the best) and the
        rollout's values ([T, M])."""
        rc, env, N, P, M = self.rc, self.env, self.N, self.P, self.M
        T, dev = rc["num_steps"], self.dev
        rec = {k: [] for k in ("obs_hash", "action", "reward", "done")}
        obs_buf, logp_buf, val_buf, rew_buf = [], [], [], []
        gap = torch.zeros((), device=dev)
        with torch.no_grad():
            for t in range(T):
                obs = self.obs.reshape(M, -1)
                logits, value = self.forward(self.params, obs)
                u = torch.rand((M, logits.shape[1]), generator=self.noise, device=dev)
                score = logits.float() - torch.log(-torch.log(u))
                if actions is None:
                    a = torch.argmax(score, -1)
                    if self.fault == "action":
                        a[0] = (a[0] + 1) % env.num_actions
                else:
                    a = actions[t].to(device=dev, dtype=torch.int64)
                    gap = torch.maximum(gap, (score.max(-1).values
                                              - score.gather(1, a[:, None])[:, 0]).max())
                logp = F.log_softmax(logits.float(), -1).gather(1, a[:, None])[:, 0]
                self.state, obs2, rew, done = ref_env.step(env, self.state, a.reshape(N, P))
                rec["obs_hash"].append(obs_hash(obs))
                rec["action"].append(a.to(torch.int32))
                rec["reward"].append(rew.reshape(M).float())
                rec["done"].append(done[:, None].expand(N, P).reshape(M))
                obs_buf.append(obs)
                logp_buf.append(logp)
                val_buf.append(value)
                rew_buf.append(rew.reshape(M).float())
                self.obs, self.done = obs2, done
            rewards = torch.stack(rew_buf)
            done_b = torch.stack(rec["done"])
            slot_dones = torch.cat([torch.zeros_like(done_b[:1]), done_b[:-1]])
            values = torch.stack(val_buf)
            next_value = tower(self.params, "critic", self.obs.reshape(M, -1), self.layers,
                               self.precision)[..., 0]
            next_done = self.done[:, None].expand(N, P).reshape(M)
            adv, returns = gae(rewards, slot_dones, values, next_value, next_done,
                               rc["gamma"], rc["gae_lambda"])
            n = adv.numel()
            mean = adv.mean()
            std = torch.sqrt(((adv - mean) ** 2).mean() * n / max(n - 1, 1))
            adv = (adv - mean) / (std + 1e-8)
        batch = dict(obs=torch.stack(obs_buf).reshape(T * M, -1),
                     actions=torch.stack(rec["action"]).reshape(T * M).long(),
                     logprobs=torch.stack(logp_buf).reshape(T * M),
                     advantages=adv.reshape(T * M), returns=returns.reshape(T * M),
                     values=values.reshape(T * M))
        losses = None
        for _ in range(rc["update_epochs"]):
            losses = self._epoch(batch)
        out = {k: torch.stack(v) for k, v in rec.items()}
        out.update(losses=losses, action_gap=float(gap), values=values,
                   state=ref_env.pack(self.state))
        return out

    def _epoch(self, b):
        """One pass over the batch as one minibatch: loss, gradients, the
        global-norm clip, Adam.  Returns the losses (pg, v, entropy, kl)."""
        rc = self.rc
        if rc["num_minibatches"] != 1:
            raise ValueError("the reference takes one minibatch an epoch")
        if self.fault == "half_batch":
            half = b["obs"].shape[0] // 2
            b = {k: v[:half] for k, v in b.items()}
        params = {k: v.detach().requires_grad_(True) for k, v in self.params.items()}
        logits, newvalue = self.forward(params, b["obs"])
        lp = F.log_softmax(logits.float(), -1)
        newlogprob = lp.gather(1, b["actions"][:, None])[:, 0]
        entropy = -(lp.exp() * lp).sum(-1)
        logratio = newlogprob - b["logprobs"]
        ratio = torch.exp(logratio)
        adv, clip = b["advantages"], rc["clip_coef"]
        pg = torch.maximum(-adv * ratio, -adv * torch.clamp(ratio, 1 - clip, 1 + clip)).mean()
        ent = entropy.mean()
        clipped = b["values"] + torch.clamp(newvalue - b["values"], -clip, clip)
        vl = 0.5 * torch.maximum((newvalue - b["returns"]) ** 2,
                                 (clipped - b["returns"]) ** 2).mean()
        total = pg - rc["ent_coef"] * ent + vl * rc["vf_coef"]
        kl = ((ratio - 1) - logratio).mean()
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


def loss(rc: dict, losses: torch.Tensor, value: bool = True) -> Tuple[float, float]:
    """The loss the update minimises, pg - ent_coef * entropy + vf_coef * v
    (without its value term where ``value`` is False), and the size of its
    terms, |pg| + ent_coef |entropy| (+ vf_coef |v|)."""
    pg, v, ent, _ = [float(x) for x in losses]
    vf = rc["vf_coef"] if value else 0.0
    return (pg - rc["ent_coef"] * ent + vf * v,
            abs(pg) + rc["ent_coef"] * abs(ent) + vf * abs(v))

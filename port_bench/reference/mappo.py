"""Plain MAPPO: the benchmark's reference for the MAPPO runner.

The reference's R_MAPPO (``train/MAPPO/r_mappo.py``, ``rMAPPOPolicy.py``,
``utils/mlp.py``, ``utils/act.py``, ``utils/valuenorm.py``,
``utils/shared_buffer.py``) at the feed-forward recipe, written out from the
configuration file with plain tensor operations and autograd; it imports
nothing of the program.  One update:

* the collect: ``episode_length`` steps of every seat of every world,
  actor and critic each a feature LayerNorm, then (Linear, ReLU, LayerNorm)
  x (1 + layer_N), then a linear head (the actor's logits, the critic's
  value in ValueNorm's normalised units); the masks before each step, 0
  after a world's episode ended;
* the returns: GAE over the denormalised value predictions, the bootstrap
  value of the last observation;
* the advantages: returns minus the denormalised predictions, normalised
  over the active steps (population variance);
* ``ppo_epoch`` passes over the whole batch as one minibatch: the clipped
  surrogate and the entropy bonus, the clipped Huber value loss against the
  returns normalised by the ValueNorm statistics, which each pass first
  updates with the returns (debiased EMA, beta 0.99999, variance at least
  1e-2), each net's global-norm clip and its own Adam.

``PlainMAPPO`` plays the judge (following the program's actions) or the
control (choosing its own), as ``reference/ppo.py``'s ``PlainSelfPlay``.
The control of this float32 recipe computes the products in TF32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from . import overcooked as ref_env
from .ppo import BETA1, BETA2, obs_hash

LN_EPS = 1e-6  # the reference's flax LayerNorm epsilon, as the recipe states
VN_BETA = 0.99999


def widths(config: dict, env) -> Dict[str, List[int]]:
    """Each net's dense widths, input first (the LayerNorms aside)."""
    rc = config["recipe"]
    base = [env.obs_size] + [rc["hidden_size"]] * (1 + rc["layer_N"])
    return {"actor": base + [env.num_actions], "critic": base + [1]}


def make_weights(config: dict, env, seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """Float32 weights of both nets from ``seed``, made on ``device`` in one
    draw: each dense weight normal with standard deviation gain / sqrt(fan-in)
    (gain sqrt(2) in the bases, the recipe's ``gain`` on the actor head, 1 on
    the value head, the scales of its orthogonal init), biases 0, every
    LayerNorm's scale 1 and offset 0.  Named as the program's modules name
    their parameters (``base.layers.0.weight``, ``act.linear.weight``,
    ``v_out.weight``)."""
    rc, w = config["recipe"], widths(config, env)
    layers = []
    for net, head in (("actor", "act.linear"), ("critic", "v_out")):
        ws = w[net]
        for i in range(len(ws) - 2):
            layers.append((net, f"base.layers.{i}", ws[i], ws[i + 1], math.sqrt(2.0)))
        layers.append((net, head, ws[-2], ws[-1], rc["gain"] if net == "actor" else 1.0))
    total = sum(i * o for _, _, i, o, _ in layers)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out = {"actor": {}, "critic": {}}
    at = 0
    for net, name, i, o, gain in layers:
        out[net][f"{name}.weight"] = (flat[at:at + i * o].reshape(o, i)
                                      * (gain / math.sqrt(i))).contiguous()
        out[net][f"{name}.bias"] = torch.zeros(o, device=device)
        at += i * o
    for net in out:
        norms = [("base.feature_norm", w[net][0])] + [
            (f"base.norms.{i}", rc["hidden_size"]) for i in range(1 + rc["layer_N"])]
        for name, n in norms:
            out[net][f"{name}.weight"] = torch.ones(n, device=device)
            out[net][f"{name}.bias"] = torch.zeros(n, device=device)
    return out


def base(p: Dict[str, torch.Tensor], x: torch.Tensor, layers: int) -> torch.Tensor:
    x = F.layer_norm(x.float(), (x.shape[-1],), p["base.feature_norm.weight"],
                     p["base.feature_norm.bias"], LN_EPS)
    for i in range(layers):
        x = F.relu(F.linear(x, p[f"base.layers.{i}.weight"], p[f"base.layers.{i}.bias"]))
        x = F.layer_norm(x, (x.shape[-1],), p[f"base.norms.{i}.weight"],
                         p[f"base.norms.{i}.bias"], LN_EPS)
    return x


def huber(e: torch.Tensor, delta: float) -> torch.Tensor:
    a = torch.abs(e)
    return torch.where(a > delta, delta * (a - 0.5 * delta), 0.5 * e ** 2)


class ValueNorm:
    """The debiased running mean and mean square of the value targets."""

    def __init__(self, device):
        self.mean = torch.zeros((), device=device)
        self.mean_sq = torch.zeros((), device=device)
        self.debias = torch.zeros((), device=device)

    def moments(self):
        mean = self.mean / torch.clamp(self.debias, min=1e-5)
        mean_sq = self.mean_sq / torch.clamp(self.debias, min=1e-5)
        return mean, torch.clamp(mean_sq - mean ** 2, min=1e-2)

    def update(self, x: torch.Tensor) -> None:
        n = x.numel()
        self.mean = self.mean * VN_BETA + (x.sum() / n) * (1 - VN_BETA)
        self.mean_sq = self.mean_sq * VN_BETA + ((x ** 2).sum() / n) * (1 - VN_BETA)
        self.debias = self.debias * VN_BETA + (1 - VN_BETA)

    def normalize(self, x):
        mean, var = self.moments()
        return (x - mean) / torch.sqrt(var)

    def denormalize(self, x):
        mean, var = self.moments()
        return x * torch.sqrt(var) + mean


class PlainMAPPO:
    """The recipe's updates on ``num_envs`` worlds of the frozen env from
    fresh episodes, with the weights ``params`` and the sampler's noise from
    a generator seeded with ``seed`` on ``device`` (each step one
    ``torch.rand((rows, actions))``, Gumbel-max).  ``tf32`` computes the
    products in TF32 (the control).  ``fault``: ``"half_batch"`` (the losses
    are means over the first half of the steps), ``"action"`` (one world's
    action each step moved to the next), ``"frozen"`` (no parameter, Adam or
    ValueNorm step)."""

    # the recipe this reference writes out; any other is refused
    RECIPE = dict(use_ReLU=True, use_feature_normalization=True, use_recurrent_policy=False,
                  weight_decay=0.0, use_linear_lr_decay=False, use_max_grad_norm=True,
                  use_gae=True, use_proper_time_limits=False, use_huber_loss=True,
                  use_clipped_value_loss=True, use_popart=False, use_valuenorm=True,
                  use_value_active_masks=True, use_policy_active_masks=True)

    def __init__(self, config: dict, num_envs: int, params, seed: int, device,
                 tf32: bool = False, fault: Optional[str] = None):
        self.rc = config["recipe"]
        other = {k: self.rc.get(k) for k, v in self.RECIPE.items() if self.rc.get(k) != v}
        if other:
            raise ValueError(f"the plain MAPPO writes out {self.RECIPE}, not {other}")
        self.env = ref_env.make_env(config)
        self.N, self.A = num_envs, self.env.num_players
        self.B = self.N * self.A
        self.dev = torch.device(device)
        self.tf32 = tf32
        self.fault = fault
        self.layers = 1 + self.rc["layer_N"]
        self.params = {n: {k: v.detach().clone().float() for k, v in p.items()}
                       for n, p in params.items()}
        self.m = {n: {k: torch.zeros_like(v) for k, v in p.items()}
                  for n, p in self.params.items()}
        self.v = {n: {k: torch.zeros_like(v) for k, v in p.items()}
                  for n, p in self.params.items()}
        self.t = 0
        self.vn = ValueNorm(self.dev)
        self.noise = torch.Generator(device=self.dev).manual_seed(seed)
        self.state = ref_env.init_state(self.env, self.N, self.dev)
        _, self.obs, _, _, _ = self.env.encode(
            self.state, torch.ones(self.N, dtype=torch.bool, device=self.dev))
        self.masks = torch.ones(self.B, device=self.dev)

    def logits(self, p, obs):
        return F.linear(base(p, obs, self.layers), p["act.linear.weight"], p["act.linear.bias"])

    def value(self, p, obs):
        return F.linear(base(p, obs, self.layers), p["v_out.weight"], p["v_out.bias"])[..., 0]

    def update(self, actions: Optional[torch.Tensor] = None) -> Dict:
        """One update; ``actions`` ([T, B], the program's) as in
        ``PlainSelfPlay.update``.  Returns the step buffers, the mean losses
        over the epochs (value, policy, entropy, ratio), ``action_gap`` and
        the episode score the runner reports (seat 0's rewards summed, per
        world) and the collect's values ([T, B])."""
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        try:
            return self._update(actions)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev

    def _update(self, actions):
        rc, env, N, A, B = self.rc, self.env, self.N, self.A, self.B
        T, dev = rc["episode_length"], self.dev
        pa, pc = self.params["actor"], self.params["critic"]
        rec = {k: [] for k in ("obs_hash", "action", "reward", "done")}
        obs_buf, logp_buf, val_buf, mask_buf = [], [], [], []
        gap = torch.zeros((), device=dev)
        with torch.no_grad():
            for t in range(T):
                obs = self.obs.reshape(B, -1)
                logits = self.logits(pa, obs)
                value = self.value(pc, obs)
                u = torch.rand((B, logits.shape[1]), generator=self.noise, device=dev)
                score = logits - torch.log(-torch.log(u))
                if actions is None:
                    a = torch.argmax(score, -1)
                    if self.fault == "action":
                        a[0] = (a[0] + 1) % env.num_actions
                else:
                    a = actions[t].to(device=dev, dtype=torch.int64)
                    gap = torch.maximum(gap, (score.max(-1).values
                                              - score.gather(1, a[:, None])[:, 0]).max())
                logp = F.log_softmax(logits, -1).gather(1, a[:, None])[:, 0]
                self.state, obs2, rew, done = ref_env.step(env, self.state, a.reshape(N, A))
                rec["obs_hash"].append(obs_hash(obs))
                rec["action"].append(a.to(torch.int32))
                rec["reward"].append(rew.reshape(B).float())
                rec["done"].append(done)
                obs_buf.append(obs)
                logp_buf.append(logp)
                val_buf.append(value)
                mask_buf.append(self.masks)
                self.masks = 1.0 - done[:, None].expand(N, A).reshape(B).float()
                self.obs = obs2
            next_value = self.value(pc, self.obs.reshape(B, -1))
            rewards = torch.stack(rec["reward"])
            vp = self.vn.denormalize(torch.cat([torch.stack(val_buf), next_value[None]]))
            masks = torch.cat([torch.stack(mask_buf), self.masks[None]])
            returns = torch.empty_like(rewards)
            g = torch.zeros_like(next_value)
            for t in range(T - 1, -1, -1):
                delta = rewards[t] + rc["gamma"] * vp[t + 1] * masks[t + 1] - vp[t]
                g = delta + rc["gamma"] * rc["gae_lambda"] * masks[t + 1] * g
                returns[t] = g + vp[t]
            adv = returns - vp[:-1]
            adv = (adv - adv.mean()) / (torch.sqrt(((adv - adv.mean()) ** 2).mean()) + 1e-5)
        batch = dict(obs=torch.stack(obs_buf), actions=torch.stack(rec["action"]).long(),
                     logp=torch.stack(logp_buf), values=torch.stack(val_buf), returns=returns,
                     adv=adv)
        epochs = [self._epoch(batch) for _ in range(rc["ppo_epoch"])]
        out = {k: torch.stack(v) for k, v in rec.items()}
        seat0 = rewards.reshape(T, N, A)[:, :, 0].sum()
        out.update(losses=torch.stack(epochs).mean(0), action_gap=float(gap),
                   score=float(seat0) / N, values=batch["values"])
        return out

    def _epoch(self, b):
        rc = self.rc
        if rc["num_mini_batch"] != 1:
            raise ValueError("the reference takes one minibatch an epoch")
        if self.fault == "half_batch":
            half = b["obs"].shape[0] // 2
            b = {k: v[:half] for k, v in b.items()}
        pa = {k: v.detach().requires_grad_(True) for k, v in self.params["actor"].items()}
        pc = {k: v.detach().requires_grad_(True) for k, v in self.params["critic"].items()}
        logits = self.logits(pa, b["obs"])
        values = self.value(pc, b["obs"])
        lp = F.log_softmax(logits, -1)
        logp = lp.gather(-1, b["actions"][..., None])[..., 0]
        entropy = (-(lp.exp() * lp).sum(-1)).mean()
        ratio = torch.exp(logp - b["logp"])
        clip = rc["clip_param"]
        pg = (-torch.minimum(ratio * b["adv"],
                             torch.clamp(ratio, 1 - clip, 1 + clip) * b["adv"])).mean()
        with torch.no_grad():
            vn_before = (self.vn.mean, self.vn.mean_sq, self.vn.debias)
            self.vn.update(b["returns"])
            target = self.vn.normalize(b["returns"])
        clipped = b["values"] + torch.clamp(values - b["values"], -clip, clip)
        vl = torch.maximum(huber(target - values, rc["huber_delta"]),
                           huber(target - clipped, rc["huber_delta"])).mean()
        ga = torch.autograd.grad(pg - entropy * rc["entropy_coef"], list(pa.values()))
        gc = torch.autograd.grad(vl * rc["value_loss_coef"], list(pc.values()))
        losses = torch.stack([vl, pg, entropy, ratio.mean()]).detach()
        if self.fault == "frozen":
            self.vn.mean, self.vn.mean_sq, self.vn.debias = vn_before
            return losses
        self.t += 1
        for net, grads, lr in (("actor", ga, rc["lr"]), ("critic", gc, rc["critic_lr"])):
            self._adam(net, grads, lr)
        return losses

    def _adam(self, net: str, grads, lr: float) -> None:
        rc = self.rc
        with torch.no_grad():
            norm = torch.sqrt(sum((g ** 2).sum() for g in grads))
            scale = torch.where(norm < rc["max_grad_norm"], torch.ones_like(norm),
                                rc["max_grad_norm"] / norm)
            bc1, bc2 = 1 - BETA1 ** self.t, 1 - BETA2 ** self.t
            p, m, v = self.params[net], self.m[net], self.v[net]
            for k, g in zip(p, grads):
                g = g * scale
                m[k] = BETA1 * m[k] + (1 - BETA1) * g
                v[k] = BETA2 * v[k] + (1 - BETA2) * g * g
                p[k] = p[k] - lr * (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + rc["opti_eps"])

"""Self-play PPO: one policy controls every seat of every env.

Counterpart of ``madrona_rl_envs_playground_tpu/train/selfplay.py`` for envs
whose seats all act every step (``env.masked`` is False), after the
reference's centralized self-play drivers
(``pantheonrl_extension/centralized_agent.py``).  One update has three
phases, kept separable as in JAX:

1. ``_rollout``: ``num_steps`` steps of policy forward, sampling and env
   step (through the collector's kernel where the env has one);
2. ``_advantage``: bootstrap value, GAE, advantage normalisation and the
   minibatch chunks (bands of the T axis, in order, no shuffle);
3. ``_update``: ``update_epochs`` passes over the chunks with the PPO loss,
   a global-norm gradient clip and Adam.

The JAX ``lax.scan`` loops become Python loops.  The masked-env path with
``credit_rewards``, checkpointing and the mesh come with later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ..core.batch import batched_reset, batched_step
from ..device import DeviceLike, resolve_device
from ..models.cleanrl import CleanRLNetwork
from ..models.common import dist_entropy, dist_log_prob, dist_sample
from .cleanrl_ppo import plain_gae
from .fused_collect import make_fused_collect


@dataclasses.dataclass(frozen=True)
class SelfPlayConfig:
    num_steps: int = 128
    gamma: float = 0.99
    gae_lambda: float = 0.95
    update_epochs: int = 4
    num_minibatches: int = 1
    lr: float = 2.5e-4
    ent_coef: float = 0.01
    vf_coef: float = 0.5
    clip_coef: float = 0.2
    max_grad_norm: float = 0.5
    hidden: int = 512
    num_layers: int = 3
    # bfloat16 compute in the towers; params and optimizer stay float32
    use_bf16: bool = False
    # "clipped_mse" follows the decentralized driver (reference
    # vectoragent.py:330-346); "smooth_l1" the centralized one
    # (centralized_agent.py:381-384): huber(beta=1) value loss, no vf_coef,
    # and the whole loss scaled x128.
    value_loss: str = "clipped_mse"


class SelfPlayPPO:
    """Owns the network, the optimizer and the batched env state.

    ``train_step()`` advances ``cfg.num_steps`` env steps and runs the PPO
    update; it returns a dict of float32 scalar tensors.
    """

    def __init__(self, env, num_envs: int, cfg: SelfPlayConfig = SelfPlayConfig(),
                 seed: int = 0, device: DeviceLike = None):
        self.device = resolve_device(device)
        if env.masked or not env.state_is_obs:
            raise NotImplementedError("masked envs, and envs whose critic state is not "
                                      "the obs, are not ported yet")
        if cfg.value_loss not in ("clipped_mse", "smooth_l1"):
            raise ValueError(f"unknown value_loss {cfg.value_loss!r}")
        if cfg.num_steps % cfg.num_minibatches:
            raise ValueError("num_minibatches must divide num_steps (chunks are "
                             "bands of the T axis)")
        self.env = env
        self.num_envs = num_envs
        self.cfg = cfg
        init_gen = torch.Generator().manual_seed(seed)
        self.net = CleanRLNetwork(
            env.obs_size, env.num_actions, cfg.hidden, cfg.num_layers,
            use_bf16=cfg.use_bf16, state_size=env.state_size,
            generator=init_gen).to(self.device)
        self.opt = torch.optim.Adam(self.net.parameters(), lr=cfg.lr, eps=1e-5)
        self.sample_gen = torch.Generator(device=self.device).manual_seed(seed)
        # envs with a step kernel (Overcooked layouts inside its envelope,
        # Cartpole, Balance Beam) step through it; the rest (e.g.
        # many_player_layout-scale grids) only have the plain env
        self._fused = make_fused_collect(env, num_envs, self.device)
        bstate, out = batched_reset(env, num_envs, device=self.device)
        self.state = {"bstate": bstate, "out": out}

    # ------------------------------------------------------------------
    def _rollout(self, actions: Optional[torch.Tensor] = None):
        """Phase 1.  ``actions`` ([T, N, P] int), when given, replaces the
        sampled actions (tests use it to drive both packages alike).
        Returns the advanced (bstate, out) and the trajectory buffers
        ``[T, N*P, ...]`` (streams n-major, seats minor)."""
        cfg, env = self.cfg, self.env
        T, N, P = cfg.num_steps, self.num_envs, env.num_agents
        M = N * P
        dev = self.device
        fused = self._fused
        if fused is not None:
            carry, env_step = fused.pack(self.state["bstate"]), fused.step
        else:
            carry = self.state["bstate"]
            env_step = lambda c, a: batched_step(env, c, a)
        out = self.state["out"]
        tr = {
            "obs": torch.empty((T, M, env.obs_size), dtype=out.obs.dtype, device=dev),
            "action": torch.empty((T, M), dtype=torch.int32, device=dev),
            "logp": torch.empty((T, M), dtype=torch.float32, device=dev),
            "value": torch.empty((T, M), dtype=torch.float32, device=dev),
            "reward": torch.empty((T, M), dtype=torch.float32, device=dev),
            "done": torch.empty((T, M), dtype=torch.bool, device=dev),
        }
        with torch.no_grad():
            for t in range(T):
                obs = out.obs.reshape(M, -1)
                logits, value = self.net(obs, obs)  # state_obs is obs
                if actions is None:
                    action = dist_sample(self.sample_gen, logits)
                else:
                    action = actions[t].reshape(M).to(device=dev, dtype=torch.int32)
                carry, out2 = env_step(carry, action.reshape(N, P))
                tr["obs"][t] = obs
                tr["action"][t] = action
                tr["logp"][t] = dist_log_prob(logits, action)
                tr["value"][t] = value
                tr["reward"][t] = out2.reward.reshape(M)
                tr["done"][t] = out2.done[:, None].expand(N, P).reshape(M)
                out = out2
        bstate = fused.unpack(carry) if fused is not None else carry
        return bstate, out, tr

    def _advantage(self, tr: Dict[str, torch.Tensor], out):
        """Phase 2.  Returns (chunks, stats): chunks maps each buffer to
        ``[num_minibatches, T / num_minibatches, M, ...]``."""
        cfg = self.cfg
        T, N, P = cfg.num_steps, self.num_envs, self.env.num_agents
        M = N * P
        rewards = tr["reward"]
        # every seat acts every step: slot dones are the dones shifted by one
        slot_dones = torch.cat([torch.zeros_like(tr["done"][:1]), tr["done"][:-1]])
        with torch.no_grad():
            next_value = self.net.get_value(out.state_obs.reshape(M, -1))
        next_done = out.done[:, None].expand(N, P).reshape(M)
        adv, returns = plain_gae(rewards, slot_dones, tr["value"], next_value,
                                 next_done, cfg.gamma, cfg.gae_lambda)
        n = float(T * M)
        m = adv.mean()
        var = ((adv - m) ** 2).mean()
        std = torch.sqrt(var * n / max(n - 1.0, 1.0))  # unbiased
        adv = (adv - m) / (std + 1e-8)
        nmb = cfg.num_minibatches
        batch = {"obs": tr["obs"], "actions": tr["action"], "logprobs": tr["logp"],
                 "advantages": adv, "returns": returns, "values": tr["value"]}
        chunks = {k: v.reshape((nmb, T // nmb) + tuple(v.shape[1:]))
                  for k, v in batch.items()}
        stats = {"mean_step_reward": rewards.mean(), "mean_value": tr["value"].mean()}
        return chunks, stats

    def _mb_loss(self, c: Dict[str, torch.Tensor]):
        cfg = self.cfg
        logits, newvalue = self.net(c["obs"], c["obs"])
        newlogprob = dist_log_prob(logits, c["actions"])
        entropy = dist_entropy(logits)
        logratio = newlogprob - c["logprobs"]
        ratio = torch.exp(logratio)
        adv = c["advantages"]
        pg = torch.maximum(
            -adv * ratio,
            -adv * torch.clamp(ratio, 1 - cfg.clip_coef, 1 + cfg.clip_coef)).mean()
        ent = entropy.mean()
        if cfg.value_loss == "smooth_l1":
            err = newvalue - c["returns"]
            a = torch.abs(err)
            vl = torch.where(a < 1.0, 0.5 * err * err, a - 0.5).mean()
            total = (pg - cfg.ent_coef * ent + vl) * 128.0
        else:
            clipped = c["values"] + torch.clamp(
                newvalue - c["values"], -cfg.clip_coef, cfg.clip_coef)
            vl = 0.5 * torch.maximum((newvalue - c["returns"]) ** 2,
                                     (clipped - c["returns"]) ** 2).mean()
            total = pg - cfg.ent_coef * ent + vl * cfg.vf_coef
        kl = ((ratio - 1) - logratio).mean()
        return total, (pg, vl, ent, kl)

    def _clip_grads(self) -> None:
        """Global-norm clip as optax writes it: ``g / norm * max_norm`` when
        ``norm >= max_norm`` (``clip_grad_norm_`` adds 1e-6 to the norm)."""
        grads = [p.grad for p in self.net.parameters() if p.grad is not None]
        norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
        keep = norm < self.cfg.max_grad_norm
        with torch.no_grad():
            for g in grads:
                g.copy_(torch.where(keep, g, g / norm * self.cfg.max_grad_norm))

    def _update(self, chunks: Dict[str, torch.Tensor]):
        """Phase 3.  Returns the last epoch's (pg, v, entropy, kl) losses,
        each the mean over its minibatches."""
        nmb = self.cfg.num_minibatches
        last = None
        for _ in range(self.cfg.update_epochs):
            auxes = []
            for i in range(nmb):
                loss, aux = self._mb_loss({k: v[i] for k, v in chunks.items()})
                self.opt.zero_grad(set_to_none=True)
                loss.backward()
                self._clip_grads()
                self.opt.step()
                auxes.append(torch.stack([x.detach() for x in aux]))
            last = torch.stack(auxes).mean(0)
        return tuple(last)

    def train_step(self, actions: Optional[torch.Tensor] = None):
        """rollout -> advantage -> update; returns the metrics."""
        bstate, out, tr = self._rollout(actions)
        chunks, stats = self._advantage(tr, out)
        pg, vl, ent, kl = self._update(chunks)
        self.state = {"bstate": bstate, "out": out}
        return {"pg_loss": pg, "v_loss": vl, "entropy": ent, "approx_kl": kl, **stats}

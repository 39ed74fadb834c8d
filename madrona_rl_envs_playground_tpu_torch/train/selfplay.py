"""Self-play PPO: one policy controls every seat of every env.

Counterpart of ``madrona_rl_envs_playground_tpu/train/selfplay.py``, after
the reference's centralized self-play drivers
(``pantheonrl_extension/centralized_agent.py``, ``hanabi_agent.py``).  One
update has three phases, kept separable as in JAX:

1. ``_rollout``: ``num_steps`` steps of policy forward, sampling and env
   step (through the collector's kernel where the env has one);
2. ``_advantage``: credit routing, bootstrap value, GAE, advantage
   normalisation and the minibatch chunks (bands of the T axis, in order,
   no shuffle; where ``num_minibatches`` does not divide ``num_steps``, JAX's
   fallback: T-major flat chunks, the remainder rows dropped);
3. ``_update``: ``update_epochs`` passes over the chunks with the PPO loss,
   a global-norm gradient clip (``train/optim.py``) and Adam.

Envs whose seats take turns (``env.masked``, Hanabi) keep the reference's
credit rules (``vectoragent.py:197-219``, ``centralized_agent.py:288-322``):
every (env, seat) stream records a slot every step; rewards earned while a
seat is inactive flow back to its last active slot; rewards arriving after
an episode boundary but before the seat's first action of the new episode
are dropped; GAE runs with ``active_masked_gae``; and the advantage
normalisation, every loss term and the metrics are means over the active
slots only.  Their logits are masked to the legal moves, and their critic
reads ``state_obs`` where it is not the obs (``env.state_is_obs``).

The JAX ``lax.scan`` loops become Python loops: the rollout's T steps
(``_rollout_body``), the advantage's credit and GAE scans (``_scan_body``)
and the epochs over the minibatches (``_update_body``: forward, backward,
clip and Adam a minibatch).  On the card, where the collector steps a
kernel (``captured``; ``train/graphs.py`` states the rule), each is
captured once as a CUDA graph and replayed on every later update, the
counterpart of JAX's one jit; the first update runs them eagerly as the
warm-up.  On a mesh the epochs stay eager: their gradient all-reduce is a
gloo call.  Adam keeps its state on the card (``train/optim.py``'s
``adam``), and the gradients are zeroed in place, so a replay steps the
same tensors as the eager loop.  Injected actions always run eagerly.
``run`` drives updates and logs their metrics; ``save``/``load``
checkpoint the network, Adam and the sampler's generator state (JAX's
``key``) and, by default, the batched env state, so a restore resumes
mid-stream exactly.  A ``load`` into a captured trainer reaches its next
replays: the env state is copied into the rollout graph's inputs at every
rollout, the generator, registered with the graph, is set in place, and
the parameters and Adam's moments and step counts are copied into the
tensors the update graph steps (``update_state``).

On a ``mesh`` (``parallel/mesh.py``) each rank holds its rows of the
``num_envs`` worlds, steps them through the mesh's collector
(``fused_collect.py``: K1 for Overcooked), and updates a replicated network:

* the sampler draws its noise for the whole batch from ``sample_gen``,
  whose state is the same on every rank, and takes this rank's rows, so the
  actions do not depend on the number of ranks;
* every mean (the advantage normalisation, the losses, the metrics) is over
  the whole batch (``train/optim.py``'s ``GlobalMean``), and the gradients
  are summed over the ranks before the clip;
* the T-axis chunks stay rank-local; JAX's fallback for a minibatch count
  that does not divide T merges the env axis, so there the buffers are
  gathered and every rank runs the same update on the whole batch, as JAX's
  all-gather does;
* the credit routing and the GAE are per stream and stay local, but for
  the masked GAE's one cross-stream question, whether every stream of the
  batch has been active yet at a slot (one all-reduce of T counts);
* ``save`` gathers the env state and writes on rank 0; ``load`` reads on
  rank 0 and hands every rank its rows.  Every rank calls both.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ..core.batch import batched_reset
from ..device import DeviceLike, resolve_device
from ..models.cleanrl import CleanRLNetwork
from ..models.common import dist_entropy, dist_log_prob, dist_sample
from ..parallel.launch import is_primary
from ..parallel.mesh import gather_batch_pytree, put_selfplay_state, shard_batch_pytree
from ..utils import tracing
from ..utils.checkpoint import load_pytree, save_pytree
from .cleanrl_ppo import Rollout, active_masked_gae, plain_gae
from .fused_collect import make_fused_collect
from .graphs import LoopGraph, captures
from .optim import (GlobalMean, adam, all_reduce_grads, all_sum, clip_grad_global_norm_,
                    load_optimizer_state_, update_tensors)


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


def credit_rewards(rewards: torch.Tensor, active: torch.Tensor, dones: torch.Tensor):
    """The reference's inactive-reward routing over raw per-step rewards.

    rewards / active / dones: [T, M] (M = env x seat streams; dones is the
    stream's episode end at that step).  Returns (credited [T, M],
    slot_dones [T, M]): credited[t] is the reward attributed to the action
    recorded at slot t, and slot_dones[t] the done delivered between slots
    t-1 and t (the reference's ``next_done`` at record time,
    ``vectoragent.py:288``)."""
    T = rewards.shape[0]
    # new-game flag when step t's rewards arrive: cleared when the seat
    # acts at t, set after any done
    new_game = torch.zeros_like(active[0])
    ng = torch.empty_like(active)
    for t in range(T):
        ng_t = new_game & ~active[t]
        ng[t] = ng_t
        new_game = ng_t | dones[t]
    kept = torch.where(ng, torch.zeros_like(rewards), rewards)
    # each step's kept reward flows to the most recent active slot at or
    # before it
    acc = torch.zeros_like(rewards[0])
    credited = torch.empty_like(rewards)
    for t in range(T - 1, -1, -1):
        acc = acc + kept[t]
        credited[t] = torch.where(active[t], acc, torch.zeros_like(acc))
        acc = torch.where(active[t], torch.zeros_like(acc), acc)
    slot_dones = torch.cat([torch.zeros_like(dones[:1]), dones[:-1]])
    return credited, slot_dones


class SelfPlayPPO:
    """Owns the network, the optimizer and the batched env state.

    ``train_step()`` advances ``cfg.num_steps`` env steps and runs the PPO
    update; it returns a dict of float32 scalar tensors.  ``num_envs`` is
    the global batch; on a ``mesh`` the device is the mesh's and the state
    this rank's rows.
    """

    def __init__(self, env, num_envs: int, cfg: SelfPlayConfig = SelfPlayConfig(),
                 seed: int = 0, device: DeviceLike = None, mesh=None):
        with tracing.span("construct"):  # on the host's clock
            self.device = resolve_device(device) if mesh is None else mesh.device
            if cfg.value_loss not in ("clipped_mse", "smooth_l1"):
                raise ValueError(f"unknown value_loss {cfg.value_loss!r}")
            self.env = env
            self.num_envs = num_envs
            self.mesh = mesh
            # this rank's worlds of the global batch
            self._rows = slice(0, num_envs) if mesh is None else mesh.rows(num_envs)
            self.cfg = cfg
            # envs whose state_obs is the obs store one trajectory buffer, and
            # envs that never mask store no mask or active flags
            self._alias = env.state_is_obs
            self._masked = env.masked
            init_gen = torch.Generator().manual_seed(seed)
            self.net = CleanRLNetwork(
                env.obs_size, env.num_actions, cfg.hidden, cfg.num_layers,
                use_bf16=cfg.use_bf16, state_size=env.state_size,
                generator=init_gen).to(self.device)
            self.opt = adam(self.net.parameters(), cfg.lr, eps=1e-5)
            self.sample_gen = torch.Generator(device=self.device).manual_seed(seed)
            # envs with a step kernel (Overcooked layouts inside its envelope,
            # Cartpole, Balance Beam, Acrobot, 2-player Hanabi) step through it;
            # the rest (e.g. many_player_layout-scale grids, 3-player Hanabi)
            # get the plain collector
            self._fused = make_fused_collect(env, num_envs, self.device, mesh=mesh)
            self._rollout_graph = self._scan_graph = self._update_graph = None
            if captures(self.device, self._fused):
                self._rollout_graph = LoopGraph(self._rollout_body, [self.sample_gen], owner=self,
                                                name="rollout")
                self._scan_graph = LoopGraph(self._scan_body, owner=self, name="scan")
                if mesh is None:  # on a mesh the epochs all-reduce over gloo
                    self._update_graph = LoopGraph(self._update_body, owner=self, name="epochs")
            bstate, out = batched_reset(env, num_envs, device=self.device)
            self.state = {"bstate": bstate, "out": out}
            if mesh is not None:
                self.state = put_selfplay_state(self.state, mesh)
                mesh.broadcast_module_(self.net)

    @property
    def _update_mesh(self):
        """The mesh an update's means and gradient sums run over: None where
        ``num_minibatches`` does not divide ``num_steps``, JAX's fallback,
        which merges the env axis, so that every rank updates on the whole
        batch (``_advantage`` gathers it)."""
        return None if self.cfg.num_steps % self.cfg.num_minibatches else self.mesh

    # ------------------------------------------------------------------
    @property
    def captured(self) -> bool:
        """Whether the rollout and the advantage scans replay CUDA graphs
        (``train/graphs.py``'s rule: a kernel collector on the card), and
        without a mesh the epochs too."""
        return self._rollout_graph is not None

    def update_state(self):
        """The tensors an update writes in place, in a fixed order: the
        parameters, their gradients and Adam's moments, step counts and
        learning rate (``train/optim.py``'s ``update_tensors``); a captured
        update reads and writes these very tensors."""
        return update_tensors([self.net], [self.opt])

    def _rollout(self, actions: Optional[torch.Tensor] = None):
        """Phase 1.  ``actions`` ([T, N, P] int), when given, replaces the
        sampled actions (tests use it to drive both packages alike; always
        eager).  Returns the advanced (bstate, out) and the trajectory
        buffers ``[T, N*P, ...]`` (streams n-major, seats minor; on a mesh N
        is this rank's worlds and ``actions`` its rows).  On a captured
        trainer the out and buffers are the graph's, which the next rollout
        overwrites."""
        carry, out = self._fused.pack(self.state["bstate"]), self.state["out"]
        if actions is None and self.captured:
            carry, out, tr = self._rollout_graph(carry, out)
        else:
            carry, out, tr = self._rollout_body(carry, out, actions)
        return self._fused.unpack(carry), out, tr

    def _rollout_body(self, carry, out, actions: Optional[torch.Tensor] = None):
        """The rollout's T steps from the collector's ``carry`` and the last
        ``StepOutput``: the loop that the CPU runs and the card captures.
        Returns (carry, out, tr)."""
        cfg, env = self.cfg, self.env
        T, N, P = cfg.num_steps, self._rows.stop - self._rows.start, env.num_agents
        M = N * P
        rows = (self._rows.start * P, self.num_envs * P)
        dev = self.device
        env_step = self._fused.step
        tr = {
            "obs": torch.empty((T, M, env.obs_size), dtype=out.obs.dtype, device=dev),
            "action": torch.empty((T, M), dtype=torch.int32, device=dev),
            "logp": torch.empty((T, M), dtype=torch.float32, device=dev),
            "value": torch.empty((T, M), dtype=torch.float32, device=dev),
            "reward": torch.empty((T, M), dtype=torch.float32, device=dev),
            "done": torch.empty((T, M), dtype=torch.bool, device=dev),
        }
        if not self._alias:
            tr["state_obs"] = torch.empty((T, M, env.state_size), dtype=out.state_obs.dtype,
                                          device=dev)
        if self._masked:
            tr["mask"] = torch.empty((T, M, env.num_actions), dtype=torch.bool, device=dev)
            tr["active"] = torch.empty((T, M), dtype=torch.bool, device=dev)
        with torch.no_grad():
            for t in range(T):
                obs = out.obs.reshape(M, -1)
                st = obs if self._alias else out.state_obs.reshape(M, -1)
                mask = out.action_mask.reshape(M, -1) if self._masked else None
                logits, value = self.net(obs, st, mask)
                if actions is None:
                    action = dist_sample(self.sample_gen, logits, rows)
                else:
                    action = actions[t].reshape(M).to(device=dev, dtype=torch.int32)
                carry, out2 = env_step(carry, action.reshape(N, P))
                tr["obs"][t] = obs
                if not self._alias:
                    tr["state_obs"][t] = st
                if self._masked:
                    tr["mask"][t] = mask
                    tr["active"][t] = out.active.reshape(M)
                tr["action"][t] = action
                tr["logp"][t] = dist_log_prob(logits, action)
                tr["value"][t] = value
                tr["reward"][t] = out2.reward.reshape(M)
                tr["done"][t] = out2.done[:, None].expand(N, P).reshape(M)
                out = out2
        return carry, out, tr

    def _scan_body(self, reward, done, value, active, next_state_obs, next_done, next_active):
        """The advantage's T-step scans: the credit routing (masked envs),
        the bootstrap value and the GAE.  ``reward``, ``done``, ``value`` and
        ``active`` are the rollout's buffers, the ``next_*`` its last
        ``StepOutput``'s ``state_obs``, ``done`` and ``active`` (``active``
        and ``next_active`` None for envs that never mask).  Returns (rewards,
        advantages, returns, trainable active or None), each [T, M].  On a
        mesh the masked GAE all-reduces its counts of waiting streams; only
        the plain collector, which is never captured, runs masked envs on a
        mesh, so a captured scan holds no collective."""
        T, N, P = self.cfg.num_steps, self._rows.stop - self._rows.start, self.env.num_agents
        M = N * P
        if self._masked:
            rewards, slot_dones = credit_rewards(reward, active, done)
        else:
            # every seat acts every step: the routing is the identity and
            # slot dones are the dones shifted by one
            rewards = reward
            slot_dones = torch.cat([torch.zeros_like(done[:1]), done[:-1]])
        with torch.no_grad():
            next_value = self.net.get_value(next_state_obs.reshape(M, -1))
        next_done = next_done[:, None].expand(N, P).reshape(M)
        if self._masked:
            buf = Rollout(obs=None, states=None, actions=None, action_masks=None,
                          logprobs=None, rewards=rewards, dones=slot_dones, active=active,
                          values=value)
            adv, returns, trainable = active_masked_gae(
                buf, next_value, next_done, next_active.reshape(M), self.cfg.gamma,
                self.cfg.gae_lambda, self.mesh)
            return rewards, adv, returns, trainable
        adv, returns = plain_gae(rewards, slot_dones, value, next_value, next_done,
                                 self.cfg.gamma, self.cfg.gae_lambda)
        return rewards, adv, returns, None

    def _advantage(self, tr: Dict[str, torch.Tensor], out):
        """Phase 2.  Returns (chunks, stats): chunks maps each buffer to
        ``[num_minibatches, T / num_minibatches, M, ...]`` where
        ``num_minibatches`` divides T, else (JAX's fallback) to
        ``[num_minibatches, T * M // num_minibatches, ...]``: the buffer
        flattened T-major, the last ``T * M % num_minibatches`` rows dropped
        (on a mesh, the buffers of every rank, gathered).  ``stats`` holds
        this rank's shares of the metrics' means."""
        cfg, mesh = self.cfg, self.mesh
        T, N, P = cfg.num_steps, self._rows.stop - self._rows.start, self.env.num_agents
        M = N * P
        scans = self._scan_graph if self.captured else self._scan_body
        rewards, adv, returns, active = scans(
            tr["reward"], tr["done"], tr["value"], tr.get("active"), out.state_obs, out.done,
            out.active if self._masked else None)
        if self._masked:
            b_active = active.float()
            mean = GlobalMean(mesh, weights=b_active, min_count=1.0)
            n_less_1 = torch.clamp(mean.count - 1.0, min=1.0)
        else:
            mean = GlobalMean(mesh, like=adv)
            n_less_1 = max(mean.count - 1.0, 1.0)
        m = all_sum(mesh, mean(adv), "advantage")
        var = all_sum(mesh, mean((adv - m) ** 2), "advantage")
        std = torch.sqrt(var * mean.count / n_less_1)  # unbiased
        adv = (adv - m) / (std + 1e-8)
        nmb = cfg.num_minibatches
        batch = {"obs": tr["obs"], "actions": tr["action"], "logprobs": tr["logp"],
                 "advantages": adv, "returns": returns, "values": tr["value"]}
        if not self._alias:
            batch["states"] = tr["state_obs"]
        if self._masked:
            batch["masks"] = tr["mask"]
            batch["active"] = b_active
        if T % nmb == 0:
            chunks = {k: v.reshape((nmb, T // nmb) + tuple(v.shape[1:]))
                      for k, v in batch.items()}
        else:
            if mesh is not None:  # every rank updates on the whole batch
                batch = {k: mesh.all_gather(v, dim=1, what="buffers") for k, v in batch.items()}
                M *= mesh.size
            mb = T * M // nmb
            chunks = {k: v.reshape((T * M,) + tuple(v.shape[2:]))[:nmb * mb]
                      .reshape((nmb, mb) + tuple(v.shape[2:])) for k, v in batch.items()}
        stats = {"mean_step_reward": mean(rewards), "mean_value": mean(tr["value"])}
        return chunks, stats

    def _mb_loss(self, c: Dict[str, torch.Tensor]):
        cfg = self.cfg
        logits, newvalue = self.net(c["obs"], c.get("states", c["obs"]), c.get("masks"))
        newlogprob = dist_log_prob(logits, c["actions"])
        entropy = dist_entropy(logits)
        if "active" in c:
            mean = GlobalMean(self._update_mesh, weights=c["active"], min_count=1.0)
        else:
            mean = GlobalMean(self._update_mesh, like=c["advantages"])
        logratio = newlogprob - c["logprobs"]
        ratio = torch.exp(logratio)
        adv = c["advantages"]
        pg = mean(torch.maximum(
            -adv * ratio,
            -adv * torch.clamp(ratio, 1 - cfg.clip_coef, 1 + cfg.clip_coef)))
        ent = mean(entropy)
        if cfg.value_loss == "smooth_l1":
            err = newvalue - c["returns"]
            a = torch.abs(err)
            vl = mean(torch.where(a < 1.0, 0.5 * err * err, a - 0.5))
            total = (pg - cfg.ent_coef * ent + vl) * 128.0
        else:
            clipped = c["values"] + torch.clamp(
                newvalue - c["values"], -cfg.clip_coef, cfg.clip_coef)
            vl = 0.5 * mean(torch.maximum((newvalue - c["returns"]) ** 2,
                                          (clipped - c["returns"]) ** 2))
            total = pg - cfg.ent_coef * ent + vl * cfg.vf_coef
        kl = mean((ratio - 1) - logratio)
        return total, (pg, vl, ent, kl)

    def _update(self, chunks: Dict[str, torch.Tensor]):
        """Phase 3.  Returns the last epoch's (pg, v, entropy, kl) losses,
        each the mean over its minibatches (on a mesh, this rank's shares,
        unless the update ran on the whole batch).  On a captured trainer
        without a mesh, a replay of the epochs' graph, whose losses the
        next replay overwrites."""
        update = self._update_graph if self._update_graph is not None else self._update_body
        return update(chunks)

    def _update_body(self, chunks: Dict[str, torch.Tensor]):
        """The epochs over the minibatch ``chunks``: the loop that the CPU
        runs and the card captures.  The gradients are zeroed in place (the
        first backward of the trainer makes them), so that a replay writes
        the tensors Adam's captured step reads."""
        nmb = self.cfg.num_minibatches
        last = None
        for _ in range(self.cfg.update_epochs):
            auxes = []
            for i in range(nmb):
                loss, aux = self._mb_loss({k: v[i] for k, v in chunks.items()})
                self.opt.zero_grad(set_to_none=False)
                loss.backward()
                all_reduce_grads(self._update_mesh, self.net.parameters())
                clip_grad_global_norm_(self.net.parameters(), self.cfg.max_grad_norm)
                self.opt.step()
                auxes.append(torch.stack([x.detach() for x in aux]))
            last = torch.stack(auxes).mean(0)
        return tuple(last)

    def train_step(self, actions: Optional[torch.Tensor] = None):
        """rollout -> advantage -> update; returns the metrics (on a mesh,
        the means over the whole batch, on every rank).  Traced as an
        ``update`` span (``utils/tracing.py``) tiled by ``rollout``,
        ``advantage``, ``epochs`` and ``metrics``."""
        dev = self.device
        with tracing.span("update", dev, update=True, tiled=True):
            with tracing.span("rollout", dev):
                bstate, out, tr = self._rollout(actions)
            with tracing.span("advantage", dev):
                chunks, stats = self._advantage(tr, out)
            with tracing.span("epochs", dev):
                losses = self._update(chunks)
            with tracing.span("metrics", dev):
                losses = torch.stack(losses)
                stats = torch.stack([stats["mean_step_reward"], stats["mean_value"]])
                if self._update_mesh is None:  # the losses are the whole batch's already
                    metrics = torch.cat([losses, all_sum(self.mesh, stats, "metrics")])
                else:
                    metrics = all_sum(self.mesh, torch.cat([losses, stats]), "metrics")
                pg, vl, ent, kl, msr, mv = metrics
        self.state = {"bstate": bstate, "out": out}
        return {"pg_loss": pg, "v_loss": vl, "entropy": ent, "approx_kl": kl,
                "mean_step_reward": msr, "mean_value": mv}

    # ---- checkpointing -------------------------------------------------
    def save(self, path: str, with_env_state: bool = True) -> None:
        """The network, Adam and the sampler's generator state always; by
        default also the batched env state and the last output, so a load
        resumes mid-stream exactly.  ``with_env_state=False`` writes a
        policy-only checkpoint, loadable at any ``num_envs``.  On a mesh the
        env state is gathered and rank 0 writes."""
        blob = {"net": self.net.state_dict(), "opt": self.opt.state_dict(),
                "sample_gen": self.sample_gen.get_state()}
        if with_env_state:
            for k in ("bstate", "out"):
                tree = _to_tree(self.state[k])
                blob[k] = tree if self.mesh is None else gather_batch_pytree(tree, self.mesh)
        if is_primary():
            save_pytree(path, blob)
        if self.mesh is not None:
            self.mesh.barrier()

    def load(self, path: str) -> None:
        """Restore a ``save``, written on the card or on the CPU.  Env state
        saved at another batch size is dropped: a policy-only restore.  The
        parameters and Adam's state are copied in place into the tensors
        that the update graph steps (``update_state``), so a captured
        trainer is not captured again.  On a mesh rank 0 reads and every
        rank takes its rows."""
        if self.mesh is None:
            blob = load_pytree(path)
        else:
            blob = self.mesh.broadcast_object(load_pytree(path) if is_primary() else None)
        self.net.load_state_dict(blob["net"])
        load_optimizer_state_(self.opt, blob["opt"])
        self.sample_gen.set_state(blob["sample_gen"])
        if "bstate" in blob and _batch_size(blob["bstate"]) == self.num_envs:
            if self.mesh is not None:
                blob = shard_batch_pytree({k: blob[k] for k in ("bstate", "out")}, self.mesh)
            self.state = {k: _from_tree(self.state[k], blob[k], self.device)
                          for k in ("bstate", "out")}

    # ------------------------------------------------------------------
    def run(self, num_updates: int, log_every: int = 0, logger=None):
        """``num_updates`` updates; every ``log_every`` updates the metrics
        go to ``logger`` as ``selfplay/<key>`` at step ``u + 1``, or are
        printed when there is no logger (on a mesh, by rank 0 only).
        Returns the last metrics."""
        metrics = None
        for u in range(num_updates):
            metrics = self.train_step()
            if log_every and (u + 1) % log_every == 0 and is_primary():
                # sorted, as JAX's metrics come back from its jit
                m = {k: float(metrics[k]) for k in sorted(metrics)}
                if logger is not None:
                    for k, v in m.items():
                        logger.add_scalar(f"selfplay/{k}", v, u + 1)
                else:
                    print(f"update {u + 1}: {m}")
        return metrics


def _to_tree(x):
    """Dataclasses of tensors -> dicts (what ``weights_only`` loads)."""
    if dataclasses.is_dataclass(x):
        return {f.name: _to_tree(getattr(x, f.name)) for f in dataclasses.fields(x)}
    return x


def _from_tree(like, tree, device):
    """The inverse of ``_to_tree``, shaped after ``like``."""
    if dataclasses.is_dataclass(like):
        return type(like)(**{f.name: _from_tree(getattr(like, f.name), tree[f.name], device)
                             for f in dataclasses.fields(like)})
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def _batch_size(bstate_tree) -> int:
    """The batch size of a saved ``BatchState``: every env-state field has
    the env axis first."""
    return int(next(iter(bstate_tree["env_states"].values())).shape[0])

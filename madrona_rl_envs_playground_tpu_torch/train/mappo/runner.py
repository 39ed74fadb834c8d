"""MAPPO self-play runner.

Counterpart of ``madrona_rl_envs_playground_tpu/train/mappo/runner.py``, the
reference ``MainPlayer`` (``train/MAPPO/main_player.py:185-309``): one
policy acts for every seat of every env each step, the trajectories of all
(env, seat) streams fill one shared buffer, then R_MAPPO trains on it.  One
update is three phases:

1. ``_collect``: ``episode_length`` steps of policy forward, sampling and
   env step, a Python loop (``_collect_body``; JAX scans it);
2. ``_compute``: the bootstrap value and ``compute_returns``;
3. ``trainer.train``: the PPO epochs.

On the card, where the collector steps a kernel (``captured``;
``train/graphs.py`` states the rule), the collect, ``compute_returns``'
reverse loop and one ``episode_length`` block of ``evaluate`` (by the same
rule for its own collector) are each captured once as a CUDA graph and
replayed from then on, the counterpart of JAX's jitted scans, and without
a mesh so is ``trainer.train``'s epochs (``RMAPPOTrainer``); each one's
first call runs eagerly as the warm-up (it also settles cuDNN's choice for
the CNN base) and captures.  Injected actions and given permutations
always run eagerly.  The carry (env state, last output, masks and hidden
states) is copied into a graph's static inputs before each replay and read
back from its outputs after it, so ``restore`` and a changed ``bstate``
take effect at the next call; ``restore`` copies the nets, optimizer
states and ValueNorm statistics into the tensors the train graph steps
(``trainer.update_state``), so nothing is captured again.

The env steps through its collector (``train/fused_collect.py``), so on the
card through its step kernel (K1 for Overcooked, K9 for Acrobot) and on the
CPU through the kernel's plain version; envs without a kernel get the plain
``batched_step``.  The device decides; there is no option.  ``evaluate``
steps the same way.  A recurrent policy's hidden states are carried from
step to step and update to update, zeroed where an episode ended
(``main_player.py:248-257``); the collect stores each step's states before
the step, as JAX's scan does.  ``use_cnn_obs`` feeds the nets the Overcooked
grid, ``[width, height, num_channels]``, so that their base is the CNN.

With a ``run_dir`` the runner logs JAX's scalars to
``<run_dir>/metrics.jsonl`` (``utils/logger.py``: ``mappo/
average_episode_rewards``, ``mappo/<train info key>`` and
``mappo/eval_score``) and ``save``s every ``save_interval`` updates.  A
checkpoint (``<dir>/checkpoint.pt``, ``utils/checkpoint.py``) holds JAX's
blob: both nets' parameters (the GRU and conv ones too), both optimizer
states (Adam or AdamW) and the ValueNorm statistics, and beside it the nets'
``ModelConfig``; ``restore`` also takes one with parameters and ValueNorm
only.  JAX's pickled checkpoint holds
optax states and does not load here: its weights cross through
``models/mappo_nets.py::load_mappo_params``.

On a ``mesh`` (``parallel/mesh.py``) each rank holds its rows of the
``n_rollout_threads`` envs (``bstate``, ``out``, the hidden states and the
masks), steps them through the mesh's collector (K1 for Overcooked), takes
its rows of the noise the sampler draws for the whole batch, and trains the
replicated nets on its streams (``RMAPPOTrainer``'s mesh); the episode score
is the whole batch's.  ``evaluate`` runs on rank 0 over the whole batch and
hands every rank its score; rank 0 logs and writes the checkpoints, and
``restore`` reads on rank 0.  Every rank calls ``run``, ``update``,
``evaluate``, ``save`` and ``restore`` together.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Dict, Optional

import torch

from ...core.batch import batched_reset
from ...device import DeviceLike, resolve_device
from ...models.common import dist_sample
from ...parallel.launch import is_primary
from ...parallel.mesh import shard_batch_pytree
from ...utils import tracing
from ...utils.checkpoint import load_pytree, save_pytree
from ...utils.logger import ScalarLogger
from ..fused_collect import make_fused_collect
from ..optim import all_sum, load_optimizer_state_
from ..graphs import LoopGraph, captures
from .buffer import MAPPOBuffer, compute_returns, init_buffer, returns_scan
from .config import MAPPOConfig
from .policy import MAPPOPolicy
from .trainer import RMAPPOTrainer
from .valuenorm import ValueNormState, vn_copy_


class MAPPORunner:
    def __init__(self, cfg: MAPPOConfig, env, run_dir: Optional[str] = None,
                 device: DeviceLike = None, mesh=None):
        with tracing.span("construct"):  # on the host's clock
            self.device = dev = resolve_device(device) if mesh is None else mesh.device
            self.cfg = cfg
            self.env = env
            self.mesh = mesh
            self.N = cfg.n_rollout_threads
            self.A = env.num_agents
            # this rank's envs of the whole batch
            self._rows = slice(0, self.N) if mesh is None else mesh.rows(self.N)
            self.n_local = self._rows.stop - self._rows.start
            obs_shape, share_obs_shape = (env.obs_size,), (env.state_size,)
            if cfg.use_cnn_obs:
                # grid envs only: the flat obs is (x, y, c)-ordered, so the
                # [W, H, C] reshape inside the nets recovers the grid the
                # reference's CNN sees (utils/cnn.py)
                if not hasattr(env, "width"):
                    raise ValueError(f"use_cnn_obs needs a grid env (width, height, "
                                     f"num_channels); {type(env).__name__} has flat obs only")
                obs_shape = (env.width, env.height, env.num_channels)
                if env.state_size == env.obs_size:
                    share_obs_shape = obs_shape
            self.policy = MAPPOPolicy(cfg, obs_shape=obs_shape, share_obs_shape=share_obs_shape,
                                      num_actions=env.num_actions, seed=cfg.seed, device=dev)
            self._fused = make_fused_collect(env, self.N, dev, mesh=mesh)
            # on a mesh the epochs all-reduce over gloo: eager
            self.trainer = RMAPPOTrainer(cfg, self.policy, mesh=mesh,
                                         captured=captures(dev, self._fused) and mesh is None)
            self.run_dir = run_dir
            self.logger = ScalarLogger(run_dir) if run_dir and is_primary() else None
            self.sample_gen = torch.Generator(device=dev).manual_seed(cfg.seed)
            self.bstate, self.out = batched_reset(env, self.N, device=dev)
            if mesh is not None:
                mesh.broadcast_module_(self.policy.actor)
                mesh.broadcast_module_(self.policy.critic)
                self.bstate, self.out = shard_batch_pytree((self.bstate, self.out), mesh)
            B = self.n_local * self.A
            # 0 where the env's last step ended an episode (the buffer's slot T)
            self._masks = torch.ones((B,), device=dev)
            # the hidden states (JAX keeps width-1 placeholders where the policy
            # is feed-forward, and so does the port)
            self._rnn = self.policy.actor.zero_states(B, dev)
            self._rnnc = self.policy.critic.zero_states(B, dev)
            self._rnn_shape = tuple(self._rnn.shape)
            # evaluate runs over the whole batch: on a mesh, on rank 0 through
            # a collector of its own; its sampler's seed is reset at every call
            self._eval_fused = self._fused if mesh is None else make_fused_collect(env, self.N, dev)
            self._eval_gen = torch.Generator(device=dev)
            self._collect_graph = self._returns_graph = None
            self._eval_graphs = {}  # deterministic -> the eval block's graph
            if captures(dev, self._fused):
                self._collect_graph = LoopGraph(self._collect_body, [self.sample_gen], owner=self,
                                                name="collect")
                self._returns_graph = LoopGraph(functools.partial(
                    returns_scan, gamma=cfg.gamma, gae_lambda=cfg.gae_lambda, use_gae=cfg.use_gae,
                    use_proper_time_limits=cfg.use_proper_time_limits), owner=self, name="returns")
            self.episode_rewards = []  # average episode score of each update

    @property
    def captured(self) -> bool:
        """Whether the collect and the returns replay CUDA graphs
        (``train/graphs.py``'s rule: a kernel collector on the card)."""
        return self._collect_graph is not None

    # ------------------------------------------------------------------
    def _collect(self, actions: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One ``episode_length`` rollout from the runner's carry, which it
        advances.  ``actions`` ([T, N, A] int), when given, replaces the
        sampled actions (always eager).  Returns the trajectory,
        ``[T, M, ...]`` with M = N * A thread-major (on a mesh, this rank's
        envs and ``actions`` its rows); a recurrent policy's also holds
        ``rnn`` and ``rnnc``, each step's hidden states before it.  On a
        captured runner the trajectory and the carry are the graph's, which
        the next collect overwrites."""
        args = (self._fused.pack(self.bstate), self.out, self._masks, self._rnn, self._rnnc)
        if actions is None and self.captured:
            res = self._collect_graph(*args)
        else:
            res = self._collect_body(*args, actions)
        carry, self.out, self._masks, self._rnn, self._rnnc, tr = res
        self.bstate = self._fused.unpack(carry)
        return tr

    def _collect_body(self, carry, out, masks, rnn, rnnc,
                      actions: Optional[torch.Tensor] = None):
        """The collect's T steps from the collector's ``carry``, the last
        output, the masks and the hidden states: the loop that the CPU runs
        and the card captures.  Returns them advanced, and the trajectory."""
        cfg, N, A = self.cfg, self.n_local, self.A
        B, T, dev = N * A, cfg.episode_length, self.device
        rows = (self._rows.start * A, self.N * A)
        recurrent = self.policy.recurrent
        env = self.env
        tr = {
            "share_obs": torch.empty((T, B, env.state_size), dtype=out.state_obs.dtype,
                                     device=dev),
            "obs": torch.empty((T, B, env.obs_size), dtype=out.obs.dtype, device=dev),
            "actions": torch.empty((T, B), dtype=torch.int32, device=dev),
            "logp": torch.empty((T, B), device=dev),
            "values": torch.empty((T, B), device=dev),
            "rewards": torch.empty((T, B), device=dev),
            "masks": torch.empty((T, B), device=dev),
            "active": torch.empty((T, B), device=dev),
            "avail": torch.empty((T, B, env.num_actions), dtype=torch.bool, device=dev),
            "done": torch.empty((T, N), dtype=torch.bool, device=dev),
        }
        if recurrent:
            tr["rnn"] = torch.empty((T,) + self._rnn_shape, device=dev)
            tr["rnnc"] = torch.empty((T,) + self._rnn_shape, device=dev)
        with torch.no_grad():
            for t in range(T):
                obs = out.obs.reshape(B, -1)  # the env's dtype; the bases cast
                sobs = out.state_obs.reshape(B, -1)
                avail = out.action_mask.reshape(B, -1)
                injected = None if actions is None else actions[t].reshape(B).to(
                    device=dev, dtype=torch.int32)
                values, act, logp, rnn2, rnnc2 = self.policy.get_actions(
                    sobs, obs, rnn, rnnc, masks, avail, generator=self.sample_gen,
                    actions=injected, rows=rows)
                carry, out2 = self._fused.step(carry, act.reshape(N, A))
                done_b = out2.done[:, None].expand(N, A).reshape(B)
                masks2 = 1.0 - done_b.float()
                if recurrent:
                    tr["rnn"][t], tr["rnnc"][t] = rnn, rnnc
                    # reset the hidden states where an episode ended
                    rnn, rnnc = rnn2 * masks2[:, None, None], rnnc2 * masks2[:, None, None]
                for k, v in (("share_obs", sobs), ("obs", obs), ("actions", act), ("logp", logp),
                             ("values", values), ("rewards", out2.reward.reshape(B)), ("masks", masks),
                             ("active", out.active.reshape(B)), ("avail", avail),
                             ("done", out2.done)):
                    tr[k][t] = v
                masks, out = masks2, out2
        return carry, out, masks, rnn, rnnc, tr

    def _compute(self, buf: MAPPOBuffer) -> MAPPOBuffer:
        B = self.n_local * self.A
        with torch.no_grad():
            next_value = self.policy.get_values(self.out.state_obs.reshape(B, -1),
                                                self._rnnc, self._masks)
        vn = self.trainer.vn if (self.cfg.use_popart or self.cfg.use_valuenorm) else None
        return compute_returns(buf, next_value.reshape(B), vn, self.cfg.gamma,
                               self.cfg.gae_lambda, self.cfg.use_gae,
                               self.cfg.use_proper_time_limits, scan=self._returns_graph)

    def _tr_to_buffer(self, tr: Dict[str, torch.Tensor], final_masks: torch.Tensor,
                      final_active: torch.Tensor) -> MAPPOBuffer:
        cfg, env, N, A = self.cfg, self.env, self.n_local, self.A
        L, H = self._rnn_shape[1:]
        buf = init_buffer(cfg.episode_length, N, A, env.obs_size, env.state_size,
                          env.num_actions, L, H, obs_dtype=env.obs_dtype, device=self.device)
        buf.share_obs[:-1] = tr["share_obs"]
        buf.obs[:-1] = tr["obs"]
        if "rnn" in tr:
            buf.rnn_states[:-1] = tr["rnn"]
            buf.rnn_states_critic[:-1] = tr["rnnc"]
        buf.actions.copy_(tr["actions"])
        buf.action_log_probs.copy_(tr["logp"])
        buf.value_preds[:-1] = tr["values"]
        buf.rewards.copy_(tr["rewards"])
        # slot T takes the mask after the last step, as the reference's
        # insert writes masks[step + 1] every step: a horizon-aligned episode
        # must not bootstrap from the next episode's first obs
        buf.masks[:-1] = tr["masks"]
        buf.masks[-1] = final_masks.reshape(N * A)
        buf.active_masks[:-1] = tr["active"]
        buf.active_masks[-1] = final_active.reshape(N * A)
        buf.available_actions[:-1] = tr["avail"]
        return buf

    def update(self, episode: int, episodes: int, actions: Optional[torch.Tensor] = None,
               perms=None):
        """One update: collect, compute, train.  ``actions`` and ``perms``,
        where given, replace the sampled actions (``_collect``) and the
        minibatch permutations (``trainer.train``), so that tests drive both
        packages alike.  Returns (train info, the average episode score: seat
        0's reward summed over the rollout, per env of the whole batch).
        Traced as an ``update`` span (``utils/tracing.py``) tiled by
        ``collect``, ``buffer``, ``compute``, ``train`` and ``score_read``."""
        dev = self.device
        with tracing.span("update", dev, update=True, tiled=True):
            lrs = self.policy.lr_for(episode, episodes)
            with tracing.span("collect", dev):
                tr = self._collect(actions)
            with tracing.span("buffer", dev):
                buf = self._tr_to_buffer(tr, self._masks, self.out.active.float())
            with tracing.span("compute", dev):
                buf = self._compute(buf)
            with tracing.span("train", dev):
                info = self.trainer.train(buf, lrs, perms)
            with tracing.span("score_read", dev):
                seat0 = tr["rewards"].reshape(-1, self.n_local, self.A)[:, :, 0].sum()
                ep_rew = float(all_sum(self.mesh, seat0, "metrics")) / self.N
        return info, ep_rew

    # ------------------------------------------------------------------
    def run(self, episodes: Optional[int] = None, log=print):
        cfg = self.cfg
        steps_per_episode = cfg.episode_length * self.N
        if episodes is None:
            episodes = int(cfg.num_env_steps) // steps_per_episode
        t0 = time.time()
        info = None
        for ep in range(episodes):
            info, ep_rew = self.update(ep, episodes)
            self.episode_rewards.append(ep_rew)
            steps = (ep + 1) * steps_per_episode
            if self.logger is not None:
                self.logger.add_scalar("mappo/average_episode_rewards", ep_rew, steps)
                for k, v in info.items():
                    self.logger.add_scalar(f"mappo/{k}", float(v), steps)
                self.logger.flush()
            if log is not None and is_primary() and ((ep + 1) % cfg.log_interval == 0
                                                     or ep == episodes - 1):
                fps = steps / (time.time() - t0)
                log(f"episode {ep + 1}/{episodes} steps={steps} avg_ep_reward={ep_rew:.2f} "
                    f"vloss={float(info['value_loss']):.4f} "
                    f"ent={float(info['dist_entropy']):.3f} FPS={fps:,.0f}")
            if self.run_dir and (ep + 1) % cfg.save_interval == 0:
                self.save()
            if cfg.use_eval and (ep + 1) % cfg.eval_interval == 0:
                score = self.evaluate(episodes=max(1, cfg.eval_episodes // self.N))
                if self.logger is not None:
                    self.logger.add_scalar("mappo/eval_score", score, steps)
                    self.logger.flush()
                if log is not None and is_primary():
                    log(f"eval @ episode {ep + 1}: deterministic score {score:.3f}")
        return info

    # ---- checkpoints (JAX runner.py save/restore) ----------------------
    def save(self, path: Optional[str] = None) -> None:
        """Write both nets' parameters, both optimizer states and the
        ValueNorm statistics to ``<path or run_dir>/checkpoint.pt``, so that a
        restored run resumes training rather than restarting Adam, and the
        nets' ``ModelConfig``, so that an exporter rebuilds the actor as
        trained (the activation leaves no parameter).  Rank 0 writes."""
        pol, vn = self.policy, self.trainer.vn
        if is_primary():
            save_pytree(os.path.join(path or self.run_dir, "checkpoint.pt"), {
                "model_config": dataclasses.asdict(pol.mc),
                "actor_params": pol.actor.state_dict(),
                "critic_params": pol.critic.state_dict(),
                "actor_opt": pol.actor_opt.state_dict(),
                "critic_opt": pol.critic_opt.state_dict(),
                "vn": {f.name: getattr(vn, f.name) for f in dataclasses.fields(vn)},
            })
        if self.mesh is not None:
            self.mesh.barrier()

    def restore(self, path: Optional[str] = None) -> None:
        """Load a ``save``, written on the card or on the CPU; a checkpoint
        without the optimizer states (parameters and ValueNorm only) keeps
        the runner's own.  Everything is copied in place into the tensors
        a captured ``train`` steps.  Rank 0 reads."""
        file = os.path.join(path or self.run_dir, "checkpoint.pt")
        if self.mesh is None:
            blob = load_pytree(file)
        else:
            blob = self.mesh.broadcast_object(load_pytree(file) if is_primary() else None)
        pol = self.policy
        pol.actor.load_state_dict(blob["actor_params"])
        pol.critic.load_state_dict(blob["critic_params"])
        if "actor_opt" in blob:
            load_optimizer_state_(pol.actor_opt, blob["actor_opt"])
            load_optimizer_state_(pol.critic_opt, blob["critic_opt"])
        vn_copy_(self.trainer.vn, ValueNormState(**blob["vn"]))

    # ---- deterministic eval (train/tester.py analog) ------------------
    def evaluate(self, episodes: int = 1, deterministic: bool = True) -> float:
        """Average episode score over ``episodes * episode_length`` steps of
        fresh envs (episodes from 10,000,000 on), seat 0's reward summed, per
        episode and env.  Steps through the env's collector where it has one,
        whose outputs equal ``batched_step``'s.  The actor starts from zero
        states and carries them, zeroed where an episode ended, as
        ``_collect`` does.  On a captured runner one ``episode_length``
        block is a graph, replayed ``episodes`` times; the score stays on
        the card until the end.  On a mesh rank 0 runs it over the whole
        batch and every rank returns its score."""
        if self.mesh is not None:
            score = self._evaluate(episodes, deterministic) if is_primary() else None
            return self.mesh.broadcast_object(score)
        return self._evaluate(episodes, deterministic)

    def _evaluate(self, episodes: int, deterministic: bool) -> float:
        cfg, N, A, dev = self.cfg, self.N, self.A, self.device
        B = N * A
        collect = self._eval_fused
        bstate, out = batched_reset(self.env, N, start_episode=10_000_000, device=dev)
        self._eval_gen.manual_seed(cfg.seed + 777)
        block = functools.partial(self._eval_body, deterministic=deterministic)
        if captures(dev, collect):
            if deterministic not in self._eval_graphs:
                self._eval_graphs[deterministic] = LoopGraph(
                    block, [self._eval_gen], name="eval" if deterministic else "eval_sampled")
            block = self._eval_graphs[deterministic]
        carry = (collect.pack(bstate), out, self.policy.actor.zero_states(B, dev),
                 torch.ones((B,), device=dev), torch.zeros((), dtype=torch.float64, device=dev))
        for _ in range(episodes):
            carry = block(*carry)
        return float(carry[-1]) / (episodes * N)

    def _eval_body(self, carry, out, rnn, masks, total, deterministic: bool):
        """One ``episode_length`` block of ``evaluate``: the loop that the
        CPU runs and the card captures.  Returns its arguments advanced, the
        score summed into ``total``."""
        N, A = self.N, self.A
        B = N * A
        collect, actor = self._eval_fused, self.policy.actor
        with torch.no_grad():
            for _ in range(self.cfg.episode_length):
                obs, avail = out.obs.reshape(B, -1), out.action_mask.reshape(B, -1)
                logits, rnn = actor(obs, rnn, masks, avail)
                act = (torch.argmax(logits, -1).to(torch.int32) if deterministic
                       else dist_sample(self._eval_gen, logits))
                carry, out = collect.step(carry, act.reshape(N, A))
                total = total + out.reward[:, 0].sum(dtype=torch.float64)
                masks = 1.0 - out.done[:, None].expand(N, A).reshape(B).float()
                rnn = rnn * masks[:, None, None]
        return carry, out, rnn, masks, total

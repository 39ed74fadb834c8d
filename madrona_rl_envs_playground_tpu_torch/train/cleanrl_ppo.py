"""CleanRL-style PPO as a partner-pluggable VectorAgent.

Counterpart of ``madrona_rl_envs_playground_tpu/train/cleanrl_ppo.py``: the
rollout buffer, the active-masked GAE, plain GAE, and the decentralized
``CleanPPOAgent`` with its carry.  Behaviour follows the reference
``CleanPPOAgent`` (``pantheonrl_extension/vectoragent.py:116-372``), with
the multi-agent credit rules kept exactly:

* rewards received while inactive accumulate into the agent's **last active**
  buffer slot; rewards from before the agent's first action of an episode are
  dropped from returns (``new_game`` gating) but kept in the episodic-return
  stats (``vectoragent.py:197-216``);
* done flags OR-accumulate between recorded actions (``:205``);
* GAE skips steps where the agent did not act, bootstraps per env from the
  last active step, and marks as untrainable the final active step of any
  env whose next value was never observed (``:230-262``, including the
  reference's quirk of freezing advantage computation for already
  bootstrapped envs while *any* env remains unbootstrapped);
* update = ``update_epochs`` full-batch passes over the active rows (the
  reference's ``mb_inds = randperm(batch)`` covers the whole batch at once,
  ``:281``; ``num_minibatches`` is accepted and unused), with active-masked
  advantage normalization, clip/value-clip losses, entropy bonus, global-norm
  gradient clipping, optional target-KL early stop, and linear LR anneal
  (``:279-327``).

One deliberate divergence, as in JAX: the reference's inactive-reward
routing line ``self.rewards[self.last_active] += ...`` (``:203``) indexes a
[T, N] buffer with a per-env [N] row index, which in torch adds each env's
reward at *every* env's last-active row (cross-env contamination whenever
last_active differs between envs, i.e. turn-based play).  Here the reward
lands only in the env's own last-active slot, the intended semantics.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..api.agents import VectorAgent
from ..api.vectorobservation import VectorObservation
from ..device import DeviceLike, resolve_device
from ..models.cleanrl import CleanRLNetwork
from ..models.common import dist_entropy, dist_log_prob, dist_sample
from ..utils.checkpoint import load_pytree, save_pytree
from ..utils.logger import maybe_logger
from .graphs import LoopGraph, captures, tree_leaves, tree_map
from .optim import adam, clip_grad_global_norm_, load_optimizer_state_, set_lr, update_tensors


@dataclasses.dataclass(frozen=True)
class Rollout:
    obs: torch.Tensor                     # [T, M, obs]
    states: torch.Tensor                  # [T, M, state]
    actions: torch.Tensor                 # [T, M] int32
    action_masks: Optional[torch.Tensor]  # [T, M, A] bool
    logprobs: torch.Tensor                # [T, M] f32
    rewards: torch.Tensor                 # [T, M] f32
    dones: torch.Tensor                   # [T, M] bool
    active: Optional[torch.Tensor]        # [T, M] bool
    values: torch.Tensor                  # [T, M] f32


@dataclasses.dataclass
class AgentCarry:
    """The agent's device state between calls.  The buffers and the [N]
    fields are written in place; the two return statistics are 0-d."""

    buf: Rollout
    next_done: torch.Tensor        # [N] bool
    new_game: torch.Tensor         # [N] bool
    running_rewards: torch.Tensor  # [N] f32
    last_active: torch.Tensor      # [N] int64 (JAX: int32), a row of buf
    mean_return_sum: torch.Tensor  # [] f32
    num_returns: torch.Tensor      # [] int32


def init_carry(num_steps: int, num_envs: int, obs_size: int, state_size: int,
               num_actions: int, device: DeviceLike = None) -> AgentCarry:
    T, N, A = num_steps, num_envs, num_actions
    dev = resolve_device(device)
    zeros = lambda shape, dt: torch.zeros(shape, dtype=dt, device=dev)  # noqa: E731
    return AgentCarry(
        buf=Rollout(
            obs=zeros((T, N, obs_size), torch.float32),
            states=zeros((T, N, state_size), torch.float32),
            actions=zeros((T, N), torch.int32),
            action_masks=torch.ones((T, N, A), dtype=torch.bool, device=dev),
            logprobs=zeros((T, N), torch.float32),
            rewards=zeros((T, N), torch.float32),
            dones=zeros((T, N), torch.bool),
            active=zeros((T, N), torch.bool),
            values=zeros((T, N), torch.float32),
        ),
        next_done=zeros((N,), torch.bool),
        new_game=zeros((N,), torch.bool),
        running_rewards=zeros((N,), torch.float32),
        last_active=zeros((N,), torch.int64),
        mean_return_sum=zeros((), torch.float32),
        num_returns=zeros((), torch.int32),
    )


def active_masked_gae(buf: Rollout, next_value: torch.Tensor, next_done: torch.Tensor,
                      final_active: torch.Tensor, gamma: float, gae_lambda: float,
                      mesh=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's active-mask GAE loop (``vectoragent.py:230-262``) as a
    reverse loop over T.  A stream's active slot bootstraps from the
    stream's next active slot (or the final value where the stream is active
    after the rollout).  Scanning back from the end, while some stream has
    not been active yet, only a stream's first active slot is computed, and
    it is not trained; once every stream has been, every active slot is
    computed and trained.  "Every stream" is the whole batch: on a ``mesh``
    (this rank's streams) the ranks add up, in one all-reduce, the streams
    still waiting at each slot.  On the card the self-play trainer replays
    this loop inside its captured advantage scans (``train/selfplay.py``'s
    ``_scan_body``) and ``CleanPPOAgent`` inside its captured train; the
    mesh case stays eager, since masked envs on a mesh step the plain
    collector, which is never captured (``train/graphs.py``).
    Returns (advantages [T, M], returns [T, M], trainable active [T, M]
    bool)."""
    T = buf.values.shape[0]
    # the streams not yet bootstrapped when the scan reaches slot t: active
    # at no later slot and not after the rollout
    waiting = torch.empty((T,), dtype=torch.int64, device=final_active.device)
    booted = final_active
    for t in range(T - 1, -1, -1):
        waiting[t] = (~booted).sum()
        booted = booted | buf.active[t]
    if mesh is not None:
        waiting = mesh.all_reduce(waiting, what="gae")
    every_booted = waiting == 0
    bootstrapped = final_active
    nextnonterminal = torch.where(final_active, 1.0 - next_done.float(),
                                  torch.zeros_like(next_value))
    nextvalues = torch.where(final_active, next_value, torch.zeros_like(next_value))
    lastgaelam = torch.zeros_like(next_value)
    adv = torch.empty_like(buf.values)
    active_out = torch.empty_like(buf.active)
    for t in range(buf.values.shape[0] - 1, -1, -1):
        mask_t = buf.active[t]
        all_boot = every_booted[t]
        bootmask = mask_t & ~bootstrapped
        computemask = torch.where(all_boot, mask_t, bootmask)
        active_out[t] = mask_t & ~(bootmask & ~all_boot)
        bootstrapped = bootstrapped | mask_t
        delta = buf.rewards[t] + gamma * nextvalues * nextnonterminal - buf.values[t]
        cand = delta + gamma * gae_lambda * nextnonterminal * lastgaelam
        lastgaelam = torch.where(computemask, cand, lastgaelam)
        adv[t] = torch.where(computemask, cand, torch.zeros_like(cand))
        nextnonterminal = torch.where(mask_t, 1.0 - buf.dones[t].float(), nextnonterminal)
        nextvalues = torch.where(mask_t, buf.values[t], nextvalues)
    return adv, adv + buf.values, active_out


def plain_gae(rewards: torch.Tensor, dones: torch.Tensor, values: torch.Tensor,
              next_value: torch.Tensor, next_done: torch.Tensor,
              gamma: float, gae_lambda: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Standard GAE over [T, M] buffers as a reverse loop over T.

    ``dones[t]`` is the done delivered before slot t; ``next_done`` and
    ``next_value`` follow the last slot.  Returns (advantages, returns).
    The JAX version evaluates the same recurrence with an associative scan,
    so the two agree to float32 reassociation.
    """
    nnt = 1.0 - torch.cat([dones[1:].float(), next_done.float()[None]], 0)
    nv = torch.cat([values[1:], next_value[None]], 0)
    delta = rewards + gamma * nv * nnt - values
    coeff = gamma * gae_lambda * nnt
    adv = torch.empty_like(delta)
    last = torch.zeros_like(delta[0])
    for t in range(delta.shape[0] - 1, -1, -1):
        last = delta[t] + coeff[t] * last
        adv[t] = last
    return adv, adv + values


class CleanPPOAgent(VectorAgent):
    """Counterpart of JAX's ``CleanPPOAgent`` (the reference agent).

    It works on the env's device (``envs.device``), samples with its own
    ``torch.Generator`` there (seeded with ``seed``; the network's
    parameters come from a CPU generator of the same seed), and keeps its
    metrics as tensors, read to the host only when a logger exists.  Its
    device functions are JAX's jitted ones: ``_act`` (recording or not),
    ``_update_impl`` (the reward credit) and ``_train_impl`` (the masked
    GAE and the epochs, a ``target_kl`` stop selected on the device).  None
    of them reads the host: they write the carry, the buffer row ``_t`` (a
    device scalar; the host keeps ``step`` for the train boundary), the
    parameters, gradients and Adam's state in place.  So on a CUDA device
    each is captured as a CUDA graph at its first call and replayed on
    every later one (``train/graphs.py``); the CPU runs them eagerly.  What
    the agent hands its caller (actions, each train's metrics) stays as it
    was: a replay's outputs are cloned."""

    def __init__(
        self,
        envs,
        name: str,
        num_updates: int,
        verbose: bool = True,
        run_dir: Optional[str] = None,
        seed: int = 0,
        lr: float = 2.5e-4,
        num_steps: int = 128,
        anneal_lr: bool = True,
        gamma: float = 0.99,
        gae_lambda: float = 0.95,
        num_minibatches: int = 4,
        update_epochs: int = 4,
        norm_adv: bool = True,
        clip_coef: float = 0.2,
        clip_vloss: bool = True,
        ent_coef: float = 0.01,
        vf_coef: float = 0.5,
        max_grad_norm: float = 0.5,
        target_kl: Optional[float] = None,
        hidden: int = 512,
    ):
        self.envs = envs
        self.device = resolve_device(envs.device)
        self.num_envs = envs.num_envs
        self.name = name
        self.verbose = verbose
        self.lr = lr
        self.num_steps = num_steps
        self.anneal_lr = anneal_lr
        self.gamma = gamma
        self.gae_lambda = gae_lambda
        self.update_epochs = update_epochs
        self.norm_adv = norm_adv
        self.clip_coef = clip_coef
        self.clip_vloss = clip_vloss
        self.ent_coef = ent_coef
        self.vf_coef = vf_coef
        self.max_grad_norm = max_grad_norm
        self.target_kl = target_kl

        obs_size = int(np.prod(envs.observation_space.shape))
        state_size = int(np.prod(envs.share_observation_space.shape))
        self.num_actions = envs.action_space.n

        self.net = CleanRLNetwork(obs_size, self.num_actions, hidden, state_size=state_size,
                                  generator=torch.Generator().manual_seed(seed)).to(self.device)
        self.opt = adam(self.net.parameters(), lr, eps=1e-5)
        self.sample_gen = torch.Generator(device=self.device).manual_seed(seed)

        self.carry = init_carry(num_steps, self.num_envs, obs_size, state_size,
                                self.num_actions, self.device)
        self._t = torch.zeros((), dtype=torch.int64, device=self.device)
        self._all_legal = torch.ones((self.num_envs, self.num_actions), dtype=torch.bool,
                                     device=self.device)
        self._envs_ar = torch.arange(self.num_envs, device=self.device)
        self._pre_step: Optional[List[torch.Tensor]] = None  # a target_kl stop's copies

        self._record_graph = self._sample_graph = self._update_graph = self._train_graph = None
        if captures(self.device):
            self._record_graph = LoopGraph(functools.partial(self._act, record=True),
                                           [self.sample_gen], owner=self, name="act_record")
            self._sample_graph = LoopGraph(functools.partial(self._act, record=False),
                                           [self.sample_gen], owner=self, name="act_sample")
            self._update_graph = LoopGraph(self._update_impl, owner=self, name="credit")
            self._train_graph = LoopGraph(self._train_impl, owner=self, name="train")

        self.global_step = 0
        self._step = 0
        self.num_updates = num_updates
        self.updates = 1
        self.start_time = time.time()
        self.logger = maybe_logger(run_dir or f"runs/{name}", verbose)
        self._last_metrics: Optional[Dict[str, torch.Tensor]] = None

    @property
    def step(self) -> int:
        """The rollout step of the next recorded action: the host's copy of
        the buffer row ``_t``, which the device functions advance and
        reset.  Assigning it sets both."""
        return self._step

    @step.setter
    def step(self, value: int) -> None:
        self._step = value
        self._t.fill_(value)

    @property
    def captured(self) -> bool:
        """Whether the device functions replay CUDA graphs (on a CUDA device)."""
        return self._train_graph is not None

    def carry_state(self) -> List[torch.Tensor]:
        """What an act and a reward credit write in place: the carry's
        tensors and the buffer row ``_t``."""
        return tree_leaves(self.carry) + [self._t]

    def update_state(self) -> List[torch.Tensor]:
        """What a train writes in place: the parameters, their gradients,
        Adam's moments, step counts and learning rate
        (``train/optim.py``'s ``update_tensors``), then ``carry_state``."""
        return update_tensors([self.net], [self.opt]) + self.carry_state()

    # ---------------- device functions --------------------------------
    @torch.no_grad()
    def _act(self, obs, state, action_mask, active, record: bool):
        obs_f, state_f = obs.float(), state.float()
        logits, value = self.net(obs_f, state_f, action_mask)
        action = dist_sample(self.sample_gen, logits)
        if not record:
            return action
        c, t = self.carry, self._t
        buf = c.buf
        row = t.view(1)
        for dst, src in ((buf.obs, obs_f), (buf.states, state_f), (buf.actions, action),
                         (buf.action_masks, action_mask),
                         (buf.logprobs, dist_log_prob(logits, action)), (buf.values, value),
                         (buf.dones, c.next_done), (buf.active, active)):
            dst.index_copy_(0, row, src.to(dst.dtype)[None])
        buf.rewards.index_fill_(0, row, 0.0)
        c.next_done.zero_()
        c.last_active.copy_(torch.where(active, t, c.last_active))
        c.new_game &= ~active
        return action

    @torch.no_grad()
    def _update_impl(self, rewards, dones):
        c = self.carry
        rewards = rewards.to(device=self.device, dtype=torch.float32).reshape(-1)
        dones = dones.to(device=self.device, dtype=torch.bool).reshape(-1)
        running = c.running_rewards + rewards
        add = torch.where(c.new_game, torch.zeros_like(rewards), rewards)
        # each env's (last_active, env) slot is distinct, so the sum is exact
        c.buf.rewards.view(-1).index_add_(0, c.last_active * self.num_envs + self._envs_ar, add)
        any_done = dones.any()
        n_done = dones.sum()
        mean_done_ret = torch.where(
            any_done,
            torch.where(dones, running, torch.zeros_like(running)).sum()
            / torch.clamp(n_done, min=1),
            torch.zeros((), device=self.device))
        c.next_done |= dones
        c.running_rewards.copy_(torch.where(dones, torch.zeros_like(running), running))
        c.new_game |= dones
        c.mean_return_sum += mean_done_ret
        c.num_returns += any_done.to(torch.int32)
        self._t += 1

    def _loss(self, b):
        logits, newvalue = self.net(b["obs"], b["states"], b["masks"])
        newlogprob = dist_log_prob(logits, b["actions"])
        entropy = dist_entropy(logits)
        logratio = newlogprob - b["logprobs"]
        ratio = torch.exp(logratio)
        mean, adv = b["mean"], b["adv"]

        pg1 = -adv * ratio
        pg2 = -adv * torch.clamp(ratio, 1 - self.clip_coef, 1 + self.clip_coef)
        pg_loss = mean(torch.maximum(pg1, pg2))

        if self.clip_vloss:
            v_unclipped = (newvalue - b["returns"]) ** 2
            v_clipped_val = b["values"] + torch.clamp(
                newvalue - b["values"], -self.clip_coef, self.clip_coef)
            v_loss = 0.5 * mean(torch.maximum(v_unclipped, (v_clipped_val - b["returns"]) ** 2))
        else:
            v_loss = 0.5 * mean((newvalue - b["returns"]) ** 2)

        ent_loss = mean(entropy)
        total = pg_loss - self.ent_coef * ent_loss + v_loss * self.vf_coef
        approx_kl = mean((ratio - 1) - logratio)
        old_kl = mean(-logratio)
        clipfrac = mean((torch.abs(ratio - 1.0) > self.clip_coef).float())
        return total, torch.stack([pg_loss, v_loss, ent_loss, approx_kl, old_kl,
                                   clipfrac]).detach()

    def _optimizer_step(self, stopped: Optional[torch.Tensor]) -> None:
        """Adam's step; where ``stopped`` (a device bool) is set, the step
        is computed and dropped: what it writes (the parameters and Adam's
        state) is selected back from copies taken before it (JAX's
        ``epoch_body``)."""
        if stopped is None:
            self.opt.step()
            return
        state = update_tensors([self.net], [self.opt])
        with torch.no_grad():
            if self._pre_step is None:
                self._pre_step = [torch.empty_like(x) for x in state]
            for h, x in zip(self._pre_step, state, strict=True):
                h.copy_(x)
            self.opt.step()
            for h, x in zip(self._pre_step, state, strict=True):
                x.copy_(torch.where(stopped, h, x))

    def _train_impl(self, final_state, final_active) -> Dict[str, torch.Tensor]:
        """The train at a rollout's end: GAE, the epochs and the metrics,
        at the learning rate ``set_lr`` gave the optimizer."""
        c = self.carry
        buf = c.buf
        with torch.no_grad():
            next_value = self.net.get_value(final_state.float())
        advantages, returns, active = active_masked_gae(
            buf, next_value, c.next_done, final_active.to(torch.bool),
            self.gamma, self.gae_lambda)

        T, N = buf.logprobs.shape
        flat = lambda x: x.reshape((T * N,) + tuple(x.shape[2:]))  # noqa: E731
        b_adv, b_returns, b_values = flat(advantages), flat(returns), flat(buf.values)
        b_active = flat(active).float()
        n_active = torch.clamp(b_active.sum(), min=1.0)

        def masked_mean(x):
            return (x * b_active).sum() / n_active

        if self.norm_adv:
            adv_mean = masked_mean(b_adv)
            adv_var = masked_mean((b_adv - adv_mean) ** 2)
            # torch .std() is Bessel-corrected
            adv_std = torch.sqrt(adv_var * n_active / torch.clamp(n_active - 1.0, min=1.0))
            b_adv = (b_adv - adv_mean) / (adv_std + 1e-8)

        batch = {"obs": flat(buf.obs), "states": flat(buf.states),
                 "actions": flat(buf.actions), "masks": flat(buf.action_masks),
                 "logprobs": flat(buf.logprobs), "adv": b_adv, "returns": b_returns,
                 "values": b_values, "mean": masked_mean}

        # each epoch is one full-batch step (JAX's epoch_body); once an
        # epoch's pre-update approx_kl exceeds target_kl, the later epochs'
        # steps are dropped on the device (their losses still make the
        # metrics).  The gradients are zeroed in place, so that a replay
        # writes the tensors the captured step reads.
        stopped = None
        auxes = []
        for _ in range(self.update_epochs):
            loss, aux = self._loss(batch)
            self.opt.zero_grad(set_to_none=False)
            loss.backward()
            clip_grad_global_norm_(self.net.parameters(), self.max_grad_norm)
            self._optimizer_step(stopped)
            if self.target_kl is not None:
                exceeded = aux[3] > self.target_kl
                stopped = exceeded if stopped is None else stopped | exceeded
            auxes.append(aux)
        auxes = torch.stack(auxes)

        with torch.no_grad():
            var_y = masked_mean((b_returns - masked_mean(b_returns)) ** 2)
            resid = masked_mean((b_returns - b_values - masked_mean(b_returns - b_values)) ** 2)
            explained_var = torch.where(var_y > 0, 1.0 - resid / var_y,
                                        torch.full_like(var_y, float("nan")))
            mean_return = torch.where(
                c.num_returns > 0,
                c.mean_return_sum / torch.clamp(c.num_returns, min=1),
                torch.full_like(c.mean_return_sum, float("nan")))
            c.mean_return_sum.zero_()
            c.num_returns.zero_()
            self._t.zero_()
        return {
            "pg_loss": auxes[-1, 0],
            "v_loss": auxes[-1, 1],
            "entropy": auxes[-1, 2],
            "approx_kl": auxes[-1, 3],
            "old_approx_kl": auxes[-1, 4],
            "clipfrac": auxes[:, 5].mean(),
            "explained_variance": explained_var,
            "mean_return": mean_return,
        }

    # ---------------- host interface ----------------------------------
    def get_action(self, obs: VectorObservation, record: bool = True) -> torch.Tensor:
        if self.global_step > 0 and self.global_step % self.num_steps == 0 and record:
            self._step = 0  # the train resets _t
            lr = (
                self.lr * (1.0 - (self.updates - 1.0) / self.num_updates)
                if self.anneal_lr
                else self.lr
            )
            set_lr(self.opt, lr)
            metrics = _replayed(self._train_graph, self._train_impl, obs.state, obs.active)
            self._last_metrics = metrics
            if self.logger is not None:
                for k, v in metrics.items():
                    v = float(v)
                    if not np.isnan(v):
                        tag = "charts/episodic_return" if k == "mean_return" else f"losses/{k}"
                        self.logger.add_scalar(tag, v, self.global_step)
                self.logger.add_scalar(
                    "charts/SPS",
                    int(self.global_step * self.num_envs / (time.time() - self.start_time)),
                    self.global_step,
                )
                self.logger.flush()
            self.updates += 1

        if record and self._step >= self.num_steps:
            raise IndexError(f"{self.name}: a recorded action at step {self._step} of a "
                             f"{self.num_steps}-step rollout")
        mask = obs.action_mask if obs.action_mask is not None else self._all_legal
        graph = self._record_graph if record else self._sample_graph
        return _replayed(graph, functools.partial(self._act, record=record),
                         obs.obs, obs.state, mask, obs.active)

    def update(self, rewards: torch.Tensor, dones: torch.Tensor) -> None:
        _replayed(self._update_graph, self._update_impl, rewards, dones)
        self._step += 1  # the reward credit advances _t
        self.global_step += 1

    # ---- checkpointing -------------------------------------------------
    def save(self, path: str) -> None:
        """The network, Adam, the sampler's generator state and the update
        and step counters (JAX saves params, opt_state, updates and
        global_step; its key is not saved, the generator state is here)."""
        save_pytree(path, {
            "net": self.net.state_dict(),
            "opt": self.opt.state_dict(),
            "sample_gen": self.sample_gen.get_state(),
            "updates": self.updates,
            "global_step": self.global_step,
        })

    def load(self, path: str) -> None:
        """Restore a ``save``, written on the card or on the CPU, into the
        tensors the graphs step: the parameters and Adam's state are copied
        in place (``load_optimizer_state_``), so a captured agent is not
        captured again.  The sampler's state is taken where it was saved on
        the same kind of device; the card's generator (Philox) and the
        CPU's (Mersenne Twister) draw different streams, so across devices
        the agent keeps its own."""
        blob = load_pytree(path)
        self.net.load_state_dict(blob["net"])
        load_optimizer_state_(self.opt, blob["opt"])
        gen_state = blob["sample_gen"]
        if gen_state.shape == self.sample_gen.get_state().shape:
            self.sample_gen.set_state(gen_state)
        self.updates = blob["updates"]
        self.global_step = blob["global_step"]


def _replayed(graph: Optional[LoopGraph], body: Callable, *args):
    """``body(*args)``, or where the agent holds ``graph`` (on the card) its
    replay, whose outputs, the graph's own buffers, are cloned: the next
    replay overwrites them."""
    if graph is None:
        return body(*args)
    return tree_map(torch.clone, graph(*args))


def run_decentralized(venv, ego: CleanPPOAgent, num_env_steps: int,
                      on_update: Optional[Callable[[int, Dict[str, torch.Tensor]], None]] = None,
                      max_seconds: Optional[float] = None) -> List[Dict[str, torch.Tensor]]:
    """The loop of the decentralized training CLIs (JAX's
    ``scripts/cartpole_train.py``, ``balance_train.py``, ``hanabi_train.py``):
    reset ``venv``, then ``num_env_steps`` times ``ego.get_action``,
    ``venv.step`` (which drives and updates the partners) and
    ``ego.update``.  ``ego`` trains inside ``get_action`` at every
    ``num_steps`` boundary but the first, so ``num_updates * num_steps``
    steps give ``num_updates - 1`` trains, as in JAX.  After each train
    ``on_update(update, metrics)`` is called.  Stops early once
    ``max_seconds`` of wall-clock have passed.  Returns each train's
    metrics."""
    curve = []
    obs = venv.reset()
    t0 = time.time()
    for _ in range(num_env_steps):
        if max_seconds is not None and time.time() - t0 > max_seconds:
            break
        act = ego.get_action(obs)
        obs, rew, done, _ = venv.step(act)
        ego.update(rew, done)
        if ego._last_metrics is not None and ego.step == 1:
            curve.append(ego._last_metrics)
            if on_update is not None:
                on_update(ego.updates - 1, ego._last_metrics)
    return curve

"""Vectorized multi-agent environment API (PantheonRL-style, on the device).

Counterpart of ``madrona_rl_envs_playground_tpu/api/vectorenv.py`` and of the
reference's ``VectorMultiAgentEnv`` (``pantheonrl_extension/
vectorenv.py:26-255``): the ego/partner seat split, per-seat partner lists
with round-robin or random resampling, ``step(ego_action)`` that gathers the
partners' actions, advances every world and routes each seat's rewards back
to its partner agent, and abstract ``n_step``/``n_reset``.

``DeviceVecEnv`` is the counterpart of JAX's ``TpuVecEnv`` and of the
reference's ``MadronaEnv`` adapter (``vectorenv.py:262-346``): it steps the
env through its collector (``train/fused_collect.py``: the env's step kernel
on the card, its plain version on the CPU), replayed from a CUDA graph on
the card as JAX jits ``Simulator.step``, and its per-seat views are axis-1
slices of the batched ``StepOutput``.

``SyncVectorEnv`` (``vectorenv.py:348-425`` analog) drives N host-side
oracle envs in a Python loop with auto-reset: the differential harness, not
a performance path.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.batch import batched_reset
from ..core.types import BatchState, StepOutput
from ..device import DeviceLike, resolve_device
from ..train.fused_collect import make_fused_collect
from ..train.graphs import LoopGraph, captures, tree_map
from .agents import VectorAgent
from .spaces import Box, Discrete, MultiBinary
from .vectorobservation import VectorObservation


class PlayerException(Exception):
    """Raised when players in the environment are incorrectly set."""


class VectorMultiAgentEnv(ABC):
    def __init__(
        self,
        num_envs: int,
        ego_ind: int = 0,
        n_players: int = 2,
        resample_policy: str = "default",
        partners: Optional[List[List[VectorAgent]]] = None,
    ):
        self.num_envs = num_envs
        self.ego_ind = ego_ind
        self.n_players = n_players

        if partners is not None:
            if len(partners) != n_players - 1:
                raise PlayerException(
                    "The number of partners needs to equal the number of non-ego players"
                )
            for plist in partners:
                if not isinstance(plist, list) or not plist:
                    raise PlayerException("Sublist for each partner must be nonempty list")
        self.partners = partners or [[] for _ in range(n_players - 1)]
        self.partnerids = [0] * (n_players - 1)
        self._obs: Tuple[Optional[VectorObservation], ...] = tuple()
        self.set_resample_policy(resample_policy)

    # -- partner management (reference vectorenv.py:110-144) ---------------
    def _get_partner_num(self, player_num: int) -> int:
        if player_num == self.ego_ind:
            raise PlayerException("Ego agent is not set by the environment")
        if player_num > self.ego_ind:
            return player_num - 1
        return player_num

    def add_partner_agent(self, agent: VectorAgent, player_num: int = 1) -> None:
        self.partners[self._get_partner_num(player_num)].append(agent)

    def set_partnerid(self, agent_id: int, player_num: int = 1) -> None:
        partner_num = self._get_partner_num(player_num)
        assert 0 <= agent_id < len(self.partners[partner_num])
        self.partnerids[partner_num] = agent_id

    def resample_random(self) -> None:
        self.partnerids = [np.random.randint(len(plist)) for plist in self.partners]

    def resample_round_robin(self) -> None:
        self.partnerids = [(self.partnerids[0] + 1) % len(self.partners[0])]

    def set_resample_policy(self, resample_policy: str) -> None:
        if resample_policy == "default":
            resample_policy = "robin" if self.n_players == 2 else "random"
        if resample_policy == "robin" and self.n_players != 2:
            raise PlayerException("Cannot do round robin resampling for >2 players")
        if resample_policy == "robin":
            self.resample_partner = self.resample_round_robin
        elif resample_policy == "random":
            self.resample_partner = self.resample_random
        else:
            raise PlayerException(f"Invalid resampling policy: {resample_policy}")

    # -- step/reset loop (reference vectorenv.py:146-213) ------------------
    def _get_actions(self, obs, ego_act) -> torch.Tensor:
        actions = []
        for player in range(self.n_players):
            if player == self.ego_ind:
                actions.append(ego_act)
            else:
                p = self._get_partner_num(player)
                agent = self.partners[p][self.partnerids[p]]
                actions.append(agent.get_action(obs[player]))
        return torch.stack(actions)

    def _update_players(self, rews: torch.Tensor, done: torch.Tensor) -> None:
        for i in range(self.n_players - 1):
            playernum = i + (0 if i < self.ego_ind else 1)
            self.partners[i][self.partnerids[i]].update(rews[playernum], done)

    def step(self, action: torch.Tensor):
        """One timestep from the ego seat's perspective.

        Returns (ego_obs: VectorObservation, ego_rew [N], done [N], info).
        """
        acts = self._get_actions(self._obs, action)
        self._obs, rews, done, info = self.n_step(acts)
        self._update_players(rews, done)
        return self._obs[self.ego_ind], rews[self.ego_ind], done, info

    def reset(self) -> VectorObservation:
        self.resample_partner()
        self._obs = self.n_reset()
        return self._obs[self.ego_ind]

    @abstractmethod
    def n_step(self, actions: torch.Tensor):
        """actions [P, N] -> (obs: tuple of per-seat VectorObservation,
        rewards [P, N], done [N], info)."""

    @abstractmethod
    def n_reset(self) -> Tuple[VectorObservation, ...]:
        ...

    def close(self, **kwargs):
        pass


def _seat_views(out: StepOutput, n_players: int) -> Tuple[VectorObservation, ...]:
    return tuple(
        VectorObservation(
            active=out.active[:, p],
            obs=out.obs[:, p],
            state=out.state_obs[:, p],
            action_mask=out.action_mask[:, p],
        )
        for p in range(n_players)
    )


def _spaces(env):
    """(observation, share_observation, action) spaces, as JAX's
    ``TpuVecEnv`` builds them: ``Box`` for float32 observations,
    ``MultiBinary`` for any other dtype."""
    if env.obs_dtype == torch.float32:
        obs, share = Box(-np.inf, np.inf, (env.obs_size,)), Box(-np.inf, np.inf,
                                                               (env.state_size,))
    else:
        obs, share = MultiBinary((env.obs_size,)), MultiBinary((env.state_size,))
    return obs, share, Discrete(env.num_actions)


class DeviceVecEnv(VectorMultiAgentEnv):
    """On-device vector env over the env's collector: the counterpart of
    JAX's ``TpuVecEnv`` (the reference's ``MadronaEnv``).

    Each step goes through ``make_fused_collect(env, num_envs, device)``: the
    env's step kernel on the card (K1 for an Overcooked layout in its
    envelope, K5 Cartpole, K7 Balance Beam, K9 Acrobot, K3 two-player
    Hanabi), its plain version on the CPU, and ``batched_step`` where no
    kernel applies (as the collector says).  The batch is packed into the
    collector's layout at each reset and unpacked only where a caller reads
    ``bstate``.  Seat views are slices; rewards come back ``[P, N]`` (the
    reference transposes its (N, P) buffers the same way,
    ``vectorenv.py:306-317``).  ``device`` defaults to the card and raises
    without one unless it is ``"cpu"``.  ``sharding`` (JAX's, here a
    ``parallel.mesh.Mesh``) makes the env this rank's rows of the
    ``num_envs`` worlds, on the mesh's device, stepped through the mesh's
    collector (``core/batch.py``'s offsets; K1 for Overcooked): actions,
    seat views, rewards and dones are this rank's, and every rank steps and
    resets together.

    Where ``train/graphs.py``'s rule captures the collector (a kernel
    collector on the card), ``n_step`` replays a CUDA graph of
    ``_step_body`` (the action transpose and the step kernel) from its
    first call on, the carry passed in through the graph's input copy, and
    hands the caller clones of the step's outputs, which later steps leave
    as they are; the plain collector, ``reset`` and the ``bstate`` setter
    stay eager."""

    def __init__(
        self,
        env,
        num_envs: int,
        ego_ind: int = 0,
        resample_policy: str = "default",
        partners=None,
        sharding=None,
        start_episode: int = 0,
        device: DeviceLike = None,
    ):
        self.mesh = sharding
        super().__init__(
            num_envs if sharding is None else sharding.local_size(num_envs),
            ego_ind=ego_ind,
            n_players=env.num_agents,
            resample_policy=resample_policy,
            partners=partners,
        )
        self.env = env
        self.device = resolve_device(device) if sharding is None else sharding.device
        self._start_episode = start_episode
        self._global_envs = num_envs
        self._collect = make_fused_collect(env, num_envs, self.device, mesh=sharding)
        self._step_graph = None
        if captures(self.device, self._collect):
            self._step_graph = LoopGraph(self._step_body, owner=self, name="step")
        self.observation_space, self.share_observation_space, self.action_space = _spaces(env)
        self._reset_batch()

    @property
    def captured(self) -> bool:
        """Whether ``n_step`` replays a CUDA graph (``train/graphs.py``'s
        rule: a kernel collector on the card)."""
        return self._step_graph is not None

    def _reset_batch(self) -> StepOutput:
        bstate, self.last_out = batched_reset(self.env, self._global_envs, self._start_episode,
                                              device=self.device, mesh=self.mesh)
        self._carry = self._collect.pack(bstate)
        return self.last_out

    @property
    def bstate(self) -> BatchState:
        """The batch state in ``core/batch.py``'s layout (unpacked on read
        from a copy of the carry, which a replay overwrites, by every rank
        of a mesh together; assigning one packs it)."""
        return self._collect.unpack(tree_map(torch.clone, self._carry))

    @bstate.setter
    def bstate(self, bstate: BatchState) -> None:
        self._carry = self._collect.pack(bstate)

    def _step_body(self, carry, actions: torch.Tensor):
        """One step of every world from the collector's ``carry`` with the
        seats' ``actions`` [P, N]: the function that the CPU runs and the
        card captures.  Returns (carry', StepOutput)."""
        return self._collect.step(carry, actions.t().to(torch.int32))

    def n_step(self, actions: torch.Tensor):
        actions = actions.to(device=self.device, dtype=torch.int32)
        if self._step_graph is None:
            self._carry, out = self._step_body(self._carry, actions)
        else:
            self._carry, out = self._step_graph(self._carry, actions)
            out = tree_map(torch.clone, out)  # the graph's buffers: the next step rewrites them
        self.last_out = out
        return _seat_views(out, self.n_players), out.reward.t(), out.done, {}

    def n_reset(self) -> Tuple[VectorObservation, ...]:
        return _seat_views(self._reset_batch(), self.n_players)


class SyncVectorEnv(VectorMultiAgentEnv):
    """Host-side oracle vectorizer: N python envs stepped in a loop.

    Each oracle env must expose
    ``n_reset() -> (obs_list, mask_list, active_list)`` and
    ``n_step(actions) -> (obs_list, mask_list, active_list, rewards, done)``
    with per-seat numpy rows, plus ``num_agents``/``obs_size``/``num_actions``
    metadata (see the JAX package's ``oracles/adapters.py``).  Auto-resets on
    done like the reference (``vectorenv.py:369-371``).  The batches are
    delivered as tensors on ``device`` (default the card).
    """

    def __init__(self, env_fns, ego_ind: int = 0, resample_policy: str = "default",
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.envs = [fn() for fn in env_fns]
        proto = self.envs[0]
        super().__init__(
            len(self.envs),
            ego_ind=ego_ind,
            n_players=proto.num_agents,
            resample_policy=resample_policy,
        )
        self.env = proto

    def _pack(self, per_env):
        return pack_seats(per_env, self.n_players, self.device)

    def n_reset(self):
        return self._pack([e.n_reset() for e in self.envs])

    def n_step(self, actions: torch.Tensor):
        acts = np.asarray(torch.as_tensor(actions).cpu())
        per_env, rews, dones = [], [], []
        for i, e in enumerate(self.envs):
            obs_l, mask_l, act_l, rew, done = e.n_step(acts[:, i])
            if done:
                obs_l, mask_l, act_l = e.n_reset()
            per_env.append((obs_l, mask_l, act_l))
            rews.append(rew)
            dones.append(done)
        rews_a = torch.as_tensor(np.stack(rews, axis=1), device=self.device)
        return (self._pack(per_env), rews_a,
                torch.as_tensor(np.asarray(dones), device=self.device), {})


def pack_seats(per_env, n_players: int, device: torch.device) -> Tuple[VectorObservation, ...]:
    """Per-env ``(obs_list, mask_list, active_list)`` rows -> one
    ``VectorObservation`` per seat, batched over the envs on ``device``."""
    obs = np.stack([np.stack(o) for o, _, _ in per_env], axis=1)
    mask = np.stack([np.stack(m) for _, m, _ in per_env], axis=1)
    active = np.stack([np.stack(a) for _, _, a in per_env], axis=1)
    return tuple(
        VectorObservation(
            active=torch.as_tensor(active[p], device=device),
            obs=torch.as_tensor(obs[p], device=device),
            action_mask=torch.as_tensor(mask[p], device=device),
        )
        for p in range(n_players)
    )

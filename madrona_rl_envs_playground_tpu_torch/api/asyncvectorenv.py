"""Process-per-env oracle vectorizer.

Counterpart of ``madrona_rl_envs_playground_tpu/api/asyncvectorenv.py`` and
of the reference ``AsyncVectorEnv`` (``pantheonrl_extension/
asyncvectorenv.py``): one OS process per oracle env (``spawn`` context, as in
JAX), talking over ``mp.Pipe``.  Workers speak the same per-env protocol as
``SyncVectorEnv`` (``n_reset``/``n_step`` with per-seat rows, auto-reset on
done).

The env constructors are serialised with ``cloudpickle`` where it is
installed, so lambdas and closures work, and with ``pickle`` otherwise, which
takes module-level callables and ``functools.partial`` of them.
"""

from __future__ import annotations

import multiprocessing as mp
import pickle
from typing import Callable, List

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .vectorenv import VectorMultiAgentEnv, pack_seats

try:
    import cloudpickle as _dumper
except ImportError:
    _dumper = pickle


class CloudpickleWrapper:
    """Serialise an env constructor with cloudpickle where it is installed,
    else with pickle (reference ``:15-29``)."""

    def __init__(self, fn: Callable):
        self.fn = fn

    def __getstate__(self):
        return _dumper.dumps(self.fn)

    def __setstate__(self, blob):
        self.fn = pickle.loads(blob)


def _worker(remote, parent_remote, fn_wrapper):
    parent_remote.close()
    env = fn_wrapper.fn()
    try:
        while True:
            cmd, data = remote.recv()
            if cmd == "step":
                obs, mask, act, rew, done = env.n_step(data)
                if done:
                    obs, mask, act = env.n_reset()
                remote.send((obs, mask, act, rew, done))
            elif cmd == "reset":
                remote.send(env.n_reset())
            elif cmd == "close":
                remote.close()
                break
    except (KeyboardInterrupt, EOFError):
        pass


class AsyncVectorEnv(VectorMultiAgentEnv):
    """The batches are delivered as tensors on ``device`` (default the
    card)."""

    def __init__(self, env_fns: List[Callable], ego_ind: int = 0,
                 resample_policy: str = "default", context: str = "spawn",
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        proto = env_fns[0]()
        super().__init__(
            len(env_fns), ego_ind=ego_ind, n_players=proto.num_agents,
            resample_policy=resample_policy,
        )
        self.env = proto
        ctx = mp.get_context(context)
        self.remotes, self.work_remotes = zip(*[ctx.Pipe() for _ in env_fns])
        self.procs = []
        for wr, r, fn in zip(self.work_remotes, self.remotes, env_fns):
            p = ctx.Process(target=_worker, args=(wr, r, CloudpickleWrapper(fn)),
                            daemon=True)
            p.start()
            wr.close()
            self.procs.append(p)

    def _pack(self, per_env):
        return pack_seats(per_env, self.n_players, self.device)

    def n_reset(self):
        for r in self.remotes:
            r.send(("reset", None))
        return self._pack([r.recv() for r in self.remotes])

    def n_step(self, actions):
        acts = np.asarray(torch.as_tensor(actions).cpu())
        for i, r in enumerate(self.remotes):
            r.send(("step", acts[:, i]))
        results = [r.recv() for r in self.remotes]
        per_env = [(o, m, a) for o, m, a, _, _ in results]
        rews = torch.as_tensor(np.stack([r for _, _, _, r, _ in results], axis=1),
                               device=self.device)
        dones = torch.as_tensor(np.asarray([d for *_, d in results]), device=self.device)
        return self._pack(per_env), rews, dones, {}

    def close(self, **kwargs):
        for r in self.remotes:
            try:
                r.send(("close", None))
            except (BrokenPipeError, OSError):
                pass
        for p in self.procs:
            p.join(timeout=2)

"""Golden traces: record, load and diff rollouts field by field.

Counterpart of ``madrona_rl_envs_playground_tpu/utils/golden_trace.py``, with
the same dump format, so a trace written by either package loads in the
other: a trace that JAX records on the CPU replays here on the card, where
JAX is not installed.  ``diff_trace`` and ``record_trace`` step through the
env's collector (``train/fused_collect.py``): on the card its step kernel, on
the CPU the kernel's plain version; envs without a kernel take the plain
``batched_step``.  The summary names the route (``"kernel"`` or
``"plain"``).

Dump format (npz, one file per rollout)
---------------------------------------
``meta``        0-d ``str`` — JSON: {"env", "layout", "num_envs",
                "num_steps", "horizon", "num_players", "source", ...}
``obs0``        [N, P, F]    observation after reset
``actions``     [T, N, P]    int32 actions fed at each step
``obs``         [T, N, P, F] observation returned by step t (post-step)
``rewards``     [T, N, P]    float32
``dones``       [T, N]       bool (world-level done at step t)
``action_mask`` [T, N, P, A] bool, optional
``active``      [T, N, P]    bool, optional

``meta["env"]`` follows JAX's ``make_env_from_meta``: ``overcooked`` (or
``overcooked1``) is the v1 env, ``overcooked2`` (or ``overcooked-new``) the
v2 env.  JAX's ``serve_policy.py`` maps ``overcooked`` and
``overcooked-new`` the other way round; each module keeps its own mapping.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional

import numpy as np
import torch

from ..core.batch import batched_reset
from ..device import DeviceLike, resolve_device
from ..train.fused_collect import make_fused_collect

REQUIRED = ("obs0", "actions", "obs", "rewards", "dones")
OPTIONAL = ("action_mask", "active")


@dataclasses.dataclass
class Trace:
    meta: Dict
    obs0: np.ndarray
    actions: np.ndarray
    obs: np.ndarray
    rewards: np.ndarray
    dones: np.ndarray
    action_mask: Optional[np.ndarray] = None
    active: Optional[np.ndarray] = None


def save_trace(path: str, meta: Dict, **arrays) -> None:
    missing = [k for k in REQUIRED if k not in arrays]
    if missing:
        raise ValueError(f"trace missing required arrays: {missing}")
    np.savez_compressed(path, meta=json.dumps(meta), **arrays)


def load_trace(path: str) -> Trace:
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        kw = {k: z[k] for k in REQUIRED}
        for k in OPTIONAL:
            if k in z.files:
                kw[k] = z[k]
    t = Trace(meta=meta, **kw)
    T, N, P = t.actions.shape
    if t.obs.shape[:3] != (T, N, P) or t.obs0.shape[:2] != (N, P):
        raise ValueError(
            f"inconsistent trace shapes: actions {t.actions.shape}, "
            f"obs {t.obs.shape}, obs0 {t.obs0.shape}")
    return t


def make_env_from_meta(meta: Dict):
    """The port's env matching a trace's metadata."""
    name = meta["env"]
    from ..envs import balance_beam, cartpole, hanabi, overcooked, overcooked2

    if name in ("overcooked", "overcooked1"):
        return overcooked.make(meta.get("layout", "cramped_room"),
                               horizon=meta.get("horizon", 400),
                               num_players=meta.get("num_players"))
    if name in ("overcooked2", "overcooked-new"):
        return overcooked2.make(meta.get("layout", "simple"),
                                horizon=meta.get("horizon", 200),
                                num_players=meta.get("num_players"))
    if name == "hanabi":
        return hanabi.Env(**hanabi.CONFIGS[meta.get("layout", "full")])
    if name == "balance":
        return balance_beam.Env()
    if name == "cartpole":
        return cartpole.Env()
    raise ValueError(f"unknown env in trace meta: {name}")


def replay(trace: Trace, env=None, device: DeviceLike = None):
    """Replay ``trace.actions`` through the env's collector on ``device``
    (default the card).  Returns ``(route, steps)``: ``route`` is
    ``"kernel"`` where the card runs the env's step kernel, else
    ``"plain"``; ``steps`` yields ``(t, StepOutput)``, t = -1 for the
    reset's output, then 0 .. T-1."""
    dev = resolve_device(device)
    if env is None:
        env = make_env_from_meta(trace.meta)
    T, N, _ = trace.actions.shape
    collect = make_fused_collect(env, N, dev)

    def steps():
        bstate, out = batched_reset(env, N, device=dev)
        yield -1, out
        carry = collect.pack(bstate)
        for t in range(T):
            actions = torch.as_tensor(trace.actions[t], dtype=torch.int32, device=dev)
            carry, out = collect.step(carry, actions)
            yield t, out

    return ("kernel" if collect.kernel and dev.type == "cuda" else "plain"), steps()


def diff_trace(trace: Trace, env=None, max_report: int = 10,
               device: DeviceLike = None) -> Dict:
    """Replay ``trace.actions`` and compare every field exactly.

    Returns a summary dict: per-field mismatch element counts, first few
    mismatch coordinates, ``ok`` (True iff everything matches exactly) and
    ``route``.  Float fields compare exactly too, as in JAX: tolerances are
    a per-callsite decision, not the differ's."""
    fields = {k: {"mismatch": 0, "total": 0, "first": []}
              for k in ("obs0", "obs", "rewards", "dones", "action_mask",
                        "active")}

    def acc(name, got, want, step):
        got = np.asarray(got)
        want = np.asarray(want)
        if got.shape != want.shape:
            fields[name]["mismatch"] += want.size or 1
            fields[name]["total"] += want.size or 1
            fields[name]["first"].append(
                {"step": step, "shape_got": list(got.shape),
                 "shape_want": list(want.shape)})
            return
        bad = got != want
        nbad = int(bad.sum())
        fields[name]["mismatch"] += nbad
        fields[name]["total"] += int(want.size)
        if nbad and len(fields[name]["first"]) < max_report:
            idx = np.argwhere(bad)[:3]
            for i in idx:
                fields[name]["first"].append(
                    {"step": step, "index": [int(v) for v in i],
                     "got": got[tuple(i)].item(),
                     "want": want[tuple(i)].item()})

    route, steps = replay(trace, env, device)
    for t, out in steps:
        if t < 0:
            acc("obs0", out.obs.cpu(), trace.obs0, -1)
            continue
        acc("obs", out.obs.cpu(), trace.obs[t], t)
        acc("rewards", out.reward.cpu().numpy().astype(np.float32),
            trace.rewards[t].astype(np.float32), t)
        acc("dones", out.done.cpu(), trace.dones[t], t)
        if trace.action_mask is not None:
            acc("action_mask", out.action_mask.cpu(), trace.action_mask[t], t)
        if trace.active is not None:
            acc("active", out.active.cpu(), trace.active[t], t)

    T, N, _ = trace.actions.shape
    summary = {k: v for k, v in fields.items() if v["total"]}
    return {
        "ok": all(v["mismatch"] == 0 for v in summary.values()),
        "steps": T,
        "num_envs": N,
        "route": route,
        "fields": summary,
    }


def record_trace(env, num_envs: int, num_steps: int, seed: int = 0,
                 with_mask: bool = True,
                 device: DeviceLike = None) -> Dict[str, np.ndarray]:
    """Record the port's rollout in the dump format: every seat's action
    drawn uniformly over all moves from ``numpy.random.RandomState(seed)``,
    legal or not, as JAX's ``record_trace`` draws them."""
    dev = resolve_device(device)
    collect = make_fused_collect(env, num_envs, dev)
    bstate, out = batched_reset(env, num_envs, device=dev)
    carry = collect.pack(bstate)
    rs = np.random.RandomState(seed)
    obs0 = out.obs.cpu().numpy()
    acts, obss, rews, dones, masks, actives = [], [], [], [], [], []
    for _ in range(num_steps):
        a = rs.randint(0, env.num_actions,
                       size=(num_envs, env.num_agents)).astype(np.int32)
        carry, out = collect.step(carry, torch.as_tensor(a, device=dev))
        acts.append(a)
        obss.append(out.obs.cpu().numpy())
        rews.append(out.reward.cpu().numpy().astype(np.float32))
        dones.append(out.done.cpu().numpy())
        if with_mask:
            masks.append(out.action_mask.cpu().numpy())
            actives.append(out.active.cpu().numpy())
    arrays = {
        "obs0": obs0,
        "actions": np.stack(acts),
        "obs": np.stack(obss),
        "rewards": np.stack(rews),
        "dones": np.stack(dones),
    }
    if with_mask:
        arrays["action_mask"] = np.stack(masks)
        arrays["active"] = np.stack(actives)
    return arrays

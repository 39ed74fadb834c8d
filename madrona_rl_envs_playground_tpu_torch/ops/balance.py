"""Balance Beam step kernels and their plain PyTorch versions.

Counterpart of ``madrona_rl_envs_playground_tpu/ops/balance_pallas.py``.
Two kernels, in ``csrc/balance.cu``:

* **K7** ``fused_step``: one step per env (move, rolling obs history,
  reward, termination, the world-order episode index of each reset and its
  TEA+LCG draw), in one kernel launch as K5's (``ops/cartpole.py``), in two
  passes over each tile of envs (which envs end; then step, draw and write
  each env once, the obs records staged through shared memory); its scan
  words persist per device and stream (``_build.step_scan``);
* **K8** ``fused_rollout``: T steps in one cooperative launch, per-(env,
  seat) LCG actions, a per-env done count and the checksum
  ``((chk + f32(sum of the obs)) + reward) + f32(done)`` after every step;
  from an env's third step on it carries the env's loc and obs history in
  one packed word (``pack_positions``, ``unpack_positions``).

Each wrapper launches its kernel for CUDA tensors and raises if it cannot;
for CPU tensors it runs its plain version (``fused_step_plain``,
``fused_rollout_plain``), which is the plain env's ``batched_step``.  Each
call adds one to ``LAUNCHES[<wrapper name>]``.

**Layout** (``TState``), env-major, mapped to the JAX kernel's seat-major
rows::

    loc[n, p]     == loc_jax[p, n]          # [N, 2] int32
    obs[n, p, k]  == obs_jax[p * 7 + k, n]  # [N, 2, 7] int32, the policy's obs
    time[n]       == time_jax[0, n]         # [N] int32
    rng[n]        == rng_jax[0, n]          # [N] int32 episode LCG word

The per-step actions are ``[N, 2]`` int32 (JAX: ``[2, N]``) and the reward
is f32 ``[N]``, shared by both seats; the rollout's action words are
``[2, N]`` as in JAX.  The episode counter is a uint32 held in an int64
scalar tensor on the state's device.

**Allocation order of K8.**  As K6 (``ops/cartpole.py``): per step in
whole-batch world order, which equals T applications of K7 and JAX's
``fused_rollout`` with ``block == N``; at ``bench.py``'s block of 16,384 the
checksums differ from JAX's.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict

import torch

from ..core.batch import batched_reset, batched_step
from ..core.rng import _MASK32, _lcg_next, _tea_seed, _to_i32
from ..core.types import BatchState
from ..device import DeviceLike, resolve_device
from ..envs.balance_beam import BUFFER, Env, State
from . import _build

ENV = Env()
OBS = 2 * ENV.obs_size

# launches of each kernel since the last reset_launches()
LAUNCHES: Dict[str, int] = {"fused_step": 0, "fused_rollout": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclasses.dataclass(frozen=True)
class TState:
    loc: torch.Tensor   # [N, 2] int32
    obs: torch.Tensor   # [N, 2, 7] int32
    time: torch.Tensor  # [N] int32
    rng: torch.Tensor   # [N] int32


def pack_state(state: State) -> TState:
    return TState(loc=state.loc.to(torch.int32).contiguous(),
                  obs=state.obs.to(torch.int32).contiguous(),
                  time=state.time.to(torch.int32).contiguous(),
                  rng=_to_i32(state.rng_v))


def unpack_state(ts: TState) -> State:
    return State(loc=ts.loc.clone(), obs=ts.obs.clone(), time=ts.time.clone(),
                 rng_v=ts.rng.to(torch.int64) & _MASK32)


def init_packed(num_envs: int, start_episode: int = 0, device: DeviceLike = None):
    """Fresh episodes ``start_episode + w`` in the kernel layout; returns
    ``(TState, counter)``."""
    bstate, _ = batched_reset(ENV, num_envs, start_episode, device=device)
    return pack_state(bstate.env_states), bstate.episode_counter


# ---- K8's packed carry ------------------------------------------------------

def pack_positions(ts: TState) -> torch.Tensor:
    """K8's packed word of each world, ``[N]`` int32 (``csrc/balance.cu``):
    l0, l1 and seat 0's obs history obs[1], obs[2], obs[4], obs[5], a nibble
    each from bit 0 up.  Exact for every world past its first two steps,
    whose history holds earlier positions + 2 or a fresh episode's zeros."""
    o = ts.obs.reshape(-1, OBS).to(torch.int64)
    vals = (ts.loc[:, 0].to(torch.int64), ts.loc[:, 1].to(torch.int64), o[:, 1], o[:, 2],
            o[:, 4], o[:, 5])
    word = sum((v & 0xF) << (4 * i) for i, v in enumerate(vals))
    return _to_i32(word)


def unpack_positions(word: torch.Tensor, time: torch.Tensor):
    """The full-width ``(loc [N, 2], obs [N, 2, 7])`` of packed words and the
    int32 times: seat 1's history repeats seat 0's, each seat's row ends
    with the time."""
    nib = [((word.to(torch.int64) >> (4 * i)) & 0xF).to(torch.int32) for i in range(6)]
    l0, l1, o1, o2, o4, o5 = nib
    b = BUFFER
    obs = torch.stack([l0 + b, o1, o2, l1 + b, o4, o5, time,
                       l1 + b, o4, o5, l0 + b, o1, o2, time], 1)
    return torch.stack([l0, l1], 1), obs.reshape(-1, 2, OBS // 2)


# ---- the rollout kernel's action stream -----------------------------------

def action_lcg_next(w: torch.Tensor, num_actions: int = 4):
    """Advance the ``[2, N]`` per-seat action words one step; the action is
    ``(u24 * num_actions) >> 24`` with u24 = bits 8..31 of the new word.
    Returns ``(w', actions)``, int32."""
    w2 = _lcg_next(w)
    u24 = (w2.to(torch.int64) >> 8) & 0x00FFFFFF
    return w2, ((u24 * num_actions) >> 24).to(torch.int32)


def init_action_rng(num_envs: int, seed: int = 0, device: DeviceLike = None) -> torch.Tensor:
    """[2, N] int32 action-LCG seeds: TEA of ``idx ^ 0xBA1A9CE5`` over 2N ids."""
    dev = resolve_device(device)
    idx = torch.arange(2 * num_envs, dtype=torch.int64, device=dev) + seed * 2 * num_envs
    # the xor tag keeps this stream apart from every episode-RNG stream
    return _tea_seed(idx ^ 0xBA1A9CE5).reshape(2, num_envs)


# ---- plain versions --------------------------------------------------------

def fused_step_plain(ts: TState, counter: torch.Tensor, actions: torch.Tensor):
    """K7's plain version: the plain env's ``batched_step``.  Returns
    ``(TState', reward [N] f32, done [N] bool, counter')``."""
    bstate = BatchState(env_states=unpack_state(ts), episode_counter=counter)
    bstate, out = batched_step(ENV, bstate, actions)
    return (pack_state(bstate.env_states), out.reward[:, 0].contiguous(), out.done,
            bstate.episode_counter)


def fused_rollout_plain(ts: TState, counter: torch.Tensor, act_rng: torch.Tensor,
                        num_steps: int):
    """K8's plain version: ``num_steps`` plain steps driven by the per-seat
    action LCG.  Returns ``(TState', act_rng', counter', done_count [N]
    int32, checksum [N] f32)``, the checksum added in float32 in the kernel's
    order."""
    N = ts.rng.shape[0]
    dcnt = torch.zeros(N, dtype=torch.int32, device=ts.obs.device)
    chk = torch.zeros(N, dtype=torch.float32, device=ts.obs.device)
    w = act_rng
    for _ in range(num_steps):
        w, a = action_lcg_next(w)
        ts, rew, done, counter = fused_step_plain(ts, counter, a.t())
        obs_sum = ts.obs.reshape(N, OBS).sum(1, dtype=torch.int32)
        chk = chk + obs_sum.to(torch.float32)
        chk = chk + rew
        chk = chk + done.to(torch.float32)
        dcnt += done.to(torch.int32)
    return ts, w, counter, dcnt, chk


# ---- CUDA kernels ----------------------------------------------------------

def _lib() -> ctypes.CDLL:
    lib = _build.load("balance")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.bb_scratch_ints.argtypes = [i]
        lib.bb_scratch_ints.restype = i
        lib.bb_step_scratch_ints.argtypes = [i]
        lib.bb_step_scratch_ints.restype = i
        _build.check_step_scan(lib.bb_step_scratch_ints, "balance.cu")
        lib.bb_step.argtypes = [p] * 14 + [i, i, p]
        lib.bb_step.restype = i
        lib.bb_rollout.argtypes = [p] * 16 + [i, i, i, p]
        lib.bb_rollout.restype = i
        lib.bb_error_string.argtypes = [i]
        lib.bb_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _check_state(ts: TState, counter: torch.Tensor) -> int:
    N = ts.rng.shape[0] if ts.rng.dim() == 1 else -1
    if N <= 0:
        raise ValueError(f"rng must be a non-empty [N] tensor, got {tuple(ts.rng.shape)}")
    dev = ts.obs.device
    _build.check_tensor(ts.loc, "loc", torch.int32, (N, 2), dev)
    _build.check_tensor(ts.obs, "obs", torch.int32, (N, 2, OBS // 2), dev)
    _build.check_tensor(ts.time, "time", torch.int32, (N,), dev, align=4)
    _build.check_tensor(ts.rng, "rng", torch.int32, (N,), dev, align=4)
    _build.check_tensor(counter, "counter", torch.int64, (), dev, align=8)
    return N


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().bb_error_string(rc).decode()
        raise RuntimeError(f"{what} failed to launch: error {rc} ({msg})")


def _empty_state(ts: TState) -> TState:
    return TState(loc=torch.empty_like(ts.loc), obs=torch.empty_like(ts.obs),
                  time=torch.empty_like(ts.time), rng=torch.empty_like(ts.rng))


def _fused_step_cuda(ts: TState, counter: torch.Tensor, actions: torch.Tensor):
    N = _check_state(ts, counter)
    dev = ts.obs.device
    _build.check_tensor(actions, "actions", torch.int32, (N, 2), dev, align=8)
    lib = _lib()
    out = _empty_state(ts)
    rew = torch.empty(N, dtype=torch.float32, device=dev)
    done = torch.empty(N, dtype=torch.bool, device=dev)
    cnt = torch.empty_like(counter)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.bb_step(
        ts.loc.data_ptr(), ts.obs.data_ptr(), ts.time.data_ptr(), ts.rng.data_ptr(),
        actions.data_ptr(), counter.data_ptr(), out.loc.data_ptr(), out.obs.data_ptr(),
        out.time.data_ptr(), out.rng.data_ptr(), rew.data_ptr(), done.data_ptr(),
        cnt.data_ptr(), _build.step_scan(N, dev, stream).data_ptr(), N, dev.index or 0, stream)
    _raise_on(rc, "bb_step_kernel")
    LAUNCHES["fused_step"] += 1
    return out, rew, done, cnt


def _fused_rollout_cuda(ts: TState, counter: torch.Tensor, act_rng: torch.Tensor,
                        num_steps: int):
    N = _check_state(ts, counter)
    dev = ts.obs.device
    _build.check_tensor(act_rng, "act_rng", torch.int32, (2, N), dev, align=4)
    lib = _lib()
    out = _empty_state(ts)
    arng = torch.empty_like(act_rng)
    dcnt = torch.empty(N, dtype=torch.int32, device=dev)
    chk = torch.empty(N, dtype=torch.float32, device=dev)
    cnt = torch.empty_like(counter)
    pos = torch.empty(N, dtype=torch.int32, device=dev)  # the packed carry (csrc/balance.cu)
    scratch = torch.empty(lib.bb_scratch_ints(N), dtype=torch.int32, device=dev)
    rc = lib.bb_rollout(
        ts.loc.data_ptr(), ts.obs.data_ptr(), ts.time.data_ptr(), ts.rng.data_ptr(),
        act_rng.data_ptr(), counter.data_ptr(), out.loc.data_ptr(), out.obs.data_ptr(),
        out.time.data_ptr(), out.rng.data_ptr(), arng.data_ptr(), dcnt.data_ptr(),
        chk.data_ptr(), cnt.data_ptr(), pos.data_ptr(), scratch.data_ptr(), N,
        int(num_steps), dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "bb_rollout_kernel")
    LAUNCHES["fused_rollout"] += 1
    return out, arng, cnt, dcnt, chk


def fused_step(ts: TState, counter: torch.Tensor, actions: torch.Tensor):
    """One step of every env.  ``actions``: int32 ``[N, 2]``.  Returns
    ``(TState', reward [N] f32, done [N] bool, counter')``.

    K7 on CUDA tensors; the plain version on CPU tensors."""
    if ts.obs.is_cuda:
        return _fused_step_cuda(ts, counter, actions)
    _check_state(ts, counter)
    return fused_step_plain(ts, counter, actions)


def fused_rollout(ts: TState, counter: torch.Tensor, act_rng: torch.Tensor,
                  num_steps: int):
    """``num_steps`` steps of every env in one launch, actions drawn from the
    per-(env, seat) LCG ``act_rng`` (``init_action_rng``).  Returns
    ``(TState', act_rng', counter', done_count [N] int32, checksum [N] f32)``.

    K8 on CUDA tensors; the plain version on CPU tensors."""
    if num_steps < 1:
        raise ValueError("num_steps must be >= 1")
    if ts.obs.is_cuda:
        return _fused_rollout_cuda(ts, counter, act_rng, num_steps)
    _check_state(ts, counter)
    return fused_rollout_plain(ts, counter, act_rng, num_steps)

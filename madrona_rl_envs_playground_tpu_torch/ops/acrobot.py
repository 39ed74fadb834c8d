"""Acrobot step kernels and their plain PyTorch versions.

Counterpart of ``madrona_rl_envs_playground_tpu/ops/acrobot_pallas.py``.
Two kernels, in ``csrc/acrobot.cu``:

* **K9** ``fused_step``: one step per env (the RK4 step, the angle wrap and
  velocity clamp, the height or 501-step termination, the world-order
  episode index of each reset and its TEA+LCG draw), in one kernel launch
  that ranks the resets by a decoupled look-back over tiles of envs spread
  on the resident grid; its scan words persist per device and stream
  (``_build.step_scan``), zero before the first launch and left zero by each;
* **K10** ``fused_rollout``: T steps in one cooperative launch, actions from
  a per-env LCG (``((w' >>> 8) & 0xFFFFFF) * 3 >>> 24``, three torques), a
  per-env done count and the checksum ``chk + t1 + t2 + w1 + w2 + done``
  after every step, in float32 and in that order; each env's carry in
  shared memory where the resident grid holds it, else in device memory
  (``rollout_kernel`` names the kernel a batch size gets).  The carry packs
  the done count beside the step count, so a rollout takes at most
  ``MAX_ROLLOUT_STEPS`` steps, on the CPU too.

Each wrapper launches its kernel for CUDA tensors and raises if it cannot;
for CPU tensors it runs its plain version (``fused_step_plain``,
``fused_rollout_plain``), which is the plain env's ``batched_step``.  Each
call adds one to ``LAUNCHES[<wrapper name>]``.

**Layout** (``TState``), mapped to the JAX kernel's::

    st[n, i]  == grid_jax[i, n]   # [N, 4] f32: theta1, theta2, omega1, omega2
    steps[n]  == steps_jax[0, n]  # [N] int32
    rng[n]    == rng_jax[0, n]    # [N] int32 episode LCG word

``st`` is also the ``[N, 1, 4]`` obs.  Per-step actions are ``[N, 1]`` int32;
the rollout's action words are ``[1, N]`` as in JAX.  The episode counter is
a uint32 held in an int64 scalar tensor on the state's device.

**Allocation order of K10** is K6's (``ops/cartpole.py``): per step in
whole-batch world order, so it equals T applications of K9 and JAX's
``fused_rollout`` with ``block == N``, not JAX's block-sequential order at
more than one block.
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
from ..envs.acrobot import Env, State
from . import _build

ENV = Env()
# K10's done counts share a word with 9 bits of step count (ac_rollout_max_steps)
MAX_ROLLOUT_STEPS = 2**23 - 1

# launches of each kernel since the last reset_launches()
LAUNCHES: Dict[str, int] = {"fused_step": 0, "fused_rollout": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclasses.dataclass(frozen=True)
class TState:
    st: torch.Tensor     # [N, 4] f32
    steps: torch.Tensor  # [N] int32
    rng: torch.Tensor    # [N] int32


def pack_state(state: State) -> TState:
    st = torch.stack([state.theta1, state.theta2, state.omega1, state.omega2], -1)
    return TState(st=st.contiguous(), steps=state.steps.to(torch.int32).contiguous(),
                  rng=_to_i32(state.rng_v))


def unpack_state(ts: TState) -> State:
    return State(theta1=ts.st[:, 0].clone(), theta2=ts.st[:, 1].clone(),
                 omega1=ts.st[:, 2].clone(), omega2=ts.st[:, 3].clone(),
                 steps=ts.steps.clone(), rng_v=ts.rng.to(torch.int64) & _MASK32)


def init_packed(num_envs: int, start_episode: int = 0, device: DeviceLike = None):
    """Fresh episodes ``start_episode + w`` in the kernel layout; returns
    ``(TState, counter)``."""
    bstate, _ = batched_reset(ENV, num_envs, start_episode, device=device)
    return pack_state(bstate.env_states), bstate.episode_counter


# ---- the rollout kernel's action stream -----------------------------------

def action_lcg_next(w: torch.Tensor):
    """Advance the action words; the action is ``(u24 * 3) >> 24`` of the new
    word's bits 8-31.  Returns ``(w', actions)``, int32."""
    w2 = _lcg_next(w)
    u24 = (w2.to(torch.int64) >> 8) & 0x00FFFFFF
    return w2, ((u24 * 3) >> 24).to(torch.int32)


def init_action_rng(num_envs: int, seed: int = 0, device: DeviceLike = None) -> torch.Tensor:
    """[1, N] int32 action-LCG seeds: TEA of ``idx ^ 0x0AC20B07``."""
    dev = resolve_device(device)
    idx = torch.arange(num_envs, dtype=torch.int64, device=dev) + seed * num_envs
    # the xor tag keeps this stream apart from every episode-RNG stream
    return _tea_seed(idx ^ 0x0AC20B07)[None, :]


# ---- plain versions --------------------------------------------------------

def fused_step_plain(ts: TState, counter: torch.Tensor, actions: torch.Tensor):
    """K9's plain version: the plain env's ``batched_step``.  Returns
    ``(TState', done [N] bool, counter')``."""
    bstate = BatchState(env_states=unpack_state(ts), episode_counter=counter)
    bstate, out = batched_step(ENV, bstate, actions)
    return pack_state(bstate.env_states), out.done, bstate.episode_counter


def fused_rollout_plain(ts: TState, counter: torch.Tensor, act_rng: torch.Tensor,
                        num_steps: int):
    """K10's plain version: ``num_steps`` plain steps driven by the action
    LCG.  Returns ``(TState', act_rng', counter', done_count [N] int32,
    checksum [N] f32)``; after every step the checksum adds the four state
    values and the done flag, in float32, in that order."""
    N = ts.rng.shape[0]
    dcnt = torch.zeros(N, dtype=torch.int32, device=ts.st.device)
    chk = torch.zeros(N, dtype=torch.float32, device=ts.st.device)
    w = act_rng
    for _ in range(num_steps):
        w, a = action_lcg_next(w)
        ts, done, counter = fused_step_plain(ts, counter, a.t())
        dcnt += done.to(torch.int32)
        st = ts.st
        chk = chk + st[:, 0] + st[:, 1] + st[:, 2] + st[:, 3] + done.to(torch.float32)
    return ts, w, counter, dcnt, chk


# ---- CUDA kernels ----------------------------------------------------------

def _lib() -> ctypes.CDLL:
    lib = _build.load("acrobot")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ac_scratch_ints.argtypes = [i]
        lib.ac_scratch_ints.restype = i
        lib.ac_step_scratch_ints.argtypes = [i]
        lib.ac_step_scratch_ints.restype = i
        _build.check_step_scan(lib.ac_step_scratch_ints, "acrobot.cu")
        lib.ac_step.argtypes = [p] * 11 + [i, i, p]
        lib.ac_step.restype = i
        lib.ac_rollout.argtypes = [p] * 13 + [i, i, i, p]
        lib.ac_rollout.restype = i
        lib.ac_rollout_onchip.argtypes = [i, i]
        lib.ac_rollout_onchip.restype = i
        lib.ac_rollout_max_steps.argtypes = []
        lib.ac_rollout_max_steps.restype = i
        if lib.ac_rollout_max_steps() != MAX_ROLLOUT_STEPS:
            raise RuntimeError("csrc/acrobot.cu's longest rollout differs from "
                               "ops.acrobot.MAX_ROLLOUT_STEPS")
        lib.ac_error_string.argtypes = [i]
        lib.ac_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _check_state(ts: TState, counter: torch.Tensor) -> int:
    N = ts.rng.shape[0] if ts.rng.dim() == 1 else -1
    if N <= 0:
        raise ValueError(f"rng must be a non-empty [N] tensor, got {tuple(ts.rng.shape)}")
    dev = ts.st.device
    _build.check_tensor(ts.st, "st", torch.float32, (N, 4), dev)
    _build.check_tensor(ts.steps, "steps", torch.int32, (N,), dev, align=4)
    _build.check_tensor(ts.rng, "rng", torch.int32, (N,), dev, align=4)
    _build.check_tensor(counter, "counter", torch.int64, (), dev, align=8)
    return N


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().ac_error_string(rc).decode()
        raise RuntimeError(f"{what} failed to launch: error {rc} ({msg})")


def _fused_step_cuda(ts: TState, counter: torch.Tensor, actions: torch.Tensor):
    N = _check_state(ts, counter)
    dev = ts.st.device
    _build.check_tensor(actions, "actions", torch.int32, (N, 1), dev, align=4)
    lib = _lib()
    st, steps, rng = torch.empty_like(ts.st), torch.empty_like(ts.steps), torch.empty_like(ts.rng)
    done = torch.empty(N, dtype=torch.bool, device=dev)
    cnt = torch.empty_like(counter)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.ac_step(
        ts.st.data_ptr(), ts.steps.data_ptr(), ts.rng.data_ptr(), actions.data_ptr(),
        counter.data_ptr(), st.data_ptr(), steps.data_ptr(), rng.data_ptr(), done.data_ptr(),
        cnt.data_ptr(), _build.step_scan(N, dev, stream).data_ptr(), N, dev.index or 0, stream)
    _raise_on(rc, "ac_step_kernel")
    LAUNCHES["fused_step"] += 1
    return TState(st=st, steps=steps, rng=rng), done, cnt


def _fused_rollout_cuda(ts: TState, counter: torch.Tensor, act_rng: torch.Tensor,
                        num_steps: int):
    N = _check_state(ts, counter)
    dev = ts.st.device
    _build.check_tensor(act_rng, "act_rng", torch.int32, (1, N), dev, align=4)
    lib = _lib()
    st, steps, rng = torch.empty_like(ts.st), torch.empty_like(ts.steps), torch.empty_like(ts.rng)
    arng = torch.empty_like(act_rng)
    dcnt = torch.empty(N, dtype=torch.int32, device=dev)
    chk = torch.empty(N, dtype=torch.float32, device=dev)
    cnt = torch.empty_like(counter)
    scratch = torch.empty(lib.ac_scratch_ints(N), dtype=torch.int32, device=dev)
    rc = lib.ac_rollout(
        ts.st.data_ptr(), ts.steps.data_ptr(), ts.rng.data_ptr(), act_rng.data_ptr(),
        counter.data_ptr(), st.data_ptr(), steps.data_ptr(), rng.data_ptr(), arng.data_ptr(),
        dcnt.data_ptr(), chk.data_ptr(), cnt.data_ptr(), scratch.data_ptr(), N,
        int(num_steps), dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "ac_rollout_kernel")
    LAUNCHES["fused_rollout"] += 1
    return TState(st=st, steps=steps, rng=rng), arng, cnt, dcnt, chk


def rollout_kernel(num_envs: int, device: DeviceLike = None) -> str:
    """The K10 kernel ``fused_rollout`` launches for ``num_envs`` envs on the
    card ``device``, by shape: ``ac_rollout_onchip_kernel`` where the resident
    grid holds every env's carry in shared memory (up to 8,192 envs an SM),
    else ``ac_rollout_kernel``, whose carry lies in device memory."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the rollout kernels run on a CUDA device")
    rc = _lib().ac_rollout_onchip(int(num_envs), dev.index or 0)
    if rc < 0:
        _raise_on(-rc, "ac_rollout_onchip")
    return "ac_rollout_onchip_kernel" if rc else "ac_rollout_kernel"


def fused_step(ts: TState, counter: torch.Tensor, actions: torch.Tensor):
    """One step of every env.  ``actions``: int32 ``[N, 1]`` in {0, 1, 2}.
    Returns ``(TState', done [N] bool, counter')``; the reward is -1 every
    step.

    K9 on CUDA tensors; the plain version on CPU tensors."""
    if ts.st.is_cuda:
        return _fused_step_cuda(ts, counter, actions)
    _check_state(ts, counter)
    return fused_step_plain(ts, counter, actions)


def fused_rollout(ts: TState, counter: torch.Tensor, act_rng: torch.Tensor,
                  num_steps: int):
    """``num_steps`` steps of every env in one launch, actions drawn from the
    per-env LCG ``act_rng`` (``init_action_rng``).  Returns ``(TState',
    act_rng', counter', done_count [N] int32, checksum [N] f32)``.

    K10 on CUDA tensors; the plain version on CPU tensors."""
    if not 1 <= num_steps <= MAX_ROLLOUT_STEPS:
        raise ValueError(f"num_steps must be in [1, {MAX_ROLLOUT_STEPS}], got {num_steps}")
    if ts.st.is_cuda:
        return _fused_rollout_cuda(ts, counter, act_rng, num_steps)
    _check_state(ts, counter)
    return fused_rollout_plain(ts, counter, act_rng, num_steps)

"""Overcooked step kernels and their plain PyTorch versions.

Counterpart of ``madrona_rl_envs_playground_tpu/ops/overcooked_pallas.py``.
Two kernels, in ``csrc/overcooked.cu``:

* **K1** ``fused_step``: one step per env (interacts, movement, cook ticks,
  horizon auto-reset) and the full observation encode;
* **K2** ``fused_rollout``: T steps in one launch with actions from a
  per-(env, player) LCG and a per-env checksum of every step's outputs.

Each wrapper launches its kernel for CUDA tensors and raises if it cannot;
for CPU tensors it runs its plain version (``fused_step_plain``,
``fused_rollout_plain``), which is the plain env of ``envs/overcooked_base``.
Each launch adds one to ``LAUNCHES[<wrapper name>]``.  The kernels read the
env's layout (``_Layout``: scalars, terrain, recipe tables, the pot and
counter cells, the obs cell order) from the card; it is built once per env
and copied once per device.

**Kernel state layout** (``TState``): ``rows`` is int8 ``[4S + 6P, N]``, the
rows in this order: obj_name, obj_onions, obj_tomatoes, obj_tick (S rows
each, cells (y, x)-major), then pos, orient, held_name, held_onions,
held_tomatoes, held_tick (P rows each); ``timestep`` is int32 ``[N]``.  Row
for row this is the JAX ``TState`` stacked in field order.

**Obs layout.**  K1 writes obs env-major, ``[N, P, W*H*C]`` int8, the layout
the policy reads and the plain env's.  The JAX kernel's ``[P, C, S, N]``
maps onto it as::

    obs[n, p, (x * H + y) * C + c] == obs_jax[p, c, y * W + x, n]

(the JAX package's ``to_env_major``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import weakref
from typing import Dict

import torch

from ..core.batch import batched_step
from ..core.rng import _lcg_next, _tea_seed, _to_i32
from ..core.types import BatchState
from ..device import DeviceLike, resolve_device
from ..envs.overcooked_base import T_AIR, T_COUNTER, T_POT, OvercookedEnv, State
from . import _build

CELL_FIELDS = ("obj_name", "obj_onions", "obj_tomatoes", "obj_tick")
PLAYER_FIELDS = ("pos", "orient", "held_name", "held_onions",
                 "held_tomatoes", "held_tick")
MAX_CELLS, MAX_PLAYERS = 100, 4

# launches of each kernel since the last reset_launches()
LAUNCHES: Dict[str, int] = {"fused_step": 0, "fused_rollout": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclasses.dataclass(frozen=True)
class TState:
    rows: torch.Tensor      # [4S + 6P, N] int8
    timestep: torch.Tensor  # [N] int32


def fused_supported(env: OvercookedEnv) -> bool:
    """The kernels' envelope: at most 100 cells and 4 players, and recipe
    times that fit the int8 cook-tick storage."""
    return (env.size <= MAX_CELLS and env.num_players <= MAX_PLAYERS
            and max(env.recipe_times) < 128)


def _require_fused(env: OvercookedEnv) -> None:
    if not fused_supported(env):
        raise ValueError(
            "overcooked kernels support layouts with <= 100 cells, <= 4 "
            f"players and recipe times < 128 (got size={env.size}, "
            f"players={env.num_players}, max recipe time "
            f"{max(env.recipe_times)}); use the plain env")


def num_rows(env: OvercookedEnv) -> int:
    return 4 * env.size + 6 * env.num_players


def pack_state(env: OvercookedEnv, state: State) -> TState:
    """Env-major ``State`` -> kernel layout (transpose and narrow to int8)."""
    _require_fused(env)
    rows = torch.cat([getattr(state, f).t() for f in CELL_FIELDS + PLAYER_FIELDS])
    return TState(rows=rows.to(torch.int8).contiguous(),
                  timestep=state.timestep.to(torch.int32).contiguous())


def unpack_state(env: OvercookedEnv, ts: TState) -> State:
    S, P = env.size, env.num_players
    sizes = [S] * len(CELL_FIELDS) + [P] * len(PLAYER_FIELDS)
    parts = torch.split(ts.rows, sizes)
    fields = {f: part.t().to(torch.int32).contiguous()
              for f, part in zip(CELL_FIELDS + PLAYER_FIELDS, parts)}
    return State(timestep=ts.timestep.clone(), **fields)


def init_packed(env: OvercookedEnv, num_envs: int,
                device: DeviceLike = None) -> TState:
    """Fresh episodes in the kernel layout."""
    _require_fused(env)
    dev = resolve_device(device)
    S, P = env.size, env.num_players
    col = torch.tensor([0] * 3 * S + [-1] * S + list(env.start_pos)
                       + [0] * 4 * P + [-1] * P, dtype=torch.int8, device=dev)
    return TState(rows=col[:, None].expand(-1, num_envs).contiguous(),
                  timestep=torch.zeros(num_envs, dtype=torch.int32, device=dev))


# ---- the rollout kernel's action stream -----------------------------------

def _act_from(w: torch.Tensor, num_actions: int) -> torch.Tensor:
    """a = (u24 * A) >> 24 with u24 = bits 8..31 of the word (logical)."""
    u24 = (w.to(torch.int64) >> 8) & 0x00FFFFFF
    return ((u24 * num_actions) >> 24).to(torch.int32)


def action_lcg_next(w: torch.Tensor, num_actions: int = 6):
    """Advance the per-(env, player) action words one step; returns
    ``(w', actions)``, both int32 ``[P, N]``."""
    w2 = _lcg_next(w)
    return w2, _act_from(w2, num_actions)


def init_action_rng(num_envs: int, num_players: int, seed: int = 0,
                    device: DeviceLike = None) -> torch.Tensor:
    """[P, N] int32 action-LCG seeds: TEA over a tagged id stream."""
    dev = resolve_device(device)
    idx = (torch.arange(num_players * num_envs, dtype=torch.int64, device=dev)
           + seed * num_players * num_envs)
    # the xor tag keeps this stream apart from every episode-RNG stream
    return _tea_seed(idx ^ 0x0C00CED5).reshape(num_players, num_envs)


# ---- plain versions --------------------------------------------------------

def fused_step_plain(env: OvercookedEnv, ts: TState, actions_t: torch.Tensor):
    """K1's plain version: the plain env's ``batched_step`` on the kernel's
    inputs and outputs.  Returns ``(TState', obs [N, P, W*H*C] int8,
    reward [P, N] int32, done [N] bool)``."""
    counter = torch.zeros((), dtype=torch.int64, device=ts.rows.device)
    bstate = BatchState(env_states=unpack_state(env, ts), episode_counter=counter)
    bstate, out = batched_step(env, bstate, actions_t.t())
    return (pack_state(env, bstate.env_states), out.obs,
            out.reward.t().contiguous(), out.done)


def fused_rollout_plain(env: OvercookedEnv, ts: TState, act_rng: torch.Tensor,
                        num_steps: int):
    """K2's plain version: ``num_steps`` plain steps driven by the LCG action
    stream.  Returns ``(TState', act_rng', done_count [N] int32,
    checksum [N] int32)`` where the checksum sums, over steps, each env's
    ``obs.sum() + P * reward + done``, wrapping as int32."""
    N, P = ts.timestep.shape[0], env.num_players
    dcnt = torch.zeros(N, dtype=torch.int64, device=ts.rows.device)
    chk = torch.zeros(N, dtype=torch.int64, device=ts.rows.device)
    w = act_rng
    for _ in range(num_steps):
        w, a = action_lcg_next(w, env.num_actions)
        ts, obs, rew, done = fused_step_plain(env, ts, a)
        chk += (obs.reshape(N, -1).sum(1, dtype=torch.int64)
                + rew.sum(0, dtype=torch.int64) + done.to(torch.int64))
        dcnt += done.to(torch.int64)
    return ts, w, dcnt.to(torch.int32), _to_i32(chk)


# ---- CUDA kernels ----------------------------------------------------------

class _Layout(ctypes.Structure):
    """Mirror of ``struct OcLayout`` in ``csrc/overcooked.cu``."""
    _fields_ = [(n, ctypes.c_int) for n in (
        "S", "P", "W", "H", "C", "K", "v1", "horizon", "t_tomato", "t_dish",
        "t_serve", "r_place", "r_dish", "r_soup", "n_pots", "n_counters",
        "base_total")] + [
        ("rtimes", ctypes.c_int * 16), ("rvals", ctypes.c_int * 16),
        ("starts", ctypes.c_int * MAX_PLAYERS),
        ("terr", ctypes.c_byte * MAX_CELLS), ("cell_of", ctypes.c_byte * MAX_CELLS),
        ("pots", ctypes.c_byte * MAX_CELLS), ("counters", ctypes.c_byte * MAX_CELLS)]


def _make_layout(env: OvercookedEnv) -> _Layout:
    H, W = env.height, env.width
    terr = list(env.terrain)
    pots = [s for s, t in enumerate(terr) if t == T_POT]
    counters = [s for s, t in enumerate(terr) if t == T_COUNTER]
    lay = _Layout(
        S=env.size, P=env.num_players, W=env.width, H=env.height,
        C=env.num_channels, K=env.num_obj_channels,
        v1=int(env.variant == "v1"), horizon=env.horizon,
        t_tomato=env.t_tomato_src, t_dish=env.t_dish_src, t_serve=env.t_serving,
        r_place=env.placement_in_pot_rew, r_dish=env.dish_pickup_rew,
        r_soup=env.soup_pickup_rew, n_pots=len(pots), n_counters=len(counters),
        # every observer sees each non-air cell's terrain one-hot: the
        # rollout's checksum adds this constant every step
        base_total=env.num_players * sum(t > T_AIR for t in terr))
    lay.rtimes[:] = list(env.recipe_times)
    lay.rvals[:] = list(env.recipe_values)
    lay.starts[:len(env.start_pos)] = list(env.start_pos)
    lay.terr[:env.size] = terr
    # obs cells run (x, y)-major, state cells (y, x)-major: obs cell
    # q = x * H + y is state cell y * W + x
    lay.cell_of[:env.size] = [(q % H) * W + q // H for q in range(env.size)]
    lay.pots[:len(pots)] = pots
    lay.counters[:len(counters)] = counters
    return lay


# env -> its layout, and env -> {device: the layout's bytes there}, built
# on first use
_LAYOUTS = weakref.WeakKeyDictionary()
_DEVICE_LAYOUTS = weakref.WeakKeyDictionary()


def _layout(env: OvercookedEnv) -> _Layout:
    lay = _LAYOUTS.get(env)
    if lay is None:
        lay = _LAYOUTS[env] = _make_layout(env)
    return lay


def _device_layout(env: OvercookedEnv, dev: torch.device) -> torch.Tensor:
    """The layout's bytes on ``dev``, which the kernels read."""
    per_dev = _DEVICE_LAYOUTS.setdefault(env, {})
    t = per_dev.get(dev)
    if t is None:
        t = per_dev[dev] = torch.tensor(list(bytes(_layout(env))), dtype=torch.uint8,
                                        device=dev)
    return t


def _lib() -> ctypes.CDLL:
    lib = _build.load("overcooked")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.oc_layout_size.argtypes = []
        lib.oc_layout_size.restype = i
        if lib.oc_layout_size() != ctypes.sizeof(_Layout):
            raise RuntimeError(f"struct OcLayout has {lib.oc_layout_size()} bytes, its "
                               f"ctypes mirror {ctypes.sizeof(_Layout)}")
        lib.oc_step.argtypes = [p] * 10 + [i, i, p]
        lib.oc_step.restype = i
        lib.oc_rollout.argtypes = [p] * 10 + [i, i, i, p]
        lib.oc_rollout.restype = i
        lib.oc_error_string.argtypes = [i]
        lib.oc_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _check_state(env: OvercookedEnv, ts: TState) -> int:
    _require_fused(env)
    N = ts.timestep.shape[0] if ts.timestep.dim() == 1 else -1
    if N <= 0:
        raise ValueError(f"timestep must be a non-empty [N] tensor, got {tuple(ts.timestep.shape)}")
    dev = ts.rows.device
    _build.check_tensor(ts.rows, "rows", torch.int8, (num_rows(env), N), dev, align=1)
    _build.check_tensor(ts.timestep, "timestep", torch.int32, (N,), dev, align=4)
    return N


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().oc_error_string(rc).decode()
        raise RuntimeError(f"{what} failed to launch: CUDA error {rc} ({msg})")


def _fused_step_cuda(env: OvercookedEnv, ts: TState, actions_t: torch.Tensor):
    N = _check_state(env, ts)
    dev = ts.rows.device
    P = env.num_players
    _build.check_tensor(actions_t, "actions_t", torch.int32, (P, N), dev, align=4)
    rows = torch.empty_like(ts.rows)
    tstep = torch.empty_like(ts.timestep)
    obs = torch.empty((N, P, env.obs_size), dtype=torch.int8, device=dev)
    rew = torch.empty((P, N), dtype=torch.int32, device=dev)
    done = torch.empty(N, dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib().oc_step(
        ctypes.addressof(_layout(env)), _device_layout(env, dev).data_ptr(),
        ts.rows.data_ptr(), ts.timestep.data_ptr(), actions_t.data_ptr(), rows.data_ptr(),
        tstep.data_ptr(), obs.data_ptr(), rew.data_ptr(), done.data_ptr(), N,
        dev.index or 0, stream)
    _raise_on(rc, "oc_step_kernel")
    LAUNCHES["fused_step"] += 1
    return TState(rows=rows, timestep=tstep), obs, rew, done


def _fused_rollout_cuda(env: OvercookedEnv, ts: TState, act_rng: torch.Tensor,
                        num_steps: int):
    N = _check_state(env, ts)
    dev = ts.rows.device
    _build.check_tensor(act_rng, "act_rng", torch.int32, (env.num_players, N), dev, align=4)
    if env.num_actions != 6:
        raise ValueError("the rollout kernel draws from 6 actions")
    rows = torch.empty_like(ts.rows)
    tstep = torch.empty_like(ts.timestep)
    rng = torch.empty_like(act_rng)
    dcnt = torch.empty(N, dtype=torch.int32, device=dev)
    chk = torch.empty(N, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib().oc_rollout(
        ctypes.addressof(_layout(env)), _device_layout(env, dev).data_ptr(),
        ts.rows.data_ptr(), ts.timestep.data_ptr(), act_rng.data_ptr(), rows.data_ptr(),
        tstep.data_ptr(), rng.data_ptr(), dcnt.data_ptr(), chk.data_ptr(), N,
        int(num_steps), dev.index or 0, stream)
    _raise_on(rc, "oc_rollout_kernel")
    LAUNCHES["fused_rollout"] += 1
    return TState(rows=rows, timestep=tstep), rng, dcnt, chk


def fused_step(env: OvercookedEnv, ts: TState, actions_t: torch.Tensor):
    """One step of every env.  ``actions_t``: int32 ``[P, N]``.  Returns
    ``(TState', obs [N, P, W*H*C] int8, reward [P, N] int32, done [N] bool)``.

    K1 on CUDA tensors; the plain version on CPU tensors."""
    if ts.rows.is_cuda:
        return _fused_step_cuda(env, ts, actions_t)
    _check_state(env, ts)
    return fused_step_plain(env, ts, actions_t)


def fused_rollout(env: OvercookedEnv, ts: TState, act_rng: torch.Tensor,
                  num_steps: int):
    """``num_steps`` steps of every env in one launch, actions drawn from the
    per-(env, player) LCG ``act_rng`` (``init_action_rng``).  Returns
    ``(TState', act_rng', done_count [N] int32, checksum [N] int32)``.

    K2 on CUDA tensors; the plain version on CPU tensors."""
    if num_steps < 1:
        raise ValueError("num_steps must be >= 1")
    if ts.rows.is_cuda:
        return _fused_rollout_cuda(env, ts, act_rng, num_steps)
    _check_state(env, ts)
    return fused_rollout_plain(env, ts, act_rng, num_steps)

"""Frozen plain Overcooked env: the benchmark's reference for K1 and K2.

A copy of the port's plain env (``envs/overcooked_base.py``) and of its
layout parser (``envs/layouts.py``'s ``get_base_layout_params``), kept here
so that no later change to the program moves the yardstick.  It imports
nothing of the program.  Every function works on the whole batch: cell
state is ``[N, S]``, player state ``[N, P]``.  ``step`` is the batched step
with the in-step auto-reset the program's ``core/batch.py`` applies (this
env draws no randomness at reset, so the episode counter is not needed),
and ``pack``/``unpack`` are the kernels' int8 row layout, written out again
from the program's documented layout (``ops/overcooked.py``: the cell
fields then the player fields, each a block of rows).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

MAX_INGREDIENTS = 3
NUM_RECIPES = (MAX_INGREDIENTS + 1) ** 2

_TERRAIN_CHARS = {
    "v1": {" ": 0, "P": 1, "X": 2, "O": 3, "T": 4, "D": 5, "S": 6},
    "v2": {" ": 0, "P": 1, "X": 2, "O": 3, "D": 4, "S": 5, "T": 6},
}

PLAYER_NUMS = (
    "1234567890" + "!@#$%^&*()" + "abcdefghij" + "klmnopqrst"
)

_DEFAULT_SHAPING = {
    "v1": {"PLACEMENT_IN_POT_REW": 3, "DISH_PICKUP_REWARD": 0, "SOUP_PICKUP_REWARD": 5},
    "v2": {"PLACEMENT_IN_POT_REW": 3, "DISH_PICKUP_REWARD": 3, "SOUP_PICKUP_REWARD": 5},
}

# Object codes (reference envs/overcooked_reimplement.py:4-9)
O_NONE, O_TOMATO, O_ONION, O_DISH, O_SOUP = 0, 1, 2, 3, 4
# Actions (reference envs/overcooked_reimplement.py:34-42)
A_NORTH, A_SOUTH, A_EAST, A_WEST, A_STAY, A_INTERACT = 0, 1, 2, 3, 4, 5
NUM_ACTIONS = 6

# Terrain codes: AIR/POT/COUNTER/ONION_SOURCE are shared; the rest differ.
T_AIR, T_POT, T_COUNTER, T_ONION_SRC = 0, 1, 2, 3
_VARIANT_TERRAIN = {
    # (tomato_source, dish_source, serving)
    "v1": (4, 5, 6),
    "v2": (6, 4, 5),
}


@dataclasses.dataclass(frozen=True)
class State:
    obj_name: torch.Tensor       # [N, S] int32
    obj_onions: torch.Tensor     # [N, S] int32
    obj_tomatoes: torch.Tensor   # [N, S] int32
    obj_tick: torch.Tensor       # [N, S] int32, -1 = not cooking
    pos: torch.Tensor            # [N, P] int32 flat position (y*W + x)
    orient: torch.Tensor         # [N, P] int32
    held_name: torch.Tensor      # [N, P] int32
    held_onions: torch.Tensor    # [N, P] int32
    held_tomatoes: torch.Tensor  # [N, P] int32
    held_tick: torch.Tensor      # [N, P] int32
    timestep: torch.Tensor       # [N] int32


class OvercookedEnv:
    """One static config per (variant, layout, horizon)."""

    state_is_obs = True
    masked = False
    reward_dtype = torch.int32
    obs_dtype = torch.int8

    def __init__(self, variant: str, terrain, height: int, width: int,
                 num_players: int, start_player_x, start_player_y,
                 placement_in_pot_rew: int, dish_pickup_rew: int,
                 soup_pickup_rew: int, recipe_values, recipe_times,
                 horizon: int, **_ignored):
        if variant not in ("v1", "v2"):
            raise ValueError(f"unknown Overcooked variant {variant!r}")
        self.variant = variant
        self.terrain = tuple(int(t) for t in terrain)
        self.height = int(height)
        self.width = int(width)
        self.size = self.height * self.width
        self.num_players = int(num_players)
        self.num_agents = self.num_players
        self.start_pos = tuple(
            int(y) * self.width + int(x)
            for x, y in zip(start_player_x, start_player_y)
        )
        self.placement_in_pot_rew = int(placement_in_pot_rew)
        self.dish_pickup_rew = int(dish_pickup_rew)
        self.soup_pickup_rew = int(soup_pickup_rew)
        self.recipe_values = tuple(int(v) for v in recipe_values)
        self.recipe_times = tuple(int(v) for v in recipe_times)
        self.horizon = int(horizon)

        self.t_tomato_src, self.t_dish_src, self.t_serving = _VARIANT_TERRAIN[variant]
        self.num_obj_channels = 16 if variant == "v1" else 10
        self.num_channels = 5 * self.num_players + self.num_obj_channels
        self.obs_size = self.size * self.num_channels
        self.state_size = self.obs_size
        self.num_actions = NUM_ACTIONS

        terr = np.asarray(self.terrain, np.int64)
        # terrain one-hot block: channel v-1 of the object block for v > AIR
        base = np.zeros((self.size, self.num_obj_channels), np.int32)
        for s in range(self.size):
            if terr[s] > T_AIR:
                base[s, terr[s] - 1] += 1
        self._base_obs = base
        # observer/player -> presence channel: self is 0, the others rank
        # 1..P-1 in id order skipping self
        P = self.num_players
        ch = np.zeros((P, P), np.int64)
        for i in range(P):
            for j in range(P):
                ch[i, j] = 0 if j == i else (j + 1 if j < i else j)
        self._ch_matrix = ch
        self._tables_by_device = {}

    def _tables(self, device: torch.device) -> dict:
        """The static layout tables as tensors on ``device``."""
        key = str(device)
        tb = self._tables_by_device.get(key)
        if tb is None:
            W = self.width
            tb = dict(
                terr=torch.tensor(self.terrain, dtype=torch.int64, device=device),
                rtimes=torch.tensor(self.recipe_times, dtype=torch.int32, device=device),
                rvals=torch.tensor(self.recipe_values, dtype=torch.int32, device=device),
                delta=torch.tensor([-W, W, 1, -1, 0, 0], dtype=torch.int64, device=device),
                base=torch.from_numpy(self._base_obs).to(device),
                ch=torch.from_numpy(self._ch_matrix).to(device),
                starts=torch.tensor(self.start_pos, dtype=torch.int32, device=device),
            )
            self._tables_by_device[key] = tb
        return tb

    # ------------------------------------------------------------------
    def init_core(self, episode_idx: torch.Tensor) -> State:
        """Fresh episodes for ``episode_idx`` [N]; the start state is fixed
        (this env draws no randomness), so only the batch size is read."""
        dev = episode_idx.device
        N, S, P = episode_idx.shape[0], self.size, self.num_players
        i32 = dict(dtype=torch.int32, device=dev)
        return State(
            obj_name=torch.zeros((N, S), **i32),
            obj_onions=torch.zeros((N, S), **i32),
            obj_tomatoes=torch.zeros((N, S), **i32),
            obj_tick=torch.full((N, S), -1, **i32),
            pos=self._tables(dev)["starts"].expand(N, P).clone(),
            orient=torch.zeros((N, P), **i32),
            held_name=torch.zeros((N, P), **i32),
            held_onions=torch.zeros((N, P), **i32),
            held_tomatoes=torch.zeros((N, P), **i32),
            held_tick=torch.full((N, P), -1, **i32),
            timestep=torch.zeros((N,), **i32),
        )

    def _move(self, tb, pos: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
        return torch.remainder(pos + tb["delta"][direction], self.size)

    # ------------------------------------------------------------------
    def transition(self, state: State, actions: torch.Tensor):
        """actions [N, P] -> (state', reward [N, P] int32, done [N] bool)."""
        P = self.num_players
        tb = self._tables(actions.device)
        terr, rtimes, rvals = tb["terr"], tb["rtimes"], tb["rvals"]
        v1 = self.variant == "v1"
        actions = actions.long()
        pos, orient = state.pos.long(), state.orient.long()
        on, oo = state.obj_name.clone(), state.obj_onions.clone()
        ot, otk = state.obj_tomatoes.clone(), state.obj_tick.clone()
        hn, ho = state.held_name.clone(), state.held_onions.clone()
        ht, htk = state.held_tomatoes.clone(), state.held_tick.clone()
        is_pot = terr == T_POT
        is_counter = terr == T_COUNTER

        # pot occupancy snapshot before any interact resolves
        pot_nonempty = (is_pot & (on != O_NONE)
                        & ((otk >= 0) | (oo + ot < MAX_INGREDIENTS)))
        n_pots_nonempty = pot_nonempty.sum(1)
        reward = torch.zeros(actions.shape[0], dtype=torch.int32,
                             device=actions.device)

        for p in range(P):
            do = actions[:, p] == A_INTERACT
            ipos = self._move(tb, pos[:, p], orient[:, p])
            t = terr[ipos]
            held, held_o = hn[:, p].clone(), ho[:, p].clone()
            held_t, held_k = ht[:, p].clone(), htk[:, p].clone()
            idx = ipos[:, None]
            cn, co = on.gather(1, idx)[:, 0], oo.gather(1, idx)[:, 0]
            ct, ctk = ot.gather(1, idx)[:, 0], otk.gather(1, idx)[:, 0]

            place = do & (t == T_COUNTER) & (held != O_NONE) & (cn == O_NONE)
            take = do & (t == T_COUNTER) & (held == O_NONE) & (cn != O_NONE)
            onion_src = do & (t == T_ONION_SRC) & (held == O_NONE)
            tomato_src = do & (t == self.t_tomato_src) & (held == O_NONE)
            dish_src = do & (t == self.t_dish_src) & (held == O_NONE)

            if P == 2:
                n_held_dishes = (hn == O_DISH).sum(1)
                dish_on_counter = (is_counter & (on == O_DISH)).any(1)
                dish_useful = ~dish_on_counter & (n_held_dishes < n_pots_nonempty)
            else:
                dish_useful = torch.zeros_like(do)

            at_pot = do & (t == T_POT)
            cell_time = rtimes[(4 * co + ct).long()]
            cell_is_soup = cn == O_SOUP
            cell_ready = cell_is_soup & (ctk >= 0) & (ctk >= cell_time)
            cell_cooking = cell_is_soup & (ctk >= 0) & (ctk < cell_time)

            soup_pick = at_pot & (held == O_DISH) & cell_ready
            ing = at_pot & ((held == O_ONION) | (held == O_TOMATO))
            # an ingredient on an empty pot creates SOUP(0, 0) first
            empty = cn == O_NONE
            eff_on = torch.where(empty, 0, co)
            eff_to = torch.where(empty, 0, ct)
            eff_tk = torch.where(empty, -1, ctk)
            can_add = ~((eff_tk >= 0) | (eff_on + eff_to == MAX_INGREDIENTS))
            add = ing & can_add
            new_on_cnt = eff_on + (add & (held == O_ONION)).int()
            new_to_cnt = eff_to + (add & (held == O_TOMATO)).int()

            if v1:
                start_cook = (at_pot & (held == O_NONE) & cell_is_soup
                              & ~cell_cooking & ~cell_ready & (co + ct > 0))
            else:
                start_cook = (ing & (eff_tk == -1)
                              & (new_on_cnt + new_to_cnt == MAX_INGREDIENTS))

            serve = do & (t == self.t_serving) & (held == O_SOUP)
            deliver_val = rvals[(4 * held_o + held_t).long()]

            reward = (reward
                      + add.int() * self.placement_in_pot_rew
                      + soup_pick.int() * self.soup_pickup_rew
                      + (dish_src & dish_useful).int() * self.dish_pickup_rew
                      + serve.int() * deliver_val)

            # held-object update
            drop = place | add | serve
            fresh = onion_src | tomato_src | dish_src
            fresh_name = torch.where(
                onion_src, O_ONION, torch.where(tomato_src, O_TOMATO, O_DISH))
            pickup = take | soup_pick
            hn[:, p] = torch.where(drop, O_NONE, torch.where(
                fresh, fresh_name, torch.where(pickup, cn, held)))
            ho[:, p] = torch.where(drop | fresh, 0, torch.where(pickup, co, held_o))
            ht[:, p] = torch.where(drop | fresh, 0, torch.where(pickup, ct, held_t))
            htk[:, p] = torch.where(drop | fresh, -1, torch.where(pickup, ctk, held_k))

            # grid-cell update at ipos (the object leaves the cell on pickup)
            new_cn = torch.where(pickup, O_NONE, torch.where(
                place, held, torch.where(add, O_SOUP, cn)))
            new_co = torch.where(pickup, 0, torch.where(
                place, held_o, torch.where(add, new_on_cnt, co)))
            new_ct = torch.where(pickup, 0, torch.where(
                place, held_t, torch.where(add, new_to_cnt, ct)))
            new_ctk = torch.where(pickup, -1, torch.where(
                start_cook, 0, torch.where(
                    place, held_k, torch.where(add, eff_tk, ctk))))
            on.scatter_(1, idx, new_cn.to(on.dtype)[:, None])
            oo.scatter_(1, idx, new_co.to(oo.dtype)[:, None])
            ot.scatter_(1, idx, new_ct.to(ot.dtype)[:, None])
            otk.scatter_(1, idx, new_ctk.to(otk.dtype)[:, None])

        # movement with the all-or-nothing collision rule
        is_interact = actions == A_INTERACT
        is_dir = actions < A_STAY
        tgt = self._move(tb, pos, actions)
        prop_or = torch.where(is_dir, actions, orient)
        prop_pos = torch.where(is_interact | (terr[tgt] != T_AIR), pos, tgt)
        off_diag = ~torch.eye(P, dtype=torch.bool, device=actions.device)
        same = (prop_pos[:, :, None] == prop_pos[:, None, :]) & off_diag
        swap = ((prop_pos[:, :, None] == pos[:, None, :])
                & (pos[:, :, None] == prop_pos[:, None, :]) & off_diag)
        conflict = (same | swap).flatten(1).any(1)
        new_pos = torch.where(conflict[:, None], pos, prop_pos)

        # environment effects: every cooking soup ticks, on a pot or a counter
        timestep = state.timestep + 1
        cell_time = rtimes[(4 * oo + ot).long()]
        cooking = (on == O_SOUP) & (otk >= 0) & (otk < cell_time)
        otk = otk + cooking.int()

        done = timestep >= self.horizon
        reward = reward[:, None].expand(-1, P).contiguous()

        new_state = State(
            obj_name=on, obj_onions=oo, obj_tomatoes=ot, obj_tick=otk,
            pos=new_pos.int(), orient=prop_or.int(),
            held_name=hn, held_onions=ho, held_tomatoes=ht, held_tick=htk,
            timestep=timestep,
        )
        return new_state, reward, done

    # ------------------------------------------------------------------
    def encode(self, state: State, just_reset: torch.Tensor):
        """Lossless state encoding, ``[N, P, W*H*C]`` int8 flattened in
        (x, y, c) order as the reference observation space (MultiBinary
        [W, H, C], ``envs/overcooked_env.py:92-106``)."""
        del just_reset
        dev = state.pos.device
        tb = self._tables(dev)
        N, S, P = state.pos.shape[0], self.size, self.num_players
        H, W = self.height, self.width
        C, K = self.num_channels, self.num_obj_channels
        shift = 5 * P
        rtimes = tb["rtimes"]
        pot = tb["terr"] == T_POT
        on, oo, ot, otk = (state.obj_name, state.obj_onions,
                           state.obj_tomatoes, state.obj_tick)
        soup = on == O_SOUP
        zero = torch.zeros_like(on)

        cols = [zero] * K
        if self.variant == "v1":
            idle = soup & pot & (otk < 0)
            live = soup & pot & (otk >= 0)
            off = soup & ~pot
            t_of = rtimes[(4 * oo + ot).long()]
            cols[6] = torch.where(idle, oo, 0)
            cols[7] = torch.where(idle, ot, 0)
            cols[8] = torch.where(live | off, oo, 0)
            cols[9] = torch.where(live | off, ot, 0)
            cols[10] = torch.where(live, t_of - otk, 0)
            cols[11] = ((live & (otk >= t_of)) | off).int()
            cols[12] = (on == O_DISH).int()
            cols[13] = (on == O_ONION).int()
            cols[14] = (on == O_TOMATO).int()
            urgent = (self.horizon - state.timestep) < 40
            cols[15] = urgent.int()[:, None].expand(N, S)
        else:
            in_pot = soup & pot
            cols[5] = torch.where(in_pot, oo, 0)
            cols[6] = torch.where(in_pot, otk.clamp(min=0), 0)
            cols[7] = (soup & ~pot).int()
            cols[8] = (on == O_DISH).int()
            cols[9] = (on == O_ONION).int()
        shared = torch.stack(cols, 2) + tb["base"]          # [N, S, K]

        # held objects add into the object block at each holder's cell
        hn = state.held_name
        if self.variant == "v1":
            is_soup = hn == O_SOUP
            slot = torch.stack([
                torch.full_like(hn, 8), torch.full_like(hn, 9),
                torch.full_like(hn, 11),
                torch.where(hn == O_DISH, 12, torch.where(
                    hn == O_ONION, 13, torch.where(hn == O_TOMATO, 14, 0))),
            ], 2)
            val = torch.stack([
                torch.where(is_soup, state.held_onions, 0),
                torch.where(is_soup, state.held_tomatoes, 0),
                is_soup.int(),
                ((hn == O_DISH) | (hn == O_ONION) | (hn == O_TOMATO)).int(),
            ], 2)
        else:
            slot = torch.where(hn == O_SOUP, 7, torch.where(
                hn == O_DISH, 8, torch.where(hn == O_ONION, 9, 0)))[:, :, None]
            val = ((hn == O_SOUP) | (hn == O_DISH) | (hn == O_ONION)).int()[:, :, None]
        pos = state.pos.long()
        hidx = (pos[:, :, None] * K + slot).reshape(N, -1)
        shared = shared.reshape(N, S * K).scatter_add(
            1, hidx, val.reshape(N, -1).to(shared.dtype)).reshape(N, S, K)

        # player block: presence and orientation one-hots per observer
        ch = tb["ch"]
        idx_pres = pos[:, None, :] * shift + ch[None]
        idx_ori = (pos[:, None, :] * shift + P + 4 * ch[None]
                   + state.orient.long()[:, None, :])
        pidx = torch.cat([idx_pres, idx_ori], 2)            # [N, P, 2P]
        player = torch.zeros((N, P, S * shift), dtype=torch.int32, device=dev)
        player.scatter_add_(2, pidx, torch.ones_like(pidx, dtype=torch.int32))

        obs = torch.cat([player.reshape(N, P, S, shift),
                         shared[:, None].expand(N, P, S, K)], 3)
        # (y, x)-major cells -> (x, y)-major, the reference layout
        obs = (obs.reshape(N, P, H, W, C).transpose(2, 3)
               .reshape(N, P, W * H * C).to(torch.int8))
        mask = torch.ones((N, P, NUM_ACTIONS), dtype=torch.bool, device=dev)
        active = torch.ones((N, P), dtype=torch.bool, device=dev)
        return state, obs, obs, mask, active


def _recipe_index(order) -> int:
    onions = sum(1 for x in order["ingredients"] if x == "onion")
    tomatoes = sum(1 for x in order["ingredients"] if x == "tomato")
    return (MAX_INGREDIENTS + 1) * onions + tomatoes


def _order_flags(orders) -> list:
    flags = [0] * NUM_RECIPES
    for order in orders or []:
        flags[_recipe_index(order)] = 1
    return flags


def get_base_layout_params(
    layout_name: dict,
    horizon: int,
    max_num_players: Optional[int] = None,
    variant: str = "v1",
) -> dict:
    """Parse a layout into flat simulator config.

    ``layout_name`` is a layout dict (grid, orders, shaping), as the
    configuration file holds it.
    """
    params = dict(layout_name)

    grid = params.pop("grid")
    params.pop("start_order_list", None)
    params.pop("num_items_for_soup", None)

    rows = [r.strip() for r in grid.split("\n")]
    cells = [list(r) for r in rows]

    player_positions = [None] * 64
    for y, row in enumerate(cells):
        for x, c in enumerate(row):
            idx = PLAYER_NUMS.find(c)
            if idx >= 0:
                cells[y][x] = " "
                if max_num_players is None or idx < max_num_players:
                    player_positions[idx] = (x, y)
    player_positions = [p for p in player_positions if p is not None]

    tmap = _TERRAIN_CHARS[variant]
    out = {
        "height": len(cells),
        "width": len(cells[0]),
        "terrain": [tmap[c] for row in cells for c in row],
        "num_players": len(player_positions),
        "start_player_x": [p[0] for p in player_positions],
        "start_player_y": [p[1] for p in player_positions],
    }

    shaping = params.pop("rew_shaping_params", None) or _DEFAULT_SHAPING[variant]
    out["placement_in_pot_rew"] = shaping["PLACEMENT_IN_POT_REW"]
    out["dish_pickup_rew"] = shaping["DISH_PICKUP_REWARD"]
    out["soup_pickup_rew"] = shaping["SOUP_PICKUP_REWARD"]

    all_orders = params.pop("start_all_orders", None) or []
    bonus_orders = params.pop("start_bonus_orders", None) or []
    all_flags = _order_flags(all_orders)
    bonus_flags = _order_flags(bonus_orders)
    order_bonus = params.pop("order_bonus", 2)

    times = [20] * NUM_RECIPES
    if "onion_time" in params and "tomato_time" in params:
        ot, tt = params.pop("onion_time"), params.pop("tomato_time")
        times = [
            o * ot + t * tt
            for o in range(MAX_INGREDIENTS + 1)
            for t in range(MAX_INGREDIENTS + 1)
        ]
    if "recipe_times" in params:
        for order, time in zip(all_orders, params.pop("recipe_times")):
            times[_recipe_index(order)] = time
    if "cook_time" in params:
        times = [params.pop("cook_time")] * NUM_RECIPES
    out["recipe_times"] = times

    values = [20] * NUM_RECIPES
    if "onion_value" in params and "tomato_value" in params:
        ov, tv = params.pop("onion_value"), params.pop("tomato_value")
        values = [
            o * ov + t * tv
            for o in range(MAX_INGREDIENTS + 1)
            for t in range(MAX_INGREDIENTS + 1)
        ]
    if "recipe_values" in params:
        for order, value in zip(all_orders, params.pop("recipe_values")):
            values[_recipe_index(order)] = value
    if "delivery_reward" in params:
        values = [params.pop("delivery_reward")] * NUM_RECIPES

    if variant == "v1":
        # Modern rules: bonus orders pay double, non-orders pay nothing
        # (envs/overcooked_env.py:355-361).
        for i in range(NUM_RECIPES):
            if bonus_flags[i]:
                values[i] *= order_bonus
            if not all_flags[i]:
                values[i] = 0
    out["recipe_values"] = values

    out["horizon"] = horizon
    return out


# ---- the batch step, the kernels' row layout and the rollout's action stream

CELL_FIELDS = ("obj_name", "obj_onions", "obj_tomatoes", "obj_tick")
PLAYER_FIELDS = ("pos", "orient", "held_name", "held_onions", "held_tomatoes", "held_tick")
_MASK32 = 0xFFFFFFFF
_LCG_A, _LCG_C = 1664525, 1013904223
_TEA_DELTA = 0x9E3779B9
_K0, _K1, _K2, _K3 = 0xA341316C, 0xC8013EA4, 0xAD90777D, 0x7E95761E


def make_env(config: dict) -> OvercookedEnv:
    """The env a configuration file names: its ``layout`` dict, ``variant``
    and ``horizon``."""
    params = get_base_layout_params(config["layout"], config["horizon"],
                                    variant=config["variant"])
    return OvercookedEnv(variant=config["variant"], **params)


def init_state(env: OvercookedEnv, num_envs: int, device) -> State:
    """Fresh episodes (the start state is fixed: no draw)."""
    return env.init_core(torch.zeros(num_envs, dtype=torch.int64, device=device))


def step(env: OvercookedEnv, state: State, actions: torch.Tensor, reset: bool = True):
    """One step of every world, actions int ``[N, P]``: the transition, the
    auto-reset of the worlds that are done, then the encode of the state
    after it.  Returns (state', obs [N, P, obs_size] int8, reward [N, P]
    int32, done [N] bool).  ``reset=False`` leaves out the auto-reset, the
    guarantee the simulator cells' control breaks."""
    s2, reward, done = env.transition(state, actions)
    if not reset:
        s4, obs, _, _, _ = env.encode(s2, done)
        return s4, obs, reward, done
    fresh = init_state(env, done.shape[0], done.device)
    s3 = State(**{f.name: torch.where(done.reshape((-1,) + (1,) * (getattr(s2, f.name).dim() - 1)),
                                      getattr(fresh, f.name), getattr(s2, f.name))
                  for f in dataclasses.fields(State)})
    s4, obs, _, _, _ = env.encode(s3, done)
    return s4, obs, reward, done


def pack(state: State):
    """State -> (rows int8 [4S + 6P, N], timestep int32 [N])."""
    rows = torch.cat([getattr(state, f).t() for f in CELL_FIELDS + PLAYER_FIELDS])
    return rows.to(torch.int8).contiguous(), state.timestep.to(torch.int32).contiguous()


def unpack(env: OvercookedEnv, rows: torch.Tensor, timestep: torch.Tensor) -> State:
    S, P = env.size, env.num_players
    sizes = [S] * len(CELL_FIELDS) + [P] * len(PLAYER_FIELDS)
    parts = torch.split(rows, sizes)
    fields = {f: part.t().to(torch.int32).contiguous()
              for f, part in zip(CELL_FIELDS + PLAYER_FIELDS, parts)}
    return State(timestep=timestep.to(torch.int32).clone(), **fields)


def _to_i32(v: torch.Tensor) -> torch.Tensor:
    return (((v & _MASK32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def _tea_u32(v0: torch.Tensor) -> torch.Tensor:
    v0 = v0.to(torch.int64) & _MASK32
    v1 = torch.zeros_like(v0)
    s0 = 0
    for _ in range(8):
        s0 = (s0 + _TEA_DELTA) & _MASK32
        v0 = (v0 + ((((v1 << 4) + _K0) ^ (v1 + s0) ^ ((v1 >> 5) + _K1)) & _MASK32)) & _MASK32
        v1 = (v1 + ((((v0 << 4) + _K2) ^ (v0 + s0) ^ ((v0 >> 5) + _K3)) & _MASK32)) & _MASK32
    return v0


def action_words(num_envs: int, num_players: int, seed: int, device) -> torch.Tensor:
    """[P, N] int32 first words of the rollout's per-(world, player) action
    LCG: 8-round TEA of the world-player index, offset by the seed's block
    and tagged apart from the episode streams (the program's
    ``init_action_rng`` documents the same stream)."""
    idx = (torch.arange(num_players * num_envs, dtype=torch.int64, device=device)
           + seed * num_players * num_envs)
    return _to_i32(_tea_u32(idx ^ 0x0C00CED5)).reshape(num_players, num_envs)


def next_actions(w: torch.Tensor, num_actions: int = NUM_ACTIONS):
    """Advance the action words one step: (w', actions [P, N] int32), the
    action ``(u24 * A) >> 24`` of bits 8..31 of the new word."""
    w2 = _to_i32((w.to(torch.int64) * _LCG_A + _LCG_C) & _MASK32)
    u24 = (w2.to(torch.int64) >> 8) & 0x00FFFFFF
    return w2, ((u24 * num_actions) >> 24).to(torch.int32)


def rollout(env: OvercookedEnv, state: State, w: torch.Tensor, num_steps: int,
            reset: bool = True):
    """``num_steps`` steps driven by the action words: (state', w',
    done count [N] int32, checksum [N] int32), the checksum summing, over
    the steps, each world's ``obs.sum() + P * reward + done`` as int32."""
    N = state.timestep.shape[0]
    dcnt = torch.zeros(N, dtype=torch.int64, device=w.device)
    chk = torch.zeros(N, dtype=torch.int64, device=w.device)
    for _ in range(num_steps):
        w, a = next_actions(w, env.num_actions)
        state, obs, rew, done = step(env, state, a.t(), reset)
        chk += obs.reshape(N, -1).sum(1, dtype=torch.int64) + rew.sum(1, dtype=torch.int64) \
            + done.to(torch.int64)
        dcnt += done.to(torch.int64)
    return state, w, dcnt.to(torch.int32), _to_i32(chk)

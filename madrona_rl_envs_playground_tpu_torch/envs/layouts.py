"""Overcooked layout registry and parser.

Re-implements the two ``get_base_layout_params`` flavors from the reference
(``envs/overcooked_env.py:261-371`` for the modern variant and
``envs/overcooked2_env.py:165-290`` for the JS-compatible variant): a
``.layout`` file is a Python-dict-literal with an ASCII grid; parsing yields
flat numeric simulator config (terrain ints, start positions, 16-entry recipe
value/time tables, shaping rewards, horizon).

The two variants differ in terrain enum order, default shaping rewards, and
whether bonus-order multipliers / non-order zeroing apply to recipe values.

Benchmark layout grids are bundled below as data (the standard
overcooked_ai / oldercooked_ai layout definitions used by the reference's
test matrix and benchmarks).
"""

from __future__ import annotations

import ast
import os
from typing import Dict, Optional

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

# --- bundled layout data (grids are standard overcooked benchmark assets) ---

_OLD_DEFAULTS = {
    "start_order_list": None,
    "cook_time": 20,
    "num_items_for_soup": 3,
    "delivery_reward": 20,
    "rew_shaping_params": None,
}

LAYOUTS: Dict[str, dict] = {
    # ---- old-rules layouts (overcooked2 / "simplecooked") -----------------
    "simple": {
        "grid": "XXPXX\nO  2O\nX1  X\nXDXSX",
        **_OLD_DEFAULTS,
    },
    "random1": {
        "grid": "XXXPX\nX 1 P\nD2X X\nO   X\nXOSXX",
        **_OLD_DEFAULTS,
    },
    "random0": {
        "grid": "XXXPX\nO X1P\nO2X X\nD X X\nXXXSX",
        **_OLD_DEFAULTS,
    },
    "random3": {
        "grid": "XXXPPXXX\nX  2   X\nD XXXX S\nX  1   X\nXXXOOXXX",
        **_OLD_DEFAULTS,
    },
    "scenario1_s": {
        "grid": "XXOXDXX\nX 1X2 X\nX  X  X\nX     X\nXSXXPPX",
        **_OLD_DEFAULTS,
    },
    "schelling_s": {
        "grid": "XSPDX\nX 1 X\nO   O\nX 2 X\nXDPSX",
        **_OLD_DEFAULTS,
    },
    "multiplayer_schelling": {
        "grid": (
            "XXSPDXX\nX  1  X\nX  X  X\nO3   4O\nX  X  X\nX  2  X\nXXDPSXX"
        ),
        **_OLD_DEFAULTS,
    },
    "unident_s": {
        "grid": "XXXXXXXXX\nO XSXOX S\nX   P 1 X\nX2  P   X\nXXXDXDXXX",
        **_OLD_DEFAULTS,
    },
    "five_by_five": {
        "grid": "XDPXX\nX   S\nO 2 X\nX1  D\nXOXPX",
        **_OLD_DEFAULTS,
    },
    "simple_single": {
        "grid": "XXPXX\nO   O\nX1  X\nXDXSX",
        **_OLD_DEFAULTS,
    },
    "small_corridor": {
        "grid": (
            "XXXXXOXDXXXXX\nX  1  X  2  X\nX  XXXXXXX  X\n"
            "X           X\nXSXXXXXXXXPPX"
        ),
        **_OLD_DEFAULTS,
    },
    # ---- modern layouts (overcooked / new rules) ---------------------------
    "cramped_room": {
        "grid": "XXPXX\nO  2O\nX1  X\nXDXSX",
        "start_bonus_orders": [],
        "start_all_orders": [{"ingredients": ["onion", "onion", "onion"]}],
        "rew_shaping_params": None,
    },
    "coordination_ring": {
        "grid": "XXXPX\nX 1 P\nD2X X\nO   X\nXOSXX",
        "start_bonus_orders": [],
        "start_all_orders": [{"ingredients": ["onion", "onion", "onion"]}],
        "rew_shaping_params": None,
    },
    "asymmetric_advantages": {
        "grid": "XXXXXXXXX\nO XSXOX S\nX   P 1 X\nX 2 P   X\nXXXDXDXXX",
        "start_bonus_orders": [],
        "start_all_orders": [{"ingredients": ["onion", "onion", "onion"]}],
        "rew_shaping_params": None,
    },
    "asymmetric_advantages_tomato": {
        "grid": "XXXXXXXXX\nT XSXOX S\nX   P 1 X\nX 2 P   X\nXXXDXDXXX",
        "start_bonus_orders": [{"ingredients": ["tomato", "tomato", "tomato"]}],
        "start_all_orders": [
            {"ingredients": ["onion", "onion", "onion"]},
            {"ingredients": ["tomato", "tomato", "tomato"]},
            {"ingredients": ["onion", "onion", "tomato"]},
            {"ingredients": ["onion", "tomato", "tomato"]},
        ],
        "onion_value": 21,
        "tomato_value": 13,
        "onion_time": 15,
        "tomato_time": 7,
        "rew_shaping_params": None,
    },
    "counter_circuit": {
        "grid": "XXXPPXXX\nX      X\nD XXXX2S\nX1     X\nXXXOOXXX",
        "start_bonus_orders": [],
        "start_all_orders": [{"ingredients": ["onion", "onion", "onion"]}],
        "rew_shaping_params": None,
    },
    "forced_coordination": {
        "grid": "XXXPX\nO X1P\nO2X X\nD X X\nXXXSX",
        "start_bonus_orders": [],
        "start_all_orders": [{"ingredients": ["onion", "onion", "onion"]}],
        "rew_shaping_params": None,
    },
    "many_player_layout": {
        "grid": (
            "XXXXXXXXXXXXXXX\n"
            "X1  2  3  4  5X\n"
            "S TX PX OX DX S\n"
            "X6  7  8  9  0X\n"
            "S TX PX OX DX S\n"
            "X!  @  #  $  %X\n"
            "S TX PX OX DX S\n"
            "X^  &  *  (  )X\n"
            "S TX PX OX DX S\n"
            "Xa  b  c  d  eX\n"
            "S TX PX OX DX S\n"
            "Xf  g  h  i  jX\n"
            "S TX PX OX DX S\n"
            "Xk  l  m  n  oX\n"
            "S TX PX OX DX S\n"
            "Xp  q  r  s  tX\n"
            "XXXXXXXXXXXXXXX"
        ),
        "start_all_orders": [
            {"ingredients": ["onion", "onion", "onion"]},
            {"ingredients": ["onion", "onion", "tomato"]},
            {"ingredients": ["tomato", "tomato", "tomato"]},
            {"ingredients": ["tomato"]},
        ],
        "start_bonus_orders": [
            {"ingredients": ["tomato", "tomato", "tomato"]},
            {"ingredients": ["onion", "onion", "tomato"]},
        ],
        "onion_value": 21,
        "tomato_value": 13,
        "onion_time": 15,
        "tomato_time": 7,
    },
}


def load_layout_file(path: str) -> dict:
    with open(path) as f:
        return ast.literal_eval(f.read())


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
    layout_name: str,
    horizon: int,
    max_num_players: Optional[int] = None,
    variant: str = "v1",
) -> dict:
    """Parse a layout into flat simulator config.

    ``layout_name`` is a registered name or a path ending in ``.layout``.
    """
    if layout_name.endswith(".layout"):
        params = dict(load_layout_file(layout_name))
    else:
        params = dict(LAYOUTS[layout_name])

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

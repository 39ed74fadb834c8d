"""Sequential numpy Overcooked oracle (both variants) for differential tests.

The port's own copy of ``madrona_rl_envs_playground_tpu/oracles/overcooked.py``,
its counterpart: the code is that file's, line for line
(``tests/test_torch_oracles.py`` compares the two).

A deliberately simple, loop-based implementation of the rules the reference
validates its C++ sims against (``envs/overcooked_reimplement.py`` and
``envs/overcooked2_reimplement.py``), used here to differentially test the
vectorized JAX simulator.  One instance = one world.

Interface: ``reset() -> obs``, ``step(actions) -> (obs, reward, done)`` where
obs is float/int array [P, W, H, C] and reward is the shared summed reward.
"""

from __future__ import annotations

import numpy as np

NONE, TOMATO, ONION, DISH, SOUP = 0, 1, 2, 3, 4
AIR, POT, COUNTER, ONION_SRC = 0, 1, 2, 3
NORTH, SOUTH, EAST, WEST, STAY, INTERACT = range(6)
MAXI = 3


class Obj:
    __slots__ = ("name", "onions", "tomatoes", "tick")

    def __init__(self, name, onions=0, tomatoes=0, tick=-1):
        self.name, self.onions, self.tomatoes, self.tick = name, onions, tomatoes, tick

    def recipe(self):
        return 4 * self.onions + self.tomatoes


class OvercookedOracle:
    def __init__(self, variant: str, params: dict):
        assert variant in ("v1", "v2")
        self.variant = variant
        self.terr = list(params["terrain"])
        self.H, self.W = params["height"], params["width"]
        self.S = self.H * self.W
        self.P = params["num_players"]
        self.starts = [
            y * self.W + x
            for x, y in zip(params["start_player_x"], params["start_player_y"])
        ]
        self.r_place = params["placement_in_pot_rew"]
        self.r_dish = params["dish_pickup_rew"]
        self.r_soup = params["soup_pickup_rew"]
        self.values = list(params["recipe_values"])
        self.times = list(params["recipe_times"])
        self.horizon = params["horizon"]
        if variant == "v1":
            self.t_tomato, self.t_dish, self.t_serve = 4, 5, 6
            self.K = 16
        else:
            self.t_tomato, self.t_dish, self.t_serve = 6, 4, 5
            self.K = 10
        self.C = 5 * self.P + self.K
        self.reset()

    # -----------------------------------------------------------------
    def reset(self):
        self.objects = [None] * self.S
        self.pos = list(self.starts)
        self.orient = [NORTH] * self.P
        self.held = [None] * self.P
        self.t = 0
        return self.encode()

    def _adj(self, pos, d):
        return pos + [-self.W, self.W, 1, -1, 0, 0][d]

    def _cooking(self, o):
        return o.tick >= 0 and o.tick < self.times[o.recipe()]

    def _ready(self, o):
        return o.tick >= 0 and o.tick >= self.times[o.recipe()]

    def _nonempty_pots(self):
        n = 0
        for p in range(self.S):
            o = self.objects[p]
            if self.terr[p] == POT and o is not None:
                if o.tick >= 0 or o.onions + o.tomatoes < MAXI:
                    n += 1
        return n

    def _dish_useful(self, pots):
        if self.P != 2:
            return False
        if any(
            o is not None and o.name == DISH and self.terr[p] == COUNTER
            for p, o in enumerate(self.objects)
        ):
            return False
        held_dishes = sum(1 for h in self.held if h is not None and h.name == DISH)
        return held_dishes < pots

    # -----------------------------------------------------------------
    def step(self, actions):
        reward = 0
        pots = self._nonempty_pots()
        for i in range(self.P):
            if actions[i] != INTERACT:
                continue
            f = self._adj(self.pos[i], self.orient[i]) % self.S
            t = self.terr[f]
            h = self.held[i]
            cell = self.objects[f]
            if t == COUNTER:
                if h is not None and cell is None:
                    self.objects[f], self.held[i] = h, None
                elif h is None and cell is not None:
                    self.held[i], self.objects[f] = cell, None
            elif t == ONION_SRC and h is None:
                self.held[i] = Obj(ONION)
            elif t == self.t_tomato and h is None:
                self.held[i] = Obj(TOMATO)
            elif t == self.t_dish and h is None:
                if self._dish_useful(pots):
                    reward += self.r_dish
                self.held[i] = Obj(DISH)
            elif t == POT:
                if h is None:
                    if (
                        self.variant == "v1"
                        and cell is not None
                        and cell.name == SOUP
                        and not self._cooking(cell)
                        and not self._ready(cell)
                        and cell.onions + cell.tomatoes > 0
                    ):
                        cell.tick = 0
                elif h.name == DISH and cell is not None and self._ready(cell):
                    self.held[i], self.objects[f] = cell, None
                    reward += self.r_soup
                elif h.name in (ONION, TOMATO):
                    if cell is None:
                        cell = self.objects[f] = Obj(SOUP)
                    if cell.name == SOUP and not (
                        cell.tick >= 0 or cell.onions + cell.tomatoes == MAXI
                    ):
                        if h.name == ONION:
                            cell.onions += 1
                        else:
                            cell.tomatoes += 1
                        self.held[i] = None
                        reward += self.r_place
                    if (
                        self.variant == "v2"
                        and cell.name == SOUP
                        and not self._cooking(cell)
                        and not self._ready(cell)
                        and cell.onions + cell.tomatoes == MAXI
                    ):
                        cell.tick = 0
            elif t == self.t_serve and h is not None:
                if h.name == SOUP:
                    reward += self.values[h.recipe()]
                    self.held[i] = None

        # movement
        props = []
        for i in range(self.P):
            a = actions[i]
            if a == INTERACT:
                props.append((self.pos[i], self.orient[i]))
            else:
                tgt = self._adj(self.pos[i], a) % self.S
                new_or = self.orient[i] if a == STAY else a
                props.append((self.pos[i] if self.terr[tgt] != AIR else tgt, new_or))
        clash = False
        for i in range(self.P):
            for j in range(i + 1, self.P):
                if props[i][0] == props[j][0] or (
                    props[i][0] == self.pos[j] and props[j][0] == self.pos[i]
                ):
                    clash = True
        for i in range(self.P):
            if not clash:
                self.pos[i] = props[i][0]
            self.orient[i] = props[i][1]

        # environment effects
        self.t += 1
        for p in range(self.S):
            o = self.objects[p]
            if o is not None and o.name == SOUP and self._cooking(o):
                o.tick += 1

        done = self.t >= self.horizon
        return self.encode(), reward, done

    # -----------------------------------------------------------------
    def encode(self):
        """Lossless encoding, [P, W, H, C] int arrays."""
        P, S, K, shift = self.P, self.S, self.K, 5 * self.P
        grid = np.zeros((S, self.C), np.int32)
        for p in range(S):
            if self.terr[p] > AIR:
                grid[p, shift + self.terr[p] - 1] = 1
        for p in range(S):
            o = self.objects[p]
            if o is None:
                continue
            if self.variant == "v1":
                if o.name == SOUP:
                    if self.terr[p] == POT:
                        if o.tick < 0:
                            grid[p, shift + 6] = o.onions
                            grid[p, shift + 7] = o.tomatoes
                        else:
                            grid[p, shift + 8] = o.onions
                            grid[p, shift + 9] = o.tomatoes
                            grid[p, shift + 10] = self.times[o.recipe()] - o.tick
                            if self._ready(o):
                                grid[p, shift + 11] = 1
                    else:
                        grid[p, shift + 8] = o.onions
                        grid[p, shift + 9] = o.tomatoes
                        grid[p, shift + 11] = 1
                elif o.name == DISH:
                    grid[p, shift + 12] = 1
                elif o.name == ONION:
                    grid[p, shift + 13] = 1
                elif o.name == TOMATO:
                    grid[p, shift + 14] = 1
            else:
                if o.name == SOUP:
                    if self.terr[p] == POT:
                        grid[p, shift + 5] = o.onions
                        grid[p, shift + 6] = max(o.tick, 0)
                    else:
                        grid[p, shift + 7] = 1
                elif o.name == DISH:
                    grid[p, shift + 8] = 1
                elif o.name == ONION:
                    grid[p, shift + 9] = 1
        if self.variant == "v1" and self.horizon - self.t < 40:
            grid[:, shift + 15] = 1

        out = []
        for i in range(P):
            g = grid.copy()
            for j in range(P):
                ch = 0 if j == i else (j + 1 if j < i else j)
                g[self.pos[j], ch] = 1
                g[self.pos[j], P + 4 * ch + self.orient[j]] = 1
                h = self.held[j]
                if h is None:
                    continue
                if self.variant == "v1":
                    if h.name == SOUP:
                        g[self.pos[j], shift + 8] = h.onions
                        g[self.pos[j], shift + 9] = h.tomatoes
                        g[self.pos[j], shift + 11] = 1
                    elif h.name == DISH:
                        g[self.pos[j], shift + 12] = 1
                    elif h.name == ONION:
                        g[self.pos[j], shift + 13] = 1
                    elif h.name == TOMATO:
                        g[self.pos[j], shift + 14] = 1
                else:
                    if h.name == SOUP:
                        g[self.pos[j], shift + 7] = 1
                    elif h.name == DISH:
                        g[self.pos[j], shift + 8] = 1
                    elif h.name == ONION:
                        g[self.pos[j], shift + 9] = 1
            out.append(g.reshape(self.H, self.W, self.C).transpose(1, 0, 2))
        return np.stack(out)

"""Sequential numpy Hanabi oracle for differential tests.

The port's own copy of ``madrona_rl_envs_playground_tpu/oracles/hanabi.py``,
its counterpart: the code is that file's, line for line
(``tests/test_torch_oracles.py`` compares the two).

A second, loop-based derivation of the reference C++ semantics
(``src/hanabi_env/sim.cpp``), driven by the same TEA+LCG episode stream, so a
fixed seed must reproduce the vectorized simulator's trajectories bit-for-bit
— deck order, hands, encodings, masks, rewards and termination.  One instance
= one world; a shared ``Counter`` provides the global episode indices.
"""

from __future__ import annotations

import numpy as np

M32 = 0xFFFFFFFF


def _seed(idx: int) -> int:
    v0, v1, s0 = idx & M32, 0, 0
    for _ in range(8):
        s0 = (s0 + 0x9E3779B9) & M32
        v0 = (v0 + ((((v1 << 4) & M32) + 0xA341316C) ^ ((v1 + s0) & M32) ^ (((v1 >> 5) + 0xC8013EA4) & M32))) & M32
        v1 = (v1 + ((((v0 << 4) & M32) + 0xAD90777D) ^ ((v0 + s0) & M32) ^ (((v0 >> 5) + 0x7E95761E) & M32))) & M32
    return v0


class Counter:
    def __init__(self, start=0):
        self.value = start

    def next(self):
        v = self.value
        self.value += 1
        return v


class HanabiOracle:
    DISCARD, PLAY, REVEAL_C, REVEAL_R, INVALID = range(5)

    def __init__(self, counter: Counter, colors=5, ranks=5, players=2,
                 max_information_tokens=8, max_life_tokens=3):
        self.counter = counter
        self.C, self.R, self.P = colors, ranks, players
        self.max_info, self.max_life = max_information_tokens, max_life_tokens
        self.H = 5 if players < 4 else 4
        self.cr_num = [3 if r == 0 else 1 if r == ranks - 1 else 2 for r in range(ranks)]
        self.max_cards = sum(self.cr_num) * colors
        self.reset()

    # --- RNG ----------------------------------------------------------
    def _rand(self) -> float:
        self.v = (1664525 * self.v + 1013904223) & M32
        return float(np.float32(self.v & 0xFFFFFF) / np.float32(0x1000000))

    def _draw(self):
        loc = int(np.float32(self.deck_size) * np.float32(self._rand()))
        card = self.deck[loc]
        self.deck[loc] = self.deck[self.deck_size - 1]
        self.deck_size -= 1
        return card

    # --- lifecycle -----------------------------------------------------
    def reset(self):
        self.v = _seed(self.counter.next())
        C, R, P, H = self.C, self.R, self.P, self.H
        self.deck = []
        for c in range(C):
            for r in range(R):
                self.deck += [c * R + r] * self.cr_num[r]
        self.deck_size = self.max_cards
        self.discards = [0] * (C * R)
        self.fireworks = [0] * C
        self.info = self.max_info
        self.life = self.max_life
        self.cur = 0
        self.turns_left = P
        self.score = 0
        self.lm = dict(move=self.INVALID, player=-1, target=-1, card_index=-1,
                       scored=False, info_token=False, color=-1, rank=-1, reveal=0)
        full = (1 << (C * R)) - 1
        self.cards = [[0] * H for _ in range(P)]
        self.plaus = [[full] * H for _ in range(P)]
        self.sizes = [H] * P
        self.kcolor = [[-1] * H for _ in range(P)]
        self.krank = [[-1] * H for _ in range(P)]
        for p in range(P):
            for j in range(H):
                self.cards[p][j] = self._draw()
        self.obs = [self.encode(a) for a in range(P)]
        self.masks = [self.gen_mask(a) for a in range(P)]

    def _remove(self, p, idx):
        full = (1 << (self.C * self.R)) - 1
        if self.deck_size == 0:
            for i in range(idx + 1, self.sizes[p]):
                self.cards[p][i - 1] = self.cards[p][i]
                self.plaus[p][i - 1] = self.plaus[p][i]
                self.kcolor[p][i - 1] = self.kcolor[p][i]
                self.krank[p][i - 1] = self.krank[p][i]
            self.sizes[p] -= 1
        else:
            self.cards[p][idx] = self._draw()
            self.plaus[p][idx] = full
            self.kcolor[p][idx] = -1
            self.krank[p][idx] = -1

    # --- step ------------------------------------------------------------
    def step(self, uid: int):
        C, R, P, H = self.C, self.R, self.P, self.H
        if self.deck_size == 0:
            self.turns_left -= 1
        agent = self.cur
        lm = dict(move=self.INVALID, player=agent, target=-1, card_index=-1,
                  scored=False, info_token=False, color=-1, rank=-1, reveal=0)
        self.cur = (self.cur + 1) % P

        if uid < H:  # discard
            card = self.cards[agent][uid]
            lm.update(move=self.DISCARD, card_index=uid, color=card // R, rank=card % R)
            self.discards[card] += 1
            self.info += 1
            self._remove(agent, uid)
        elif uid < 2 * H:  # play
            idx = uid - H
            card = self.cards[agent][idx]
            lm.update(move=self.PLAY, card_index=idx, color=card // R, rank=card % R)
            if self.fireworks[card // R] == card % R:
                self.fireworks[card // R] += 1
                lm["scored"] = True
                if self.fireworks[card // R] == R:
                    self.info += 1
                    lm["info_token"] = True
            else:
                self.discards[card] += 1
                self.life -= 1
            self._remove(agent, idx)
        else:
            uid2 = uid - 2 * H
            if uid2 < (P - 1) * C:  # reveal color
                off, color = 1 + uid2 // C, uid2 % C
                tgt = (agent + off) % P
                self.info -= 1
                lm.update(move=self.REVEAL_C, target=tgt, color=color)
                newmask = sum(1 << (color * R + i) for i in range(R))
                for i in range(self.sizes[tgt]):
                    if self.cards[tgt][i] // R == color:
                        lm["reveal"] |= 1 << i
                        self.kcolor[tgt][i] = color
                        self.plaus[tgt][i] &= newmask
                    else:
                        self.plaus[tgt][i] &= ~newmask
            else:  # reveal rank
                uid3 = uid2 - (P - 1) * C
                off, rank = 1 + uid3 // R, uid3 % R
                tgt = (agent + off) % P
                self.info -= 1
                lm.update(move=self.REVEAL_R, target=tgt, rank=rank)
                newmask = sum(1 << (i * R + rank) for i in range(R))
                for i in range(self.sizes[tgt]):
                    if self.cards[tgt][i] % R == rank:
                        lm["reveal"] |= 1 << i
                        self.krank[tgt][i] = rank
                        self.plaus[tgt][i] &= newmask
                    else:
                        self.plaus[tgt][i] &= ~newmask

        self.lm = lm

        # observation refresh for the new current player only
        self.obs[self.cur] = self.encode(self.cur)
        self.masks[self.cur] = self.gen_mask(self.cur)

        # checkDone
        old = self.score
        self.score = sum(self.fireworks) if self.life > 0 else 0
        reward = float(self.score - old)
        done = self.life < 1 or self.score >= C * R or self.turns_left <= 0
        return reward, done

    # --- encodings ---------------------------------------------------------
    def encode(self, a: int):
        C, R, P, H = self.C, self.R, self.P, self.H
        BPC = C * R
        bits = []

        for i in range(1, P):
            p = (a + i) % P
            for n in range(H):
                if n < self.sizes[p]:
                    bits += [1 if b == self.cards[p][n] else 0 for b in range(BPC)]
                else:
                    bits += [0] * BPC
        for i in range(P):
            bits.append(1 if self.sizes[(a + i) % P] < H else 0)

        max_deck = self.max_cards - H * P
        bits += [1 if i < self.deck_size else 0 for i in range(max_deck)]
        for c in range(C):
            bits += [1 if i + 1 == self.fireworks[c] else 0 for i in range(R)]
        bits += [1 if i < self.info else 0 for i in range(self.max_info)]
        bits += [1 if i < self.life else 0 for i in range(self.max_life)]

        for c in range(C):
            for r in range(R):
                for i in range(self.cr_num[r]):
                    bits.append(1 if self.discards[c * R + r] > i else 0)

        lm = self.lm
        rel = -1 if lm["player"] == -1 else (a - lm["player"] + P) % P
        bits += [1 if i == rel else 0 for i in range(P)]
        mt = lm["move"]
        bits += [
            1 if mt == self.PLAY else 0,
            1 if mt == self.DISCARD else 0,
            1 if mt == self.REVEAL_C else 0,
            1 if mt == self.REVEAL_R else 0,
        ]
        if mt in (self.REVEAL_C, self.REVEAL_R):
            rt = (a - lm["target"] + P) % P
            bits += [1 if i == rt else 0 for i in range(P)]
        else:
            bits += [0] * P
        bits += [1 if mt == self.REVEAL_C and i == lm["color"] else 0 for i in range(C)]
        bits += [1 if mt == self.REVEAL_R and i == lm["rank"] else 0 for i in range(R)]
        if mt in (self.REVEAL_C, self.REVEAL_R):
            bits += [(lm["reveal"] >> i) & 1 for i in range(H)]
        else:
            bits += [0] * H
        if mt in (self.PLAY, self.DISCARD):
            bits += [1 if i == lm["card_index"] else 0 for i in range(H)]
            bits += [1 if i == lm["color"] * R + lm["rank"] else 0 for i in range(BPC)]
        else:
            bits += [0] * (H + BPC)
        if mt == self.PLAY:
            bits += [1 if lm["scored"] else 0, 1 if lm["info_token"] else 0]
        else:
            bits += [0, 0]

        # card knowledge — including the reference's bit-index quirk
        for i in range(P):
            p = (a + i) % P
            for n in range(H):
                if n < self.sizes[p]:
                    plaus_bit = (self.plaus[p][n] >> i) & 1
                    bits += [plaus_bit] * BPC
                    bits += [1 if self.kcolor[p][n] == v else 0 for v in range(C)]
                    bits += [1 if self.krank[p][n] == v else 0 for v in range(R)]
                else:
                    bits += [0] * (BPC + C + R)

        obs = np.asarray(bits, np.int8)
        own = []
        for n in range(H):
            if n < self.sizes[a]:
                own += [1 if b == self.cards[a][n] else 0 for b in range(BPC)]
            else:
                own += [0] * BPC
        state = np.concatenate([obs, np.asarray(own, np.int8)])
        return obs, state

    def gen_mask(self, a: int):
        C, R, P, H = self.C, self.R, self.P, self.H
        m = []
        for i in range(H):
            m.append(i < self.sizes[a] and self.info < self.max_info)
        for i in range(H):
            m.append(i < self.sizes[a])
        for off in range(1, P):
            p = (a + off) % P
            for c in range(C):
                # scans all hand_size slots, dead ones included (quirk)
                m.append(self.info > 0 and any(self.cards[p][n] // R == c for n in range(H)))
        for off in range(1, P):
            p = (a + off) % P
            for r in range(R):
                m.append(self.info > 0 and any(self.cards[p][n] % R == r for n in range(H)))
        return np.asarray(m, bool)

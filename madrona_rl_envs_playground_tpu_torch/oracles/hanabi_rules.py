"""Independent rules-level Hanabi oracle (HLE-facing semantics).

The port's own copy of ``madrona_rl_envs_playground_tpu/oracles/hanabi_rules.py``,
its counterpart: the code is that file's, line for line
(``tests/test_torch_oracles.py`` compares the two).

This is the Hanabi analog of ``oracles/reference_mdp.py``: a SECOND,
independently structured implementation transcribed from the reference's
*python/HLE-derived* semantics — ``PantheonHanabi`` over DeepMind's
``hanabi_learning_environment`` (the reference's ``envs/hanabi_env.py:
108-154``) and the ``HanabiState`` decode / simulate / mask rules
(``:157-475``) — NOT from ``src/hanabi_env/sim.cpp``.  The existing
``oracles/hanabi.HanabiOracle`` is a sequential re-derivation of the same
C++ the vectorized simulator was built from; a shared misreading would
agree with itself.  This module models the game the way the HLE does:
cards are ``(color, rank)`` pairs, hands are slot objects carrying a
plausibility SET and hint marks, the discard pile is a list of cards, and
the bit encoding is emitted by a section-by-section writer following the
HLE canonical observation layout.

Randomness is fully externalized: the game draws cards from an injected
``draw_source`` callable, so it contains no RNG at all — in the three-way
differential test the hidden draws are recorded from the TEA+LCG stream
and replayed here, making every *rules and encoding* decision independent
while holding the hidden information equal (the deal machinery itself is
covered by the bitwise RNG audit in ``tests/test_rng.py``).

Two places where the reference C++ deviates from clean HLE semantics are
reproduced only behind ``cxx_quirks=True`` (the default, for bitwise
three-way diffs) and implemented cleanly otherwise:

* **knowledge plausibility bit-index bug** (``sim.cpp:311``): the C++
  fills each slot's ``bits_per_card``-wide plausibility block with bit
  ``i`` of the mask — ``i`` being the *relative player index*, not the
  card id — so the block degenerates to ``card_id==i`` plausibility
  replicated ``BPC`` times.  Clean mode emits the real per-card-id bits.
* **stale dead-slot reveal legality** (``sim.cpp:414-436`` analog): after
  deck exhaustion shrinks a hand, the C++ legal-move scan still reads the
  remnant cards parked in dead slots.  Clean mode scans live slots only.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Set, Tuple

import numpy as np

Card = Tuple[int, int]  # (color, rank)


class RecordingOracle:
    """Sequential C++-derived oracle that records every hidden draw
    (append-only card-id list) — the draw source for three-way diffs.
    Defined lazily to avoid a hard import cycle with ``oracles.hanabi``."""

    def __new__(cls, counter, **cfg):
        from .hanabi import HanabiOracle

        class _Recording(HanabiOracle):
            def __init__(self, counter_, **kw):
                self.drawn = []
                super().__init__(counter_, **kw)

            def _draw(self):
                card = super()._draw()
                self.drawn.append(card)
                return card

        return _Recording(counter, **cfg)


def draw_cursor(queue, ranks: int):
    """Independent read cursor over a recorded draw list: returns a
    ``draw()`` callable yielding ``(color, rank)`` pairs, with a
    ``.consumed()`` accessor for draw-accounting checks."""
    pos = [0]

    def draw():
        cid = queue[pos[0]]
        pos[0] += 1
        return (cid // ranks, cid % ranks)

    draw.consumed = lambda: pos[0]
    return draw

# move-type tags in HLE encoding order of the move-type one-hot is
# (play, discard, reveal_color, reveal_rank); uid layout is
# discard[H] | play[H] | reveal_color[(P-1)*C] | reveal_rank[(P-1)*R]
PLAY, DISCARD, REVEAL_COLOR, REVEAL_RANK = "play", "discard", "rev_c", "rev_r"


def copies_of_rank(rank: int, ranks: int) -> int:
    """Standard Hanabi multiset: three 1s, one top rank, two of the rest."""
    if rank == 0:
        return 3
    if rank == ranks - 1:
        return 1
    return 2


@dataclasses.dataclass
class Slot:
    """One hand position.  ``card`` stays populated after the slot dies
    (deck-exhaustion shrink) because the C++ scans the remnant."""

    card: Optional[Card] = None
    plausible: Set[Card] = dataclasses.field(default_factory=set)
    hint_color: Optional[int] = None
    hint_rank: Optional[int] = None


@dataclasses.dataclass
class LastAction:
    actor: Optional[int] = None
    kind: Optional[str] = None
    target: Optional[int] = None
    position: Optional[int] = None
    card: Optional[Card] = None
    color: Optional[int] = None
    rank: Optional[int] = None
    touched: Tuple[int, ...] = ()
    scored: bool = False
    refunded: bool = False


class _BitWriter:
    def __init__(self):
        self._bits: List[int] = []

    def put(self, flag) -> None:
        self._bits.append(1 if flag else 0)

    def one_hot(self, index: Optional[int], width: int) -> None:
        for v in range(width):
            self.put(index is not None and index == v)

    def thermometer(self, level: int, width: int) -> None:
        for v in range(width):
            self.put(v < level)

    def zeros(self, width: int) -> None:
        self._bits.extend([0] * width)

    def array(self) -> np.ndarray:
        return np.asarray(self._bits, np.int8)


class RulesHanabi:
    """One Hanabi game under HLE rules, hidden draws injected.

    ``draw_source()`` must return the next drawn ``(color, rank)``; it is
    called ``players*hand_size`` times by ``new_game`` and once per
    play/discard while the deck is non-empty.
    """

    def __init__(self, draw_source: Callable[[], Card], colors=5, ranks=5,
                 players=2, max_information_tokens=8, max_life_tokens=3,
                 cxx_quirks=True, **_ignored):
        self.colors, self.ranks, self.players = colors, ranks, players
        self.max_info = max_information_tokens
        self.max_life = max_life_tokens
        self.hand_size = 5 if players < 4 else 4
        self.quirks = cxx_quirks
        self._draw_source = draw_source
        self.total_cards = colors * sum(
            copies_of_rank(r, ranks) for r in range(ranks))
        self.num_moves = (2 * self.hand_size
                          + (players - 1) * (colors + ranks))
        self.new_game()

    # -- state layout sizes (HLE canonical sections) --------------------
    @property
    def bits_per_card(self) -> int:
        return self.colors * self.ranks

    @property
    def deck_bits(self) -> int:
        return self.total_cards - self.players * self.hand_size

    def _all_cards(self) -> Set[Card]:
        return {(c, r) for c in range(self.colors) for r in range(self.ranks)}

    # -- lifecycle -------------------------------------------------------
    def new_game(self) -> None:
        P, H = self.players, self.hand_size
        self.deck_remaining = self.total_cards
        self.hands: List[List[Slot]] = [
            [Slot() for _ in range(H)] for _ in range(P)]
        self.live: List[int] = [H] * P
        self.fireworks: List[int] = [0] * self.colors
        self.discard_pile: List[Card] = []
        self.info_tokens = self.max_info
        self.life_tokens = self.max_life
        self.to_move = 0
        self.final_countdown = P  # turns once the deck runs dry
        self.score = 0
        self.last = LastAction()
        for p in range(P):
            for s in range(H):
                self._fill_slot(self.hands[p][s])

    def _fill_slot(self, slot: Slot) -> None:
        slot.card = self._draw_source()
        slot.plausible = self._all_cards()
        slot.hint_color = None
        slot.hint_rank = None
        self.deck_remaining -= 1

    def _discard_or_play_slot(self, player: int, pos: int) -> Card:
        """Remove the card at ``pos``; redraw if possible, else shrink the
        hand (HLE semantics: later slots shift down; under ``cxx_quirks``
        the dead tail keeps its remnant card, as the C++ buffers do)."""
        hand = self.hands[player]
        card = hand[pos].card
        if self.deck_remaining > 0:
            self._fill_slot(hand[pos])
        else:
            n = self.live[player]
            for s in range(pos + 1, n):
                prev, cur = hand[s - 1], hand[s]
                prev.card = cur.card
                prev.plausible = cur.plausible
                prev.hint_color = cur.hint_color
                prev.hint_rank = cur.hint_rank
            self.live[player] = n - 1
            # hand[n-1] keeps its remnant (the quirk scan reads it)
        return card

    # -- legality --------------------------------------------------------
    def move_of_uid(self, uid: int) -> LastAction:
        H, C, R, P = self.hand_size, self.colors, self.ranks, self.players
        mv = LastAction(actor=self.to_move)
        if uid < H:
            mv.kind, mv.position = DISCARD, uid
        elif uid < 2 * H:
            mv.kind, mv.position = PLAY, uid - H
        elif uid < 2 * H + (P - 1) * C:
            k = uid - 2 * H
            mv.kind = REVEAL_COLOR
            mv.target = (self.to_move + 1 + k // C) % P
            mv.color = k % C
        else:
            k = uid - 2 * H - (P - 1) * C
            mv.kind = REVEAL_RANK
            mv.target = (self.to_move + 1 + k // R) % P
            mv.rank = k % R
        return mv

    def _scan_width(self, player: int) -> int:
        """How many slots the reveal-legality scan reads."""
        return self.hand_size if self.quirks else self.live[player]

    def legal_mask(self, player: int) -> np.ndarray:
        H, C, R, P = self.hand_size, self.colors, self.ranks, self.players
        m = np.zeros(self.num_moves, bool)
        for pos in range(H):
            m[pos] = pos < self.live[player] and self.info_tokens < self.max_info
            m[H + pos] = pos < self.live[player]
        off = 2 * H
        for rel in range(1, P):
            other = (player + rel) % P
            slots = self.hands[other][: self._scan_width(other)]
            for c in range(C):
                m[off] = self.info_tokens > 0 and any(
                    s.card is not None and s.card[0] == c for s in slots)
                off += 1
        for rel in range(1, P):
            other = (player + rel) % P
            slots = self.hands[other][: self._scan_width(other)]
            for r in range(R):
                m[off] = self.info_tokens > 0 and any(
                    s.card is not None and s.card[1] == r for s in slots)
                off += 1
        return m

    # -- transition (HanabiState.simulate semantics, :300-370) -----------
    def step(self, uid: int) -> Tuple[float, bool]:
        C, R = self.colors, self.ranks
        if self.deck_remaining == 0:
            self.final_countdown -= 1
        mv = self.move_of_uid(uid)
        actor = mv.actor

        if mv.kind == DISCARD:
            card = self.hands[actor][mv.position].card
            mv.card, mv.color, mv.rank = card, card[0], card[1]
            self.discard_pile.append(card)
            self.info_tokens += 1
            self._discard_or_play_slot(actor, mv.position)
        elif mv.kind == PLAY:
            card = self.hands[actor][mv.position].card
            mv.card, mv.color, mv.rank = card, card[0], card[1]
            if self.fireworks[card[0]] == card[1]:
                self.fireworks[card[0]] += 1
                mv.scored = True
                if self.fireworks[card[0]] == R:
                    self.info_tokens += 1
                    mv.refunded = True
            else:
                self.discard_pile.append(card)
                self.life_tokens -= 1
            self._discard_or_play_slot(actor, mv.position)
        else:
            self.info_tokens -= 1
            tgt_hand = self.hands[mv.target]
            touched = []
            for pos in range(self.live[mv.target]):
                slot = tgt_hand[pos]
                if mv.kind == REVEAL_COLOR:
                    if slot.card[0] == mv.color:
                        touched.append(pos)
                        slot.hint_color = mv.color
                        slot.plausible = {
                            cr for cr in slot.plausible if cr[0] == mv.color}
                    else:
                        slot.plausible = {
                            cr for cr in slot.plausible if cr[0] != mv.color}
                else:
                    if slot.card[1] == mv.rank:
                        touched.append(pos)
                        slot.hint_rank = mv.rank
                        slot.plausible = {
                            cr for cr in slot.plausible if cr[1] == mv.rank}
                    else:
                        slot.plausible = {
                            cr for cr in slot.plausible if cr[1] != mv.rank}
            mv.touched = tuple(touched)

        self.last = mv
        self.to_move = (self.to_move + 1) % self.players

        previous = self.score
        self.score = sum(self.fireworks) if self.life_tokens > 0 else 0
        reward = float(self.score - previous)
        done = (self.life_tokens < 1
                or self.score >= self.colors * self.ranks
                or self.final_countdown <= 0)
        return reward, done

    # -- encoding (HLE canonical sections; HanabiState decode, :157-298) --
    def _card_id(self, card: Card) -> int:
        return card[0] * self.ranks + card[1]

    def encode(self, viewer: int) -> Tuple[np.ndarray, np.ndarray]:
        """Return ``(obs, state)`` bit vectors for ``viewer``; ``state`` is
        ``obs`` with the viewer's own hand appended."""
        C, R, P, H = self.colors, self.ranks, self.players, self.hand_size
        BPC = self.bits_per_card
        w = _BitWriter()

        # 1. other players' hands (viewer-relative order), live slots only
        for rel in range(1, P):
            other = (viewer + rel) % P
            for pos in range(H):
                if pos < self.live[other]:
                    w.one_hot(self._card_id(self.hands[other][pos].card), BPC)
                else:
                    w.zeros(BPC)
        for rel in range(P):
            w.put(self.live[(viewer + rel) % P] < H)

        # 2. board: deck thermometer, fireworks, tokens
        w.thermometer(self.deck_remaining, self.deck_bits)
        for c in range(C):
            w.one_hot(self.fireworks[c] - 1 if self.fireworks[c] else None, R)
        w.thermometer(self.info_tokens, self.max_info)
        w.thermometer(self.life_tokens, self.max_life)

        # 3. discards: per (color, rank) a thermometer over the copy count
        piled = [0] * (C * R)
        for card in self.discard_pile:
            piled[self._card_id(card)] += 1
        for c in range(C):
            for r in range(R):
                w.thermometer(piled[c * R + r], copies_of_rank(r, R))

        # 4. last action
        mv = self.last
        w.one_hot(None if mv.actor is None
                  else (viewer - mv.actor) % P, P)
        w.put(mv.kind == PLAY)
        w.put(mv.kind == DISCARD)
        w.put(mv.kind == REVEAL_COLOR)
        w.put(mv.kind == REVEAL_RANK)
        is_reveal = mv.kind in (REVEAL_COLOR, REVEAL_RANK)
        w.one_hot((viewer - mv.target) % P if is_reveal else None, P)
        w.one_hot(mv.color if mv.kind == REVEAL_COLOR else None, C)
        w.one_hot(mv.rank if mv.kind == REVEAL_RANK else None, R)
        for pos in range(H):
            w.put(is_reveal and pos in mv.touched)
        is_pd = mv.kind in (PLAY, DISCARD)
        w.one_hot(mv.position if is_pd else None, H)
        w.one_hot(self._card_id(mv.card) if is_pd else None, BPC)
        w.put(mv.kind == PLAY and mv.scored)
        w.put(mv.kind == PLAY and mv.refunded)

        # 5. card knowledge (viewer-relative, self first)
        for rel in range(P):
            other = (viewer + rel) % P
            for pos in range(H):
                if pos >= self.live[other]:
                    w.zeros(BPC + C + R)
                    continue
                slot = self.hands[other][pos]
                if self.quirks:
                    # sim.cpp:311 — bit `rel` of the mask, replicated
                    quirk_card = (rel // R, rel % R)
                    for _ in range(BPC):
                        w.put(quirk_card in slot.plausible)
                else:
                    for cid in range(BPC):
                        w.put((cid // R, cid % R) in slot.plausible)
                w.one_hot(slot.hint_color, C)
                w.one_hot(slot.hint_rank, R)

        obs = w.array()

        own = _BitWriter()
        for pos in range(H):
            if pos < self.live[viewer]:
                own.one_hot(self._card_id(self.hands[viewer][pos].card), BPC)
            else:
                own.zeros(BPC)
        state = np.concatenate([obs, own.array()])
        return obs, state

"""Hanabi batch simulator (plain PyTorch).

Counterpart of ``madrona_rl_envs_playground_tpu/envs/hanabi.py`` (reference
``src/hanabi_env/sim.cpp``): the full card game as a Dec-POMDP with a
50-slot deck and random-swap draws, per-seat hands with ``card_plausible``
bitmask knowledge, the discard / play / reveal-color / reveal-rank move
space, turn-based control (``cur_player`` and per-seat active flags), the
five-section bit-vector observation plus the own-hand block appended to the
state tensor only, the legal-move mask, and reward = the change of score
with life / score / turn-exhaustion termination.

Only the acting seat's observation, own hand and mask are re-encoded each
step (and every seat's on a reset); the other seats keep their stale
snapshots, as the reference does, so the per-seat buffers are part of the
state.  Two quirks of the reference C++ are reproduced on purpose:

* the card-knowledge section broadcasts plausible-mask bit ``i`` (the
  observer-relative player offset) over the whole bits-per-card block;
* the reveal legality scan runs over every hand slot, dead slots included.

Every tensor has a leading batch axis N (the JAX env is written for one
world and ``vmap``-ed).  Integer fields are int32, except the two uint32
fields ``hand_plausible`` and ``rng_v``, which are int64 holding the uint32
value (``core/rng.py``); complements of them are masked back to 32 bits.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import rng
from ..core.base import EnvBase
from ..core.batch import select_state

# The reference caps the move space at 20 (enough for its 2-player configs);
# the mask here is sized to the config's own move count, so games of more
# players fit too.
NUM_MOVES_MAX = 60

FULL_CONFIG = dict(colors=5, ranks=5, players=2, max_information_tokens=8, max_life_tokens=3)
SMALL_CONFIG = dict(colors=2, ranks=5, players=2, max_information_tokens=3, max_life_tokens=1)
VERY_SMALL_CONFIG = dict(colors=1, ranks=5, players=2, max_information_tokens=3,
                         max_life_tokens=1)
CONFIGS = {"full": FULL_CONFIG, "small": SMALL_CONFIG, "very_small": VERY_SMALL_CONFIG}

M_DISCARD, M_PLAY, M_REVEAL_C, M_REVEAL_R, M_INVALID = 0, 1, 2, 3, 4

I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class State:
    deck: torch.Tensor            # [N, M] int32 card ids
    deck_size: torch.Tensor       # [N] int32
    discard_counts: torch.Tensor  # [N, C*R] int32
    fireworks: torch.Tensor       # [N, C] int32
    info_tokens: torch.Tensor     # [N] int32
    life_tokens: torch.Tensor     # [N] int32
    cur_player: torch.Tensor      # [N] int32
    turns_to_play: torch.Tensor   # [N] int32
    score: torch.Tensor           # [N] int32
    # last move (lm_move: 0 discard, 1 play, 2 reveal color, 3 reveal rank,
    # 4 none yet); -1 marks an absent player, card, color or rank
    lm_move: torch.Tensor
    lm_player: torch.Tensor
    lm_target: torch.Tensor
    lm_card_index: torch.Tensor
    lm_scored: torch.Tensor
    lm_info_token: torch.Tensor
    lm_color: torch.Tensor
    lm_rank: torch.Tensor
    lm_reveal_bits: torch.Tensor
    # hands
    hand_cards: torch.Tensor      # [N, P, H] int32
    hand_plausible: torch.Tensor  # [N, P, H] int64 holding a uint32 bitmask
    hand_size: torch.Tensor       # [N, P] int32
    known_color: torch.Tensor     # [N, P, H] int32 (-1 unknown)
    known_rank: torch.Tensor      # [N, P, H] int32
    # stale per-seat encodings; the state tensor is obs ++ own
    obs_buf: torch.Tensor         # [N, P, OBS] int8
    own_buf: torch.Tensor         # [N, P, H*C*R] int8
    mask_buf: torch.Tensor        # [N, P, A] bool
    rng_v: torch.Tensor           # [N] int64 holding the uint32 LCG word


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(I32)


def _set_row(mat: torch.Tensor, row: torch.Tensor, new_row: torch.Tensor) -> torch.Tensor:
    """``mat[n, row[n]] = new_row[n]`` for every n, out of place; ``mat``
    [N, P, ...], ``new_row`` [N, ...]."""
    P = mat.shape[1]
    sel = torch.arange(P, device=mat.device)[None, :] == row[:, None]
    sel = sel.reshape(sel.shape + (1,) * (mat.dim() - 2))
    return torch.where(sel, new_row[:, None], mat)


def _get_row(mat: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """``mat[n, row[n]]`` for every n."""
    return mat[torch.arange(mat.shape[0], device=mat.device), row.long()]


class Env(EnvBase):
    state_is_obs = False
    masked = True

    reward_dtype = torch.float32
    obs_dtype = torch.int8

    def __init__(self, colors=5, ranks=5, players=2, max_information_tokens=8,
                 max_life_tokens=3, **_ignored):
        self.colors = int(colors)
        self.ranks = int(ranks)
        self.players = int(players)
        self.max_info = int(max_information_tokens)
        self.max_life = int(max_life_tokens)
        self.hand = 5 if self.players < 4 else 4
        self.num_agents = self.players

        C, R, P, H = self.colors, self.ranks, self.players, self.hand
        self.bits_per_card = C * R
        # copies of each (color, rank): 3 of rank 0, 1 of the top rank, else 2
        self.cr_num = [3 if r == 0 else 1 if r == R - 1 else 2 for r in range(R)]
        self.cards_per_color = sum(self.cr_num)
        self.max_cards = self.cards_per_color * C
        self.max_deck_bits = self.max_cards - H * P

        self.sz_hands = self.bits_per_card * H * (P - 1) + P
        self.sz_board = self.max_deck_bits + C * R + self.max_info + self.max_life
        self.sz_discard = self.max_cards
        self.sz_last = P + 4 + P + C + R + H + H + C * R + 2
        self.sz_know = P * H * (C * R + C + R)
        self.obs_size = (self.sz_hands + self.sz_board + self.sz_discard + self.sz_last
                         + self.sz_know)
        self.state_size = self.obs_size + H * self.bits_per_card
        self.num_actions = 2 * H + (P - 1) * C + (P - 1) * R
        assert self.num_actions <= NUM_MOVES_MAX
        # a card's plausible set is a uint32 bit mask (JAX's Env raises the
        # same error here, from np.uint32)
        if self.bits_per_card > 32:
            raise OverflowError(f"colors x ranks = {self.bits_per_card} card kinds do not "
                                "fit the uint32 plausible mask (at most 32)")

        # discard encoding: bit -> (card id, threshold)
        ids, thr = [], []
        for c in range(C):
            for r in range(R):
                for i in range(self.cr_num[r]):
                    ids.append(c * R + r)
                    thr.append(i)
        self._discard_ids = torch.tensor(ids, dtype=torch.long)
        self._discard_thr = torch.tensor(thr, dtype=I32)
        # initial deck: card id c*R+r repeated cr_num[r] times, in (c, r) order
        deck0 = []
        for c in range(C):
            for r in range(R):
                deck0 += [c * R + r] * self.cr_num[r]
        self._deck0 = torch.tensor(deck0, dtype=I32)
        self._valid_mask = (1 << self.bits_per_card) - 1

    # ------------------------------------------------------------------
    def _orig_card(self, loc: torch.Tensor) -> torch.Tensor:
        """``deck0[loc]`` arithmetically: color from ``loc // cards_per_color``,
        rank from the within-color copy counts."""
        cpc, R = self.cards_per_color, self.ranks
        rem = loc % cpc
        rank = torch.zeros_like(loc)
        acc = 0
        for r in range(R):
            acc += self.cr_num[r]
            rank = torch.where(rem >= acc, r + 1, rank)
        return (loc // cpc) * R + rank

    def init_core(self, episode_idx: torch.Tensor) -> State:
        """Fresh games for episode indices [N].  The deal's P*H swap draws
        (reference sim.cpp:45-52) are independent of the actions, so they
        are resolved in closed form: the D LCG words come straight from the
        seed, and the swap chain resolves with a last-write-wins cascade
        over the touched positions."""
        C, R, P, H = self.colors, self.ranks, self.players, self.hand
        dev = episode_idx.device
        N = episode_idx.shape[0]
        M, D = self.max_cards, P * H
        v = rng.seed(episode_idx)
        locs = []
        for k in range(D):
            v = rng.next_uint(v)
            u = rng.uniform_from(v)
            locs.append(_i32(torch.tensor(float(M - k), dtype=torch.float32, device=dev) * u))

        deck0 = self._deck0.to(dev)
        # moved[j] = the card at position M-1-j just before draw j
        moved = []
        for j in range(D):
            tgt = M - 1 - j
            val = torch.full((N,), int(deck0[tgt]), dtype=I32, device=dev)
            for i in range(j):
                val = torch.where(locs[i] == tgt, moved[i], val)
            moved.append(val)
        # dealt card k = the last value written at locs[k] (the original if none)
        cards = []
        for k in range(D):
            val = self._orig_card(locs[k])
            for j in range(k):
                val = torch.where(locs[j] == locs[k], moved[j], val)
            cards.append(val)
        hand_cards = torch.stack(cards, 1).reshape(N, P, H)

        pos = torch.arange(M, device=dev)[None, :]
        deck = deck0[None, :].expand(N, M)
        for j in range(D):
            deck = torch.where(pos == locs[j][:, None], moved[j][:, None], deck)

        def full(shape, value, dtype=I32):
            return torch.full(shape, value, dtype=dtype, device=dev)

        return State(
            deck=deck.contiguous(),
            deck_size=full((N,), M - D),
            discard_counts=full((N, C * R), 0),
            fireworks=full((N, C), 0),
            info_tokens=full((N,), self.max_info),
            life_tokens=full((N,), self.max_life),
            cur_player=full((N,), 0),
            turns_to_play=full((N,), P),
            score=full((N,), 0),
            lm_move=full((N,), M_INVALID),
            lm_player=full((N,), -1),
            lm_target=full((N,), -1),
            lm_card_index=full((N,), -1),
            lm_scored=full((N,), 0),
            lm_info_token=full((N,), 0),
            lm_color=full((N,), -1),
            lm_rank=full((N,), -1),
            lm_reveal_bits=full((N,), 0),
            hand_cards=hand_cards,
            hand_plausible=full((N, P, H), self._valid_mask, torch.int64),
            hand_size=full((N, P), H),
            known_color=full((N, P, H), -1),
            known_rank=full((N, P, H), -1),
            obs_buf=full((N, P, self.obs_size), 0, torch.int8),
            own_buf=full((N, P, H * self.bits_per_card), 0, torch.int8),
            mask_buf=full((N, P, self.num_actions), False, torch.bool),
            rng_v=v,
        )

    # ------------------------------------------------------------------
    def _remove_from_hand(self, s: State, agent: torch.Tensor, idx: torch.Tensor) -> State:
        """removeFromHand (sim.cpp:567-595): refill slot ``idx`` with a
        random-swap draw, or shift the slots after it left by one when the
        deck is empty (the dead slot keeps its stale values)."""
        H = self.hand
        dev = s.deck.device
        deck_empty = s.deck_size == 0

        # draw: loc = int32(f32(size) * u); the drawn card is replaced by
        # the deck's last card
        v_a, loc = rng.randint(s.rng_v, s.deck_size)
        card = s.deck.gather(1, loc.long()[:, None])[:, 0]
        last = s.deck.gather(1, (s.deck_size - 1).clamp(min=0).long()[:, None])
        deck_a = torch.where(torch.arange(s.deck.shape[1], device=dev)[None, :] == loc[:, None],
                             last, s.deck)

        k = torch.arange(H, device=dev)[None, :]
        size_here = _get_row(s.hand_size, agent)
        shift_sel = (k >= idx[:, None]) & (k < (size_here - 1)[:, None])
        at = k == idx[:, None]
        empty = deck_empty[:, None]

        def new_row(mat, fill):
            row = _get_row(mat, agent)
            shifted = torch.where(shift_sel, torch.roll(row, -1, dims=1), row)
            drawn = torch.where(at, fill, row)
            return _set_row(mat, agent, torch.where(empty, shifted, drawn))

        own_seat = torch.arange(s.hand_size.shape[1], device=dev)[None, :] == agent[:, None]
        return dataclasses.replace(
            s,
            deck=torch.where(empty, s.deck, deck_a),
            deck_size=torch.where(deck_empty, s.deck_size, s.deck_size - 1),
            rng_v=torch.where(deck_empty, s.rng_v, v_a),
            hand_cards=new_row(s.hand_cards, card[:, None]),
            hand_plausible=new_row(s.hand_plausible, self._valid_mask),
            hand_size=s.hand_size - _i32(own_seat & empty),
            known_color=new_row(s.known_color, -1),
            known_rank=new_row(s.known_rank, -1),
        )

    def transition(self, s: State, actions: torch.Tensor):
        """actions [N, P] int (only the current player's is read) ->
        (state', reward [N, P] f32, done [N] bool)."""
        C, R, P, H = self.colors, self.ranks, self.players, self.hand
        dev = s.deck.device
        s = dataclasses.replace(s, turns_to_play=s.turns_to_play - _i32(s.deck_size == 0))
        agent = s.cur_player
        uid = _i32(actions.gather(1, agent.long()[:, None])[:, 0])

        is_discard = uid < H
        is_play = (uid >= H) & (uid < 2 * H)
        rc_base, rr_base = 2 * H, 2 * H + (P - 1) * C
        is_rc = (uid >= rc_base) & (uid < rr_base)
        is_rr = uid >= rr_base
        is_reveal = is_rc | is_rr

        card_idx = torch.where(is_discard, uid, uid - H).clamp(0, H - 1)
        card = _get_row(s.hand_cards, agent).gather(1, card_idx.long()[:, None])[:, 0]
        card_color, card_rank = card // R, card % R

        # discard and play
        cr = torch.arange(C * R, device=dev)[None, :]
        cc = torch.arange(C, device=dev)[None, :]
        disc = s.discard_counts + _i32(is_discard[:, None] & (cr == card[:, None]))
        info = s.info_tokens + _i32(is_discard)
        fw_c = s.fireworks.gather(1, card_color.long()[:, None])[:, 0]
        success = is_play & (fw_c == card_rank)
        fireworks = s.fireworks + _i32(success[:, None] & (cc == card_color[:, None]))
        completed = success & (fw_c + 1 == R)
        info = info + _i32(completed)
        failed = is_play & ~success
        disc = disc + _i32(failed[:, None] & (cr == card[:, None]))
        life = s.life_tokens - _i32(failed)

        # reveals
        rc_uid = (uid - rc_base).clamp(0, (P - 1) * C)
        rr_uid = (uid - rr_base).clamp(0, (P - 1) * R)
        tgt_off = torch.where(is_rc, 1 + rc_uid // C, 1 + rr_uid // R)
        rev_color, rev_rank = rc_uid % C, rr_uid % R
        target = (agent + tgt_off) % P
        info = info - _i32(is_reveal)

        slot = torch.arange(H, device=dev)[None, :]
        t_cards = _get_row(s.hand_cards, target)
        live = slot < _get_row(s.hand_size, target)[:, None]
        match_c = (t_cards // R == rev_color[:, None]) & live
        match_r = (t_cards % R == rev_rank[:, None]) & live

        # plausible-mask updates, uint32 in int64
        mask32 = rng._MASK32
        color_mask = (((1 << R) - 1) << (rev_color * R).long())[:, None]
        rank_mask = torch.zeros_like(color_mask)
        for i in range(R):
            rank_mask = rank_mask + (1 << (i * R + rev_rank.long()))[:, None]
        rank_mask = rank_mask & mask32
        t_plaus = _get_row(s.hand_plausible, target)
        plaus_rc = torch.where(match_c, t_plaus & color_mask, t_plaus & (~color_mask & mask32))
        plaus_rr = torch.where(match_r, t_plaus & rank_mask, t_plaus & (~rank_mask & mask32))
        new_t_plaus = torch.where(is_rc[:, None], plaus_rc,
                                  torch.where(is_rr[:, None], plaus_rr, t_plaus))
        new_t_kc = torch.where(is_rc[:, None] & match_c, rev_color[:, None],
                               _get_row(s.known_color, target))
        new_t_kr = torch.where(is_rr[:, None] & match_r, rev_rank[:, None],
                               _get_row(s.known_rank, target))
        hits = torch.where(is_rc[:, None], match_c, match_r)
        reveal_bits = (_i32(hits) << slot).sum(1, dtype=I32) * _i32(is_reveal)

        took = is_discard | is_play
        minus1 = torch.full_like(uid, -1)
        s = dataclasses.replace(
            s,
            discard_counts=disc,
            fireworks=fireworks,
            info_tokens=info,
            life_tokens=life,
            hand_plausible=_set_row(s.hand_plausible, target, new_t_plaus),
            known_color=_set_row(s.known_color, target, new_t_kc),
            known_rank=_set_row(s.known_rank, target, new_t_kr),
            cur_player=(s.cur_player + 1) % P,
            lm_move=torch.where(is_discard, M_DISCARD, torch.where(
                is_play, M_PLAY, torch.where(is_rc, M_REVEAL_C, M_REVEAL_R))).to(I32),
            lm_player=agent,
            lm_target=torch.where(is_reveal, target, minus1),
            lm_card_index=torch.where(took, card_idx, minus1),
            lm_scored=_i32(success),
            lm_info_token=_i32(completed),
            lm_color=torch.where(took, card_color, torch.where(is_rc, rev_color, minus1)),
            lm_rank=torch.where(took, card_rank, torch.where(is_rr, rev_rank, minus1)),
            lm_reveal_bits=reveal_bits,
        )

        # replace or shift the played or discarded card
        s_removed = self._remove_from_hand(s, agent, card_idx)
        s = select_state(took, s_removed, s)

        # checkDone (sim.cpp:812-849)
        score = torch.where(s.life_tokens > 0, s.fireworks.sum(1, dtype=I32), 0)
        reward = (score - s.score).to(torch.float32)[:, None].expand(-1, P).contiguous()
        s = dataclasses.replace(s, score=score)
        done = (s.life_tokens < 1) | (score >= C * R) | (s.turns_to_play <= 0)
        return s, reward, done

    # ------------------------------------------------------------------
    # observation encoding (sim.cpp:54-379), one observer seat at a time
    def _encode_seat(self, s: State, a: int):
        C, R, P, H = self.colors, self.ranks, self.players, self.hand
        BPC = self.bits_per_card
        dev = s.deck.device
        N = s.deck.shape[0]
        i8 = lambda b: b.to(torch.int8)
        ar = lambda n: torch.arange(n, device=dev)[None, :]
        slot = ar(H)
        parts = []

        # hands: the partners' actual cards, in observer-relative order
        partners = [(a + 1 + i) % P for i in range(P - 1)]
        for q in partners:
            live = slot < s.hand_size[:, q, None]
            oh = (s.hand_cards[:, q, :, None] == ar(BPC)[:, None, :]) & live[:, :, None]
            parts.append(i8(oh).reshape(N, -1))
        seats = [(a + i) % P for i in range(P)]
        parts.append(i8(s.hand_size[:, seats] < H))

        # board
        parts.append(i8(ar(self.max_deck_bits) < s.deck_size[:, None]))
        # fireworks == i+1 (a color at 0 has no bit)
        parts.append(i8(s.fireworks[:, :, None] - 1 == ar(R)[:, None, :]).reshape(N, -1))
        parts.append(i8(ar(self.max_info) < s.info_tokens[:, None]))
        parts.append(i8(ar(self.max_life) < s.life_tokens[:, None]))

        # discards
        ids, thr = self._discard_ids.to(dev), self._discard_thr.to(dev)
        parts.append(i8(s.discard_counts[:, ids] > thr[None, :]))

        # last action
        mt = s.lm_move[:, None]
        rel_actor = torch.where(s.lm_player == -1, -1, (a - s.lm_player + P) % P)
        parts.append(i8(ar(P) == rel_actor[:, None]))
        parts.append(i8(torch.cat([mt == M_PLAY, mt == M_DISCARD, mt == M_REVEAL_C,
                                   mt == M_REVEAL_R], 1)))
        is_reveal = (mt == M_REVEAL_C) | (mt == M_REVEAL_R)
        rel_target = (a - s.lm_target + P) % P
        parts.append(i8((ar(P) == rel_target[:, None]) & is_reveal))
        parts.append(i8((ar(C) == s.lm_color[:, None]) & (mt == M_REVEAL_C)))
        parts.append(i8((ar(R) == s.lm_rank[:, None]) & (mt == M_REVEAL_R)))
        parts.append(i8(((s.lm_reveal_bits[:, None] >> slot) & 1).bool() & is_reveal))
        is_pd = (mt == M_PLAY) | (mt == M_DISCARD)
        parts.append(i8((slot == s.lm_card_index[:, None]) & is_pd))
        parts.append(i8((ar(C * R) == (s.lm_color * R + s.lm_rank)[:, None]) & is_pd))
        is_p = mt == M_PLAY
        parts.append(i8(torch.cat([(s.lm_scored[:, None] != 0) & is_p,
                                   (s.lm_info_token[:, None] != 0) & is_p], 1)))

        # card knowledge (the quirk: plausible bit index = player offset,
        # broadcast over the bits-per-card block)
        for off, q in enumerate(seats):
            live = slot < s.hand_size[:, q, None]                         # [N, H]
            pb = ((s.hand_plausible[:, q] >> off) & 1).bool() & live
            blk_p = i8(pb)[:, :, None].expand(N, H, BPC)
            blk_c = i8((s.known_color[:, q, :, None] == ar(C)[:, None, :]) & live[:, :, None])
            blk_r = i8((s.known_rank[:, q, :, None] == ar(R)[:, None, :]) & live[:, :, None])
            parts.append(torch.cat([blk_p, blk_c, blk_r], 2).reshape(N, -1))
        obs = torch.cat(parts, 1)

        # own hand, appended to the state tensor only
        own_live = slot < s.hand_size[:, a, None]
        own = (s.hand_cards[:, a, :, None] == ar(BPC)[:, None, :]) & own_live[:, :, None]
        return obs, i8(own).reshape(N, -1)

    def legal_mask(self, hand_cards: torch.Tensor, hand_size: torch.Tensor,
                   info_tokens: torch.Tensor, a: int) -> torch.Tensor:
        """Seat ``a``'s legal moves [N, A] bool from the hand cards [N, P, H],
        hand sizes [N, P] and info tokens [N] (sim.cpp:381-444; the reveal
        scan includes dead slots)."""
        C, R, P, H = self.colors, self.ranks, self.players, self.hand
        dev = hand_cards.device
        slot = torch.arange(H, device=dev)[None, :]
        live = slot < hand_size[:, a, None]
        discard_ok = live & (info_tokens < self.max_info)[:, None]
        info_avail = (info_tokens > 0)[:, None]
        rc, rr = [], []
        for i in range(P - 1):
            cards = hand_cards[:, (a + 1 + i) % P]                        # [N, H]
            rc.append((cards[:, :, None] // R == torch.arange(C, device=dev)).any(1)
                      & info_avail)
            rr.append((cards[:, :, None] % R == torch.arange(R, device=dev)).any(1)
                      & info_avail)
        return torch.cat([discard_ok, live] + rc + rr, 1)

    def encode(self, s: State, just_reset: torch.Tensor):
        P = self.players
        dev = s.deck.device
        enc = [self._encode_seat(s, a) for a in range(P)]
        obs_new = torch.stack([o for o, _ in enc], 1)
        own_new = torch.stack([w for _, w in enc], 1)
        mask_new = torch.stack([self.legal_mask(s.hand_cards, s.hand_size, s.info_tokens, a)
                                for a in range(P)], 1)
        seats = torch.arange(P, device=dev)[None, :]
        # stale-seat rule: only a reset or the seat to act refreshes a seat
        refresh = (just_reset[:, None] | (seats == s.cur_player[:, None]))[:, :, None]
        obs_buf = torch.where(refresh, obs_new, s.obs_buf)
        own_buf = torch.where(refresh, own_new, s.own_buf)
        mask_buf = torch.where(refresh, mask_new, s.mask_buf)
        s = dataclasses.replace(s, obs_buf=obs_buf, own_buf=own_buf, mask_buf=mask_buf)
        state_buf = torch.cat([obs_buf, own_buf], -1)
        active = seats == s.cur_player[:, None]
        return s, obs_buf, state_buf, mask_buf, active

